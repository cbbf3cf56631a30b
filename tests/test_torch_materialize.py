"""BITDISTILLER_QMM_MATERIALIZE_M on the port (A15), on the CPU against the
JAX package (tests/test_pallas_kernels.py's two materialize tests, ported):
`quant_matmul_materialize` against JAX's on the same packed leaf and x, a
plain and a stacked layer, f32 and bf16 x (the same bf16 weight, so f32 x
differs only in summation order: rtol 1e-5; bf16 x by one bf16 rounding of
the output: rtol 1e-2), and the dispatch at, below and without the
threshold, with A8-ordered leaves never materialized."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdistiller_tpu.ops.quant_matmul  # noqa: F401  (the package re-exports a function of the same name)
from bitdistiller_tpu.quant.packing import quantize_pack_linear
from bitdistiller_tpu_torch.ops import quant_matmul as tq
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from torch_port_util import to_numpy_tree

jq = sys.modules["bitdistiller_tpu.ops.quant_matmul"]
K, N = 256, 128


def _leaves(bits=2, group=128, bias=False):
    """A plain JAX leaf (as JAX's tests pack it) and the port's copy."""
    w = jax.random.normal(jax.random.key(0), (K, N), jnp.float32)
    b = jax.random.normal(jax.random.key(2), (N,), jnp.float32) if bias else None
    jp = quantize_pack_linear(w, bits, group, bias=b)
    return jp, params_from_numpy({"w": to_numpy_tree(jp)}, "cpu")["w"]


def _x(shape, dtype):
    x = np.asarray(jax.random.normal(jax.random.key(1), shape, jnp.float32))
    return x.astype(np.float32), dtype


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group,bias", [(2, 128, False), (4, 64, True)])
def test_materialize_matches_jax(bits, group, bias, dtype):
    jp, tp = _leaves(bits, group, bias)
    x, _ = _x((64, K), dtype)
    want = jq.quant_matmul_materialize(jnp.asarray(x).astype(dtype), jp)
    got = tq.quant_matmul_materialize(torch.from_numpy(x).to(getattr(torch, dtype)), tp)
    assert got.dtype == getattr(torch, dtype) and got.shape == (64, N)
    _close(got, want, dtype)


def test_materialize_stacked_layer_matches_jax():
    """Layer li of a stacked leaf: JAX materializes the sliced layer."""
    ws = jax.random.normal(jax.random.key(3), (3, K, N), jnp.float32)
    layers = [quantize_pack_linear(ws[i], 2, 64) for i in range(3)]
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *layers)
    tp = params_from_numpy({"w": to_numpy_tree(stacked)}, "cpu")["w"]
    x, _ = _x((2, 40, K), "float32")
    for li in range(3):
        want = jq.quant_matmul_materialize(jnp.asarray(x), layers[li])
        _close(tq.quant_matmul_materialize(torch.from_numpy(x), tp, li), want, "float32")



@pytest.fixture(autouse=True)
def fresh_switch():
    """The switch is read once a process: each test reads its own setting,
    and leaves none behind."""
    tq.materialize_min_m.cache_clear()
    yield
    tq.materialize_min_m.cache_clear()

@pytest.mark.parametrize("env,materialized", [("32", True), ("33", False), ("", False),
                                              (None, False)])
def test_materialize_env_dispatch(monkeypatch, env, materialized):
    """[2, 16, K] is 32 rows: the switch at 32 materializes (as JAX's
    dispatch does for the same call), at 33, "" and unset it does not; the
    output is JAX's dispatch's either way."""
    jp, tp = _leaves()
    calls = []
    real = tq.quant_matmul_materialize
    monkeypatch.setattr(tq, "quant_matmul_materialize",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    if env is None:
        monkeypatch.delenv(tq.MATERIALIZE_ENV, raising=False)
    else:
        monkeypatch.setenv(tq.MATERIALIZE_ENV, env)
    x, _ = _x((2, 16, K), "float32")
    got = tq.quant_matmul(torch.from_numpy(x), tp)
    assert bool(calls) == materialized and got.shape == (2, 16, N)
    want = jq.quant_matmul(jnp.asarray(x), jp)
    if materialized:
        _close(got, jq.quant_matmul_materialize(jnp.asarray(x), jp), "float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2 * float(jnp.abs(want).max()))


def test_a8_ordered_leaf_is_never_materialized(monkeypatch):
    """An A8-ordered leaf always goes to the A8 matmul, the switch set or
    not: its words cannot be dequantized in the pair layout."""
    _, tp = _leaves()
    a8 = tq.repack_linear_a8(tp)
    x = torch.from_numpy(_x((64, K), "float32")[0])
    monkeypatch.delenv(tq.MATERIALIZE_ENV, raising=False)
    want = tq.quant_matmul(x, a8)
    monkeypatch.setenv(tq.MATERIALIZE_ENV, "1")
    monkeypatch.setattr(tq, "quant_matmul_materialize",
                        lambda *a, **kw: pytest.fail("an A8-ordered leaf was materialized"))
    assert torch.equal(tq.quant_matmul(x, a8), want)
