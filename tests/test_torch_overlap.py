"""The port's ring matmuls (`parallel/overlap.py`) on 4 spawned gloo ranks
(tests/torch_tp_worker.py:overlap_job), the counterparts of the JAX
package's tests/test_overlap.py at tp = 4 (JAX's own at tp = 8), against
JAX's `make_row_parallel_fn` on a tp = 4 CPU mesh over the same numpy
inputs:

- the dense ring all-reduce and the packed int2-g128 one (each rank's K
  shard quantized on its own), on every rank, within 2e-4 (rtol and atol;
  XLA's f32 sums against PyTorch's in another order);
- the reduce-scatter: rank r's chunk is columns r of the whole product;
- the whole packed model at dp 2 x tp 2 under BITDISTILLER_RING_TP=1 (o
  and down through the ring, their chunks cut once) equal to the default
  tp path within 2e-5 at prefill S = 4 and decode S = 1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu.ops.quant_matmul import quant_matmul_xla
from bitdistiller_tpu.parallel.mesh import make_mesh as jmake_mesh
from bitdistiller_tpu.parallel.overlap import make_row_parallel_fn as jrow_parallel
from bitdistiller_tpu.quant.packing import quantize_pack_linear as jquantize_pack
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from test_torch_dp_worker import spawn
from torch_port_util import to_numpy_tree, torch_cfg

WORLD = 4
TOL, MODEL_TOL = 2e-4, 2e-5
JCFG = dataclasses.replace(TINY_TEST, dtype="float32")


def _inputs(seed, k, n, m):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, k)).astype(np.float32))


DENSE = _inputs(0, 256, 128, 4)
RS = _inputs(1, 256, 64, 2)
PACKED = _inputs(2, 1024, 128, 4)


@pytest.fixture(scope="module")
def ranks():
    jparams = init_params(JCFG, jax.random.key(0), dtype=jnp.float32)
    model = pack_model(jparams, JCFG, bits=4, group_size=64, fuse=False)
    t = lambda a: torch.from_numpy(a)
    job = {"kind": "call", "target": "torch_tp_worker:overlap_job",
           "dense_w": t(DENSE[0]), "dense_x": t(DENSE[1]), "rs_w": t(RS[0]), "rs_x": t(RS[1]),
           "packed_w": t(PACKED[0]), "packed_x": t(PACKED[1]), "cfg": torch_cfg(JCFG),
           "model": params_from_numpy(to_numpy_tree(model), "cpu"),
           "tokens": torch.from_numpy(np.arange(16).reshape(4, 4) % JCFG.vocab_size)}
    return spawn(job, world=WORLD)


def _jax_ring(w, x, **kw):
    mesh = jmake_mesh(dp=1, tp=WORLD, devices=jax.devices()[:WORLD])
    fn = jrow_parallel(jnp.asarray(w), "tp", mesh, **kw)
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_ring_all_reduce_matmul_matches_jax(ranks, kind):
    w, x = DENSE if kind == "dense" else PACKED
    kw = {} if kind == "dense" else {"packed_bits": 2, "group_size": 128}
    want = _jax_ring(w, x, **kw)
    if kind == "packed":  # per-shard grids == the whole weight's (G | K / tp)
        whole = np.asarray(quant_matmul_xla(jnp.asarray(x), jquantize_pack(jnp.asarray(w), 2, 128)))
        np.testing.assert_allclose(want, whole, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_allclose(want, x @ w, rtol=TOL, atol=TOL)
    for out in ranks:
        np.testing.assert_allclose(out[kind].numpy(), want, rtol=TOL, atol=TOL)


def test_reduce_scatter_matmul_chunks(ranks):
    """Rank r holds chunk r ([M, N / tp]) of the whole product."""
    w, x = RS
    got = np.concatenate([out["chunk"].numpy() for out in ranks], axis=1)
    np.testing.assert_allclose(got, x @ w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", [0, 1], ids=["prefill_s4", "decode_s1"])
def test_ring_tp_whole_model_matches_default(ranks, which):
    for out in ranks:
        ring, default = out["model_ring1"][which], out["model_ring0"][which]
        np.testing.assert_allclose(ring.numpy(), default.numpy(), rtol=MODEL_TOL, atol=MODEL_TOL)
        assert out["ring_leaves"] == 2  # o and down, each cut into its chunks once
