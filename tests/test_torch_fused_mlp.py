"""The port's fused packed MLP (plain version) against the JAX package's
`experimental.fused_mlp.fused_mlp` with the Pallas kernel in interpret mode,
at the widths of tests/test_pallas_kernels.py (K=256, FFN=512, D=256), for
the three activation names at int2 and int4.

Tolerance: |port - JAX| <= 2^-8 * (|mid| @ |Wd|) + 1e-4 * max|ref|,
elementwise. Both sides feed bf16 x and bf16 mid to f32 products, but the
f32 gate/up sums and the activation (XLA's on one side, PyTorch's on the
other) can differ in the last bit, and where mid sits at a bf16 rounding
boundary that moves bf16(mid) by one bf16 ulp (2^-8 relative): the first
term bounds one such ulp in every mid element, carried through the down
product; the second is f32 summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bitdistiller_tpu.experimental.fused_mlp import fused_mlp as jax_fused_mlp
from bitdistiller_tpu.quant.packing import PackedLinear as JP
from bitdistiller_tpu.quant.packing import pack_codes as jpack
from bitdistiller_tpu_torch.experimental import fused_mlp as tfm
from bitdistiller_tpu_torch.quant.packing import PackedLinear as TP

K, FFN, D, G = 256, 512, 256, 128


def _layer(rng, k, n, bits):
    codes = rng.integers(0, 2**bits, (k, n)).astype(np.int32)
    scales = (rng.random((k // G, n)) * 0.02 + 0.005).astype(np.float32)
    szeros = (scales * rng.integers(0, 2**bits, (k // G, n))).astype(np.float32)
    qw = np.array(jpack(jnp.asarray(codes), bits, G))
    jp = JP(qweight=jnp.asarray(qw), scales=jnp.asarray(scales), szeros=jnp.asarray(szeros),
            bias=None, bits=bits, group_size=G, in_features=k, out_features=n)
    tp = TP(qweight=torch.from_numpy(qw), scales=torch.from_numpy(scales),
            szeros=torch.from_numpy(szeros), bias=None, bits=bits, group_size=G,
            in_features=k, out_features=n)
    return jp, tp


def _dense(jp):
    """The dequantized f32 [K, N] weight of a JAX PackedLinear."""
    from bitdistiller_tpu.quant.packing import dequantize_linear

    return np.asarray(dequantize_linear(jp), np.float64)


def _assert_close(got, want, x, jl, act):
    g, u = x @ _dense(jl[0]), x @ _dense(jl[1])
    mid = np.asarray(jax.nn.silu(g) if act == "silu" else jax.nn.gelu(g)) * u
    bound = 2.0**-8 * (np.abs(mid) @ np.abs(_dense(jl[2])))
    err = np.abs(got.reshape(want.shape) - want)
    assert (err <= bound.reshape(want.shape) + 1e-4 * np.abs(want).max()).all(), err.max()


def _mlp(seed, bits, m=4):
    rng = np.random.default_rng(seed)
    layers = [_layer(rng, K, FFN, bits), _layer(rng, K, FFN, bits), _layer(rng, FFN, D, bits)]
    x = rng.standard_normal((m, K)).astype(np.float32)
    return x, [j for j, _ in layers], [t for _, t in layers]


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("bits", [2, 4])
def test_plain_matches_jax_fused_mlp(bits, act):
    x, jl, tl = _mlp(bits * 10 + len(act), bits)
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), *jl, act, interpret=True))
    got = tfm.fused_mlp(torch.from_numpy(x), *tl, act).numpy()
    assert got.shape == (4, D)
    _assert_close(got, want, x, jl, act)


def test_block_f_sets_the_tile_order_as_in_jax():
    """A narrower ffn tile (block_f=128: four tiles) against JAX at the same
    block_f, on a 3-D input."""
    x, jl, tl = _mlp(5, 2, m=6)
    x3 = x.reshape(2, 3, K)
    want = np.asarray(jax_fused_mlp(jnp.asarray(x3), *jl, "silu", block_f=128, interpret=True))
    got = tfm.fused_mlp(torch.from_numpy(x3), *tl, "silu", block_f=128).numpy()
    assert got.shape == (2, 3, D)
    _assert_close(got, want, x, jl, "silu")


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True, so the JAX kernel's "gelu"
    is the tanh GELU, which is what the port computes for it: equal to the
    fallback name bit for bit, and not the erf GELU."""
    z = np.linspace(-4, 4, 101).astype(np.float32)
    tanh_form = F.gelu(torch.from_numpy(z), approximate="tanh").numpy()
    np.testing.assert_allclose(np.asarray(jax.nn.gelu(jnp.asarray(z))), tanh_form,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(tanh_form - F.gelu(torch.from_numpy(z)).numpy()).max() > 1e-4
    x, _, tl = _mlp(6, 4)
    a = tfm.fused_mlp(torch.from_numpy(x), *tl, "gelu")
    assert torch.equal(a, tfm.fused_mlp(torch.from_numpy(x), *tl, "anything-else"))
    assert not torch.equal(a, tfm.fused_mlp(torch.from_numpy(x), *tl, "silu"))


def test_cpu_runs_the_plain_version_and_checks_shapes():
    x, _, (g, u, d) = _mlp(7, 2)
    before = tfm.fused_mlp.launches
    out = tfm.fused_mlp(torch.from_numpy(x), g, u, d)
    assert tfm.fused_mlp.launches == before
    assert torch.equal(out, tfm.fused_mlp_plain(torch.from_numpy(x), g, u, d))
    with pytest.raises(ValueError, match="widths"):
        tfm.fused_mlp(torch.from_numpy(x), g, u, g)


@pytest.mark.parametrize("m", [1, 33])
@pytest.mark.parametrize("bits", [2, 4])
def test_plain_matches_jax_at_an_odd_group_count(bits, m):
    """FFN = 640, 5 groups of 128: the JAX entry halves block_f to 128 (five
    ffn tiles), and the card's down launch splits 5 groups over its cluster
    with a remainder. The plain version, which the card holds the kernel
    against, agrees with JAX there."""
    rng = np.random.default_rng(100 + 10 * bits + m)
    layers = [_layer(rng, K, 640, bits), _layer(rng, K, 640, bits), _layer(rng, 640, D, bits)]
    jl, tl = [j for j, _ in layers], [t for _, t in layers]
    x = rng.standard_normal((m, K)).astype(np.float32)
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), *jl, "silu", interpret=True))
    got = tfm.fused_mlp(torch.from_numpy(x), *tl, "silu").numpy()
    assert got.shape == (m, D)
    _assert_close(got, want, x, jl, "silu")


@pytest.mark.parametrize("k,ffn,d,sms,want", [
    (4096, 11008, 4096, 132, (4, 8)),  # 7B: 86 ffn tiles x 4; down as the 7B down matmul
    (256, 640, 256, 132, (2, 5)),      # the tests' widths: clusters capped by the groups
    (4096, 11008, 4096, 8, (1, 1)),    # a small card
])
def test_mlp_plan_sizes_both_launches(k, ffn, d, sms, want):
    assert tfm.mlp_plan(k, ffn, d, sms) == want
