"""The port's per-layer decode attention `flash_decode_attention` (plain
version) against the JAX package's `experimental.flash_decode` kernel in
interpret mode, driven as tests/test_pallas_kernels.py drives it: GQA rep 1,
4 and 8, starts empty / partial / full, a sliding window, attn_len at a
block boundary, inside a block and at T; and the stacked decode attention at
rep 8 (the TinyLlama grouping) against JAX `flash_decode_stacked`.

Tolerances: f32 caches, atol/rtol 2e-5 as the JAX tests use (f32 sums in
another order). The stacked bf16 case rounds the prob row to bf16 against
other running maxima than JAX's T blocks: one bf16 ulp of a prob, 1e-2."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdistiller_tpu.ops.decode_attention  # noqa: F401
from bitdistiller_tpu.experimental.flash_decode import flash_decode_attention as jax_fda
from bitdistiller_tpu_torch.experimental.flash_decode import flash_decode_attention
from bitdistiller_tpu_torch.ops import decode_attention as tda

jda = sys.modules["bitdistiller_tpu.ops.decode_attention"]


def _inputs(seed, b, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, 1, hq, d), f(b, hkv, t, d), f(b, hkv, t, d), f(b, 1, hkv, d), f(b, 1, hkv, d)


def _both(arrays, start, **kw):
    want = jax_fda(*map(jnp.asarray, arrays), jnp.asarray(start), interpret=True, **kw)
    got = flash_decode_attention(*map(torch.from_numpy, arrays), torch.from_numpy(start), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1)])
def test_plain_matches_jax_at_each_rep(hq, hkv):
    arrays = _inputs(hq + hkv, 3, hq, hkv, 64, 128)
    start = np.asarray([0, 17, 64], np.int32)  # empty / partial / full
    got, want = _both(arrays, start, block_t=16)
    assert got.shape == (3, 1, hq, 128)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_sliding_window_matches_jax():
    arrays = _inputs(1, 2, 4, 4, 64, 128)
    got, want = _both(arrays, np.asarray([40, 64], np.int32), block_t=16, window=8)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("attn_len,block_t", [(32, 16), (40, 16), (128, 16), (32, 64)])
def test_attn_len_matches_jax(attn_len, block_t):
    """Block-aligned, inside a block, at T, and below one block; every start
    is below attn_len, as the JAX entry requires."""
    arrays = _inputs(2, 3, 8, 2, 128, 128)
    got, want = _both(arrays, np.asarray([0, 17, 30], np.int32), block_t=block_t,
                      attn_len=attn_len)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_stacked_rep8_matches_jax(kind):
    """B3's plain version at GQA rep 8 (32 query heads over 4 kv heads)."""
    rng = np.random.default_rng(8)
    b, hq, hkv, t, d, L, li = 2, 32, 4, 64, 64, 2, 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kn, vn = f(b, 1, hq, d), f(b, 1, hkv, d), f(b, 1, hkv, d)
    ck, cv = f(L, b, hkv, t, d), f(L, b, hkv, t, d)
    start = np.asarray([5, 64], np.int32)
    jt = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if kind == "bf16" else jnp.asarray
    tt = (lambda a: torch.from_numpy(a).bfloat16()) if kind == "bf16" else torch.from_numpy
    want = jda.flash_decode_stacked(jt(q), jt(ck), jt(cv), jnp.asarray(li, jnp.int32), jt(kn),
                                    jt(vn), jnp.asarray(start), interpret=True)
    got = tda.flash_decode_stacked(tt(q), tt(ck), tt(cv), li, tt(kn), tt(vn),
                                   torch.from_numpy(start))
    tol = 2e-5 if kind == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    assert 8 in tda.KERNEL_REPS


def test_cpu_runs_the_plain_version_and_checks_block_t():
    arrays = [torch.from_numpy(a) for a in _inputs(3, 2, 4, 2, 32, 64)]
    start = torch.tensor([3, 32], dtype=torch.int32)
    before = flash_decode_attention.launches
    out = flash_decode_attention(*arrays, start, block_t=48)  # halved to 16, as in JAX
    assert flash_decode_attention.launches == before
    q, ck, cv, kn, vn = arrays
    assert torch.equal(out, tda.decode_attention_plain(q, ck[None], cv[None], 0, kn, vn, start))
    with pytest.raises(ValueError, match="block_t"):
        flash_decode_attention(*arrays, start, block_t=0)
