"""The port's plain decode attention against the JAX package's stacked
flash-decode kernel in interpret mode, driven as tests/test_decode_attention.py
drives it: GQA and MHA, per-slot starts including 0, a sliding window,
attn_len, and the int8 cache with raw [L, B, Hkv, T] scales.

Tolerances: with f32 caches both sides compute the same f32 sums in another
order (rtol/atol 1e-5). With bf16 and int8 caches both round the prob row to
bf16 before the PV product, but relative to different running maxima (the
kernel's T blocks vs one pass), so one bf16 ulp of the probs can differ:
atol/rtol 1e-2."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdistiller_tpu.ops.decode_attention  # noqa: F401
from bitdistiller_tpu_torch.ops import decode_attention as tda

jda = sys.modules["bitdistiller_tpu.ops.decode_attention"]


def _inputs(seed, b, hq, hkv, t, d, L, kind):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kn, vn = f(b, 1, hq, d), f(b, 1, hkv, d), f(b, 1, hkv, d)
    ks = vs = None
    if kind == "int8":
        kf, vf = f(L, b, hkv, t, d), f(L, b, hkv, t, d)
        ks = (np.abs(kf).max(-1) / 127.0 + 1e-8).astype(np.float32)
        vs = (np.abs(vf).max(-1) / 127.0 + 1e-8).astype(np.float32)
        ck = np.round(kf / ks[..., None]).astype(np.int8)
        cv = np.round(vf / vs[..., None]).astype(np.int8)
    else:
        ck, cv = f(L, b, hkv, t, d), f(L, b, hkv, t, d)
    return q, ck, cv, kn, vn, ks, vs


def _jax_array(a, kind):
    if a is None:
        return None
    if kind == "bf16" and a.dtype == np.float32:
        return jnp.asarray(a).astype(jnp.bfloat16)
    return jnp.asarray(a)


def _torch(a, kind):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t.bfloat16() if kind == "bf16" and t.dtype == torch.float32 else t


CASES = [
    # (b, hq, hkv, t, d, starts, window, attn_len)
    (2, 4, 4, 64, 128, [17, 64], None, None),  # MHA, one slot full
    (3, 8, 2, 128, 64, [0, 100, 33], None, None),  # GQA rep 4, start 0
    (2, 4, 2, 128, 128, [100, 40], 32, None),  # sliding window
    (2, 8, 8, 128, 64, [50, 9], None, 64),  # attn_len bounds the rows read
]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_jax_flash_decode(case, kind):
    b, hq, hkv, t, d, starts, window, attn_len = CASES[case]
    L, li = 3, 1
    q, ck, cv, kn, vn, ks, vs = _inputs(case, b, hq, hkv, t, d, L, kind)
    start = np.asarray(starts, np.int32)
    want = jda.flash_decode_stacked(
        _jax_array(q, kind), _jax_array(ck, kind), _jax_array(cv, kind),
        jnp.asarray(li, jnp.int32), _jax_array(kn, kind), _jax_array(vn, kind),
        jnp.asarray(start), k_scale=_jax_array(ks, kind), v_scale=_jax_array(vs, kind),
        window=window, attn_len=attn_len, interpret=True,
    )
    got = tda.flash_decode_stacked(
        _torch(q, kind), _torch(ck, kind), _torch(cv, kind), li, _torch(kn, kind),
        _torch(vn, kind), torch.from_numpy(start), k_scale=_torch(ks, kind),
        v_scale=_torch(vs, kind), window=window, attn_len=attn_len,
    )
    assert got.shape == (b, 1, hq, d)
    tol = 1e-5 if kind == "f32" else 1e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def test_start_zero_is_the_fresh_value():
    """start == 0: the fresh token attends only to itself."""
    q, ck, cv, kn, vn, _, _ = _inputs(9, 2, 4, 2, 16, 64, 1, "f32")
    out = tda.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), 0,
        torch.from_numpy(kn), torch.from_numpy(vn), torch.zeros(2, dtype=torch.int32),
    )
    np.testing.assert_allclose(out.numpy(), np.repeat(vn, 2, axis=2), rtol=1e-6, atol=1e-6)


def test_cpu_call_counts_plain_not_launch():
    q, ck, cv, kn, vn, _, _ = _inputs(3, 1, 2, 2, 8, 64, 2, "f32")
    before = (tda.flash_decode_stacked.launches, tda.flash_decode_stacked.plain_calls)
    tda.flash_decode_stacked(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), 1,
        torch.from_numpy(kn), torch.from_numpy(vn), torch.tensor([5], dtype=torch.int32),
    )
    assert tda.flash_decode_stacked.launches == before[0]
    assert tda.flash_decode_stacked.plain_calls == before[1] + 1
