"""The port's plain decode attention against the JAX package's stacked
flash-decode kernel in interpret mode, driven as tests/test_decode_attention.py
drives it: GQA and MHA, per-slot starts including 0, a sliding window,
attn_len, and the int8 cache with raw [L, B, Hkv, T] scales. The CUDA
kernel's split of each slot's rows over a cluster, with its rank-ordered
merge, is mirrored here (`split_merge`) and held against both, and its
cluster plan (`attention_plan`) is pinned.

Tolerances: with f32 caches both sides compute the same f32 sums in another
order (rtol/atol 1e-5). With bf16 and int8 caches both round the prob row to
bf16 before the PV product, but relative to different running maxima (the
kernel's T blocks vs one pass), so one bf16 ulp of the probs can differ:
atol/rtol 1e-2."""

import math
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


@pytest.mark.parametrize("b,hkv,sms,want", [
    (8, 32, 132, 1),  # Llama-2-7B at batch 8: 256 pairs fill one wave of 2 x 132
    (8, 4, 132, 8),   # TinyLlama, GQA rep 8: 32 pairs, the largest cluster
    (1, 32, 132, 8),  # one slot of the 7B
    (4, 32, 132, 2),  # the 7B at batch 4: 256 CTAs
    (8, 32, 8, 1),    # a small card: the pairs overfill it alone
])
def test_attention_plan(b, hkv, sms, want):
    """The largest cluster, at most 8, whose CTAs fit the card at two an SM."""
    c = tda.attention_plan(b, hkv, sms)
    assert c == want
    assert c == 1 or b * hkv * c <= 2 * sms
    assert c == tda.MAX_CLUSTER or b * hkv * (c + 1) > 2 * sms


def split_merge(q, ck, cv, li, kn, vn, start, clusters, *, k_scale=None, v_scale=None,
                window=None, attn_len=None):
    """The kernel's split, mirrored on the CPU: each (slot, kv head)'s valid
    rows [t_lo, t_hi) cut into `clusters` contiguous runs (run r is
    [t_lo + r*n // C, t_lo + (r+1)*n // C), n = t_hi - t_lo; a run may be
    empty), each run's softmax state (max m, sum l, acc) from its own rows
    with the prob row rounded as the kernel rounds it (bf16(p), or
    bf16(p * s_t) for int8; none for an f32 cache), an empty run m = -1e30,
    l = 0; the states merged in rank order, the fresh token folded last."""
    b, _, hq, d = q.shape
    hkv, t = ck.shape[2], ck.shape[3]
    rep = hq // hkv
    t_lim = t if attn_len is None or attn_len > t else attn_len
    scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, hkv, rep, d), dtype=torch.float32)
    for bi in range(b):
        st = int(start[bi])
        t_hi = min(st, t_lim)
        t_lo = max(0, st - window + 1) if window else 0
        n = max(t_hi - t_lo, 0)
        for h in range(hkv):
            qg = q[bi, 0, h * rep:(h + 1) * rep].float()
            states = []
            for r in range(clusters):
                lo, hi = t_lo + r * n // clusters, t_lo + (r + 1) * n // clusters
                if hi <= lo:
                    states.append((torch.full((rep,), -1e30), torch.zeros(rep),
                                   torch.zeros((rep, d))))
                    continue
                s = qg @ ck[li, bi, h, lo:hi].float().T * scale
                if k_scale is not None:
                    s = s * k_scale[li, bi, h, lo:hi].float()
                m = s.amax(-1)
                p = torch.exp(s - m[:, None])
                if v_scale is not None:
                    pv = (p * v_scale[li, bi, h, lo:hi].float()).bfloat16().float()
                else:
                    pv = p.to(cv.dtype).float()
                states.append((m, p.sum(-1), pv @ cv[li, bi, h, lo:hi].float()))
            mx = torch.stack([m for m, _, _ in states]).amax(0)
            lsum, acc = torch.zeros(rep), torch.zeros((rep, d))
            for m, l, a in states:  # rank order
                f = torch.exp(m - mx)
                lsum, acc = lsum + l * f, acc + a * f[:, None]
            sn = (qg * kn[bi, 0, h].float()).sum(-1) * scale
            mf = torch.maximum(mx, sn)
            alpha, pn = torch.exp(mx - mf), torch.exp(sn - mf)
            out[bi, h] = ((acc * alpha[:, None] + pn[:, None] * vn[bi, 0, h].float())
                          / (lsum * alpha + pn)[:, None])
    return out.to(q.dtype).reshape(b, 1, hq, d)


SPLIT_CASES = [
    # (b, hq, hkv, t, d, starts, window, attn_len)
    (3, 4, 4, 64, 64, [0, 3, 6], None, None),  # fewer rows than CTAs: empty runs; start 0
    (2, 4, 2, 128, 128, [100, 40], 33, None),  # the window crosses run boundaries
    (2, 8, 8, 128, 64, [50, 9], None, 64),     # attn_len bounds the rows read
    (2, 32, 4, 64, 64, [64, 17], None, None),  # GQA rep 8
]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_rank_ordered_split_matches_plain_and_jax(case, kind):
    """Splitting the rows over C = 1, 2, 3, 8 CTAs and merging their states
    in rank order computes the attention: against the plain version and
    JAX's stacked kernel in interpret mode. Tolerances as above: f32 1e-5
    (the same sums in another order); bf16 and int8 1e-2 (the prob row is
    rounded against each run's maximum, not one global maximum)."""
    b, hq, hkv, t, d, starts, window, attn_len = SPLIT_CASES[case]
    L, li = 2, 1
    q, ck, cv, kn, vn, ks, vs = _inputs(100 + case, b, hq, hkv, t, d, L, kind)
    start = np.asarray(starts, np.int32)
    kw = dict(window=window, attn_len=attn_len)
    tt = [_torch(a, kind) for a in (q, ck, cv, kn, vn, ks, vs)]
    plain = tda.decode_attention_plain(*tt[:3], li, *tt[3:5], torch.from_numpy(start),
                                       k_scale=tt[5], v_scale=tt[6], **kw).float().numpy()
    want = np.asarray(jda.flash_decode_stacked(
        _jax_array(q, kind), _jax_array(ck, kind), _jax_array(cv, kind),
        jnp.asarray(li, jnp.int32), _jax_array(kn, kind), _jax_array(vn, kind),
        jnp.asarray(start), k_scale=_jax_array(ks, kind), v_scale=_jax_array(vs, kind),
        interpret=True, **kw), np.float32)
    tol = 1e-5 if kind == "f32" else 1e-2
    for clusters in (1, 2, 3, 8):
        got = split_merge(*tt[:3], li, *tt[3:5], torch.from_numpy(start), clusters,
                          k_scale=tt[5], v_scale=tt[6], **kw).float().numpy()
        np.testing.assert_allclose(got, plain, rtol=tol, atol=tol, err_msg=f"C={clusters}")
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=f"C={clusters}")


def test_decode_ablation_attention_patches_apply():
    """scripts/decode_ablation.py patches the decode attention kernel's
    source by text: every patch still applies, once, and each variant
    differs from the kernel and from the others."""
    from bitdistiller_tpu_torch.ops import _build
    from bitdistiller_tpu_torch.scripts import decode_ablation

    src = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    texts = decode_ablation.attention_variants(src)
    assert texts["kernel"] == src
    assert len(set(texts.values())) == len(texts)
