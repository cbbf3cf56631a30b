"""The arithmetic of B8's f32 backward kernels on the CPU: 3xTF32
(`tf32x3_matmul`: each operand split into hi = tf32(x) and lo =
tf32(x - hi), three products hi hi + hi lo + lo hi in f32), emulated in
plain PyTorch by `train_attn_bwd_tf32x3_emulated` (above D = 128 the score
products as the kernels' splits take them: ceil(D / 128) chunks of 128
columns, each in 3xTF32, summed in rank order), against the JAX package's
f32 flash gradients, run as tests/test_torch_train_attention.py runs them
(the stock Pallas TPU flash kernel under pltpu.force_tpu_interpret_mode()).
D = 64, 128, 144 and 256 (splits of 2), 272, 320 (of 3) and 512 (of 4),
rep 1, 2, 4 and 8, padded, a ragged S.

Tolerance: 1e-4 of max|JAX| per gradient, the bar the kernels are held to
on the card (chip_smoke.py: TRAIN_ATTN_TOL_F32). One pass (plain TF32,
hi hi alone) must miss it by at least 10x on the same inputs: why the
kernels take three. lse and di come from the port's plain f32 forward, as
the kernels take them from the forward kernel."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitdistiller_tpu.models.layers import flash_train_attention as jax_flash
from bitdistiller_tpu_torch.ops import train_attention as ta

CASES = [  # b, s, hq, hkv, d
    (2, 130, 2, 2, 64),   # MHA, rep 1
    (1, 130, 8, 1, 64),   # MQA, rep 8
    (2, 100, 2, 2, 128),  # rep 1, D = 128
    (1, 100, 8, 1, 128),  # rep 8, D = 128
    (2, 100, 2, 2, 144),  # a split of 2: rep 1, the second chunk mostly zero columns
    (1, 100, 8, 1, 144),  # ... rep 8
    (2, 100, 2, 2, 256),  # ... rep 1, D = 256
    (1, 100, 8, 1, 256),  # ... rep 8 (Gemma-2B's heads)
    (1, 100, 8, 2, 272),  # a split of 3: the third CTA's columns mostly zeros, rep 4
    (1, 100, 8, 1, 320),  # ... of 3, rep 8
    (1, 64, 4, 2, 512),   # ... of 4, rep 2
]
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _case(b, s, hq, hkv, d):
    """Seeded inputs (the last batch row padded from 3/4 of S), the JAX
    gradients, and the emulated ones at three passes and at one."""
    rng = np.random.default_rng(d + hq)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[-1, s - s // 4:] = 0
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x, y, z: jax_flash(x, y, z, jnp.asarray(mask)),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo, tm = (torch.tensor(x) for x in (q, k, v, do, mask))
    out = ta.flash_train_attention_plain(tq, tk, tv, tm)
    scores = torch.einsum("bshrd,bthd->bhrst", tq.reshape(b, s, hkv, hq // hkv, d), tk)
    scores = torch.where(ta._allowed(s, tm, "cpu"), scores / math.sqrt(d), ta.MASK_VALUE)
    lse = torch.logsumexp(scores, -1).reshape(b, hq, s)
    di = (out * tdo).sum(-1)
    got = {n: [g.numpy() for g in ta.train_attn_bwd_tf32x3_emulated(tq, tk, tv, tm, tdo, lse, di,
                                                                     passes=n)]
           for n in (3, 1)}
    return want, got


def _errs(want, got):
    return [float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("b,s,hq,hkv,d", CASES)
def test_tf32x3_backward_holds_the_f32_bar_against_jax(b, s, hq, hkv, d):
    want, got = _case(b, s, hq, hkv, d)
    for name, err in zip(("dq", "dk", "dv"), _errs(want, got[3])):
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("b,s,hq,hkv,d", CASES)
def test_one_tf32_pass_misses_the_bar_by_10x(b, s, hq, hkv, d):
    want, got = _case(b, s, hq, hkv, d)
    three, one = _errs(want, got[3]), _errs(want, got[1])
    assert max(one) > TOL
    for name, e3, e1 in zip(("dq", "dk", "dv"), three, one):
        assert e1 >= 10 * e3, (name, e1, e3)


def test_tf32_round_is_cvt_rna_on_the_bit_pattern():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -12, 1 + 2 ** -12, -(1 + 2 ** -11), 0.0, -3.5])
    assert ta.tf32_round(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 0.0,
                                         -3.5]  # ties away from zero


def test_hi_plus_lo_is_exact_and_both_are_tf32():
    x = torch.tensor(np.random.default_rng(1).standard_normal(4096).astype(np.float32)) * 1e3
    hi = ta.tf32_round(x)
    lo = x - hi
    for t in (hi, ta.tf32_round(lo)):
        assert (t.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.equal(hi + lo, x)
    assert ((lo - ta.tf32_round(lo)).abs() <= x.abs() * 2.0 ** -22).all()
