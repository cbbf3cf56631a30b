"""`train_attn_bwd_dq_plain`, B8's dq by itself from the dq kernel's own
inputs (q, k, v, the segment ids, dO, the f32 log-sum-exp and
di = rowsum(o * dO)), against two references on the same numpy inputs:

- autograd's dq of the port's `flash_train_attention_plain`;
- the JAX package's dq: the vjp of `flash_train_attention`, run as
  tests/test_torch_train_attention.py runs it (the stock Pallas TPU flash
  kernel under pltpu.force_tpu_interpret_mode()).

lse and di come from the plain forward in f32. Cases: MHA and GQA rep 2, 4
and 8, padded and unpadded, S = 129 and 200 (ragged against the 64-row
tiles), D = 64, 128 and 256, all inputs f32.

Tolerance: 1e-4 of max|reference| (f32 throughout; the references sum
the softmax and its gradient in another order: autograd through softmax,
the Pallas kernel block by block). Pad rows compute the same function in
all three (segment ids follow the mask) and are compared too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitdistiller_tpu.models.layers import flash_train_attention as jax_flash
from bitdistiller_tpu_torch.ops import train_attention as ta

CASES = [  # b, s, hq, hkv, d, padded
    (1, 129, 2, 2, 64, True),    # MHA, S = 129: one row past two tiles
    (2, 200, 4, 2, 64, False),   # rep 2, ragged S
    (1, 200, 4, 1, 128, True),   # rep 4, D = 128, padded
    (1, 129, 8, 1, 64, True),    # rep 8 (MQA), padded
    (2, 129, 16, 2, 128, False),  # rep 8 over two kv heads, two batches
    (1, 129, 2, 1, 256, True),   # rep 2, D = 256, padded
    (1, 200, 2, 2, 256, False),  # MHA, D = 256, ragged S
]


def _case(b, s, hq, hkv, d, padded, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    mask = None
    if padded:
        mask = np.ones((b, s), np.int32)
        mask[-1, s - s // 4:] = 0
    return q, k, v, do, mask


def _dq_inputs(q, k, v, do, mask):
    """torch tensors of the dq kernel's inputs: (q, k, v, seg, do, lse, di)."""
    q, k, v, do = (torch.tensor(x) for x in (q, k, v, do))
    seg = None if mask is None else torch.tensor(mask)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bshrd,bthd->bhrst", qg, k) / np.sqrt(d)
    scores = torch.where(ta._allowed(s, seg, q.device), scores, ta.MASK_VALUE)
    lse = torch.logsumexp(scores, dim=-1).reshape(b, hq, s)
    di = (ta.flash_train_attention_plain(q, k, v, seg) * do).sum(-1)
    return q, k, v, seg, do, lse, di


def _autograd_dq(q, k, v, do, mask):
    tq = torch.tensor(q, requires_grad=True)
    out = ta.flash_train_attention_plain(tq, torch.tensor(k), torch.tensor(v),
                                         None if mask is None else torch.tensor(mask))
    out.backward(torch.tensor(do))
    return tq.grad.numpy()


def _jax_dq(q, k, v, do, mask):
    m = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: jax_flash(a, jnp.asarray(k), jnp.asarray(v), m),
                         jnp.asarray(q))
        (dq,) = vjp(jnp.asarray(do))
    return np.asarray(dq)


@pytest.mark.parametrize("b,s,hq,hkv,d,padded", CASES)
def test_dq_plain_matches_autograd(b, s, hq, hkv, d, padded):
    case = _case(b, s, hq, hkv, d, padded)
    got = ta.train_attn_bwd_dq_plain(*_dq_inputs(*case)).numpy()
    want = _autograd_dq(*case)
    assert got.shape == want.shape == (b, s, hq, d)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("b,s,hq,hkv,d,padded", CASES)
def test_dq_plain_matches_jax_flash_dq(b, s, hq, hkv, d, padded):
    case = _case(b, s, hq, hkv, d, padded, seed=1)
    got = ta.train_attn_bwd_dq_plain(*_dq_inputs(*case)).numpy()
    want = _jax_dq(*case)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_dq_plain_keeps_the_input_dtype_and_launches_nothing():
    q, k, v, seg, do, lse, di = _dq_inputs(*_case(1, 70, 4, 2, 32, True, seed=2))
    before = ta.train_attn_bwd_dq.launches
    got = ta.train_attn_bwd_dq_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), seg,
                                     do.bfloat16(), lse, di)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert ta.train_attn_bwd_dq.launches == before
