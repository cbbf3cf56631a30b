"""The port's `flash_train_attention_plain` (what B8's kernels are held to on
the card) against the JAX package's `flash_train_attention`, run as
tests/test_train_flash_attention.py runs it on the CPU: the stock Pallas TPU
flash kernel under pltpu.force_tpu_interpret_mode(), wrapping trace,
lowering and run. Value and dq/dk/dv, MHA and GQA (rep 2 and 4), padded and
unpadded, S = 256 and a ragged S, D = 64 and 128, and above 128, the D the
wide dkv kernel serves: 256 and 160 (which JAX zero-pads to 256); f32
inputs.

Tolerance: 1e-4 of max|JAX| per tensor (both f32; the Pallas kernel sums
block by block with an online softmax, the plain version in one pass).
Segment ids follow the padding mask in both, so pad rows compute the same
function and are compared too. Also here: the CPU dispatch of the wrapper
(CPU tensors take the plain version; no kernel counter moves)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitdistiller_tpu.models.layers import flash_train_attention as jax_flash
from bitdistiller_tpu_torch.ops import train_attention as ta


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


def _jax(q, k, v, do, mask):
    m = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, m),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _torch(fn, q, k, v, do, mask):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(tq, tk, tv, None if mask is None else torch.tensor(mask))
    out.backward(torch.tensor(do))
    return [out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()]


@pytest.mark.parametrize("b,s,hq,hkv,d,padded", [
    (1, 256, 2, 2, 64, False),   # MHA, S = 256, D = 64
    (2, 256, 4, 2, 128, True),   # GQA rep 2, padded, D = 128
    (1, 200, 4, 1, 64, True),    # rep 4, ragged S, padded
    (2, 200, 2, 2, 128, False),  # ragged S, unpadded, D = 128
    (1, 130, 4, 2, 256, True),   # D = 256, GQA rep 2, padded, ragged S
    (1, 130, 2, 2, 160, False),  # D = 160 (JAX pads it to 256), MHA, unpadded
])
def test_plain_matches_jax_flash_value_and_grads(b, s, hq, hkv, d, padded):
    case = _case(b, s, hq, hkv, d, padded)
    want = _jax(*case)
    got = _torch(ta.flash_train_attention_plain, *case)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


def test_cpu_tensors_take_the_plain_version():
    case = _case(1, 70, 4, 2, 32, True, seed=1)
    before = (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
              ta.train_attn_bwd_dq.launches)
    got = _torch(ta.flash_train_attention, *case)
    want = _torch(ta.flash_train_attention_plain, *case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
            ta.train_attn_bwd_dq.launches) == before


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 2, 24))  # D not a multiple of 16
    with pytest.raises(ValueError, match="multiple of 16"):
        ta._check(q, q[:, :, :1], q[:, :, :1], None)
    q = torch.zeros((1, 8, 2, 32), dtype=torch.float16)
    with pytest.raises(ValueError, match="one dtype"):
        ta._check(q, q[:, :, :1], q[:, :, :1], None)
