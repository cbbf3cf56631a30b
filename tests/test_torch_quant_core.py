"""The port's quant/core.py against the JAX package's, on the same numpy
inputs: values and gradients of every function, int2/3/4 and NF3 at groups
32, 64, 128 and -1 (one group a row), both roundings, a tie of the group
max, f32 and bf16 weights.

Tolerances: f32 values within 1e-6 (the same f32 operations; the sums of
the gradient paths in another order: 1e-5); bf16 weights: XLA on the CPU may
keep f32 precision between bf16 operations where PyTorch rounds after each
one, so a value can land one quantization step away; at least 99% of the
elements agree exactly and every one is within one step (the group's
scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.quant import core as jcore
from bitdistiller_tpu_torch.quant import core as tcore

GROUPS = [32, 64, 128, -1]


def _w(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _grad_torch(fn, w, cot):
    t = torch.tensor(w, requires_grad=True)
    out = fn(t)
    if not out.requires_grad:  # e.g. PTQ NF3: nothing in the graph, a zero gradient
        return out.numpy(), np.zeros_like(w)
    out.backward(torch.tensor(cot))
    return out.detach().numpy(), t.grad.numpy()


def _grad_jax(fn, w, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(w))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def test_round_half_away_and_half_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -0.51], np.float32)
    np.testing.assert_array_equal(tcore.round_half_away(torch.tensor(x)).numpy(),
                                  np.asarray(jcore.round_half_away(jnp.asarray(x))))
    np.testing.assert_array_equal(torch.round(torch.tensor(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


def test_ste_round_and_clip_gradients():
    x = np.array([-1.0, 0.0, 0.4, 3.0, 3.5, 4.0], np.float32)
    cot = np.arange(1, 7, dtype=np.float32)
    for tf, jf in ((tcore.ste_round, jcore.ste_round),
                   (lambda v: tcore.clip_torch_grad(v, 0.0, 3.0),
                    lambda v: jcore.clip_torch_grad(v, 0.0, 3.0))):
        tv, tg = _grad_torch(tf, x, cot)
        jv, jg = _grad_jax(jf, x, cot)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("n_bit", [2, 3, 4])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("ste", [False, True])
def test_fake_quant_int_values_and_grads(n_bit, group, ste):
    w = _w((6, 256), seed=n_bit)
    cot = _w((6, 256), seed=7)
    tv, tg = _grad_torch(lambda t: tcore.fake_quant_int(t, n_bit, group, ste=ste), w, cot)
    jv, jg = _grad_jax(lambda t: jcore.fake_quant_int(t, n_bit, group, ste=ste), w, cot)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant_type", ["int2-asym", "int3-asym", "int4-asym", "ste-n2f3",
                                        "nf3", "int2", "int4"])
@pytest.mark.parametrize("group", GROUPS)
def test_weight_quantizer_values_and_grads(quant_type, group):
    """The [K, N] weight quantizer (groups along K), stacked [L, K, N] too."""
    w = _w((2, 256, 48), seed=3)
    cot = _w((2, 256, 48), seed=4)
    tq = tcore.make_weight_quantizer(quant_type, group)
    jq = jcore.make_weight_quantizer(quant_type, group)
    tv, tg = _grad_torch(tq, w, cot)
    jv, jg = _grad_jax(jax.vmap(jq), w, cot)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", GROUPS)
def test_fake_quant_nf3_values_and_grads(group):
    w = _w((4, 256), seed=11)
    w[0] = np.abs(w[0])  # an all-positive row: scale_neg 0 is guarded
    cot = _w((4, 256), seed=12)
    for ste in (False, True):
        tv, tg = _grad_torch(lambda t: tcore.fake_quant_nf3(t, group, ste=ste), w, cot)
        jv, jg = _grad_jax(lambda t: jcore.fake_quant_nf3(t, group, ste=ste), w, cot)
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


def test_max_min_tie_splits_the_gradient():
    """Two elements share the group max: both ports split its gradient."""
    w = np.array([[0.5, 2.0, -1.0, 2.0, 0.25, -3.0, 1.0, -3.0]], np.float32)
    cot = np.linspace(-1, 1, 8, dtype=np.float32)[None]
    tv, tg = _grad_torch(lambda t: tcore.fake_quant_int(t, 2, 8, ste=True), w, cot)
    jv, jg = _grad_jax(lambda t: jcore.fake_quant_int(t, 2, 8, ste=True), w, cot)
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    tv, tg = _grad_torch(lambda t: tcore.fake_quant_nf3(t, 8, ste=True), w, cot)
    jv, jg = _grad_jax(lambda t: jcore.fake_quant_nf3(t, 8, ste=True), w, cot)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_bit", [2, 4])
@pytest.mark.parametrize("group", GROUPS)
def test_quantize_dequantize_int(n_bit, group):
    w = _w((5, 256), seed=21)
    tq, tp = tcore.quantize_int(torch.tensor(w), n_bit, group)
    jq, jp = jcore.quantize_int(jnp.asarray(w), n_bit, group)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tp.scales.numpy(), np.asarray(jp.scales), rtol=1e-7)
    np.testing.assert_array_equal(tp.zeros.numpy(), np.asarray(jp.zeros))
    td = tcore.dequantize_int(tq.to(torch.float32), tp, w.shape)
    jd = jcore.dequantize_int(jq.astype(jnp.float32), jp, w.shape)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    tpar = tcore.asym_quant_params(torch.tensor(w).reshape(5, -1, 64), n_bit)
    jpar = jcore.asym_quant_params(jnp.asarray(w).reshape(5, -1, 64), n_bit)
    np.testing.assert_allclose(tpar.scales.numpy(), np.asarray(jpar.scales), rtol=1e-7)


@pytest.mark.parametrize("group", GROUPS)
def test_quantize_dequantize_nf3(group):
    w = _w((3, 256), seed=31)
    tc, tsp, tsn = tcore.quantize_nf3(torch.tensor(w), group)
    jc, jsp, jsn = jcore.quantize_nf3(jnp.asarray(w), group)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp))
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn))
    td = tcore.dequantize_nf3(tc, tsp, tsn, w.shape)
    jd = jcore.dequantize_nf3(jc, jsp, jsn, w.shape)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


def test_make_fake_quantizer_names():
    w = _w((2, 128), seed=41)
    for name in ("int2-asym", "int3", "nf3", "ste-n2f3"):
        tv = tcore.make_fake_quantizer(name, 64)(torch.tensor(w)).numpy()
        jv = np.asarray(jcore.make_fake_quantizer(name, 64)(jnp.asarray(w)))
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    for bad in ("int", "fp8"):
        with pytest.raises(ValueError):
            tcore.make_fake_quantizer(bad, 64)


@pytest.mark.parametrize("quant_type", ["int2-asym", "ste-n2f3"])
@pytest.mark.parametrize("group", [64, -1])
def test_weight_quantizer_in_bf16(quant_type, group):
    """bf16 weights quantize in bf16 in both packages (see the module
    docstring for the tolerance)."""
    w = _w((256, 48), seed=51)
    tv = tcore.make_weight_quantizer(quant_type, group)(
        torch.tensor(w).to(torch.bfloat16)).to(torch.float32).numpy()
    jv = np.asarray(jcore.make_weight_quantizer(quant_type, group)(
        jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    g = 256 if group < 1 else group
    wg = w.reshape(256 // g, g, 48)
    step = (wg.max(axis=1) - wg.min(axis=1)) / 3.0  # int2 steps; NF3's are narrower
    step = np.repeat(step, g, axis=0).reshape(256, 48) * 1.02 + 1e-2
    same = np.mean(tv == jv)
    assert same >= 0.99, same
    assert np.all(np.abs(tv - jv) <= step)
