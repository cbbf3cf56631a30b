"""The port's KD losses against the JAX package's train/losses.py: every
loss's value and its gradients in both logits (cakld_loss_fused against
JAX's custom VJP, the beta gradient included), on the same numpy logits
with padded labels.

Tolerance: 1e-5 relative (f32 log-softmax and reductions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.train import losses as jl
from bitdistiller_tpu_torch.train import losses as tl


def _case(seed=0, b=2, s=7, v=33, dtype=np.float32):
    rng = np.random.default_rng(seed)
    zs = (rng.standard_normal((b, s, v)) * 2).astype(dtype)
    zt = (rng.standard_normal((b, s, v)) * 2).astype(dtype)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, 5:] = -100
    labels[1, :2] = -100
    return labels, zs, zt


def _torch_vg(fn, labels, zs, zt):
    s = torch.tensor(zs, requires_grad=True)
    t = torch.tensor(zt, requires_grad=True)
    loss = fn(torch.tensor(labels, dtype=torch.int64), s, t)
    loss.backward()
    gt = t.grad.numpy() if t.grad is not None else np.zeros_like(zt)
    return loss.item(), s.grad.numpy(), gt


def _jax_vg(fn, labels, zs, zt):
    loss, (gs, gt) = jax.value_and_grad(lambda a, b: fn(jnp.asarray(labels), a, b),
                                        argnums=(0, 1))(jnp.asarray(zs), jnp.asarray(zt))
    return float(loss), np.asarray(gs), np.asarray(gt)


LOSSES = {
    "cakld": (lambda l, s, t: tl.cakld_loss(l, s, t, 0.37),
              lambda l, s, t: jl.cakld_loss(l, s, t, 0.37)),
    "jsd": (tl.jsd_loss, jl.jsd_loss),
    "forward": (lambda l, s, t: tl.forward_kl_loss(l, s, t, 2.0),
                lambda l, s, t: jl.forward_kl_loss(l, s, t, 2.0)),
    "reverse": (tl.reverse_kl_loss, jl.reverse_kl_loss),
    "tlsd": (tl.tlsd_loss, jl.tlsd_loss),
    "mse": (lambda l, s, t: tl.mse_loss(s, t), lambda l, s, t: jl.mse_loss(s, t)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_grads(name):
    labels, zs, zt = _case(seed=len(name))
    tf, jf = LOSSES[name]
    tv, tgs, tgt = _torch_vg(tf, labels, zs, zt)
    jv, jgs, jgt = _jax_vg(jf, labels, zs, zt)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tgs, jgs, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tgt, jgt, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["cakld", "jsd", "forward", "reverse", "tlsd", "mse"])
def test_kd_loss_dispatch(name):
    labels, zs, zt = _case(seed=3)
    tv, tgs, _ = _torch_vg(lambda l, s, t: tl.kd_loss(name, l, s, t.detach(), beta=0.6,
                                                      temperature=1.5), labels, zs, zt)
    jv, jgs, _ = _jax_vg(lambda l, s, t: jl.kd_loss(name, l, s, jax.lax.stop_gradient(t),
                                                    beta=0.6, temperature=1.5), labels, zs, zt)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tgs, jgs, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_cakld_fused_matches_jax_custom_vjp(dtype):
    """cakld_loss_fused's analytic backward, the beta gradient included, on
    f32 and bf16 logits (bf16: the inputs are the same bf16 values)."""
    labels, zs, zt = _case(seed=9, v=65)
    beta = 0.42
    if dtype == "bfloat16":
        zs = np.asarray(jnp.asarray(zs, jnp.bfloat16).astype(jnp.float32))
        zt = np.asarray(jnp.asarray(zt, jnp.bfloat16).astype(jnp.float32))
    s = torch.tensor(zs, requires_grad=True)
    b = torch.tensor(beta, requires_grad=True)
    loss = tl.cakld_loss_fused(torch.tensor(labels, dtype=torch.int64), s, torch.tensor(zt), b)
    loss.backward()
    jloss, (jgs, jgb) = jax.value_and_grad(
        lambda a, bb: jl.cakld_loss_fused(jnp.asarray(labels), a, jnp.asarray(zt), bb),
        argnums=(0, 1))(jnp.asarray(zs), jnp.asarray(beta, jnp.float32))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgs), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.grad.item(), float(jgb), rtol=1e-5, atol=1e-7)
    # and the fused form equals the golden cakld_loss
    s2 = torch.tensor(zs, requires_grad=True)
    tl.cakld_loss(torch.tensor(labels, dtype=torch.int64), s2, torch.tensor(zt), beta).backward()
    np.testing.assert_allclose(s.grad.numpy(), s2.grad.numpy(), rtol=1e-5, atol=1e-7)
