"""The port's sampling against the JAX package's: greedy picks, top-k/top-p
masks and the repetition penalty are exact; stochastic draws use another
generator and are compared by distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.serve import sampling as js
from bitdistiller_tpu_torch.serve import sampling as ts


def _logits(seed, b=4, v=50):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32) * 3


def _prev(seed, b=4, w=6, v=50):
    p = np.random.default_rng(seed).integers(0, v, (b, w)).astype(np.int32)
    p[:, :2] = -1  # padding
    return p


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_greedy_equal(penalty):
    lg, prev = _logits(0), _prev(1)
    params = js.SamplingParams(temperature=0.0, repetition_penalty=penalty)
    want = js.sample_tokens(jax.random.key(0), jnp.asarray(lg), params, jnp.asarray(prev))
    got = ts.sample_tokens(torch.from_numpy(lg), ts.SamplingParams(
        temperature=0.0, repetition_penalty=penalty), torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masks_and_penalty_equal():
    lg, prev = _logits(2), _prev(3)
    for k in (1, 5):
        np.testing.assert_array_equal(
            ts._top_k_mask(torch.from_numpy(lg), k).numpy(),
            np.asarray(js._top_k_mask(jnp.asarray(lg), k)))
    for p in (0.1, 0.7, 0.95):
        np.testing.assert_array_equal(
            ts._top_p_mask(torch.from_numpy(lg), p).numpy(),
            np.asarray(js._top_p_mask(jnp.asarray(lg), p)))
    np.testing.assert_allclose(
        ts.apply_repetition_penalty(torch.from_numpy(lg), torch.from_numpy(prev), 1.7).numpy(),
        np.asarray(js.apply_repetition_penalty(jnp.asarray(lg), jnp.asarray(prev), 1.7)),
        rtol=1e-6)


def test_batched_greedy_rows_equal():
    lg, prev = _logits(4), _prev(5)
    temps = np.asarray([0.0, 0.0, 0.0, 0.0], np.float32)
    ks = np.asarray([0, 3, 1, 10], np.int32)
    ps = np.asarray([1.0, 0.5, 0.9, 1.0], np.float32)
    pens = np.asarray([1.0, 1.2, 1.5, 1.0], np.float32)
    want = js.sample_tokens_batched(jax.random.key(0), *(jnp.asarray(a) for a in (lg, temps, ks, ps, pens, prev)))
    got = ts.sample_tokens_batched(*(torch.from_numpy(a) for a in (lg, temps, ks, ps, pens, prev)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_draws_follow_the_distribution():
    """Temperature 1 on logits [0, 2]: P(token 1) = sigmoid(2) ~ 0.881;
    top-k 1 always draws the argmax."""
    gen = torch.Generator().manual_seed(0)
    lg = torch.tensor([[0.0, 2.0]]).repeat(4000, 1)
    draws = ts.sample_tokens(lg, ts.SamplingParams(temperature=1.0), generator=gen)
    assert abs(draws.float().mean().item() - 0.8808) < 0.03
    lg2 = torch.from_numpy(_logits(6))
    top1 = ts.sample_tokens(lg2, ts.SamplingParams(temperature=1.0, top_k=1), generator=gen)
    np.testing.assert_array_equal(top1.numpy(), lg2.argmax(-1).numpy())
    batched = ts.sample_tokens_batched(
        lg2, torch.ones(4), torch.ones(4, dtype=torch.int32), torch.ones(4), torch.ones(4),
        generator=gen)
    np.testing.assert_array_equal(batched.numpy(), lg2.argmax(-1).numpy())
