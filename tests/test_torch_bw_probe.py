"""The HBM probe's plain stream sum (the CUDA kernel's reference) against
numpy on small bf16 and int8 plane sets, and the chaining rule of the JAX
probe: c' = c * 1e-6 + (sum K + sum V) * 1e-9 on every call.

Tolerance: rtol 1e-6 against float64 numpy (f32 sums of a few thousand
O(1) values)."""

import numpy as np
import torch

from bitdistiller_tpu_torch.scripts import bw_probe


def _planes(dtype, seed=0, shape=(2, 3, 4, 16, 8)):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen)
        v = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen)
    else:
        k = torch.rand(shape, generator=gen).bfloat16()
        v = torch.rand(shape, generator=gen).bfloat16()
    return k, v


def _np_sum(a):
    return a.to(torch.float64).sum().item()


def test_plain_stream_sum_matches_numpy():
    for dtype in (torch.bfloat16, torch.int8):
        k, v = _planes(dtype)
        c = torch.tensor([2.5])
        got = bw_probe.stream_sum_plain(k, v, c)
        want = 2.5 * 1e-6 + (_np_sum(k) + _np_sum(v)) * 1e-9
        assert got.shape == (1,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_chained_calls_follow_the_jax_rule():
    k, v = _planes(torch.bfloat16, seed=1)
    total = (_np_sum(k) + _np_sum(v)) * 1e-9
    c = torch.zeros(1)
    want = 0.0
    for _ in range(3):
        c = bw_probe.stream_sum(k, v, c)  # CPU tensors: the plain version
        want = want * 1e-6 + total
    np.testing.assert_allclose(c.item(), want, rtol=1e-6)


def test_cpu_stream_sum_launches_nothing():
    k, v = _planes(torch.int8, seed=2)
    before = bw_probe.stream_sum.launches
    out = bw_probe.stream_sum(k, v, torch.ones(1))
    assert bw_probe.stream_sum.launches == before
    assert torch.equal(out, bw_probe.stream_sum_plain(k, v, torch.ones(1)))
