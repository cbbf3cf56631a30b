"""B8's f32 forward on the CPU: the arithmetic of
`train_attn_fwd_tf32_kernel` (both products, s = q k^T and o = p v, in
3xTF32: `tf32x3_matmul`; above D = 128 s as a split of ceil(D / 128) CTAs
takes it, 128-column chunks summed in rank order), emulated in plain
PyTorch by `train_attn_fwd_tf32x3_emulated`, against the port's plain f32
forward and the JAX package's f32 flash forward (the stock Pallas TPU flash
kernel under pltpu.force_tpu_interpret_mode(), as
tests/test_torch_train_attention.py runs it). D = 64, 128, 144, 256, 320
and 512, rep 1, 4 and 8, padded, a ragged S. Then the dispatch rule
(`fwd_plan`: f32 at D <= 128 on the kernel, at 128 < D <= 1024 on its
splits of ceil(D / 128) CTAs, bf16 on the wgmma kernel up to 256 and on
the f32 splits above, both above 1024 on the CUDA cores on column slices)
and the launch plan's CTAs, clusters and shared memory, which the wrapper
hands the CUDA launch (a recording stub here, as
tests/test_torch_train_attention_plan.py does for dkv).

Tolerance: 1e-4 of max|plain| per tensor, the bar the kernel is held to on
the card (chip_smoke.py: TRAIN_ATTN_TOL_F32), as the backward's; the lse
within 1e-5 absolute (f32 logs of sums near 1 to 100). One pass (plain
TF32) must miss the bar by at least 10x: why the kernel takes three."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitdistiller_tpu.models.layers import flash_train_attention as jax_flash
from bitdistiller_tpu_torch import _device
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
    (1, 100, 8, 2, 320),  # a split of 3 (C6's D = 320), rep 4
    (1, 70, 4, 1, 512),   # a split of 4, rep 4
]
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _case(b, s, hq, hkv, d):
    """Seeded inputs (the last batch row padded from 3/4 of S); the JAX
    forward, the plain forward and its lse, and the emulated forward at
    three passes and at one."""
    rng = np.random.default_rng(d + hq + 7)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[-1, s - s // 4:] = 0
    with pltpu.force_tpu_interpret_mode():
        jax_out = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask)))
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, mask))
    plain = ta.flash_train_attention_plain(tq, tk, tv, tm)
    scores = torch.einsum("bshrd,bthd->bhrst", tq.reshape(b, s, hkv, hq // hkv, d), tk)
    scores = torch.where(ta._allowed(s, tm, "cpu"), scores / math.sqrt(d), ta.MASK_VALUE)
    lse = torch.logsumexp(scores, -1).reshape(b, hq, s)
    emulated = {n: ta.train_attn_fwd_tf32x3_emulated(tq, tk, tv, tm, passes=n) for n in (3, 1)}
    return jax_out, plain.numpy(), lse.numpy(), {n: (o.numpy(), l.numpy())
                                                  for n, (o, l) in emulated.items()}


def _err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,s,hq,hkv,d", CASES)
def test_tf32x3_forward_holds_the_f32_bar(b, s, hq, hkv, d):
    jax_out, plain, lse, emulated = _case(b, s, hq, hkv, d)
    out, got_lse = emulated[3]
    assert _err(out, plain) <= TOL
    assert _err(out, jax_out) <= TOL
    assert _err(plain, jax_out) <= TOL
    np.testing.assert_allclose(got_lse, lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,s,hq,hkv,d", CASES)
def test_one_tf32_pass_misses_the_forward_bar_by_10x(b, s, hq, hkv, d):
    _, plain, _, emulated = _case(b, s, hq, hkv, d)
    three, one = _err(emulated[3][0], plain), _err(emulated[1][0], plain)
    assert one > TOL and one >= 10 * three


def test_emulation_takes_the_real_head_dims_scale():
    """A padded call (zero columns to 80) at the real D's scale is the
    unpadded function."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((1, 40, 2, 72)).astype(np.float32))
               for _ in range(3))
    pad = lambda t: torch.nn.functional.pad(t, (0, 8))
    want, want_lse = ta.train_attn_fwd_tf32x3_emulated(q, k, v, None)
    got, got_lse = ta.train_attn_fwd_tf32x3_emulated(pad(q), pad(k), pad(v), None,
                                                     scale=1 / math.sqrt(72))
    assert _err(got[..., :72].numpy(), want.numpy()) <= 1e-6 and not got[..., 72:].any()
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 48, 64, 80, 128, 144, 256, 320, 512, 1024, 1040])
def test_forward_dispatch_rule(d, dtype):
    plan = ta.fwd_plan(2, 300, 8, 2, d, dtype)
    ns = -(-d // 128)
    if d > ta.SPLIT_MAX_HEAD_DIM:
        want = "cores_wide"
    elif dtype == torch.bfloat16 and d <= ta.MAX_HEAD_DIM:
        want = "wgmma"
    else:  # f32, and bf16 above 256 on f32 copies
        want = "tf32x3" if d <= 128 else "tf32x3_split"
    assert plan.kernel == want
    assert plan.cluster == (ns if want == "tf32x3_split" else 1)
    if want in ("wgmma", "tf32x3"):  # a CTA a (query head, batch, 64-row query tile)
        assert plan.grid == (8, 2, 5)
    elif want == "tf32x3_split":  # ... and ns of them, on clusters of ns along x
        assert plan.grid == (8 * ns, 2, 5) and 2 <= ns <= ta.MAX_CLUSTER
    else:  # a warp a query row, 8 a CTA, and D's output columns in slices of 256
        assert plan.grid == (-(-300 // ta.F32_ROWS), 8, 2 * -(-d // ta.WIDE_COLS))
    assert ta.widened(dtype, d) == (dtype == torch.bfloat16 and want == "tf32x3_split")


@pytest.mark.parametrize("d,smem,ctas", [(16, 99888, 2), (64, 99888, 2), (80, 181808, 1),
                                         (128, 181808, 1), (144, 181824, 1), (256, 181824, 1),
                                         (320, 181824, 1), (512, 181824, 1), (1024, 181824, 1)])
def test_tf32_forward_launch_plan(d, smem, ctas):
    """Q (64 x DT f32), two stages of K and V as hi and lo planes, the p
    slot's planes, the rows' factors, segment ids and mbarriers (a split's
    two more, at any ns: its partial scores lie in the p hi slot): two CTAs
    an SM at DT = 64, one at 128 and for each CTA of a split (DT = 128 too),
    within the SM's 228 KB (1 KB reserved a CTA)."""
    plan = ta.fwd_plan(2, 1024, 32, 4, d, torch.float32)
    assert (plan.stages, plan.smem, plan.ctas_per_sm) == (2, smem, ctas)
    ns = ta.split_ctas(d)
    assert plan.cluster == ns and plan.grid == (32 * ns, 2, 16) and plan.ctas == 1024 * ns
    assert ctas * (plan.smem + 1024) <= 233472 < (ctas + 1) * (plan.smem + 1024)
    assert plan.smem <= 232448  # a block's limit


class _Stream:
    cuda_stream = 0


def _stub(monkeypatch):
    log = []

    def stub(name):
        def launch(*args):
            log.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(_device, "on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(ta, "_launcher", stub)
    return log


@pytest.mark.parametrize("d", [64, 128, 144, 256, 320, 512, 1024])
def test_wrapper_launches_the_plans_kernel(monkeypatch, d):
    """f32: the plan's kernel, its cluster (ns = 2, 3, 4, 8 at D = 256,
    320, 512, 1024; 1 at D <= 128) and the f32 flag go to the launch."""
    log = _stub(monkeypatch)
    q = torch.zeros((1, 70, 4, d))
    before = ta.train_attn_fwd.launches
    out, lse = ta.train_attn_fwd(q, q[:, :, :2], q[:, :, :2], None)
    assert ta.train_attn_fwd.launches == before + 1
    assert ta.train_attn_fwd.plan == ta.fwd_plan(1, 70, 4, 2, d, torch.float32)
    assert ta.train_attn_fwd.plan.kernel == ("tf32x3" if d <= 128 else "tf32x3_split")
    (name, args), = log
    assert name == "bd_train_attn_fwd" and args[6:11] == (1, 70, 4, 2, d) and args[-2] == 1
    assert args[11] == pytest.approx(1 / math.sqrt(d))
    assert args[12] == ta.split_ctas(d) == ta.train_attn_fwd.plan.cluster
    assert out.shape == q.shape and lse.shape == (1, 4, 70)


def test_bf16_forward_above_256_takes_the_split_on_f32_copies(monkeypatch):
    """bf16 at D = 320: the kernel gets f32 copies of q, k and v (not the
    bf16 tensors), the f32 flag and the split's cluster of 3; o comes back
    in bf16, the lse in f32."""
    log = _stub(monkeypatch)
    q = torch.zeros((1, 70, 4, 320), dtype=torch.bfloat16)
    k, v = torch.zeros((2, 1, 70, 2, 320), dtype=torch.bfloat16)
    out, lse = ta.train_attn_fwd(q, k, v, None)
    (name, args), = log
    assert name == "bd_train_attn_fwd" and args[6:11] == (1, 70, 4, 2, 320)
    assert args[12:14] == (3, 1)  # the plan's cluster, f32
    assert not {args[0], args[1], args[2]} & {q.data_ptr(), k.data_ptr(), v.data_ptr()}
    assert ta.train_attn_fwd.plan == ta.fwd_plan(1, 70, 4, 2, 320, torch.bfloat16)
    assert ta.train_attn_fwd.plan.kernel == "tf32x3_split"
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 70)
