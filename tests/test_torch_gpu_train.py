"""The training-path kernels on the card: B8's causal flash attention
(forward, dkv, dq) against `flash_train_attention_plain`, and the packed
kernels at the cases the C1 repair added (group sizes 32, 64 and
per-channel, f32 activations, decode attention at D = 256 and with f32 q)
against their plain versions. Marked `gpu`; each test skips without a CUDA
device. On the card:

    python -m pytest -m gpu tests/test_torch_gpu_train.py

B8's bf16 cases cover the dkv plan's cluster sizes (1, 2, 7, 8 with 71 % 8
!= 0) and its dispatch on D (the wide kernel above D = 128: D = 160, 192,
256, MHA and rep 2 and 8; two calls at D = 256 give the same bits). The dq kernel
is also held by itself against `train_attn_bwd_dq_plain` on the forward
kernel's lse and di (D = 64, 80, 128, 256; rep 1, 8, 71; S = 64, 129, 1000;
padded, and D = 192 and 320), and its two calls must give the same bits.
B8 in f32: dkv and dq at D <= 128 on the 3xTF32 kernels (D = 32, 64, 128;
rep 1, 4, 8; S = 75 and 1000, padded; two calls at D = 64 give the same
bits); at 128 < D <= 256 the forward, dkv and dq on the 3xTF32 splits of
2 CTAs (D = 144, 192, 256; rep 1, 2, 8; S = 129 and 1000, padded; two
calls at D = 256 give the same bits over the split alone, clusters of 8
and a head split that C does not divide); at 256 < D <= 1024 the three on
the splits of ceil(D / 128) CTAs, bf16 on f32 copies (D = 272, 320, 384,
512, 1024, both dtypes, rep 2 and 8, a padded tail and a ragged S, two
calls bit-equal; the f32 forward alone at D = 320, 512 and 1024 with its
lse; the three through the splits only at D = 320, 512 and 1024), and the
f32 dq alone at D = 144 to 512. Above D = 1024 (D = 1040, both dtypes)
the CUDA-core forward, dkv and dq. The plans' clusters against the C
dispatch rule: the raw launchers take each plan's cluster and refuse any
other, at every D the tests take.

Tolerances: B8 in bf16, outputs and gradients within 2e-2 of max|plain| per
tensor (p and ds enter their products rounded to bf16, the plain version
keeps f32; one bf16 ulp is 2^-8 relative); B8 in f32 within 1e-4 of
max|plain| (f32 sums in another order). Packed matmuls with integer-valued
inputs: exact (every partial sum is an integer below 2^24 in f32), f32 x
included (the kernels round x to bf16, which keeps small integers exact);
f32 x with random values within 1e-2 of max|plain| (x rounded to bf16 in the
kernel, f32 in the plain version). Decode attention within 2e-2 (as the
existing bf16 cases)."""

import pytest
import torch

from bitdistiller_tpu_torch.experimental.fused_mlp import fused_mlp, fused_mlp_plain
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.ops import quant_matmul as qm
from bitdistiller_tpu_torch.ops import train_attention as ta
from bitdistiller_tpu_torch.quant.packing import PackedLinear, make_scale_combo, scales_from_combo

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with pytest -m gpu")
    return torch.Generator(device="cuda").manual_seed(0)


def _attention_case(gen, b, s, hq, hkv, d, dtype, pad_to=None):
    q = torch.randn((b, s, hq, d), device="cuda", generator=gen).to(dtype)
    k = torch.randn((b, s, hkv, d), device="cuda", generator=gen).to(dtype)
    v = torch.randn((b, s, hkv, d), device="cuda", generator=gen).to(dtype)
    do = torch.randn((b, s, hq, d), device="cuda", generator=gen).to(dtype)
    mask = None
    if pad_to is not None:
        mask = torch.ones((b, s), dtype=torch.int32, device="cuda")
        mask[0, pad_to:] = 0
    return q, k, v, do, mask


def _fwd_bwd(fn, q, k, v, do, mask):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, mask)
    out.backward(do)
    return out.detach(), q.grad, k.grad, v.grad


def _rel(got, want, mask=None):
    got, want = got.float(), want.float()
    if mask is not None:  # pad rows' outputs are garbage in both: compare real rows
        keep = mask.bool()[..., None, None]
        got, want = got * keep, want * keep
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("b,s,hq,hkv,d,pad_to", [
    (1, 64, 2, 2, 64, None),     # one tile
    (2, 200, 4, 2, 64, 150),     # ragged S, GQA rep 2, a padded row
    (1, 130, 8, 1, 128, None),   # MQA, rep 8, D = 128
    (1, 96, 2, 2, 80, None),     # D not a power of two
    (1, 70, 4, 4, 256, 33),      # D = 256 (the wide dkv)
    (1, 256, 14, 2, 64, None),   # rep 7: a cluster of 7
    (1, 130, 71, 1, 64, 100),    # MQA rep 71 (FALCON_7B's): clusters of 8, 71 % 8 != 0, padded
    (2, 256, 8, 2, 64, None),    # S an exact multiple of 128
    (1, 129, 4, 2, 64, 100),     # S = 129: one row past a 128 boundary
    (1, 200, 2, 2, 160, 150),    # D = 160: the wide dkv with a box wholly past D, padded
    (2, 129, 4, 2, 192, None),   # D = 192, rep 2: a cluster of 2
    (1, 300, 8, 1, 256, 250),    # D = 256, MQA rep 8 (Gemma-2B's heads): a cluster of 8
])
def test_train_attention_bf16_matches_plain(gen, b, s, hq, hkv, d, pad_to):
    q, k, v, do, mask = _attention_case(gen, b, s, hq, hkv, d, torch.bfloat16, pad_to)
    launches = (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
                ta.train_attn_bwd_dq.launches)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    assert (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
            ta.train_attn_bwd_dq.launches) == tuple(n + 1 for n in launches)
    # dkv went through the kernel its plan names, on clusters of min(rep, 8):
    # wgmma up to D = 128, the wide kernel above
    plan = ta.train_attn_bwd_dkv.plan
    assert plan == ta.dkv_plan(b, s, hq, hkv, d)
    assert (plan.kernel, plan.cluster) == ("wgmma" if d <= 128 else "wgmma_wide",
                                           min(hq // hkv, 8))
    # the output and dq of real rows; dk/dv sum over real query rows only
    assert _rel(got[0], want[0], mask) < 2e-2
    assert _rel(got[1], want[1], mask) < 2e-2
    assert _rel(got[2], want[2]) < 2e-2
    assert _rel(got[3], want[3]) < 2e-2


@pytest.mark.parametrize("d", [32, 144])
def test_train_attention_f32_matches_plain(gen, d):
    q, k, v, do, mask = _attention_case(gen, 2, 75, 4, 2, d, torch.float32, pad_to=60)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    # dkv on 3xTF32 up to D = 128, on the 3xTF32 splits above
    assert ta.train_attn_bwd_dkv.plan.kernel == ("tf32x3" if d <= 128 else "tf32x3_split")
    assert _rel(got[0], want[0], mask) < 1e-4
    assert _rel(got[1], want[1], mask) < 1e-4
    assert _rel(got[2], want[2]) < 1e-4
    assert _rel(got[3], want[3]) < 1e-4


@pytest.mark.parametrize("s", [75, 1000])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_train_attention_f32_tf32x3_matches_plain(gen, d, rep, s):
    """The 3xTF32 dkv and dq: rep 1 over two kv heads and two batches (batch
    0 padded), rep 4 and 8 (clusters of 4 and 8) over one kv head; ragged S."""
    b, hkv = (2, 2) if rep == 1 else (1, 1)
    q, k, v, do, mask = _attention_case(gen, b, s, rep * hkv, hkv, d, torch.float32,
                                        pad_to=s - s // 4)
    launches = (ta.train_attn_bwd_dkv.launches, ta.train_attn_bwd_dq.launches)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert (ta.train_attn_bwd_dkv.launches, ta.train_attn_bwd_dq.launches) == tuple(
        n + 1 for n in launches)
    plan = ta.train_attn_bwd_dkv.plan
    assert (plan.kernel, plan.cluster) == ("tf32x3", min(rep, 8))
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    assert _rel(got[1], want[1], mask) < 1e-4
    assert _rel(got[2], want[2]) < 1e-4
    assert _rel(got[3], want[3]) < 1e-4


def test_train_attention_f32_is_deterministic(gen):
    """The 3xTF32 kernels at D = 64, clusters of 8 (rep 8), padded: bit for bit."""
    q, k, v, do, mask = _attention_case(gen, 1, 300, 16, 2, 64, torch.float32, pad_to=280)
    a = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert ta.train_attn_bwd_dkv.plan == ta.dkv_plan(1, 300, 16, 2, 64, torch.float32)
    c = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("s", [129, 1000])
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("d", [144, 192, 256])
def test_train_attention_f32_pair_matches_plain(gen, d, rep, s):
    """The f32 forward, dkv and dq at 128 < D <= 256 on the 3xTF32 splits of
    2 CTAs (the forward's and dq's clusters of 2, dkv's of 2 min(rep, 4)):
    the output and the three gradients; rep 1 over two kv heads and two
    batches (batch 0 padded), rep 2 and 8 over one kv head; D = 144 leaves
    the second CTA's columns mostly zeros."""
    b, hkv = (2, 2) if rep == 1 else (1, 1)
    q, k, v, do, mask = _attention_case(gen, b, s, rep * hkv, hkv, d, torch.float32,
                                        pad_to=s - s // 4)
    launches = (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
                ta.train_attn_bwd_dq.launches)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
            ta.train_attn_bwd_dq.launches) == tuple(n + 1 for n in launches)
    fplan, plan = ta.train_attn_fwd.plan, ta.train_attn_bwd_dkv.plan
    assert (fplan.kernel, fplan.cluster, fplan.grid) == ("tf32x3_split", 2,
                                                         (2 * rep * hkv, b, -(-s // 64)))
    assert (plan.kernel, plan.cluster) == ("tf32x3_split", 2 * min(rep, 4))
    qplan = ta.train_attn_bwd_dq.plan
    assert (qplan.kernel, qplan.cluster, qplan.grid) == ("tf32x3_split", 2,
                                                         (2 * rep * hkv, b, -(-s // 64)))
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    assert _rel(got[0], want[0], mask) < 1e-4
    assert _rel(got[1], want[1], mask) < 1e-4
    assert _rel(got[2], want[2]) < 1e-4
    assert _rel(got[3], want[3]) < 1e-4


@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 1), (12, 1)])
def test_train_attention_f32_pair_is_deterministic(gen, hq, hkv):
    """The splits of 2 at D = 256: the split alone (rep 1), dkv clusters of
    8 over rep 8 (two heads a head rank) and rep 12 (C = 4 of 12: three);
    bit for bit, forward and the three gradients."""
    q, k, v, do, mask = _attention_case(gen, 1, 300, hq, hkv, 256, torch.float32, pad_to=280)
    a = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert (ta.train_attn_fwd.plan.kernel, ta.train_attn_fwd.plan.cluster) == ("tf32x3_split", 2)
    plan = ta.train_attn_bwd_dkv.plan
    assert (plan.kernel, plan.cluster) == ("tf32x3_split", 2 * min(hq // hkv, 4))
    c = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_train_attention_is_deterministic(gen):
    q, k, v, do, mask = _attention_case(gen, 1, 300, 8, 2, 64, torch.bfloat16, pad_to=280)
    a = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    c = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("hq,hkv", [(16, 2), (71, 1), (12, 1)])
def test_train_attention_is_deterministic_across_cluster_splits(gen, hq, hkv):
    """Clusters of 8 over rep 8 (one head a CTA), rep 71 and rep 12 (C does
    not divide rep: CTAs walk 9 or 8, 2 or 1 heads); bit for bit."""
    q, k, v, do, mask = _attention_case(gen, 1, 200, hq, hkv, 64, torch.bfloat16, pad_to=170)
    a = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert ta.train_attn_bwd_dkv.plan.cluster == 8
    c = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 1), (24, 2)])
def test_train_attention_is_deterministic_at_d256(gen, hq, hkv):
    """The wide dkv kernel at D = 256: no cluster (MHA), a cluster of 8 over
    rep 8, and rep 12 (C = 8 does not divide it); bit for bit."""
    q, k, v, do, mask = _attention_case(gen, 1, 200, hq, hkv, 256, torch.bfloat16, pad_to=170)
    a = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert ta.train_attn_bwd_dkv.plan.kernel == "wgmma_wide"
    c = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("s", [64, 129, 1000])
@pytest.mark.parametrize("rep", [1, 8, 71])
@pytest.mark.parametrize("d", [64, 80, 128, 256, 192, 320])
def test_train_attention_dq_kernel_alone_matches_plain(gen, d, rep, s):
    """The dq kernel on identical inputs to its plain version; rep 1 runs two
    batches (batch 0 padded), rep 8 two kv heads, rep 71 one (FALCON_7B).
    D = 320: the f32 split on f32 copies, rounded to bf16."""
    b, hkv = (2, 2) if rep == 1 else (1, 2) if rep == 8 else (1, 1)
    q, k, v, do, mask = _attention_case(gen, b, s, rep * hkv, hkv, d, torch.bfloat16,
                                        pad_to=s - s // 4)
    out, lse = ta.train_attn_fwd(q, k, v, mask)
    di = (out.float() * do.float()).sum(-1).contiguous()
    before = ta.train_attn_bwd_dq.launches
    got = ta.train_attn_bwd_dq(q, k, v, mask, do, lse, di)
    assert ta.train_attn_bwd_dq.launches == before + 1
    want = ta.train_attn_bwd_dq_plain(q, k, v, mask, do, lse, di)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel(got, want, mask) < 2e-2
    assert torch.equal(got, ta.train_attn_bwd_dq(q, k, v, mask, do, lse, di))
    assert ta.train_attn_bwd_dq.plan.kernel == ("tf32x3_split" if d > 256 else "wgmma")


@pytest.mark.parametrize("s", [129, 1000])
@pytest.mark.parametrize("rep", [1, 8])
@pytest.mark.parametrize("d", [144, 192, 256, 320, 512])
def test_train_attention_f32_dq_kernel_alone_matches_plain(gen, d, rep, s):
    """The f32 dq on the splits (D <= 256: 2 CTAs, 320: 3, 512: 4) alone, on
    the forward kernel's lse and di, within 1e-4; rep 1 over
    two batches (batch 0 padded), rep 8 over two kv heads; two calls
    bit-equal."""
    b, hkv = (2, 2) if rep == 1 else (1, 2)
    q, k, v, do, mask = _attention_case(gen, b, s, rep * hkv, hkv, d, torch.float32,
                                        pad_to=s - s // 4)
    out, lse = ta.train_attn_fwd(q, k, v, mask)
    di = (out * do).sum(-1).contiguous()
    got = ta.train_attn_bwd_dq(q, k, v, mask, do, lse, di)
    plan = ta.train_attn_bwd_dq.plan
    ns = -(-d // 128)
    assert (plan.kernel, plan.cluster) == ("tf32x3_split", ns)
    want = ta.train_attn_bwd_dq_plain(q, k, v, mask, do, lse, di)
    assert _rel(got, want, mask) < 1e-4
    assert torch.equal(got, ta.train_attn_bwd_dq(q, k, v, mask, do, lse, di))


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [272, 320, 384, 512, 1024])
def test_train_attention_split_matches_plain(gen, d, dtype, hq, hkv):
    """The forward, dkv and dq at 256 < D <= 1024 on the 3xTF32 splits of
    ns = ceil(D / 128) CTAs (dkv clusters of ns min(rep, 8 // ns), the
    forward's and dq's clusters of ns; bf16 on f32 copies, rounded once):
    the output and the three gradients at S = 300 (ragged) with a padded
    tail (segment ids), rep 2 and 8; D = 272 leaves the third CTA 16 real
    columns; two calls bit-equal."""
    b, s = 2, 300
    q, k, v, do, mask = _attention_case(gen, b, s, hq, hkv, d, dtype, pad_to=260)
    launches = (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
                ta.train_attn_bwd_dq.launches)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
            ta.train_attn_bwd_dq.launches) == tuple(n + 1 for n in launches)
    ns, rep = -(-d // 128), hq // hkv
    kernel = "tf32x3_split"
    plan, qplan = ta.train_attn_bwd_dkv.plan, ta.train_attn_bwd_dq.plan
    assert (plan.kernel, plan.cluster, plan.columns) == (kernel, ns * min(rep, 8 // ns), ns)
    assert (qplan.kernel, qplan.cluster, qplan.grid) == (kernel, ns, (ns * hq, b, 5))
    fplan = ta.train_attn_fwd.plan
    assert (fplan.kernel, fplan.cluster, fplan.grid) == (kernel, ns, (ns * hq, b, 5))
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want))
    assert _rel(got[0], want[0], mask) < tol
    assert _rel(got[1], want[1], mask) < tol
    assert _rel(got[2], want[2]) < tol
    assert _rel(got[3], want[3]) < tol
    again = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("d,dtype,s", [
    (320, torch.bfloat16, 600), (320, torch.float32, 600), (512, torch.float32, 300),
    (1024, torch.float32, 100)])
def test_train_attention_splits_only_forward_and_backward(gen, d, dtype, s):
    """The forward and backward through the splits alone: at D = 320 (ns =
    3, both dtypes, bf16 on f32 copies), 512 (ns = 4) and 1024 (ns = 8, the
    portable cluster's edge, a short S) every plan is "tf32x3_split" and
    each kernel is launched once with its cluster of ns >= 2, which the C
    dispatch refuses to a CUDA-core kernel (those take a cluster of 1 only):
    no `*_cores_kernel` runs. The output and the three gradients within the
    B8 tolerances of the plain version (padded tail, rep 4); two calls
    bit-equal."""
    b, hq, hkv = 1, 8, 2
    q, k, v, do, mask = _attention_case(gen, b, s, hq, hkv, d, dtype, pad_to=s - s // 4)
    launches = (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
                ta.train_attn_bwd_dq.launches)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
            ta.train_attn_bwd_dq.launches) == tuple(n + 1 for n in launches)
    ns = -(-d // 128)
    fplan, kplan = ta.train_attn_fwd.plan, ta.train_attn_bwd_dkv.plan
    qplan = ta.train_attn_bwd_dq.plan
    assert {fplan.kernel, kplan.kernel, qplan.kernel} == {"tf32x3_split"}
    assert (fplan.cluster, qplan.cluster, kplan.columns) == (ns, ns, ns) and kplan.cluster >= ns
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want))
    assert _rel(got[0], want[0], mask) < tol
    assert _rel(got[1], want[1], mask) < tol
    assert _rel(got[2], want[2]) < tol
    assert _rel(got[3], want[3]) < tol
    again = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_attention_above_1024_matches_plain(gen, dtype):
    """D = 1040 (past the splits): the forward, dkv and dq on the CUDA-core
    kernels, 256-column slices; the output and the three gradients against
    the plain version at a short ragged S with a padded tail, rep 2; two
    calls bit-equal."""
    b, s, hq, hkv, d = 1, 100, 8, 4, 1040
    q, k, v, do, mask = _attention_case(gen, b, s, hq, hkv, d, dtype, pad_to=80)
    launches = (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
                ta.train_attn_bwd_dq.launches)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
            ta.train_attn_bwd_dq.launches) == tuple(n + 1 for n in launches)
    assert (ta.train_attn_fwd.plan.kernel, ta.train_attn_bwd_dkv.plan.kernel,
            ta.train_attn_bwd_dq.plan.kernel) == ("cores_wide",) * 3
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want))
    assert _rel(got[0], want[0], mask) < tol
    assert _rel(got[1], want[1], mask) < tol
    assert _rel(got[2], want[2]) < tol
    assert _rel(got[3], want[3]) < tol
    again = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 144, 256, 272, 320, 384, 512, 1024, 1040])
def test_train_attention_plans_match_the_dispatch_rule(gen, d, dtype):
    """The raw forward, dkv and dq launchers at every D the tests take: the
    plan's cluster launches (0), one more or one less is refused before any
    launch (csrc/train_attention.cu: dispatch); bf16 at 256 < D <= 1024 is
    refused whatever the cluster (the wrapper passes f32 copies there)."""
    b, s, hq, hkv = 1, 100, 8, 2
    q, k, v, do, _ = _attention_case(gen, b, s, hq, hkv, d, dtype)
    lse = torch.zeros((b, hq, s), device="cuda")
    di = torch.zeros((b, s, hq), device="cuda")
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    out, lse_out = torch.empty_like(q), torch.empty((b, hq, s), device="cuda")
    f32, sc = int(dtype == torch.float32), d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(), lse.data_ptr(),
            di.data_ptr())
    launch = {
        "fwd": lambda c: ta._launcher("bd_train_attn_fwd")(
            *ptrs[:4], out.data_ptr(), lse_out.data_ptr(), b, s, hq, hkv, d, sc, c, f32, stream),
        "dkv": lambda c: ta._launcher("bd_train_attn_dkv")(
            *ptrs, dk.data_ptr(), dv.data_ptr(), b, s, hq, hkv, d, sc, c, f32, stream),
        "dq": lambda c: ta._launcher("bd_train_attn_dq")(
            *ptrs, dq.data_ptr(), b, s, hq, hkv, d, sc, c, f32, stream)}
    plans = {"fwd": ta.fwd_plan(b, s, hq, hkv, d, dtype),
             "dkv": ta.dkv_plan(b, s, hq, hkv, d, dtype), "dq": ta.dq_plan(b, s, hq, hkv, d, dtype)}
    for kind, plan in plans.items():
        for c in (plan.cluster - 1, plan.cluster + 1):
            assert launch[kind](c) != 0, (kind, c)
        assert (launch[kind](plan.cluster) == 0) == (not ta.widened(dtype, d)), kind
    torch.cuda.synchronize()


def test_train_attention_under_checkpoint_relaunches_the_forward(gen):
    q, k, v, do, mask = _attention_case(gen, 1, 64, 2, 2, 64, torch.bfloat16)
    q.requires_grad_(True)
    before = ta.train_attn_fwd.launches
    out = torch.utils.checkpoint.checkpoint(
        ta.flash_train_attention, q, k, v, mask, use_reentrant=False)
    out.backward(do)
    assert ta.train_attn_fwd.launches == before + 2


# ---- C1: the packed kernels at every group size, f32 activations ---------------

C1_GROUPS = [32, 64, 256, -1]  # -1: one group of K (per-channel)


def _packed_g(gen, k, n, bits, group, layers=2, integer=True):
    g = k if group < 1 else group
    qw = torch.randint(-(2**31), 2**31 - 1, (layers, k * bits // 32, n), dtype=torch.int32,
                       device="cuda", generator=gen)
    if integer:
        scales = torch.ones((layers, k // g, n), device="cuda")
        szeros = torch.randint(0, 2**bits, (layers, k // g, n), device="cuda",
                               generator=gen).float()
    else:
        scales = (torch.rand((layers, k // g, n), device="cuda", generator=gen) * 0.02
                  + 0.005).bfloat16().float()
        szeros = (scales * torch.randint(0, 2**bits, (layers, k // g, n), device="cuda",
                                         generator=gen).float()).bfloat16().float()
    return PackedLinear(qweight=qw, scales=scales, szeros=szeros, bias=None, bits=bits,
                        group_size=g, in_features=k, out_features=n,
                        combo=make_scale_combo(scales, szeros))


def _xints(gen, m, k, dtype, top=None):
    x = torch.randint(-4, 5, (m, k), device="cuda", generator=gen).float()
    if top is not None:
        x[:, 0] = top
    return x.to(dtype)


def _tile(monkeypatch, tile):
    """Force the prefill kernels' tile height (None: a decode M, no tile)."""
    if tile is not None:
        monkeypatch.setattr(qm, "prefill_tile_m", lambda m_, n, sms: tile)


# decode M (one, two, four token tiles) and prefill M on both tile heights
A16_CASES = [(2, 8, None), (2, 12, None), (4, 8, None), (4, 17, None),
             (2, 100, 64), (2, 100, 128), (4, 40, 64), (4, 40, 128)]
A8_CASES = [(2, 8, None), (4, 12, None), (2, 100, 64), (2, 100, 128), (4, 40, 64),
            (4, 40, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", C1_GROUPS)
@pytest.mark.parametrize("bits,m,tile", A16_CASES)
def test_a16_kernels_exact_on_integers_at_every_group(gen, monkeypatch, bits, m, tile, group,
                                                      dtype):
    _tile(monkeypatch, tile)
    k = 512
    p = _packed_g(gen, k, 320, bits, group)
    x = _xints(gen, m, k, dtype)
    before = qm.qmm_decode.launches + qm.qmm_prefill.launches
    got = qm.quant_matmul(x, p, 1)
    lay = p.layer(1)
    want = qm.quant_matmul_plain(x, lay.qweight, lay.scales, lay.szeros, bits, lay.group_size)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert qm.qmm_decode.launches + qm.qmm_prefill.launches == before + 1


@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", C1_GROUPS)
@pytest.mark.parametrize("bits,m,tile", A8_CASES)
def test_a8_kernels_exact_on_integers_at_every_group(gen, monkeypatch, bits, m, tile, group,
                                                     dtype, repacked):
    _tile(monkeypatch, tile)
    k = 512
    p = _packed_g(gen, k, 320, bits, group)
    if repacked:
        p = qm.repack_linear_a8(p)
    x = _xints(gen, m, k, dtype, top=127.0)  # one 127 a row: the per-token scale is 1
    before = qm.qmm_a8.launches
    got = qm.quant_matmul_a8(x, p, 1)
    lay = p.layer(1)
    want = qm.quant_matmul_a8_plain(x, lay.qweight, lay.scales, lay.szeros, bits,
                                    lay.group_size, p.a8_order)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert qm.qmm_a8.launches == before + 1


@pytest.mark.parametrize("group", C1_GROUPS)
@pytest.mark.parametrize("m", [8, 100])
def test_a16_kernels_close_on_random_f32_x(gen, m, group):
    """f32 x is rounded to bf16 in the kernel, kept f32 by the plain version."""
    p = _packed_g(gen, 512, 320, 2, group, integer=False)
    x = torch.randn((m, 512), device="cuda", generator=gen)
    got = qm.quant_matmul(x, p, 1)
    lay = p.layer(1)
    s, sz = scales_from_combo(lay.combo)
    want = qm.quant_matmul_plain(x, lay.qweight, s, sz, 2, lay.group_size)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", C1_GROUPS)
@pytest.mark.parametrize("bits,m", [(2, 8), (4, 40)])
def test_fused_mlp_kernel_matches_plain_at_every_group(gen, bits, m, group, dtype):
    # the three layers share one group: per-channel takes a square MLP (K = FFN)
    f = 512 if group > 0 else 256
    g = _packed_g(gen, 256, f, bits, group, layers=1, integer=False).layer(0)
    u = _packed_g(gen, 256, f, bits, group, layers=1, integer=False).layer(0)
    d = _packed_g(gen, f, 200, bits, group, layers=1, integer=False).layer(0)
    x = torch.randn((m, 256), device="cuda", generator=gen).to(dtype)
    before = fused_mlp.launches
    got = fused_mlp(x, g, u, d, "silu", block_f=f)
    assert fused_mlp.launches == before + 1
    want = fused_mlp_plain(x, g, u, d, "silu", block_f=f)
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 256), (8, 2, 256), (16, 2, 256), (8, 1, 128)])
def test_decode_attention_kernel_at_d256_and_f32_q(gen, hq, hkv, d, qdtype, kv):
    b, t, layers = 3, 40, 2
    q = torch.randn((b, 1, hq, d), device="cuda", generator=gen).to(qdtype)
    kn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).to(qdtype)
    vn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).to(qdtype)
    shape = (layers, b, hkv, t, d)
    if kv == "int8":
        ck = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
        cv = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
        ks = torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02
        vs = torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02
    else:
        ck = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        cv = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        ks = vs = None
    start = torch.tensor([0, 17, 39], dtype=torch.int32, device="cuda")
    before = da.flash_decode_stacked.launches
    got = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, start, k_scale=ks, v_scale=vs)
    want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, start, k_scale=ks, v_scale=vs)
    assert da.flash_decode_stacked.launches == before + 1
    assert got.dtype == qdtype
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


# ---- the 3xTF32 forward and the C6 shapes ----------------------------------------


@pytest.mark.parametrize("b,s,hq,hkv,d,pad_to", [
    (1, 300, 8, 2, 64, 250),      # chip_smoke.py's `f32` case
    (2, 1024, 32, 4, 64, 900),    # TinyLlama's attention in f32
    (1, 2048, 32, 32, 128, None),  # Llama-2-7B's attention in f32
    (1, 200, 4, 2, 16, 150),      # D = 16, padded
    (2, 129, 8, 1, 48, 100),      # D = 48, MQA rep 8, padded
    (1, 333, 4, 4, 128, 300),     # D = 128, padded
    (2, 1024, 8, 1, 256, 900),    # Gemma-2B's heads in f32: the splits of 2
    (1, 333, 4, 2, 144, 300),     # D = 144, padded: the splits of 2, the second CTA mostly zeros
    (1, 600, 8, 2, 320, 500),     # C6's D = 320: the splits of 3
    (1, 1024, 8, 2, 512, 900),    # d512_f32: the splits of 4
    (1, 200, 4, 4, 1024, 150),    # D = 1024: the splits of 8, the portable cluster's edge
])
def test_train_attention_f32_forward_kernel_matches_plain(gen, b, s, hq, hkv, d, pad_to):
    """The f32 forward on the 3xTF32 kernel (on splits of ceil(D / 128) CTAs
    above D = 128): o and lse against the plain version (lse from the plain
    scores), and two calls bit for bit."""
    q, k, v, _, mask = _attention_case(gen, b, s, hq, hkv, d, torch.float32, pad_to)
    seg = None if mask is None else mask.contiguous()
    before = ta.train_attn_fwd.launches
    out, lse = ta.train_attn_fwd(q, k, v, seg)
    assert ta.train_attn_fwd.launches == before + 1
    assert ta.train_attn_fwd.plan.kernel == ("tf32x3" if d <= 128 else "tf32x3_split")
    assert ta.train_attn_fwd.plan.cluster == ta.split_ctas(d)
    want = ta.flash_train_attention_plain(q, k, v, mask)
    assert _rel(out, want, mask) < 1e-4
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bshrd,bthd->bhrst", qg, k) / d ** 0.5
    scores = torch.where(ta._allowed(s, mask, "cuda"), scores, ta.MASK_VALUE)
    want_lse = torch.logsumexp(scores, -1).reshape(b, hq, s)
    keep = torch.ones((b, s), device="cuda") if mask is None else mask.float()
    assert ((lse - want_lse).abs() * keep[:, None, :]).max().item() < 1e-4
    out2, lse2 = ta.train_attn_fwd(q, k, v, seg)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [72, 80, 300, 320])
def test_train_attention_any_head_dim_matches_plain(gen, d, dtype):
    """C6: D not a multiple of 16 (72, 300) padded by the wrapper at the real
    D's scale; above D = 256 (300, 320) the forward, dkv and dq on the
    3xTF32 splits of 3 CTAs (bf16 on f32 copies); forward and the three
    gradients, each kernel launched once."""
    q, k, v, do, mask = _attention_case(gen, 1, 300, 8, 2, d, dtype, pad_to=250)
    launches = (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
                ta.train_attn_bwd_dq.launches)
    got = _fwd_bwd(ta.flash_train_attention, q, k, v, do, mask)
    assert (ta.train_attn_fwd.launches, ta.train_attn_bwd_dkv.launches,
            ta.train_attn_bwd_dq.launches) == tuple(n + 1 for n in launches)
    dp = ta.padded_head_dim(d)
    assert ta.train_attn_bwd_dkv.plan == ta.dkv_plan(1, 300, 8, 2, dp, dtype)
    assert ta.train_attn_fwd.plan == ta.fwd_plan(1, 300, 8, 2, dp, dtype)
    want = _fwd_bwd(ta.flash_train_attention_plain, q, k, v, do, mask)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert _rel(got[0], want[0], mask) < tol
    assert _rel(got[1], want[1], mask) < tol
    assert _rel(got[2], want[2]) < tol
    assert _rel(got[3], want[3]) < tol


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("m,tile", [(8, None), (17, None), (100, 64), (256, 128)])
@pytest.mark.parametrize("group", [64, 32])
def test_packed_kernels_exact_at_k_64_mod_128(gen, monkeypatch, group, m, tile, a8):
    """C6: K = 4544 (Falcon-7B's hidden size, 64 mod 128): the half last
    step, A16 and A8 (pair-layout and repacked words), exact on integers."""
    _tile(monkeypatch, tile)
    k, n = 4544, 320
    p = _packed_g(gen, k, n, 2, group)
    for w in ((p, qm.repack_linear_a8(p)) if a8 else (p,)):
        x = _xints(gen, m, k, torch.bfloat16, top=127.0 if a8 else None)
        before = (qm.qmm_a8.launches, qm.qmm_decode.launches + qm.qmm_prefill.launches)
        got = (qm.quant_matmul_a8 if a8 else qm.quant_matmul)(x, w, 1)
        lay = w.layer(1)
        if a8:
            want = qm.quant_matmul_a8_plain(x, lay.qweight, lay.scales, lay.szeros, 2, group,
                                            w.a8_order)
            assert qm.qmm_a8.launches == before[0] + 1
        else:
            want = qm.quant_matmul_plain(x, lay.qweight, lay.scales, lay.szeros, 2, group)
            assert qm.qmm_decode.launches + qm.qmm_prefill.launches == before[1] + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("group", [64, 32])
def test_fused_mlp_kernel_at_k_64_mod_128(gen, group, m):
    k, f = 4544, 512
    g = _packed_g(gen, k, f, 2, group, layers=1, integer=False).layer(0)
    u = _packed_g(gen, k, f, 2, group, layers=1, integer=False).layer(0)
    d = _packed_g(gen, f, 320, 2, group, layers=1, integer=False).layer(0)
    x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
    before = fused_mlp.launches
    got = fused_mlp(x, g, u, d, "silu", block_f=f)
    assert fused_mlp.launches == before + 1
    want = fused_mlp_plain(x, g, u, d, "silu", block_f=f)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
