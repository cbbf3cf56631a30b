"""B8's dkv and dq plans on the CPU: `dkv_plan` (which kernel by dtype and
D: bf16 "wgmma" up to D = 128, "wgmma_wide" up to 256; f32 "tf32x3" up to
D = 128, "tf32x3_split" up to 1024, bf16 above 256 on f32 copies; the cluster size C = min(rep, 8) on the tensor cores,
ns min(rep, 8 // ns) for the splits of ns = ceil(D / 128) CTAs, 1 on the
CUDA cores above D = 1024; the grid), `dq_plan` (the same kernels for dq,
on clusters of ns along x) and `dkv_walk` (what CTA `rank` of a cluster
walks for a key tile, in the plan's query tiles: 64 rows, 32 for the tf32
kernels; a split's column ranks walk their head rank's list), which the
CUDA launch of csrc/train_attention.cu follows and whose cluster its
`dispatch` checks. Every (key tile, query head, query tile) on or below the
diagonal is walked exactly once, by one head rank; the wrapper hands the
kernel the plan's cluster; the split CTA's shared memory, from the .cu
layout, fits a block. No kernel launches here: the dispatch test replaces
the launcher with a recording stub, as tests/test_torch_c1_dispatch.py
does."""

import pytest
import torch

from bitdistiller_tpu_torch import _device
from bitdistiller_tpu_torch.ops import train_attention as ta

TILE = ta.DKV_KEY_TILE


def _ceil(a, b):
    return -(-a // b)


WALKS = [(64, 1), (130, 2), (129, 4), (256, 7), (1024, 8), (130, 71), (2048, 1)]


@pytest.mark.parametrize("s,rep,dtype,d", [
    pytest.param(s, rep, torch.bfloat16, 64, id=f"{s}-{rep}") for s, rep in WALKS]
    + [pytest.param(s, rep, torch.float32, 64, id=f"{s}-{rep}-f32") for s, rep in WALKS]
    + [pytest.param(s, rep, torch.float32, 256, id=f"{s}-{rep}-f32-pair") for s, rep in WALKS]
    + [pytest.param(s, rep, torch.float32, 384, id=f"{s}-{rep}-f32-split") for s, rep in WALKS])
def test_dkv_walk_covers_each_pair_once_on_or_below_the_diagonal(s, rep, dtype, d):
    plan = ta.dkv_plan(1, s, rep, 1, d, dtype)
    qtile, ranks = plan.query_tile, plan.head_ranks
    assert plan.cluster == (ta.split_ctas(d) if dtype == torch.float32 else 1) * ranks
    nq = _ceil(s, qtile)
    for kt in range(_ceil(s, TILE)):
        walked = [(rank, pair) for rank in range(ranks)
                  for pair in ta.dkv_walk(s, rep, ranks, rank, kt, qtile)]
        pairs = [pair for _, pair in walked]
        # query tiles whose last row reaches the key tile's first key
        want = {(r, qt) for r in range(rep) for qt in range(nq)
                if (qt + 1) * qtile - 1 >= kt * TILE}
        assert len(pairs) == len(set(pairs)) and set(pairs) == want
        owner = {}
        for rank, (r, _) in walked:  # a head belongs to one rank
            assert owner.setdefault(r, rank) == rank


@pytest.mark.parametrize("rep,c", [(1, 1), (2, 2), (7, 7), (8, 8), (71, 8)])
def test_dkv_cluster_is_min_of_rep_and_8(rep, c):
    for b, hkv, d in ((1, 1, 64), (2, 2, 128)):
        for dtype, kernel in ((torch.bfloat16, "wgmma"), (torch.float32, "tf32x3")):
            plan = ta.dkv_plan(b, 300, rep * hkv, hkv, d, dtype)
            assert plan.kernel == kernel and plan.cluster == c
            assert plan.grid == (c, _ceil(300, TILE) * hkv, b)


def test_dkv_ctas_at_tinyllama_and_llama2_7b():
    tiny = ta.dkv_plan(2, 1024, 32, 4, 64)  # TinyLlama: rep 8, D 64
    assert (tiny.kernel, tiny.cluster, tiny.grid, tiny.ctas) == ("wgmma", 8, (8, 64, 2), 1024)
    assert len(ta.dkv_walk(1024, 8, 8, 0, 0)) == 16  # the longest walk: 16 query tiles
    big = ta.dkv_plan(1, 2048, 32, 32, 128)  # Llama-2-7B: MHA, D 128
    assert (big.kernel, big.cluster, big.grid, big.ctas) == ("wgmma", 1, (1, 1024, 1), 1024)
    assert len(ta.dkv_walk(2048, 1, 1, 0, 0)) == 32


@pytest.mark.parametrize("d,kernel,dtype", [
    pytest.param(d, kernel, dtype, id=f"{d}-{kernel}") for d, kernel, dtype in (
        (16, "wgmma", torch.bfloat16), (64, "wgmma", torch.bfloat16),
        (80, "wgmma", torch.bfloat16), (128, "wgmma", torch.bfloat16),
        (144, "wgmma_wide", torch.bfloat16), (256, "wgmma_wide", torch.bfloat16),
        (16, "tf32x3", torch.float32), (64, "tf32x3", torch.float32),
        (128, "tf32x3", torch.float32), (144, "tf32x3_split", torch.float32),
        (256, "tf32x3_split", torch.float32), (320, "tf32x3_split", torch.float32),
        (320, "tf32x3_split", torch.bfloat16), (1040, "cores_wide", torch.float32),
        (1040, "cores_wide", torch.bfloat16))])
def test_dkv_kernel_is_chosen_by_head_dim(d, kernel, dtype):
    plan = ta.dkv_plan(1, 200, 8, 2, d, dtype)
    assert plan.kernel == kernel
    if kernel == "cores_wide":  # one warp a key row, F32_ROWS a CTA, no cluster, 5 slices
        assert plan.cluster == 1 and plan.grid == (_ceil(200, ta.F32_ROWS), 2, 5)
        return
    # the tensor-core kernels: clusters of min(rep, 8) CTAs a 64-row key tile and kv
    # head; the splits ns min(rep, 8 // ns) (rep 4: a pair 8 CTAs, each head rank's
    # two walking one head; D = 320, ns = 3: 6 CTAs, two head ranks of three)
    ns = ta.split_ctas(d) if kernel.startswith("tf32x3") else 1
    c = ns * min(4, 8 // ns)
    assert plan.cluster == c and plan.grid == (c, _ceil(200, 64) * 2, 1)
    assert plan.columns == ns and plan.head_ranks == min(4, 8 // ns)
    assert plan.query_tile == (32 if kernel.startswith("tf32x3") else 64)


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("hq,hkv,d,dtype,cluster", [
    (71, 1, 64, torch.bfloat16, 8), (14, 2, 80, torch.bfloat16, 7),
    (4, 4, 256, torch.bfloat16, 1), (8, 2, 64, torch.float32, 4),
    (8, 1, 256, torch.bfloat16, 8),   # Gemma-2B's attention heads: MQA, rep 8, D 256
    (4, 2, 192, torch.bfloat16, 2),   # D 192, rep 2
    (32, 4, 128, torch.float32, 8),   # f32 on clusters of 8 (tf32x3)
    (8, 2, 144, torch.float32, 8),    # f32 above D 128: pairs of CTAs, 2 min(rep, 4)
    (2, 2, 256, torch.float32, 2),    # ... MHA: the pair alone
    (12, 4, 192, torch.float32, 6),   # ... rep 3: three pairs
    (8, 2, 320, torch.float32, 6),    # above D 256: splits of 3 CTAs, two head ranks
    (8, 8, 1024, torch.float32, 8),   # ... of 8, MHA
    (8, 2, 1040, torch.float32, 1)])  # above D 1024: the CUDA cores, no cluster
def test_dkv_wrapper_hands_the_kernel_the_plans_cluster(monkeypatch, hq, hkv, d, dtype, cluster):
    log = []

    def stub(name):
        def launch(*args):
            log.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(_device, "on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(ta, "_launcher", stub)
    b, s = 1, 130
    q = torch.zeros((b, s, hq, d), dtype=dtype)
    k = torch.zeros((b, s, hkv, d), dtype=dtype)
    lse = torch.zeros((b, hq, s))
    di = torch.zeros((b, s, hq))
    before = ta.train_attn_bwd_dkv.launches
    ta.train_attn_bwd_dkv(q, k, k, None, q, lse, di)
    (name, args), = log
    assert name == "bd_train_attn_dkv" and ta.train_attn_bwd_dkv.launches == before + 1
    assert args[9:14] == (b, s, hq, hkv, d)
    assert args[-3:-1] == (cluster, int(dtype == torch.float32))
    plan = ta.dkv_plan(b, s, hq, hkv, d, dtype)
    assert cluster == plan.cluster and ta.train_attn_bwd_dkv.plan == plan
    if dtype == torch.bfloat16:
        assert plan.kernel == ("wgmma" if d <= 128 else "wgmma_wide")
    else:
        assert plan.kernel == ("tf32x3" if d <= 128 else "tf32x3_split" if d <= 1024
                               else "cores_wide")
    if plan.kernel != "cores_wide":
        assert plan.grid == (cluster, _ceil(s, TILE) * hkv, b)


@pytest.mark.parametrize("d,smem", [(64, 99744), (128, 231216), (144, 231232), (256, 231232)])
def test_tf32_dkv_shared_memory_fits(d, smem):
    """`dkv_tf32_smem`, csrc/train_attention.cu's DkvTf32 layout in Python:
    two CTAs an SM at DT = 64, one at 128; a pair's CTA (DT = 128) adds only
    its two mbarriers, its partials landing in the ds slots, and stays
    within a block's 232,448 bytes and the SM's 233,472 (1 KB a CTA)."""
    plan = ta.dkv_plan(2, 1024, 8, 1, d, torch.float32)
    assert plan.smem == ta.dkv_tf32_smem(d) == smem
    ctas = 2 if d <= 64 else 1
    assert plan.smem <= 232448
    assert ctas * (plan.smem + 1024) <= 233472 < (ctas + 1) * (plan.smem + 1024)
    fwd = ta.fwd_plan(2, 1024, 8, 1, d, torch.float32)
    assert fwd.smem <= 232448 and fwd.ctas_per_sm * (fwd.smem + 1024) <= 233472


def test_pair_ctas_at_gemma_2b_heads_in_f32():
    """d256_f32 (B 2, S 1024, 8 query heads over 1, D 256): dkv on 256 CTAs
    in clusters of 8 (four head ranks of two heads, each a pair), as many
    as the D = 128 kernel's clusters of 8 give; the forward on 512 CTAs in
    splits of 2."""
    dkv = ta.dkv_plan(2, 1024, 8, 1, 256, torch.float32)
    assert (dkv.kernel, dkv.cluster, dkv.grid, dkv.ctas, dkv.head_ranks) == (
        "tf32x3_split", 8, (8, 16, 2), 256, 4)
    assert dkv.ctas == ta.dkv_plan(2, 1024, 8, 1, 128, torch.float32).ctas
    assert len(ta.dkv_walk(1024, 8, 4, 0, 0, 32)) == 2 * 32  # two heads, 32 query stages
    fwd = ta.fwd_plan(2, 1024, 8, 1, 256, torch.float32)
    assert (fwd.kernel, fwd.cluster, fwd.grid, fwd.ctas) == ("tf32x3_split", 2, (16, 2, 16), 512)


SPLITS = [  # d, ns: the split of D's columns into ns CTAs of 128
    (144, 2), (256, 2), (272, 3), (320, 3), (512, 4), (1024, 8)]


@pytest.mark.parametrize("rep", [1, 2, 3, 8])
@pytest.mark.parametrize("d,ns", SPLITS)
def test_split_plans_by_head_dim(d, ns, rep):
    """f32 above D = 128 (bf16 above 256, widened to f32): the forward, dkv
    and dq on the 3xTF32 kernels split over ns = ceil(D / 128) CTAs; dkv
    clusters of ns min(rep, 8 // ns) (head ranks times column ranks, within
    the portable 8), the forward's and dq's clusters of ns along x over a
    grid of ns Hq."""
    b, s, hkv = 2, 300, 2
    hq = rep * hkv
    kernel = "tf32x3_split"
    for dtype in (torch.float32, torch.bfloat16) if d > 256 else (torch.float32,):
        dkv = ta.dkv_plan(b, s, hq, hkv, d, dtype)
        c = ns * min(rep, 8 // ns)
        assert (dkv.kernel, dkv.columns, dkv.cluster, dkv.grid) == (
            kernel, ns, c, (c, _ceil(s, TILE) * hkv, b))
        assert dkv.head_ranks == min(rep, 8 // ns) and dkv.cluster <= ta.MAX_CLUSTER
        assert dkv.smem == ta.dkv_tf32_smem(d) and dkv.query_tile == 32
        dq = ta.dq_plan(b, s, hq, hkv, d, dtype)
        assert (dq.kernel, dq.cluster, dq.grid) == (kernel, ns, (ns * hq, b, _ceil(s, 64)))
        assert dq.smem == ta.dq_tf32_smem(d)
        fwd = ta.fwd_plan(b, s, hq, hkv, d, dtype)
        assert (fwd.kernel, fwd.cluster, fwd.grid) == (kernel, ns, (ns * hq, b, _ceil(s, 64)))
        assert (fwd.stages, fwd.smem, fwd.ctas_per_sm) == ta.fwd_tf32_smem(d)
    assert ta.widened(torch.bfloat16, d) == (d > 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_above_1024_dkv_and_dq_stay_on_the_cuda_cores(dtype):
    """D = 1040 (ns would be 9, past the portable cluster): the CUDA-core
    kernels, one warp a row, 256-column slices, no cluster."""
    d, s = 1040, 300
    dkv, dq = ta.dkv_plan(2, s, 8, 2, d, dtype), ta.dq_plan(2, s, 8, 2, d, dtype)
    assert (dkv.kernel, dkv.cluster, dkv.grid) == ("cores_wide", 1, (_ceil(s, 8), 2, 2 * 5))
    assert (dq.kernel, dq.cluster, dq.grid) == ("cores_wide", 1, (_ceil(s, 8), 8, 2 * 5))
    assert not ta.widened(dtype, d)
    assert ta.fwd_plan(2, s, 8, 2, d, dtype).kernel == "cores_wide"


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_dq_plan_up_to_d256(d):
    """One CTA a (query head, batch, 64-row tile), bf16 up to D = 256 and f32
    up to 128; f32 above 128 a split of 2 along x."""
    for dtype, kernel in ((torch.bfloat16, "wgmma"), (torch.float32, "tf32x3")):
        if d > 128 and dtype == torch.float32:
            kernel = "tf32x3_split"
        plan = ta.dq_plan(1, 130, 8, 2, d, dtype)
        ns = 2 if kernel == "tf32x3_split" else 1
        assert (plan.kernel, plan.cluster, plan.grid) == (kernel, ns, (ns * 8, 1, 3))


@pytest.mark.parametrize("d,smem", [(64, 83104), (128, 214320), (144, 214336), (256, 214336),
                                    (320, 214336), (1024, 214336)])
def test_tf32_dq_shared_memory_fits(d, smem):
    """`dq_tf32_smem`, csrc/train_attention.cu's DqTf32 layout in Python:
    two CTAs an SM at DT = 64, one at 128; a split's CTA (DT = 128, any ns)
    adds only its two mbarriers, its partials landing in the ds slots. The
    dkv split CTA is the pair's (231,232 bytes). Both within a block's
    232,448 bytes and the SM's 233,472 (1 KB a CTA)."""
    assert ta.dq_tf32_smem(d) == smem
    ctas = 2 if d <= 64 else 1
    assert ctas * (smem + 1024) <= 233472 < (ctas + 1) * (smem + 1024)
    assert ta.dq_plan(1, 64, 2, 1, d, torch.float32).smem == smem
    if d > 128:
        assert ta.dkv_tf32_smem(d) == 231232 <= 232448


@pytest.mark.parametrize("hq,hkv,d,dtype,cluster", [
    (8, 2, 64, torch.float32, 1), (8, 2, 64, torch.bfloat16, 1), (8, 2, 256, torch.bfloat16, 1),
    (8, 2, 144, torch.float32, 2), (8, 2, 320, torch.float32, 3), (4, 4, 1024, torch.float32, 8),
    (8, 2, 1040, torch.float32, 1)])
def test_dq_wrapper_hands_the_kernel_the_plans_cluster(monkeypatch, hq, hkv, d, dtype, cluster):
    log = _stub(monkeypatch)
    b, s = 1, 130
    q = torch.zeros((b, s, hq, d), dtype=dtype)
    k = torch.zeros((b, s, hkv, d), dtype=dtype)
    before = ta.train_attn_bwd_dq.launches
    dq = ta.train_attn_bwd_dq(q, k, k, None, q, torch.zeros((b, hq, s)), torch.zeros((b, s, hq)))
    (name, args), = log
    assert name == "bd_train_attn_dq" and ta.train_attn_bwd_dq.launches == before + 1
    assert args[8:13] == (b, s, hq, hkv, d)
    assert args[-3:-1] == (cluster, int(dtype == torch.float32))
    plan = ta.train_attn_bwd_dq.plan
    assert plan == ta.dq_plan(b, s, hq, hkv, d, dtype) and plan.cluster == cluster
    assert dq.shape == q.shape and dq.dtype == dtype


def test_bf16_above_256_reaches_the_split_kernels_with_f32_inputs(monkeypatch):
    """bf16 at D = 320 through the autograd Function: the forward launched
    with the f32 flag on f32 copies of q, k and v, on its split plan (a
    cluster of 3); dkv and dq with the f32 flag on the same f32 copies of q,
    k, v and dout (made once in the backward), on the split plans; none on
    the bf16 tensors; the output and the gradients come back in bf16."""
    log = _stub(monkeypatch)
    b, s, hq, hkv, d = 1, 100, 8, 2, 320
    q = torch.zeros((b, s, hq, d), dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros((b, s, hkv, d), dtype=torch.bfloat16, requires_grad=True)
    v = torch.zeros((b, s, hkv, d), dtype=torch.bfloat16, requires_grad=True)
    out = ta.flash_train_attention(q, k, v, torch.ones((b, s), dtype=torch.int32))
    out.backward(torch.zeros_like(out))
    (fname, fargs), (kname, kargs), (qname, qargs) = log
    assert (fname, kname, qname) == ("bd_train_attn_fwd", "bd_train_attn_dkv", "bd_train_attn_dq")
    assert fargs[-3:-1] == (3, 1) and ta.train_attn_fwd.plan.kernel == "tf32x3_split"
    assert kargs[-3:-1] == (6, 1) and qargs[-3:-1] == (3, 1)  # the plans' clusters, f32
    assert kargs[:3] == qargs[:3] and kargs[4] == qargs[4]  # one copy of q, k, v, dout
    bf16 = {q.data_ptr(), k.data_ptr(), v.data_ptr()}
    assert not bf16 & {*fargs[:3], *kargs[:3]}  # not the bf16 tensors
    assert ta.train_attn_bwd_dkv.plan.kernel == ta.train_attn_bwd_dq.plan.kernel == "tf32x3_split"
    assert out.dtype == torch.bfloat16
    for t in (q, k, v):
        assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape


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
