"""B8's dkv plan on the CPU: `dkv_plan` (which kernel by D: "wgmma" up to
D = 128, "wgmma_wide" above; the cluster size C = min(rep, 8) at every D;
the grid) and `dkv_walk` (what CTA `rank` of a cluster
walks for a key tile), which the CUDA launch of
csrc/train_attention.cu follows. Every (key tile, query head, query tile)
on or below the diagonal is walked exactly once, by one rank; the wrapper
hands the kernel the plan's cluster. No kernel launches here: the dispatch
test replaces the launcher with a recording stub, as
tests/test_torch_c1_dispatch.py does."""

import pytest
import torch

from bitdistiller_tpu_torch import _device
from bitdistiller_tpu_torch.ops import train_attention as ta

TILE = ta.DKV_KEY_TILE


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("s,rep", [(64, 1), (130, 2), (129, 4), (256, 7), (1024, 8), (130, 71),
                                   (2048, 1)])
def test_dkv_walk_covers_each_pair_once_on_or_below_the_diagonal(s, rep):
    plan = ta.dkv_plan(1, s, rep, 1, 64)
    nq = _ceil(s, ta.DKV_QUERY_TILE)
    for kt in range(_ceil(s, TILE)):
        walked = [(rank, pair) for rank in range(plan.cluster)
                  for pair in ta.dkv_walk(s, rep, plan.cluster, rank, kt)]
        pairs = [pair for _, pair in walked]
        # query tiles whose last row reaches the key tile's first key
        want = {(r, qt) for r in range(rep) for qt in range(nq)
                if (qt + 1) * ta.DKV_QUERY_TILE - 1 >= kt * TILE}
        assert len(pairs) == len(set(pairs)) and set(pairs) == want
        owner = {}
        for rank, (r, _) in walked:  # a head belongs to one rank
            assert owner.setdefault(r, rank) == rank


@pytest.mark.parametrize("rep,c", [(1, 1), (2, 2), (7, 7), (8, 8), (71, 8)])
def test_dkv_cluster_is_min_of_rep_and_8(rep, c):
    for b, hkv, d in ((1, 1, 64), (2, 2, 128)):
        plan = ta.dkv_plan(b, 300, rep * hkv, hkv, d)
        assert plan.kernel == "wgmma" and plan.cluster == c
        assert plan.grid == (c, _ceil(300, TILE) * hkv, b)


def test_dkv_ctas_at_tinyllama_and_llama2_7b():
    tiny = ta.dkv_plan(2, 1024, 32, 4, 64)  # TinyLlama: rep 8, D 64
    assert (tiny.kernel, tiny.cluster, tiny.grid, tiny.ctas) == ("wgmma", 8, (8, 64, 2), 1024)
    assert len(ta.dkv_walk(1024, 8, 8, 0, 0)) == 16  # the longest walk: 16 query tiles
    big = ta.dkv_plan(1, 2048, 32, 32, 128)  # Llama-2-7B: MHA, D 128
    assert (big.kernel, big.cluster, big.grid, big.ctas) == ("wgmma", 1, (1, 1024, 1), 1024)
    assert len(ta.dkv_walk(2048, 1, 1, 0, 0)) == 32


@pytest.mark.parametrize("d,kernel", [(16, "wgmma"), (64, "wgmma"), (80, "wgmma"),
                                      (128, "wgmma"), (144, "wgmma_wide"), (256, "wgmma_wide")])
def test_dkv_kernel_is_chosen_by_head_dim(d, kernel):
    plan = ta.dkv_plan(1, 200, 8, 2, d)
    assert plan.kernel == kernel
    # both kernels: clusters of min(rep, 8) CTAs a 64-row key tile and kv head
    assert plan.cluster == 4 and plan.grid == (4, _ceil(200, 64) * 2, 1)


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("hq,hkv,d,dtype,cluster", [
    (71, 1, 64, torch.bfloat16, 8), (14, 2, 80, torch.bfloat16, 7),
    (4, 4, 256, torch.bfloat16, 1), (8, 2, 64, torch.float32, 1),
    (8, 1, 256, torch.bfloat16, 8),   # Gemma-2B's attention heads: MQA, rep 8, D 256
    (4, 2, 192, torch.bfloat16, 2)])  # D 192, rep 2
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
    if dtype == torch.bfloat16:
        plan = ta.dkv_plan(b, s, hq, hkv, d)
        assert cluster == plan.cluster and ta.train_attn_bwd_dkv.plan == plan
        assert plan.kernel == ("wgmma" if d <= 128 else "wgmma_wide")
        assert plan.grid == (cluster, _ceil(s, TILE) * hkv, b)
