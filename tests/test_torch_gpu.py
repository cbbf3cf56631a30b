"""The port's CUDA kernels against their plain versions on the card, at small
shapes (the full-width checks are in chip_smoke.py). Marked `gpu`; each test
skips without a CUDA device. On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: integer-valued inputs are exact (the A8 matmul too, with one
127 a row so the per-token scale is 1); the streaming decode kernels (A16
and A8 at M <= 32, both fused-MLP launches) and the cluster decode
attention give the same bytes on two calls; bf16 attention outputs within 2e-2
(one bf16 ulp of a prob, rounded against other running maxima); the fused
MLP within 1e-2 of max|plain| (bf16 outputs, f32 sums in another order, mid
rounded to bf16 at another f32 rounding of the activation); the stream sum
within 1e-5 relative (f32 sums in another order); a whole tiny-model decode
step within 5e-2 of the logit scale."""

import dataclasses

import pytest
import torch

from bitdistiller_tpu_torch.experimental.flash_decode import flash_decode_attention
from bitdistiller_tpu_torch.experimental.fused_mlp import fused_mlp, fused_mlp_plain
from bitdistiller_tpu_torch.models import TINY_TEST, KVCache, forward, random_packed_params
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.ops import quant_matmul as qm
from bitdistiller_tpu_torch.quant.packing import PackedLinear, make_scale_combo, scales_from_combo
from bitdistiller_tpu_torch.scripts import bw_probe
from bitdistiller_tpu_torch.serve import Engine, SamplingParams

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with pytest -m gpu")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("bits,m", [(2, 3), (2, 40), (4, 8), (4, 100)])
def test_packed_matmul_kernels_exact_on_integers(gen, bits, m):
    k, n, g, layers = 512, 320, 128, 3
    qw = torch.randint(-(2**31), 2**31 - 1, (layers, k * bits // 32, n), dtype=torch.int32,
                       device="cuda", generator=gen)
    scales = torch.ones((layers, k // g, n), device="cuda")
    szeros = torch.randint(0, 2**bits, (layers, k // g, n), device="cuda", generator=gen).float()
    p = PackedLinear(qweight=qw, scales=scales, szeros=szeros, bias=None, bits=bits,
                     group_size=g, in_features=k, out_features=n,
                     combo=make_scale_combo(scales, szeros))
    x = torch.randint(-4, 5, (m, k), device="cuda", generator=gen).bfloat16()
    before = qm.qmm_decode.launches + qm.qmm_prefill.launches
    got = qm.quant_matmul(x, p, 2)
    lay = p.layer(2)
    want = qm.quant_matmul_plain(x, lay.qweight, lay.scales, lay.szeros, bits, g)
    assert torch.equal(got, want)
    assert qm.qmm_decode.launches + qm.qmm_prefill.launches == before + 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,d,window", [(4, 4, 128, None), (8, 2, 64, None), (4, 2, 32, 9)])
def test_decode_attention_kernel_matches_plain(gen, kv, hq, hkv, d, window):
    b, t, layers = 3, 40, 2
    q = torch.randn((b, 1, hq, d), device="cuda", generator=gen).bfloat16()
    kn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).bfloat16()
    vn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).bfloat16()
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
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    got = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, start, **kw)
    want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, start, **kw)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_tiny_engine_runs_through_kernels(gen):
    cfg = dataclasses.replace(TINY_TEST, num_heads=4, num_kv_heads=2)
    params = random_packed_params(cfg, bits=2, group_size=128, device="cuda")
    eng = Engine(params, cfg, max_slots=2, max_len=64, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), device="cuda")
    before = da.flash_decode_stacked.launches
    outs = eng.generate([[1, 2, 3], [4, 5], [7] * 20], max_new_tokens=6)
    assert all(len(o) == 6 for o in outs)
    assert da.flash_decode_stacked.launches - before == eng.decode_steps * cfg.num_layers
    cache = KVCache.init(cfg, 2, 16, device="cuda")
    ref = dict(params, layers=dict(params["layers"]))
    for name, leaf in params["layers"].items():
        if isinstance(leaf, PackedLinear):
            s, sz = scales_from_combo(leaf.combo)
            ref["layers"][name] = dataclasses.replace(leaf, scales=s, szeros=sz)
    tok = torch.tensor([[5], [9]], device="cuda")
    pos = torch.tensor([3, 0], device="cuda")
    lk, _ = forward(params, cfg, tok, cache=cache, cache_pos=pos)
    lp, _ = forward(ref, cfg, tok, cache=cache, cache_pos=pos, use_kernels=False)
    assert (lk - lp).abs().max().item() <= 5e-2 * lp.abs().max().item()


def _packed(gen, k, n, bits, layers=None, integer=True):
    lead = () if layers is None else (layers,)
    qw = torch.randint(-(2**31), 2**31 - 1, lead + (k * bits // 32, n), dtype=torch.int32,
                       device="cuda", generator=gen)
    if integer:
        scales = torch.ones(lead + (k // 128, n), device="cuda")
        szeros = torch.randint(0, 2**bits, lead + (k // 128, n), device="cuda",
                               generator=gen).float()
    else:
        scales = torch.rand(lead + (k // 128, n), device="cuda", generator=gen) * 0.02 + 0.005
        szeros = scales * torch.randint(0, 2**bits, lead + (k // 128, n), device="cuda",
                                        generator=gen)
    return PackedLinear(qweight=qw, scales=scales, szeros=szeros, bias=None, bits=bits,
                        group_size=128, in_features=k, out_features=n,
                        combo=make_scale_combo(scales, szeros))


@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("bits,m", [(2, 3), (2, 40), (4, 8), (4, 100)])
def test_a8_kernel_exact_on_integers(gen, bits, m, repacked, monkeypatch):
    monkeypatch.setenv("BITDISTILLER_QMM_A8", "1")
    p = _packed(gen, 512, 320, bits, layers=3)
    if repacked:
        p = qm.repack_linear_a8(p)
    x = torch.randint(-5, 6, (m, 512), device="cuda", generator=gen).float()
    x[:, 0] = 127.0
    x = x.bfloat16()
    before = (qm.qmm_a8.launches, qm.qmm_decode.launches + qm.qmm_prefill.launches)
    got = qm.quant_matmul(x, p, 2)  # pair layout goes to A8 too: the switch is on
    lay = p.layer(2)
    want = qm.quant_matmul_a8_plain(x, lay.qweight, lay.scales, lay.szeros, bits, 128,
                                    p.a8_order)
    assert torch.equal(got, want)
    assert (qm.qmm_a8.launches, qm.qmm_decode.launches + qm.qmm_prefill.launches) == (
        before[0] + 1, before[1])


def _ints(gen, m, k, top=None):
    x = torch.randint(-4, 5, (m, k), device="cuda", generator=gen).float()
    if top is not None:
        x[:, 0] = top
    return x.bfloat16()


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [33, 130, 256])
def test_prefill_kernel_exact_on_integers(gen, bits, m, tile, monkeypatch):
    """The wgmma prefill kernel at its edges, on both tile heights: M just
    above the decode cap and ragged against both, 5 groups (no ring depth
    divides it), N = 320 (ragged against 128 columns), layer 2 of a stack."""
    monkeypatch.setattr(qm, "prefill_tile_m", lambda m, n, sms: tile)
    p = _packed(gen, 5 * 128, 320, bits, layers=3)
    x = _ints(gen, m, 5 * 128)
    before = (qm.qmm_prefill.launches, qm.qmm_decode.launches)
    got = qm.quant_matmul(x, p, 2)
    lay = p.layer(2)
    assert torch.equal(got, qm.quant_matmul_plain(x, lay.qweight, lay.scales, lay.szeros, bits, 128))
    assert (qm.qmm_prefill.launches, qm.qmm_decode.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [33, 130, 256])
def test_a8_prefill_kernel_exact_on_integers(gen, bits, m, repacked, tile, monkeypatch):
    """The s8 wgmma prefill kernel at the same edges; both counters move."""
    monkeypatch.setattr(qm, "prefill_tile_m", lambda m, n, sms: tile)
    p = _packed(gen, 5 * 128, 320, bits, layers=3)
    if repacked:
        p = qm.repack_linear_a8(p)
    x = _ints(gen, m, 5 * 128, top=127.0)  # one 127 a row: the per-token scale is 1
    before = (qm.qmm_a8.launches, qm.qmm_a8.prefill_launches)
    got = qm.quant_matmul_a8(x, p, 2)
    lay = p.layer(2)
    want = qm.quant_matmul_a8_plain(x, lay.qweight, lay.scales, lay.szeros, bits, 128, p.a8_order)
    assert torch.equal(got, want)
    assert (qm.qmm_a8.launches, qm.qmm_a8.prefill_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("a8", [False, True])
def test_prefill_kernels_close_on_bf16(gen, a8):
    """Random bf16 x and non-unit scales, with a bias on the A8 path: within
    1e-2 of max|plain| (one bf16 rounding of f32 sums in another order)."""
    p = _packed(gen, 5 * 128, 320, 2, layers=3, integer=False)
    x = torch.randn((200, 5 * 128), device="cuda", generator=gen).bfloat16()
    lay = p.layer(2)
    if a8:
        bias = torch.randn((320,), device="cuda", generator=gen)
        got = qm.qmm_a8(x, lay.qweight, lay.scales, lay.szeros, 2, 128, False, bias)
        want = qm.quant_matmul_a8_plain(x, lay.qweight, lay.scales, lay.szeros, 2, 128, False,
                                        bias)
    else:  # the plain version reads the scales the kernel decodes from the combo words
        got = qm.quant_matmul(x, p, 2)
        s, sz = scales_from_combo(lay.combo)
        want = qm.quant_matmul_plain(x, lay.qweight, s, sz, 2, 128)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("bits,m,act", [(2, 5, "silu"), (4, 40, "gelu")])
def test_fused_mlp_kernel_matches_plain(gen, bits, m, act):
    g, u = _packed(gen, 256, 384, bits, integer=False), _packed(gen, 256, 384, bits, integer=False)
    d = _packed(gen, 384, 200, bits, integer=False)
    x = torch.randn((m, 256), device="cuda", generator=gen).bfloat16()
    before = fused_mlp.launches
    got = fused_mlp(x, g, u, d, act)
    assert fused_mlp.launches == before + 1
    want = fused_mlp_plain(x, g, u, d, act)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 128), (32, 4, 128), (16, 2, 64)])
def test_flash_decode_attention_kernel_matches_plain(gen, hq, hkv, d):
    b, t = 3, 48
    q = torch.randn((b, 1, hq, d), device="cuda", generator=gen).bfloat16()
    ck = torch.randn((b, hkv, t, d), device="cuda", generator=gen).bfloat16()
    cv = torch.randn((b, hkv, t, d), device="cuda", generator=gen).bfloat16()
    kn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).bfloat16()
    vn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).bfloat16()
    start = torch.tensor([0, 20, 48], dtype=torch.int32, device="cuda")
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, ck, cv, kn, vn, start, window=30)
    assert flash_decode_attention.launches == before + 1
    want = da.decode_attention_plain(q, ck[None], cv[None], 0, kn, vn, start, window=30)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    # the stacked entry on a stack of this one layer (the same kernel)
    got_st = da.flash_decode_stacked(q, ck[None], cv[None], 0, kn, vn, start, window=30)
    assert (got_st.float() - want.float()).abs().max().item() <= 2e-2
    with pytest.raises(ValueError, match="bfloat16 cache"):  # the card takes bf16 only
        flash_decode_attention(q, ck.float(), cv.float(), kn, vn, start)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_stream_sum_kernel_matches_plain(gen, dtype):
    shape = (3, 5, 64, 128)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
        v = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
    else:
        k = torch.rand(shape, device="cuda", generator=gen).bfloat16()
        v = torch.rand(shape, device="cuda", generator=gen).bfloat16()
    c = torch.full((1,), 3.0, device="cuda")
    before = bw_probe.stream_sum.launches
    got = bw_probe.stream_sum(k, v, c)
    assert bw_probe.stream_sum.launches == before + 1
    want = bw_probe.stream_sum_plain(k, v, c)
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())


@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [1, 17, 32])
def test_a8_decode_exact_on_integers_at_the_down_shape(gen, m, bits, repacked):
    """The streaming A8 decode kernel at K = 11008 (86 groups: the
    cluster's K split has a remainder), N = 4096, layer 1 of a stack, token
    rows masked in one and four 8-row tiles."""
    p = _packed(gen, 11008, 4096, bits, layers=2)
    if repacked:
        p = qm.repack_linear_a8(p)
    x = _ints(gen, m, 11008, top=127.0)  # one 127 a row: the per-token scale is 1
    before = (qm.qmm_a8.launches, qm.qmm_a8.prefill_launches)
    got = qm.quant_matmul_a8(x, p, 1)
    lay = p.layer(1)
    want = qm.quant_matmul_a8_plain(x, lay.qweight, lay.scales, lay.szeros, bits, 128, p.a8_order)
    assert torch.equal(got, want)
    assert (qm.qmm_a8.launches, qm.qmm_a8.prefill_launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("k,n", [(11008, 4096), (4096, 320)])
def test_a8_decode_is_deterministic(gen, k, n):
    """Two calls on the same bf16 inputs give the same bytes (the cluster
    sums in rank order, no atomics), within 1e-2 of max|plain|."""
    p = _packed(gen, k, n, 2, integer=False)
    x = torch.randn((8, k), device="cuda", generator=gen).bfloat16()
    bias = torch.randn((n,), device="cuda", generator=gen)
    args = (x, p.qweight, p.scales, p.szeros, 2, 128, False, bias)
    a, b = qm.qmm_a8(*args), qm.qmm_a8(*args)
    assert torch.equal(a, b)
    want = qm.quant_matmul_a8_plain(*args)
    assert (a.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [1, 33])
def test_fused_mlp_streaming_kernel_matches_plain(gen, m, bits, act):
    """Both launches at an odd group count (FFN = 640: 5 groups, split over
    the down clusters with a remainder; K = 512), one and three 16-row
    fragments; bit-identical across two calls."""
    g, u = _packed(gen, 512, 640, bits, integer=False), _packed(gen, 512, 640, bits, integer=False)
    d = _packed(gen, 640, 320, bits, integer=False)
    x = torch.randn((m, 512), device="cuda", generator=gen).bfloat16()
    before = fused_mlp.launches
    got = fused_mlp(x, g, u, d, act)
    assert fused_mlp.launches == before + 1
    assert torch.equal(got, fused_mlp(x, g, u, d, act))
    want = fused_mlp_plain(x, g, u, d, act)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("cluster,m", [(16, 8), (1, 32)])
def test_cluster_launch_raises_on_a_size_the_card_cannot_hold(gen, cluster, m, monkeypatch):
    """A cluster of 16 (above the portable 8) and one CTA holding all of
    K = 11008 at 32 rows (352 KB of xi, above the 227 KB a block can have:
    the launcher's shared-memory and occupancy checks refuse it) raise and
    launch nothing; the next call on a good plan is right."""
    p = _packed(gen, 11008, 4096, 2)
    x = _ints(gen, m, 11008, top=127.0)
    want = qm.quant_matmul_a8_plain(x, p.qweight, p.scales, p.szeros, 2, 128, False)
    with monkeypatch.context() as mp:
        mp.setattr(qm, "decode_plan", lambda n, groups, sms: cluster)
        before = qm.qmm_a8.launches
        with pytest.raises(RuntimeError, match="cudaError"):
            qm.qmm_a8(x, p.qweight, p.scales, p.szeros, 2, 128, False)
        assert qm.qmm_a8.launches == before
    assert torch.equal(qm.qmm_a8(x, p.qweight, p.scales, p.szeros, 2, 128, False), want)


@pytest.mark.parametrize("warp_cols", [16, 32])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [1, 17, 32])
def test_a16_decode_exact_on_integers_at_the_down_shape(gen, m, bits, warp_cols, monkeypatch):
    """The streaming A16 decode kernel at K = 11008 (86 groups: the
    cluster's K split has a remainder), N = 4096, layer 1 of a stack, token
    rows masked in one and four 8-row tiles, on both column tiles a warp."""
    monkeypatch.setattr(qm, "a16_decode_plan", lambda n, groups, sms: (
        qm.decode_plan(n, groups, sms, cols=8 * warp_cols), warp_cols))
    p = _packed(gen, 11008, 4096, bits, layers=2)
    x = _ints(gen, m, 11008)
    before = (qm.qmm_decode.launches, qm.qmm_prefill.launches)
    got = qm.quant_matmul(x, p, 1)
    lay = p.layer(1)
    assert torch.equal(got, qm.quant_matmul_plain(x, lay.qweight, lay.scales, lay.szeros, bits, 128))
    assert (qm.qmm_decode.launches, qm.qmm_prefill.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("k,n", [(11008, 4096), (4096, 320)])
def test_a16_decode_is_deterministic(gen, k, n):
    """Two calls on the same bf16 inputs give the same bytes (the cluster
    sums in rank order, no atomics), within 1e-2 of max|plain| (the plain
    version reads the scales the kernel decodes from the combo words)."""
    p = _packed(gen, k, n, 2, integer=False)
    x = torch.randn((8, k), device="cuda", generator=gen).bfloat16()
    a, b = (qm.qmm_decode(x, p.qweight, p.combo, 2, 128) for _ in range(2))
    assert torch.equal(a, b)
    s, sz = scales_from_combo(p.combo)
    want = qm.quant_matmul_plain(x, p.qweight, s, sz, 2, 128)
    assert (a.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("cluster,m", [(16, 8), (1, 32)])
def test_a16_decode_raises_on_a_cluster_the_card_cannot_hold(gen, cluster, m, monkeypatch):
    """A cluster of 16 (above the portable 8) and one CTA holding all of
    K = 11008 at 32 rows (a 705 KB x slice) raise and launch nothing; the
    next call on the chosen plan is exact."""
    p = _packed(gen, 11008, 4096, 2)
    x = _ints(gen, m, 11008)
    want = qm.quant_matmul_plain(x, p.qweight, p.scales, p.szeros, 2, 128)
    with monkeypatch.context() as mp:
        mp.setattr(qm, "a16_decode_plan", lambda n, groups, sms: (cluster, 32))
        before = qm.qmm_decode.launches
        with pytest.raises(RuntimeError, match="cudaError"):
            qm.qmm_decode(x, p.qweight, p.combo, 2, 128)
        assert qm.qmm_decode.launches == before
    assert torch.equal(qm.qmm_decode(x, p.qweight, p.combo, 2, 128), want)


SPLIT_CASES = {  # name: (b, hq, hkv, t, d, starts, window, attn_len)
    "fewer_rows_than_ctas": (8, 8, 8, 64, 128, [0, 1, 2, 3, 4, 5, 6, 7], None, None),
    "one_long_slot": (4, 4, 4, 512, 128, [0, 511, 0, 0], None, None),
    "window_across_ctas": (3, 8, 2, 300, 64, [290, 37, 150], 100, None),
    "attn_len": (3, 4, 2, 256, 32, [100, 200, 0], None, 160),
    "rep8": (2, 32, 4, 200, 128, [199, 70], None, None),
}


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_attention_split_over_a_cluster(gen, case, kv, cluster, monkeypatch):
    """The kernel's rows split over C CTAs: fewer valid rows than CTAs
    (empty runs), one long slot beside empty ones, a window that crosses a
    run boundary, attn_len < T, rep 8; within 2e-2 of the plain version, and
    two calls give the same bytes (the cluster merges in rank order)."""
    b, hq, hkv, t, d, starts, window, attn_len = SPLIT_CASES[case]
    monkeypatch.setattr(da, "attention_plan", lambda b, hkv, sms: cluster)
    shape = (2, b, hkv, t, d)
    q = torch.randn((b, 1, hq, d), device="cuda", generator=gen).bfloat16()
    kn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).bfloat16()
    vn = torch.randn((b, 1, hkv, d), device="cuda", generator=gen).bfloat16()
    if kv == "int8":
        ck = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
        cv = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
        ks = torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02
        vs = torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02
    else:
        ck = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        cv = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        ks = vs = None
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, window=window, attn_len=attn_len)
    got = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, start, **kw)
    assert torch.equal(got, da.flash_decode_stacked(q, ck, cv, 1, kn, vn, start, **kw))
    want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, start, **kw)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_decode_attention_raises_on_a_cluster_the_card_cannot_hold(gen, monkeypatch):
    """A cluster of 16 CTAs (above the portable 8) raises and launches
    nothing."""
    q = torch.randn((2, 1, 4, 64), device="cuda", generator=gen).bfloat16()
    ck = torch.randn((1, 2, 4, 32, 64), device="cuda", generator=gen).bfloat16()
    kn = torch.randn((2, 1, 4, 64), device="cuda", generator=gen).bfloat16()
    start = torch.tensor([5, 31], dtype=torch.int32, device="cuda")
    monkeypatch.setattr(da, "attention_plan", lambda b, hkv, sms: 16)
    before = da.flash_decode_stacked.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        da.flash_decode_stacked(q, ck, ck, 0, kn, kn, start)
    assert da.flash_decode_stacked.launches == before


# ---- C6: the decode attention at any GQA rep and head dim -------------------------


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("b,hq,hkv,d,window", [
    (8, 71, 1, 64, None),   # Falcon-7B's heads: 36 head tiles of 2
    (3, 24, 8, 128, None),  # rep 3 (Llama-3.2-3B): tiles of 2, one head masked
    (3, 10, 2, 128, 9),     # rep 5, a window
    (3, 56, 8, 128, None),  # rep 7 (Yi-34B)
    (3, 16, 4, 72, None),   # D = 72: int8 rows of 72 bytes copied by element
    (3, 16, 4, 80, None),   # D = 80 on the width 128
    (3, 16, 4, 96, 9),
    (3, 16, 4, 320, None),  # D = 320: tiles of 2 at the width 512
    (3, 6, 6, 40, None),    # rep 1, D = 40
    (3, 12, 4, 100, None),  # D = 100: bf16 rows of 200 bytes (and int8 of 100) by element
])
def test_decode_attention_general_route_matches_plain(gen, b, hq, hkv, d, window, kv, qdtype):
    t, layers = 300, 2
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
    start = torch.tensor([0, 17, 299, 150, 64, 3, 250, 100][:b], dtype=torch.int32,
                         device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    before = da.flash_decode_stacked.launches
    got = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, start, **kw)
    assert da.flash_decode_stacked.launches == before + 1
    assert da.decode_tile(hq // hkv, d) is not None  # the general route
    want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, start, **kw)
    assert got.dtype == qdtype
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert torch.equal(got, da.flash_decode_stacked(q, ck, cv, 1, kn, vn, start, **kw))
