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


@pytest.mark.parametrize("mode", ["greedy", "spec", "sampled", "custom"])
def test_replayed_steps_equal_eager_ones(gen, mode):
    """The engine's default route on the card replays captured step graphs:
    its tokens and launch counts equal its eager twin's (graphs=False) on
    the same requests at the same seed, through growth (64 -> 128 -> 256
    rows): greedy, speculative at every k of the ladder, sampled, and with
    per-request sampling (the custom step)."""
    from bitdistiller_tpu_torch.serve import Request
    from bitdistiller_tpu_torch.serve import engine as engine_mod

    cfg = dataclasses.replace(TINY_TEST, num_heads=4, num_kv_heads=2)
    params = random_packed_params(cfg, bits=2, group_size=128, device="cuda")
    sampled = mode in ("sampled", "custom")
    prompts = [[1, 2, 3] * 4, [4, 5], [7] * 20, list(range(3, 100)), [9, 8, 9, 8]]

    def run(graphs):
        eng = Engine(params, cfg, max_slots=4, max_len=256, eos_token_id=None, seed=3,
                     sampling=SamplingParams(temperature=0.8 if sampled else 0.0, top_p=0.9),
                     spec_decode=mode == "spec", spec_adaptive_k=False, device="cuda",
                     graphs=graphs)
        before = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
        outs = []
        for k in (engine_mod.SPEC_K_LADDER if mode == "spec" else (None,)):
            if k is not None:
                eng._spec_k_cur, eng.spec_min_accept = k, -1.0
            reqs = [Request(prompt_tokens=p, max_new_tokens=40 if i != 3 else 70,
                            sampling=(SamplingParams(temperature=0.5, top_k=20)
                                      if mode == "custom" and i % 2 else None))
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            outs.append([r.output_tokens for r in reqs])
        counts = [getattr(o, a) - b for (o, a), b in zip(engine_mod.LAUNCH_COUNTERS, before)]
        return eng, outs, counts

    replayed, outs, counts = run(None)
    twin, twin_outs, twin_counts = run(False)
    assert (replayed.route, twin.route) == ("graphs", "eager")
    assert outs == twin_outs and counts == twin_counts
    assert replayed.growths == twin.growths == [(64, 128), (128, 256)]
    assert replayed._graphs.replays > 0


def test_replayed_mesh_steps_equal_eager_ones(gen):
    """The engine over a tp = 2 mesh of two gloo ranks on the one card
    replays its pieces as chains of graphs split at each operation (A3i):
    on both ranks, without and with the ring, its tokens (greedy,
    speculative, sampled, a stored prompt's hit and tail prefill) and
    launch counts equal its eager twin's, every key has the segments worked
    out from the code, none of which captured no work, and the ranks'
    streams are equal."""
    from test_torch_dp_worker import spawn
    from torch_tp_worker import predicted_segments

    from bitdistiller_tpu_torch.serve import engine as engine_mod

    cfg = dataclasses.replace(TINY_TEST, num_heads=4, num_kv_heads=2)
    prompts = [[1, 2, 3] * 4, [4, 5], [7] * 20, list(range(3, 40))]
    ranks = spawn({"kind": "call", "target": "torch_tp_worker:card_engine_job", "cfg": cfg,
                   "prompts": prompts}, world=2)
    for out in ranks:
        for ring in ("0", "1"):
            replayed, twin = out[ring, "graphs"], out[ring, "eager"]
            assert replayed["streams"] == twin["streams"] == ranks[0][ring, "graphs"]["streams"]
            assert replayed["counts"] == twin["counts"] and any(twin["counts"])
            assert replayed["prefix_hits"] == twin["prefix_hits"] == 1
            assert replayed["empty"] == 0
            kinds = {engine_mod.piece(k) for k in replayed["segments"]}
            assert {"prefill", "insert", "commit", "extend", "uniform", "verify"} == kinds
            for key, n in replayed["segments"].items():
                assert n == predicted_segments(engine_mod.piece(key), cfg.num_layers, 2,
                                               ring == "1"), key


def test_unowned_views_the_memory_and_holds_none(gen):
    """`distributed.unowned` reads and writes the tensor's elements (a
    strided bf16 view too), and the memory is freed once the tensor is
    dropped, although the view lives on."""
    from bitdistiller_tpu_torch.parallel.distributed import unowned

    base = torch.randn(64, 96, device="cuda", dtype=torch.bfloat16, generator=gen)
    t = base[8:40, 16:80]
    view = unowned(t)
    assert view.shape == t.shape and view.stride() == t.stride() and torch.equal(view, t)
    view.add_(1)
    assert torch.equal(view, t) and torch.equal(base[8:40, 16:80], t)
    del base, t
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    big = torch.empty(1 << 24, device="cuda")
    view = unowned(big)
    del big
    assert torch.cuda.memory_allocated() == before and view.numel() == 1 << 24


@pytest.mark.parametrize("cache,a8", [("bf16", False), ("int8", False), ("bf16", True)],
                         ids=["bf16", "int8", "bf16-a8"])
def test_replayed_admission_equals_eager(gen, cache, a8, monkeypatch):
    """The admission pieces replayed on the card (prefill, insert, commit,
    a prompt's stored rows and a tail prefill): tokens and launch counts
    equal the eager twin's; the same keys replay into other slots with
    other prompts (a group of 1 into slot 1, then into slot 0), and exact
    and prefix prompt-cache hits replay their inserts and tail prefills.
    Under BITDISTILLER_QMM_A8=1 the replayed prefills run B4 (its
    CUtensorMaps encoded at capture over the fixed buffers)."""
    from bitdistiller_tpu_torch.serve import Request
    from bitdistiller_tpu_torch.serve import engine as engine_mod

    monkeypatch.setenv(qm.A8_ENV, "1" if a8 else "0")

    cfg = dataclasses.replace(TINY_TEST, num_heads=4, num_kv_heads=2)
    params = random_packed_params(cfg, bits=2, group_size=128, device="cuda")
    g = torch.Generator().manual_seed(5)
    rand = lambda n: torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
    pfx = rand(40)
    runs = [[(rand(30), 3, False)], [(rand(30), 30, False), (rand(12), 2, False),
                                      (rand(9), 6, False)],
            [(rand(20), 5, False)], [(pfx, 3, True)],
            [(pfx, 4, False), (pfx + rand(10), 5, True)],
            [(pfx + rand(12), 4, False), (pfx + rand(25), 3, False), (rand(70), 4, False)]]

    def run(graphs):
        eng = Engine(params, cfg, max_slots=2, max_len=256, eos_token_id=None, seed=3,
                     sampling=SamplingParams(temperature=0.0), prompt_cache_size=4,
                     cache_dtype=getattr(torch, "bfloat16" if cache == "bf16" else "int8"),
                     device="cuda", graphs=graphs)
        before = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
        outs = []
        for run_ in runs:
            reqs = [Request(prompt_tokens=p, max_new_tokens=n, cache_prompt=c) for p, n, c in run_]
            eng.run(reqs)
            outs.append([r.output_tokens for r in reqs])
        counts = [getattr(o, a) - b for (o, a), b in zip(engine_mod.LAUNCH_COUNTERS, before)]
        return eng, outs, counts

    replayed, outs, counts = run(None)
    twin, twin_outs, twin_counts = run(False)
    assert outs == twin_outs and counts == twin_counts
    a8_prefills = counts[engine_mod.LAUNCH_COUNTERS.index((qm.qmm_a8, "prefill_launches"))]
    assert (a8_prefills > 0) == a8
    table = replayed._graphs
    assert table.count(engine_mod.ADMISSION_PIECES)[1] >= 6
    assert ("prefill", 64, 1) in table.graphs
    assert any(k[0] == "extend" for k in table.captured)
    assert replayed.prompt_cache_prefix_hits == twin.prompt_cache_prefix_hits == 3


def test_materialize_switch_on_the_card(gen, monkeypatch, request):
    """BITDISTILLER_QMM_MATERIALIZE_M: at and above M rows the packed matmul
    runs as a bf16 dequantization and torch.matmul (no B1 launch), within
    bf16 rounding of B1; below it B1 runs."""
    qm.materialize_min_m.cache_clear()
    request.addfinalizer(qm.materialize_min_m.cache_clear)
    k, n = 1024, 512
    p = _packed(gen, k, n, 2, integer=False)
    x = torch.randn((300, k), device="cuda", generator=gen).bfloat16()
    ref = qm.quant_matmul(x, p).float()
    monkeypatch.setenv(qm.MATERIALIZE_ENV, "256")
    qm.materialize_min_m.cache_clear()
    before = qm.qmm_prefill.launches
    got = qm.quant_matmul(x, p).float()
    assert qm.qmm_prefill.launches == before
    assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    qm.quant_matmul(x[:200], p)
    assert qm.qmm_prefill.launches == before + 1


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


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_int_quantizers_give_the_cpu_bytes(gen, bits):
    """The int fake quantizers and the packer divide the group range by
    2^bits - 1 as the CPU does (a true division: PyTorch's CUDA division by a
    Python scalar is a product by the f32 reciprocal), so every scale, code
    and dequantized weight on the card is the CPU's, bf16 weights too."""
    from bitdistiller_tpu_torch.quant import core
    from bitdistiller_tpu_torch.quant.packing import quantize_pack_linear

    for dtype in (torch.float32, torch.bfloat16):
        w = (torch.randn((256, 192), device="cuda", generator=gen) * 0.05).to(dtype)
        wc = w.cpu()
        for ste in (False, True):
            assert torch.equal(core.fake_quant_int(w, bits, 64, ste=ste).cpu(),
                               core.fake_quant_int(wc, bits, 64, ste=ste))
            assert torch.equal(core.fake_quant_int_kaxis(w, bits, 64, ste=ste).cpu(),
                               core.fake_quant_int_kaxis(wc, bits, 64, ste=ste))
        if bits == 3:  # the packer takes 2 and 4 bits
            continue
        got, want = quantize_pack_linear(w, bits, 64), quantize_pack_linear(wc, bits, 64)
        for name in ("qweight", "scales", "szeros"):
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name))


@pytest.mark.parametrize("a8", [False, True])
def test_packed_perplexity_through_the_kernels_matches_plain(gen, a8, monkeypatch):
    """The eval's perplexity of a small packed tree on the card: every packed
    matmul of every block through B1 (A16) or B4's prefill kernel (A8),
    counted, and the summed NLL within 1e-2 relative of use_kernels=False on
    the same tree (bf16 outputs rounded after sums in another order)."""
    import numpy as np

    from bitdistiller_tpu_torch.eval.ppl import make_nll_fn, perplexity

    cfg = dataclasses.replace(TINY_TEST, num_heads=4, num_kv_heads=2)
    params = random_packed_params(cfg, bits=2, group_size=64, device="cuda")
    ref = dict(params, layers=dict(params["layers"]))
    for name, leaf in params["layers"].items():
        if isinstance(leaf, PackedLinear):
            s, sz = scales_from_combo(leaf.combo)
            ref["layers"][name] = dataclasses.replace(leaf, scales=s, szeros=sz)
    if a8:
        monkeypatch.setenv(qm.A8_ENV, "1")
        params = ref = qm.maybe_repack_a8(ref)
    blocks = np.random.default_rng(0).integers(0, cfg.vocab_size, (5, 128))
    counter, attr = (qm.qmm_a8, "prefill_launches") if a8 else (qm.qmm_prefill, "launches")
    before = getattr(counter, attr)
    ppl = perplexity(params, cfg, blocks, batch_size=2, device="cuda")
    assert getattr(counter, attr) - before == 3 * cfg.num_layers * 4
    assert np.isfinite(ppl)
    tokens = torch.as_tensor(blocks, device="cuda")
    k = make_nll_fn(cfg)(params, tokens).sum().item()
    p = make_nll_fn(cfg, use_kernels=False)(ref, tokens).sum().item()
    assert abs(k - p) <= 1e-2 * abs(p)
