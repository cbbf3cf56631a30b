"""AutoClip on the port against the JAX package on the CPU: the clip search
(`search_layer_clip`), the block capture (`capture_block_inputs`) on every
family's tiny config, `run_autoclip` end to end, the clip cache both ways,
and the JAX package's faults that the port matches (ROADMAP C4).

Tolerances. The search: at least 99% of the (column, group) clips equal to
JAX's, and every clip's objective within 1e-5 relative of the objective of
JAX's clip, both evaluated by `objective` (the products in numpy f64): the
two packages sum the same f32 products in other orders, so a near-tie may
fall the other way. The capture: f32 inputs and next hidden states within
1e-5 of the largest |JAX value| (the same f32 operations in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.models import layers as jlayers
from bitdistiller_tpu.models import llama as jllama
from bitdistiller_tpu.quant import autoclip as jclip
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.layers import layer_norm
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.quant import autoclip as tclip
from test_torch_families import MODELS, _params, _tcfg
from torch_port_util import t2n, to_numpy_tree, torch_cfg

TINY = dataclasses.replace(TINY_TEST, dtype="float32")
FAMILIES = sorted(MODELS)
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes and loops of small ops: one intra-op thread (the suite
    runs several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jp = jinit(TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_numpy(to_numpy_tree(jp), "cpu")


def _calib(cfg, seed, nb, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (nb, s)).astype(np.int32)


def objective(w_kn, feat, mx, mn, quant_type, n_bit, group_size):
    """[N, K/G] mean over the tokens of (x_g . w_g - x_g . q_g)^2 in f64,
    q_g the clamped weights fake quantized by the port's f32 quantizer."""
    k, n = w_kn.shape
    g = group_size if group_size > 0 else k
    ng = k // g
    w = torch.from_numpy(np.array(w_kn, np.float32)).t().reshape(n, ng, g)
    cur = torch.clamp(w, torch.tensor(np.asarray(mn))[..., None],
                      torch.tensor(np.asarray(mx))[..., None])
    q = tclip._quantize_for_search(cur, quant_type, n_bit, g).numpy().astype(np.float64)
    f = np.asarray(feat, np.float64).reshape(-1, ng, g)
    org = np.einsum("tgk,ngk->ntg", f, w.numpy().astype(np.float64))
    out = np.einsum("tgk,ngk->ntg", f, q)
    return ((out - org) ** 2).mean(axis=1)


def _hold_clips(w, feat, got, want, quant_type, n_bit, group_size, share=0.99):
    (gmax, gmin), (wmax, wmin) = got, want
    assert gmax.shape == wmax.shape and gmin.shape == wmin.shape
    same = (gmax == wmax) & (gmin == wmin)
    assert same.mean() >= share, same.mean()
    og = objective(w, feat, gmax, gmin, quant_type, n_bit, group_size)
    ow = objective(w, feat, wmax, wmin, quant_type, n_bit, group_size)
    np.testing.assert_allclose(og, ow, rtol=REL, atol=0)
    return same.mean()


# ---- 1. search_layer_clip ------------------------------------------------------------

QUANTS = [("int", 2), ("int", 3), ("int", 4), ("nf3", 3)]
SEARCH_CASES = ([(q, b, g, 64) for q, b in QUANTS for g in (64, 128, -1)]
                + [(q, b, 64, 512) for q, b in QUANTS])


@pytest.mark.parametrize("quant_type,n_bit,group_size,n", SEARCH_CASES)
def test_search_layer_clip_matches_jax(quant_type, n_bit, group_size, n, monkeypatch):
    """K = 256, 40 tokens, heavy-tailed weights (clipping pays). Every
    quantizer at g64, g128 and per-channel on n = 64 (one chunk in both
    packages), and at g64 on n = 512: JAX's chunked route (256-column
    chunks) and the port's too (a chunk budget of 256 columns)."""
    rng = np.random.default_rng(n + n_bit + group_size)
    k, t = 256, 40
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[rng.integers(0, k, n // 2), rng.integers(0, n, n // 2)] *= 6
    feat = rng.standard_normal((t, k)).astype(np.float32)
    want = jclip.search_layer_clip(jnp.asarray(w), jnp.asarray(feat), quant_type=quant_type,
                                   n_bit=n_bit, group_size=group_size)
    if n == 512:
        monkeypatch.setattr(tclip, "SEARCH_ELEMS", (k // group_size) * t * 256)
    got = tclip.search_layer_clip(torch.from_numpy(w), torch.from_numpy(feat),
                                  quant_type=quant_type, n_bit=n_bit, group_size=group_size)
    _hold_clips(w, feat, [t2n(x) for x in got], [np.asarray(x) for x in want], quant_type,
                n_bit, group_size)


def test_search_chunks_change_no_value(monkeypatch):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((128, 48)).astype(np.float32))
    feat = torch.from_numpy(rng.standard_normal((24, 128)).astype(np.float32))
    whole = tclip.search_layer_clip(w, feat, quant_type="int", n_bit=2, group_size=64)
    for cols in (13, 32):  # ragged and even chunks
        monkeypatch.setattr(tclip, "SEARCH_ELEMS", 2 * 24 * cols)
        part = tclip.search_layer_clip(w, feat, quant_type="int", n_bit=2, group_size=64)
        assert all(torch.equal(a, b) for a, b in zip(whole, part))


def test_search_grid_is_the_jax_compiled_grid():
    """The last shrink of the 10 x 10 grid as JAX's compiled search holds it:
    0.55 on the max side, 0.54999995 on the min side. Where JAX's best clip
    sits there on both sides, its values are the group's max times 0.55 and
    min times 0.54999995, the port's equal them, and the min would differ
    at 0.55."""
    rng = np.random.default_rng(0)
    k, n, t = 128, 64, 48
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[rng.integers(0, k, 20), rng.integers(0, n, 20)] *= 6
    feat = rng.standard_normal((t, k)).astype(np.float32)
    jm, jn = (np.asarray(x) for x in jclip.search_layer_clip(
        jnp.asarray(w), jnp.asarray(feat), quant_type="int", n_bit=2, group_size=64))
    tm, tn = (t2n(x) for x in tclip.search_layer_clip(
        torch.from_numpy(w), torch.from_numpy(feat), quant_type="int", n_bit=2, group_size=64))
    wg = w.T.reshape(n, 2, 64)
    om, on = wg.max(-1), wg.min(-1)
    edge = (jm == om * np.float32(0.55)) & (jn == on * np.float32(0.54999995))
    assert edge.sum() >= 4, edge.sum()
    assert (on[edge] * np.float32(0.55) != jn[edge]).any()
    np.testing.assert_array_equal(tm[edge], jm[edge])
    np.testing.assert_array_equal(tn[edge], jn[edge])


# ---- 2. capture_block_inputs on every family -------------------------------------------


def _jax_layer_args(cfg, nb, s):
    """(cos, sin, mask) a layer and the ALiBi bias, as the JAX package's
    run_autoclip builds them (autoclip.py:171-206)."""
    cdt = jnp.dtype(cfg.dtype)
    positions = jnp.arange(s)[None, :]
    cos, sin = jlayers.rope_cos_sin(positions, cfg.actual_head_dim, cfg.rope_theta, cdt)
    per_layer_sliding = bool(cfg.sliding_layers) and cfg.sliding_window is not None
    mask_sliding = base_mask = cos_l = sin_l = None
    if cfg.sliding_window:
        allow = jnp.tril(jnp.ones((s, s), bool)) & (
            jnp.arange(s)[None, :] > jnp.arange(s)[:, None] - cfg.sliding_window)
        if per_layer_sliding:
            mask_sliding = allow[None, None]
            cos_l, sin_l = jlayers.rope_cos_sin(positions, cfg.actual_head_dim,
                                                cfg.rope_local_theta or cfg.rope_theta, cdt)
        else:
            base_mask = allow[None, None]
    bias = None
    if cfg.alibi:
        slopes = jlayers.alibi_slopes(cfg.num_heads)
        q_pos = jnp.broadcast_to(positions, (nb, s))
        dist = (q_pos[:, :, None] - q_pos[:, None, :]).astype(jnp.float32)
        bias = -slopes[None, :, None, None] * jnp.maximum(dist, 0.0)[:, None]
    layers = [(cos_l, sin_l, mask_sliding) if per_layer_sliding and cfg.sliding_layers[li]
              else (cos, sin, base_mask) for li in range(cfg.num_layers)]
    return layers, bias


def _family(name):
    if name == "tiny":
        return TINY, torch_cfg(TINY)
    return MODELS[name], _tcfg(name)


def _family_params(name, tiny_params):
    return tiny_params if name == "tiny" else _params(name)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(t2n(got), want, rtol=REL, atol=REL * np.abs(want).max())


@pytest.mark.parametrize("name", ["tiny"] + FAMILIES)
def test_capture_block_inputs_matches_jax(name, tiny):
    """Every layer of every family: the same h in, each linear's input and
    the next hidden state out."""
    jcfg, tcfg = _family(name)
    jp, tp = _family_params(name, tiny)
    nb, s = 2, 12
    jargs, jbias = _jax_layer_args(jcfg, nb, s)
    targs, tbias = tclip._layer_args(tcfg, s, nb, torch.device("cpu"))
    if jbias is not None:
        _close(tbias, jbias)
    h = np.random.default_rng(7).standard_normal((nb, s, jcfg.hidden_size)).astype(np.float32)
    capture = jax.jit(functools.partial(jclip.capture_block_inputs, jcfg))
    for li in range(jcfg.num_layers):
        lp = jax.tree_util.tree_map(lambda x: x[li], jp["layers"])
        jh, jcaps = capture(lp, jnp.asarray(h), *jargs[li], jbias)
        th, tcaps = tclip.capture_block_inputs(tcfg, tp["layers"], li, torch.from_numpy(h),
                                               *targs[li], tbias)
        assert sorted(tcaps) == sorted(jcaps)
        for key in jcaps:
            _close(tcaps[key], jcaps[key])
        _close(th, jh)
        h = np.array(jh)


# ---- 3. run_autoclip end to end ----------------------------------------------------------


def _recorded_searches(monkeypatch, module):
    """Wrap a package's search_layer_clip: [(w, feat, (max, min))] a call."""
    calls = []
    real = module.search_layer_clip

    def spy(w, feat, **kw):
        out = real(w, feat, **kw)
        to_np = t2n if isinstance(feat, torch.Tensor) else np.asarray
        calls.append((to_np(w), to_np(feat), tuple(to_np(x) for x in out)))
        return out

    monkeypatch.setattr(module, "search_layer_clip", spy)
    return calls


@pytest.mark.parametrize("name", ["tiny"] + FAMILIES)
def test_run_autoclip_matches_jax(name, tiny, monkeypatch):
    """The clips of every searched linear of every layer, and the sampled
    inputs they were searched on (int2, g32: it divides every tiny width)."""
    jcfg, tcfg = _family(name)
    jp, tp = _family_params(name, tiny)
    calib = _calib(jcfg, 1, 2, 16)
    kw = dict(quant_type="int", n_bit=2, group_size=32, n_sample_token=16, apply=False)
    jcalls = _recorded_searches(monkeypatch, jclip)
    tcalls = _recorded_searches(monkeypatch, tclip)
    want = jclip.run_autoclip(jp, jcfg, calib, **kw)["clip"]
    got = tclip.run_autoclip(tp, tcfg, calib, **kw)["clip"]
    assert sorted(got) == sorted(want) == list(range(jcfg.num_layers))
    assert len(tcalls) == len(jcalls)
    for li in want:
        assert list(got[li]) == list(want[li]) == list(jclip.clip_linears(jcfg))
    for (jw, jfeat, jclips), (tw, tfeat, tclips) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tw, jw)
        assert tfeat.shape == jfeat.shape == (16, jw.shape[0])
        np.testing.assert_allclose(tfeat, jfeat, rtol=REL, atol=REL * np.abs(jfeat).max())
        _hold_clips(jw, jfeat, tclips, jclips, "int", 2, 32, share=0.9)
    same = np.mean([np.mean((g[0] == w[0]) & (g[1] == w[1]))
                    for (_, _, w), (_, _, g) in zip(jcalls, tcalls)])
    assert same >= 0.99, same
    for li in want:
        for key in want[li]:
            for a, b in zip(got[li][key], want[li][key]):
                assert a.dtype == np.float32 and a.shape == b.shape


def test_run_autoclip_applies_to_a_copy(tiny):
    """apply=True clamps a copy (q and k untouched, every clamped weight
    within the original's range, the original tree unchanged); apply=False
    returns the params themselves, unchanged."""
    _, tp = tiny
    before = {k: v["w"].clone() for k, v in tp["layers"].items() if isinstance(v, dict)}
    calib = _calib(TINY, 2, 2, 32)
    res = tclip.run_autoclip(tp, torch_cfg(TINY), calib, group_size=64, n_sample_token=32)
    for name, w in before.items():
        assert torch.equal(tp["layers"][name]["w"], w)
    out = res["params"]["layers"]
    assert out["q"] is tp["layers"]["q"] and out["k"] is tp["layers"]["k"]
    assert not torch.equal(out["down"]["w"], before["down"])
    assert (out["down"]["w"].abs() <= before["down"].abs()).all()
    off = tclip.run_autoclip(tp, torch_cfg(TINY), calib, group_size=64, n_sample_token=32,
                             apply=False)
    assert off["params"] is tp
    for name, w in before.items():
        assert torch.equal(tp["layers"][name]["w"], w)
    for li in res["clip"]:
        for name in res["clip"][li]:
            for a, b in zip(off["clip"][li][name], res["clip"][li][name]):
                np.testing.assert_array_equal(a, b)


def test_next_layer_input_comes_from_the_unclipped_block(tiny, monkeypatch):
    """Layer 1 is searched on the output of layer 0's UNCLIPPED block, not
    on that of the clipped weights written into the copy."""
    _, tp = tiny
    tcfg = torch_cfg(TINY)
    seen = []
    real = tclip.capture_block_inputs

    def spy(cfg, lp, li, h, *args):
        seen.append((li, h.clone()))
        return real(cfg, lp, li, h, *args)

    monkeypatch.setattr(tclip, "capture_block_inputs", spy)
    calib = _calib(TINY, 3, 2, 32)
    res = tclip.run_autoclip(tp, tcfg, calib, group_size=64, n_sample_token=32)
    (l0, h0), (l1, h1) = seen
    assert (l0, l1) == (0, 1)
    args, bias = tclip._layer_args(tcfg, 32, 2, torch.device("cpu"))
    unclipped, _ = real(tcfg, tp["layers"], 0, h0, *args[0], bias)
    clipped, _ = real(tcfg, res["params"]["layers"], 0, h0, *args[0], bias)
    assert torch.equal(h1, unclipped)
    assert (h1 - clipped).abs().max() > 1e-3


def test_capture_in_chunks_of_blocks(tiny, monkeypatch):
    """One block a capture call keeps the same sampled rows (a stride that
    does not divide the block) and, on the CPU, the same values."""
    _, tp = tiny
    tcfg = torch_cfg(TINY)
    calib = _calib(TINY, 4, 3, 12)  # 36 rows, stride 7: rows 0, 7, ..., 35
    kw = dict(group_size=64, n_sample_token=5, apply=False)
    calls = _recorded_searches(monkeypatch, tclip)
    whole = tclip.run_autoclip(tp, tcfg, calib, **kw)["clip"]
    monkeypatch.setattr(tclip, "CAPTURE_ELEMS", 1)
    chunked = tclip.run_autoclip(tp, tcfg, calib, **kw)["clip"]
    half = len(calls) // 2
    for (_, fa, _), (_, fb, _) in zip(calls[:half], calls[half:]):
        assert fa.shape == (6, fa.shape[1])
        np.testing.assert_allclose(fb, fa, rtol=REL, atol=REL * np.abs(fa).max())
    for li in whole:
        for name in whole[li]:
            for a, b in zip(chunked[li][name], whole[li][name]):
                np.testing.assert_array_equal(a, b)


# ---- 4. the clip cache both ways ---------------------------------------------------------


def test_clip_cache_crosses_both_ways(tmp_path, tiny):
    jp, tp = tiny
    calib = _calib(TINY, 5, 2, 32)
    clip = tclip.run_autoclip(tp, torch_cfg(TINY), calib, group_size=64, n_sample_token=32,
                              apply=False)["clip"]
    tclip.save_clip_cache(str(tmp_path / "port.npz"), clip)
    jclip.save_clip_cache(str(tmp_path / "jax.npz"), clip)
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert a.files == b.files
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])
        assert a[key].dtype == b[key].dtype
    for path, loader in ((tmp_path / "port.npz", jclip.load_clip_cache),
                         (tmp_path / "jax.npz", tclip.load_clip_cache)):
        back = loader(str(path))
        assert sorted(back) == sorted(clip)
        for li in clip:
            assert sorted(back[li]) == sorted(clip[li])
            for name in clip[li]:
                for x, y in zip(back[li][name], clip[li][name]):
                    np.testing.assert_array_equal(x, y)
    # the clamp of the tree by either file is the same
    want = jclip.apply_clip_cache(jp, jclip.load_clip_cache(str(tmp_path / "port.npz")))
    got = tclip.apply_clip_cache(tp, tclip.load_clip_cache(str(tmp_path / "jax.npz")))
    for name in clip[0]:
        np.testing.assert_array_equal(t2n(got["layers"][name]["w"]),
                                      np.asarray(want["layers"][name]["w"]))


# ---- 5. the JAX package's faults, matched (ROADMAP C4) -------------------------------------


def _layer0_inputs(name, monkeypatch):
    """Both packages' layer-0 block inputs (h, cos) in the forward and in
    run_autoclip, recorded at the block: {(package, path): (h, cos)}."""
    jcfg, tcfg = _family(name)
    jp, tp = _params(name)
    seen: dict = {}
    jreal, treal = jllama._block, tllama._block

    def jspy(cfg, lp, h, cos, sin, *args, **kw):
        def record(hv, cv):
            seen.setdefault(("jax", where[0]), (np.asarray(hv), np.asarray(cv)))
        jax.debug.callback(record, h, cos if cos is not None else jnp.zeros(()), ordered=True)
        return jreal(cfg, lp, h, cos, sin, *args, **kw)

    def tspy(cfg, lp, norms, li, h, cos, sin, *args):
        if li == 0:
            c = cos if cos is not None else torch.zeros(())
            seen.setdefault(("port", where[0]), (t2n(h).copy(), t2n(c).copy()))
        return treal(cfg, lp, norms, li, h, cos, sin, *args)

    monkeypatch.setattr(jllama, "_block", jspy)
    monkeypatch.setattr(tllama, "_block", tspy)
    calib = _calib(jcfg, 6, 2, 16)
    kw = dict(quant_type="int", n_bit=2, group_size=32, n_sample_token=16, apply=False)
    where = ["forward"]
    jllama.forward(jp, jcfg, jnp.asarray(calib))
    tllama.forward(tp, tcfg, torch.from_numpy(calib).long())
    where[0] = "autoclip"
    jclip.run_autoclip(jp, jcfg, calib, **kw)
    tclip.run_autoclip(tp, tcfg, calib, **kw)
    for path in ("forward", "autoclip"):
        for i in range(2 if jcfg.use_rope else 1):
            want = seen[("jax", path)][i]
            np.testing.assert_allclose(seen[("port", path)][i], want, rtol=REL,
                                       atol=REL * max(np.abs(want).max(), 1.0))
    return seen, jp, calib


def test_c4_autoclip_skips_the_embedding_norm_as_jax(monkeypatch):
    """Bloom: the forward's layer-0 input is LayerNorm(embed); AutoClip's in
    both packages is the embedding alone."""
    seen, jp, calib = _layer0_inputs("bloom", monkeypatch)
    emb = np.asarray(jp["embed"])[calib]
    np.testing.assert_array_equal(seen[("jax", "autoclip")][0], emb)
    np.testing.assert_array_equal(seen[("port", "autoclip")][0], emb)
    w, b = (torch.from_numpy(np.array(jp["embed_norm"][k])) for k in ("w", "b"))
    normed = t2n(layer_norm(torch.from_numpy(emb), w, b, 1e-5))
    np.testing.assert_allclose(seen[("jax", "forward")][0], normed, rtol=1e-5, atol=1e-5)
    assert np.abs(seen[("port", "forward")][0] - emb).max() > 0.1


def test_c4_autoclip_skips_the_learned_positions_as_jax(monkeypatch):
    """OPT: the forward adds pos_embed[positions + 2]; AutoClip does not."""
    seen, jp, calib = _layer0_inputs("opt", monkeypatch)
    emb = np.asarray(jp["embed"])[calib]
    offset = MODELS["opt"].pos_embedding_offset
    pos = np.asarray(jp["pos_embed"])[np.arange(calib.shape[1]) + offset]
    for pkg in ("jax", "port"):
        np.testing.assert_array_equal(seen[(pkg, "autoclip")][0], emb)
        np.testing.assert_allclose(seen[(pkg, "forward")][0], emb + pos[None], rtol=1e-6, atol=1e-6)


def test_c4_autoclip_skips_the_rope_scaling_as_jax(monkeypatch):
    """Phi-3 (longrope): the forward rotates with the scaled tables;
    AutoClip in both packages with the unscaled ones, on the same h."""
    seen, jp, calib = _layer0_inputs("phi3", monkeypatch)
    cfg = MODELS["phi3"]
    plain, _ = jlayers.rope_cos_sin(jnp.arange(calib.shape[1])[None], cfg.actual_head_dim,
                                    cfg.rope_theta, jnp.float32)
    inv, mscale = jlayers.rope_scaling_params(cfg, cfg.actual_head_dim, cfg.rope_theta)
    scaled, _ = jlayers.rope_cos_sin(jnp.arange(calib.shape[1])[None], cfg.actual_head_dim,
                                     cfg.rope_theta, jnp.float32, inv_freq=inv, mscale=mscale)
    for pkg in ("jax", "port"):
        np.testing.assert_array_equal(seen[(pkg, "autoclip")][0], seen[(pkg, "forward")][0])
        np.testing.assert_allclose(seen[(pkg, "autoclip")][1], np.asarray(plain), atol=1e-6)
        np.testing.assert_allclose(seen[(pkg, "forward")][1], np.asarray(scaled), atol=1e-6)
    assert np.abs(np.asarray(plain) - np.asarray(scaled)).max() > 0.05
