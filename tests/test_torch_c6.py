"""The C6 repair on the CPU: the shapes the JAX package computes and earlier
slices of the port refused on the card.

(i) JAX parity: the port's plain path against the JAX package's forward at
logits, on two small Llama configs that reach every part of C6, with int2
weights packed at g64 and g32 by the JAX package and carried across with
`params_from_numpy`: hidden 448 with 7 query heads over 1 kv head of D = 64
(GQA rep 7; K = 448 and FFN = 1216 are 64 mod 128: a half last K step), and
hidden 320 with 4 heads over 2 of D = 80 (FFN 704). A prefill and two decode
steps against an f32 cache (the decode attention at rep 7 and D = 80; the
JAX side through its Pallas decode kernel in interpret mode).

(ii) B8 at a head dim that is not a multiple of 16 (72, and 300 on the
splits of 3 CTAs), and at D = 512 (the splits of 4): `flash_train_attention`
pads q, k, v to a multiple of 16 and runs the plain version at the real D's
scale (the card's route, with the plain version for the kernels), against
the JAX package's `flash_train_attention` (which pads D to 128 and scales
by the real D) in Pallas interpret mode: values and the three gradients.

(iii) Dispatch: rep 3, 7 and 71, D = 80 and 320, K = 4544 at g32 and g64,
and B8 at D = 72 and 300 each choose a kernel entry, never a plain version,
and hand the kernel the real D's scale, the tile and the plan (the
recording-stub pattern of tests/test_torch_c1_dispatch.py).

Tolerances: f32 on both sides (logits within 1e-4: summation order only;
the integer-input packed matmuls are exact on the card, and here both sides
sum f32 products of the same codes); B8 within 1e-4 of max|JAX| per tensor,
as tests/test_torch_train_attention.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitdistiller_tpu.models import TINY_TEST, KVCache, init_params, llama
from bitdistiller_tpu.models.layers import flash_train_attention as jax_flash
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu_torch import _device
from bitdistiller_tpu_torch.experimental import fused_mlp as fm
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.ops import quant_matmul as qm
from bitdistiller_tpu_torch.ops import train_attention as ta
from bitdistiller_tpu_torch.quant.packing import quantize_pack_linear
from torch_port_util import t2n, to_numpy_tree, torch_cfg

CONFIGS = {
    "rep7_k448": dataclasses.replace(TINY_TEST, hidden_size=448, num_heads=7, num_kv_heads=1,
                                     intermediate_size=1216, dtype="float32"),
    "d80_k320": dataclasses.replace(TINY_TEST, hidden_size=320, num_heads=4, num_kv_heads=2,
                                    intermediate_size=704, dtype="float32"),
}


@pytest.fixture(scope="module")
def packed():
    out = {}
    for name, cfg in CONFIGS.items():
        dense = init_params(cfg, jax.random.key(0), dtype=jnp.float32)
        for g in (64, 32):
            out[name, g] = pack_model(dense, cfg, bits=2, group_size=g)
    return out


def _tokens(seed, cfg, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("group", [64, 32])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_match_jax(packed, name, group):
    cfg = CONFIGS[name]
    params = packed[name, group]
    toks = _tokens(1, cfg, 2, 12)
    want, _ = llama.forward(params, cfg, jnp.asarray(toks))
    got, _ = tllama.forward(params_from_numpy(to_numpy_tree(params), "cpu"), torch_cfg(cfg),
                            torch.from_numpy(toks).long())
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("group", [64, 32])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_steps_match_jax(packed, name, group):
    """Prefill 8 tokens into an f32 cache, then two per-slot decode steps
    (the decode attention at the config's rep and D)."""
    cfg = CONFIGS[name]
    tcfg = torch_cfg(cfg)
    params = packed[name, group]
    tparams = params_from_numpy(to_numpy_tree(params), "cpu")
    b, t = 2, 32
    jc = KVCache.init(cfg, batch=b, max_len=t, dtype=jnp.float32)
    tc = tllama.KVCache.init(tcfg, b, t, torch.float32, device="cpu")
    prompt = _tokens(3, cfg, b, 8)
    _, jc = llama.forward(params, cfg, jnp.asarray(prompt), cache=jc, cache_pos=0)
    _, tc = tllama.forward(tparams, tcfg, torch.from_numpy(prompt).long(), cache=tc,
                           cache_pos=0)
    pos = np.asarray([8, 5], np.int32)
    tok = _tokens(4, cfg, b, 1)
    before = da.flash_decode_stacked.plain_calls
    for _ in range(2):
        wl, jc = llama.forward(params, cfg, jnp.asarray(tok), cache=jc,
                               cache_pos=jnp.asarray(pos), flash2=True)
        gl, tc = tllama.forward(tparams, tcfg, torch.from_numpy(tok).long(), cache=tc,
                                cache_pos=torch.from_numpy(pos))
        np.testing.assert_allclose(t2n(gl), np.asarray(wl), rtol=1e-4, atol=1e-4)
        tok = np.array(wl[:, -1].argmax(-1), np.int32)[:, None]
        pos = pos + 1
    # the decode attention route (its plain version on the CPU), once a layer a step
    assert da.flash_decode_stacked.plain_calls == before + 2 * cfg.num_layers


def _b8_case(s, hq, hkv, d, padded, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    do = rng.standard_normal((1, s, hq, d)).astype(np.float32)
    mask = None
    if padded:
        mask = np.ones((1, s), np.int32)
        mask[0, s - s // 4:] = 0
    return q, k, v, do, mask


def _jax_b8(q, k, v, do, mask):
    m = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, m),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _torch_b8(fn, q, k, v, do, mask):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(tq, tk, tv, None if mask is None else torch.tensor(mask))
    out.backward(torch.tensor(do))
    return [out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()]


def _padded_plain(q, k, v, attn_mask):
    """The card's route with the plain version for the kernels: zero columns
    to a multiple of 16, the real D's scale, the result sliced back."""
    d = q.shape[3]
    dp = ta.padded_head_dim(d)
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    out = ta.flash_train_attention_plain(pad(q), pad(k), pad(v), attn_mask,
                                         scale=1.0 / math.sqrt(d))
    return out[..., :d]


@pytest.mark.parametrize("entry", ["wrapper", "composed"])
@pytest.mark.parametrize("s,hq,hkv,d,padded", [
    (128, 4, 2, 72, True),   # GQA rep 2, padded to 80
    (96, 2, 1, 300, False),  # rep 2, padded to 304 (the splits of 3 on the card)
    (64, 2, 1, 512, False),  # rep 2, D = 512 (the splits of 4 on the card)
])
def test_b8_padded_head_dim_matches_jax(s, hq, hkv, d, padded, entry):
    case = _b8_case(s, hq, hkv, d, padded)
    want = _jax_b8(*case)
    fn = ta.flash_train_attention if entry == "wrapper" else _padded_plain
    got = _torch_b8(fn, *case)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


# ---- (iii) dispatch --------------------------------------------------------------

class _Stream:
    cuda_stream = 0


@pytest.fixture
def calls(monkeypatch):
    log = []

    def stub(name):
        def launch(*args):
            log.append((name, args))
            return 0
        return launch

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran for a tensor on the card")

    monkeypatch.setattr(_device, "on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    for mod in (qm, fm, da):
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    monkeypatch.setattr(qm, "_launcher", stub)
    monkeypatch.setattr(qm, "_a8_launcher", lambda: stub("bd_qmm_a8"))
    monkeypatch.setattr(fm, "_launcher", lambda: stub("bd_fused_mlp"))
    monkeypatch.setattr(da, "_launcher", lambda: stub("bd_flash_decode"))
    monkeypatch.setattr(ta, "_launcher", stub)
    for mod, name in ((qm, "quant_matmul_plain"), (qm, "quant_matmul_a8_plain"),
                      (fm, "fused_mlp_plain"), (da, "decode_attention_plain"),
                      (ta, "flash_train_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    return log


@pytest.mark.parametrize("hq,hkv,d,tile", [
    (24, 8, 128, (2, 128)),  # rep 3: two tiles of 2, one head masked
    (56, 8, 128, (2, 128)),  # rep 7
    (71, 1, 64, (2, 64)),    # Falcon-7B: 36 tiles of 2
    (16, 4, 80, (2, 128)),   # D = 80, columns 80 .. 127 masked
    (16, 4, 320, (2, 512)),  # D = 320 at width 512
    (6, 6, 40, (1, 64)),     # rep 1, D = 40
])
def test_decode_attention_general_route_takes_the_kernel(calls, hq, hkv, d, tile):
    b, t = 2, 16
    q = torch.zeros((b, 1, hq, d), dtype=torch.bfloat16)
    kv = torch.zeros((b, 1, hkv, d), dtype=torch.bfloat16)
    ck = torch.zeros((2, b, hkv, t, d), dtype=torch.bfloat16)
    before = da.flash_decode_stacked.launches
    da.flash_decode_stacked(q, ck, ck, 1, kv, kv, torch.tensor([3, 9], dtype=torch.int32))
    name, args = calls[-1]
    assert name == "bd_flash_decode" and da.flash_decode_stacked.launches == before + 1
    rep = hq // hkv
    tiles = -(-rep // tile[0])
    assert args[12] == rep and args[14] == d and args[17] == pytest.approx(1 / math.sqrt(d))
    assert args[18] == da.attention_plan(b, hkv * tiles, 132) and args[19] == 0  # bf16 q
    assert da.decode_tile(rep, d) == tile and da.head_tiles(rep, d) == tiles


@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("group", [64, 32])
def test_packed_matmuls_at_k_64_mod_128_take_the_kernels(calls, group, m):
    k, n = 4544, 4672  # Falcon-7B's qkv
    p = quantize_pack_linear(torch.zeros((k, n)), 2, group)
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    qm.quant_matmul(x, p)
    name, args = calls[-1]
    assert name == ("bd_qmm_decode" if m <= qm.DECODE_MAX_M else "bd_qmm_prefill")
    off = 5 if m <= qm.DECODE_MAX_M else 7  # pointers before M
    assert args[off:off + 5] == (m, k, n, 2, group)
    if m <= qm.DECODE_MAX_M:  # the cluster splits the 36 steps (the last a half step)
        assert 1 <= args[off + 5] <= qm.kernel_steps(k) == 36
    qm.quant_matmul_a8(x, qm.repack_linear_a8(p))
    name, args = calls[-1]
    assert name == "bd_qmm_a8" and args[10:15] == (m, k, n, 2, group)
    if m <= qm.DECODE_MAX_M:
        assert args[16] == qm.decode_plan(n, 36, 132)


@pytest.mark.parametrize("group", [64, 32])
def test_fused_mlp_at_k_64_mod_128_takes_the_kernel(calls, group):
    k, f, d = 4544, 256, 4544
    gate, up = (quantize_pack_linear(torch.zeros((k, f)), 2, group) for _ in range(2))
    down = quantize_pack_linear(torch.zeros((f, d)), 2, group)
    fm.fused_mlp(torch.zeros((8, k), dtype=torch.bfloat16), gate, up, down, block_f=f)
    name, args = calls[-1]
    assert name == "bd_fused_mlp" and args[15:21] == (8, k, f, d, 2, group)
    assert args[22:24] == fm.mlp_plan(k, f, d, 132)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,dp", [(72, 80), (300, 304)])
def test_b8_padded_head_dim_takes_the_kernels_at_the_real_scale(calls, d, dp, dtype):
    q = torch.zeros((1, 40, 4, d), dtype=dtype, requires_grad=True)
    k = torch.zeros((1, 40, 2, d), dtype=dtype, requires_grad=True)
    out = ta.flash_train_attention(q, k, k, torch.ones((1, 40), dtype=torch.int32))
    assert out.shape == q.shape
    out.backward(torch.zeros_like(out))
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert [name for name, _ in calls] == ["bd_train_attn_fwd", "bd_train_attn_dkv",
                                           "bd_train_attn_dq"]
    n_ptr = {"bd_train_attn_fwd": 6, "bd_train_attn_dkv": 9, "bd_train_attn_dq": 8}
    for name, args in calls:
        n = n_ptr[name]
        assert args[n:n + 5] == (1, 40, 4, 2, dp)  # B, S, Hq, Hkv and the padded D
        assert args[n + 5] == pytest.approx(1 / math.sqrt(d))  # the real D's scale
        # bf16 above D = 256 takes the f32 split kernels on f32 copies
        assert args[-2] == int(dtype == torch.float32 or ta.widened(dtype, dp))
    want = "tf32x3_split" if dp > ta.MAX_HEAD_DIM else ("tf32x3" if dtype == torch.float32
                                                        else "wgmma")
    assert ta.train_attn_fwd.plan.kernel == want
    assert calls[0][1][6 + 6] == ta.fwd_plan(1, 40, 4, 2, dp, dtype).cluster
    assert calls[1][1][9 + 6] == ta.dkv_plan(1, 40, 4, 2, dp, dtype).cluster


@pytest.mark.parametrize("rep,d", [(4, 513), (3, 1024)])
def test_decode_attention_refuses_head_dims_above_512(calls, rep, d):
    """The general route's widest template is 512: above it the wrapper
    raises before any launch (the JAX kernel has no such width in any
    supported family)."""
    with pytest.raises(ValueError, match="D up to 512"):
        da.decode_tile(rep, d)
    q = torch.zeros((1, 1, rep, d), dtype=torch.bfloat16)
    kv = torch.zeros((1, 1, 1, d), dtype=torch.bfloat16)
    ck = torch.zeros((1, 1, 1, 8, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D up to 512"):
        da.flash_decode_stacked(q, ck, ck, 0, kv, kv, torch.tensor([3], dtype=torch.int32))
    assert not calls
