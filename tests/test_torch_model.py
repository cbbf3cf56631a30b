"""The port's Llama forward against the JAX package's `llama.forward` on the
CPU (TINY_TEST in f32): dense and packed logits, prefill KV, per-slot decode
steps with the fresh-token write-back on f32, bf16 and int8 caches, the
decode-attention route, stacked weights read in place, and weights carried
across with `params_from_numpy` and `load_packed_checkpoint`.

Tolerances: f32 compute on both sides differs only in summation order
(atol/rtol 1e-4 on logits). Decode against bf16/int8 caches compares with the
JAX package's flash-decode path (interpret mode), which rounds the same bf16
values; one bf16 ulp of an attention prob can differ, so logits get
atol/rtol 1e-2 and int8 cache codes may differ by one step."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, KVCache, init_params, llama
from bitdistiller_tpu.models.quantized import pack_model, save_packed_checkpoint
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import (
    load_packed_checkpoint,
    pack_model as torch_pack_model,
    params_from_numpy,
)
from bitdistiller_tpu_torch.ops import decode_attention as tda
from bitdistiller_tpu_torch.ops import quant_matmul as tq
from torch_port_util import t2n, to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
L = CFG.num_layers


@pytest.fixture(scope="module")
def dense():
    return init_params(CFG, jax.random.key(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def packed(dense):
    return pack_model(dense, CFG, bits=2, group_size=64)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_forward_logits_match(kind, dense, packed):
    params = dense if kind == "dense" else packed
    toks = _tokens(1, 2, 12)
    want, _ = llama.forward(params, CFG, jnp.asarray(toks))
    got, _ = tllama.forward(params_from_numpy(to_numpy_tree(params), "cpu"), TCFG,
                            torch.from_numpy(toks).long())
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_prefill_return_kv_matches(packed):
    toks = _tokens(2, 3, 10)
    wl, wkv = llama.forward(packed, CFG, jnp.asarray(toks), return_kv=True)
    gl, gkv = tllama.forward(params_from_numpy(to_numpy_tree(packed), "cpu"), TCFG,
                             torch.from_numpy(toks).long(), return_kv=True)
    assert tuple(gkv.k.shape) == wkv.k.shape  # [L, B, S, Hkv, D]
    np.testing.assert_allclose(t2n(gl), np.asarray(wl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(gkv.k), np.asarray(wkv.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(gkv.v), np.asarray(wkv.v), rtol=1e-4, atol=1e-4)


_CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _cache_arrays(c):
    out = [np.asarray(c.k, np.float32), np.asarray(c.v, np.float32)]
    if c.k_scale is not None:
        out += [np.asarray(c.k_scale), np.asarray(c.v_scale)]
    return out


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_per_slot_decode_steps_match(kind, packed):
    """Prefill 8 tokens into the cache, then two per-slot decode steps at
    positions [8, 5] and [9, 6]; logits and the whole cache after each
    write-back match."""
    jdt, tdt = _CACHE[kind]
    B, T = 2, 32
    tparams = params_from_numpy(to_numpy_tree(packed), "cpu")
    jc = KVCache.init(CFG, batch=B, max_len=T, dtype=jdt)
    tc = tllama.KVCache.init(TCFG, B, T, tdt, device="cpu")
    prompt = _tokens(3, B, 8)
    _, jc = llama.forward(packed, CFG, jnp.asarray(prompt), cache=jc, cache_pos=0)
    _, tc = tllama.forward(tparams, TCFG, torch.from_numpy(prompt).long(), cache=tc, cache_pos=0)
    tol = 1e-4 if kind == "f32" else 1e-2
    pos = np.asarray([8, 5], np.int32)
    tok = _tokens(4, B, 1)
    for _ in range(2):
        wl, jc = llama.forward(packed, CFG, jnp.asarray(tok), cache=jc,
                               cache_pos=jnp.asarray(pos), flash2=True)
        gl, tc2 = tllama.forward(tparams, TCFG, torch.from_numpy(tok).long(), cache=tc,
                                 cache_pos=torch.from_numpy(pos))
        assert tc2 is tc  # written back in place
        np.testing.assert_allclose(t2n(gl), np.asarray(wl), rtol=tol, atol=tol)
        gk = [t2n(x) for x in (tc.k, tc.v) + ((tc.k_scale, tc.v_scale) if tc.quantized else ())]
        for g, w in zip(gk, _cache_arrays(jc)):
            np.testing.assert_allclose(g, w, rtol=tol, atol=1.0 if kind == "int8" else tol)
        tok = np.array(wl[:, -1].argmax(-1), np.int32)[:, None]
        pos = pos + 1


def test_scalar_position_decode_matches(packed):
    B, T = 2, 16
    tparams = params_from_numpy(to_numpy_tree(packed), "cpu")
    jc = KVCache.init(CFG, batch=B, max_len=T, dtype=jnp.float32)
    tc = tllama.KVCache.init(TCFG, B, T, torch.float32, device="cpu")
    prompt = _tokens(5, B, 6)
    llama_out = llama.forward(packed, CFG, jnp.asarray(prompt), cache=jc, cache_pos=0)
    jc = llama_out[1]
    tllama.forward(tparams, TCFG, torch.from_numpy(prompt).long(), cache=tc, cache_pos=0)
    tok = _tokens(6, B, 1)
    wl, jc = llama.forward(packed, CFG, jnp.asarray(tok), cache=jc, cache_pos=6)
    gl, tc = tllama.forward(tparams, TCFG, torch.from_numpy(tok).long(), cache=tc, cache_pos=6)
    np.testing.assert_allclose(t2n(gl), np.asarray(wl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(tc.k), np.asarray(jc.k), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,with_cache", [(1, True), (3, True), (4, False)])
def test_decode_attention_route_matches_flash_ok(s, with_cache, packed, monkeypatch):
    """The port's decode step goes through the decode-attention wrapper
    exactly when the JAX package's `flash_ok` holds (S=1 against a cache for
    the Llama family): the JAX side counts calls of its kernel entry."""
    jax_da = sys.modules["bitdistiller_tpu.ops.decode_attention"]
    jax_calls = []
    real = jax_da.flash_decode_stacked

    def spy(*a, **k):
        jax_calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(jax_da, "flash_decode_stacked", spy)
    B, T = 2, 16
    toks = _tokens(7, B, s)
    jc = KVCache.init(CFG, batch=B, max_len=T, dtype=jnp.float32) if with_cache else None
    llama.forward(packed, CFG, jnp.asarray(toks), cache=jc, cache_pos=jnp.asarray([4, 2]),
                  flash2=True)
    tc = tllama.KVCache.init(TCFG, B, T, torch.float32, device="cpu") if with_cache else None
    before = tda.flash_decode_stacked.plain_calls
    tllama.forward(params_from_numpy(to_numpy_tree(packed), "cpu"), TCFG,
                   torch.from_numpy(toks).long(), cache=tc, cache_pos=torch.tensor([4, 2]))
    port_calls = tda.flash_decode_stacked.plain_calls - before
    assert (port_calls > 0) == bool(jax_calls)
    assert port_calls in (0, L)  # one call a layer when taken


def test_decode_reads_stacked_weights_in_place(packed, monkeypatch):
    """Every packed matmul of a decode step receives layer li of the stacked
    qweight as a view: data_ptr == base + li * layer stride."""
    tparams = params_from_numpy(to_numpy_tree(packed), "cpu")
    seen = []
    real = tq.quant_matmul_plain

    def spy(x, qweight, *args):
        seen.append(qweight.data_ptr())
        return real(x, qweight, *args)

    monkeypatch.setattr(tq, "quant_matmul_plain", spy)
    tc = tllama.KVCache.init(TCFG, 2, 16, torch.float32, device="cpu")
    tllama.forward(tparams, TCFG, torch.tensor([[3], [4]]), cache=tc,
                   cache_pos=torch.tensor([5, 1]))
    layers = tparams["layers"]
    want = [
        layers[name].qweight.data_ptr() + li * layers[name].qweight.stride(0) * 4
        for li in range(L) for name in ("qkv", "o", "gate_up", "down")
    ]
    assert seen == want


def test_load_packed_checkpoint_byte_for_byte(packed, tmp_path):
    save_packed_checkpoint(str(tmp_path), packed, CFG, bits=2, group_size=64)
    tparams, tcfg = load_packed_checkpoint(str(tmp_path), device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(torch_cfg(CFG))
    for name in ("qkv", "o", "gate_up", "down"):
        jl, tl = packed["layers"][name], tparams["layers"][name]
        np.testing.assert_array_equal(tl.qweight.numpy(), np.asarray(jl.qweight))
        np.testing.assert_array_equal(tl.combo.numpy(), np.asarray(jl.combo))
        np.testing.assert_array_equal(tl.scales.numpy(), np.asarray(jl.scales))
        assert (tl.bits, tl.group_size, tl.in_features, tl.out_features) == (
            jl.bits, jl.group_size, jl.in_features, jl.out_features)
    toks = _tokens(8, 1, 9)
    want, _ = llama.forward(packed, CFG, jnp.asarray(toks))
    got, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_pack_model_bit_equal(dense, packed):
    """The port's pack_model on the same dense weights gives the JAX
    package's fused layers bit for bit."""
    tpacked = torch_pack_model(params_from_numpy(to_numpy_tree(dense), "cpu"), TCFG,
                               bits=2, group_size=64)
    assert sorted(tpacked["layers"]) == sorted(packed["layers"])
    for name in ("qkv", "o", "gate_up", "down"):
        jl, tl = packed["layers"][name], tpacked["layers"][name]
        for f in ("qweight", "scales", "szeros", "combo"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
