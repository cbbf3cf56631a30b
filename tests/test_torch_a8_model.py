"""The W{2,4}A8 serving path of the port against the JAX package's on the
CPU: a packed f32 TINY_TEST repacked into the A8 byte order by the JAX
package and carried across with `params_from_numpy` gives the same prefill
and decode logits; both engines with BITDISTILLER_QMM_A8=1 (each repacks its
own pair-layout weights at construction) give the same greedy tokens; the
A8 order survives the numpy hand-over.

Tolerances: logits rtol/atol 1e-4 (f32 compute; the int group products are
exact, the f32 group sums and XLA's reciprocal-multiply division by 127 can
differ in the last bits). Engine tokens equal: the two sides quantize the
same activations to the same int8 codes, so greedy argmaxes see logits that
agree to about 1e-6."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdistiller_tpu.ops.quant_matmul  # noqa: F401
from bitdistiller_tpu.models import TINY_TEST, KVCache, init_params, llama
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.ops import quant_matmul as tq
from bitdistiller_tpu_torch.quant.packing import dequantize_linear
from bitdistiller_tpu_torch.serve import Engine, SamplingParams
from torch_port_util import t2n, to_numpy_tree, torch_cfg

jq = sys.modules["bitdistiller_tpu.ops.quant_matmul"]

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
PROMPTS = [[3, 7, 11], [5, 6], [9, 1, 4, 4, 2, 8, 30, 31, 7], [200, 17], [42] * 20]


@pytest.fixture(scope="module")
def packed():
    return pack_model(init_params(CFG, jax.random.key(0), dtype=jnp.float32), CFG,
                      bits=2, group_size=64)


@pytest.fixture(scope="module")
def repacked(packed):
    """The JAX package's own A8 repack of every packed leaf."""
    layers = {k: jq.repack_linear_a8(v) if hasattr(v, "qweight") else v
              for k, v in packed["layers"].items()}
    return dict(packed, layers=layers)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def test_a8_order_survives_the_numpy_hand_over(repacked):
    tparams = params_from_numpy(to_numpy_tree(repacked), "cpu")
    for name in ("qkv", "o", "gate_up", "down"):
        jl, tl = repacked["layers"][name], tparams["layers"][name]
        assert jl.a8_order and tl.a8_order
        np.testing.assert_array_equal(tl.qweight.numpy(), np.asarray(jl.qweight))
        with pytest.raises(ValueError, match="A8"):  # a pair-layout reader refuses
            dequantize_linear(tl.layer(0))
        with pytest.raises(ValueError, match="A8"):
            lay = tl.layer(0)
            tq.quant_matmul_plain(torch.zeros(1, lay.in_features), lay.qweight, lay.scales,
                                  lay.szeros, lay.bits, lay.group_size, lay.a8_order)


def test_a8_prefill_and_decode_logits_match(repacked):
    tparams = params_from_numpy(to_numpy_tree(repacked), "cpu")
    B, T = 2, 16
    prompt = _tokens(1, B, 6)
    jc = KVCache.init(CFG, batch=B, max_len=T, dtype=jnp.float32)
    tc = tllama.KVCache.init(TCFG, B, T, torch.float32, device="cpu")
    wl, jc = llama.forward(repacked, CFG, jnp.asarray(prompt), cache=jc, cache_pos=0)
    gl, tc = tllama.forward(tparams, TCFG, torch.from_numpy(prompt).long(), cache=tc, cache_pos=0)
    np.testing.assert_allclose(t2n(gl), np.asarray(wl), rtol=1e-4, atol=1e-4)
    tok = _tokens(2, B, 1)
    pos = np.asarray([6, 3], np.int32)
    for _ in range(2):
        wl, jc = llama.forward(repacked, CFG, jnp.asarray(tok), cache=jc,
                               cache_pos=jnp.asarray(pos))
        gl, tc = tllama.forward(tparams, TCFG, torch.from_numpy(tok).long(), cache=tc,
                                cache_pos=torch.from_numpy(pos))
        np.testing.assert_allclose(t2n(gl), np.asarray(wl), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(t2n(tc.k), np.asarray(jc.k), rtol=1e-4, atol=1e-4)
        tok = np.array(wl[:, -1].argmax(-1), np.int32)[:, None]
        pos = pos + 1


def test_a8_engine_greedy_tokens_equal_jax(packed, monkeypatch):
    """Five requests through two slots with the switch on: each engine
    repacks its pair-layout weights, every packed matmul is A8."""
    monkeypatch.setenv("BITDISTILLER_QMM_A8", "1")
    tparams = params_from_numpy(to_numpy_tree(packed), "cpu")
    jeng = JaxEngine(packed, CFG, max_slots=2, max_len=64, cache_dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0), eos_token_id=None)
    teng = Engine(tparams, TCFG, max_slots=2, max_len=64, cache_dtype=torch.float32,
                  sampling=SamplingParams(temperature=0.0), eos_token_id=None, device="cpu")
    assert all(leaf.a8_order for leaf in teng.params["layers"].values() if hasattr(leaf, "a8_order"))
    assert not tparams["layers"]["qkv"].a8_order  # the caller's tree is left as it was
    want = jeng.generate(PROMPTS, max_new_tokens=9)
    got = teng.generate(PROMPTS, max_new_tokens=9)
    assert got == want
    assert all(len(o) == 9 for o in got)
    # with the switch off the engine keeps the caller's pair-layout tree (A16)
    monkeypatch.delenv("BITDISTILLER_QMM_A8")
    a16 = Engine(tparams, TCFG, max_slots=2, max_len=64, cache_dtype=torch.float32,
                 sampling=SamplingParams(temperature=0.0), eos_token_id=None, device="cpu")
    assert a16.params is tparams
