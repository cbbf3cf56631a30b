"""The model families on the port against the JAX package on the CPU: every
`ModelConfig` flag the JAX package runs (Falcon 7B- and 40B-style, MPT,
Gemma-2/3 with its per-layer sliding pattern, Qwen2, Qwen3, Phi-3, OPT and
Bloom), from `from_hf_config` through dense and cached logits, the decode and
training-flash routes, `pack_model` and the Engine to training.

Each model is tiny (2 layers, hidden 64 or 96), its params made by the JAX
package's `init_params` in f32, then every leaf moved by numpy noise from a
seed so that biases and norms are not zeros and ones; the port gets them
through `params_from_numpy`. The JAX forward takes its XLA path, with the
decode kernel in Pallas interpret mode where `flash_ok` holds (`flash2=True`).

Tolerances, as tests/test_torch_model.py: f32 logits and caches rtol/atol
1e-4 (the same f32 operations summed in another order); against bf16 and
int8 caches 1e-2 (one bf16 ulp of an attention prob may differ between the
kernel's rounding and the plain version's), int8 codes within one step.
Training: loss within 1e-5 relative and every gradient within 1e-4 of its
leaf's max|JAX| (f32, the STE quantizer; no quantized weight sits on a
rounding boundary at these inputs). Packing: bit-equal.

The pinned choices (ROADMAP C4): the q/k norm has no Gemma offset, "gelu"
is the tanh form, and a Gemma-3 config that names its activation only as
`hidden_activation` parses to "silu"; the port matches the JAX package on
each, since its weights and its parity tests come from the JAX package."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdistiller_tpu.ops.decode_attention  # noqa: F401
from bitdistiller_tpu.models import KVCache as JKV
from bitdistiller_tpu.models import ModelConfig as JMC
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.models import llama as jllama
from bitdistiller_tpu.models import layers as jlayers
from bitdistiller_tpu.models.quantized import pack_model as jpack
from bitdistiller_tpu.quant import autoclip as jclip
from bitdistiller_tpu.quant.core import make_weight_quantizer as jmq
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu.train import trainer as jtr
from bitdistiller_tpu_torch.models import config as tconfig
from bitdistiller_tpu_torch.models import layers as tlayers
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import (
    pack_model as tpack,
    params_from_numpy,
    train_state_from_numpy,
)
from bitdistiller_tpu_torch.quant import autoclip as tclip
from bitdistiller_tpu_torch.quant.core import make_weight_quantizer as tmq
from bitdistiller_tpu_torch.serve import Engine, SamplingParams
from bitdistiller_tpu_torch.train import trainer as ttr
from test_model_families import TINY_FALCON, TINY_FALCON40B, TINY_GEMMA, TINY_MPT
from torch_port_util import t2n, to_numpy_tree, torch_cfg

jda = sys.modules["bitdistiller_tpu.ops.decode_attention"]

# Hugging Face config.json dicts, one a family branch of from_hf_config
HF = {
    "qwen2": {"model_type": "qwen2", "vocab_size": 128, "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "rope_theta": 1e6, "max_position_embeddings": 128,
              "tie_word_embeddings": False, "use_sliding_window": False, "sliding_window": 32},
    "qwen3": {"model_type": "qwen3", "vocab_size": 128, "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 32, "rope_theta": 1e6,
              "attention_bias": False, "tie_word_embeddings": True},
    "phi3": {"model_type": "phi3", "vocab_size": 128, "hidden_size": 64,
             "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 4, "sliding_window": 5, "max_position_embeddings": 128,
             "original_max_position_embeddings": 64,
             "rope_scaling": {"type": "longrope", "long_factor": [1.0 + 0.25 * i for i in range(8)],
                              "short_factor": [1.0] * 8}},
    "opt": {"model_type": "opt", "vocab_size": 128, "hidden_size": 64, "ffn_dim": 128,
            "num_hidden_layers": 2, "num_attention_heads": 4, "max_position_embeddings": 64,
            "activation_function": "relu", "enable_bias": True},
    "bloom": {"model_type": "bloom", "vocab_size": 128, "hidden_size": 96, "n_layer": 2,
              "n_head": 6, "layer_norm_epsilon": 1e-5},
    "falcon": {"model_type": "falcon", "vocab_size": 128, "hidden_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4, "multi_query": True,
               "parallel_attn": True, "new_decoder_architecture": False},
    "falcon40b": {"model_type": "falcon", "vocab_size": 128, "hidden_size": 64,
                  "num_hidden_layers": 2, "num_attention_heads": 4, "num_kv_heads": 2,
                  "new_decoder_architecture": True},
    "falcon_rw": {"model_type": "falcon", "vocab_size": 128, "hidden_size": 64,
                  "num_hidden_layers": 2, "num_attention_heads": 4, "multi_query": False,
                  "alibi": True, "parallel_attn": False, "new_decoder_architecture": False},
    "refinedweb": {"model_type": "RefinedWeb", "vocab_size": 128, "hidden_size": 64,
                   "n_layer": 2, "n_head": 4, "n_head_kv": 2},
    "refinedwebmodel": {"model_type": "RefinedWebModel", "vocab_size": 128, "hidden_size": 64,
                        "n_layer": 2, "n_head": 4},
    "mpt": {"model_type": "mpt", "vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4,
            "expansion_ratio": 4, "max_seq_len": 128, "attn_config": {"alibi": True}},
    "llama": {"model_type": "llama", "vocab_size": 128, "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2},
    "gemma2": {"model_type": "gemma2", "vocab_size": 128, "hidden_size": 64,
               "intermediate_size": 128, "num_hidden_layers": 4, "num_attention_heads": 4,
               "num_key_value_heads": 2, "head_dim": 16, "sliding_window": 8,
               "hidden_act": "gelu_pytorch_tanh"},
    "gemma3_pattern": {"model_type": "gemma3_text", "vocab_size": 128, "hidden_size": 64,
                       "intermediate_size": 128, "num_hidden_layers": 12,
                       "num_attention_heads": 4, "num_key_value_heads": 2,
                       "sliding_window": 512, "sliding_window_pattern": 6,
                       "rope_theta": 1e6, "rope_local_base_freq": 1e4,
                       "hidden_act": "gelu_pytorch_tanh",
                       "rope_scaling": {"rope_type": "linear", "factor": 8.0}},
    "gemma3_layer_types": {"model_type": "gemma3_text", "vocab_size": 128, "hidden_size": 64,
                           "intermediate_size": 128, "num_hidden_layers": 3,
                           "num_attention_heads": 4, "num_key_value_heads": 2,
                           "sliding_window": 4, "hidden_act": "gelu_pytorch_tanh",
                           "layer_types": ["sliding_attention", "full_attention",
                                           "sliding_attention"]},
    # the published key only (ROADMAP C4): both packages read `hidden_act`
    "gemma3_hidden_activation": {"model_type": "gemma3_text", "vocab_size": 128,
                                 "hidden_size": 64, "intermediate_size": 128,
                                 "num_hidden_layers": 2, "num_attention_heads": 4,
                                 "num_key_value_heads": 2,
                                 "hidden_activation": "gelu_pytorch_tanh"},
}

F32 = dict(dtype="float32")
GEMMA_SLIDING = dataclasses.replace(TINY_GEMMA, sliding_window=4, sliding_layers=(True, False),
                                    rope_local_theta=10000.0, rope_theta=1000000.0)
MODELS = {  # name: the JAX package's config (f32)
    "falcon": TINY_FALCON, "falcon40b": TINY_FALCON40B, "mpt": TINY_MPT, "gemma": TINY_GEMMA,
    "gemma_sliding": GEMMA_SLIDING,
    **{name: JMC.from_hf_config(HF[name]) for name in ("qwen2", "qwen3", "phi3", "opt", "bloom")},
}
MODELS = {name: dataclasses.replace(cfg, **F32) for name, cfg in MODELS.items()}
NAMES = sorted(MODELS)
# the JAX package's flash_ok at S=1 against a cache (no ALiBi, no kv_valid, no per-layer sliding)
DECODE_KERNEL = {"falcon", "falcon40b", "gemma", "qwen2", "qwen3", "phi3", "opt"}


def _tcfg(name):
    """The port's config: through its own from_hf_config where a dict made it."""
    if name in HF:
        return dataclasses.replace(tconfig.ModelConfig.from_hf_config(HF[name]), **F32)
    return torch_cfg(MODELS[name])


def _randomized(params, seed):
    """Every leaf moved by N(0, 0.05^2) noise (biases off zero, norms off one)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape), jnp.float32),
        params)


_PARAMS: dict = {}


def _params(name):
    """(JAX params, the port's) of a model, made once a module."""
    if name not in _PARAMS:
        jp = _randomized(jinit(MODELS[name], jax.random.key(0), dtype=jnp.float32), seed=1)
        _PARAMS[name] = (jp, params_from_numpy(to_numpy_tree(jp), "cpu"))
    return _PARAMS[name]


def _tokens(seed, b, s, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---- 1. from_hf_config -------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(HF))
def test_from_hf_config_matches_jax(name):
    j = JMC.from_hf_config(HF[name])
    t = tconfig.ModelConfig.from_hf_config(HF[name])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.q_size, t.kv_size) == (j.q_size, j.kv_size)


def test_from_pretrained_reads_config_json(tmp_path):
    import json

    (tmp_path / "config.json").write_text(json.dumps(HF["gemma3_pattern"]))
    assert (dataclasses.asdict(tconfig.ModelConfig.from_pretrained(str(tmp_path)))
            == dataclasses.asdict(JMC.from_pretrained(str(tmp_path))))


# ---- 2. dense logits ---------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_dense_logits_match(name):
    jp, tp = _params(name)
    toks = _tokens(2, 2, 12)
    want, _ = jllama.forward(jp, MODELS[name], jnp.asarray(toks))
    got, _ = tllama.forward(tp, _tcfg(name), torch.from_numpy(toks).long())
    _close(got, want, 1e-4)


# ---- 3. prefill KV and per-slot decode through the cache ---------------------------

_CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _cache_arrays(c):
    out = [c.k, c.v] + ([c.k_scale, c.v_scale] if c.k_scale is not None else [])
    return [np.asarray(x, np.float32) for x in out]


@pytest.mark.parametrize("name", NAMES)
def test_prefill_return_kv_matches(name):
    jp, tp = _params(name)
    toks = _tokens(3, 2, 10)
    wl, wkv = jllama.forward(jp, MODELS[name], jnp.asarray(toks), return_kv=True)
    gl, gkv = tllama.forward(tp, _tcfg(name), torch.from_numpy(toks).long(), return_kv=True)
    _close(gl, wl, 1e-4)
    _close(gkv.k, wkv.k, 1e-4)
    _close(gkv.v, wkv.v, 1e-4)


@pytest.mark.parametrize("kind", sorted(_CACHE))
@pytest.mark.parametrize("name", NAMES)
def test_per_slot_decode_steps_match(name, kind):
    """Prefill 8 tokens into a 32-row cache, then two per-slot decode steps
    at positions [8, 5] and [9, 6]: slot 0 is past the window of Phi-3 (5)
    and of Gemma's sliding layers (4). Logits and the whole cache after each
    write-back match."""
    jdt, tdt = _CACHE[kind]
    cfg, tcfg = MODELS[name], _tcfg(name)
    jp, tp = _params(name)
    jc = JKV.init(cfg, batch=2, max_len=32, dtype=jdt)
    tc = tllama.KVCache.init(tcfg, 2, 32, tdt, device="cpu")
    prompt = _tokens(4, 2, 8)
    wl, jc = jllama.forward(jp, cfg, jnp.asarray(prompt), cache=jc, cache_pos=0)
    gl, tc = tllama.forward(tp, tcfg, torch.from_numpy(prompt).long(), cache=tc, cache_pos=0)
    tol = 1e-4 if kind == "f32" else 1e-2
    _close(gl, wl, tol)
    pos = np.asarray([8, 5], np.int32)
    tok = _tokens(5, 2, 1)
    for _ in range(2):
        wl, jc = jllama.forward(jp, cfg, jnp.asarray(tok), cache=jc, cache_pos=jnp.asarray(pos),
                                flash2=True)
        gl, tc = tllama.forward(tp, tcfg, torch.from_numpy(tok).long(), cache=tc,
                                cache_pos=torch.from_numpy(pos))
        _close(gl, wl, tol)
        got = [t2n(x) for x in (tc.k, tc.v) + ((tc.k_scale, tc.v_scale) if tc.quantized else ())]
        for g, w in zip(got, _cache_arrays(jc)):
            np.testing.assert_allclose(g, w, rtol=tol, atol=1.0 if kind == "int8" else tol)
        tok = np.array(wl[:, -1].argmax(-1), np.int32)[:, None]
        pos = pos + 1


# ---- 4. kv_valid and attn_len --------------------------------------------------------


@pytest.mark.parametrize("case", ["kv_valid", "attn_len", "attn_len_past_cache"])
@pytest.mark.parametrize("name", ["falcon", "phi3", "mpt"])
def test_kv_valid_and_attn_len_match(name, case):
    """A decode step with some cache rows masked out by `kv_valid` (the
    cached attention, as JAX's flash_ok fails), or read only below
    `attn_len` (the decode kernel where flash_ok holds; dropped at or above
    the cache length and off the kernel's route)."""
    cfg, tcfg = MODELS[name], _tcfg(name)
    jp, tp = _params(name)
    jc = JKV.init(cfg, batch=2, max_len=32, dtype=jnp.float32)
    tc = tllama.KVCache.init(tcfg, 2, 32, torch.float32, device="cpu")
    prompt = _tokens(6, 2, 12)
    _, jc = jllama.forward(jp, cfg, jnp.asarray(prompt), cache=jc, cache_pos=0)
    tllama.forward(tp, tcfg, torch.from_numpy(prompt).long(), cache=tc, cache_pos=0)
    kw_j, kw_t = {}, {}
    if case == "kv_valid":
        valid = np.random.default_rng(7).random((2, 32)) > 0.3
        kw_j["kv_valid"], kw_t["kv_valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    else:
        kw_j["attn_len"] = kw_t["attn_len"] = 16 if case == "attn_len" else 40
    tok, pos = _tokens(8, 2, 1), np.asarray([12, 9], np.int32)
    wl, _ = jllama.forward(jp, cfg, jnp.asarray(tok), cache=jc, cache_pos=jnp.asarray(pos),
                           flash2=True, **kw_j)
    gl, _ = tllama.forward(tp, tcfg, torch.from_numpy(tok).long(), cache=tc,
                           cache_pos=torch.from_numpy(pos), **kw_t)
    _close(gl, wl, 1e-4)


# ---- 5. routing ---------------------------------------------------------------------


def _decode_route(name, monkeypatch, **kw):
    """(JAX's windows at its decode kernel, the port's) for one S=1 step."""
    cfg, tcfg = MODELS[name], _tcfg(name)
    jp, tp = _params(name)
    jseen, tseen = [], []

    def jspy(q, *a, **k):
        jseen.append(k.get("window"))
        return jnp.zeros_like(q)

    def tspy(q, *a, **k):
        tseen.append(k.get("window"))
        return torch.zeros_like(q)

    monkeypatch.setattr(jda, "flash_decode_stacked", jspy)
    monkeypatch.setattr(tllama, "flash_decode_stacked", tspy)
    tok, pos = _tokens(9, 2, 1), np.asarray([4, 2], np.int32)
    jc = JKV.init(cfg, batch=2, max_len=16, dtype=jnp.float32)
    tc = tllama.KVCache.init(tcfg, 2, 16, torch.float32, device="cpu")
    kv_j = {k: jnp.asarray(v) for k, v in kw.items()}
    kv_t = {k: torch.from_numpy(v) for k, v in kw.items()}
    jllama.forward(jp, cfg, jnp.asarray(tok), cache=jc, cache_pos=jnp.asarray(pos), flash2=True,
                   **kv_j)
    tllama.forward(tp, tcfg, torch.from_numpy(tok).long(), cache=tc,
                   cache_pos=torch.from_numpy(pos), **kv_t)
    return jseen, tseen


@pytest.mark.parametrize("name", NAMES)
def test_decode_attention_route_matches_flash_ok(name, monkeypatch):
    """The port's decode step calls the decode attention entry exactly where
    the JAX package's flash_ok holds (once a layer; JAX traces its scan body
    once), with the same window; never with kv_valid given."""
    jseen, tseen = _decode_route(name, monkeypatch)
    assert bool(jseen) == bool(tseen) == (name in DECODE_KERNEL)
    assert tseen == [jseen[0]] * MODELS[name].num_layers if jseen else not tseen
    assert not any(_decode_route(name, monkeypatch, kv_valid=np.ones((2, 16), bool)))


@pytest.mark.parametrize("name", NAMES)
def test_train_flash_route_matches_jax(name, monkeypatch):
    """With the training flash attention asked for, the port takes it exactly
    where the JAX package does (cache-less, no ALiBi, no window)."""
    cfg, tcfg = MODELS[name], _tcfg(name)
    jp, tp = _params(name)
    jseen, tseen = [], []

    def jspy(q, k, v, mask=None):
        jseen.append(1)
        return jlayers.causal_attention(q, k, v, None)

    def tspy(q, k, v, attn_mask=None):
        tseen.append(1)
        return tlayers.causal_attention(q, k, v)

    monkeypatch.setattr(jllama, "flash_train_attention", jspy)
    monkeypatch.setattr(tllama, "flash_train_attention", tspy)
    toks = _tokens(10, 2, 6)
    jllama.forward(jp, cfg, jnp.asarray(toks), use_train_flash=True)
    tllama.forward(tp, tcfg, torch.from_numpy(toks).long(), use_train_flash=True)
    assert bool(jseen) == bool(tseen)
    assert len(tseen) in (0, cfg.num_layers)
    assert bool(tseen) == (not cfg.alibi and cfg.sliding_window is None)



# the Python calls of one Llama decode layer made from the port's models/ code
# (functions, and the builtins and torch functions they call)
LLAMA_DECODE_LAYER_CALLS = {
    "_layer": 1, "run": 1, "_block": 1, "actual_head_dim": 1, "rms_norm": 2, "lin": 4,
    "linear": 4, "apply_rope": 2, "attend": 1, "quantized": 1, "C to": 11, "C cat": 2,
    "C mean": 2, "C rsqrt": 2, "C isinstance": 4, "C reshape": 4, "C append": 2}


def _llama_decode_calls(layers):
    """Counts of the calls made from models/ code in one packed Llama decode
    step on the CPU, after a first step."""
    import collections

    from bitdistiller_tpu_torch.models import config as mconfig
    from bitdistiller_tpu_torch.models.quantized import random_packed_params

    cfg = dataclasses.replace(mconfig.LLAMA2_7B, num_layers=layers, hidden_size=128,
                              intermediate_size=256, num_heads=4, num_kv_heads=4, vocab_size=256)
    params = random_packed_params(cfg, bits=2, group_size=64, device="cpu")
    cache = tllama.KVCache.init(cfg, 8, 64, device="cpu")
    tok, pos = torch.zeros((8, 1), dtype=torch.long), torch.full((8,), 10, dtype=torch.int32)
    seen = collections.Counter()

    def prof(frame, event, arg):
        if "bitdistiller_tpu_torch/models/" in frame.f_code.co_filename.replace("\\", "/"):
            if event == "call":
                seen[frame.f_code.co_name] += 1
            elif event == "c_call":
                seen["C " + getattr(arg, "__name__", str(arg))] += 1

    with torch.inference_mode():
        tllama.forward(params, cfg, tok, cache=cache, cache_pos=pos)
        sys.setprofile(prof)
        try:
            tllama.forward(params, cfg, tok, cache=cache, cache_pos=pos)
        finally:
            sys.setprofile(None)
    return seen


def test_llama_decode_layer_pays_nothing_for_the_family_flags():
    """The family flags (norm kind and offset, rope, windows, ALiBi, the
    route) are decided once a forward: a Llama decode layer makes the same
    Python calls as the Llama-only block did, so the host-paced decode step
    does no more host work a layer. Read as the difference between 4 and 2
    layers, so the per-forward work cancels."""
    two, four = _llama_decode_calls(2), _llama_decode_calls(4)
    per_layer = {k: (four[k] - two[k]) / 2 for k in four if four[k] != two[k]}
    assert per_layer == LLAMA_DECODE_LAYER_CALLS
    assert four["_layer_norms"] == four["apply_norm"] == 1  # the final norm


# ---- 6. pack_model -------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_pack_model_bit_equal(name):
    """Fused where every part is present and unbiased, else alone with its
    bias: the same names and words as the JAX package's pack_model, and the
    packed logits agree."""
    cfg, tcfg = MODELS[name], _tcfg(name)
    jp, tp = _params(name)
    jpk = jpack(jp, cfg, bits=2, group_size=32)
    tpk = tpack(tp, tcfg, bits=2, group_size=32)
    assert sorted(tpk["layers"]) == sorted(jpk["layers"])
    for lname, jl in jpk["layers"].items():
        tl = tpk["layers"][lname]
        if not hasattr(jl, "qweight"):
            continue
        for f in ("qweight", "scales", "szeros", "combo", "bias"):
            a, b = getattr(tl, f), getattr(jl, f)
            assert (a is None) == (b is None), (lname, f)
            if b is not None:
                want = np.asarray(b, np.float32) if f == "bias" else np.asarray(b)
                np.testing.assert_array_equal(t2n(a), want)
        assert (tl.bits, tl.group_size, tl.in_features, tl.out_features) == (
            jl.bits, jl.group_size, jl.in_features, jl.out_features)
    fused = {"qkv": not cfg.attention_bias,
             "gate_up": cfg.mlp_style == "gated" and not cfg.mlp_bias}
    for lname, want in fused.items():
        assert (lname in tpk["layers"]) == want
    toks = _tokens(11, 2, 9)
    want, _ = jllama.forward(jpk, cfg, jnp.asarray(toks))
    got, _ = tllama.forward(params_from_numpy(to_numpy_tree(jpk), "cpu"), tcfg,
                            torch.from_numpy(toks).long())
    _close(got, want, 1e-4)
    got2, _ = tllama.forward(tpk, tcfg, torch.from_numpy(toks).long())
    _close(got2, want, 1e-4)


def test_params_from_numpy_carries_every_family_leaf():
    """Norm dicts, biases, q/k norms, learned positions and the embedding
    norm cross as they are, and PackedLinears keep their biases."""
    for name in NAMES:
        jp, tp = _params(name)
        jflat = dict(ttr.tree_items(jax.tree_util.tree_map(np.asarray, jp)))
        tflat = dict(ttr.tree_items(tp))
        assert jflat.keys() == tflat.keys(), name
        for path, want in jflat.items():
            np.testing.assert_array_equal(t2n(tflat[path]), want)
    jpk = jpack(_params("qwen2")[0], MODELS["qwen2"], bits=2, group_size=32)
    tpk = params_from_numpy(to_numpy_tree(jpk), "cpu")
    for lname in ("q", "k", "v"):
        np.testing.assert_array_equal(t2n(tpk["layers"][lname].bias),
                                      np.asarray(jpk["layers"][lname].bias))


def test_port_init_params_makes_the_jax_leaves():
    """The port's init_params makes every leaf the JAX package's makes, with
    its shape, for each family."""
    for name in NAMES:
        jshapes = {p: x.shape for p, x in ttr.tree_items(jax.tree_util.tree_map(
            np.asarray, jinit(MODELS[name], jax.random.key(0), dtype=jnp.float32)))}
        tshapes = {p: tuple(x.shape) for p, x in ttr.tree_items(
            tllama.init_params(_tcfg(name), seed=0, dtype=torch.float32, device="cpu"))}
        assert tshapes == jshapes, name


# ---- the Engine --------------------------------------------------------------------


def _engines(jp, cfg, tcfg, max_len=64):
    jeng = JaxEngine(jp, cfg, max_slots=2, max_len=max_len, cache_dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0), eos_token_id=None)
    teng = Engine(params_from_numpy(to_numpy_tree(jp), "cpu"), tcfg, max_slots=2,
                  max_len=max_len, cache_dtype=torch.float32,
                  sampling=SamplingParams(temperature=0.0), eos_token_id=None, device="cpu")
    return jeng, teng


PROMPTS = [[3, 7, 11], [5, 6], [9, 1, 4, 4, 2, 8, 30, 31, 7], [100, 17]]


@pytest.mark.parametrize("case", ["qwen2_vocab_152064", "opt_past_the_table", "qwen2_a8",
                                  "opt_a8"])
def test_engine_greedy_tokens_equal_jax(case, monkeypatch):
    """Packed int2-g32 models through both engines (two slots, four
    requests): Qwen2 with an untied vocabulary of 152064 rows (the prefill's
    f32 logits), OPT with a position table of 18 rows that the 64-row prefill
    bucket and the decode run past (both clamp to the last row), and both
    under A8 with their biased, unfused leaves repacked."""
    name = case.split("_")[0]
    cfg, tcfg = MODELS[name], _tcfg(name)
    if case == "qwen2_vocab_152064":
        cfg, tcfg = (dataclasses.replace(c, vocab_size=152064) for c in (cfg, tcfg))
    if name == "opt":
        cfg, tcfg = (dataclasses.replace(c, max_position_embeddings=16) for c in (cfg, tcfg))
    if case.endswith("a8"):
        monkeypatch.setenv("BITDISTILLER_QMM_A8", "1")
    jp = jpack(_randomized(jinit(cfg, jax.random.key(2), dtype=jnp.float32), seed=3), cfg,
               bits=2, group_size=32)
    jeng, teng = _engines(jp, cfg, tcfg)
    if case.endswith("a8"):
        assert all(leaf.a8_order for leaf in teng.params["layers"].values()
                   if hasattr(leaf, "a8_order"))
    want = jeng.generate(PROMPTS, max_new_tokens=9)
    got = teng.generate(PROMPTS, max_new_tokens=9)
    assert got == want
    assert all(len(o) == 9 for o in got)


def test_learned_positions_clamp_at_the_table_edge():
    """Positions past OPT's table (16 + the offset 2 rows) read its last row,
    as the JAX package's gather clamps: a cache-less forward over 24 tokens
    and a decode step at position 30."""
    cfg = dataclasses.replace(MODELS["opt"], max_position_embeddings=16)
    tcfg = dataclasses.replace(_tcfg("opt"), max_position_embeddings=16)
    jp = _randomized(jinit(cfg, jax.random.key(0), dtype=jnp.float32), seed=4)
    tp = params_from_numpy(to_numpy_tree(jp), "cpu")
    assert tp["pos_embed"].shape[0] == 18
    toks = _tokens(12, 1, 24)
    want, _ = jllama.forward(jp, cfg, jnp.asarray(toks))
    got, _ = tllama.forward(tp, tcfg, torch.from_numpy(toks).long())
    _close(got, want, 1e-4)
    jc = JKV.init(cfg, batch=1, max_len=32, dtype=jnp.float32)
    tc = tllama.KVCache.init(tcfg, 1, 32, torch.float32, device="cpu")
    want, _ = jllama.forward(jp, cfg, jnp.asarray(toks[:, :1]), cache=jc, cache_pos=30)
    got, _ = tllama.forward(tp, tcfg, torch.from_numpy(toks[:, :1]).long(), cache=tc,
                            cache_pos=30)
    _close(got, want, 1e-4)


# ---- 7. training -------------------------------------------------------------------


def _train_batch(seed=0, b=2, s=20):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 3:] = 0  # fewer pad rows than Gemma's window: every query sees a real key
    return toks, mask


@pytest.mark.parametrize("name", ["falcon", "gemma_sliding"])
def test_training_loss_and_grads_match(name):
    """A Falcon-style and a Gemma-style student: int2-asym STE at g64, remat
    "full", a padding mask; loss and the gradient of every leaf (norm dicts
    and their biases, q/k norms included) against jax.value_and_grad."""
    cfg, tcfg = MODELS[name], _tcfg(name)
    jp, _ = _params(name)
    toks, mask = _train_batch()

    def jloss(params):
        logits, _ = jllama.forward(params, cfg, jnp.asarray(toks), quantizer=jmq("int2-asym", 64),
                                   attn_mask=jnp.asarray(mask), remat=True)
        return (jax.nn.log_softmax(logits)[..., 3] * mask).sum() / mask.sum()

    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = ttr.tree_map(lambda x: x.requires_grad_(True),
                      params_from_numpy(to_numpy_tree(jp), "cpu"))
    logits, _ = tllama.forward(tp, tcfg, torch.from_numpy(toks).long(),
                               quantizer=tmq("int2-asym", 64), attn_mask=torch.from_numpy(mask),
                               remat="full")
    tl = (torch.log_softmax(logits, -1)[..., 3] * torch.from_numpy(mask)).sum() / mask.sum()
    tl.backward()
    assert np.isfinite(tl.item())
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = dict(ttr.tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    tflat = dict(ttr.tree_items(tp))
    assert jflat.keys() == tflat.keys()
    for path, leaf in tflat.items():
        want = jflat[path]
        err = np.abs(leaf.grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-7, (path, err)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_cakld_step_on_falcon_matches_jax(param_dtype):
    """One CAKLD step of the port's trainer on TINY_FALCON from JAX's
    initial state (f32 latents: ClipAdamW; bf16: the f32 master walks the
    LayerNorm dicts): loss, grad_norm, Adam's moments and the latents, at
    tests/test_torch_trainer.py's tolerances (f32 latents within 5% of a
    learning rate where Adam's step saturates, |g| > 1e-5)."""
    cfg, tcfg = MODELS["falcon"], _tcfg("falcon")
    jp, _ = _params("falcon")
    lr = 1e-3
    kw = dict(q_group_size=64, learning_rate=lr, param_dtype=param_dtype, train_kd=True,
              total_steps=10, weight_decay=0.01)
    jtc, ttc = jtr.TrainConfig(**kw), ttr.TrainConfig(**kw)
    jstate = jtr.init_train_state(jp, jtc)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tstate = train_state_from_numpy(np_tree(jstate.params), np_tree(jstate.opt_state),
                                    np.asarray(jstate.step), "cpu")
    toks, mask = _train_batch(seed=5, s=16)
    labels = np.where(mask == 1, toks, -100).astype(np.int32)
    batch = {"input_ids": toks, "labels": labels, "attention_mask": mask}
    teacher_t = params_from_numpy(to_numpy_tree(jp), "cpu")
    jstate, jm = jax.jit(jtr.make_train_step(cfg, jtc))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0.3), jp)
    tstate, tm = ttr.make_train_step(tcfg, ttc)(tstate, ttr.to_device(batch, "cpu"), 0.3,
                                                teacher_t)
    f32 = param_dtype == "float32"
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5 if f32 else 2e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4 if f32 else 2e-2)
    flat_t = lambda tree: {p: x.detach().float().numpy() for p, x in ttr.tree_items(tree)}
    flat_j = lambda tree: {p: np.asarray(x, np.float32) for p, x in ttr.tree_items(np_tree(tree))}
    jadam = jstate.opt_state
    stack = [jadam]
    while stack:  # the chain's ScaleByAdamState
        jadam = stack.pop()
        if "mu" in getattr(jadam, "_fields", ()):
            break
        stack.extend(n for n in (jadam if isinstance(jadam, tuple) else ()) if n is not None)
    tadam = tstate.opt_state
    while not isinstance(tadam, ttr.AdamWState):
        tadam = tadam.inner
    for field in ("mu", "nu"):
        tf, jf = flat_t(getattr(tadam, field)), flat_j(getattr(jadam, field))
        assert tf.keys() == jf.keys()
        for p in tf:
            tol = (1e-4 if f32 else 0.15) * np.abs(jf[p]).max() + 1e-12
            assert np.all(np.abs(tf[p] - jf[p]) <= tol), (field, p)
    tflat, jflat = flat_t(tstate.params), flat_j(jstate.params)
    jmu = flat_j(jadam.mu)
    assert tflat.keys() == jflat.keys()
    assert any(p[-1] == "b" for p in tflat)  # the LayerNorm biases train
    for p in tflat:
        err = np.abs(tflat[p] - jflat[p])
        if f32:
            # Adam's first step moves a weight by lr * g / (|g| + eps): where
            # |g| is near eps, a 1e-6 relative difference of g (checked in mu
            # above) is a visible share of lr; where |g| >> eps both moved lr
            saturated = np.abs(jmu[p]) > 1e-6
            assert np.all(err[saturated] <= 5e-2 * lr), p
            assert np.all(err <= 2 * lr), p
        else:
            assert np.all(err <= 4.5 * lr + 2.0 ** -7 * np.abs(jflat[p])), p


def test_clip_cache_applies_to_a_plain_mlp():
    """A clip cache with `up` and `down` entries (no gate: Falcon's MLP)
    clamps the same weights as the JAX package's apply_clip_cache."""
    jp, tp = _params("falcon")
    rng = np.random.default_rng(6)
    clip = {}
    for li in (0, 1):
        for name in ("up", "down", "o"):
            k, n = np.asarray(jp["layers"][name]["w"]).shape[1:]
            mx = np.abs(rng.standard_normal((n, k // 32))).astype(np.float32) * 0.05
            clip.setdefault(li, {})[name] = (mx, -mx)
    want = jclip.apply_clip_cache(jp, clip)
    got = tclip.apply_clip_cache(tp, clip)
    for name in ("up", "down", "o"):
        np.testing.assert_array_equal(t2n(got["layers"][name]["w"]),
                                      np.asarray(want["layers"][name]["w"]))
    assert not np.array_equal(t2n(got["layers"]["up"]["w"]), t2n(tp["layers"]["up"]["w"]))


# ---- 8. ALiBi slopes ----------------------------------------------------------------


@pytest.mark.parametrize("heads", [8, 12, 71])
def test_alibi_slopes_match_jax(heads):
    np.testing.assert_array_equal(tlayers.alibi_slopes(heads).numpy(),
                                  np.asarray(jlayers.alibi_slopes(heads)))


# ---- 9. the pinned choices (ROADMAP C4) ---------------------------------------------


def test_qk_norm_has_no_offset_as_jax():
    """Gemma-3's HF q/k norms compute x_hat * (1 + w); the JAX package
    applies w alone, and so does the port (ROADMAP C4): with q/k norm
    weights of zero the scores vanish on both sides, where a unit offset
    would keep them."""
    cfg, tcfg = MODELS["gemma"], _tcfg("gemma")
    assert cfg.norm_offset == 1.0 and cfg.qk_norm
    jp, _ = _params("gemma")
    layers = dict(jp["layers"], q_norm=jnp.zeros_like(jp["layers"]["q_norm"]),
                  k_norm=jnp.zeros_like(jp["layers"]["k_norm"]))
    jz = dict(jp, layers=layers)
    toks = _tokens(13, 1, 7)
    want, _ = jllama.forward(jz, cfg, jnp.asarray(toks))
    got, _ = tllama.forward(params_from_numpy(to_numpy_tree(jz), "cpu"), tcfg,
                            torch.from_numpy(toks).long())
    _close(got, want, 1e-4)
    x = torch.randn(3, 16)
    assert torch.equal(tlayers.rms_norm(x, torch.zeros(16), 1e-6), torch.zeros(3, 16))


def test_gelu_is_the_tanh_form_as_jax():
    """The JAX package's "gelu" is jax.nn.gelu, approximate=True by default:
    gelu(1) = 0.841192, where HF's Falcon and MPT use the erf GELU,
    0.841345. The port computes what JAX computes (ROADMAP C4)."""
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    got = tlayers.activation("gelu")(torch.from_numpy(x)).numpy()
    # atol: the two f32 tanh differ by an ulp, which 1 + tanh near -1 (x = -4)
    # turns into 1e-7 of an output of 1e-4
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    one = float(tlayers.activation("gelu")(torch.tensor(1.0)))
    assert abs(one - 0.841192) < 1e-6 and abs(one - 0.841345) > 1e-4
    assert torch.equal(tlayers.activation("gelu_tanh")(torch.from_numpy(x)), torch.from_numpy(got))
    for name in ("silu", "relu"):
        np.testing.assert_allclose(tlayers.activation(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jlayers._activation(name)(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7)


def test_gemma3_hidden_activation_is_not_read_as_jax():
    """Gemma-3's config.json names its activation `hidden_activation`; both
    packages read only `hidden_act`, so it parses to "silu" (ROADMAP C4)."""
    hf = HF["gemma3_hidden_activation"]
    assert JMC.from_hf_config(hf).hidden_act == "silu"
    assert tconfig.ModelConfig.from_hf_config(hf).hidden_act == "silu"
    with_key = dict(hf, hidden_act="gelu_pytorch_tanh")
    assert tconfig.ModelConfig.from_hf_config(with_key).hidden_act == "gelu_tanh"


def test_scores_scale_by_head_dim_as_jax():
    """HF's Gemma-3 scales scores by query_pre_attn_scalar ** -0.5; the JAX
    package reads no such field and scales by head_dim ** -0.5, and so does
    the port (ROADMAP C4; equal for Gemma-3-4B, 256 = 256): a config with
    query_pre_attn_scalar 64 at head_dim 16 parses the same as without it,
    and the attention is softmax(q k^T / sqrt(16))."""
    hf = dict(HF["gemma3_layer_types"], head_dim=16)
    with_scalar = dict(hf, query_pre_attn_scalar=64)
    assert (dataclasses.asdict(tconfig.ModelConfig.from_hf_config(with_scalar))
            == dataclasses.asdict(tconfig.ModelConfig.from_hf_config(hf))
            == dataclasses.asdict(JMC.from_hf_config(with_scalar)))
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 16)).astype(np.float32))
               for _ in range(3))
    got = tlayers.causal_attention(q, k, v)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / 16 ** 0.5
    scores = scores.masked_fill(~torch.tril(torch.ones(5, 5, dtype=torch.bool)), float("-inf"))
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    want_j = jlayers.causal_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                      jnp.asarray(v.numpy()), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["opt", "falcon"])
def test_fake_quant_and_quantize_layer_weights_keep_every_leaf(name):
    """`fake_quant_weights` and `quantize_layer_weights` quantize the linear
    weights a family has (no gate in a plain MLP), keep their biases and
    leave the norm dicts alone, as the JAX package's."""
    cfg = MODELS[name]
    jp, tp = _params(name)
    for jfn, tfn in ((jllama.fake_quant_weights, tllama.fake_quant_weights),
                     (jllama.quantize_layer_weights, tllama.quantize_layer_weights)):
        want = dict(ttr.tree_items(jax.tree_util.tree_map(
            np.asarray, jfn(jp, jmq("int2-asym", 32)))))
        got = dict(ttr.tree_items(tfn(tp, tmq("int2-asym", 32))))
        assert got.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_allclose(t2n(got[path]), w, rtol=1e-6, atol=1e-6, err_msg=str(path))
    assert "gate" not in tp["layers"] and cfg.mlp_style == "plain"


def test_random_packed_params_leaves_match_jax():
    """The port's random_packed_params makes the JAX package's leaves (the
    Llama layout, q/k norms under qk_norm) with their shapes."""
    from bitdistiller_tpu.models.quantized import random_packed_params as jrpp
    from bitdistiller_tpu_torch.models.quantized import random_packed_params as trpp

    cfg = dataclasses.replace(MODELS["qwen3"], dtype="bfloat16")
    jp = jrpp(cfg, jax.random.key(0), bits=2, group_size=32)
    tp = trpp(_tcfg("qwen3"), bits=2, group_size=32, device="cpu")
    assert sorted(tp["layers"]) == sorted(jp["layers"])
    assert "q_norm" in tp["layers"] and "k_norm" in tp["layers"]
    for name, jl in jp["layers"].items():
        tl = tp["layers"][name]
        shape = (lambda x: tuple(x.qweight.shape)) if hasattr(jl, "qweight") else (
            lambda x: tuple(x.shape))
        assert shape(tl) == shape(jl), name
    assert sorted(tp) == sorted(jp)
