"""Rope scaling on the port against the JAX package on the CPU, for every
scaling of tests/test_rope_scaling.py (linear, llama3, longrope with its
short and its long table, yarn with and without an attention factor): the
frequencies and the magnitude factor, the cos/sin tables, `from_hf_config`
on each `rope_scaling` type, and a model's dense logits and cached decode
step under each.

Tolerances: the frequencies are computed by the same numpy f32 code in both
packages, so they are equal and so is the factor; cos/sin within 1e-6 (f32
cos and sin of the same arguments in two libraries); logits rtol/atol 1e-4
(f32, the same operations summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import KVCache as JKV
from bitdistiller_tpu.models import ModelConfig as JMC
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.models import llama as jllama
from bitdistiller_tpu.models import layers as jlayers
from bitdistiller_tpu_torch.models import config as tconfig
from bitdistiller_tpu_torch.models import layers as tlayers
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from torch_port_util import t2n, to_numpy_tree, torch_cfg

BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2, num_kv_heads=2, dtype="float32")
DH = BASE["hidden_size"] // BASE["num_heads"]
LONG = tuple(1.0 + 0.5 * i for i in range(DH // 2))
SCALINGS = {  # name: ModelConfig fields beside BASE
    "linear": dict(rope_scaling_type="linear", rope_scaling_factor=4.0),
    "llama3": dict(rope_theta=500000.0, rope_scaling_type="llama3", rope_scaling_factor=8.0,
                   rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
                   rope_original_max_position=8192),
    "longrope_short": dict(rope_scaling_type="longrope", rope_long_factor=LONG,
                           rope_short_factor=(1.0,) * (DH // 2), rope_original_max_position=512,
                           max_position_embeddings=512),
    "longrope_long": dict(rope_scaling_type="longrope", rope_long_factor=LONG,
                          rope_short_factor=(1.0,) * (DH // 2), rope_original_max_position=512,
                          max_position_embeddings=2048),
    "yarn": dict(rope_theta=1000000.0, rope_scaling_type="yarn", rope_scaling_factor=4.0,
                 rope_original_max_position=32768),
    "yarn_attention_factor": dict(rope_theta=1000000.0, rope_scaling_type="yarn",
                                  rope_scaling_factor=4.0, rope_beta_fast=16.0,
                                  rope_attention_factor=1.5, rope_original_max_position=32768),
}


def _cfgs(name):
    j = JMC(**{**BASE, **SCALINGS[name]})
    return j, torch_cfg(j)


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_rope_scaling_params_equal(name):
    j, t = _cfgs(name)
    jinv, jms = jlayers.rope_scaling_params(j, DH, j.rope_theta)
    tinv, tms = tlayers.rope_scaling_params(t, DH, t.rope_theta)
    np.testing.assert_array_equal(np.asarray(tinv, np.float32), np.asarray(jinv))
    assert tms == jms
    if name != "longrope_short":  # the short table is all ones here
        base = tlayers.rope_inv_freq(DH, t.rope_theta)
        assert not np.array_equal(np.asarray(tinv, np.float32), base)
    assert (tms != 1.0) == (name in ("longrope_long", "yarn", "yarn_attention_factor"))


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_rope_cos_sin_match(name):
    j, t = _cfgs(name)
    pos = np.array([[0, 3, 17, 511, 2047]], np.int32)
    jinv, jms = jlayers.rope_scaling_params(j, DH, j.rope_theta)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), DH, j.rope_theta, inv_freq=jinv, mscale=jms)
    inv, ms = tlayers.rope_tables(t, DH, t.rope_theta, torch.device("cpu"))
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), inv, ms)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


HF_BASE = {"model_type": "llama", "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
           "num_hidden_layers": 1, "num_attention_heads": 2, "num_key_value_heads": 2}
HF_SCALINGS = {
    "linear": {"rope_scaling": {"rope_type": "linear", "factor": 8.0}},
    "linear_legacy_type": {"rope_scaling": {"type": "linear", "factor": 2.0}},
    "llama3": {"rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192}},
    "longrope": {"original_max_position_embeddings": 4096, "max_position_embeddings": 131072,
                 "rope_scaling": {"type": "longrope", "long_factor": [1.5] * 8,
                                  "short_factor": [1.0] * 8}},
    "su": {"original_max_position_embeddings": 4096,
           "rope_scaling": {"type": "su", "long_factor": [1.0] * 8, "short_factor": [1.0] * 8}},
    "yarn": {"model_type": "qwen2",
             "rope_scaling": {"rope_type": "yarn", "factor": 4.0, "beta_fast": 16,
                              "attention_factor": 1.5,
                              "original_max_position_embeddings": 32768}},
    "default": {"rope_scaling": {"rope_type": "default"}},
    "none": {"rope_scaling": None},
}


@pytest.mark.parametrize("name", sorted(HF_SCALINGS))
def test_from_hf_config_rope_scaling_matches_jax(name):
    hf = {**HF_BASE, **HF_SCALINGS[name]}
    j, t = JMC.from_hf_config(hf), tconfig.ModelConfig.from_hf_config(hf)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_unsupported_rope_scaling_raises_as_jax():
    hf = {**HF_BASE, "rope_scaling": {"rope_type": "dynamic", "factor": 2.0}}
    for parse in (JMC.from_hf_config, tconfig.ModelConfig.from_hf_config):
        with pytest.raises(ValueError, match="dynamic"):
            parse(hf)


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_scaled_model_logits_and_decode_match(name):
    """Dense logits over 12 tokens, then 11 tokens into a cache and the 12th
    as a decode step, under each scaling."""
    j, t = _cfgs(name)
    jp = jinit(j, jax.random.key(0), dtype=jnp.float32)
    tp = params_from_numpy(to_numpy_tree(jp), "cpu")
    toks = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(np.int32)
    want, _ = jllama.forward(jp, j, jnp.asarray(toks))
    got, _ = tllama.forward(tp, t, torch.from_numpy(toks).long())
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    jc = JKV.init(j, batch=2, max_len=16, dtype=jnp.float32)
    tc = tllama.KVCache.init(t, 2, 16, torch.float32, device="cpu")
    _, jc = jllama.forward(jp, j, jnp.asarray(toks[:, :11]), cache=jc, cache_pos=0)
    tllama.forward(tp, t, torch.from_numpy(toks[:, :11]).long(), cache=tc, cache_pos=0)
    want, _ = jllama.forward(jp, j, jnp.asarray(toks[:, 11:]), cache=jc, cache_pos=11)
    got, _ = tllama.forward(tp, t, torch.from_numpy(toks[:, 11:]).long(), cache=tc, cache_pos=11)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)
