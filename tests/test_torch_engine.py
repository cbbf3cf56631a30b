"""The port's serving engine against the JAX package's `Engine` on a packed
f32 TINY_TEST (CPU): greedy outputs must be equal token for token, with more
requests than slots, mixed prompt lengths, and EOS stopping mid-horizon.
Both engines run an f32 KV cache, so greedy argmaxes see the same logits up
to f32 summation order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import Request as JaxRequest
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
PROMPTS = [[3, 7, 11], [5, 6], [9, 1, 4, 4, 2, 8, 30, 31, 7], [200, 17], [42] * 20]


@pytest.fixture(scope="module")
def models():
    jparams = pack_model(init_params(CFG, jax.random.key(0), dtype=jnp.float32),
                         CFG, bits=2, group_size=64)
    return jparams, params_from_numpy(to_numpy_tree(jparams), "cpu")


def _jax_engine(jparams, **kw):
    return JaxEngine(jparams, CFG, max_slots=2, max_len=64, cache_dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0), **kw)


def _port_engine(tparams, **kw):
    return Engine(tparams, torch_cfg(CFG), max_slots=2, max_len=64,
                  cache_dtype=torch.float32, sampling=SamplingParams(temperature=0.0),
                  device="cpu", **kw)


def test_greedy_tokens_equal_jax_engine(models):
    """Five requests through two slots: continuous batching, admission of
    groups, horizons cut by the remaining budgets."""
    jparams, tparams = models
    want = _jax_engine(jparams, eos_token_id=None).generate(PROMPTS, max_new_tokens=11)
    got = _port_engine(tparams, eos_token_id=None).generate(PROMPTS, max_new_tokens=11)
    assert got == want
    assert all(len(o) == 11 for o in got)


def test_eos_stops_like_jax_engine(models):
    jparams, tparams = models
    free = _jax_engine(jparams, eos_token_id=None).generate(PROMPTS[:3], max_new_tokens=10)
    eos = free[0][3]  # a token emitted mid-horizon
    jreqs = [JaxRequest(prompt_tokens=p, max_new_tokens=10) for p in PROMPTS[:3]]
    treqs = [Request(prompt_tokens=p, max_new_tokens=10) for p in PROMPTS[:3]]
    _jax_engine(jparams, eos_token_id=eos).run(jreqs)
    _port_engine(tparams, eos_token_id=eos).run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.output_tokens == j.output_tokens
        assert (t.finished, t.finish_reason) == (j.finished, j.finish_reason)
    assert treqs[0].finish_reason == "stop" and treqs[0].output_tokens[-1] == eos


def test_stop_ids_and_cache_length_finish(models):
    """A per-request stop id finishes with "stop"; a prompt near max_len
    finishes on the cache length with "length"."""
    _, tparams = models
    eng = _port_engine(tparams, eos_token_id=None)
    first = eng.generate([PROMPTS[1]], max_new_tokens=3)[0]
    stop = Request(prompt_tokens=PROMPTS[1], max_new_tokens=8, stop_token_ids=(first[1],))
    long = Request(prompt_tokens=list(np.arange(60) % 200 + 1), max_new_tokens=20)
    eng.run([stop, long])
    assert stop.finish_reason == "stop"
    assert stop.output_tokens == first[: first.index(first[1]) + 1]
    assert long.finish_reason == "length" and 60 + len(long.output_tokens) <= 64


def test_engine_defaults_to_the_card():
    """With no card, an engine built without device="cpu" raises rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine({}, torch_cfg(CFG))


def test_prefills_count_the_batched_prefill_forwards(models, monkeypatch):
    """`Engine.prefills` (read by chip_smoke.py to expect 4 prefill matmuls a
    layer a prefill) counts the forwards that return a prompt's KV."""
    from bitdistiller_tpu_torch.serve import engine as engine_mod

    _, tparams = models
    calls = []
    real = engine_mod.llama.forward

    def spy(*args, **kw):
        calls.append(kw.get("return_kv", False))
        return real(*args, **kw)

    monkeypatch.setattr(engine_mod.llama, "forward", spy)
    eng = _port_engine(tparams, eos_token_id=None)
    eng.generate(PROMPTS, max_new_tokens=4)
    assert eng.prefills == sum(calls) >= 3  # five prompts through two slots
