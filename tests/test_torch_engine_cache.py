"""The port's KV cache growth, in-group prompt dedup and prompt cache
(exact hits and the tail-only prefix extension) against the JAX package's
engine on a packed int2-g64 f32 TINY_TEST (CPU, f32 and int8 KV caches):
equal greedy tokens and counters on the same scenarios, the JAX engines
built once for the module. The LRU, byte-budget and randomized-soak
scenarios of the JAX package's tests/test_serve.py are held against the
port's own engine."""

import dataclasses
import random

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
from bitdistiller_tpu_torch.serve import engine as engine_mod
from bitdistiller_tpu_torch.serve.engine import grow_kv_cache
from bitdistiller_tpu_torch.models.llama import KVCache
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
DTYPES = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}
SYSTEM = [7, 3, 9, 9, 2, 5]
LONG = list(range(3, 61))  # 58 tokens: starts in the 64 bucket and grows past it


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jparams = pack_model(init_params(CFG, jax.random.key(0), dtype=jnp.float32),
                         CFG, bits=2, group_size=64)
    return jparams, params_from_numpy(to_numpy_tree(jparams), "cpu")


def _jax(jparams, dtype=jnp.float32, **kw):
    return JaxEngine(jparams, CFG, sampling=JaxSampling(temperature=0.0), eos_token_id=None,
                     cache_dtype=dtype, **kw)


def _port(tparams, dtype=torch.float32, **kw):
    return Engine(tparams, TCFG, sampling=SamplingParams(temperature=0.0), eos_token_id=None,
                  cache_dtype=dtype, device="cpu", **kw)


def _prefix_turns(eng, R):
    """The system prompt stored, then a turn extending it (stored), then a
    turn extending that: (outputs, counters)."""
    eng.run([R(prompt_tokens=SYSTEM, max_new_tokens=2, cache_prompt=True)])
    r2 = R(prompt_tokens=SYSTEM + [4, 8, 1], max_new_tokens=6, cache_prompt=True)
    eng.run([r2])
    r3 = R(prompt_tokens=SYSTEM + [4, 8, 1, 2, 2], max_new_tokens=4)
    eng.run([r3])
    r4 = R(prompt_tokens=SYSTEM + [4, 8, 1], max_new_tokens=4)  # exact hit
    eng.run([r4])
    return ([r2.output_tokens, r3.output_tokens, r4.output_tokens],
            (eng.prompt_cache_hits, eng.prompt_cache_prefix_hits, eng.prompt_cache_misses))


def _exact_and_mixed(eng, R):
    r1 = R(prompt_tokens=[9, 4, 4, 2], max_new_tokens=6, cache_prompt=True)
    eng.run([r1])
    reqs = [R(prompt_tokens=[9, 4, 4, 2], max_new_tokens=6), R(prompt_tokens=[2, 9],
                                                               max_new_tokens=6)]
    eng.run(reqs)
    return ([r1.output_tokens] + [r.output_tokens for r in reqs],
            (eng.prompt_cache_hits, eng.prompt_cache_prefix_hits, eng.prompt_cache_misses))


@pytest.fixture(scope="module")
def jax_runs(models):
    jparams, _ = models
    out = {}
    eng = _jax(jparams, max_slots=2, max_len=256)
    out["grow"] = eng.generate([LONG, [5, 6]], max_new_tokens=24)
    out["grow_len"] = eng.cache.k.shape[3]
    eng = _jax(jparams, max_slots=4, max_len=64)
    out["dedup"] = eng.generate([[7, 3, 11]] * 3 + [[5, 2]], max_new_tokens=6)
    for name, (jd, _) in DTYPES.items():
        out["prefix", name] = _prefix_turns(_jax(jparams, jd, max_slots=2, max_len=64,
                                                 prompt_cache_size=2), JaxRequest)
        out["exact", name] = _exact_and_mixed(_jax(jparams, jd, max_slots=2, max_len=64,
                                                   prompt_cache_size=2), JaxRequest)
    return out


# ---- growth ----------------------------------------------------------------------


def test_growth_greedy_tokens_equal_jax(models, jax_runs):
    _, tparams = models
    eng = _port(tparams, max_slots=2, max_len=256)
    assert eng._cache_len() == 64
    assert eng.generate([LONG, [5, 6]], max_new_tokens=24) == jax_runs["grow"]
    assert eng._cache_len() == jax_runs["grow_len"] == 128
    assert eng.growths == [(64, 128)]
    static = _port(tparams, max_slots=2, max_len=256, grow_cache=False)
    assert static._cache_len() == 256
    assert static.generate([LONG, [5, 6]], max_new_tokens=24) == jax_runs["grow"]
    assert not static.growths
    # decode steps are counted at the cache length they read
    assert sum(eng.decode_steps_at.values()) == eng.decode_steps
    assert set(eng.decode_steps_at) <= {64, 128} and set(static.decode_steps_at) == {256}


def test_growth_int8_cache_matches_static_int8(models):
    """The int8 cache's scale planes grow with its codes."""
    _, tparams = models
    grown = _port(tparams, torch.int8, max_slots=2, max_len=256)
    static = _port(tparams, torch.int8, max_slots=2, max_len=256, grow_cache=False)
    got = grown.generate([LONG], max_new_tokens=24)
    assert grown.cache.k_scale.shape[3] == grown.cache.k.shape[3] == 128
    assert got == static.generate([LONG], max_new_tokens=24)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_grow_kv_cache_copies_every_plane(dtype):
    cache = KVCache.init(TCFG, 2, 8, dtype, device="cpu")
    for buf in (cache.k, cache.v) + ((cache.k_scale, cache.v_scale) if cache.quantized else ()):
        buf.copy_(torch.arange(buf.numel()).reshape(buf.shape).to(buf.dtype))
    grown = grow_kv_cache(cache, 32)
    for old, new in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                        (grown.k, grown.v, grown.k_scale, grown.v_scale)):
        if old is None:
            assert new is None
            continue
        assert new.shape[3] == 32 and new.dtype == old.dtype
        assert torch.equal(new[:, :, :, :8], old) and not new[:, :, :, 8:].any()


def test_growth_peak_bucket_walk(models, monkeypatch):
    """Buckets follow CACHE_BUCKET_FACTOR; a trajectory walks them in order."""
    _, tparams = models
    monkeypatch.setattr(engine_mod, "CACHE_BUCKET_FACTOR", 4)
    eng = _port(tparams, max_slots=1, max_len=512)
    assert eng.cache_buckets == [64, 256, 512]
    eng.generate([[3, 4, 5]], max_new_tokens=300)
    assert eng.growths == [(64, 256), (256, 512)]


# ---- dedup and the prompt cache --------------------------------------------------------


def test_in_group_dedup_equals_jax(models, jax_runs, monkeypatch):
    """Three identical prompts share one prefill row: one prefill of batch
    2 (two unique prompts, a power of two)."""
    _, tparams = models
    eng = _port(tparams, max_slots=4, max_len=64)
    shapes = []
    real = eng._prefill
    monkeypatch.setattr(eng, "_prefill", lambda t, i: shapes.append(tuple(t.shape)) or real(t, i))
    outs = eng.generate([[7, 3, 11]] * 3 + [[5, 2]], max_new_tokens=6)
    assert outs == jax_runs["dedup"]
    assert shapes == [(2, 64)] and eng.prefills == 1
    solo = _port(tparams, max_slots=1, max_len=64)
    assert outs[0] == solo.generate([[7, 3, 11]], max_new_tokens=6)[0]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prompt_cache_exact_hits_equal_jax(models, jax_runs, dtype):
    """A stored prompt admits from its rows and logits (no prefill), beside
    a fresh prompt in the same group."""
    _, tparams = models
    eng = _port(tparams, DTYPES[dtype][1], max_slots=2, max_len=64, prompt_cache_size=2)
    got = _exact_and_mixed(eng, Request)
    assert got == jax_runs["exact", dtype]
    assert eng.prefills == 2  # the stored prompt's and the fresh one's
    assert got[0][0] == got[0][1]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefix_extension_equals_jax(models, jax_runs, dtype):
    """Tail-only prefills against the stored prefix, chained (the extended
    prompt is stored and extended again), then an exact hit: tokens and
    counters equal JAX's; one full prefill in all."""
    _, tparams = models
    eng = _port(tparams, DTYPES[dtype][1], max_slots=2, max_len=64, prompt_cache_size=2)
    got = _prefix_turns(eng, Request)
    assert got == jax_runs["prefix", dtype]
    assert got[1] == (3, 2, 1)
    assert eng.prefills == 1 and eng.prefix_extends == [16, 16]
    assert got[0][2] == got[0][0][:4]
    solo = _port(tparams, DTYPES[dtype][1], max_slots=2, max_len=64)
    assert got[0][0] == solo.generate([SYSTEM + [4, 8, 1]], max_new_tokens=6)[0]


def test_prefix_extension_skips_a_tail_that_would_not_fit(models):
    """pfx + the padded tail past max_len: a full prefill instead."""
    _, tparams = models
    eng = _port(tparams, max_slots=1, max_len=64, prompt_cache_size=2)
    base = list(range(3, 53))  # 50 tokens: 50 + 16 > 64
    eng.run([Request(prompt_tokens=base, max_new_tokens=1, cache_prompt=True)])
    r = Request(prompt_tokens=base + [9, 9], max_new_tokens=4)
    eng.run([r])
    assert eng.prompt_cache_prefix_hits == 0 and eng.prefills == 2
    solo = _port(tparams, max_slots=1, max_len=64)
    assert r.output_tokens == solo.generate([base + [9, 9]], max_new_tokens=4)[0]


def test_prompt_cache_lru_eviction(models):
    _, tparams = models
    eng = _port(tparams, max_slots=2, max_len=64, prompt_cache_size=1)
    a, b = [3, 1], [8, 8, 2]
    eng.run([Request(prompt_tokens=a, max_new_tokens=3, cache_prompt=True)])
    eng.run([Request(prompt_tokens=b, max_new_tokens=3, cache_prompt=True)])
    assert eng.prefills == 2
    eng.run([Request(prompt_tokens=a, max_new_tokens=3)])  # evicted: prefill
    assert eng.prefills == 3 and eng.prompt_cache_hits == 0
    eng.run([Request(prompt_tokens=b, max_new_tokens=3)])  # still stored
    assert eng.prefills == 3 and eng.prompt_cache_hits == 1


def test_prompt_cache_bytes_budget(models):
    _, tparams = models
    prompts = ([3, 1, 4], [5, 5], [9, 2, 2])
    eng = _port(tparams, max_slots=2, max_len=64, prompt_cache_size=8, prompt_cache_bytes=1)
    eng.run([Request(prompt_tokens=prompts[0], max_new_tokens=2, cache_prompt=True)])
    assert len(eng._prompt_cache) == 0  # over budget: dropped
    eng2 = _port(tparams, max_slots=2, max_len=64, prompt_cache_size=8,
                 prompt_cache_bytes=1 << 30)
    for p in prompts:
        eng2.run([Request(prompt_tokens=p, max_new_tokens=2, cache_prompt=True)])
    assert len(eng2._prompt_cache) == 3
    entry = next(iter(eng2._prompt_cache.values()))
    nbytes = Engine._entry_bytes(entry)
    assert nbytes == 2 * CFG.num_layers * 64 * CFG.num_kv_heads * CFG.actual_head_dim * 4 + 4 * CFG.vocab_size
    eng3 = _port(tparams, max_slots=2, max_len=64, prompt_cache_size=8,
                 prompt_cache_bytes=int(nbytes * 2.5))  # room for 2
    for p in prompts:
        eng3.run([Request(prompt_tokens=p, max_new_tokens=2, cache_prompt=True)])
    assert len(eng3._prompt_cache) == 2 and tuple(prompts[0]) not in eng3._prompt_cache
    # a byte budget alone turns the cache on, with the 512-entry cap
    assert _port(tparams, max_slots=1, max_len=64, prompt_cache_bytes=1 << 20).prompt_cache_size == 512


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_random_soak_matches_solo(models, spec):
    """Mixed prompt lengths, budgets, stop ids, duplicates and stored
    prompts, arriving through a feeder: every greedy output equals a solo
    single-slot engine's."""
    _, tparams = models
    rng = random.Random(7)
    specs = []
    for i in range(17):
        prompt = [rng.randint(3, CFG.vocab_size - 1) for _ in range(rng.randint(1, 40))]
        if i % 4 == 0 and specs:
            prompt = specs[-1][0]  # exact duplicates: the dedup path
        specs.append((prompt, rng.randint(1, 30), (rng.randint(3, 9),) if i % 3 == 0 else ()))
    eng = _port(tparams, max_slots=3, max_len=128, prompt_cache_size=2, spec_decode=spec,
                spec_k=3)
    reqs = [Request(prompt_tokens=p, max_new_tokens=m, stop_token_ids=s,
                    cache_prompt=(i % 5 == 0)) for i, (p, m, s) in enumerate(specs)]
    pending = reqs[3:]

    def feeder(idle):
        return [pending.pop(0) for _ in range(2) if pending]

    done = eng.run(reqs[:3], feeder=feeder, stop=lambda: not pending)
    assert len(done) == len(reqs) and all(r.finished for r in reqs)
    solo = _port(tparams, max_slots=1, max_len=128)
    for r, (prompt, max_new, stops) in zip(reqs, specs):
        want = Request(prompt_tokens=prompt, max_new_tokens=max_new, stop_token_ids=stops)
        solo.run([want])
        assert (r.output_tokens, r.finish_reason) == (want.output_tokens, want.finish_reason)
