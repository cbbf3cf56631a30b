"""The port's n-gram speculative decoding against the JAX package's engine
(CPU): the draft helpers and the adaptive-k policy on the same inputs, and
the greedy tokens and acceptance counters of the same scenarios on a packed
int2-g64 f32 TINY_TEST with f32 KV caches (greedy argmaxes see the same
logits up to f32 summation order). The port-only scenarios are the JAX
package's tests/test_serve.py spec tests, held against the port's own plain
engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.serve import engine as engine_mod
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
PERIODIC = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 2, 9, 2, 9, 2, 9], [3, 11, 4], list(range(3, 40))]


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


@pytest.fixture(scope="module")
def dense():
    """The dense f32 TINY_TEST of the JAX package's spec tests: its greedy
    continuation of a periodic prompt stays periodic to the cache's end."""
    return params_from_numpy(to_numpy_tree(init_params(CFG, jax.random.key(0),
                                                       dtype=jnp.float32)), "cpu")


def _port(tparams, cache_dtype=torch.float32, **kw):
    kw = {"max_slots": 4, "max_len": 128, **kw}
    return Engine(tparams, torch_cfg(CFG), sampling=kw.pop("sampling", SamplingParams(temperature=0.0)),
                  eos_token_id=None, cache_dtype=cache_dtype, device="cpu", **kw)


def _jax(jparams, **kw):
    kw = {"max_slots": 4, "max_len": 128, **kw}
    return JaxEngine(jparams, CFG, sampling=JaxSampling(temperature=0.0), eos_token_id=None,
                     cache_dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine's greedy tokens and counters for each scenario, built
    once for the module."""
    jparams, _ = models
    out = {}
    for name, kw, prompts, new in (
        ("k4", dict(spec_decode=True, spec_k=4), PERIODIC, 20),
        ("ladder_backoff", dict(spec_decode=True, spec_k=4, spec_k_ladder=(2, 4, 7),
                                spec_ngram_backoff=True), PERIODIC, 24),
        ("two_slots", dict(max_slots=2, spec_decode=True, spec_k=3),
         [[5, 6, 7, 5, 6, 7], [9, 2, 9, 2, 9], [4, 4, 4, 4], [8, 1, 8, 1]], 12),
    ):
        eng = _jax(jparams, **kw)
        outs = eng.generate(prompts, max_new_tokens=new)
        out[name] = dict(outs=outs, rounds=eng.spec_rounds, tokens=eng.spec_tokens,
                         k=eng._spec_k_last)
    return out


# ---- the draft helpers and the policy --------------------------------------------


def _histories(seed, b=6, hw=24, vocab=5):
    """Right-aligned windows with filler (-2) on the left and a small vocab,
    so that n-grams recur."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, vocab, (b, hw)).astype(np.int32)
    for i, fill in enumerate(rng.integers(0, hw, b)):
        h[i, :fill] = -2
    h[0, -1] = -1  # a filler context row
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ngram,k", [(1, 3), (2, 4), (3, 7)])
def test_ngram_draft_matches_jax(seed, ngram, k):
    h = _histories(seed)
    want = np.asarray(JaxEngine.ngram_draft(jnp.asarray(h), k, ngram))
    got = Engine.ngram_draft(torch.from_numpy(h), k, ngram).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_ngram_draft_backoff_matches_jax(seed):
    h = _histories(seed, vocab=4)
    want = np.asarray(JaxEngine.ngram_draft_backoff(jnp.asarray(h), 4, 3, 2))
    got = Engine.ngram_draft_backoff(torch.from_numpy(h), 4, 3, 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_ngram_draft_exact_followers():
    """The JAX package's hand cases: the tokens IMMEDIATELY after the last
    earlier occurrence; none for an unseen gram or a filler context."""
    hist = torch.tensor([
        [-2, -2, 5, 6, 7, 9, 5, 6],
        [-2, 3, 3, 3, 3, 3, 3, 3],
        [-2, -2, -2, -2, -2, -2, 1, 2],
        [-2, -2, -2, -2, -2, -2, -2, -1],
    ], dtype=torch.int32)
    d = Engine.ngram_draft(hist, k=3, ngram=2).numpy()
    np.testing.assert_array_equal(d, [[7, 9, 5], [3, 3, 3], [-1, -1, -1], [-1, -1, -1]])
    d3 = Engine.ngram_draft(hist, k=2, ngram=3).numpy()
    np.testing.assert_array_equal(d3[:2], [[-1, -1], [3, 3]])


@pytest.mark.parametrize("seed", [0, 1])
def test_var_append_matches_jax(seed):
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2, 50, (5, 12)).astype(np.int32)
    toks = rng.integers(0, 50, (5, 6)).astype(np.int32)
    n = rng.integers(0, 7, 5).astype(np.int32)
    want = np.asarray(JaxEngine._var_append(jnp.asarray(buf), jnp.asarray(toks), jnp.asarray(n)))
    got = Engine._var_append(torch.from_numpy(buf), torch.from_numpy(toks),
                             torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, want)


def test_invert_geometric_matches_jax():
    for e in (0.0, 0.05, 0.5, 1.7, 3.3, 6.99, 7.0, 9.0):
        for k in (1, 4, 7, 11):
            assert Engine._invert_geometric(e, k) == JaxEngine._invert_geometric(e, k)


@pytest.mark.parametrize("adaptive,ladder", [(True, (4, 7, 11)), (True, (2, 4, 7)),
                                             (False, (4, 7, 11))])
def test_current_spec_k_follows_jax_over_ema_sequences(models, monkeypatch, adaptive, ladder):
    """The same EMA updates (as run() makes them) give the same k at every
    step, hysteresis included (the port's ladder is its module constant)."""
    jparams, tparams = models
    kw = dict(max_slots=2, max_len=64, spec_decode=True, spec_k=4, spec_adaptive_k=adaptive)
    monkeypatch.setattr(engine_mod, "SPEC_K_LADDER", ladder)
    jeng, teng = _jax(jparams, spec_k_ladder=ladder, **kw), _port(tparams, **kw)
    rng = np.random.default_rng(5)
    for rate in list(rng.uniform(1.0, 12.0, 40)) + [1.0, 1.05, 11.9, 11.9, 2.2, 2.3]:
        for eng in (jeng, teng):
            k = eng._current_spec_k()
            eng._spec_k_last = k
            eng._spec_ema = rate if eng._spec_ema is None else 0.7 * eng._spec_ema + 0.3 * rate
        assert teng._spec_k_cur == jeng._spec_k_cur
    assert teng._current_spec_k() == jeng._current_spec_k()


# ---- greedy tokens against the JAX engine -------------------------------------------


@pytest.mark.parametrize("name,kw,prompts,new", [
    ("k4", dict(spec_decode=True, spec_k=4), PERIODIC, 20),
    ("ladder_backoff", dict(spec_decode=True, spec_k=4, spec_k_ladder=(2, 4, 7),
                            spec_ngram_backoff=True), PERIODIC, 24),
    ("two_slots", dict(max_slots=2, spec_decode=True, spec_k=3),
     [[5, 6, 7, 5, 6, 7], [9, 2, 9, 2, 9], [4, 4, 4, 4], [8, 1, 8, 1]], 12),
], ids=["k4", "ladder_backoff", "mid_run_admission"])
def test_spec_greedy_tokens_and_counters_equal_jax(models, jax_runs, monkeypatch, name, kw,
                                                   prompts, new):
    _, tparams = models
    kw = dict(kw)
    if "spec_k_ladder" in kw:  # the port's ladder is its module constant
        monkeypatch.setattr(engine_mod, "SPEC_K_LADDER", kw.pop("spec_k_ladder"))
    eng = _port(tparams, **kw)
    outs = eng.generate(prompts, max_new_tokens=new)
    want = jax_runs[name]
    assert outs == want["outs"]
    assert (eng.spec_rounds, eng.spec_tokens, eng._spec_k_last) == (
        want["rounds"], want["tokens"], want["k"])
    assert eng.spec_tokens > eng.spec_rounds  # drafts were accepted
    # a pure speedup: the port's plain engine emits the same tokens
    plain = _port(tparams, max_slots=kw.get("max_slots", 4))
    assert plain.generate(prompts, max_new_tokens=new) == outs
    # verify forwards ran at every k the counters name
    assert sum(eng.spec_forwards.values()) >= 1


# ---- port-only scenarios (the JAX package's test_serve.py) -----------------------------


def test_spec_int8_cache_matches_int8_plain(models):
    _, tparams = models
    spec = _port(tparams, torch.int8, spec_decode=True, spec_k=4)
    plain = _port(tparams, torch.int8)
    assert spec.generate(PERIODIC, max_new_tokens=20) == plain.generate(PERIODIC,
                                                                       max_new_tokens=20)


def test_spec_stops_and_budget(models):
    """A stop id inside an accepted burst truncates exactly; budgets hold."""
    _, tparams = models
    prompt = [5, 6, 7, 5, 6, 7, 5, 6]
    ref = _port(tparams, max_slots=2).generate([prompt], max_new_tokens=24)[0]
    stop = ref[10]
    spec = _port(tparams, max_slots=2, spec_decode=True, spec_k=4)
    r = Request(prompt_tokens=prompt, max_new_tokens=24, stop_token_ids=(stop,))
    spec.run([r])
    assert r.output_tokens == ref[:ref.index(stop) + 1] and r.finish_reason == "stop"
    r2 = Request(prompt_tokens=prompt, max_new_tokens=7)
    spec.run([r2])
    assert r2.output_tokens == ref[:7] and r2.finish_reason == "length"


def test_spec_sampled_runs(models):
    _, tparams = models
    spec = _port(tparams, max_slots=2, sampling=SamplingParams(temperature=0.8, top_p=0.9),
                 spec_decode=True, spec_k=4, seed=3)
    outs = spec.generate([[5, 6, 7, 5, 6, 7], [3, 9]], max_new_tokens=10)
    assert all(len(o) == 10 for o in outs)
    assert all(0 <= t < CFG.vocab_size for o in outs for t in o)


def test_spec_near_max_len_matches_plain(dense):
    """Below k + 1 rows of headroom a round takes the plain step: a verify
    there would write over attended rows."""
    tparams = dense
    prompt = [5, 6, 7] * 4
    want = _port(tparams, max_slots=2, max_len=48).generate([prompt], max_new_tokens=48)[0]
    spec = _port(tparams, max_slots=2, max_len=48, spec_decode=True, spec_k=4)
    r = Request(prompt_tokens=prompt, max_new_tokens=48)
    spec.run([r])
    assert spec.spec_tokens > spec.spec_rounds
    assert r.finish_reason == "length" and r.output_tokens == want


def test_spec_rep_penalty_and_custom_sampling_fall_back_to_plain(models):
    _, tparams = models
    sp = SamplingParams(temperature=0.0, repetition_penalty=1.3)
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 2, 9, 2, 9]]
    want = _port(tparams, max_slots=2, sampling=sp).generate(prompts, max_new_tokens=16)
    spec = _port(tparams, max_slots=2, sampling=sp, spec_decode=True, spec_k=4)
    assert spec.generate(prompts, max_new_tokens=16) == want
    assert spec.spec_rounds == 0 and not spec.spec_forwards
    # a request with its own sampling params takes the plain step too
    spec2 = _port(tparams, max_slots=2, spec_decode=True, spec_k=4)
    r = Request(prompt_tokens=prompts[0], max_new_tokens=8,
                sampling=SamplingParams(temperature=0.0))
    spec2.run([r])
    assert spec2.spec_rounds == 0 and len(r.output_tokens) == 8


def test_spec_adaptive_fallback_probes(models):
    """Structureless prompts: acceptance under spec_min_accept hands the
    rounds to the plain step, with probes, and the tokens stay the plain
    engine's."""
    _, tparams = models
    prompts = [[3, 11, 4, 9, 2], list(range(3, 30))]
    want = _port(tparams, max_slots=2, max_len=256).generate(prompts, max_new_tokens=64)
    spec = _port(tparams, max_slots=2, max_len=256, spec_decode=True, spec_k=4)
    assert spec.generate(prompts, max_new_tokens=64) == want
    if spec._spec_ema < spec.spec_min_accept:
        assert spec._spec_off_rounds > 0 and spec.decode_steps > 0


def test_spec_k_ladder_is_the_constant_plus_spec_k(models):
    _, tparams = models
    assert _port(tparams, spec_decode=True, spec_k=4).spec_k_ladder == engine_mod.SPEC_K_LADDER
    assert _port(tparams, spec_decode=True, spec_k=5).spec_k_ladder == tuple(
        sorted(engine_mod.SPEC_K_LADDER + (5,)))
