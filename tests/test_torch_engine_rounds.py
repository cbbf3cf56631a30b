"""The port's engine loop (CPU): the horizon's one read, the request hooks
(`stream`, `stop_check`, `on_finish`, the timing fields), the feeder and
`warmup`. Greedy tokens at horizons 1 and 4 are held against the JAX
package's engine on a packed int2-g64 f32 TINY_TEST; the rest are the JAX
package's tests/test_serve.py scenarios against the port's own engine."""

import dataclasses

import jax
import jax.numpy as jnp
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
TCFG = torch_cfg(CFG)
PROMPTS = [[3, 7, 11], [5, 2], [9, 1, 4, 4, 2, 8, 30, 31, 7]]


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


def _port(tparams, **kw):
    kw = {"max_slots": 2, "max_len": 64, "eos_token_id": None, **kw}
    return Engine(tparams, TCFG, sampling=kw.pop("sampling", SamplingParams(temperature=0.0)),
                  cache_dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("horizon", [1, 4])
def test_horizon_tokens_equal_jax(models, horizon):
    """The loop's horizons change no token against the JAX engine."""
    jparams, tparams = models
    want = JaxEngine(jparams, CFG, max_slots=2, max_len=64, cache_dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0), eos_token_id=None,
                     decode_horizon=horizon).generate(PROMPTS, 24)
    eng = _port(tparams, decode_horizon=horizon)
    assert eng.generate(PROMPTS, max_new_tokens=24) == want
    assert eng.decode_steps == sum(eng.decode_steps_at.values())


def test_each_horizon_is_read_before_the_next_dispatch(models, monkeypatch):
    """One host read a horizon (the admission's first tokens ride with the
    first): no horizon is dispatched before the previous one is read, and
    none past the budget (1 first token + 32 horizon tokens = 8 horizons of
    4)."""
    _, tparams = models
    eng = _port(tparams, max_slots=1, max_len=128, decode_horizon=4)
    calls, reads = [], []
    real_dispatch, real_wait = eng._dispatch_decode, engine_mod._Fetch.wait

    def spy(steps, spec=None, spec_k=None):
        calls.append((steps, len(reads)))
        return real_dispatch(steps, spec=spec, spec_k=spec_k)

    def wait(self):
        reads.append(1)
        return real_wait(self)

    monkeypatch.setattr(eng, "_dispatch_decode", spy)
    monkeypatch.setattr(engine_mod._Fetch, "wait", wait)
    out = eng.generate([[3, 7, 11]], max_new_tokens=33)[0]
    assert len(out) == 33
    assert [s for s, _ in calls] == [4] * 8
    # the first horizon is read with the first tokens (two reads); every
    # later one after the one before it
    assert [r for _, r in calls] == [0] + [2 + i for i in range(7)]
    assert len(reads) == 9


def test_fetch_reads_cpu_tensors_as_they_are():
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    f = engine_mod._Fetch([t, t + 1])
    assert f.event is None
    a, b = f.wait()
    assert a.tolist() == [[0, 1, 2], [3, 4, 5]] and b[0, 0] == 1


def test_stream_on_finish_and_timing_fields(models):
    _, tparams = models
    eng = _port(tparams)
    got, finished = [], []
    req = Request(prompt_tokens=[1, 2, 3], max_new_tokens=5, stream=got.append,
                  on_finish=finished.append)
    eng.run([req])
    assert got == req.output_tokens and len(got) == 5
    assert finished == [req] and req.finish_reason == "length"
    assert req.prefill_time > 0 and req.decode_time > 0 and req.decode_tokens == 4


def test_stop_check_finishes_with_stop(models):
    """A host predicate over the output so far (the frontend's multi-token
    stop strings) ends the request at the token where it turns True."""
    _, tparams = models
    free = _port(tparams).generate([PROMPTS[0]], max_new_tokens=12)[0]
    pair = free[4:6]
    eng = _port(tparams)
    req = Request(prompt_tokens=PROMPTS[0], max_new_tokens=12,
                  stop_check=lambda out: out[-2:] == pair)
    eng.run([req])
    assert req.finish_reason == "stop" and req.output_tokens == free[:6]


def test_eos_and_stop_ids(models):
    _, tparams = models
    first = _port(tparams, max_slots=1).generate([[5, 6]], max_new_tokens=1)[0][0]
    eng = _port(tparams, max_slots=1, eos_token_id=first)
    req = Request(prompt_tokens=[5, 6], max_new_tokens=10)
    eng.run([req])
    assert (req.finish_reason, req.output_tokens) == ("stop", [first])


def test_feeder_trickles_requests_and_stop_ends_the_loop(models):
    """Requests arriving through the feeder join mid-run; the loop exits once
    no work remains and stop() holds."""
    _, tparams = models
    eng = _port(tparams)
    later = [Request(prompt_tokens=p, max_new_tokens=6) for p in PROMPTS]
    polls = []

    def feeder(idle):
        polls.append(idle)
        return [later.pop(0)] if later else []

    first = Request(prompt_tokens=[4, 4], max_new_tokens=6)
    done = eng.run([first], feeder=feeder, stop=lambda: not later)
    assert len(done) == 4 and all(r.finished for r in done)
    solo = _port(tparams, max_slots=1)
    for r in done:
        assert r.output_tokens == solo.generate([r.prompt_tokens], max_new_tokens=6)[0]
    assert polls and not any(polls[:2])  # slots were decoding: not idle


def test_rep_penalty_window_resets_on_slot_reuse(models):
    _, tparams = models
    eng = _port(tparams, max_slots=1, max_len=32, rep_window=8,
                sampling=SamplingParams(temperature=0.0, repetition_penalty=1.3))
    eng.generate([[1, 2, 3]], max_new_tokens=4)
    assert int((eng.prev_tokens[0] >= 0).sum()) >= 4
    firsts = eng._admit_group([Request(prompt_tokens=[5, 6], max_new_tokens=1)], [0])
    window = eng.prev_tokens[0]
    assert bool((window[:-1] == -1).all()) and int(window[-1]) == int(firsts[0])


def test_warmup_leaves_a_clean_engine(models):
    _, tparams = models
    eng = _port(tparams, max_len=128)
    msgs = []
    eng.warmup(prompt_len=8, verbose=msgs.append)
    assert msgs and "warmup done" in msgs[0]
    assert not eng.active.any() and eng._cache_len() == 128
    fresh = _port(tparams, max_len=128)
    assert eng.generate([[5, 9, 2]], max_new_tokens=6) == fresh.generate([[5, 9, 2]],
                                                                        max_new_tokens=6)


def test_warmup_with_eos_still_grows_and_restores_counters(models):
    """EOS and the spec fallback are suspended during the walk: the cache
    grows through every bucket, every ladder k runs, and eos and the
    counters come back."""
    _, tparams = models
    first = _port(tparams, max_len=256).generate([[3, 4, 5, 6, 7, 8, 9, 10]],
                                                 max_new_tokens=1)[0][0]
    eng = _port(tparams, max_len=256, eos_token_id=first, spec_decode=True, spec_k=3,
                prompt_cache_size=2)
    eng.warmup(prompt_len=8)
    assert eng._cache_len() == 256 and [n for _, n in eng.growths] == [128, 256]
    assert set(eng.spec_forwards) == set(eng.spec_k_ladder)
    assert eng.eos == first and eng.spec_min_accept == 1.3
    assert eng._spec_ema is None and eng.spec_rounds == 0 and eng.spec_tokens == 0
    assert eng.prompt_cache_hits == eng.prompt_cache_misses == 0
