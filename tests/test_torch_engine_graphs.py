"""The engine's decode and verify steps over its fixed buffers (the port's
counterpart of the JAX engine's jitted, cache-donating `_decode` and
`_spec`), on the CPU against the JAX package's `Engine` on a packed
int2-g64 f32 TINY_TEST: greedy tokens equal on bf16 and int8 caches, growth
through three buckets, admission in mid-run, speculation at each k of the
ladder and a per-request greedy override inside a sampling engine; each
scenario on the eager route and on the graph route with a stand-in for
`torch.cuda.CUDAGraph` (a capture that runs the step and then puts the
engine's state back, a replay that runs it with the launch counters held;
the admission pieces replay on it too, checked by
tests/test_torch_engine_admission.py), whose bookkeeping is checked: keys
by bucket and mode, graphs dropped on growth, counters advanced by each
replay at the deltas its capture recorded. The JAX engines run once for
the module. The int8 cache is held
on the speculative engine's short streams; over a long stream (a 60-token
prompt, 75 new tokens through 64 -> 256 rows) the port's int8 greedy
stream leaves JAX's at token 40, where f32 and bf16 caches stay equal: the
engines split a near-tie (0.019 apart) under int8 quantization of k/v that
differ at the ulp level between XLA's and PyTorch's prefill matmuls, so
`tests/test_torch_kv_quant.py` holds that stream by the tie rule, and the
int8 cache's codes and scales bit-equal to JAX's compiled ones (C10)."""

import dataclasses
import types

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
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.serve import engine as engine_mod
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
L = CFG.num_layers
PERIODIC = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 2, 9, 2, 9, 2, 9], [3, 11, 4]]
CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8),
          "f32": (jnp.float32, torch.float32)}


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, CFG.vocab_size, n).tolist() for n in lens]


# name: (engine keywords, KV cache, runs); a run: (engine attributes set
# before it, its requests [(prompt, new tokens, "greedy" for a per-request
# greedy override)]). Each engine's runs go in order, on the JAX engine and
# on the port's.
_SHORT, _LONG = _prompts(0, (3, 5)), _prompts(1, (100,))[0]
ENGINES = {
    # per-request greedy overrides inside a sampling engine (the custom
    # step) on a bf16 cache: two short requests decode at 64 rows; the long
    # one is admitted in mid-run when the first finishes, its prefill grows
    # the cache to 128 rows and its decode to 256
    "bf16_growth_override": (
        dict(max_slots=2, max_len=256, sampling=(0.8, 0.9), seed=5, decode_horizon=2), "bf16",
        [({}, [(_SHORT[0], 12, "greedy"), (_SHORT[1], 24, "greedy"), (_LONG, 40, "greedy")])]),
    # the verify at each k of the ladder on an int8 cache (the acceptance
    # floor off: every round verifies)
    "int8_spec": (dict(max_slots=4, max_len=64, spec_decode=True, spec_adaptive_k=False,
                       decode_horizon=1), "int8",
                  [(dict(_spec_k_cur=k, spec_min_accept=-1.0), [(p, 12, None) for p in PERIODIC])
                   for k in engine_mod.SPEC_K_LADDER]),
}
RUNS = [(name, i) for name, (_, _, runs) in ENGINES.items() for i in range(len(runs))]


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


def _kw(kw: dict, sampling_cls):
    kw = dict(kw)
    t, p = kw.pop("sampling", (0.0, 1.0))
    return dict(kw, sampling=sampling_cls(temperature=t, top_p=p))


def _requests(reqs, request_cls, sampling_cls):
    return [request_cls(prompt_tokens=list(p), max_new_tokens=n,
                        sampling=sampling_cls(temperature=0.0) if s == "greedy" else None)
            for p, n, s in reqs]


def _runs(eng, runs, request_cls, sampling_cls) -> list:
    """Each run's output tokens and its plain decode-attention calls."""
    out = []
    for attrs, reqs in runs:
        for k, v in attrs.items():
            setattr(eng, k, v)
        before = da.flash_decode_stacked.plain_calls
        rs = _requests(reqs, request_cls, sampling_cls)
        eng.run(rs)
        out.append(([r.output_tokens for r in rs], da.flash_decode_stacked.plain_calls - before))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    jparams, _ = models
    out = {}
    for name, (kw, cache, runs) in ENGINES.items():
        eng = JaxEngine(jparams, CFG, eos_token_id=None, cache_dtype=CACHES[cache][0],
                        **_kw(kw, JaxSampling))
        out[name] = [o for o, _ in _runs(eng, runs, JaxRequest, JaxSampling)]
    return out


class FakeGraph:
    """`torch.cuda.CUDAGraph`'s stand-in: replay runs the body stored at
    capture on the CPU with the launch counters held, as a replay calls no
    wrapper, and writes what the body returns into the tensors the capture
    returned (a graph's outputs)."""

    def __init__(self):
        self.body = self.outs = None
        self.replays = 0

    def replay(self):
        held = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
        res = self.body()
        if self.outs is not None:
            for dst, src in zip(self.outs, res):
                dst.copy_(src)
        for (o, a), v in zip(engine_mod.LAUNCH_COUNTERS, held):
            setattr(o, a, v)
        self.replays += 1


def _state(eng) -> list:
    """Every tensor a step or an admission piece writes."""
    c = eng.cache
    out = [c.k, c.v, eng.cur_tokens, eng._pos, eng._lengths_dev, eng._active_dev,
           eng.prev_tokens, eng.history, eng._hz_step, eng._hz_tokens, eng._temps, eng._top_ks,
           eng._top_ps, eng._rep_pens]
    out += [t for t in (c.k_scale, c.v_scale) if t is not None]
    out += list(eng._staged.values()) + list(eng._rows or ())
    return out + [t for pair in eng._hz_verify.values() for t in pair]


def _steps(keys):
    """The step keys of a graph table's keys (a list, or a dict's keys with
    their values), without the admission's pieces."""
    if isinstance(keys, dict):
        return {k: v for k, v in keys.items() if engine_mod.piece(k) in engine_mod.STEP_PIECES}
    return [k for k in keys if engine_mod.piece(k) in engine_mod.STEP_PIECES]


def with_stand_in(eng):
    """Put the engine on the graph route with FakeGraph, its steps and its
    admission pieces: a capture runs the body (its wrappers count, as under
    a real capture), keeps what it returns as the graph's outputs, and then
    restores the engine's state and generator, as a capture leaves the
    device as it was."""

    def capture(graph, body):
        saved = [t.clone() for t in _state(eng)]
        gen = eng.generator.get_state()
        eng._hz_step.zero_()  # a real capture runs nothing: the index may be past the rows
        outs = body()
        for t, s in zip(_state(eng), saved):
            t.copy_(s)
        eng.generator.set_state(gen)
        graph.body, graph.outs = body, outs
        return outs

    eng._graphs = engine_mod._GraphTable(FakeGraph, capture)
    eng.route = "graphs"
    return eng


def _port(tparams, kw, cache, route):
    eng = Engine(tparams, TCFG, eos_token_id=None, cache_dtype=CACHES[cache][1], device="cpu",
                 **_kw(kw, SamplingParams))
    assert eng.route == "eager"
    return with_stand_in(eng) if route == "graphs" else eng


@pytest.fixture(scope="module")
def port_runs(models):
    """Every engine's runs on the eager route and on the stand-in graph
    route: (engine, [(tokens, plain decode-attention calls) a run])."""
    _, tparams = models
    out = {}
    for route in ("eager", "graphs"):
        for name, (kw, cache, runs) in ENGINES.items():
            eng = _port(tparams, kw, cache, route)
            out[route, name] = eng, _runs(eng, runs, Request, SamplingParams)
    return out


@pytest.mark.parametrize("route", ["eager", "graphs"])
@pytest.mark.parametrize("name,i", RUNS)
def test_step_equals_jax(jax_runs, port_runs, route, name, i):
    """Greedy tokens equal the JAX engine's on both routes; the graph
    route calls the decode attention as often as the eager one (a capture's
    calls are set back, a replay adds one step's)."""
    outs, calls = port_runs[route, name][1][i]
    assert outs == jax_runs[name][i]
    assert [len(o) for o in outs] == [n for _, n, _ in ENGINES[name][2][i][1]]
    assert calls == port_runs["eager", name][1][i][1]


@pytest.mark.parametrize("name", list(ENGINES))
def test_graph_route_bookkeeping(port_runs, name):
    """Every step either ran eagerly at its key's first use (then was
    captured) or replayed; each graph's recorded deltas are one step's
    counts: L plain decode-attention calls a plain step, none a verify
    (S = k + 1 goes through cached_attention)."""
    eng = port_runs["graphs", name][0]
    table = eng._graphs
    steps = eng.decode_steps + sum(eng.spec_forwards.values())
    captured, replays = table.count(engine_mod.STEP_PIECES)
    assert replays == steps - captured > 0
    plain_calls = engine_mod.LAUNCH_COUNTERS.index((da.flash_decode_stacked, "plain_calls"))
    for key, (graph, deltas, _) in _steps(table.graphs).items():
        want = 0 if key[1] == "verify" else L
        assert deltas[plain_calls] == want and sum(deltas) == want
        assert graph.body is not None
    modes = {key[1:] for key in _steps(table.captured)}
    assert modes == {"bf16_growth_override": {("custom",)},
                     "int8_spec": {("verify", 4), ("verify", 7), ("verify", 11)}}[name]


def test_graph_keys_by_bucket_and_mode_and_dropped_on_growth(models, port_runs):
    eng = port_runs["graphs", "bf16_growth_override"][0]
    assert eng.growths == [(64, 128), (128, 256)]
    assert set(eng.decode_steps_at) == {64, 128, 256}
    assert _steps(eng._graphs.captured) == [(64, "custom"), (128, "custom"), (256, "custom")]
    assert list(_steps(eng._graphs.graphs)) == [(256, "custom")]  # the replaced caches' dropped
    # the engine's own sampling takes the uniform step, at the bucket it reads
    eng.run([Request(prompt_tokens=[3, 4], max_new_tokens=6)])
    assert list(_steps(eng._graphs.graphs)) == [(256, "custom"), (256, "uniform")]
    # a greedy engine: the uniform step's graphs give the eager route's tokens
    _, tparams = models
    reqs = [(p, 9, None) for p in _prompts(3, (3, 11, 6))]
    greedy = {route: _port(tparams, dict(max_slots=2, max_len=64), "f32", route)
              for route in ("eager", "graphs")}
    outs = {route: _runs(eng, [({}, reqs)], Request, SamplingParams) for route, eng in
            greedy.items()}
    assert outs["graphs"] == outs["eager"]
    assert _steps(greedy["graphs"]._graphs.captured) == [(64, "uniform")]


def test_warmup_captures_the_ladder_at_the_last_bucket(models):
    """Growth drops the smaller buckets' graphs, so warmup ends with a step
    of each kind at the last bucket: live traffic then captures nothing."""
    _, tparams = models
    eng = _port(tparams, dict(max_slots=2, max_len=128, spec_decode=True), "f32", "graphs")
    eng.warmup(prompt_len=16)
    assert eng._cache_len() == 128
    kept = set(_steps(eng._graphs.graphs))
    assert {(128, "verify", k) for k in eng.spec_k_ladder} | {(128, "uniform"),
                                                              (128, "custom")} == kept
    n = len(eng._graphs.captured)
    eng.run([Request(prompt_tokens=p, max_new_tokens=12) for p in PERIODIC]
            + [Request(prompt_tokens=[3, 4], max_new_tokens=9,
                       sampling=SamplingParams(temperature=0.0))])
    assert len(eng._graphs.captured) == n


def test_graph_table_replays_add_the_captured_deltas():
    """The table alone on a toy step: first use eager, then a capture whose
    counts are set back, then replays that add them."""
    counter = types.SimpleNamespace(launches=0)
    ran = []

    def body():
        counter.launches += 3
        ran.append(1)

    graphs = []

    class Graph:
        def __init__(self):
            self.replays = 0
            graphs.append(self)

        def replay(self):
            self.replays += 1

    table = engine_mod._GraphTable(Graph, lambda g, b: b(), counters=((counter, "launches"),))
    table.run((64, "uniform"), body)
    assert counter.launches == 3 and len(ran) == 2 and table.captured == [(64, "uniform")]
    assert table.graphs[(64, "uniform")][1] == (3,)
    for _ in range(4):
        table.run((64, "uniform"), body)
    assert counter.launches == 15 and len(ran) == 2 and graphs[0].replays == 4
    table.run((128, "uniform"), body)
    table.drop(64)
    assert list(table.graphs) == [(128, "uniform")] and table.replays == 4


def test_graphs_true_raises_on_the_cpu_and_under_a_mesh(models):
    _, tparams = models
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        Engine(tparams, TCFG, max_slots=2, max_len=64, device="cpu", graphs=True)
    # a mesh takes the graph route on the card too: on the CPU it raises alike
    mesh = types.SimpleNamespace(dp=2, tp=1, dp_rank=0)
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        Engine(tparams, TCFG, max_slots=2, max_len=64, device="cpu", mesh=mesh, graphs=True)
    for graphs in (None, False):
        assert Engine(tparams, TCFG, max_slots=2, max_len=64, device="cpu",
                      graphs=graphs).route == "eager"


def test_a_horizon_beyond_the_output_rows_raises(models):
    _, tparams = models
    eng = Engine(tparams, TCFG, max_slots=2, max_len=64, device="cpu", decode_horizon=4)
    with pytest.raises(ValueError, match="decode_horizon = 4"):
        eng._decode(8, custom=False)
