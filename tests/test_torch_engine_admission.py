"""The engine's admission over fixed buffers (the port's counterpart of the
JAX engine's jitted `_prefill`, `_insert`, `_admit_commit` and memoized tail
prefill), on the CPU against the JAX package's `Engine` on a packed
int2-g64 f32 TINY_TEST: greedy tokens equal on an f32 cache through growth
(a prefill that grows the cache, mid-run admissions) and on a bf16 cache
through exact and prefix prompt-cache hits; a sampled custom group on the
eager route and the graph route alike. The graph route runs with a stand-in
for `torch.cuda.CUDAGraph` whose replay runs the body stored at capture
and writes what it returns into the tensors the capture returned: a host
value baked into a captured body shows up as wrong tokens at the second
use of its key, which every scenario makes with other prompts into other
slots (`with_stand_in` of tests/test_torch_engine_graphs.py). The JAX
engines run once for the module."""

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
from bitdistiller_tpu_torch.serve import engine as engine_mod
from test_torch_engine_graphs import with_stand_in
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, CFG.vocab_size, n).tolist() for n in lens]


_G = _prompts(0, (12, 30, 9, 14, 130))
_PFX = _prompts(1, (40,))[0]
_TAILS = _prompts(2, (10, 12, 25))
# name: (engine keywords, KV cache, runs); a run is a list of requests
# (prompt, new tokens, cache_prompt), run in order on each engine
SCENARIOS = {
    # growth: X (30 tokens, 40 new: the cache grows to 128 in its decode) and
    # Y share a group (nb 2), Y finishes and Z takes its slot
    # (a group of 1 into slot 1); U then takes the same keys into slot 0; the
    # 130-token W prefills at bucket 256 and grows the cache to 256 first
    "f32_growth": (dict(max_slots=2, max_len=256, decode_horizon=2), "f32",
                   [[(_G[1], 40, False), (_G[0], 3, False), (_G[2], 5, False)],
                    [(_G[3], 6, False)],
                    [(_G[4], 5, False)]]),
    # the prompt cache: P stored, then an exact hit beside a prefix hit (a
    # group of 2: two staged inserts), then another prefix hit at the same
    # tail prefill key with another tail, and a 25-token tail (bucket 32)
    "bf16_prompt_cache": (dict(max_slots=2, max_len=256, decode_horizon=2, prompt_cache_size=4),
                          "bf16",
                          [[(_PFX, 3, True)],
                           [(_PFX, 4, False), (_PFX + _TAILS[0], 5, True)],
                           [(_PFX + _TAILS[1], 4, False), (_PFX + _TAILS[2], 3, False)]]),
}


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


def _pieces(keys):
    """The admission's keys of a graph table's keys, in order."""
    return [k for k in keys if engine_mod.piece(k) in engine_mod.ADMISSION_PIECES]


def _run_all(eng, runs, request_cls) -> list:
    out = []
    for run in runs:
        reqs = [request_cls(prompt_tokens=list(p), max_new_tokens=n, cache_prompt=c)
                for p, n, c in run]
        eng.run(reqs)
        out.append([r.output_tokens for r in reqs])
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    jparams, _ = models
    out = {}
    for name, (kw, cache, runs) in SCENARIOS.items():
        eng = JaxEngine(jparams, CFG, eos_token_id=None, cache_dtype=CACHES[cache][0],
                        sampling=JaxSampling(temperature=0.0), **kw)
        out[name] = _run_all(eng, runs, JaxRequest)
    return out


def _port(tparams, kw, cache, route, sampling=SamplingParams(temperature=0.0)):
    eng = Engine(tparams, TCFG, eos_token_id=None, cache_dtype=CACHES[cache][1], device="cpu",
                 sampling=sampling, **kw)
    return with_stand_in(eng) if route == "graphs" else eng


@pytest.fixture(scope="module")
def port_runs(models):
    _, tparams = models
    out = {}
    for route in ("eager", "graphs"):
        for name, (kw, cache, runs) in SCENARIOS.items():
            eng = _port(tparams, kw, cache, route)
            out[route, name] = eng, _run_all(eng, runs, Request)
    return out


@pytest.mark.parametrize("route", ["eager", "graphs"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_admission_equals_jax(jax_runs, port_runs, route, name):
    """Greedy tokens equal the JAX engine's on both routes, every request
    with its budget."""
    outs = port_runs[route, name][1]
    assert outs == jax_runs[name]
    assert [[len(o) for o in run] for run in outs] == [[n for _, n, _ in run]
                                                       for run in SCENARIOS[name][2]]


def test_admission_keys_replays_and_drops(port_runs):
    """The growth scenario's admission pieces by key: the first use of each
    captured, the second use of the group-of-1 keys (U into slot 0 after Z
    into slot 1) replayed, and growth dropping the insert graphs of the
    caches it replaced while prefill and commit graphs stay."""
    eng = port_runs["graphs", "f32_growth"][0]
    table = eng._graphs
    assert eng.growths == [(64, 128), (128, 256)]
    assert _pieces(table.captured) == [
        ("prefill", 64, 2), (64, "insert", "prefill", 64, 2, 2), ("commit", 2, False),
        ("prefill", 64, 1), (64, "insert", "prefill", 64, 1, 1), ("commit", 1, False),
        (128, "insert", "prefill", 64, 1, 1),
        ("prefill", 256, 1), (256, "insert", "prefill", 256, 1, 1)]
    assert set(_pieces(table.graphs)) == {("prefill", 64, 2), ("commit", 2, False),
                                          ("prefill", 64, 1), ("commit", 1, False),
                                          ("prefill", 256, 1), (256, "insert", "prefill", 256, 1, 1)}
    # U replayed the group-of-1 prefill and commit, W the commit
    assert table.count(engine_mod.ADMISSION_PIECES) == (9, 3)
    # a prefill's graph counts as one prefill's launches, and nothing else does
    prefill_calls = {k: d for k, (_, d, _) in table.graphs.items() if k[0] == "prefill"}
    assert all(sum(d) == 0 for d in prefill_calls.values())  # the CPU launches no kernel
    assert eng.prefills == 4


def test_prompt_cache_pieces_by_key(port_runs):
    """Exact hits insert from the staging of the stored rows, prefix hits
    replay the tail prefill of (entry bucket, tail bucket, temporary cache
    length): the second prefix hit at (64, 16, 64) replays it with another
    tail, the 25-token tail takes bucket 32 and a temporary cache of 128."""
    eng = port_runs["graphs", "bf16_prompt_cache"][0]
    table = eng._graphs
    extends = [k for k in table.captured if k[0] == "extend"]
    assert extends == [("extend", 64, 16, 64), ("extend", 64, 32, 128)]
    assert eng.prefix_extends == [16, 16, 32]
    stage_inserts = [k for k in table.captured if k[1:3] == ("insert", "stage")]
    assert stage_inserts == [(64, "insert", "stage", 1, 64, 1), (128, "insert", "stage", 1, 128, 1)]
    assert eng.prompt_cache_prefix_hits == 3 and eng.prompt_cache_hits == 4
    assert table.count(engine_mod.ADMISSION_PIECES)[1] >= 2


def test_sampled_custom_group_graphs_equal_eager(models):
    """A custom group of 3 in slots 0-2 (its commit padded to 4: every row
    sampled on both routes) and then one of 4 at the same keys with other
    prompts, its custom rows in slots 0, 2 and 3: the replayed admissions
    draw what the eager ones draw."""
    _, tparams = models
    kw = dict(max_slots=4, max_len=128, decode_horizon=2, seed=3)
    runs = [[(p, 8, s) for p, s in zip(_prompts(5, (7, 9, 11)), ("a", None, "greedy"))],
            [(p, 8, s) for p, s in zip(_prompts(6, (20, 12, 5, 3)), ("a", None, "a", "a"))]]
    custom = {"a": SamplingParams(temperature=0.9, top_p=0.8, top_k=20), "greedy":
              SamplingParams(temperature=0.0), None: None}
    outs = {}
    for route in ("eager", "graphs"):
        eng = _port(tparams, kw, "f32", route, sampling=SamplingParams(temperature=0.8, top_p=0.9))
        got = []
        for run in runs:
            reqs = [Request(prompt_tokens=list(p), max_new_tokens=n, sampling=custom[s])
                    for p, n, s in run]
            eng.run(reqs)
            got.append([r.output_tokens for r in reqs])
        outs[route] = (got, eng)
    assert outs["graphs"][0] == outs["eager"][0]
    table = outs["graphs"][1]._graphs
    assert ("commit", 4, True) in table.captured
    assert table.count(engine_mod.ADMISSION_PIECES)[1] >= 2


def test_set_rows_drops_the_out_of_range_index():
    buf = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    engine_mod._set_rows(buf, torch.tensor([2, 4, 0, 4]),
                         torch.tensor([[9, 9], [7, 7], [5, 5], [6, 6]]))
    assert buf.tolist() == [[5, 5], [2, 3], [9, 9], [6, 7]]


def test_warmup_captures_the_admission_keys(models):
    """Warmup admits every power-of-two group at the prompt length, before
    and after the growth walk: a live greedy request of that length then
    captures no admission piece (nor a step)."""
    _, tparams = models
    eng = _port(tparams, dict(max_slots=2, max_len=128), "f32", "graphs")
    eng.warmup(prompt_len=16)
    assert eng._cache_len() == 128
    kept = set(eng._graphs.graphs)
    for nb in (1, 2):
        assert {("prefill", 64, nb), (128, "insert", "prefill", 64, nb, nb),
                ("commit", nb, False), ("commit", nb, True)} <= kept
    n = len(eng._graphs.captured)
    eng.run([Request(prompt_tokens=list(range(5, 21)), max_new_tokens=9)])
    assert len(eng._graphs.captured) == n


def test_prefills_past_graph_rows_run_eagerly(models, jax_runs, monkeypatch):
    """With GRAPH_ROWS at 64, the growth scenario's group of 2 at bucket 64
    (128 rows) and W's 256-row prefill run eagerly on the graph route, with
    their inserts, and the tokens stay JAX's; the group-of-1 prefill at 64
    rows writes the engine-owned rows, 64 of them, and its graph keeps only
    its last logits."""
    _, tparams = models
    monkeypatch.setattr(engine_mod, "GRAPH_ROWS", 64)
    kw, cache, runs = SCENARIOS["f32_growth"]
    eng = _port(tparams, kw, cache, "graphs")
    assert _run_all(eng, runs, Request) == jax_runs["f32_growth"]
    prefills = [k for k in eng._graphs.captured if engine_mod.piece(k) in ("prefill", "insert")]
    assert prefills == [("prefill", 64, 1), (64, "insert", "prefill", 64, 1, 1),
                        (128, "insert", "prefill", 64, 1, 1)]
    assert eng.prefills == 4
    per_row = TCFG.num_layers * TCFG.num_kv_heads * TCFG.actual_head_dim
    assert [b.numel() for b in eng._rows] == [64 * per_row] * 2
    outs = eng._graphs.graphs["prefill", 64, 1][2]
    assert [tuple(t.shape) for t in outs] == [(1, TCFG.vocab_size)]
