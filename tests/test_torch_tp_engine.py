"""The port's engine over a (dp, tp) mesh (`Engine(..., mesh=)`) on spawned
gloo ranks (tests/torch_tp_worker.py:engine_job), one spawn at tp = 2 and
one at dp 2 x tp 2, every case in each: the counterparts of the JAX
package's tests/test_sharded_engine.py (matches unsharded, int8 cache,
behind HTTP with the requests joining the running loop, prompt cache,
speculative decoding) and of tests/test_multihost.py's two-process engine
(5 requests over 4 slots, here with a prompt long enough to grow the
cache).

The tiny f32 config, packed int4-g64 unfused by the JAX package and handed
over as numpy; each rank holds its `shard_packed_model` slice. At greedy
every rank's streams equal the JAX package's UNSHARDED engine's token for
token (f32, int8 and bf16 caches), as JAX's own sharded test demands;
sampled at temperature 0.8 from a seed, every rank's streams equal each
other's. `stop_check` verdicts are rank 0's on every rank. A max_slots
that dp does not divide is refused. The A8 engine's repack of a rank's
slice is the slice of a whole-leaf repack.

Each case also runs on the graph route, in the same spawn, with the
segmented stand-in of tests/torch_tp_worker.py (`segmented_stand_in`: the
engine's table and chains, a capture through `distributed.segmented` that
issues no operation, a replay that runs the body segment by segment with
each recorded operation issued between two and checked against the live
call): its streams equal JAX's unsharded ones and the eager route's on
every rank, token for token, and its launch counters move as the eager
route's. Each key has the segments worked out from the code
(`predicted_segments`: 2L + 4 a step at tp = 2, 2L + 3 a prefill, 2 a
commit, 1 an insert; one a step at dp = 2, tp = 1; the ring's 3 (tp - 1)
operations a matmul), growth drops the rank's keys of the cache it
replaced, and after `warmup()` live traffic captures nothing."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import Request as JaxRequest
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.ops.quant_matmul import quant_matmul_a8, repack_linear_a8
from bitdistiller_tpu_torch.parallel.mesh import (Mesh, packed_param_specs, shard_packed_model,
                                                  take)
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.serve import engine as engine_mod
from test_torch_dp_worker import spawn
from torch_port_util import to_numpy_tree, torch_cfg
from torch_tp_worker import predicted_segments

JCFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(JCFG)
PROMPTS = [[3, 5, 7], [11, 13, 17, 19], [2, 4, 6, 8, 10], [9, 9, 9]]
# 5 requests over 4 slots; the last prompt's 45 + 24 tokens grow the cache past 64
PROMPTS5 = PROMPTS + [list(range(3, 48))]
SPEC_PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 2, 9, 2, 9]]
CACHED = [3, 5, 7, 2]
STOP_TOKEN = 197  # a token of the greedy streams of PROMPTS5 (checked below)
MESHES = {"tp2": (2, 2), "dp2_tp2": (4, 2)}  # world, tp


@pytest.fixture(scope="module")
def jpacked():
    params = init_params(JCFG, jax.random.key(0), dtype=jnp.float32)
    return pack_model(params, JCFG, bits=4, group_size=64, fuse=False)


class _Worlds(dict):
    """Each mesh's ranks' results, waited for at first use: the worlds run
    at once, beside the JAX engines that `want` builds meanwhile."""

    def __getitem__(self, name):
        return super().__getitem__(name).result()


@pytest.fixture(scope="module")
def ranks(jpacked):
    packed = params_from_numpy(to_numpy_tree(jpacked), "cpu")
    job = {"kind": "call", "target": "torch_tp_worker:engine_job", "cfg": TCFG,
           "packed": packed, "prompts": PROMPTS, "prompts5": PROMPTS5,
           "spec_prompts": SPEC_PROMPTS, "cached_prompt": CACHED, "stop_token": STOP_TOKEN}
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        yield _Worlds({name: pool.submit(spawn, dict(job, tp=tp), world=world)
                       for name, (world, tp) in MESHES.items()})


def _jax(jpacked, dtype=jnp.float32, max_len=32):
    return JaxEngine(jpacked, JCFG, max_slots=4, max_len=max_len,
                     sampling=JaxSampling(temperature=0.0), eos_token_id=None, cache_dtype=dtype)


@pytest.fixture(scope="module")
def want(jpacked):
    """The JAX package's unsharded greedy streams of each case (the f32
    cases through one engine: its slots and cache start clean each run)."""
    jeng = _jax(jpacked)
    r = JaxRequest(prompt_tokens=CACHED, max_new_tokens=6)
    jeng.run([r])
    warm = [JaxRequest(prompt_tokens=p, max_new_tokens=12) for p in SPEC_PROMPTS]
    warm.append(JaxRequest(prompt_tokens=[3, 4], max_new_tokens=9))
    _jax(jpacked, max_len=64).run(warm)
    return {"f32": jeng.generate(PROMPTS, 6), "http": jeng.generate(PROMPTS[:2], 6),
            "cached": r.output_tokens, "spec": jeng.generate(SPEC_PROMPTS, 10),
            "int8": _jax(jpacked, jnp.int8).generate(PROMPTS, 6),
            "growth": _jax(jpacked, jnp.bfloat16, max_len=128).generate(PROMPTS5, 24),
            "warm": [w.output_tokens for w in warm]}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", ["f32", "int8", "http", "growth"])
def test_sharded_streams_equal_jax_unsharded(ranks, want, mesh, case):
    """Every rank returns the same greedy streams, JAX's unsharded engine's."""
    for out in ranks[mesh]:
        assert out[case] == want[case], (out["mesh"], out[case], want[case])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_cache_is_the_rank_slice(ranks, mesh):
    """Each rank's cache holds max_slots / dp slots and Hkv / tp heads (the
    int8 scales alike), and the 45-token prompt grew it 64 -> 128 rows."""
    world, tp = MESHES[mesh]
    dp = world // tp
    for out in ranks[mesh]:
        assert out["mesh"][:2] == (dp, tp)
        l, b, h, t, d = out["f32_cache_shape"]
        assert (l, b, h, d) == (JCFG.num_layers, 4 // dp, JCFG.num_kv_heads // tp,
                                JCFG.head_dim or JCFG.hidden_size // JCFG.num_heads)
        assert out["int8_scale_shape"][1:3] == (4 // dp, JCFG.num_kv_heads // tp)
        assert out["growths"] == [(64, 128)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_prompt_cache_and_spec_decode(ranks, want, mesh):
    """A prompt-cache hit re-inserts the stored rows into each rank's slice
    (one hit, the fresh path's stream); speculative decoding equals plain
    decoding and JAX's unsharded plain streams."""
    for out in ranks[mesh]:
        r1, r2, hits = out["prompt_cache"]
        assert hits == 1 and r1 == r2 == want["cached"]
        assert out["spec"][True] == out["spec"][False] == want["spec"]
        assert out["spec_rounds"] > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sampled_streams_equal_on_every_rank(ranks, mesh):
    outs = [out["sampled"] for out in ranks[mesh]]
    assert all(o == outs[0] for o in outs)
    assert all(len(s) == 24 for s in outs[0])
    assert outs[0] != ranks[mesh][0]["growth"]  # sampled, not greedy


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_stop_check_verdicts_are_rank0s(ranks, want, jpacked, mesh):
    """Rank 0's stop_check fires on STOP_TOKEN, the other ranks' never
    would: every rank ends each request where rank 0 did, as the port's
    unsharded engine with rank 0's check."""
    assert any(STOP_TOKEN in s for s in want["growth"])
    ref = Engine(params_from_numpy(to_numpy_tree(jpacked), "cpu"), TCFG, max_slots=4,
                 max_len=128, sampling=SamplingParams(temperature=0.0), eos_token_id=None,
                 cache_dtype=torch.float32, device="cpu")
    reqs = [Request(prompt_tokens=p, max_new_tokens=24,
                    stop_check=lambda toks: STOP_TOKEN in toks) for p in PROMPTS5]
    ref.run(reqs)
    expected = [(r.output_tokens, r.finish_reason) for r in reqs]
    assert any(reason == "stop" for _, reason in expected)
    for out in ranks[mesh]:
        assert out["stop_check"] == expected


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", ["f32", "int8", "http", "growth"])
def test_graph_route_streams_equal_jax_and_eager(ranks, want, mesh, case):
    """The graph route (the segmented stand-in) gives JAX's unsharded greedy
    streams and the eager route's, token for token, on every rank."""
    for out in ranks[mesh]:
        assert out["graphs"][case] == out[case] == want[case], out["mesh"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_route_prompt_cache_spec_and_sampled(ranks, want, mesh):
    """A prompt-cache hit, a stored prompt's tail prefill, speculative
    decoding and sampled streams on the graph route: equal to the eager
    route's on every rank (sampled: the generator draws alike)."""
    sampled = [out["graphs"]["sampled"] for out in ranks[mesh]]
    assert all(s == sampled[0] for s in sampled)
    for out in ranks[mesh]:
        g = out["graphs"]
        r1, r2, hits = g["prompt_cache"]
        assert hits == 1 and r1 == r2 == want["cached"]
        assert g["prompt_extend"] == out["prompt_extend"] and g["prompt_extend"][1] == 1
        assert g["spec"][True] == g["spec"][False] == want["spec"]
        assert g["spec_rounds"] == out["spec_rounds"] > 0
        assert g["sampled"] == out["sampled"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_route_launch_counters_equal_eager(ranks, mesh):
    """Every launch counter moves on the graph route as on the eager route
    over the same cases: a capture's calls are set back, a replay adds its
    key's."""
    for out in ranks[mesh]:
        assert out["graphs"]["counters"] == out["counters"]
        assert any(out["counters"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_route_segments_by_key(ranks, mesh):
    """Every key the engines hold has the segments worked out from the
    code, each piece's kind among them, and every kind replayed."""
    _, tp = MESHES[mesh]
    L = JCFG.num_layers
    for out in ranks[mesh]:
        kinds, replays = set(), 0
        for name, t in out["graphs"]["tables"].items():
            for key, n in t["segments"].items():
                assert n == predicted_segments(engine_mod.piece(key), L, tp), (name, key, n)
                kinds.add(engine_mod.piece(key))
            replays += t["replays"]
        assert kinds == {"prefill", "insert", "commit", "extend", "uniform", "verify"}
        assert replays > 0
        for key, n in out["warmup"]["segments"].items():
            assert n == predicted_segments(engine_mod.piece(key), L, tp), key


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_route_growth_drops_the_rank_keys(ranks, mesh):
    """Growth (64 -> 128 rows) drops the step and insert chains of the
    cache it replaced on every rank; prefill and commit chains stay."""
    for out in ranks[mesh]:
        t = out["graphs"]["tables"]["growth"]
        old = [k for k in t["captured"] if k[0] == 64]
        assert {engine_mod.piece(k) for k in old} >= {"uniform"}
        assert not set(old) & set(t["segments"])
        assert {k[0] for k in t["segments"] if not isinstance(k[0], str)} == {128}
        assert {"prefill", "commit"} <= {engine_mod.piece(k) for k in t["segments"]}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_route_warmup_captures_every_kind(ranks, want, mesh):
    """warmup() over the mesh captures every kind of key, the custom step
    and each k's verify included; live requests after it (speculative and
    a per-request greedy override) capture nothing and give JAX's
    unsharded streams."""
    for out in ranks[mesh]:
        w = out["warmup"]
        assert w["after"] == w["captured"] > 0
        kinds = {engine_mod.piece(k) for k in w["segments"]}
        assert kinds == {"prefill", "insert", "commit", "uniform", "custom", "verify"}
        assert {k[2] for k in w["segments"] if engine_mod.piece(k) == "verify"} == set(
            engine_mod.SPEC_K_LADDER)
        assert w["streams"] == want["warm"]


def test_graph_route_ring_and_dp_only(ranks):
    """Under BITDISTILLER_RING_TP=1 (tp = 2) the chains hold the ring's
    operations and the streams equal the eager ring's; over the same two
    ranks as dp = 2, tp = 1 a step is one segment, and the streams equal
    the eager route's and JAX's."""
    L = JCFG.num_layers
    for out in ranks["tp2"]:
        assert out["ring"]["graphs"] == out["ring"]["eager"]
        for key, n in out["ring_segments"].items():
            assert n == predicted_segments(engine_mod.piece(key), L, 2, ring=True), key
        assert out["dp_only"]["graphs"] == out["dp_only"]["eager"]
        for key, n in out["dp_only_segments"].items():
            assert n == predicted_segments(engine_mod.piece(key), L, 1), key
    assert ranks["tp2"][0]["dp_only"]["eager"] == ranks["tp2"][0]["f32"]


def test_max_slots_not_a_multiple_of_dp_is_refused(ranks):
    for out in ranks["dp2_tp2"]:
        assert "max_slots = 3" in out["uneven_slots"] and "dp = 2" in out["uneven_slots"]
    for out in ranks["tp2"]:  # dp = 1 divides anything
        assert out["uneven_slots"] is None


@pytest.mark.parametrize("tp_rank", [0, 1])
def test_a8_repack_of_a_rank_slice_is_the_slice_of_the_repack(jpacked, tp_rank):
    """The A8 engine repacks after sharding (`shard_packed_model` refuses
    A8-ordered words): a rank's repacked slice holds the words a whole-leaf
    repack holds there, row-parallel K slices (whole groups, in the K-word
    order) and column-parallel N slices alike, and its A8 matmul is the
    slice's."""
    whole = params_from_numpy(to_numpy_tree(jpacked), "cpu")
    mesh = Mesh(dp=1, tp=2, tp_rank=tp_rank)
    local = shard_packed_model(whole, mesh, TCFG)
    specs = packed_param_specs(TCFG)["layers"]
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        mine = repack_linear_a8(local["layers"][name])
        want = take(repack_linear_a8(whole["layers"][name]).qweight, specs[name], mesh)
        assert mine.a8_order and torch.equal(mine.qweight, want), name
    o = whole["layers"]["o"]
    x = torch.randn(3, o.in_features, generator=torch.Generator().manual_seed(0))
    kl = o.in_features // 2
    mine = repack_linear_a8(local["layers"]["o"])
    got = quant_matmul_a8(x[:, tp_rank * kl:(tp_rank + 1) * kl], mine, 1)
    ref = quant_matmul_a8(x[:, tp_rank * kl:(tp_rank + 1) * kl], local["layers"]["o"], 1)
    assert torch.equal(got, ref)
