"""Rank jobs of the port's tensor-parallel tests (tests/test_torch_tp_*.py),
run through `test_torch_dp_worker.spawn({"kind": "call", "target":
"torch_tp_worker:<job>", ...})`: each is fn(rank, world, job) in a spawned
gloo rank. The module holds no tests and imports no JAX (a spawned child
that imported the JAX package would start JAX without the suite's CPU
settings)."""

import functools
import threading

import torch
import torch.distributed as dist

from bitdistiller_tpu_torch.models import KVCache, llama
from bitdistiller_tpu_torch.models.quantized import pack_model
from bitdistiller_tpu_torch.parallel import distributed, zero
from bitdistiller_tpu_torch.parallel.mesh import (make_mesh, param_specs, shard_packed_model,
                                                  shard_params)
from bitdistiller_tpu_torch.parallel.tensor import tp_config
from bitdistiller_tpu_torch.serve import engine as engine_mod
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as ttr
from test_torch_dp_worker import train

CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def decode_run(packed, cfg, mesh=None, cache_dtype=torch.bfloat16, attn_len=None):
    """A packed prefill of 4 tokens into an empty cache of 16 rows, then one
    decode step a slot at per-slot positions 4 and 3 (the decode attention's
    route; `attn_len` buckets its read): (prefill logits, step logits, the
    cache's k after the step)."""
    lcfg = cfg if mesh is None else tp_config(cfg, mesh.tp)
    cache = KVCache.init(lcfg, 2, 16, dtype=cache_dtype, device="cpu")
    toks = torch.arange(8, dtype=torch.int64).reshape(2, 4)
    with torch.no_grad():
        pre, _ = llama.forward(packed, cfg, toks, cache=cache, cache_pos=0, mesh=mesh)
        step, cache = llama.forward(packed, cfg, torch.tensor([[5], [7]]), cache=cache,
                                    cache_pos=torch.tensor([4, 3], dtype=torch.int32),
                                    attn_len=attn_len, mesh=mesh)
    return pre, step, cache.k.to(torch.float32)


def dense_grads(params, cfg, tokens, mesh=None, remat=False):
    """The dense forward's logits, and the gradients of every leaf of
    sum(logits * w) for a fixed w (the backward through every collective)."""
    p = ttr.tree_map(lambda x: x.detach().requires_grad_(True), params)
    logits, _ = llama.forward(p, cfg, tokens, mesh=mesh, remat=remat)
    w = torch.linspace(-1, 1, logits.numel(), dtype=logits.dtype).reshape(logits.shape)
    grads = ttr._grads((logits * w).sum(), p)
    return logits.detach(), {"/".join(k): g for k, g in ttr.tree_items(grads)}


def forward_job(rank, world, job):
    """The dense forward and its gradients on this rank's tp slice (with and
    without remat), and the packed unfused decode over each cache dtype."""
    mesh = make_mesh(tp=job["tp"])
    cfg, params = job["cfg"], job["params"]
    local = shard_params(params, mesh, param_specs(cfg))
    out = {"dense": dense_grads(local, cfg, job["tokens"], mesh),
           "remat": dense_grads(local, cfg, job["tokens"], mesh, remat="save_dots")[1]}
    packed = shard_packed_model(pack_model(params, cfg, bits=4, group_size=64, fuse=False),
                                mesh, cfg)
    out["packed"] = {name: decode_run(packed, cfg, mesh, dt) for name, dt in CACHE_DTYPES.items()}
    out["packed_attn_len"] = decode_run(packed, cfg, mesh, attn_len=8)[1]
    out["families"] = {name: dense_grads(shard_params(p, mesh, param_specs(c)), c, tok, mesh)
                       for name, (c, p, tok) in job.get("families", {}).items()}
    return out


def _counting():
    """Patch every collective the train state's I/O could issue; returns the
    counter and an undo."""
    counts: dict = {}
    saved = []

    def wrap(owner, name):
        fn = getattr(owner, name)

        def counted(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)

        saved.append((owner, name, fn))
        setattr(owner, name, counted)

    for name in ("all_gather", "all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
                 "broadcast", "gather", "barrier", "all_gather_object", "broadcast_object_list"):
        wrap(dist, name)
    for name in ("_all_gather", "_reduce_scatter"):
        wrap(zero, name)

    def undo():
        for owner, name, fn in saved:
            setattr(owner, name, fn)

    return counts, undo


def checkpoint_job(rank, world, job):
    """Train `job["batches"]` on the mesh (dp = world / tp), then save with
    every collective counted; or restore `job["resume"]` and train on."""
    mesh = make_mesh(tp=job["tp"])
    if job.get("resume"):
        return train(job["params"], job["cfg"], job["tc"], job["batches"], stage=job["stage"],
                     resume=job["resume"], mesh=mesh)
    out = train(job["params"], job["cfg"], job["tc"], job["batches"], stage=job["stage"],
                mesh=mesh, keep_state=True)
    counts, undo = _counting()
    try:
        pipeline.save_checkpoint(job["save"], job["save_step"], out.pop("state"))
    finally:
        undo()
    out["save_collectives"] = counts
    return out


class SmallTok:
    """A byte tokenizer inside a tiny model's 128 ids (3..122)."""

    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 120) + 3 for c in s][:64]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


def cli_train_job(rank, world, job):
    """`cli train` joining the group from its flags (gloo on the CPU)."""
    from bitdistiller_tpu_torch import cli

    cli._load_tokenizer = lambda path: SmallTok()
    argv = job["argv"] + ["--coordinator_address", f"127.0.0.1:{job['port']}",
                          "--num_processes", str(world), "--process_id", str(rank)]
    summary = cli.main(argv)
    return {"final_loss": summary["final_loss"], "steps": summary["steps"],
            "beta": summary["beta"], "master": {"/".join(p): x for p, x in
                                                ttr.tree_items(summary["master"])}}


def dryrun_job(rank, world, job):
    """The dry run's steps on this rank (the script's `_rank`, in process)."""
    from bitdistiller_tpu_torch.parallel.distributed import init_distributed
    from bitdistiller_tpu_torch.scripts.dryrun_multichip import dryrun

    init_distributed(f"127.0.0.1:{job['port']}", world, rank, device="cpu")
    return dryrun(torch.device("cpu"))



# ---- tensor-parallel serving (tests/test_torch_tp_engine.py) ---------------

class IdTok:
    """Tokens as space-separated ids (the JAX package's sharded HTTP test's)."""

    def encode(self, s):
        return [int(t) for t in s.split()]

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)


def _http_generate(eng, prompts, new):
    """Rank 0: the frontend over the sharded engine, the prompts sent
    concurrently (each joins the running loop through the feeder); every
    other rank follows rank 0's loop. Each rank returns the streams it
    served, in the prompts' order (rank 0: the responses' tokens)."""
    import json
    import threading
    import urllib.request

    from bitdistiller_tpu_torch.serve.server import ServingFrontend, follow

    if dist.get_rank() != 0:
        served = {tuple(r.prompt_tokens): r.output_tokens for r in follow(eng)}
        return [served[tuple(p)] for p in prompts]
    front = ServingFrontend(eng, IdTok(), port=0)
    loop = threading.Thread(target=front.serve_forever)
    loop.start()
    results = {}
    try:
        host, port = front.address

        def hit(i, prompt):
            body = json.dumps({"prompt": " ".join(map(str, prompt)), "max_new_tokens": new,
                               "temperature": 0.0}).encode()
            req = urllib.request.Request(f"http://{host}:{port}/generate", body,
                                         {"Content-Type": "application/json"})
            results[i] = json.load(urllib.request.urlopen(req, timeout=60))["tokens"]

        clients = [threading.Thread(target=hit, args=(i, p)) for i, p in enumerate(prompts)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
    finally:
        front.shutdown()
        loop.join(timeout=60)
    assert not loop.is_alive()
    return [results[i] for i in range(len(prompts))]


# ---- the graph route's stand-in under a mesh (tests/test_torch_tp_*.py) -----

def predicted_segments(piece: str, layers: int, tp: int, ring: bool = False) -> int:
    """Segments of one key of a Llama engine over a mesh, from the code: a
    step or verify round reaches the embedding's all-reduce, o's and down's
    in each layer (a ring matmul each under BITDISTILLER_RING_TP=1: 3 (tp -
    1) hops' operations, parallel/overlap.py), the logits' all-gather and
    the tokens' broadcast over tp; a prefill or tail prefill all but the broadcast; a
    commit the first tokens' broadcast from global rank 0; an insert
    nothing. A chain has one segment more than its operations."""
    if piece == "insert":
        return 1
    if piece == "commit":
        return 2
    if tp == 1:
        return 1
    per = 3 * (tp - 1) if ring else 1
    ops = 2 + 2 * layers * per + (piece in ("uniform", "custom", "verify"))
    return ops + 1


def _engine_state(eng) -> list:
    """Every tensor a step or an admission piece writes."""
    c = eng.cache
    out = [c.k, c.v, eng.cur_tokens, eng._pos, eng._lengths_dev, eng._active_dev,
           eng.prev_tokens, eng.history, eng._hz_step, eng._hz_tokens, eng._temps, eng._top_ks,
           eng._top_ps, eng._rep_pens]
    out += [t for t in (c.k_scale, c.v_scale) if t is not None]
    out += list(eng._staged.values()) + list(eng._rows or ())
    return out + [t for pair in eng._hz_verify.values() for t in pair]


def signature(op) -> tuple:
    """A recorded operation as a replay checks it: (kind, the group's global
    ranks or "world", then (shape, dtype) of each tensor read and each
    written)."""
    ranks = "world" if op.group is None else tuple(dist.get_process_group_ranks(op.group))
    return (op.kind, ranks) + tuple((tuple(t.shape), t.dtype) for t in op.reads + op.writes)


class _Segment:
    """A stand-in segment: its replay runs the piece's code from the
    operation before it to the one after it (`_Replayer`)."""

    def __init__(self, replayer, index):
        self.replayer, self.index = replayer, index

    def replay(self):
        self.replayer.segment(self.index)


class _Replayer:
    """One key's segments on the CPU. Segment 0's replay starts the piece's
    body in a thread of its own, with the launch counters held (a replay
    calls no wrapper); at each operation the thread checks the live call
    against the one recorded at capture (kind, group, shape and dtype of
    each tensor), copies what it reads into the recorded operation's
    tensors and stops, and the chain issues the recorded operation; the
    next segment's replay copies what that wrote into the live tensors and
    runs the body on to the next operation. The last one's end writes the
    body's outputs into the key's (a graph's outputs)."""

    def __init__(self, body):
        self.body, self.ops, self.n, self.outs = body, [], 0, None

    def new_segment(self) -> _Segment:
        self.n += 1
        return _Segment(self, self.n - 1)

    def segment(self, i: int) -> None:
        held = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
        if i == 0:
            self.at, self.error, self.result, self.done = 0, None, None, False
            self.to_main, self.to_body = threading.Semaphore(0), threading.Semaphore(0)
            threading.Thread(target=self._run, args=(torch.get_num_threads(),),
                             daemon=True).start()
        else:
            self.to_body.release()
        self.to_main.acquire()
        for (o, a), v in zip(engine_mod.LAUNCH_COUNTERS, held):
            setattr(o, a, v)
        if self.error is not None:
            raise self.error
        if self.done != (i == self.n - 1):
            raise AssertionError(f"segment {i} of {self.n}: the body "
                                 f"{'ended' if self.done else 'did not end'} there")
        if self.done:
            if self.at != len(self.ops):
                raise AssertionError(f"{self.at} operations replayed of {len(self.ops)}")
            for dst, src in zip(self.outs or (), self.result or ()):
                dst.copy_(src)

    def _run(self, threads: int):
        torch.set_num_threads(threads)  # a new thread would take every core
        try:
            with torch.inference_mode(), distributed.recording(self._check):
                self.result = self.body()
            self.done = True
        except BaseException as err:  # handed to the segment's replay
            self.error = err
        self.to_main.release()

    def _check(self, live) -> None:
        want = self.ops[self.at]
        if signature(live) != signature(want):
            raise AssertionError(f"operation {self.at}: {signature(live)} replays "
                                 f"{signature(want)}")
        for src, dst in zip(live.reads, want.reads):
            dst.copy_(src)
        self.at += 1
        self.to_main.release()
        self.to_body.acquire()
        for src, dst in zip(want.writes, live.writes):
            dst.copy_(src)


def segmented_stand_in(eng):
    """Put the engine on the graph route with the segmented stand-in: the
    table and the chains are the engine's (`_GraphTable`, `_Chain`), and a
    capture records the body through `distributed.segmented` as the card's
    does, its segments `_Segment`s. The capture runs the body on the CPU,
    issuing no operation (the calls counted by `BOUNDARY_STATS` must not
    move; what an operation writes reads as zeros), and then restores the
    engine's state and generator, as a capture leaves the device as it
    was."""

    def capture(chain, body):
        saved = [t.clone() for t in _engine_state(eng)]
        gen = eng.generator.get_state()
        issued = distributed.BOUNDARY_STATS["eager_calls"]
        eng._hz_step.zero_()  # a real capture runs nothing: the index may be past the rows
        replayer = _Replayer(body)

        def record(op):
            replayer.ops.append(op)
            for t in op.writes:
                t.zero_()

        chain.steps, outs = distributed.segmented(body, replayer.new_segment, lambda seg: None,
                                                  record)
        if distributed.BOUNDARY_STATS["eager_calls"] != issued:
            raise AssertionError("a capture issued an operation")
        for t, v in zip(_engine_state(eng), saved):
            t.copy_(v)
        eng.generator.set_state(gen)
        replayer.outs = outs
        return outs

    eng._graphs = engine_mod._GraphTable(engine_mod._Chain, capture)
    eng.route = "graphs"
    return eng


# ---- the sharded engine's cases on both routes (tests/test_torch_tp_engine.py)

def _engine_cases(eng, job, rank, graphs: bool) -> dict:
    """The sharded engine's cases on one route: each returns its streams
    (every rank returns them all) and what the rank holds, and the launch
    counters' moves over all of them but HTTP's; on the graph route also each
    engine's segments by key (the stop_check case runs on the eager route
    only)."""
    from bitdistiller_tpu_torch.serve import Request

    out, tables = {}, {}
    before = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
    e = eng()
    out["f32"] = e.generate(job["prompts"], 6)
    out["f32_cache_shape"] = tuple(e.cache.k.shape)
    tables["f32"] = e
    e = eng(torch.int8)
    out["int8"] = e.generate(job["prompts"], 6)
    out["int8_scale_shape"] = tuple(e.cache.k_scale.shape)
    tables["int8"] = e
    e = eng()
    http_before = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
    out["http"] = _http_generate(e, job["prompts"][:2], 6)
    # the requests join the running loop when they arrive: not counted
    before = [b + getattr(o, a) - h for (o, a), b, h in
              zip(engine_mod.LAUNCH_COUNTERS, before, http_before)]
    tables["http"] = e

    e = eng(prompt_cache_size=1)
    r1 = Request(prompt_tokens=job["cached_prompt"], max_new_tokens=6, cache_prompt=True)
    e.run([r1])
    r2 = Request(prompt_tokens=job["cached_prompt"], max_new_tokens=6)
    e.run([r2])
    out["prompt_cache"] = (r1.output_tokens, r2.output_tokens, e.prompt_cache_hits)
    r3 = Request(prompt_tokens=job["cached_prompt"] + [23, 29], max_new_tokens=6)
    e.run([r3])  # the stored prompt's tail prefill
    out["prompt_extend"] = (r3.output_tokens, e.prompt_cache_prefix_hits)
    tables["prompt_cache"] = e

    out["spec"] = {}
    for spec in (False, True):
        e = eng(spec_decode=spec, spec_k=3)
        out["spec"][spec] = e.generate(job["spec_prompts"], 10)
    out["spec_rounds"] = e.spec_rounds
    tables["spec"] = e

    e = eng(torch.bfloat16, max_len=128)
    out["growth"] = e.generate(job["prompts5"], 24)
    out["growths"] = list(e.growths)
    tables["growth"] = e
    e = eng(torch.bfloat16, max_len=128, temperature=0.8)
    out["sampled"] = e.generate(job["prompts5"], 24)
    tables["sampled"] = e

    out["counters"] = [getattr(o, a) - v for (o, a), v in zip(engine_mod.LAUNCH_COUNTERS, before)]
    if graphs:
        out["tables"] = {name: dict(segments=t._graphs.segments(), captured=t._graphs.captured,
                                    replays=t._graphs.replays)
                         for name, t in tables.items()}
        return out
    # stop_check on every rank, but rank 0's verdicts rule: the other ranks'
    # own check would never fire
    stop_tok = job["stop_token"]
    check = ((lambda toks: stop_tok in toks) if rank == 0 else (lambda toks: False))
    reqs = [Request(prompt_tokens=p, max_new_tokens=24, stop_check=check)
            for p in job["prompts5"]]
    eng(max_len=128).run(reqs)
    out["stop_check"] = [(r.output_tokens, r.finish_reason) for r in reqs]
    return out


def _graph_only_cases(eng, mesh, job) -> dict:
    """The graph route's own checks on this rank: warmup() capturing every
    kind (live traffic after it captures nothing) and, where the mesh is
    all tp, the ring's chains under BITDISTILLER_RING_TP=1 against its
    eager twin."""
    import os

    from bitdistiller_tpu_torch.serve import Request, SamplingParams

    out = {}
    e = eng(max_len=64, spec_decode=True, route="graphs")
    e.warmup(prompt_len=16)
    n = len(e._graphs.captured)
    reqs = [Request(prompt_tokens=p, max_new_tokens=12) for p in job["spec_prompts"]]
    reqs.append(Request(prompt_tokens=[3, 4], max_new_tokens=9,
                        sampling=SamplingParams(temperature=0.0)))
    e.run(reqs)
    out["warmup"] = dict(captured=n, after=len(e._graphs.captured),
                         segments=e._graphs.segments(), streams=[r.output_tokens for r in reqs])
    if mesh.dp == 1:
        os.environ["BITDISTILLER_RING_TP"] = "1"
        try:
            ring = {route: eng(route=route) for route in ("eager", "graphs")}
            out["ring"] = {route: e.generate(job["prompts"], 6) for route, e in ring.items()}
            out["ring_segments"] = ring["graphs"]._graphs.segments()
        finally:
            os.environ.pop("BITDISTILLER_RING_TP")
    return out


def engine_job(rank, world, job):
    """The sharded engine's cases on this rank of a (dp, tp) mesh (dp =
    world / tp), on the eager route and on the segmented stand-in of the
    graph route (`out["graphs"]`), then the graph route's own checks and,
    at tp = 2, the graph route over the same ranks as dp = world, tp = 1."""
    from bitdistiller_tpu_torch.serve import Engine, SamplingParams

    mesh = make_mesh(tp=job["tp"])
    cfg = job["cfg"]
    local = shard_packed_model(job["packed"], mesh, cfg)

    def eng(cache=torch.float32, max_len=32, temperature=0.0, route="eager", mesh=mesh,
            params=local, **kw):
        e = Engine(params, cfg, max_slots=4, max_len=max_len,
                   sampling=SamplingParams(temperature=temperature), eos_token_id=None,
                   cache_dtype=cache, device="cpu", mesh=mesh, **kw)
        return segmented_stand_in(e) if route == "graphs" else e

    out = {"mesh": (mesh.dp, mesh.tp, mesh.dp_rank, mesh.tp_rank)}
    out.update(_engine_cases(eng, job, rank, False))
    out["graphs"] = _engine_cases(functools.partial(eng, route="graphs"), job, rank, True)
    out.update(_graph_only_cases(eng, mesh, job))
    try:
        Engine(local, cfg, max_slots=3, max_len=32, device="cpu", mesh=mesh)
        out["uneven_slots"] = None
    except ValueError as err:
        out["uneven_slots"] = str(err)
    if mesh.dp == 1:  # the same ranks as dp = world, tp = 1: every slot a rank's own
        dp_mesh = make_mesh(dp=world, tp=1)
        whole = shard_packed_model(job["packed"], dp_mesh, cfg)
        dp = {route: eng(route=route, mesh=dp_mesh, params=whole) for route in ("eager", "graphs")}
        out["dp_only"] = {route: e.generate(job["prompts"], 6) for route, e in dp.items()}
        out["dp_only_segments"] = dp["graphs"]._graphs.segments()
    return out


def card_engine_job(rank, world, job):
    """On the card (tests/test_torch_gpu.py): the engine over a tp = world
    mesh of gloo ranks on the one card, on its default route (graphs:
    chains replayed, the operations between the segments) and its eager
    twin, without and with the ring; greedy, speculative at one k (every
    round verifying), sampled, and a stored prompt's hit and tail prefill.
    Returns, by ring and route, the streams, the launch counters' moves,
    the segments by key and how many captured no work (torch warns at
    such a capture)."""
    import os
    import warnings

    from bitdistiller_tpu_torch.models import random_packed_params
    from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams

    torch.cuda.set_device(0)
    mesh = make_mesh(tp=world)
    cfg = job["cfg"]
    local = shard_packed_model(random_packed_params(cfg, bits=2, group_size=64, device="cuda",
                                                    fuse=False), mesh, cfg)
    out = {}
    for ring in ("0", "1"):
        os.environ["BITDISTILLER_RING_TP"] = ring
        for graphs in (None, False):
            before = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
            streams, segs = [], {}
            with warnings.catch_warnings(record=True) as empty:
                warnings.simplefilter("always")
                for kw in (dict(temperature=0.0), dict(temperature=0.0, spec=True),
                           dict(temperature=0.8)):
                    eng = Engine(local, cfg, max_slots=4, max_len=128, eos_token_id=None, seed=3,
                                 sampling=SamplingParams(temperature=kw["temperature"]),
                                 spec_decode=kw.get("spec", False), spec_adaptive_k=False,
                                 prompt_cache_size=4, device="cuda", mesh=mesh, graphs=graphs)
                    eng.spec_min_accept = -1.0
                    streams.append(eng.generate(job["prompts"], 30))
                    segs.update(eng._graphs.segments() if eng._graphs is not None else {})
                stored = Request(prompt_tokens=job["prompts"][0], max_new_tokens=4,
                                 cache_prompt=True)
                eng.run([stored])
                streams.append(eng.generate([job["prompts"][0], job["prompts"][0] + [7, 8, 9]], 6))
                torch.cuda.synchronize()
            counts = [getattr(o, a) - v for (o, a), v in zip(engine_mod.LAUNCH_COUNTERS, before)]
            segs.update(eng._graphs.segments() if eng._graphs is not None else {})
            out[ring, eng.route] = dict(streams=streams, counts=counts, segments=segs,
                                        prefix_hits=eng.prompt_cache_prefix_hits,
                                        empty=sum("CUDA Graph is empty" in str(w.message)
                                                  for w in empty))
    os.environ.pop("BITDISTILLER_RING_TP")
    return out


# ---- the ring matmuls (tests/test_torch_overlap.py) ------------------------

def overlap_job(rank, world, job):
    """The ring at tp = world on the job's matmuls, and the whole packed
    model at dp 2 x tp 2 with BITDISTILLER_RING_TP off and on (prefill S = 4
    into a cache, then a decode step S = 1, on the dp rank's rows)."""
    import os

    from bitdistiller_tpu_torch.parallel.overlap import (make_row_parallel_fn,
                                                         reduce_scatter_matmul)

    mesh = make_mesh(tp=world)
    out = {"dense": make_row_parallel_fn(job["dense_w"], mesh)(job["dense_x"]),
           "packed": make_row_parallel_fn(job["packed_w"], mesh, packed_bits=2,
                                          group_size=128)(job["packed_x"])}
    kl = job["rs_w"].shape[0] // world
    cut = slice(rank * kl, (rank + 1) * kl)
    out["chunk"] = reduce_scatter_matmul(job["rs_x"][:, cut], job["rs_w"][cut], mesh)

    mesh = make_mesh(dp=world // 2, tp=2)
    cfg = job["cfg"]
    local = shard_packed_model(job["model"], mesh, cfg)
    b = job["tokens"].shape[0] // mesh.dp
    toks = job["tokens"][mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
    lcfg = tp_config(cfg, mesh.tp)
    for ring in ("0", "1"):
        os.environ["BITDISTILLER_RING_TP"] = ring
        cache = KVCache.init(lcfg, b, 16, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            pre, _ = llama.forward(local, cfg, toks, cache=cache, cache_pos=0, mesh=mesh)
            step, _ = llama.forward(local, cfg, toks[:, -1:], cache=cache,
                                    cache_pos=torch.full((b,), 4, dtype=torch.int32), mesh=mesh)
        out[f"model_ring{ring}"] = (pre, step)
    os.environ.pop("BITDISTILLER_RING_TP")
    out["ring_leaves"] = len(mesh.ring_cache)  # o and down, cut once
    return out


# ---- GPipe (tests/test_torch_pp.py) ----------------------------------------

def pp_job(rank, world, job):
    """pipeline_forward at each (pp, n_micro) of the job over the first pp
    of the world's ranks (every rank receives the logits), the fake-quant
    student at pp = 4, and a packed tree at pp = 2."""
    from bitdistiller_tpu_torch.parallel.pipeline import (make_pp_mesh, pipeline_forward,
                                                          shard_params_pp)
    from bitdistiller_tpu_torch.quant.core import make_fake_quantizer

    cfg, params, tokens = job["cfg"], job["params"], job["tokens"]
    out = {}
    with torch.no_grad():
        for pp, n_micro in job["cases"]:
            mesh = make_pp_mesh(pp)
            out[(pp, n_micro)] = pipeline_forward(shard_params_pp(params, mesh), cfg, tokens,
                                                  mesh, n_micro=n_micro)
        q = make_fake_quantizer("int2", 32)
        mesh = make_pp_mesh(4)
        out["fake_quant"] = pipeline_forward(shard_params_pp(params, mesh), cfg, tokens, mesh,
                                             n_micro=2, quantizer=lambda w: q(w.t()).t())
        mesh = make_pp_mesh(2)
        out["packed"] = pipeline_forward(shard_params_pp(job["packed"], mesh), cfg, tokens,
                                         mesh, n_micro=2)
    return out
