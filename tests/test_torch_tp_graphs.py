"""The engine's graph route under a mesh (`parallel.distributed.boundary`,
`segmented`, `serve.engine._Chain`), in one process, with no spawn: the
spawned ranks' streams, segment counts, growth and warmup on the segmented
stand-in are tests/test_torch_tp_engine.py's, whose spawn runs them.

Here a tp = 2 mesh is rank 0 of a world that torch.distributed's
functions fake in this process (the other rank mirrors this one: an
all-reduce doubles, an all-gather repeats, a broadcast keeps, a
point-to-point hop comes back), so that the engine's whole host loop runs
on the eager route and on the segmented stand-in of the graph route
(tests/torch_tp_worker.py:segmented_stand_in), without and with the ring
(BITDISTILLER_RING_TP=1): every key has the segments worked out from the
code (`predicted_segments`), every kind of piece among them, and the two
routes give the same tokens and move the launch counters alike, which
they would not if a replay dropped, repeated or reordered an operation;
and every segment of every key computes something (an empty one would
replay as a graph of no work), the ring's at tp = 2 and 4 too.
The guard refuses a collective inside a capture by name, whether called
directly under `segmented` or through the hook on a capturing stream; a
capture issues nothing, a replay issues the recorded operations between
the segments, and a body that fails leaves no segment open."""

import dataclasses
import gc
import threading
import weakref

import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from bitdistiller_tpu_torch.models import TINY_TEST, init_params, pack_model
from bitdistiller_tpu_torch.parallel import distributed
from bitdistiller_tpu_torch.parallel import tensor as tp_ops
from bitdistiller_tpu_torch.parallel.distributed import CaptureError
from bitdistiller_tpu_torch.parallel.mesh import Mesh, shard_packed_model
from bitdistiller_tpu_torch.parallel.overlap import ring_all_reduce_matmul
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.serve import engine as engine_mod
from torch_tp_worker import predicted_segments, segmented_stand_in

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
L = CFG.num_layers
PROMPTS = [[3, 5, 7], [11, 13, 17, 19], [2, 4, 6, 8, 10]]
SPEC = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 2, 9, 2, 9]]


class _Work:
    def __init__(self, done=None):
        self.done = done

    def wait(self):
        if self.done is not None:
            self.done()
        return True


class _Computing(TorchDispatchMode):
    """Counts the aten operations that compute: neither a view nor an
    allocation, which on the card launch no kernel."""

    ALLOC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func.overloadpacket.__name__ not in self.ALLOC:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def idle_segments(monkeypatch):
    """`distributed.segmented` counting the work of each segment it opens:
    returns the list of the segments that computed nothing."""
    real, idle, work = distributed.segmented, [], _Computing()

    def counting(body, begin, end, on_record=None):
        marks = {}

        def counted_begin():
            seg = begin()
            marks[id(seg)] = work.n
            return seg

        def counted_end(seg):
            if work.n == marks[id(seg)]:
                idle.append(seg)
            end(seg)

        with work:
            return real(body, counted_begin, counted_end, on_record)

    monkeypatch.setattr(distributed, "segmented", counting)
    return idle


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_world(monkeypatch):
    """torch.distributed's functions as rank 0 of a world whose other rank
    mirrors it; returns the log of the operations issued."""
    log, mailbox = [], []

    def issued(name, fn):
        def call(*args, **kwargs):
            log.append(name)
            return fn(*args, **kwargs)
        return call

    def all_gather(parts, x, group=None):
        for p in parts:
            p.copy_(x)

    fakes = {
        "get_rank": lambda group=None: 0,
        "get_process_group_ranks": lambda group: (0, 1),
        "all_reduce": issued("all_reduce", lambda t, group=None: t.mul_(2)),
        "all_gather": issued("all_gather", all_gather),
        "broadcast": issued("broadcast", lambda t, src=0, group=None: None),
        "isend": issued("isend", lambda t, dst, group=None: mailbox.append(t.clone()) or _Work()),
        "irecv": issued("irecv", lambda t, src, group=None: _Work(
            lambda: t.copy_(mailbox.pop(0)))),
    }
    for name, fn in fakes.items():
        monkeypatch.setattr(dist, name, fn)
    return log


@pytest.fixture(scope="module")
def shard():
    torch.manual_seed(0)
    packed = pack_model(init_params(CFG, seed=0, dtype=torch.float32, device="cpu"), CFG,
                        bits=4, group_size=64, fuse=False)
    mesh = Mesh(dp=1, tp=2, tp_rank=0, tp_group="tp")
    return shard_packed_model(packed, mesh, CFG)


def _engine(shard, route, **kw):
    mesh = Mesh(dp=1, tp=2, tp_rank=0, tp_group="tp")
    eng = Engine(shard, CFG, max_slots=4, max_len=64, sampling=SamplingParams(temperature=0.0),
                 eos_token_id=None, cache_dtype=torch.float32, device="cpu", mesh=mesh, **kw)
    assert eng.route == "eager"
    return segmented_stand_in(eng) if route == "graphs" else eng


def _traffic(eng) -> tuple:
    """warmup(), then plain and custom requests, speculation and a stored
    prompt's hit and tail prefill; (streams, launch counters' moves after
    the warmup, which walks more steps on the graph route)."""
    eng.warmup(prompt_len=16)
    before = [getattr(o, a) for o, a in engine_mod.LAUNCH_COUNTERS]
    reqs = [Request(prompt_tokens=p, max_new_tokens=7) for p in PROMPTS]
    reqs.append(Request(prompt_tokens=[3, 4], max_new_tokens=5,
                        sampling=SamplingParams(temperature=0.0)))
    eng.run(reqs)
    out = [r.output_tokens for r in reqs]
    out += eng.generate(SPEC, 9)
    stored = Request(prompt_tokens=PROMPTS[1], max_new_tokens=4, cache_prompt=True)
    eng.run([stored])
    out += eng.generate([PROMPTS[1], PROMPTS[1] + [23, 29]], 4)
    assert eng.prompt_cache_hits == 2 and eng.prompt_cache_prefix_hits == 1
    return out, [getattr(o, a) - b for (o, a), b in zip(engine_mod.LAUNCH_COUNTERS, before)]


@pytest.mark.parametrize("ring", [False, True])
def test_segments_by_key_and_routes_equal(fake_world, shard, monkeypatch, idle_segments, ring):
    """Every key of every kind has the segments worked out from the code,
    each of which computes something; the stand-in's tokens and launch
    counts equal the eager route's."""
    if ring:
        monkeypatch.setenv("BITDISTILLER_RING_TP", "1")
    got = {}
    for route in ("eager", "graphs"):
        eng = _engine(shard, route, spec_decode=True, prompt_cache_size=4)
        got[route] = _traffic(eng), eng
    assert got["graphs"][0] == got["eager"][0]
    assert any(got["eager"][0][1])
    table = got["graphs"][1]._graphs
    kinds = {engine_mod.piece(k) for k in table.captured}
    assert kinds == set(engine_mod.STEP_PIECES) | set(engine_mod.ADMISSION_PIECES)
    for key, n in table.segments().items():
        assert n == predicted_segments(engine_mod.piece(key), L, 2, ring), (key, n)
    assert table.replays > 0 and not idle_segments


@pytest.mark.parametrize("tp", [2, 4])
def test_the_ring_computes_between_any_two_operations(fake_world, idle_segments, tp):
    """A ring matmul under `segmented`: 3 (tp - 1) operations, a
    reduce-scatter hop's exchange and wait around its chunk matmul and an
    all-gather hop's sendrecv between two chunk copies, and no segment
    that computes nothing."""
    mesh = Mesh(dp=1, tp=tp, tp_rank=0, tp_group="tp")
    x, w = torch.randn(3, 8), torch.randn(8, 4 * tp)
    steps, y = distributed.segmented(lambda: ring_all_reduce_matmul(x, w, mesh), object,
                                     lambda seg: None)
    ops = [op.kind for kind, op in steps if kind == "op"]
    assert ops == ["exchange", "wait"] * (tp - 1) + ["sendrecv"] * (tp - 1)
    assert y.shape == (3, 4 * tp) and not idle_segments and not fake_world


def test_a_capture_issues_nothing_and_a_replay_issues_in_order(fake_world, shard):
    """A step's capture issues no operation; its replay issues the 2L + 3
    recorded ones, in the eager step's order."""
    eng = _engine(shard, "graphs")
    eng.generate([PROMPTS[0]], 2)  # the step's key: first use eager, then captured
    first = list(fake_world)
    fake_world.clear()
    eng.generate([PROMPTS[0]], 3)  # prefill, commit and two steps replayed
    (chain, _, _), = [v for k, v in eng._graphs.graphs.items()
                      if engine_mod.piece(k) == "uniform"]
    step_ops = [op.kind for kind, op in chain.steps if kind == "op"]
    assert step_ops == ["all_reduce"] * (2 * L + 1) + ["all_gather", "broadcast"]
    prefill_ops = ["all_reduce"] * (2 * L + 1) + ["all_gather"]
    assert fake_world == prefill_ops + ["broadcast"] + step_ops * 2  # replayed
    assert first == prefill_ops + ["broadcast"] + step_ops  # the first uses, eager


def test_a_direct_collective_inside_a_capture_is_refused_by_name(fake_world):
    seen = []
    with pytest.raises(CaptureError, match=r"torch\.distributed\.all_reduce"):
        distributed.segmented(lambda: dist.all_reduce(torch.ones(2)),
                              lambda: seen.append("begin") or len(seen),
                              lambda seg: seen.append(("end", seg)))
    assert seen == ["begin", ("end", 1)]  # the open segment was closed
    assert not fake_world
    dist.all_reduce(torch.ones(1))  # restored: issued now
    assert fake_world == ["all_reduce"]


def test_the_guard_refuses_only_on_the_recording_thread(fake_world):
    """Another thread's collective during a segmented capture goes through."""
    def body():
        other = threading.Thread(target=lambda: dist.all_reduce(torch.ones(1)))
        other.start()
        other.join()
        with pytest.raises(CaptureError, match=r"torch\.distributed\.broadcast"):
            dist.broadcast(torch.ones(1))

    distributed.segmented(body, object, lambda seg: None)
    assert fake_world == ["all_reduce"]


def test_a_recorded_operation_holds_none_of_the_body_tensors(fake_world, monkeypatch):
    """The chain holds an operation's tensors only through `unowned` (on the
    card, views that do not keep the memory allocated), so that what the
    body drops (the f32 sum, the gathered parts, a hop's buffers) is freed
    for the next key's capture, as a graph's transients are."""
    seen = []

    def view(t):
        seen.append(weakref.ref(t))
        return torch.empty_like(t)

    monkeypatch.setattr(distributed, "unowned", view)

    def body():
        y = tp_ops._sum(torch.arange(4.0), "tp")
        logits = tp_ops._GatherFromTP.apply(y, "tp", 2, 0)
        buf, back = torch.empty(4), torch.empty(4)
        distributed.exchange(y, 1, buf, 1, "tp").wait()
        distributed.sendrecv(buf, 1, back, 1, "tp")
        return (logits + back.sum()).sum()

    chain = engine_mod._Chain()
    chain.steps, _ = distributed.segmented(body, object, lambda seg: None)
    gc.collect()
    assert [op.kind for kind, op in chain.steps if kind == "op"] == [
        "all_reduce", "all_gather", "exchange", "wait", "sendrecv"]
    # the sum's y, the gather's x and 2 parts, the exchange's and its wait's y and buf,
    # the sendrecv's buf and back
    assert len(seen) == 10 and all(r() is None for r in seen)
    assert not fake_world


def test_a_hooked_collective_on_a_capturing_stream_is_refused(fake_world, monkeypatch):
    """Outside a segmented capture, a stream that captures refuses the
    operation before gloo sees it."""
    monkeypatch.setattr(distributed, "_stream_capturing", lambda: True)
    with pytest.raises(CaptureError, match="all_reduce reached inside a CUDA graph capture"):
        tp_ops._sum(torch.ones(3), "tp")
    with pytest.raises(CaptureError, match="isend"):
        distributed.isend(torch.ones(3), 1, "tp")
    assert not fake_world


def test_segmented_splits_at_each_operation_and_replays_in_order(fake_world):
    """A segment before the first operation, between any two and after the
    last; the operations' tensors are the body's; `_Chain.replay` runs
    segment, operation, segment, ... and counts the operations replayed."""
    class Seg:
        def __init__(self, i):
            self.i = i

        def replay(self):
            fake_world.append(f"segment {self.i}")

    segs = []

    def begin():
        segs.append(Seg(len(segs)))
        return segs[-1]

    def body():
        x = torch.arange(4.0)
        y = tp_ops._sum(x, "tp")
        send = distributed.isend(y, 1, "tp")
        buf = torch.zeros(4)
        recv = distributed.irecv(buf, 1, "tp")
        send.wait()
        recv.wait()
        return (y, buf)

    chain = engine_mod._Chain()
    chain.steps, (y, buf) = distributed.segmented(body, begin, lambda seg: None)
    assert not fake_world  # nothing issued
    kinds = [(k, x.i if k == "graph" else x.kind) for k, x in chain.steps]
    assert kinds == [("graph", 0), ("op", "all_reduce"), ("graph", 1), ("op", "isend"),
                     ("graph", 2), ("op", "irecv"), ("graph", 3), ("op", "wait"),
                     ("graph", 4), ("op", "wait"), ("graph", 5)]
    ops = [op for kind, op in chain.steps if kind == "op"]
    assert chain.segments == 6 and ops[0].reads[0] is ops[0].writes[0]
    assert len(ops[4].writes) == 1 and ops[4].writes[0] is buf
    n = distributed.BOUNDARY_STATS["replayed_calls"]
    chain.replay()
    assert distributed.BOUNDARY_STATS["replayed_calls"] == n + 5
    assert fake_world == ["segment 0", "all_reduce", "segment 1", "isend", "segment 2", "irecv",
                          "segment 3", "segment 4", "segment 5"]  # the waits: on the works
    assert torch.equal(y, 2 * torch.arange(4.0)) and torch.equal(buf, y)
