"""Multi-process bring-up (PyTorch port of the JAX package's
`parallel/distributed.py`): join a process group, one device a rank, the
dp "mesh", and each rank's contiguous shard of a list.

One process a rank, as torchrun and DeepSpeed launch them. The backend
follows the device the caller asked for: NCCL for a CUDA device, gloo for
the CPU. Rank r runs on `cuda:{local_rank}`. Where JAX assembles a global
dp-sharded array from every host's rows (`global_batch_from_host`), each
rank here feeds its own rows to its own step; the gradients are averaged
over the ranks (`parallel/zero.py`), so the step is that of the global
batch, the concatenation of the ranks' rows in rank order.

Every collective and point-to-point operation that the serving engine's
pieces reach goes through one hook, `boundary`: it issues the operation,
unless a segmented capture (`segmented`) is recording on this thread.
Then it ends the current CUDA graph segment, records the operation (a
closure handed the tensors it reads and writes as views that do not keep
them allocated, so that the graphs' pool reuses them as it reuses a
graph's transients), and begins the next segment; a replay runs the
segments in order with the operations, eager, between them. A collective
reached while the current stream captures, other than through the hook,
raises `CaptureError`. A ring hop's send and receive are one operation
(`exchange`, whose `wait` is another, or `sendrecv`, which waits too),
so that the ring has a kernel between any two operations.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
TIMEOUT_S = 600  # the rendezvous and every collective


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device="cuda",
                     backend: Optional[str] = None) -> bool:
    """Join a multi-process run; returns True when the process is in a
    group after the call.

    With every argument None this is a no-op, unless torchrun's RANK,
    WORLD_SIZE and MASTER_ADDR are set: then the group comes from them (the
    counterpart of JAX's auto-detection). Otherwise `coordinator_address`
    ("host:port" of rank 0's store), `num_processes` and `process_id` give
    the rendezvous. A process already in a group stays in it. `backend`
    overrides the device's (gloo over CUDA tensors: two ranks on one card,
    which NCCL refuses)."""
    if dist.is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id)
    from_env = all(v is None for v in explicit)
    if from_env and not all(v in os.environ for v in _TORCHRUN_VARS):
        return False
    if not from_env and None in explicit:
        raise ValueError("coordinator_address, num_processes and process_id go together")
    backend = backend or backend_for(device)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if from_env:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                                rank=process_id, timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    logger.info("distributed init: rank %d/%d over %s", dist.get_rank(), dist.get_world_size(),
                backend)
    return True


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """torchrun's LOCAL_RANK, else the rank modulo the cards on this host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return get_rank() % max(n, 1)


def local_device(device) -> torch.device:
    """The rank's own device: `cuda:{local_rank}` for a CUDA device, else
    the device itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return dev


def local_world_size() -> int:
    """The ranks on this host: torchrun's LOCAL_WORLD_SIZE, else one a card
    (at most the world), else, on the CPU, the whole world (every rank a
    process of this host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    n = get_world_size()
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return min(torch.cuda.device_count(), n)
    return n


def make_hybrid_mesh(tp: int = 1, dp: Optional[int] = None) -> Mesh:
    """The (dp, tp) mesh of the process group (`mesh.make_mesh`), tp groups
    kept inside a host so that their collectives stay on its links (NVLink
    for the cards of one node), as JAX keeps them on ICI: dp * tp must be
    the world size and, with more than one rank, tp must divide the ranks
    of one host."""
    n = get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    local = local_world_size()
    if n > 1 and (tp > local or local % tp):
        raise ValueError(f"tp={tp} must divide the per-host device count {local} so tensor "
                         f"collectives stay inside a host")
    return make_mesh(dp=dp, tp=tp)


def host_staged(t: torch.Tensor, group=None) -> bool:
    """True where a point-to-point transfer of `t` over `group` goes through
    host memory: a CUDA tensor over gloo, whose TCP pairs read and write the
    tensor's memory from the host (a send of a CUDA tensor aborts the
    process: "writev: Bad address"). NCCL sends the CUDA tensor itself."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def p2p_transport(t: torch.Tensor, group=None) -> str:
    """How `isend` / `irecv` move `t` over `group`: "host" (staged) or
    "device"."""
    return "host" if host_staged(t, group) else "device"


class CaptureError(RuntimeError):
    """A collective reached inside a CUDA graph capture other than through
    `boundary` under `segmented`: it cannot be captured (gloo stages it
    through the host and waits there), so it is refused by name."""


# the torch.distributed calls a segmented capture refuses on its thread
_GUARDED = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
            "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
            "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather", "scatter",
            "send", "recv", "isend", "irecv", "batch_isend_irecv", "barrier")

# calls and host seconds of the operations `boundary` issued: eagerly, and
# by a replay between its segments (`Boundary.run(replayed=True)`)
BOUNDARY_STATS = {"eager_calls": 0, "eager_s": 0.0, "replayed_calls": 0, "replayed_s": 0.0}

_local = threading.local()  # .record: the recording `boundary` hands its operations to


class Boundary:
    """One collective or point-to-point operation as `boundary` saw it: its
    kind, its group (None: the world), the tensors it reads and those it
    writes, and `issue(reads, writes)`, which performs it on exactly those
    tensors and refers to no device tensor of its own, so that a recording
    can hand it views that do not keep their memory allocated (`unowned`)."""

    __slots__ = ("kind", "issue", "group", "reads", "writes")

    def __init__(self, kind: str, issue: Callable, group, reads: tuple, writes: tuple):
        self.kind, self.issue, self.group, self.reads, self.writes = (kind, issue, group, reads,
                                                                      writes)

    def run(self, replayed: bool = False):
        t0 = time.perf_counter()
        out = self.issue(self.reads, self.writes)
        how = "replayed" if replayed else "eager"
        BOUNDARY_STATS[how + "_calls"] += 1
        BOUNDARY_STATS[how + "_s"] += time.perf_counter() - t0
        return out


def _stream_capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def boundary(kind: str, issue: Callable, group=None, reads=(), writes=()):
    """Issue one collective or point-to-point operation (`issue(reads,
    writes)`, over `group`) and return what it returns; under `segmented`,
    record it instead and return None. Outside a segmented capture, a
    stream that is capturing refuses it."""
    op = Boundary(kind, issue, group, tuple(reads), tuple(writes))
    record = getattr(_local, "record", None)
    if record is not None:
        record(op)
        return None
    if _stream_capturing():
        raise CaptureError(f"{kind} reached inside a CUDA graph capture that is not split at "
                           f"its collectives (parallel.distributed.segmented)")
    return op.run()


@contextlib.contextmanager
def recording(record: Callable):
    """`boundary` on this thread hands its operations to `record(op)`
    instead of issuing them."""
    prev = getattr(_local, "record", None)
    _local.record = record
    try:
        yield
    finally:
        _local.record = prev


class _Memory:
    """A CUDA tensor's bytes as `__cuda_array_interface__`, holding no
    reference to the tensor."""

    def __init__(self, t: torch.Tensor):
        s = t.untyped_storage()
        self.__cuda_array_interface__ = {"shape": (s.nbytes(),), "typestr": "|u1",
                                         "data": (s.data_ptr(), False), "version": 2}


def unowned(t: torch.Tensor) -> torch.Tensor:
    """`t`'s elements through a tensor that does not keep their memory
    allocated (`t` itself off the card, or where it holds no bytes). A
    recorded operation holds these, as a CUDA graph holds the addresses of
    its transients: what the body drops goes back to the graphs' pool for
    the next key's capture, and a replay finds its own values there because
    a key's segments and operations replay back to back."""
    if not t.is_cuda or t.untyped_storage().nbytes() == 0:
        return t
    raw = torch.as_tensor(_Memory(t), device=t.device)
    return raw.view(t.dtype).as_strided(t.shape, t.stride(), t.storage_offset())


def _refusing(name: str, fn: Callable):
    def call(*args, **kwargs):
        if getattr(_local, "record", None) is not None:
            raise CaptureError(f"torch.distributed.{name} inside a segmented CUDA graph "
                               f"capture: an operation there goes through "
                               f"parallel.distributed.boundary")
        return fn(*args, **kwargs)
    return call


_GUARD_LOCK = threading.Lock()
_GUARD: dict = {"depth": 0, "saved": {}}


@contextlib.contextmanager
def _refusing_collectives():
    """While a segmented capture records, the torch.distributed calls of
    _GUARDED raise on a recording thread and go through on any other."""
    with _GUARD_LOCK:
        if _GUARD["depth"] == 0:
            _GUARD["saved"] = {n: getattr(dist, n) for n in _GUARDED if hasattr(dist, n)}
            for name, fn in _GUARD["saved"].items():
                setattr(dist, name, _refusing(name, fn))
        _GUARD["depth"] += 1
    try:
        yield
    finally:
        with _GUARD_LOCK:
            _GUARD["depth"] -= 1
            if _GUARD["depth"] == 0:
                for name, fn in _GUARD["saved"].items():
                    setattr(dist, name, fn)


def segmented(body: Callable, begin: Callable, end: Callable,
              on_record: Optional[Callable] = None) -> tuple:
    """Record `body()` as segments split at its operations, issuing none:
    `begin()` opens a segment and returns it, `end(seg)` closes it; each
    `boundary` the body reaches closes the open segment, is recorded on
    `unowned` views of its tensors and opens the next, and a direct
    torch.distributed call on this thread raises `CaptureError`.
    `on_record(op)` sees each operation on the body's own tensors: a hook
    for the CPU tests' stand-in, which checks and replays it there.
    Returns ([("graph", seg) | ("op", Boundary), ...], body's result): a
    segment before the first operation, between any two, and after the
    last. A body that raises leaves no segment open."""
    steps: list = []
    open_seg = [begin()]

    def record(op: Boundary) -> None:
        seg, open_seg[0] = open_seg[0], None
        end(seg)
        steps.append(("graph", seg))
        if on_record is not None:
            on_record(op)
        views: dict = {}
        for t in op.reads + op.writes:
            if id(t) not in views:
                views[id(t)] = unowned(t)
        steps.append(("op", Boundary(op.kind, op.issue, op.group,
                                     tuple(views[id(t)] for t in op.reads),
                                     tuple(views[id(t)] for t in op.writes))))
        open_seg[0] = begin()

    try:
        with recording(record), _refusing_collectives():
            out = body()
    except BaseException:
        if open_seg[0] is not None:
            with contextlib.suppress(Exception):
                end(open_seg[0])
        raise
    end(open_seg[0])
    steps.append(("graph", open_seg[0]))
    return steps, out


class _Hop:
    """One send or receive of a transfer: its peer (a global rank), its
    host buffer where it goes through the host (else None), and its work
    once started."""

    __slots__ = ("send", "peer", "staged", "work")

    def __init__(self, send: bool, t: torch.Tensor, peer: int, group):
        self.send, self.peer, self.work = send, peer, None
        self.staged = torch.empty(t.shape, dtype=t.dtype) if host_staged(t, group) else None

    def start(self, t: torch.Tensor, group) -> None:
        if self.send and self.staged is not None:
            self.staged.copy_(t)  # taken as the send is issued: `t` may be written after
        wire = t if self.staged is None else self.staged
        self.work = (dist.isend if self.send else dist.irecv)(wire, self.peer, group=group)

    def finish(self, t: torch.Tensor) -> None:
        self.work.wait()
        if not self.send and self.staged is not None:
            t.copy_(self.staged)


class _Transfer:
    """Started sends and receives (the sends first). `wait()`, an operation
    of its own through `boundary`, blocks until all are done; each receive's
    tensor then holds its data."""

    def __init__(self, group, hops: tuple, sent: tuple, received: tuple):
        self.group, self.hops, self.sent, self.received = group, hops, sent, received

    def wait(self) -> None:
        hops = self.hops

        def issue(reads, writes):
            for h, t in zip(hops, reads + writes):
                h.finish(t)

        boundary("wait", issue, self.group, reads=self.sent, writes=self.received)


def _transfer(kind: str, group, sends: tuple, recvs: tuple, wait: bool = False):
    """Start the sends ((tensor, dst), ...) and then the receives ((tensor,
    src), ...) as one operation `kind`; with `wait` also finish them within
    it and return None, else return the `_Transfer` whose `wait()` does."""
    hops = tuple([_Hop(True, t, dst, group) for t, dst in sends]
                 + [_Hop(False, t, src, group) for t, src in recvs])
    sent = tuple(t if h.staged is not None else t.contiguous() for h, (t, _) in zip(hops, sends))
    received = tuple(t for t, _ in recvs)

    def issue(reads, writes):
        for h, t in zip(hops, reads + writes):
            h.start(t, group)
        if wait:
            for h, t in zip(hops, reads + writes):
                h.finish(t)

    boundary(kind, issue, group, reads=sent, writes=received)
    return None if wait else _Transfer(group, hops, sent, received)


def isend(t: torch.Tensor, dst: int, group=None) -> _Transfer:
    """Start sending `t` to global rank `dst` (through a host copy where
    `host_staged`, taken as the send is issued, so that `t` may be written
    after that)."""
    return _transfer("isend", group, ((t, dst),), ())


def irecv(t: torch.Tensor, src: int, group=None) -> _Transfer:
    """Start receiving into the contiguous `t` from global rank `src`; `t`
    holds the data after `wait()`."""
    return _transfer("irecv", group, (), ((t, src),))


def exchange(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int,
             group=None) -> _Transfer:
    """One hop of a ring as one operation: `isend(send, dst)` and then
    `irecv(recv, src)`; `wait()` (one more) finishes both."""
    return _transfer("exchange", group, ((send, dst),), ((recv, src),))


def sendrecv(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int, group=None) -> None:
    """`exchange(...)` and its `wait()` as one operation, for a hop that
    nothing overlaps: `recv` holds the data when it returns."""
    _transfer("sendrecv", group, ((send, dst),), ((recv, src),), wait=True)


def host_shard(seq, process_id: Optional[int] = None, process_count: Optional[int] = None):
    """This rank's contiguous shard of a list (the DistributedSampler
    analogue). Every shard has the same length: the global remainder is
    dropped, so no rank sees a shorter last batch."""
    p = get_rank() if process_id is None else process_id
    n = get_world_size() if process_count is None else process_count
    if n == 1:
        return seq
    per = len(seq) // n
    if per == 0:
        raise ValueError(f"cannot shard {len(seq)} items over {n} hosts")
    return seq[p * per: (p + 1) * per]
