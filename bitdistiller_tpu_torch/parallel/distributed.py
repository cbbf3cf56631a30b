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
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

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


class _Transfer:
    """A started point-to-point transfer: `wait()` blocks until it is done
    and, for a receive staged through the host, copies into the target."""

    def __init__(self, work, staged: Optional[torch.Tensor] = None,
                 target: Optional[torch.Tensor] = None):
        self.work, self.staged, self.target = work, staged, target

    def wait(self) -> None:
        self.work.wait()
        if self.target is not None:
            self.target.copy_(self.staged)


def isend(t: torch.Tensor, dst: int, group=None) -> _Transfer:
    """Start sending `t` to global rank `dst` (through a host copy where
    `host_staged`; the copy is taken before this returns, so `t` may be
    written at once)."""
    if host_staged(t, group):
        host = t.to("cpu", copy=True)
        return _Transfer(dist.isend(host, dst, group=group), staged=host)
    t = t.contiguous()
    return _Transfer(dist.isend(t, dst, group=group), staged=t)


def irecv(t: torch.Tensor, src: int, group=None) -> _Transfer:
    """Start receiving into the contiguous `t` from global rank `src`; `t`
    holds the data after `wait()`."""
    if host_staged(t, group):
        host = torch.empty(t.shape, dtype=t.dtype)
        return _Transfer(dist.irecv(host, src, group=group), staged=host, target=t)
    return _Transfer(dist.irecv(t, src, group=group))


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
