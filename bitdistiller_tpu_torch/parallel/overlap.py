"""Communication-overlapped tensor-parallel matmuls (collective matmul; the
JAX package's `parallel/overlap.py`) over a mesh's tp group.

A row-parallel linear (o, down) ends in an all-reduce of [M, N] partials,
which serializes behind the matmul. Here the all-reduce becomes a ring of
N-chunks interleaved with the chunk matmuls: each hop's send and receive
are issued before the next chunk's matmul, so that on NCCL the two
overlap (JAX's `lax.ppermute` hops). Over gloo a CUDA tensor's hop goes
through host memory (`distributed.isend`), and nothing overlaps. A hop
is an operation of `distributed.boundary`, which a segmented CUDA graph
capture records between two segments: a reduce-scatter hop two (its send
and receive, `distributed.exchange`, then their wait, with the chunk's
matmul between), an all-gather hop one (`distributed.sendrecv`, with the
received chunk's copy between two hops), so that a kernel runs between
any two operations and a ring matmul has 3 (tp - 1). The receive buffers
are allocated before their hop, inside a segment.

- `reduce_scatter_matmul`: x_local [M, K/tp] @ w_local [K/tp, N] -> this
  rank's chunk [M, N/tp] of the sum over the ranks, accumulated around the
  ring;
- `ring_all_reduce_matmul`: that, then a ring all-gather -> [M, N] on every
  rank (the all-reduce's result, chunk-pipelined).

Sums run in f32 and round once to x's dtype, as `tensor.reduce_from_tp`
does. A packed weight's chunks go through `quant_matmul`'s dispatch (B1,
B2 or B4 on the card); the kernels take row-major words, so each leaf's N
chunks are cut once, when the ring first sees it (`ring_chunks`), and
never on a call.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch

from ..quant.packing import PackedLinear
from .distributed import exchange, sendrecv
from .mesh import Mesh


def slice_packed_n(p: PackedLinear, n0: int, nc: int) -> PackedLinear:
    """The N slice [n0, n0 + nc) of a (stacked or not) PackedLinear: every
    per-N array sliced together, as views (strided: the row stride stays N)."""
    cut = lambda a: None if a is None else a.narrow(-1, n0, nc)
    return dataclasses.replace(p, qweight=cut(p.qweight), scales=cut(p.scales),
                               szeros=cut(p.szeros), combo=cut(p.combo), bias=cut(p.bias),
                               out_features=nc)


def _out_features(w) -> int:
    return w.out_features if isinstance(w, PackedLinear) else w.shape[-1]


def ring_chunks(w_local, mesh: Mesh) -> list:
    """The tp N-chunks of a rank's row-parallel weight, chunk c = columns [c
    N / tp, (c + 1) N / tp). A dense weight's are views; a packed one's are
    contiguous copies of `slice_packed_n`, made once and kept on the mesh
    for as long as the leaf's words live."""
    tp = mesh.tp
    n = _out_features(w_local)
    if n % tp:
        raise ValueError(f"the ring splits N = {n} into tp = {tp} chunks: not a multiple")
    nc = n // tp
    if not isinstance(w_local, PackedLinear):
        return [w_local.narrow(-1, c * nc, nc) for c in range(tp)]
    key = id(w_local.qweight)
    hit = mesh.ring_cache.get(key)
    if hit is None or hit[0]() is not w_local.qweight:
        solid = lambda a: None if a is None else a.contiguous()
        chunks = []
        for c in range(tp):
            v = slice_packed_n(w_local, c * nc, nc)
            chunks.append(dataclasses.replace(
                v, qweight=solid(v.qweight), scales=solid(v.scales), szeros=solid(v.szeros),
                combo=solid(v.combo), bias=solid(v.bias)))
        hit = (weakref.ref(w_local.qweight), chunks)
        mesh.ring_cache[key] = hit
        weakref.finalize(w_local.qweight, mesh.ring_cache.pop, key, None)
    return hit[1]


def _chunk_matmul(x2, chunk, li: Optional[int], use_kernels: bool) -> torch.Tensor:
    from ..models.layers import linear

    if isinstance(chunk, PackedLinear):
        return linear(chunk, x2, li, use_kernels=use_kernels)
    return x2 @ (chunk if li is None else chunk[li]).to(x2.dtype)


def _neighbours(mesh: Mesh) -> tuple[int, int]:
    """Global ranks of the next and the previous rank around the tp ring
    (rank = dp_rank * tp + tp_rank)."""
    base, tp, i = mesh.dp_rank * mesh.tp, mesh.tp, mesh.tp_rank
    return base + (i + 1) % tp, base + (i - 1) % tp


def _reduce_scatter(x2, w_local, mesh: Mesh, li, use_kernels) -> torch.Tensor:
    """This rank's f32 chunk of the reduced [M, N]. Step s computes the
    chunk (tp - 1 - s) hops downstream and passes the accumulator one hop;
    after the last hop each rank holds its own chunk, summed over every
    rank."""
    tp, idx = mesh.tp, mesh.tp_rank
    nxt, prv = _neighbours(mesh)
    chunks = ring_chunks(w_local, mesh)
    acc = None
    for step in range(tp):
        hop = None
        if acc is not None:  # the hop goes out before this step's matmul
            buf = torch.empty(acc.shape, dtype=acc.dtype, device=acc.device)
            hop = exchange(acc, nxt, buf, prv, mesh.tp_group)
        part = _chunk_matmul(x2, chunks[(idx + tp - 1 - step) % tp], li,
                             use_kernels).to(torch.float32)
        if hop is None:
            acc = part
        else:
            hop.wait()
            acc = buf + part
    return acc


def reduce_scatter_matmul(x_local, w_local, mesh: Mesh, li: Optional[int] = None,
                          use_kernels: bool = True) -> torch.Tensor:
    """Row-parallel matmul with a ring reduce-scatter folded into the
    compute: x_local [..., K/tp] @ w_local [K/tp, N] (dense, or a
    PackedLinear, layer `li` of a stacked one) -> this rank's chunk [...,
    N/tp] of the sum over the tp ranks, in x's dtype."""
    x2 = x_local.reshape(-1, x_local.shape[-1])
    out = _reduce_scatter(x2, w_local, mesh, li, use_kernels).to(x_local.dtype)
    return out.reshape(*x_local.shape[:-1], out.shape[-1])


def ring_all_reduce_matmul(x_local, w_local, mesh: Mesh, li: Optional[int] = None,
                           use_kernels: bool = True) -> torch.Tensor:
    """Row-parallel matmul -> [..., N] on every tp rank (the all-reduce of
    the partials), as a ring reduce-scatter, each chunk rounded once to x's
    dtype, then a ring all-gather of the chunks."""
    tp = mesh.tp
    nxt, prv = _neighbours(mesh)
    x2 = x_local.reshape(-1, x_local.shape[-1])
    buf = _reduce_scatter(x2, w_local, mesh, li, use_kernels).to(x_local.dtype)
    nc = buf.shape[-1]
    out = torch.empty((x2.shape[0], nc * tp), dtype=buf.dtype, device=buf.device)
    src = mesh.tp_rank
    for step in range(tp):
        out[:, src * nc:(src + 1) * nc] = buf
        if step == tp - 1:
            break
        nbuf = torch.empty(buf.shape, dtype=buf.dtype, device=buf.device)
        sendrecv(buf, nxt, nbuf, prv, mesh.tp_group)
        buf, src = nbuf, (src - 1) % tp
    return out.reshape(*x_local.shape[:-1], nc * tp)


def make_row_parallel_fn(w_full: torch.Tensor, mesh: Mesh, *, packed_bits: Optional[int] = None,
                         group_size: int = 128):
    """Split a whole [K, N] weight row-parallel over the mesh's tp ranks and
    return fn(x [..., K], the same on every rank) -> [..., N] on every rank,
    computed with the ring (for tests and microbenchmarks; a model is split
    by its spec tables). With `packed_bits` this rank's K shard is quantized
    on its own, as JAX's (tp divides the groups, so the grid is the whole
    weight's)."""
    from ..quant.packing import quantize_pack_linear

    k = w_full.shape[0]
    if k % mesh.tp:
        raise ValueError(f"K = {k} does not split over tp = {mesh.tp}")
    kl = k // mesh.tp
    k0 = mesh.tp_rank * kl
    w_local = w_full[k0:k0 + kl]
    if packed_bits is not None:
        w_local = quantize_pack_linear(w_local, packed_bits, group_size)

    def fn(x):
        return ring_all_reduce_matmul(x[..., k0:k0 + kl], w_local, mesh)

    return fn
