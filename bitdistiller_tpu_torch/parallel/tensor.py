"""Megatron's explicit tensor-parallel collectives (no JAX counterpart: GSPMD
inserts them from the shardings of `parallel/mesh.py`), as autograd
Functions over a mesh's tp group:

- `copy_to_tp`: the identity forward; the backward all-reduces the
  gradient over tp (the input of a column-parallel linear, whose ranks
  each see part of the output);
- `reduce_from_tp`: the forward all-reduces (the partial outputs of a
  row-parallel linear); the identity backward;
- `gather_from_tp`: the forward concatenates every rank's last dim in rank
  order (the vocab-parallel logits); the backward takes this rank's slice;
- `vocab_parallel_embed`: rows outside the rank's vocab range masked to
  zero, then `reduce_from_tp`.

Sums run in f32 and round once to the input's dtype, as a single
device's f32 accumulation would. At tp = 1 (or without a mesh) each is the
identity and issues no collective. Each collective goes through
`distributed.boundary`, so that a segmented CUDA graph capture records it
between two segments; the buffers it writes (the f32 sum, the gathered
parts) are allocated before it, in the segment that ends there, and handed
to the operation as arguments, never held by its closure.
`tp_config` is the config of one tp rank's slice, and the check that a
config splits over tp at all.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .distributed import boundary


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    boundary("all_reduce", lambda r, w: dist.all_reduce(w[0], group=group), group, reads=(y,),
             writes=(y,))
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.n = rank, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(size)]
        x = x.contiguous()
        boundary("all_gather", lambda r, w: dist.all_gather(list(w), r[0], group=group), group,
                 reads=(x,), writes=tuple(parts))
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if _tp(mesh) == 1 else _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if _tp(mesh) == 1 else _ReduceFromTP.apply(x, mesh.tp_group)


def gather_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    if _tp(mesh) == 1:
        return x
    return _GatherFromTP.apply(x, mesh.tp_group, mesh.tp, mesh.tp_rank)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """table[tokens] from each rank's contiguous vocab rows [V / tp, d]."""
    if _tp(mesh) == 1:
        return table[tokens]
    v = table.shape[0]
    local = tokens - mesh.tp_rank * v
    inside = (local >= 0) & (local < v)
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    return reduce_from_tp(rows * inside[..., None].to(rows.dtype), mesh)


def tp_config(cfg, tp: int):
    """The config of one rank's slice at tensor-parallel size tp: hq / tp
    query and hkv / tp kv heads (head_dim kept), intermediate / tp of the
    MLP, vocab / tp rows. Raises where a head, the MLP or the vocab would
    not split whole (no head is ever split: Falcon-7B's one kv head cannot
    be placed at tp = 2, as JAX's KV spec cannot place it)."""
    if tp == 1:
        return cfg
    for what, n in (("num_kv_heads", cfg.num_kv_heads), ("num_heads", cfg.num_heads),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"tensor parallelism: {what} = {n} is not a multiple of tp = {tp} "
                             f"(a tp rank holds whole heads, MLP columns and vocab rows)")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               head_dim=cfg.actual_head_dim,
                               intermediate_size=cfg.intermediate_size // tp,
                               vocab_size=cfg.vocab_size // tp)
