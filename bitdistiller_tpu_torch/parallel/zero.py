"""ZeRO over a process group: where each leaf of the train state lives, and
the collectives of a data-parallel step (the port's counterpart of the
JAX package's shardings at `train/trainer.py:init_train_state`, which XLA
turns into collectives; here they are explicit).

The port's params are plain dict trees and its optimizer is hand-written,
so ZeRO is a placement of those trees plus a few collectives, not a DDP or
FSDP wrapper around an nn.Module (which would own the parameters, the
gradient hooks and the optimizer the port already has):
- stage 0: every leaf whole on every rank; gradients all-reduced;
- stage 2: the f32 master, Adam's moments and the accumulators split over
  the ranks along `mesh.zero_extend_spec`'s dim (the "optimizer dim");
  gradients reduce-scattered into that split, the update made on the
  shard, the new latents all-gathered;
- stage 3: the latents split too, along the dim of JAX's fsdp spec (the
  "param dim"); gathered whole before each forward.

Gradients are averaged in f32 (every optimizer wrapper takes f32 gradients).
The clip's global norm sums every leaf's squares over the ranks before the
decision (a leaf whole on every rank counts once), so every rank clips
alike.

Under tensor parallelism (a mesh with tp > 1) the plan places each rank's
tp slice (`mesh.shard_params`): ZeRO's reduce-scatter, all-reduce and
all-gather run over the mesh's dp group only, on top of that slice; the
global norm sums over the whole world, a leaf whole across tp (a norm, a
row-parallel bias) counted once; `gather_tp` reassembles whole leaves (the
final save's master). Integer counters are replicated. Under ZeRO-3 the forward gathers
the whole latent tree once a step (a micro-step, or a cycle in the fused
step) and drops it after the backward: between steps a rank holds 1/dp of
the latents, during a step all of them. At world size 1 every collective
still runs, and the step equals the one without a group bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..train.trainer import _get, _set, tree_items
from .mesh import dp_dim, opt_state_specs, param_specs_from_params, tp_dim

# the names torch 2.13 gives the two collectives (older releases: *_tensor)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _param_shaped(node):
    """The first param-shaped spec tree (a dict) in an optimizer state's."""
    if isinstance(node, dict):
        return node
    if isinstance(node, tuple):
        for x in node:
            found = _param_shaped(x)
            if found is not None:
                return found
    return None


def _gather(x: torch.Tensor, dim: int, group, world: int) -> torch.Tensor:
    """The whole leaf from every rank's part along dim, in rank order."""
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((world * front.shape[0],) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, front, group=group)
    return out.movedim(0, dim).contiguous()


class ZeroPlan:
    """The split of one param tree's leaves over `group` (the dp ranks) at
    a ZeRO stage: `pdims[path]` for the latents, `odims[path]` for the
    optimizer state's param-shaped leaves (None: whole on every rank), read
    off the spec trees of the params and of `opt`'s state
    (`mesh.opt_state_specs`); `tdims[path]` the dim a leaf is split along
    over tp (`mesh`: its tp group and rank; `params` is then this rank's tp
    slice)."""

    def __init__(self, params: dict, stage: int, opt, group=None, mesh=None):
        if stage not in (0, 2, 3):
            raise ValueError(f"zero_stage must be 0, 2 or 3, not {stage}")
        self.stage, self.group, self.mesh = stage, group, mesh
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.tp = 1 if mesh is None else mesh.tp
        self.tp_rank = 0 if mesh is None else mesh.tp_rank
        specs = param_specs_from_params(params, "dp" if stage >= 3 else None)
        ospecs = _param_shaped(opt_state_specs(opt, params, specs, self.world, stage))
        self.pdims: dict = {}
        self.odims: dict = {}
        self.tdims = {path: tp_dim(_get(specs, path)) for path, _ in tree_items(params)}
        for path, leaf in tree_items(params):
            shape = tuple(leaf.shape)
            pd = dp_dim(_get(specs, path)) if stage >= 3 else None
            od = dp_dim(_get(ospecs, path))
            for d in (pd, od):
                if d is not None and shape[d] % self.world:
                    raise ValueError(f"{'/'.join(path)}: dim {d} of {shape} does not divide "
                                     f"over dp = {self.world}")
            self.pdims[path], self.odims[path] = pd, od

    # ---- one leaf ----------------------------------------------------------

    def view(self, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's contiguous part of x along dim, a view of x."""
        if dim is None:
            return x
        m = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * m, m)

    def shard(self, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's contiguous part of x along dim (a fresh tensor)."""
        if dim is None:
            return x
        return self.view(x, dim).clone(memory_format=torch.contiguous_format)

    def gather(self, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The whole leaf over dp from every rank's part along dim."""
        return x if dim is None else _gather(x, dim, self.group, self.world)

    def reduce_mean(self, g: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The mean over the ranks of g in f32: this rank's part along dim
        (a reduce-scatter), or the whole (an all-reduce)."""
        if dim is None:
            g = g.to(torch.float32, copy=True)
            dist.all_reduce(g, group=self.group)
            return g / self.world
        front = g.to(torch.float32).movedim(dim, 0).contiguous()
        out = torch.empty((front.shape[0] // self.world,) + tuple(front.shape[1:]),
                          dtype=torch.float32, device=g.device)
        _reduce_scatter(out, front, group=self.group)
        return out.movedim(0, dim).contiguous() / self.world

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a (detached) tensor."""
        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y / self.world

    # ---- trees -------------------------------------------------------------

    def _map(self, fn, tree: dict, dims: dict) -> dict:
        out: dict = {}
        for path, x in tree_items(tree):
            _set(out, path, fn(x, dims[path]))
        return out

    def reduce_grads(self, grads: dict) -> dict:
        """The gradients averaged over the ranks, in f32, split as the
        optimizer state is."""
        return self._map(self.reduce_mean, grads, self.odims)

    def latents_from(self, opt_tree: dict) -> dict:
        """Stored latents from a tree split along the optimizer dims (the
        master cast to the latent dtype, or params + updates): gathered
        where the two dims differ."""
        def place(x, path):
            od, pd = self.odims[path], self.pdims[path]
            return x if od == pd else self.shard(self.gather(x, od), pd)

        out: dict = {}
        for path, x in tree_items(opt_tree):
            _set(out, path, place(x, path))
        return out

    def opt_parts(self, whole: dict, parts: dict) -> dict:
        """The latents split as the optimizer state is, without a copy: this
        rank's own part (`parts`) where the two splits agree, else a view
        of the whole leaf."""
        out: dict = {}
        for path, x in tree_items(whole):
            od = self.odims[path]
            _set(out, path, _get(parts, path) if od == self.pdims[path] else self.view(x, od))
        return out

    def dims(self, which: str) -> dict:
        """The split dims of "params" (the latents) or "opt" (a param-shaped
        tree of the optimizer state)."""
        return self.pdims if which == "params" else self.odims

    def gather_tree(self, tree: dict, which: str) -> dict:
        """A whole tree from its parts."""
        return self._map(self.gather, tree, self.dims(which))

    def shard_tree(self, tree: dict, which: str) -> dict:
        return self._map(self.shard, tree, self.dims(which))

    def gather_tp(self, tree: dict) -> dict:
        """Whole leaves from the tp ranks' slices (a tree whole over dp)."""
        if self.tp == 1:
            return tree
        return self._map(lambda x, d: x if d is None else _gather(
            x, d, self.mesh.tp_group, self.tp), tree, self.tdims)

    def global_norm(self, items) -> torch.Tensor:
        """optax's global norm of the whole gradient from the ranks' parts:
        each leaf's f32 sum of squares (a leaf whole over dp counted on dp
        rank 0 only, one whole over tp on tp rank 0 only), summed over every
        rank, then over the leaves in order."""
        sq = []
        for path, g in items:
            s = torch.sum(g.to(torch.float32) ** 2)
            if ((self.odims[path] is None and self.rank != 0)
                    or (self.tdims[path] is None and self.tp_rank != 0)):
                s = torch.zeros_like(s)
            sq.append(s)
        sq = torch.stack(sq)
        dist.all_reduce(sq, group=self.group if self.tp == 1 else None)
        total = None
        for s in sq:
            total = s if total is None else total + s
        return torch.sqrt(total)

