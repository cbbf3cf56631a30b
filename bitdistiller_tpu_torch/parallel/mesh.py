"""The dp half of the JAX package's `parallel/mesh.py`: the (dp, tp) mesh of
a process group, the partition-spec table of a param tree, and ZeRO's rule
for the dim each leaf is split along.

Nothing here is executed under tensor parallelism: the specs keep JAX's
"tp" entries (a spec is a tuple of None, "dp" and "tp", one entry a dim)
because ZeRO's rule reads them. A "tp" dim is taken, even at tp = 1, so
ZeRO never splits it. `zero.py` places the train state by these tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

# Megatron-style TP of the stacked-layer tree ([L, K, N] leaves), as JAX:
# column-parallel (shard N) q, k, v, gate, up and the fused qkv, gate_up;
# row-parallel (shard K) o, down. fsdp_axis="dp" puts dp on the other
# matrix dim (ZeRO-3).
_COL = ("q", "k", "v", "gate", "up")
_ROW = ("o", "down")
_COL_FUSED = ("qkv", "gate_up")


class P(tuple):
    """A partition spec: one entry (None, "dp" or "tp") a dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, tp) mesh of the process group: dp ranks, each one device."""

    dp: int
    tp: int = 1


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """dp is the world size (1 outside a process group). tp > 1 raises:
    tensor parallelism waits for the TP slice."""
    if tp > 1:
        raise NotImplementedError(
            "tensor parallelism (tp > 1) is not ported yet: it comes with the TP slice "
            "(the Megatron specs, ring matmuls and GPipe); the port runs dp only")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    return Mesh(dp=dp, tp=tp)


def _rep(leaf) -> P:
    return P(*([None] * leaf.ndim))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_specs_from_params(params: dict, fsdp_axis: Optional[str] = None) -> dict:
    """The spec tree of the ACTUAL param tree, JAX's rule verbatim: every
    family's leaves are mirrored; linears are column- or row-parallel,
    norms and other per-layer vectors replicated, the embedding
    vocab-sharded, any other top-level leaf replicated."""
    f = fsdp_axis

    def linear_spec(name, leaf):
        col = name in _COL or name in _COL_FUSED
        out: dict = {"w": P(None, f, "tp") if col else P(None, "tp", f)}
        if isinstance(leaf, dict) and "b" in leaf:
            out["b"] = P(None, "tp") if col else P(None, None)
        return out

    layers: dict = {}
    for name, leaf in params["layers"].items():
        if name in _COL or name in _ROW or name in _COL_FUSED:
            layers[name] = linear_spec(name, leaf)
        else:
            layers[name] = _map(_rep, leaf)
    specs = {
        "embed": P("tp", f),
        "final_norm": _map(_rep, params["final_norm"]),
        "layers": layers,
    }
    if "lm_head" in params:
        specs["lm_head"] = {"w": P(f, "tp")}
    for key in params:
        if key not in specs:
            specs[key] = _map(_rep, params[key])
    return specs


def zero_extend_spec(spec: P, shape: tuple, dp_size: int, axis: str = "dp") -> P:
    """ZeRO-2's split: `axis` on the first unsharded dim whose size divides
    by dp; the spec unchanged if it has `axis` already (ZeRO-3) or no dim
    divides (the leaf stays whole on every rank)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if axis in entries:
        return spec
    for d, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % dp_size == 0 and n >= dp_size:
            entries[d] = axis
            return P(*entries)
    return spec


def opt_state_specs(opt, params: dict, specs: dict, dp_size: int, zero_stage: int = 2):
    """The spec tree of `opt.init(params)`: each param-shaped tree (Adam's
    moments, the f32 master, the accumulators) takes the params' specs,
    extended over dp from stage 2 on; integer counters are replicated
    (P()). The state is built on the meta device: nothing is allocated.
    `zero.ZeroPlan` reads its split of the optimizer state from here."""
    meta = _map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype, device="meta"), params)
    ext = ((lambda spec, leaf: zero_extend_spec(spec, tuple(leaf.shape), dp_size))
           if zero_stage >= 2 else (lambda spec, leaf: spec))

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(x) for x in node))
        if isinstance(node, dict):
            return _zip_map(ext, specs, node)
        return P()

    return walk(opt.init(meta))


def _zip_map(fn, specs, tree):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def dp_dim(spec: P) -> Optional[int]:
    """The dim a spec splits over dp, or None (whole on every rank)."""
    return spec.index("dp") if "dp" in spec else None


def batch_spec() -> P:
    return P("dp")
