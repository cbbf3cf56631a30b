"""The JAX package's `parallel/mesh.py` for a process group: the (dp, tp)
mesh of the ranks, the partition-spec tables of a param tree, a packed tree
and the KV cache, ZeRO's rule for the dim each leaf is split along, and the
placement of a tree by its specs.

A spec is a tuple of None, "dp" and "tp", one entry a dim, equal to JAX's
entry for entry. In the port "sharding" means one thing: each rank keeps
only its slice of each leaf, cut by the spec's "tp" and "dp" entries
(`shard_params`, `shard_packed_model`); GSPMD's collectives become the
explicit ones of `tensor.py` (the tp forward) and `zero.py` (ZeRO over dp).
A "tp" dim is taken even at tp = 1, so ZeRO never splits it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

# Megatron-style TP of the stacked-layer tree ([L, K, N] leaves), as JAX:
# column-parallel (shard N) q, k, v, gate, up and the fused qkv, gate_up;
# row-parallel (shard K) o, down. fsdp_axis="dp" puts dp on the other
# matrix dim (ZeRO-3).
_COL = ("q", "k", "v", "gate", "up")
ROW_PARALLEL = ("o", "down")
_COL_FUSED = ("qkv", "gate_up")


class P(tuple):
    """A partition spec: one entry (None, "dp" or "tp") a dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, tp) mesh of the process group, one device a rank, tp
    innermost as JAX's `reshape(dp, tp)`: rank = dp_rank * tp + tp_rank.
    `dp_group` holds the ranks of this rank's tp index (ZeRO's collectives
    run over it), `tp_group` those of its dp index (the tp forward's); both
    None outside a process group. `ring_cache` keeps the ring matmuls'
    weight chunks (`overlap.ring_chunks`)."""

    dp: int
    tp: int = 1
    dp_rank: int = 0
    tp_rank: int = 0
    dp_group: Any = None
    tp_group: Any = None
    ring_cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The mesh of the world (one device outside a process group): dp * tp
    must be the world size (dp defaults to world // tp). At tp > 1 every
    rank creates every dp and tp group (`dist.new_group`) in the same
    order; at tp = 1 the dp group is the world."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    if not dist.is_initialized():
        return Mesh(dp=1)
    dp_rank, tp_rank = divmod(dist.get_rank(), tp)
    if tp == 1:
        return Mesh(dp=dp, tp=1, dp_rank=dp_rank, dp_group=dist.group.WORLD)
    dp_group = tp_group = None
    for t in range(tp):  # every rank makes every group, in this order
        g = dist.new_group([d * tp + t for d in range(dp)])
        if t == tp_rank:
            dp_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)])
        if d == dp_rank:
            tp_group = g
    return Mesh(dp=dp, tp=tp, dp_rank=dp_rank, tp_rank=tp_rank, dp_group=dp_group,
                tp_group=tp_group)


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
        if name in _COL or name in ROW_PARALLEL or name in _COL_FUSED:
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


def tp_dim(spec: P) -> Optional[int]:
    """The dim a spec splits over tp, or None (whole on every tp rank)."""
    return spec.index("tp") if "tp" in spec else None


def _meta_tree(shapes: dict) -> dict:
    tree: dict = {}
    for path, shape in shapes.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, device="meta")
    return tree


def param_specs(cfg, fsdp_axis: Optional[str] = None) -> dict:
    """The spec tree of `init_params(cfg)`'s tree, read off the port's
    shape table (`models.llama.param_shapes`) as JAX reads it off an
    abstract init: nothing is allocated."""
    from ..models.llama import param_shapes

    return param_specs_from_params(_meta_tree(param_shapes(cfg)), fsdp_axis)


def packed_param_specs(cfg) -> dict:
    """The specs of an unfused packed tree (`pack_model(..., fuse=False)`),
    JAX's table: each PackedLinear's qweight, scales, szeros (and combo)
    split along N (column-parallel) or their packed K rows (row-parallel)
    by one spec a linear, set for every name of the two lists."""
    specs = param_specs(cfg)
    for name in _COL:
        specs["layers"][name] = P(None, None, "tp")
    for name in ROW_PARALLEL:
        specs["layers"][name] = P(None, "tp", None)
    return specs


def kv_cache_specs(quantized: bool = False):
    """The KV cache [L, B, Hkv, T, D]: batch over dp, kv heads over tp; the
    int8 cache's scales [L, B, Hkv, T] alike."""
    from ..models.llama import KVCache

    kv = P(None, "dp", "tp", None, None)
    if quantized:
        s = P(None, "dp", "tp", None)
        return KVCache(k=kv, v=kv, k_scale=s, v_scale=s)
    return KVCache(k=kv, v=kv)


def take(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf by its spec (a fresh contiguous
    tensor; the leaf itself where the spec splits nothing on this mesh)."""
    out = x
    for d, e in enumerate(spec):
        size, rank = {"tp": (mesh.tp, mesh.tp_rank), "dp": (mesh.dp, mesh.dp_rank)}.get(
            e, (1, 0))
        if size == 1:
            continue
        n = x.shape[d]
        if n % size:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide over {e} = {size}")
        out = out.narrow(d, rank * (n // size), n // size)
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def shard_params(params: dict, mesh: Mesh, specs: dict) -> dict:
    """Each leaf of the tree cut to this rank's slice by the spec tree (None
    leaves stay None)."""
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, specs[k]) for k, v in params.items()}
    return None if params is None else take(params, specs, mesh)


def shard_packed_model(params: dict, mesh: Mesh, cfg) -> dict:
    """This rank's slice of an unfused packed tree (`pack_model(...,
    fuse=False)`) by `packed_param_specs`: each PackedLinear's arrays cut
    together along N (column-parallel, its bias too) or along the packed K
    rows (row-parallel, the bias whole), its in/out features set to the
    slice's. A fused leaf, A8-ordered words, or a row-parallel slice whose
    quantization groups would straddle a shard edge raise."""
    from ..quant.packing import PackedLinear
    from .tensor import tp_config

    tp_config(cfg, mesh.tp)
    specs = packed_param_specs(cfg)
    out = dict(params)
    for key in params:
        if key != "layers":
            out[key] = shard_params(params[key], mesh, specs[key])
    layers = {}
    for name, leaf in params["layers"].items():
        spec = specs["layers"].get(name)
        if not isinstance(leaf, PackedLinear):
            layers[name] = shard_params(leaf, mesh, spec)
            continue
        if name in _COL_FUSED and mesh.tp > 1:
            raise ValueError(f"the fused leaf {name!r} cannot be split over tp = {mesh.tp} "
                             f"without mixing its parts: pack with pack_model(..., fuse=False)")
        if leaf.a8_order:
            raise ValueError(f"{name}: A8-ordered words are not sharded; repack after sharding")
        col = spec[2] == "tp"
        if not col and (leaf.in_features // mesh.tp) % leaf.group_size:
            raise ValueError(f"{name}: K = {leaf.in_features} over tp = {mesh.tp} leaves "
                             f"{leaf.in_features // mesh.tp} rows, not whole groups of "
                             f"{leaf.group_size}: a group would straddle a shard edge")
        cut = lambda a, s=spec: None if a is None else take(a, s, mesh)
        layers[name] = dataclasses.replace(
            leaf, qweight=cut(leaf.qweight), scales=cut(leaf.scales), szeros=cut(leaf.szeros),
            combo=cut(leaf.combo),
            bias=cut(leaf.bias, P(None, "tp") if col else P(None, None)),
            in_features=leaf.in_features if col else leaf.in_features // mesh.tp,
            out_features=leaf.out_features // mesh.tp if col else leaf.out_features)
    out["layers"] = layers
    return out
