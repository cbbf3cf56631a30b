"""GPipe-style pipeline parallelism over the first pp ranks of the process
group (the JAX package's `parallel/pipeline.py`).

The decoder's stacked layer leaves ([L, ...], PackedLinear fields
included) are cut along L, L / pp layers a stage, one stage a rank
(`shard_params_pp`); embed, final_norm and lm_head stay whole on every
rank. `pipeline_forward` runs the cache-less forward microbatch-pipelined:
at tick t stage s runs its layers on microbatch t - s and sends the
activation to stage s + 1 (point-to-point, `distributed.isend`: through
host memory for a CUDA tensor over gloo), so after the first pp - 1 ticks
every stage is busy; the bubble is (pp - 1) / (n_micro + pp - 1). A stage
skips its idle ticks (JAX's SPMD program computes them on don't-care data
and masks them). The last stage's hidden states reach every rank of the
group by a broadcast (JAX's masked psum), and each rank applies the final
norm and the lm_head.

Scope, as JAX's: the cache-less forward (prefill, eval, the KD forward of
teacher and student). Decode serving takes tensor parallelism
(`parallel/mesh.py`, `serve/engine.py`).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional

import torch
import torch.distributed as dist

from ..quant.packing import PackedLinear
from .distributed import irecv, isend
from .mesh import P

if TYPE_CHECKING:
    from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class PPMesh:
    """The pipeline's ranks: global ranks 0 .. pp - 1, stage s on rank s.
    `stage` is None on a rank outside them; `group` holds the pp ranks
    (None outside a process group)."""

    pp: int
    stage: Optional[int] = 0
    group: Any = None


def make_pp_mesh(pp: int) -> PPMesh:
    """The first `pp` ranks of the world, one stage a rank. Every rank of
    the world calls it (`dist.new_group` is collective)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if pp > n:
        raise ValueError(f"pp={pp} > device count {n}")
    if not dist.is_initialized():
        return PPMesh(pp=1)
    rank = dist.get_rank()
    group = dist.new_group(list(range(pp)))
    inside = rank < pp
    return PPMesh(pp=pp, stage=rank if inside else None, group=group if inside else None)


def _map_layers(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_layers(fn, v) for k, v in tree.items()}
    if isinstance(tree, PackedLinear):
        cut = lambda a: None if a is None else fn(a)
        return dataclasses.replace(tree, qweight=cut(tree.qweight), scales=cut(tree.scales),
                                   szeros=cut(tree.szeros), combo=cut(tree.combo),
                                   bias=cut(tree.bias))
    return fn(tree)


def pp_param_specs(params: dict) -> dict:
    """Layer-stacked leaves ([L, ...]; a PackedLinear's arrays each) split
    along L over `pp`; everything else (embed, final_norm, lm_head)
    whole."""
    return {k: _map_layers(lambda _: P("pp"), v) if k == "layers"
            else _map_layers(lambda _: P(), v) for k, v in params.items()}


def shard_params_pp(params: dict, mesh: PPMesh) -> dict:
    """This rank's tree: its stage's L / pp layers of every stacked leaf (a
    fresh contiguous copy, so that the whole tree can be freed), the rest
    whole. A rank outside the pipeline keeps no layer."""
    out = {k: v for k, v in params.items() if k != "layers"}
    if mesh.stage is None:
        out["layers"] = {}
        return out

    def cut(x):
        n = x.shape[0]
        if n % mesh.pp:
            raise ValueError(f"num_layers {n} % pp {mesh.pp} != 0")
        per = n // mesh.pp
        return x.narrow(0, mesh.stage * per, per).clone(memory_format=torch.contiguous_format)

    out["layers"] = _map_layers(cut, params["layers"])
    return out


def pipeline_forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int; B % n_micro == 0
    mesh: PPMesh,
    *,
    n_micro: int = 2,
    quantizer=None,
    logits_dtype=torch.float32,
) -> torch.Tensor:
    """Cache-less decoder forward, pipelined over the mesh's pp stages
    (GPipe's fill and drain: n_micro + pp - 1 ticks). `params` is this
    rank's `shard_params_pp` tree; each stage runs its layers through
    `llama._stack`, the forward's own layer loop. Returns logits [B, S, V]
    on every rank of the process group (equal to `llama.forward` on the
    whole tree, tests/test_torch_pp.py)."""
    from ..models import llama  # the models import this package

    S = mesh.pp
    if cfg.num_layers % S != 0:
        raise ValueError(f"num_layers {cfg.num_layers} % pp {S} != 0")
    b, s = tokens.shape
    if b % n_micro != 0:
        raise ValueError(f"batch {b} % n_micro {n_micro} != 0")
    mb = b // n_micro

    # replicated pre/post stages (small next to the layer stack)
    h, positions, start = llama._embed(params, cfg, tokens, 0, None)
    micro = h.reshape(n_micro, mb, s, h.shape[-1])
    hidden = torch.empty_like(micro)
    if mesh.stage is not None:
        stage, per = mesh.stage, cfg.num_layers // S
        layers = range(stage * per, (stage + 1) * per)
        sends = []
        for t in range(n_micro + S - 1):
            m = t - stage
            if not 0 <= m < n_micro:
                continue  # the fill or the drain: this stage idles at tick t
            if stage == 0:
                x = micro[m]
            else:
                x = torch.empty(micro.shape[1:], dtype=micro.dtype, device=micro.device)
                irecv(x, stage - 1, mesh.group).wait()
            y, _, _ = llama._stack(cfg, params["layers"], x, positions, start[:mb], layers,
                                   quantizer=quantizer)
            if stage == S - 1:
                hidden[m] = y
            else:
                sends.append(isend(y, stage + 1, mesh.group))
        for w in sends:
            w.wait()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast(hidden, src=S - 1)  # the last stage's outputs, on every rank
    return llama._head(params, cfg, hidden.reshape(b, s, -1), None, logits_dtype)
