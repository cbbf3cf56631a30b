"""Serving capacity planning: how many engine slots fit one card's memory for
a packed model at a context length and KV dtype (PyTorch port of the JAX
package's `serve/capacity.py`).

Analytic, nothing allocated: exact for the KV cache (the bytes of
`KVCache.init`), component-modeled for the packed weights (codes, one combo
word a group column, everything else bf16). The shapes come from the port's
own table of the dense tree (`models.llama.param_table`).
`tp_decode_scaling` projects a tp-split decode step's efficiency from a
measured one-card step and the link figures.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.llama import LAYER_LINEARS, param_table
from .engine import CACHE_BUCKET_FACTOR, graph_rows_bytes

GiB = 1024**3


def packed_model_bytes(cfg: ModelConfig, *, bits: int = 2, group_size: int = 128) -> int:
    """Bytes of a pack_model() tree: the stacked [L, K, N] linear weights as
    `bits`-wide codes plus one int32 combo word (bf16 scale and szero) a
    group column; every other leaf (embeddings, norms, lm_head, biases)
    bf16."""
    total = 0
    linear_names = set(LAYER_LINEARS) | {"qkv", "gate_up"}
    for path, (shape, _) in param_table(cfg).items():
        n = math.prod(shape)
        if (len(path) >= 2 and path[-1] == "w" and path[-2] in linear_names
                and len(shape) == 3):
            total += n * bits // 8  # packed codes
            total += n // group_size * 4  # combo words
        else:
            total += n * 2  # bf16
    return total


def kv_bytes_per_slot(cfg: ModelConfig, max_len: int, kv_dtype=torch.bfloat16) -> int:
    """Exact bytes of one slot of KVCache.init: k and v planes, plus the f32
    per-token scale planes [L, B, H, T] of an int8 cache."""
    per = 2 * cfg.num_layers * cfg.num_kv_heads * max_len  # k + v rows
    itemsize = torch.empty((), dtype=kv_dtype).element_size()
    total = per * cfg.actual_head_dim * itemsize
    if kv_dtype == torch.int8:
        total += per * 4
    return total


def serve_capacity(cfg: ModelConfig, *, bits: int = 2, group_size: int = 128,
                   max_len: int = 2048, kv_dtype=torch.bfloat16, tp: int = 1,
                   hbm_bytes: Optional[int] = None, reserve_frac: float = 0.10,
                   grow_cache: bool = True, prompt_cache_bytes: int = 0,
                   graphs: bool = True) -> dict:
    """Max engine slots for one card (or a tp group: weights and KV heads
    divide by tp). `hbm_bytes` defaults to the current CUDA device's
    memory; without a card the caller passes it. `reserve_frac` holds
    memory back for activations and transients.

    grow_cache (the engine default) sizes the peak for the worst growth
    step: old and new caches coexist during the copy, so the last growth to
    max_len peaks at (1 + 1/CACHE_BUCKET_FACTOR) of the full cache. Capacity-critical
    deployments pass grow_cache=False (Engine(grow_cache=False)) and plan
    against the flat full-size cache. Engine(prompt_cache_bytes=...) holds
    device buffers on top of the slots: they come out of the budget. So do,
    with `graphs` (the engine's graph route, its default on the card with
    or without a mesh), the rows a captured prefill writes at the rank's
    kv heads (`engine.graph_rows_bytes(cfg, tp)`). The graphs' pool (a
    captured piece's transients and last logits, which every key reuses;
    under a mesh the buffers of the operations between segments are such
    transients too) is left to `reserve_frac`, as the eager route's
    transients are."""
    if hbm_bytes is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass hbm_bytes to plan "
                               "for a card from the CPU")
        hbm_bytes = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    weights = packed_model_bytes(cfg, bits=bits, group_size=group_size) // tp
    per_slot = kv_bytes_per_slot(cfg, max_len, kv_dtype) // tp
    if grow_cache:
        per_slot = per_slot + per_slot // CACHE_BUCKET_FACTOR  # growth peak
    rows = graph_rows_bytes(cfg, tp) if graphs else 0
    budget = int(hbm_bytes * (1 - reserve_frac)) - weights - int(prompt_cache_bytes) - rows
    slots = max(budget // per_slot, 0)
    return {
        "weights_bytes": weights,
        "graph_rows_bytes": rows,
        "kv_bytes_per_slot": per_slot,
        "budget_bytes": budget,
        "max_slots": int(slots),
    }


# NVIDIA's H100 SXM data sheet: 900 GB/s of NVLink a card, both directions
# together, 450 GB/s each way (a data-sheet figure, not a measurement).
H100_NVLINK_BW = 450e9


def tp_decode_scaling(cfg: ModelConfig, *, t_step_s: float, batch: int, tp: int,
                      link_latency_s: float, link_bw: float = H100_NVLINK_BW) -> dict:
    """Projected decode-step scaling efficiency of a tp-split engine (the
    JAX package's `serve/capacity.py:tp_decode_scaling`, the same formula):
    two all-reduces a layer of the [B, hidden] bf16 activations (after o
    and down; a ring moves 2 (tp - 1) / tp of them) and one all-gather of
    the [B, vocab / tp] logits, each paying `link_latency_s` (no data sheet
    gives a collective's latency: the caller states it); everything else
    divides by tp. efficiency = t_1 / (tp (t_1 / tp + t_comm)). `t_step_s`
    must be a measured one-card step."""
    if tp == 1:
        return {"tp": 1, "t_step_s": t_step_s, "t_comm_s": 0.0, "efficiency": 1.0}
    ar_bytes = batch * cfg.hidden_size * 2
    t_ar = 2 * cfg.num_layers * (2 * (tp - 1) / tp * ar_bytes / link_bw + link_latency_s)
    t_ag = (tp - 1) / tp * batch * cfg.vocab_size * 2 / link_bw + link_latency_s
    t_comm = t_ar + t_ag
    t_local = t_step_s / tp
    return {"tp": tp, "t_step_s": t_local + t_comm, "t_comm_s": t_comm,
            "efficiency": t_step_s / (tp * (t_local + t_comm))}
