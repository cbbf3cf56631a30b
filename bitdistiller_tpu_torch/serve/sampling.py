"""Token sampling: temperature / top-k / top-p / repetition penalty (PyTorch
port of the JAX package's `serve/sampling.py`, same processor order; greedy
when temperature == 0). Random draws come from a `torch.Generator` and so
differ from `jax.random` draws: only greedy results are comparable token
for token, stochastic ones by distribution."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.7
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    repetition_window: int = 512


def _seen(prev_tokens: torch.Tensor, v: int) -> torch.Tensor:
    """[B, V] bool: which ids occur in the window (pad entries are < 0)."""
    valid = prev_tokens >= 0
    safe = torch.where(valid, prev_tokens, 0).to(torch.int64)
    counts = torch.zeros((prev_tokens.shape[0], v), dtype=torch.int32, device=prev_tokens.device)
    counts.scatter_add_(1, safe, valid.to(torch.int32))
    return counts > 0


def apply_repetition_penalty(logits: torch.Tensor, prev_tokens: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF semantics: for seen tokens, positive logits /= p, negative *= p.
    `penalty` is a float or a [B, 1] tensor."""
    seen = _seen(prev_tokens, logits.shape[-1])
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_mask = cum - probs >= p  # keep while the exclusive mass < p; top-1 always
    cutoff = torch.where(cutoff_mask, torch.inf, sorted_logits).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, -torch.inf, logits)


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
    prev_tokens: Optional[torch.Tensor] = None,  # [B, W], pad -1
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Next tokens [B] int32 (greedy if temperature == 0)."""
    logits = logits.to(torch.float32)
    if params.repetition_penalty != 1.0 and prev_tokens is not None:
        logits = apply_repetition_penalty(logits, prev_tokens, params.repetition_penalty)
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / params.temperature
    if params.top_k > 0:
        logits = _top_k_mask(logits, params.top_k)
    if params.top_p < 1.0:
        logits = _top_p_mask(logits, params.top_p)
    return _categorical(logits, generator)


def sample_tokens_batched(
    logits: torch.Tensor,  # [B, V]
    temps: torch.Tensor,  # [B] (0 = greedy per row)
    top_ks: torch.Tensor,  # [B] int (0 = disabled per row)
    top_ps: torch.Tensor,  # [B] (1.0 = disabled per row)
    rep_pens: torch.Tensor,  # [B] (1.0 = disabled per row)
    prev_tokens: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Per-row sampling parameters (slots with different request settings in
    one step). One descending sort serves the per-row top-k threshold and
    the top-p cutoff."""
    logits = logits.to(torch.float32)
    b, v = logits.shape
    if prev_tokens is not None:
        logits = apply_repetition_penalty(logits, prev_tokens, rep_pens[:, None])
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    ranks = torch.arange(v, device=logits.device)[None, :]
    k_cut = (top_ks[:, None] > 0) & (ranks >= top_ks[:, None])
    sorted_masked = torch.where(k_cut, -torch.inf, sorted_desc)
    kth_idx = torch.clamp(top_ks.to(torch.int64) - 1, 0, v - 1)[:, None]
    kth = torch.where(top_ks > 0, sorted_desc.gather(1, kth_idx)[:, 0], -torch.inf)
    scaled = torch.where(scaled < kth[:, None], -torch.inf, scaled)
    probs = torch.softmax(sorted_masked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_mask = cum - probs >= top_ps[:, None]
    cutoff = torch.where(cutoff_mask, torch.inf, sorted_masked).amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled < cutoff, -torch.inf, scaled)
    sampled = _categorical(scaled, generator)
    return torch.where(temps == 0.0, greedy, sampled)
