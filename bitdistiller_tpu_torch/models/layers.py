"""Decoder building blocks for the Llama family: linear dispatch (with the
training forward's weight quantizer), RMSNorm, rotate-half RoPE, the two
attentions the JAX package leaves to XLA (written here as plain einsum +
softmax; the causal one with the training padding mask), and the training
flash attention (`flash_train_attention`, ops/train_attention.py: B8's
kernels on the card, the plain version on the CPU).

Numerics follow the JAX package's `models/layers.py`: f32 RMSNorm
accumulation, f32 attention scores and softmax.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.quant_matmul import quant_matmul, quant_matmul_a8_plain, quant_matmul_plain
from ..ops.train_attention import flash_train_attention  # noqa: F401  (re-exported)
from ..quant.packing import PackedLinear

# A "linear" param leaf is either
#   {"w": [(L,) K, N], "b"?: [(L,) N]}     dense
#   PackedLinear (stacked or not)          packed


def linear(leaf, x: torch.Tensor, li: Optional[int] = None, *,
           use_kernels: bool = True, quantizer=None) -> torch.Tensor:
    """Apply a linear layer; `li` picks layer li of a stacked leaf in place.
    `use_kernels=False` runs the plain packed matmul on any device (a
    reference run on the card; A8-ordered words take the plain A8 version);
    otherwise the device decides. A dense weight goes through `quantizer`
    (the training forward's fake quantizer) in its OWN dtype, then takes x's
    dtype, as the JAX package's linear does."""
    if isinstance(leaf, PackedLinear):
        if use_kernels:
            return quant_matmul(x, leaf, li)
        layer = leaf if li is None else leaf.layer(li)
        x2 = x.reshape(-1, layer.in_features)
        if layer.a8_order:
            return quant_matmul_a8_plain(
                x2, layer.qweight, layer.scales, layer.szeros, layer.bits,
                layer.group_size, True, layer.bias,
            ).reshape(*x.shape[:-1], layer.out_features)
        out = quant_matmul_plain(
            x2, layer.qweight, layer.scales, layer.szeros, layer.bits, layer.group_size,
        ).reshape(*x.shape[:-1], layer.out_features)
        if layer.bias is not None:
            out = out + layer.bias.to(out.dtype)
        return out
    w = leaf["w"] if li is None else leaf["w"][li]
    if quantizer is not None:
        w = quantizer(w)
    out = x @ w.to(x.dtype)
    b = leaf.get("b")
    if b is not None:
        out = out + (b if li is None else b[li]).to(out.dtype)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Llama RMS norm; variance in f32."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.to(torch.float32)).to(x.dtype)


def rope_inv_freq(head_dim: int, theta: float) -> torch.Tensor:
    """Unscaled rope frequencies, computed in f32 as the JAX package does."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    return torch.from_numpy(np.asarray(inv, np.float32))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotate-half RoPE. positions [...] -> [..., head_dim]."""
    inv_freq = rope_inv_freq(head_dim, theta).to(positions.device)
    freqs = positions[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [..., S, D], broadcast over heads."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[..., None, :] + rotated * sin[..., None, :]).to(x.dtype)


def cached_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    ck: torch.Tensor,  # [B, Hkv, T, D] read-only cache (head-major)
    cv: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D] fresh tokens
    v_new: torch.Tensor,
    mask: torch.Tensor,  # [B, 1, S, T+S] bool
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, T]: ck holds int8 codes
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over cache ++ fresh without concatenating the KV: only the
    score tensors are joined. int8 scales fold into the score and prob rows
    (q.(s_t k_t) = s_t (q.k_t), sum_t p_t (s_t v_t) = sum_t (p_t s_t) v_t)."""
    b, s, hq, d = q.shape
    hkv, t = ck.shape[1], ck.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, s, hkv, rep, d).to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    sc_cache = torch.einsum("bshrd,bhtd->bhrst", qg, ck.to(q.dtype).to(torch.float32)) * scale
    if k_scale is not None:
        sc_cache = sc_cache * k_scale[:, :, None, None, :].to(torch.float32)
    sc_new = torch.einsum("bshrd,bthd->bhrst", qg, k_new.to(torch.float32)) * scale
    scores = torch.cat([sc_cache, sc_new], dim=-1)  # [B, Hkv, rep, S, T+S]
    scores = torch.where(mask[:, :, None], scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    p_cache = probs[..., :t]
    if v_scale is not None:
        p_cache = p_cache * v_scale[:, :, None, None, :].to(torch.float32)
    p_cache = p_cache.to(q.dtype)
    p_new = probs[..., t:].to(v_new.dtype)
    out = torch.einsum("bhrst,bhtd->bshrd", p_cache, cv.to(q.dtype)) + torch.einsum(
        "bhrst,bthd->bshrd", p_new, v_new
    )
    return out.reshape(b, s, hq, d)


def causal_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # [B, 1, S, S] bool, or None = causal
) -> torch.Tensor:
    """Causal GQA scaled-dot-product attention; f32 scores and softmax. With
    `mask` (the training padding mask: causal and key is real) the mask
    replaces the causal rule."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, s, hkv, rep, d).to(torch.float32)
    scores = torch.einsum("bshrd,bthd->bhrst", qg, k.to(torch.float32)) / math.sqrt(d)
    if mask is None:
        pos = torch.arange(s, device=q.device)
        scores = torch.where(pos[None, :] <= pos[:, None], scores, -math.inf)
    else:
        scores = torch.where(mask[:, :, None], scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d)
