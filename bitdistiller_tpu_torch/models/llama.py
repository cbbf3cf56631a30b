"""Llama decoder as plain functions over a stacked-layer param dict (PyTorch
port of the JAX package's `models/llama.py`, Llama family only).

Params keep the JAX layout: every layer leaf carries a leading [L] axis, and
the layer loop is a Python loop over `li` that reads each layer in place
(views, no copies). Packed leaves are stacked `PackedLinear`s with fused
`qkv` and `gate_up`.

Two forward cases:
  * cache-less prefill (`cache=None`), optionally returning each layer's
    fresh k/v [L, B, S, Hkv, D] (`return_kv=True`);
  * decode against the head-major cache [L, B, Hkv, T, D] with a scalar or
    per-slot `cache_pos`. At S=1 attention runs through the decode attention
    kernel (`ops/decode_attention.py`); otherwise through `cached_attention`.
    The fresh tokens are written back into the cache IN PLACE (the JAX
    package returns a new cache; here the returned cache is the same object).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .._device import resolve_device, torch_dtype
from ..ops.decode_attention import decode_attention_plain, flash_decode_stacked
from .config import ModelConfig
from .layers import (
    apply_rope,
    cached_attention,
    causal_attention,
    linear,
    rms_norm,
    rope_cos_sin,
)

@dataclasses.dataclass
class KVCache:
    """Static KV cache, head-major [L, B, Hkv, T, D]: each (batch, head) is a
    contiguous [T, D] plane. dtype int8 keeps symmetric per-token codes with
    f32 scales [L, B, Hkv, T]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
             device="cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.actual_head_dim)
        if dtype == torch.int8:
            return KVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=dev),
                v=torch.zeros(shape, dtype=torch.int8, device=dev),
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            )
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
        )


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-token quantization along the trailing head_dim:
    x [..., T, D] -> (codes int8 [..., T, D], scale f32 [..., T])."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    codes = torch.round(xf / scale[..., None])
    return codes.to(torch.int8), scale


_UNSUPPORTED = (
    ("qk_norm", False), ("attention_bias", False), ("mlp_bias", False),
    ("attention_out_bias", False), ("parallel_block", False), ("sandwich_norm", False),
    ("alibi", False), ("use_rope", True), ("learned_pos_embeddings", False),
    ("embedding_norm", False), ("sliding_window", None), ("sliding_layers", None),
    ("rope_scaling_type", None),
    ("embedding_multiplier", 1.0), ("norm_offset", 0.0), ("norm_type", "rms"),
    ("mlp_style", "gated"), ("hidden_act", "silu"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model-family flags this port does not run yet."""
    bad = [f"{name}={getattr(cfg, name)!r}" for name, ok in _UNSUPPORTED
           if getattr(cfg, name) != ok]
    if bad:
        raise NotImplementedError(
            "the PyTorch port runs the Llama family only; unsupported: " + ", ".join(bad)
        )


def _cache_mask(cache: KVCache, start, s: int):
    """[B, 1, S, T+S] mask over cache ++ fresh: cache rows valid strictly
    below the slot's start; fresh token j causally visible."""
    b = start.shape[0]
    t = cache.k.shape[3]
    ar = torch.arange(s, device=start.device)
    k_pos = torch.arange(t, device=start.device)[None, None, :]
    allow_cache = (k_pos < start.reshape(-1, 1, 1)).expand(b, s, t)
    allow_new = (ar[None, :] <= ar[:, None]).expand(b, s, s)
    return torch.cat([allow_cache, allow_new], dim=-1)[:, None]


def _write_back(cache: KVCache, nk, nv, start, s: int) -> None:
    """Write fresh k/v [L, B, S, Hkv, D] into the cache at each slot's start,
    in place. Starts clamp to T - S, as XLA's dynamic_update_slice does."""
    b = start.shape[0]
    t = cache.k.shape[3]
    nk = nk.permute(0, 1, 3, 2, 4)  # [L, B, Hkv, S, D]
    nv = nv.permute(0, 1, 3, 2, 4)
    if cache.quantized:
        nk, nks = quantize_kv(nk)
        nv, nvs = quantize_kv(nv)
    st = torch.clamp(start.to(torch.int64), 0, t - s)
    t_idx = st[:, None] + torch.arange(s, device=st.device)[None, :]  # [B, S]
    b_idx = torch.arange(b, device=st.device)[:, None]
    # [L, B, H, T, D] viewed as [B, T, L, H, D]: index (slot, row) pairs
    cache.k.permute(1, 3, 0, 2, 4)[b_idx, t_idx] = nk.permute(1, 3, 0, 2, 4).to(cache.k.dtype)
    cache.v.permute(1, 3, 0, 2, 4)[b_idx, t_idx] = nv.permute(1, 3, 0, 2, 4).to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale.permute(1, 3, 0, 2)[b_idx, t_idx] = nks.permute(1, 3, 0, 2)
        cache.v_scale.permute(1, 3, 0, 2)[b_idx, t_idx] = nvs.permute(1, 3, 0, 2)


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    *,
    cache: Optional[KVCache] = None,
    cache_pos=0,  # int, 0-d tensor, or [B] tensor of per-slot positions
    return_kv: bool = False,
    logits_dtype=torch.float32,
    use_kernels: bool = True,
):
    """Returns (logits [B, S, V], cache | prompt KV | None).

    `use_kernels=False` routes the packed matmuls and the decode attention
    through their plain versions on any device: a reference run on the
    card. Otherwise CUDA tensors go through the kernels and CPU tensors
    through the plain versions."""
    check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    cdt = torch_dtype(cfg.dtype)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.actual_head_dim
    h = params["embed"][tokens].to(cdt)

    pos = torch.as_tensor(cache_pos, device=dev)
    per_slot = pos.ndim == 1
    ar = torch.arange(s, device=dev)
    positions = pos[:, None] + ar[None, :] if per_slot else (ar + pos)[None, :]
    cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta, cdt)
    start = (pos if per_slot else pos.expand(b)).to(torch.int32)

    # decode attention kernel eligibility (the JAX package's flash_ok for
    # the Llama family: S=1 against a cache)
    flash_ok = cache is not None and s == 1
    mask = _cache_mask(cache, start, s) if cache is not None and not flash_ok else None
    attend = flash_decode_stacked if use_kernels else decode_attention_plain

    lp = params["layers"]
    fresh_k, fresh_v = [], []
    for li in range(cfg.num_layers):
        x = rms_norm(h, lp["input_norm"][li], cfg.rms_norm_eps)
        if "qkv" in lp:
            qkv = linear(lp["qkv"], x, li, use_kernels=use_kernels)
            q = qkv[..., : hq * dh].reshape(b, s, hq, dh)
            k = qkv[..., hq * dh : (hq + hkv) * dh].reshape(b, s, hkv, dh)
            v = qkv[..., (hq + hkv) * dh :].reshape(b, s, hkv, dh)
        else:
            q = linear(lp["q"], x, li, use_kernels=use_kernels).reshape(b, s, hq, dh)
            k = linear(lp["k"], x, li, use_kernels=use_kernels).reshape(b, s, hkv, dh)
            v = linear(lp["v"], x, li, use_kernels=use_kernels).reshape(b, s, hkv, dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if cache is not None:
            # int8 cache: fresh k/v stay in the compute dtype here and are
            # quantized once at the write-back
            fresh_dtype = k.dtype if cache.quantized else cache.k.dtype
            k, v = k.to(fresh_dtype), v.to(fresh_dtype)
            if flash_ok:
                attn = attend(q, cache.k, cache.v, li, k, v, start,
                              k_scale=cache.k_scale, v_scale=cache.v_scale)
            else:
                attn = cached_attention(
                    q, cache.k[li], cache.v[li], k, v, mask,
                    k_scale=cache.k_scale[li] if cache.quantized else None,
                    v_scale=cache.v_scale[li] if cache.quantized else None,
                )
        else:
            attn = causal_attention(q, k, v)
        if cache is not None or return_kv:
            fresh_k.append(k)
            fresh_v.append(v)

        h = h + linear(lp["o"], attn.reshape(b, s, hq * dh).to(h.dtype), li,
                       use_kernels=use_kernels)
        mlp_in = rms_norm(h, lp["post_attn_norm"][li], cfg.rms_norm_eps)
        if "gate_up" in lp:
            gu = linear(lp["gate_up"], mlp_in, li, use_kernels=use_kernels)
            gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
        else:
            gate = linear(lp["gate"], mlp_in, li, use_kernels=use_kernels)
            up = linear(lp["up"], mlp_in, li, use_kernels=use_kernels)
        h = h + linear(lp["down"], F.silu(gate) * up, li, use_kernels=use_kernels)

    out_cache = None
    if cache is not None:
        _write_back(cache, torch.stack(fresh_k), torch.stack(fresh_v), start, s)
        out_cache = cache
    elif return_kv:
        out_cache = KVCache(k=torch.stack(fresh_k), v=torch.stack(fresh_v))

    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = h @ params["embed"].t().to(h.dtype)
    else:
        logits = linear(params["lm_head"], h)
    return logits.to(logits_dtype), out_cache
