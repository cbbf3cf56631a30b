"""Llama decoder as plain functions over a stacked-layer param dict (PyTorch
port of the JAX package's `models/llama.py`, Llama family only).

Params keep the JAX layout: every layer leaf carries a leading [L] axis, and
the layer loop is a Python loop over `li` that reads each layer in place
(views, no copies). Packed leaves are stacked `PackedLinear`s with fused
`qkv` and `gate_up`.

Three forward cases:
  * cache-less prefill (`cache=None`), optionally returning each layer's
    fresh k/v [L, B, S, Hkv, D] (`return_kv=True`);
  * the training forward (also cache-less): the weight fake quantizer
    (`quantizer`), the padding mask (`attn_mask`), per-layer rematerialization
    (`remat`: True/"full", "save_quantized", "save_dots", "save_qkvo",
    through torch.utils.checkpoint(use_reentrant=False); values and
    gradients do not depend on the policy) and the training flash attention
    (`use_train_flash`, else BITDISTILLER_TRAIN_FLASH=1 as the JAX package
    reads it: B8's kernels on CUDA tensors);
  * decode against the head-major cache [L, B, Hkv, T, D] with a scalar or
    per-slot `cache_pos`. At S=1 attention runs through the decode attention
    kernel (`ops/decode_attention.py`); otherwise through `cached_attention`.
    The fresh tokens are written back into the cache IN PLACE (the JAX
    package returns a new cache; here the returned cache is the same object).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .._device import resolve_device, torch_dtype
from ..ops.decode_attention import decode_attention_plain, flash_decode_stacked
from .config import ModelConfig
from .layers import (
    apply_rope,
    cached_attention,
    causal_attention,
    flash_train_attention,
    linear,
    rms_norm,
    rope_cos_sin,
)

LAYER_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
REMAT_POLICIES = (True, "full", "save_quantized", "save_dots", "save_qkvo")

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


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> dict:
    """Random dense params in the JAX package's layout (stacked [L, K, N]
    linears, unfused q/k/v and gate/up): normal * 1/sqrt(K), the embedding
    * 0.02, norms 1, drawn in f32 on the device from a torch.Generator
    seeded with `seed` (other numbers than the JAX package's jax.random)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hq, hkv, dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.actual_head_dim
    ffn, L = cfg.intermediate_size, cfg.num_layers

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                * scale).to(dtype)

    def dense(shape):  # [L, K, N], a layer at a time: no full-size f32 copy
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], 1.0 / float(shape[-2]) ** 0.5)
        return out

    layers = {
        "input_norm": torch.ones((L, d), dtype=dtype, device=dev),
        "post_attn_norm": torch.ones((L, d), dtype=dtype, device=dev),
        "q": {"w": dense((L, d, hq * dh))},
        "k": {"w": dense((L, d, hkv * dh))},
        "v": {"w": dense((L, d, hkv * dh))},
        "o": {"w": dense((L, hq * dh, d))},
        "gate": {"w": dense((L, d, ffn))},
        "up": {"w": dense((L, d, ffn))},
        "down": {"w": dense((L, ffn, d))},
    }
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": normal((d, cfg.vocab_size), 1.0 / float(d) ** 0.5)}
    return params


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


def _block(cfg: ModelConfig, lp: dict, li: int, h, cos, sin, attend, lin):
    """One decoder layer: norm, q/k/v (fused or not), rope, `attend(q, k, v)`,
    o, residual, norm, the gated MLP, residual. `lin(name, x)` applies layer
    li's linear `name`."""
    b, s = h.shape[:2]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.actual_head_dim
    x = rms_norm(h, lp["input_norm"][li], cfg.rms_norm_eps)
    if "qkv" in lp:
        qkv = lin("qkv", x)
        q = qkv[..., : hq * dh].reshape(b, s, hq, dh)
        k = qkv[..., hq * dh : (hq + hkv) * dh].reshape(b, s, hkv, dh)
        v = qkv[..., (hq + hkv) * dh :].reshape(b, s, hkv, dh)
    else:
        q = lin("q", x).reshape(b, s, hq, dh)
        k = lin("k", x).reshape(b, s, hkv, dh)
        v = lin("v", x).reshape(b, s, hkv, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v)
    h = h + lin("o", attn.reshape(b, s, hq * dh).to(h.dtype))
    mlp_in = rms_norm(h, lp["post_attn_norm"][li], cfg.rms_norm_eps)
    if "gate_up" in lp:
        gu = lin("gate_up", mlp_in)
        gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
    else:
        gate, up = lin("gate", mlp_in), lin("up", mlp_in)
    return h + lin("down", F.silu(gate) * up)


def _save_matmuls(mlp_width):
    """Selective-checkpoint policy: keep the outputs of the non-batched
    matmuls (the projections; attention's batched products are recomputed),
    all of them (mlp_width None: "save_dots"), or those whose weight has no
    dimension of the MLP width ("save_qkvo": q, k, v and o)."""

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.mm.default and (mlp_width is None or not any(
                d in (mlp_width, 2 * mlp_width) for d in args[1].shape)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _layer(cfg, lp, li, h, cos, sin, attend, quantizer, remat, use_kernels):
    """Layer li, rematerialized by `remat` (False: not at all)."""
    if remat not in (False, None) and remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; expected one of {REMAT_POLICIES}")
    weights = {}
    if remat in ("save_quantized", "save_dots", "save_qkvo") and quantizer is not None:
        # quantize outside the checkpoint: the quantized weights are kept for
        # the backward instead of being quantized again
        weights = {n: quantizer(leaf["w"][li]) for n, leaf in lp.items()
                   if isinstance(leaf, dict) and "w" in leaf}
        quantizer = None

    def run(h):
        def lin(name, x):
            if name in weights:
                return x @ weights[name].to(x.dtype)
            return linear(lp[name], x, li, use_kernels=use_kernels, quantizer=quantizer)

        return _block(cfg, lp, li, h, cos, sin, attend, lin)

    if remat in (False, None):
        return run(h)
    if remat in ("save_dots", "save_qkvo"):
        policy = _save_matmuls(None if remat == "save_dots" else cfg.intermediate_size)
        return checkpoint(run, h, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       policy))
    return checkpoint(run, h, use_reentrant=False)


def train_flash_enabled(use_train_flash: Optional[bool]) -> bool:
    """The JAX package's rule: the argument if given, else
    BITDISTILLER_TRAIN_FLASH == "1"."""
    if use_train_flash is not None:
        return use_train_flash
    return os.environ.get("BITDISTILLER_TRAIN_FLASH", "0") == "1"


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
    quantizer=None,
    attn_mask: Optional[torch.Tensor] = None,  # [B, S] padding mask (1 = real)
    remat=False,
    use_train_flash: Optional[bool] = None,
):
    """Returns (logits [B, S, V], cache | prompt KV | None).

    `use_kernels=False` routes the packed matmuls and the decode attention
    through their plain versions on any device: a reference run on the
    card. Otherwise CUDA tensors go through the kernels and CPU tensors
    through the plain versions. The training arguments apply to the
    cache-less forward: `quantizer` fake-quantizes every dense layer weight
    in its own dtype, `attn_mask` masks padded keys, `remat` checkpoints each
    layer (the "save_*" policies quantize the weights outside the
    checkpoint, so the quantized weights are kept; "save_dots" and
    "save_qkvo" also keep the projections' outputs), and the training flash
    attention replaces the causal attention where `train_flash_enabled`."""
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
    decode_attend = flash_decode_stacked if use_kernels else decode_attention_plain
    if cache is None:
        # training flash attention: full causal (+ padding) attention (the
        # Llama family has no ALiBi, window or bias)
        if train_flash_enabled(use_train_flash):
            train_attend = functools.partial(flash_train_attention, attn_mask=attn_mask)
        else:
            if attn_mask is not None:
                allow = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
                mask = allow[None, None] & attn_mask[:, None, None, :].to(torch.bool)
            train_attend = functools.partial(causal_attention, mask=mask)

    lp = params["layers"]
    fresh_k, fresh_v = [], []
    for li in range(cfg.num_layers):
        if cache is not None:
            def attend(q, k, v):
                # int8 cache: fresh k/v stay in the compute dtype here and are
                # quantized once at the write-back
                fresh_dtype = k.dtype if cache.quantized else cache.k.dtype
                k, v = k.to(fresh_dtype), v.to(fresh_dtype)
                fresh_k.append(k)
                fresh_v.append(v)
                if flash_ok:
                    return decode_attend(q, cache.k, cache.v, li, k, v, start,
                                         k_scale=cache.k_scale, v_scale=cache.v_scale)
                return cached_attention(
                    q, cache.k[li], cache.v[li], k, v, mask,
                    k_scale=cache.k_scale[li] if cache.quantized else None,
                    v_scale=cache.v_scale[li] if cache.quantized else None,
                )
        elif return_kv:
            def attend(q, k, v):
                fresh_k.append(k)
                fresh_v.append(v)
                return train_attend(q, k, v)
        else:
            attend = train_attend
        h = _layer(cfg, lp, li, h, cos, sin, attend, quantizer, remat, use_kernels)

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


def fake_quant_weights(params: dict, quantizer) -> dict:
    """Apply a fake quantizer to every layer linear weight once (PTQ-style),
    computed in f32 and stored back in the weight's dtype."""
    out = dict(params, layers=dict(params["layers"]))
    for name in LAYER_LINEARS:
        if name not in out["layers"]:
            continue
        leaf = out["layers"][name]
        w = leaf["w"]
        out["layers"][name] = dict(leaf, w=quantizer(w.to(torch.float32)).to(w.dtype))
    return out


def quantize_layer_weights(params: dict, quantizer) -> dict:
    """Differentiable one-shot weight quantization, the same values as
    `linear()` computes in the forward (the quantizer in the weight's own
    dtype), with the gradient paths of in-forward QAT. The returned tree goes
    into `forward(..., quantizer=None)` unchanged (the fused training step
    quantizes once a cycle through it)."""
    out = dict(params, layers=dict(params["layers"]))
    for name in LAYER_LINEARS:
        if name not in out["layers"]:
            continue
        leaf = out["layers"][name]
        out["layers"][name] = dict(leaf, w=quantizer(leaf["w"]))
    return out
