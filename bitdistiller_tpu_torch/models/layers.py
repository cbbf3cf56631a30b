"""Decoder building blocks of every model family: linear dispatch (with the
training forward's weight quantizer), RMSNorm and LayerNorm (`apply_norm`),
ALiBi slopes and bias, rotate-half RoPE with the HF rope scalings (linear,
llama3, longrope, yarn), the MLP activations, the two attentions the JAX
package leaves to XLA (written here as plain einsum + softmax, each with an
additive bias; the causal one with the training padding mask), and the
training flash attention (`flash_train_attention`, ops/train_attention.py:
B8's kernels on the card, the plain version on the CPU).

Numerics follow the JAX package's `models/layers.py`: f32 norm
accumulation, f32 attention scores and softmax, rope tables in f32.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """Mean-subtracting LayerNorm (Falcon, MPT, OPT, Bloom); mean, variance
    and the affine map in f32."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def apply_norm(leaf, x: torch.Tensor, eps: float, offset: float = 0.0) -> torch.Tensor:
    """Norm dispatch on the leaf: a {"w", "b"} dict is a LayerNorm (offset
    unused), a tensor an RMSNorm whose weight takes the Gemma-style unit
    `offset` (x_hat * (w + offset)), as the JAX package's apply_norm."""
    if isinstance(leaf, dict):
        return layer_norm(x, leaf["w"], leaf.get("b"), eps)
    if offset:
        return rms_norm(x, leaf.to(torch.float32) + offset, eps)
    return rms_norm(x, leaf, eps)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """The standard ALiBi head slopes in f32: a geometric series for a power
    of two, else the closest power of two's series followed by every other
    slope of the next one's (MPT, Bloom, Falcon-ALiBi)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return torch.tensor(pow2_slopes(n_heads), dtype=torch.float32)
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(pow2_slopes(closest) + extra, dtype=torch.float32)


def alibi_bias(slopes: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """[B, H, S, T] additive bias -slope_h * max(q_pos - k_pos, 0) for query
    positions q_pos [B, S] and key positions k_pos [B, T] (future keys are
    masked anyway)."""
    dist = (q_pos[:, :, None] - k_pos[:, None, :]).to(torch.float32)
    return -slopes.to(q_pos.device)[None, :, None, None] * torch.clamp(dist, min=0.0)[:, None]


def rope_scaling_params(cfg, head_dim: int, theta: float) -> tuple[np.ndarray, float]:
    """(inv_freq [head_dim / 2] f32, attention scale) with the config's rope
    scaling, computed in numpy f32 as the JAX package's (transformers'
    ROPE_INIT_FUNCTIONS): linear divides by the factor; llama3 scales long
    wavelengths by 1 / factor, keeps short ones and interpolates between;
    longrope divides by the long table when max_position_embeddings exceeds
    the original length (then with the magnitude sqrt(1 + ln s / ln orig)),
    else by the short one; yarn ramps between interpolation and
    extrapolation over the beta_fast..beta_slow dims, magnitude
    0.1 ln(factor) + 1 unless given."""
    inv_freq = rope_inv_freq(head_dim, theta)
    typ = cfg.rope_scaling_type
    if typ is None:
        return inv_freq, 1.0
    if typ == "linear":
        return inv_freq / cfg.rope_scaling_factor, 1.0
    if typ == "llama3":
        orig = float(cfg.rope_original_max_position or 8192)
        factor = cfg.rope_scaling_factor
        low_wavelen = orig / cfg.rope_low_freq_factor
        high_wavelen = orig / cfg.rope_high_freq_factor
        wavelen = 2.0 * np.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (orig / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        mid = (wavelen < low_wavelen) & (wavelen > high_wavelen)
        return np.where(mid, smoothed, scaled), 1.0
    if typ == "longrope":
        orig = float(cfg.rope_original_max_position or cfg.max_position_embeddings)
        long_ctx = cfg.max_position_embeddings > orig
        table = cfg.rope_long_factor if long_ctx else cfg.rope_short_factor
        scale = cfg.max_position_embeddings / orig
        mscale = float(np.sqrt(1.0 + np.log(scale) / np.log(orig))) if scale > 1.0 else 1.0
        return inv_freq / np.asarray(table, np.float32), mscale
    if typ == "yarn":
        factor = cfg.rope_scaling_factor
        orig = float(cfg.rope_original_max_position or cfg.max_position_embeddings)
        mscale = (cfg.rope_attention_factor if cfg.rope_attention_factor is not None
                  else 0.1 * float(np.log(factor)) + 1.0)

        def correction_dim(num_rotations):
            return (head_dim * np.log(orig / (num_rotations * 2 * np.pi))) / (2 * np.log(theta))

        low = max(float(np.floor(correction_dim(cfg.rope_beta_fast))), 0.0)
        high = min(float(np.ceil(correction_dim(cfg.rope_beta_slow))), head_dim - 1.0)
        if low == high:
            high += 0.001  # no zero-width ramp
        ramp = np.clip((np.arange(head_dim // 2, dtype=np.float32) - low) / (high - low), 0, 1)
        extrap_weight = 1.0 - ramp
        return inv_freq / factor * (1 - extrap_weight) + inv_freq * extrap_weight, float(mscale)
    raise ValueError(f"unknown rope_scaling_type {typ!r}")


@functools.lru_cache(maxsize=64)
def rope_tables(cfg, head_dim: int, theta: float, device: torch.device, scaled: bool = True):
    """(inv_freq on `device`, mscale), made once a (config, theta, device):
    with the config's rope scaling (`scaled`), or unscaled (Gemma's local
    rope)."""
    if scaled:
        inv, mscale = rope_scaling_params(cfg, head_dim, theta)
    else:
        inv, mscale = rope_inv_freq(head_dim, theta), 1.0
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device), mscale


def rope_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    """Unscaled rope frequencies, computed in f32 as the JAX package does."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor, mscale: float = 1.0,
                 dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotate-half RoPE, each times `mscale`, in f32 then
    `dtype`. positions [...] -> [..., head_dim]."""
    freqs = positions[..., None].to(torch.float32) * inv_freq.to(positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return cos.to(dtype), sin.to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [..., S, D], broadcast over heads."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[..., None, :] + rotated * sin[..., None, :]).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "silu": F.silu,
    # the JAX package's "gelu" is jax.nn.gelu, whose default is the tanh
    # form: the port computes what it computes, not HF's erf GELU (ROADMAP C4)
    "gelu": _gelu_tanh,
    "gelu_tanh": _gelu_tanh,
    "relu": F.relu,
}


def activation(name: str):
    """The MLP activation of `hidden_act`."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name}")
    return _ACTIVATIONS[name]


def cached_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    ck: torch.Tensor,  # [B, Hkv, T, D] read-only cache (head-major)
    cv: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D] fresh tokens
    v_new: torch.Tensor,
    mask: torch.Tensor,  # [B, 1, S, T+S] bool
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, T]: ck holds int8 codes
    v_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,  # [B, Hq, S, T+S] additive (ALiBi)
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
    if bias is not None:
        scores = scores + bias.reshape(b, hkv, rep, *bias.shape[-2:]).to(torch.float32)
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
    bias: Optional[torch.Tensor] = None,  # [B, Hq, S, S] additive (ALiBi)
) -> torch.Tensor:
    """Causal GQA scaled-dot-product attention; f32 scores and softmax. With
    `mask` (causal, and the padding mask and sliding window where given) the
    mask replaces the causal rule."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, s, hkv, rep, d).to(torch.float32)
    scores = torch.einsum("bshrd,bthd->bhrst", qg, k.to(torch.float32)) / math.sqrt(d)
    if bias is not None:
        scores = scores + bias.reshape(b, hkv, rep, s, s).to(torch.float32)
    if mask is None:
        pos = torch.arange(s, device=q.device)
        scores = torch.where(pos[None, :] <= pos[:, None], scores, -math.inf)
    else:
        scores = torch.where(mask[:, :, None], scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d)
