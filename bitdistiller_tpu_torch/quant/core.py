"""Group-wise sub-4-bit weight quantization primitives (PyTorch port of the
JAX package's `quant/core.py`; the same functions, names and semantics).

  * asymmetric int-k groups: scale = clamp(max - min, 1e-5) / (2^b - 1),
    zero = clamp(-round(min / scale), 0, 2^b - 1), dequant =
    (clamp(round(w / scale) + zero, 0, 2^b - 1) - zero) * scale;
  * two roundings kept apart: `round_half_away` for the STE quantizers'
    values, round-half-to-even (torch.round) for zero points and the
    PTQ/eval path;
  * STE mode does NOT detach the group statistics: gradients flow through
    the scale path too (amax/amin split the gradient among ties, as JAX's
    max/min do); `clip_torch_grad` passes the gradient on the closed
    interval [lo, hi];
  * NF3: the two-scale normal-float codebook, STE by the detach trick.

Every function takes the weight in its own dtype and computes in it, as
the JAX package's forward quantizer does (bf16 latents quantize in bf16).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Rounding primitives
# ---------------------------------------------------------------------------


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero: sign(x) * floor(|x| + 0.5)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_half_away(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half-away-from-zero with a straight-through (identity) gradient."""
    return _SteRound.apply(x)


def ste_passthrough(rounded: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Detach-trick STE: value of `rounded`, gradient of `raw`."""
    return raw + (rounded - raw).detach()


def clip_torch_grad(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi) whose gradient passes on the CLOSED interval [lo, hi]
    (a group's max/min elements land exactly on the clamp boundary)."""
    inside = (x >= lo) & (x <= hi)
    return torch.where(inside, x, torch.clamp(x, lo, hi).detach())


# ---------------------------------------------------------------------------
# Group reshape helpers
# ---------------------------------------------------------------------------


def _to_groups(w: torch.Tensor, group_size: int) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Reshape (..., K) -> (rows, n_groups, G). group_size=-1: one group a row."""
    orig_shape = tuple(w.shape)
    k = orig_shape[-1]
    if group_size <= 0:
        group_size = k
    if k % group_size != 0:
        raise ValueError(f"last dim {k} not divisible by group size {group_size}")
    return w.reshape(-1, k // group_size, group_size), orig_shape


# ---------------------------------------------------------------------------
# Asymmetric integer quantization
# ---------------------------------------------------------------------------


class GroupQuantParams(NamedTuple):
    """Per-group affine parameters. Shapes are (rows, n_groups)."""

    scales: torch.Tensor
    zeros: torch.Tensor  # integer-valued zero points stored as float


def asym_quant_params(wg: torch.Tensor, n_bit: int, *, clip_max=None,
                      clip_min=None) -> GroupQuantParams:
    """scale/zero from per-group min/max of grouped weights (rows, n_groups, G)."""
    max_int = 2**n_bit - 1
    if clip_max is None:
        max_val = wg.amax(dim=-1)
        min_val = wg.amin(dim=-1)
    else:
        max_val, min_val = clip_max, clip_min
    scales = torch.clamp(max_val - min_val, min=1e-5) / max_int
    zeros = torch.clamp(-torch.round(min_val / scales), 0, max_int)  # half to even
    return GroupQuantParams(scales=scales, zeros=zeros)


def fake_quant_int(w: torch.Tensor, n_bit: int, group_size: int = 128, *,
                   ste: bool = False) -> torch.Tensor:
    """Group-wise asymmetric fake quantization (quantize + dequantize) with
    groups along the last axis. ste=False: the PTQ/eval path (round half to
    even, no gradient through the statistics); ste=True: the QAT STE
    quantizers (round half away, identity gradient on the values, and the
    statistics not detached)."""
    wg, orig_shape = _to_groups(w, group_size)
    stats = wg if ste else wg.detach()
    params = asym_quant_params(stats, n_bit)
    scales = params.scales[..., None]
    zeros = params.zeros[..., None]
    max_int = 2**n_bit - 1
    rnd = ste_round if ste else torch.round
    q = clip_torch_grad(rnd(wg / scales) + zeros, 0, max_int)
    return ((q - zeros) * scales).reshape(orig_shape)


def fake_quant_int_kaxis(w: torch.Tensor, n_bit: int, group_size: int = 128, *,
                         ste: bool = False) -> torch.Tensor:
    """fake_quant_int for [..., K, N] weights with groups along K (per output
    column): the same values as fake_quant_int on the transpose."""
    k, n = w.shape[-2:]
    if group_size <= 0:
        group_size = k
    if k % group_size != 0:
        raise ValueError(f"K dim {k} not divisible by group size {group_size}")
    wg = w.reshape(*w.shape[:-2], k // group_size, group_size, n)
    stats = wg if ste else wg.detach()
    max_int = 2**n_bit - 1
    max_val = stats.amax(dim=-2)
    min_val = stats.amin(dim=-2)
    scales = torch.clamp(max_val - min_val, min=1e-5) / max_int
    zeros = torch.clamp(-torch.round(min_val / scales), 0, max_int)
    s = scales.unsqueeze(-2)
    z = zeros.unsqueeze(-2)
    rnd = ste_round if ste else torch.round
    q = clip_torch_grad(rnd(wg / s) + z, 0, max_int)
    return ((q - z) * s).reshape(w.shape)


def quantize_int(w: torch.Tensor, n_bit: int, group_size: int = 128
                 ) -> tuple[torch.Tensor, GroupQuantParams]:
    """Real quantization: integer codes (rows, n_groups, G) + params."""
    wg, _ = _to_groups(w, group_size)
    params = asym_quant_params(wg, n_bit)
    max_int = 2**n_bit - 1
    q = torch.clamp(torch.round(wg / params.scales[..., None]) + params.zeros[..., None],
                    0, max_int)
    return q.to(torch.int32), params


def dequantize_int(q: torch.Tensor, params: GroupQuantParams, orig_shape) -> torch.Tensor:
    return ((q - params.zeros[..., None]) * params.scales[..., None]).reshape(orig_shape)


# ---------------------------------------------------------------------------
# NF3 (two-scale normal-float 3-bit) codebook
# ---------------------------------------------------------------------------

NF3_POS_THRESHOLDS = (0.0916687622666359, 0.2826657369732857, 0.5024898052215576,
                      0.8114928305149078)
NF3_POS_LEVELS = (0.0, 0.1833375245332718, 0.3819939494132996, 0.6229856610298157, 1.0)
NF3_NEG_THRESHOLDS = (-0.7675113677978516, -0.39097706973552704, -0.1234657019376755)
NF3_NEG_LEVELS = (-1.0, -0.5350227355957031, -0.2469314038753510, 0.0)


def _level(q: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(q, value)


def _nf3_round_pos(q: torch.Tensor) -> torch.Tensor:
    """Map normalized non-negative values to the 5 positive NF3 levels."""
    t, lv = NF3_POS_THRESHOLDS, NF3_POS_LEVELS
    out = _level(q, lv[4])
    out = torch.where(q < t[3], _level(q, lv[3]), out)
    out = torch.where(q < t[2], _level(q, lv[2]), out)
    out = torch.where(q < t[1], _level(q, lv[1]), out)
    return torch.where(q < t[0], _level(q, lv[0]), out)


def _nf3_round_neg(q: torch.Tensor) -> torch.Tensor:
    """Map normalized non-positive values to the 4 negative NF3 levels."""
    t, lv = NF3_NEG_THRESHOLDS, NF3_NEG_LEVELS
    out = _level(q, lv[0])
    out = torch.where(q >= t[0], _level(q, lv[1]), out)
    out = torch.where(q >= t[1], _level(q, lv[2]), out)
    return torch.where(q >= t[2], _level(q, lv[3]), out)


def _fake_quant_nf3_grouped(wg: torch.Tensor, dim: int, ste: bool) -> torch.Tensor:
    """NF3 core on already-grouped weights; `dim` is the group dimension."""
    stats = wg if ste else wg.detach()
    scale_pos = torch.abs(stats.amax(dim=dim, keepdim=True))
    scale_neg = torch.abs(stats.amin(dim=dim, keepdim=True))
    zero = torch.zeros((), dtype=wg.dtype, device=wg.device)
    x_pos = torch.where(wg >= 0, wg, zero)
    x_neg = torch.where(wg < 0, wg, zero)
    one = torch.ones((), dtype=wg.dtype, device=wg.device)
    safe_pos = torch.where(scale_pos == 0, one, scale_pos)
    safe_neg = torch.where(scale_neg == 0, one, scale_neg)
    q_pos = x_pos / safe_pos
    q_neg = x_neg / safe_neg
    r_pos = _nf3_round_pos(q_pos)
    r_neg = _nf3_round_neg(q_neg)
    if ste:
        r_pos = ste_passthrough(r_pos, q_pos)
        r_neg = ste_passthrough(r_neg, q_neg)
    return r_pos * scale_pos + r_neg * scale_neg


def fake_quant_nf3(w: torch.Tensor, group_size: int = 128, *, ste: bool = True) -> torch.Tensor:
    """Two-scale NF3 fake quantization with groups along the last axis."""
    wg, orig_shape = _to_groups(w, group_size)
    return _fake_quant_nf3_grouped(wg, -1, ste).reshape(orig_shape)


def fake_quant_nf3_kaxis(w: torch.Tensor, group_size: int = 128, *,
                         ste: bool = True) -> torch.Tensor:
    """fake_quant_nf3 for [..., K, N] weights with groups along K."""
    k, n = w.shape[-2:]
    if group_size <= 0:
        group_size = k
    if k % group_size != 0:
        raise ValueError(f"K dim {k} not divisible by group size {group_size}")
    wg = w.reshape(*w.shape[:-2], k // group_size, group_size, n)
    return _fake_quant_nf3_grouped(wg, -2, ste).reshape(w.shape)


def quantize_nf3(w: torch.Tensor, group_size: int = 128
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Real NF3 quantization: 3-bit codes (rows, n_groups, G) in [0, 7] plus
    per-group (scale_pos, scale_neg), each (rows, n_groups). Codes 0..4: the
    positive levels; 5, 6, 7: -0.2469, -0.5350, -1.0."""
    wg, _ = _to_groups(w, group_size)
    scale_pos = torch.abs(wg.amax(dim=-1, keepdim=True))
    scale_neg = torch.abs(wg.amin(dim=-1, keepdim=True))
    one = torch.ones((), dtype=wg.dtype, device=wg.device)
    safe_pos = torch.where(scale_pos == 0, one, scale_pos)
    safe_neg = torch.where(scale_neg == 0, one, scale_neg)
    qn = wg / torch.where(wg >= 0, safe_pos, safe_neg)
    t = NF3_POS_THRESHOLDS
    pos_idx = sum((qn >= t[i]).to(torch.int32) for i in range(4))
    nt = NF3_NEG_THRESHOLDS
    neg_idx = 5 + (qn < nt[1]).to(torch.int32) + (qn < nt[0]).to(torch.int32)
    neg_idx = torch.where(qn >= nt[2], torch.zeros_like(neg_idx), neg_idx)
    codes = torch.where(wg >= 0, pos_idx, neg_idx)
    return codes.to(torch.int32), scale_pos[..., 0], scale_neg[..., 0]


NF3_CODE_VALUES = np.asarray(
    list(NF3_POS_LEVELS) + [-0.2469314038753510, -0.5350227355957031, -1.0], dtype=np.float32)


def dequantize_nf3(codes: torch.Tensor, scale_pos: torch.Tensor, scale_neg: torch.Tensor,
                   orig_shape) -> torch.Tensor:
    values = torch.from_numpy(NF3_CODE_VALUES).to(codes.device)[codes.long()]
    scale = torch.where(codes <= 4, scale_pos[..., None], scale_neg[..., None])
    return (values * scale).reshape(orig_shape)


# ---------------------------------------------------------------------------
# Unified fake-quant dispatch
# ---------------------------------------------------------------------------


def make_fake_quantizer(quant_type: str, group_size: int = 128):
    """fn(w) -> fake-quantized w for a registry name, groups along the last
    axis. QAT names (STE): 'int2-asym', 'int3-asym', 'int4-asym',
    'ste-n2f3'; PTQ/eval names (round half to even, no STE): 'int2',
    'int3', 'int4', 'nf3'."""
    if quant_type == "ste-n2f3":
        return functools.partial(fake_quant_nf3, group_size=group_size, ste=True)
    if quant_type == "nf3":
        return functools.partial(fake_quant_nf3, group_size=group_size, ste=False)
    if quant_type.startswith("int") and quant_type.endswith("-asym"):
        n_bit = int(quant_type[3:-5])
        return functools.partial(fake_quant_int, n_bit=n_bit, group_size=group_size, ste=True)
    if quant_type.startswith("int") and quant_type[3:].isdigit():
        n_bit = int(quant_type[3:])
        return functools.partial(fake_quant_int, n_bit=n_bit, group_size=group_size, ste=False)
    if quant_type == "int":
        raise ValueError("'int' requires explicit n_bit: use 'int2'/'int3'/'int4'")
    raise ValueError(
        f"unknown quant_type {quant_type!r}; expected one of "
        "['int{k}-asym', 'ste-n2f3'] (QAT) or ['int{k}', 'nf3'] (PTQ)"
    )


def make_weight_quantizer(quant_type: str, group_size: int = 128):
    """Quantizer for the [..., K, N] (in-features, out-features) layer
    weights: groups run along K, per output column (the reference groups
    along the input-feature axis of its [N, K] weights). A leading [L] axis
    of stacked layers quantizes layer by layer."""
    if quant_type.startswith("int") and quant_type.endswith("-asym"):
        n_bit = int(quant_type[3:-5])
        return lambda w: fake_quant_int_kaxis(w, n_bit, group_size, ste=True)
    if quant_type in ("ste-n2f3", "nf3"):
        ste = quant_type == "ste-n2f3"
        return lambda w: fake_quant_nf3_kaxis(w, group_size, ste=ste)
    q = make_fake_quantizer(quant_type, group_size)
    return lambda w: q(w.transpose(-1, -2)).transpose(-1, -2)
