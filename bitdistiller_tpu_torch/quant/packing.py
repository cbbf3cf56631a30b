"""Packed sub-byte weight storage (PyTorch port of the JAX package's
`quant/packing.py`; the words are bit-identical).

  qweight : int32 [K // pack, N]   pack = 32 // bits (16 @ int2, 8 @ int4)
  scales  : f32   [K // G, N]
  szeros  : f32   [K // G, N]      (= zeros * scales, so dequant is one FMA)
  combo   : int32 [K // G, N]      bf16(scale) bits low, bf16(szero) bits high

N (output features) is the minor dimension. K is packed in the half-word
*pair layout* within each group: with R = G // pack packed rows per group,
code k_local maps to word r = (k_local % 2R) // 2, half-word b = k_local & 1,
bit-field f = (k_local // 2R) + b * pack/2. One shift and mask of a word,
`(w >> bits*i) & 0x000m000m`, then yields the two codes of rows
i*2R + 2r and i*2R + 2r + 1, one in each 16-bit half — which is exactly a
`__nv_bfloat162` after the exponent-bias OR (see csrc/quant_matmul.cu).

`a8_order=True` marks words repacked into the A8 kernel's byte order
(ops/quant_matmul.py: pack_codes_a8) instead of the pair layout.

A stacked layer set carries a leading [L] axis on every array; `layer(li)`
returns a view of one layer without copying.
Dequant: w[k, n] = q[k, n] * scales[k//G, n] - szeros[k//G, n].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_U32 = 1 << 32


@dataclasses.dataclass
class PackedLinear:
    qweight: torch.Tensor  # int32 [(L,) K // pack, N]
    scales: torch.Tensor  # f32 [(L,) K // G, N]
    szeros: torch.Tensor  # f32 [(L,) K // G, N]
    bias: Optional[torch.Tensor]
    bits: int
    group_size: int
    in_features: int
    out_features: int
    combo: Optional[torch.Tensor] = None  # int32 [(L,) K // G, N]
    # True when qweight was repacked into the W{2,4}A8 kernel's byte
    # extraction order (ops/quant_matmul.py: repack_linear_a8). Only the A8
    # matmul reads such words; pair-layout readers raise.
    a8_order: bool = False

    @property
    def pack(self) -> int:
        return 32 // self.bits

    def layer(self, li: int) -> "PackedLinear":
        """Layer `li` of a stacked set, as views into the stacked arrays."""
        take = lambda a: None if a is None else a[li]
        return dataclasses.replace(
            self, qweight=self.qweight[li], scales=self.scales[li],
            szeros=self.szeros[li], combo=take(self.combo), bias=take(self.bias),
        )


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the same bits as int32."""
    return torch.where(words >= (1 << 31), words - _U32, words).to(torch.int32)


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even bf16 bit pattern of x, as int64 in [0, 2^16)."""
    return x.to(torch.float32).to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def make_scale_combo(scales: torch.Tensor, szeros: torch.Tensor) -> torch.Tensor:
    """Pack (bf16(scales), bf16(szeros)) into one int32 word per group/lane."""
    return _to_int32((_bf16_bits(szeros) << 16) | _bf16_bits(scales))


def scales_from_combo(combo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 (scale, szero) a kernel decodes from a combo word: bf16 bits in
    the top half of an f32 word are that value in f32."""
    w = combo.to(torch.int32)
    s = _to_int32((w.to(torch.int64) & 0xFFFF) << 16).view(torch.float32)
    sz = (w & -65536).view(torch.float32)
    return s, sz


def _layout_dims(k: int, bits: int, group_size: int) -> tuple[int, int, int]:
    if bits not in (2, 4, 8):
        raise ValueError(f"bits={bits} does not divide a 32-bit word into half-word pairs")
    pack = 32 // bits
    g = group_size if group_size > 0 else k
    if k % g != 0:
        raise ValueError(f"K={k} must be divisible by group_size={g}")
    if g % pack != 0:
        raise ValueError(f"group_size={g} must be divisible by pack={pack}")
    return pack, g, g // pack


def _fields(half: int, device) -> torch.Tensor:
    """Bit-field index of (i, b) in the pair layout, shaped to broadcast over
    [K//G, half, R, 2, N]."""
    i = torch.arange(half, dtype=torch.int64, device=device)[None, :, None, None, None]
    b = torch.tensor([0, half], dtype=torch.int64, device=device)[None, None, None, :, None]
    return i + b


def pack_codes(q_kn: torch.Tensor, bits: int, group_size: int = 128) -> torch.Tensor:
    """Pack integer codes [K, N] (values in [0, 2^bits)) into int32 [K//pack, N]."""
    k, n = q_kn.shape
    pack, g, r = _layout_dims(k, bits, group_size)
    half = pack // 2
    q = q_kn.to(torch.int64).reshape(k // g, half, r, 2, n)
    words = (q << (_fields(half, q.device) * bits)).sum(dim=(1, 3))
    return _to_int32(words.reshape(k // pack, n))


def unpack_codes(qweight: torch.Tensor, bits: int, group_size: int = 128) -> torch.Tensor:
    """Unpack int32 [K//pack, N] back to integer codes [K, N]."""
    kp, n = qweight.shape
    pack = 32 // bits
    k = kp * pack
    _, g, r = _layout_dims(k, bits, group_size)
    half = pack // 2
    w = (qweight.to(torch.int64) & (_U32 - 1)).reshape(k // g, 1, r, 1, n)
    codes = (w >> (_fields(half, w.device) * bits)) & ((1 << bits) - 1)
    return codes.reshape(k, n).to(torch.int32)


def quantize_pack_linear(
    w_kn: torch.Tensor, bits: int, group_size: int = 128,
    bias: Optional[torch.Tensor] = None,
) -> PackedLinear:
    """Quantize a [K, N] weight (per-group asymmetric min/max, round half to
    even) and pack it."""
    k, n = w_kn.shape
    g = group_size if group_size > 0 else k
    if k % g != 0:
        raise ValueError(f"K={k} not divisible by group_size={g}")
    wg = w_kn.to(torch.float32).reshape(k // g, g, n)
    max_int = 2**bits - 1
    max_val = wg.amax(dim=1)
    min_val = wg.amin(dim=1)
    scales = torch.clamp(max_val - min_val, min=1e-5) / max_int
    zeros = torch.clamp(-torch.round(min_val / scales), 0, max_int)
    q = torch.clamp(
        torch.round(wg / scales[:, None, :]) + zeros[:, None, :], 0, max_int
    ).to(torch.int32)
    szeros = zeros * scales
    return PackedLinear(
        qweight=pack_codes(q.reshape(k, n), bits, g),
        scales=scales, szeros=szeros, bias=bias,
        bits=bits, group_size=g, in_features=k, out_features=n,
        combo=make_scale_combo(scales, szeros),
    )


def dequantize_linear(p: PackedLinear, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense [K, N] weight of one (unstacked) layer."""
    if p.a8_order:
        raise ValueError("qweight is in A8 extraction order; pair-layout dequant would scramble k")
    q = unpack_codes(p.qweight, p.bits, p.group_size).to(torch.float32)
    g = p.group_size
    scales = torch.repeat_interleave(p.scales.to(torch.float32), g, dim=0)
    szeros = torch.repeat_interleave(p.szeros.to(torch.float32), g, dim=0)
    return (q * scales - szeros).to(dtype)
