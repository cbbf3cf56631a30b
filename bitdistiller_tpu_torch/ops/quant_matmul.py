"""Packed int2/int4 dequantize-matmul: plain PyTorch version and the wrapper
of the hand-written CUDA kernels (csrc/quant_matmul.cu).

One call serves a plain layer and layer `li` of a stacked [L, K/pack, N]
weight: the wrapper passes `qweight[li]`, a view (base pointer plus layer
stride), and never copies a layer. This replaces both TPU kernels of the
JAX package, `_qmm_kernel` and `_qmm_kernel_stacked`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches a kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..quant.packing import PackedLinear, unpack_codes
from . import _build

DECODE_MAX_M = 32  # rows up to which the decode kernel runs; above, the prefill kernel
KERNEL_BITS = (2, 4)
KERNEL_GROUPS = (128,)


def quant_matmul_plain(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
    szeros: torch.Tensor, bits: int, group_size: int,
) -> torch.Tensor:
    """x [M, K] -> [M, N] in x's dtype. Mirrors the JAX package's
    `quant_matmul_xla`: f32 compute, grouped products, the scale/zero
    correction applied to the per-group accumulator."""
    m, k = x.shape
    n = qweight.shape[-1]
    g = group_size
    codes = unpack_codes(qweight, bits, g).to(torch.float32)
    xg = x.to(torch.float32).reshape(m, k // g, g)
    partial = torch.einsum("mgk,gkn->mgn", xg, codes.reshape(k // g, g, n))
    xsum = xg.sum(dim=-1)
    out = torch.einsum("mgn,gn->mn", partial, scales.to(torch.float32)) - torch.einsum(
        "mg,gn->mn", xsum, szeros.to(torch.float32)
    )
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _launcher(fn_name: str):
    lib = _build.load("quant_matmul")
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_args(x, qweight, combo, bits, group_size):
    if not (x.is_cuda and qweight.device == x.device):
        raise ValueError("the packed matmul kernel takes CUDA tensors on one device")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the packed matmul kernel takes bfloat16 x, got {x.dtype}")
    if combo is None:
        raise ValueError("the packed layer has no combo words (make_scale_combo)")
    if qweight.dtype != torch.int32 or combo.dtype != torch.int32:
        raise ValueError("qweight and combo must be int32")
    if bits not in KERNEL_BITS:
        raise ValueError(f"bits={bits}: the packed matmul kernel takes bits in {KERNEL_BITS}")
    if group_size not in KERNEL_GROUPS:
        raise ValueError(f"group_size={group_size}: the kernel takes {KERNEL_GROUPS}")
    m, k = x.shape
    n = qweight.shape[-1]
    if qweight.shape != (k // (32 // bits), n) or combo.shape != (k // group_size, n):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, qweight {tuple(qweight.shape)}, "
            f"combo {tuple(combo.shape)} at bits={bits}, group={group_size}"
        )
    if combo.device != x.device or not (
            x.is_contiguous() and qweight.is_contiguous() and combo.is_contiguous()):
        raise ValueError("the kernel takes row-major contiguous x, qweight and combo")


def _launch(fn_name, x, qweight, combo, bits, group_size):
    _check_args(x, qweight, combo, bits, group_size)
    m, k = x.shape
    n = qweight.shape[-1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _launcher(fn_name)(
        x.data_ptr(), qweight.data_ptr(), combo.data_ptr(), out.data_ptr(),
        m, k, n, bits, group_size,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, fn_name)
    return out


def qmm_decode(x, qweight, combo, bits: int, group_size: int) -> torch.Tensor:
    """Decode kernel (M <= 32): x [M, K] @ packed [K, N] on the card."""
    if x.shape[0] > DECODE_MAX_M:
        raise ValueError(f"decode kernel takes M <= {DECODE_MAX_M}, got {x.shape[0]}")
    out = _launch("bd_qmm_decode", x, qweight, combo, bits, group_size)
    qmm_decode.launches += 1
    return out


def qmm_prefill(x, qweight, combo, bits: int, group_size: int) -> torch.Tensor:
    """Tiled prefill kernel (any M): x [M, K] @ packed [K, N] on the card."""
    out = _launch("bd_qmm_prefill", x, qweight, combo, bits, group_size)
    qmm_prefill.launches += 1
    return out


qmm_decode.launches = 0
qmm_prefill.launches = 0


def quant_matmul(x: torch.Tensor, p: PackedLinear, li: Optional[int] = None) -> torch.Tensor:
    """x [..., K] -> [..., N]. `li` selects layer li of a stacked PackedLinear
    (read in place through views)."""
    k, n = p.in_features, p.out_features
    xf = x.reshape(-1, k).contiguous()
    if xf.device.type == "cpu":
        layer = p if li is None else p.layer(li)
        out = quant_matmul_plain(
            xf, layer.qweight, layer.scales, layer.szeros, layer.bits, layer.group_size
        )
    elif xf.is_cuda:
        # index only what the kernel reads: this runs 4 times a layer a step
        qweight = p.qweight if li is None else p.qweight[li]
        combo = p.combo if li is None or p.combo is None else p.combo[li]
        launch = qmm_decode if xf.shape[0] <= DECODE_MAX_M else qmm_prefill
        out = launch(xf, qweight, combo, p.bits, p.group_size)
    else:
        raise ValueError(f"no packed matmul for device {xf.device}")
    if p.bias is not None:
        out = out + (p.bias if li is None else p.bias[li]).to(out.dtype)
    return out.reshape(*x.shape[:-1], n)
