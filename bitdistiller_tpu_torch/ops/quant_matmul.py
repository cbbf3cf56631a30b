"""Packed int2/int4 dequantize-matmul: plain PyTorch versions and the
wrappers of the hand-written CUDA kernels (csrc/quant_matmul.cu for bf16
activations, csrc/quant_matmul_a8.cu for the W{2,4}A8 path).

One call serves a plain layer and layer `li` of a stacked [L, K/pack, N]
weight: the wrapper passes `qweight[li]`, a view (base pointer plus layer
stride), and never copies a layer. This replaces both TPU kernels of the
JAX package, `_qmm_kernel` and `_qmm_kernel_stacked`.

The W{2,4}A8 half (below) quantizes activations per token to int8 and
multiplies them with the int codes in int32; it replaces the TPU kernel
`_qmm_a8_kernel`. `BITDISTILLER_QMM_A8=1` (the JAX package's own switch)
turns it on for serving: `maybe_repack_a8` then repacks every packed leaf
once into the A8 byte order, and `quant_matmul` sends every packed matmul
through it.

Up to DECODE_MAX_M rows a call runs a decode kernel (A16 and A8 alike
stream the words through clusters that split K, `decode_plan`); above, a
prefill kernel (Hopper wgmma tiles fed by TMA, `prefill_tile_m` rows by 128
columns), after a pass that sums x over each group into scratch the wrapper
allocates.

Every kernel walks K in steps of KERNEL_STEP = 128 k: a step holds 128 / g
groups at g = 32 and 64, one at 128, and a group of g > 128 (a multiple of
128, per-channel g = K included) is g / 128 steps whose activations the
kernel reads in the order of `step_kmap` (the pair layout of a g-group,
walked as if it were g / 128 groups of 128). The plans count K in these
steps, `kernel_steps`: at g = 32 and 64 K may be 64 mod 128 (Falcon-7B's
hidden size 4544), and the last step is then a half step, whose missing
half the kernels stage as zeros without reading past K. x may be bf16 or
f32: the kernels round f32 x to bf16 as they stage it (the A8 kernels
quantize it as it is) and write the output in x's dtype.

`qmm_prefill.launches` counts A16 prefill calls, `qmm_a8.launches` every A8
call and `qmm_a8.prefill_launches` the A8 calls above DECODE_MAX_M rows.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches a kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

from .. import _device
from ..quant.packing import _U32, PackedLinear, _to_int32, unpack_codes
from . import _build

DECODE_MAX_M = 32  # rows up to which the decode kernel runs; above, the prefill kernel
KERNEL_BITS = (2, 4)
KERNEL_STEP = 128  # k a step of every packed kernel
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def kernel_group_ok(group_size: int, k: int) -> bool:
    """The group sizes the packed kernels take: 32 or 64 with K a multiple of
    64 (K = 64 mod 128: a half last step), or 128, or a multiple of 128
    dividing K (per-channel included)."""
    if group_size in (32, 64):
        return k % 64 == 0
    return group_size % KERNEL_STEP == 0 and k % group_size == 0


def kernel_steps(k: int) -> int:
    """K steps of KERNEL_STEP k the packed kernels walk (a half last step
    counts)."""
    return -(-k // KERNEL_STEP)


def step_kmap(bits: int, group_size: int) -> np.ndarray:
    """For a group g > 128 in the pair layout: kmap[k'] = the k within the
    group whose code the kernels find at position k' when they read the
    group's words as g / 128 groups of 128 (word row w, pair field i, half
    b: k' = (w // RS) * 128 + 2 * RS * i + 2 * (w % RS) + b against
    k = 2 * R * i + 2 * w + b, R = g / pack and RS = 128 / pack rows)."""
    pack = 32 // bits
    r, rs = group_size // pack, KERNEL_STEP // pack
    w = np.arange(r)[:, None, None]
    i = np.arange(pack // 2)[None, :, None]
    b = np.arange(2)[None, None, :]
    kprime = (w // rs) * KERNEL_STEP + i * 2 * rs + 2 * (w % rs) + b
    kmap = np.empty(group_size, np.int32)
    kmap[kprime.ravel()] = (i * 2 * r + 2 * w + b).ravel()
    return kmap


def prefill_tile_m(m: int, n: int, sms: int) -> int:
    """Rows of the prefill kernels' output tile (A16 and A8; 128 columns
    either way): 128 once the 128 x 128 tiles fill the card's `sms` SMs
    twice over, else 64, so that a short prefill still has a block for
    every SM."""
    return 128 if -(-m // 128) * -(-n // 128) >= 2 * sms else 64


MAX_CLUSTER = 8  # the largest portable thread block cluster
A8_DECODE_COLS = 256  # output columns a cluster of the A8 decode kernel
A16_WARP_COLS = (32, 16)  # columns a warp of the A16 decode kernel, in order of preference


def decode_plan(n: int, groups: int, sms: int, cols: int = A8_DECODE_COLS) -> int:
    """Cluster size of the streaming decode kernels (the A16 and A8 matmuls
    at M <= 32, both launches of the fused MLP): a cluster of CTAs owns
    `cols` output columns and splits their `groups` K groups, at most one
    group a CTA and MAX_CLUSTER CTAs a cluster. The smallest cluster that
    puts two CTAs on each of the card's `sms` SMs, so that every SM holds
    two CTAs' loads in flight, else the largest."""
    tiles, cap = -(-n // cols), min(MAX_CLUSTER, groups)
    return next((c for c in range(1, cap + 1) if tiles * c >= 2 * sms), cap)


def a16_decode_plan(n: int, groups: int, sms: int) -> tuple[int, int]:
    """(cluster size, columns a warp) of the A16 decode kernel, whose 8
    warps own 8 * warp_cols output columns a cluster: 32 columns a warp (a
    word row is a 128-byte line) where `decode_plan`'s clusters of 256
    columns put two CTAs on every SM, else 16 (twice the clusters: o and
    down of the 7B, N = 4096), on `decode_plan`'s cluster for that tile."""
    for wc in A16_WARP_COLS:
        cluster = decode_plan(n, groups, sms, cols=8 * wc)
        if -(-n // (8 * wc)) * cluster >= 2 * sms:
            break
    return cluster, wc


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile_m(x: torch.Tensor, n: int) -> int:
    if n % 4:
        raise ValueError(f"the prefill kernels take N a multiple of 4, got {n}")
    return prefill_tile_m(x.shape[0], n, _sm_count(x.device.index or 0))


def quant_matmul_plain(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
    szeros: torch.Tensor, bits: int, group_size: int, a8_order: bool = False,
) -> torch.Tensor:
    """x [M, K] -> [M, N] in x's dtype. Mirrors the JAX package's
    `quant_matmul_xla`: f32 compute, grouped products, the scale/zero
    correction applied to the per-group accumulator. Pair-layout words only."""
    if a8_order:
        raise ValueError("A8-ordered qweight cannot go through the pair-layout plain path")
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
    # decode: + cluster and columns a warp; prefill: + bf16 copy and xsum scratch, tile rows
    n_ptr, n_int = (7, 7) if fn_name == "bd_qmm_prefill" else (5, 8)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_args(x, qweight, combo, bits, group_size):
    if not (_device.on_card(x) and qweight.device == x.device):
        raise ValueError("the packed matmul kernel takes CUDA tensors on one device")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the packed matmul kernel takes x in {KERNEL_DTYPES}, got {x.dtype}")
    if combo is None:
        raise ValueError("the packed layer has no combo words (make_scale_combo)")
    if qweight.dtype != torch.int32 or combo.dtype != torch.int32:
        raise ValueError("qweight and combo must be int32")
    if bits not in KERNEL_BITS:
        raise ValueError(f"bits={bits}: the packed matmul kernel takes bits in {KERNEL_BITS}")
    m, k = x.shape
    if not kernel_group_ok(group_size, k):
        raise ValueError(f"group_size={group_size}, K={k}: the kernel takes 32 or 64 (K a "
                         f"multiple of 64) or a multiple of 128 dividing K")
    n = qweight.shape[-1]
    if qweight.shape != (k // (32 // bits), n) or combo.shape != (k // group_size, n):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, qweight {tuple(qweight.shape)}, "
            f"combo {tuple(combo.shape)} at bits={bits}, group={group_size}"
        )
    if combo.device != x.device or not (
            x.is_contiguous() and qweight.is_contiguous() and combo.is_contiguous()):
        raise ValueError("the kernel takes row-major contiguous x, qweight and combo")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it, at a 16-byte aligned address (the kernels load x
    16 bytes at a time)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def group_sums_scratch(m: int, k: int, dtype, device, group_size: int = 128) -> torch.Tensor:
    """The prefill kernels' scratch for x's group sums: [K / min(g, 128),
    round_up(M, 4)] (one sum a group, or a step of a larger group)."""
    fold = min(group_size, KERNEL_STEP)
    return torch.empty((k // fold, -(-m // 4) * 4), dtype=dtype, device=device)


_KMAPS: dict = {}


def _device_table(key, make, device) -> Optional[torch.Tensor]:
    """A kmap table as a device int32 tensor, made once a device (None: no table)."""
    key = key + (str(device),)
    if key not in _KMAPS:
        table = make()
        _KMAPS[key] = None if table is None else torch.from_numpy(table).to(device)
    return _KMAPS[key]


def _step_kmap(bits: int, group_size: int, device) -> Optional[torch.Tensor]:
    if group_size <= KERNEL_STEP:
        return None
    return _device_table(("step", bits, group_size), lambda: step_kmap(bits, group_size), device)


def qmm_decode(x, qweight, combo, bits: int, group_size: int) -> torch.Tensor:
    """Decode kernel (M <= 32): x [M, K] @ packed [K, N] on the card, on
    `a16_decode_plan`'s clusters."""
    _check_args(x, qweight, combo, bits, group_size)
    m, k = x.shape
    n = qweight.shape[-1]
    if m > DECODE_MAX_M:
        raise ValueError(f"decode kernel takes M <= {DECODE_MAX_M}, got {m}")
    x = _aligned(x)
    cluster, warp_cols = a16_decode_plan(n, kernel_steps(k), _sm_count(x.device.index or 0))
    kmap = _step_kmap(bits, group_size, x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _launcher("bd_qmm_decode")(
        x.data_ptr(), qweight.data_ptr(), combo.data_ptr(), _ptr(kmap), out.data_ptr(),
        m, k, n, bits, group_size, cluster, warp_cols, int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "bd_qmm_decode")
    qmm_decode.launches += 1
    return out


def qmm_prefill(x, qweight, combo, bits: int, group_size: int) -> torch.Tensor:
    """Prefill kernel (wgmma tiles, any M; N a multiple of 4): x [M, K] @
    packed [K, N] on the card."""
    _check_args(x, qweight, combo, bits, group_size)
    m, k = x.shape
    n = qweight.shape[-1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xsum = group_sums_scratch(m, k, torch.float32, x.device, group_size)
    kmap = _step_kmap(bits, group_size, x.device)
    f32 = x.dtype == torch.float32
    # the bf16 copy of x (rounded, in step order) that TMA reads instead of x
    xb = torch.empty((m, k), dtype=torch.bfloat16, device=x.device) if f32 or kmap is not None else None
    err = _launcher("bd_qmm_prefill")(
        x.data_ptr(), qweight.data_ptr(), combo.data_ptr(), _ptr(kmap), _ptr(xb),
        xsum.data_ptr(), out.data_ptr(), m, k, n, bits, group_size, _tile_m(x, n), int(f32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "bd_qmm_prefill")
    qmm_prefill.launches += 1
    return out


qmm_decode.launches = 0
qmm_prefill.launches = 0


def quant_matmul(x: torch.Tensor, p: PackedLinear, li: Optional[int] = None) -> torch.Tensor:
    """x [..., K] -> [..., N]. `li` selects layer li of a stacked PackedLinear
    (read in place through views). The JAX package's dispatch, with "Pallas"
    read as "CUDA tensor": A8-ordered words always go to the A8 matmul; with
    BITDISTILLER_QMM_A8 on, a pair-layout int2/int4 leaf on the card does too
    (through a per-call permutation of x); everything else is A16."""
    k, n = p.in_features, p.out_features
    xf = x.reshape(-1, k).contiguous()
    if p.a8_order or (_device.on_card(xf) and p.bits in A8_BITS and a8_enabled()):
        return quant_matmul_a8(x, p, li)
    if _device.on_card(xf):
        # index only what the kernel reads: this runs 4 times a layer a step
        qweight = p.qweight if li is None else p.qweight[li]
        combo = p.combo if li is None or p.combo is None else p.combo[li]
        launch = qmm_decode if xf.shape[0] <= DECODE_MAX_M else qmm_prefill
        out = launch(xf, qweight, combo, p.bits, p.group_size)
    elif xf.device.type == "cpu":
        layer = p if li is None else p.layer(li)
        out = quant_matmul_plain(
            xf, layer.qweight, layer.scales, layer.szeros, layer.bits, layer.group_size
        )
    else:
        raise ValueError(f"no packed matmul for device {xf.device}")
    if p.bias is not None:
        out = out + (p.bias if li is None else p.bias[li]).to(out.dtype)
    return out.reshape(*x.shape[:-1], n)


# ---------------------------------------------------------------------------
# W{2,4}A8: per-token int8 activations, int8 x int8 -> int32 group products.
#
# The A8 kernel extracts codes as int8 BYTES: (w >> bits*i) & 0x0m0m0m0m gives
# four codes a word. Read from pair-layout words, that order is a fixed
# permutation of k within each group (`_a8_perm`), folded into x per call;
# `repack_linear_a8` instead writes the words in the extraction order once, so
# that byte lane j of bit field i of word row r holds k = i*4R + 4r + j.
#   out = sx_m * sum_g (s_g * (xi . q)_g - sz_g * sum(xi_g)),
#   sx_m = max(max|x_m| / 127, 1e-8), xi = clip(round(x / sx), -127, 127).
# ---------------------------------------------------------------------------

A8_ENV = "BITDISTILLER_QMM_A8"  # the JAX package's switch; the port adds none
A8_BITS = (2, 4)


def a8_enabled() -> bool:
    """The JAX package's truth rule for its switch: unset, "" and "0" are off."""
    return os.environ.get(A8_ENV, "") not in ("", "0")


def _a8_perm(bits: int, group_size: int) -> np.ndarray:
    """kmap[p] = source k (pair layout) for extraction-order row p."""
    pack = 32 // bits
    half = pack // 2
    r_words = group_size // pack
    cpb = 8 // bits  # codes per byte
    kmap = np.empty(group_size, np.int32)
    for i in range(cpb):
        for r in range(r_words):
            for j in range(4):  # byte lanes of the int32 word
                f = cpb * j + i  # bit-field index in the word
                kmap[i * 4 * r_words + 4 * r + j] = (f % half) * 2 * r_words + 2 * r + f // half
    return kmap


def _a8_dims(k: int, bits: int, group_size: int) -> tuple[int, int, int, int]:
    if bits not in A8_BITS:
        raise ValueError(f"bits={bits}: the A8 byte order takes bits in {A8_BITS}")
    pack = 32 // bits
    g = group_size if group_size > 0 else k
    if k % g or g % pack:
        raise ValueError(f"K={k}, group_size={g}: groups must be whole words of {pack} codes")
    return pack, g, g // pack, 8 // bits


def _a8_shifts(bits: int, device) -> torch.Tensor:
    """Shift of (bit field i, byte lane j), shaped [1, i, 1, j, 1]."""
    cpb = 8 // bits
    i = torch.arange(cpb, dtype=torch.int64, device=device)[:, None] * bits
    j = torch.arange(4, dtype=torch.int64, device=device)[None, :] * 8
    return (i + j)[None, :, None, :, None]


def pack_codes_a8(q_kn: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    """Natural-order codes [K, N] -> int32 [K//pack, N] in the A8 extraction
    order (bit-identical to the JAX package's `pack_codes_a8`)."""
    k, n = q_kn.shape
    pack, g, r, cpb = _a8_dims(k, bits, group_size)
    q = q_kn.to(torch.int64).reshape(k // g, cpb, r, 4, n)
    words = (q << _a8_shifts(bits, q.device)).sum(dim=(1, 3))
    return _to_int32(words.reshape(k // pack, n))


def unpack_codes_a8(qweight: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    """Inverse of `pack_codes_a8`: int32 [K//pack, N] -> codes [K, N]."""
    kp, n = qweight.shape
    k = kp * (32 // bits)
    _, g, r, _ = _a8_dims(k, bits, group_size)
    w = (qweight.to(torch.int64) & (_U32 - 1)).reshape(k // g, 1, r, 1, n)
    codes = (w >> _a8_shifts(bits, w.device)) & ((1 << bits) - 1)
    return codes.reshape(k, n).to(torch.int32)


def repack_linear_a8(p: PackedLinear) -> PackedLinear:
    """Pair layout -> A8 extraction order, once. A stacked [L, K/pack, N] leaf
    is repacked one layer at a time (an all-layer int64 unpack of the 7B
    gate_up would take about 23 GB). Scales, szeros and combo are order-
    invariant within a group and stay. The result goes only through the A8
    matmul (a8_order=True)."""
    if p.a8_order:
        return p
    qw = p.qweight
    if qw.ndim == 2:
        new = pack_codes_a8(unpack_codes(qw, p.bits, p.group_size), p.bits, p.group_size)
    else:
        new = torch.empty_like(qw)
        for li in range(qw.shape[0]):
            codes = unpack_codes(qw[li], p.bits, p.group_size)
            new[li] = pack_codes_a8(codes, p.bits, p.group_size)
    return dataclasses.replace(p, qweight=new, a8_order=True)


def maybe_repack_a8(params):
    """With BITDISTILLER_QMM_A8 on, a copy of the param tree with every
    PackedLinear repacked for the A8 matmul; otherwise `params` itself.
    Call once at model load."""
    if not a8_enabled():
        return params

    def walk(node):
        if isinstance(node, PackedLinear):
            return repack_linear_a8(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def quantize_a8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 of x [M, K]: (xi as f32 integers, sx [M, 1]).
    Divisions are true IEEE divisions by a tensor, as the CUDA prologue's."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=1, keepdim=True)
    sx = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    return torch.clamp(torch.round(xf / sx), -127, 127), sx


def quant_matmul_a8_plain(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, szeros: torch.Tensor,
    bits: int, group_size: int, a8_order: bool, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x [M, K] -> [M, N] in x's dtype, as the A8 kernels compute it: x
    quantized per token, int group products (exact in f32: every partial sum
    is an integer below 2^24), then acc = acc + partial*s - xsum*sz group by
    group in order, out = acc * sx (+ bias) rounded once to x's dtype. The dot
    is permutation-invariant, so the codes are unpacked to natural order
    rather than permuting x."""
    m, k = x.shape
    n = qweight.shape[-1]
    _, g, _, _ = _a8_dims(k, bits, group_size)
    xi, sx = quantize_a8(x)
    codes = (unpack_codes_a8 if a8_order else unpack_codes)(qweight, bits, g)
    xg = xi.reshape(m, k // g, g)
    partial = torch.einsum("mgk,gkn->mgn", xg, codes.to(torch.float32).reshape(k // g, g, n))
    xsum = xg.sum(dim=-1)
    s, sz = scales.to(torch.float32), szeros.to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for gi in range(k // g):
        acc = acc + partial[:, gi] * s[gi] - xsum[:, gi, None] * sz[gi]
    out = acc * sx
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def a8_kmap(bits: int, group_size: int, a8_order: bool) -> Optional[np.ndarray]:
    """The A8 kernels' kmap of one group: kmap[k'] = the k of x whose code
    the kernel finds at position k' (the quantization kernel permutes x to
    match). Pair-layout words: `_a8_perm`; A8-ordered words: None. Above
    128 the group is read as g / 128 steps of 128 in the A8 byte order
    (word row w, bit field i, byte lane j: k' = (w // RS) * 128 + 4 * RS * i
    + 4 * (w % RS) + j), composed with where the group's own layout keeps
    that code."""
    if group_size <= KERNEL_STEP:
        return None if a8_order else _a8_perm(bits, group_size)
    pack, cpb = 32 // bits, 8 // bits
    r, rs = group_size // pack, KERNEL_STEP // pack
    w = np.arange(r)[:, None, None]
    i = np.arange(cpb)[None, :, None]
    j = np.arange(4)[None, None, :]
    kprime = (w // rs) * KERNEL_STEP + i * 4 * rs + 4 * (w % rs) + j
    if a8_order:
        k = i * 4 * r + 4 * w + j
    else:
        f = cpb * j + i  # the bit field of the word the extraction reads
        k = (f % (pack // 2)) * 2 * r + 2 * w + f // (pack // 2)
    kmap = np.empty(group_size, np.int32)
    kmap[kprime.ravel()] = np.broadcast_to(k, kprime.shape).ravel()
    return kmap


def _kmap(bits: int, group_size: int, a8_order: bool, device) -> Optional[torch.Tensor]:
    return _device_table(("a8", bits, group_size, a8_order),
                         lambda: a8_kmap(bits, group_size, a8_order), device)


@functools.lru_cache(maxsize=None)
def _a8_launcher():
    fn = _build.load("quant_matmul_a8").bd_qmm_a8
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def qmm_a8(x, qweight, scales, szeros, bits: int, group_size: int, a8_order: bool,
           bias=None) -> torch.Tensor:
    """A8 kernels (any M): quantize x [M, K] per token (and permute it for
    pair-layout words) and multiply with packed [K, N] on the card: up to
    DECODE_MAX_M rows the streaming decode kernel on `decode_plan`'s
    clusters, above through the prefill kernel (N a multiple of 4), counted
    in `qmm_a8.prefill_launches` as well as `qmm_a8.launches`."""
    if not (_device.on_card(x) and all(t.device == x.device for t in (qweight, scales, szeros))):
        raise ValueError("the A8 matmul kernel takes CUDA tensors on one device")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the A8 matmul kernel takes x in {KERNEL_DTYPES}, got {x.dtype}")
    m, k = x.shape
    if bits not in A8_BITS or not kernel_group_ok(group_size, k):
        raise ValueError(f"the A8 kernel takes bits in {A8_BITS} and group 32 or 64 (K a "
                         f"multiple of 64) or a multiple of 128 dividing K = {k}; got {bits}, "
                         f"{group_size}")
    n = qweight.shape[-1]
    if (qweight.dtype != torch.int32 or qweight.shape != (k // (32 // bits), n)
            or scales.shape != (k // group_size, n) or szeros.shape != scales.shape
            or scales.dtype != torch.float32 or szeros.dtype != torch.float32):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, qweight {tuple(qweight.shape)} "
            f"{qweight.dtype}, scales {tuple(scales.shape)} {scales.dtype} at bits={bits}")
    if not all(t.is_contiguous() for t in (x, qweight, scales, szeros)):
        raise ValueError("the A8 kernel takes row-major contiguous x, qweight, scales, szeros")
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        if bias.shape != (n,) or bias.device != x.device:
            raise ValueError(f"bias must be [{n}] on x's device")
    x = _aligned(x)
    prefill = m > DECODE_MAX_M
    tile = _tile_m(x, n) if prefill else 0
    cluster = 0 if prefill else decode_plan(n, kernel_steps(k), _sm_count(x.device.index or 0))
    kmap = _kmap(bits, group_size, a8_order, x.device)
    xi = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    xsum = group_sums_scratch(m, k, torch.int32, x.device, group_size) if prefill else None
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _a8_launcher()(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), szeros.data_ptr(), _ptr(bias),
        _ptr(kmap), xi.data_ptr(), sx.data_ptr(), _ptr(xsum), out.data_ptr(),
        m, k, n, bits, group_size, tile, cluster, int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "bd_qmm_a8")
    qmm_a8.launches += 1
    if prefill:
        qmm_a8.prefill_launches += 1
    return out


qmm_a8.launches = 0
qmm_a8.prefill_launches = 0


def quant_matmul_a8(x: torch.Tensor, p: PackedLinear, li: Optional[int] = None) -> torch.Tensor:
    """W{2,4}A8 matmul x [..., K] -> [..., N] (layer li of a stacked leaf, read
    in place): the kernel on a CUDA tensor, the plain version on a CPU one."""
    k, n = p.in_features, p.out_features
    xf = x.reshape(-1, k).contiguous()
    take = (lambda a: a) if li is None else (lambda a: None if a is None else a[li])
    args = (xf, take(p.qweight), take(p.scales), take(p.szeros), p.bits, p.group_size,
            p.a8_order, take(p.bias))
    if _device.on_card(xf):
        out = qmm_a8(*args)
    elif xf.device.type == "cpu":
        out = quant_matmul_a8_plain(*args)
    else:
        raise ValueError(f"no A8 matmul for device {xf.device}")
    return out.reshape(*x.shape[:-1], n)
