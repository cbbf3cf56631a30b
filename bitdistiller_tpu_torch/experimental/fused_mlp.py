"""Fused packed MLP, out = (act(x @ Wg) * (x @ Wu)) @ Wd (port of the JAX
package's `experimental/fused_mlp.py`, whose Pallas `_mlp_kernel` the CUDA
kernel csrc/fused_mlp.cu replaces).

Semantics kept from the JAX kernel: x and the intermediate `mid` enter the
products as bf16, codes as (q + 2^bits) with the offset folded into the
zero correction, each group adds `partial*s - sum(x_g)*(sz + 2^bits*s)` to an
f32 accumulator (sum(x_g) over the unrounded f32 values), the scales are
f32, and the down product accumulates ffn tiles of `block_f` columns in
order. act "silu" is x*sigmoid(x); any other name is the tanh form of GELU:
`jax.nn.gelu` defaults to approximate=True, so the JAX kernel's "gelu"
branch and its fallback branch compute the same function.

On a CPU tensor `fused_mlp` runs the plain version; on a CUDA tensor it
launches the kernel or raises. No model calls it, as in the JAX package.
On the card a call is two launches (gate/up, then down, chained by
programmatic dependent launch) on the clusters `mlp_plan` sizes; mid passes
between them through L2 as bf16 with its f32 sums over each group of
min(g, 128) ffn columns (see csrc/fused_mlp.cu). Groups of 32, 64, 128 and
multiples of 128 (per-channel included) run in the kernel, as in the packed
matmuls (ops/quant_matmul.py: kernel_group_ok, step_kmap); f32 x is rounded
to bf16 as the kernel stages it, and the output takes x's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _device
from ..ops import _build
from ..ops.quant_matmul import (
    KERNEL_DTYPES,
    KERNEL_STEP,
    _aligned,
    _ptr,
    _sm_count,
    _step_kmap,
    decode_plan,
    kernel_group_ok,
    kernel_steps,
)
from ..quant.packing import PackedLinear, unpack_codes

_OFFSET = {2: 4.0, 4: 16.0}  # the bf16 exponent-bias trick's code offset
KERNEL_BITS = (2, 4)
KERNEL_COLS = 128  # output columns a cluster, both launches (csrc/fused_mlp.cu: COLS)


def _act(gate: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return gate * torch.sigmoid(gate)  # jax.nn.silu
    return F.gelu(gate, approximate="tanh")  # jax.nn.gelu's default, both branches


def _packed_acc(x: torch.Tensor, codes: torch.Tensor, p: PackedLinear, g0: int) -> torch.Tensor:
    """f32 [M, N] of x [M, n*G] against the unpacked codes [n*G, N] of groups
    g0 .. g0 + n - 1 of `p`, in group order: acc + partial*s - xsum*(sz +
    off*s), with partial = bf16(x) @ (q + off)."""
    m = x.shape[0]
    g = p.group_size
    n_groups = codes.shape[0] // g
    off = _OFFSET[p.bits]
    vals = codes.to(torch.float32).reshape(n_groups, g, -1) + off
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(m, n_groups, g)
    partial = torch.einsum("mgk,gkn->mgn", xb, vals)
    xsum = x.to(torch.float32).reshape(m, n_groups, g).sum(dim=-1)
    s = p.scales.to(torch.float32)[g0:g0 + n_groups]
    zc = p.szeros.to(torch.float32)[g0:g0 + n_groups] + off * s
    acc = torch.zeros((m, vals.shape[-1]), dtype=torch.float32, device=x.device)
    for j in range(n_groups):
        acc = acc + partial[:, j] * s[j] - xsum[:, j, None] * zc[j]
    return acc


def _block_f(block_f: int, ffn: int, group_size: int) -> int:
    """The JAX entry's ffn tile: halved until it divides the ffn width. A
    tile narrower than a group would drop the down product in JAX (0 groups
    a tile); here it raises."""
    if block_f < 1:
        raise ValueError(f"block_f must be positive, got {block_f}")
    while ffn % block_f != 0:
        block_f //= 2
    if block_f % group_size:
        raise ValueError(f"ffn tile {block_f} is not a whole number of groups ({group_size})")
    return block_f


def _check_layers(gate: PackedLinear, up: PackedLinear, down: PackedLinear) -> None:
    if not (gate.in_features == up.in_features and gate.out_features == up.out_features
            == down.in_features):
        raise ValueError("gate/up [K, FFN] and down [FFN, D] widths disagree")
    if len({gate.bits, up.bits, down.bits}) != 1 or len(
            {gate.group_size, up.group_size, down.group_size}) != 1:
        raise ValueError("the three layers must share bits and group size")
    if any(p.a8_order for p in (gate, up, down)):
        raise ValueError("the fused MLP reads pair-layout words, not A8-ordered ones")


def fused_mlp_plain(x, gate: PackedLinear, up: PackedLinear, down: PackedLinear,
                    act: str = "silu", *, block_f: int = 256) -> torch.Tensor:
    """The JAX kernel's arithmetic in plain PyTorch: x [M, K] -> [M, D]."""
    _check_layers(gate, up, down)
    ffn, g = gate.out_features, gate.group_size
    block_f = _block_f(block_f, ffn, g)
    codes = lambda p: unpack_codes(p.qweight, p.bits, g)
    mid = _act(_packed_acc(x, codes(gate), gate, 0), act) * _packed_acc(x, codes(up), up, 0)
    down_codes = codes(down)
    acc = torch.zeros((x.shape[0], down.out_features), dtype=torch.float32, device=x.device)
    for f0 in range(0, ffn, block_f):
        acc = acc + _packed_acc(mid[:, f0:f0 + block_f], down_codes[f0:f0 + block_f], down,
                                f0 // g)
    return acc.to(x.dtype)


def mlp_plan(k: int, ffn: int, d: int, sms: int) -> tuple[int, int]:
    """Cluster sizes of the kernel's two launches (`decode_plan` for both):
    gate/up clusters split the K steps (128 k) of each 128-column ffn tile,
    down clusters the ffn steps of each 128-column output tile."""
    return (decode_plan(ffn, kernel_steps(k), sms, cols=KERNEL_COLS),
            decode_plan(d, kernel_steps(ffn), sms, cols=KERNEL_COLS))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("fused_mlp").bd_fused_mlp
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scratch(m: int, ffn: int, device, group_size: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch: mid [M, FFN] bf16 and its group sums
    [M, FFN / min(g, 128)] f32."""
    return (torch.empty((m, ffn), dtype=torch.bfloat16, device=device),
            torch.empty((m, ffn // min(group_size, KERNEL_STEP)), dtype=torch.float32,
                        device=device))


def _launch(x, gate, up, down, act) -> torch.Tensor:
    layers = (gate, up, down)
    arrays = [a for p in layers for a in (p.qweight, p.scales, p.szeros)]
    if not all(a.device == x.device for a in arrays):
        raise ValueError("the fused MLP kernel takes CUDA tensors on one device")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the fused MLP kernel takes x in {KERNEL_DTYPES}, got {x.dtype}")
    m, k = x.shape
    ffn, d = gate.out_features, down.out_features
    g = gate.group_size
    if gate.bits not in KERNEL_BITS or not (kernel_group_ok(g, k) and kernel_group_ok(g, ffn)):
        raise ValueError(f"the kernel takes bits in {KERNEL_BITS} and a group of 32 or 64 (K "
                         f"a multiple of 64) or a multiple of 128 dividing K and FFN; got "
                         f"{gate.bits}, {g}")
    if ffn % KERNEL_COLS:
        raise ValueError(f"the kernel takes FFN in multiples of {KERNEL_COLS}, got {ffn}")
    if any(p.bias is not None for p in layers):
        raise ValueError("the fused MLP has no bias (nor has the JAX kernel)")
    if not all(a.is_contiguous() for a in [x] + arrays) or any(
            p.scales.dtype != torch.float32 or p.szeros.dtype != torch.float32 for p in layers):
        raise ValueError("the kernel takes contiguous arrays and f32 scales and szeros")
    x = _aligned(x)
    mid, msum = scratch(m, ffn, x.device, g)
    kmap = _step_kmap(gate.bits, g, x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    err = _launcher()(
        x.data_ptr(), *[a.data_ptr() for a in arrays], _ptr(kmap), _ptr(kmap), mid.data_ptr(),
        msum.data_ptr(), out.data_ptr(), m, k, ffn, d, gate.bits, g, 0 if act == "silu" else 1,
        *mlp_plan(k, ffn, d, _sm_count(x.device.index or 0)), int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "bd_fused_mlp")
    return out


def fused_mlp(x: torch.Tensor, gate: PackedLinear, up: PackedLinear, down: PackedLinear,
              act: str = "silu", *, block_f: int = 256) -> torch.Tensor:
    """x [..., K] -> [..., D] through the fused packed MLP. `block_f` is the
    JAX kernel's ffn tile, which sets the plain version's summation order;
    the CUDA kernel sums the down product over the ffn groups in order within
    a CTA, then over the CTAs of a cluster in rank order."""
    _check_layers(gate, up, down)
    _block_f(block_f, gate.out_features, gate.group_size)
    xf = x.reshape(-1, gate.in_features).contiguous()
    if _device.on_card(xf):
        out = _launch(xf, gate, up, down, act)
        fused_mlp.launches += 1
    elif xf.device.type == "cpu":
        out = fused_mlp_plain(xf, gate, up, down, act, block_f=block_f)
    else:
        raise ValueError(f"no fused MLP for device {xf.device}")
    return out.reshape(*x.shape[:-1], down.out_features)


fused_mlp.launches = 0  # calls that launched the kernels (CUDA tensors)
