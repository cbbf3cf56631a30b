"""Causal flash attention for training (forward and backward): the plain
PyTorch version and the wrappers of the hand-written CUDA kernels
(csrc/train_attention.cu), which replace the stock Pallas TPU flash
attention that the JAX package's `models/layers.py:flash_train_attention`
calls (its forward, dkv and dq kernels).

The function is JAX's `flash_train_attention`: q [B, S, Hq, D], k and v
[B, S, Hkv, D] (GQA: query head h reads kv head h // rep), causal, with
segment ids from the padding mask (1 real, 0 pad: a query attends to keys at
or before it with its own segment id), the finite mask value
-0.7 * f32max, sm_scale = 1/sqrt(D), softmax in f32, the output in q's dtype.
Pad rows' outputs are garbage in both packages and sit under label -100.
Any D: JAX pads D to a multiple of 128 and scales by the real D; here
`flash_train_attention` pads q, k and v with zero columns to a multiple of
16 (KERNEL_HEAD_STEP), hands every kernel and plain version the real D's
scale, and slices the result back (autograd slices the gradients).

On a CPU tensor `flash_train_attention` runs the plain version (autograd
differentiates it); on a CUDA tensor it runs `TrainAttention`, a
torch.autograd.Function whose forward launches `train_attn_fwd` and whose
backward launches `train_attn_bwd_dkv` and `train_attn_bwd_dq`, or raises.
It saves q, k, v, o and the f32 log-sum-exp, so it is safe under
torch.utils.checkpoint (a recompute launches the forward again).
`di = rowsum(o * do)` in f32 stays a plain op, as JAX computes it outside
Pallas. The route by dtype and D:

- bf16 up to D = 256: the forward, dq and dkv are wgmma kernels fed by a
  TMA ring (dkv above D = 128 by its wide kernel, which walks twice with
  D's columns split between its warpgroups).
- f32 up to D = 128: the three are 3xTF32 wgmma kernels (each operand
  split into tf32 hi and lo, three products: `tf32x3_matmul` is its plain
  emulation, `train_attn_bwd_tf32x3_emulated` and
  `train_attn_fwd_tf32x3_emulated` the kernels', which only the tests use).
- f32 at 128 < D <= SPLIT_MAX_HEAD_DIM = 1024: the same three kernels on
  splits, clusters of ns = ceil(D / SPLIT_COLS) CTAs (2 to MAX_CLUSTER)
  that split D's columns, each taking the score products over its
  SPLIT_COLS columns, leaving its partials in its own shared memory and
  pulling the ns partials in rank order (the emulations sum such chunks in
  that order).
- bf16 at 256 < D <= 1024: the f32 splits, on f32 copies (`_kernel_inputs`)
  of q, k and v that `train_attn_fwd` makes, and of q, k, v and dout that
  `TrainAttention.backward` makes once for dkv and dq; the output and the
  gradients rounded to bf16 once, the lse f32. A bf16 value is exact in f32
  and in tf32 (8 significand bits against 11), so the products lose
  nothing: the kernels compute in f32 on the bf16 inputs and round once,
  as the plain version does and as the CUDA-core kernels there did before.
- The CUDA-core kernels (one warp a row, the CTAs splitting D's output
  columns into slices of WIDE_COLS, each slice recomputing the scores):
  all three above D = 1024, both dtypes (routing by shape: a split would
  pass the portable cluster of 8). No model of either package has such a
  head dim.

`train_attn_bwd_dq_plain` is dq alone in plain PyTorch from the kernel's
own inputs (lse, di), what the dq kernel is held to on the card.

The launches follow `fwd_plan`, `dkv_plan` and `dq_plan` (the kernel by
dtype and D, the cluster size, the grid) and `dkv_walk` (what each CTA of
a dkv cluster walks); csrc/train_attention.cu's `dispatch` refuses a
cluster that is not the plan's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import _device
from . import _build
from .quant_matmul import MAX_CLUSTER

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # flash_attention.py: DEFAULT_MASK_VALUE
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_HEAD_STEP = 16  # the kernels take D a multiple of this; other D is padded to one
MAX_HEAD_DIM = 256  # above: bf16 widened to f32 for the splits
WIDE_COLS = 256  # the CUDA-core kernels: output columns a CTA (above, slices)
# above: a 64 x D f32 accumulator a warpgroup does not fit beside its score
# tiles, so the wide kernel splits D between the warpgroups and walks twice
DKV_WGMMA_MAX_HEAD_DIM = 128
DKV_KEY_TILE = 64     # the dkv kernels on the tensor cores: key rows a CTA
DKV_QUERY_TILE = 64   # ... query rows a ring stage (bf16)
DKV_TF32_QUERY_TILE = 32  # ... and of the 3xTF32 kernel (f32 tiles: twice bf16's, plus lo planes)
SPLIT_COLS = 128  # f32 above D = 128: D's columns each CTA of a split owns
SPLIT_MAX_HEAD_DIM = SPLIT_COLS * MAX_CLUSTER  # above: the three on CUDA cores, both dtypes
F32_ROWS = 8          # the CUDA-core kernels: rows (one a warp) a CTA
FWD_TF32_QUERY_TILE = 64  # the f32 forward: query rows a CTA ...
FWD_TF32_KEY_STAGE = 32   # ... and key rows a ring stage
DQ_QUERY_TILE = 64        # the dq kernels on the tensor cores: query rows a CTA ...
DQ_TF32_KEY_STAGE = 32    # ... and key rows a ring stage of the 3xTF32 kernels


def split_ctas(d: int) -> int:
    """CTAs of a cluster that split D's columns, SPLIT_COLS each, on the f32
    tensor-core kernels: 1 up to SPLIT_COLS, then 2 up to MAX_CLUSTER
    (csrc/train_attention.cu: split_ctas)."""
    return 1 if d <= SPLIT_COLS else -(-d // SPLIT_COLS)


def _takes_tf32(d: int, dtype) -> bool:
    """The forward, dkv and dq on the 3xTF32 kernels: f32 up to
    SPLIT_MAX_HEAD_DIM, and bf16 above MAX_HEAD_DIM (on f32 copies,
    `widened`)."""
    return d <= SPLIT_MAX_HEAD_DIM and (dtype == torch.float32 or d > MAX_HEAD_DIM)


def widened(dtype, d: int) -> bool:
    """bf16 at MAX_HEAD_DIM < D <= SPLIT_MAX_HEAD_DIM: the f32 split
    kernels (forward, dkv, dq) on f32 copies of their inputs, the output and
    the gradients rounded to bf16 once."""
    return dtype == torch.bfloat16 and MAX_HEAD_DIM < d <= SPLIT_MAX_HEAD_DIM


@dataclass(frozen=True)
class DkvPlan:
    """How the dkv kernel covers [B, S, Hkv] key rows. On the tensor cores a
    cluster of `cluster` CTAs a key tile of 64 rows, splitting the rep query
    heads; `kernel` is, for bf16 up to D = 256, "wgmma" (D <= 128:
    `train_attn_dkv_ws_kernel`, its two warpgroups splitting the products of
    one walk) or "wgmma_wide" (128 < D <= 256: `train_attn_dkv_wide_kernel`,
    its warpgroups splitting D's columns over two walks, dv then dk), and for
    f32 (and widened bf16 above D = 256) "tf32x3" (D <= 128:
    `train_attn_dkv_tf32_kernel`, one warpgroup, query stages of
    `query_tile` rows, `smem` bytes of shared memory) or "tf32x3_split"
    (128 < D <= 1024, `train_attn_dkv_tf32_split_kernel`): the same body on
    clusters of ns C CTAs, `columns` = ns = split_ctas(D) column ranks each
    owning SPLIT_COLS of D's columns times C = min(rep, MAX_CLUSTER // ns)
    head ranks (within the portable 8), CTA ns r + side walking head rank
    r's heads over its side's columns. `grid` as launched, x first (x is
    the cluster). Both dtypes above D = 1024: "cores_wide"
    (`train_attn_dkv_cores_kernel`, one warp a key row, F32_ROWS a CTA, no
    cluster, its row dots reading k and v from memory: grid (row blocks,
    Hkv, B x ceil(D / WIDE_COLS) column slices))."""

    kernel: str
    cluster: int
    grid: tuple[int, int, int]
    query_tile: int = DKV_QUERY_TILE
    smem: int = 0
    columns: int = 1

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def head_ranks(self) -> int:
        """The CTAs of a cluster that split the query heads (dkv_walk's C):
        the column ranks of a split walk the same heads."""
        return self.cluster // self.columns


def dkv_plan(b: int, s: int, hq: int, hkv: int, d: int, dtype=torch.bfloat16) -> DkvPlan:
    """The dkv launch at these shapes: the kernel by dtype and D, on clusters
    of C = min(rep, MAX_CLUSTER) CTAs on the tensor cores, the grid (C, key
    tiles x Hkv, B) with the key tile slowest, so the longest walks (key
    tile 0) start first. f32 above D = 128 (bf16 above 256, widened): ns
    min(rep, 8 // ns) CTAs, ns = split_ctas(d) column ranks splitting D
    within the portable cluster of 8 (at rep 8 and ns = 2 as many CTAs as
    the D = 128 kernel's clusters of 8, each head rank walking two heads;
    a larger cluster would need the non-portable size). The cluster depends
    on rep and D only, never on the card, so the same inputs give the same
    bits on every card."""
    if d > SPLIT_MAX_HEAD_DIM:
        return DkvPlan("cores_wide", 1, (-(-s // F32_ROWS), hkv, b * -(-d // WIDE_COLS)))
    rep, key_tiles = hq // hkv, -(-s // DKV_KEY_TILE) * hkv
    if _takes_tf32(d, dtype):
        ns = split_ctas(d)
        c = ns * min(rep, MAX_CLUSTER // ns)
        return DkvPlan("tf32x3" if ns == 1 else "tf32x3_split", c, (c, key_tiles, b),
                       DKV_TF32_QUERY_TILE, dkv_tf32_smem(d), ns)
    c = min(rep, MAX_CLUSTER)
    return DkvPlan("wgmma" if d <= DKV_WGMMA_MAX_HEAD_DIM else "wgmma_wide", c, (c, key_tiles, b))


def dkv_tf32_smem(d: int) -> int:
    """Shared memory bytes of `train_attn_dkv_tf32_kernel` at head dim d <=
    128, and of a split's CTA above (DT = SPLIT_COLS), as
    csrc/train_attention.cu's DkvTf32 lays it out: raw K and V (2 x 64 x DT
    f32), the ring's stages of Q and dO as hi and lo planes (4 x 32 x DT f32
    a stage; one stage at DT = 64, two at 128), the p and ds slots' hi and lo
    planes (4 x 64 x 32 f32, where a split's partials land), a stage's lse,
    di and segment ids and its one segment id, the mbarriers (full, empty,
    kv; a split's xready and xfree), and 1024 bytes of alignment."""
    dt, ts = (64 if d <= 64 else SPLIT_COLS), DKV_TF32_QUERY_TILE
    stages = 1 if dt <= 64 else 2
    scal = 2 * DKV_KEY_TILE * dt * 4 + 4 * stages * ts * dt * 4 + 4 * DKV_KEY_TILE * ts * 4
    bar = -(-(scal + stages * (3 * ts + 1) * 4) // 8) * 8
    return bar + (2 * stages + 1 + 2 * (d > SPLIT_COLS)) * 8 + 1024


@dataclass(frozen=True)
class DqPlan:
    """How the dq kernel covers [B, S, Hq] query rows: "wgmma" (bf16 up to
    D = 256: `train_attn_dq_ws_kernel`) and "tf32x3" (f32 up to 128:
    `train_attn_dq_tf32_kernel`) one CTA a (query head, batch, query tile of
    64 rows), grid (Hq, B, query tiles); "tf32x3_split" (f32 at 128 < D <=
    1024, widened bf16 above 256: `train_attn_dq_tf32_split_kernel`): the
    same body on clusters of `cluster` = ns = split_ctas(D) CTAs along x, each
    owning SPLIT_COLS of D's columns, grid (ns Hq, B, query tiles), `smem`
    bytes a CTA; "cores_wide" (above D = 1024): `train_attn_dq_cores_kernel`,
    one warp a query row, F32_ROWS a CTA, grid (row blocks, Hq, B x column
    slices)."""

    kernel: str
    grid: tuple[int, int, int]
    cluster: int = 1
    smem: int = 0

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def dq_plan(b: int, s: int, hq: int, hkv: int, d: int, dtype=torch.bfloat16) -> DqPlan:
    """The dq launch at these shapes: the kernel by dtype and D, its
    cluster and grid (query tiles launched longest first on the tensor
    cores)."""
    if d > SPLIT_MAX_HEAD_DIM:
        return DqPlan("cores_wide", (-(-s // F32_ROWS), hq, b * -(-d // WIDE_COLS)))
    tiles = -(-s // DQ_QUERY_TILE)
    if _takes_tf32(d, dtype):
        ns = split_ctas(d)
        return DqPlan("tf32x3" if ns == 1 else "tf32x3_split", (ns * hq, b, tiles), ns,
                      dq_tf32_smem(d))
    return DqPlan("wgmma", (hq, b, tiles))


def dq_tf32_smem(d: int) -> int:
    """Shared memory bytes of `train_attn_dq_tf32_kernel` at head dim d <=
    128, and of a split's CTA above (DT = SPLIT_COLS), as
    csrc/train_attention.cu's DqTf32 lays it out: raw Q and dO (2 x 64 x DT
    f32), the ring's stages of K and V as hi and lo planes (4 x 32 x DT f32
    a stage; one stage at DT = 64, two at 128), the ds slot's hi and lo
    planes (2 x 64 x 32 f32, where a split's partials land), a stage's
    segment ids and its one segment id, the mbarriers (full, empty, q; a
    split's xready and xfree), and 1024 bytes of alignment."""
    dt, ts = (64 if d <= 64 else SPLIT_COLS), DQ_TF32_KEY_STAGE
    stages = 1 if dt <= 64 else 2
    seg = 2 * DQ_QUERY_TILE * dt * 4 + 4 * stages * ts * dt * 4 + 2 * DQ_QUERY_TILE * ts * 4
    bar = -(-(seg + stages * (ts + 1) * 4) // 8) * 8
    return bar + (2 * stages + 1 + 2 * (d > SPLIT_COLS)) * 8 + 1024


def dkv_walk(s: int, rep: int, cluster: int, rank: int, key_tile: int,
             query_tile: int = DKV_QUERY_TILE) -> list[tuple[int, int]]:
    """(query head within the kv head, query tile) in the order CTA `rank` of
    a cluster walks them for key tile `key_tile`: heads rank, rank + C, ...
    and for each the query tiles of `query_tile` rows (the plan's) from the
    diagonal to the end (tiles above it see no key of the tile). The wide
    kernel walks this list twice, dv then dk."""
    first = key_tile * DKV_KEY_TILE // query_tile
    nq = -(-s // query_tile)
    return [(r, qt) for r in range(rank, rep, cluster) for qt in range(first, nq)]


@dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel covers [B, S, Hq] query rows. "wgmma" (bf16,
    D <= 256) and "tf32x3" (f32, D <= 128: `train_attn_fwd_tf32_kernel`):
    one CTA a (query head, batch, query tile of 64 rows), a consumer
    warpgroup and a producer warp, grid (Hq, B, query tiles); "tf32x3"
    streams key stages of FWD_TF32_KEY_STAGE rows through `stages` ring
    stages in `smem` bytes of shared memory, `ctas_per_sm` CTAs an SM.
    "tf32x3_split" (f32 at 128 < D <= 1024, widened bf16 above 256:
    `train_attn_fwd_tf32_split_kernel`): the same on clusters of `cluster`
    = ns = split_ctas(D) CTAs along x, each owning SPLIT_COLS of D's
    columns, grid (ns Hq, B, query tiles). "cores_wide" (above D = 1024):
    `train_attn_fwd_cores_kernel`, one warp a query row, F32_ROWS a CTA,
    grid (row blocks, Hq, B x column slices)."""

    kernel: str
    grid: tuple[int, int, int]
    stages: int = 0
    smem: int = 0
    ctas_per_sm: int = 0
    cluster: int = 1

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def fwd_tf32_smem(d: int) -> tuple[int, int, int]:
    """(stages, shared memory bytes, CTAs an SM) of `train_attn_fwd_tf32_kernel`
    at head dim d <= 128, and of a split's CTA above (DT = SPLIT_COLS, any
    ns), as csrc/train_attention.cu's FwdTf32 lays it out: the raw Q tile
    (64 x DT f32), a stage's K and V as hi and lo planes (4 x 32 x DT f32),
    the p slot's hi and lo planes (2 x 64 x 32 f32; a split's CTA leaves its
    partial scores in the hi one), the rows' factors (64 f32), the keys'
    segment ids and the stage's one, the mbarriers (full, empty, q; a
    split's xready and xfree), and 1024 bytes of alignment; DT = 64 or
    128."""
    dt, ts = (64 if d <= 64 else SPLIT_COLS), FWD_TF32_KEY_STAGE
    stages, ctas = 2, (2 if dt <= 64 else 1)
    tile, plane, slot = 64 * dt * 4, ts * dt * 4, 64 * ts * 4
    seg = tile + 4 * stages * plane + 2 * slot + 64 * 4  # Q, the ring, p, the factors
    bar = -(-(seg + stages * (ts + 1) * 4) // 8) * 8
    return stages, bar + (2 * stages + 1 + 2 * (d > SPLIT_COLS)) * 8 + 1024, ctas


@functools.lru_cache(maxsize=None)
def fwd_plan(b: int, s: int, hq: int, hkv: int, d: int, dtype=torch.bfloat16) -> FwdPlan:
    """The forward launch at these shapes: the kernel by dtype and D, and its
    grid (query tiles launched longest first on the tensor cores). Cached:
    the wrapper records it on every launch, and a training step launches the
    forward once a layer."""
    if d > SPLIT_MAX_HEAD_DIM:
        return FwdPlan("cores_wide", (-(-s // F32_ROWS), hq, b * -(-d // WIDE_COLS)))
    tiles = -(-s // FWD_TF32_QUERY_TILE)
    if _takes_tf32(d, dtype):
        ns = split_ctas(d)
        return FwdPlan("tf32x3" if ns == 1 else "tf32x3_split", (ns * hq, b, tiles),
                       *fwd_tf32_smem(d), cluster=ns)
    return FwdPlan("wgmma", (hq, b, tiles))


def _allowed(s: int, attn_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """[B or 1, 1, 1, S, S] bool: causal, and the same segment id."""
    pos = torch.arange(s, device=device)
    allow = (pos[None, :] <= pos[:, None])[None, None, None]
    if attn_mask is not None:
        seg = attn_mask.to(torch.int32)
        allow = allow & (seg[:, :, None] == seg[:, None, :])[:, None, None]
    return allow


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if scale is None else scale


def flash_train_attention_plain(q, k, v, attn_mask=None, *, scale=None) -> torch.Tensor:
    """The same function in plain PyTorch, differentiable by autograd: f32
    scores and softmax over [B, Hkv, rep, S, S]; `scale` defaults to
    1/sqrt(D) (a padded call passes the real D's)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).to(torch.float32)
    scores = torch.einsum("bshrd,bthd->bhrst", qg, k.to(torch.float32)) * _scale(d, scale)
    scores = torch.where(_allowed(s, attn_mask, q.device), scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs, v.to(torch.float32))
    return out.reshape(b, s, hq, d).to(q.dtype)


def train_attn_bwd_dq_plain(q, k, v, seg, dout, lse, di, *, scale=None) -> torch.Tensor:
    """dq alone, from the dq kernel's inputs, in f32: p = exp(s - lse) where
    allowed (else 0), ds = p (dout . v - di), dq = scale * ds k; seg [B, S]
    (the padding mask) or None, lse [B, Hq, S], di [B, S, Hq]. Returns dq
    [B, S, Hq, D] in q's dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    scale = _scale(d, scale)
    k32 = k.to(torch.float32)
    qg = q.reshape(b, s, hkv, rep, d).to(torch.float32)
    dog = dout.reshape(b, s, hkv, rep, d).to(torch.float32)
    scores = torch.einsum("bshrd,bthd->bhrst", qg, k32) * scale
    lse_g = lse.to(torch.float32).reshape(b, hkv, rep, s, 1)
    p = torch.where(_allowed(s, seg, q.device), torch.exp(scores - lse_g), 0.0)
    dp = torch.einsum("bshrd,bthd->bhrst", dog, v.to(torch.float32))
    di_g = di.to(torch.float32).reshape(b, s, hkv, rep).permute(0, 2, 3, 1)[..., None]
    dq = torch.einsum("bhrst,bthd->bshrd", p * (dp - di_g), k32) * scale
    return dq.reshape(b, s, hq, d).to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to tf32 as the kernels' cvt.rna.tf32.f32 rounds it: to
    nearest on the bit pattern, ties away from zero, the low 13 bits
    cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the 3xTF32 kernels take it: each operand split into hi =
    tf32(x) and lo = tf32(x - hi), and hi hi + hi lo + lo hi summed in f32
    (lo lo dropped); passes=1 takes hi hi alone (plain TF32). Only the tests
    use it, to show that three passes hold the f32 bar and one does not."""
    if passes not in (1, 3):
        raise ValueError(f"passes is 1 or 3, got {passes}")
    ah, bh = tf32_round(a), tf32_round(b)
    out = ah @ bh
    if passes == 3:
        out = out + ah @ tf32_round(b - bh) + tf32_round(a - ah) @ bh
    return out


def _scores_tf32x3(a, b, mm):
    """a b^T over D (the last dim) as the kernels take the score products:
    by `mm`, and above D = SPLIT_COLS as a split's CTAs do, the products over
    each CTA's SPLIT_COLS columns summed in rank order, ((p0 + p1) + p2) +
    ..."""
    d = a.shape[-1]
    if d <= SPLIT_COLS:
        return mm(a, b.transpose(-1, -2))
    out = None
    for c0 in range(0, d, SPLIT_COLS):
        c = slice(c0, c0 + SPLIT_COLS)
        part = mm(a[..., c], b[..., c].transpose(-1, -2))
        out = part if out is None else out + part
    return out


def train_attn_fwd_tf32x3_emulated(q, k, v, seg, passes: int = 3, *, scale=None):
    """(o [B, S, Hq, D], lse [B, Hq, S]) of the forward with both products
    taken by `tf32x3_matmul`, as `train_attn_fwd_tf32_kernel` takes them: s
    = q k^T (q and k split; above D = SPLIT_COLS in a split's ceil(D /
    SPLIT_COLS) chunks, summed in rank order), the softmax in f32 over the
    allowed keys, o = p v / l (p and v split). f32 results; seg as
    train_attn_bwd_dq_plain's. The kernel's online softmax rescales its sum
    once a key stage: the same function, summed in another order."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    mm = functools.partial(tf32x3_matmul, passes=passes)
    heads = lambda x, r: x.to(torch.float32).reshape(b, s, hkv, r, d).permute(0, 2, 3, 1, 4)
    qg, kg, vg = heads(q, rep), heads(k, 1), heads(v, 1)
    allowed = _allowed(s, seg, q.device)
    sc = torch.where(allowed, _scores_tf32x3(qg, kg, mm) * _scale(d, scale), -torch.inf)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(sc - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = mm(p, vg) / l
    lse = (m + torch.log(l)).reshape(b, hq, s)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d), lse


def train_attn_bwd_tf32x3_emulated(q, k, v, seg, dout, lse, di, passes: int = 3, *, scale=None):
    """dq, dk, dv from the backward kernels' inputs (as
    train_attn_bwd_dq_plain) with every product taken by `tf32x3_matmul`,
    as the f32 kernels take them: s = q k^T, dp = do v^T (above D =
    SPLIT_COLS in a split's ceil(D / SPLIT_COLS) chunks, summed in rank
    order, as dkv and dq take them), p in f32, ds = p (dp - di), dv = p^T
    do, dk = scale ds^T q, dq = scale ds k (p and ds split too). f32 [B, S,
    H, D] results."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    scale = _scale(d, scale)
    mm = functools.partial(tf32x3_matmul, passes=passes)
    heads = lambda x, r: x.to(torch.float32).reshape(b, s, hkv, r, d).permute(0, 2, 3, 1, 4)
    qg, og = heads(q, rep), heads(dout, rep)  # [B, Hkv, rep, S, D]
    kg, vg = heads(k, 1), heads(v, 1)         # [B, Hkv, 1, S, D]
    lse_g = lse.to(torch.float32).reshape(b, hkv, rep, s, 1)
    di_g = di.to(torch.float32).reshape(b, s, hkv, rep).permute(0, 2, 3, 1)[..., None]
    p = torch.where(_allowed(s, seg, q.device),
                    torch.exp(_scores_tf32x3(qg, kg, mm) * scale - lse_g), 0.0)
    ds = p * (_scores_tf32x3(og, vg, mm) - di_g)
    dv = mm(p.transpose(-1, -2), og).sum(2)
    dk = mm(ds.transpose(-1, -2), qg).sum(2) * scale
    dq = mm(ds, kg) * scale
    back = lambda x: x.permute(0, 3, 1, 2, 4).reshape(b, s, -1, d)
    return back(dq), back(dk[:, :, None]), back(dv[:, :, None])


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    fn = getattr(_build.load("train_attention"), name)
    n_ptr = {"bd_train_attn_fwd": 6, "bd_train_attn_dkv": 9, "bd_train_attn_dq": 8}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])  # cluster, f32
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, seg) -> None:
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d % KERNEL_HEAD_STEP or d < KERNEL_HEAD_STEP:
        raise ValueError(f"the kernels take D a multiple of {KERNEL_HEAD_STEP}, got {d} "
                         f"(flash_train_attention pads it)")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernels take q, k, v of one dtype in {KERNEL_DTYPES}")
    if not (_device.on_card(q) and k.device == q.device and v.device == q.device):
        raise ValueError("the training attention kernels take CUDA tensors on one device")
    if seg is not None and (seg.shape != (b, s) or seg.device != q.device):
        raise ValueError(f"the padding mask must be [{b}, {s}] on q's device")


def _dims(q, k):
    b, s, hq, d = q.shape
    return [b, s, hq, k.shape[2], d]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_inputs(q, *rest):
    """q and the kernel's other inputs (the forward's k, v; dkv's and dq's
    k, v, dout) as the kernels take them: f32 copies where `widened` (bf16
    at MAX_HEAD_DIM < D <= SPLIT_MAX_HEAD_DIM, the f32 splits' route), else
    the tensors themselves."""
    if widened(q.dtype, q.shape[3]):
        return tuple(t.to(torch.float32) for t in (q, *rest))
    return (q, *rest)


def train_attn_fwd(q, k, v, seg, scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o [B, S, Hq, D] in q's dtype, lse [B, Hq, S] f32), on
    the kernel of `fwd_plan` (the plan of the last launch stays in
    `train_attn_fwd.plan`). `scale`: 1/sqrt(D) unless given (the real D's
    for a padded call). bf16 where `widened`: the f32 split on f32 copies,
    o rounded to bf16 once."""
    dtype = q.dtype
    plan = fwd_plan(*_dims(q, k), dtype=dtype)
    q, k, v = _kernel_inputs(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=q.device)
    err = _launcher("bd_train_attn_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), out.data_ptr(), lse.data_ptr(),
        *_dims(q, k), _scale(q.shape[3], scale), plan.cluster, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "bd_train_attn_fwd")
    train_attn_fwd.launches += 1
    train_attn_fwd.plan = plan
    return out.to(dtype), lse


def train_attn_bwd_dkv(q, k, v, seg, dout, lse, di,
                       scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """dk, dv [B, S, Hkv, D], summed over the rep query heads in the kernel
    (on the tensor cores by the cluster of `dkv_plan`, in rank order; the
    plan of the last launch stays in `train_attn_bwd_dkv.plan`). bf16 where
    `widened`: the f32 kernel on f32 copies, the result rounded to bf16."""
    dtype = q.dtype
    q, k, v, dout = _kernel_inputs(q, k, v, dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan = dkv_plan(*_dims(q, k), dtype=q.dtype)
    err = _launcher("bd_train_attn_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k), _scale(q.shape[3], scale), plan.cluster, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "bd_train_attn_dkv")
    train_attn_bwd_dkv.launches += 1
    train_attn_bwd_dkv.plan = plan
    return dk.to(dtype), dv.to(dtype)


def train_attn_bwd_dq(q, k, v, seg, dout, lse, di, scale=None) -> torch.Tensor:
    """dq [B, S, Hq, D] (on the tensor cores one CTA, or one cluster of
    `dq_plan`'s split, a (query head, batch, 64-row query tile) owns its
    rows, so the result is the same bits on every run; the plan of the last
    launch stays in `train_attn_bwd_dq.plan`). bf16 where `widened`: the f32
    kernel on f32 copies, the result rounded to bf16."""
    dtype = q.dtype
    q, k, v, dout = _kernel_inputs(q, k, v, dout)
    dq = torch.empty_like(q)
    plan = dq_plan(*_dims(q, k), dtype=q.dtype)
    err = _launcher("bd_train_attn_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(),
        *_dims(q, k), _scale(q.shape[3], scale), plan.cluster, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "bd_train_attn_dq")
    train_attn_bwd_dq.launches += 1
    train_attn_bwd_dq.plan = plan
    return dq.to(dtype)


train_attn_fwd.launches = 0
train_attn_fwd.plan = None  # the FwdPlan of the last launch
train_attn_bwd_dkv.launches = 0
train_attn_bwd_dkv.plan = None  # the DkvPlan of the last launch
train_attn_bwd_dq.launches = 0
train_attn_bwd_dq.plan = None  # the DqPlan of the last launch


class TrainAttention(torch.autograd.Function):
    """The kernels as an autograd Function: forward saves q, k, v, the
    segment ids, o and the log-sum-exp; backward launches dkv and dq, all
    three at `scale` (bf16 where `widened`: on f32 copies made once for
    both, the gradients rounded to bf16 once)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale):
        out, lse = train_attn_fwd(q, k, v, seg, scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        di = (out.to(torch.float32) * dout.to(torch.float32)).sum(dim=-1).contiguous()
        dtype = q.dtype
        q, k, v, dout = _kernel_inputs(q, k, v, dout)  # once for both
        dk, dv = train_attn_bwd_dkv(q, k, v, seg, dout, lse, di, ctx.scale)
        dq = train_attn_bwd_dq(q, k, v, seg, dout, lse, di, ctx.scale)
        return dq.to(dtype), dk.to(dtype), dv.to(dtype), None, None


def padded_head_dim(d: int) -> int:
    """D rounded up to a multiple of KERNEL_HEAD_STEP: the width the kernels
    (and, on the CPU, the plain version) run at."""
    return -(-d // KERNEL_HEAD_STEP) * KERNEL_HEAD_STEP


def flash_train_attention(q, k, v, attn_mask=None) -> torch.Tensor:
    """q [B, S, Hq, D], k, v [B, S, Hkv, D], attn_mask [B, S] (1 = real) or
    None -> [B, S, Hq, D]. CPU tensors: the plain version; CUDA tensors: the
    kernels (any S and D; bf16 or f32). A D that is not a multiple of 16 is
    padded with zero columns (which add nothing to a score and give zero
    output columns) and scaled by the real D, on both routes."""
    d = q.shape[3]
    scale, dp = 1.0 / math.sqrt(d), padded_head_dim(d)
    if dp != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    if not _device.on_card(q):
        if q.device.type != "cpu":
            raise ValueError(f"no training attention for device {q.device}")
        out = flash_train_attention_plain(q, k, v, attn_mask, scale=scale)
    else:
        seg = None if attn_mask is None else attn_mask.to(torch.int32).contiguous()
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        _check(q, k, v, seg)
        out = TrainAttention.apply(q, k, v, seg, scale)
    return out if dp == d else out[..., :d]
