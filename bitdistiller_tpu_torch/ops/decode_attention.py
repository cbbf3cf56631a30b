"""Stacked single-token decode attention: plain PyTorch version and the
wrapper of the hand-written CUDA kernel (csrc/decode_attention.cu), which
replaces the JAX package's Pallas `_fd2_kernel`.

S=1 GQA attention of q [B, 1, Hq, D] (bf16 or f32; any GQA rep, D up to
512) over layer `li` of the stacked head-major cache [L, B, Hkv, T, D]
(bf16, or int8 codes with raw f32 scales [L, B, Hkv, T]), read in place.
Cache rows t < start[b] are valid (and t < attn_len; with a window only
t > start - window); the fresh k/v of the token at position `start` is
folded in last. Softmax in f32.

On the card each (slot, kv head)'s valid rows are split over a thread block
cluster of `attention_plan` CTAs, merged in rank order inside the kernel.
Rep 1, 2, 4 or 8 at D 32, 64, 128 or 256 run instances of their own; any
other rep and D the kernel's general route (`decode_tile`: head tiles of 2
query heads, a width template at or above D).
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import _device
from . import _build
from .quant_matmul import MAX_CLUSTER, _sm_count

_NEG = -1e30
KERNEL_REPS = (1, 2, 4, 8)  # with KERNEL_HEAD_DIMS: an instance of their own
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
GENERAL_HEAD_DIMS = (32, 64, 128, 256, 512)  # the general route's width templates
KERNEL_Q_DTYPES = (torch.bfloat16, torch.float32)


def decode_tile(rep: int, d: int) -> Optional[tuple[int, int]]:
    """(head tile RT, width DT) of the kernel's general route for GQA rep
    `rep` and head dim `d`, or None where an instance of their own exists.
    DT is the least width template at or above D (columns past D are
    masked). RT is 2 query heads (1 at rep 1): the grid walks ceil(rep / 2)
    tiles a kv head (rep 3: a tile of 2 and one of 2 with a head masked;
    rep 71: 36 tiles). The kernel makes the same choice
    (csrc/decode_attention.cu: launch_shape); this mirror sizes the plan.
    On the H100 at batch 8 over long slots, tiles of 2 beat tiles of 1, 4
    and 8 at rep 3, 5, 7 and 71 (PERF.md): more, lighter CTAs, each kv row
    read from L2 once a tile."""
    if rep in KERNEL_REPS and d in KERNEL_HEAD_DIMS:
        return None
    if rep < 1 or not 1 <= d <= GENERAL_HEAD_DIMS[-1]:
        raise ValueError(f"the decode attention kernel takes D up to {GENERAL_HEAD_DIMS[-1]}, "
                         f"got rep {rep}, D {d}")
    return min(rep, 2), next(w for w in GENERAL_HEAD_DIMS if w >= d)


def head_tiles(rep: int, d: int) -> int:
    """Head tiles a kv head of the kernel's grid: 1, or ceil(rep / RT)."""
    tile = decode_tile(rep, d)
    return 1 if tile is None else -(-rep // tile[0])


def attention_plan(b: int, hkv: int, sms: int) -> int:
    """Cluster size C of the decode attention kernel: the valid rows of each
    of the b * hkv (slot, kv head) pairs are split into C contiguous runs,
    one a CTA. The largest C, at most MAX_CLUSTER, whose b * hkv * C CTAs
    all fit on the card's `sms` SMs at once, two an SM: a second wave would
    pay every CTA's fixed latency (start, merges, cluster barriers) again.
    On the general route hkv counts the kv heads' head tiles
    (hkv * `head_tiles`): each tile is a CTA row of its own."""
    return max(1, min(MAX_CLUSTER, 2 * sms // (b * hkv)))


def decode_attention_plain(
    q, ck, cv, li: int, k_new, v_new, start, *,
    k_scale=None, v_scale=None, window: Optional[int] = None,
    attn_len: Optional[int] = None,
) -> torch.Tensor:
    """Same math as the kernel with its T loop in one block: scores in f32,
    the prob row rounded to the cache's precision before the PV product
    (bf16(p) for bf16, bf16(p * v_scale) for int8), then the fresh token."""
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError("decode attention is the S=1 path")
    _, _, hkv, t, _ = ck.shape
    rep = hq // hkv
    t_lim = t if attn_len is None or attn_len > t else attn_len
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, rep, d).to(torch.float32)
    kc = ck[li, :, :, :t_lim].to(torch.float32)
    vc = cv[li, :, :, :t_lim]
    sc = torch.einsum("bhrd,bhtd->bhrt", qg, kc) * scale
    if k_scale is not None:
        sc = sc * k_scale[li, :, :, None, :t_lim].to(torch.float32)
    t_idx = torch.arange(t_lim, device=q.device)
    st = start.to(q.device).reshape(b, 1, 1, 1)
    valid = t_idx < st
    if window is not None:
        valid = valid & (t_idx > st - window)
    sc = torch.where(valid, sc, _NEG)
    m = sc.amax(dim=-1, keepdim=True) if t_lim else torch.full_like(sc[..., :1], _NEG)
    p = torch.where(valid, torch.exp(sc - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        pv_in = (p * v_scale[li, :, :, None, :t_lim].to(torch.float32)).to(torch.bfloat16)
    else:
        pv_in = p.to(vc.dtype)
    pv = torch.einsum("bhrt,bhtd->bhrd", pv_in.to(torch.float32), vc.to(torch.float32))
    kn = k_new.reshape(b, hkv, 1, d).to(torch.float32)
    vn = v_new.reshape(b, hkv, 1, d).to(torch.float32)
    s_new = (qg * kn).sum(dim=-1, keepdim=True) * scale
    m_f = torch.maximum(m, s_new)
    alpha = torch.exp(m - m_f)
    p_new = torch.exp(s_new - m_f)
    out = (pv * alpha + p_new * vn) / (l * alpha + p_new)
    return out.to(q.dtype).reshape(b, 1, hq, d)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("decode_attention").bd_flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_layer(q, ck, cv, k_scale, v_scale, k_new, v_new, start, window, attn_len):
    """Launch the kernel on ONE layer's cache ck/cv [B, Hkv, T, D] (a view of
    a stacked cache, or a per-layer cache) and int8 scales [B, Hkv, T] or
    None. Checks what the kernel takes and raises otherwise."""
    b, s, hq, d = q.shape
    cb, hkv, t, cd = ck.shape
    quantized = k_scale is not None
    tensors = [ck, cv, k_new, v_new, start] + ([k_scale, v_scale] if quantized else [])
    if s != 1 or cb != b or cd != d or hq % hkv or cv.shape != ck.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, cache {tuple(ck.shape)}")
    if any(x.device != q.device for x in tensors):
        raise ValueError("decode attention takes CUDA tensors on one device")
    rep = hq // hkv
    tiles = head_tiles(rep, d)  # raises above the largest width template
    if q.dtype not in KERNEL_Q_DTYPES:
        raise ValueError(f"the decode attention kernel takes q in {KERNEL_Q_DTYPES}, got {q.dtype}")
    if ck.dtype != (torch.int8 if quantized else torch.bfloat16) or cv.dtype != ck.dtype:
        raise ValueError(
            f"the kernel takes a bfloat16 cache, or int8 with scales; got {ck.dtype}, "
            f"scales given: {quantized}"
        )
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("fresh k/v must have q's dtype")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("the cache must be contiguous")
    if (d * ck.element_size()) % 16 == 0 and (ck.data_ptr() % 16 or cv.data_ptr() % 16):
        raise ValueError("the kernel copies cache rows 16 bytes at a time: align the cache")
    if quantized and not (k_scale.dtype == v_scale.dtype == torch.float32
                          and k_scale.is_contiguous() and v_scale.is_contiguous()
                          and k_scale.shape == v_scale.shape == (b, hkv, t)):
        raise ValueError("int8 scales must be contiguous f32 [(L,) B, Hkv, T]")
    q2 = q.reshape(b, hq, d).contiguous()
    kn = k_new.reshape(b, hkv, d).contiguous()
    vn = v_new.reshape(b, hkv, d).contiguous()
    st = start.to(torch.int32).contiguous()
    t_lim = t if attn_len is None or attn_len > t else attn_len
    out = torch.empty_like(q2)
    err = _launcher()(
        q2.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        kn.data_ptr(), vn.data_ptr(), st.data_ptr(), out.data_ptr(),
        int(quantized), b, hkv, rep, t, d, t_lim,
        window or 0, 1.0 / math.sqrt(d),
        attention_plan(b, hkv * tiles, _sm_count(q.device.index or 0)),
        int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "bd_flash_decode")
    return out.reshape(b, 1, hq, d)


def flash_decode_stacked(
    q, ck, cv, li: int, k_new, v_new, start, *,
    k_scale=None, v_scale=None, window: Optional[int] = None,
    attn_len: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, 1, Hq, D]. The kernel reads only the valid rows of layer
    `li`, at ck[li].data_ptr() (a view of the stacked cache)."""
    if not _device.on_card(q):
        if q.device.type != "cpu":
            raise ValueError(f"no decode attention for device {q.device}")
        flash_decode_stacked.plain_calls += 1
        return decode_attention_plain(
            q, ck, cv, li, k_new, v_new, start, k_scale=k_scale, v_scale=v_scale,
            window=window, attn_len=attn_len,
        )
    if ck.ndim != 5:
        raise ValueError(f"the stacked cache is [L, B, Hkv, T, D], got {tuple(ck.shape)}")
    take = lambda a: None if a is None else a[li]
    out = launch_layer(q, ck[li], cv[li], take(k_scale), take(v_scale), k_new, v_new, start,
                       window, attn_len)
    flash_decode_stacked.launches += 1
    return out


flash_decode_stacked.launches = 0  # kernel launches (CUDA tensors)
flash_decode_stacked.plain_calls = 0  # plain-version calls (CPU tensors)
