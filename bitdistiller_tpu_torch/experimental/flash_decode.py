"""Per-layer single-token decode attention (port of the JAX package's
`experimental/flash_decode.py`, whose Pallas `_fd_kernel` it replaces).

S=1 GQA attention of q [B, 1, Hq, D] over ONE layer's head-major cache
[B, Hkv, T, D]: rows t < start[b] are valid (and t < attn_len; with a window
only t > start - window), the fresh k/v at position `start` is folded in
last, softmax in f32, the prob row rounded to the cache's dtype before the PV
product. That is the stacked decode attention's function on a stack of one
layer, so the plain version is `decode_attention_plain` on ck[None] and the
kernel is the stacked one's (csrc/decode_attention.cu), launched with this
cache as its layer. On a CPU tensor the plain version runs; on a CUDA tensor
the kernel runs (bf16 cache only) or the call raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.decode_attention import decode_attention_plain, launch_layer


def _block_t(block_t: int, t: int) -> int:
    """The JAX entry's T blocking: halved until it divides T."""
    if not isinstance(block_t, int) or block_t < 1:
        raise ValueError(f"block_t must be a positive int, got {block_t!r}")
    while t % block_t != 0:
        block_t //= 2
    return block_t


def flash_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    ck: torch.Tensor,  # [B, Hkv, T, D]
    cv: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    start: torch.Tensor,  # [B] int
    *,
    block_t: int = 256,
    window: Optional[int] = None,
    attn_len: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, 1, Hq, D]. `block_t` is the JAX kernel's T blocking; it is
    checked as JAX checks it, and neither the plain version nor the CUDA
    kernel (whose 8 warps split the valid rows) depends on it. `attn_len`
    bounds the rows read; callers keep every start <= attn_len, as in JAX."""
    if q.shape[1] != 1 or ck.ndim != 4:
        raise ValueError(f"S=1 over one layer's [B, Hkv, T, D]: q {tuple(q.shape)}, "
                         f"cache {tuple(ck.shape)}")
    _block_t(block_t, ck.shape[2])
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck[None], cv[None], 0, k_new, v_new, start,
                                      window=window, attn_len=attn_len)
    if not q.is_cuda:
        raise ValueError(f"no decode attention for device {q.device}")
    out = launch_layer(q, ck, cv, None, None, k_new, v_new, start, window, attn_len)
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0  # kernel launches (CUDA tensors)
