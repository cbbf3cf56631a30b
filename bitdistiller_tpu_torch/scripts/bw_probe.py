"""Practical HBM read-rate probe for the attention and matmul rooflines
(port of the JAX package's `scripts/bw_probe.py`; the CUDA kernel
csrc/bw_probe.cu replaces its Pallas `stream_kernel`).

    python -m bitdistiller_tpu_torch.scripts.bw_probe      # on the card

Measures on one GPU the sustained GB/s of, each row with its counterpart:

  torch-sum-bf16  (xla-sum-bf16)   torch.sum over the bf16 K and V plane sets
  torch-sum-int8  (xla-sum-int8)   the same planes as int8
  cuda-stream     (pallas-stream)  the streaming-read kernel, bf16 planes
  cuda-int8       (pallas-int8)    the streaming-read kernel, int8 planes
  plain-attn      (xla-attn)       the plain cached_attention over L layers
  flash-attn      (flash2-attn)    flash_decode_stacked over L layers

K and V are two separate contiguous arrays [L, B, Hkv, T, D] (B=8, Hkv=32,
T=2048, D=128, L=16 by default or $BWPROBE_L): 4.29 GB of bf16 a call, so a
launch's fixed cost is lost in the read. Every timed call chains an f32
accumulator c' = c * 1e-6 + (sum K + sum V) * 1e-9 through the loop, as the
JAX probe does.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys

import torch

from ..ops import _build

B, HKV, T, D = 8, 32, 2048, 128


def stream_sum_plain(k: torch.Tensor, v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """c' = c * 1e-6 + (sum K + sum V) * 1e-9, sums in f32 (shape of c)."""
    total = torch.sum(k, dtype=torch.float32) + torch.sum(v, dtype=torch.float32)
    return c.to(torch.float32) * 1e-6 + total * 1e-9


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bw_probe")
    lib.bd_stream_blocks.argtypes = []
    lib.bd_stream_blocks.restype = ctypes.c_int
    fn = lib.bd_stream_sum
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


_PARTIALS: dict = {}


def stream_sum(k: torch.Tensor, v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The chained streaming read: a new [1] f32 tensor c'. On CUDA tensors
    the kernel reads every byte of k and v once; on CPU tensors the plain
    version runs."""
    if k.device.type == "cpu":
        return stream_sum_plain(k, v, c)
    if not (k.is_cuda and v.device == k.device and c.device == k.device):
        raise ValueError("the stream kernel takes CUDA tensors on one device")
    if k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"the stream kernel takes two bf16 or int8 arrays of one shape, "
                         f"got {k.dtype} {tuple(k.shape)} and {v.dtype} {tuple(v.shape)}")
    nbytes = k.numel() * k.element_size()
    if not (k.is_contiguous() and v.is_contiguous()) or nbytes % 16 or (
            k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("the stream kernel takes contiguous, 16-byte aligned whole chunks")
    if c.dtype != torch.float32 or c.numel() != 1:
        raise ValueError("the chained accumulator is one f32")
    lib = _lib()
    if k.device not in _PARTIALS:
        _PARTIALS[k.device] = torch.empty(lib.bd_stream_blocks(), dtype=torch.float32,
                                          device=k.device)
    out = torch.empty(1, dtype=torch.float32, device=k.device)
    err = lib.bd_stream_sum(k.data_ptr(), v.data_ptr(), nbytes, int(k.dtype == torch.int8),
                            _PARTIALS[k.device].data_ptr(), c.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(err, "bd_stream_sum")
    stream_sum.launches += 1
    return out


stream_sum.launches = 0  # kernel launches (CUDA tensors)


def timed_chain(fn, args, iters: int = 6) -> tuple[float, float]:
    """fn(*args, c) -> c'; seconds a call over `iters` chained calls (CUDA
    events, after three warm-up calls), and the final c."""
    c = torch.zeros(1, dtype=torch.float32, device=args[0].device)
    for _ in range(3):
        c = fn(*args, c)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        c = fn(*args, c)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 1e3 / iters, float(c.item())


def make_planes(layers: int, seed: int = 0, device="cuda"):
    """K and V [L, B, Hkv, T, D] bf16 from a seed, made on the device layer
    by layer (no multi-GB f32 temporary), and their int8 copies."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (layers, B, HKV, T, D)
    k = torch.empty(shape, dtype=torch.bfloat16, device=device)
    v = torch.empty_like(k)
    for arr in (k, v):
        for li in range(layers):
            arr[li] = torch.randn(shape[1:], generator=gen, device=device)
    to8 = lambda x: torch.stack([(x[li].float() * 10).to(torch.int8) for li in range(layers)])
    return k, v, to8(k), to8(v)


def main() -> int:
    if not torch.cuda.is_available():
        print("bw_probe: no CUDA device; nothing was measured", file=sys.stderr)
        return 1
    from ..models.layers import cached_attention
    from ..ops.decode_attention import flash_decode_stacked

    layers = int(os.environ.get("BWPROBE_L", 16))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card or torch.cuda.get_device_name(0)}")
    k, v, k8, v8 = make_planes(layers)
    nbytes = 2 * k.numel() * k.element_size()
    print(f"plane set: {layers} layers x {nbytes / layers / 1e9:.2f} GB "
          f"= {nbytes / 1e9:.2f} GB a call", file=sys.stderr)

    def row(name, fn, args, nb):
        dt, cv = timed_chain(fn, args)
        print(f"{name:15s} {nb / dt / 1e9:7.1f} GB/s  ({dt * 1e3:.3f} ms)  [{cv:.4f}]")

    row("torch-sum-bf16:", stream_sum_plain, (k, v), nbytes)
    row("torch-sum-int8:", stream_sum_plain, (k8, v8), nbytes // 2)
    row("cuda-stream:", stream_sum, (k, v), nbytes)
    row("cuda-int8:", stream_sum, (k8, v8), nbytes // 2)
    del k8, v8

    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((B, 1, HKV, D), generator=gen, device="cuda").bfloat16()
    kn = torch.randn((B, 1, HKV, D), generator=gen, device="cuda").bfloat16()
    vn = kn + 1
    start = torch.full((B,), T - 8, dtype=torch.int32, device="cuda")
    mask = torch.cat([torch.arange(T, device="cuda")[None] < start[:, None],
                      torch.ones((B, 1), dtype=torch.bool, device="cuda")], -1)[:, None, None, :]

    def plain_attn(kk, vv, c):
        qd = (q.float() * (1 + c * 1e-12)).bfloat16()
        acc = c * 1e-6
        for li in range(layers):
            o = cached_attention(qd, kk[li], vv[li], kn, vn, mask)
            acc = acc + torch.sum(o, dtype=torch.float32) * 1e-9
        return acc

    def flash_attn(kk, vv, c):
        qd = (q.float() * (1 + c * 1e-12)).bfloat16()
        acc = c * 1e-6
        for li in range(layers):
            o = flash_decode_stacked(qd, kk, vv, li, kn, vn, start)
            acc = acc + torch.sum(o, dtype=torch.float32) * 1e-9
        return acc

    with torch.inference_mode():
        row("plain-attn:", plain_attn, (k, v), nbytes)
        row("flash-attn:", flash_attn, (k, v), nbytes)
    print(f"bound of one bf16 call at 3.35 TB/s: {nbytes / 3.35e12 * 1e3:.3f} ms "
          f"(B={B}, Hkv={HKV}, T={T}, D={D}, L={layers})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
