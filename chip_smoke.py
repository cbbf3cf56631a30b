#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a), holds each kernel
against its plain PyTorch version at the shapes of the packed int2-g128
Llama-2-7B serving path, times kernel / plain version / one library call,
then serves requests with the port's Engine on a random packed 7B model
(all 32 layers), first A16 (bf16 activations), then W2A8
(BITDISTILLER_QMM_A8=1, set for that phase only), checks that each decode
and prefill path went through its kernels, and times one engine-shaped
prefill (8 prompts of 512 tokens) through each path. The entry points
outside the engine (the HBM probe, the fused MLP, the per-layer decode
attention) each run a path of their own with their launch counts reset
before and read after.
Phases print one line each; any failure exits non-zero before the last
line. The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Tolerances (kernel vs plain version on the same inputs):
  * integer-valued activations and weights: exact (every product and partial
    sum is an integer below 2^24 in f32, so summation order cannot matter),
    at M = 8, 33, 200, 256 and 4096 (the decode kernels up to 32 rows, the
    wgmma prefill kernels above, ragged and whole tiles);
  * bf16 activations, packed matmul: max|kernel - plain| <= 1e-2 * max|plain|
    (both round an f32 sum to bf16: one bf16 ulp is 2^-8 relative, and the
    f32 sums differ in order);
  * A8 matmul: integer-valued x with one 127 a row (per-token scale 1):
    exact, at M = 1, 8, 16, 17 and 32 too (the streaming decode kernel's
    one, two and four 8-token tiles); bf16 x: max|kernel - plain| <= 1e-2 *
    max|plain| (as above);
  * fused MLP, M = 1, 8, 33, 128: max|kernel - plain| <= 1e-2 * max|plain|
    (bf16 output, f32 sums in another order and tile grouping, mid rounded
    to bf16 after an activation whose last f32 bit may differ);
  * the streaming decode kernels (A8 at M <= 32, the fused MLP): a second
    call on the same inputs gives the same bytes (sums in a fixed order, no
    atomics);
  * decode attention, stacked and per layer: max abs error <= 2e-2 on O(1)
    outputs (the prob row is rounded to bf16 against per-warp running maxima
    in the kernel and against one global maximum in the plain version; one
    bf16 ulp of a prob);
  * HBM probe: |kernel - plain| <= 1e-6 * (the same sum over |x|): f32 sums
    of 2^30 elements in another order differ by about 1e-10 of it, while a
    kernel that skipped 1% of the normal planes would be off by about 2e-6;
  * one whole decode step of the 7B model, kernels vs plain versions:
    max|logit error| <= 5e-2 * max|logit| (bf16 rounding differences of every
    matmul output compound over 32 layers), A16 and A8 alike.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bitdistiller_tpu_torch.experimental import flash_decode as fd1
from bitdistiller_tpu_torch.experimental import fused_mlp as fm
from bitdistiller_tpu_torch.models import LLAMA2_7B, forward, random_packed_params
from bitdistiller_tpu_torch.ops import _build
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.ops import quant_matmul as qm
from bitdistiller_tpu_torch.quant.packing import (
    PackedLinear,
    dequantize_linear,
    make_scale_combo,
    scales_from_combo,
)
from bitdistiller_tpu_torch.scripts import bw_probe
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
DEV = "cuda"

CFG = LLAMA2_7B
BITS, GROUP = 2, 128
SHAPES = {  # name: (K, N) of the fused 7B projections
    "qkv": (4096, 3 * 4096),
    "o": (4096, 4096),
    "gate_up": (4096, 2 * 11008),
    "down": (11008, 4096),
}
MLP = (4096, 11008, 4096)  # K, FFN, D of the 7B MLP
MATMUL_TOL = 1e-2
MLP_TOL = 1e-2
ATTN_TOL = 2e-2
PROBE_TOL = 1e-6
LOGIT_TOL = 5e-2
CHECK_M = (8, 33, 200, 256, 4096)  # decode cap 32; 200 ragged against both prefill tiles
A8_CHECK_M = (1, 8, 16, 17, 32) + CHECK_M[1:]  # the A8 decode kernel: 1, 2 and 4 token tiles
MLP_CHECK_M = (1, 8, 33, 128)
PREFILL_M = 4096  # the engine's first prefill: 8 prompts in the 512 bucket
REQ_LENS = [64, 512, 200, 333, 128, 480, 96, 256, 400, 150, 64, 300]


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, typ, exc, tb):
        if typ is None:
            torch.cuda.synchronize()
            say(f"[{self.name}] ok in {time.time() - self.t0:.1f} s")
        else:
            say(f"[{self.name}] FAILED: {typ.__name__}: {exc}")
        return False  # never swallow


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over `reps` of the mean per-call time of `iters` calls, by CUDA
    events, after a warm-up call. `fn(i)` gets the call index."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(iters):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, peak_ops: float = PEAK_BF16_FLOPS,
             bw: float = PEAK_BYTES_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / bw * 1e3, flops / peak_ops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rand_stacked(gen, layers, k, n, bits, integer):
    """A stacked PackedLinear with random codes. Integer case: scales 1 and
    integer szeros; else bf16-exact scales, so the plain version (f32 scales)
    and the kernel (combo words) read the same weights."""
    pack = 32 // bits
    qw = torch.randint(-(2**31), 2**31 - 1, (layers, k // pack, n), dtype=torch.int32,
                       device=DEV, generator=gen)
    ng = k // GROUP
    if integer:
        scales = torch.ones((layers, ng, n), device=DEV)
        szeros = torch.full((layers, ng, n), float(2 ** (bits - 1)), device=DEV)
    else:
        scales = (torch.rand((layers, ng, n), device=DEV, generator=gen) * 0.02 + 0.005)
        scales = scales.bfloat16().float()
        zeros = torch.randint(0, 2**bits, (layers, ng, n), device=DEV, generator=gen).float()
        szeros = (scales * zeros).bfloat16().float()
    return PackedLinear(qweight=qw, scales=scales, szeros=szeros, bias=None, bits=bits,
                        group_size=GROUP, in_features=k, out_features=n,
                        combo=make_scale_combo(scales, szeros))


def by_rows(fn, x, rows: int = 512):
    """fn over x in row chunks: both plain matmuls treat rows independently,
    and at M=4096 a whole call would hold [M, K/G, N] f32 partials (11.5 GB
    for gate_up)."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def plain_matmul(x, p: PackedLinear, li: int):
    lay = p.layer(li)
    return qm.quant_matmul_plain(x, lay.qweight, lay.scales, lay.szeros, lay.bits, lay.group_size)


def check_matmuls(gen, record):
    worst = 0.0
    for bits in (2, 4):
        for name, (k, n) in SHAPES.items():
            for integer in (True, False):
                p = rand_stacked(gen, 2, k, n, bits, integer)
                for m in CHECK_M:
                    if integer:
                        x = torch.randint(-3, 4, (m, k), device=DEV, generator=gen).bfloat16()
                    else:
                        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
                    got = qm.quant_matmul(x, p, 1)  # layer 1 of a stack, in place
                    want = by_rows(lambda xr: plain_matmul(xr, p, 1), x)
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    ok = err == 0.0 if integer else err <= MATMUL_TOL * scale
                    record.append(dict(bits=bits, shape=name, m=m, integer=integer,
                                       max_abs_err=err, ref_max=scale, ok=ok))
                    if not ok:
                        raise AssertionError(
                            f"packed matmul {name} bits={bits} M={m} integer={integer}: "
                            f"max|err|={err} vs max|ref|={scale}")
                    if not integer and bits == BITS:
                        worst = max(worst, err / scale)
    return worst


def attn_inputs(gen, b, hq, hkv, t, d, kv, starts, layers=2):
    q = torch.randn((b, 1, hq, d), device=DEV, generator=gen).bfloat16()
    kn = torch.randn((b, 1, hkv, d), device=DEV, generator=gen).bfloat16()
    vn = torch.randn((b, 1, hkv, d), device=DEV, generator=gen).bfloat16()
    shape = (layers, b, hkv, t, d)
    if kv == "int8":
        ck = torch.randint(-127, 128, shape, dtype=torch.int8, device=DEV, generator=gen)
        cv = torch.randint(-127, 128, shape, dtype=torch.int8, device=DEV, generator=gen)
        ks = torch.rand(shape[:-1], device=DEV, generator=gen) * 0.02
        vs = torch.rand(shape[:-1], device=DEV, generator=gen) * 0.02
    else:
        ck = torch.randn(shape, device=DEV, generator=gen).bfloat16()
        cv = torch.randn(shape, device=DEV, generator=gen).bfloat16()
        ks = vs = None
    start = torch.tensor(starts, dtype=torch.int32, device=DEV)
    return q, ck, cv, kn, vn, start, ks, vs


def mixed_starts(b, t):
    return [0, t, t // 2, 17, t - 1, 1, t // 3, 1000 % t][:b]


def check_attention(gen, record):
    """B3 (stacked, layer 1 of 2) on bf16 and int8 caches, and B6 (the
    per-layer entry, bf16 only: the card takes a bf16 cache there) on the
    same bf16 inputs; returns the worst bf16 MHA error of each."""
    cases = [
        dict(b=8, hq=32, hkv=32, t=2048, d=128, window=None, attn_len=None),
        dict(b=8, hq=32, hkv=8, t=2048, d=128, window=None, attn_len=None),  # GQA
        dict(b=8, hq=32, hkv=4, t=2048, d=128, window=None, attn_len=None),  # GQA rep 8
        dict(b=8, hq=32, hkv=32, t=2048, d=128, window=256, attn_len=None),
        dict(b=4, hq=8, hkv=4, t=512, d=64, window=None, attn_len=384),
    ]
    worst = {"stacked": 0.0, "per_layer": 0.0}
    for kv in ("bf16", "int8"):
        for c in cases:
            starts = mixed_starts(c["b"], (c["attn_len"] or c["t"]) - 1)
            q, ck, cv, kn, vn, st, ks, vs = attn_inputs(gen, c["b"], c["hq"], c["hkv"], c["t"],
                                                        c["d"], kv, starts)
            kw = dict(window=c["window"], attn_len=c["attn_len"])
            want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, st, k_scale=ks, v_scale=vs,
                                             **kw)
            runs = {"stacked": lambda: da.flash_decode_stacked(
                q, ck, cv, 1, kn, vn, st, k_scale=ks, v_scale=vs, **kw)}
            if kv == "bf16":  # the per-layer entry on layer 1 as its own cache
                runs["per_layer"] = lambda: fd1.flash_decode_attention(
                    q, ck[1], cv[1], kn, vn, st, **kw)
            for entry, run in runs.items():
                err = (run().float() - want.float()).abs().max().item()
                record.append(dict(kv=kv, entry=entry, **c, max_abs_err=err,
                                   ok=err <= ATTN_TOL))
                if not err <= ATTN_TOL:  # NaN fails too
                    raise AssertionError(f"decode attention {entry} {kv} {c}: max|err|={err}")
                if kv == "bf16" and c["hq"] == c["hkv"] and c["window"] is None:
                    worst[entry] = max(worst[entry], err)
    return worst


def check_a8(gen, record):
    """B4 on layer 1 of a stack: int2 and int4, the four 7B shapes, M in
    A8_CHECK_M, pair-layout words (x permuted per call) and repacked ones;
    at M = 8 on bf16 x a second call must give the same bytes."""
    worst = 0.0
    for bits in (2, 4):
        for name, (k, n) in SHAPES.items():
            for integer in (True, False):
                pair = rand_stacked(gen, 2, k, n, bits, integer)
                for w in (pair, qm.repack_linear_a8(pair)):
                    lay = w.layer(1)
                    for m in A8_CHECK_M:
                        if integer:  # one 127 a row: the per-token scale is 1
                            x = torch.randint(-3, 4, (m, k), device=DEV, generator=gen).float()
                            x[:, 0] = 127.0
                            x = x.bfloat16()
                        else:
                            x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
                        got = qm.quant_matmul_a8(x, w, 1)
                        if m == 8 and not integer and not torch.equal(got, qm.quant_matmul_a8(x, w, 1)):
                            raise AssertionError(f"A8 matmul {name} bits={bits}: two calls differ")
                        want = by_rows(lambda xr: qm.quant_matmul_a8_plain(
                            xr, lay.qweight, lay.scales, lay.szeros, bits, GROUP, w.a8_order), x)
                        err = (got.float() - want.float()).abs().max().item()
                        scale = want.float().abs().max().item()
                        ok = err == 0.0 if integer else err <= MATMUL_TOL * scale
                        record.append(dict(bits=bits, shape=name, m=m, integer=integer,
                                           a8_order=w.a8_order, max_abs_err=err, ref_max=scale,
                                           ok=ok))
                        if not ok:
                            raise AssertionError(
                                f"A8 matmul {name} bits={bits} M={m} integer={integer} "
                                f"a8_order={w.a8_order}: max|err|={err} vs max|ref|={scale}")
                        if not integer and bits == BITS:
                            worst = max(worst, err / scale)
                del pair
    return worst


def time_matmuls(gen, m, bw, detail):
    """One layer's four packed matmuls at M rows, int2-g128. The kernel is
    timed through its raw ctypes launcher (a few us of host time a call, so
    the card, not Python, sets the pace); `wrapper_ms` is the same work
    through `quant_matmul`. Weights cycle through enough stacked layers
    (> 100 MB) that every call reads them from HBM, as the layer loop does;
    the plain version and the library call (torch.matmul on a dequantized
    bf16 weight) run on layer 0. Above 32 rows the raw call is the prefill
    kernels' (the x group sums, then the wgmma kernel) at the tile the
    wrapper chooses."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    prefill = m > qm.DECODE_MAX_M
    fn = qm._launcher("bd_qmm_prefill" if prefill else "bd_qmm_decode")
    stream = torch.cuda.current_stream().cuda_stream
    plain_iters, plain_reps = (1, 2) if m >= PREFILL_M else (3, 3)
    for name, (k, n) in SHAPES.items():
        layer_bytes = k * n * BITS / 8 + (k // GROUP) * n * 4
        layers = max(2, math.ceil(120e6 / layer_bytes))
        p = rand_stacked(gen, layers, k, n, BITS, integer=False)
        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
        out = torch.empty((m, n), dtype=torch.bfloat16, device=DEV)
        if prefill:
            xsum = qm.group_sums_scratch(m, k, torch.float32, DEV)
            extra, tile = (xsum.data_ptr(),), (qm._tile_m(x, n),)
        else:
            extra, tile = (), ()
        args = [(x.data_ptr(), p.qweight[i].data_ptr(), p.combo[i].data_ptr(), *extra,
                 out.data_ptr(), m, k, n, BITS, GROUP, *tile, stream) for i in range(layers)]
        _build.check(fn(*args[0]), "raw launch")
        ms = cuda_ms(lambda i: fn(*args[i % layers]), 50)
        wrapper = cuda_ms(lambda i: qm.quant_matmul(x, p, i % layers), 50)
        plain = cuda_ms(lambda i: plain_matmul(x, p, 0), plain_iters, reps=plain_reps)
        w = dequantize_linear(p.layer(0), torch.bfloat16)
        lib = cuda_ms(lambda i: torch.matmul(x, w), 20)
        nbytes = layer_bytes + m * k * 2 + m * n * 2
        flops = 2.0 * m * k * n
        b, by = bound_ms(nbytes, flops)
        detail.append(dict(kernel="qmm_prefill" if prefill else "qmm_decode", shape=name, m=m,
                           k=k, n=n, tile_m=tile[0] if tile else None, ms=ms,
                           wrapper_ms=wrapper, plain_ms=plain, library_ms=lib, bound_ms=b,
                           bound_by=by, bound_measured_bw_ms=nbytes / bw * 1e3))
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += nbytes
        tot["flops"] += flops
        del p, w
    return tot


def time_attention(gen, bw, detail, per_layer: bool):
    """B3 on layer i % 2 of a stacked cache, or (per_layer) B6, the per-layer
    entry, on two separate [B, Hkv, T, D] caches: the same work and the same
    kernel. `ms` is the raw launcher (as for the matmuls), `wrapper_ms` the
    entry point; the library yardstick is SDPA over the same layer's cache
    with a row mask (it reads all T rows and does not fold the fresh token)."""
    b, hq, hkv, t, d = 8, 32, 32, 2048, 128
    starts = [2047, 1900, 1536, 1024, 700, 512, 300, 64]
    q, ck, cv, kn, vn, st, _, _ = attn_inputs(gen, b, hq, hkv, t, d, "bf16", starts, layers=2)
    if per_layer:
        caches = [(ck[i].clone(), cv[i].clone()) for i in range(2)]
        del ck, cv
        entry = lambda i: fd1.flash_decode_attention(q, *caches[i % 2], kn, vn, st)
    else:
        caches = [(ck[i], cv[i]) for i in range(2)]
        entry = lambda i: da.flash_decode_stacked(q, ck, cv, i % 2, kn, vn, st)
    fn = da._launcher()
    out = torch.empty((b, hq, d), dtype=torch.bfloat16, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    args = [(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, kn.data_ptr(), vn.data_ptr(),
             st.data_ptr(), out.data_ptr(), 0, b, hkv, hq // hkv, t, d, t, 0,
             1.0 / math.sqrt(d), stream) for k, v in caches]
    _build.check(fn(*args[0]), "raw launch")
    ms = cuda_ms(lambda i: fn(*args[i % 2]), 50)
    wrapper = cuda_ms(entry, 50)
    plain = cuda_ms(lambda i: da.decode_attention_plain(
        q, caches[0][0][None], caches[0][1][None], 0, kn, vn, st), 3, reps=3)
    mask = (torch.arange(t, device=DEV)[None, :] < st[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    lib = cuda_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qs, *caches[i % 2], attn_mask=mask), 20)
    rows = sum(starts)
    nbytes = 2 * rows * hkv * d * 2 + 2 * b * hq * d * 2 + 2 * b * hkv * d * 2
    bnd, by = bound_ms(nbytes, 4.0 * rows * hq * d)
    rec = dict(entry="flash_decode_attention" if per_layer else "flash_decode_stacked", b=b,
               hq=hq, hkv=hkv, t=t, d=d, starts=starts, ms=ms, wrapper_ms=wrapper,
               plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
               bound_measured_bw_ms=nbytes / bw * 1e3)
    detail.append(rec)
    return rec


def time_a8(gen, m, detail):
    """B4: one layer's four A8 matmuls at M rows, int2-g128 repacked, as
    `time_matmuls` times B1/B2 (raw launcher over >100 MB of stacked layers;
    the wrapper; the plain version and torch.matmul on a dequantized bf16
    weight on layer 0). Bytes count the f32 scales and szeros (8 bytes a
    group column); operations are int8 at 1,979 TOP/s. Up to 32 rows the
    call is the quantize kernel and the streaming decode kernel on
    `decode_plan`'s clusters (two launches chained by PDL); above, the
    prefill kernels (quantize, xi group sums, s8 wgmma)."""
    tot = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    fn = qm._a8_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    prefill = m > qm.DECODE_MAX_M
    plain_iters, plain_reps = (1, 2) if m >= PREFILL_M else (3, 3)
    for name, (k, n) in SHAPES.items():
        layer_bytes = k * n * BITS / 8 + (k // GROUP) * n * 8
        layers = max(2, math.ceil(120e6 / layer_bytes))
        pair = rand_stacked(gen, layers, k, n, BITS, integer=False)
        p = qm.repack_linear_a8(pair)
        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
        xi = torch.empty((m, k), dtype=torch.int8, device=DEV)
        sx = torch.empty((m,), dtype=torch.float32, device=DEV)
        xsum = qm.group_sums_scratch(m, k, torch.int32, DEV) if prefill else None
        tile = qm._tile_m(x, n) if prefill else 0
        cluster = 0 if prefill else qm.decode_plan(n, k // GROUP, qm._sm_count(0))
        out = torch.empty((m, n), dtype=torch.bfloat16, device=DEV)
        args = [(x.data_ptr(), p.qweight[i].data_ptr(), p.scales[i].data_ptr(),
                 p.szeros[i].data_ptr(), None, None, xi.data_ptr(), sx.data_ptr(),
                 None if xsum is None else xsum.data_ptr(), out.data_ptr(), m, k, n, BITS, GROUP,
                 tile, cluster, stream) for i in range(layers)]
        _build.check(fn(*args[0]), "raw launch")
        ms = cuda_ms(lambda i: fn(*args[i % layers]), 50)
        wrapper = cuda_ms(lambda i: qm.quant_matmul_a8(x, p, i % layers), 50)
        lay = p.layer(0)
        plain = cuda_ms(lambda i: qm.quant_matmul_a8_plain(
            x, lay.qweight, lay.scales, lay.szeros, BITS, GROUP, True), plain_iters, reps=plain_reps)
        w = dequantize_linear(pair.layer(0), torch.bfloat16)
        lib = cuda_ms(lambda i: torch.matmul(x, w), 20)
        nbytes = layer_bytes + m * k * 2 + m * n * 2
        flops = 2.0 * m * k * n
        b, by = bound_ms(nbytes, flops, PEAK_INT8_OPS)
        detail.append(dict(kernel="qmm_a8", shape=name, m=m, k=k, n=n, tile_m=tile or None,
                           cluster=cluster or None, ms=ms, wrapper_ms=wrapper,
                           plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by))
        for key, val in (("ms", ms), ("wrapper_ms", wrapper), ("plain_ms", plain),
                         ("library_ms", lib), ("bytes", nbytes), ("flops", flops)):
            tot[key] += val
        del pair, p, w
    return tot


def mlp_stack(gen, layers):
    """Random int2-g128 gate, up and down of the 7B MLP, stacked [L, ...]."""
    k, f, d = MLP
    return (rand_stacked(gen, layers, k, f, BITS, False), rand_stacked(gen, layers, k, f, BITS, False),
            rand_stacked(gen, layers, f, d, BITS, False))


def fused_mlp_phase(gen, detail):
    """B5 at the 7B MLP widths (K=4096, FFN=11008, D=4096), int2, silu:
    layer 1 of a 32-layer stack against the plain version at M in
    MLP_CHECK_M, and a second call on the same inputs must give the same
    bytes;
    the kernel's time (raw launcher cycling the 32 layers, 1.4 GB), the
    plain version's and the library's three calls (torch.matmul on the
    dequantized bf16 gate|up, silu*mul, torch.matmul on the bf16 down); then
    its path: the MLP of one 7B decode step (M=8) through all 32 layers with
    the launch count reset before and read after."""
    k, f, d = MLP
    L = CFG.num_layers
    gate, up, down = mlp_stack(gen, L)
    lay = lambda li: (gate.layer(li), up.layer(li), down.layer(li))
    worst = 0.0
    for m in MLP_CHECK_M:
        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
        got = fm.fused_mlp(x, *lay(1))
        if not torch.equal(got, fm.fused_mlp(x, *lay(1))):
            raise AssertionError(f"fused MLP M={m}: two calls on the same inputs differ")
        want = fm.fused_mlp_plain(x, *lay(1))
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        detail.append(dict(check="fused_mlp", m=m, max_abs_err=err, ref_max=scale))
        if not err <= MLP_TOL * scale:  # NaN fails too
            raise AssertionError(f"fused MLP M={m}: max|err|={err} vs max|ref|={scale}")
        worst = max(worst, err / scale)
    m = 8
    x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
    fn = fm._launcher()
    mid, msum = fm.scratch(m, f, DEV)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    plan = fm.mlp_plan(k, f, d, qm._sm_count(0))
    args = [(x.data_ptr(), *[a[li].data_ptr() for p in (gate, up, down)
                             for a in (p.qweight, p.scales, p.szeros)],
             mid.data_ptr(), msum.data_ptr(), out.data_ptr(), m, k, f, d, BITS, GROUP, 0, *plan,
             stream) for li in range(L)]
    _build.check(fn(*args[0]), "raw launch")
    ms = cuda_ms(lambda i: fn(*args[i % L]), 64)
    wrapper = cuda_ms(lambda i: fm.fused_mlp(x, *lay(i % L)), 64)
    plain = cuda_ms(lambda i: fm.fused_mlp_plain(x, *lay(0)), 2, reps=3)
    wgu = torch.cat([dequantize_linear(gate.layer(0), torch.bfloat16),
                     dequantize_linear(up.layer(0), torch.bfloat16)], dim=1)
    wd = dequantize_linear(down.layer(0), torch.bfloat16)

    def library(i):
        gu = torch.matmul(x, wgu)
        return torch.matmul(torch.nn.functional.silu(gu[:, :f]) * gu[:, f:], wd)

    lib = cuda_ms(library, 20)
    nbytes = (2 * k * f + f * d) * BITS / 8 + (2 * (k // GROUP) * f + (f // GROUP) * d) * 8 \
        + m * k * 2 + m * d * 2
    flops = 2.0 * m * (2 * k * f + f * d)
    bnd, by = bound_ms(nbytes, flops)
    fm.fused_mlp.launches = 0
    h = x
    for li in range(L):  # an RMS norm before each MLP, as in the model (random
        # weights without one grow the activations past bf16's range)
        hf = h.float()
        h = fm.fused_mlp((hf * torch.rsqrt(hf.pow(2).mean(-1, keepdim=True) + 1e-6)).bfloat16(),
                         *lay(li))
    torch.cuda.synchronize()
    launches = fm.fused_mlp.launches
    if launches < L:
        raise AssertionError(f"fused MLP path: {launches} launches for {L} layers")
    if not torch.isfinite(h).all():
        raise AssertionError("fused MLP path: non-finite output")
    rec = dict(m=m, plan=plan, ms=ms, wrapper_ms=wrapper, plain_ms=plain, library_ms=lib, bound_ms=bnd,
               bound_by=by, bytes=nbytes, flops=flops, launches=launches, max_abs_err=worst)
    detail.append(rec)
    del gate, up, down, wgu, wd
    return rec


def probe_phase(record):
    """B7 at its script's sizes (L=16: K and V planes of 2.15 GB each, 4.29
    GB of bf16 a call): the kernel against its plain version on bf16 and
    int8 planes, then its path, the chained timing run (launch count reset
    before, read after), the plain version's and the library's time (two
    torch.sum calls). Returns the measured bf16 read rate."""
    layers = 16
    k, v, k8, v8 = bw_probe.make_planes(layers)
    nbytes = 2 * k.numel() * k.element_size()
    for kind, a, b in (("bf16", k, v), ("int8", k8, v8)):
        c0 = torch.full((1,), 0.5, device=DEV)
        got = bw_probe.stream_sum(a, b, c0).item()
        want = bw_probe.stream_sum_plain(a, b, c0).item()
        mag = (torch.sum(a.abs(), dtype=torch.float32) + torch.sum(b.abs(), dtype=torch.float32)
               ).item() * 1e-9 + 0.5e-6
        err = abs(got - want)
        record[f"check_{kind}"] = dict(got=got, want=want, abs_sum=mag, err=err)
        if not err <= PROBE_TOL * mag:  # NaN fails too
            raise AssertionError(f"stream sum {kind}: {got} vs plain {want} (|x| sum {mag})")
    bw_probe.stream_sum.launches = 0
    dt, _ = bw_probe.timed_chain(bw_probe.stream_sum, (k, v))
    launches = bw_probe.stream_sum.launches
    if launches < 1:
        raise AssertionError("the probe path launched no stream kernel")
    dt8, _ = bw_probe.timed_chain(bw_probe.stream_sum, (k8, v8))
    plain, _ = bw_probe.timed_chain(bw_probe.stream_sum_plain, (k, v))
    lib = cuda_ms(lambda i: (torch.sum(k, dtype=torch.float32),
                             torch.sum(v, dtype=torch.float32)), 5, reps=3)
    bnd, by = bound_ms(nbytes, float(nbytes // 2))
    record.update(ms=dt * 1e3, int8_ms=dt8 * 1e3, plain_ms=plain * 1e3, library_ms=lib,
                  bound_ms=bnd, bound_by=by, bytes=nbytes, launches=launches,
                  bw=nbytes / dt, bw_int8=nbytes / 2 / dt8,
                  max_abs_err=max(r["err"] / r["abs_sum"] for key, r in record.items()
                                  if key.startswith("check_")))
    del k, v, k8, v8
    return record


def packed_weights(cfg) -> int:
    """Weights of the packed projections (qkv, o, gate, up, down), all layers."""
    d, dh = cfg.hidden_size, cfg.actual_head_dim
    per_layer = (d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh
                 + cfg.num_heads * dh * d + 3 * d * cfg.intermediate_size)
    return per_layer * cfg.num_layers


def step_bytes(cfg, bits, rows_per_slot, group_bytes: int = 4) -> float:
    """HBM bytes one decode step must read: packed weights, the group
    statistics (a 4-byte combo word a group column for A16, f32 scale and
    szero, 8 bytes, for A8), lm_head, and the valid KV rows (bench.py's
    model_bytes_per_step with the KV term counted per slot)."""
    n_w = packed_weights(cfg)
    kv = cfg.num_layers * sum(rows_per_slot) * cfg.num_kv_heads * cfg.actual_head_dim * 2 * 2
    return n_w * bits / 8 + n_w / 128 * group_bytes + cfg.hidden_size * cfg.vocab_size * 2 + kv


def device_busy_ms(step, n: int):
    """Device time a step keeps the card busy, from a torch.profiler trace of
    n steps (sum of kernels' self device time), with the top kernels; None
    if the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:  # kernels, not ops
            per[e.key[:48]] = per.get(e.key[:48], 0.0) + t / 1e3 / n
    if not per:
        return None
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    return dict(busy_ms=sum(per.values()), top=top)


COUNTERS = {  # name: (wrapper, its counter)
    "qmm_decode": (qm.qmm_decode, "launches"), "qmm_prefill": (qm.qmm_prefill, "launches"),
    "qmm_a8": (qm.qmm_a8, "launches"), "qmm_a8_prefill": (qm.qmm_a8, "prefill_launches"),
    "flash_decode": (da.flash_decode_stacked, "launches"),
    "flash_decode_attention": (fd1.flash_decode_attention, "launches"),
    "fused_mlp": (fm.fused_mlp, "launches"), "stream_sum": (bw_probe.stream_sum, "launches")}


def reset_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def time_prefill(params, cfg, tag, a8, out):
    """One engine-shaped prefill: 8 prompts in the 512 bucket through
    forward(..., return_kv=True), all 32 layers, host clock around a
    synchronize after a warm-up call; the launch counts are reset just
    before the timed call and read just after, and every packed matmul of it
    must go through a prefill kernel."""
    b, s = 8, 512
    tokens = torch.randint(3, cfg.vocab_size, (b, s), device=DEV)
    L = cfg.num_layers
    with torch.inference_mode():
        forward(params, cfg, tokens, return_kv=True)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        logits, kv = forward(params, cfg, tokens, return_kv=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
    key, other = ("qmm_a8_prefill", "qmm_prefill") if a8 else ("qmm_prefill", "qmm_a8")
    if counts[key] < 4 * L or counts["qmm_decode"] or counts[other]:
        raise AssertionError(f"prefill {tag} did not run every matmul through {key}: {counts}")
    if not torch.isfinite(logits).all() or kv.k.shape[:3] != (L, b, s):
        raise AssertionError(f"prefill {tag}: non-finite logits or a KV of the wrong shape")
    flops = 2.0 * b * s * packed_weights(cfg)
    bound = flops / (PEAK_INT8_OPS if a8 else PEAK_BF16_FLOPS) * 1e3
    out["prefill"] = dict(batch=b, seq=s, wall_ms=wall * 1e3, tok_per_s=b * s / wall,
                          launches={k: v for k, v in counts.items() if v},
                          matmul_bound_ms=bound)
    say(f"prefill {tag}: {b} x {s} tokens through {L} layers in {wall * 1e3:.1f} ms "
        f"({b * s / wall:.0f} tok/s); packed-matmul bound {bound:.1f} ms; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del logits, kv


def end_to_end(bw, out, a16_counts=None):
    """12 requests through the port's Engine on a random packed int2-g128
    7B (32 layers), then the steady decode step, its device idle share and
    one step against the plain versions. Given the A16 run's counts, the A8
    switch is set for this phase only (the Engine repacks the weights at
    construction) and every packed matmul of the same schedule must go
    through `qmm_a8`: as many launches as the A16 run's decode and prefill
    launches together, and none of those. The A16 run also drives
    the per-layer decode attention entry over the engine's 32 cache layers
    (its own path, counts reset before and read after)."""
    cfg = CFG
    a8 = a16_counts is not None
    params = random_packed_params(cfg, bits=BITS, group_size=GROUP, seed=0, device=DEV)
    saved = os.environ.get(qm.A8_ENV)
    os.environ[qm.A8_ENV] = "1" if a8 else "0"
    try:
        eng = Engine(params, cfg, max_slots=8, max_len=2048, eos_token_id=None,
                     sampling=SamplingParams(temperature=0.0), device=DEV)
        rng = np.random.default_rng(0)
        reqs = [Request(prompt_tokens=rng.integers(3, cfg.vocab_size, n).tolist(),
                        max_new_tokens=32) for n in REQ_LENS]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
    finally:
        if saved is None:
            os.environ.pop(qm.A8_ENV, None)
        else:
            os.environ[qm.A8_ENV] = saved
    params = eng.params  # the repacked tree under A8
    steps = eng.decode_steps
    out["prefills"] = eng.prefills
    L = cfg.num_layers
    if len(done) != len(reqs) or not all(r.finished and len(r.output_tokens) == 32 for r in reqs):
        raise AssertionError("not every request finished with 32 tokens")
    if counts["flash_decode"] < steps * L:
        raise AssertionError(f"decode attention did not run through the kernel: {counts}")
    prefill_matmuls = 4 * L * eng.prefills  # every prefill has M >= 64 rows
    if a8:
        a16_matmuls = a16_counts["qmm_decode"] + a16_counts["qmm_prefill"]
        if (counts["qmm_a8"] != a16_matmuls or counts["qmm_a8"] < steps * L * 4 + L * 4
                or counts["qmm_a8_prefill"] != a16_counts["qmm_prefill"]
                or counts["qmm_a8_prefill"] < prefill_matmuls
                or counts["qmm_decode"] + counts["qmm_prefill"]):
            raise AssertionError(f"A8 serving did not run every matmul through qmm_a8: {counts} "
                                 f"(A16 run: {a16_matmuls} packed matmuls)")
    elif (counts["qmm_decode"] < steps * L * 4 or counts["qmm_prefill"] < prefill_matmuls
          or eng.prefills < 1 or counts["qmm_a8"]):
        raise AssertionError(f"decode/prefill did not run through the kernels: {counts}")
    tag = "A8" if a8 else "A16"
    say(f"engine {tag}: {len(reqs)} requests, 8 slots, depth {L} of {CFG.num_layers} (no cut), "
        f"{eng.prefills} prefills, {steps} decode steps, "
        f"launches { {k: v for k, v in counts.items() if v} }, "
        f"wall {wall:.2f} s, "
        f"{sum(len(r.output_tokens) for r in reqs) / wall:.1f} generated tok/s end to end")

    # steady decode: all 8 slots at their final lengths, 8 timed steps
    pos = torch.as_tensor(np.minimum(eng.lengths, 2047 - 17), dtype=torch.int32, device=DEV)
    tok = torch.randint(3, cfg.vocab_size, (8, 1), device=DEV)

    def step(i):
        forward(params, cfg, tok, cache=eng.cache, cache_pos=pos + i)

    with torch.inference_mode():
        ms_step = cuda_ms(step, 8, reps=3)
        busy = device_busy_ms(step, 4)
        rows = [int(p) + 4 for p in pos.tolist()]
        nbytes = step_bytes(cfg, BITS, rows, group_bytes=8 if a8 else 4)
        # one decode step, kernels vs plain versions, same state. A16: the
        # plain path reads the scales the kernel decodes from the combo
        # words; A8: both read the f32 scales. Rows >= pos are not read by
        # either call, so the second call sees the cache the first one saw.
        ref_params = dict(params, layers=dict(params["layers"]))
        for name, leaf in params["layers"].items():
            if isinstance(leaf, PackedLinear) and not a8:
                s, sz = scales_from_combo(leaf.combo)
                ref_params["layers"][name] = dataclasses.replace(leaf, scales=s, szeros=sz)
        lk, _ = forward(params, cfg, tok, cache=eng.cache, cache_pos=pos + 20)
        lp, _ = forward(ref_params, cfg, tok, cache=eng.cache, cache_pos=pos + 20,
                        use_kernels=False)
        if not a8:  # the per-layer entry point's path: one step's attention, 32 layers
            q = torch.randn((8, 1, cfg.num_heads, cfg.actual_head_dim), device=DEV).bfloat16()
            kv_new = torch.randn((8, 1, cfg.num_kv_heads, cfg.actual_head_dim),
                                 device=DEV).bfloat16()
            fd1.flash_decode_attention.launches = 0
            outs = [fd1.flash_decode_attention(q, eng.cache.k[li], eng.cache.v[li], kv_new,
                                               kv_new, pos) for li in range(L)]
            torch.cuda.synchronize()
            out["per_layer_launches"] = fd1.flash_decode_attention.launches
            if out["per_layer_launches"] < L or not all(torch.isfinite(o).all() for o in outs):
                raise AssertionError("the per-layer decode attention path did not run its kernel")
    if busy is None:
        say("profiler: no device time recorded; device idle share not measured")
    else:
        say(f"profiler {tag}: device busy {busy['busy_ms']:.3f} ms of a {ms_step:.3f} ms step "
            f"(idle share {1 - busy['busy_ms'] / ms_step:.3f}); top: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in busy["top"]))
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits from the kernel path")
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    say(f"decode step {tag} vs plain path: max|dlogit| {err:.4g} of max|logit| {ref:.4g} "
        f"(tol {LOGIT_TOL} relative), argmax agreement {agree:.3f}")
    if not err <= LOGIT_TOL * ref:  # NaN fails too
        raise AssertionError("decode step logits disagree with the plain path")
    time_prefill(params, cfg, tag, a8, out)
    out.update(
        requests=len(reqs), decode_steps=steps, launches=counts, wall_s=wall,
        decode_ms_per_step=ms_step, decode_tok_per_s=8 / ms_step * 1e3,
        step_bytes=nbytes, step_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
        step_bound_measured_bw_ms=nbytes / bw * 1e3,
        idle_share=None if busy is None else 1 - busy["busy_ms"] / ms_step,
        logit_max_abs_err=err, logit_max=ref, argmax_agreement=agree, profile=busy,
    )
    say(f"decode {tag}: {ms_step:.3f} ms/step, {8 / ms_step * 1e3:.1f} tok/s at batch 8, "
        f"{nbytes / 1e9:.3f} GB/step -> bound {nbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at "
        f"3.35 TB/s, {nbytes / bw * 1e3:.3f} ms at the probe's {bw / 1e9:.0f} GB/s")
    del eng, params, ref_params
    return counts


def kernel_entry(name, src, replaces, launches, err, t, work, **extra):
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict(name=name, route="cuda", source=f"bitdistiller_tpu_torch/csrc/{src}",
                replaces=replaces, launches=launches, max_abs_err=err,
                **{k: t[k] for k in keys}, work=work, **extra)


def totals_entry(t, bw, peak_ops=PEAK_BF16_FLOPS):
    """Bound of a summed row (one layer's four matmuls) from its bytes and ops."""
    b, by = bound_ms(t["bytes"], t["flops"], peak_ops)
    return dict(t, bound_ms=b, bound_by=by, bound_measured_bw_ms=t["bytes"] / bw * 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(0)
    summary: dict = {}

    with Phase("build"):
        t0 = time.time()
        libs = _build.build()
        summary["build_s"] = time.time() - t0
        say(f"built {sorted(libs)} in {summary['build_s']:.1f} s")

    with Phase("card"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        say(card)
        n = 1 << 30
        src = torch.empty(n, dtype=torch.uint8, device=DEV)
        dst = torch.empty_like(src)
        copy_ms = cuda_ms(lambda i: dst.copy_(src), 10)
        copy_bw = 2 * n / (copy_ms / 1e3)  # read + write
        del src, dst
        reset_counts()
        probe = probe_phase({})
        bw = probe["bw"]
        summary.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       copy_bw=copy_bw, measured_bw=bw, probe=probe)
        say(f"device copy of 1 GiB: {copy_ms:.3f} ms -> {copy_bw / 1e9:.1f} GB/s (read + write, "
            f"library yardstick)")
        say(f"HBM probe (stream kernel, {probe['bytes'] / 1e9:.2f} GB of bf16 a call): "
            f"{probe['ms']:.3f} ms -> {bw / 1e9:.1f} GB/s; int8 {probe['bw_int8'] / 1e9:.1f} GB/s; "
            f"plain {probe['plain_ms']:.3f} ms, two torch.sum {probe['library_ms']:.3f} ms, "
            f"bound {probe['bound_ms']:.3f} ms; {probe['launches']} launches; "
            f"worst error {probe['max_abs_err']:.3g} of the |x| sum. bw = this rate from here on")

    with Phase("packed matmul vs plain"):
        summary["matmul_checks"] = []
        mm_rel = check_matmuls(gen, summary["matmul_checks"])
        say(f"{len(summary['matmul_checks'])} cases; integer inputs exact; "
            f"worst bf16 relative error at int2 {mm_rel:.3g}")

    with Phase("A8 matmul vs plain"):
        summary["a8_checks"] = []
        a8_rel = check_a8(gen, summary["a8_checks"])
        say(f"{len(summary['a8_checks'])} cases (pair-layout and repacked words, M={A8_CHECK_M}); "
            f"integer inputs exact; two calls equal at M=8; worst bf16 relative error at int2 "
            f"{a8_rel:.3g}")

    with Phase("decode attention vs plain (stacked and per layer)"):
        summary["attention_checks"] = []
        at_err = check_attention(gen, summary["attention_checks"])
        say(f"{len(summary['attention_checks'])} cases, GQA rep 8 included; worst bf16 MHA abs "
            f"error {at_err['stacked']:.3g} stacked, {at_err['per_layer']:.3g} per layer")

    with Phase("fused MLP vs plain, times and path"):
        summary["fused_mlp"] = []
        mlp = fused_mlp_phase(gen, summary["fused_mlp"])
        say(f"7B MLP, M={MLP_CHECK_M}: worst relative error {mlp['max_abs_err']:.3g}, two calls "
            f"equal; plan {mlp['plan']}; M=8 "
            f"{mlp['ms']:.4f} ms (bound {mlp['bound_ms']:.4f}, plain {mlp['plain_ms']:.3f}, "
            f"3 library calls {mlp['library_ms']:.4f}); path: {mlp['launches']} launches")

    with Phase("kernel times"):
        summary["matmul_times"] = []
        dec = time_matmuls(gen, 8, bw, summary["matmul_times"])
        pre = time_matmuls(gen, 256, bw, summary["matmul_times"])
        pre4k = time_matmuls(gen, PREFILL_M, bw, summary["matmul_times"])
        a8_dec = time_a8(gen, 8, summary["matmul_times"])
        a8_pre = time_a8(gen, 256, summary["matmul_times"])
        a8_pre4k = time_a8(gen, PREFILL_M, summary["matmul_times"])
        summary["attention_times"] = []
        att = time_attention(gen, bw, summary["attention_times"], per_layer=False)
        att1 = time_attention(gen, bw, summary["attention_times"], per_layer=True)
        for r in summary["matmul_times"] + summary["attention_times"]:
            say(json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in r.items()}))

    with Phase("end to end"):
        summary["e2e"] = {}
        counts = end_to_end(bw, summary["e2e"])

    with Phase("end to end A8"):
        summary["e2e_a8"] = {}
        counts_a8 = end_to_end(bw, summary["e2e_a8"], a16_counts=counts)

    dec, pre, pre4k = totals_entry(dec, bw), totals_entry(pre, bw), totals_entry(pre4k, bw)
    a8_dec = totals_entry(a8_dec, bw, PEAK_INT8_OPS)
    a8_pre = totals_entry(a8_pre, bw, PEAK_INT8_OPS)
    a8_pre4k = totals_entry(a8_pre4k, bw, PEAK_INT8_OPS)
    times = lambda t: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    kernels = [
        kernel_entry("qmm_decode", "quant_matmul.cu", "bitdistiller_tpu/ops/quant_matmul.py:152",
                     counts["qmm_decode"], mm_rel, dec,
                     "one layer's qkv+o+gate_up+down, M=8, int2-g128, 7B widths; max_abs_err "
                     "relative to max|plain|; launches from the A16 engine run",
                     bound_measured_bw_ms=dec["bound_measured_bw_ms"]),
        kernel_entry("qmm_prefill", "quant_matmul.cu", "bitdistiller_tpu/ops/quant_matmul.py:107",
                     counts["qmm_prefill"], mm_rel, pre,
                     "the same four, M=256 (x group sums + wgmma kernel; m4096: the engine's "
                     "first prefill shape); launches from the A16 engine run",
                     bound_measured_bw_ms=pre["bound_measured_bw_ms"], m4096=times(pre4k)),
        kernel_entry("flash_decode", "decode_attention.cu",
                     "bitdistiller_tpu/ops/decode_attention.py:106", counts["flash_decode"],
                     at_err["stacked"], att,
                     "B=8, Hq=Hkv=32, T=2048, D=128, bf16 cache, mixed starts; launches from "
                     "the A16 engine run", bound_measured_bw_ms=att["bound_measured_bw_ms"]),
        kernel_entry("qmm_a8", "quant_matmul_a8.cu", "bitdistiller_tpu/ops/quant_matmul.py:721",
                     counts_a8["qmm_a8"], a8_rel, a8_dec,
                     "one layer's four A8 matmuls (quantization included), M=8, int2-g128 "
                     "repacked, 7B widths, quantize + streaming decode kernel (PDL); "
                     "max_abs_err relative to max|plain|; "
                     "launches from the A8 engine run (every packed matmul, prefill and decode)",
                     bound_measured_bw_ms=a8_dec["bound_measured_bw_ms"],
                     m256=times(a8_pre), m4096=times(a8_pre4k),
                     prefill_launches=counts_a8["qmm_a8_prefill"]),
        kernel_entry("fused_mlp", "fused_mlp.cu", "bitdistiller_tpu/experimental/fused_mlp.py:57",
                     mlp["launches"], mlp["max_abs_err"], mlp,
                     "7B MLP (K=4096, FFN=11008, D=4096), M=8, int2-g128, silu, two launches "
                     "(gate/up, down) chained by PDL; library_ms is "
                     "three calls (matmul, silu*mul, matmul on bf16 weights); launches from its "
                     "path: one decode step's MLP through 32 layers (entry point, no model hook)",
                     bound_measured_bw_ms=mlp["bytes"] / bw * 1e3),
        kernel_entry("flash_decode_attention", "decode_attention.cu",
                     "bitdistiller_tpu/experimental/flash_decode.py:33",
                     summary["e2e"]["per_layer_launches"], at_err["per_layer"], att1,
                     "B3's kernel on one layer's [B, Hkv, T, D] cache, same work as B3's row; "
                     "launches from its path: the 32 layers of the A16 engine's cache "
                     "(entry point)", bound_measured_bw_ms=att1["bound_measured_bw_ms"]),
        kernel_entry("stream_sum", "bw_probe.cu", "scripts/bw_probe.py:100",
                     probe["launches"], probe["max_abs_err"], probe,
                     "K and V bf16 planes [16*8*32, 2048, 128], 4.29 GB a call, chained; "
                     "max_abs_err relative to the |x| sum; library_ms is two torch.sum calls; "
                     "launches from its path, the probe's timing run",
                     bound_measured_bw_ms=probe["bytes"] / bw * 1e3),
    ]
    summary["kernels"] = kernels
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
