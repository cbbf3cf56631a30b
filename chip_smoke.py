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
before and read after. Then the training slice: `c1` (the packed kernels
at g32, g64 and per-channel, f32 activations, decode attention at D = 256
and with f32 q, each through its kernel; g64 times beside g128's),
`train_attention` (B8's forward and gradients against the plain version at
TinyLlama's and 7B's shapes, padded and ragged, MQA with 71 heads, D = 256
with 16 heads and at Gemma-2B's 8 query heads over 1 kv head, and f32, and
their times beside SDPA's at TinyLlama's, 7B's, both D = 256 and the f32
case's shapes, with the dkv plan), `train` (run_training at the full width and depth of
TinyLlama-1.1B: int2-asym STE at g64, CAKLD, 2 x 1024 tokens a micro-step,
grad_accum 2, two optimizer cycles, student and teacher through B8; the
random bf16 model written to disk with save_hf_checkpoint, and loaded,
trained and saved by run_training itself, its losses bit-equal to a run
handed the same tree) and `serve_trained` (the final save reloaded
bit-equal to the master, packed at int2-g64 and served through the Engine
on B1/B2/B3, then exported to GPTQ with every code, scale and zero point
held; the checkpoint I/O seconds beside the card's name and power limit). Between c1 and train_attention, `c6` runs the shapes
the JAX package computes and earlier slices refused: the decode attention
at any GQA rep and head dim (Falcon-7B's 71 heads over 1, rep 3, 5, 7, D =
72, 80, 96, 320), the packed matmuls and fused MLP at Falcon-7B's K = 4544
(64 mod 128) at g64 and g32, and B8 at D = 72, 80, 300, 320, 1040, each
through its kernel. Last, after serve_trained, `families` serves the
model families through the port's entry points (init_params, pack_model,
Engine; random weights from seed 0, biases and norms moved off zero and
one): Falcon-7B whole (32 layers, int2-g64, A16 then A8, timed),
and MPT-7B, Qwen3-8B, Qwen2-7B (A16 and A8), Phi-3-mini-4k (prompts past
its window of 2047) and Gemma-3-4B at full width and reduced depth, each
from the HF config dict stated in FAMILIES, with every launch count exact
(B1 every prefill matmul, B2 or B4 every decode matmul, B3 the decode
attention exactly where the JAX package's flash_ok holds). Beside
the build, scripts/kernel_sass.py reads what ptxas made of
csrc/train_attention.cu; the `sass` phase prints it and fails unless every
B8 tensor-core kernel (bf16, and the 3xTF32 forward, dkv and dq, alone and
on the splits above D = 128) issues HGMMA, holds no HMMA (mma.sync) and
spills nothing.
Phases print one line each; any failure exits non-zero before the last
line. The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Tolerances (kernel vs plain version on the same inputs):
  * integer-valued activations and weights: exact (every product and partial
    sum is an integer below 2^24 in f32, so summation order cannot matter),
    at M = 1, 8, 16, 17, 32, 33, 200, 256 and 4096 (the streaming decode
    kernels' one, two and four 8-token tiles up to 32 rows, ragged too; the
    wgmma prefill kernels above, ragged and whole tiles);
  * bf16 activations, packed matmul: max|kernel - plain| <= 1e-2 * max|plain|
    (both round an f32 sum to bf16: one bf16 ulp is 2^-8 relative, and the
    f32 sums differ in order);
  * A8 matmul: integer-valued x with one 127 a row (per-token scale 1):
    exact, at the same M; bf16 x: max|kernel - plain| <= 1e-2 * max|plain|
    (as above);
  * fused MLP, M = 1, 8, 33, 128: max|kernel - plain| <= 1e-2 * max|plain|
    (bf16 output, f32 sums in another order and tile grouping, mid rounded
    to bf16 after an activation whose last f32 bit may differ);
  * the streaming decode kernels (A16 and A8 at M <= 32, the fused MLP) and
    the decode attention: a second call on the same inputs gives the same
    bytes (sums and merges in a fixed order, no atomics);
  * decode attention, stacked and per layer: max abs error <= 2e-2 on O(1)
    outputs (the prob row is rounded to bf16 against per-warp running maxima
    in the kernel and against one global maximum in the plain version; one
    bf16 ulp of a prob), on the cases the cluster split creates too (fewer
    rows than CTAs, one long slot beside empty ones, a window across a CTA
    boundary);
  * HBM probe: |kernel - plain| <= 1e-6 * (the same sum over |x|): f32 sums
    of 2^30 elements in another order differ by about 1e-10 of it, while a
    kernel that skipped 1% of the normal planes would be off by about 2e-6;
  * one whole decode step of the 7B model, kernels vs plain versions:
    max|logit error| <= 5e-2 * max|logit| (bf16 rounding differences of every
    matmul output compound over 32 layers), A16 and A8 alike; the same for
    the trained TinyLlama student packed at int2-g64;
  * C1: integer-valued x (bf16 or f32: the kernels round f32 x to bf16,
    which keeps small integers exact), exact, A16 and A8 at g32, g64 and
    per-channel, M = 8 and 256; the fused MLP within MLP_TOL (f32 x: its
    group sums of the unrounded x, as the plain version); decode attention
    at D = 256 and with f32 q within ATTN_TOL;
  * C6: the packed matmuls exact on integers (A16, A8 on pair-layout and
    repacked words), the fused MLP within MLP_TOL, the decode attention
    within ATTN_TOL (two calls equal), B8 as below;
  * families: in one decode step of each run, every packed linear against
    its plain version on the same input within MATMUL_TOL (as above), and
    the step's logits against the plain path within LOGIT_TOL (as the 7B
    step's; under A8 within the larger of LOGIT_TOL and A8_SPREADS times
    the plain A8 path's own spread for a one-ulp move of its input:
    per-token int8 grids move with a row's maximum); Falcon-7B's prefill
    then cached decode of one request against the plain cache-less forward
    within LOGIT_TOL;
  * B8 in bf16: the output and each of dq, dk, dv within 2e-2 of the
    plain version's max (p and ds enter their products rounded to bf16, the
    plain version keeps f32; pad rows compared under the mask); in f32 within
    1e-4 (f32 sums in another order);
  * the first KD micro-step of TinyLlama through B8 against the same step
    with the plain attention: loss within 2e-2 and gradient norm within 5e-2
    relative (22 bf16 layers; bf16 probabilities in B8, f32 in the plain
    softmax); every training loss finite.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from bitdistiller_tpu_torch.experimental import flash_decode as fd1
from bitdistiller_tpu_torch.experimental import fused_mlp as fm
from bitdistiller_tpu_torch.models import gptq_export as gx
from bitdistiller_tpu_torch.models import llama as llama_mod
from bitdistiller_tpu_torch.models import safetensors_io
from bitdistiller_tpu_torch.models import (
    FALCON_7B,
    LLAMA2_7B,
    TINYLLAMA_1B,
    KVCache,
    ModelConfig,
    forward,
    init_params,
    pack_model,
    random_packed_params,
)
from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint, save_hf_checkpoint
from bitdistiller_tpu_torch.ops import _build
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.ops import quant_matmul as qm
from bitdistiller_tpu_torch.ops import train_attention as ta
from bitdistiller_tpu_torch.quant.packing import (
    PackedLinear,
    dequantize_linear,
    make_scale_combo,
    scales_from_combo,
    unpack_codes,
)
from bitdistiller_tpu_torch.scripts import bw_probe
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as tr
from bitdistiller_tpu_torch.train.pipeline import run_training

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 on CUDA cores (data sheet)
PEAK_TF32X3_FLOPS = 495e12 / 3  # f32 as 3xTF32: three dense TF32 products (data sheet 495) a product
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
A8_SPREADS = 2  # A8 logits: within this many of the plain A8 path's one-ulp spreads
NOISE = 0.1  # the families' biases and norms, moved off zero and one
# decode kernels up to 32 rows (1, 2 and 4 token tiles, 17 ragged); 200 ragged
# against both prefill tiles
CHECK_M = (1, 8, 16, 17, 32, 33, 200, 256, 4096)
MLP_CHECK_M = (1, 8, 33, 128)
PREFILL_M = 4096  # the engine's first prefill: 8 prompts in the 512 bucket
REQ_LENS = [64, 512, 200, 333, 128, 480, 96, 256, 400, 150, 64, 300]
TABLE_STARTS = [2047, 1900, 1536, 1024, 700, 512, 300, 64]  # long, skewed: 8083 rows
PATH_STARTS = [n + 32 for n in REQ_LENS[-8:]]  # the steady decode step's slots: 2130 rows


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


def rand_stacked(gen, layers, k, n, bits, integer, group=GROUP):
    """A stacked PackedLinear with random codes (group -1: one group of K).
    Integer case: scales 1 and integer szeros; else bf16-exact scales, so the
    plain version (f32 scales) and the kernel (combo words) read the same
    weights."""
    pack = 32 // bits
    qw = torch.randint(-(2**31), 2**31 - 1, (layers, k // pack, n), dtype=torch.int32,
                       device=DEV, generator=gen)
    group = k if group < 1 else group
    ng = k // group
    if integer:
        scales = torch.ones((layers, ng, n), device=DEV)
        szeros = torch.full((layers, ng, n), float(2 ** (bits - 1)), device=DEV)
    else:
        scales = (torch.rand((layers, ng, n), device=DEV, generator=gen) * 0.02 + 0.005)
        scales = scales.bfloat16().float()
        zeros = torch.randint(0, 2**bits, (layers, ng, n), device=DEV, generator=gen).float()
        szeros = (scales * zeros).bfloat16().float()
    return PackedLinear(qweight=qw, scales=scales, szeros=szeros, bias=None, bits=bits,
                        group_size=group, in_features=k, out_features=n,
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
    """B1/B2 on layer 1 of a stack: int2 and int4, the four 7B shapes, M in
    CHECK_M; at M = 8 on bf16 x a second call must give the same bytes."""
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
                    if m == 8 and not integer and not torch.equal(got, qm.quant_matmul(x, p, 1)):
                        raise AssertionError(f"packed matmul {name} bits={bits}: two calls differ")
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
    same bf16 inputs; the stacked call twice, which must give the same
    bytes. Besides mixed starts, the cases the split over a cluster creates
    where `attention_plan` splits (GQA rep 8 at batch 8, and batch 1: clusters
    of 8; the 7B at batch 8 runs one CTA a pair): every slot with fewer rows
    than CTAs, one long slot beside empty ones, a window across CTA
    boundaries, attn_len < T. Returns the worst bf16 MHA error of each entry."""
    mha = dict(b=8, hq=32, hkv=32, t=2048, d=128, window=None, attn_len=None)
    rep8 = dict(mha, hkv=4)
    cases = [
        mha,
        dict(mha, hkv=8),  # GQA
        rep8,  # GQA rep 8
        dict(mha, window=256),
        dict(b=4, hq=8, hkv=4, t=512, d=64, window=None, attn_len=384),
        dict(mha, starts=[0, 1, 2, 3, 4, 5, 6, 7]),  # tiny slots, one CTA each
        dict(rep8, starts=[0, 1, 2, 3, 5, 7, 8, 9]),  # fewer rows than CTAs
        dict(rep8, starts=[2047, 0, 0, 0, 0, 0, 0, 0]),  # one long slot
        dict(mha, b=1, starts=[2047]),
        dict(rep8, window=300, starts=[1000, 2047, 1500, 301, 299, 5, 700, 1200]),
    ]
    worst = {"stacked": 0.0, "per_layer": 0.0}
    for kv in ("bf16", "int8"):
        for c in cases:
            c = dict(c)
            starts = c.pop("starts", None) or mixed_starts(c["b"], (c["attn_len"] or c["t"]) - 1)
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
                got = run()
                if entry == "stacked" and not torch.equal(got, run()):
                    raise AssertionError(f"decode attention {kv} {c}: two calls differ")
                err = (got.float() - want.float()).abs().max().item()
                record.append(dict(kv=kv, entry=entry, **c, starts=starts, max_abs_err=err,
                                   ok=err <= ATTN_TOL))
                if not err <= ATTN_TOL:  # NaN fails too
                    raise AssertionError(f"decode attention {entry} {kv} {c}: max|err|={err}")
                if kv == "bf16" and c["hq"] == c["hkv"] and c["window"] is None:
                    worst[entry] = max(worst[entry], err)
    return worst


def check_a8(gen, record):
    """B4 on layer 1 of a stack: int2 and int4, the four 7B shapes, M in
    CHECK_M, pair-layout words (x permuted per call) and repacked ones;
    at M = 8 on bf16 x a second call must give the same bytes."""
    worst = 0.0
    for bits in (2, 4):
        for name, (k, n) in SHAPES.items():
            for integer in (True, False):
                pair = rand_stacked(gen, 2, k, n, bits, integer)
                for w in (pair, qm.repack_linear_a8(pair)):
                    lay = w.layer(1)
                    for m in CHECK_M:
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


def time_matmuls(gen, m, bw, detail, group=GROUP, shapes=SHAPES):
    """One layer's four packed matmuls at M rows, int2 at `group` (128 for the
    table's rows). The kernel is
    timed through its raw ctypes launcher (a few us of host time a call, so
    the card, not Python, sets the pace); `wrapper_ms` is the same work
    through `quant_matmul`. Weights cycle through enough stacked layers
    (> 100 MB) that every call reads them from HBM, as the layer loop does;
    the plain version and the library call (torch.matmul on a dequantized
    bf16 weight) run on layer 0. Up to 32 rows the raw call is the streaming
    decode kernel on `a16_decode_plan`'s cluster and columns a warp; above,
    the prefill kernels' (the x group sums, then the wgmma kernel) at the
    tile the wrapper chooses. `shapes`: {name: (K, N)}, the 7B's four unless
    given."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    prefill = m > qm.DECODE_MAX_M
    fn = qm._launcher("bd_qmm_prefill" if prefill else "bd_qmm_decode")
    stream = torch.cuda.current_stream().cuda_stream
    plain_iters, plain_reps = (1, 2) if m >= PREFILL_M else (3, 3)
    for name, (k, n) in shapes.items():
        layer_bytes = k * n * BITS / 8 + (k // group) * n * 4
        layers = max(2, math.ceil(120e6 / layer_bytes))
        p = rand_stacked(gen, layers, k, n, BITS, integer=False, group=group)
        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
        out = torch.empty((m, n), dtype=torch.bfloat16, device=DEV)
        if prefill:
            xsum = qm.group_sums_scratch(m, k, torch.float32, DEV, group)
            extra, plan = (None, xsum.data_ptr()), (qm._tile_m(x, n),)
        else:
            extra, plan = (), qm.a16_decode_plan(n, qm.kernel_steps(k), qm._sm_count(0))
        args = [(x.data_ptr(), p.qweight[i].data_ptr(), p.combo[i].data_ptr(), None, *extra,
                 out.data_ptr(), m, k, n, BITS, group, *plan, 0, stream) for i in range(layers)]
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
                           k=k, n=n, group=group, tile_m=plan[0] if prefill else None,
                           cluster=None if prefill else plan[0],
                           warp_cols=None if prefill else plan[1], ms=ms,
                           wrapper_ms=wrapper, plain_ms=plain, library_ms=lib, bound_ms=b,
                           bound_by=by, bound_measured_bw_ms=nbytes / bw * 1e3))
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += nbytes
        tot["flops"] += flops
        del p, w
    return tot


def time_attention(gen, bw, detail, per_layer: bool, starts=TABLE_STARTS):
    """B3 on layer i % 2 of a stacked cache, or (per_layer) B6, the per-layer
    entry, on two separate [B, Hkv, T, D] caches: the same work and the same
    kernel, 7B heads, batch 8, T = 2048, the slots at `starts` (the table's
    long skewed work, or the steady decode step's lengths). `ms` is the raw
    launcher on `attention_plan`'s clusters (as for the matmuls),
    `wrapper_ms` the entry point; the library yardstick is SDPA over the same
    layer's cache with a row mask (it reads all T rows and does not fold the
    fresh token)."""
    b, hq, hkv, t, d = 8, 32, 32, 2048, 128
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
    cluster = da.attention_plan(b, hkv, qm._sm_count(0))
    args = [(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, kn.data_ptr(), vn.data_ptr(),
             st.data_ptr(), out.data_ptr(), 0, b, hkv, hq // hkv, t, d, t, 0,
             1.0 / math.sqrt(d), cluster, 0, stream) for k, v in caches]
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
               hq=hq, hkv=hkv, t=t, d=d, starts=starts, rows=rows, cluster=cluster, ms=ms,
               wrapper_ms=wrapper,
               plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
               bound_measured_bw_ms=nbytes / bw * 1e3)
    detail.append(rec)
    return rec


def time_a8(gen, m, detail, group=GROUP, shapes=SHAPES):
    """B4: one layer's four A8 matmuls at M rows, int2 at `group` repacked, as
    `time_matmuls` times B1/B2 (raw launcher over >100 MB of stacked layers;
    the wrapper; the plain version and torch.matmul on a dequantized bf16
    weight on layer 0). Bytes count the f32 scales and szeros (8 bytes a
    group column); operations are int8 at 1,979 TOP/s. Up to 32 rows the
    call is the quantize kernel and the streaming decode kernel on
    `decode_plan`'s clusters (two launches chained by PDL); above, the
    prefill kernels (quantize, xi group sums, s8 wgmma). `shapes` as
    time_matmuls'."""
    tot = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    fn = qm._a8_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    prefill = m > qm.DECODE_MAX_M
    plain_iters, plain_reps = (1, 2) if m >= PREFILL_M else (3, 3)
    for name, (k, n) in shapes.items():
        layer_bytes = k * n * BITS / 8 + (k // group) * n * 8
        layers = max(2, math.ceil(120e6 / layer_bytes))
        pair = rand_stacked(gen, layers, k, n, BITS, integer=False, group=group)
        p = qm.repack_linear_a8(pair)
        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
        xi = torch.empty((m, k), dtype=torch.int8, device=DEV)
        sx = torch.empty((m,), dtype=torch.float32, device=DEV)
        xsum = qm.group_sums_scratch(m, k, torch.int32, DEV, group) if prefill else None
        tile = qm._tile_m(x, n) if prefill else 0
        cluster = 0 if prefill else qm.decode_plan(n, qm.kernel_steps(k), qm._sm_count(0))
        out = torch.empty((m, n), dtype=torch.bfloat16, device=DEV)
        args = [(x.data_ptr(), p.qweight[i].data_ptr(), p.scales[i].data_ptr(),
                 p.szeros[i].data_ptr(), None, None, xi.data_ptr(), sx.data_ptr(),
                 None if xsum is None else xsum.data_ptr(), out.data_ptr(), m, k, n, BITS, group,
                 tile, cluster, 0, stream) for i in range(layers)]
        _build.check(fn(*args[0]), "raw launch")
        ms = cuda_ms(lambda i: fn(*args[i % layers]), 50)
        wrapper = cuda_ms(lambda i: qm.quant_matmul_a8(x, p, i % layers), 50)
        lay = p.layer(0)
        plain = cuda_ms(lambda i: qm.quant_matmul_a8_plain(
            x, lay.qweight, lay.scales, lay.szeros, BITS, group, True), plain_iters, reps=plain_reps)
        w = dequantize_linear(pair.layer(0), torch.bfloat16)
        lib = cuda_ms(lambda i: torch.matmul(x, w), 20)
        nbytes = layer_bytes + m * k * 2 + m * n * 2
        flops = 2.0 * m * k * n
        b, by = bound_ms(nbytes, flops, PEAK_INT8_OPS)
        detail.append(dict(kernel="qmm_a8", shape=name, m=m, k=k, n=n, group=group,
                           tile_m=tile or None,
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
             None, None, mid.data_ptr(), msum.data_ptr(), out.data_ptr(), m, k, f, d, BITS, GROUP,
             0, *plan, 0, stream) for li in range(L)]
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
    """Weights of the packed projections (q, k, v, o, the gate where the MLP
    is gated, up, down), all layers."""
    d, ffn = cfg.hidden_size, cfg.intermediate_size
    mlp = (3 if cfg.mlp_style == "gated" else 2) * d * ffn
    return (2 * d * cfg.q_size + 2 * d * cfg.kv_size + mlp) * cfg.num_layers


def step_bytes(cfg, bits, rows_per_slot, group_bytes: int = 4, group: int = GROUP) -> float:
    """HBM bytes one decode step must read: packed weights, the group
    statistics (a 4-byte combo word a group column for A16, f32 scale and
    szero, 8 bytes, for A8), the lm_head (or the tied embedding) and the
    valid KV rows (bench.py's model_bytes_per_step with the KV term counted
    per slot)."""
    n_w = packed_weights(cfg)
    kv = cfg.num_layers * sum(rows_per_slot) * cfg.num_kv_heads * cfg.actual_head_dim * 2 * 2
    return n_w * bits / 8 + n_w / group * group_bytes + cfg.hidden_size * cfg.vocab_size * 2 + kv


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
    b8 = {k: v for k, v in per.items() if "train_attn" in k}  # B8's kernels, ms a step
    return dict(busy_ms=sum(per.values()), top=top, b8=b8, b8_ms=sum(b8.values()))


COUNTERS = {  # name: (wrapper, its counter)
    "qmm_decode": (qm.qmm_decode, "launches"), "qmm_prefill": (qm.qmm_prefill, "launches"),
    "qmm_a8": (qm.qmm_a8, "launches"), "qmm_a8_prefill": (qm.qmm_a8, "prefill_launches"),
    "flash_decode": (da.flash_decode_stacked, "launches"),
    "flash_decode_attention": (fd1.flash_decode_attention, "launches"),
    "fused_mlp": (fm.fused_mlp, "launches"), "stream_sum": (bw_probe.stream_sum, "launches"),
    "train_attn_fwd": (ta.train_attn_fwd, "launches"),
    "train_attn_bwd_dkv": (ta.train_attn_bwd_dkv, "launches"),
    "train_attn_bwd_dq": (ta.train_attn_bwd_dq, "launches")}


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


# ---- C1: the packed kernels at every group size, f32 activations ----------------

C1_GROUPS = (32, 64, -1)  # -1: per-channel, one group of K
C1_M = (8, 256)
C1_SQUARE_MLP = (4096, 4096, 4096)  # per-channel fused MLP: K = FFN = D


def _ints(gen, m, k, dtype, top=None):
    x = torch.randint(-3, 4, (m, k), device=DEV, generator=gen).float()
    if top is not None:  # one 127 a row: the A8 per-token scale is 1
        x[:, 0] = top
    return x.to(dtype)


def check_c1(gen, record):
    """The cases C1 repaired, each through its kernel (launch counters) and
    against its plain version: A16 decode and prefill and A8 (pair-layout
    and repacked words) at g32, g64 and per-channel on the 7B o and down
    shapes, M = 8 and 256, bf16 and f32 x, exact on integers; the fused MLP
    at the same groups (7B widths; per-channel on a square MLP, K = FFN = D
    = 4096, since the three layers share one group) within MLP_TOL, bf16 and
    f32 x; decode attention at D = 256 and with f32 q within ATTN_TOL."""
    for group in C1_GROUPS:
        for name in ("o", "down"):
            k, n = SHAPES[name]
            p = rand_stacked(gen, 2, k, n, BITS, integer=True, group=group)
            p8 = qm.repack_linear_a8(p)
            for m in C1_M:
                for dtype in (torch.bfloat16, torch.float32):
                    x = _ints(gen, m, k, dtype)
                    reset_counts()
                    got = qm.quant_matmul(x, p, 1)
                    counts = read_counts()
                    key = "qmm_decode" if m <= qm.DECODE_MAX_M else "qmm_prefill"
                    want = plain_matmul(x, p, 1)
                    ok = counts[key] == 1 and got.dtype == dtype and torch.equal(got, want)
                    record.append(dict(kernel=key, group=p.group_size, shape=name, m=m,
                                       dtype=str(dtype), ok=ok))
                    if not ok:
                        raise AssertionError(f"C1 A16 g{p.group_size} {name} M={m} {dtype}: "
                                             f"counts {counts}, exact {torch.equal(got, want)}")
                    x8 = _ints(gen, m, k, dtype, top=127.0)
                    for w in (p, p8):
                        reset_counts()
                        got = qm.quant_matmul_a8(x8, w, 1)
                        counts = read_counts()
                        lay = w.layer(1)
                        want = qm.quant_matmul_a8_plain(x8, lay.qweight, lay.scales, lay.szeros,
                                                        BITS, lay.group_size, w.a8_order)
                        ok = counts["qmm_a8"] == 1 and torch.equal(got, want)
                        record.append(dict(kernel="qmm_a8", group=p.group_size, shape=name, m=m,
                                           dtype=str(dtype), a8_order=w.a8_order, ok=ok))
                        if not ok:
                            raise AssertionError(f"C1 A8 g{p.group_size} {name} M={m} {dtype} "
                                                 f"a8_order={w.a8_order}: counts {counts}")
            del p, p8
    for group in C1_GROUPS:
        k, f, d = MLP if group > 0 else C1_SQUARE_MLP
        g, u, dn = (rand_stacked(gen, 1, a, b, BITS, False, group=group).layer(0)
                    for a, b in ((k, f), (k, f), (f, d)))
        for m in (8, 33, 256):  # the kernel runs M > 32 in chunks of 32 token rows
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((m, k), device=DEV, generator=gen).to(dtype)
                reset_counts()
                got = fm.fused_mlp(x, g, u, dn, block_f=f)
                counts = read_counts()
                want = fm.fused_mlp_plain(x, g, u, dn, block_f=f)
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                ok = counts["fused_mlp"] == 1 and got.dtype == dtype and err <= MLP_TOL * scale
                record.append(dict(kernel="fused_mlp", group=g.group_size, m=m, dtype=str(dtype),
                                   max_abs_err=err, ref_max=scale, ok=ok))
                if not ok:
                    raise AssertionError(f"C1 fused MLP g{g.group_size} M={m} {dtype}: "
                                         f"err {err} of {scale}, counts {counts}")
    for hq, hkv, d, qdt in ((8, 8, 256, torch.bfloat16), (32, 4, 256, torch.bfloat16),
                            (32, 4, 256, torch.float32), (32, 32, 128, torch.float32),
                            (32, 4, 64, torch.float32)):
        q, ck, cv, kn, vn, st, _, _ = attn_inputs(gen, 8, hq, hkv, 1024, d, "bf16",
                                                  mixed_starts(8, 1023))
        q, kn, vn = q.to(qdt), kn.to(qdt), vn.to(qdt)
        reset_counts()
        got = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, st)
        counts = read_counts()
        want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, st)
        err = (got.float() - want.float()).abs().max().item()
        ok = counts["flash_decode"] == 1 and got.dtype == qdt and err <= ATTN_TOL
        record.append(dict(kernel="flash_decode", hq=hq, hkv=hkv, d=d, q_dtype=str(qdt),
                           max_abs_err=err, ok=ok))
        if not ok:
            raise AssertionError(f"C1 decode attention D={d} {qdt}: err {err}, counts {counts}")
    return len(record)


# ---- C6: the shapes the JAX package computes and earlier slices refused ------------

# Falcon-7B's widths (FALCON_7B in the JAX package's config): hidden 4544 (K = 64
# mod 128), 71 query heads over 1 kv head of D = 64, FFN 4 x 4544
FALCON = dict(hidden=4544, heads=71, kv_heads=1, ffn=18176)
C6_ATTN = [  # name: (B, Hq, Hkv, T, D, cache)
    ("falcon7b", 8, 71, 1, 2048, 64, "bf16"), ("falcon7b_int8", 8, 71, 1, 2048, 64, "int8"),
    ("rep3", 8, 24, 8, 2048, 128, "bf16"),  # Llama-3.2-3B's heads
    ("rep5", 8, 40, 8, 2048, 128, "bf16"),
    ("rep7", 8, 56, 8, 2048, 128, "bf16"),  # Yi-34B's heads
    ("d72", 8, 32, 8, 2048, 72, "bf16"), ("d72_int8", 8, 32, 8, 2048, 72, "int8"),  # by element
    ("d80", 8, 32, 8, 2048, 80, "bf16"), ("d96", 8, 32, 8, 2048, 96, "bf16"),
    ("d320", 8, 32, 8, 2048, 320, "bf16"),
    ("rep8_d128", 8, 32, 4, 2048, 128, "bf16"),  # control: an instance of its own
]
C6_MATMULS = {  # name: (K, N) of Falcon-7B's projections; down (K = FFN) is the control
    "qkv": (4544, 4672), "dense": (4544, 4544), "gate_up": (4544, 2 * 18176),
    "down": (18176, 4544),
}
C6_GROUPS = (64, 32)
C6_TA = {  # name: (B, S, Hq, Hkv, D, padded row length or None)
    "d72": (1, 600, 8, 2, 72, 500), "d80": (1, 600, 8, 2, 80, 500),
    "d300": (1, 600, 8, 2, 300, 500), "d320": (1, 600, 8, 2, 320, 500),
    "d1040": (1, 100, 8, 4, 1040, 80),  # past the splits: all three on the CUDA cores
}


def _attn_row(gen, b, hq, hkv, t, d, kv):
    """One C6 attention case on the table's long skewed starts: the kernel
    against its plain version (two calls equal), its time through the raw
    launcher on layers 0 and 1 in turn (as `time_attention`; `wrapper_ms`
    the entry point), the plain version's, SDPA's (on the bf16 cache; an
    int8 cache dequantized to bf16 first, outside the timing) and the byte
    bound."""
    starts = TABLE_STARTS[:b]
    q, ck, cv, kn, vn, st, ks, vs = attn_inputs(gen, b, hq, hkv, t, d, kv, starts)
    run = lambda i: da.flash_decode_stacked(q, ck, cv, i % 2, kn, vn, st, k_scale=ks,
                                            v_scale=vs)
    reset_counts()
    got = run(1)
    counts = read_counts()
    want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, st, k_scale=ks, v_scale=vs)
    err = (got.float() - want.float()).abs().max().item()
    ok = counts["flash_decode"] == 1 and torch.equal(got, run(1)) and err <= ATTN_TOL
    rep, fn = hq // hkv, da._launcher()
    out = torch.empty((b, hq, d), dtype=torch.bfloat16, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    cluster = da.attention_plan(b, hkv * da.head_tiles(rep, d), qm._sm_count(0))
    ptr = lambda a, i: None if a is None else a[i].data_ptr()
    args = [(q.data_ptr(), ck[i].data_ptr(), cv[i].data_ptr(), ptr(ks, i), ptr(vs, i),
             kn.data_ptr(), vn.data_ptr(), st.data_ptr(), out.data_ptr(), int(kv == "int8"), b,
             hkv, rep, t, d, t, 0, 1.0 / math.sqrt(d), cluster, 0, stream) for i in range(2)]
    _build.check(fn(*args[0]), "raw launch")
    ms = cuda_ms(lambda i: fn(*args[i % 2]), 50)
    wrapper = cuda_ms(run, 50)
    plain = cuda_ms(lambda i: da.decode_attention_plain(q, ck, cv, 1, kn, vn, st, k_scale=ks,
                                                        v_scale=vs), 3, reps=3)
    kl, vl = ck[1], cv[1]
    if kv == "int8":  # SDPA reads the cache dequantized to bf16 beforehand (not timed)
        kl, vl = ((c[1].float() * sc[1][..., None]).bfloat16() for c, sc in ((ck, ks), (cv, vs)))
    mask = (torch.arange(t, device=DEV)[None, :] < st[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    lib = cuda_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qs, kl, vl, attn_mask=mask, enable_gqa=True), 20)
    rows, elt = sum(starts), (1 if kv == "int8" else 2)
    row_bytes = d * elt + (4 if kv == "int8" else 0)  # + its f32 scale
    nbytes = 2 * rows * hkv * row_bytes + 4 * b * hq * d + 4 * b * hkv * d
    bnd, by = bound_ms(nbytes, 4.0 * rows * hq * d)
    return ok, dict(b=b, hq=hq, hkv=hkv, t=t, d=d, kv=kv, tile=da.decode_tile(rep, d),
                    cluster=cluster, rows=rows, max_abs_err=err,
                    launches=counts["flash_decode"], ms=ms, wrapper_ms=wrapper, plain_ms=plain,
                    library_ms=lib, bound_ms=bnd, bound_by=by)


def _mm_case(gen, k, n, group, m, a8):
    """One C6 packed matmul (layer 1 of a 2-layer stack, integer inputs)
    against its plain version, exact: A16 through quant_matmul, or A8 on
    pair-layout and repacked words; returns (ok, launches of its kernel)."""
    p = rand_stacked(gen, 2, k, n, BITS, integer=True, group=group)
    x = _ints(gen, m, k, torch.bfloat16, top=127.0 if a8 else None)
    ok, launches = True, 0
    for w in ((p, qm.repack_linear_a8(p)) if a8 else (p,)):
        reset_counts()
        got = (qm.quant_matmul_a8 if a8 else qm.quant_matmul)(x, w, 1)
        counts = read_counts()
        key = "qmm_a8" if a8 else ("qmm_decode" if m <= qm.DECODE_MAX_M else "qmm_prefill")
        lay = w.layer(1)
        if a8:
            want = by_rows(lambda xr: qm.quant_matmul_a8_plain(
                xr, lay.qweight, lay.scales, lay.szeros, BITS, group, w.a8_order), x, 32)
        else:
            want = by_rows(lambda xr: plain_matmul(xr, p, 1), x, 32)
        ok = ok and counts[key] == 1 and torch.equal(got, want)
        launches += counts[key]
    return ok, launches


def c6_phase(gen, bw, rec):
    """The shapes C6 repaired, each through its kernel (launch counters) and
    against its plain version on the card, with times beside the bounds:
    B3 at Falcon-7B's heads (rep 71, D = 64; bf16 and int8 caches), rep 3, 5
    and 7 at D = 128, D = 72 (bf16, and int8 by element), 80, 96 and 320, and
    rep 8 at D = 128 as the control; B1/B2 and B4 at Falcon-7B's K = 4544
    (g64 and g32, M = 8 and 256, qkv, dense and gate_up; down at K = 18176
    the control), exact on integers; B5 at K = 4544, FFN = 18176; B8 at D =
    72, 80, 300, 320 and 1040 (the CUDA-core dkv and dq), bf16 and f32,
    forward and the three gradients (timed beside SDPA and the plain
    version). The whole model at Falcon-7B's widths is the families phase's
    Falcon-7B."""
    rec["attention"] = {}
    for name, *case in C6_ATTN:
        ok, row = _attn_row(gen, *case)
        rec["attention"][name] = row
        say(f"c6 attention {name}: tile {row['tile']} err {row['max_abs_err']:.3g}, "
            f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, plain {row['plain_ms']:.3f}, "
            f"SDPA {row['library_ms']})")
        if not ok:
            raise AssertionError(f"C6 decode attention {name}: {row}")
    rec["matmul_checks"] = []
    for group in C6_GROUPS:
        for name, (k, n) in C6_MATMULS.items():
            for m in C1_M:
                for a8 in (False, True):
                    ok, launches = _mm_case(gen, k, n, group, m, a8)
                    rec["matmul_checks"].append(dict(shape=name, k=k, n=n, group=group, m=m,
                                                     a8=a8, launches=launches, ok=ok))
                    if not ok:
                        raise AssertionError(f"C6 matmul {name} g{group} M={m} a8={a8}: inexact "
                                             f"or not through its kernel")
    rec["matmul_times"] = []  # through the raw launchers, as the table's rows
    time_matmuls(gen, 8, bw, rec["matmul_times"], group=64, shapes=C6_MATMULS)
    time_matmuls(gen, 256, bw, rec["matmul_times"], group=64, shapes=C6_MATMULS)
    time_a8(gen, 8, rec["matmul_times"], group=64, shapes=C6_MATMULS)
    for t in rec["matmul_times"]:
        say(f"c6 {t['kernel']} {t['shape']} K={t['k']} N={t['n']} M={t['m']} g64: "
            f"{t['ms']:.4f} ms (wrapper {t['wrapper_ms']:.4f}, bound {t['bound_ms']:.4f}, "
            f"plain {t['plain_ms']:.3f}, matmul {t['library_ms']:.4f})")
    k, f = FALCON["hidden"], FALCON["ffn"]
    rec["mlp"] = {}
    for group in C6_GROUPS:
        g, u, dn = (rand_stacked(gen, 1, a, b, BITS, False, group=group).layer(0)
                    for a, b in ((k, f), (k, f), (f, k)))
        for m in (8, 33):
            x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
            reset_counts()
            got = fm.fused_mlp(x, g, u, dn, block_f=f)
            counts = read_counts()
            want = fm.fused_mlp_plain(x, g, u, dn, block_f=f)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            row = dict(group=group, m=m, max_abs_err=err / scale, launches=counts["fused_mlp"])
            if m == 8 and group == 64:
                stats = (2 * (k // group) * f + (f // group) * k) * 8  # f32 scales, szeros
                nbytes = (2 * k * f + f * k) * BITS / 8 + stats + 2 * m * k * 2
                b, by = bound_ms(nbytes, 2.0 * m * 3 * k * f)
                wg, wu, wd = (dequantize_linear(t, torch.bfloat16) for t in (g, u, dn))
                row.update(
                    ms=cuda_ms(lambda i: fm.fused_mlp(x, g, u, dn, block_f=f), 20),
                    plain_ms=cuda_ms(lambda i: fm.fused_mlp_plain(x, g, u, dn, block_f=f), 1,
                                     reps=2),
                    library_ms=cuda_ms(lambda i: torch.matmul(
                        torch.nn.functional.silu(x @ wg) * (x @ wu), wd), 20),
                    bound_ms=b, bound_by=by)
                del wg, wu, wd
            rec["mlp"][f"g{group}_m{m}"] = row
            if not (counts["fused_mlp"] == 1 and err <= MLP_TOL * scale):
                raise AssertionError(f"C6 fused MLP g{group} M={m}: {row}")
        del g, u, dn
    say(f"c6 fused MLP K={k} FFN={f}: {rec['mlp']}")
    rec["train_attention"] = {}
    for name, (b, s, hq, hkv, d, pad) in C6_TA.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, kk, v, do, mask = _ta_inputs(gen, b, s, hq, hkv, d, pad, dtype)
            reset_counts()
            got = _ta_run(ta.flash_train_attention, q, kk, v, do, mask)
            counts = read_counts()
            want = _ta_run(ta.flash_train_attention_plain, q, kk, v, do, mask)
            tol = TRAIN_ATTN_TOL_F32 if dtype == torch.float32 else TRAIN_ATTN_TOL
            errs = {}
            for tname, g, w in zip(("out", "dq", "dk", "dv"), got, want):
                g, w = g.float(), w.float()
                if tname in ("out", "dq"):
                    keep = mask.bool()[..., None, None]
                    g, w = g * keep, w * keep
                errs[tname] = (g - w).abs().max().item() / w.abs().max().item()
            launched = [counts[c] for c in ("train_attn_fwd", "train_attn_bwd_dkv",
                                            "train_attn_bwd_dq")]
            dp = ta.padded_head_dim(d)
            qp, kp, vp, dop = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, kk, v, do))
            sc = 1.0 / math.sqrt(d)
            out, lse = ta.train_attn_fwd(qp, kp, vp, None, sc)
            di = (out.float() * dop.float()).sum(-1).contiguous()
            peak = PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
            unit = float(b) * hq * s * s * d
            row = dict(shape=(b, s, hq, hkv, d), padded_d=dp, dtype=str(dtype), rel_err=errs,
                       launches=launched, fwd_plan=ta.fwd_plan(b, s, hq, hkv, dp, dtype).kernel,
                       dkv_plan=ta.dkv_plan(b, s, hq, hkv, dp, dtype).kernel,
                       dq_plan=ta.dq_plan(b, s, hq, hkv, dp, dtype).kernel,
                       fwd_ms=cuda_ms(lambda i: ta.train_attn_fwd(qp, kp, vp, None, sc), 5),
                       dkv_ms=cuda_ms(lambda i: ta.train_attn_bwd_dkv(qp, kp, vp, None, dop, lse,
                                                                      di, sc), 5),
                       dq_ms=cuda_ms(lambda i: ta.train_attn_bwd_dq(qp, kp, vp, None, dop, lse,
                                                                    di, sc), 5),
                       fwd_bound_ms=2 * unit / peak * 1e3, dkv_bound_ms=4 * unit / peak * 1e3,
                       dq_bound_ms=3 * unit / peak * 1e3)
            # SDPA on the same padded inputs, the real D's scale and the timed calls'
            # mask (causal, no segments): its forward, and fwd+bwd less fwd
            qt, kt, vt = (t.transpose(1, 2) for t in (qp, kp, vp))
            sdpa = lambda a, bb, c: torch.nn.functional.scaled_dot_product_attention(
                a, bb, c, is_causal=True, enable_gqa=True, scale=sc)

            def lib_fb(i):
                a, bb, c = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
                sdpa(a, bb, c).backward(dop.transpose(1, 2))

            # by device time too: events of these short calls move with the host
            row["device_ms"] = dev = {kind: device_ms(fn, 5) for kind, fn in (
                ("fwd", lambda i: ta.train_attn_fwd(qp, kp, vp, None, sc)),
                ("dkv", lambda i: ta.train_attn_bwd_dkv(qp, kp, vp, None, dop, lse, di, sc)),
                ("dq", lambda i: ta.train_attn_bwd_dq(qp, kp, vp, None, dop, lse, di, sc)),
                ("sdpa_fwd", lambda i: sdpa(qt, kt, vt)), ("sdpa_fwd_bwd", lib_fb))}
            dev["sdpa_bwd"] = (None if None in (dev["sdpa_fwd"], dev["sdpa_fwd_bwd"])
                               else dev["sdpa_fwd_bwd"] - dev["sdpa_fwd"])
            row["sdpa_fwd_ms"] = cuda_ms(lambda i: sdpa(qt, kt, vt), 5)
            row["sdpa_fwd_bwd_ms"] = cuda_ms(lib_fb, 5)
            row["sdpa_bwd_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
            # the plain version on the same inputs: its forward, and fwd+bwd less fwd
            plain = lambda a, bb, c, m: ta.flash_train_attention_plain(a, bb, c, m, scale=sc)
            row["plain_fwd_ms"] = cuda_ms(lambda i: plain(qp, kp, vp, None), 2, reps=3)
            row["plain_bwd_ms"] = cuda_ms(lambda i: _ta_run(plain, qp, kp, vp, dop, None), 2,
                                          reps=3) - row["plain_fwd_ms"]
            rec["train_attention"][f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}"] = row
            say(f"c6 train attention {name} {dtype}: errs {errs}, plans {row['fwd_plan']}/"
                f"{row['dkv_plan']}/{row['dq_plan']}, fwd {row['fwd_ms']:.4f} dkv "
                f"{row['dkv_ms']:.4f} dq "
                f"{row['dq_ms']:.4f} ms (bounds {row['fwd_bound_ms']:.4f}, "
                f"{row['dkv_bound_ms']:.4f}, {row['dq_bound_ms']:.4f}); SDPA fwd "
                f"{row['sdpa_fwd_ms']:.4f}, bwd {row['sdpa_bwd_ms']:.4f}; plain fwd "
                f"{row['plain_fwd_ms']:.4f}, bwd {row['plain_bwd_ms']:.4f}; device time "
                f"{row['device_ms']}")
            if launched != [1, 1, 1] or not all(e <= tol for e in errs.values()):
                raise AssertionError(f"C6 train attention {name} {dtype}: {row}")
            del q, kk, v, do, got, want, qp, kp, vp, dop, out, lse, di, qt, kt, vt


# ---- families (A2): every ModelConfig flag through the port's packed serving path ----

FAMILY_NEW = 16  # new tokens a request
FALCON_GROUP = 64  # g128 does not divide Falcon-7B's 4544
# One HF config.json dict a family, with the widths of the model's public config.json,
# parsed by the port's from_hf_config; cut to `layers` (depth only) and served at
# int2-g128 through the Engine, 8 requests of 16 new tokens.
FAMILIES = {  # name: (dict, source, layers kept, KV cache rows, prompt lengths, A8 too)
    # ALiBi and LayerNorm, a plain GELU MLP: the decode attention through
    # cached_attention (JAX's flash_ok excludes ALiBi), matmuls through B1/B2
    "mpt7b": (dict(model_type="mpt", vocab_size=50432, d_model=4096, n_layers=32, n_heads=32,
                   expansion_ratio=4, max_seq_len=2048, attn_config={"alibi": True}),
              "huggingface.co/mosaicml/mpt-7b", 2, 1024, REQ_LENS[:8], False),
    # q/k norms, GQA rep 4 at D = 128 (B3's own instance), untied 151936 rows
    "qwen3_8b": (dict(model_type="qwen3", vocab_size=151936, hidden_size=4096,
                      intermediate_size=12288, num_hidden_layers=36, num_attention_heads=32,
                      num_key_value_heads=8, head_dim=128, rope_theta=1000000.0,
                      max_position_embeddings=40960, rms_norm_eps=1e-6, attention_bias=False,
                      tie_word_embeddings=False),
                 "huggingface.co/Qwen/Qwen3-8B", 2, 1024, REQ_LENS[:8], False),
    # q/k/v biases: packed alone with their biases (B1, B2, B4's epilogue under
    # A8); GQA rep 7 (B3's general route); untied 152064 rows
    "qwen2_7b": (dict(model_type="qwen2", vocab_size=152064, hidden_size=3584,
                      intermediate_size=18944, num_hidden_layers=28, num_attention_heads=28,
                      num_key_value_heads=4, rope_theta=1000000.0,
                      max_position_embeddings=131072, rms_norm_eps=1e-6,
                      use_sliding_window=False, sliding_window=131072,
                      tie_word_embeddings=False),
                 "huggingface.co/Qwen/Qwen2-7B", 2, 1024, REQ_LENS[:8], True),
    # a uniform window of 2047 that two prompts and the decode run past: B3's
    # window route (rep 1, D = 96: the general route)
    "phi3_mini_4k": (dict(model_type="phi3", vocab_size=32064, hidden_size=3072,
                          intermediate_size=8192, num_hidden_layers=32, num_attention_heads=32,
                          num_key_value_heads=32, max_position_embeddings=4096,
                          original_max_position_embeddings=4096, rope_theta=10000.0,
                          rms_norm_eps=1e-5, sliding_window=2047, tie_word_embeddings=False),
                     "huggingface.co/microsoft/Phi-3-mini-4k-instruct", 2, 4096,
                     [2100, 3000] + REQ_LENS[:6], False),
    # one whole period of the pattern (5 sliding layers with the local theta,
    # 1 global with linear rope scaling x8): per-layer sliding sends the decode
    # attention through cached_attention; sandwich and q/k norms, the unit norm
    # offset, the sqrt(2560) embedding multiplier, gelu_tanh, tied 262208 rows
    "gemma3_4b": (dict(model_type="gemma3_text", vocab_size=262208, hidden_size=2560,
                       intermediate_size=10240, num_hidden_layers=34, num_attention_heads=8,
                       num_key_value_heads=4, head_dim=256, rms_norm_eps=1e-6,
                       rope_theta=1000000.0, rope_local_base_freq=10000.0,
                       rope_scaling={"rope_type": "linear", "factor": 8.0}, sliding_window=1024,
                       sliding_window_pattern=6, max_position_embeddings=131072,
                       query_pre_attn_scalar=256, hidden_activation="gelu_pytorch_tanh",
                       # from_hf_config reads only `hidden_act` (ROADMAP C4: a config
                       # with the published key alone parses to silu), so it is stated too
                       hidden_act="gelu_pytorch_tanh"),
                  "huggingface.co/google/gemma-3-4b-it (text_config)", 6, 1024, REQ_LENS[:8],
                  False),
}


def family_config(name):
    """The port's from_hf_config on the family's dict, cut to its depth."""
    hf, _, layers = FAMILIES[name][:3]
    cfg = ModelConfig.from_hf_config(hf)
    return dataclasses.replace(cfg, num_layers=layers, sliding_layers=(
        cfg.sliding_layers[:layers] if cfg.sliding_layers else None))


def plain_reference(params, a8: bool):
    """The tree the plain path reads: under A16 the scales the kernels decode
    from the combo words; under A8 the f32 scales both read."""
    if a8:
        return params
    ref = dict(params, layers=dict(params["layers"]))
    for name, leaf in params["layers"].items():
        if isinstance(leaf, PackedLinear):
            s, sz = scales_from_combo(leaf.combo)
            ref["layers"][name] = dataclasses.replace(leaf, scales=s, szeros=sz)
    return ref


def step_with_linear_checks(params, ref_params, cfg, tok, cache, pos):
    """One decode step through the kernels, each packed linear of it also
    run through its plain version (on `ref_params`' leaf) on the same input:
    (logits, the worst max|kernel - plain| / max|plain| over the linears,
    the linears checked)."""
    refs = {id(leaf): ref_params["layers"][name] for name, leaf in params["layers"].items()}
    errs = []
    real = llama_mod.linear

    def checked(leaf, x, li=None, *, use_kernels=True, quantizer=None):
        out = real(leaf, x, li, use_kernels=use_kernels, quantizer=quantizer)
        if isinstance(leaf, PackedLinear):
            want = real(refs[id(leaf)], x, li, use_kernels=False).float()
            err = (out.float() - want).abs().max().item() / want.abs().max().item()
            errs.append(err if err == err else math.inf)  # NaN fails
        return out

    llama_mod.linear = checked
    try:
        logits, _ = forward(params, cfg, tok, cache=cache, cache_pos=pos)
    finally:
        llama_mod.linear = real
    return logits, max(errs, default=math.inf), len(errs)


def moved_off_unit(dense):
    """Every bias off zero and every norm off one (a LayerNorm's bias off
    zero) by N(0, NOISE^2) from seed 1, in place, as the CPU tests'
    parameters: a kernel that dropped a bias, or added it in the wrong
    column or at the wrong scale, then fails the per-linear check."""
    gen = torch.Generator(device=DEV).manual_seed(1)

    def move(t):
        t.add_((NOISE * torch.randn(t.shape, generator=gen, device=DEV)).to(t.dtype))

    with torch.no_grad():
        for tree in (dense, dense["layers"]):
            for name, leaf in tree.items():
                if name.endswith("norm"):
                    for t in leaf.values() if isinstance(leaf, dict) else (leaf,):
                        move(t)
                elif isinstance(leaf, dict) and "b" in leaf:
                    move(leaf["b"])
    return dense


def ulp_spread(ref_params, cfg, tok, cache, pos, logits):
    """The plain path against itself with its input moved by one bf16 ulp:
    the step's tokens' embedding rows one ulp larger in magnitude. Returns
    max|moved - logits| / max|logits|."""
    embed = ref_params["embed"].clone()
    rows = embed[tok[:, 0]]
    bits = {2: torch.int16, 4: torch.int32}[rows.element_size()]
    embed[tok[:, 0]] = (rows.view(bits) + 1).view(rows.dtype)
    moved, _ = forward(dict(ref_params, embed=embed), cfg, tok, cache=cache, cache_pos=pos,
                       use_kernels=False)
    return (moved - logits).abs().max().item() / logits.abs().max().item()


def serve_family(params, cfg, tag, rows, lens, a8, card, out, group, timed=False):
    """8 requests through the Engine (A8: the switch set for this call only;
    the Engine repacks), every packed matmul through B1 (prefill) and B2
    (decode), or B4 under A8, and the decode attention through B3 exactly
    where the JAX package's flash_ok holds, as the launch counts (reset just
    before, read just after) show. Then one decode step through the kernels:
    each packed linear of it against its plain version on the same input
    within MATMUL_TOL, and the step's logits against the plain path within
    LOGIT_TOL relative to max|logit|. Under A8 the tolerance is the larger
    of LOGIT_TOL and A8_SPREADS times the plain A8 path's own spread when
    its input moves by one bf16 ulp (`ulp_spread`): per-token int8 codes
    follow each row's maximum, so a rounding anywhere upstream moves whole
    rows of codes, and the kernel's rounding is such a move. With `timed`,
    the steady step's ms, idle share and byte bound."""
    saved = os.environ.get(qm.A8_ENV)
    os.environ[qm.A8_ENV] = "1" if a8 else "0"
    try:
        eng = Engine(params, cfg, max_slots=8, max_len=rows, eos_token_id=None,
                     sampling=SamplingParams(temperature=0.0), device=DEV)
        rng = np.random.default_rng(0)
        reqs = [Request(prompt_tokens=rng.integers(3, cfg.vocab_size, n).tolist(),
                        max_new_tokens=FAMILY_NEW) for n in lens]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
    finally:
        if saved is None:
            os.environ.pop(qm.A8_ENV, None)
        else:
            os.environ[qm.A8_ENV] = saved
    params = eng.params
    L, steps, prefills = cfg.num_layers, eng.decode_steps, eng.prefills
    n_lin = sum(isinstance(leaf, PackedLinear) for leaf in params["layers"].values())
    if not all(r.finished and len(r.output_tokens) == FAMILY_NEW for r in reqs):
        raise AssertionError(f"{tag}: not every request finished with {FAMILY_NEW} tokens")
    want = dict(qmm_decode=0, qmm_prefill=0, qmm_a8=0, qmm_a8_prefill=0)
    if a8:
        want.update(qmm_a8=n_lin * L * (steps + prefills), qmm_a8_prefill=n_lin * L * prefills)
    else:
        want.update(qmm_decode=n_lin * L * steps, qmm_prefill=n_lin * L * prefills)
    flash_ok = not cfg.alibi and not (cfg.sliding_layers and cfg.sliding_window)
    want["flash_decode"] = steps * L if flash_ok else 0
    got = {k: counts[k] for k in want}
    if got != want or prefills < 1 or steps < FAMILY_NEW - 1:
        raise AssertionError(f"{tag}: launches {got}, want {want} ({n_lin} packed linears a "
                             f"layer, {L} layers, {prefills} prefills, {steps} decode steps)")
    pos = torch.as_tensor(np.minimum(eng.lengths, rows - 20), dtype=torch.int32, device=DEV)
    tok = torch.randint(3, cfg.vocab_size, (8, 1), device=DEV)
    ref_params = plain_reference(params, a8)
    with torch.inference_mode():
        lk, lin_err, n_checked = step_with_linear_checks(params, ref_params, cfg, tok, eng.cache,
                                                         pos)
        lp, _ = forward(ref_params, cfg, tok, cache=eng.cache, cache_pos=pos, use_kernels=False)
        spread = ulp_spread(ref_params, cfg, tok, eng.cache, pos, lp) if a8 else None
        a16 = None
        if a8:  # the plain path at A16: A8's own quantization error, for the record
            l16, _ = forward(plain_reference(params, False), cfg, tok, cache=eng.cache,
                             cache_pos=pos, use_kernels=False)
            a16 = (l16 - lp).abs().max().item()
    err, ref = (lk - lp).abs().max().item(), lp.abs().max().item()
    tol = LOGIT_TOL if spread is None else max(LOGIT_TOL, A8_SPREADS * spread)
    out.update(layers=L, packed_linears=n_lin, prefills=prefills, decode_steps=steps,
               launches={k: v for k, v in counts.items() if v}, wall_s=wall,
               logit_max_abs_err=err, logit_max=ref, linear_max_rel_err=lin_err,
               logit_tol=tol, ulp_spread=spread, plain_a8_vs_a16_max_abs=a16,
               argmax_agreement=(lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
    if (not torch.isfinite(lk).all() or n_checked != n_lin * L
            or not lin_err <= MATMUL_TOL):
        raise AssertionError(f"{tag}: a packed linear of the decode step disagrees with its "
                             f"plain version on the same input ({lin_err} relative, "
                             f"{n_checked} of {n_lin * L} linears checked)")
    if not err <= tol * ref:
        raise AssertionError(f"{tag}: one step's logits disagree with the plain path "
                             f"({err} of {ref}, tol {tol} relative; one-ulp spread {spread})")
    say(f"{tag}: {len(reqs)} requests (prompts {lens}), {L} layers, {n_lin} packed linears a "
        f"layer, {prefills} prefills, {steps} decode steps, launches {out['launches']}; one "
        f"step's packed linears vs plain on their inputs {lin_err:.3g} relative (tol "
        f"{MATMUL_TOL}); its logits vs the plain path {err:.4g} of {ref:.4g} (tol {tol:.4g} "
        "relative" + ("" if spread is None else
                      f"; the plain A8 path moved by one input ulp {spread:.4g} relative, "
                      f"against plain A16 {a16:.4g}") + ")")
    if timed:
        def step(i):
            forward(params, cfg, tok, cache=eng.cache, cache_pos=pos + i)

        with torch.inference_mode():
            ms = cuda_ms(step, 8, reps=3)
            busy = device_busy_ms(step, 4)
        nbytes = step_bytes(cfg, BITS, [int(p) + 4 for p in pos.tolist()],
                            group_bytes=8 if a8 else 4, group=group)
        idle = None if busy is None else 1 - busy["busy_ms"] / ms
        out.update(decode_ms_per_step=ms, step_bytes=nbytes,
                   step_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, idle_share=idle,
                   busy_ms=None if busy is None else busy["busy_ms"],
                   top=None if busy is None else busy["top"])
        say(f"{tag} decode: {ms:.3f} ms/step at batch 8, idle share "
            f"{'not measured' if idle is None else f'{idle:.3f}'}, {nbytes / 1e9:.3f} GB/step -> "
            f"bound {nbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s ({card})"
            + ("" if busy is None else f"; device busy {busy['busy_ms']:.3f} ms, top: "
               + ", ".join(f"{k} {v:.3f}" for k, v in busy["top"][:5])))
    return eng


def falcon_prefill_decode_check(params, cfg, out):
    """One request through the cache with the kernels (its 64-token prompt
    prefilled into a 1-slot cache, then one decode step: B1, B2, B3) against
    the plain cache-less forward over the same 65 tokens. Tolerance
    LOGIT_TOL relative to max|logit|, as the decode step's: the same bf16
    rounding of every matmul output in another order, compounded over 32
    layers, plus the decode attention's bf16 probabilities; the bf16 cache
    holds the same bf16 k/v the cache-less path attends to."""
    toks = torch.as_tensor(np.random.default_rng(1).integers(3, cfg.vocab_size, 65),
                           device=DEV)[None]
    with torch.inference_mode():
        cache = KVCache.init(cfg, 1, 128, device=DEV)
        reset_counts()
        forward(params, cfg, toks[:, :64], cache=cache, cache_pos=0)
        lk, _ = forward(params, cfg, toks[:, 64:], cache=cache, cache_pos=64)
        counts = read_counts()
        lp, _ = forward(plain_reference(params, False), cfg, toks, use_kernels=False)
    lk, lp = lk[0, -1], lp[0, -1]
    err, ref = (lk - lp).abs().max().item(), lp.abs().max().item()
    out.update(logit_max_abs_err=err, logit_max=ref, launches={k: v for k, v in counts.items()
                                                                if v})
    if (counts["qmm_prefill"] < cfg.num_layers or counts["flash_decode"] != cfg.num_layers
            or not torch.isfinite(lk).all() or not err <= LOGIT_TOL * ref):
        raise AssertionError(f"Falcon-7B prefill then cached decode vs the plain cache-less "
                             f"forward: {err} of {ref}, launches {counts}")
    say(f"falcon7b prefill (64 tokens) then cached decode vs plain cache-less forward: "
        f"{err:.4g} of {ref:.4g} (tol {LOGIT_TOL} relative); launches {out['launches']}")


def families_phase(card, rec):
    """(a) Falcon-7B whole (FALCON_7B, 32 layers, full width), int2-g64:
    init_params then pack_model on the card (LayerNorm dicts, a plain MLP:
    qkv, o, up, down), served A16 then A8 with the launch counts, one
    step's logits and the decode timing; and one request's prefill and
    cached decode against the plain cache-less forward. (b) MPT-7B,
    Qwen3-8B, Qwen2-7B (A16 and A8), Phi-3-mini-4k and Gemma-3-4B at full
    width and reduced depth, int2-g128, each through the Engine with its
    launch counts and one step's logits. Random weights from seed 0, the
    biases and norms then moved off zero and one (`moved_off_unit`)."""
    cfg = FALCON_7B
    dense = moved_off_unit(init_params(cfg, seed=0, device=DEV))
    t0 = time.time()
    params = pack_model(dense, cfg, BITS, FALCON_GROUP)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    del dense
    torch.cuda.empty_cache()
    rec["falcon7b"] = fal = dict(pack_s=pack_s, layers=sorted(
        k for k, v in params["layers"].items() if isinstance(v, PackedLinear)))
    say(f"falcon7b: FALCON_7B, {cfg.num_layers} layers, packed int2-g{FALCON_GROUP} on the card "
        f"in {pack_s:.1f} s; packed linears {fal['layers']}")
    for a8 in (False, True):
        tag = "A8" if a8 else "A16"
        fal[tag] = {}
        eng = serve_family(params, cfg, f"falcon7b {tag}", 1024, REQ_LENS[:8], a8, card,
                           fal[tag], FALCON_GROUP, timed=True)
        del eng
    fal["prefill_decode"] = {}
    falcon_prefill_decode_check(params, cfg, fal["prefill_decode"])
    del params
    torch.cuda.empty_cache()
    for name, (hf, source, layers, rows, lens, with_a8) in FAMILIES.items():
        cfg = family_config(name)
        dense = moved_off_unit(init_params(cfg, seed=0, device=DEV))
        params = pack_model(dense, cfg, BITS, GROUP)
        del dense
        rec[name] = fam = dict(source=source, layers=layers, cache_rows=rows, prompts=lens)
        for a8 in (False, True) if with_a8 else (False,):
            tag = "A8" if a8 else "A16"
            fam[tag] = {}
            eng = serve_family(params, cfg, f"{name} {tag} ({source}, {layers} of "
                                            f"{hf.get('num_hidden_layers', hf.get('n_layers'))} "
                                            f"layers)", rows, lens, a8, card, fam[tag], GROUP)
            if name == "phi3_mini_4k":
                # the window bites: slots run past 2047 rows, and the plain path
                # without the window gives other logits
                pos = torch.as_tensor(np.minimum(eng.lengths, rows - 20), dtype=torch.int32,
                                      device=DEV)
                tok = torch.randint(3, cfg.vocab_size, (8, 1), device=DEV)
                nowin = dataclasses.replace(cfg, sliding_window=None)
                ref = plain_reference(eng.params, a8)
                with torch.inference_mode():
                    lw, _ = forward(ref, cfg, tok, cache=eng.cache, cache_pos=pos,
                                    use_kernels=False)
                    ln, _ = forward(ref, nowin, tok, cache=eng.cache, cache_pos=pos,
                                    use_kernels=False)
                fam["window_moves_logits"] = (lw - ln).abs().max().item()
                if int(pos.max()) <= cfg.sliding_window or not fam["window_moves_logits"] > 0:
                    raise AssertionError(f"phi3: the window did not bite ({pos.tolist()}, "
                                         f"{fam['window_moves_logits']})")
                say(f"phi3_mini_4k: slots at {pos.tolist()} past the window of "
                    f"{cfg.sliding_window}; the window moves the logits by "
                    f"{fam['window_moves_logits']:.4g}")
            del eng
        del params
        torch.cuda.empty_cache()


# ---- B8: the training flash attention --------------------------------------------

TRAIN_ATTN_TOL = 2e-2  # bf16: p and ds enter their products in bf16, the plain version f32
TRAIN_ATTN_TOL_F32 = 1e-4
TA_CASES = {  # name: (B, S, Hq, Hkv, D, padded row length or None, dtype)
    "tinyllama": (2, 1024, 32, 4, 64, 900, torch.bfloat16),
    "llama2_7b": (1, 2048, 32, 32, 128, None, torch.bfloat16),
    "ragged": (2, 1000, 8, 2, 64, 700, torch.bfloat16),
    "f32": (1, 300, 8, 2, 64, 250, torch.float32),
    # the two models' attention in f32 (cfg.dtype float32, the CLI's --dtype float32)
    "tinyllama_f32": (2, 1024, 32, 4, 64, 900, torch.float32),
    "llama2_7b_f32": (1, 2048, 32, 32, 128, None, torch.float32),
    "mqa71": (1, 1000, 71, 1, 64, 900, torch.bfloat16),  # FALCON_7B's heads: 71 % 8 != 0
    "d256": (1, 1000, 16, 16, 256, 900, torch.bfloat16),  # the wide dkv (D > 128), MHA
    # Gemma-2B's attention widths (8 query heads over 1 kv head, head_dim 256) at
    # the train phase's 2 x 1024 micro-batch: the wide dkv on clusters of 8
    "d256_mqa": (2, 1024, 8, 1, 256, 900, torch.bfloat16),
    # the same in f32: the forward, dkv and dq on 3xTF32 splits of 2 CTAs
    "d256_f32": (2, 1024, 8, 1, 256, 900, torch.float32),
    # D = 512 in f32 (no preset has it): the three on 3xTF32 splits of 4 CTAs
    # (dkv clusters of 8 at rep 4)
    "d512_f32": (1, 1024, 8, 2, 512, 900, torch.float32),
    # D = 1024, short: the splits of 8 CTAs, the portable cluster's edge
    "d1024_f32": (1, 256, 4, 4, 1024, 200, torch.float32),
}
F32_TIMED = ("f32", "tinyllama_f32", "llama2_7b_f32", "d256_f32", "d512_f32", "d1024_f32")
SPLIT_TIMED = ("d256_f32", "d512_f32", "d1024_f32")  # the f32 cases on the splits


def _ta_inputs(gen, b, s, hq, hkv, d, pad, dtype):
    q = torch.randn((b, s, hq, d), device=DEV, generator=gen).to(dtype)
    k = torch.randn((b, s, hkv, d), device=DEV, generator=gen).to(dtype)
    v = torch.randn((b, s, hkv, d), device=DEV, generator=gen).to(dtype)
    do = torch.randn((b, s, hq, d), device=DEV, generator=gen).to(dtype)
    mask = None
    if pad is not None:
        mask = torch.ones((b, s), dtype=torch.int32, device=DEV)
        mask[0, pad:] = 0
    return q, k, v, do, mask


def _ta_run(fn, q, k, v, do, mask):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, mask)
    out.backward(do)
    return out.detach(), q.grad, k.grad, v.grad


def device_ms(fn, n: int, tries: int = 3):
    """Device time of one call of fn, not paced by the host as a CUDA-event
    time of a host-bound call is: the kernels' self device time in a
    torch.profiler trace of n calls (device_busy_ms), over n. A trace that
    records no device time is taken again (with twice the calls, up to
    `tries` traces; seen on the H100 machine after earlier traces in the
    same process); None, said, if none does."""
    fn(0)
    torch.cuda.synchronize()
    for t in range(tries):
        got = device_busy_ms(fn, n << t)
        if got is not None:
            return got["busy_ms"]
    say(f"  profiler: no device time in {tries} traces; device time not measured")
    return None


def train_attention_phase(gen, record):
    """B8's forward and its three gradients against
    flash_train_attention_plain at TA_CASES (pad rows compared under the
    mask: garbage in both), and the dq kernel by itself ("dq_alone") against
    train_attn_bwd_dq_plain and against autograd's dq of the plain version,
    on the kernel forward's lse and di; then its times at TinyLlama's, 7B's
    and the two D = 256 cases' shapes, and in f32 at the f32 case's, the
    two models' and Gemma-2B's heads (`d256_f32`: the forward, dkv and dq on
    the 3xTF32 splits of 2 CTAs), at D = 512 (`d512_f32`: the splits of 4
    CTAs) and at D = 1024 (`d1024_f32`, a short S: the splits of 8):
    the forward, dkv and dq kernels one by one through their wrappers, the
    plain version's forward and forward+backward, and SDPA
    (scaled_dot_product_attention(is_causal=True, enable_gqa=True), the
    unpadded yardstick) forward and forward+backward. Bounds: causal
    operations over PEAK_BF16_FLOPS, B*Hq*S^2*D flops a product of half the
    score matrix: 2 products forward, 4 in dkv (the s recompute, dp, dv,
    dk), 3 in dq (s, dp, dq); the f32 cases' (f32, and the two models'
    attention in f32) over PEAK_TF32X3_FLOPS, with the CUDA-core figure at
    PEAK_F32_FLOPS beside, against SDPA in f32. bwd_ms is dkv_ms + dq_ms,
    beside SDPA's backward. Every kernel and SDPA time is also read as device
    time from a profiler trace of the timed calls (device_ms). Each time row
    carries the dkv and dq plans (kernel, cluster, CTAs)."""
    worst = {}
    for name, case in TA_CASES.items():
        q, k, v, do, mask = _ta_inputs(gen, *case)
        got = _ta_run(ta.flash_train_attention, q, k, v, do, mask)
        want = _ta_run(ta.flash_train_attention_plain, q, k, v, do, mask)
        tol = TRAIN_ATTN_TOL_F32 if case[-1] == torch.float32 else TRAIN_ATTN_TOL
        errs = {}
        for tname, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            if mask is not None and tname in ("out", "dq"):
                keep = mask.bool()[..., None, None]
                g, w = g * keep, w * keep
            errs[tname] = (g - w).abs().max().item() / w.abs().max().item()
        seg = None if mask is None else mask.to(torch.int32).contiguous()
        out, lse = ta.train_attn_fwd(q, k, v, seg)
        di = (out.float() * do.float()).sum(-1).contiguous()
        dq = ta.train_attn_bwd_dq(q, k, v, seg, do, lse, di).float()
        keep = 1 if mask is None else mask.bool()[..., None, None]
        for tname, w in (("dq_alone", ta.train_attn_bwd_dq_plain(q, k, v, seg, do, lse, di)),
                         ("dq_alone_autograd", want[1])):
            w = w.float() * keep
            errs[tname] = (dq * keep - w).abs().max().item() / w.abs().max().item()
        ok = all(e <= tol for e in errs.values())
        record.append(dict(case=name, shape=case[:6], dtype=str(case[-1]), rel_err=errs, tol=tol,
                           ok=ok))
        if not ok:
            raise AssertionError(f"train attention {name}: relative errors {errs} (tol {tol})")
        worst[name] = max(errs.values())
        del q, k, v, do, got, want, out, lse, di, dq
    times = {}
    for name in ("tinyllama", "llama2_7b", "d256", "d256_mqa") + F32_TIMED:
        b, s, hq, hkv, d, pad, dtype = TA_CASES[name]
        f32 = dtype == torch.float32
        peak = PEAK_TF32X3_FLOPS if f32 else PEAK_BF16_FLOPS
        plan, qplan = ta.dkv_plan(b, s, hq, hkv, d, dtype), ta.dq_plan(b, s, hq, hkv, d, dtype)
        fplan = ta.fwd_plan(b, s, hq, hkv, d, dtype)
        q, k, v, do, mask = _ta_inputs(gen, b, s, hq, hkv, d, None, dtype)
        seg = None
        out, lse = ta.train_attn_fwd(q, k, v, seg)
        di = (out.float() * do.float()).sum(-1).contiguous()
        fwd_fn = lambda i: ta.train_attn_fwd(q, k, v, seg)
        dkv_fn = lambda i: ta.train_attn_bwd_dkv(q, k, v, seg, do, lse, di)
        dq_fn = lambda i: ta.train_attn_bwd_dq(q, k, v, seg, do, lse, di)
        fwd, dkv, dq = (cuda_ms(fn, 10) for fn in (fwd_fn, dkv_fn, dq_fn))
        fb = cuda_ms(lambda i: _ta_run(ta.flash_train_attention, q, k, v, do, None), 5)
        plain_f = cuda_ms(lambda i: ta.flash_train_attention_plain(q, k, v), 2, reps=3)
        plain_fb = cuda_ms(lambda i: _ta_run(ta.flash_train_attention_plain, q, k, v, do, None),
                           2, reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda a, bb, c: torch.nn.functional.scaled_dot_product_attention(
            a, bb, c, is_causal=True, enable_gqa=True)
        lib_f_fn = lambda i: sdpa(qt, kt, vt)

        def lib_fb(i):
            a, bb, c = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
            sdpa(a, bb, c).backward(do.transpose(1, 2))

        lib_f = cuda_ms(lib_f_fn, 10)
        lib_fb_ms = cuda_ms(lib_fb, 5)
        # the same calls by device time (profiler): SDPA's backward is its
        # forward+backward less its forward
        dev = {key: device_ms(fn, 5) for key, fn in (
            ("fwd", fwd_fn), ("dkv", dkv_fn), ("dq", dq_fn), ("sdpa_fwd", lib_f_fn),
            ("sdpa_fwd_bwd", lib_fb))}
        known = lambda a, c: dev[a] is not None and dev[c] is not None
        dev["sdpa_bwd"] = (dev["sdpa_fwd_bwd"] - dev["sdpa_fwd"]
                           if known("sdpa_fwd_bwd", "sdpa_fwd") else None)
        dev["bwd"] = dev["dkv"] + dev["dq"] if known("dkv", "dq") else None
        unit = float(b) * hq * s * s * d  # flops of one causal product
        times[name] = dict(
            shape=(b, s, hq, hkv, d), dtype=str(dtype), fwd_ms=fwd, dkv_ms=dkv, dq_ms=dq,
            bwd_ms=dkv + dq, fwd_bwd_ms=fb,
            plain_fwd_ms=plain_f, plain_fwd_bwd_ms=plain_fb, plain_bwd_ms=plain_fb - plain_f,
            sdpa_fwd_ms=lib_f, sdpa_fwd_bwd_ms=lib_fb_ms, sdpa_bwd_ms=lib_fb_ms - lib_f,
            device_ms=dev,
            fwd_bound_ms=2 * unit / peak * 1e3, dkv_bound_ms=4 * unit / peak * 1e3,
            dq_bound_ms=3 * unit / peak * 1e3,
            dkv_plan=dict(kernel=plan.kernel, cluster=plan.cluster, ctas=plan.ctas),
            dq_plan=dict(kernel=qplan.kernel, cluster=qplan.cluster, ctas=qplan.ctas),
            fwd_plan=dict(kernel=fplan.kernel, cluster=fplan.cluster, ctas=fplan.ctas))
        if f32:  # beside the 3xTF32 bounds: the same operations on the CUDA cores
            times[name].update(
                {f"{kind}_cores_bound_ms": n * unit / PEAK_F32_FLOPS * 1e3
                 for kind, n in (("fwd", 2), ("dkv", 4), ("dq", 3))})
        del q, k, v, do, out, lse, di
    return worst, times


# ---- the training path: KD-QAT on TinyLlama-1.1B --------------------------------

# The first micro-step through B8 against the plain attention, relative; about
# 10x the largest readings of sound runs on the H100 (PERF.md): loss 2.1e-5,
# global gradient norm 1.9e-4 (22 bf16 layers, bf16 p and ds against f32).
TRAIN_LOSS_TOL = 5e-4
TRAIN_GNORM_TOL = 2e-3
# The gradient norms of the q, k and v projections of the first and the last
# layer, which B8's backward kernels move directly: about 10x the largest
# reading, 1.8e-3 (the last layer's k).
TRAIN_ATTN_GRAD_TOL = 2e-2


class ByteTok:
    """Byte-level tokenizer (ids 3..252), as the JAX package's tests' FakeTok."""

    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


def write_teacher_jsonl(path: Path, n: int = 10, seed: int = 0) -> None:
    """n synthetic [[prompt, reply]] lines, from a seed: all but one longer
    than 1024 tokens (a full 2 x 1024 micro-batch), one of 900 (a padded row)."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "kernel", "tensor", "group", "scale", "bits",
             "teacher", "student", "quant", "cache", "token", "layer", "norm"]
    with open(path, "w") as f:
        for i in range(n):
            length = 900 if i == 3 else 1400
            text = " ".join(rng.choice(words, size=length // 4))
            prompt, reply = text[: length // 3], text[length // 3: length - 4]
            f.write(json.dumps([[f"Q{i}: {prompt}", f" A: {reply}"]]) + "\n")


def train_args(data, out, **kw):
    """The JAX package's `train` CLI namespace for the smoke's run."""
    base = dict(
        model_name_or_path="(injected)", data_path=str(data), output_dir=str(out), bits=2,
        q_group_size=64, quant_type="int2-asym", clip=None, train_kd=True,
        kd_loss_type="cakld", cakld_steps=2, learning_rate=8e-6, num_train_epochs=1,
        per_device_train_batch_size=2, gradient_accumulation_steps=2, model_max_length=1024,
        max_train_samples=None, lr_scheduler_type="constant", warmup_ratio=0.0, save_steps=0,
        eval_steps=0, logging_steps=1, seed=0, dp=None, tp=1, resume=False,
        param_dtype="bfloat16", remat_policy="full", teacher_flash=True, device=DEV)
    base.update(kw)
    return types.SimpleNamespace(**base)


def first_step_check(params, cfg, data, rec):
    """The first micro-step's loss, global gradient norm and the gradient
    norms of the first and the last layer's q, k and v projections through B8
    (student and teacher flash) against the same step with the plain
    attention (flash off), from the same latents; no optimizer state is made.
    Then one flash micro-step (forward and backward, no optimizer) under
    torch.profiler: where its device time goes."""
    from bitdistiller_tpu_torch.train.data import Collator, SupervisedDataset, data_loader

    ds = SupervisedDataset.from_jsonl(str(data), ByteTok.eos_token, None, "train", 0)
    batch = tr.to_device(next(data_loader(ds, Collator(ByteTok(), 1024), 2, shuffle=True,
                                          seed=0)), DEV)
    last = cfg.num_layers - 1
    proj = [(li, name) for li in (0, last) for name in ("q", "k", "v")]

    def micro_step(flash):
        os.environ["BITDISTILLER_TRAIN_FLASH"] = "1" if flash else "0"
        tc = tr.TrainConfig(q_group_size=64, teacher_flash=flash)
        latent = tr._with_grad(tr.tree_map(lambda x: x.detach().clone(), params))
        loss = tr._kd_or_ce_loss(cfg, tc, latent, batch, 0.5, params,
                                 quantizer=tr.make_quantizer(tc), student_remat="full")
        return loss, tr._grads(loss, latent)

    out = {}
    for flash in (True, False):
        loss, grads = micro_step(flash)
        attn = {f"{name}{li}": grads["layers"][name]["w"][li].float().norm().item()
                for li, name in proj}
        out[flash] = (loss.item(), tr.global_norm(tr.tree_leaves(grads)).item(), attn)
        del grads, loss
        torch.cuda.empty_cache()
    (lf, gf, af), (lp, gp, ap) = out[True], out[False]
    attn_err = {k: abs(af[k] - ap[k]) / ap[k] for k in af}
    rec.update(first_step=dict(flash_loss=lf, plain_loss=lp, flash_grad_norm=gf,
                               plain_grad_norm=gp, flash_attn_grad_norms=af,
                               plain_attn_grad_norms=ap, attn_grad_rel_err=attn_err,
                               loss_rel_err=abs(lf - lp) / abs(lp),
                               grad_norm_rel_err=abs(gf - gp) / gp,
                               tokens=int(batch["attention_mask"].sum())))
    worst = max(attn_err, key=attn_err.get)
    say(f"train first micro-step: loss {lf:.5f} (B8) vs {lp:.5f} (plain attention), grad norm "
        f"{gf:.5f} vs {gp:.5f}; q/k/v grad norms of layers 0 and {last}: worst {worst} "
        f"{af[worst]:.5f} vs {ap[worst]:.5f} ({attn_err[worst]:.3g}); tol {TRAIN_LOSS_TOL} / "
        f"{TRAIN_GNORM_TOL} / {TRAIN_ATTN_GRAD_TOL} relative")
    if not (abs(lf - lp) <= TRAIN_LOSS_TOL * abs(lp) and abs(gf - gp) <= TRAIN_GNORM_TOL * gp
            and attn_err[worst] <= TRAIN_ATTN_GRAD_TOL):
        raise AssertionError("the first micro-step through B8 disagrees with the plain attention")
    busy = device_busy_ms(lambda i: micro_step(True), 1)
    os.environ.pop("BITDISTILLER_TRAIN_FLASH", None)
    torch.cuda.empty_cache()
    return busy


class CheckpointTimes:
    """Host seconds of the HF load and the final save that run_training makes
    itself: the pipeline module's two references, wrapped for one run (each
    call ends on a synchronised device)."""

    def __init__(self):
        self.s: dict = {}

    def _timed(self, name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.s[name] = time.time() - t0
            return out
        return call

    def __enter__(self):
        self.saved = (pipeline.load_hf_checkpoint, pipeline.save_hf_checkpoint)
        pipeline.load_hf_checkpoint = self._timed("load_f32_s", self.saved[0])
        pipeline.save_hf_checkpoint = self._timed("final_save_f32_s", self.saved[1])
        return self

    def __exit__(self, *exc):
        pipeline.load_hf_checkpoint, pipeline.save_hf_checkpoint = self.saved
        return False


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir() if f.suffix == ".safetensors")


def train_run(args, model=None) -> dict:
    """One run_training (peak memory reset before it); its summary, wall
    seconds, peak memory and metrics.jsonl, with each micro-step's and each
    cycle's ms. A micro-step's loss is read back before the next starts, so
    its seconds_per_step ends on a synchronised step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = run_training(args, tokenizer=ByteTok(), model=model)
    torch.cuda.synchronize()
    wall = time.time() - t0
    metrics = [json.loads(line) for line in open(Path(args.output_dir) / "metrics.jsonl")]
    ends = [m["step"] * m["seconds_per_step"] for m in metrics]  # since the loop began
    micro_ms = [(b - a) * 1e3 for a, b in zip([0.0] + ends, ends)]
    return dict(summary=summary, wall_s=wall, peak=torch.cuda.max_memory_allocated(),
                losses=[m["loss"] for m in metrics],
                grad_norms=[m["grad_norm"] for m in metrics], micro_step_ms=micro_ms,
                cycle_ms=[sum(micro_ms[:2]), sum(micro_ms[2:4])])


def train_phase(rec):
    """run_training at the full width and depth of TinyLlama-1.1B (random
    bf16 weights from seed 0), from a checkpoint on disk: int2-asym STE at
    g64, CAKLD with beta from estimate_cakld_beta, micro-batch 2 x 1024,
    grad_accum 2, two optimizer cycles, student and teacher through B8
    (BITDISTILLER_TRAIN_FLASH=1 and teacher_flash, for this phase only),
    remat "full". First the tree is handed to run_training as earlier slices
    did (injected: the parent's path); then it is written with
    save_hf_checkpoint (bf16), dropped, and run_training loads it itself (in
    f32: exact upcasts of the same bf16 values), trains and writes its final
    f32 save: the main path, its counts reset just before and read just
    after. Its losses and gradient norms must equal the injected run's bit
    for bit. The second cycle, past the first launches, gives ms a cycle and
    tokens/s. Returns the final master, the config and the temp dir that
    holds the final save (serve_trained reads it, then removes the dir)."""
    cfg = TINYLLAMA_1B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    tmp = Path(tempfile.mkdtemp(prefix="bd_train_"))
    saved = os.environ.get("BITDISTILLER_TRAIN_FLASH")
    try:
        data = tmp / "teacher.jsonl"
        write_teacher_jsonl(data)
        busy = first_step_check(params, cfg, data, rec)
        os.environ["BITDISTILLER_TRAIN_FLASH"] = "1"
        ref = train_run(train_args(data, tmp / "injected"), model=(params, cfg))
        del ref["summary"]
        shutil.rmtree(tmp / "injected")
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.time()
        save_hf_checkpoint(params, cfg, str(tmp / "init"), dtype=torch.bfloat16)
        save_s = time.time() - t0
        init_bytes = dir_bytes(tmp / "init")
        del params
        torch.cuda.empty_cache()
        reset_counts()
        with CheckpointTimes() as io:
            run = train_run(train_args(data, tmp / "out", model_name_or_path=str(tmp / "init")))
        counts = read_counts()
        shutil.rmtree(tmp / "init")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        if saved is None:
            os.environ.pop("BITDISTILLER_TRAIN_FLASH", None)
        else:
            os.environ["BITDISTILLER_TRAIN_FLASH"] = saved
    summary, losses, micro_ms, cycle_ms = (run["summary"], run["losses"], run["micro_step_ms"],
                                           run["cycle_ms"])
    need = ("train_attn_fwd", "train_attn_bwd_dkv", "train_attn_bwd_dq")
    tokens = 2 * 2 * 1024  # a cycle: grad_accum 2 x micro-batch 2 x 1024 positions
    rec.update(config="TINYLLAMA_1B", layers=cfg.num_layers, micro_batch=[2, 1024],
               grad_accum=2, cycles=2, beta=summary["beta"], losses=losses,
               grad_norms=run["grad_norms"], launches=counts, wall_s=run["wall_s"],
               micro_step_ms=micro_ms, cycle_ms=cycle_ms,
               tokens_per_s=tokens / cycle_ms[1] * 1e3, max_memory_allocated=run["peak"],
               profile=busy, injected={k: ref[k] for k in ref},
               checkpoint_io=dict(save_bf16_s=save_s, save_bf16_bytes=init_bytes, **io.s,
                                  final_save_bytes=dir_bytes(tmp / "out")))
    try:
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses) or summary["steps"] != 4:
            raise AssertionError(f"training: {summary['steps']} micro-steps, losses {losses}")
        if not all(counts[k] > 0 for k in need):
            raise AssertionError(f"training did not run through B8's kernels: {counts}")
        say(f"train TinyLlama-1.1B from its checkpoint ({cfg.num_layers} layers, int2-asym g64 "
            f"STE, CAKLD beta {summary['beta']:.4f}): launches "
            f"{ {k: counts[k] for k in need} }, run {run['wall_s']:.1f} s; micro-steps "
            f"{[round(x, 1) for x in micro_ms]} ms, cycles {[round(x, 1) for x in cycle_ms]} ms; "
            f"the second cycle (2 x 2 x 1024 positions) -> {tokens / cycle_ms[1] * 1e3:.0f} "
            f"tokens/s; peak memory {run['peak'] / 2**30:.2f} GiB")
        for name, key in (("losses", "losses"), ("grad norms", "grad_norms"),
                          ("micro-step ms", "micro_step_ms"), ("cycle ms", "cycle_ms")):
            say(f"train {name}: from the checkpoint {run[key]!r} | injected tree (the parent's "
                f"path) {ref[key]!r}")
        say(f"train peak memory: from the checkpoint {run['peak'] / 2**30:.3f} GiB | injected "
            f"tree {ref['peak'] / 2**30:.3f} GiB; run {run['wall_s']:.2f} s | {ref['wall_s']:.2f} s")
        if losses != ref["losses"] or run["grad_norms"] != ref["grad_norms"]:
            raise AssertionError("training from the checkpoint is not bit-equal to the injected "
                                 "tree's run")
        say("train from the checkpoint: the 4 losses and grad norms bit-equal to the injected "
            "tree's")
        if busy is not None:
            say(f"profiler train: B8 {busy['b8_ms']:.2f} ms in one flash micro-step: "
                + ", ".join(f"{k} {v:.2f} ms" for k, v in busy["b8"].items()))
            say(f"profiler train: device busy {busy['busy_ms']:.1f} ms in one flash micro-step "
                f"(forward and backward, no optimizer; the run's second cycle took "
                f"{micro_ms[2]:.1f} + {micro_ms[3]:.1f} ms); top: "
                + ", ".join(f"{k} {v:.2f} ms" for k, v in busy["top"]))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    master = tr.master_params(summary["state"])
    del summary, run
    return master, cfg, tmp


def check_gptq_export(packed, cfg, path: Path) -> int:
    """The GPTQ export of the packed student, read back with the port's
    reader: every linear's GPTQ codes equal `unpack_codes` of its pair-layout
    words (the fused qkv and gate_up split along N), every scale the leaf's
    cast to f16, every zero point szeros / scales. Returns the tensors held."""
    out = safetensors_io.read(str(path / "model.safetensors"))
    hq, hkv, dh, ffn = cfg.num_heads, cfg.num_kv_heads, cfg.actual_head_dim, cfg.intermediate_size
    parts = {"qkv": [("self_attn.q_proj", hq * dh), ("self_attn.k_proj", hkv * dh),
                     ("self_attn.v_proj", hkv * dh)],
             "gate_up": [("mlp.gate_proj", ffn), ("mlp.up_proj", ffn)],
             "o": [("self_attn.o_proj", cfg.hidden_size)],
             "down": [("mlp.down_proj", cfg.hidden_size)]}
    held = 0
    for leaf_name, cuts in parts.items():
        leaf = packed["layers"][leaf_name]
        for li in range(cfg.num_layers):
            codes = unpack_codes(leaf.qweight[li], leaf.bits, leaf.group_size)
            start = 0
            for hf_name, width in cuts:
                key = f"model.layers.{li}.{hf_name}"
                cols = slice(start, start + width)
                got = gx.unpack_gptq_qweight(out[key + ".qweight"].to(DEV), leaf.bits)
                zeros = gx.unpack_gptq_qweight(out[key + ".qzeros"].to(DEV).T.contiguous(),
                                               leaf.bits).T
                s, sz = leaf.scales[li][:, cols], leaf.szeros[li][:, cols]
                if not (torch.equal(got, codes[:, cols])
                        and torch.equal(out[key + ".scales"].to(DEV), s.to(torch.float16))
                        and torch.equal(zeros, torch.round(sz / s).to(torch.int32))):
                    raise AssertionError(f"GPTQ export: {key} does not hold the packed codes, "
                                         f"scales and zeros")
                held += 3
                start += width
    return held


def serve_trained_phase(master, cfg, tmp: Path, rec):
    """Reload the checkpoint that run_training saved (f32) and hold it bit-equal,
    leaf for leaf, against the run's master; pack_model it at int2-g64, serve
    4 prompts through the Engine on the kernels (counts reset before, read
    after: the g64 prefill and decode go through B1 and B2, the attention
    through B3), hold one decode step's logits against use_kernels=False on
    the same cache, then export the packed student to GPTQ and hold the
    export's codes and scales against the packed leaves. Removes `tmp`."""
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        loaded, lcfg = load_hf_checkpoint(str(tmp / "out"), dtype=torch.float32, device=DEV)
        torch.cuda.synchronize()
        reload_s = time.time() - t0
        got, want = dict(tr.tree_items(loaded)), dict(tr.tree_items(master))
        if dataclasses.asdict(lcfg) != dataclasses.asdict(cfg) or sorted(got) != sorted(want):
            raise AssertionError("serve_trained: the saved checkpoint's tree or config differs")
        differ = [p for p in want if not torch.equal(got[p], want[p])]
        if differ:
            raise AssertionError(f"serve_trained: the reloaded master differs at {differ[:4]}")
        say(f"serve_trained: the final save reloads bit-equal to the master ({len(want)} leaves, "
            f"{sum(t.numel() for t in want.values())} f32 values) in {reload_s:.2f} s")
        del master, got, want
        packed = pack_model(loaded, cfg, bits=2, group_size=64)
        del loaded
        packed = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
                  for k, v in packed.items()}
        packed["layers"] = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
                            for k, v in packed["layers"].items()}
        if "lm_head" in packed:
            packed["lm_head"] = {"w": packed["lm_head"]["w"].to(torch.bfloat16)}
        torch.cuda.empty_cache()
        eng = Engine(packed, cfg, max_slots=4, max_len=512, eos_token_id=None,
                     sampling=SamplingParams(temperature=0.0), device=DEV)
        rng = np.random.default_rng(1)
        reqs = [Request(prompt_tokens=rng.integers(3, 253, n).tolist(), max_new_tokens=16)
                for n in (40, 120, 64, 200)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        if len(done) != 4 or not all(r.finished and len(r.output_tokens) == 16 for r in reqs):
            raise AssertionError("serve_trained: not every request finished with 16 tokens")
        if counts["qmm_decode"] < 1 or counts["qmm_prefill"] < 1 or counts["flash_decode"] < 1:
            raise AssertionError(f"serve_trained: g64 decode/prefill not through the kernels: "
                                 f"{counts}")
        pos = torch.as_tensor(np.minimum(eng.lengths, 480), dtype=torch.int32, device=DEV)
        tok = torch.randint(3, 253, (4, 1), device=DEV)
        ref = dict(packed, layers=dict(packed["layers"]))
        for name, leaf in packed["layers"].items():
            if isinstance(leaf, PackedLinear):
                s, sz = scales_from_combo(leaf.combo)
                ref["layers"][name] = dataclasses.replace(leaf, scales=s, szeros=sz)
        with torch.inference_mode():
            lk, _ = forward(packed, cfg, tok, cache=eng.cache, cache_pos=pos + 4)
            lp, _ = forward(ref, cfg, tok, cache=eng.cache, cache_pos=pos + 4, use_kernels=False)
        err = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        say(f"serve_trained: 4 requests on the packed int2-g64 student, launches "
            f"{ {k: v for k, v in counts.items() if v} }, {wall:.2f} s; decode step vs plain "
            f"max|dlogit| {err:.4g} of {scale:.4g} (tol {LOGIT_TOL} relative)")
        if not (torch.isfinite(lk).all() and err <= LOGIT_TOL * scale):
            raise AssertionError("serve_trained: decode logits disagree with the plain path")
        del eng, ref
        torch.cuda.synchronize()
        t0 = time.time()
        gx.export_gptq(packed, cfg, str(tmp / "gptq"))
        export_s = time.time() - t0
        held = check_gptq_export(packed, cfg, tmp / "gptq")
        rec.update(requests=4, group_size=64, launches=counts, wall_s=wall,
                   logit_max_abs_err=err, logit_max=scale, reload_f32_s=reload_s,
                   gptq_export_s=export_s, gptq_bytes=dir_bytes(tmp / "gptq"), gptq_held=held)
        say(f"serve_trained: GPTQ export of the packed student in {export_s:.2f} s "
            f"({dir_bytes(tmp / 'gptq') / 1e9:.3f} GB); {held} code, scale and zero tensors "
            f"held exactly against the packed leaves")
        del packed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


TF32_KERNELS = ("train_attn_fwd_tf32_kernel<64>", "train_attn_fwd_tf32_kernel<128>",
                "train_attn_dkv_tf32_kernel<64>", "train_attn_dkv_tf32_kernel<128>",
                "train_attn_dq_tf32_kernel<64>", "train_attn_dq_tf32_kernel<128>",
                "train_attn_fwd_tf32_split_kernel", "train_attn_dkv_tf32_split_kernel",
                "train_attn_dq_tf32_split_kernel")


def sass_phase(rc: int, out: str, err: str) -> dict:
    """What ptxas made of B8's tensor-core kernels, bf16 and the f32
    3xTF32 ones (scripts/kernel_sass.py's rows: registers, spill bytes,
    HGMMA, wgmma waits, HMMA, local stores and loads; the CUDA-core kernels,
    `*_cores_kernel`, left out); fails unless each issues
    HGMMA, holds no HMMA and spills nothing."""
    if rc:
        raise RuntimeError(f"kernel_sass exited {rc}:\n{err[-2000:]}")
    rows = {r["kernel"]: r for r in map(json.loads, out.splitlines())}
    b8 = {k: {f: r.get(f) for f in ("registers", "spill_stores", "hgmma", "wgmma_waits", "hmma")}
          for k, r in rows.items()
          if k.startswith("train_attn_") and "_cores_kernel" not in k}
    for k, r in sorted(b8.items()):
        say(f"sass {k}: {r}")
    bad = [k for k, r in b8.items() if not r["hgmma"] or r["hmma"] or r["spill_stores"]
           or rows[k]["spill_loads"] or rows[k]["stl"] or rows[k]["ldl"]]
    missing = [k for k in ("train_attn_dkv_wide_kernel",) + TF32_KERNELS if k not in b8]
    if missing or bad:
        raise AssertionError(f"B8 tensor-core kernels missing {missing}, or off wgmma, on "
                             f"mma.sync or spilling: {bad}")
    return b8


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
        sass = subprocess.Popen(  # its own nvcc of train_attention.cu, beside the build's
            [sys.executable, "-m", "bitdistiller_tpu_torch.scripts.kernel_sass", "train_attention"],
            cwd=OUT_DIR.parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            libs = _build.build()
        finally:
            sass_out, sass_err = sass.communicate()
        summary["build_s"] = time.time() - t0
        say(f"built {sorted(libs)} in {summary['build_s']:.1f} s")

    with Phase("sass"):
        summary["sass"] = b8_sass = sass_phase(sass.returncode, sass_out, sass_err)

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
        say(f"{len(summary['a8_checks'])} cases (pair-layout and repacked words, M={CHECK_M}); "
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
        att_path = time_attention(gen, bw, summary["attention_times"], per_layer=False,
                                  starts=PATH_STARTS)
        for r in summary["matmul_times"] + summary["attention_times"]:
            say(json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in r.items()}))

    with Phase("end to end"):
        summary["e2e"] = {}
        counts = end_to_end(bw, summary["e2e"])

    with Phase("end to end A8"):
        summary["e2e_a8"] = {}
        counts_a8 = end_to_end(bw, summary["e2e_a8"], a16_counts=counts)

    with Phase("c1"):
        summary["c1_checks"] = []
        n_c1 = check_c1(gen, summary["c1_checks"])
        summary["c1_times"] = []
        dec64 = totals_entry(time_matmuls(gen, 8, bw, summary["c1_times"], group=64), bw)
        pre64 = totals_entry(time_matmuls(gen, 256, bw, summary["c1_times"], group=64), bw)
        a8_64 = totals_entry(time_a8(gen, 8, summary["c1_times"], group=64), bw, PEAK_INT8_OPS)
        say(f"C1: {n_c1} cases through their kernels (A16, A8, fused MLP at g32, g64, "
            f"per-channel, bf16 and f32 x; decode attention at D = 256 and f32 q); g64 at the "
            f"table's work: qmm_decode M=8 {dec64['ms']:.4f} ms, qmm_prefill M=256 "
            f"{pre64['ms']:.4f} ms, qmm_a8 M=8 {a8_64['ms']:.4f} ms")

    with Phase("c6"):
        summary["c6"] = {}
        c6_phase(gen, bw, summary["c6"])

    with Phase("train_attention"):
        summary["train_attention_checks"] = []
        ta_err, ta_times = train_attention_phase(gen, summary["train_attention_checks"])
        summary["train_attention_times"] = ta_times
        for name, t in ta_times.items():
            dev = t["device_ms"]
            say(f"train attention {name} {t['shape']} {t['dtype']}: fwd {t['fwd_ms']:.4f} ms "
                f"(bound {t['fwd_bound_ms']:.4f}, plain {t['plain_fwd_ms']:.3f}, SDPA "
                f"{t['sdpa_fwd_ms']:.4f}); dkv {t['dkv_ms']:.4f} (bound {t['dkv_bound_ms']:.4f}), "
                f"dq {t['dq_ms']:.4f} (bound {t['dq_bound_ms']:.4f}); bwd {t['bwd_ms']:.4f} (SDPA "
                f"{t['sdpa_bwd_ms']:.4f}); fwd+bwd {t['fwd_bwd_ms']:.4f} "
                f"(plain {t['plain_fwd_bwd_ms']:.3f}, SDPA {t['sdpa_fwd_bwd_ms']:.4f}); dkv plan "
                f"{t['dkv_plan']}, dq plan {t['dq_plan']}")
            say("  device time (profiler): " + ", ".join(
                    f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                    for k, v in dev.items())
                + (f"; CUDA-core bounds fwd {t['fwd_cores_bound_ms']:.4f}, dkv "
                   f"{t['dkv_cores_bound_ms']:.4f}, dq {t['dq_cores_bound_ms']:.4f}"
                   if "fwd_cores_bound_ms" in t else ""))
        say(f"train attention checks: worst relative error {ta_err}")

    with Phase("train"):
        summary["train"] = {}
        master, tcfg, saved_dir = train_phase(summary["train"])

    with Phase("serve_trained"):
        summary["serve_trained"] = {}
        serve_trained_phase(master, tcfg, saved_dir, summary["serve_trained"])
        del master
        io = dict(summary["train"]["checkpoint_io"], reload_f32_s=summary["serve_trained"][
            "reload_f32_s"], gptq_export_s=summary["serve_trained"]["gptq_export_s"])
        say(f"checkpoint I/O, TinyLlama-1.1B (host seconds on the card's machine; {card}): bf16 "
            f"save {io['save_bf16_s']:.3f} s ({io['save_bf16_bytes'] / 1e9:.3f} GB), f32 load "
            f"{io['load_f32_s']:.3f} s, final f32 save {io['final_save_f32_s']:.3f} s "
            f"({io['final_save_bytes'] / 1e9:.3f} GB), reload {io['reload_f32_s']:.3f} s, GPTQ "
            f"export {io['gptq_export_s']:.3f} s")

    # last, so that the earlier phases run in the same process state with or
    # without it (run before training, its 13 GB Falcon-7B build slowed the KD cycle)
    with Phase("families"):
        summary["families"] = {}
        families_phase(card, summary["families"])

    dec, pre, pre4k = totals_entry(dec, bw), totals_entry(pre, bw), totals_entry(pre4k, bw)
    a8_dec = totals_entry(a8_dec, bw, PEAK_INT8_OPS)
    a8_pre = totals_entry(a8_pre, bw, PEAK_INT8_OPS)
    a8_pre4k = totals_entry(a8_pre4k, bw, PEAK_INT8_OPS)
    times = lambda t: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    c6 = summary["c6"]
    fams = summary["families"]
    fal = fams["falcon7b"]
    # C6's path: Falcon-7B whole, int2-g64 (A16 for B1-B3, A8 for B4)
    c6_model = dict(fal["A16"]["launches"], **{k: v for k, v in fal["A8"]["launches"].items()
                                               if k.startswith("qmm_a8")})

    def c6_mm(kind):  # Falcon-7B's projections at K = 4544 (down: the control), g64
        return dict({r["shape"]: times(r) for r in c6["matmul_times"] if r["kernel"] == kind},
                    path_launches=c6_model.get(kind, 0))

    def family_block(kind):  # the families phase's launches of one kernel, each run
        out = {f"{name} {tag}": run["launches"].get(kind, 0) for name, fam in fams.items()
               for tag, run in fam.items() if tag in ("A16", "A8")}
        if kind in ("qmm_decode", "qmm_a8", "flash_decode"):
            for tag in ("A16", "A8"):
                run = fal[tag]
                out[f"falcon7b {tag} step"] = {k: run[k] for k in (
                    "decode_ms_per_step", "idle_share", "step_bound_ms", "step_bytes")}
        return out

    kernels = [
        kernel_entry("qmm_decode", "quant_matmul.cu", "bitdistiller_tpu/ops/quant_matmul.py:152",
                     counts["qmm_decode"], mm_rel, dec,
                     "one layer's qkv+o+gate_up+down, M=8, int2-g128, 7B widths, streaming "
                     "kernel on clusters; max_abs_err relative to max|plain|; launches from the "
                     "A16 engine run",
                     bound_measured_bw_ms=dec["bound_measured_bw_ms"], g64=times(dec64),
                     c6=c6_mm("qmm_decode"), families=family_block("qmm_decode")),
        kernel_entry("qmm_prefill", "quant_matmul.cu", "bitdistiller_tpu/ops/quant_matmul.py:107",
                     counts["qmm_prefill"], mm_rel, pre,
                     "the same four, M=256 (x group sums + wgmma kernel; m4096: the engine's "
                     "first prefill shape); launches from the A16 engine run",
                     bound_measured_bw_ms=pre["bound_measured_bw_ms"], m4096=times(pre4k),
                     g64=times(pre64), c6=c6_mm("qmm_prefill"),
                     families=family_block("qmm_prefill")),
        kernel_entry("flash_decode", "decode_attention.cu",
                     "bitdistiller_tpu/ops/decode_attention.py:106", counts["flash_decode"],
                     at_err["stacked"], att,
                     "B=8, Hq=Hkv=32, T=2048, D=128, bf16 cache, rows split over clusters; the "
                     "table's long skewed starts (8083 rows; path: the steady decode step's "
                     "2130 rows); launches from the A16 engine run",
                     bound_measured_bw_ms=att["bound_measured_bw_ms"], path=times(att_path),
                     c6=dict({name: times(r) for name, r in c6["attention"].items()},
                             path_launches=c6_model["flash_decode"]),
                     families=family_block("flash_decode")),
        kernel_entry("qmm_a8", "quant_matmul_a8.cu", "bitdistiller_tpu/ops/quant_matmul.py:721",
                     counts_a8["qmm_a8"], a8_rel, a8_dec,
                     "one layer's four A8 matmuls (quantization included), M=8, int2-g128 "
                     "repacked, 7B widths, quantize + streaming decode kernel (PDL); "
                     "max_abs_err relative to max|plain|; "
                     "launches from the A8 engine run (every packed matmul, prefill and decode)",
                     bound_measured_bw_ms=a8_dec["bound_measured_bw_ms"],
                     m256=times(a8_pre), m4096=times(a8_pre4k),
                     prefill_launches=counts_a8["qmm_a8_prefill"], g64=times(a8_64),
                     c6=c6_mm("qmm_a8"), families=family_block("qmm_a8")),
        kernel_entry("fused_mlp", "fused_mlp.cu", "bitdistiller_tpu/experimental/fused_mlp.py:57",
                     mlp["launches"], mlp["max_abs_err"], mlp,
                     "7B MLP (K=4096, FFN=11008, D=4096), M=8, int2-g128, silu, two launches "
                     "(gate/up, down) chained by PDL; library_ms is "
                     "three calls (matmul, silu*mul, matmul on bf16 weights); launches from its "
                     "path: one decode step's MLP through 32 layers (entry point, no model hook)",
                     bound_measured_bw_ms=mlp["bytes"] / bw * 1e3,
                     c6=times(c6["mlp"]["g64_m8"])),
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
    tl, t7 = ta_times["tinyllama"], ta_times["llama2_7b"]
    ta_err_max = max(ta_err.values())

    def b8(kind, t, plain, lib):  # bwd_ms (dkv + dq) beside library_ms, SDPA's backward
        dev = t["device_ms"]
        row = dict(ms=t[f"{kind}_ms"], plain_ms=t[plain], bound_ms=t[f"{kind}_bound_ms"],
                   bound_by="operations", library_ms=t[lib], device_ms=dev[kind],
                   library_device_ms=dev[lib[:-3]])
        if kind != "fwd":
            row.update(bwd_ms=t["bwd_ms"], bwd_device_ms=dev["bwd"])
        if f"{kind}_cores_bound_ms" in t:
            row.update(bound_by="operations (f32 as 3xTF32, 165 TFLOP/s)",
                       cores_bound_ms=t[f"{kind}_cores_bound_ms"])
        return row

    b8_work = ("TinyLlama-1.1B attention, B=2, S=1024, Hq=32, Hkv=4, D=64, bf16, causal "
               "(llama2_7b: B=1, S=2048, Hq=Hkv=32, D=128; d256: B=1, S=1000, Hq=Hkv=16, "
               "D=256; d256_mqa: Gemma-2B's heads, B=2, S=1024, Hq=8, Hkv=1, D=256; dkv "
               "above D=128 by train_attn_dkv_wide_kernel; f32: B=1, S=300, Hq=8, Hkv=2, "
               "D=64, and tinyllama_f32, llama2_7b_f32 at the two models' shapes in f32, "
               "forward, dkv and dq by the 3xTF32 kernels; d256_f32: d256_mqa in f32, the "
               "forward, dkv and dq by the 3xTF32 splits of 2 CTAs; d512_f32: B=1, S=1024, "
               "Hq=8, Hkv=2, D=512, the three by the 3xTF32 splits of 4 CTAs; d1024_f32: "
               "B=1, S=256, Hq=Hkv=4, D=1024, the splits of 8; c6: D=72, 80, 300, 320 "
               "padded to a multiple of 16, above D=256 the forward, dkv and dq by the 3xTF32 "
               "splits of 3 CTAs (bf16 on f32 copies), and D=1040 (B=1, S=100, Hq=8, Hkv=4) "
               "with the three on the CUDA cores (256-column slices); their library_ms is "
               "SDPA and plain_ms the plain version on "
               "the same padded inputs at the real D's scale, causal); max_abs_err is the "
               "worst relative error over the forward, the three gradients and dq alone of the "
               "checked cases; device_ms and library_device_ms: the kernel's and SDPA's "
               "device time (profiler); launches from the train phase (4 micro-steps of "
               "run_training)")
    tm = ta_times["d256_mqa"]
    for kind, name, line, plain, lib, cu in (
            ("fwd", "train_attn_fwd", ":758 (_flash_attention_kernel :331)", "plain_fwd_ms",
             "sdpa_fwd_ms", ("train_attn_fwd_kernel", "train_attn_fwd_tf32_kernel",
                             "train_attn_fwd_tf32_split_kernel")),
            ("dkv", "train_attn_bwd_dkv", ":1121 (_flash_attention_dkv_kernel :796)",
             "plain_bwd_ms", "sdpa_bwd_ms", ("train_attn_dkv_ws_kernel",
                                              "train_attn_dkv_wide_kernel",
                                              "train_attn_dkv_tf32_kernel",
                                              "train_attn_dkv_tf32_split_kernel")),
            ("dq", "train_attn_bwd_dq", ":1456 (_flash_attention_dq_kernel :1146)",
             "plain_bwd_ms", "sdpa_bwd_ms", ("train_attn_dq_ws_kernel",
                                             "train_attn_dq_tf32_kernel",
                                             "train_attn_dq_tf32_split_kernel"))):
        kernels.append(dict(
            name=name, route="cuda", source="bitdistiller_tpu_torch/csrc/train_attention.cu",
            replaces="jax/experimental/pallas/ops/tpu/flash_attention.py" + line
            + ", reached from bitdistiller_tpu/models/layers.py:341",
            launches=summary["train"]["launches"][name], max_abs_err=ta_err_max,
            **b8(kind, tl, plain, lib), work=b8_work
            + ("; plain_ms and library_ms are the whole backward (dq, dk, dv together)"
               if kind != "fwd" else ""),
            llama2_7b=b8(kind, t7, plain, lib), d256=b8(kind, ta_times["d256"], plain, lib),
            d256_mqa=b8(kind, tm, plain, lib),
            **{c: b8(kind, ta_times[c], plain, lib) for c in F32_TIMED},
            c6={c: dict({key: r[key] for key in (f"{kind}_ms", f"{kind}_bound_ms", "dkv_plan",
                                                 "dq_plan", "fwd_plan", "rel_err", "launches")},
                        device_ms=r["device_ms"][kind],
                        library_ms=r["sdpa_fwd_ms" if kind == "fwd" else "sdpa_bwd_ms"],
                        library_device_ms=r["device_ms"]["sdpa_fwd" if kind == "fwd"
                                                         else "sdpa_bwd"],
                        plain_ms=r["plain_fwd_ms" if kind == "fwd" else "plain_bwd_ms"])
                for c, r in summary["c6"]["train_attention"].items()},
            sass={k: r for k, r in b8_sass.items() if k.startswith(cu)},
            **({"plan": tl["dkv_plan"], "llama2_7b_plan": t7["dkv_plan"],
                "d256_plan": ta_times["d256"]["dkv_plan"], "d256_mqa_plan": tm["dkv_plan"],
                "d256_kernel": "train_attn_dkv_wide_kernel",
                **{f"{c}_plan": ta_times[c]["dkv_plan"] for c in F32_TIMED}}
               if kind == "dkv" else {f"{c}_plan": ta_times[c][f"{kind}_plan"]
                                      for c in SPLIT_TIMED})))
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
