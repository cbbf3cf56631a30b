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
case's shapes, with the dkv plan), `train` (the three stages of the method at the
full width and depth of TinyLlama-1.1B, from one checkpoint on disk: the
random bf16 model written with save_hf_checkpoint; stage 1, run_autoclip on
it over 128 x 1024 calibration tokens cut from the wikitext fixture's text
(int2 g64, 512 sampled rows), its capture and search timed apart, the cache
saved; stage 2, run_teacher_generation on it through the dense engine (B3
on every decode step, no packed matmul), 10 prompts of 720 new tokens;
stage 3, run_training on the clip cache and the generated data: int2-asym
STE at g64, CAKLD, 2 x 1024 tokens a micro-step, grad_accum 2, two
optimizer cycles, student and teacher through B8, the checkpoint loaded,
trained and saved by run_training itself, its losses bit-equal to a run
handed the same tree; the three stages go through the CLI
in process, `cli train` in a process group of one rank over NCCL at ZeRO
2, and its step-2 checkpoint resumes through `cli train --resume
--fused_accum --zero_stage 3` under BITDISTILLER_DEBUG=1) and
`serve_trained` (the final save reloaded
bit-equal to the master, packed at int2-g64 and served through the Engine
on B1/B2/B3, then exported to GPTQ with every code, scale and zero point
held, and again by `cli export_gptq` from the save; the checkpoint I/O
seconds beside the card's name and power limit),
`eval` (stage 4 on the trained TinyLlama-1.1B: the perplexity over all 139
blocks of 2048 byte tokens of the wikitext fixture's test text, batch 8, of
the teacher checkpoint, of RTN int2-g64 of it and of the student under the
CLI's PTQ quantizer, and of the packed int2-g64 student at A16 through B1 and
at A8 through B4, every prefill matmul counted; the packed runs' first two
blocks against the plain path; run_tasks on ARC-Challenge and MMLU abstract
algebra, GreedyUntilFn on 8 GSM8K docs through the Engine (B1, B2, B3), the
CLI's `ppl --dtype float32` in a child process under the training flash
(B8's forward only) and the f32 config's perplexity through B8's 3xTF32
forward) and `method` (the port's scripts/method_demo.py at the JAX script's
defaults: the RTN -> AutoClip -> CAKLD QAT table for int2 and nf3 at g64,
with the packed int2 row at A16 and W2A8, gated on its shape). Between c1 and train_attention, `c6` runs the shapes
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
Before families, `tp` runs tensor parallelism (tp_phase): B1, B2 and B3
at the shapes a tp = 2 rank gives them (the 7B's and TinyLlama's unfused
slices: K = 2048, 5504 and 2816 among them; 16 / 16 and 16 / 2 heads),
and B4 at the 7B rank's 7 linears, B1 and B2 at the ring's chunks (o and
down at K / 2 x N / 2), checked and timed in this process, then two ranks
on the one card joined over gloo (NCCL refuses two ranks on one device;
a point-to-point hop goes through host memory): the dry run's steps
(scripts/dryrun_multichip.py, GPipe's part included), the packed 7B
decode at tp = 2, again through the ring (BITDISTILLER_RING_TP=1) and
under A8, the Engine over the tp group serving 8 requests (A16, A8,
speculative, the ring, and dp = 2 x tp = 1 on the same ranks), each on
the graph route, its pieces replayed as chains of graphs split at each
collective (A3i), beside its eager twin, and after a warmup, GPipe at
pp = 2, and run_training at tp = 2 (TinyLlama's width, 2 layers,
through B8 at 16 / 2 heads, a checkpoint in each rank's parts), against
tp = 1 runs here; in a process of its own, a probe of whole-graph NCCL
capture on one rank (a finding, no route's). The
train phase's checkpoints are C9's layout: each rank's parts and a
manifest, the write timed with the process's resident memory sampled. Beside
the build, scripts/kernel_sass.py reads what ptxas made of
csrc/train_attention.cu; the `sass` phase prints it and fails unless every
B8 tensor-core kernel (bf16, and the 3xTF32 forward, dkv and dq, alone and
on the splits above D = 128) issues HGMMA, holds no HMMA (mma.sync) and
spills nothing.
Every Engine takes the engine's default route on the card: its decode
steps, verify rounds and admission pieces replay captured CUDA graphs (the
port's jitted horizons; under a mesh chains split at each collective);
each phase prints the routes its engines took and fails if one ran
eagerly without asking (graphs=False: the eager twins). The end-to-end runs (A16 and A8), one speculative and one sampled
serve run each have an eager twin on the same requests, whose tokens and
launch counts must be equal bit for bit; the 7B's decode horizon is timed
replayed and eager in turns, and a profiler trace of a replayed horizon
must name B2 (B4 under A8) and B3. Warmup prints its captures, their
seconds and the graphs' memory pool at each of the 7B's six buckets.
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
    softmax); every training loss finite;
  * AutoClip (stage 1): the search on the card against the same function on
    the CPU, both f32, on layer 0's sampled inputs of v (K 2048, N 256) and
    of the first 256 columns of down (K 5632): at least 99% of the (column,
    group) clips equal, and where one differs its objective within 1e-4
    relative of the other's (near-ties summed in another order); every
    chosen clip of every searched linear of layers 0 and 21 no worse than
    shrink (1, 1), on the grid, both objectives recomputed on the card,
    within 1e-6 relative; the cache reloads equal, and its clamp of the
    loaded tree equals the clipped tree exactly;
  * teacher generation (stage 2): 10 lines in prompt order, each prompt
    templated and each completion non-empty; B3's launches exactly 22 times
    the engine's decode steps and no other kernel (the dense tree); the
    training micro-batches 2 x 1024; one decode step of the dense model
    through the kernels against use_kernels=False within LOGIT_TOL;
  * stage 3 through the CLI: `cli train` at world size 1 (NCCL,
    ZeRO 2) bit-equal to the injected single-device run (losses and
    gradient norms), B8's launches exactly 22 x (2 CAKLD batches + 3 x
    the micro-steps) forwards and 22 x the micro-steps dkv and dq; the
    fused ZeRO-3 resume's cycle-2 loss within RESUME_LOSS_TOL relative of
    the uninterrupted run's mean over the same micro-steps, and its final
    master's update within RESUME_MASTER_TOL of the uninterrupted run's;
    `cli mix_data` keeps every line; `cli export_gptq`'s codes, zero points
    and scales equal to the direct export's, its other tensors within a
    bf16 rounding (2^-7 relative past 2^-24);
  * eval (stage 4): the packed perplexities through B1 / B4 against
    use_kernels=False on the first 2 blocks: summed NLL within 1e-3
    relative (bf16 matmul outputs rounded after sums in another order); the
    tasks' per-pair log-likelihood sums within 1e-2 relative of the plain
    path (greedy flags and acc not held: a bf16 argmax tie flips them); the
    CLI's f32-loaded `ppl` under B8's bf16 forward within 2e-3 relative of the
    same perplexity without the flash; the f32 config's under the 3xTF32
    forward within 1e-4 relative of the plain f32 attention;
  * method (A13): int2 RTN > +AutoClip > +QAT, nf3 QAT < RTN, the packed row
    within 0.5% of the QAT row (one int2 grid) and the W2A8 row within 2% of
    the packed row;
  * tp: the shard shapes as the packed matmuls and the decode attention
    above (integer inputs exact, bf16 within MATMUL_TOL, ATTN_TOL, two
    calls equal); every rank's B1 / B2 / B3 launches of the tp decode and
    B8's of the tp run_training exactly as predicted; the tp = 2 decode's
    logits within LOGIT_TOL of the largest from tp = 1's on the same
    weights and tokens, and so the A8 decode's and the ring's (against the
    default tp path); the engine's greedy streams equal on both ranks and,
    up to the tie rule, to the one-process engine's, A16 and A8, its B1 /
    B2 / B3 / B4 launches exactly as predicted; on both ranks every tp
    engine run on "graphs, admission graphs", its tokens and launch counts
    equal to its eager twin's and as predicted, each key's segments as
    `tp_segments` predicts, no key captured after warmup; GPipe's logits within
    LOGIT_TOL of one process's, its B1 launches as predicted; the tp = 2
    training losses within TP_LOSS_TOL relative of tp = 1's; the tp = 2
    checkpoint restored at tp = 1 in one process equal bit for bit to the
    ranks' final master.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

from bitdistiller_tpu_torch import cli as port_cli
from bitdistiller_tpu_torch.data.calib import get_calib_dataset
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
    load_packed_checkpoint,
    pack_model,
    random_packed_params,
    save_packed_checkpoint,
)
from bitdistiller_tpu_torch.generation import datasets as gen_datasets
from bitdistiller_tpu_torch.generation import teacher as teacher_mod
from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint, save_hf_checkpoint
from bitdistiller_tpu_torch.ops import _build
from bitdistiller_tpu_torch.parallel.distributed import (BOUNDARY_STATS, init_distributed,
                                                         make_hybrid_mesh, p2p_transport,
                                                         shutdown_distributed)
from bitdistiller_tpu_torch.parallel.mesh import make_mesh, shard_packed_model
from bitdistiller_tpu_torch.parallel.pipeline import (make_pp_mesh, pipeline_forward,
                                                      shard_params_pp)
from bitdistiller_tpu_torch.parallel.tensor import tp_config
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.ops import quant_matmul as qm
from bitdistiller_tpu_torch.ops import train_attention as ta
from bitdistiller_tpu_torch.quant import autoclip
from bitdistiller_tpu_torch.quant.packing import (
    PackedLinear,
    dequantize_linear,
    make_scale_combo,
    scales_from_combo,
    unpack_codes,
)
from bitdistiller_tpu_torch.scripts import bw_probe, loadtest
from bitdistiller_tpu_torch.scripts.dryrun_multichip import dryrun as tp_dryrun
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.serve.capacity import serve_capacity
from bitdistiller_tpu_torch.serve.engine import (ADMISSION_PIECES, GRAPH_ROWS, STEP_PIECES,
                                                 graph_rows_bytes, grow_kv_cache, piece)
from bitdistiller_tpu_torch.serve.server import ServingFrontend
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as tr
from bitdistiller_tpu_torch.train.data import Collator, SupervisedDataset, data_loader
from bitdistiller_tpu_torch.train.pipeline import run_training
from bitdistiller_tpu_torch.utils.profiling import StepTimer

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


LOG = OUT_DIR / "chip_smoke.log"  # main() keeps every line here (a call returns only the tail)
CARD = "not read"  # nvidia-smi's name and power limit, read in the card phase
_log_lines: list = []


def say(msg: str) -> None:
    print(msg, flush=True)
    _log_lines.append(msg)


_ROUTES: list = []  # (phase, route, why) of every Engine built in this process


def record_routes() -> None:
    """Wrap Engine.__init__ so that every engine a phase builds (inside the
    port's modules too: teacher generation, eval, the method script) leaves
    its route, its admission's route ("graphs" when its prefill, insert,
    commit and tail prefill replay, else "eager") and why: "twin"
    (graphs=False), "mesh" or "default"."""
    init = Engine.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        why = ("twin" if kw.get("graphs") is False else "mesh" if self.mesh is not None
               else "default")
        _ROUTES.append((Phase.current, f"{self.route}, admission {self.route}", why))

    Engine.__init__ = recorded


class Phase:
    current = ""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        Phase.current = self.name
        self.routes_at = len(_ROUTES)
        return self

    def __exit__(self, typ, exc, tb):
        if typ is None:
            torch.cuda.synchronize()
            routes = _ROUTES[self.routes_at:]
            if routes:
                tally = collections.Counter(f"{route} ({why})" for _, route, why in routes)
                say(f"[{self.name}] engine routes: "
                    + ", ".join(f"{k} x{n}" for k, n in sorted(tally.items())))
                if any(why != "twin" and route != "graphs, admission graphs"
                       for _, route, why in routes):
                    raise AssertionError(f"[{self.name}] an engine did not take the graph "
                                         f"route unasked: {routes}")
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


def check_matmuls(gen, record, ms=CHECK_M, bits_list=(2, 4), shapes=SHAPES):
    """B1/B2 on layer 1 of a stack: int2 and int4, the four 7B shapes (or
    `shapes`), M in `ms`; at M = 8 on bf16 x a second call must give the
    same bytes."""
    worst = 0.0
    for bits in bits_list:
        for name, (k, n) in shapes.items():
            for integer in (True, False):
                p = rand_stacked(gen, 2, k, n, bits, integer)
                for m in ms:
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


def check_a8(gen, record, ms=CHECK_M, bits_list=(2, 4), shapes=SHAPES):
    """B4 on layer 1 of a stack: int2 and int4, the four 7B shapes (or
    `shapes`), M in `ms`, pair-layout words (x permuted per call) and
    repacked ones; at M = 8 on bf16 x a second call must give the same
    bytes."""
    worst = 0.0
    for bits in bits_list:
        for name, (k, n) in shapes.items():
            for integer in (True, False):
                pair = rand_stacked(gen, 2, k, n, bits, integer)
                for w in (pair, qm.repack_linear_a8(pair)):
                    lay = w.layer(1)
                    for m in ms:
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


def time_attention(gen, bw, detail, per_layer: bool, starts=TABLE_STARTS, heads=(32, 32, 128)):
    """B3 on layer i % 2 of a stacked cache, or (per_layer) B6, the per-layer
    entry, on two separate [B, Hkv, T, D] caches: the same work and the same
    kernel, 7B heads (or `heads`: Hq, Hkv, D), batch 8, T = 2048, the slots
    at `starts` (the table's long skewed work, or the steady decode step's
    lengths). `ms` is the raw
    launcher on `attention_plan`'s clusters (as for the matmuls),
    `wrapper_ms` the entry point; the library yardstick is SDPA over the same
    layer's cache with a row mask (it reads all T rows and does not fold the
    fresh token)."""
    (hq, hkv, d), b, t = heads, 8, 2048
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
        qs, *caches[i % 2], attn_mask=mask, enable_gqa=hq != hkv), 20)
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
    per, names = {}, set()
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:  # kernels, not ops
            per[e.key[:48]] = per.get(e.key[:48], 0.0) + t / 1e3 / n
            names.add(e.key)
    if not per:
        return None
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    b8 = {k: v for k, v in per.items() if "train_attn" in k}  # B8's kernels, ms a step
    return dict(busy_ms=sum(per.values()), top=top, b8=b8, b8_ms=sum(b8.values()),
                kernels=sorted(names))


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


MATERIALIZE_M = 256  # A15's switch for the check: every matmul of an 8 x 512 prefill crosses it
MATERIALIZE_TOL = LOGIT_TOL  # last logits, relative to the largest: bf16 weights either way
MATERIALIZE_TURNS = 3


def materialize_check(params, cfg, out):
    """A15 on the 7B: one 8 x 512 prefill with BITDISTILLER_QMM_MATERIALIZE_M
    = 256 (every packed matmul dequantizes its layer to bf16 once and runs
    torch.matmul; no B1 launch, counts reset just before and read just
    after), its last logits held against the default path's (B1) within
    MATERIALIZE_TOL of the largest, and both timed in turns (`route_turns`:
    host clock around a synchronize, then device busy)."""
    b, s = 8, 512
    g = torch.Generator(device=DEV).manual_seed(15)
    tokens = torch.randint(3, cfg.vocab_size, (b, s), device=DEV, generator=g)
    saved = os.environ.get(qm.MATERIALIZE_ENV)

    def prefill(materialize):
        os.environ[qm.MATERIALIZE_ENV] = str(MATERIALIZE_M) if materialize else ""
        qm.materialize_min_m.cache_clear()  # the switch is read once until cleared
        try:
            with torch.inference_mode():
                logits, _ = forward(params, cfg, tokens, return_kv=True)
            return logits[:, -1].float()
        finally:
            if saved is None:
                os.environ.pop(qm.MATERIALIZE_ENV, None)
            else:
                os.environ[qm.MATERIALIZE_ENV] = saved
            qm.materialize_min_m.cache_clear()

    ref = prefill(False)
    torch.cuda.synchronize()
    reset_counts()
    got = prefill(True)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    t = route_turns({"materialized": lambda: prefill(True), "B1": lambda: prefill(False)},
                    MATERIALIZE_TURNS)
    err = (got - ref).abs().max().item()
    top = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    out["materialize"] = dict(switch=MATERIALIZE_M, launches=counts, max_abs_err=err, logit_max=top,
                              argmax_agreement=agree, turns=t, tol=MATERIALIZE_TOL)
    say(f"materialize A15 ({CARD}): 8 x 512 prefill with BITDISTILLER_QMM_MATERIALIZE_M="
        f"{MATERIALIZE_M}: launches {counts}; last logits vs B1's max|d| {err:.4g} of {top:.4g} "
        f"(tol {MATERIALIZE_TOL} relative), argmax agreement {agree:.3f}; "
        + turns_text(t, ("materialized", "B1")))
    if counts.get("qmm_prefill") or counts.get("qmm_a8") or not err <= MATERIALIZE_TOL * top:
        raise AssertionError("materialize A15: a B1 launch under the switch, or logits off B1's")


HZ_STEPS, HZ_TURNS = 8, 4  # the engine's default horizon; turns a route


def decode_turns(engines: dict, tag: str, a8: bool) -> dict:
    """The engine's own decode horizon (8 steps of every slot, greedy, from
    each engine's state after its run) on each route, host clock around a
    synchronize, in turns (graphs, eager, graphs, ...; HZ_TURNS a route),
    then one horizon of each profiled: device busy and idle share a step,
    and the kernels the replayed horizon ran, which must name B2 (B4 and
    its quantize pass under A8) and B3."""
    need = (("quantize_rows_kernel", "qmm_a8_decode_kernel") if a8
            else ("qmm_decode_stream_kernel",)) + ("fd_kernel",)
    out = {route: dict(ms=[]) for route in engines}
    for eng in engines.values():
        eng._decode(HZ_STEPS, custom=False)  # each key's graph exists after the run already
    for _ in range(HZ_TURNS):
        for route, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._decode(HZ_STEPS, custom=False)
            torch.cuda.synchronize()
            out[route]["ms"].append((time.perf_counter() - t0) * 1e3 / HZ_STEPS)
    for route, eng in engines.items():
        r = out[route]
        r["step_ms"] = float(np.median(r["ms"]))
        busy = device_busy_ms(lambda i, eng=eng: eng._decode(HZ_STEPS, custom=False), 1)
        r["busy_ms"] = None if busy is None else busy["busy_ms"] / HZ_STEPS
        r["idle_share"] = None if busy is None else 1 - r["busy_ms"] / r["step_ms"]
        r["kernels"] = [] if busy is None else busy["kernels"]
    missing = [k for k in need if not any(k in name for name in out["graphs"]["kernels"])]
    g, e = out["graphs"], out["eager"]
    say(f"decode horizon {tag} (8 slots, {HZ_STEPS} steps, {HZ_TURNS} turns a route, host clock; "
        f"{CARD}): replayed {g['step_ms']:.3f} ms a step (turns "
        + " / ".join(f"{x:.3f}" for x in g["ms"]) + f"), eager {e['step_ms']:.3f} (turns "
        + " / ".join(f"{x:.3f}" for x in e["ms"]) + "); device busy "
        + (f"{g['busy_ms']:.3f} / {e['busy_ms']:.3f} ms a step, idle share "
           f"{g['idle_share']:.3f} replayed, {e['idle_share']:.3f} eager"
           if g["busy_ms"] is not None and e["busy_ms"] is not None else "not measured")
        + f"; the replayed trace names {[k for k in need if k not in missing]}")
    if missing:
        raise AssertionError(f"decode horizon {tag}: the trace of a replayed horizon lacks "
                             f"{missing}: {out['graphs']['kernels']}")
    return out


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
                     sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in REQ_LENS]
        reqs = [Request(prompt_tokens=p, max_new_tokens=32) for p in prompts]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        # the eager twin: the same requests through graphs=False
        twin = Engine(eng.params, cfg, max_slots=8, max_len=2048, eos_token_id=None,
                      sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV,
                      graphs=False)
        twin_reqs = [Request(prompt_tokens=p, max_new_tokens=32) for p in prompts]
        reset_counts()
        t0 = time.time()
        twin.run(twin_reqs)
        torch.cuda.synchronize()
        twin_wall = time.time() - t0
        twin_counts = read_counts()
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
    twin_same = [r.output_tokens for r in reqs] == [r.output_tokens for r in twin_reqs]
    table = eng._graphs
    steps_n, steps_r = table.count(STEP_PIECES)
    adm_n, adm_r = table.count(ADMISSION_PIECES)
    kinds = sorted({piece(k) for k in table.captured if piece(k) in ADMISSION_PIECES})
    say(f"engine {tag} routes: {eng.route} ({steps_n} step graphs captured, {steps_r} "
        f"replays), admission graphs ({adm_n} pieces of {kinds} captured, {adm_r} replays; "
        f"{table.capture_s:.2f} s of capture in all) beside its eager twin ({twin.route}): tokens "
        f"{'bit-equal' if twin_same else 'DIFFERENT'}, launches "
        f"{'equal' if twin_counts == counts else f'DIFFERENT {twin_counts}'}; wall {wall:.2f} s "
        f"replayed, {twin_wall:.2f} s eager")
    if not twin_same or twin_counts != counts or eng.route != "graphs" or not steps_r:
        raise AssertionError(f"engine {tag}: the replayed run and its eager twin differ")
    out["twin"] = dict(route=eng.route, graphs=steps_n, capture_s=table.capture_s,
                       replays=steps_r, admission_pieces=adm_n, admission_replays=adm_r,
                       wall_s=wall, twin_wall_s=twin_wall, tokens_equal=twin_same,
                       launches_equal=twin_counts == counts)
    out["horizon"] = decode_turns({"graphs": eng, "eager": twin}, tag, a8)
    del twin

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
    if not a8:
        materialize_check(params, cfg, out)
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
                     sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV)
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
    "tinyllama_tp2": (2, 1024, 16, 2, 64, 900, torch.bfloat16),  # a tp = 2 rank's heads
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
    for name in ("tinyllama", "tinyllama_tp2", "llama2_7b", "d256", "d256_mqa") + F32_TIMED:
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
# the resumed cycle (fused: the weights quantized once a cycle) against the
# uninterrupted stepwise run's mean loss of the same two micro-batches, from
# the same latents: the same forwards up to the fused route's remat. Read:
# 4.8e-8 relative on an H100 80GB HBM3 at 700 W, in every call.
RESUME_LOSS_TOL = 5e-7
# The resumed run's final master against the uninterrupted run's, by the
# update both made from the step-2 master m2: ||m - m_ref|| / ||m_ref - m2||
# over the whole tree. Both cycles take the mean gradient of the same two
# micro-batches (the fused one rounds it to bf16 at the quantized weights)
# and make one Adam step from the restored moments. A rank's part of the
# master left unmoved reads about 0.7 here, an update of half the size 0.5.
# Read: 0.00251 on an H100 80GB HBM3 at 700 W.
RESUME_MASTER_TOL = 0.01


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

    def __call__(self, s, **kw):  # an HF tokenizer's call: .input_ids
        return types.SimpleNamespace(input_ids=self.encode(s))


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
    """Host seconds of the rendezvous, the HF load and the final save that
    run_training makes itself: the pipeline module's three references,
    wrapped for one run (each call ends on a synchronised device)."""

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
        self.saved = (pipeline.load_hf_checkpoint, pipeline.save_hf_checkpoint,
                      pipeline.init_distributed, pipeline.save_checkpoint)
        pipeline.load_hf_checkpoint = self._timed("load_f32_s", self.saved[0])
        pipeline.save_hf_checkpoint = self._timed("final_save_f32_s", self.saved[1])
        pipeline.init_distributed = self._timed("nccl_init_s", self.saved[2])
        self.saves: list = []  # (micro-step, host seconds) of each train-state checkpoint
        self.host_rise: list = []  # the resident memory's rise during each
        save = self._timed("checkpoint_s", self.saved[3])

        def save_checkpoint(ckpt_dir, step, state):
            with RssRise() as rss:
                out = save(ckpt_dir, step, state)
            self.saves.append((step, self.s["checkpoint_s"]))
            self.host_rise.append(rss.rise)
            return out

        pipeline.save_checkpoint = save_checkpoint
        return self

    def __exit__(self, *exc):
        (pipeline.load_hf_checkpoint, pipeline.save_hf_checkpoint,
         pipeline.init_distributed, pipeline.save_checkpoint) = self.saved
        return False


class CycleTimes:
    """Each fused cycle of one run timed by the port's StepTimer (host clock,
    ended by a synchronize) beside CUDA events around the same call: the
    pipeline's make_fused_train_step, wrapped for one run."""

    def __enter__(self):
        self.saved, self.timer, self.events_ms = pipeline.make_fused_train_step, StepTimer(), []

        def make(*a, **kw):
            step = self.saved(*a, **kw)

            def timed(*args):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                holder = []
                with self.timer.step(holder):
                    start.record()
                    out = step(*args)
                    end.record()
                    holder.append(out[1]["loss"])
                end.synchronize()
                self.events_ms.append(start.elapsed_time(end))
                return out

            return timed

        pipeline.make_fused_train_step = make
        return self

    def __exit__(self, *exc):
        pipeline.make_fused_train_step = self.saved
        return False


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir() if f.suffix == ".safetensors")


def train_run(args=None, model=None, argv=None, saves=()) -> dict:
    """One run_training, injected (`args`, `model`) or through `cli train`
    in process (`argv`), peak memory reset before it; its summary, wall
    seconds, peak memory and metrics.jsonl, with each micro-step's and each
    cycle's ms. A micro-step's loss is read back before the next starts, so
    its seconds_per_step ends on a synchronised step. `saves`: the (step,
    seconds) of the run's checkpoint writes (a list filled as it runs),
    taken out of the micro-step whose interval holds them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if argv is None:
        summary, out_dir = run_training(args, tokenizer=ByteTok(), model=model), args.output_dir
    else:
        summary, out_dir = port_cli.main(argv), argv[argv.index("--output_dir") + 1]
    torch.cuda.synchronize()
    wall = time.time() - t0
    metrics = [json.loads(line) for line in open(Path(out_dir) / "metrics.jsonl")]
    ends = [m["step"] * m["seconds_per_step"] for m in metrics]  # since the loop began
    micro_ms = [(b - a) * 1e3 for a, b in zip([0.0] + ends, ends)]
    for step, sec in saves:  # written after micro-step `step`, before the next ends
        if step < len(micro_ms):
            micro_ms[step] -= sec * 1e3
    return dict(summary=summary, wall_s=wall, peak=torch.cuda.max_memory_allocated(),
                losses=[m["loss"] for m in metrics],
                grad_norms=[m["grad_norm"] for m in metrics], micro_step_ms=micro_ms,
                cycle_ms=[sum(micro_ms[:2]), sum(micro_ms[2:4])])


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_train_argv(data, out, clip, model, *extra) -> list:
    """`cli train` flags for train_args's run (teacher_flash: the CLI has no
    flag; BITDISTILLER_TRAIN_FLASH=1 routes the teacher as teacher_flash
    does), joining a process group of one rank over NCCL."""
    return ["train", "--model_name_or_path", str(model), "--data_path", str(data),
            "--output_dir", str(out), "--bits", "2", "--q_group_size", "64", "--quant_type",
            "int2-asym", "--clip", str(clip), "--kd_loss_type", "cakld", "--cakld_steps", "2",
            "--learning_rate", "8e-6", "--num_train_epochs", "1",
            "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "2",
            "--model_max_length", "1024", "--lr_scheduler_type", "constant", "--warmup_ratio",
            "0.0", "--eval_steps", "0", "--logging_steps", "1", "--seed", "0", "--tp", "1",
            "--param_dtype", "bfloat16", "--remat_policy", "full", "--coordinator_address",
            f"127.0.0.1:{free_port()}", "--num_processes", "1", "--process_id", "0",
            "--device", DEV, *extra]


def predicted_b8(layers: int, cakld_steps: int, micro_steps: int) -> dict:
    """B8's launches in a KD run with remat "full": the teacher's forward a
    layer a CAKLD batch; a micro-step's student and teacher forwards and the
    student's recompute in the backward; its dkv and dq once a layer."""
    return dict(train_attn_fwd=layers * (cakld_steps + 3 * micro_steps),
                train_attn_bwd_dkv=layers * micro_steps, train_attn_bwd_dq=layers * micro_steps)


# ---- stages 1 and 2 of the method: AutoClip and teacher generation --------------

FIXTURES = Path(__file__).resolve().parent / "fixtures"
CALIB_FIXTURE = FIXTURES / "wikitext__wikitext-2-raw-v1__test.jsonl"
CALIB_BLOCKS, CALIB_BLOCK = 128, 1024
CLIP_TOKENS = 512  # n_sample_token
# the search on the card against the same function on the CPU (f32, other
# summation orders): clips equal in at least this share, and where one
# differs its objective within CLIP_OBJ_TOL relative of the other's
CLIP_SAME_SHARE = 0.99
CLIP_OBJ_TOL = 1e-4
# the invariant: the chosen clip's objective <= shrink (1, 1)'s, both
# recomputed on the card, within this relative slack
CLIP_INVARIANT_TOL = 1e-6
# generation: every prompt is at least 304 tokens, so 720 new tokens put every
# training row (prompt, completion, "</s>") past 1024: micro-batches 2 x 1024
GEN_NEW_TOKENS = 720


class AutoclipTimes:
    """Host seconds of run_autoclip's capture and search calls (each ends on
    a synchronised device), and the (weight, sampled input, clips) of every
    search of the layers in `keep`: autoclip's two module references,
    wrapped for one run."""

    def __init__(self, cfg, keep):
        self.s = {"capture_s": 0.0, "search_s": 0.0}
        self.targets = autoclip.clip_linears(cfg)
        self.keep = keep
        self.calls = 0
        self.kept: dict = {}

    def _timed(self, key, fn, record=False):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.s[key] += time.time() - t0
            if record:  # run_autoclip searches the targets in order, layer by layer
                li, i = divmod(self.calls, len(self.targets))
                if li in self.keep:
                    self.kept[(li, self.targets[i])] = (args[0], args[1], out)
                self.calls += 1
            return out
        return call

    def __enter__(self):
        self.saved = (autoclip.capture_block_inputs, autoclip.search_layer_clip)
        autoclip.capture_block_inputs = self._timed("capture_s", self.saved[0])
        autoclip.search_layer_clip = self._timed("search_s", self.saved[1], record=True)
        return self

    def __exit__(self, *exc):
        autoclip.capture_block_inputs, autoclip.search_layer_clip = self.saved
        return False


def clip_objective(w_kn, feat, mx, mn, n_bit, group_size):
    """[N, K/G] f32 on the tensors' device: the search's objective, the mean
    over the sampled rows of (x_g . w_g - x_g . q_g)^2, q_g the group clamped
    to [mn, mx] and fake quantized at int n_bit."""
    k, n = w_kn.shape
    ng = k // group_size
    w = w_kn.float().t().reshape(n, ng, group_size).transpose(0, 1)  # [ng, N, G]
    mx = torch.as_tensor(mx).to(w.device).t()[..., None]
    mn = torch.as_tensor(mn).to(w.device).t()[..., None]
    q = autoclip._quantize_for_search(torch.clamp(w, mn, mx), "int", n_bit, group_size)
    f = feat.float().reshape(-1, ng, group_size).transpose(0, 1)  # [ng, T, G]
    org = torch.bmm(f, w.transpose(1, 2))
    out = torch.bmm(f, q.transpose(1, 2))
    return (out - org).square().mean(dim=1).t()  # [N, ng]


def autoclip_stage(ckpt: Path, tmp: Path, card: str, rec: dict) -> Path:
    """Stage 1 through `cli autoclip` (in process; the byte tokenizer through
    the CLI's `_load_tokenizer`): the CLI loads the checkpoint in bf16, cuts
    128 blocks of 1024 tokens from the wikitext fixture's text rows, runs
    run_autoclip at int2 g64 on 512 sampled rows and saves the cache.
    Checks: the blocks' shape; layer 0's v and the first 256 columns of its
    down searched on the CPU in f32 against the card (CLIP_SAME_SHARE,
    CLIP_OBJ_TOL); every chosen clip of layers 0 and 21 no worse than
    shrink (1, 1) (CLIP_INVARIANT_TOL); the cache holds those layers'
    searches bit for bit, and its clamp of the loaded tree (apply_clip_cache)
    equals each group clamped to its range. Returns the cache's path."""
    cfg = TINYLLAMA_1B
    with open(CALIB_FIXTURE) as f:
        (tmp / "calib.txt").write_text("".join(json.loads(x)["text"] for x in f if x.strip()))
    calib = np.concatenate(get_calib_dataset("text", ByteTok(), n_samples=CALIB_BLOCKS,
                                             block_size=CALIB_BLOCK,
                                             data_path=str(tmp / "calib.txt")))
    if calib.shape != (CALIB_BLOCKS, CALIB_BLOCK):
        raise AssertionError(f"autoclip: calibration blocks {calib.shape}")
    last = cfg.num_layers - 1
    clip_path = tmp / "clip.npz"
    torch.cuda.synchronize()
    t0 = time.time()
    with AutoclipTimes(cfg, keep=(0, last)) as times:
        port_cli.main(["autoclip", "--model_path", str(ckpt), "--w_bit", "2", "--q_group_size",
                       "64", "--quant_type", "int", "--dump_clip", str(clip_path),
                       "--calib_dataset", "text", "--calib_path", str(tmp / "calib.txt"),
                       "--n_samples", str(CALIB_BLOCKS), "--seqlen", str(CALIB_BLOCK),
                       "--device", DEV])
    torch.cuda.synchronize()
    wall = time.time() - t0
    kept = times.kept
    if times.calls != len(times.targets) * cfg.num_layers:
        raise AssertionError(f"autoclip: {times.calls} searches, not one a linear a layer")
    params, _ = load_hf_checkpoint(str(ckpt), dtype=torch.bfloat16, device=DEV)

    # the card's search against the CPU's, f32, on the same inputs
    vs_cpu = {}
    for name, cols in (("v", None), ("down", 256)):
        w, feat, (bmax, bmin) = kept[(0, name)]
        w = w[:, :cols] if cols else w
        card_max, card_min = bmax[:cols], bmin[:cols]
        cpu_max, cpu_min = autoclip.search_layer_clip(w.float().cpu(), feat.float().cpu(),
                                                      quant_type="int", n_bit=2, group_size=64)
        same = torch.eq(card_max.cpu(), cpu_max) & torch.eq(card_min.cpu(), cpu_min)
        o_card = clip_objective(w, feat, card_max, card_min, 2, 64).cpu()
        o_cpu = clip_objective(w, feat, cpu_max.to(DEV), cpu_min.to(DEV), 2, 64).cpu()
        rel = ((o_card - o_cpu).abs() / o_cpu.abs().clamp(min=1e-30))[~same]
        worst = rel.max().item() if rel.numel() else 0.0
        vs_cpu[name] = dict(shape=list(w.shape), same_share=same.float().mean().item(),
                            differ=int((~same).sum()), worst_objective_rel=worst)
        if same.float().mean().item() < CLIP_SAME_SHARE or worst > CLIP_OBJ_TOL:
            raise AssertionError(f"autoclip: layer 0's {name} on the card disagrees with the "
                                 f"CPU search: {vs_cpu[name]}")
    # the invariant: no chosen clip worse than the unclipped grid point
    worst_inv, checked = 0.0, 0
    for (li, name), (w, feat, (bmax, bmin)) in kept.items():
        wg = w.float().t().reshape(w.shape[1], -1, 64)
        chosen = clip_objective(w, feat, bmax, bmin, 2, 64)
        plain = clip_objective(w, feat, wg.amax(-1), wg.amin(-1), 2, 64)
        excess = ((chosen - plain) / plain.abs().clamp(min=1e-30)).max().item()
        worst_inv, checked = max(worst_inv, excess), checked + chosen.numel()
        if excess > CLIP_INVARIANT_TOL:
            raise AssertionError(f"autoclip: layer {li} {name}: a chosen clip is worse than "
                                 f"shrink (1, 1) by {excess:.3g} relative")
    # the cache: holds the searches; its clamp of the loaded tree is each
    # group clamped to its range
    loaded = autoclip.load_clip_cache(str(clip_path))
    clipped = autoclip.apply_clip_cache(params, loaded)
    for (li, name), (w, _, (bmax, bmin)) in kept.items():
        mx, mn = loaded[li][name]
        if not (np.array_equal(mx, bmax.cpu().numpy()) and np.array_equal(mn, bmin.cpu().numpy())):
            raise AssertionError(f"autoclip: the cache of layer {li} {name} is not its search's")
        k, n = w.shape
        wg = w.float().t().reshape(n, k // 64, 64)
        want = torch.clamp(wg, torch.as_tensor(mn, device=DEV)[..., None],
                           torch.as_tensor(mx, device=DEV)[..., None])
        if not torch.equal(clipped["layers"][name]["w"][li], want.reshape(n, k).t().to(w.dtype)):
            raise AssertionError(f"autoclip: apply_clip_cache of layer {li} {name} is not the "
                                 f"groups clamped to their ranges")
    groups = shrunk = 0
    for li, layer in loaded.items():
        for name, (mx, mn) in layer.items():
            w = params["layers"][name]["w"][li]
            wg = w.float().t().reshape(w.shape[1], -1, 64)
            groups += mx.size
            shrunk += int(((torch.as_tensor(mx, device=DEV) != wg.amax(-1))
                           | (torch.as_tensor(mn, device=DEV) != wg.amin(-1))).sum())
    s = times.s
    rec.update(blocks=list(calib.shape), n_sample_token=CLIP_TOKENS, group_size=64, bits=2,
               wall_s=wall, capture_s=s["capture_s"], search_s=s["search_s"],
               s_per_layer=wall / cfg.num_layers, groups=groups, groups_shrunk=shrunk,
               vs_cpu=vs_cpu, invariant_worst_rel=worst_inv, invariant_checked=checked,
               cache_bytes=clip_path.stat().st_size, through="cli autoclip")
    say(f"autoclip TinyLlama-1.1B through `cli autoclip` from its checkpoint ({card}): "
        f"{CALIB_BLOCKS} x {CALIB_BLOCK} calibration tokens, int2 g64, {CLIP_TOKENS} sampled "
        f"rows; run {wall:.2f} s (the CLI's load included; capture {s['capture_s']:.2f} s, search "
        f"{s['search_s']:.2f} s, {wall / cfg.num_layers:.3f} s a layer); {shrunk} of {groups} "
        f"groups clipped at a shrink other than 1")
    say(f"autoclip checks: card vs CPU search, v {vs_cpu['v']['same_share']:.4f} equal (worst "
        f"objective {vs_cpu['v']['worst_objective_rel']:.3g}), down[:, :256] "
        f"{vs_cpu['down']['same_share']:.4f} (worst {vs_cpu['down']['worst_objective_rel']:.3g}) "
        f"(>= {CLIP_SAME_SHARE}, tol {CLIP_OBJ_TOL}); layers 0 and {last}: {checked} chosen "
        f"clips no worse than shrink (1, 1) (worst {worst_inv:.3g}, tol {CLIP_INVARIANT_TOL}); "
        f"the cache holds their searches and clamps the loaded tree group by group")
    del params, clipped, kept, times
    torch.cuda.empty_cache()
    return clip_path


class EngineCapture:
    """The Engines the teacher-generation module builds while inside (the
    module's reference, wrapped for one run)."""

    def __enter__(self):
        self.engines, self.saved = [], teacher_mod.Engine

        def build(*a, **kw):
            self.engines.append(self.saved(*a, **kw))
            return self.engines[-1]

        teacher_mod.Engine = build
        return self

    def __exit__(self, *exc):
        teacher_mod.Engine = self.saved
        return False


def generation_stage(ckpt: Path, prompts: Path, tmp: Path, card: str, rec: dict,
                     params) -> Path:
    """Stage 2 through `cli generate` (in process): the CLI's
    run_teacher_generation (bf16, the dense engine, 8 slots, 2048 rows,
    temperature 0.7, top_p 1.0, 720 new tokens) on the prompts of the
    [[p, r]] file, its counts reset before and read after. Checks: 10 lines
    in prompt order, each prompt templated and each completion non-empty;
    B3's launches exactly 22 layers times the engine's decode steps, no
    packed matmul, no other kernel; one decode step of the dense model
    through the kernels against use_kernels=False within LOGIT_TOL
    (`params`: the tree the checkpoint holds). Returns the generated file."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with EngineCapture() as cap:
        out = Path(port_cli.main([
            "generate", "--base_model", str(ckpt), "--dataset_name", "json", "--data_path",
            str(prompts), "--out_path", str(tmp / "generated.jsonl"), "--max_sample", "5000",
            "--max_new_tokens", str(GEN_NEW_TOKENS), "--temperature", "0.7", "--top_p", "1.0",
            "--max_batch", "8", "--max_seq_len", "2048", "--seed", "0", "--device", DEV]))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    if len(cap.engines) != 1:
        raise AssertionError(f"generation: {len(cap.engines)} engines")
    steps = cap.engines[0].decode_steps
    want_b3 = TINYLLAMA_1B.num_layers * steps
    if counts["flash_decode"] != want_b3 or any(v for k, v in counts.items() if k != "flash_decode"):
        raise AssertionError(f"generation: launches {counts}, predicted B3 {want_b3} "
                             f"({steps} decode steps x 22 layers) and nothing else")
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    want = [json.loads(x)[0][0] for x in prompts.read_text().splitlines() if x.strip()]
    style = gen_datasets.PROMPT_STYLES[gen_datasets.style_for_dataset("json")]
    if [x[0][0] for x in lines] != [style.format(instruction=p) for p in want]:
        raise AssertionError("generation: the prompts are not the templated prompts in order")
    if len(lines) != 10 or not all(x[0][1] for x in lines):
        raise AssertionError(f"generation: {len(lines)} lines, or an empty completion")
    layers = TINYLLAMA_1B.num_layers
    tokens = sum(len(x[0][1]) for x in lines)  # ByteTok: a character a token
    # the training rows (prompt, completion, "</s>") and their micro-batches
    ds = SupervisedDataset.from_jsonl(str(out), ByteTok.eos_token, None, "train", 0)
    rows = [len(ByteTok().encode(s + t)) for s, t in zip(ds.sources, ds.targets)]
    shapes = {tuple(b["input_ids"].shape) for b in data_loader(ds, Collator(ByteTok(), 1024), 2)}
    if shapes != {(2, 1024)}:
        raise AssertionError(f"generation: the micro-batches are {shapes}, not 2 x 1024")
    step = dense_step_check(params)
    rec.update(lines=len(lines), new_tokens=GEN_NEW_TOKENS, tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, launches=counts, decode_steps=steps,
               predicted_b3=want_b3, row_tokens=rows, decode_check=step, through="cli generate")
    say(f"generation TinyLlama-1.1B through `cli generate` from its checkpoint ({card}): 10 "
        f"prompts, 8 slots, temperature 0.7; {tokens} tokens in {wall:.2f} s -> "
        f"{tokens / wall:.1f} tokens/s; B3 {counts['flash_decode']} launches = {layers} layers x "
        f"{steps} decode steps, as predicted, no other kernel; training rows "
        f"{min(rows)}-{max(rows)} tokens, micro-batches 2 x 1024")
    say(f"generation decode step, dense bf16, kernels vs plain: max|dlogit| {step['err']:.4g} of "
        f"{step['max']:.4g} (tol {LOGIT_TOL} relative)")
    return out


def dense_step_check(params) -> dict:
    """One decode step of the dense bf16 TinyLlama on an engine's cache
    after 4 requests, through B3 against use_kernels=False on the same
    cache."""
    cfg = TINYLLAMA_1B
    eng = Engine(params, cfg, max_slots=4, max_len=512, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV)
    rng = np.random.default_rng(2)
    eng.run([Request(prompt_tokens=rng.integers(3, 253, n).tolist(), max_new_tokens=8)
             for n in (40, 120, 64, 200)])
    pos = torch.as_tensor(eng.lengths, dtype=torch.int32, device=DEV)
    tok = torch.randint(3, 253, (4, 1), device=DEV)
    with torch.inference_mode():
        lk, _ = forward(params, cfg, tok, cache=eng.cache, cache_pos=pos + 4)
        lp, _ = forward(params, cfg, tok, cache=eng.cache, cache_pos=pos + 4, use_kernels=False)
    err, top = (lk - lp).abs().max().item(), lp.abs().max().item()
    if not (torch.isfinite(lk).all() and err <= LOGIT_TOL * top):
        raise AssertionError(f"generation: the dense decode step disagrees with the plain path "
                             f"({err} of {top})")
    del eng
    torch.cuda.empty_cache()
    return dict(err=err, max=top)


def train_phase(card, rec):
    """The three stages of the method at the full width and depth of
    TinyLlama-1.1B (random bf16 weights from seed 0), from one checkpoint on
    disk: the tree is written with save_hf_checkpoint (bf16) first; stage 1,
    AutoClip on it (`autoclip_stage`); stage 2, teacher generation on it
    (`generation_stage`), whose file is the training data; stage 3,
    run_training with the clip cache and that data: int2-asym STE at g64,
    CAKLD with beta from estimate_cakld_beta, micro-batch 2 x 1024,
    grad_accum 2, two optimizer cycles, student and teacher through B8
    (BITDISTILLER_TRAIN_FLASH=1 and teacher_flash, for this phase only),
    remat "full". Stages 1 and 2 go through `cli autoclip` and `cli
    generate`, and `cli mix_data` merges the generated file with the
    prompts. The first micro-step is held against the plain attention; then
    the tree is handed to run_training (injected, one device, no process
    group), and `cli train` loads the checkpoint itself (in f32: exact
    upcasts of the same bf16 values) in a process group of one rank over
    NCCL at ZeRO 2, saves the full state every 2 micro-steps, trains and
    writes its final f32 save: the main path, its counts reset just before
    and read just after. Its losses and gradient norms must equal the
    injected run's bit for bit, and B8's launches the count predicted from
    the run. Then `cli train --resume --fused_accum --zero_stage 3` under
    BITDISTILLER_DEBUG=1 (the checked step) from a copy of the step-2
    checkpoint trains cycle 2 in the fused format: its loss within
    RESUME_LOSS_TOL of the uninterrupted run's, its B8 launches as
    predicted, the cycle timed by StepTimer beside CUDA events. The second
    cycle of the first run, past the first launches, gives ms a cycle and
    tokens/s. Returns the final master, the config and the temp dir that
    holds the bf16 checkpoint ("init", the teacher) and the final save
    ("out", the student): serve_trained reads the save, the eval phase both,
    and the eval phase removes the dir."""
    cfg = TINYLLAMA_1B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    tmp = Path(tempfile.mkdtemp(prefix="bd_train_"))
    saved = os.environ.get("BITDISTILLER_TRAIN_FLASH")
    saved_tok = port_cli._load_tokenizer
    port_cli._load_tokenizer = lambda path: ByteTok()  # the card has no transformers
    try:
        prompts = tmp / "teacher.jsonl"
        write_teacher_jsonl(prompts)
        torch.cuda.synchronize()
        t0 = time.time()
        save_hf_checkpoint(params, cfg, str(tmp / "init"), dtype=torch.bfloat16)
        save_s = time.time() - t0
        init_bytes = dir_bytes(tmp / "init")
        rec.update(autoclip={}, generation={}, disk_free_bytes=shutil.disk_usage(tmp).free)
        clip = str(autoclip_stage(tmp / "init", tmp, card, rec["autoclip"]))
        data = generation_stage(tmp / "init", prompts, tmp, card, rec["generation"], params)
        rec["mix_data"] = mix_data_check(data, prompts, tmp)
        busy = first_step_check(params, cfg, data, rec)
        os.environ["BITDISTILLER_TRAIN_FLASH"] = "1"
        ref = train_run(train_args(data, tmp / "injected", clip=clip), model=(params, cfg))
        del ref["summary"]
        shutil.rmtree(tmp / "injected")
        del params
        torch.cuda.empty_cache()
        reset_counts()
        with CheckpointTimes() as io:
            run = train_run(argv=cli_train_argv(data, tmp / "out", clip, tmp / "init",
                                                "--zero_stage", "2", "--save_steps", "2"),
                            saves=io.saves)
        counts = read_counts()
        del run["summary"]["state"]  # 19.8 GB on the card; the summary keeps the master
        # the resume run starts from a copy (hard links) of the step-2 checkpoint
        (tmp / "resume" / "step_2").mkdir(parents=True)
        for f in (tmp / "out" / "step_2").iterdir():
            os.link(f, tmp / "resume" / "step_2" / f.name)
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "out" / "step_2").iterdir())
        largest_leaf = largest_part(tmp / "out" / "step_2")
        for step in ("step_2", "step_4"):
            shutil.rmtree(tmp / "out" / step)
        torch.cuda.empty_cache()
        os.environ["BITDISTILLER_DEBUG"] = "1"
        reset_counts()
        with CheckpointTimes() as rio, CycleTimes() as cycles:
            resumed = train_run(argv=cli_train_argv(
                data, tmp / "resume", clip, tmp / "init", "--zero_stage", "3", "--save_steps",
                "0", "--resume", "--fused_accum"))
        resume_counts = read_counts()
        del resumed["summary"]["state"]
        master_gap = update_gap(resumed["summary"].pop("master"), run["summary"]["master"],
                                tmp / "resume" / "step_2")
        shutil.rmtree(tmp / "resume")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        port_cli._load_tokenizer = saved_tok
        os.environ.pop("BITDISTILLER_DEBUG", None)
        if saved is None:
            os.environ.pop("BITDISTILLER_TRAIN_FLASH", None)
        else:
            os.environ["BITDISTILLER_TRAIN_FLASH"] = saved
    summary, losses, micro_ms, cycle_ms = (run["summary"], run["losses"], run["micro_step_ms"],
                                           run["cycle_ms"])
    need = ("train_attn_fwd", "train_attn_bwd_dkv", "train_attn_bwd_dq")
    want_b8 = predicted_b8(cfg.num_layers, 2, 4)
    want_b8_resume = predicted_b8(cfg.num_layers, 2, 2)
    resume_loss = resumed["losses"][-1] if resumed["losses"] else float("nan")
    uninterrupted = (losses[2] + losses[3]) / 2 if len(losses) == 4 else float("nan")
    resume_gap = abs(resume_loss - uninterrupted) / abs(uninterrupted)
    tokens = 2 * 2 * 1024  # a cycle: grad_accum 2 x micro-batch 2 x 1024 positions
    rec.update(config="TINYLLAMA_1B", layers=cfg.num_layers, micro_batch=[2, 1024],
               grad_accum=2, cycles=2, beta=summary["beta"], losses=losses,
               grad_norms=run["grad_norms"], launches=counts, wall_s=run["wall_s"],
               micro_step_ms=micro_ms, cycle_ms=cycle_ms,
               tokens_per_s=tokens / cycle_ms[1] * 1e3, max_memory_allocated=run["peak"],
               profile=busy, injected={k: ref[k] for k in ref}, through="cli train",
               zero_stage=2, world_size=1, predicted_launches=want_b8,
               checkpoint_io=dict(save_bf16_s=save_s, save_bf16_bytes=init_bytes, **io.s,
                                  final_save_bytes=dir_bytes(tmp / "out"),
                                  train_state_bytes=ckpt_bytes, train_state_saves=io.saves,
                                  save_host_rise_bytes=io.host_rise,
                                  largest_leaf_bytes=largest_leaf),
               resume=dict(loss=resume_loss, uninterrupted=uninterrupted, rel_gap=resume_gap,
                           tol=RESUME_LOSS_TOL, master_update_gap=master_gap,
                           master_tol=RESUME_MASTER_TOL, launches=resume_counts,
                           predicted_launches=want_b8_resume, wall_s=resumed["wall_s"],
                           max_memory_allocated=resumed["peak"], steps=resumed["summary"]["steps"],
                           cycle_step_timer_ms=cycles.timer.mean_ms,
                           cycle_events_ms=cycles.events_ms, io=rio.s))
    try:
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses) or summary["steps"] != 4:
            raise AssertionError(f"training: {summary['steps']} micro-steps, losses {losses}")
        if {k: counts[k] for k in need} != want_b8:
            raise AssertionError(f"cli train's B8 launches {counts}, predicted {want_b8}")
        say(f"train TinyLlama-1.1B through `cli train` from its checkpoint ({cfg.num_layers} "
            f"layers, int2-asym g64 "
            f"STE, the clip cache, the generated data, CAKLD beta {summary['beta']:.4f}; {card}): "
            f"launches "
            f"{ {k: counts[k] for k in need} }, run {run['wall_s']:.1f} s; micro-steps "
            f"{[round(x, 1) for x in micro_ms]} ms, cycles {[round(x, 1) for x in cycle_ms]} ms; "
            f"the second cycle (2 x 2 x 1024 positions) -> {tokens / cycle_ms[1] * 1e3:.0f} "
            f"tokens/s; peak memory {run['peak'] / 2**30:.2f} GiB")
        for name, key in (("losses", "losses"), ("grad norms", "grad_norms"),
                          ("micro-step ms", "micro_step_ms"), ("cycle ms", "cycle_ms")):
            say(f"train {name}: cli train from the checkpoint {run[key]!r} | injected tree "
                f"{ref[key]!r}")
        say(f"train run: cli train {run['wall_s']:.2f} s | injected tree {ref['wall_s']:.2f} s")
        if losses != ref["losses"] or run["grad_norms"] != ref["grad_norms"]:
            raise AssertionError("cli train (NCCL, world size 1, ZeRO 2) is not bit-equal to the "
                                 "injected tree's run")
        say(f"train through `cli train` (NCCL at world size 1, ZeRO 2, rendezvous "
            f"{io.s['nccl_init_s']:.3f} s): the 4 losses and grad norms bit-equal to the injected "
            f"single-device run; B8 launches as predicted {want_b8}; the train state's "
            f"checkpoints {ckpt_bytes / 1e9:.2f} GB each, written in "
            f"{[round(sec, 2) for _, sec in io.saves]} s (taken out of the micro-step ms)")
        say(f"train checkpoint (C9 format: rank{{r}}.safetensors + manifest.json, each rank "
            f"its own parts; {card}): {ckpt_bytes / 1e9:.3f} GB a checkpoint, written in "
            f"{[round(sec, 2) for _, sec in io.saves]} s; this process's resident memory rose "
            f"{[round(x / 1e9, 3) for x in io.host_rise]} GB during each write (the writer "
            f"copies one leaf to the host at a time; the largest leaf "
            f"{largest_leaf / 1e9:.3f} GB)")
        say(f"train resume (cli train --resume --fused_accum --zero_stage 3, BITDISTILLER_DEBUG=1, "
            f"from the stepwise ZeRO-2 step-2 checkpoint): cycle 2 loss {resume_loss!r} vs the "
            f"uninterrupted run's {uninterrupted!r} (relative gap {resume_gap:.3g}, tol "
            f"{RESUME_LOSS_TOL}); the final master's update {master_gap:.4g} from the "
            f"uninterrupted run's (||m - m_ref|| / ||m_ref - m2||, tol {RESUME_MASTER_TOL}); B8 "
            f"launches {({k: resume_counts[k] for k in need})} (predicted "
            f"{want_b8_resume}); the cycle {cycles.timer.mean_ms:.1f} ms (StepTimer) vs "
            f"{cycles.events_ms} ms (CUDA events); run {resumed['wall_s']:.1f} s, rendezvous "
            f"{rio.s['nccl_init_s']:.3f} s")
        say(f"train peak memory ({card}): injected tree {ref['peak'] / 2**30:.3f} GiB | cli train "
            f"ZeRO 2 {run['peak'] / 2**30:.3f} GiB | resume fused ZeRO 3 checked "
            f"{resumed['peak'] / 2**30:.3f} GiB (the first run's f32 master held beside it)")
        if resumed["summary"]["steps"] != 4 or len(resumed["losses"]) != 1:
            raise AssertionError(f"resume: {resumed['summary']['steps']} micro-steps, losses "
                                 f"{resumed['losses']}")
        if not resume_gap <= RESUME_LOSS_TOL:
            raise AssertionError(f"resume: cycle 2's loss {resume_loss} vs {uninterrupted}")
        if not master_gap <= RESUME_MASTER_TOL:
            raise AssertionError(f"resume: the final master's update lies {master_gap} from the "
                                 f"uninterrupted run's")
        if {k: resume_counts[k] for k in need} != want_b8_resume:
            raise AssertionError(f"resume: B8 launches {resume_counts}, predicted "
                                 f"{want_b8_resume}")
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
    master = summary["master"]
    del summary, run
    return master, cfg, tmp


def update_gap(master: dict, ref: dict, ckpt: Path) -> float:
    """||master - ref|| / ||ref - m2|| over the whole f32 tree, m2 the
    master the checkpoint dir `ckpt` holds (read leaf by leaf from its
    memory-mapped parts)."""
    num = den = 0.0
    for path, want in tr.tree_items(ref):
        got = tr._get(master, path)
        start = pipeline.read_checkpoint_leaf(str(ckpt),
                                              "opt_state/master/" + "/".join(path)).to(DEV)
        num += float(((got - want).double() ** 2).sum())
        den += float(((want - start).double() ** 2).sum())
    return math.sqrt(num / den)


def largest_part(ckpt: Path) -> int:
    """The bytes of the largest tensor in a checkpoint's part files: the
    largest host copy its writer makes (it copies one tensor at a time)."""
    most = 0
    for f in ckpt.glob("rank*.safetensors"):
        header, _ = safetensors_io.read_header(str(f))
        most = max([most] + [e["data_offsets"][1] - e["data_offsets"][0]
                             for k, e in header.items() if k != "__metadata__"])
    return most


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssRise:
    """The largest rise of this process's resident memory over its level at
    entry, sampled every 5 ms from /proc/self/statm while the block runs."""

    def __enter__(self):
        self.base = self.peak = _rss()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()
        return self

    def _sample(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, _rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.rise = max(self.peak, _rss()) - self.base
        return False


def mix_data_check(generated: Path, prompts: Path, tmp: Path) -> dict:
    """`cli mix_data` of the generated file and the smoke's prompts file:
    as many lines as the two hold, every line kept."""
    out = tmp / "mixed.jsonl"
    port_cli.main(["mix_data", str(generated), str(prompts), "--out", str(out)])
    src = [x for p in (generated, prompts) for x in p.read_text().splitlines() if x.strip()]
    got = out.read_text().splitlines()
    if sorted(got) != sorted(src):
        raise AssertionError(f"cli mix_data: {len(got)} lines, not the {len(src)} of its inputs")
    say(f"cli mix_data: the generated file and the prompts file merged into {len(got)} lines, "
        f"every line kept")
    out.unlink()
    return dict(lines=len(got), sources=len(src))


GPTQ_KEYS = (".qweight", ".qzeros", ".scales", ".g_idx")
# the direct export's packed tree carries bf16 norms, embedding and lm_head
# (f16 of a bf16 copy), the CLI's dense export f16 of the f32 save: a bf16
# rounding apart (2^-8 of the value) plus one f16 rounding, whose step
# below f16's smallest normal (6.1e-5) is 2^-24
GPTQ_AUX_RTOL, GPTQ_AUX_ATOL = 2 ** -7, 2 ** -24


def compare_exports(direct: Path, cli: Path) -> dict:
    """The CLI's GPTQ export against the direct one: the same files, the
    JSON files byte-equal, the same tensors (names, shapes, dtypes), every
    code, zero point and scale equal, the other tensors within
    GPTQ_AUX_RTOL relative plus GPTQ_AUX_ATOL."""
    names = sorted(p.name for p in direct.iterdir())
    if names != sorted(p.name for p in cli.iterdir()):
        raise AssertionError(f"cli export_gptq wrote other files than the direct export: {names}")
    for name in names:
        if name.endswith(".json") and (cli / name).read_bytes() != (direct / name).read_bytes():
            raise AssertionError(f"cli export_gptq: {name} differs from the direct export's")
    a = safetensors_io.read(str(direct / "model.safetensors"))
    b = safetensors_io.read(str(cli / "model.safetensors"))
    if sorted(a) != sorted(b):
        raise AssertionError("cli export_gptq: other tensor names than the direct export")
    exact = aux = 0
    worst = 0.0
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"cli export_gptq: {k} is {y.dtype} {tuple(y.shape)}, the direct "
                                 f"export's {x.dtype} {tuple(x.shape)}")
        if k.endswith(GPTQ_KEYS):
            if not torch.equal(x, y):
                raise AssertionError(f"cli export_gptq: {k} differs from the direct export's")
            exact += 1
        else:
            x, y = x.float(), y.float()
            over = ((x - y).abs() - GPTQ_AUX_ATOL).clamp(min=0) / y.abs().clamp(min=1e-30)
            gap = over.max().item()
            worst = max(worst, gap)
            if gap > GPTQ_AUX_RTOL:
                raise AssertionError(f"cli export_gptq: {k} off the direct export's by {gap:.3g} "
                                     f"relative past {GPTQ_AUX_ATOL:.3g}")
            aux += 1
    return dict(files=names, exact=exact, aux=aux, aux_worst_rel=worst)


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


def plain_packed(packed: dict) -> dict:
    """The packed tree with each PackedLinear's scales and zeros taken back
    from its combo words, as the kernels read them: the tree the plain path
    (use_kernels=False) runs on."""
    ref = dict(packed, layers=dict(packed["layers"]))
    for name, leaf in packed["layers"].items():
        if isinstance(leaf, PackedLinear):
            s, sz = scales_from_combo(leaf.combo)
            ref["layers"][name] = dataclasses.replace(leaf, scales=s, szeros=sz)
    return ref


def serve_trained_phase(master, cfg, tmp: Path, rec):
    """Reload the checkpoint that run_training saved (f32) and hold it bit-equal,
    leaf for leaf, against the run's master; pack_model it at int2-g64, serve
    4 prompts through the Engine on the kernels (counts reset before, read
    after: the g64 prefill and decode go through B1 and B2, the attention
    through B3), hold one decode step's logits against use_kernels=False on
    the same cache, then export the packed student to GPTQ and hold the
    export's codes and scales against the packed leaves. Returns the reloaded
    f32 master and its packed bf16 tree for the eval phase, which removes
    `tmp` (removed here only on a failure)."""
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
        packed = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
                  for k, v in packed.items()}
        packed["layers"] = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
                            for k, v in packed["layers"].items()}
        if "lm_head" in packed:
            packed["lm_head"] = {"w": packed["lm_head"]["w"].to(torch.bfloat16)}
        torch.cuda.empty_cache()
        eng = Engine(packed, cfg, max_slots=4, max_len=512, eos_token_id=None,
                     sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV)
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
        ref = plain_packed(packed)
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
        gx.export_gptq(packed, cfg, str(tmp / "gptq"), bits=2, group_size=64)
        export_s = time.time() - t0
        held = check_gptq_export(packed, cfg, tmp / "gptq")
        torch.cuda.synchronize()
        t0 = time.time()
        port_cli.main(["export_gptq", "--model_path", str(tmp / "out"), "--w_bit", "2",
                       "--q_group_size", "64", "--output", str(tmp / "gptq_cli"), "--device", DEV])
        torch.cuda.synchronize()
        cli_export_s = time.time() - t0
        cli_held = check_gptq_export(packed, cfg, tmp / "gptq_cli")
        same = compare_exports(tmp / "gptq", tmp / "gptq_cli")
        rec.update(requests=4, group_size=64, launches=counts, wall_s=wall,
                   logit_max_abs_err=err, logit_max=scale, reload_f32_s=reload_s,
                   gptq_export_s=export_s, gptq_bytes=dir_bytes(tmp / "gptq"), gptq_held=held,
                   cli_export_gptq=dict(s=cli_export_s, held=cli_held, **same))
        say(f"serve_trained: GPTQ export of the packed student in {export_s:.2f} s "
            f"({dir_bytes(tmp / 'gptq') / 1e9:.3f} GB); {held} code, scale and zero tensors "
            f"held exactly against the packed leaves")
        say(f"serve_trained: `cli export_gptq` of the final save in {cli_export_s:.2f} s (its f32 "
            f"load included): the same {len(same['files'])} files, {cli_held} code, scale and "
            f"zero tensors held exactly against the packed leaves, {same['exact']} GPTQ tensors "
            f"equal to the direct export's, {same['aux']} others within {GPTQ_AUX_RTOL:.3g} "
            f"relative past {GPTQ_AUX_ATOL:.3g} (worst {same['aux_worst_rel']:.3g})")
        shutil.rmtree(tmp / "gptq")
        shutil.rmtree(tmp / "gptq_cli")
        rec["packed_checkpoint"] = packed_checkpoint_check(packed, cfg, tmp, reqs)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return loaded, packed


def packed_leaves(tree) -> dict:
    """{path: tensor} of a packed tree, a PackedLinear's arrays and meta by field."""
    out = {}
    for path, leaf in tr.tree_items(tree):
        if isinstance(leaf, PackedLinear):
            for f in ("qweight", "scales", "szeros", "bias", "combo"):
                if getattr(leaf, f) is not None:
                    out[path + (f,)] = getattr(leaf, f)
            out[path + ("meta",)] = torch.tensor([leaf.bits, leaf.group_size, leaf.in_features,
                                                  leaf.out_features, leaf.a8_order])
        else:
            out[path] = leaf
    return out


def packed_checkpoint_check(packed, cfg, tmp: Path, reqs) -> dict:
    """The packed student through save_packed_checkpoint and
    load_packed_checkpoint: every leaf bit-equal and the config equal; the
    reloaded tree served gives the in-process tree's tokens; the CLI's
    `pack` in a child process, from the HF save, writes the packed.npz of
    the same pack in this process (the checkpoint loaded in bf16, as the CLI
    loads it, packed on the card)."""
    torch.cuda.synchronize()
    t0 = time.time()
    save_packed_checkpoint(tmp / "packed", packed, cfg, bits=2, group_size=64)
    save_s = time.time() - t0
    t0 = time.time()
    reloaded, rcfg = load_packed_checkpoint(tmp / "packed", device=DEV)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    got, want = packed_leaves(reloaded), packed_leaves(packed)
    differ = [p for p in want if p not in got or got[p].dtype != want[p].dtype
              or not torch.equal(got[p].cpu(), want[p].cpu())]
    if rcfg != cfg or sorted(got) != sorted(want) or differ:
        raise AssertionError(f"serve_trained: the packed checkpoint does not reload bit-equal "
                             f"({differ[:4]})")
    eng = Engine(reloaded, cfg, max_slots=4, max_len=512, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV)
    again = [Request(prompt_tokens=r.prompt_tokens, max_new_tokens=16) for r in reqs]
    eng.run(again)
    if [r.output_tokens for r in again] != [r.output_tokens for r in reqs]:
        raise AssertionError("serve_trained: the reloaded packed tree serves other tokens")
    del eng, reloaded
    env = dict(os.environ, PYTHONPATH=str(OUT_DIR.parent))
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "bitdistiller_tpu_torch.cli", "pack",
                          "--model_path", str(tmp / "out"), "--w_bit", "2", "--q_group_size",
                          "64", "--output", str(tmp / "cli_packed"), "--device", DEV],
                         cwd=OUT_DIR.parent, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t0
    if res.returncode:
        raise AssertionError(f"serve_trained: cli pack exited {res.returncode}:\n{res.stderr[-2000:]}")
    bf16, _ = load_hf_checkpoint(str(tmp / "out"), dtype=torch.bfloat16, device=DEV)
    save_packed_checkpoint(tmp / "inproc_packed", pack_model(bf16, cfg, bits=2, group_size=64),
                           cfg, bits=2, group_size=64)
    del bf16
    with np.load(tmp / "cli_packed" / "packed.npz") as a, \
            np.load(tmp / "inproc_packed" / "packed.npz") as b:
        keys = sorted(a.files)
        same = keys == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in keys)
    if not same:
        raise AssertionError("serve_trained: the CLI's packed.npz differs from the in-process one")
    nbytes = (tmp / "packed" / "packed.npz").stat().st_size
    for d in ("packed", "cli_packed", "inproc_packed"):
        shutil.rmtree(tmp / d)
    say(f"serve_trained: packed checkpoint saved in {save_s:.2f} s ({nbytes / 1e9:.3f} GB), "
        f"reloaded bit-equal ({len(want)} arrays) in {load_s:.2f} s, served the same 4 x 16 "
        f"tokens; `cli pack` in a child process ({cli_s:.1f} s) wrote the in-process "
        f"packed.npz ({len(keys)} arrays equal)")
    return dict(save_s=save_s, load_s=load_s, bytes=nbytes, arrays=len(want), cli_pack_s=cli_s,
                npz_arrays=len(keys))


# ---- stage 4, evaluation: the trained student scored --------------------------

EVAL_SEQ, EVAL_BATCH = 2048, 8
# the packed perplexities through the kernels against use_kernels=False on the
# first EVAL_CHECK_BLOCKS blocks: the summed NLL within this relative gap
# (every packed matmul's bf16 output rounded after sums in another order; one
# decode step's logits agree within LOGIT_TOL of their max, and a block's NLL
# averages 2047 tokens' log-probabilities)
EVAL_CHECK_BLOCKS = 2
EVAL_NLL_TOL = 1e-3
# the tasks' per-pair log-likelihood sums through the kernels against the plain
# path, relative (the same reason); greedy flags and acc are not held (a bf16
# argmax tie flips them)
EVAL_LL_TOL = 1e-2
# the CLI's `ppl` under B8 (bf16 forward kernel: the CLI computes in the
# config's bf16, ROADMAP C4) against the in-process plain attention: p enters
# P.V in bf16 in the kernel and in f32 in the plain version
CLI_PPL_TOL = 2e-3
# the f32 config's perplexity under B8's 3xTF32 forward against the plain f32
# attention: f32 sums in another order
F32_PPL_TOL = 1e-4
GEN_DOCS, GEN_NEW, GEN_SHOTS = 8, 64, 2  # 5-shot prompts are 2417-2636 byte tokens


class Recording:
    """A pairs scorer that keeps every pair it scored and its result."""

    def __init__(self, fn):
        self.fn, self.pairs, self.results = fn, [], []

    def __call__(self, pairs):
        out = self.fn(pairs)
        self.pairs += list(pairs)
        self.results += out
        return out


def eval_run(name, fn, blocks, out: dict) -> float:
    """One perplexity over `blocks`, its launch counts reset just before and
    read just after; host seconds around a synchronised device."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    ppl = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    toks = blocks.shape[0] * blocks.shape[1]
    out[name] = dict(ppl=ppl, s=wall, tokens=toks, tokens_per_s=toks / wall, launches=counts)
    if not math.isfinite(ppl):
        raise AssertionError(f"eval {name}: perplexity {ppl}")
    return ppl


def nll_gap(params, ref, cfg, blocks, out: dict, name: str) -> float:
    """Summed NLL of the first blocks through the kernels against the plain
    path (use_kernels=False on `ref`), relative."""
    from bitdistiller_tpu_torch.eval.ppl import make_nll_fn

    tokens = torch.as_tensor(blocks[:EVAL_CHECK_BLOCKS], dtype=torch.int64, device=DEV)
    k = make_nll_fn(cfg)(params, tokens).sum().item()
    p = make_nll_fn(cfg, use_kernels=False)(ref, tokens).sum().item()
    gap = abs(k - p) / abs(p)
    out[name].update(check_nll_kernels=k, check_nll_plain=p, check_rel_gap=gap)
    say(f"eval {name}: NLL of the first {EVAL_CHECK_BLOCKS} blocks through the kernels {k:.6f}"
        f" vs plain {p:.6f}, relative gap {gap:.3g} (tol {EVAL_NLL_TOL})")
    if not gap <= EVAL_NLL_TOL:
        raise AssertionError(f"eval {name}: the kernels' NLL disagrees with the plain path")
    return gap


def cli_ppl(model: Path, tokens: Path, extra_env: dict) -> tuple[float, dict]:
    """`python -m bitdistiller_tpu_torch.cli ppl` (run as __main__ through
    runpy in a child process, which then prints its launch counts as JSON)."""
    prog = ("import json, runpy, sys\n"
            "sys.argv = ['bitdistiller_tpu_torch.cli'] + sys.argv[1:]\n"
            "runpy.run_module('bitdistiller_tpu_torch.cli', run_name='__main__', "
            "alter_sys=True)\n"
            "from bitdistiller_tpu_torch.ops import train_attention as ta\n"
            "from bitdistiller_tpu_torch.ops import quant_matmul as qm\n"
            "print(json.dumps({'train_attn_fwd': ta.train_attn_fwd.launches, "
            "'train_attn_bwd_dkv': ta.train_attn_bwd_dkv.launches, "
            "'train_attn_bwd_dq': ta.train_attn_bwd_dq.launches, "
            "'qmm_prefill': qm.qmm_prefill.launches}))\n")
    argv = ["ppl", "--model_path", str(model), "--tokens_file", str(tokens), "--dtype",
            "float32", "--batch_size", str(EVAL_BATCH), "--seqlen", str(EVAL_SEQ),
            "--device", "cuda"]
    run = subprocess.run([sys.executable, "-c", prog] + argv, cwd=OUT_DIR.parent,
                         capture_output=True, text=True, env=dict(os.environ, **extra_env),
                         timeout=600)
    if run.returncode:
        raise RuntimeError(f"cli ppl exited {run.returncode}:\n{run.stderr[-3000:]}")
    lines = run.stdout.strip().splitlines()
    ppl = float([ln for ln in lines if ln.startswith("ppl:")][-1].split()[1])
    return ppl, json.loads(lines[-1])


def eval_phase(loaded, packed, cfg, tmp: Path, card: str, rec: dict) -> dict:
    """Stage 4 on TinyLlama-1.1B (22 layers): the teacher (the bf16 checkpoint
    the train phase wrote), RTN int2-g64 of it (the CLI's PTQ quantizer), the
    trained student under the same quantizer (the reloaded f32 master in
    bf16), the packed int2-g64 student at A16 (B1) and at A8 (B4), each a
    perplexity over all 139 blocks of 2048 byte tokens of the wikitext
    fixture's test text at batch 8; the packed runs' first 2 blocks held
    against the plain path. Then run_tasks on the packed student (ARC-Challenge,
    MMLU abstract algebra, their per-pair sums held against the plain path),
    GreedyUntilFn on 8 GSM8K docs through the Engine (B1, B2, B3), the CLI's
    `ppl --dtype float32` under the training flash (B8's forward) against the
    same perplexity in process without it, and the f32 config's perplexity
    through B8's 3xTF32 forward against the plain f32 attention. Removes `tmp`.
    Returns the launch counts of each run."""
    from bitdistiller_tpu_torch.cli import _ptq_quantizer
    from bitdistiller_tpu_torch.eval import tasks as T
    from bitdistiller_tpu_torch.eval.ppl import load_wikitext2_test, perplexity, prepare_blocks

    saved = {k: os.environ.get(k) for k in ("BITDISTILLER_DATA_DIR", qm.A8_ENV,
                                            "BITDISTILLER_TRAIN_FLASH")}
    os.environ["BITDISTILLER_DATA_DIR"] = str(FIXTURES)
    os.environ.pop("BITDISTILLER_TRAIN_FLASH", None)
    try:
        tokens = load_wikitext2_test(ByteTok())
        blocks = prepare_blocks(tokens, EVAL_SEQ)
        if blocks.shape != (139, EVAL_SEQ):
            raise AssertionError(f"eval: {len(tokens)} tokens -> blocks {blocks.shape}, not "
                                 f"139 x {EVAL_SEQ}")
        rtn = _ptq_quantizer(types.SimpleNamespace(quant_type="int", w_bit=2, q_group_size=64))
        ppl = lambda params, q=None, c=cfg, b=blocks: perplexity(
            params, c, b, quantizer=q, batch_size=EVAL_BATCH, device=DEV)
        runs: dict = {}
        teacher, _ = load_hf_checkpoint(str(tmp / "init"), dtype=torch.bfloat16, device=DEV)
        eval_run("teacher", lambda: ppl(teacher), blocks, runs)
        eval_run("teacher_rtn_int2_g64", lambda: ppl(teacher, rtn), blocks, runs)
        del teacher
        student = tr.tree_map(lambda x: x.to(torch.bfloat16), loaded)
        eval_run("student_rtn_int2_g64", lambda: ppl(student, rtn), blocks, runs)
        del student
        ref = plain_packed(packed)
        eval_run("packed_a16", lambda: ppl(packed), blocks, runs)
        nll_gap(packed, ref, cfg, blocks, runs, "packed_a16")
        os.environ[qm.A8_ENV] = "1"
        try:
            packed_a8 = qm.maybe_repack_a8(packed)
            eval_run("packed_a8", lambda: ppl(packed_a8), blocks, runs)
            # the plain A8 version reads the same scales as the A8 kernel
            nll_gap(packed_a8, packed_a8, cfg, blocks, runs, "packed_a8")
        finally:
            os.environ.pop(qm.A8_ENV, None)
        del packed_a8
        torch.cuda.empty_cache()
        fwd = -(-blocks.shape[0] // EVAL_BATCH)  # 17 batches of 8 and the remainder of 3
        want = fwd * cfg.num_layers * 4
        a16, a8 = runs["packed_a16"]["launches"], runs["packed_a8"]["launches"]
        if (a16.get("qmm_prefill") != want or a16.get("qmm_a8") or a16.get("qmm_decode")
                or a8.get("qmm_a8_prefill") != want or a8.get("qmm_a8") != want
                or a8.get("qmm_prefill") or a8.get("qmm_decode")):
            raise AssertionError(f"eval: the packed perplexities did not run every matmul "
                                 f"through B1 / B4 ({want} each): {a16} / {a8}")
        say(f"eval TinyLlama-1.1B ({cfg.num_layers} layers, {blocks.shape[0]} blocks of "
            f"{EVAL_SEQ} byte tokens of the wikitext fixture, batch {EVAL_BATCH}; {card}): "
            + "; ".join(f"{name} ppl {r['ppl']:.4f} in {r['s']:.2f} s "
                        f"({r['tokens_per_s']:.0f} tokens/s)" for name, r in runs.items()))
        say(f"eval launches: A16 perplexity {a16}, A8 perplexity {a8} (predicted {want} each: "
            f"{fwd} forwards x {cfg.num_layers} layers x 4 packed linears)")

        # the task harness on the packed student, every pair held against the plain path
        t0 = time.time()
        reset_counts()
        fn = Recording(T.LogLikelihoodFn(packed, cfg, ByteTok(), batch_size=EVAL_BATCH,
                                         device=DEV))
        task_res = T.run_tasks(fn, ["arc_challenge", "hendrycksTest-abstract_algebra"])
        torch.cuda.synchronize()
        task_s = time.time() - t0
        task_counts = {k: v for k, v in read_counts().items() if v}
        plain = T.LogLikelihoodFn(ref, cfg, ByteTok(), batch_size=EVAL_BATCH, device=DEV,
                                  use_kernels=False)(fn.pairs)
        errs = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(fn.results, plain)]
        worst = max(errs)
        runs["tasks"] = dict(results=task_res, s=task_s, pairs=len(fn.pairs), launches=task_counts,
                             ll_worst_rel_err=worst,
                             greedy_flags_differ=sum(a[1] != b[1] for a, b in zip(fn.results, plain)))
        say(f"eval tasks on the packed student: "
            + "; ".join(f"{k} acc {v['acc']:.3f} acc_norm {v.get('acc_norm', float('nan')):.3f} "
                        f"n {v['n']}" for k, v in task_res.items() if isinstance(v, dict))
            + f"; {len(fn.pairs)} pairs in {task_s:.2f} s, launches {task_counts}; per-pair "
            f"log-likelihood sums vs plain: worst relative {worst:.3g} (tol {EVAL_LL_TOL})")
        if not (worst <= EVAL_LL_TOL and task_counts.get("qmm_prefill", 0) > 0):
            raise AssertionError("eval tasks: the kernels' log-likelihoods disagree with the "
                                 "plain path, or no pair went through B1")

        # greedy generation through the engine on the packed student
        docs = T._gsm8k_gen_docs(n_fewshot=GEN_SHOTS)[:GEN_DOCS]
        eng = Engine(packed, cfg, max_slots=EVAL_BATCH, max_len=EVAL_SEQ,
                     sampling=SamplingParams(temperature=0.0),
                     eos_token_id=ByteTok.eos_token_id, grow_cache=False, device=DEV)
        gen_fn = T.GreedyUntilFn(eng, ByteTok(), max_new_tokens=GEN_NEW)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        gen_res = T.evaluate_gen_task(gen_fn, docs, match=T.GEN_TASKS["gsm8k"][2])
        torch.cuda.synchronize()
        gen_s = time.time() - t0
        gen_counts = {k: v for k, v in read_counts().items() if v}
        runs["gsm8k_greedy"] = dict(result=gen_res, s=gen_s, docs=GEN_DOCS, shots=GEN_SHOTS,
                                    new_tokens=GEN_NEW, decode_steps=eng.decode_steps,
                                    prefills=eng.prefills, launches=gen_counts)
        say(f"eval GreedyUntilFn: {GEN_DOCS} GSM8K docs ({GEN_SHOTS}-shot; the 5-shot prompts "
            f"pass the 2048-row cache in byte tokens), {GEN_NEW} new tokens, exact match "
            f"{gen_res['exact_match']:.3f}, {gen_s:.2f} s, {eng.decode_steps} decode steps, "
            f"{eng.prefills} prefills, launches {gen_counts}")
        if not all(gen_counts.get(k, 0) > 0 for k in ("qmm_prefill", "qmm_decode", "flash_decode")):
            raise AssertionError(f"eval GreedyUntilFn: not through B1, B2 and B3: {gen_counts}")
        del eng, gen_fn, ref
        torch.cuda.empty_cache()

        # the CLI's f32 ppl under the training flash, and the f32 config's forward
        head = blocks[:EVAL_BATCH]
        np.save(tmp / "tokens.npy", head.reshape(-1))
        t0 = time.time()
        cli_val, cli_counts = cli_ppl(tmp / "out", tmp / "tokens.npy",
                                      {"BITDISTILLER_TRAIN_FLASH": "1"})
        cli_s = time.time() - t0
        ref_val = perplexity(loaded, cfg, head, batch_size=EVAL_BATCH, device=DEV)
        cli_gap = abs(cli_val - ref_val) / ref_val
        runs["cli_ppl_float32_flash"] = dict(ppl=cli_val, in_process_plain=ref_val,
                                             rel_gap=cli_gap, s=cli_s, launches=cli_counts)
        say(f"eval cli ppl --dtype float32 (BITDISTILLER_TRAIN_FLASH=1, {EVAL_BATCH} blocks, a "
            f"child process, {cli_s:.1f} s): ppl {cli_val:.4f} vs in process without the flash "
            f"{ref_val:.4f} (relative {cli_gap:.3g}, tol {CLI_PPL_TOL}); launches {cli_counts}")
        if not (cli_gap <= CLI_PPL_TOL and cli_counts["train_attn_fwd"] == cfg.num_layers
                and not cli_counts["train_attn_bwd_dkv"] and not cli_counts["train_attn_bwd_dq"]):
            raise AssertionError("eval cli ppl: off the plain path, or not B8's forward alone")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        plain32 = perplexity(loaded, cfg32, head, batch_size=EVAL_BATCH, device=DEV)
        os.environ["BITDISTILLER_TRAIN_FLASH"] = "1"
        try:
            eval_run("f32_config_flash", lambda: perplexity(
                loaded, cfg32, head, batch_size=EVAL_BATCH, device=DEV), head, runs)
        finally:
            os.environ.pop("BITDISTILLER_TRAIN_FLASH", None)
        r32 = runs["f32_config_flash"]
        f32_gap = abs(r32["ppl"] - plain32) / plain32
        r32.update(plain=plain32, rel_gap=f32_gap)
        say(f"eval f32 config (B8's 3xTF32 forward, {EVAL_BATCH} blocks): ppl {r32['ppl']:.6f} "
            f"vs plain f32 attention {plain32:.6f} (relative {f32_gap:.3g}, tol {F32_PPL_TOL}) in "
            f"{r32['s']:.2f} s; launches {r32['launches']}")
        l32 = r32["launches"]
        if not (f32_gap <= F32_PPL_TOL and l32.get("train_attn_fwd") == cfg.num_layers
                and not l32.get("train_attn_bwd_dkv") and not l32.get("train_attn_bwd_dq")):
            raise AssertionError("eval f32 config: off the plain path, or not B8's forward alone")
        rec.update(runs)
        return runs
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


# ---- A13, the method check: the port's method_demo at the JAX script's defaults

# RESULTS.md:42-43 (the JAX script on the TPU; shown beside, never as the port's)
JAX_METHOD = {"teacher": 4.244,
              "int2-g64": dict(rtn=317.034, clip=79.078, qat=13.806, packed=13.810),
              "nf3-g64": dict(qat=4.782)}
PACKED_TOL = 5e-3  # the packed row within 0.5% of the QAT row (one int2 grid)
A8_ROW_TOL = 2e-2  # the W2A8 row within 2% of the packed row


def method_phase(card: str, rec: dict) -> dict:
    """The port's method_demo at the JAX script's defaults (Markov corpus,
    1500 teacher steps at batch 32, 256 x 128 generated tokens, 400 QAT steps
    at batch 16 a quant type, g64, 192 held-out blocks of 256), its launch
    counts reset before and read after; gates on the table's shape."""
    from bitdistiller_tpu_torch.scripts import method_demo

    args = method_demo.build_parser().parse_args(
        ["--device", DEV, "--out", str(OUT_DIR / "method_demo.md"), "--spec-bench"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    res = method_demo.run(args, log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    OUT_DIR.mkdir(exist_ok=True)
    method_demo.replace_section(args.out, res["header"], "\n".join(res["lines"]))
    rows = {r["label"]: r for r in res["rows"]}
    i2, n3 = rows["int2-g64"], rows["nf3-g64"]
    share = {k: method_demo.recovered(r, res["teacher"]) for k, r in rows.items()}
    rec.update(teacher=res["teacher"], rows=res["rows"], seconds=res["seconds"], wall_s=wall,
               launches=counts, recovered=share, teacher_steps=res["teacher_steps"],
               qat_steps=res["qat_steps"], n_params=res["n_params"])
    rec["spec"] = method_spec_check(res["spec"], res["cfg"], args.out, card)
    for line in res["lines"]:
        if line.startswith("|") or line.startswith("Teacher"):
            say(f"method {line}")
    j = JAX_METHOD
    say(f"method beside RESULTS.md:42-43 (the JAX script, not the port): teacher {j['teacher']}; "
        f"int2-g64 RTN {j['int2-g64']['rtn']} +AutoClip {j['int2-g64']['clip']} +QAT "
        f"{j['int2-g64']['qat']} packed {j['int2-g64']['packed']} (97% recovered); nf3-g64 QAT "
        f"{j['nf3-g64']['qat']} (81%). The port: recovered "
        + ", ".join(f"{k} {v:.0%}" for k, v in share.items()))
    say(f"method seconds ({card}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items())
        + f"; total {wall:.1f} s; launches {counts}")
    gates = {
        "int2: RTN > +AutoClip > +QAT": i2["rtn"] > i2["clip"] > i2["qat"],
        "nf3: QAT < RTN": n3["qat"] < n3["rtn"],
        f"packed within {PACKED_TOL:.1%} of QAT": abs(i2["packed"] - i2["qat"]) <= PACKED_TOL * i2["qat"],
        f"W2A8 within {A8_ROW_TOL:.0%} of packed":
            abs(i2["packed_a8"] - i2["packed"]) <= A8_ROW_TOL * i2["packed"],
    }
    rec["gates"] = gates
    say("method gates: " + ", ".join(f"{k}: {'pass' if v else 'FAIL'}" for k, v in gates.items()))
    if not all(gates.values()):
        raise AssertionError(f"method: a gate failed: {gates}")
    if not all(counts.get(k, 0) > 0 for k in ("qmm_prefill", "qmm_a8_prefill", "flash_decode")):
        raise AssertionError(f"method: the packed rows or the generation missed their kernels: "
                             f"{counts}")
    return counts


# ---- A3: the rest of the serving engine on the full-width Llama-2-7B -----------

# 128 new tokens a stream (a depth cut that holds the smoke under 1000 s): the
# growth still crosses two buckets (64 -> 128 -> 256) and speculation runs
# tens of verify rounds; longer streams add decode depth, not paths
SERVE_SLOTS, SERVE_LEN, SERVE_NEW = 8, 2048, 128
SPEC_LADDER = (4, 7, 11)
VERIFY_M = tuple(SERVE_SLOTS * (k + 1) for k in SPEC_LADDER)  # a verify forward's rows
PREFIX_LEN = 512
PREFIX_TAILS = (16, 23, 30, 37, 44, 51, 58, 64)  # tail buckets 16, 32, 32, 64 x 5
PREFIX_NEW = 16
HTTP_REQUESTS, HTTP_CONCURRENCY, HTTP_NEW = 32, 16, 64
# the warmup walks: the plain engine through the 7B's six buckets (to 2048 rows:
# a replayed walk, where an eager one was about a minute of host-paced
# steps), and a speculative one through four (its ladder's verify graphs)
WARMUP_LEN, WARMUP_SPEC_LEN = 2048, 512
CAPACITY_TOL = 1e-2  # serve_capacity's weights within 1% of the packed tree's bytes


def kv_copy(cache: KVCache) -> KVCache:
    return KVCache(*(None if t is None else t.clone()
                     for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)))


def prefilled_cache(params, cfg, prompts, t: int):
    """A bf16 cache of t rows holding each prompt but its last token (one
    slot a prompt), the prompts' last tokens and their positions: the state
    from which one decode step predicts the token after each prompt."""
    s = max(len(p) for p in prompts) - 1
    toks = torch.zeros((len(prompts), s), dtype=torch.int64, device=DEV)
    for i, p in enumerate(prompts):
        toks[i, :len(p) - 1] = torch.as_tensor(p[:-1], device=DEV)
    cache = KVCache.init(cfg, len(prompts), t, torch.bfloat16, device=DEV)
    with torch.inference_mode():
        _, kv = forward(params, cfg, toks, return_kv=True)
    cache.k[:, :, :, :s] = kv.k.permute(0, 1, 3, 2, 4)
    cache.v[:, :, :, :s] = kv.v.permute(0, 1, 3, 2, 4)
    last = torch.as_tensor([p[-1] for p in prompts], device=DEV)
    pos = torch.as_tensor([len(p) - 1 for p in prompts], dtype=torch.int32, device=DEV)
    return cache, last, pos


def _rows(n: int) -> int:
    return -(-n // 64) * 64


def delta_verify(params, cfg, prompts, conts, k: int) -> float:
    """The tie rule's delta at draft length k: the largest |logit| difference
    between one S = k + 1 verify forward (B (k + 1) rows: B1 above 32) and
    the k + 1 S = 1 steps (B2, B3) on the same tokens from the same cache."""
    cache, last, pos = prefilled_cache(params, cfg, prompts,
                                       _rows(max(map(len, prompts)) + k + 1))
    toks = torch.cat([last[:, None], torch.as_tensor([c[:k] for c in conts], device=DEV)], 1)
    with torch.inference_mode():
        lv, _ = forward(params, cfg, toks, cache=kv_copy(cache), cache_pos=pos)
        ls = torch.cat([forward(params, cfg, toks[:, j:j + 1], cache=cache, cache_pos=pos + j)[0]
                        for j in range(k + 1)], dim=1)
    return (lv - ls).abs().max().item()


def delta_len(params, cfg, prompts, t_small: int, t_big: int) -> float:
    """The largest |logit| difference of one decode step (B3) against a
    cache of t_small rows and one of t_big holding the same rows."""
    small, last, pos = prefilled_cache(params, cfg, prompts, t_small)
    big = grow_kv_cache(small, t_big)
    with torch.inference_mode():
        a, _ = forward(params, cfg, last[:, None], cache=small, cache_pos=pos)
        b, _ = forward(params, cfg, last[:, None], cache=big, cache_pos=pos)
    return (a - b).abs().max().item()


def forced_margins(params, cfg, prompts, streams) -> tuple[list, int]:
    """Each stream fed back through S = 1 decode steps (B2, B3) after its
    prompt, all streams in one batch: at every position the top logit
    minus the logit of the stream's own token (0 where the stream took the
    argmax). Returns the margins [stream][position] and the cache length."""
    n = len(streams[0])
    if any(len(st) != n for st in streams):
        raise AssertionError("forced_margins: streams of unequal length")
    t = _rows(max(len(p) for p in prompts) + n)
    cache, cur, pos = prefilled_cache(params, cfg, prompts, t)
    toks = torch.as_tensor(streams, device=DEV)
    out = []
    with torch.inference_mode():
        for j in range(n):
            lg, _ = forward(params, cfg, cur[:, None], cache=cache, cache_pos=pos + j)
            lg = lg[:, 0].float()
            out.append(lg.amax(dim=1) - lg.gather(1, toks[:, j:j + 1])[:, 0])
            cur = toks[:, j]
    return torch.stack(out, dim=1).tolist(), t


def tie_rule(params, cfg, prompts, ref, got, delta: float, what: str, lens=()) -> dict:
    """Greedy streams of two runs whose kernels saw different M (or T): an
    equal stream passes. A stream that diverges is fed back through S = 1
    decode steps after its prompt (forced_margins), and EVERY one of its
    tokens, those after its first divergence too, must lie within 2 delta
    of that step's top logit (a bf16 argmax near a tie). delta grows by
    delta_len between the check's cache length and each of `lens`, the
    cache lengths the two runs reached. Raises on a token above 2 delta."""
    idx = [i for i, (r, g) in enumerate(zip(ref, got)) if r != g]
    divs = []
    if idx:
        sub = [prompts[i] for i in idx]
        margins, t = forced_margins(params, cfg, sub, [got[i] for i in idx])
        for tl in sorted(set(lens) - {t}):
            delta = max(delta, delta_len(params, cfg, sub, min(t, tl), max(t, tl)))
        for i, m in zip(idx, margins):
            j = next((j for j, (a, b) in enumerate(zip(ref[i], got[i])) if a != b),
                     min(len(ref[i]), len(got[i])))
            off = [x for x in m if x > 0]
            divs.append(dict(stream=i, pos=j, off_argmax=len(off), worst=max(m),
                             ok=max(m) <= 2 * delta))
    say(f"{what}: {len(ref) - len(idx)}/{len(ref)} streams equal; delta {delta:.4g}; "
        "divergences (first position, tokens off the forced argmax, worst margin): "
        + (", ".join(f"stream {d['stream']} at {d['pos']}, {d['off_argmax']} off, "
                     f"{d['worst']:.4g}" for d in divs) or "none"))
    bad = [d for d in divs if not d["ok"]]
    if bad:
        raise AssertionError(f"{what}: greedy tokens above 2 delta = {2 * delta:.4g}: {bad}")
    return dict(equal=len(ref) - len(idx), streams=len(ref), delta=delta, divergences=divs)


def engine_snapshot(eng) -> dict:
    return dict(prefills=eng.prefills, decode_steps=eng.decode_steps,
                spec=dict(eng.spec_forwards), extends=len(eng.prefix_extends))


def predicted_launches(eng, since: dict) -> dict:
    """B1, B2 and B3 launches of what the engine ran since `since`: four
    packed matmuls a layer a forward, on B1 above 32 rows (a prefill, a
    verify of max_slots (k + 1) rows, a tail prefill of its tail bucket) and
    on B2 at or below; B3 once a layer a plain decode step (a verify and a
    tail prefill go through cached_attention, as under JAX's flash_ok)."""
    rows = [(eng.max_slots * (k + 1), n - since["spec"].get(k, 0))
            for k, n in eng.spec_forwards.items()]
    rows += [(tb, 1) for tb in eng.prefix_extends[since["extends"]:]]
    rows += [(eng.max_slots, eng.decode_steps - since["decode_steps"])]
    big = sum(n for m, n in rows if m > qm.DECODE_MAX_M) + eng.prefills - since["prefills"]
    small = sum(n for m, n in rows if m <= qm.DECODE_MAX_M)
    L = eng.cfg.num_layers
    return dict(qmm_prefill=4 * L * big, qmm_decode=4 * L * small,
                flash_decode=L * (eng.decode_steps - since["decode_steps"]))


def drive(eng, prompts, new: int, what: str, **req_kw) -> dict:
    """Requests through eng.run with the launch counts reset just before and
    read just after; every request must finish with `new` tokens and the
    counts must be the ones predicted from what the engine ran."""
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=new, **req_kw) for p in prompts]
    since = engine_snapshot(eng)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    if len(done) != len(reqs) or not all(r.finished and len(r.output_tokens) == new for r in reqs):
        raise AssertionError(f"{what}: not every request finished with {new} tokens")
    want = predicted_launches(eng, since)
    got = {k: counts[k] for k in want}
    if got != want or any(v for k, v in counts.items() if k not in want):
        raise AssertionError(f"{what}: launches {counts}, predicted {want}")
    steps = eng.decode_steps - since["decode_steps"]
    verify = {k: n - since["spec"].get(k, 0) for k, n in eng.spec_forwards.items()}
    return dict(outs=[r.output_tokens for r in reqs], wall_s=wall, launches=got,
                decode_steps=steps, verify_forwards=verify, cache_len=eng._cache_len(),
                ms_per_token=wall * 1e3 / (new * len(reqs)))


def serve_phase(gen, bw, card, rec) -> dict:
    """A3 on a random packed int2-g128 Llama-2-7B (seed 0, 32 layers, 8
    slots, max_len 2048, bf16 cache, A16, greedy): B1 held and timed at the
    verify shapes; growth against a static cache; n-gram speculation on
    random and periodic prompts against the plain engine; the prompt cache's
    tail-only prefills; the HTTP frontend under mixed load; warmup;
    capacity. Launch counts are exact against what each run
    ran; greedy streams held by the tie rule. Returns the kernel times at
    the verify shapes."""
    cfg = CFG
    L = cfg.num_layers
    rec["verify_checks"], rec["verify_times"] = [], []
    worst = check_matmuls(gen, rec["verify_checks"], ms=VERIFY_M, bits_list=(BITS,))
    verify_t = {m: totals_entry(time_matmuls(gen, m, bw, rec["verify_times"]), bw)
                for m in VERIFY_M}
    for m, t in verify_t.items():
        say(f"serve: B1 at the verify's M={m} (one layer's four int2-g128 matmuls; {card}): "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.3f}, torch.matmul {t['library_ms']:.4f}, "
            f"bound {t['bound_ms']:.4f} ({t['bound_by']}); held against the plain version "
            f"(worst relative error {worst:.3g})")
    params = random_packed_params(cfg, bits=BITS, group_size=GROUP, seed=0, device=DEV)

    def engine(**kw):
        return Engine(params, cfg, max_slots=SERVE_SLOTS, max_len=kw.pop("max_len", SERVE_LEN),
                      eos_token_id=None,
                      sampling=kw.pop("sampling", SamplingParams(temperature=0.0)), device=DEV,
                      **kw)

    rng = np.random.default_rng(19)
    rand = [rng.integers(3, cfg.vocab_size, 64).tolist() for _ in range(SERVE_SLOTS)]
    periodic = [rng.integers(3, cfg.vocab_size, 16).tolist() * 16 for _ in range(SERVE_SLOTS)]

    # growth: the same requests on a growing and a static cache
    grown_eng = engine()
    grown = drive(grown_eng, rand, SERVE_NEW, "serve growth")
    static_eng = engine(grow_cache=False)
    static = drive(static_eng, rand, SERVE_NEW, "serve static")
    live_slot_bytes = sum(t.nbytes for t in (static_eng.cache.k, static_eng.cache.v)) // SERVE_SLOTS
    del static_eng
    copies = []
    for old, new in grown_eng.growths:
        c = KVCache.init(cfg, SERVE_SLOTS, old, torch.bfloat16, device=DEV)
        ms = cuda_ms(lambda i: grow_kv_cache(c, new), 2, reps=3)
        nbytes = 2 * (c.k.nbytes + c.k.nbytes * new // old)  # read the old k, v; write the new
        copies.append(dict(old=old, new=new, ms=ms, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3))
        del c
    by_bucket = {t: L * n for t, n in sorted(grown_eng.decode_steps_at.items())}
    say(f"serve growth ({card}): copies " + ", ".join(
        f"{c['old']}->{c['new']} {c['ms']:.3f} ms (bound {c['bound_ms']:.3f})" for c in copies)
        + f"; B3 launches by cache length {by_bucket}; "
        f"{grown['wall_s'] * 1e3 / grown['decode_steps']:.3f} ms a step grown, "
        f"{static['wall_s'] * 1e3 / static['decode_steps']:.3f} static (host clock, "
        f"{SERVE_SLOTS} x {SERVE_NEW} tokens)")
    deltas = {k: delta_verify(params, cfg, rand, grown["outs"], k) for k in SPEC_LADDER}
    deltas["T"] = delta_len(params, cfg, rand, 512, SERVE_LEN)
    delta = max(deltas.values())
    say(f"serve tie rule: delta by k {deltas} -> {delta:.4g}")
    rec["growth"] = dict(grown={k: v for k, v in grown.items() if k != "outs"},
                         static={k: v for k, v in static.items() if k != "outs"},
                         copies=copies, b3_by_cache_len=by_bucket, deltas=deltas,
                         ties=tie_rule(params, cfg, rand, static["outs"], grown["outs"], delta,
                                       "serve grown vs static",
                                       (static["cache_len"], grown["cache_len"])))

    # speculation, adaptive over the ladder, against the plain engine
    rec["spec"] = {}
    plain_outs = {}
    for name, prompts, plain in (("random", rand, grown), ("periodic", periodic, None)):
        if plain is None:
            plain = drive(engine(), prompts, SERVE_NEW, f"serve plain {name}")
        eng = engine(spec_decode=True, spec_k=SPEC_LADDER[0])
        if eng.spec_k_ladder != SPEC_LADDER:
            raise AssertionError(f"serve spec: the engine's ladder {eng.spec_k_ladder}")
        sp = drive(eng, prompts, SERVE_NEW, f"serve spec {name}")
        acc = eng.spec_tokens / max(eng.spec_rounds, 1)
        rec["spec"][name] = dict(
            spec={k: v for k, v in sp.items() if k != "outs"},
            plain={k: v for k, v in plain.items() if k != "outs"}, accept=acc,
            k=eng._spec_k_last, rounds=eng.spec_rounds,
            ties=tie_rule(params, cfg, prompts, plain["outs"], sp["outs"], delta,
                          f"serve spec {name} vs plain", (plain["cache_len"], sp["cache_len"])))
        distinct = len({tuple(o) for o in plain["outs"]})
        rec["spec"][name]["distinct_plain_streams"] = distinct
        say(f"serve spec {name} ({card}): the plain streams {distinct} distinct of "
            f"{len(prompts)}, {len({t for o in plain['outs'] for t in o})} distinct tokens; "
            f"acceptance {acc:.3f} tokens a verify cell, k ends "
            f"at {eng._spec_k_last}, verify forwards by k {sp['verify_forwards']}, plain steps "
            f"{sp['decode_steps']}; launches {sp['launches']} (predicted: 4 x {L} a forward, B1 "
            f"at M = 8(k+1) > 32); {sp['ms_per_token']:.3f} ms a generated token, plain "
            f"{plain['ms_per_token']:.3f}")
        plain_outs[name] = plain["outs"]
        if name == "random":  # the replayed verify rounds beside their eager twin's
            rec["spec"]["twin"] = twin_check(
                sp, engine(spec_decode=True, spec_k=SPEC_LADDER[0], graphs=False), prompts,
                f"serve spec {name}", card)
        del eng
    # sampled streams: the replayed steps draw what the eager twin draws at one seed
    sampled = dict(sampling=SamplingParams(temperature=0.8, top_p=0.9), seed=11)
    sp = drive(engine(**sampled), rand, SERVE_NEW, "serve sampled")
    rec["sampled"] = twin_check(sp, engine(graphs=False, **sampled), rand, "serve sampled",
                                card)
    rec["spec"]["same_plain_streams"] = plain_outs["random"] == plain_outs["periodic"]
    say(f"serve spec: the plain streams of the random and the periodic prompts are "
        f"{'the same' if rec['spec']['same_plain_streams'] else 'different'}")

    # the prompt cache: one stored 512-token prefix, then 8 requests extending it
    eng = engine(prompt_cache_size=4)
    prefix = rng.integers(3, cfg.vocab_size, PREFIX_LEN).tolist()
    tails = [rng.integers(3, cfg.vocab_size, n).tolist() for n in PREFIX_TAILS]
    drive(eng, [prefix], PREFIX_NEW, "serve prefix store", cache_prompt=True)
    prompts = [prefix + t for t in tails]
    hit = drive(eng, prompts, PREFIX_NEW, "serve prefix hits")
    if eng.prompt_cache_prefix_hits != len(tails) or hit["launches"]["qmm_prefill"] != 4 * L * sum(
            tb > qm.DECODE_MAX_M for tb in eng.prefix_extends):
        raise AssertionError(f"serve prefix: {eng.prompt_cache_prefix_hits} prefix hits of "
                             f"{len(tails)}, tail buckets {eng.prefix_extends}")
    full = drive(engine(), prompts, PREFIX_NEW, "serve prefix full prefill")
    entry = eng._prompt_cache[tuple(prefix)]
    twin = engine(prompt_cache_size=4, graphs=False)
    one = np.zeros((1, 1024), np.int64)  # the prompt in its bucket
    one[0, :len(prompts[-1])] = prompts[-1]
    last_idx = np.asarray([len(prompts[-1]) - 1], np.int64)
    tail_t = {len(t): route_turns({r: (lambda e=e, t=t: e._extend_prefix(entry[0], PREFIX_LEN, t))
                                   for r, e in (("replayed", eng), ("eager", twin))})
              for t in (tails[0], tails[-1])}
    full_t = route_turns({r: (lambda e=e: e._prefill(one, last_idx))
                          for r, e in (("replayed", eng), ("eager", twin))})
    tail_ms = {n: t["replayed"]["median_ms"] for n, t in tail_t.items()}
    full_ms = full_t["replayed"]["median_ms"]
    rec["prefix"] = dict(hits=eng.prompt_cache_prefix_hits, tail_buckets=eng.prefix_extends[:8],
                         launches=hit["launches"], tail_prefill_ms=tail_ms,
                         full_prefill_ms=full_ms, tail_turns=tail_t, full_turns=full_t,
                         wall_s=hit["wall_s"], full_wall_s=full["wall_s"],
                         ties=tie_rule(params, cfg, prompts, full["outs"], hit["outs"], delta,
                                       "serve prefix extension vs full prefill",
                                       (full["cache_len"], hit["cache_len"])))
    say(f"serve prefix ({card}): {eng.prompt_cache_prefix_hits}/{len(tails)} prefix hits, tail "
        f"buckets {eng.prefix_extends[:8]}, launches {hit['launches']}; tail prefill "
        + ", ".join(f"{n} tokens {turns_text(t)}" for n, t in tail_t.items())
        + f" beside a full {len(prompts[-1])}-token prefill (bucket 1024) {turns_text(full_t)}")
    del eng, twin, entry

    rec["admission"] = admission_times(params, cfg, rng, card)
    rec["same_key"] = same_key_check(params, cfg, rng, card)

    rec["http"] = http_load(engine(), card)
    rec["warmup"] = warmup_run(engine(max_len=WARMUP_LEN), rand[0], card)
    rec["warmup_spec"] = warmup_run(engine(max_len=WARMUP_SPEC_LEN, spec_decode=True), rand[0],
                                    card)
    rec["capacity"] = capacity_check(params, live_slot_bytes, card)
    del params
    torch.cuda.empty_cache()
    return verify_t


ADMIT_TURNS = 4  # turns a route of each admission timing
ADMIT_GROUPS = ((8, 64), (1, 512))  # (prompts, tokens) of the timed admissions
# the graphs' pool after admissions at every bucket and group: about one
# 2048-row prefill's transients (its plain attention's f32 scores), which
# every captured piece reuses; a pool holding each key's rows would pass 20 GiB
ADMIT_POOL_LIMIT = 4 * 2**30


def route_turns(calls: dict, turns: int = ADMIT_TURNS) -> dict:
    """Each route's call (route -> fn) once, then timed on the host clock
    around a synchronize in turns (replayed, eager, replayed, ...), then one
    call of each profiled: the median ms, device busy and idle share a
    call."""
    for fn in calls.values():
        fn()
    ms = {route: [] for route in calls}
    for _ in range(turns):
        for route, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[route].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for route, fn in calls.items():
        med = float(np.median(ms[route]))
        busy = device_busy_ms(lambda i, fn=fn: fn(), 1)
        out[route] = dict(ms=ms[route], median_ms=med,
                          busy_ms=None if busy is None else busy["busy_ms"],
                          idle_share=None if busy is None else 1 - busy["busy_ms"] / med)
    return out


def turns_text(t: dict, routes=("replayed", "eager")) -> str:
    def one(r):
        busy = ("busy not measured" if r["busy_ms"] is None
                else f"busy {r['busy_ms']:.3f}, idle share {r['idle_share']:.3f}")
        return (f"{r['median_ms']:.3f} ms (turns " + " / ".join(f"{x:.3f}" for x in r["ms"])
                + f"; {busy})")

    return ", ".join(f"{route} {one(t[route])}" for route in routes)


def admit_once(eng, prompts) -> list:
    """One admission group of `prompts` into slots 0.. (prefill, insert,
    commit), its first tokens read on the host as `run` reads them; the
    slots are freed after."""
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=1) for p in prompts]
    slots = list(range(len(prompts)))
    firsts = eng._admit_group(reqs, slots).cpu().tolist()
    for slot in slots:
        eng.active[slot] = False
        eng.slot_req[slot] = None
    eng._active_dirty = True
    return firsts


def admission_times(params, cfg, rng, card) -> dict:
    """A3h on the 7B (8 slots, a 2048-row static cache): an admission of 8
    prompts of 64 tokens and one of a 512-token prompt, replayed against
    the eager twin in turns, their first tokens equal; then one admission
    at every prompt bucket and group size (a prompt of the bucket's length
    a slot), first tokens equal to the twin's, with the graphs' pool read
    after each bucket: the pool must stay within ADMIT_POOL_LIMIT, since
    every captured prefill writes the engine-owned rows and keeps only its
    last logits, and a prefill past GRAPH_ROWS rows runs eagerly."""
    eng = Engine(params, cfg, max_slots=SERVE_SLOTS, max_len=SERVE_LEN, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV)
    twin = Engine(params, cfg, max_slots=SERVE_SLOTS, max_len=SERVE_LEN, eos_token_id=None,
                  sampling=SamplingParams(temperature=0.0), grow_cache=False, device=DEV,
                  graphs=False)
    out = {}
    for n, length in ADMIT_GROUPS:
        prompts = [rng.integers(3, cfg.vocab_size, length).tolist() for _ in range(n)]
        firsts = {r: admit_once(e, prompts) for r, e in (("replayed", eng), ("eager", twin))}
        if firsts["replayed"] != firsts["eager"]:
            raise AssertionError(f"admission {n} x {length}: first tokens {firsts}")
        t = route_turns({r: (lambda e=e: admit_once(e, prompts))
                         for r, e in (("replayed", eng), ("eager", twin))})
        out[f"{n}x{length}"] = t
        say(f"admission {n} x {length} (7B, prefill + insert + commit + the first tokens' read; "
            f"{card}): {turns_text(t)}")
    table = eng._graphs
    pool = table.capture.pool
    out["timed_pool_bytes"] = pool_bytes(pool)
    sizes = [nb for nb in (1, 2, 4, 8) if nb <= SERVE_SLOTS]
    by_bucket, eager_prefills, peaks = {}, [], {}
    for bucket in eng.buckets:
        for nb in sizes:
            prompts = [rng.integers(3, cfg.vocab_size, bucket).tolist() for _ in range(nb)]
            firsts = []
            for route, e in (("replayed", eng), ("eager", twin)):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                firsts.append(admit_once(e, prompts))
                torch.cuda.synchronize()
                # the admission's transient beyond what was held before it
                # (a capture's allocations come from the graphs' pool)
                peaks[f"{route} {nb}x{bucket}"] = torch.cuda.max_memory_allocated() - base
            if firsts[0] != firsts[1]:
                raise AssertionError(f"admission {nb} x {bucket}: first tokens {firsts}")
            if ("prefill", bucket, nb) not in table.graphs:
                eager_prefills.append((nb, bucket))
        by_bucket[bucket] = pool_bytes(pool)
    rows = sum(t.nbytes for t in eng._rows)
    adm_n, adm_r = table.count(ADMISSION_PIECES)
    out.update(pieces=[list(k) for k in table.captured], capture_s=table.capture_s,
               pool_bytes_by_bucket=by_bucket, pool_bytes=by_bucket[eng.buckets[-1]],
               eager_prefills=eager_prefills, rows_bytes=rows,
               graph_rows_bytes=graph_rows_bytes(cfg), admission_pieces=adm_n,
               admission_replays=adm_r, peak_transient_bytes=peaks)
    say(f"admission sweep ({card}): every bucket {eng.buckets} x groups {sizes}, first tokens "
        f"equal to the eager twin's; {adm_n} admission pieces captured ({adm_r} replays, "
        f"{table.capture_s:.2f} s of capture), prefills past GRAPH_ROWS = {GRAPH_ROWS} rows "
        f"eager {eager_prefills}; the graphs' pool after the timed admissions "
        f"{out['timed_pool_bytes'] / 2**20:.1f} MiB, after each bucket "
        + ", ".join(f"{b}: {v / 2**20:.1f}" for b, v in by_bucket.items())
        + f" MiB; the engine-owned prefill rows {rows / 2**20:.1f} MiB (capacity counts "
        f"{graph_rows_bytes(cfg) / 2**20:.1f}); an admission's peak transient, on the graph "
        f"route (a key's first use: its eager run and its capture) / the eager twin, by "
        f"bucket (the largest group): "
        + ", ".join(f"{b}: {peaks[f'replayed {sizes[-1]}x{b}'] / 2**30:.2f} / "
                    f"{peaks[f'eager {sizes[-1]}x{b}'] / 2**30:.2f} GiB" for b in eng.buckets))
    if (out["pool_bytes"] > ADMIT_POOL_LIMIT or rows != graph_rows_bytes(cfg)
            or any(nb * b <= GRAPH_ROWS for nb, b in eager_prefills)):
        raise AssertionError(f"admission sweep: pool {out['pool_bytes']} bytes (limit "
                             f"{ADMIT_POOL_LIMIT}), rows {rows}, eager {eager_prefills}")
    del eng, twin
    torch.cuda.empty_cache()
    return out


def same_key_check(params, cfg, rng, card) -> dict:
    """Two admissions at one key into other slots with other prompts, each
    equal to the eager twin, A16 and then A8 (BITDISTILLER_QMM_A8=1 for that
    run only, the weights repacked once: the replayed prefills run B4 over
    the CUtensorMaps encoded at capture): on a 2-slot 7B engine, W alone
    takes slot 0 (the group-of-1 pieces captured), X and Y share a group, Y
    finishes and Z takes slot 1 (replayed), then U takes slot 0 (replayed
    again); tokens and launch counts of every stream against
    graphs=False."""
    runs = [[(64, 4)], [(64, 24), (64, 2), (64, 8)], [(64, 8)]]
    runs = [[(rng.integers(3, cfg.vocab_size, n).tolist(), new) for n, new in run] for run in runs]
    out = {}
    for tag in ("A16", "A8"):
        saved = os.environ.get(qm.A8_ENV)
        os.environ[qm.A8_ENV] = "1" if tag == "A8" else "0"
        try:
            weights = qm.maybe_repack_a8(params)
            got = {}
            for route, graphs in (("replayed", None), ("eager", False)):
                eng = Engine(weights, cfg, max_slots=2, max_len=512, eos_token_id=None,
                             sampling=SamplingParams(temperature=0.0), grow_cache=False,
                             device=DEV, graphs=graphs)
                torch.cuda.synchronize()
                reset_counts()
                outs = []
                for run in runs:
                    reqs = [Request(prompt_tokens=p, max_new_tokens=new) for p, new in run]
                    eng.run(reqs)
                    outs.append([r.output_tokens for r in reqs])
                torch.cuda.synchronize()
                got[route] = (outs, read_counts(), eng)
        finally:
            if saved is None:
                os.environ.pop(qm.A8_ENV, None)
            else:
                os.environ[qm.A8_ENV] = saved
        outs, counts, eng = got["replayed"]
        table = eng._graphs
        ones = [k for k in table.captured if k in (("prefill", 64, 1), ("commit", 1, False))]
        replays = sum(table.replayed[k] for k in ones)
        same = outs == got["eager"][0] and counts == got["eager"][1]
        a8_ok = (counts["qmm_a8_prefill"] > 0) == (tag == "A8")
        say(f"serve same-key admissions {tag} ({card}): the group-of-1 pieces {ones} captured "
            f"once and replayed into slot 1, then slot 0, with other prompts ({replays} "
            f"replays of them; B4 prefill launches {counts['qmm_a8_prefill']}): tokens and "
            f"launches {'equal to' if same else 'DIFFERENT from'} the eager twin's")
        if not same or len(ones) != 2 or replays < 4 or not a8_ok:
            raise AssertionError(f"serve same-key admissions {tag}: {outs} vs "
                                 f"{got['eager'][0]}, {counts} vs {got['eager'][1]}")
        out[tag] = dict(tokens_equal=same, replays=replays, launches=counts,
                        captured=[list(k) for k in table.captured])
        del got, eng, weights
    return out


HTTP_TEXT = "the quick brown fox jumps over the lazy dog while the cat sleeps by the warm fire "


def http_load(eng, card) -> dict:
    """An in-process ServingFrontend on port 0 with the byte tokenizer: the
    engine loop in this thread, the port's run_load in another, 32 requests
    at concurrency 16 mixing /generate (JSON and SSE), /v1/completions,
    /v1/chat/completions with a multi-token stop string, /health and
    /metrics. Every request must succeed."""
    front = ServingFrontend(eng, ByteTok(), port=0)
    host, port = front.address
    url = f"http://{host}:{port}"
    jobs = []
    for i in range(HTTP_REQUESTS):
        text = HTTP_TEXT[i % 17:] + HTTP_TEXT[:i % 17]
        kind = i % 8
        if kind in (0, 1, 2):
            jobs.append(("/generate", {"prompt": text, "max_new_tokens": HTTP_NEW,
                                       "temperature": 0.0, "stream": kind == 2}))
        elif kind in (3, 4):
            jobs.append(("/v1/completions", {"prompt": text, "max_tokens": HTTP_NEW}))
        elif kind == 5:
            jobs.append(("/v1/chat/completions", {
                "messages": [{"role": "user", "content": text}], "max_tokens": HTTP_NEW,
                "stop": "xyz"}))
        else:
            jobs.append(("/health" if kind == 6 else "/metrics", None))
    out = {}

    def client():
        try:
            out["summary"] = loadtest.run_load([url + p for p, _ in jobs], [b for _, b in jobs],
                                               HTTP_CONCURRENCY, timeout=300)
        finally:
            front.shutdown()

    t = threading.Thread(target=client)
    reset_counts()
    t0 = time.time()
    t.start()
    front.serve_forever()  # the engine loop, here; returns once the client is done
    t.join(timeout=300)
    wall = time.time() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    summary = out.get("summary")
    if t.is_alive() or summary is None or summary["errors"] or summary["ok"] != len(jobs):
        raise AssertionError(f"serve http: {summary}")
    say(f"serve http ({card}): {len(jobs)} requests at concurrency {HTTP_CONCURRENCY} "
        f"(/generate JSON and SSE, /v1/completions, /v1/chat/completions with a stop string, "
        f"/health, /metrics): {len(jobs) / wall:.2f} requests/s, latency p50 "
        f"{summary['latency_p50_s']} s p99 {summary['latency_p99_s']} s, "
        f"{summary['throughput_tok_s']} tokens/s; launches {counts}")
    return dict(summary, wall_s=wall, requests_per_s=len(jobs) / wall, launches=counts)


def twin_check(run: dict, twin, prompts, what: str, card: str) -> dict:
    """`run` (a drive of a replaying engine) beside the same requests through
    its eager twin: tokens and launch counts must be equal bit for bit."""
    other = drive(twin, prompts, SERVE_NEW, f"{what} eager twin")
    same = other["outs"] == run["outs"]
    say(f"{what} replayed vs its eager twin ({card}): tokens "
        f"{'bit-equal' if same else 'DIFFERENT'}, launches "
        f"{'equal' if other['launches'] == run['launches'] else 'DIFFERENT'}; "
        f"{run['ms_per_token']:.3f} ms a generated token replayed, "
        f"{other['ms_per_token']:.3f} eager")
    if not same or other["launches"] != run["launches"]:
        raise AssertionError(f"{what}: the replayed run and its eager twin differ")
    return dict(ms_per_token=run["ms_per_token"], twin_ms_per_token=other["ms_per_token"],
                tokens_equal=same, wall_s=run["wall_s"], twin_wall_s=other["wall_s"])


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in one graph memory pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def warmup_run(eng, prompt, card) -> dict:
    """Engine.warmup, with the graphs' memory pool read after each capture
    (decode steps by the cache length they were captured at, admission
    pieces by key: the pool's growth each), then the first live request's
    launches and wall time: it must capture nothing."""
    table = eng._graphs
    capture, pools = table.capture, []

    def measured(graph, body):
        outs = capture(graph, body)
        pools.append(pool_bytes(capture.pool))
        return outs

    table.capture = measured
    torch.cuda.synchronize()
    t0 = time.time()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    table.capture = capture
    if eng._cache_len() != eng.max_len or eng.active.any():
        raise AssertionError("serve warmup did not walk every cache bucket")
    captured = list(table.captured)
    growth, prev = {}, 0
    for k, b in zip(captured, pools):
        growth[k] = b - prev
        prev = b
    by_key = {str(k): b for k, b in growth.items() if piece(k) in ADMISSION_PIECES}
    steps_by_len = {k[0]: b for k, b in zip(captured, pools) if piece(k) in STEP_PIECES}
    steps = [k for k in captured if piece(k) in STEP_PIECES]
    kept = list(table.graphs)
    first = drive(eng, [prompt], 32, "serve first request after warmup")
    say(f"serve warmup ({card}): {warm_s:.2f} s (buckets {eng.cache_buckets}"
        f"{', speculative' if eng.spec_decode else ''}); {len(steps)} step graphs "
        f"and {len(captured) - len(steps)} admission pieces captured in "
        f"{table.capture_s:.2f} s, {len(kept)} kept "
        f"({sorted(map(str, kept))}); the graphs' pool by cache length after the steps "
        + ", ".join(f"{t}: {b / 2**20:.1f} MiB" for t, b in sorted(steps_by_len.items()))
        + f", {prev / 2**20:.1f} MiB in all; its growth by admission piece "
        + ", ".join(f"{k}: {b / 2**20:.1f} MiB" for k, b in by_key.items())
        + f"; first live request {first['wall_s'] * 1e3:.1f} ms, launches {first['launches']}, "
        f"{len(table.captured) - len(captured)} captures")
    if table.captured != captured:
        raise AssertionError(f"serve warmup: the first live request captured "
                             f"{table.captured[len(captured):]}")
    return dict(seconds=warm_s, graphs=len(steps), admission_pieces=len(captured) - len(steps),
                capture_s=table.capture_s, kept=[list(k) for k in kept],
                pool_bytes=steps_by_len, pool_growth_by_key=by_key, pool_bytes_total=prev,
                first={k: v for k, v in first.items() if k != "outs"})


def packed_bytes(tree) -> tuple[int, int]:
    """(bytes the kernels read: codes, combo words and every dense leaf;
    the whole tree, the f32 scales and zeros too)."""
    read = whole = 0
    for _, leaf in tr.tree_items(tree):
        if isinstance(leaf, PackedLinear):
            read += leaf.qweight.nbytes + leaf.combo.nbytes
            whole += leaf.qweight.nbytes + leaf.combo.nbytes + leaf.scales.nbytes + leaf.szeros.nbytes
        else:
            read += leaf.nbytes
            whole += leaf.nbytes
    return read, whole


def capacity_check(params, live_slot_bytes: int, card) -> dict:
    """serve_capacity for Llama-2-7B int2-g128 at 2048 against the card's
    memory, bf16 and int8 caches: kv_bytes_per_slot equal to a live cache's
    bytes (the static engine's bf16 cache; a one-slot int8 cache), the
    weights within 1% of the packed tree's."""
    read, whole = packed_bytes(params)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        cap = serve_capacity(CFG, bits=BITS, group_size=GROUP, max_len=SERVE_LEN, kv_dtype=dtype,
                             grow_cache=False)
        grown = serve_capacity(CFG, bits=BITS, group_size=GROUP, max_len=SERVE_LEN,
                               kv_dtype=dtype)
        live = live_slot_bytes
        if dtype == torch.int8:
            c = KVCache.init(CFG, 1, SERVE_LEN, dtype, device=DEV)
            live = c.k.nbytes + c.v.nbytes + c.k_scale.nbytes + c.v_scale.nbytes
            del c
        if cap["kv_bytes_per_slot"] != live or abs(cap["weights_bytes"] - read) > CAPACITY_TOL * read:
            raise AssertionError(f"serve capacity {name}: {cap} against a live slot of {live} "
                                 f"bytes and a packed tree of {read}")
        out[name] = dict(cap, live_slot_bytes=live, grow_max_slots=grown["max_slots"])
        say(f"serve capacity {name} ({card}, {torch.cuda.get_device_properties(0).total_memory} "
            f"bytes): {cap['max_slots']} slots at {SERVE_LEN} (static cache), "
            f"{grown['max_slots']} growing; kv a slot {cap['kv_bytes_per_slot']} = the live "
            f"cache's {live}; weights {cap['weights_bytes']} vs the packed tree's {read} "
            f"({(cap['weights_bytes'] - read) / read:+.4%}; with the f32 scales and zeros "
            f"{whole})")
    return out


def method_spec_check(spec: dict, cfg, out: str, card: str) -> dict:
    """The method script's spec bench (seven engine variants on the packed
    int2 teacher, 16 held-out prompts, greedy): each variant's acceptance, k
    and greedy agreement with plain, every token of every divergent stream
    held by the tie rule (delta over the ladder's k at the bench's 16 slots
    and over the cache lengths the engines reached). The bench's engines
    fall back to the plain step once acceptance is under the floor, so one
    more run verifies every round (no fallback) and reports the acceptance
    the drafts reach on the teacher."""
    from bitdistiller_tpu_torch.scripts import method_demo

    params, prompts = spec["params"], spec["prompts"]
    plain = spec["plain"]
    ref = plain["outs"]
    delta = max(delta_verify(params, cfg, prompts, ref, k) for k in SPEC_LADDER)
    method_demo.replace_section(out, spec["header"], "\n".join(spec["lines"]))
    for line in spec["lines"]:
        if line.startswith("|"):
            say(f"method spec {line}")
    rows = {}
    for mode, _ in method_demo.SPEC_VARIANTS:
        r = spec[mode]
        rows[mode] = {k: r[k] for k in ("tok_s", "accept", "k", "rounds", "spec_forwards",
                                        "decode_steps", "cache_len")}
        if mode != "plain":
            rows[mode]["agree"] = r["agree"]
            rows[mode]["ties"] = tie_rule(params, cfg, prompts, ref, r["outs"], delta,
                                          f"method spec {mode} vs plain ({card})",
                                          (plain["cache_len"], r["cache_len"]))
    eng = Engine(params, cfg, max_slots=len(prompts), max_len=method_demo.SEQ,
                 sampling=SamplingParams(temperature=0.0), eos_token_id=None,
                 decode_horizon=16, device=DEV, spec_decode=True, spec_k=SPEC_LADDER[0])
    eng.spec_min_accept = -1.0  # no fallback: every round verifies
    outs = eng.generate(prompts, max_new_tokens=len(ref[0]))
    forced = dict(accept=eng.spec_tokens / max(eng.spec_rounds, 1), rounds=eng.spec_rounds,
                  k=eng._spec_k_last, spec_forwards=dict(eng.spec_forwards),
                  decode_steps=eng.decode_steps, cache_len=eng._cache_len())
    say(f"method spec, every round verified ({card}): acceptance {forced['accept']:.3f} "
        f"tokens a verify cell over {forced['rounds']} cells, k ends at {forced['k']}, "
        f"verify forwards by k {forced['spec_forwards']}, plain steps {forced['decode_steps']}")
    forced["ties"] = tie_rule(params, cfg, prompts, ref, outs, delta,
                              f"method spec every round verified vs plain ({card})",
                              (plain["cache_len"], forced["cache_len"]))
    return dict(delta=delta, rows=rows, forced_verify=forced)


TF32_KERNELS = ("train_attn_fwd_tf32_kernel<64>", "train_attn_fwd_tf32_kernel<128>",
                "train_attn_dkv_tf32_kernel<64>", "train_attn_dkv_tf32_kernel<128>",
                "train_attn_dq_tf32_kernel<64>", "train_attn_dq_tf32_kernel<128>",
                "train_attn_fwd_tf32_split_kernel", "train_attn_dkv_tf32_split_kernel",
                "train_attn_dq_tf32_split_kernel")


# ---- tensor parallelism (TP-a): tp = 2 on two ranks of the one card ------------

TP_TRAIN_CFG = dataclasses.replace(TINYLLAMA_1B, num_layers=2)  # full width, depth cut
TP_DECODE_CFG = dataclasses.replace(LLAMA2_7B, num_layers=2)
TP_PROMPT = (8, 64)  # 8 slots of 64 prompt tokens: a prefill of 512 rows through B1
TP_STEPS = 8
TP_CACHE = 128
# The tp = 2 runs against the one-process runs on the same weights and inputs,
# both through the kernels: bf16 activations, where the row-parallel o and
# down sum two bf16 partial products in f32 and one process rounds one
# product. Logits as the whole decode step's (LOGIT_TOL); the training
# losses within tests/test_torch_dp_train.py's bf16 bound.
TP_LOSS_TOL = 2e-3
TP_TIMEOUT_S = 300
# the engine over the tp group (A11b): 8 prompts of 64 tokens, 32 new each,
# greedy, bf16 cache (the engine's first bucket, 64 rows, grown to 128)
TP_SERVE = (8, 64, 32)
TP_SERVE_LEN = 256
TP_HORIZON = 8  # the engine's default decode_horizon
# the ring's chunk matmuls of a 7B tp = 2 rank: o and down, K / 2 x N / 2
TP_RING_CHUNKS = {"o_chunk": (2048, 2048), "down_chunk": (5504, 2048)}
# the engine's graph route under the mesh (A3i): the speculative tp engine's
# fixed draft length (every round verifies), the warmed engine's cache and
# its live requests' new tokens, and the NCCL capture probe's time limit
TP_SPEC_K = 4
TP_WARM_LEN = 128
TP_WARM_NEW = 8
TP_PROBE_TIMEOUT_S = 180
TP_PP_TOKENS = (4, 128)  # GPipe at pp = 2: 4 x 128 tokens, n_micro = 2
TP_PP_MICRO = 2
# the graphs' pool of a mesh engine after an admission at every prompt bucket
# from 256 and group size up to GRAPH_ROWS rows: the 7B's widths, its depth cut
# to 8 layers (gloo moves each prefill's 2L + 1 f32 sums through the host)
TP_POOL_CFG = dataclasses.replace(LLAMA2_7B, num_layers=8)
TP_POOL_MIN_BUCKET = 256


def tp_shard_shapes(cfg, tp: int = 2) -> dict:
    """{linear: (K, N)} of one tp rank's slice of the unfused layer linears:
    q, k, v, gate, up column-parallel (N / tp), o and down row-parallel
    (K / tp)."""
    local, d, dh = tp_config(cfg, tp), cfg.hidden_size, cfg.actual_head_dim
    q, kv, ffn = local.num_heads * dh, local.num_kv_heads * dh, local.intermediate_size
    return {"q": (d, q), "k": (d, kv), "v": (d, kv), "o": (q, d), "gate": (d, ffn),
            "up": (d, ffn), "down": (ffn, d)}


def tp_predicted(layers: int) -> dict:
    """B1, B2 and B3 launches of `tp_decode` on unfused layers: the
    prefill's 7 matmuls a layer through B1, every step's 7 through B2 and
    its attention through B3."""
    return dict(qmm_prefill=7 * layers, qmm_decode=7 * layers * TP_STEPS,
                flash_decode=layers * TP_STEPS)


def tp_engine_steps(new: int, horizon: int = TP_HORIZON) -> int:
    """Decode steps of one admission group of requests of `new` tokens each:
    the first token comes from the prefill; each horizon is the engine's
    decode_horizon, halved while it exceeds the tokens left
    (serve/engine.py:run)."""
    steps, left = 0, new - 1
    while left > 0:
        s = horizon
        while s > 1 and s > left:
            s //= 2
        steps, left = steps + s, left - s
    return steps


def tp_engine_predicted(layers: int, a8: bool) -> dict:
    """Launches of `tp_engine` on unfused layers, from the code: one prefill
    of 8 x 64 rows (7 matmuls a layer through B1, or B4's prefill kernels
    under A8), then tp_engine_steps decode steps (7 through B2 or B4, the
    attention through B3)."""
    steps = tp_engine_steps(TP_SERVE[2])
    if a8:
        return dict(qmm_a8=7 * layers * (1 + steps), qmm_a8_prefill=7 * layers, qmm_prefill=0,
                    qmm_decode=0, flash_decode=layers * steps)
    return dict(qmm_prefill=7 * layers, qmm_decode=7 * layers * steps, qmm_a8=0,
                flash_decode=layers * steps)


def tp_ring_predicted(layers: int, tp: int = 2) -> dict:
    """`tp_decode`'s launches under BITDISTILLER_RING_TP=1: q, k, v, gate,
    up once a layer, o and down as tp chunk matmuls each."""
    per = 5 + 2 * tp
    return dict(qmm_prefill=per * layers, qmm_decode=per * layers * TP_STEPS,
                flash_decode=layers * TP_STEPS)


def tp_a8_predicted(layers: int) -> dict:
    """`tp_decode`'s launches under BITDISTILLER_QMM_A8=1: every matmul through B4."""
    return dict(qmm_a8=7 * layers * (1 + TP_STEPS), qmm_a8_prefill=7 * layers,
                flash_decode=layers * TP_STEPS)


def tp_engine(params, cfg, mesh, dev, graphs=None, spec=False) -> dict:
    """TP_SERVE's requests (random prompts, seed 2) through `Engine(...,
    mesh=mesh)` (None: one process), greedy, a bf16 cache growing from its
    first bucket, on the engine's default route (`graphs=False`: its eager
    twin); `spec`: n-gram speculation at TP_SPEC_K with every round
    verifying. The launch counts reset just before the run and read just
    after. Returns the streams, the counts, what the engine ran, the host
    seconds and how they divide (`host_split`), and on the graph route the
    segments by key, the graphs held and the capture seconds."""
    n, plen, new = TP_SERVE
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, cfg.vocab_size, plen).tolist() for _ in range(n)]
    kw = dict(spec_decode=True, spec_k=TP_SPEC_K, spec_adaptive_k=False) if spec else {}
    eng = Engine(params, cfg, max_slots=n, max_len=TP_SERVE_LEN, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), device=dev, mesh=mesh, graphs=graphs,
                 **kw)
    if spec:
        eng.spec_min_accept = -1.0  # every round verifies: the verify keys replay
    torch.cuda.synchronize()
    reset_counts()
    stats = dict(BOUNDARY_STATS)
    t0 = time.time()
    with warnings.catch_warnings(record=True) as seen:  # torch warns at an empty capture
        warnings.simplefilter("always")
        outs = eng.generate(prompts, new)
        torch.cuda.synchronize()
    wall = time.time() - t0
    route = f"{eng.route}, admission {eng.route}"
    out = dict(prompts=prompts, outs=outs, launches=read_counts(), wall_s=wall, route=route,
               decode_steps=eng.decode_steps, prefills=eng.prefills,
               verify_forwards=dict(eng.spec_forwards), growths=list(eng.growths),
               cache_len=eng._cache_len(), cache_shape=list(eng.cache.k.shape),
               host_split=tp_host_split(eng, wall, stats),
               empty_graphs=sum("CUDA Graph is empty" in str(w.message) for w in seen))
    if eng._graphs is not None:
        segs = eng._graphs.segments()
        out.update(segments={repr(k): v for k, v in segs.items()},
                   pieces={repr(k): piece(k) for k in segs}, graphs=sum(segs.values()),
                   capture_s=eng._graphs.capture_s, replays=eng._graphs.replays)
    return out


def tp_host_split(eng, wall: float, before: dict) -> dict:
    """How a run's host seconds divide: the replays of the segments, the
    boundary operations (issued between segments by a replay, or eagerly:
    the eager route's, and a key's first use), and the rest (captures, the
    eager route's launches, the host loop)."""
    ops = {k: BOUNDARY_STATS[k] - before[k] for k in before}
    replay_s = eng._graphs.replay_s if eng._graphs is not None else 0.0
    segments_s = replay_s - ops["replayed_s"]
    boundary_s = ops["replayed_s"] + ops["eager_s"]
    return dict(total_s=wall, segments_s=segments_s, boundary_s=boundary_s,
                rest_s=wall - segments_s - boundary_s,
                boundary_calls=ops["replayed_calls"] + ops["eager_calls"])


def tp_admission_pool(mesh, dev) -> dict:
    """The graphs' pool of an engine over the mesh (TP_POOL_CFG's tp slice,
    8 slots, a static 2048-row cache) after one admission at every prompt
    bucket from TP_POOL_MIN_BUCKET and every group size up to GRAPH_ROWS
    rows (each key's first use eager, then captured), read after each
    bucket; then every group again, replayed with the other keys' captures
    in the same pool, its first tokens equal to its first use's and nothing
    captured. An operation between segments holds its buffers as views the
    pool reuses, so the pool stays near one prefill's transients; held
    buffers would pin each prefill key's 2L + 1 f32 sums of rows x hidden
    (`pinned_sums_bytes`)."""
    cfg = TP_POOL_CFG
    whole = random_packed_params(cfg, bits=BITS, group_size=GROUP, seed=5, device=dev,
                                 fuse=False)
    shard = shard_packed_model(whole, mesh, cfg)
    del whole
    eng = Engine(shard, cfg, max_slots=8, max_len=2048, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), grow_cache=False, device=dev,
                 mesh=mesh)
    table = eng._graphs
    rng = np.random.default_rng(6)
    groups = [(b, nb) for b in eng.buckets if b >= TP_POOL_MIN_BUCKET for nb in (1, 2, 4, 8)
              if nb * b <= GRAPH_ROWS]
    prompts = {g: [rng.integers(3, cfg.vocab_size, g[0]).tolist() for _ in range(g[1])]
               for g in groups}
    firsts, by_bucket = {}, {}
    t0 = time.time()
    for g in groups:
        firsts[g] = eng.generate(prompts[g], 1)
        torch.cuda.synchronize()
        by_bucket[g[0]] = pool_bytes(table.capture.pool)
    first_s, captured = time.time() - t0, len(table.captured)
    t0 = time.time()
    again = {g: eng.generate(prompts[g], 1) for g in groups}
    torch.cuda.synchronize()
    out = dict(groups=groups, pool_bytes_by_bucket=by_bucket,
               pool_bytes=pool_bytes(table.capture.pool), captured=captured,
               after=len(table.captured), prefill_keys=sum(("prefill", b, nb) in table.graphs
                                                           for b, nb in groups),
               replays_equal=again == firsts, first_s=first_s, replay_s=time.time() - t0,
               capture_s=table.capture_s, rows_bytes=sum(t.nbytes for t in eng._rows or ()),
               graph_rows_bytes=graph_rows_bytes(cfg, mesh.tp), firsts=list(firsts.values()),
               pinned_sums_bytes=sum((2 * cfg.num_layers + 1) * b * nb * cfg.hidden_size * 4
                                     for b, nb in groups))
    del eng, shard
    torch.cuda.empty_cache()
    return out


def tp_segments(kind: str, layers: int, tp: int, ring: bool = False) -> int:
    """Segments of one key of the Llama engine over a mesh, from the code
    (serve/engine.py): a step or verify round reaches the embedding's
    all-reduce, o's and down's in each layer (under the ring, 3 (tp - 1)
    hops' operations each, parallel/overlap.py), the logits' all-gather and the tokens'
    broadcast over tp; a prefill or tail prefill all but the broadcast; a
    commit the first tokens' broadcast from global rank 0; an insert none.
    A chain has one segment more than its operations."""
    if kind == "insert":
        return 1
    if kind == "commit":
        return 2
    if tp == 1:
        return 1
    per = 3 * (tp - 1) if ring else 1
    return 3 + 2 * layers * per + (kind in STEP_PIECES)


def tp_engine_warm(params, cfg, mesh, dev) -> dict:
    """`warmup()` of an engine over the mesh (max_len TP_WARM_LEN, prompt
    length TP_SERVE[1]), then live requests: TP_SERVE[0] - 1 random
    prompts and one with a per-request (greedy) sampling override, one
    admission group, TP_WARM_NEW new tokens each. Returns the keys
    captured by the warmup and after it, the graphs, the capture seconds."""
    n, plen, _ = TP_SERVE
    eng = Engine(params, cfg, max_slots=n, max_len=TP_WARM_LEN, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), device=dev, mesh=mesh)
    t0 = time.time()
    eng.warmup(prompt_len=plen)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    table = eng._graphs
    captured, capture_s = len(table.captured), table.capture_s
    segs = table.segments()
    rng = np.random.default_rng(4)
    reqs = [Request(prompt_tokens=rng.integers(3, cfg.vocab_size, plen).tolist(),
                    max_new_tokens=TP_WARM_NEW) for _ in range(n - 1)]
    reqs.append(Request(prompt_tokens=rng.integers(3, cfg.vocab_size, plen).tolist(),
                        max_new_tokens=TP_WARM_NEW, sampling=SamplingParams(temperature=0.0)))
    t0 = time.time()
    eng.run(reqs)
    torch.cuda.synchronize()
    return dict(route=f"{eng.route}, admission {eng.route}", warm_s=warm_s, captured=captured,
                after=len(table.captured), capture_s=capture_s, graphs=sum(segs.values()),
                kinds=sorted({piece(k) for k in segs}), live_s=time.time() - t0,
                pool_bytes=torch.cuda.memory_stats().get("reserved_bytes.all.current", 0),
                outs=[r.output_tokens for r in reqs])


def nccl_probe(rank: int, port: int, tmp: Path) -> None:
    """A finding for whole-step capture (A3j), no route's: on an NCCL group
    of one rank, all_reduce, all_gather and broadcast of CUDA tensors run
    eagerly, then captured in one CUDA graph and replayed on new inputs;
    writes tmp/nccl_probe.pt with whether each replay gave the eager
    values, or the error that stopped it."""
    import torch.distributed as dist

    out: dict = {"captured": False}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                                rank=0)
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
        x = torch.arange(4096, dtype=torch.float32, device="cuda")
        parts = [torch.empty_like(x)]
        b = torch.empty_like(x)

        def ops():
            y = x * 3.0
            dist.all_reduce(y)
            dist.all_gather(parts, y + 1.0)
            b.copy_(y - 1.0)
            dist.broadcast(b, src=0)
            return y

        want = ops().clone(), parts[0].clone(), b.clone()  # eager, also NCCL's warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            y = ops()
        out["captured"] = True
        x.copy_(torch.arange(4096, dtype=torch.float32, device="cuda").flip(0))
        want_new = ops().clone(), parts[0].clone(), b.clone()
        x.copy_(torch.arange(4096, dtype=torch.float32, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        got = y, parts[0], b
        out["replay_equal"] = {name: bool(torch.equal(g, w)) for name, g, w in
                               zip(("all_reduce", "all_gather", "broadcast"), got, want)}
        x.copy_(torch.arange(4096, dtype=torch.float32, device="cuda").flip(0))
        graph.replay()
        torch.cuda.synchronize()
        out["replay_follows_inputs"] = all(torch.equal(g, w) for g, w in
                                           zip((y, parts[0], b), want_new))
    except Exception as err:  # the finding: what stopped the capture or the replay
        out["error"] = f"{type(err).__name__}: {err}"[:400]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, tmp / "nccl_probe.pt")


def tp_nccl_probe(tmp: Path) -> dict:
    """`nccl_probe` in a process of its own, killed at TP_PROBE_TIMEOUT_S."""
    import torch.multiprocessing as mp

    t0 = time.time()
    ctx = mp.start_processes(nccl_probe, args=(free_port(), tmp), nprocs=1, join=False,
                             start_method="spawn")
    deadline = time.time() + TP_PROBE_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.time() > deadline:
                return dict(error=f"not done in {TP_PROBE_TIMEOUT_S} s", captured=False)
    except Exception as err:
        return dict(error=f"the probe's process failed: {err}"[:400], captured=False)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    out = torch.load(tmp / "nccl_probe.pt", weights_only=False)
    out["wall_s"] = time.time() - t0
    return out


def tp_pipeline(whole, cfg, dev) -> dict:
    """GPipe at pp = 2 over the group's two ranks (one layer a stage):
    `pipeline_forward` of TP_PP_TOKENS random tokens (seed 3) at n_micro =
    TP_PP_MICRO on the whole packed tree cut by `shard_params_pp`, the
    launch counts reset just before and read just after; then, in this
    process, the one-process forward on the whole tree: its largest logit
    and the pipeline's largest gap from it."""
    pp_mesh = make_pp_mesh(2)
    local = shard_params_pp(whole, pp_mesh)
    b, s = TP_PP_TOKENS
    toks = torch.randint(3, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        got = pipeline_forward(local, cfg, toks, pp_mesh, n_micro=TP_PP_MICRO)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        want, _ = forward(whole, cfg, toks)
    return dict(launches=counts, wall_s=wall, err=(got - want).abs().max().item(),
                scale=want.abs().max().item(), shape=list(got.shape),
                transport=p2p_transport(want, pp_mesh.group))


def tp_decode(params, cfg, mesh, dev, forced=None):
    """TP_PROMPT random prompts (seed 1) prefilled into a TP_CACHE-row bf16
    cache, then TP_STEPS greedy decode steps (or the `forced` tokens), on
    `mesh`'s tp slice (None: one process), the launch counts reset just
    before and read just after. Returns (the last position's logits of the
    prefill and of each step, [TP_STEPS + 1, B, V] f32 on the host; the
    tokens fed; the counts; each step's host ms)."""
    local = cfg if mesh is None else tp_config(cfg, mesh.tp)
    b, s = TP_PROMPT
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(3, cfg.vocab_size, (b, s), generator=gen, device=dev)
    cache = KVCache.init(local, b, TP_CACHE, device=dev)
    logits_out, toks, step_ms = [], [], []
    with torch.inference_mode():
        reset_counts()
        logits, _ = forward(params, cfg, prompts, cache=cache, cache_pos=0, mesh=mesh)
        last = logits[:, -1]
        for i in range(TP_STEPS):
            logits_out.append(last.float().cpu())
            tok = last.argmax(-1) if forced is None else forced[i].to(dev)
            toks.append(tok.cpu())
            pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t0 = time.time()
            logits, _ = forward(params, cfg, tok[:, None], cache=cache, cache_pos=pos, mesh=mesh)
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
            last = logits[:, 0]
        logits_out.append(last.float().cpu())
        counts = read_counts()
    return torch.stack(logits_out), torch.stack(toks), counts, step_ms


def tp_rank(rank: int, world: int, port: int, tmp: Path) -> None:
    """One of the tp phase's two ranks, both on the one card, joined over
    gloo (NCCL refuses two ranks on one device; gloo stages each collective
    through the host, and each point-to-point hop through host memory): the
    dry run's steps (`scripts/dryrun_multichip.py`, GPipe's part included),
    the packed 7B decode (`tp_decode`) on the rank's tp slice of
    TP_DECODE_CFG, again under BITDISTILLER_RING_TP=1 (o and down through
    the ring) and under BITDISTILLER_QMM_A8=1, the engine over the tp group
    (`tp_engine`, A16 then A8, speculative, and under the ring), each on its
    default route (graphs) and beside it its eager twin (graphs=False), the
    engine after its warmup (`tp_engine_warm`), the graphs' pool after an
    admission at every bucket and group (`tp_admission_pool`), the engine over the same
    ranks as dp = 2, tp = 1 (both routes), GPipe at pp = 2
    (`tp_pipeline`), and run_training of TP_TRAIN_CFG at tp = 2 through
    B8, each with its launch counts. Writes tmp/rank{r}.pt (rank 0 also its
    final master and train config)."""
    dev = torch.device(DEV, 0)
    torch.cuda.set_device(dev)
    init_distributed(f"127.0.0.1:{port}", world, rank, device=DEV, backend="gloo")
    out: dict = {}
    try:
        reset_counts()
        t0 = time.time()
        out["dryrun"] = tp_dryrun(dev)
        out["dryrun_s"] = time.time() - t0
        out["dryrun_launches"] = read_counts()
        mesh = make_hybrid_mesh(tp=2)
        cfg = TP_DECODE_CFG
        whole = random_packed_params(cfg, bits=BITS, group_size=GROUP, seed=0, device=dev,
                                     fuse=False)
        shard = shard_packed_model(whole, mesh, cfg)
        out["decode"] = tp_decode(shard, cfg, mesh, dev)
        forced = out["decode"][1]
        os.environ["BITDISTILLER_RING_TP"] = "1"
        try:
            out["ring"] = tp_decode(shard, cfg, mesh, dev, forced=forced)
        finally:
            os.environ.pop("BITDISTILLER_RING_TP")
        out["ring_leaves"] = len(mesh.ring_cache)
        out["transport"] = p2p_transport(forced.to(dev), mesh.tp_group)
        for graphs, tag in ((None, ""), (False, "_eager")):
            out["engine" + tag] = tp_engine(shard, cfg, mesh, dev, graphs=graphs)
            out["engine_spec" + tag] = tp_engine(shard, cfg, mesh, dev, graphs=graphs, spec=True)
        os.environ["BITDISTILLER_RING_TP"] = "1"
        try:
            for graphs, tag in ((None, ""), (False, "_eager")):
                out["engine_ring" + tag] = tp_engine(shard, cfg, mesh, dev, graphs=graphs)
        finally:
            os.environ.pop("BITDISTILLER_RING_TP")
        out["engine_warm"] = tp_engine_warm(shard, cfg, mesh, dev)
        out["engine_pool"] = tp_admission_pool(mesh, dev)
        os.environ[qm.A8_ENV] = "1"
        try:
            for graphs, tag in ((None, ""), (False, "_eager")):
                out["engine_a8" + tag] = tp_engine(shard, cfg, mesh, dev, graphs=graphs)
            out["decode_a8"] = tp_decode(qm.maybe_repack_a8(shard), cfg, mesh, dev,
                                         forced=forced)
        finally:
            os.environ.pop(qm.A8_ENV)
        dp_mesh = make_mesh(dp=2, tp=1)  # the same two ranks, each slot a dp rank's own
        for graphs, tag in ((None, ""), (False, "_eager")):
            out["engine_dp" + tag] = tp_engine(whole, cfg, dp_mesh, dev, graphs=graphs)
        out["pipeline"] = tp_pipeline(whole, cfg, dev)
        del shard, whole
        torch.cuda.empty_cache()
        os.environ["BITDISTILLER_TRAIN_FLASH"] = "1"
        params = init_params(TP_TRAIN_CFG, seed=0, dtype=torch.bfloat16, device=dev)
        reset_counts()
        t0 = time.time()
        summary = run_training(train_args(tmp / "teacher.jsonl", tmp / "tp2", tp=2,
                                          save_steps=4), tokenizer=ByteTok(),
                               model=(params, TP_TRAIN_CFG))
        out["train"] = dict(launches=read_counts(), wall_s=time.time() - t0,
                            steps=summary["steps"], beta=summary["beta"],
                            final_loss=summary["final_loss"])
        if rank == 0:
            torch.save({"master": tr.tree_map(lambda x: x.cpu(), summary["master"]),
                        "train_config": summary["train_config"]}, tmp / "tp2_master.pt")
    finally:
        shutdown_distributed()
    torch.save(out, tmp / f"rank{rank}.pt")


def tp_spawn(tmp: Path) -> list:
    """The two ranks of `tp_rank`, each a fresh process; every one left is
    killed at TP_TIMEOUT_S."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(tp_rank, args=(2, free_port(), tmp), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.time() + TP_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.time() > deadline:
                raise TimeoutError(f"tp ranks: not done in {TP_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


def tp_check_attention(gen, record, heads) -> float:
    """B3 at a tp rank's heads (Hq, Hkv, D) on bf16 and int8 caches of 2048
    rows against the plain version (ATTN_TOL), two calls equal."""
    hq, hkv, d = heads
    worst = 0.0
    for kv in ("bf16", "int8"):
        q, ck, cv, kn, vn, st, ks, vs = attn_inputs(gen, 8, hq, hkv, 2048, d, kv,
                                                    mixed_starts(8, 2047))
        got = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, st, k_scale=ks, v_scale=vs)
        again = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, st, k_scale=ks, v_scale=vs)
        want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, st, k_scale=ks, v_scale=vs)
        err = (got.float() - want.float()).abs().max().item()
        record.append(dict(kv=kv, heads=heads, max_abs_err=err, ok=err <= ATTN_TOL))
        if not err <= ATTN_TOL or not torch.equal(got, again):
            raise AssertionError(f"tp decode attention {heads} {kv}: max|err|={err}")
        worst = max(worst, err)
    return worst


def tp_phase(gen, bw, card, rec) -> dict:
    """Tensor parallelism on the card (TP-a). First, in this process, B1,
    B2 and B3 at the shapes a tp = 2 rank gives them: the packed matmuls of
    Llama-2-7B's and TinyLlama's unfused slices (q, k, v, gate, up at N / 2,
    o and down at K / 2: 2048 and 5504 for the 7B, 2816 for TinyLlama's
    down) against the plain version (integer inputs exact, bf16 within
    MATMUL_TOL) at M = 8 (B2) and 512 (B1), and timed; B3 at 16 / 16 heads
    (the 7B) and 16 / 2 (TinyLlama), bf16 and int8 caches, checked and
    timed. (B8 at TinyLlama's 16 / 2 heads is `train_attention`'s
    `tinyllama_tp2` case.) Then two ranks on the one card over gloo
    (`tp_rank`): the dry run, the packed 7B decode at tp = 2 (2 layers,
    full width) and run_training at tp = 2 (TinyLlama, 2 layers, B8,
    a checkpoint in the C9 format at micro-step 4), each rank's launch
    counts predicted exactly; against them, in this process, the same
    decode at tp = 1 on the same weights fed the ranks' tokens (logits
    within LOGIT_TOL of the largest), run_training at tp = 1 (losses within
    TP_LOSS_TOL relative), and the tp = 2 checkpoint restored at tp = 1, in
    one process, equal bit for bit to the ranks' final master."""
    out: dict = {"checks": [], "matmul_times": [], "attention_times": [], "a8_times": []}
    shapes7, shapes_tl = tp_shard_shapes(LLAMA2_7B), tp_shard_shapes(TINYLLAMA_1B)
    out["matmul_rel_err"] = max(
        check_matmuls(gen, out["checks"], ms=(8, 512), bits_list=(BITS,), shapes=shapes7),
        check_matmuls(gen, out["checks"], ms=(8,), bits_list=(BITS,), shapes=shapes_tl))
    out["ring_rel_err"] = check_matmuls(gen, out["checks"], ms=(8, 512), bits_list=(BITS,),
                                        shapes=TP_RING_CHUNKS)
    out["a8_rel_err"] = check_a8(gen, out["checks"], ms=(8, 512), bits_list=(BITS,),
                                 shapes=shapes7)
    out["attention_err"] = max(tp_check_attention(gen, out["checks"], (16, 16, 128)),
                               tp_check_attention(gen, out["checks"], (16, 2, 64)))
    out["b2_7b"] = time_matmuls(gen, 8, bw, out["matmul_times"], shapes=shapes7)
    out["b1_7b"] = time_matmuls(gen, 512, bw, out["matmul_times"], shapes=shapes7)
    out["b2_tinyllama"] = time_matmuls(gen, 8, bw, out["matmul_times"], shapes=shapes_tl)
    out["b3_7b"] = time_attention(gen, bw, out["attention_times"], per_layer=False,
                                  heads=(16, 16, 128))
    out["b3_tinyllama"] = time_attention(gen, bw, out["attention_times"], per_layer=False,
                                         heads=(16, 2, 64))
    out["b2_ring"] = time_matmuls(gen, 8, bw, out["matmul_times"], shapes=TP_RING_CHUNKS)
    out["b1_ring"] = time_matmuls(gen, 512, bw, out["matmul_times"], shapes=TP_RING_CHUNKS)
    out["b4_7b_m8"] = time_a8(gen, 8, out["a8_times"], shapes=shapes7)
    out["b4_7b_m512"] = time_a8(gen, 512, out["a8_times"], shapes=shapes7)
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="bd_tp_"))
    saved_flash = os.environ.get("BITDISTILLER_TRAIN_FLASH")
    try:
        write_teacher_jsonl(tmp / "teacher.jsonl")
        t0 = time.time()
        ranks = tp_spawn(tmp)
        out["ranks_s"] = time.time() - t0
        cfg = TP_DECODE_CFG
        whole = random_packed_params(cfg, bits=BITS, group_size=GROUP, seed=0, device=DEV,
                                     fuse=False)
        forced = ranks[0]["decode"][1]
        ref_logits, _, ref_counts, ref_ms = tp_decode(whole, cfg, None, torch.device(DEV),
                                                      forced=forced)
        ref_engine = tp_engine(whole, cfg, None, torch.device(DEV))
        os.environ[qm.A8_ENV] = "1"
        try:
            whole_a8 = qm.maybe_repack_a8(whole)
            ref_a8 = tp_decode(whole_a8, cfg, None, torch.device(DEV), forced=forced)
            ref_engine_a8 = tp_engine(whole, cfg, None, torch.device(DEV))
            a8_err = max((r["decode_a8"][0] - ref_a8[0]).abs().max().item() for r in ranks)
            a8_scale = ref_a8[0].abs().max().item()
            ties_a8 = tie_rule(whole_a8, cfg, ref_engine_a8["prompts"], ref_engine_a8["outs"],
                               ranks[0]["engine_a8"]["outs"], a8_err,
                               "tp engine A8: tp = 2 vs one process")
            del whole_a8
        finally:
            os.environ.pop(qm.A8_ENV)
        a16_err = max((r["decode"][0] - ref_logits).abs().max().item() for r in ranks)
        ties = tie_rule(whole, cfg, ref_engine["prompts"], ref_engine["outs"],
                        ranks[0]["engine"]["outs"], a16_err, "tp engine A16: tp = 2 vs one process")
        routes = [r[k]["route"] for r in ranks for k in ("engine", "engine_a8")]
        say(f"tp engine routes: the ranks' {routes} (under a mesh: graphs by default), one "
            f"process {ref_engine['route']} / {ref_engine_a8['route']}")
        if (set(routes) != {"graphs, admission graphs"}
                or {ref_engine["route"], ref_engine_a8["route"]} != {"graphs, admission graphs"}):
            raise AssertionError(f"tp engine: routes {routes}, one process {ref_engine['route']}")
        probe = tp_nccl_probe(tmp)
        del whole
        os.environ["BITDISTILLER_TRAIN_FLASH"] = "1"
        params = init_params(TP_TRAIN_CFG, seed=0, dtype=torch.bfloat16, device=DEV)
        reset_counts()
        one = train_run(train_args(tmp / "teacher.jsonl", tmp / "tp1"), model=(params, TP_TRAIN_CFG))
        one_counts = read_counts()
        tp2_losses = [json.loads(x)["loss"] for x in open(tmp / "tp2" / "metrics.jsonl")]
        saved = torch.load(tmp / "tp2_master.pt", weights_only=False)
        state = tr.init_train_state(params, saved["train_config"])
        state = pipeline.restore_checkpoint(str(tmp / "tp2" / "step_4"), state)
        restored = tr.master_params(state)
        restore_equal = all(torch.equal(x.cpu(), tr._get(saved["master"], p))
                            for p, x in tr.tree_items(restored))
        with open(tmp / "tp2" / "step_4" / pipeline.MANIFEST) as f:
            manifest = json.load(f)
        del state, restored, params, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved_flash is None:
            os.environ.pop("BITDISTILLER_TRAIN_FLASH", None)
        else:
            os.environ["BITDISTILLER_TRAIN_FLASH"] = saved_flash
    want_dec = tp_predicted(cfg.num_layers)
    want_b8 = predicted_b8(TP_TRAIN_CFG.num_layers, 2, ranks[0]["train"]["steps"])
    b8 = ("train_attn_fwd", "train_attn_bwd_dkv", "train_attn_bwd_dq")
    scale = ref_logits.abs().max().item()
    logit_err = max((r["decode"][0] - ref_logits).abs().max().item() for r in ranks)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(tp2_losses, one["losses"]))
    out.update(
        route="two ranks on one card over gloo (CUDA tensors staged through the host)",
        ranks=[{k: r[k] for k in ("dryrun", "dryrun_s", "dryrun_launches", "train")}
               for r in ranks],
        decode=dict(launches=[r["decode"][2] for r in ranks], predicted=want_dec,
                    reference_launches=ref_counts, step_ms=[r["decode"][3] for r in ranks],
                    reference_step_ms=ref_ms, logit_err=logit_err, logit_scale=scale),
        train=dict(losses=tp2_losses, reference_losses=one["losses"], loss_gap=loss_gap,
                   tol=TP_LOSS_TOL, predicted_b8=want_b8, reference_launches=one_counts,
                   reference_wall_s=one["wall_s"]),
        checkpoint=dict(restored_at_tp1_equal=restore_equal, dp=manifest["dp"],
                        tp=manifest["tp"]))
    L = cfg.num_layers
    want_ring, want_a8 = tp_ring_predicted(L), tp_a8_predicted(L)
    want_eng = {False: tp_engine_predicted(L, False), True: tp_engine_predicted(L, True)}
    want_pp = dict(qmm_prefill=7 * (L // 2) * TP_PP_MICRO, qmm_decode=0, flash_decode=0)
    ring_err = max((r["ring"][0] - r["decode"][0]).abs().max().item() for r in ranks)
    engines = {}
    for a8, key, ref, tie in ((False, "engine", ref_engine, ties), (True, "engine_a8",
                                                                     ref_engine_a8, ties_a8)):
        engines[key] = dict(
            launches=[r[key]["launches"] for r in ranks], predicted=want_eng[a8],
            reference_launches=ref["launches"], decode_steps=[r[key]["decode_steps"] for r in ranks],
            predicted_steps=tp_engine_steps(TP_SERVE[2]), growths=ranks[0][key]["growths"],
            cache_shape=ranks[0][key]["cache_shape"], wall_s=[r[key]["wall_s"] for r in ranks],
            reference_wall_s=ref["wall_s"], ranks_equal=ranks[0][key]["outs"] == ranks[1][key]["outs"],
            equal_to_one_process=ranks[0][key]["outs"] == ref["outs"], ties=tie)
    out.update(
        transport=ranks[0]["transport"],
        ring=dict(launches=[r["ring"][2] for r in ranks], predicted=want_ring,
                  logit_err=ring_err, logit_scale=scale, leaves=[r["ring_leaves"] for r in ranks],
                  step_ms=[r["ring"][3] for r in ranks]),
        decode_a8=dict(launches=[r["decode_a8"][2] for r in ranks], predicted=want_a8,
                       reference_launches=ref_a8[2], logit_err=a8_err, logit_scale=a8_scale,
                       step_ms=[r["decode_a8"][3] for r in ranks], reference_step_ms=ref_a8[3]),
        pipeline=dict(ranks=[r["pipeline"] for r in ranks], predicted=want_pp, tol=LOGIT_TOL),
        nccl_probe=probe, **engines)
    out["graph_route"] = tp_graph_route(ranks, L, card)
    rec.update(out)
    for r in ranks:
        got = {k: r["decode"][2][k] for k in want_dec}
        if got != want_dec:
            raise AssertionError(f"tp decode launches {r['decode'][2]}, predicted {want_dec}")
        if {k: r["train"]["launches"][k] for k in b8} != want_b8:
            raise AssertionError(f"tp train B8 launches {r['train']['launches']}, "
                                 f"predicted {want_b8}")
        if not (r["dryrun_launches"]["qmm_decode"] and r["dryrun_launches"]["flash_decode"]):
            raise AssertionError(f"tp dry run: no B2 / B3 launch {r['dryrun_launches']}")
    if {k: ref_counts[k] for k in want_dec} != want_dec:
        raise AssertionError(f"tp = 1 decode launches {ref_counts}, predicted {want_dec}")
    if not logit_err <= LOGIT_TOL * scale:
        raise AssertionError(f"tp = 2 decode logits {logit_err} from tp = 1's (max {scale})")
    if len(tp2_losses) != len(one["losses"]) or not loss_gap <= TP_LOSS_TOL:
        raise AssertionError(f"tp = 2 losses {tp2_losses} vs tp = 1 {one['losses']}")
    if not restore_equal or (manifest["dp"], manifest["tp"]) != (1, 2):
        raise AssertionError("the tp = 2 checkpoint did not restore at tp = 1 to its master")
    pick = lambda counts, want: {k: counts[k] for k in want}
    for r in ranks:
        if pick(r["ring"][2], want_ring) != want_ring or r["ring_leaves"] != 2:
            raise AssertionError(f"ring launches {r['ring'][2]}, predicted {want_ring}; "
                                 f"{r['ring_leaves']} leaves cut into chunks (o and down: 2)")
        if pick(r["decode_a8"][2], want_a8) != want_a8:
            raise AssertionError(f"tp A8 decode launches {r['decode_a8'][2]}, predicted {want_a8}")
        for a8, key in ((False, "engine"), (True, "engine_a8")):
            e = r[key]
            if pick(e["launches"], want_eng[a8]) != want_eng[a8] or (
                    e["decode_steps"], e["prefills"]) != (tp_engine_steps(TP_SERVE[2]), 1):
                raise AssertionError(f"tp {key} launches {e['launches']} ({e['decode_steps']} "
                                     f"steps), predicted {want_eng[a8]}")
        pl = r["pipeline"]
        if pick(pl["launches"], want_pp) != want_pp:
            raise AssertionError(f"GPipe launches {pl['launches']}, predicted {want_pp}")
        if not pl["err"] <= LOGIT_TOL * pl["scale"]:
            raise AssertionError(f"GPipe logits {pl['err']} from one process's (max {pl['scale']})")
    for a8, key, ref in ((False, "engine", ref_engine), (True, "engine_a8", ref_engine_a8)):
        if pick(ref["launches"], want_eng[a8]) != want_eng[a8]:
            raise AssertionError(f"one-process {key} launches {ref['launches']}, predicted "
                                 f"{want_eng[a8]}")
        if not engines[key]["ranks_equal"]:
            raise AssertionError(f"tp {key}: the two ranks' streams differ")
    if pick(ref_a8[2], want_a8) != want_a8:
        raise AssertionError(f"tp = 1 A8 decode launches {ref_a8[2]}, predicted {want_a8}")
    if not ring_err <= LOGIT_TOL * scale:
        raise AssertionError(f"ring logits {ring_err} from the default tp path's (max {scale})")
    if not a8_err <= LOGIT_TOL * a8_scale:
        raise AssertionError(f"tp = 2 A8 decode logits {a8_err} from tp = 1's (max {a8_scale})")
    d0 = ranks[0]["decode"]
    say(f"tp ({card}; {out['route']}, {out['ranks_s']:.1f} s for both ranks' runs): the dry "
        f"run's steps ({ranks[0]['dryrun_s']:.1f} s: ZeRO 2 / 3 steps, the fused cycle, the "
        f"packed decode over bf16 and int8 caches, run_training) with B2 / B3 launches "
        f"{ {k: v for k, v in ranks[0]['dryrun_launches'].items() if v} }")
    say(f"tp decode, Llama-2-7B 2 layers int2-g128 unfused at tp = 2: launches a rank "
        f"{ {k: d0[2][k] for k in want_dec} } (predicted {want_dec}); logits {logit_err:.4g} "
        f"from tp = 1's on the same weights and tokens (max {scale:.4g}, tol {LOGIT_TOL}); a "
        f"step {np.median(d0[3]):.2f} ms at tp = 2 over gloo, {np.median(ref_ms):.2f} ms at "
        f"tp = 1 (host clock, median of {TP_STEPS})")
    say(f"tp train, TinyLlama 2 layers at tp = 2 (B8 at 16 / 2 heads a rank): losses "
        f"{tp2_losses} vs tp = 1 {one['losses']} (worst relative gap {loss_gap:.3g}, tol "
        f"{TP_LOSS_TOL}); B8 launches a rank "
        f"{ {k: ranks[0]['train']['launches'][k] for k in b8} } (predicted {want_b8}); "
        f"{ranks[0]['train']['wall_s']:.1f} s at tp = 2, {one['wall_s']:.1f} s at tp = 1; "
        f"its step-4 checkpoint (dp 1, tp 2) restored in one process equals its final master")
    for name, t in (("B2 7B", out["b2_7b"]), ("B1 7B M=512", out["b1_7b"]),
                    ("B2 TinyLlama", out["b2_tinyllama"])):
        tt = totals_entry(t, bw)
        say(f"tp shard shapes {name}: the 7 linears {tt['ms']:.4f} ms (bound {tt['bound_ms']:.4f} "
            f"{tt['bound_by']}, plain {tt['plain_ms']:.3f}, torch.matmul {tt['library_ms']:.4f})")
    for name, t in (("7B 16/16 heads", out["b3_7b"]), ("TinyLlama 16/2 heads",
                                                        out["b3_tinyllama"])):
        say(f"tp shard shapes B3 {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
            f"{t['plain_ms']:.3f}, SDPA {t['library_ms']:.4f})")
    for name, t, peak in (("B2 ring chunks (o, down) M=8", out["b2_ring"], PEAK_BF16_FLOPS),
                          ("B1 ring chunks (o, down) M=512", out["b1_ring"], PEAK_BF16_FLOPS),
                          ("B4 7B M=8", out["b4_7b_m8"], PEAK_INT8_OPS),
                          ("B4 7B M=512", out["b4_7b_m512"], PEAK_INT8_OPS)):
        tt = totals_entry(t, bw, peak)
        say(f"tp shard shapes {name}: {tt['ms']:.4f} ms (bound {tt['bound_ms']:.4f} "
            f"{tt['bound_by']}, plain {tt['plain_ms']:.3f}, torch.matmul {tt['library_ms']:.4f})")
    say(f"tp checks ({card}): B4 at a 7B tp rank's 7 linears, M = 8 and 512, pair-layout and "
        f"repacked words (integer inputs exact, bf16 worst relative {out['a8_rel_err']:.3g}); "
        f"B1 / B2 at the ring's chunks {TP_RING_CHUNKS} (worst relative "
        f"{out['ring_rel_err']:.3g})")
    rg = out["ring"]
    say(f"tp ring (BITDISTILLER_RING_TP=1; point-to-point transport: {out['transport']}): logits "
        f"{ring_err:.4g} from the default tp path's (max {scale:.4g}, tol {LOGIT_TOL}); launches "
        f"a rank { {k: rg['launches'][0][k] for k in want_ring} } (predicted {want_ring}); a step "
        f"{np.median(rg['step_ms'][0]):.2f} ms (host clock, median of {TP_STEPS})")
    say(f"tp decode A8 at tp = 2: logits {a8_err:.4g} from tp = 1's (max {a8_scale:.4g}); "
        f"launches a rank { {k: out['decode_a8']['launches'][0][k] for k in want_a8} } "
        f"(predicted {want_a8})")
    for key in ("engine", "engine_a8"):
        e = out[key]
        say(f"tp {key} (Llama-2-7B 2 layers at tp = 2, {TP_SERVE[0]} x {TP_SERVE[1]}-token "
            f"prompts, {TP_SERVE[2]} new, greedy; {card}): ranks' streams equal "
            f"{e['ranks_equal']}, equal to one process {e['equal_to_one_process']} (tie rule: "
            f"{e['ties']['equal']}/{e['ties']['streams']} equal, delta {e['ties']['delta']:.4g}); "
            f"launches a rank { {k: e['launches'][0][k] for k in e['predicted']} } (predicted "
            f"{e['predicted']}, {e['decode_steps'][0]} decode steps); growths {e['growths']}, "
            f"cache {e['cache_shape']}; {e['wall_s'][0]:.2f} s at tp = 2, "
            f"{e['reference_wall_s']:.2f} s in one process (host clock)")
    if probe.get("error"):
        finding = f"failed: {probe['error']}"
    else:
        finding = (f"replays equal to the eager values {probe['replay_equal']}, a replay "
                   f"follows new inputs {probe['replay_follows_inputs']}")
    say(f"tp NCCL capture probe (A3j's question, no route depends on it; {card}): all_reduce, "
        f"all_gather and broadcast on an NCCL group of one rank (NCCL "
        f"{probe.get('nccl', '?')}) captured in one CUDA graph: captured {probe['captured']}, "
        f"{finding}")
    p0 = out["pipeline"]["ranks"][0]
    say(f"tp GPipe at pp = 2 ({TP_PP_TOKENS[0]} x {TP_PP_TOKENS[1]} tokens, n_micro "
        f"{TP_PP_MICRO}, transport {p0['transport']}): logits {p0['err']:.4g} from one process's "
        f"(max {p0['scale']:.4g}, tol {LOGIT_TOL}); launches a rank "
        f"{ {k: p0['launches'][k] for k in want_pp} } (predicted {want_pp}); {p0['wall_s']:.3f} s")
    return out


def tp_graph_route(ranks, layers: int, card: str) -> dict:
    """The engine's graph route over the mesh (A3i) on both ranks: each run
    (A16, speculative, the ring, A8, dp = 2 x tp = 1) on the route
    "graphs, admission graphs" beside its eager twin on the same ranks:
    the same tokens bit for bit, launch counts equal and equal to the ones
    predicted from what the engine ran, every key's segments as
    `tp_segments` predicts, the ranks' streams equal; and the warmed
    engine's live requests capturing nothing. Prints each run's host
    seconds split into segment replays, boundary operations and the rest,
    on both routes."""
    steps = tp_engine_steps(TP_SERVE[2])
    L = layers
    predicted = {"engine": tp_engine_predicted(L, False), "engine_a8": tp_engine_predicted(L, True),
                 "engine_dp": tp_engine_predicted(L, False),
                 "engine_ring": dict(qmm_prefill=9 * L, qmm_decode=9 * L * steps, qmm_a8=0,
                                     flash_decode=L * steps)}
    meshes = {"engine": 2, "engine_spec": 2, "engine_ring": 2, "engine_a8": 2, "engine_dp": 1}
    runs = {}
    for key, tp in meshes.items():
        graph, eager = [r[key] for r in ranks], [r[key + "_eager"] for r in ranks]
        g0 = graph[0]
        if key == "engine_spec":
            verify = sum(g0["verify_forwards"].values())
            want = dict(qmm_prefill=7 * L * (g0["prefills"] + verify),
                        qmm_decode=7 * L * g0["decode_steps"], qmm_a8=0,
                        flash_decode=L * g0["decode_steps"])
        else:
            want = predicted[key]
        for r, (g, e) in enumerate(zip(graph, eager)):
            what = f"tp graph route {key}, rank {r}"
            if (g["route"], e["route"]) != ("graphs, admission graphs", "eager, admission eager"):
                raise AssertionError(f"{what}: routes {g['route']} / {e['route']}")
            if g["outs"] != e["outs"] or g["outs"] != graph[0]["outs"]:
                raise AssertionError(f"{what}: tokens differ from the eager twin's or rank 0's")
            if g["launches"] != e["launches"] or {k: g["launches"][k] for k in want} != want:
                raise AssertionError(f"{what}: launches {g['launches']}, eager {e['launches']}, "
                                     f"predicted {want}")
            if (g["decode_steps"], g["verify_forwards"]) != (e["decode_steps"],
                                                              e["verify_forwards"]):
                raise AssertionError(f"{what}: ran other steps than its eager twin")
            bad = {k: n for k, n in g["segments"].items()
                   if n != tp_segments(g["pieces"][k], L, tp, key == "engine_ring")}
            if bad or (key == "engine_spec" and "verify" not in g["pieces"].values()):
                raise AssertionError(f"{what}: segments {bad} not as predicted ({g['segments']})")
            if g["empty_graphs"]:
                raise AssertionError(f"{what}: {g['empty_graphs']} segments captured no work")
        runs[key] = dict(launches=[g["launches"] for g in graph],
                         eager_launches=[e["launches"] for e in eager], predicted=want,
                         segments=g0["segments"], graphs=[g["graphs"] for g in graph],
                         capture_s=[g["capture_s"] for g in graph],
                         host_split=[g["host_split"] for g in graph],
                         eager_host_split=[e["host_split"] for e in eager],
                         wall_s=[g["wall_s"] for g in graph],
                         eager_wall_s=[e["wall_s"] for e in eager],
                         decode_steps=g0["decode_steps"], verify_forwards=g0["verify_forwards"])
        by_kind = collections.defaultdict(set)
        for k, n in g0["segments"].items():
            by_kind[g0["pieces"][k]].add(n)
        hs, he = g0["host_split"], eager[0]["host_split"]
        where = "dp = 2, tp = 1" if tp == 1 else "tp = 2"
        say(f"tp graph route {key} (Llama-2-7B 2 layers, {where}, two ranks over gloo; {card}): "
            f"tokens equal to the eager twin's on both ranks, "
            f"launches equal and as predicted {want}; segments by kind "
            f"{ {k: sorted(v) for k, v in sorted(by_kind.items())} }, {g0['graphs']} graphs, none "
            f"empty, "
            f"capture {g0['capture_s']:.2f} s; rank 0 host s: graphs {hs['total_s']:.3f} = "
            f"segment replays {hs['segments_s']:.3f} + boundary ops {hs['boundary_s']:.3f} "
            f"({hs['boundary_calls']} calls) + rest {hs['rest_s']:.3f}; eager {he['total_s']:.3f} "
            f"= boundary ops {he['boundary_s']:.3f} ({he['boundary_calls']} calls) + rest "
            f"{he['rest_s']:.3f}")
    warm = [r["engine_warm"] for r in ranks]
    for r, w in enumerate(warm):
        if w["after"] != w["captured"] or w["route"] != "graphs, admission graphs":
            raise AssertionError(f"tp warmup, rank {r}: {w['after'] - w['captured']} keys "
                                 f"captured by live requests after warmup ({w['route']})")
        if w["outs"] != warm[0]["outs"]:
            raise AssertionError("tp warmup: the ranks' live streams differ")
    w0 = warm[0]
    say(f"tp warmup over the mesh (tp = 2, max_len {TP_WARM_LEN}, prompts of {TP_SERVE[1]}; "
        f"{card}): {w0['warm_s']:.1f} s, {w0['captured']} keys captured ({w0['kinds']}), "
        f"{w0['graphs']} graphs, capture {w0['capture_s']:.2f} s, reserved "
        f"{w0['pool_bytes'] / 2**20:.0f} MiB; {TP_SERVE[0]} live requests after it (one with a "
        f"per-request override) captured {w0['after'] - w0['captured']} keys in "
        f"{w0['live_s']:.2f} s")
    pools = [r["engine_pool"] for r in ranks]
    for r, p in enumerate(pools):
        what = f"tp admission pool, rank {r}"
        if not p["replays_equal"] or p["after"] != p["captured"] or p["firsts"] != pools[0][
                "firsts"]:
            raise AssertionError(f"{what}: replays equal {p['replays_equal']}, "
                                 f"{p['after'] - p['captured']} keys captured by the replays, "
                                 f"or the ranks' first tokens differ")
        if (p["prefill_keys"] != len(p["groups"]) or p["pool_bytes"] > ADMIT_POOL_LIMIT
                or p["pool_bytes"] * 2 > p["pinned_sums_bytes"]
                or p["rows_bytes"] != p["graph_rows_bytes"]):
            raise AssertionError(f"{what}: {p['prefill_keys']} prefill keys of "
                                 f"{len(p['groups'])}, pool {p['pool_bytes']} bytes (limit "
                                 f"{ADMIT_POOL_LIMIT}, half the pinned sums "
                                 f"{p['pinned_sums_bytes'] // 2}), rows {p['rows_bytes']} "
                                 f"(capacity counts {p['graph_rows_bytes']})")
    p0 = pools[0]
    say(f"tp admission pool over the mesh (Llama-2-7B widths, {TP_POOL_CFG.num_layers} layers, "
        f"tp = 2, 8 slots, a static 2048-row cache; {card}): {len(p0['groups'])} admissions "
        f"{[f'{nb}x{b}' for b, nb in p0['groups']]}, each key's first use eager and captured "
        f"({p0['captured']} keys, capture {p0['capture_s']:.2f} s, {p0['first_s']:.1f} s), "
        f"then replayed ({p0['replay_s']:.1f} s): first tokens equal to the first uses' on "
        f"both ranks, nothing captured; the graphs' pool after each bucket "
        + ", ".join(f"{b}: {v / 2**20:.1f}" for b, v in p0["pool_bytes_by_bucket"].items())
        + f" MiB, after the replays {p0['pool_bytes'] / 2**20:.1f} MiB (rank 1 "
        f"{pools[1]['pool_bytes'] / 2**20:.1f}); holding the operations' buffers would pin "
        f"the f32 sums alone, {p0['pinned_sums_bytes'] / 2**20:.1f} MiB; engine-owned rows "
        f"{p0['rows_bytes'] / 2**20:.1f} MiB (capacity counts "
        f"{p0['graph_rows_bytes'] / 2**20:.1f})")
    return dict(runs=runs, warm=warm, pool=pools)


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
    try:
        return run()
    finally:
        if _log_lines:
            OUT_DIR.mkdir(exist_ok=True)
            LOG.write_text("\n".join(_log_lines) + "\n")


def run() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    record_routes()
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
        CARD = card
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
        master, tcfg, saved_dir = train_phase(card, summary["train"])

    with Phase("serve_trained"):
        summary["serve_trained"] = {}
        loaded, packed = serve_trained_phase(master, tcfg, saved_dir, summary["serve_trained"])
        del master
        io = dict(summary["train"]["checkpoint_io"], reload_f32_s=summary["serve_trained"][
            "reload_f32_s"], gptq_export_s=summary["serve_trained"]["gptq_export_s"])
        say(f"checkpoint I/O, TinyLlama-1.1B (host seconds on the card's machine; {card}): bf16 "
            f"save {io['save_bf16_s']:.3f} s ({io['save_bf16_bytes'] / 1e9:.3f} GB), f32 load "
            f"{io['load_f32_s']:.3f} s, final f32 save {io['final_save_f32_s']:.3f} s "
            f"({io['final_save_bytes'] / 1e9:.3f} GB), reload {io['reload_f32_s']:.3f} s, GPTQ "
            f"export {io['gptq_export_s']:.3f} s")

    with Phase("eval"):
        summary["eval"] = {}
        eval_runs = eval_phase(loaded, packed, tcfg, saved_dir, card, summary["eval"])
        del loaded, packed
        torch.cuda.empty_cache()

    with Phase("method"):
        summary["method"] = {}
        method_counts = method_phase(card, summary["method"])
        torch.cuda.empty_cache()

    with Phase("serve"):
        summary["serve"] = {}
        verify_t = serve_phase(gen, bw, card, summary["serve"])

    with Phase("tp"):
        summary["tp"] = {}
        tp_out = tp_phase(gen, bw, card, summary["tp"])
        torch.cuda.empty_cache()

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

    def eval_block(*kinds):  # the eval phase's launches of one kernel (and its prefill count), each run
        return {name: {k: run["launches"].get(k, 0) for k in kinds} if len(kinds) > 1
                else run["launches"].get(kinds[0], 0) for name, run in eval_runs.items()}

    def method_block(*kinds):  # A13's launches (the method phase's whole run)
        return {k: method_counts.get(k, 0) for k in kinds}

    sv = summary["serve"]
    tp_runs = tp_out["ranks"]

    def tp_block(*kinds):  # the tp phase's launches of kernels, each rank and run
        runs = {"decode": tp_out["decode"], "ring": tp_out["ring"],
                "decode_a8": tp_out["decode_a8"], "engine": tp_out["engine"],
                "engine_a8": tp_out["engine_a8"],
                "pipeline": {"launches": [p["launches"] for p in tp_out["pipeline"]["ranks"]]}}
        for key, run in tp_out["graph_route"]["runs"].items():  # A3i's runs, by route
            runs.setdefault(key, {"launches": run["launches"]})
            runs[key + "_eager"] = {"launches": run["eager_launches"]}
        return {f"rank{r}": {k: dict({name: run["launches"][r].get(k, 0)
                                      for name, run in runs.items()},
                                     dryrun=dry["dryrun_launches"].get(k, 0)) for k in kinds}
                for r, dry in enumerate(tp_runs)}

    def tp_rows(kernel):  # one rank's shard shapes (and the ring's chunks), one row a linear
        return [{k: row[k] for k in ("shape", "m", "k", "n", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
                for row in tp_out["matmul_times"] + tp_out["a8_times"] if row["kernel"] == kernel]

    def serve_block(kind):  # the serve phase's launches of one kernel, each run
        runs = {"grown": sv["growth"]["grown"], "static": sv["growth"]["static"],
                **{f"spec {n}": sv["spec"][n]["spec"] for n in ("random", "periodic")},
                "plain periodic": sv["spec"]["periodic"]["plain"],
                "prefix hits": sv["prefix"],
                "http": sv["http"], "first after warmup": sv["warmup"]["first"]}
        return {name: run["launches"].get(kind, 0) for name, run in runs.items()}

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
                     c6=c6_mm("qmm_decode"), families=family_block("qmm_decode"),
                     eval=eval_block("qmm_decode"), method=method_block("qmm_decode"),
                     serve=serve_block("qmm_decode"),
                     tp=dict(llama2_7b_m8=times(totals_entry(tp_out["b2_7b"], bw)),
                             tinyllama_m8=times(totals_entry(tp_out["b2_tinyllama"], bw)),
                             ring_chunks_m8=times(totals_entry(tp_out["b2_ring"], bw)),
                             shapes=tp_rows("qmm_decode"), launches=tp_block("qmm_decode"),
                             predicted=dict(decode=tp_out["decode"]["predicted"]["qmm_decode"],
                                            ring=tp_out["ring"]["predicted"]["qmm_decode"],
                                            engine=tp_out["engine"]["predicted"]["qmm_decode"]),
                             max_abs_err=max(tp_out["matmul_rel_err"],
                                             tp_out["ring_rel_err"]))),
        kernel_entry("qmm_prefill", "quant_matmul.cu", "bitdistiller_tpu/ops/quant_matmul.py:107",
                     counts["qmm_prefill"], mm_rel, pre,
                     "the same four, M=256 (x group sums + wgmma kernel; m4096: the engine's "
                     "first prefill shape; m40, m64, m96: the speculative verify's 8(k+1) rows "
                     "at k = 4, 7, 11); launches from the A16 engine run; serve: the serve "
                     "phase's runs",
                     bound_measured_bw_ms=pre["bound_measured_bw_ms"], m4096=times(pre4k),
                     g64=times(pre64), c6=c6_mm("qmm_prefill"),
                     families=family_block("qmm_prefill"), eval=eval_block("qmm_prefill"),
                     method=method_block("qmm_prefill"),
                     **{f"m{m}": times(t) for m, t in verify_t.items()},
                     serve=serve_block("qmm_prefill"),
                     tp=dict(llama2_7b_m512=times(totals_entry(tp_out["b1_7b"], bw)),
                             ring_chunks_m512=times(totals_entry(tp_out["b1_ring"], bw)),
                             shapes=tp_rows("qmm_prefill"), launches=tp_block("qmm_prefill"),
                             predicted=dict(
                                 decode=tp_out["decode"]["predicted"]["qmm_prefill"],
                                 ring=tp_out["ring"]["predicted"]["qmm_prefill"],
                                 engine=tp_out["engine"]["predicted"]["qmm_prefill"],
                                 pipeline=tp_out["pipeline"]["predicted"]["qmm_prefill"]))),
        kernel_entry("flash_decode", "decode_attention.cu",
                     "bitdistiller_tpu/ops/decode_attention.py:106", counts["flash_decode"],
                     at_err["stacked"], att,
                     "B=8, Hq=Hkv=32, T=2048, D=128, bf16 cache, rows split over clusters; the "
                     "table's long skewed starts (8083 rows; path: the steady decode step's "
                     "2130 rows); launches from the A16 engine run; teacher_generation_launches "
                     "from stage 2 of the train phase (dense bf16 TinyLlama-1.1B)",
                     bound_measured_bw_ms=att["bound_measured_bw_ms"], path=times(att_path),
                     teacher_generation_launches=summary["train"]["generation"]["launches"][
                         "flash_decode"],
                     c6=dict({name: times(r) for name, r in c6["attention"].items()},
                             path_launches=c6_model["flash_decode"]),
                     families=family_block("flash_decode"), eval=eval_block("flash_decode"),
                     method=method_block("flash_decode"),
                     serve=dict(serve_block("flash_decode"),
                                grown_by_cache_len=sv["growth"]["b3_by_cache_len"]),
                     tp=dict(llama2_7b_16_16=times(tp_out["b3_7b"]),
                             tinyllama_16_2=times(tp_out["b3_tinyllama"]),
                             launches=tp_block("flash_decode"),
                             predicted=dict(
                                 decode=tp_out["decode"]["predicted"]["flash_decode"],
                                 engine=tp_out["engine"]["predicted"]["flash_decode"]),
                             max_abs_err=tp_out["attention_err"])),
        kernel_entry("qmm_a8", "quant_matmul_a8.cu", "bitdistiller_tpu/ops/quant_matmul.py:721",
                     counts_a8["qmm_a8"], a8_rel, a8_dec,
                     "one layer's four A8 matmuls (quantization included), M=8, int2-g128 "
                     "repacked, 7B widths, quantize + streaming decode kernel (PDL); "
                     "max_abs_err relative to max|plain|; "
                     "launches from the A8 engine run (every packed matmul, prefill and decode)",
                     bound_measured_bw_ms=a8_dec["bound_measured_bw_ms"],
                     m256=times(a8_pre), m4096=times(a8_pre4k),
                     prefill_launches=counts_a8["qmm_a8_prefill"], g64=times(a8_64),
                     c6=c6_mm("qmm_a8"), families=family_block("qmm_a8"),
                     eval=eval_block("qmm_a8", "qmm_a8_prefill"),
                     method=method_block("qmm_a8", "qmm_a8_prefill"),
                     tp=dict(llama2_7b_m8=times(totals_entry(tp_out["b4_7b_m8"], bw,
                                                             PEAK_INT8_OPS)),
                             llama2_7b_m512=times(totals_entry(tp_out["b4_7b_m512"], bw,
                                                               PEAK_INT8_OPS)),
                             shapes=tp_rows("qmm_a8"),
                             launches=tp_block("qmm_a8", "qmm_a8_prefill"),
                             predicted=dict(decode=tp_out["decode_a8"]["predicted"],
                                            engine=tp_out["engine_a8"]["predicted"]),
                             max_abs_err=tp_out["a8_rel_err"])),
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
            eval=eval_block(name),
            llama2_7b=b8(kind, t7, plain, lib), d256=b8(kind, ta_times["d256"], plain, lib),
            tinyllama_tp2=dict(b8(kind, ta_times["tinyllama_tp2"], plain, lib),
                               launches=[run["train"]["launches"][name] for run in tp_runs],
                               predicted=tp_out["train"]["predicted_b8"][name]),
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
