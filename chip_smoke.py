#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a), holds each kernel
against its plain PyTorch version at the shapes of the packed int2-g128
Llama-2-7B serving path, times kernel / plain version / one library call,
then serves requests with the port's Engine on a random packed 7B model
(all 32 layers) and checks that the decode path went through the kernels.
Phases print one line each; any failure exits non-zero before the last
line. The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Tolerances (kernel vs plain version on the same inputs):
  * integer-valued activations and weights: exact (every product and partial
    sum is an integer below 2^24 in f32, so summation order cannot matter);
  * bf16 activations, packed matmul: max|kernel - plain| <= 1e-2 * max|plain|
    (both round an f32 sum to bf16: one bf16 ulp is 2^-8 relative, and the
    f32 sums differ in order);
  * decode attention: max abs error <= 2e-2 on O(1) outputs (the prob row is
    rounded to bf16 against per-warp running maxima in the kernel and against
    one global maximum in the plain version; one bf16 ulp of a prob);
  * one whole decode step of the 7B model, kernels vs plain versions:
    max|logit error| <= 5e-2 * max|logit| (bf16 rounding differences of every
    matmul output compound over 32 layers).
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
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
MATMUL_TOL = 1e-2
ATTN_TOL = 2e-2
LOGIT_TOL = 5e-2


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


def bound_ms(nbytes: float, flops: float, bw: float = PEAK_BYTES_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / bw * 1e3, flops / PEAK_BF16_FLOPS * 1e3
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


def plain_matmul(x, p: PackedLinear, li: int):
    lay = p.layer(li)
    return qm.quant_matmul_plain(x, lay.qweight, lay.scales, lay.szeros, lay.bits, lay.group_size)


def check_matmuls(gen, record):
    worst = 0.0
    for bits in (2, 4):
        for name, (k, n) in SHAPES.items():
            for integer in (True, False):
                p = rand_stacked(gen, 2, k, n, bits, integer)
                for m in (8, 256):
                    if integer:
                        x = torch.randint(-3, 4, (m, k), device=DEV, generator=gen).bfloat16()
                    else:
                        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
                    got = qm.quant_matmul(x, p, 1)  # layer 1 of a stack, in place
                    want = plain_matmul(x, p, 1)
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
    cases = [
        dict(b=8, hq=32, hkv=32, t=2048, d=128, window=None, attn_len=None),
        dict(b=8, hq=32, hkv=8, t=2048, d=128, window=None, attn_len=None),  # GQA
        dict(b=8, hq=32, hkv=32, t=2048, d=128, window=256, attn_len=None),
        dict(b=4, hq=8, hkv=4, t=512, d=64, window=None, attn_len=384),
    ]
    worst = 0.0
    for kv in ("bf16", "int8"):
        for c in cases:
            starts = mixed_starts(c["b"], (c["attn_len"] or c["t"]) - 1)
            q, ck, cv, kn, vn, st, ks, vs = attn_inputs(gen, c["b"], c["hq"], c["hkv"], c["t"],
                                                        c["d"], kv, starts)
            kw = dict(k_scale=ks, v_scale=vs, window=c["window"], attn_len=c["attn_len"])
            got = da.flash_decode_stacked(q, ck, cv, 1, kn, vn, st, **kw)
            want = da.decode_attention_plain(q, ck, cv, 1, kn, vn, st, **kw)
            err = (got.float() - want.float()).abs().max().item()
            record.append(dict(kv=kv, **c, max_abs_err=err, ok=err <= ATTN_TOL))
            if err > ATTN_TOL:
                raise AssertionError(f"decode attention {kv} {c}: max|err|={err}")
            if kv == "bf16" and c["hq"] == c["hkv"] and c["window"] is None:
                worst = max(worst, err)
    return worst


def time_matmuls(gen, m, bw, detail):
    """One layer's four packed matmuls at M rows, int2-g128. The kernel is
    timed through its raw ctypes launcher (a few us of host time a call, so
    the card, not Python, sets the pace); `wrapper_ms` is the same work
    through `quant_matmul`. Weights cycle through enough stacked layers
    (> 100 MB) that every call reads them from HBM, as the layer loop does;
    the plain version and the library call (torch.matmul on a dequantized
    bf16 weight) run on layer 0."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    fn = qm._launcher("bd_qmm_decode" if m <= qm.DECODE_MAX_M else "bd_qmm_prefill")
    stream = torch.cuda.current_stream().cuda_stream
    for name, (k, n) in SHAPES.items():
        layer_bytes = k * n * BITS / 8 + (k // GROUP) * n * 4
        layers = max(2, math.ceil(120e6 / layer_bytes))
        p = rand_stacked(gen, layers, k, n, BITS, integer=False)
        x = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
        out = torch.empty((m, n), dtype=torch.bfloat16, device=DEV)
        args = [(x.data_ptr(), p.qweight[i].data_ptr(), p.combo[i].data_ptr(), out.data_ptr(),
                 m, k, n, BITS, GROUP, stream) for i in range(layers)]
        _build.check(fn(*args[0]), "raw launch")
        ms = cuda_ms(lambda i: fn(*args[i % layers]), 50)
        wrapper = cuda_ms(lambda i: qm.quant_matmul(x, p, i % layers), 50)
        plain = cuda_ms(lambda i: plain_matmul(x, p, 0), 3, reps=3)
        w = dequantize_linear(p.layer(0), torch.bfloat16)
        lib = cuda_ms(lambda i: torch.matmul(x, w), 20)
        nbytes = layer_bytes + m * k * 2 + m * n * 2
        flops = 2.0 * m * k * n
        b, by = bound_ms(nbytes, flops)
        detail.append(dict(shape=name, m=m, k=k, n=n, ms=ms, wrapper_ms=wrapper, plain_ms=plain,
                           library_ms=lib, bound_ms=b, bound_by=by,
                           bound_measured_bw_ms=nbytes / bw * 1e3))
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += nbytes
        tot["flops"] += flops
        del p, w
    return tot


def time_attention(gen, bw, detail):
    b, hq, hkv, t, d = 8, 32, 32, 2048, 128
    starts = [2047, 1900, 1536, 1024, 700, 512, 300, 64]
    q, ck, cv, kn, vn, st, _, _ = attn_inputs(gen, b, hq, hkv, t, d, "bf16", starts, layers=2)
    # the kernel through its raw launcher (as for the matmuls), then the wrapper
    fn = da._launcher()
    out = torch.empty((b, hq, d), dtype=torch.bfloat16, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    args = [(q.data_ptr(), ck[li].data_ptr(), cv[li].data_ptr(), None, None, kn.data_ptr(),
             vn.data_ptr(), st.data_ptr(), out.data_ptr(), 0, b, hkv, hq // hkv, t, d, t, 0,
             1.0 / math.sqrt(d), stream) for li in range(2)]
    _build.check(fn(*args[0]), "raw launch")
    ms = cuda_ms(lambda i: fn(*args[i % 2]), 50)
    wrapper = cuda_ms(lambda i: da.flash_decode_stacked(q, ck, cv, i % 2, kn, vn, st), 50)
    plain = cuda_ms(lambda i: da.decode_attention_plain(q, ck, cv, 0, kn, vn, st), 3, reps=3)
    # library yardstick: SDPA over the same layer's cache with a row mask
    # (it reads all T rows and does not fold the fresh token)
    mask = (torch.arange(t, device=DEV)[None, :] < st[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    lib = cuda_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qs, ck[i % 2], cv[i % 2], attn_mask=mask), 20)
    rows = sum(starts)
    nbytes = 2 * rows * hkv * d * 2 + 2 * b * hq * d * 2 + 2 * b * hkv * d * 2
    flops = 4.0 * rows * hq * d
    bnd, by = bound_ms(nbytes, flops)
    rec = dict(b=b, hq=hq, hkv=hkv, t=t, d=d, starts=starts, ms=ms, wrapper_ms=wrapper,
               plain_ms=plain,
               library_ms=lib, bound_ms=bnd, bound_by=by, bound_measured_bw_ms=nbytes / bw * 1e3)
    detail.append(rec)
    return rec


def step_bytes(cfg, bits, rows_per_slot) -> float:
    """HBM bytes one decode step must read: packed weights, combo words,
    lm_head, and the valid KV rows (bench.py's model_bytes_per_step with the
    KV term counted per slot)."""
    d, dh = cfg.hidden_size, cfg.actual_head_dim
    per_layer = (d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh
                 + cfg.num_heads * dh * d + 3 * d * cfg.intermediate_size)
    n_w = per_layer * cfg.num_layers
    kv = cfg.num_layers * sum(rows_per_slot) * cfg.num_kv_heads * dh * 2 * 2
    return n_w * bits / 8 + n_w / 128 * 4 + d * cfg.vocab_size * 2 + kv


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
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return dict(busy_ms=sum(per.values()), top=top)


def reset_counts():
    qm.qmm_decode.launches = 0
    qm.qmm_prefill.launches = 0
    da.flash_decode_stacked.launches = 0


def end_to_end(bw, out):
    cfg = CFG
    params = random_packed_params(cfg, bits=BITS, group_size=GROUP, seed=0, device=DEV)
    eng = Engine(params, cfg, max_slots=8, max_len=2048, eos_token_id=None,
                 sampling=SamplingParams(temperature=0.0), device=DEV)
    rng = np.random.default_rng(0)
    lens = [64, 512, 200, 333, 128, 480, 96, 256, 400, 150, 64, 300]
    reqs = [Request(prompt_tokens=rng.integers(3, cfg.vocab_size, n).tolist(), max_new_tokens=32)
            for n in lens]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(qmm_decode=qm.qmm_decode.launches, qmm_prefill=qm.qmm_prefill.launches,
                  flash_decode=da.flash_decode_stacked.launches)
    steps = eng.decode_steps
    L = cfg.num_layers
    if len(done) != len(reqs) or not all(r.finished and len(r.output_tokens) == 32 for r in reqs):
        raise AssertionError("not every request finished with 32 tokens")
    if counts["qmm_decode"] < steps * L * 4 or counts["flash_decode"] < steps * L:
        raise AssertionError(f"decode did not run through the kernels: {counts}, steps {steps}")
    if counts["qmm_prefill"] < L * 4:
        raise AssertionError(f"prefill did not run through the kernel: {counts}")
    say(f"engine: {len(reqs)} requests, 8 slots, depth {L} of {CFG.num_layers} (no cut), "
        f"{steps} decode steps, launches {counts}, wall {wall:.2f} s, "
        f"{sum(len(r.output_tokens) for r in reqs) / wall:.1f} generated tok/s end to end")

    # steady decode: all 8 slots at their final lengths, 16 timed steps
    pos = torch.as_tensor(np.minimum(eng.lengths, 2047 - 17), dtype=torch.int32, device=DEV)
    tok = torch.randint(3, cfg.vocab_size, (8, 1), device=DEV)

    def step(i):
        forward(params, cfg, tok, cache=eng.cache, cache_pos=pos + i)

    with torch.inference_mode():
        ms_step = cuda_ms(step, 8, reps=3)
        busy = device_busy_ms(step, 4)
        rows = [int(p) + 4 for p in pos.tolist()]
        nbytes = step_bytes(cfg, BITS, rows)
        # one decode step, kernels vs plain versions, same state; the plain
        # path reads the scales the kernel decodes from the combo words.
        # Rows >= pos are not read by either call, so the second call sees
        # the cache the first one saw.
        ref_params = dict(params, layers=dict(params["layers"]))
        for name, leaf in params["layers"].items():
            if isinstance(leaf, PackedLinear):
                s, sz = scales_from_combo(leaf.combo)
                ref_params["layers"][name] = dataclasses.replace(leaf, scales=s, szeros=sz)
        lk, _ = forward(params, cfg, tok, cache=eng.cache, cache_pos=pos + 20)
        lp, _ = forward(ref_params, cfg, tok, cache=eng.cache, cache_pos=pos + 20,
                        use_kernels=False)
    if busy is None:
        say("profiler: no device time recorded; device idle share not measured")
    else:
        say(f"profiler: device busy {busy['busy_ms']:.3f} ms of a {ms_step:.3f} ms step "
            f"(idle share {1 - busy['busy_ms'] / ms_step:.3f}); top: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in busy["top"]))
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits from the kernel path")
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    say(f"decode step vs plain path: max|dlogit| {err:.4g} of max|logit| {ref:.4g} "
        f"(tol {LOGIT_TOL} relative), argmax agreement {agree:.3f}")
    if err > LOGIT_TOL * ref:
        raise AssertionError("decode step logits disagree with the plain path")
    out.update(
        requests=len(reqs), decode_steps=steps, launches=counts, wall_s=wall,
        decode_ms_per_step=ms_step, decode_tok_per_s=8 / ms_step * 1e3,
        step_bytes=nbytes, step_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
        step_bound_measured_bw_ms=nbytes / bw * 1e3,
        logit_max_abs_err=err, logit_max=ref, argmax_agreement=agree, profile=busy,
    )
    say(f"decode: {ms_step:.3f} ms/step, {8 / ms_step * 1e3:.1f} tok/s at batch 8, "
        f"{nbytes / 1e9:.3f} GB/step -> bound {nbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at "
        f"3.35 TB/s, {nbytes / bw * 1e3:.3f} ms at the measured {bw / 1e9:.0f} GB/s")
    return counts


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
        bw = 2 * n / (copy_ms / 1e3)  # read + write
        del src, dst
        summary.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       measured_bw=bw)
        say(f"device copy of 1 GiB: {copy_ms:.3f} ms -> {bw / 1e9:.1f} GB/s measured")

    with Phase("packed matmul vs plain"):
        summary["matmul_checks"] = []
        mm_rel = check_matmuls(gen, summary["matmul_checks"])
        say(f"{len(summary['matmul_checks'])} cases; integer inputs exact; "
            f"worst bf16 relative error at int2 {mm_rel:.3g}")

    with Phase("decode attention vs plain"):
        summary["attention_checks"] = []
        at_err = check_attention(gen, summary["attention_checks"])
        say(f"{len(summary['attention_checks'])} cases; worst bf16 MHA abs error {at_err:.3g}")

    with Phase("kernel times"):
        summary["matmul_times"] = []
        dec = time_matmuls(gen, 8, bw, summary["matmul_times"])
        pre = time_matmuls(gen, 256, bw, summary["matmul_times"])
        summary["attention_times"] = []
        att = time_attention(gen, bw, summary["attention_times"])
        for r in summary["matmul_times"] + summary["attention_times"]:
            say(json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in r.items()}))

    with Phase("end to end"):
        summary["e2e"] = {}
        counts = end_to_end(bw, summary["e2e"])

    kernels = []
    for name, t, rel, launches, src, replaces in (
        ("qmm_decode", dec, mm_rel, counts["qmm_decode"], "bitdistiller_tpu_torch/csrc/quant_matmul.cu",
         "bitdistiller_tpu/ops/quant_matmul.py:152"),
        ("qmm_prefill", pre, mm_rel, counts["qmm_prefill"], "bitdistiller_tpu_torch/csrc/quant_matmul.cu",
         "bitdistiller_tpu/ops/quant_matmul.py:107"),
    ):
        b, by = bound_ms(t["bytes"], t["flops"])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches,
            max_abs_err=rel, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=t["library_ms"], bound_measured_bw_ms=t["bytes"] / bw * 1e3,
            work=f"one layer's qkv+o+gate_up+down, M={8 if name == 'qmm_decode' else 256}, "
                 "int2-g128, 7B widths; max_abs_err relative to max|plain|",
        ))
    kernels.append(dict(
        name="flash_decode", route="cuda", source="bitdistiller_tpu_torch/csrc/decode_attention.cu",
        replaces="bitdistiller_tpu/ops/decode_attention.py:106", launches=counts["flash_decode"],
        max_abs_err=at_err, ms=att["ms"], plain_ms=att["plain_ms"], bound_ms=att["bound_ms"],
        bound_by=att["bound_by"], library_ms=att["library_ms"],
        bound_measured_bw_ms=att["bound_measured_bw_ms"],
        work="B=8, Hq=Hkv=32, T=2048, D=128, bf16 cache, mixed starts",
    ))
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
