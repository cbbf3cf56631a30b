"""Where the streaming decode kernels' time goes: each kernel against copies
of itself with one part taken out or one constant changed, on the card.

    python -m bitdistiller_tpu_torch.scripts.decode_ablation [a16 a8 attention]

(no argument: all three). Each variant is a text patch of the kernel's
source, written and built by nvcc into _build/ablation/ (git-ignored), as
prefill_ablation does; a patch that no longer applies raises. Variants that
take work out compute wrong results and are timed only.

A16 decode matmul (csrc/quant_matmul.cu, `a16_variants`):
  * no_mma: the tensor-core products removed (the staged words are still
    read from shared memory);
  * no_loads: no word or combo copies (the K loop runs on whatever the
    rings hold): the loop's compute, the prologue and the epilogue;
  * no_loop: the K loop removed: launch, prologue (its first copies in
    flight), the x copy, the cluster's reduction and the output;
  * no_x_copy: no copy of the x slice to shared memory (nor its group sums);
  * no_reduce: each CTA outputs its own partial tile, no reads of its
    peers' shared memory (the cluster barriers stay);
  * stages3 / stages6: rings of 3 or 6 groups a warp (exact);
  * no_pdl: not launched as a programmatic dependent of the kernel before it.
A8 decode matmul (csrc/quant_matmul_a8.cu, `variants`): no_mma, no_loads,
no_loop, no_wait (no wait for the quantize kernel), no_xi_copy, no_reduce,
stages3, stages6, blocks3 (3 CTAs an SM).
Decode attention (csrc/decode_attention.cu, `attention_variants`):
  * stages2 / stages3 / stages6: rings of 2, 3 or 6 runs a warp (exact;
    6: 96 KB a CTA at D = 128, still two an SM);
  * lanes16 / lanes32: a row on 16 or 32 lanes at rep 1 (8 or 4 elements a
    lane), not 8 (exact);
  * no_loads: no K/V copies (the loop computes on whatever the rings hold);
  * no_loop: the row loop removed: launch, q, the first copies, the merges
    and the output;
  * blocks3: __launch_bounds__ for 3 CTAs an SM, not 2 (exact).
Times: the matmuls are one call of each 7B shape (qkv, o, gate_up, down)
and their sum, int2-g128, M=8, on the wrapper's plan, over layers that
cycle through more than 100 MB of weights; the attention is one call at 7B
heads, batch 8, T = 2048, on the long skewed work of PERF.md's table and at
the steady decode step's lengths, over two cache layers (268 MB). In ms by
CUDA events around a launch loop (as chip_smoke.py times kernels), and in
brackets the device time a call in us from a profiler trace (`device_us`).
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import decode_attention as da
from ..ops import quant_matmul as qm
from ..quant.packing import make_scale_combo
from .decode_sweep import PATH_STARTS, TABLE_STARTS
from .prefill_ablation import _patch, build, cuda_ms


def device_us(fn, calls: int = 40) -> float:
    """Device time a call, in us: the kernels' time in a torch.profiler trace
    of `calls` calls (for A8 the quantize kernel and the matmul, which with
    PDL starts while the quantize kernel runs), so the host's launch cost,
    which the CUDA-event time of a launch loop can include, is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / calls

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096)}
MMA = "        for (int mt = 0; mt < MT; ++mt) mma_s8(part[t][mt], a[mt], b0, b1);\n"
NO_MMA = "        for (int mt = 0; mt < MT; ++mt) part[t][mt][0] += a[mt][0] ^ a[mt][3] ^ b0 ^ b1;\n"
LOADS = "    if (j < ngs) {\n      uint32_t* st = ring + (j % DEC_STAGES) * D::WSTAGE;\n"
LOOP = "  for (int j = 0; j < ngs; ++j) {\n    cp_wait<DEC_STAGES - 2>();"
STAGES = "constexpr int DEC_STAGES = 4;"
WAIT = "  grid_dep_wait();  // xi and sx are quantize_rows_kernel's; read past L1\n"
XI_COPY = "  pipelined<4>(\n      tid, MROWS * per, kThreads,"
REDUCE = "      for (int q = 0; q < kMaxCluster; ++q)  // all loads in flight, then the sum in rank order\n        if (q < C) part[q] = cluster.map_shared_rank(red, q)[idx];\n"
BOUNDS = "__global__ void __launch_bounds__(kThreads, 2)\n    qmm_a8_decode_kernel"
A16_MMA = "        for (int mt = 0; mt < MT; ++mt) mma_bf16(part[t][mt], a[mt], b0, b1);\n"
A16_NO_MMA = ("        for (int mt = 0; mt < MT; ++mt)\n"
              "          part[t][mt][0] += __uint_as_float(a[mt][0] ^ a[mt][3] ^ b0 ^ b1);\n")
A16_PDL = "constexpr bool DEC_PDL = true;"
A16_X_COPY = "  for (int base = 0; base < total; base += 4 * kThreads) {"
FD_STAGES = "constexpr int FD_STAGES = 4;"
FD_EPL = "static constexpr int EPL_REP = REP == 1 ? 16 :"
FD_LOADS = "    if (jr < runs) {\n      uint8_t* sl = ring + (jr % FD_STAGES) * P::SLOT;\n"
FD_LOOP = "  for (int jr = 0; jr < runs; ++jr) {\n"
FD_BOUNDS = "__launch_bounds__(kThreads, REP == 8 || D > 256 ? 1 : 2)"


def variants(src: str) -> dict[str, str]:
    """The A8 decode kernel's variants (csrc/quant_matmul_a8.cu)."""
    patch = lambda old, new: _patch(src, old, new)
    return {"kernel": src,
            "no_mma": patch(MMA, NO_MMA),
            "no_loads": patch(LOADS, LOADS.replace("j < ngs", "false")),
            "no_loop": patch(LOOP, LOOP.replace("j < ngs", "j < 0")),
            "no_wait": patch(WAIT, ""),
            "no_xi_copy": patch(XI_COPY, XI_COPY.replace("MROWS * per", "0")),
            "no_reduce": patch(REDUCE, "      part[0] = red[idx];\n"),
            "stages3": patch(STAGES, STAGES.replace("4", "3")),
            "stages6": patch(STAGES, STAGES.replace("4", "6")),
            "blocks3": patch(BOUNDS, BOUNDS.replace("kThreads, 2", "kThreads, 3"))}


def a16_variants(src: str) -> dict[str, str]:
    """The A16 decode kernel's variants (csrc/quant_matmul.cu)."""
    patch = lambda old, new: _patch(src, old, new)
    return {"kernel": src,
            "no_mma": patch(A16_MMA, A16_NO_MMA),
            "no_loads": patch(LOADS, LOADS.replace("j < ngs", "false")),
            "no_loop": patch(LOOP, LOOP.replace("j < ngs", "j < 0")),
            "no_x_copy": patch(A16_X_COPY, A16_X_COPY.replace("base < total", "base < 0")),
            "no_reduce": patch(REDUCE, "      part[0] = red[idx];\n"),
            "stages3": patch(STAGES, STAGES.replace("4", "3")),
            "stages6": patch(STAGES, STAGES.replace("4", "6")),
            "no_pdl": patch(A16_PDL, A16_PDL.replace("true", "false"))}


def attention_variants(src: str) -> dict[str, str]:
    """The decode attention kernel's variants (csrc/decode_attention.cu)."""
    patch = lambda old, new: _patch(src, old, new)
    return {"kernel": src,
            "stages2": patch(FD_STAGES, FD_STAGES.replace("4", "2")),
            "stages3": patch(FD_STAGES, FD_STAGES.replace("4", "3")),
            "stages6": patch(FD_STAGES, FD_STAGES.replace("4", "6")),
            "lanes16": patch(FD_EPL, FD_EPL.replace("16", "8")),
            "lanes32": patch(FD_EPL, FD_EPL.replace("16", "4")),
            "no_loads": patch(FD_LOADS, FD_LOADS.replace("jr < runs", "false")),
            "no_loop": patch(FD_LOOP, FD_LOOP.replace("jr < runs", "jr < 0")),
            "blocks3": patch(FD_BOUNDS, FD_BOUNDS.replace(": 2)", ": 3)"))}


def _report(times: dict) -> None:
    for name, row in times.items():
        print(f"  {name}: " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:.1f} us)" for k, v in row.items())
              + f"; sum {sum(v[0] for v in row.values()):.4f} ms "
              f"({sum(v[1] for v in row.values()):.1f} us)", flush=True)


def _matmuls(fns, gen, stream, sms, a8: bool) -> None:
    m, bits = 8, 2
    times = {name: {} for name in fns}
    for shape, (k, n) in SHAPES.items():
        stat_bytes = k // 128 * n * (8 if a8 else 4)
        layers = max(2, math.ceil(120e6 / (k * n * bits / 8 + stat_bytes)))
        qw = torch.randint(-(2**31), 2**31 - 1, (layers, k * bits // 32, n), dtype=torch.int32,
                           device="cuda", generator=gen)
        s = torch.rand((layers, k // 128, n), device="cuda", generator=gen) * 0.02
        x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        if a8:
            xi = torch.empty((m, k), dtype=torch.int8, device="cuda")
            sx = torch.empty((m,), dtype=torch.float32, device="cuda")
            cluster = qm.decode_plan(n, k // 128, sms)
            args = [(x.data_ptr(), qw[i].data_ptr(), s[i].data_ptr(), s[i].data_ptr(), None, None,
                     xi.data_ptr(), sx.data_ptr(), None, out.data_ptr(), m, k, n, bits, 128, 0,
                     cluster, 0, stream) for i in range(layers)]
        else:
            combo = make_scale_combo(s, s)
            plan = qm.a16_decode_plan(n, k // 128, sms)
            args = [(x.data_ptr(), qw[i].data_ptr(), combo[i].data_ptr(), None, out.data_ptr(), m,
                     k, n, bits, 128, *plan, 0, stream) for i in range(layers)]
        for name, row in times.items():
            fn = fns[name]
            _build.check(fn(*args[0]), name)
            row[shape] = (cuda_ms(lambda i: fn(*args[i % layers]), iters=50, reps=5),
                          device_us(lambda i: fn(*args[i % layers])))
        del qw, s
    _report(times)


def _attention(fns, gen, stream, sms) -> None:
    b, h, t, d = 8, 32, 2048, 128
    ck = torch.randn((2, b, h, t, d), device="cuda", generator=gen).bfloat16()
    cv = torch.randn((2, b, h, t, d), device="cuda", generator=gen).bfloat16()
    q = torch.randn((b, h, d), device="cuda", generator=gen).bfloat16()
    out = torch.empty_like(q)
    cluster = da.attention_plan(b, h, sms)
    times = {name: {} for name in fns}
    for label, starts in (("table", TABLE_STARTS), ("path", PATH_STARTS)):
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        args = [(q.data_ptr(), ck[i].data_ptr(), cv[i].data_ptr(), None, None, q.data_ptr(),
                 q.data_ptr(), st.data_ptr(), out.data_ptr(), 0, b, h, 1, t, d, t, 0, d ** -0.5,
                 cluster, 0, stream) for i in range(2)]
        for name, row in times.items():
            fn = fns[name]
            _build.check(fn(*args[0]), name)
            row[label] = (cuda_ms(lambda i: fn(*args[i % 2]), iters=50, reps=5),
                          device_us(lambda i: fn(*args[i % 2])))
    _report(times)


_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {  # name: (source, its variants, C function, its argtypes)
    "a16": ("quant_matmul.cu", a16_variants, "bd_qmm_decode", [_P] * 5 + [_I] * 8 + [_P]),
    "a8": ("quant_matmul_a8.cu", variants, "bd_qmm_a8", [_P] * 10 + [_I] * 8 + [_P]),
    "attention": ("decode_attention.cu", attention_variants, "bd_flash_decode",
                  [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _I, _P]),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_ablation: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    chosen = sys.argv[1:] or list(KERNELS)
    srcs = {}
    for kernel in chosen:
        src, make, _, _ = KERNELS[kernel]
        texts = make((_build.CSRC_DIR / src).read_text())
        srcs.update({f"{kernel}_{name}": text for name, text in texts.items()})
    libs = build(srcs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel in chosen:
        _, _, fn_name, argtypes = KERNELS[kernel]
        fns = {}
        for name, lib in libs.items():
            if name.startswith(kernel + "_"):
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name[len(kernel) + 1:]] = fn
        print(f"{kernel}:", flush=True)
        if kernel == "attention":
            _attention(fns, gen, stream, sms)
        else:
            _matmuls(fns, gen, stream, sms, a8=kernel == "a8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
