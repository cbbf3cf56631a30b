"""Where the A8 decode kernel's time goes: the kernel against copies of
itself with one part taken out or one constant changed, on the card.

    python -m bitdistiller_tpu_torch.scripts.decode_ablation

Each variant is a text patch of csrc/quant_matmul_a8.cu, written and built
by nvcc into _build/ablation/ (git-ignored), as prefill_ablation does; a
patch that no longer applies raises. Variants that take work out compute
wrong results and are timed only:
  * no_mma: the tensor-core products removed (the staged words are still
    read from shared memory);
  * no_loads: no word, scale or szero copies (the K loop runs on whatever
    the rings hold): the loop's compute, the prologue and the epilogue;
  * no_loop: the K loop removed: launch, prologue (its first copies in
    flight), the cluster's reduction and the output;
  * no_wait: the matmul does not wait for the quantize kernel (it reads
    xi as it finds it);
  * no_xi_copy: no copy of the xi slice to shared memory;
  * no_reduce: each CTA outputs its own partial tile, no reads of its
    peers' shared memory (the cluster barriers stay);
  * stages3 / stages6: rings of 3 or 6 groups a warp (exact);
  * blocks3: __launch_bounds__ for 3 CTAs an SM (exact).
Times are one call of each 7B shape (qkv, o, gate_up, down) and their sum,
int2-g128 in the A8 order, M=8, on the cluster `decode_plan` picks (the
quantize kernel and the decode kernel), over layers that cycle through
more than 100 MB of weights: in ms by CUDA events around
a launch loop (as chip_smoke.py times kernels), and in brackets the device
time a call in us from a profiler trace (`device_us`).
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import quant_matmul as qm
from .prefill_ablation import _patch, build, cuda_ms


def device_us(fn, calls: int = 40) -> float:
    """Device time a call, in us: the kernels' time in a torch.profiler trace
    of `calls` calls (the quantize kernel and the matmul, which with PDL
    starts while the quantize kernel runs), so the host's launch cost, which
    the CUDA-event time of a launch loop can include, is left out."""
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


def variants(src: str) -> dict[str, str]:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_ablation: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    src = (_build.CSRC_DIR / "quant_matmul_a8.cu").read_text()
    libs = build({f"a8_{name}": text for name, text in variants(src).items()})
    fns = {}
    for name, lib in libs.items():
        fn = lib.bd_qmm_a8
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name[3:]] = fn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m, bits = 8, 2
    times = {name: {} for name in fns}
    for shape, (k, n) in SHAPES.items():
        layers = max(2, math.ceil(120e6 / (k * n * bits / 8 + k // 128 * n * 8)))
        qw = torch.randint(-(2**31), 2**31 - 1, (layers, k * bits // 32, n), dtype=torch.int32,
                           device="cuda", generator=gen)
        s = torch.rand((layers, k // 128, n), device="cuda", generator=gen) * 0.02
        x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
        xi = torch.empty((m, k), dtype=torch.int8, device="cuda")
        sx = torch.empty((m,), dtype=torch.float32, device="cuda")
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        cluster = qm.decode_plan(n, k // 128, sms)
        for name, row in times.items():
            fn = fns[name]
            args = [(x.data_ptr(), qw[i].data_ptr(), s[i].data_ptr(), s[i].data_ptr(), None, None,
                     xi.data_ptr(), sx.data_ptr(), None, out.data_ptr(), m, k, n, bits, 128, 0,
                     cluster, stream) for i in range(layers)]
            _build.check(fn(*args[0]), name)
            row[shape] = (cuda_ms(lambda i: fn(*args[i % layers]), iters=50, reps=5),
                          device_us(lambda i: fn(*args[i % layers])))
        del qw, s
    for name, row in times.items():
        print(f"{name}: " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:.1f} us)"
                                                  for k, v in row.items())
              + f"; sum {sum(v[0] for v in row.values()):.4f} ms "
              f"({sum(v[1] for v in row.values()):.1f} us)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
