"""Per-CTA timelines of the A16 decode matmul and the decode attention, on
the card: where a CTA's life goes between launch and exit.

    python -m bitdistiller_tpu_torch.scripts.decode_timeline [a16 attention]

(no argument: both). Each kernel is a text patch of its source that writes
%globaltimer stamps (and the SM id and the work count) of every CTA to a
device array at the phase boundaries, built into _build/ablation/ as
prefill_ablation builds its variants; a patch that no longer applies raises.
A stamp waits for a value of the phase it closes (the start index, the
run count, an accumulator), so it is taken when that phase's result is in.
The stamps of the last of several calls are read back, and each phase is
printed as percentiles over the CTAs (p10, p50, p90, max, in us), with the
span from the first entry to the last exit:
  * a16: entry -> prologue issued -> PDL wait -> x slice and its group sums
    staged -> K loop -> drain and first cluster barrier -> reduction and
    last barrier; qkv and down of the 7B at M=8, int2-g128, on
    `a16_decode_plan`'s plan and two others;
  * attention: entry -> start read -> first copies issued -> row loop ->
    merges -> first cluster barrier -> rank 0's merge and the last barrier
    (a cluster of one finishes after the merges); 7B heads, batch 8,
    T = 2048, bf16, on PERF.md's long skewed work and at the steady decode
    step's lengths, clusters of 1, 2 and 3.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import quant_matmul as qm
from ..quant.packing import make_scale_combo
from .decode_sweep import PATH_STARTS, TABLE_STARTS
from .prefill_ablation import _patch, build

S = 16  # slots a CTA: stamps, then 8 the SM id, 9 the work count
HEAD = "namespace {\n\nusing namespace bd;\n"
STAMP = '''
__device__ unsigned long long g_ts[8192 * 16];
__device__ __forceinline__ int cta_id() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
__device__ __forceinline__ void stamp(int slot, int dep) {
  int d;
  asm volatile("mov.b32 %0, %1;" : "=r"(d) : "r"(dep));
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0) g_ts[cta_id() * 16 + slot] = t + (d == 0x7fffffff);
}
__device__ __forceinline__ void note(int work) {
  if (threadIdx.x == 0) {
    unsigned smid;
    asm("mov.u32 %0, %%smid;" : "=r"(smid));
    g_ts[cta_id() * 16 + 8] = smid;
    g_ts[cta_id() * 16 + 9] = work;
  }
}
'''
COPY = '''
extern "C" int bd_ts_copy(void* dst) { return cudaMemcpyFromSymbol(dst, g_ts, sizeof(g_ts)); }
'''


def a16_source(src: str) -> str:
    """csrc/quant_matmul.cu with stamps 0..7 in the decode kernel."""
    src = _patch(src, HEAD, HEAD + STAMP)
    src = _patch(src, "  const int xld = D::xld(ngs_max);\n  uint32_t* ring",
                 "  const int xld = D::xld(ngs_max);\n  stamp(0, 0);\n  uint32_t* ring")
    src = _patch(src, "  for (int j = 0; j < DEC_STAGES - 1; ++j) issue(j);\n\n  grid_dep_wait();",
                 "  for (int j = 0; j < DEC_STAGES - 1; ++j) issue(j);\n  stamp(1, ngs);\n\n"
                 "  grid_dep_wait();\n  stamp(2, 0);")
    synced = "  __syncthreads();  // the x slice and its group sums in shared memory\n"
    src = _patch(src, synced, synced + "  stamp(3, 0);\n")
    drain = ("  // the partial tile over the drained rings, then the cluster's sum in rank order\n"
             "  cp_wait<0>();\n")
    src = _patch(src, drain, "  stamp(4, __float_as_int(acc[0][0][0]));\n  note(ngs);\n" + drain)
    first = ("  cluster.sync();\n"
             "  const int e0 = rank * MROWS * COLS / C, e1 = (rank + 1) * MROWS * COLS / C;\n")
    src = _patch(src, first, first.replace("  cluster.sync();\n", "  cluster.sync();\n  stamp(5, 0);\n"))
    last = ("      out[size_t(r) * N + n] = __float2bfloat16(sum);\n    }\n  }\n"
            "  cluster.sync();  // no CTA leaves while a peer still reads its shared memory\n")
    return _patch(src, last, last + "  stamp(6, 0);\n") + COPY


def attention_source(src: str) -> str:
    """csrc/decode_attention.cu with stamps 0..6 in fd_kernel."""
    src = _patch(src, HEAD, HEAD + STAMP)
    st = "  const int st = start[b];  // first: the copies wait for it\n"
    src = _patch(src, st, "  stamp(0, 0);\n" + st + "  stamp(1, st);\n")
    src = _patch(src, "  for (int jr = 0; jr < FD_STAGES - 1; ++jr) issue(jr);\n",
                 "  for (int jr = 0; jr < FD_STAGES - 1; ++jr) issue(jr);\n  stamp(2, runs);\n")
    merge = "  // the warp's lane groups merged by shuffles"
    src = _patch(src, merge, "  stamp(3, __float_as_int(m[0]));\n  note(runs);\n" + merge)
    src = _patch(src, "  if (C == 1) return;  // no peer: no cluster barrier\n",
                 "  stamp(4, 0);\n  if (C == 1) {\n    stamp(5, 0);\n    stamp(6, 0);\n    return;\n  }\n")
    sync = "  cluster.sync();      // every CTA's state in its shared memory\n"
    src = _patch(src, sync, sync + "  stamp(5, 0);\n")
    last = "  cluster.sync();  // no CTA leaves while rank 0 still reads its shared memory\n"
    return _patch(src, last, last + "  stamp(6, 0);\n") + COPY


def _read(lib, ctas: int) -> np.ndarray:
    buf = np.zeros(8192 * S, np.uint64)
    if lib.bd_ts_copy(buf.ctypes.data) != 0:
        raise RuntimeError("could not read the stamps")
    return buf[: ctas * S].reshape(ctas, S).astype(np.int64)


def _report(title: str, ts: np.ndarray, phases) -> None:
    pct = lambda a: " ".join(f"{v:6.2f}" for v in np.percentile(a, [10, 50, 90, 100]))
    t0 = ts[:, 0].min()
    print(f"{title}: {len(ts)} CTAs, span {(ts[:, 6].max() - t0) / 1e3:.2f} us, at most "
          f"{np.bincount(ts[:, 8]).max()} a SM, work a CTA {ts[:, 9].min()}-{ts[:, 9].max()}",
          flush=True)
    print(f"   {'entry':14s} {pct((ts[:, 0] - t0) / 1e3)}")
    for i, name in enumerate(phases):
        print(f"   {name:14s} {pct((ts[:, i + 1] - ts[:, i]) / 1e3)}")
    print(f"   {'lifetime':14s} {pct((ts[:, 6] - ts[:, 0]) / 1e3)}", flush=True)


def _load(name: str, text: str, fn_name: str, argtypes):
    lib = build({name: text})[name]
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.bd_ts_copy.argtypes, lib.bd_ts_copy.restype = [ctypes.c_void_p], ctypes.c_int
    return lib, fn


def run_a16(gen, stream, sms) -> None:
    src = a16_source((_build.CSRC_DIR / "quant_matmul.cu").read_text())
    lib, fn = _load("a16_timeline", src, "bd_qmm_decode",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    m = 8
    for name, (k, n) in {"qkv": (4096, 12288), "down": (11008, 4096)}.items():
        layers = max(2, math.ceil(120e6 / (k * n / 4 + k // 128 * n * 4)))
        qw = torch.randint(-(2**31), 2**31 - 1, (layers, k // 16, n), dtype=torch.int32,
                           device="cuda", generator=gen)
        s = torch.rand((layers, k // 128, n), device="cuda", generator=gen) * 0.02
        combo = make_scale_combo(s, s)
        x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        chosen = qm.a16_decode_plan(n, k // 128, sms)
        for plan in (chosen, *[p for p in ((4, 32), (8, 32)) if p != chosen]):
            for i in range(8):  # the last call's stamps stay
                _build.check(fn(x.data_ptr(), qw[i % layers].data_ptr(),
                                combo[i % layers].data_ptr(), out.data_ptr(), m, k, n, 2, 128,
                                *plan, stream), "a16 timeline")
            torch.cuda.synchronize()
            ts = _read(lib, -(-n // (8 * plan[1])) * plan[0])
            _report(f"a16 {name} (cluster, columns a warp) {plan}{'*' if plan == chosen else ''}",
                    ts, ("prologue", "PDL wait", "x staged", "K loop", "drain+sync",
                         "reduce+sync"))
        del qw, s, combo


def run_attention(gen, stream, sms) -> None:
    src = attention_source((_build.CSRC_DIR / "decode_attention.cu").read_text())
    lib, fn = _load("attention_timeline", src, "bd_flash_decode",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    b, h, t, d = 8, 32, 2048, 128
    ck = torch.randn((2, b, h, t, d), device="cuda", generator=gen).bfloat16()
    cv = torch.randn((2, b, h, t, d), device="cuda", generator=gen).bfloat16()
    q = torch.randn((b, h, d), device="cuda", generator=gen).bfloat16()
    out = torch.empty_like(q)
    for label, starts in (("path", PATH_STARTS), ("table", TABLE_STARTS)):
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        for c in (1, 2, 3):
            for i in range(6):  # the last call's stamps stay
                _build.check(fn(q.data_ptr(), ck[i % 2].data_ptr(), cv[i % 2].data_ptr(), None,
                                None, q.data_ptr(), q.data_ptr(), st.data_ptr(), out.data_ptr(),
                                0, b, h, 1, t, d, t, 0, d ** -0.5, c, stream),
                             "attention timeline")
            torch.cuda.synchronize()
            _report(f"attention {label} ({sum(starts)} rows), cluster {c}", _read(lib, b * h * c),
                    ("start read", "first copies", "row loop", "merges", "cluster sync",
                     "rank-0 merge"))


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_timeline: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = {"a16": run_a16, "attention": run_attention}
    for name in sys.argv[1:] or list(runs):
        runs[name](gen, stream, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
