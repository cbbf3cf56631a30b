"""Where the A16 prefill kernel's time goes: the kernel against copies of
itself with one part taken out, on the card.

    python -m bitdistiller_tpu_torch.scripts.prefill_ablation

Each ablation is a text patch of csrc/quant_matmul.cu, written and built by
nvcc into _build/ablation/ (git-ignored) beside the unpatched source; a
patch that no longer applies raises. The ablated kernels compute wrong results and are
timed only:
  * no_fold: acc += part, without the scale and zero correction;
  * no_wgmma: the wgmma instructions removed (the A fragments still built);
  * no_wgmma_no_fold: both;
  * mma_only: no loads inside the K loop (every group reads stage 0) and no
    fold: the fragment building and the wgmma chain alone.
Times are one layer's four 7B matmuls (qkv, o, gate_up, down), int2-g128,
at M = 256 and 4096, by CUDA events over layers that cycle through more
than 100 MB of weights, each variant in turn; one line per M, in ms.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import quant_matmul as qm
from ..quant.packing import make_scale_combo

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096)}
FOLD = "acc[4 * j + e] = acc[4 * j + e] + part[4 * j + e] * s[h] - xe * zc[h];"
WGMMA = ("        wgmma_bf16(part, a[kk], sw128_desc(xa + (kk >> 2) * (BM * 128) + (kk & 3) * 32),\n"
         "                   kk > gs * Map::KB);\n")
NO_WGMMA = "        part[kk] += __uint_as_float(a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ a[kk][3] ^ xa);\n"
WAIT = ("    const uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;\n"
        "    mbar_wait(full + g % PF_STAGES, (g / PF_STAGES) & 1);\n")
LOAD = "        if (tid == 0 && g + PF_STAGES - 1 < ng) load_stage(g + PF_STAGES - 1);\n"
PROLOGUE = "    for (int g = 0; g < PF_STAGES - 1 && g < ng; ++g) load_stage(g);\n"


def _patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"ablation patch does not apply to its kernel source: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    no_fold = _patch(src, FOLD, "acc[4 * j + e] += part[4 * j + e];")
    no_wgmma = _patch(src, WGMMA, NO_WGMMA)
    mma_only = _patch(_patch(_patch(no_fold, WAIT, "    const uint8_t* st = smem;\n"
                                    "    if (g == 0) mbar_wait(full, 0);\n"), LOAD, ""),
                      PROLOGUE, "    load_stage(0);\n")
    return {"kernel": src, "no_fold": no_fold, "no_wgmma": no_wgmma,
            "no_wgmma_no_fold": _patch(no_wgmma, FOLD, "acc[4 * j + e] += part[4 * j + e];"),
            "mma_only": mma_only}


def build(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.nvcc_path(), {}
    for name, text in srcs.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, failed = {}, []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
        else:
            libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def cuda_ms(fn, iters: int = 20, reps: int = 3) -> float:
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(iters):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_ablation: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    libs = build(variants((_build.CSRC_DIR / "quant_matmul.cu").read_text()))
    fns = {}
    for name, lib in libs.items():
        fn = lib.bd_qmm_prefill
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bits = 2
    for m in (256, 4096):
        total = dict.fromkeys(fns, 0.0)
        for k, n in SHAPES.values():
            layers = max(2, math.ceil(120e6 / (k * n * bits / 8)))
            qw = torch.randint(-(2**31), 2**31 - 1, (layers, k * bits // 32, n),
                               dtype=torch.int32, device="cuda", generator=gen)
            s = (torch.rand((layers, k // 128, n), device="cuda", generator=gen) * 0.02).bfloat16()
            combo = make_scale_combo(s.float(), 2 * s.float())
            x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
            xsum = qm.group_sums_scratch(m, k, torch.float32, "cuda")
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            tile = qm.prefill_tile_m(m, n, torch.cuda.get_device_properties(0).multi_processor_count)
            for name, fn in fns.items():
                args = [(x.data_ptr(), qw[i].data_ptr(), combo[i].data_ptr(), None, None,
                         xsum.data_ptr(), out.data_ptr(), m, k, n, bits, 128, tile, 0, stream)
                        for i in range(layers)]
                _build.check(fn(*args[0]), name)
                total[name] += cuda_ms(lambda i: fn(*args[i % layers]))
        print(f"M={m}: " + ", ".join(f"{name} {ms:.4f}" for name, ms in total.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
