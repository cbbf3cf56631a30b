"""The streaming decode kernels on other plans than the wrappers choose, on
the card: the A16 matmul at M=8 (by columns a warp and cluster size), the
A8 matmul at M=8 (quantize kernel and decode kernel, by cluster size), the
fused MLP at M=8 (the clusters of its two launches) and the decode
attention (by cluster size, on the long skewed work of PERF.md's table and
at the steady decode step's slot lengths).

    python -m bitdistiller_tpu_torch.scripts.decode_sweep [a16 a8 mlp attention]

(no argument: all four). Times are by CUDA events over layers that cycle
through more than 100 MB of weights or cache (every call reads them from
HBM), int2-g128 at 7B widths, in ms, one line per (kernel, shape); the plan
`a16_decode_plan` / `decode_plan` / `mlp_plan` / `attention_plan` picks is
marked with *. Every plan is first checked against the chosen plan's output
(same bytes for the matmuls on integer-valued inputs; the fused MLP within
1e-2 of max|out|, f32 sums in another grouping; the attention within 2e-2,
its merge in another grouping).
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

from ..experimental import fused_mlp as fm
from ..ops import _build
from ..ops import decode_attention as da
from ..ops import quant_matmul as qm
from ..quant.packing import make_scale_combo

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096)}
MLP = (4096, 11008, 4096)
CLUSTERS = (1, 2, 3, 4, 5, 6, 8)
M = 8
TABLE_STARTS = [2047, 1900, 1536, 1024, 700, 512, 300, 64]  # as chip_smoke.py
PATH_STARTS = [160, 512, 128, 288, 432, 182, 96, 332]


def cuda_ms(fn, iters: int = 50, reps: int = 5) -> float:
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


def _stack(gen, layers, k, n, bits=2):
    qw = torch.randint(-(2**31), 2**31 - 1, (layers, k * bits // 32, n), dtype=torch.int32,
                       device="cuda", generator=gen)
    scales = torch.ones((layers, k // 128, n), device="cuda")
    szeros = torch.randint(0, 2**bits, (layers, k // 128, n), device="cuda", generator=gen).float()
    return qw, scales, szeros


def sweep_a8(gen, sms, stream):
    fn = qm._a8_launcher()
    for name, (k, n) in SHAPES.items():
        layers = max(2, math.ceil(120e6 / (k * n / 4 + k // 128 * n * 8)))
        qw, scales, szeros = _stack(gen, layers, k, n)
        x = torch.randint(-3, 4, (M, k), device="cuda", generator=gen).float()
        x[:, 0] = 127.0
        x = x.bfloat16()
        xi = torch.empty((M, k), dtype=torch.int8, device="cuda")
        sx = torch.empty((M,), dtype=torch.float32, device="cuda")
        outs = {}
        chosen = qm.decode_plan(n, k // 128, sms)
        row = []
        for cluster in (c for c in CLUSTERS if c <= k // 128):
            out = torch.empty((M, n), dtype=torch.bfloat16, device="cuda")
            args = [(x.data_ptr(), qw[i].data_ptr(), scales[i].data_ptr(), szeros[i].data_ptr(),
                     None, None, xi.data_ptr(), sx.data_ptr(), None, out.data_ptr(), M, k, n, 2,
                     128, 0, cluster, 0, stream) for i in range(layers)]
            _build.check(fn(*args[0]), f"qmm_a8 {name} cluster {cluster}")
            torch.cuda.synchronize()
            outs[cluster] = out.clone()
            ms = cuda_ms(lambda i: fn(*args[i % layers]))
            row.append(f"{cluster} {ms:.4f}{'*' if cluster == chosen else ''}")
        ref = outs[chosen]
        bad = [key for key, o in outs.items() if not torch.equal(o, ref)]
        if bad:
            raise AssertionError(f"qmm_a8 {name}: plans {bad} disagree with the chosen one")
        print(f"qmm_a8 {name} (K={k}, N={n}; by cluster size): " + ", ".join(row), flush=True)
        del qw, scales, szeros


def sweep_a16(gen, sms, stream):
    fn = qm._launcher("bd_qmm_decode")
    for name, (k, n) in SHAPES.items():
        layers = max(2, math.ceil(120e6 / (k * n / 4 + k // 128 * n * 4)))
        qw, scales, szeros = _stack(gen, layers, k, n)
        combo = make_scale_combo(scales, szeros)
        x = torch.randint(-3, 4, (M, k), device="cuda", generator=gen).bfloat16()
        chosen = qm.a16_decode_plan(n, k // 128, sms)
        outs, row = {}, []
        for plan in [(c, wc) for wc in qm.A16_WARP_COLS for c in CLUSTERS if c <= k // 128]:
            out = torch.empty((M, n), dtype=torch.bfloat16, device="cuda")
            args = [(x.data_ptr(), qw[i].data_ptr(), combo[i].data_ptr(), None, out.data_ptr(), M,
                     k, n, 2, 128, *plan, 0, stream) for i in range(layers)]
            _build.check(fn(*args[0]), f"qmm_decode {name} plan {plan}")
            torch.cuda.synchronize()
            outs[plan] = out.clone()
            ms = cuda_ms(lambda i: fn(*args[i % layers]))
            row.append(f"{plan[1]}/{plan[0]} {ms:.4f}{'*' if plan == chosen else ''}")
        bad = [key for key, o in outs.items() if not torch.equal(o, outs[chosen])]
        if bad:
            raise AssertionError(f"qmm_decode {name}: plans {bad} disagree with the chosen one")
        print(f"qmm_decode {name} (K={k}, N={n}; columns a warp/cluster size): " + ", ".join(row),
              flush=True)
        del qw, scales, szeros, combo


def sweep_attention(gen, sms, stream):
    b, h, t, d = 8, 32, 2048, 128
    fn = da._launcher()
    ck = torch.randn((2, b, h, t, d), device="cuda", generator=gen).bfloat16()
    cv = torch.randn((2, b, h, t, d), device="cuda", generator=gen).bfloat16()
    q = torch.randn((b, h, d), device="cuda", generator=gen).bfloat16()
    kn = torch.randn((b, h, d), device="cuda", generator=gen).bfloat16()
    chosen = da.attention_plan(b, h, sms)
    for label, starts in (("table", TABLE_STARTS), ("path", PATH_STARTS)):
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        ref, row = None, []
        for c in [chosen] + [c for c in range(1, qm.MAX_CLUSTER + 1) if c != chosen]:
            out = torch.empty_like(q)
            args = [(q.data_ptr(), ck[i].data_ptr(), cv[i].data_ptr(), None, None, kn.data_ptr(),
                     kn.data_ptr(), st.data_ptr(), out.data_ptr(), 0, b, h, 1, t, d, t, 0,
                     d ** -0.5, c, 0, stream) for i in range(2)]
            _build.check(fn(*args[0]), f"decode attention cluster {c}")
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone().float()
            elif not (out.float() - ref).abs().max().item() <= 2e-2:
                raise AssertionError(f"decode attention cluster {c} disagrees with the chosen one")
            ms = cuda_ms(lambda i: fn(*args[i % 2]))
            row.append((c, f"{c} {ms:.4f}{'*' if c == chosen else ''}"))
        print(f"flash_decode {label} ({sum(starts)} rows; by cluster size): "
              + ", ".join(text for _, text in sorted(row)), flush=True)
    del ck, cv


def sweep_mlp(gen, sms, stream):
    k, f, d = MLP
    layers = 12  # 12 x 42 MB
    gate, up, down = _stack(gen, layers, k, f), _stack(gen, layers, k, f), _stack(gen, layers, f, d)
    for t in (*gate, *up, *down):
        if t.is_floating_point():
            t.mul_(0.01)
    x = torch.randn((M, k), device="cuda", generator=gen).bfloat16()
    mid, msum = fm.scratch(M, f, "cuda")
    fn = fm._launcher()
    chosen = fm.mlp_plan(k, f, d, sms)
    plans = sorted({chosen} | {(c1, c2) for c1 in (1, 2, 4, 8) for c2 in (4, 5, 8)})
    row, ref = [], None
    for plan in [chosen] + [p for p in plans if p != chosen]:
        out = torch.empty((M, d), dtype=torch.bfloat16, device="cuda")
        args = [(x.data_ptr(), *[a[li].data_ptr() for w in (gate, up, down) for a in w],
                 None, None, mid.data_ptr(), msum.data_ptr(), out.data_ptr(), M, k, f, d, 2, 128,
                 0, *plan, 0, stream) for li in range(layers)]
        _build.check(fn(*args[0]), f"fused_mlp {plan}")
        torch.cuda.synchronize()
        if ref is None:
            ref = out.clone().float()
        elif not (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item():
            raise AssertionError(f"fused_mlp plan {plan} disagrees with the chosen one")
        ms = cuda_ms(lambda i: fn(*args[i % layers]))
        row.append(f"{plan[0]}/{plan[1]} {ms:.4f}{'*' if plan == chosen else ''}")
    print(f"fused_mlp (K={k}, FFN={f}, D={d}; cluster1/cluster2): " + ", ".join(row),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    sweeps = {"a16": sweep_a16, "a8": sweep_a8, "mlp": sweep_mlp, "attention": sweep_attention}
    for name in sys.argv[1:] or list(sweeps):
        sweeps[name](gen, sms, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
