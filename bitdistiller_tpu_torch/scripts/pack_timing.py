"""Host packing time: the C++ packer (quant/native.py) beside PyTorch's
CPU packer (`quant.packing.quantize_pack_linear`) on one decoder layer's
fused linears at Llama-2-7B widths, int2-g128 by default.

    python -m bitdistiller_tpu_torch.scripts.pack_timing [--bits 2] [--group 128] [--reps 3]

Each shape is a random f32 [K, N] weight from seed 0. Both packers run
`--reps` times after one untimed call; the best wall time of each is kept,
and their words, scales and zeros must be bit-equal. Prints one line a
shape and, last, one JSON object with every row and both thread counts
(the C++ packer takes every core; PyTorch its intra-op pool).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..quant.native import quantize_pack_native
from ..quant.packing import quantize_pack_linear

# Llama-2-7B's fused layer linears, [K, N]: qkv, o, gate_up, down
SHAPES = (("qkv", 4096, 12288), ("o", 4096, 4096), ("gate_up", 4096, 22016),
          ("down", 11008, 4096))


def best_of(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--group", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    rows = []
    for name, k, n in SHAPES:
        w = rng.standard_normal((k, n), dtype=np.float32)
        wt = torch.from_numpy(w)
        ref = quantize_pack_linear(wt, args.bits, args.group)
        got = quantize_pack_native(w, args.bits, args.group)
        for a, b in zip(got, (ref.qweight, ref.scales, ref.szeros)):
            if not np.array_equal(a, b.numpy()):
                raise AssertionError(f"{name}: the packers disagree")
        torch_s = best_of(lambda: quantize_pack_linear(wt, args.bits, args.group), args.reps)
        native_s = best_of(lambda: quantize_pack_native(w, args.bits, args.group), args.reps)
        rows.append(dict(name=name, k=k, n=n, torch_s=torch_s, native_s=native_s,
                         speedup=torch_s / native_s))
        print(f"{name} [{k}, {n}] int{args.bits}-g{args.group}: PyTorch {torch_s:.4f} s, "
              f"C++ {native_s:.4f} s ({torch_s / native_s:.2f}x)", flush=True)
    out = dict(rows=rows, torch_threads=torch.get_num_threads(), cores=os.cpu_count(),
               bits=args.bits, group=args.group, reps=args.reps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
