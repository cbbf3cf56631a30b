"""Times B8's forward, dkv and dq kernels through their wrappers, card only.

    python -m bitdistiller_tpu_torch.scripts.train_attention_times [B S Hq Hkv D dtype]

Defaults to Gemma-2B's heads in f32 (B=2, S=1024, Hq=8, Hkv=1, D=256: the
forward, dkv and dq on the 3xTF32 splits of 2 CTAs). Prints one JSON line:
the shape, the forward's plan, each kernel's CUDA-event times (ms a call,
the median of 5 runs of 10 calls, then each run's own), and the card's
name and power limit. Run it from two checkouts
in one session, in the order A, B, B, A, to compare two versions of
csrc/train_attention.cu on one card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import train_attention as ta


def _ms(fn, iters: int = 10, reps: int = 5) -> list[float]:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return runs


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("train_attention_times needs a CUDA card", file=sys.stderr)
        return 1
    b, s, hq, hkv, d = (int(x) for x in argv[:5]) if argv else (2, 1024, 8, 1, 256)
    dtype = getattr(torch, argv[5]) if len(argv) > 5 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((b, s, hq, d), device="cuda", generator=gen).to(dtype) for _ in "qo")
    k, v = (torch.randn((b, s, hkv, d), device="cuda", generator=gen).to(dtype) for _ in "kv")
    out, lse = ta.train_attn_fwd(q, k, v, None)
    di = (out.float() * do.float()).sum(-1).contiguous()
    runs = {
        "fwd": _ms(lambda: ta.train_attn_fwd(q, k, v, None)),
        "dkv": _ms(lambda: ta.train_attn_bwd_dkv(q, k, v, None, do, lse, di)),
        "dq": _ms(lambda: ta.train_attn_bwd_dq(q, k, v, None, do, lse, di)),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(shape=[b, s, hq, hkv, d], dtype=str(dtype), card=card,
                          plan=ta.fwd_plan(b, s, hq, hkv, d, dtype).kernel,
                          ms={k: sorted(r)[len(r) // 2] for k, r in runs.items()}, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
