"""Where the f32 splits' exchange time goes above D = 128: B8's 3xTF32
forward, dkv and dq against copies of themselves with a part of the
exchange taken out, on the card.

    python -m bitdistiller_tpu_torch.scripts.train_attention_ablation

Each variant is a text patch of csrc/train_attention.cu, built by nvcc into
_build/ablation/ (git-ignored) beside the unpatched source (a patch that no
longer applies raises), and launched through its own C entry points with
the plan's cluster:
  * kernel: the source as it is;
  * local_reads: split_sum with its mbarriers, every rank's partial read
    from this CTA's own slots (no remote read; wrong sums);
  * no_exchange: no exchange at all, each CTA keeping its own partial
    (wrong results; timed only).
kernel - local_reads is what the remote reads cost, local_reads -
no_exchange what the rest of the exchange (its stores, arrivals and
waits) costs; at D = 128 (no split) the kernel alone, for scale.
Times by CUDA events (the median of 3 runs of 10 calls) at Gemma-2B's heads
in f32 (B=2, S=1024, Hq=8, Hkv=1) at D = 128 and 256, and at B=1, S=600 /
1024, Hq=8, Hkv=2 at D = 320 and 512, and B=1, S=1024, Hq=Hkv=8 at D =
1024. One JSON line a shape, in ms, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import train_attention as ta
from .prefill_ablation import build, cuda_ms

REMOTE = "    const float4* p = r == side ? own : cluster.map_shared_rank(own, base + r);\n"
SPLIT_SUM = ("  cg::cluster_group cluster = cg::this_cluster();\n"
             "  float4* own = reinterpret_cast<float4*>(xs);\n")
SPLIT_FREE = ("  split_arrive<true>(xfree, base, side, ns, lane);\n"
              "  mbar_wait_cluster(xfree, t & 1);\n")
SHAPES = [(2, 1024, 8, 1, 128), (2, 1024, 8, 1, 256), (1, 600, 8, 2, 320), (1, 1024, 8, 2, 512),
          (1, 1024, 8, 8, 1024)]


def _patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"ablation patch does not apply to its kernel source: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    none = _patch(_patch(src, SPLIT_SUM, "  if (t >= 0) return;\n" + SPLIT_SUM), SPLIT_FREE, "")
    return {"kernel": src, "local_reads": _patch(src, REMOTE, "    const float4* p = own;\n"),
            "no_exchange": none}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_attention_ablation: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    srcs = variants((_build.CSRC_DIR / "train_attention.cu").read_text())
    built = build({f"train_attention_{name}": text for name, text in srcs.items()})
    libs = {name: built[f"train_attention_{name}"] for name in srcs}
    for lib in libs.values():
        lib.bd_train_attn_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                          + [ctypes.c_float] + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
        lib.bd_train_attn_dkv.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                                          + [ctypes.c_float] + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
        lib.bd_train_attn_dq.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                         + [ctypes.c_float] + [ctypes.c_int] * 2
                                         + [ctypes.c_void_p])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, s, hq, hkv, d in SHAPES:
        q, do = (torch.randn((b, s, hq, d), device="cuda", generator=gen) for _ in "qo")
        k, v = (torch.randn((b, s, hkv, d), device="cuda", generator=gen) for _ in "kv")
        out, lse = ta.train_attn_fwd(q, k, v, None)
        di = (out * do).sum(-1).contiguous()
        dk, dv, dq, o, lse_o = (torch.empty_like(t) for t in (k, v, q, q, lse))
        dims = (b, s, hq, hkv, d, d ** -0.5)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(), lse.data_ptr(),
               di.data_ptr())
        fc = ta.fwd_plan(b, s, hq, hkv, d, torch.float32).cluster
        kc = ta.dkv_plan(b, s, hq, hkv, d, torch.float32).cluster
        qc = ta.dq_plan(b, s, hq, hkv, d, torch.float32).cluster
        ms = {}
        for name, lib in libs.items():
            if d <= 128 and name != "kernel":
                continue  # no exchange at D <= 128
            fwd = lambda i: lib.bd_train_attn_fwd(*ins[:4], o.data_ptr(), lse_o.data_ptr(),
                                                  *dims, fc, 1, stream)
            dkv = lambda i: lib.bd_train_attn_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims, kc,
                                                  1, stream)
            dqf = lambda i: lib.bd_train_attn_dq(*ins, dq.data_ptr(), *dims, qc, 1, stream)
            for kind, fn in (("fwd", fwd), ("dkv", dkv), ("dq", dqf)):
                _build.check(fn(0), f"{name} {kind}")
            ms[name] = {"fwd": cuda_ms(fwd, 10), "dkv": cuda_ms(dkv, 10), "dq": cuda_ms(dqf, 10)}
        print(json.dumps(dict(shape=[b, s, hq, hkv, d], card=card, ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
