"""What ptxas made of a CUDA source of the port, kernel by kernel: registers
a thread and spill bytes (`nvcc -Xptxas -v`), and in the SASS (`cuobjdump
-sass`) the warpgroup MMAs (HGMMA), the waits for them (WARPGROUP.DEPBAR),
the warp-level MMAs (HMMA: mma.sync, which no B8 tensor-core kernel, bf16
or f32 3xTF32, should hold) and the local-memory stores and loads (STL,
LDL).

    python -m bitdistiller_tpu_torch.scripts.kernel_sass [train_attention ...]

A wait after nearly every HGMMA says ptxas serialised the chain (B8's first
dq kernel: a test of D between its wgmmas). STL and LDL are spills. Needs the CUDA toolkit (nvcc,
cuobjdump), not a card. Builds each named source of csrc/ (default
train_attention) with ops/_build.py's flags into _build/sass/
(git-ignored) and prints one JSON line a kernel.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

from ..ops import _build

COUNTED = {"hgmma": "HGMMA", "wgmma_waits": "WARPGROUP.DEPBAR", "hmma": "HMMA", "stl": "STL",
           "ldl": "LDL"}
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict[str, dict]:
    """{mangled kernel: {registers, spill_stores, spill_loads}} from the
    output of nvcc -Xptxas -v."""
    out: dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        if m := _SPILL.search(line):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif m := _REGS.search(line):
            cur["registers"] = int(m.group(1))
    return out


def parse_sass(text: str) -> dict[str, dict]:
    """{mangled kernel: {hgmma, wgmma_waits, hmma, stl, ldl}}: instruction counts
    in the cuobjdump -sass listing of each function."""
    out: dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :", 1)[1].strip(),
                                 {k: 0 for k in COUNTED})
            continue
        if cur is not None and "/*" in line:
            op = line.split("*/", 1)[-1].strip()
            op = op.split()[1] if op.startswith("@") and len(op.split()) > 1 else op.split(" ")[0]
            for key, name in COUNTED.items():
                if op.startswith(name):
                    cur[key] += 1
    return out


def _demangle(names: list[str], tools: Path) -> dict[str, str]:
    filt = tools / "cu++filt"
    if not names or not filt.exists():
        return {n: n for n in names}
    res = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True)
    plain = res.stdout.splitlines()
    if res.returncode or len(plain) != len(names):
        return {n: n for n in names}
    # drop the anonymous namespace, the casts of template arguments and the
    # parameter list: "train_attn_fwd_kernel<64>", "train_attn_dkv_wide_kernel"
    return {n: re.sub(r"^.*?::(?=\w+(?:<|\())|\(.*$", "", re.sub(r"\((?:int|bool)\)", "", p))
            for n, p in zip(names, plain)}


def report(name: str) -> list[dict]:
    nvcc = Path(_build.nvcc_path())
    out_dir = _build.BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    build = subprocess.run(
        [str(nvcc), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(_build.CSRC_DIR / f"{name}.cu")], capture_output=True, text=True)
    if build.returncode:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{build.stdout}{build.stderr}")
    regs = parse_ptxas(build.stdout + build.stderr)
    dump = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True)
    sass = parse_sass(dump.stdout)
    names = sorted(set(regs) | set(sass))
    plain = _demangle(names, nvcc.parent)
    return [dict(source=f"{name}.cu", kernel=plain[n], **regs.get(n, {}), **sass.get(n, {}))
            for n in names]


def main(argv: list[str]) -> int:
    for name in argv or ["train_attention"]:
        for row in report(name):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
