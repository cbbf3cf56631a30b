"""The native (C++) host packer, loaded through ctypes (the port's counterpart
of the JAX package's `native/__init__.py`).

`csrc/packlib.cpp` is compiled by g++ at first use into the package's
git-ignored `_build/` (a file name carrying a digest of the source and the
flags, so an edited source is rebuilt). A failed build raises with the
compiler's output: there is no quiet fallback. `pack_model` packs weights
on the CPU through it (`scripts/pack_timing.py` times it beside PyTorch's
packer).

    quantize_pack_native(w, bits, group_size) -> (qweight, scales, szeros)

packs a [K, N] float32 weight with every core, bit-equal to
`quant.packing.quantize_pack_linear` on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "csrc" / "packlib.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpack-{digest}.so"


def build() -> Path:
    """Compile the packer unless it is built; returns the library's path.
    Raises RuntimeError with the compiler's output if g++ fails or is
    missing."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native packer cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native packer failed (exit {res.returncode}):\n"
                           f"{res.stderr}{res.stdout}")
    os.replace(tmp, target)
    return target


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.quantize_pack.restype = ctypes.c_int
            lib.quantize_pack.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ]
            lib.unpack.restype = ctypes.c_int
            lib.unpack.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def quantize_pack_native(w: np.ndarray, bits: int, group_size: int = 128,
                         n_threads: int = 0):
    """w: [K, N] float32 -> (qweight int32 [K/pack, N], scales, szeros
    float32 [K/G, N]); group_size <= 0 is one group of K."""
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape
    g = group_size if group_size > 0 else k
    if bits not in (2, 4, 8) or k % g or g % (32 // bits):
        raise ValueError(f"the packer takes bits 2/4/8 and groups dividing K into whole "
                         f"words; got bits={bits}, K={k}, group={g}")
    qweight = np.empty((k // (32 // bits), n), np.int32)
    scales = np.empty((k // g, n), np.float32)
    szeros = np.empty((k // g, n), np.float32)
    rc = get_lib().quantize_pack(_ptr(w, ctypes.c_float), k, n, bits, g,
                                 _ptr(qweight, ctypes.c_int32), _ptr(scales, ctypes.c_float),
                                 _ptr(szeros, ctypes.c_float), n_threads)
    if rc != 0:
        raise RuntimeError(f"quantize_pack failed with code {rc}")
    return qweight, scales, szeros


def unpack_native(qweight: np.ndarray, k: int, bits: int, group_size: int) -> np.ndarray:
    """Packed words [K/pack, N] -> codes int32 [K, N]."""
    qweight = np.ascontiguousarray(qweight, np.int32)
    out = np.empty((k, qweight.shape[1]), np.int32)
    rc = get_lib().unpack(_ptr(qweight, ctypes.c_int32), k, qweight.shape[1], bits,
                          group_size if group_size > 0 else k, _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"unpack failed with code {rc}")
    return out
