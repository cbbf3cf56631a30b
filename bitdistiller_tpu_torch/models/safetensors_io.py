"""The safetensors file format, read and written with torch alone (the port
needs no `safetensors` package; the format is the package's own).

A file is an 8-byte little-endian header length n, n bytes of JSON, then
the tensors' raw little-endian bytes back to back. The JSON maps each name
to {"dtype", "shape", "data_offsets": [begin, end]} (offsets into the byte
buffer after the header) and may hold "__metadata__", a {str: str} dict.
The writer lays a file out as the package does: the JSON without spaces,
padded with spaces so that the buffer starts on a multiple of 8, and the
tensors sorted by dtype (widest first, in the package's dtype order) then
by name, so that every tensor starts aligned to its element size.

`read` maps the file copy-on-write and makes every tensor a view of the
mapping (`torch.frombuffer`): nothing is copied into host memory until a
caller copies it, and bf16 is read as torch's bf16, without numpy.
"""

from __future__ import annotations

import json
import mmap
import struct

import torch

# the package's dtype names, in the order of its Dtype enum (the writer's sort)
_DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}
_RANK = {name: i for i, name in enumerate(_DTYPES)}


def read_header(path: str) -> tuple[dict, int]:
    """(the JSON header, the byte offset where the tensor buffer begins)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, as CPU tensors that view a
    copy-on-write mapping of the file ("__metadata__" is left out: it is
    `read_header(path)[0].get("__metadata__")`)."""
    header, start = read_header(path)
    entries = {k: v for k, v in header.items() if k != "__metadata__"}
    if not entries:
        return {}
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, e in entries.items():
        try:
            dtype = _DTYPES[e["dtype"]]
        except KeyError:
            raise ValueError(f"{path}: tensor {name!r} has dtype {e['dtype']!r}, "
                             f"which the reader does not take") from None
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, "
                             f"its shape {list(shape)} needs {count * itemsize}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = start + begin
        if offset % itemsize:  # a writer that did not align: copy this tensor's bytes
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin, offset=offset)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                         offset=offset).reshape(shape)
    return out


def write(path: str, tensors: dict[str, torch.Tensor], metadata: dict | None = None) -> None:
    """Write `tensors` (any device; a tensor is copied to the host only while
    its bytes are written, one at a time) as one .safetensors file."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, which the format "
                             f"writer does not take")
    order = sorted(tensors, key=lambda k: (-_RANK[_NAMES[tensors[k].dtype]], k))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                host = t.to("cpu").contiguous().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
                del host  # before the next copy: one tensor on the host at a time
