"""The port's own safetensors reader and writer (`models/safetensors_io.py`)
against the `safetensors` package: the port's files read by the package,
the package's files read by the port, and the two writers' files byte for
byte. Every dtype the port takes, a 0-d and an empty tensor, metadata, two
shards read through the HF loader's path. Tensors must be bit-equal."""

import json
import struct

import pytest
import torch
from safetensors.torch import load_file, save_file

from bitdistiller_tpu_torch.models import safetensors_io as sio
from bitdistiller_tpu_torch.models.hf_import import _load_all_tensors

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8,
          torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool]


def _tensors(seed: int) -> dict:
    """One tensor a dtype (odd sizes, so the writer's order decides the
    alignment), a 0-d and an empty tensor."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, 5 + i)
        if dt.is_floating_point:
            t = (torch.randn(shape, generator=g, dtype=torch.float64) * 100).to(dt)
        elif dt == torch.bool:
            t = torch.randint(0, 2, shape, generator=g).to(torch.bool)
        else:
            info = torch.iinfo(dt)
            t = torch.randint(info.min, info.max, shape, generator=g, dtype=torch.int64).to(dt)
        out[f"t.{str(dt).split('.')[1]}"] = t
    out["scalar"] = torch.tensor(-2.75, dtype=torch.float32)
    out["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    return out


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           want[k].reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("metadata", [None, {"format": "pt", "note": "tiny"}])
def test_port_writer_read_by_the_package(tmp_path, metadata):
    ts = _tensors(0)
    sio.write(str(tmp_path / "a.safetensors"), ts, metadata)
    _assert_bit_equal(load_file(str(tmp_path / "a.safetensors")), ts)
    from safetensors import safe_open

    with safe_open(str(tmp_path / "a.safetensors"), framework="pt") as f:
        assert f.metadata() == metadata


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_package_writer_read_by_the_port(tmp_path, metadata):
    ts = _tensors(1)
    save_file(ts, str(tmp_path / "b.safetensors"), metadata=metadata)
    _assert_bit_equal(sio.read(str(tmp_path / "b.safetensors")), ts)
    assert sio.read_header(str(tmp_path / "b.safetensors"))[0].get("__metadata__") == metadata


def test_files_equal_byte_for_byte(tmp_path):
    """The port lays a file out as the package does: header, padding, order."""
    ts = _tensors(2)
    sio.write(str(tmp_path / "port.safetensors"), ts, {"format": "pt"})
    save_file(ts, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "pkg.safetensors").read_bytes()


def test_read_views_the_file_mapping(tmp_path):
    """Tensors view the mapping (no copy), aligned to their element size, and
    writing into one changes neither the file nor a second read."""
    ts = _tensors(3)
    path = str(tmp_path / "c.safetensors")
    sio.write(path, ts)
    first = sio.read(path)
    for k, t in first.items():
        if t.numel():
            assert t.data_ptr() % t.element_size() == 0, k
    before = (tmp_path / "c.safetensors").read_bytes()
    first["t.float32"].fill_(0.0)
    assert (tmp_path / "c.safetensors").read_bytes() == before
    _assert_bit_equal(sio.read(path), ts)


def test_unaligned_tensor_is_copied(tmp_path):
    """A file from a writer that did not align (an f32 after one byte) still
    reads bit-equal."""
    a = torch.tensor([7], dtype=torch.uint8)
    b = torch.tensor([1.5, -2.25], dtype=torch.float32)
    header = {"a": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [1, 9]}}
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(text)) + text + a.numpy().tobytes()
                     + b.numpy().tobytes())
    _assert_bit_equal(sio.read(str(path)), {"a": a, "b": b})


def test_bad_files_raise(tmp_path):
    path = tmp_path / "bad.safetensors"
    header = {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}
    text = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(text)) + text + bytes(8))
    with pytest.raises(ValueError, match="spans 8 bytes"):
        sio.read(str(path))
    header = {"a": {"dtype": "F8_E4M3", "shape": [4], "data_offsets": [0, 4]}}
    text = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(text)) + text + bytes(4))
    with pytest.raises(ValueError, match="F8_E4M3"):
        sio.read(str(path))
    with pytest.raises(ValueError, match="complex"):
        sio.write(str(tmp_path / "x.safetensors"), {"c": torch.zeros(2, dtype=torch.complex64)})


def test_two_shards_read_in_sorted_order(tmp_path):
    """The HF loader reads every shard of a dir in sorted order (a later
    shard's tensor of the same name wins, as the JAX loader's dict update)."""
    ts = _tensors(4)
    names = sorted(ts)
    half = len(names) // 2
    save_file({k: ts[k] for k in names[:half]},
              str(tmp_path / "model-00001-of-00002.safetensors"))
    sio.write(str(tmp_path / "model-00002-of-00002.safetensors"),
              {**{k: ts[k] for k in names[half:]}, "scalar": ts["scalar"] + 1})
    assert "scalar" in names[:half]
    got = _load_all_tensors(str(tmp_path))
    want = dict(ts, scalar=ts["scalar"] + 1)
    _assert_bit_equal(got, want)
