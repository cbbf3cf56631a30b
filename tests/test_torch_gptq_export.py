"""The port's GPTQ export (`models/gptq_export.py`) against the JAX
package's on the same trees: dense trees loaded from tiny HF checkpoints of
Llama, Qwen2 (biases), Falcon (MQA, RW-MHA, the new architecture), MPT,
Bloom and OPT, quantized by the export, and packed trees (`pack_model`,
fused qkv and gate_up; Qwen2's biased q/k/v packed alone; the Falcon and
MPT layouts under a Llama model_type, as the JAX package's own family
tests make them) exported without requantization. Both write the same
tensors, bit for bit, and the same two JSON files; for the packed
trees, the same model.safetensors byte for byte. The JAX package's file of a
dense export holds its transposed tensors' memory in column-major order
under their row-major shapes (a fault of that file, not of its values): the
port writes the values, and a test pins the difference.

Also: the pack and unpack helpers against the JAX package's, the packed
export's codes against the pair layout's, the `a8_order` raise, and two
inherited faults kept (ROADMAP C4): config.json says "llama" for every
family, and a packed tree of a fused-qkv family (Falcon, Bloom, MPT by
model_type) raises a TypeError in both packages."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.models import gptq_export as jg
from bitdistiller_tpu.models.hf_import import load_hf_checkpoint as jload
from bitdistiller_tpu.models.quantized import pack_model as jpack
from bitdistiller_tpu_torch.models import gptq_export as tg
from bitdistiller_tpu_torch.models import safetensors_io
from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint as tload
from bitdistiller_tpu_torch.models.quantized import pack_model as tpack
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.quant.packing import unpack_codes
import hf_checkpoints
from test_model_families import TINY_FALCON, TINY_MPT
from torch_port_util import to_numpy_tree, torch_cfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hf"))
    return lambda name: hf_checkpoints.build(name, root)


def _same_export(jax_dir, port_dir):
    for name in ("model.safetensors", "quantize_config.json", "config.json"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


DENSE = ["llama_untied", "qwen2", "falcon_mqa", "falcon_rw", "falcon_new", "mpt", "bloom",
         "opt"]


def _jax_export(monkeypatch, params, cfg, path, **kw) -> dict:
    """The JAX package's export, with the tensor dict it hands to
    `safetensors.numpy.save_file` (its values as computed, in memory)."""
    import safetensors.numpy

    seen: dict = {}
    save = safetensors.numpy.save_file

    def capture(tensors, filename, *a, **k):
        seen.update(tensors)
        return save(tensors, filename, *a, **k)

    monkeypatch.setattr(safetensors.numpy, "save_file", capture)
    jg.export_gptq(params, cfg, str(path), **kw)
    return seen


def _port_file_holds(port_dir, jax_tensors: dict):
    got = safetensors_io.read(str(port_dir / "model.safetensors"))
    assert sorted(got) == sorted(jax_tensors)
    for name, want in jax_tensors.items():
        assert str(got[name].dtype).split(".")[1] == str(want.dtype), name
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("case", DENSE)
def test_dense_export_matches_jax(ckpt, tmp_path, monkeypatch, case, bits):
    """Every tensor bit-equal to the JAX export's as it computes them, both
    JSON files equal. (Not its file's bytes: see the next test.)"""
    jp, jcfg = jload(ckpt(case), dtype=jnp.float32)
    tp, tcfg = tload(ckpt(case), dtype=torch.float32, device="cpu")
    want = _jax_export(monkeypatch, jp, jcfg, tmp_path / "jax", bits=bits, group_size=32)
    tg.export_gptq(tp, tcfg, str(tmp_path / "port"), bits=bits, group_size=32)
    _port_file_holds(tmp_path / "port", want)
    for name in ("quantize_config.json", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_jax_dense_export_file_holds_column_major_bytes(ckpt, tmp_path, monkeypatch):
    """The JAX package's fault, repaired in the port (ROADMAP C4): a dense
    leaf's qweight, qzeros and scales come out of `layer_to_gptq` as
    transposes (Fortran-ordered numpy arrays), and `safetensors.numpy`
    writes their memory as it lies under the row-major shape, so the JAX
    file reads back scrambled, by the package itself too. The port writes
    the values."""
    from safetensors.numpy import load_file

    jp, jcfg = jload(ckpt("llama_untied"), dtype=jnp.float32)
    tp, tcfg = tload(ckpt("llama_untied"), dtype=torch.float32, device="cpu")
    want = _jax_export(monkeypatch, jp, jcfg, tmp_path / "jax", bits=2, group_size=32)
    tg.export_gptq(tp, tcfg, str(tmp_path / "port"), bits=2, group_size=32)
    jax_file = load_file(str(tmp_path / "jax" / "model.safetensors"))
    port_file = load_file(str(tmp_path / "port" / "model.safetensors"))
    scrambled = [k for k, v in want.items() if not v.flags["C_CONTIGUOUS"]]
    assert {k.rsplit(".", 1)[1] for k in scrambled} == {"qweight", "qzeros", "scales"}
    for k in scrambled:
        assert jax_file[k].shape == want[k].shape
        np.testing.assert_array_equal(jax_file[k].ravel(), want[k].ravel(order="F"))
        assert not np.array_equal(jax_file[k], want[k])
        np.testing.assert_array_equal(port_file[k], want[k])


def test_bf16_dense_export_matches_jax(ckpt, tmp_path, monkeypatch):
    jp, jcfg = jload(ckpt("llama_tied"), dtype=jnp.bfloat16)
    tp, tcfg = tload(ckpt("llama_tied"), dtype=torch.bfloat16, device="cpu")
    want = _jax_export(monkeypatch, jp, jcfg, tmp_path / "jax", bits=2, group_size=64)
    tg.export_gptq(tp, tcfg, str(tmp_path / "port"), bits=2, group_size=64)
    _port_file_holds(tmp_path / "port", want)


def _packed(jp, jcfg, bits, group):
    """(the JAX package's packed tree, the port's own pack_model of the same
    dense tree: bit-equal words)."""
    tp = params_from_numpy(to_numpy_tree(jp), "cpu")
    return jpack(jp, jcfg, bits=bits, group_size=group), tpack(tp, torch_cfg(jcfg), bits, group)


PACKED = {
    "llama": lambda c: jload(c("llama_untied"), dtype=jnp.float32),
    "qwen2": lambda c: jload(c("qwen2"), dtype=jnp.float32),
    "falcon_layout": lambda c: (jinit(TINY_FALCON, jax.random.key(1), dtype=jnp.float32),
                                TINY_FALCON),
    "mpt_layout": lambda c: (jinit(TINY_MPT, jax.random.key(2), dtype=jnp.float32), TINY_MPT),
}


@pytest.mark.parametrize("bits,group", [(2, 32), (2, 64), (4, 32)])
@pytest.mark.parametrize("case", sorted(PACKED))
def test_packed_export_matches_jax(ckpt, tmp_path, case, bits, group):
    jp, jcfg = PACKED[case](ckpt)
    jpk, tpk = _packed(jp, jcfg, bits, group)
    jg.export_gptq(jpk, jcfg, str(tmp_path / "jax"))
    tg.export_gptq(tpk, torch_cfg(jcfg), str(tmp_path / "port"))
    _same_export(tmp_path / "jax", tmp_path / "port")


def test_packed_export_holds_the_codes_and_scales(ckpt, tmp_path):
    """No requantization: every layer's GPTQ codes unpack to the pair
    layout's codes, its zeros to szeros / scales, its scales to f16 of the
    leaf's."""
    tp, tcfg = tload(ckpt("llama_untied"), dtype=torch.float32, device="cpu")
    tpk = tpack(tp, tcfg, bits=2, group_size=32)
    tg.export_gptq(tpk, tcfg, str(tmp_path / "out"))
    out = safetensors_io.read(str(tmp_path / "out" / "model.safetensors"))
    hq, hkv, dh, ffn = tcfg.num_heads, tcfg.num_kv_heads, tcfg.actual_head_dim, \
        tcfg.intermediate_size
    parts = {"qkv": [("q_proj", hq * dh), ("k_proj", hkv * dh), ("v_proj", hkv * dh)],
             "gate_up": [("gate_proj", ffn), ("up_proj", ffn)], "o": [("o_proj", None)],
             "down": [("down_proj", None)]}
    for leaf_name, cuts in parts.items():
        leaf = tpk["layers"][leaf_name]
        for li in range(tcfg.num_layers):
            codes = unpack_codes(leaf.qweight[li], 2, 32)
            start = 0
            for hf_name, width in cuts:
                width = width or leaf.out_features
                mod = "mlp" if hf_name in ("gate_proj", "up_proj", "down_proj") else "self_attn"
                key = f"model.layers.{li}.{mod}.{hf_name}"
                sl = slice(start, start + width)
                assert torch.equal(tg.unpack_gptq_qweight(out[key + ".qweight"], 2),
                                   codes[:, sl]), key
                assert torch.equal(out[key + ".scales"], leaf.scales[li][:, sl].half()), key
                zeros = torch.round(leaf.szeros[li][:, sl] / leaf.scales[li][:, sl])
                assert torch.equal(tg.unpack_gptq_qweight(out[key + ".qzeros"].T.contiguous(),
                                                          2).T, zeros.to(torch.int32)), key
                start += width


@pytest.mark.parametrize("bits", [2, 4])
def test_pack_helpers_match_jax(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, (64, 48)).astype(np.int32)
    zeros = rng.integers(0, 2**bits, (4, 48)).astype(np.int32)
    qw = tg.pack_gptq_qweight(torch.as_tensor(codes), bits)
    np.testing.assert_array_equal(qw.numpy(), jg.pack_gptq_qweight(codes, bits))
    np.testing.assert_array_equal(tg.pack_gptq_qzeros(torch.as_tensor(zeros), bits).numpy(),
                                  jg.pack_gptq_qzeros(zeros, bits))
    np.testing.assert_array_equal(tg.unpack_gptq_qweight(qw, bits).numpy(), codes)
    np.testing.assert_array_equal(jg.unpack_gptq_qweight(qw.numpy(), bits), codes)
    with pytest.raises(ValueError, match="multiple"):
        tg.pack_gptq_qweight(torch.zeros((10, 4), dtype=torch.int32), bits)


@pytest.mark.parametrize("case", ["falcon_mqa", "falcon_rw", "falcon_new", "bloom", "mpt"])
def test_fuse_qkv_inverts_the_loader_split(ckpt, case):
    """The re-fused q/k/v equal the file's fused weight, transposed, and the
    JAX package's fuse."""
    from bitdistiller_tpu_torch.models.hf_import import _load_all_tensors

    jp, jcfg = jload(ckpt(case), dtype=jnp.float32)
    tp, tcfg = tload(ckpt(case), dtype=torch.float32, device="cpu")
    raw = _load_all_tensors(ckpt(case))
    key = ("transformer.blocks.0.attn.Wqkv.weight" if case == "mpt"
           else "transformer.h.0.self_attention.query_key_value.weight")
    lay = tp["layers"]
    fused = tg.fuse_qkv_hf(tcfg, lay["q"]["w"][0], lay["k"]["w"][0], lay["v"]["w"][0])
    assert torch.equal(fused, raw[key].T)
    jl = jp["layers"]
    np.testing.assert_array_equal(fused.numpy(), jg.fuse_qkv_hf(
        jcfg, jl["q"]["w"][0], jl["k"]["w"][0], jl["v"]["w"][0]))


def test_a8_order_leaf_raises():
    from bitdistiller_tpu_torch.quant.packing import quantize_pack_linear

    p = quantize_pack_linear(torch.randn(64, 32), 2, 32)
    stacked = dataclasses.replace(p, qweight=p.qweight[None], scales=p.scales[None],
                                  szeros=p.szeros[None], combo=p.combo[None], a8_order=True)
    with pytest.raises(ValueError, match="A8"):
        tg.packed_layer_to_gptq(stacked, 0, 2, 32)


def test_config_json_says_llama_for_a_falcon_export(ckpt, tmp_path):
    """C4, kept: the export's config.json names every family "llama"."""
    jp, jcfg = jload(ckpt("falcon_mqa"), dtype=jnp.float32)
    tp, tcfg = tload(ckpt("falcon_mqa"), dtype=torch.float32, device="cpu")
    jg.export_gptq(jp, jcfg, str(tmp_path / "jax"), group_size=32)
    tg.export_gptq(tp, tcfg, str(tmp_path / "port"), group_size=32)
    for d in ("jax", "port"):
        assert json.loads((tmp_path / d / "config.json").read_text())["model_type"] == "llama"
    keys = safetensors_io.read_header(str(tmp_path / "port" / "model.safetensors"))[0]
    assert "transformer.h.0.self_attention.query_key_value.qweight" in keys


def test_packed_fused_qkv_family_raises_in_both(ckpt, tmp_path):
    """C4, kept: a packed tree whose model_type fuses q/k/v in HF (Falcon here)
    reaches the re-fuse with PackedLinear leaves, which both packages index
    as dicts."""
    jp, jcfg = jload(ckpt("falcon_mqa"), dtype=jnp.float32)
    jpk, tpk = _packed(jp, jcfg, 2, 32)
    with pytest.raises(TypeError):
        jg.export_gptq(jpk, jcfg, str(tmp_path / "jax"))
    with pytest.raises(TypeError):
        tg.export_gptq(tpk, torch_cfg(jcfg), str(tmp_path / "port"))
