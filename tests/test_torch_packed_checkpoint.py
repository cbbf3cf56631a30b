"""The port's packed checkpoint (`save_packed_checkpoint`,
`load_packed_checkpoint`) and its native packer (`quant/native.py`) on the
CPU.

The C4 choice, pinned here: the port writes EVERY ModelConfig field to
quant_config.json (the JAX package writes 15, so a packed Falcon, MPT,
Bloom, OPT or Gemma reloads there as a Llama), and reads JSON lists back as
the config's tuples. `packed.npz` holds the JAX package's keys and arrays
for the same tree; the JAX package's loader reads the port's file (the full
Falcon config included) and the port's loader reads the JAX package's
15-field file into the same tree and config. The native packer is
bit-equal to `quantize_pack_linear`."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.config import ModelConfig as JaxConfig
from bitdistiller_tpu.models.quantized import load_packed_checkpoint as jax_load
from bitdistiller_tpu.models.quantized import pack_model as jax_pack
from bitdistiller_tpu.models.quantized import save_packed_checkpoint as jax_save
from bitdistiller_tpu_torch.models import (
    init_params as t_init,
    load_packed_checkpoint,
    pack_model,
    params_from_numpy,
    save_packed_checkpoint,
)
from bitdistiller_tpu_torch.models.config import ModelConfig
from bitdistiller_tpu_torch.quant import native
from bitdistiller_tpu_torch.quant.packing import PackedLinear, quantize_pack_linear, unpack_codes
from torch_port_util import to_numpy_tree, torch_cfg

FALCON_HF = {"model_type": "falcon", "vocab_size": 128, "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4, "multi_query": True,
             "parallel_attn": True, "new_decoder_architecture": False, "bias": True}
GEMMA3_HF = {"model_type": "gemma3_text", "vocab_size": 128, "hidden_size": 64,
             "intermediate_size": 128, "num_hidden_layers": 3, "num_attention_heads": 4,
             "num_key_value_heads": 2, "sliding_window": 4, "hidden_act": "gelu_pytorch_tanh",
             "layer_types": ["sliding_attention", "full_attention", "sliding_attention"]}


def _leaves(tree, prefix=""):
    """{path: tensor} of a port tree, a PackedLinear's arrays by field."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        elif isinstance(v, PackedLinear):
            for f in ("qweight", "scales", "szeros", "bias", "combo"):
                if getattr(v, f) is not None:
                    out[f"{path}/{f}"] = getattr(v, f)
            out[f"{path}/meta"] = torch.tensor([v.bits, v.group_size, v.in_features,
                                                v.out_features])
        else:
            out[path] = v
    return out


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


@pytest.fixture(scope="module")
def jax_packed():
    return jax_pack(init_params(TINY_TEST, jax.random.key(0)), TINY_TEST, bits=2, group_size=64)


def _npz(path):
    with np.load(os.path.join(path, "packed.npz")) as data:
        return {k: data[k] for k in data.files}


def test_round_trip_is_bit_equal(tmp_path):
    cfg = torch_cfg(TINY_TEST)
    packed = pack_model(t_init(cfg, seed=1, device="cpu"), cfg, bits=2, group_size=64)
    save_packed_checkpoint(tmp_path, packed, cfg, bits=2, group_size=64)
    tree, cfg2 = load_packed_checkpoint(tmp_path, device="cpu")
    assert cfg2 == cfg
    _assert_trees_equal(tree, packed)


def test_port_file_equals_the_jax_file_for_the_same_tree(tmp_path, jax_packed):
    jax_save(tmp_path / "jax", jax_packed, TINY_TEST, bits=2, group_size=64)
    tpacked = params_from_numpy(to_numpy_tree(jax_packed), "cpu")
    save_packed_checkpoint(tmp_path / "port", tpacked, torch_cfg(TINY_TEST), bits=2,
                           group_size=64)
    a, b = _npz(tmp_path / "jax"), _npz(tmp_path / "port")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jmeta = json.loads((tmp_path / "jax" / "quant_config.json").read_text())
    tmeta = json.loads((tmp_path / "port" / "quant_config.json").read_text())
    assert (tmeta["bits"], tmeta["group_size"]) == (jmeta["bits"], jmeta["group_size"])
    assert all(tmeta["config"][k] == v for k, v in jmeta["config"].items())


def test_jax_file_loads_to_the_jax_tree_and_config(tmp_path, jax_packed):
    jax_save(tmp_path, jax_packed, TINY_TEST, bits=2, group_size=64)
    jtree, jcfg = jax_load(tmp_path)
    tree, cfg = load_packed_checkpoint(tmp_path, device="cpu")
    assert cfg == torch_cfg(jcfg)
    _assert_trees_equal(tree, params_from_numpy(to_numpy_tree(jtree), "cpu"))


def test_c4_full_config_reloads_falcon_as_itself_in_both_loaders(tmp_path):
    """The port's file carries every field: the JAX package's loader reads a
    packed Falcon (biases, MQA, parallel block, LayerNorm) back as Falcon,
    which its own 15-field file cannot."""
    jcfg = dataclasses.replace(JaxConfig.from_hf_config(FALCON_HF), dtype="float32")
    cfg = torch_cfg(jcfg)
    dense = t_init(cfg, seed=0, dtype=torch.float32, device="cpu")
    packed = pack_model(dense, cfg, bits=4, group_size=64)
    save_packed_checkpoint(tmp_path / "port", packed, cfg, bits=4, group_size=64)
    meta = json.loads((tmp_path / "port" / "quant_config.json").read_text())
    assert set(meta["config"]) == {f.name for f in dataclasses.fields(ModelConfig)}
    tree, cfg2 = load_packed_checkpoint(tmp_path / "port", device="cpu")
    assert cfg2 == cfg and cfg2.parallel_block and cfg2.norm_type == "layernorm"
    _assert_trees_equal(tree, packed)
    jtree, jcfg2 = jax_load(tmp_path / "port")
    assert jcfg2 == jcfg
    _assert_trees_equal(params_from_numpy(to_numpy_tree(jtree), "cpu"), packed)
    # the JAX package's own file drops the family flags (its C4 fault)
    jax_save(tmp_path / "jax", jtree, jcfg, bits=4, group_size=64)
    assert not jax_load(tmp_path / "jax")[1].parallel_block


def test_c4_tuples_come_back_as_tuples(tmp_path):
    """JSON has no tuples: sliding_layers (and the longrope tables) are
    lists in the file and tuples again in the loaded config."""
    cfg = dataclasses.replace(torch_cfg(JaxConfig.from_hf_config(GEMMA3_HF)), dtype="float32")
    assert isinstance(cfg.sliding_layers, tuple)
    packed = pack_model(t_init(cfg, seed=0, dtype=torch.float32, device="cpu"), cfg, bits=2,
                        group_size=64)
    save_packed_checkpoint(tmp_path, packed, cfg, bits=2, group_size=64)
    _, cfg2 = load_packed_checkpoint(tmp_path, device="cpu")
    assert cfg2 == cfg and isinstance(cfg2.sliding_layers, tuple)
    hash(cfg2)


def test_a8_ordered_tree_is_refused(tmp_path):
    from bitdistiller_tpu_torch.ops.quant_matmul import repack_linear_a8

    cfg = torch_cfg(TINY_TEST)
    packed = pack_model(t_init(cfg, seed=0, device="cpu"), cfg, bits=2, group_size=64)
    packed["layers"]["o"] = repack_linear_a8(packed["layers"]["o"])
    with pytest.raises(ValueError, match="A8"):
        save_packed_checkpoint(tmp_path, packed, cfg, bits=2, group_size=64)


# ---- the native packer ---------------------------------------------------------------


@pytest.mark.parametrize("bits,group", [(2, 128), (4, 128), (2, 64), (4, 32), (2, -1)])
def test_native_pack_is_bit_equal_to_the_torch_packer(bits, group):
    w = np.random.default_rng(bits * 100 + group).standard_normal((256, 96)).astype(np.float32)
    w[3, 5] = w[7, 5]  # ties inside a group
    qw, s, sz = native.quantize_pack_native(w, bits, group)
    ref = quantize_pack_linear(torch.from_numpy(w), bits, group)
    for got, want in ((qw, ref.qweight), (s, ref.scales), (sz, ref.szeros)):
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())


def test_native_unpack_round_trip_and_threads():
    w = np.random.default_rng(1).standard_normal((1024, 64)).astype(np.float32)
    qw, _, _ = native.quantize_pack_native(w, 2, 128)
    codes = native.unpack_native(qw, 1024, 2, 128)
    np.testing.assert_array_equal(codes, unpack_codes(torch.from_numpy(qw), 2, 128).numpy())
    one = native.quantize_pack_native(w, 2, 128, n_threads=1)
    four = native.quantize_pack_native(w, 2, 128, n_threads=4)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        native.quantize_pack_native(w[:100], 2, 128)


def test_pack_model_takes_the_native_packer_on_the_cpu(monkeypatch):
    """CPU weights go through the native packer, bit-equal to PyTorch's
    packer on every fused leaf and to the JAX package's pack_model."""
    cfg = torch_cfg(TINY_TEST)
    dense = t_init(cfg, seed=2, dtype=torch.float32, device="cpu")
    calls = []
    real = native.quantize_pack_native
    monkeypatch.setattr(native, "quantize_pack_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    auto = pack_model(dense, cfg, bits=2, group_size=64)
    assert len(calls) == 4 * cfg.num_layers  # qkv, o, gate_up, down a layer
    for fused, parts in (("qkv", ("q", "k", "v")), ("gate_up", ("gate", "up")), ("o", ("o",)),
                         ("down", ("down",))):
        w = torch.cat([dense["layers"][p]["w"] for p in parts], dim=-1)
        for i in range(cfg.num_layers):
            ref = quantize_pack_linear(w[i], 2, 64)
            got = auto["layers"][fused]
            for f in ("qweight", "scales", "szeros", "combo"):
                assert torch.equal(getattr(got, f)[i], getattr(ref, f)), (fused, i, f)
    jtree = jax_pack(jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), dense),
                     TINY_TEST, bits=2, group_size=64)
    _assert_trees_equal(auto, params_from_numpy(to_numpy_tree(jtree), "cpu"))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "packlib.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native packer failed") as e:
        native.quantize_pack_native(np.zeros((128, 8), np.float32), 2, 128)
    assert "packlib.cpp" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))
