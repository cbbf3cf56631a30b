"""The port's HF checkpoint load and save (`models/hf_import.py`) against the
JAX package's on the same files.

Every family branch of the JAX loader (tests/hf_checkpoints.py builds the
dirs: `transformers` models where it has the class, key dicts elsewhere):
Llama tied and untied, Qwen2's biases, Qwen3's q/k norms, Phi-3's fused
projections, Gemma-2/3's sandwich norms, Falcon MQA, RW-MHA and the new
architecture, MPT with and without LayerNorm biases, OPT under both
prefixes, Bloom, `.bin` shards and an f16 source. Each loads bit-equal to
the JAX package's tree at f32 and at bf16 (the casts round to nearest even
in both), with an equal config; a loaded Llama runs the port's forward to
the JAX forward's logits within tests/test_torch_model.py's f32 tolerance
(1e-4). The port's save writes the JAX save's file byte for byte, and its
config.json equal.

The JAX save's faults, kept (ROADMAP C4): it cannot write a LayerNorm tree
(the JAX package raises SafetensorError, the port a ValueError naming the
family, before writing anything), and it writes every tree as a Llama, so a
Qwen3 tree reloads without its q/k norms in both packages."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import llama as jllama
from bitdistiller_tpu.models.hf_import import load_hf_checkpoint as jload
from bitdistiller_tpu.models.hf_import import save_hf_checkpoint as jsave
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint as tload
from bitdistiller_tpu_torch.models.hf_import import save_hf_checkpoint as tsave
from bitdistiller_tpu_torch.train.trainer import tree_items
import hf_checkpoints
from torch_port_util import t2n, to_numpy_tree

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hf"))
    return lambda name: hf_checkpoints.build(name, root)


def _bits(x) -> np.ndarray:
    """The f32 bits of a leaf (bf16 and f16 upcast exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy().view(np.uint32)
    return np.asarray(x, np.float32).view(np.uint32)


def assert_trees_bit_equal(jax_tree, port_tree, dtype=None):
    want = dict(tree_items(to_numpy_tree(jax_tree)))
    got = dict(tree_items(port_tree))
    assert sorted(got) == sorted(want)
    for path in want:
        if dtype is not None:
            assert got[path].dtype == dtype, path
        assert tuple(got[path].shape) == np.shape(want[path]), path
        np.testing.assert_array_equal(_bits(got[path]), _bits(want[path]), err_msg=str(path))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", hf_checkpoints.CASES)
def test_load_bit_equal_to_jax(ckpt, case, dtype):
    jdt, tdt = DTYPES[dtype]
    path = ckpt(case)
    jp, jcfg = jload(path, dtype=jdt)
    tp, tcfg = tload(path, dtype=tdt, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_trees_bit_equal(jp, tp, tdt)


def test_load_takes_a_given_config(ckpt):
    """cfg=... overrides config.json (here: f32 compute), as the JAX loader."""
    path = ckpt("llama_untied")
    _, cfg = tload(path, device="cpu")
    override = dataclasses.replace(cfg, dtype="float32")
    _, got = tload(path, cfg=override, device="cpu")
    assert got is override


def test_loaded_llama_forward_matches_jax(ckpt):
    path = ckpt("llama_untied")
    jp, jcfg = jload(path, dtype=jnp.float32)
    tp, tcfg = tload(path, dtype=torch.float32, device="cpu")
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    tokens = np.random.default_rng(0).integers(0, 128, (2, 9)).astype(np.int32)
    want, _ = jllama.forward(jp, jcfg, jnp.asarray(tokens))
    got, _ = tllama.forward(tp, tcfg, torch.as_tensor(tokens, dtype=torch.int64))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


SAVE_CASES = ["llama_untied", "llama_tied", "qwen2", "qwen3", "phi3", "gemma2", "gemma3"]


@pytest.mark.parametrize("save_dtype", [None, "f16"])
@pytest.mark.parametrize("case", SAVE_CASES)
def test_save_writes_the_jax_file(ckpt, tmp_path, case, save_dtype):
    """The same model.safetensors byte for byte (names, shapes, dtypes,
    bytes, layout) and the same config.json, for a loaded f32 tree, cast on
    save or not."""
    jp, jcfg = jload(ckpt(case), dtype=jnp.float32)
    tp, tcfg = tload(ckpt(case), dtype=torch.float32, device="cpu")
    jsave(jp, jcfg, str(tmp_path / "jax"), dtype=None if save_dtype is None else np.float16)
    tsave(tp, tcfg, str(tmp_path / "port"), dtype=None if save_dtype is None else torch.float16)
    for name in ("model.safetensors", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_bf16_tree_saves_as_jax(ckpt, tmp_path):
    jp, jcfg = jload(ckpt("qwen2"), dtype=jnp.bfloat16)
    tp, tcfg = tload(ckpt("qwen2"), dtype=torch.bfloat16, device="cpu")
    jsave(jp, jcfg, str(tmp_path / "jax"))
    tsave(tp, tcfg, str(tmp_path / "port"))
    assert (tmp_path / "port" / "model.safetensors").read_bytes() == \
        (tmp_path / "jax" / "model.safetensors").read_bytes()


@pytest.mark.parametrize("case", ["llama_untied", "llama_tied", "qwen2", "gemma3"])
def test_save_load_round_trip_is_bit_equal(ckpt, tmp_path, case):
    tp, tcfg = tload(ckpt(case), dtype=torch.float32, device="cpu")
    tsave(tp, tcfg, str(tmp_path / "out"))
    back, _ = tload(str(tmp_path / "out"), cfg=tcfg, dtype=torch.float32, device="cpu")
    got, want = dict(tree_items(back)), dict(tree_items(tp))
    assert sorted(got) == sorted(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path


@pytest.mark.parametrize("case", ["falcon_mqa", "mpt", "bloom", "opt"])
def test_layernorm_trees_do_not_save_in_either_package(ckpt, tmp_path, case):
    """C4, kept: the JAX save cannot write a {"w", "b"} norm (an object array:
    SafetensorError); the port raises a ValueError that names the family, and
    writes nothing."""
    from safetensors import SafetensorError

    jp, jcfg = jload(ckpt(case), dtype=jnp.float32)
    tp, tcfg = tload(ckpt(case), dtype=torch.float32, device="cpu")
    with pytest.raises(SafetensorError):
        jsave(jp, jcfg, str(tmp_path / "jax"))
    with pytest.raises(ValueError, match=tcfg.model_type):
        tsave(tp, tcfg, str(tmp_path / "port"))
    assert not (tmp_path / "port").exists()


def test_qwen3_save_reload_drops_qk_norms_in_both(ckpt, tmp_path):
    """C4, kept: the save writes a Llama config.json, so the q/k norms it
    saved are not read back (qk_norm=False) by either package."""
    jp, jcfg = jload(ckpt("qwen3"), dtype=jnp.float32)
    tp, tcfg = tload(ckpt("qwen3"), dtype=torch.float32, device="cpu")
    assert tcfg.qk_norm and "q_norm" in tp["layers"]
    jsave(jp, jcfg, str(tmp_path / "jax"))
    tsave(tp, tcfg, str(tmp_path / "port"))
    conf = json.loads((tmp_path / "port" / "config.json").read_text())
    assert conf["model_type"] == "llama" and len(conf) == 11
    jback, jcfg2 = jload(str(tmp_path / "jax"), dtype=jnp.float32)
    tback, tcfg2 = tload(str(tmp_path / "port"), dtype=torch.float32, device="cpu")
    assert not jcfg2.qk_norm and not tcfg2.qk_norm
    assert "q_norm" not in jback["layers"] and "q_norm" not in tback["layers"]
    assert_trees_bit_equal(jback, tback)
