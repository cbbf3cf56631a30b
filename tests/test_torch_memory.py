"""The port's parameter count and KD memory estimate (`train/memory.py`)
against the JAX package's, integer for integer and field for field, on
every preset of the port's `models/config.py` and on the tiny family
configs of tests/test_torch_families.py, which cover every `ModelConfig`
flag (ROADMAP C7: the count once summed a Llama tree for every family).
The count sums `models/llama.py:param_shapes`, the table `init_params`
fills, so the two cannot drift apart: a test holds them to each other."""

import dataclasses
import math

import pytest
import torch

from bitdistiller_tpu.models import config as jconfig
from bitdistiller_tpu.train import memory as jmem
from bitdistiller_tpu.train.trainer import TrainConfig as JTC
from bitdistiller_tpu_torch.models import config as tconfig
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.train import memory as tmem
from bitdistiller_tpu_torch.train.trainer import TrainConfig as TTC
from bitdistiller_tpu_torch.train.trainer import tree_items
from test_torch_families import HF, MODELS, _tcfg

PRESETS = ["FALCON_7B", "LLAMA2_7B", "MPT_7B", "TINYLLAMA_1B", "TINY_TEST"]
# the families' tiny configs, and one a from_hf_config branch
FAMILIES = {name: (cfg, lambda name=name: _tcfg(name)) for name, cfg in MODELS.items()}
FAMILIES.update({f"hf_{name}": (jconfig.ModelConfig.from_hf_config(HF[name]),
                                lambda name=name: tconfig.ModelConfig.from_hf_config(HF[name]))
                 for name in HF})
TRAIN_CONFIGS = [dict(), dict(param_dtype="float32"), dict(grad_accum=4),
                 dict(kd_loss_type="jsd"), dict(train_kd=False)]


def _configs(name):
    """(the JAX package's config, the port's)."""
    if name in PRESETS:
        return getattr(jconfig, name), getattr(tconfig, name)
    jcfg, tcfg = FAMILIES[name]
    return jcfg, tcfg()


def test_presets_are_the_jax_presets():
    assert [n for n in dir(tconfig) if n.isupper()] == PRESETS
    for name in PRESETS:
        jcfg, tcfg = _configs(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name


@pytest.mark.parametrize("name", PRESETS + sorted(FAMILIES))
def test_param_count_equals_jax(name):
    jcfg, tcfg = _configs(name)
    assert tmem.param_count(tcfg) == jmem.param_count(jcfg)


def test_the_repaired_counts():
    """The two presets whose counts were wrong before the repair."""
    assert tmem.param_count(tconfig.FALCON_7B) == 6_921_720_704
    assert tmem.param_count(tconfig.MPT_7B) == 6_649_552_896
    assert tmem.param_count(tconfig.LLAMA2_7B) == 6_738_415_616


@pytest.mark.parametrize("kw", TRAIN_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values()))
                         or "default")
@pytest.mark.parametrize("name", PRESETS + ["falcon", "falcon40b", "mpt", "gemma", "qwen3",
                                            "opt", "bloom", "phi3"])
def test_memory_estimate_equals_jax(name, kw):
    jcfg, tcfg = _configs(name)
    want = jmem.kd_train_memory_estimate(jcfg, JTC(**kw), batch=2, seq=1024)
    got = tmem.kd_train_memory_estimate(tcfg, TTC(**kw), batch=2, seq=1024)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_params_fills_the_shape_table(name):
    """init_params makes exactly the leaves of param_shapes, each with its
    shape, and param_count is their size."""
    tcfg = _tcfg(name)
    shapes = tllama.param_shapes(tcfg)
    made = dict(tree_items(tllama.init_params(tcfg, seed=0, dtype=torch.float32,
                                              device="cpu")))
    assert sorted(made) == sorted(shapes)
    for path, t in made.items():
        assert tuple(t.shape) == shapes[path], path
    assert tmem.param_count(tcfg) == sum(math.prod(s) for s in shapes.values())
