"""The port restates ModelConfig: same fields, same defaults, same presets."""

import dataclasses

import pytest

from bitdistiller_tpu.models import config as jax_config
from bitdistiller_tpu_torch.models import config as torch_config


def test_model_config_fields_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(jax_config.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(torch_config.ModelConfig)]
    assert tf == jf


@pytest.mark.parametrize("name", ["TINY_TEST", "TINYLLAMA_1B", "LLAMA2_7B", "FALCON_7B",
                                  "MPT_7B"])
def test_presets_field_equal(name):
    j = getattr(jax_config, name)
    t = getattr(torch_config, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.actual_head_dim, t.q_size, t.kv_size) == (j.actual_head_dim, j.q_size, j.kv_size)
