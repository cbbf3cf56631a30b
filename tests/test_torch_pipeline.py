"""The port's `run_training` against the JAX package's on the same injected
TINY_TEST model (f32) and the same teacher data, read through a byte-level
fake tokenizer: the same per-step losses and grad norms (metrics.jsonl,
logging every micro-step), stepwise and fused. Save, restore and resume
reproduce an uninterrupted run. The pinned C4 cadence: logging, saving and
eval count micro-steps, and a fused run checks them only when a cycle
completes (both packages log at micro-steps 2, 4, ...).

Tolerance: losses within 1e-4 relative and grad norms within 1e-3 (f32 in
both; Adam amplifies last-bit gradient differences near eps,
tests/test_torch_trainer.py). The learning rate is 1e-4: at 1e-3 those
differences (a few % of a learning rate per step) let a master weight cross
a rounding boundary of the int2 grid now and then, and the two runs drift
apart slowly (measured: equal to 1e-7 for two steps, 0.4% apart after 11
micro-steps). The resumed run equals the uninterrupted one exactly (the
same process, the same operations)."""

import dataclasses
import json
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bitdistiller_tpu.models import TINY_TEST as JT
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.train.pipeline import run_training as jax_run
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.train.pipeline import run_training
from torch_port_util import to_numpy_tree, torch_cfg

JCFG = dataclasses.replace(JT, dtype="float32")


class FakeTok:
    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s][:96]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    path = d / "teacher.jsonl"
    with open(path, "w") as f:
        for i in range(24):
            f.write(json.dumps([[f"prompt number {i} " * (1 + i % 3), f"reply text {i}"]]) + "\n")
    return jinit(JCFG, jax.random.key(0), dtype=jnp.float32), str(path), d


def _args(data, out, **kw):
    base = dict(
        model_name_or_path="unused", data_path=data, output_dir=str(out), bits=2,
        q_group_size=64, quant_type="int2-asym", clip=None, train_kd=True,
        kd_loss_type="cakld", cakld_steps=2, learning_rate=1e-4, num_train_epochs=1,
        per_device_train_batch_size=2, gradient_accumulation_steps=2, model_max_length=64,
        max_train_samples=None, lr_scheduler_type="constant", warmup_ratio=0.0,
        save_steps=0, eval_steps=0, logging_steps=1, seed=0, dp=None, tp=1, resume=False,
        param_dtype="float32", device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _metrics(out):
    return [json.loads(line) for line in open(out / "metrics.jsonl")]


def _port(params, args):
    return run_training(args, tokenizer=FakeTok(),
                        model=(params_from_numpy(to_numpy_tree(params), "cpu"), torch_cfg(JCFG)))


@pytest.mark.parametrize("fused", [False, True])
def test_run_training_matches_jax(setup, fused):
    params, data, d = setup
    jout, tout = d / f"jax_{fused}", d / f"port_{fused}"
    jax_run(_args(data, jout, fused_accum=fused), tokenizer=FakeTok(), model=(params, JCFG))
    summary = _port(params, _args(data, tout, fused_accum=fused))
    jm, tm = _metrics(jout), _metrics(tout)
    assert [m["step"] for m in tm] == [m["step"] for m in jm]
    assert [m["step"] for m in tm] == (list(range(2, 12, 2)) if fused else list(range(1, 12)))
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in tm], [m["grad_norm"] for m in jm],
                               rtol=1e-3)
    assert summary["steps"] == 11 and summary["state"].step == (5 if fused else 11)


def test_save_restore_resume_reproduces_the_run(setup):
    params, data, d = setup
    full = d / "full"
    _port(params, _args(data, full, save_steps=4))
    resumed = d / "resumed"
    resumed.mkdir()
    shutil.copytree(full / "step_4", resumed / "step_4")
    _port(params, _args(data, resumed, resume=True))
    fm, rm = _metrics(full), _metrics(resumed)
    assert [m["step"] for m in rm] == list(range(5, 12))
    assert [m["loss"] for m in rm] == [m["loss"] for m in fm[4:]]
    assert [m["grad_norm"] for m in rm] == [m["grad_norm"] for m in fm[4:]]


def test_run_training_without_a_model_names_a5(setup):
    _, data, d = setup
    with pytest.raises(NotImplementedError, match="A5"):
        run_training(_args(data, d / "none"), tokenizer=FakeTok())
