"""The port's `run_training` against the JAX package's on the same injected
TINY_TEST model (f32) and the same teacher data, read through a byte-level
fake tokenizer: the same per-step losses and grad norms (metrics.jsonl,
logging every micro-step), stepwise and fused. Save, restore and resume
reproduce an uninterrupted run. The pinned C4 cadence: logging, saving and
eval count micro-steps, and a fused run checks them only when a cycle
completes (both packages log at micro-steps 2, 4, ...). Both write the same
final HF save (names, shapes, dtypes, config.json; values within the losses'
tolerance). Without an injected model the port loads the HF dir itself, to
the same losses bit for bit, and its final save reloads as the f32 master
bit for bit.

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
import torch
from safetensors.numpy import load_file

from bitdistiller_tpu.models import TINY_TEST as JT
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.train.pipeline import run_training as jax_run
from bitdistiller_tpu_torch.models import safetensors_io
from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint, save_hf_checkpoint
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.train.pipeline import run_training
from bitdistiller_tpu_torch.train.trainer import master_params, tree_items
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
    # the final consolidated save: the JAX save's names, shapes, dtypes and
    # config.json, its values within the losses' tolerance (same weights,
    # trained apart by the last-bit gradient differences above)
    assert (tout / "config.json").read_bytes() == (jout / "config.json").read_bytes()
    want = load_file(str(jout / "model.safetensors"))
    got = safetensors_io.read(str(tout / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and w.dtype == np.float32, name
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4, atol=1e-4, err_msg=name)


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


def _hf_dir(params, path):
    """The JAX params (TINY_TEST, f32) as an HF checkpoint dir, written by the
    port's save; (the dir, the config its config.json gives)."""
    tp = params_from_numpy(to_numpy_tree(params), "cpu")
    save_hf_checkpoint(tp, torch_cfg(JCFG), str(path))
    return str(path), load_hf_checkpoint(str(path), device="cpu")[1]


@pytest.mark.parametrize("fused", [False, True])
def test_run_training_loads_the_model_dir_itself(setup, fused):
    """model=None loads args.model_name_or_path in f32: the same losses and
    grad norms, bit for bit, as the run handed the same tree and config."""
    params, data, d = setup
    src, cfg = _hf_dir(params, d / f"hf_src_{fused}")
    loaded = d / f"loaded_{fused}"
    injected = d / f"injected_{fused}"
    run_training(_args(data, loaded, model_name_or_path=src, fused_accum=fused),
                 tokenizer=FakeTok())
    run_training(_args(data, injected, fused_accum=fused), tokenizer=FakeTok(),
                 model=(params_from_numpy(to_numpy_tree(params), "cpu"), cfg))
    lm, im = _metrics(loaded), _metrics(injected)
    assert len(lm) == (5 if fused else 11)
    assert [(m["loss"], m["grad_norm"]) for m in lm] == [(m["loss"], m["grad_norm"]) for m in im]


def test_final_save_round_trips_the_master(setup):
    """The final HF save holds the f32 master bit for bit, bf16 latents
    included (the master is the optimizer's f32 copy)."""
    params, data, d = setup
    out = d / "final_bf16"
    summary = _port(params, _args(data, out, param_dtype="bfloat16"))
    master = dict(tree_items(master_params(summary["state"])))
    back = dict(tree_items(load_hf_checkpoint(str(out), cfg=torch_cfg(JCFG),
                                              dtype=torch.float32, device="cpu")[0]))
    assert sorted(back) == sorted(master)
    for path, t in master.items():
        assert t.dtype == torch.float32 and torch.equal(back[path], t), path
