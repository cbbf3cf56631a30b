"""The port's `utils/debug.py` and `utils/profiling.py` against the JAX
package's: `assert_tree_finite` raises JAX's message (every non-finite
leaf by its keystr path, with its count) on the same trees; under
BITDISTILLER_DEBUG=1 `run_training` takes the checked step, and a NaN in a
leaf of the model raises that message; `tap_check` prints what JAX's
prints; the trace writes a torch.profiler file; StepTimer and autotune
keep JAX's interface."""

import dataclasses
import json
import types
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.utils import debug as jdebug
from bitdistiller_tpu_torch.models import TINY_TEST, init_params
from bitdistiller_tpu_torch.train.pipeline import run_training
from bitdistiller_tpu_torch.utils import debug as tdebug
from bitdistiller_tpu_torch.utils import profiling as tprof
from test_torch_dp_worker import ByteTok


class Pair(NamedTuple):
    mu: object
    nu: object


def _trees():
    """The same tree twice (JAX arrays, torch tensors): NaN, inf and -inf in
    some leaves, an integer leaf, a named tuple and a list."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    a[0, 1] = np.nan
    a[2, 2] = np.inf
    b[4] = -np.inf
    c = rng.standard_normal((2, 2)).astype(np.float32)
    ints = np.arange(4, dtype=np.int32)

    def tree(conv):
        return {"layers": {"q": {"w": conv(a)}, "norm": conv(c)}, "embed": conv(b),
                "state": Pair(mu=conv(c), nu=[conv(b), conv(ints)])}

    return tree(jnp.asarray), tree(torch.from_numpy)


def test_assert_tree_finite_message_equals_jax():
    jt, tt = _trees()
    with pytest.raises(ValueError) as want:
        jdebug.assert_tree_finite(jt, "params")
    with pytest.raises(ValueError) as got:
        tdebug.assert_tree_finite(tt, "params")
    assert str(got.value) == str(want.value)
    assert "['layers']['q']['w']: 2 non-finite" in str(got.value)
    clean = {"x": torch.ones(3), "n": torch.arange(3)}
    tdebug.assert_tree_finite(clean)
    jdebug.assert_tree_finite({"x": jnp.ones(3), "n": jnp.arange(3)})


def test_tap_check_prints_as_jax(capsys, monkeypatch):
    x = torch.tensor([1.0, -3.0, float("nan")])
    monkeypatch.delenv("BITDISTILLER_DEBUG", raising=False)
    assert tdebug.tap_check(x, "h") is x
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("BITDISTILLER_DEBUG", "1")
    assert tdebug.tap_check(x[:2], "h") is not None
    assert capsys.readouterr().out == "[debug] h finite=True max|x|=3.000e+00\n"


def _train_args(tmp_path, **kw):
    tmp_path.mkdir(parents=True, exist_ok=True)
    with open(tmp_path / "data.jsonl", "w") as f:
        for i in range(8):
            f.write(json.dumps([[f"prompt {i} " * 3, f"reply {i}"]]) + "\n")
    base = dict(model_name_or_path="unused", data_path=str(tmp_path / "data.jsonl"),
                output_dir=str(tmp_path / "out"), bits=2, q_group_size=64,
                quant_type="int2-asym", clip=None, train_kd=True, kd_loss_type="cakld",
                cakld_steps=1, learning_rate=1e-4, num_train_epochs=1,
                per_device_train_batch_size=2, gradient_accumulation_steps=2,
                model_max_length=48, max_train_samples=None, lr_scheduler_type="constant",
                warmup_ratio=0.0, save_steps=0, eval_steps=0, logging_steps=1, seed=0, dp=None,
                tp=1, resume=False, param_dtype="bfloat16", device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("fused", [False, True])
def test_debug_run_raises_jax_message_on_a_nan_leaf(tmp_path, monkeypatch, fused):
    """BITDISTILLER_DEBUG=1: the checked step. A clean model trains as
    without it (the same losses); a NaN in one leaf raises the message that
    names it."""
    cfg = dataclasses.replace(TINY_TEST, dtype="float32")
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    monkeypatch.delenv("BITDISTILLER_DEBUG", raising=False)
    plain = run_training(_train_args(tmp_path / "a", fused_accum=fused), tokenizer=ByteTok(),
                         model=(params, cfg))
    monkeypatch.setenv("BITDISTILLER_DEBUG", "1")
    debug = run_training(_train_args(tmp_path / "b", fused_accum=fused), tokenizer=ByteTok(),
                         model=(params, cfg))
    assert debug["final_loss"] == plain["final_loss"]
    bad = {k: v for k, v in params.items()}
    bad["layers"] = dict(params["layers"], k={"w": params["layers"]["k"]["w"].clone()})
    bad["layers"]["k"]["w"][1, 3, 5] = float("nan")
    with pytest.raises(ValueError, match=r"NaN or Inf detected in step inputs:") as err:
        run_training(_train_args(tmp_path / "c", fused_accum=fused), tokenizer=ByteTok(),
                     model=(bad, cfg))
    assert ".params['layers']['k']['w']: 1 non-finite" in str(err.value)


def test_trace_writes_a_profile(tmp_path):
    with tprof.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = list((tmp_path / "prof").iterdir())
    assert files and all(f.stat().st_size > 0 for f in files)


def test_step_timer_and_autotune():
    timer = tprof.StepTimer()
    for _ in range(3):
        with timer.step([torch.ones(2)]):
            torch.ones(128, 128) @ torch.ones(128, 128)
    assert len(timer.times) == 3 and timer.mean_ms > 0
    assert timer.time_fn(lambda x: x * 2, torch.ones(8), warmup=1, iters=3) > 0

    def build(n):
        if n == 0:
            raise ValueError("a config that fails to build is skipped")
        return lambda x: torch.ones(n, n) @ torch.ones(n, n)

    best, results = tprof.autotune(build, [0, 4, 512], None, warmup=1, iters=3)
    assert best == 4 and set(results) == {"4", "512"}
