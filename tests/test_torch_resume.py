"""Resume across optimizer formats on the port's own checkpoints (the JAX
package's tests/test_pipeline.py:329-381, `_restore_cross_format`, ported):
a stepwise `MasterAccumState` checkpoint (bf16 latents, grad_accum > 1)
restores into the fused cycle's `MasterWeightsState` (master and Adam's
state carried, the accumulator dropped at the cycle boundary) and back
(the accumulator empty, count 0); a stepwise `MultiStepsState` checkpoint
(f32 latents) into the fused cycle's plain `AdamWState` and back. From
either side one more cycle of the same gradients gives the same master and
moments bit for bit (the same operations on the same values). The
resumed latents are the checkpoint's."""

import dataclasses

import pytest
import torch

from bitdistiller_tpu_torch.models import TINY_TEST, init_params
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as tr

CFG = dataclasses.replace(TINY_TEST, dtype="float32")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0, dtype=torch.float32, device="cpu")


def _grads(params, scale):
    return tr.tree_map(lambda x: torch.full_like(x, scale, dtype=torch.float32), params)


def _cycle(tc, state, scale):
    """One optimizer cycle of constant gradients: grad_accum updates of the
    stepwise optimizer, or one of the fused one (the cycle's mean)."""
    opt = tr.make_optimizer(tc)
    opt_params = state.params
    steps = 1 if tc.fused_accum else tc.grad_accum
    upd = None
    for _ in range(steps):
        upd, state.opt_state = opt.update(_grads(state.params, scale), state.opt_state,
                                          opt_params)
    state.params = tr._new_params(state.params, state.opt_state, upd, opt_params)
    return state


def _adam(opt_state):
    """The AdamWState inside any of the formats."""
    while not isinstance(opt_state, tr.AdamWState):
        opt_state = opt_state.inner
    return opt_state


def _equal_trees(a, b):
    ia, ib = tr.tree_items(a), tr.tree_items(b)
    assert [p for p, _ in ia] == [p for p, _ in ib]
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(ia, ib))


@pytest.mark.parametrize("dtype,stepwise_type", [("bfloat16", tr.MasterAccumState),
                                                 ("float32", tr.MultiStepsState)])
def test_stepwise_checkpoint_resumes_into_fused(tmp_path, params, dtype, stepwise_type):
    kw = dict(total_steps=8, grad_accum=4, param_dtype=dtype, learning_rate=1e-3)
    tc_sw, tc_f = tr.TrainConfig(**kw), tr.TrainConfig(**kw, fused_accum=True)
    state_sw = _cycle(tc_sw, tr.init_train_state(params, tc_sw), 0.5)
    assert isinstance(state_sw.opt_state, stepwise_type)
    assert _adam(state_sw.opt_state).count == 1
    path = pipeline.save_checkpoint(str(tmp_path / "sw"), 4, state_sw)

    state_f = pipeline.restore_checkpoint(path, tr.init_train_state(params, tc_f))
    assert type(state_f.opt_state) is (tr.MasterWeightsState if dtype == "bfloat16"
                                       else tr.AdamWState)
    assert _equal_trees(tr.master_params(state_f), tr.master_params(state_sw))
    assert _equal_trees(state_f.params, state_sw.params)
    a_sw, a_f = _adam(state_sw.opt_state), _adam(state_f.opt_state)
    assert (a_f.count, a_f.sched_count) == (a_sw.count, a_sw.sched_count) == (1, 1)
    assert _equal_trees(a_f.mu, a_sw.mu) and _equal_trees(a_f.nu, a_sw.nu)
    assert state_f.step == state_sw.step  # the checkpoint's (micro-steps), as JAX keeps it

    # the next cycle of the same gradients: the same master either way
    cont_sw = _cycle(tc_sw, state_sw, -0.25)
    cont_f = _cycle(tc_f, state_f, -0.25)
    assert _equal_trees(tr.master_params(cont_f), tr.master_params(cont_sw))
    assert _equal_trees(_adam(cont_f.opt_state).nu, _adam(cont_sw.opt_state).nu)

    # and back: the fused checkpoint into the stepwise format
    path2 = pipeline.save_checkpoint(str(tmp_path / "fused"), 8, cont_f)
    back = pipeline.restore_checkpoint(path2, tr.init_train_state(params, tc_sw))
    assert isinstance(back.opt_state, stepwise_type)
    assert _equal_trees(tr.master_params(back), tr.master_params(cont_f))
    assert _adam(back.opt_state).count == 2
    if stepwise_type is tr.MasterAccumState:
        assert back.opt_state.count == 0
        assert all(not x.any() for x in tr.tree_leaves(back.opt_state.acc))
    else:
        assert (back.opt_state.mini_step, back.opt_state.gradient_step) == (0, 2)
        assert all(not x.any() for x in tr.tree_leaves(back.opt_state.acc_grads))
    cont_back = _cycle(tc_sw, back, 0.125)
    cont_f2 = _cycle(tc_f, cont_f, 0.125)
    assert _equal_trees(tr.master_params(cont_back), tr.master_params(cont_f2))


def test_same_format_restores_unchanged(tmp_path, params, caplog):
    """A checkpoint of the template's own format loads as written, with no
    migration logged."""
    tc = tr.TrainConfig(grad_accum=2, param_dtype="bfloat16")
    state = _cycle(tc, tr.init_train_state(params, tc), 0.5)
    path = pipeline.save_checkpoint(str(tmp_path), 2, state)
    with caplog.at_level("WARNING"):
        got = pipeline.restore_checkpoint(path, tr.init_train_state(params, tc))
    assert "migrated" not in caplog.text
    assert _equal_trees(got.opt_state.master, state.opt_state.master)
    assert _equal_trees(got.params, state.params)
