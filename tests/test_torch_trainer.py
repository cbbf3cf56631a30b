"""The port's KD-QAT trainer against the JAX package's, from the same state
(JAX's init_train_state handed over through `train_state_from_numpy`): one
and two steps of `make_train_step` (CAKLD KD and plain CE; grad_accum 1 and
2; f32 and bf16 latents) and of `make_fused_train_step`, comparing loss,
grad_norm, the latents, the f32 master and the Adam moments. Also the
schedules, `estimate_cakld_beta` and the pinned C4 choice: `state.step`
counts micro-steps in the stepwise step and optimizer cycles in the fused
one, in both packages.

Tolerances. f32 latents: loss within 1e-5 relative, grad_norm 1e-4, the
moments within 1e-4 of each leaf's max (the same f32 operations, reduced in
another order; measured: 1e-7, 1e-7, 2e-5), the latents within 5% of a
learning rate (Adam's update g / (|g| + eps) turns a 1e-6 relative
difference of a gradient near eps = 1e-8 into a few % of a learning rate;
measured 3e-5 = 3% at lr 1e-3). bf16 latents: the quantizer runs in bf16,
where XLA on the CPU keeps f32 between operations and PyTorch rounds each
one, so a few quantized weights differ by one step
(tests/test_torch_quant_core.py) and move the gradients of their columns:
loss within 2e-3 relative, grad_norm 2e-2, the moments within 0.15 of each
leaf's max (measured 0.095 after two steps), the master within 4.5 learning
rates (Adam's first steps move a weight by about one learning rate in the
direction of its gradient's sign: two steps whose sign differs are 4 lr
apart) and the latents within that plus one bf16 ulp (2^-7 relative)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST as JT
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.train import trainer as jtr
from bitdistiller_tpu_torch.models.quantized import params_from_numpy, train_state_from_numpy
from bitdistiller_tpu_torch.train import trainer as ttr
from torch_port_util import to_numpy_tree, torch_cfg

JCFG = dataclasses.replace(JT, dtype="float32")
TCFG = torch_cfg(JCFG)
LR = 1e-3


def _batches(n, seed=0, b=2, s=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(3, JCFG.vocab_size, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.int32)
        mask[1, s - 5:] = 0
        labels = np.where(mask == 1, ids, -100).astype(np.int32)
        out.append({"input_ids": ids, "labels": labels, "attention_mask": mask})
    return out


@pytest.fixture(scope="module")
def model():
    return jinit(JCFG, jax.random.key(0), dtype=jnp.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _find(node, field):
    """The first NamedTuple below node that has `field`."""
    stack = [node]
    while stack:
        n = stack.pop()
        if field in getattr(n, "_fields", ()):
            return n
        if isinstance(n, (tuple, list)):
            stack.extend(reversed(n))
    return None


def _flat_t(tree):
    return {p: x.detach().to(torch.float32).numpy() for p, x in ttr.tree_items(tree)}


def _flat_j(tree):
    return {p: np.asarray(x, np.float32) for p, x in ttr.tree_items(_np(tree))}


def _close_trees(t, j, *, rel_max=None, atol=None, rtol=0.0, what=""):
    tf, jf = _flat_t(t), _flat_j(j)
    assert tf.keys() == jf.keys(), what
    for p in tf:
        if rel_max is not None:
            tol = rel_max * np.abs(jf[p]).max() + 1e-12
        else:
            tol = atol + rtol * np.abs(jf[p])
        assert np.all(np.abs(tf[p] - jf[p]) <= tol), (what, p, np.abs(tf[p] - jf[p]).max())


VARIANTS = {  # name: (train_kd, grad_accum, param_dtype, fused)
    "kd_ga1_f32": (True, 1, "float32", False),
    "kd_ga2_bf16": (True, 2, "bfloat16", False),
    "ce_ga1_bf16": (False, 1, "bfloat16", False),
    "ce_ga2_f32": (False, 2, "float32", False),
    "kd_ga2_f32": (True, 2, "float32", False),
    "fused_kd_ga2_bf16": (True, 2, "bfloat16", True),
    "fused_ce_ga2_f32": (False, 2, "float32", True),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_steps_match_jax(model, name):
    kd, ga, pdt, fused = VARIANTS[name]
    kw = dict(q_group_size=64, learning_rate=LR, grad_accum=ga, param_dtype=pdt,
              fused_accum=fused, train_kd=kd, total_steps=10, weight_decay=0.01)
    jtc, ttc = jtr.TrainConfig(**kw), ttr.TrainConfig(**kw)
    jstate = jtr.init_train_state(model, jtc)
    tstate = train_state_from_numpy(_np(jstate.params), _np(jstate.opt_state),
                                    np.asarray(jstate.step), "cpu")
    teacher_j = model if kd else None
    teacher_t = params_from_numpy(to_numpy_tree(model), "cpu") if kd else None
    beta = 0.3
    if fused:
        jstep = jax.jit(jtr.make_fused_train_step(JCFG, jtc))
        tstep = ttr.make_fused_train_step(TCFG, ttc)
        calls = [_batches(ga, seed=c) for c in range(2)]
    else:
        jstep = jax.jit(jtr.make_train_step(JCFG, jtc))
        tstep = ttr.make_train_step(TCFG, ttc)
        calls = _batches(2 * ga)  # two optimizer cycles
    f32 = pdt == "float32"
    for call in calls:
        if fused:
            jb = {k: jnp.asarray(np.stack([b[k] for b in call])) for k in call[0]}
            tb = [ttr.to_device(b, "cpu") for b in call]
        else:
            jb = {k: jnp.asarray(v) for k, v in call.items()}
            tb = ttr.to_device(call, "cpu")
        jstate, jm = jstep(jstate, jb, jnp.asarray(beta), teacher_j)
        tstate, tm = tstep(tstate, tb, beta, teacher_t)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if f32 else 2e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4 if f32 else 2e-2)
        tight = dict(atol=5e-2 * LR, rtol=0.0) if f32 else dict(atol=4.5 * LR, rtol=0.0)
        # bf16 latents: the master's difference may round to one bf16 ulp more
        _close_trees(tstate.params, jstate.params, what="latents",
                     **(tight if f32 else dict(atol=4.5 * LR, rtol=2.0**-7)))
        jmaster = _find(jstate.opt_state, "master")
        if jmaster is not None:
            _close_trees(tstate.opt_state.master, jmaster.master, what="master", **tight)
        jadam = _find(jstate.opt_state, "mu")
        tadam = tstate.opt_state
        while not isinstance(tadam, ttr.AdamWState):
            tadam = tadam.inner
        assert tadam.count == int(jadam.count)
        for field in ("mu", "nu"):
            _close_trees(getattr(tadam, field), getattr(jadam, field),
                         rel_max=1e-4 if f32 else 0.15, what=field)
        # C4, pinned: the step counter counts calls (micro-steps stepwise, cycles fused)
        assert tstate.step == int(jstate.step)
    assert tstate.step == (2 if fused else 2 * ga)


@pytest.mark.parametrize("sched,warmup", [("constant", 0.0), ("constant", 0.3),
                                          ("cosine", 0.0), ("cosine", 0.2)])
def test_schedules_match_optax(sched, warmup):
    kw = dict(learning_rate=2e-5, lr_scheduler=sched, warmup_ratio=warmup, total_steps=12)
    js, ts = jtr.make_schedule(jtr.TrainConfig(**kw)), ttr.make_schedule(ttr.TrainConfig(**kw))
    for count in range(15):
        np.testing.assert_allclose(float(ts(count)), float(js(jnp.asarray(count, jnp.int32))),
                                   rtol=1e-6, atol=1e-12)


def test_estimate_cakld_beta_matches_jax(model):
    batches = _batches(2, seed=5)
    want = jtr.estimate_cakld_beta(model, JCFG, [{k: jnp.asarray(v) for k, v in b.items()}
                                                 for b in batches])
    tparams = params_from_numpy(to_numpy_tree(model), "cpu")
    got = ttr.estimate_cakld_beta(tparams, TCFG, [ttr.to_device(b, "cpu") for b in batches])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


MASTER_CASES = {  # name: (grad_accum, lr_scheduler, warmup_ratio, weight_decay)
    "master_ga1": (1, "constant", 0.0, 0.01),
    "master_ga1_cosine_warmup": (1, "cosine", 0.25, 0.0),
    "accum_ga2": (2, "constant", 0.0, 0.01),
    "accum_ga3_cosine_warmup": (3, "cosine", 0.25, 0.01),
}


def _jax_latents(new_opt, params):
    """The latents JAX's make_train_step derives after an update (trainer.py:
    the master rounded to the latent dtype; on cycle boundaries only for the
    accumulating wrapper)."""
    if isinstance(new_opt, jtr.MasterAccumState) and int(new_opt.count) != 0:
        return params
    return jax.tree_util.tree_map(lambda m, p: m.astype(p.dtype), new_opt.master, params)


@pytest.mark.parametrize("name", sorted(MASTER_CASES))
def test_f32_master_optimizers_match_jax_on_the_same_gradients(name):
    """WithF32Master and WithF32MasterAccum (clip + AdamW inside) against JAX's
    with_f32_master / with_f32_master_accum, fed the same bf16 gradients for
    three optimizer cycles, every micro-step compared: the f32 master, Adam's
    mu, nu and count, the accumulator and its count, and the bf16 latents.
    The gradients of cycle 2 have a global norm above max_grad_norm, so the
    clip runs. Tolerance: the master, mu, nu and the accumulator within 1e-6
    of each leaf's max (the same f32 operations, the global norm summed in
    another order, XLA's fusions rounding apart: measured 2 f32 ulps, about
    1e-7 of the leaf's max); the latents equal, as both round the same
    master. A master that missed an update is a learning rate (1e-3) off."""
    ga, sched, warmup, wd = MASTER_CASES[name]
    kw = dict(learning_rate=LR, grad_accum=ga, param_dtype="bfloat16", lr_scheduler=sched,
              warmup_ratio=warmup, weight_decay=wd, total_steps=8)
    jopt, topt = jtr.make_optimizer(jtr.TrainConfig(**kw)), ttr.make_optimizer(ttr.TrainConfig(**kw))
    want = jtr.MasterAccumState if ga > 1 else jtr.MasterWeightsState
    rng = np.random.default_rng(7)
    shapes = {"embed": (12, 16), "layers": {"wq": (2, 16, 16), "w_down": (2, 24, 16)},
              "norm": (16,)}
    init = jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32) * 0.05,
                                  shapes, is_leaf=lambda s: isinstance(s, tuple))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), init)
    tp = ttr.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), init)
    js, ts = jopt.init(jp), topt.init(tp)
    assert isinstance(js, want) and type(ts).__name__ == want.__name__
    for micro in range(3 * ga):
        big = 3.0 if micro // ga == 1 else 0.02  # cycle 2: global norm above 1, clipped
        g = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32)
                                   * big, init)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
        tg = ttr.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), g)
        _, js = jax.jit(jopt.update)(jg, js, jp)
        jp = _jax_latents(js, jp)
        tupd, ts = topt.update(tg, ts, tp)
        tp = ttr._new_params(tp, ts, tupd)
        what = f"{name} micro-step {micro}"
        _close_trees(ts.master, js.master, rel_max=1e-6, what=f"master, {what}")
        if ga > 1:
            assert ts.count == int(js.count) == (micro + 1) % ga, what
            _close_trees(ts.acc, js.acc, rel_max=1e-6, what=f"acc, {what}")
        jadam, tadam = _find(js.inner, "mu"), ts.inner
        assert tadam.count == int(jadam.count) == (micro + 1) // ga, what
        for field in ("mu", "nu"):
            _close_trees(getattr(tadam, field), getattr(jadam, field), rel_max=1e-6,
                         what=f"{field}, {what}")
        tf, jf = _flat_t(tp), _flat_j(jp)
        for p in tf:
            assert np.array_equal(tf[p], jf[p]), (f"latents, {what}", p)
    # the master moved: three cycles of Adam, each about one learning rate a weight
    moved = max(np.abs(_flat_t(ts.master)[p] - _flat_t(ttr.tree_map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16).float(), init))[p]).max()
        for p in _flat_t(ts.master))
    assert moved > LR, moved


def test_optimizer_choice_matches_jax():
    """make_optimizer picks the same wrapper as the JAX package's."""
    cases = [(dict(param_dtype="bfloat16"), ttr.WithF32Master),
             (dict(param_dtype="float32"), ttr.ClipAdamW),
             (dict(grad_accum=2), ttr.WithF32MasterAccum),
             (dict(grad_accum=2, param_dtype="float32"), ttr.MultiSteps),
             (dict(grad_accum=2, fused_accum=True), ttr.WithF32Master)]
    for kw, kind in cases:
        assert type(ttr.make_optimizer(ttr.TrainConfig(**kw))) is kind, kw
