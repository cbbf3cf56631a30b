"""Data-parallel KD-QAT on the port over gloo: two spawned CPU ranks
(tests/test_torch_dp_worker.py) train the tiny f32 config, each on its half of
every global batch of 4 rows, at ZeRO 0, 2 and 3, stepwise and fused,
with bf16 and f32 latents, for two optimizer cycles (grad_accum 2). They
must equal the port's single-process run on the whole global batches and
JAX's `make_train_step` under `make_mesh(dp=2, tp=1)` at the same ZeRO stage
(the JAX package's tests/test_parallel.py:121-181 way). Also: the bytes a
rank holds between steps (exact, from the parameter count), a gradient
large enough to clip (both ranks see the same global norm), CAKLD beta over
every rank's batches, and checkpoints written at dp = 2, stage 3 that resume
at dp = 1, stage 0, and the reverse.

Tolerances are those of tests/test_torch_trainer.py, one run against
another computed differently (two half-batch gradients summed in f32
against one whole-batch gradient; JAX's XLA against PyTorch): f32 latents,
loss within 1e-5 relative, grad norm 1e-4; bf16 latents, where the matmuls
round to bf16 at another blocking and a few quantized weights move a step,
loss 2e-3, grad norm 2e-2 (measured against the single-process run: 7.4e-4,
1.5e-3). The master is held by its update: the norm of the two runs'
difference over the norm of the reference's move from the initial master,
||m - m_ref|| / ||m_ref - m_0||, over the whole tree. A rank whose part of
the master never moved reads about 0.7 there, an update of half the size
0.5 (test_master_check_catches_a_stale_shard_and_a_half_update). Measured,
at every stage: bf16 3.2e-2 (fused) and 3.5e-2 (stepwise) against one
process, 4.3e-2 against JAX's dp = 2, whose own single device lies 3.4e-2
from the port's; f32 9.3e-6 against one process, 1.8e-4 against JAX (the
port's one process 1.8e-4 from it too). Bounds: bf16 0.1 against either;
f32 1e-4 against one process, 1e-3 against JAX, and besides the largest
entry within 5% of a learning rate of one process (measured 0.4%) and 0.2
of one of JAX (the port's single process lies 0.125 of one from JAX's
single device, at 5.5e-6 of the values: gradients near Adam's eps). The
ranks' masters are equal bit for bit."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from bitdistiller_tpu.models import TINY_TEST as JT
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.parallel.mesh import make_mesh as jmake_mesh
from bitdistiller_tpu.parallel.mesh import param_specs as jparam_specs
from bitdistiller_tpu.parallel.mesh import shard_params
from bitdistiller_tpu.train import trainer as jtr
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.parallel.mesh import dp_dim, param_specs_from_params, zero_extend_spec
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as ttr
from test_torch_dp_worker import global_batches, spawn, train
from torch_port_util import to_numpy_tree, torch_cfg

JCFG = dataclasses.replace(JT, dtype="float32")
TCFG = torch_cfg(JCFG)
LR = 1e-3
BETA = 0.3
MODES = {  # name: (param_dtype, fused)
    "stepwise_bf16": ("bfloat16", False),
    "stepwise_f32": ("float32", False),
    "fused_bf16": ("bfloat16", True),
    "fused_f32": ("float32", True),
}
TOL = {"bfloat16": dict(loss=2e-3, gnorm=2e-2, update=0.1, master=None),
       "float32": dict(loss=1e-5, gnorm=1e-4, update=1e-4, master=0.05 * LR)}
JAX_TOL = {"bfloat16": dict(update=0.1, master=None),
           "float32": dict(update=1e-3, master=0.2 * LR)}
BATCHES = global_batches(4, JCFG.vocab_size)  # two cycles of 2 micro-batches of 4 rows
STAGES = (0, 2, 3)


def _kw(pdt, fused, **extra):
    return dict(q_group_size=64, learning_rate=LR, grad_accum=2, param_dtype=pdt,
                fused_accum=fused, total_steps=10, weight_decay=0.01, **extra)


def _tc(mode, **extra):
    return ttr.TrainConfig(**_kw(*MODES[mode], **extra))


@pytest.fixture(scope="module")
def model():
    jparams = jinit(JCFG, jax.random.key(0), dtype=jnp.float32)
    return jparams, params_from_numpy(to_numpy_tree(jparams), "cpu")


_CACHE: dict = {}


def _single(mode, tparams):
    key = ("single", mode)
    if key not in _CACHE:
        _CACHE[key] = train(tparams, TCFG, _tc(mode), BATCHES, beta=BETA)
    return _CACHE[key]


def _dp(stage, tparams):
    """Both ranks' runs of every mode at one stage: one spawn."""
    key = ("dp", stage)
    if key not in _CACHE:
        names = sorted(MODES)
        jobs = [dict(kind="train", params=tparams, cfg=TCFG, tc=_tc(m), batches=BATCHES,
                     stage=stage) for m in names]
        ranks = spawn({"kind": "many", "jobs": jobs})
        _CACHE[key] = {m: [r[i] for r in ranks] for i, m in enumerate(names)}
    return _CACHE[key]


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _master_gap(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max((got[k].float() - want[k].float()).abs().max().item() for k in want)


def _init_master(tparams, pdt: str) -> dict:
    """The master before any step: the latents (params in `pdt`) in f32."""
    dt = torch.bfloat16 if pdt == "bfloat16" else torch.float32
    return {"/".join(p): x.to(dt).to(torch.float32) for p, x in ttr.tree_items(tparams)}


def _update_gap(got: dict, want: dict, init: dict) -> float:
    """||got - want|| / ||want - init|| over the whole tree: how far the
    update that reached `got` lies from `want`'s, relative to the latter."""
    assert got.keys() == want.keys() == init.keys()
    num = sum(((got[k].double() - want[k].double()) ** 2).sum().item() for k in want)
    den = sum(((want[k].double() - init[k].double()) ** 2).sum().item() for k in want)
    return math.sqrt(num / den)


def _check_master(got: dict, want: dict, init: dict, tol: dict):
    gap = _update_gap(got, want, init)
    assert gap <= tol["update"], gap
    if tol["master"] is not None:  # f32: the largest entry too
        assert _master_gap(got, want) <= tol["master"]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stage", STAGES)
def test_two_ranks_equal_one_process(model, stage, mode):
    _, tparams = model
    ranks = _dp(stage, tparams)[mode]
    ref = _single(mode, tparams)
    tol = TOL[MODES[mode][0]]
    for r in ranks:  # both ranks report the global batch's loss and norm
        assert len(r["losses"]) == len(ref["losses"])
        assert _rel(r["losses"], ref["losses"]) <= tol["loss"], (r["losses"], ref["losses"])
        assert _rel(r["grad_norms"], ref["grad_norms"]) <= tol["gnorm"]
        assert r["step"] == ref["step"]
    for k in ref["master"]:
        assert torch.equal(ranks[0]["master"][k], ranks[1]["master"][k]), k
    _check_master(ranks[0]["master"], ref["master"], _init_master(tparams, MODES[mode][0]), tol)


def _jax_run(jparams, stage, mode):
    """JAX's make_train_step on a dp = 2 mesh at `stage`, the same global
    batches (micro-steps; a cycle every 2)."""
    tc = jtr.TrainConfig(**_kw(*MODES[mode]))
    mesh = jmake_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    specs = jparam_specs(JCFG, fsdp_axis="dp" if stage >= 3 else None)
    losses, norms = [], []
    with jax.set_mesh(mesh):
        teacher = shard_params(jparams, mesh, jparam_specs(JCFG))
        state = jtr.init_train_state(shard_params(jparams, mesh, specs), tc, mesh=mesh,
                                     param_spec_tree=specs, zero_stage=stage)
        step = jax.jit(jtr.make_train_step(JCFG, tc))
        for b in BATCHES:
            batch = {k: jax.device_put(v.astype(np.int32), NamedSharding(mesh, JP("dp")))
                     for k, v in b.items()}
            state, m = step(state, batch, jnp.asarray(BETA, jnp.float32), teacher)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        master = jtr.master_params(state)
    flat = {"/".join(p): torch.from_numpy(np.asarray(x, np.float32))
            for p, x in ttr.tree_items(jax.tree_util.tree_map(np.asarray, master))}
    return losses, norms, flat


@pytest.mark.parametrize("mode", ["stepwise_bf16", "stepwise_f32"])
@pytest.mark.parametrize("stage", STAGES)
def test_two_ranks_equal_jax_dp2(model, stage, mode):
    jparams, tparams = model
    ranks = _dp(stage, tparams)[mode]
    losses, norms, master = _jax_run(jparams, stage, mode)
    tol = TOL[MODES[mode][0]]
    assert _rel(ranks[0]["losses"], losses) <= tol["loss"], (ranks[0]["losses"], losses)
    assert _rel(ranks[0]["grad_norms"], norms) <= tol["gnorm"]
    pdt = MODES[mode][0]
    _check_master(ranks[0]["master"], master, _init_master(tparams, pdt), JAX_TOL[pdt])


def test_master_check_catches_a_stale_shard_and_a_half_update(model):
    """The master check's power, on the sound stage-2 bf16 run: the same
    master with rank 1's part of every split leaf left at its initial
    value, or with half its update, fails the bound against one process
    and against JAX's dp = 2."""
    jparams, tparams = model
    mode = "stepwise_bf16"
    got = _dp(2, tparams)[mode][0]["master"]
    init = _init_master(tparams, "bfloat16")
    specs = param_specs_from_params(tparams)
    stale, half = {}, {}
    for path, leaf in ttr.tree_items(tparams):
        k = "/".join(path)
        dim = dp_dim(zero_extend_spec(ttr._get(specs, path), tuple(leaf.shape), 2))
        stale[k] = got[k].clone()
        if dim is not None:
            n = leaf.shape[dim] // 2
            stale[k].narrow(dim, n, n).copy_(init[k].narrow(dim, n, n))
        half[k] = init[k] + 0.5 * (got[k] - init[k])
    for want, bound in ((_single(mode, tparams)["master"], TOL["bfloat16"]["update"]),
                        (_jax_run(jparams, 2, mode)[2], JAX_TOL["bfloat16"]["update"])):
        assert _update_gap(got, want, init) <= bound
        assert _update_gap(stale, want, init) > 4 * bound
        assert _update_gap(half, want, init) > 4 * bound


def test_zero_stages_cut_the_bytes_a_rank_holds(model):
    """Between steps, a rank's state (bf16 latents; f32 master, mu, nu and
    the accumulator) at P parameters: stage 0 18 P bytes, stage 2 2 P + 16
    P / 2 (about half), stage 3 2 (P - W) / 2 + 2 W + 16 P / 2 (half), W
    the norms' parameters, which JAX's fsdp spec keeps whole; every other
    leaf of the tiny config divides over 2."""
    _, tparams = model
    p = sum(x.numel() for x in ttr.tree_leaves(tparams))
    specs = param_specs_from_params(tparams, "dp")
    w = sum(x.numel() for path, x in ttr.tree_items(tparams)
            if "dp" not in ttr._get(specs, path))
    want = {0: 18 * p, 2: 2 * p + 8 * p, 3: p + w + 8 * p}
    for stage in STAGES:
        for r in _dp(stage, tparams)["stepwise_bf16"]:
            assert set(r["bytes"]) == {want[stage]}, (stage, r["bytes"], want[stage])
    assert _single("stepwise_bf16", tparams)["bytes"][-1] == want[0]


def test_clip_decision_is_the_same_on_both_ranks(model):
    """max_grad_norm far below the gradient's norm: every step clips. The
    ranks see the same global norms (their halves' squares summed before the
    decision; 4 micro-steps' metrics and 2 cycles' clips) and end with the
    single-process run's master."""
    _, tparams = model
    tc = _tc("stepwise_f32", max_grad_norm=1e-3)
    ranks = spawn({"kind": "train", "params": tparams, "cfg": TCFG, "tc": tc,
                   "batches": BATCHES, "stage": 2})
    ref = train(tparams, TCFG, tc, BATCHES, beta=BETA)
    n0, n1 = ranks[0]["clip_norms"], ranks[1]["clip_norms"]
    assert len(n0) == 6 and n0 == n1
    assert min(n0) > 100 * tc.max_grad_norm
    init = _init_master(tparams, "float32")
    for r in ranks:
        _check_master(r["master"], ref["master"], init, TOL["float32"])


def test_cakld_beta_is_the_global_mean(model):
    _, tparams = model
    ranks = spawn({"kind": "beta", "params": tparams, "cfg": TCFG, "batches": BATCHES})
    local = [ttr.to_device(b, "cpu") for b in BATCHES]
    want = float(ttr.estimate_cakld_beta(tparams, TCFG, local))
    assert ranks[0]["beta"] == ranks[1]["beta"]
    assert abs(ranks[0]["beta"] - want) <= 1e-6 * want


def test_checkpoint_resumes_across_dp_and_stage(model, tmp_path):
    """A checkpoint written after cycle 1 at dp = 2, ZeRO 3 resumes in one
    process at stage 0, and one written in one process resumes at dp = 2,
    ZeRO 3; cycle 2 then ends where the uninterrupted single-process run
    does (bf16 latents, the stepwise MasterAccumState)."""
    _, tparams = model
    mode = "stepwise_bf16"
    tc, tol = _tc(mode), TOL["bfloat16"]
    ref = _single(mode, tparams)
    first, second = BATCHES[:2], BATCHES[2:]
    spawn({"kind": "train", "params": tparams, "cfg": TCFG, "tc": tc, "batches": first,
           "stage": 3, "save": str(tmp_path / "dp2"), "save_step": 2})
    resumed = train(tparams, TCFG, tc, second, beta=BETA,
                    resume=pipeline.latest_checkpoint(str(tmp_path / "dp2"))[0])
    init = _init_master(tparams, "bfloat16")
    assert _rel(resumed["losses"], ref["losses"][2:]) <= tol["loss"]
    _check_master(resumed["master"], ref["master"], init, tol)

    train(tparams, TCFG, tc, first, beta=BETA, save=str(tmp_path / "dp1"), save_step=2)
    ranks = spawn({"kind": "train", "params": tparams, "cfg": TCFG, "tc": tc, "batches": second,
                   "stage": 3, "resume": str(tmp_path / "dp1" / "step_2")})
    for r in ranks:
        assert _rel(r["losses"], ref["losses"][2:]) <= tol["loss"]
        _check_master(r["master"], ref["master"], init, tol)
