"""Checkpoints written by every rank (C9's repair): on 2 spawned gloo ranks
(tests/torch_tp_worker.py:checkpoint_job), the tiny f32 config trains its
first cycle (bf16 latents, stepwise: the MasterAccumState format) at
(dp 1, tp 2) and, separately, at (dp 2, tp 1) under ZeRO 3, and saves.

- `save_checkpoint` issues no collective but its closing barrier (every
  collective of torch.distributed and ZeRO's aliases counted on each rank);
- each rank's part file holds exactly the parts the manifest gives it: its
  own slice of every split leaf and the whole leaves it alone writes (tp
  rank 0 the ones whole over tp), and so no more bytes than its share;
- the manifest names every leaf of the state once, with its whole shape;
- resumed for cycle 2 the run ends where the uninterrupted single-process
  run does: written at (dp 1, tp 2), resumed at (dp 2, tp 1) ZeRO 2, in one
  process, and in the fused format (`_migrate`) at (dp 1, tp 2); written at
  dp 2 × ZeRO 3, resumed at (dp 1, tp 2), at dp 2 and in one process. The
  tolerances are tests/test_torch_dp_train.py's for bf16 latents;
- a checkpoint of the single-file format (`state.pt`) still restores."""

import dataclasses
import json
import os

import pytest
import torch

from bitdistiller_tpu_torch.models import TINY_TEST, init_params
from bitdistiller_tpu_torch.models import safetensors_io
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as ttr
from test_torch_dp_train import BATCHES, BETA, TOL, _check_master, _init_master, _rel, _tc
from test_torch_dp_worker import spawn, train

TCFG = dataclasses.replace(TINY_TEST, dtype="float32")
MODE = "stepwise_bf16"
FIRST, SECOND = BATCHES[:2], BATCHES[2:]
JOB = "torch_tp_worker:checkpoint_job"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both saves, then every resume across meshes, in one spawn; the
    single-process reference and resumes here."""
    d = tmp_path_factory.mktemp("c9")
    params = init_params(TCFG, seed=0, dtype=torch.float32, device="cpu")
    common = dict(kind="call", target=JOB, params=params, cfg=TCFG)
    tp2, dp2 = str(d / "tp2"), str(d / "dp2")
    jobs = [dict(common, tc=_tc(MODE), batches=FIRST, stage=2, tp=2, save=tp2, save_step=2),
            dict(common, tc=_tc(MODE), batches=FIRST, stage=3, tp=1, save=dp2, save_step=2),
            dict(common, tc=_tc(MODE), batches=SECOND, stage=2, tp=1,
                 resume=f"{tp2}/step_2"),
            dict(common, tc=_tc("fused_bf16"), batches=SECOND, stage=3, tp=2,
                 resume=f"{tp2}/step_2"),
            dict(common, tc=_tc(MODE), batches=SECOND, stage=3, tp=2,
                 resume=f"{dp2}/step_2"),
            dict(common, tc=_tc(MODE), batches=SECOND, stage=3, tp=1,
                 resume=f"{dp2}/step_2")]
    ranks = spawn({"kind": "many", "jobs": jobs})
    ref = train(params, TCFG, _tc(MODE), BATCHES, beta=BETA)
    single = {name: train(params, TCFG, _tc(MODE), SECOND, beta=BETA,
                          resume=f"{path}/step_2") for name, path in (("tp2", tp2), ("dp2", dp2))}
    return dict(params=params, dirs={"tp2": tp2, "dp2": dp2}, ranks=ranks, ref=ref,
                single=single)


def test_save_issues_no_collective_but_the_barrier(run):
    for r in run["ranks"]:
        for job in r[:2]:
            assert job["save_collectives"] == {"barrier": 1}


def _state_keys(params) -> dict:
    """{key: whole shape} of every tensor leaf of a one-process state."""
    state = ttr.init_train_state(params, _tc(MODE))
    return {k: list(v[1].shape) for k, v, which in pipeline._walk(state) if which is not None}


@pytest.mark.parametrize("name", ["tp2", "dp2"])
def test_parts_and_manifest(run, name):
    path = os.path.join(run["dirs"][name], "step_2")
    with open(os.path.join(path, pipeline.MANIFEST)) as f:
        manifest = json.load(f)
    assert (manifest["dp"], manifest["tp"]) == ((1, 2) if name == "tp2" else (2, 1))
    assert manifest["optimizer"] == "MasterAccumState"
    assert manifest["scalars"]["step"] == 2
    want = _state_keys(run["params"])
    assert {k: e["shape"] for k, e in manifest["leaves"].items()} == want
    held = {f: safetensors_io.read(os.path.join(path, f)) for f in ("rank0.safetensors",
                                                                   "rank1.safetensors")}
    listed = {f: {} for f in held}
    for key, e in manifest["leaves"].items():
        split = e["tp_dim"] if name == "tp2" else e["dp_dim"]
        assert len(e["parts"]) == (1 if split is None else 2)
        for part in e["parts"]:
            listed[part["file"]][key] = part["shape"]
    share = {f: 0 for f in held}
    for f, tensors in held.items():
        assert {k: list(t.shape) for k, t in tensors.items()} == listed[f]
        share[f] = sum(t.numel() * t.element_size() for t in tensors.values())
    assert share["rank1.safetensors"] < share["rank0.safetensors"]  # rank 0: the whole leaves
    total = sum(share.values())
    leaves = ttr.init_train_state(run["params"], _tc(MODE))
    state_bytes = sum(v[1].numel() * v[1].element_size()
                      for _, v, which in pipeline._walk(leaves) if which is not None)
    assert total == state_bytes  # every byte once, on exactly one rank


def _check(out, ref, params):
    tol = TOL["bfloat16"]
    want = ref["losses"][2:]
    if len(out["losses"]) == 1:  # a fused cycle reports its micro-steps' mean
        want = [sum(want) / 2]
    assert _rel(out["losses"], want) <= tol["loss"]
    _check_master(out["master"], ref["master"], _init_master(params, "bfloat16"), tol)


@pytest.mark.parametrize("job,what", [(2, "written at (dp 1, tp 2), resumed at (dp 2, tp 1)"),
                                      (3, "written stepwise at (dp 1, tp 2), resumed fused"),
                                      (4, "written at dp 2 x ZeRO 3, resumed at (dp 1, tp 2)"),
                                      (5, "written at dp 2 x ZeRO 3, resumed there")])
def test_resume_across_meshes_equals_the_uninterrupted_run(run, job, what):
    for r in run["ranks"]:
        _check(r[job], run["ref"], run["params"])
    for k in run["ref"]["master"]:
        assert torch.equal(run["ranks"][0][job]["master"][k], run["ranks"][1][job]["master"][k])


@pytest.mark.parametrize("name", ["tp2", "dp2"])
def test_resume_in_one_process(run, name):
    _check(run["single"][name], run["ref"], run["params"])


def test_single_file_checkpoints_still_restore(tmp_path):
    """The format before the parts: one torch.save of every leaf whole."""
    params = init_params(TCFG, seed=0, dtype=torch.float32, device="cpu")
    tc = _tc(MODE)
    state = train(params, TCFG, tc, FIRST, beta=BETA, keep_state=True)["state"]
    flat = {}
    for key, value, which in pipeline._walk(state):
        flat[key] = value if which is None else value[1].clone()
    (tmp_path / "step_2").mkdir()
    torch.save(flat, tmp_path / "step_2" / "state.pt")
    got = pipeline.restore_checkpoint(str(tmp_path / "step_2"), ttr.init_train_state(params, tc))
    assert got.step == state.step
    for (k, a), (_, b) in zip(ttr.tree_items(got.opt_state.master),
                              ttr.tree_items(state.opt_state.master)):
        assert torch.equal(a, b), k
