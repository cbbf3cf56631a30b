"""Ranks of the port's data-parallel tests (tests/test_torch_dp_train.py,
tests/test_torch_distributed.py): `spawn(job)` starts `world` processes
that join one gloo group on a free localhost port, run the job, write what
they return and leave the group, even when the job fails. `train` is the
one training loop of those tests: a rank runs it on its rows of every
global batch, the single-process reference on all of them. The module holds
no tests and imports no JAX: a spawned rank imports it, and a child that
imported the JAX package would start JAX without the suite's CPU settings."""

import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from bitdistiller_tpu_torch.parallel.mesh import make_mesh, param_specs_from_params, shard_params
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as ttr

TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rows(batch: dict, rank: int, world: int) -> dict:
    """A rank's contiguous rows of a global numpy batch, as int64 tensors."""
    b = batch["input_ids"].shape[0] // world
    return ttr.to_device({k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}, "cpu")


def state_bytes(state) -> int:
    """The bytes of every tensor of a train state (latents and optimizer
    state) that this rank holds."""
    leaves = list(ttr.tree_leaves(state.params))
    stack = list(state.opt_state)
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            leaves += ttr.tree_leaves(node)
        elif isinstance(node, tuple):
            stack.extend(node)
    return sum(x.numel() * x.element_size() for x in leaves if isinstance(x, torch.Tensor))


def train(params, cfg, tc, batches, *, rank=0, world=1, group=None, stage=0, beta=0.3,
          resume=None, save=None, save_step=0, mesh=None, keep_state=False):
    """Steps over the global `batches` (one a micro-step; grad_accum of them
    a fused cycle): losses, grad norms, the bytes of the state after every
    step, the clip's norms as this rank saw them, and the whole f32 master
    at the end. `resume`: a checkpoint dir restored first; `save`: the dir a
    checkpoint of the end state goes to, as step `save_step`. `mesh`: a
    (dp, tp) mesh; the ranks of a dp group take its rows, the teacher is
    each rank's tp slice. `keep_state`: the end state too, as "state"."""
    teacher = params if tc.train_kd else None
    if mesh is not None:
        rank, world = mesh.dp_rank, mesh.dp
        if teacher is not None and mesh.tp > 1:
            teacher = shard_params(params, mesh, param_specs_from_params(params))
    state = ttr.init_train_state(params, tc, group=group, zero_stage=stage, mesh=mesh)
    if resume:
        state = pipeline.restore_checkpoint(resume, state)
    clip_norms = []
    if state.zero is not None:
        plan_norm = state.zero.global_norm

        def recording(items):
            n = plan_norm(items)
            clip_norms.append(float(n))
            return n

        state.zero.global_norm = recording
    fused = tc.fused_accum
    step = ttr.make_fused_train_step(cfg, tc) if fused else ttr.make_train_step(cfg, tc)
    local = [rows(b, rank, world) for b in batches]
    groups = ([local[i:i + tc.grad_accum] for i in range(0, len(local), tc.grad_accum)]
              if fused else local)
    out = {"losses": [], "grad_norms": [], "bytes": []}
    for item in groups:
        state, m = step(state, item, torch.tensor(beta), teacher)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["bytes"].append(state_bytes(state))
    out["clip_norms"] = clip_norms
    out["master"] = {"/".join(p): x.detach().clone()
                     for p, x in ttr.tree_items(ttr.master_params(state))}
    out["step"] = state.step
    if save:
        pipeline.save_checkpoint(save, save_step, state)
    if keep_state:
        out["state"] = state
    return out


def _job_train(rank, world, group, job):
    mesh = make_mesh(tp=job["tp"]) if "tp" in job else None
    return train(job["params"], job["cfg"], job["tc"], job["batches"], rank=rank, world=world,
                 group=group, stage=job["stage"], resume=job.get("resume"),
                 save=job.get("save"), save_step=job.get("save_step", 0), mesh=mesh)


def _job_beta(rank, world, group, job):
    local = [rows(b, rank, world) for b in job["batches"]]
    return {"beta": float(ttr.estimate_cakld_beta(job["params"], job["cfg"], local,
                                                  group=group))}


def _job_many(rank, world, group, job):
    return [JOBS[j["kind"]](rank, world, group, j) for j in job["jobs"]]


class ByteTok:
    """The JAX package's tests' byte tokenizer (ids 3..252, prompts cut at 96)."""

    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s][:96]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


def _job_generate(rank, world, port, job):
    """run_teacher_generation joining the group itself from its args."""
    import types

    from bitdistiller_tpu_torch.generation.teacher import run_teacher_generation

    args = types.SimpleNamespace(**job["args"], coordinator_address=f"127.0.0.1:{port}",
                                 num_processes=world, process_id=rank, device="cpu")
    return run_teacher_generation(args, tokenizer=ByteTok(), model=(job["params"], job["cfg"]))


def _job_call(rank, world, group, job):
    """`job["target"]` ("module:function"), called as fn(rank, world, job)."""
    import importlib

    module, name = job["target"].split(":")
    return getattr(importlib.import_module(module), name)(rank, world, job)


JOBS = {"train": _job_train, "beta": _job_beta, "many": _job_many, "call": _job_call}


def _run(rank, world, port, job_path, out_dir):
    import torch.distributed as dist

    from bitdistiller_tpu_torch.parallel.distributed import (init_distributed,
                                                             shutdown_distributed)

    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    try:
        if job["kind"] == "generate":
            out = _job_generate(rank, world, port, job)
        elif job.get("joins"):  # the job joins the group itself, at job["port"]
            out = JOBS[job["kind"]](rank, world, None, dict(job, port=port))
        else:
            init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
            out = JOBS[job["kind"]](rank, world, dist.group.WORLD, job)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


def spawn(job: dict, world: int = 2) -> list:
    """Run `job` on `world` gloo ranks; each rank's result, in rank order."""
    with tempfile.TemporaryDirectory() as d:
        job_path = os.path.join(d, "job.pt")
        torch.save(job, job_path)
        ctx = mp.start_processes(_run, args=(world, free_port(), job_path, d), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.time() + TIMEOUT_S
        try:
            while not ctx.join(timeout=1):
                if time.time() > deadline:
                    raise TimeoutError(f"the ranks did not finish in {TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def global_batches(n, vocab, seed=0, b=4, s=24):
    """n global batches of b rows (random tokens, the second row padded)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab, (b, s)).astype(np.int64)
        mask = np.ones((b, s), np.int64)
        mask[1, s - 5:] = 0
        labels = np.where(mask == 1, ids, -100).astype(np.int64)
        out.append({"input_ids": ids, "labels": labels, "attention_mask": mask})
    return out
