"""Rank jobs of the port's tensor-parallel tests (tests/test_torch_tp_*.py),
run through `test_torch_dp_worker.spawn({"kind": "call", "target":
"torch_tp_worker:<job>", ...})`: each is fn(rank, world, job) in a spawned
gloo rank. The module holds no tests and imports no JAX (a spawned child
that imported the JAX package would start JAX without the suite's CPU
settings)."""

import torch
import torch.distributed as dist

from bitdistiller_tpu_torch.models import KVCache, llama
from bitdistiller_tpu_torch.models.quantized import pack_model
from bitdistiller_tpu_torch.parallel import zero
from bitdistiller_tpu_torch.parallel.mesh import (make_mesh, param_specs, shard_packed_model,
                                                  shard_params)
from bitdistiller_tpu_torch.parallel.tensor import tp_config
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train import trainer as ttr
from test_torch_dp_worker import train

CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def decode_run(packed, cfg, mesh=None, cache_dtype=torch.bfloat16, attn_len=None):
    """A packed prefill of 4 tokens into an empty cache of 16 rows, then one
    decode step a slot at per-slot positions 4 and 3 (the decode attention's
    route; `attn_len` buckets its read): (prefill logits, step logits, the
    cache's k after the step)."""
    lcfg = cfg if mesh is None else tp_config(cfg, mesh.tp)
    cache = KVCache.init(lcfg, 2, 16, dtype=cache_dtype, device="cpu")
    toks = torch.arange(8, dtype=torch.int64).reshape(2, 4)
    with torch.no_grad():
        pre, _ = llama.forward(packed, cfg, toks, cache=cache, cache_pos=0, mesh=mesh)
        step, cache = llama.forward(packed, cfg, torch.tensor([[5], [7]]), cache=cache,
                                    cache_pos=torch.tensor([4, 3], dtype=torch.int32),
                                    attn_len=attn_len, mesh=mesh)
    return pre, step, cache.k.to(torch.float32)


def dense_grads(params, cfg, tokens, mesh=None, remat=False):
    """The dense forward's logits, and the gradients of every leaf of
    sum(logits * w) for a fixed w (the backward through every collective)."""
    p = ttr.tree_map(lambda x: x.detach().requires_grad_(True), params)
    logits, _ = llama.forward(p, cfg, tokens, mesh=mesh, remat=remat)
    w = torch.linspace(-1, 1, logits.numel(), dtype=logits.dtype).reshape(logits.shape)
    grads = ttr._grads((logits * w).sum(), p)
    return logits.detach(), {"/".join(k): g for k, g in ttr.tree_items(grads)}


def forward_job(rank, world, job):
    """The dense forward and its gradients on this rank's tp slice (with and
    without remat), and the packed unfused decode over each cache dtype."""
    mesh = make_mesh(tp=job["tp"])
    cfg, params = job["cfg"], job["params"]
    local = shard_params(params, mesh, param_specs(cfg))
    out = {"dense": dense_grads(local, cfg, job["tokens"], mesh),
           "remat": dense_grads(local, cfg, job["tokens"], mesh, remat="save_dots")[1]}
    packed = shard_packed_model(pack_model(params, cfg, bits=4, group_size=64, fuse=False),
                                mesh, cfg)
    out["packed"] = {name: decode_run(packed, cfg, mesh, dt) for name, dt in CACHE_DTYPES.items()}
    out["packed_attn_len"] = decode_run(packed, cfg, mesh, attn_len=8)[1]
    out["families"] = {name: dense_grads(shard_params(p, mesh, param_specs(c)), c, tok, mesh)
                       for name, (c, p, tok) in job.get("families", {}).items()}
    return out


def _counting():
    """Patch every collective the train state's I/O could issue; returns the
    counter and an undo."""
    counts: dict = {}
    saved = []

    def wrap(owner, name):
        fn = getattr(owner, name)

        def counted(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)

        saved.append((owner, name, fn))
        setattr(owner, name, counted)

    for name in ("all_gather", "all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
                 "broadcast", "gather", "barrier", "all_gather_object", "broadcast_object_list"):
        wrap(dist, name)
    for name in ("_all_gather", "_reduce_scatter"):
        wrap(zero, name)

    def undo():
        for owner, name, fn in saved:
            setattr(owner, name, fn)

    return counts, undo


def checkpoint_job(rank, world, job):
    """Train `job["batches"]` on the mesh (dp = world / tp), then save with
    every collective counted; or restore `job["resume"]` and train on."""
    mesh = make_mesh(tp=job["tp"])
    if job.get("resume"):
        return train(job["params"], job["cfg"], job["tc"], job["batches"], stage=job["stage"],
                     resume=job["resume"], mesh=mesh)
    out = train(job["params"], job["cfg"], job["tc"], job["batches"], stage=job["stage"],
                mesh=mesh, keep_state=True)
    counts, undo = _counting()
    try:
        pipeline.save_checkpoint(job["save"], job["save_step"], out.pop("state"))
    finally:
        undo()
    out["save_collectives"] = counts
    return out


class SmallTok:
    """A byte tokenizer inside a tiny model's 128 ids (3..122)."""

    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 120) + 3 for c in s][:64]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


def cli_train_job(rank, world, job):
    """`cli train` joining the group from its flags (gloo on the CPU)."""
    from bitdistiller_tpu_torch import cli

    cli._load_tokenizer = lambda path: SmallTok()
    argv = job["argv"] + ["--coordinator_address", f"127.0.0.1:{job['port']}",
                          "--num_processes", str(world), "--process_id", str(rank)]
    summary = cli.main(argv)
    return {"final_loss": summary["final_loss"], "steps": summary["steps"],
            "beta": summary["beta"], "master": {"/".join(p): x for p, x in
                                                ttr.tree_items(summary["master"])}}


def dryrun_job(rank, world, job):
    """The dry run's steps on this rank (the script's `_rank`, in process)."""
    from bitdistiller_tpu_torch.parallel.distributed import init_distributed
    from bitdistiller_tpu_torch.scripts.dryrun_multichip import dryrun

    init_distributed(f"127.0.0.1:{job['port']}", world, rank, device="cpu")
    return dryrun(torch.device("cpu"))

