"""Multi-rank dry run of the port (the counterpart of the JAX package's
`__graft_entry__.py:dryrun_multichip`): on the tiny shapes, over a (dp, tp)
mesh of `world` ranks, tp = 2 when the world is even,

- one KD-QAT step at ZeRO 2 (the optimizer state split over dp, checked
  before and after the step), one at ZeRO 3 (the latents split too), and
  one fused cycle of two micro-batches;
- the packed int2 decode step (`pack_model(..., fuse=False)`, each rank's
  tp slice) over a bf16 cache, again with the bucketed `attn_len`, and over
  an int8 cache;
- `run_training` over the group;
- the 7B memory estimate at ZeRO 3, dp = 8, against one H100's 80 GB;
- GPipe: `pipeline_forward` of 4 x 16 tokens at n_micro = 2 over pp = the
  largest of 4, 2, 1 dividing both the world and the layers, against the
  one-process forward (rtol and atol 2e-4, in f32).

Usage (one process a rank, spawned here):

    python -m bitdistiller_tpu_torch.scripts.dryrun_multichip --world 2 --device cpu
    python -m bitdistiller_tpu_torch.scripts.dryrun_multichip --world 2 --backend gloo

The second runs two ranks on one card over gloo (NCCL refuses two ranks on
one device); with a card a rank, `--world N` alone runs over NCCL. Each
rank prints its lines; rank 0's summary goes to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import tempfile
import types

import numpy as np
import torch


def _batch(rows: int, dp_rank: int, dp: int, seq: int, vocab: int, device) -> dict:
    """This dp rank's rows of JAX's global batch (dp * 2 rows of seq tokens)."""
    ids = np.random.default_rng(0).integers(0, vocab, (rows, seq))
    labels = np.random.default_rng(1).integers(0, vocab, (rows, seq))
    b = rows // dp
    cut = lambda a: torch.as_tensor(a[dp_rank * b:(dp_rank + 1) * b], dtype=torch.int64,
                                    device=device)
    return {"input_ids": cut(ids), "labels": cut(labels),
            "attention_mask": cut(np.ones((rows, seq), np.int64))}


class _Tok:
    """The JAX dry run's tokenizer (ids 3..252, cut at 48)."""

    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s][:48]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


def dryrun(device) -> dict:
    """The dry run on this rank (in a process group already joined)."""
    from ..models import LLAMA2_7B, KVCache, ModelConfig, init_params, llama
    from ..models.quantized import pack_model
    from ..parallel.distributed import get_rank, get_world_size, make_hybrid_mesh
    from ..parallel.mesh import param_specs, shard_packed_model, shard_params
    from ..parallel.tensor import tp_config
    from ..train.memory import GiB, format_estimate, kd_train_memory_estimate
    from ..train.pipeline import run_training
    from ..train.trainer import (TrainConfig, init_train_state, make_fused_train_step,
                                 make_train_step)

    world = get_world_size()
    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = make_hybrid_mesh(tp=tp)
    tag = f"dryrun_multichip({world}) rank {get_rank()}"
    out: dict = {"world": world, "dp": dp, "tp": tp}
    cfg = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_position_embeddings=128)
    tc = TrainConfig(quant_type="int2-asym", q_group_size=64, kd_loss_type="cakld",
                     total_steps=4, gradient_checkpointing=True)
    teacher = init_params(cfg, seed=0, dtype=torch.float32, device=device)
    teacher_tp = shard_params(teacher, mesh, param_specs(cfg))
    batch = _batch(dp * 2, mesh.dp_rank, dp, 32, cfg.vocab_size, device)
    beta = torch.tensor(0.5, device=device)

    def split(state, which):  # leaves of the state split over dp
        dims = state.zero.dims(which)
        return sum(d is not None for d in dims.values())

    # ZeRO-2: Adam's moments (and the f32 master) split over dp
    state = init_train_state(teacher, tc, zero_stage=2, mesh=mesh)
    n_dp = split(state, "opt")
    if n_dp == 0:
        raise AssertionError("ZeRO-2: no optimizer-state leaf is split over dp")
    state, m = make_train_step(cfg, tc)(state, batch, beta, teacher_tp)
    out["loss"] = float(m["loss"])
    if not math.isfinite(out["loss"]) or split(state, "opt") != n_dp:
        raise AssertionError(f"ZeRO-2 step: loss {out['loss']}, the dp split lost")
    print(f"{tag}: mesh dp={dp} tp={tp}; ZeRO-2 opt state has {n_dp} dp-split leaves; "
          f"loss={out['loss']:.4f} ok", flush=True)

    # ZeRO-3: the latents split over dp as well, gathered for the step
    state3 = init_train_state(teacher, tc, zero_stage=3, mesh=mesh)
    p_dp = split(state3, "params")
    if p_dp == 0:
        raise AssertionError("ZeRO-3: no latent is split over dp")
    _, m3 = make_train_step(cfg, tc)(state3, batch, beta, teacher_tp)
    out["zero3_loss"] = float(m3["loss"])
    if not math.isfinite(out["zero3_loss"]):
        raise AssertionError(f"ZeRO-3 step: loss {out['zero3_loss']}")
    print(f"{tag}: ZeRO-3 step ok ({p_dp} dp-split latents)", flush=True)
    del state, state3

    # the fused cycle: the weights quantized once a cycle of 2 micro-batches
    tc_f = TrainConfig(quant_type="int2-asym", q_group_size=64, kd_loss_type="cakld",
                       total_steps=4, gradient_checkpointing=True, grad_accum=2,
                       fused_accum=True)
    state_f = init_train_state(teacher, tc_f, zero_stage=2, mesh=mesh)
    _, mf = make_fused_train_step(cfg, tc_f)(state_f, [batch, batch], beta, teacher_tp)
    out["fused_loss"] = float(mf["loss"])
    if not math.isfinite(out["fused_loss"]) or split(state_f, "opt") == 0:
        raise AssertionError(f"fused cycle: loss {out['fused_loss']}")
    print(f"{tag}: fused-accum cycle ok (loss={out['fused_loss']:.4f})", flush=True)
    del state_f

    # the packed int2 decode step on this rank's tp slice (unfused layout)
    packed = shard_packed_model(pack_model(teacher, cfg, bits=2, group_size=64, fuse=False),
                                mesh, cfg)
    lcfg = tp_config(cfg, tp)
    toks = _batch(dp * 2, mesh.dp_rank, dp, 1, cfg.vocab_size, device)["input_ids"]
    pos = torch.full((toks.shape[0],), 4, dtype=torch.int32, device=device)
    cache = KVCache.init(lcfg, toks.shape[0], 32, dtype=torch.bfloat16, device=device)
    logits, _ = llama.forward(packed, cfg, toks, cache=cache, cache_pos=pos, mesh=mesh)
    blogits, _ = llama.forward(packed, cfg, toks, cache=cache, cache_pos=pos, attn_len=16,
                               mesh=mesh)
    gap = float((blogits - logits).abs().max())
    if not bool(torch.isfinite(logits).all()) or gap > 2e-4:
        raise AssertionError(f"packed decode: finite {bool(torch.isfinite(logits).all())}, "
                             f"attn_len=16 differs by {gap}")
    qcache = KVCache.init(lcfg, toks.shape[0], 32, dtype=torch.int8, device=device)
    qlogits, qcache = llama.forward(packed, cfg, toks, cache=qcache, cache_pos=pos, mesh=mesh)
    if not bool(torch.isfinite(qlogits).all()) or qcache.k.dtype != torch.int8:
        raise AssertionError("packed decode over the int8 cache")
    out.update(logits_shape=list(logits.shape), attn_len_gap=gap,
               int8_logits_gap=float((qlogits - logits).abs().max()))
    print(f"{tag}: packed int2 TP decode ok (logits {tuple(logits.shape)}, bucketed attn_len "
          f"gap {gap:.3g}, int8 KV cache ok)", flush=True)

    # run_training over the group: the mesh, beta, the loop, the final save
    with tempfile.TemporaryDirectory() as td:
        data_path = os.path.join(td, "teacher.jsonl")
        with open(data_path, "w") as f:
            for i in range(8):
                f.write(json.dumps([[f"prompt {i} ", f"reply {i}"]]) + "\n")
        args = types.SimpleNamespace(
            model_name_or_path="unused", data_path=data_path, output_dir=f"{td}/out", bits=2,
            q_group_size=64, quant_type="int2-asym", clip=None, train_kd=True,
            kd_loss_type="cakld", cakld_steps=1, learning_rate=1e-4, num_train_epochs=1,
            per_device_train_batch_size=2, gradient_accumulation_steps=1, model_max_length=32,
            max_train_samples=None, lr_scheduler_type="constant", warmup_ratio=0.0,
            save_steps=0, eval_steps=0, logging_steps=1, seed=0, dp=None, tp=tp, zero_stage=2,
            resume=False, eval_on_start=False, device=str(device))
        summary = run_training(args, tokenizer=_Tok(), model=(teacher, cfg))
    if not summary["steps"] or not math.isfinite(summary["final_loss"]):
        raise AssertionError(f"run_training: {summary['steps']} steps, loss "
                             f"{summary['final_loss']}")
    out.update(run_training_steps=summary["steps"], run_training_loss=summary["final_loss"])
    print(f"{tag}: run_training over dp x tp={tp} ok ({summary['steps']} steps, loss "
          f"{summary['final_loss']:.4f})", flush=True)

    # the 7B estimate at ZeRO 3, dp = 8, micro-batch 1 x 1024: one H100's
    # 80 GB (NVIDIA's data sheet) is the budget a rank has
    est = kd_train_memory_estimate(LLAMA2_7B, tc, dp=8, tp=1, zero_stage=3, batch=1, seq=1024)
    out["llama2_7b_zero3_dp8_bytes"] = est["total"]
    print(f"{tag}: 7B estimate (zero3, dp=8, bs1): {format_estimate(est)}", flush=True)
    if est["total"] >= 80e9:
        raise AssertionError(f"7B at ZeRO 3, dp = 8: {est['total'] / GiB:.2f} GiB a rank")

    # pipeline parallelism: the GPipe forward over a pp group of the first
    # ranks (the layer stacks cut along L) reproduces the one-process forward.
    # In f32: a microbatch has half the rows, and cuBLAS may sum another
    # number of rows in another order, which bf16 rounding would turn into
    # whole-ulp differences
    from ..parallel.pipeline import make_pp_mesh, pipeline_forward, shard_params_pp

    pcfg = dataclasses.replace(cfg, dtype="float32")
    pp = max(g for g in (4, 2, 1) if world % g == 0 and cfg.num_layers % g == 0)
    pp_mesh = make_pp_mesh(pp)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 16)),
                           device=device)
    with torch.no_grad():
        got = pipeline_forward(shard_params_pp(teacher, pp_mesh), pcfg, toks, pp_mesh,
                               n_micro=2)
        want, _ = llama.forward(teacher, pcfg, toks)
    gap = float(((got - want).abs() - 2e-4 * want.abs()).max())
    out.update(pp=pp, pp_gap=gap)
    if not gap <= 2e-4:
        raise AssertionError(f"pp={pp} pipelined forward: |got - want| - 2e-4 |want| = {gap}")
    print(f"{tag}: pp={pp} pipelined forward matches dense ok", flush=True)
    return out


def _rank(rank, world, port, device, backend, out_path):
    from ..parallel.distributed import init_distributed, local_device, shutdown_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device=device, backend=backend)
    try:
        out = dryrun(local_device(device))
        if rank == 0 and out_path:
            with open(out_path, "w") as f:
                json.dump(out, f, indent=1)
    finally:
        shutdown_distributed()


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2, help="ranks (processes) to spawn")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl for cuda, gloo for the CPU)")
    ap.add_argument("--out", default=None, help="rank 0's summary as JSON")
    args = ap.parse_args(argv)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(args.world, port, args.device, args.backend, args.out),
                       nprocs=args.world, start_method="spawn")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
