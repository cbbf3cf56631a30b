"""End-to-end KD-QAT training runner (PyTorch port of the JAX package's
`train/pipeline.py:run_training`).

Flow: join the process group the args name (none: one process) -> the
model (an HF checkpoint dir loaded in f32 through `models/hf_import.py`, or
an injected (params, cfg)) -> clip cache on the student -> teacher (a
frozen copy in the compute dtype, whole on every rank) -> CAKLD beta (the
mean over every rank's batches) -> the KD train loop with gradient
accumulation (stepwise or one fused call a cycle), each rank on its
`host_shard` of the train set, the state placed by ZeRO (`zero_stage`,
`parallel/zero.py`) -> periodic checkpoints and a replicated eval -> the
final consolidated save of the f32 master in HF layout into `output_dir`
(`save_hf_checkpoint`), by rank 0 while the others wait at a barrier.

Checkpoints are the port's own format: one `torch.save` of a flat dict of
tensors (the params, the optimizer state's leaves and scalars, keyed by
their paths) plus the step, under `{output_dir}/step_{micro_step}`. Under
ZeRO they are gathered whole and written by rank 0, so a checkpoint written
at one dp and stage resumes at any other. A checkpoint of another optimizer
format resumes across it (`_migrate`: stepwise and fused cycles, with bf16
or f32 latents). The JAX package's orbax checkpoints, and its legacy optax
format, have no port counterpart and are not read. The run's summary
carries the final state, whose `master_params` a caller packs.

Cadence (inherited fault C4, kept as the JAX package has it): logging,
saving and eval count micro-steps, and in the fused mode they are checked
only when a cycle completes.
"""

from __future__ import annotations

import json
import logging
import os
import time
import torch
import torch.distributed as dist

from .._device import resolve_device, torch_dtype
from ..models.hf_import import load_hf_checkpoint, save_hf_checkpoint
from ..parallel.distributed import (host_shard, init_distributed, local_device,
                                    make_hybrid_mesh, shutdown_distributed)
from ..quant.autoclip import apply_clip_cache, load_clip_cache
from ..utils.debug import checked, enabled as debug_enabled
from .data import Collator, SupervisedDataset, data_loader
from .losses import kd_loss
from .trainer import (
    AdamWState,
    MasterAccumState,
    MasterWeightsState,
    MultiStepsState,
    TrainConfig,
    TrainState,
    estimate_cakld_beta,
    init_train_state,
    make_fused_train_step,
    make_quantizer,
    make_train_step,
    master_params,
    to_device,
    tree_items,
    tree_map,
)

logger = logging.getLogger(__name__)


def _is_state_tuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_state(state: TrainState, keep: bool = True) -> dict:
    """A flat {path: tensor or int} dict of the whole train state, each leaf
    whole (gathered leaf by leaf under ZeRO, a collective on every rank);
    keep=False gathers without keeping the host copies."""
    z = state.zero
    flat: dict = {"step": state.step}

    def put(prefix, node, which):
        if _is_state_tuple(node):
            for field in node._fields:
                put(f"{prefix}/{field}", getattr(node, field), which)
        elif isinstance(node, dict):
            dims = None if z is None else z.dims(which)
            for path, leaf in tree_items(node):
                whole = leaf if dims is None else z.gather(leaf, dims[path])
                if keep:
                    flat[prefix + "/" + "/".join(path)] = whole.detach().cpu()
        else:
            flat[prefix] = node

    put("params", state.params, "params")
    put("opt_state", state.opt_state, "opt")
    return flat


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState) -> str:
    """The FULL train state (params, optimizer moments and master, step),
    written by rank 0; every rank takes part in the gathers and waits.
    Rank 0 holds the whole state in host memory while it writes: 18 bytes
    a parameter in KD with bf16 latents (about 121 GB for a 7B model)."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    flat = _flatten_state(state, keep=_rank0())
    if _rank0():
        os.makedirs(path, exist_ok=True)
        torch.save(flat, os.path.join(path, "state.pt"))
    if dist.is_initialized():
        dist.barrier()
    return path


_ZEROS = "zeros"  # a leaf _migrate starts empty: restore zeroes the template's tensor


def _migrate(flat: dict, opt_state, path: str) -> dict:
    """A checkpoint of another optimizer format, moved into the template's
    (JAX `_restore_cross_format`; every format holds the same Adam state,
    and the accumulator is dropped, or started empty, at the cycle
    boundary where checkpoints are written):
    - stepwise `MasterAccumState` (bf16 latents, grad_accum > 1) <-> the
      fused cycle's `MasterWeightsState`;
    - stepwise `MultiStepsState` (f32 latents) <-> the fused cycle's plain
      `AdamWState` (its gradient_step taken as Adam's count)."""
    fields = {k.split("/")[1] for k in flat if k.startswith("opt_state/")}
    out = dict(flat)
    if isinstance(opt_state, MasterWeightsState) and "acc" in fields:
        for k in [k for k in out if k.startswith(("opt_state/acc/", "opt_state/count"))]:
            del out[k]
    elif isinstance(opt_state, MasterAccumState) and "acc" not in fields:
        for k, v in flat.items():
            if k.startswith("opt_state/master/"):
                out["opt_state/acc/" + k[len("opt_state/master/"):]] = _ZEROS
        out["opt_state/count"] = 0
    elif isinstance(opt_state, AdamWState) and "inner" in fields:
        out = {k: v for k, v in flat.items() if not k.startswith("opt_state/")}
        for k, v in flat.items():
            if k.startswith("opt_state/inner/"):
                out["opt_state/" + k[len("opt_state/inner/"):]] = v
    elif isinstance(opt_state, MultiStepsState) and "mini_step" not in fields:
        out = {k: v for k, v in flat.items() if not k.startswith("opt_state/")}
        for k, v in flat.items():
            if k.startswith("opt_state/"):
                out["opt_state/inner/" + k[len("opt_state/"):]] = v
            if k.startswith("opt_state/mu/"):
                out["opt_state/acc_grads/" + k[len("opt_state/mu/"):]] = _ZEROS
        out.update({"opt_state/mini_step": 0, "opt_state/gradient_step": flat["opt_state/count"]})
    else:
        return flat
    logger.warning("migrated optimizer state from %s into %s (accumulator reset at a cycle "
                   "boundary)", path, type(opt_state).__name__)
    return out


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into a state of the same structure, in place: each
    leaf is copied into the template's tensor (its dtype and device kept;
    no second copy of the state on the device). The file is memory-mapped,
    so under ZeRO each rank reads only its part of the whole leaves it
    holds. Another optimizer format migrates."""
    flat = _migrate(torch.load(os.path.join(path, "state.pt"), map_location="cpu", mmap=True),
                    state.opt_state, path)
    z = state.zero

    def take(prefix, node, which):
        if _is_state_tuple(node):
            return type(node)(*(take(f"{prefix}/{f}", getattr(node, f), which)
                                for f in node._fields))
        if isinstance(node, dict):
            dims = None if z is None else z.dims(which)
            out: dict = {}
            for p, leaf in tree_items(node):
                val = flat[prefix + "/" + "/".join(p)]
                d = out
                for k in p[:-1]:
                    d = d.setdefault(k, {})
                if val is _ZEROS:
                    d[p[-1]] = leaf.detach().zero_()
                else:
                    d[p[-1]] = leaf.detach().copy_(val if dims is None else z.view(val, dims[p]))
            return out
        return flat[prefix]

    return TrainState(params=take("params", state.params, "params"),
                      opt_state=take("opt_state", state.opt_state, "opt"), step=flat["step"],
                      zero=z)


def latest_checkpoint(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    if not steps:
        return None
    s = max(steps)
    return os.path.join(ckpt_dir, f"step_{s}"), s


def make_eval_step(cfg, tc: TrainConfig, teacher):
    """The eval loss on the training quantization grid."""
    from ..models import llama

    quantizer = make_quantizer(tc)

    @torch.no_grad()
    def eval_step(params, batch, beta):
        s_logits, _ = llama.forward(params, cfg, batch["input_ids"], quantizer=quantizer,
                                    attn_mask=batch["attention_mask"])
        t_logits, _ = llama.forward(teacher, cfg, batch["input_ids"],
                                    attn_mask=batch["attention_mask"])
        return kd_loss(tc.kd_loss_type, batch["labels"], s_logits, t_logits, beta=beta)

    return eval_step


def evaluate(state, cfg, tc, teacher, eval_ds, collator, batch_size, beta, device,
             eval_step=None) -> float:
    """Mean eval loss over rows (batches of `batch_size`, the last one short)."""
    if eval_step is None:
        eval_step = make_eval_step(cfg, tc, teacher)
    params = state.params if state.zero is None else state.zero.gather_tree(state.params, "params")
    total, n_rows = 0.0, 0
    for b in data_loader(eval_ds, collator, batch_size, shuffle=False, drop_last=False):
        n = b["input_ids"].shape[0]
        total += float(eval_step(params, to_device(b, device), beta)) * n
        n_rows += n
    return total / n_rows if n_rows else float("nan")


def run_training(args, *, tokenizer=None, model=None) -> dict:
    """args: the JAX package's CLI `train` namespace (the fields it reads),
    plus `device` (default "cuda"). The model loads from
    `args.model_name_or_path` in f32 unless model=(params, cfg) is given;
    the tokenizer through `transformers.AutoTokenizer` (imported only then)
    unless given. With `coordinator_address`, `num_processes` and
    `process_id` (or torchrun's variables) the process joins a group of
    that many ranks (NCCL on the card, gloo on the CPU), each on its own
    device, and leaves it at the end; `zero_stage` (default 2, as the CLI)
    places the state. Returns {"final_loss", "steps", "state", "master",
    "beta", "train_config"}: "master" the whole f32 master (the final
    save's tree); "state" as placed, whose ZeRO collectives end with the
    group."""
    device = resolve_device(getattr(args, "device", "cuda"))
    fresh = not dist.is_initialized()
    joined = init_distributed(getattr(args, "coordinator_address", None),
                              getattr(args, "num_processes", None),
                              getattr(args, "process_id", None), device=device)
    try:
        return _run(args, local_device(device), tokenizer, model)
    finally:
        if fresh and joined:  # a group this call joined is left at its end
            shutdown_distributed()


def _run(args, device, tokenizer, model) -> dict:
    mesh = make_hybrid_mesh(tp=getattr(args, "tp", None) or 1, dp=getattr(args, "dp", None))
    group = dist.group.WORLD if dist.is_initialized() else None
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path, use_fast=True)
        if tokenizer.pad_token is None:
            tokenizer.pad_token = tokenizer.eos_token
    if model is None:
        params, cfg = load_hf_checkpoint(args.model_name_or_path, dtype=torch.float32,
                                         device=device)
    else:
        params, cfg = model
        params = tree_map(lambda x: x.to(device), params)
    student_src = params
    if args.clip:
        # the clip cache shapes the student only; the teacher stays unclipped
        student_src = apply_clip_cache(params, load_clip_cache(args.clip))

    tok = tokenizer
    train_ds = SupervisedDataset.from_jsonl(args.data_path, tok.eos_token,
                                            args.max_train_samples, "train", args.seed)
    eval_ds = SupervisedDataset.from_jsonl(args.data_path, tok.eos_token,
                                           args.max_train_samples, "eval", args.seed)
    if mesh.dp > 1:
        # each rank feeds its own contiguous, equal slice; eval stays replicated
        train_ds = SupervisedDataset(sources=host_shard(train_ds.sources),
                                     targets=host_shard(train_ds.targets))
    collator = Collator(tok, model_max_length=args.model_max_length)

    steps_per_epoch = max(len(train_ds) // args.per_device_train_batch_size, 1)
    total_micro = steps_per_epoch * args.num_train_epochs
    tc = TrainConfig(
        bits=args.bits, q_group_size=args.q_group_size, quant_type=args.quant_type,
        train_kd=args.train_kd, kd_loss_type=args.kd_loss_type, cakld_steps=args.cakld_steps,
        learning_rate=args.learning_rate,
        lr_scheduler="cosine" if "cosine" in args.lr_scheduler_type else "constant",
        warmup_ratio=args.warmup_ratio,
        total_steps=max(total_micro // args.gradient_accumulation_steps, 1),
        grad_accum=args.gradient_accumulation_steps,
        param_dtype=getattr(args, "param_dtype", "bfloat16"),
        remat_policy=getattr(args, "remat_policy", "full"),
        fused_accum=(getattr(args, "fused_accum", False)
                     and args.gradient_accumulation_steps > 1),
        teacher_flash=getattr(args, "teacher_flash", None),
    )

    teacher = None
    if tc.train_kd:
        cdt = torch_dtype(cfg.dtype)  # the teacher rides in the compute dtype
        teacher = tree_map(lambda x: x.to(cdt) if x.is_floating_point() else x, params)
    state = init_train_state(student_src, tc, group=group,
                             zero_stage=getattr(args, "zero_stage", 2))
    # the loaded tree is freed here unless the teacher shares its tensors
    # (compute dtype f32) or the caller holds it (an injected model)
    del params, student_src

    start_step = 0
    if args.resume:
        found = latest_checkpoint(args.output_dir)
        if found:
            path, start_step = found
            logger.info("resuming from %s", path)
            state = restore_checkpoint(path, state)

    beta = torch.zeros((), dtype=torch.float32, device=device)
    if tc.train_kd and tc.kd_loss_type == "cakld":
        batches = []
        for i, b in enumerate(data_loader(train_ds, collator, args.per_device_train_batch_size,
                                          shuffle=False)):
            if i >= tc.cakld_steps:
                break
            batches.append(to_device(b, device))
        beta = estimate_cakld_beta(teacher, cfg, batches, group=group)
        logger.info("CAKLD beta = %.4f", float(beta))

    step_fn = make_fused_train_step(cfg, tc) if tc.fused_accum else make_train_step(cfg, tc)
    if debug_enabled():
        # BITDISTILLER_DEBUG=1: NaN/Inf in the backward or in the step's
        # outputs raises, naming every non-finite leaf (JAX `checked`)
        step_fn = checked(step_fn)
    micro_step = 0
    logs = []
    eval_step_fn = None
    os.makedirs(args.output_dir, exist_ok=True)
    metrics_f = (open(os.path.join(args.output_dir, "metrics.jsonl"), "a", buffering=1)
                 if _rank0() else None)
    try:
        if (getattr(args, "eval_on_start", False) and len(eval_ds) and teacher is not None
                and start_step == 0):
            eval_step_fn = make_eval_step(cfg, tc, teacher)
            ev = evaluate(state, cfg, tc, teacher, eval_ds, collator,
                          args.per_device_train_batch_size, beta, device, eval_step_fn)
            logger.info("eval loss (step 0) %.4f", ev)
        t0 = time.time()
        skip = start_step  # resume: replay the same shuffles, skip the done micro-steps
        fuse_buf: list = []
        for epoch in range(args.num_train_epochs):
            for batch in data_loader(train_ds, collator, args.per_device_train_batch_size,
                                     shuffle=True, seed=args.seed + epoch):
                if skip > 0:
                    skip -= 1
                    micro_step += 1
                    continue
                if tc.fused_accum:
                    fuse_buf.append(to_device(batch, device))
                    micro_step += 1
                    if len(fuse_buf) < tc.grad_accum:
                        continue  # tail micros of a partial cycle are dropped
                    state, metrics = step_fn(state, fuse_buf, beta, teacher)
                    fuse_buf = []
                else:
                    state, metrics = step_fn(state, to_device(batch, device), beta, teacher)
                    micro_step += 1
                if micro_step % args.logging_steps == 0:
                    loss = float(metrics["loss"])
                    logs.append(loss)
                    per_step = (time.time() - t0) / max(micro_step - start_step, 1)
                    logger.info("step %d/%d loss %.4f (%.2fs/step)", micro_step, total_micro,
                                loss, per_step)
                    if metrics_f is not None:
                        metrics_f.write(json.dumps({
                            "step": micro_step, "epoch": epoch, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds_per_step": per_step}) + "\n")
                if args.save_steps and micro_step % args.save_steps == 0:
                    save_checkpoint(args.output_dir, micro_step, state)
                if (args.eval_steps and micro_step % args.eval_steps == 0 and len(eval_ds)
                        and teacher is not None):
                    if eval_step_fn is None:
                        eval_step_fn = make_eval_step(cfg, tc, teacher)
                    ev = evaluate(state, cfg, tc, teacher, eval_ds, collator,
                                  args.per_device_train_batch_size, beta, device, eval_step_fn)
                    logger.info("eval loss %.4f", ev)
    finally:
        if metrics_f is not None:
            metrics_f.close()
    # the final consolidated save, from the f32 master when the optimizer
    # keeps one (bf16 latents); gathered on every rank, written by rank 0
    final = tree_map(lambda x: x.to(torch.float32), master_params(state))
    if _rank0():
        save_hf_checkpoint(final, cfg, args.output_dir)
        logger.info("saved final model to %s", args.output_dir)
    if dist.is_initialized():
        dist.barrier()
    return {"final_loss": logs[-1] if logs else None, "steps": micro_step, "state": state,
            "master": final, "beta": float(beta), "train_config": tc}
