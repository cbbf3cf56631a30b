"""End-to-end KD-QAT training runner (PyTorch port of the JAX package's
`train/pipeline.py:run_training`, single device).

Flow: the model (an HF checkpoint dir loaded in f32 through
`models/hf_import.py`, or an injected (params, cfg)) -> clip cache on the
student -> teacher (a frozen copy in the compute dtype) -> CAKLD beta -> the
KD train loop with gradient accumulation (stepwise or one fused call a
cycle) -> periodic checkpoints and eval -> the final consolidated save of
the f32 master in HF layout into `output_dir` (`save_hf_checkpoint`).
Checkpoints are the port's own format: one `torch.save` of a flat dict of
tensors (the params, the optimizer state's leaves and scalars, keyed by
their paths) plus the step, under `{output_dir}/step_{micro_step}`. Not
ported yet (ROADMAP A7): the orbax cross-format restore, multi-host. The
run's summary carries the final state, whose `master_params` a caller
packs.

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

from .._device import resolve_device, torch_dtype
from ..models.hf_import import load_hf_checkpoint, save_hf_checkpoint
from ..quant.autoclip import apply_clip_cache, load_clip_cache
from .data import Collator, SupervisedDataset, data_loader
from .losses import kd_loss
from .trainer import (
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


def _flatten_state(state: TrainState) -> dict:
    """A flat {path: tensor or int} dict of the whole train state."""
    flat: dict = {"step": state.step}

    def put(prefix, node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for field in node._fields:
                put(f"{prefix}/{field}", getattr(node, field))
        elif isinstance(node, dict):
            for path, leaf in tree_items(node):
                flat[prefix + "/" + "/".join(path)] = leaf.detach().cpu()
        else:
            flat[prefix] = node

    put("params", state.params)
    put("opt_state", state.opt_state)
    return flat


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState) -> str:
    """The FULL train state (params, optimizer moments and master, step)."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save(_flatten_state(state), os.path.join(path, "state.pt"))
    return path


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into a state of the same structure (leaves keep the
    template's dtype and device)."""
    flat = torch.load(os.path.join(path, "state.pt"), map_location="cpu")

    def take(prefix, node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(take(f"{prefix}/{f}", getattr(node, f)) for f in node._fields))
        if isinstance(node, dict):
            out: dict = {}
            for p, leaf in tree_items(node):
                val = flat[prefix + "/" + "/".join(p)].to(device=leaf.device, dtype=leaf.dtype)
                d = out
                for k in p[:-1]:
                    d = d.setdefault(k, {})
                d[p[-1]] = val
            return out
        return flat[prefix]

    return TrainState(params=take("params", state.params),
                      opt_state=take("opt_state", state.opt_state), step=flat["step"])


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
    total, n_rows = 0.0, 0
    for b in data_loader(eval_ds, collator, batch_size, shuffle=False, drop_last=False):
        n = b["input_ids"].shape[0]
        total += float(eval_step(state.params, to_device(b, device), beta)) * n
        n_rows += n
    return total / n_rows if n_rows else float("nan")


def run_training(args, *, tokenizer=None, model=None) -> dict:
    """args: the JAX package's CLI `train` namespace (the fields it reads),
    plus `device` (default "cuda"). The model loads from
    `args.model_name_or_path` in f32 unless model=(params, cfg) is given;
    the tokenizer through `transformers.AutoTokenizer` (imported only then)
    unless given. Returns {"final_loss", "steps", "state", "beta",
    "train_config"}."""
    if (getattr(args, "tp", None) or 1) > 1 or (getattr(args, "dp", None) or 1) > 1:
        raise NotImplementedError("the port trains on one device (dp = tp = 1)")
    device = resolve_device(getattr(args, "device", "cuda"))
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
    state = init_train_state(student_src, tc)
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
        beta = estimate_cakld_beta(teacher, cfg, batches)
        logger.info("CAKLD beta = %.4f", float(beta))

    step_fn = make_fused_train_step(cfg, tc) if tc.fused_accum else make_train_step(cfg, tc)
    micro_step = 0
    logs = []
    eval_step_fn = None
    os.makedirs(args.output_dir, exist_ok=True)
    metrics_f = open(os.path.join(args.output_dir, "metrics.jsonl"), "a", buffering=1)
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
        metrics_f.close()
    # the final consolidated save, from the f32 master when the optimizer
    # keeps one (bf16 latents)
    final = tree_map(lambda x: x.to(torch.float32), master_params(state))
    save_hf_checkpoint(final, cfg, args.output_dir)
    logger.info("saved final model to %s", args.output_dir)
    return {"final_loss": logs[-1] if logs else None, "steps": micro_step, "state": state,
            "beta": float(beta), "train_config": tc}
