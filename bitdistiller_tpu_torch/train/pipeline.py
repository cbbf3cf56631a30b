"""End-to-end KD-QAT training runner (PyTorch port of the JAX package's
`train/pipeline.py:run_training`).

Flow: join the process group the args name (none: one process) and lay
its ranks out as the (dp, tp) mesh (`make_hybrid_mesh`, `args.tp`) -> the
model (an HF checkpoint dir loaded in f32 through `models/hf_import.py`, or
an injected (params, cfg)) -> clip cache on the student -> teacher (a
frozen copy in the compute dtype, each rank's tp slice) -> CAKLD beta (the
mean over every dp rank's batches) -> the KD train loop with gradient
accumulation (stepwise or one fused call a cycle), each dp group on its
`host_shard` of the train set (its tp ranks read the same rows), the state
placed by tp and ZeRO (`zero_stage`, `parallel/zero.py`) -> periodic
checkpoints and a replicated eval -> the final consolidated save of the f32
master in HF layout into `output_dir` (`save_hf_checkpoint`, the master
gathered whole), by rank 0 while the others wait at a barrier.

Checkpoints are the port's own format, under
`{output_dir}/step_{micro_step}`: each rank writes the slices it holds
(`rank{r}.safetensors`) and rank 0 a `manifest.json` of every leaf's shape,
split dims and parts (`save_checkpoint`); nothing is gathered. A restore
reads, by memory map, the parts that its own placement needs, so a
checkpoint written at one dp, tp and ZeRO stage resumes at any other. A
checkpoint of another optimizer format resumes across it (`_migrate`:
stepwise and fused cycles, with bf16 or f32 latents). The JAX package's
orbax checkpoints, and its legacy optax format, have no port counterpart
and are not read. The run's summary carries the final state, whose
`master_params` a caller packs.

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
from ..models import safetensors_io
from ..models.hf_import import load_hf_checkpoint, save_hf_checkpoint
from ..parallel.distributed import (host_shard, init_distributed, local_device,
                                    make_hybrid_mesh, shutdown_distributed)
from ..parallel.mesh import param_specs_from_params, shard_params
from ..parallel.tensor import tp_config
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


def _walk(state: TrainState):
    """(key, value, which) for every leaf of the train state: tensors of the
    params ("params") and of the optimizer state's param-shaped trees
    ("opt"), ints (which None). Keys are the leaves' paths."""
    yield "step", state.step, None

    def walk(prefix, node, which):
        if _is_state_tuple(node):
            for field in node._fields:
                yield from walk(f"{prefix}/{field}", getattr(node, field), which)
        elif isinstance(node, dict):
            for path, leaf in tree_items(node):
                yield prefix + "/" + "/".join(path), (path, leaf), which
        else:
            yield prefix, node, None

    yield from walk("params", state.params, "params")
    yield from walk("opt_state", state.opt_state, "opt")


def _placement(z, path, which, shape) -> tuple:
    """(dp dim, tp dim, the whole leaf's shape, this rank's offset) of a
    leaf held as `shape` on this rank under the plan `z` (None: one
    process, the leaf whole)."""
    if z is None:
        return None, None, list(shape), [0] * len(shape)
    ddim, tdim = z.dims(which)[path], z.tdims[path]
    whole, offset = list(shape), [0] * len(shape)
    for d, n, r in ((ddim, z.world, z.rank), (tdim, z.tp, z.tp_rank)):
        if d is not None:
            whole[d], offset[d] = shape[d] * n, shape[d] * r
    return ddim, tdim, whole, offset


def _parts(ddim, tdim, whole, dp: int, tp: int) -> list:
    """Every part of a leaf in a checkpoint written on a (dp, tp) mesh:
    one a distinct slice, each written by the lowest rank that holds it
    (a leaf whole over dp by dp rank 0, one whole over tp by tp rank 0)."""
    out = []
    for i in range(dp if ddim is not None else 1):
        for j in range(tp if tdim is not None else 1):
            shape, offset = list(whole), [0] * len(whole)
            for d, n, r in ((ddim, dp, i), (tdim, tp, j)):
                if d is not None:
                    shape[d] //= n
                    offset[d] = shape[d] * r
            out.append({"file": f"rank{i * tp + j}.safetensors", "offset": offset,
                        "shape": shape})
    return out


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


MANIFEST = "manifest.json"


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState) -> str:
    """The FULL train state (params, optimizer moments and master, step)
    under `{ckpt_dir}/step_{step}`, each rank writing only the slices it
    holds, with no collective but the closing barrier: `rank{r}.safetensors`
    (a file of the port's safetensors writer, one leaf on the host at a
    time) holds rank r's ZeRO part of its tp slice of each leaf, and a leaf
    whole on several ranks is written by the lowest of them. Rank 0 also
    writes `manifest.json`: the step, dp, tp, ZeRO stage and optimizer
    format, the ints, and for each leaf its whole shape, dtype, the dims
    split over dp and tp, and each part's file, offset and shape."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    z = state.zero
    dp, tp = (1, 1) if z is None else (z.world, z.tp)
    mine: dict = {}
    leaves: dict = {}
    scalars: dict = {}
    for key, value, which in _walk(state):
        if which is None:
            scalars[key] = value
            continue
        p, leaf = value
        ddim, tdim, whole, _ = _placement(z, p, which, tuple(leaf.shape))
        if z is None or ((ddim is not None or z.rank == 0)
                         and (tdim is not None or z.tp_rank == 0)):
            mine[key] = leaf
        leaves[key] = {"shape": whole, "dtype": str(leaf.dtype).removeprefix("torch."),
                       "dp_dim": ddim, "tp_dim": tdim,
                       "parts": _parts(ddim, tdim, whole, dp, tp)}
    rank = dist.get_rank() if dist.is_initialized() else 0
    safetensors_io.write(os.path.join(path, f"rank{rank}.safetensors"), mine)
    if _rank0():
        manifest = {"step": step, "dp": dp, "tp": tp,
                    "zero_stage": None if z is None else z.stage,
                    "optimizer": type(state.opt_state).__name__, "scalars": scalars,
                    "leaves": leaves}
        tmp = os.path.join(path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, MANIFEST))
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


def _read_flat(path: str) -> dict:
    """{key: an int, or the leaf's manifest entry (its "key" added)} of a
    checkpoint; a checkpoint of the single-file format (`state.pt`, each
    leaf whole) reads too, its tensors memory-mapped."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        old = torch.load(os.path.join(path, "state.pt"), map_location="cpu", mmap=True)
        return {k: {"key": k, "shape": list(v.shape), "tensor": v}
                if isinstance(v, torch.Tensor) else v for k, v in old.items()}
    with open(mpath) as f:
        manifest = json.load(f)
    flat = dict(manifest["scalars"])
    flat.update({k: dict(e, key=k) for k, e in manifest["leaves"].items()})
    return flat


class _Parts:
    """The part files of one checkpoint, each memory-mapped at its first use."""

    def __init__(self, path: str):
        self.path, self.files = path, {}

    def fill(self, dst: torch.Tensor, entry: dict, offset: list) -> None:
        """Copy into dst, the box at `offset` of the whole leaf, the overlap
        of every part that meets it (each part read only there)."""
        if len(entry["shape"]) != dst.ndim or any(
                o + n > w for o, n, w in zip(offset, dst.shape, entry["shape"])):
            raise ValueError(f"{self.path}: {entry['key']} is {entry['shape']} in the "
                             f"checkpoint; this placement needs {list(dst.shape)} at {offset}")
        parts = ([(entry["tensor"], [0] * dst.ndim)] if "tensor" in entry
                 else [(p, p["offset"]) for p in entry["parts"]])
        for part, at in parts:
            box = []
            for d in range(dst.ndim):
                n = part["shape"][d] if isinstance(part, dict) else part.shape[d]
                lo, hi = max(offset[d], at[d]), min(offset[d] + dst.shape[d], at[d] + n)
                if lo >= hi:
                    break
                box.append((lo, hi))
            else:
                src = part if not isinstance(part, dict) else self._tensor(part["file"],
                                                                          entry["key"])
                d_view, s_view = dst, src
                for d, (lo, hi) in enumerate(box):
                    d_view = d_view.narrow(d, lo - offset[d], hi - lo)
                    s_view = s_view.narrow(d, lo - at[d], hi - lo)
                d_view.copy_(s_view)

    def _tensor(self, name: str, key: str) -> torch.Tensor:
        if name not in self.files:
            self.files[name] = safetensors_io.read(os.path.join(self.path, name))
        return self.files[name][key]


def read_checkpoint_leaf(path: str, key: str) -> torch.Tensor:
    """One whole leaf of a checkpoint (its path joined by "/", e.g.
    "opt_state/master/embed"), assembled on the host from its parts."""
    entry = _read_flat(path)[key]
    if "tensor" in entry:
        return entry["tensor"]
    out = torch.empty(entry["shape"], dtype=getattr(torch, entry["dtype"]))
    _Parts(path).fill(out, entry, [0] * out.ndim)
    return out


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into a state of the same structure, in place: each
    leaf's slice that this rank's placement holds (its dp and tp parts under
    the template's ZeRO plan) is copied into the template's tensor from the
    memory-mapped part files that hold it (its dtype and device kept; no
    second copy of the state on the device, and no rank reads more than its
    slices). The checkpoint may have been written at any dp, tp and ZeRO
    stage; another optimizer format migrates."""
    flat = _migrate(_read_flat(path), state.opt_state, path)
    z = state.zero
    parts = _Parts(path)

    def take(prefix, node, which):
        if _is_state_tuple(node):
            return type(node)(*(take(f"{prefix}/{f}", getattr(node, f), which)
                                for f in node._fields))
        if isinstance(node, dict):
            out: dict = {}
            for p, leaf in tree_items(node):
                val = flat[prefix + "/" + "/".join(p)]
                d = out
                for k in p[:-1]:
                    d = d.setdefault(k, {})
                dst = leaf.detach()
                if val is _ZEROS:
                    dst.zero_()
                else:
                    parts.fill(dst, val, _placement(z, p, which, tuple(dst.shape))[3])
                d[p[-1]] = dst
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


def make_eval_step(cfg, tc: TrainConfig, teacher, mesh=None):
    """The eval loss on the training quantization grid (`mesh`: the params
    and the teacher are tp slices)."""
    from ..models import llama

    quantizer = make_quantizer(tc)

    @torch.no_grad()
    def eval_step(params, batch, beta):
        s_logits, _ = llama.forward(params, cfg, batch["input_ids"], quantizer=quantizer,
                                    attn_mask=batch["attention_mask"], mesh=mesh)
        t_logits, _ = llama.forward(teacher, cfg, batch["input_ids"],
                                    attn_mask=batch["attention_mask"], mesh=mesh)
        return kd_loss(tc.kd_loss_type, batch["labels"], s_logits, t_logits, beta=beta)

    return eval_step


def evaluate(state, cfg, tc, teacher, eval_ds, collator, batch_size, beta, device,
             eval_step=None) -> float:
    """Mean eval loss over rows (batches of `batch_size`, the last one short)."""
    if eval_step is None:
        eval_step = make_eval_step(cfg, tc, teacher,
                                   None if state.zero is None else state.zero.mesh)
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
    device, and leaves it at the end; `tp` (default 1) splits every layer
    over that many ranks of a dp group, and `zero_stage` (default 2, as the
    CLI) places the state over dp. Returns {"final_loss", "steps", "state", "master",
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
    group = mesh.dp_group
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
    tp_config(cfg, mesh.tp)  # whole heads, MLP columns and vocab rows a tp rank
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
        # each dp group feeds its own contiguous, equal slice; eval stays replicated
        train_ds = SupervisedDataset(
            sources=host_shard(train_ds.sources, mesh.dp_rank, mesh.dp),
            targets=host_shard(train_ds.targets, mesh.dp_rank, mesh.dp))
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
        if mesh.tp > 1:
            teacher = shard_params(teacher, mesh, param_specs_from_params(teacher))
    state = init_train_state(student_src, tc, group=group,
                             zero_stage=getattr(args, "zero_stage", 2), mesh=mesh)
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
        beta = estimate_cakld_beta(teacher, cfg, batches, group=group, mesh=mesh)
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
            eval_step_fn = make_eval_step(cfg, tc, teacher, mesh)
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
                        eval_step_fn = make_eval_step(cfg, tc, teacher, mesh)
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
