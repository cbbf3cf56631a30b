"""KD-QAT training step: teacher + fake-quantized student with CAKLD
(PyTorch port of the JAX package's `train/trainer.py`).

The optimizer is optax's `chain(clip_by_global_norm, adamw)` restated
exactly: the clip has no epsilon (g * max_norm / |g| once |g| >= max_norm),
Adam's bias corrections are computed in f32, weight decay is added to the
Adam direction for every leaf and multiplied by the scheduled learning
rate. The mixed-precision wrappers are the JAX package's: `with_f32_master`
(f32 master weights and f32 gradient math; the bf16 latents are
`master.to(bf16)`, derived again after every update),
`with_f32_master_accum` (f32 accumulation, Adam and the master sweep only on
cycle boundaries) and `multi_steps` (optax.MultiSteps, for f32 latents).
The optimizer state is updated in place (the state handed to a step is
consumed, as the JAX step donates it).

`state.step` counts what the JAX package counts: micro-steps in
`make_train_step`, optimizer cycles in `make_fused_train_step` (inherited
fault C4, kept and pinned by tests/test_torch_trainer.py).

Data parallelism: `init_train_state(..., group=, zero_stage=)` places the
state over a process group (`parallel/zero.py`, ZeRO 0/2/3) and the steps
then average the gradients over the ranks, each rank feeding its own rows.
Tensor parallelism: with `mesh=` (tp > 1) each rank holds its tp slice of
the latents and the optimizer state, ZeRO runs over the mesh's dp group,
and the forwards (student and teacher, the teacher handed over as the same
slice) issue the tp collectives (`models/llama.py:forward(mesh=)`); the tp
ranks of a dp group feed the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import torch_dtype
from ..models import llama
from ..models.config import ModelConfig
from ..quant.core import make_weight_quantizer
from .losses import IGNORE_INDEX, kd_loss


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig: same fields, same defaults."""

    bits: int = 2
    q_group_size: int = 128
    quant_type: str = "int2-asym"
    train_kd: bool = True
    kd_loss_type: str = "cakld"
    kd_tmp: float = 1.0
    cakld_steps: int = 10
    learning_rate: float = 8e-6
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.0
    lr_scheduler: str = "constant"
    total_steps: int = 1000
    grad_accum: int = 1
    fused_accum: bool = False
    max_grad_norm: float = 1.0
    gradient_checkpointing: bool = True
    remat_policy: str = "full"
    teacher_flash: Optional[bool] = None
    kd_loss_scale: float = 1.0
    param_dtype: str = "bfloat16"


def latent_dtype(tc: TrainConfig) -> torch.dtype:
    return torch_dtype(tc.param_dtype)


# ---- trees of tensors (nested dicts; leaves in sorted-key order, as JAX's) ----


def tree_items(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of the f32 sum of squares (optax's
    global_norm on f32 leaves)."""
    total = None
    for g in leaves:
        s = torch.sum(g.to(torch.float32) ** 2)
        total = s if total is None else total + s
    return torch.sqrt(total)


# ---- schedules (optax's, restated) ------------------------------------------


def make_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate in f32: optax's warmup_cosine_decay_schedule,
    linear_schedule or constant_schedule as the JAX package builds them."""
    lr = tc.learning_rate
    warmup = int(tc.warmup_ratio * tc.total_steps)
    f32 = np.float32

    def linear(count, init, end, steps):
        if steps <= 0:
            return f32(init)
        c = f32(min(max(count, 0), steps))
        frac = f32(1) - c / f32(steps)
        return f32(f32(init - end) * frac + f32(end))

    def cosine(count, init, decay_steps):
        c = f32(min(count, decay_steps))
        decayed = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return f32(f32(init) * decayed)

    if tc.lr_scheduler == "cosine":
        w = max(warmup, 1) if warmup else 0
        init = 0.0 if warmup else lr
        if tc.total_steps - w <= 0:
            raise ValueError("the cosine schedule needs total_steps above the warmup")
        return lambda count: (linear(count, init, lr, w) if count < w
                              else cosine(count - w, lr, tc.total_steps - w))
    if warmup:
        return lambda count: linear(count, 0.0, lr, warmup)
    return lambda count: f32(lr)


# ---- the optimizer ------------------------------------------------------------


class AdamWState(NamedTuple):
    """chain(clip_by_global_norm, adamw)'s state: Adam's count and moments,
    the schedule's count."""

    count: int
    mu: dict
    nu: dict
    sched_count: int


class MasterWeightsState(NamedTuple):
    master: dict
    inner: Any


class MasterAccumState(NamedTuple):
    master: dict
    acc: dict
    count: int  # micro-steps accumulated since the last update (0: just moved)
    inner: Any


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner: Any
    acc_grads: dict


def _f32_like(tree) -> dict:
    return tree_map(lambda x: x.detach().to(torch.float32).clone(), tree)


def _zeros_like(tree, dtype=None) -> dict:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def _leaf_norm(items) -> torch.Tensor:
    return global_norm([g for _, g in items])


class ClipAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay)). `norm` maps [(path, grad)] to the global norm the
    clip decides on (under ZeRO, the whole gradient's over the ranks)."""

    def __init__(self, tc: TrainConfig, norm=None):
        self.tc = tc
        self.schedule = make_schedule(tc)
        self.norm = norm or _leaf_norm

    def init(self, params) -> AdamWState:
        return AdamWState(0, _zeros_like(params), _zeros_like(params), 0)

    def update(self, grads: dict, state: AdamWState, params: dict, g_norm=None):
        """`g_norm`: these grads' global norm, where the caller has it."""
        tc = self.tc
        b1, b2 = tc.adam_b1, tc.adam_b2
        items = tree_items(grads)
        if g_norm is None:
            g_norm = self.norm(items)
        clip = not bool(g_norm < tc.max_grad_norm)
        count = state.count + 1
        bc1 = 1 - np.float32(b1) ** np.float32(count)
        bc2 = 1 - np.float32(b2) ** np.float32(count)
        step = -np.float32(self.schedule(state.sched_count))
        mu, nu = state.mu, state.nu
        updates = {}
        for path, g in items:
            if clip:
                g = (g / g_norm.to(g.dtype)) * tc.max_grad_norm
            m = _get(mu, path)
            v = _get(nu, path)
            m_new = (1 - b1) * g + b1 * m
            v_new = (1 - b2) * (g * g) + b2 * v
            _set(mu, path, m_new)
            _set(nu, path, v_new)
            u = (m_new / float(bc1)) / (torch.sqrt(v_new / float(bc2)) + tc.adam_eps)
            if tc.weight_decay:
                u = u + tc.weight_decay * _get(params, path)
            _set(updates, path, float(step) * u)
        return updates, AdamWState(count, mu, nu, state.sched_count + 1)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class WithF32Master:
    """f32 master weights and f32 gradient math around `inner`."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params) -> MasterWeightsState:
        master = _f32_like(params)
        return MasterWeightsState(master, self.inner.init(master))

    def update(self, grads, state: MasterWeightsState, params=None, g_norm=None):
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        upd, inner = self.inner.update(g32, state.inner, state.master, g_norm)
        for path, u in tree_items(upd):
            _set(state.master, path, _get(state.master, path) + u)
        return None, MasterWeightsState(state.master, inner)


class WithF32MasterAccum:
    """f32 master and f32 accumulation; the inner update and the master move
    only on every k-th micro-step, on the mean of the accumulated grads."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params) -> MasterAccumState:
        master = _f32_like(params)
        return MasterAccumState(master, _zeros_like(master), 0, self.inner.init(master))

    def update(self, grads, state: MasterAccumState, params=None, g_norm=None):
        # g_norm (the micro-step's) is not the norm of the mean the inner update sees
        for path, g in tree_items(grads):
            _set(state.acc, path, _get(state.acc, path) + g.to(torch.float32))
        count = state.count + 1
        if count < self.k:
            return None, MasterAccumState(state.master, state.acc, count, state.inner)
        mean_g = tree_map(lambda a: a / self.k, state.acc)
        upd, inner = self.inner.update(mean_g, state.inner, state.master)
        for path, u in tree_items(upd):
            _set(state.master, path, _get(state.master, path) + u)
        acc = _zeros_like(state.acc)
        return None, MasterAccumState(state.master, acc, 0, inner)


class MultiSteps:
    """optax.MultiSteps(inner, every_k) with its running-mean accumulation;
    the emitted update is zero except on the k-th micro-step."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params) -> MultiStepsState:
        return MultiStepsState(0, 0, self.inner.init(params), _zeros_like(params))

    def update(self, grads, state: MultiStepsState, params=None, g_norm=None):
        # g_norm (the micro-step's) is not the norm of the mean the inner update sees
        n = state.mini_step
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state.acc_grads)
        if n != self.k - 1:
            zeros = _zeros_like(grads)
            return zeros, MultiStepsState(n + 1, state.gradient_step, state.inner, acc)
        upd, inner = self.inner.update(acc, state.inner, params)
        return upd, MultiStepsState(0, state.gradient_step + 1, inner, _zeros_like(acc))


def make_optimizer(tc: TrainConfig, norm=None):
    """The JAX package's make_optimizer: the same wrappers, chosen alike."""
    opt = ClipAdamW(tc, norm)
    latent_is_f32 = latent_dtype(tc) == torch.float32
    if tc.fused_accum:
        return opt if latent_is_f32 else WithF32Master(opt)
    if tc.grad_accum > 1 and not latent_is_f32:
        return WithF32MasterAccum(opt, tc.grad_accum)
    if tc.grad_accum > 1:
        opt = MultiSteps(opt, tc.grad_accum)
    if not latent_is_f32:
        opt = WithF32Master(opt)
    return opt


def make_quantizer(tc: TrainConfig):
    """Weight quantizer of the training and eval forwards: groups along the
    input-feature (K) axis of the [K, N] weights."""
    return make_weight_quantizer(tc.quant_type, tc.q_group_size)


@dataclasses.dataclass
class TrainState:
    params: dict  # student latent weights (this rank's parts under ZeRO-3)
    opt_state: Any
    step: int
    zero: Any = None  # parallel.zero.ZeroPlan under a process group


def init_train_state(params, tc: TrainConfig, *, group=None, zero_stage: int = 0,
                     mesh=None) -> TrainState:
    """Latents in tc.param_dtype (fresh tensors: the step updates the state in
    place, so it never aliases the caller's tree) and the optimizer state.

    With a process group, the state is placed over its ranks at
    `zero_stage` (JAX `trainer.py:263-280`): 0 replicates it; 2 splits the
    f32 master, Adam's moments and the accumulators; 3 splits the latents
    too. Integer counters are replicated. With a mesh, ZeRO runs over its
    dp group (`group` is ignored), and at tp > 1 `params` (the whole tree)
    is cut to this rank's tp slice first."""
    dt = latent_dtype(tc)
    if mesh is not None:
        group = mesh.dp_group
    if mesh is not None and mesh.tp > 1:
        from ..parallel.mesh import param_specs_from_params, shard_params

        check_tp_groups(params, tc, mesh.tp)
        params = shard_params(params, mesh, param_specs_from_params(params))
    latent = tree_map(lambda x: x.detach().to(dt).clone() if x.is_floating_point() else x,
                      params)
    if group is None:
        return TrainState(params=latent, opt_state=make_optimizer(tc).init(latent), step=0)
    from ..parallel.zero import ZeroPlan

    opt = make_optimizer(tc)
    plan = ZeroPlan(latent, zero_stage, opt, group, mesh)
    opt_state = opt.init(plan.shard_tree(latent, "opt"))
    return TrainState(params=plan.shard_tree(latent, "params"), opt_state=opt_state, step=0,
                      zero=plan)


def master_params(state: TrainState) -> dict:
    """The f32 master copy when the optimizer keeps one, else the params;
    whole (gathered from every rank, a collective) under ZeRO and tp."""
    z = state.zero
    if isinstance(state.opt_state, (MasterWeightsState, MasterAccumState)):
        m = state.opt_state.master
        return m if z is None else z.gather_tp(z.gather_tree(m, "opt"))
    return state.params if z is None else z.gather_tp(z.gather_tree(state.params, "params"))


def check_tp_groups(params: dict, tc: TrainConfig, tp: int) -> None:
    """A row-parallel weight's quantization groups must not straddle a
    shard edge: K / tp must be whole groups (and per-channel groups, which
    span K, cannot split)."""
    from ..parallel.mesh import ROW_PARALLEL

    if tp == 1 or not tc.quant_type:
        return
    for name in ROW_PARALLEL:
        leaf = params["layers"].get(name)
        if leaf is None:
            continue
        k = leaf["w"].shape[-2]
        if tc.q_group_size <= 0 or (k // tp) % tc.q_group_size:
            raise ValueError(f"{name}: K = {k} over tp = {tp} leaves {k // tp} rows, not whole "
                             f"quantization groups of {tc.q_group_size}: a group would "
                             f"straddle a shard edge")


def _student_remat(tc: TrainConfig, quantizer):
    if (tc.gradient_checkpointing and quantizer is not None
            and tc.remat_policy in ("save_quantized", "save_dots", "save_qkvo")):
        return tc.remat_policy
    return tc.gradient_checkpointing


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch -> int64 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def _kd_or_ce_loss(cfg, tc: TrainConfig, params, batch, beta, teacher_params, *,
                   quantizer, student_remat, mesh=None):
    """Per-micro-batch KD (CAKLD etc.) or plain-CE loss."""
    student_logits, _ = llama.forward(
        params, cfg, batch["input_ids"], quantizer=quantizer,
        attn_mask=batch.get("attention_mask"), remat=student_remat, mesh=mesh,
    )
    if teacher_params is not None and tc.train_kd:
        with torch.no_grad():
            teacher_logits, _ = llama.forward(
                teacher_params, cfg, batch["input_ids"], attn_mask=batch.get("attention_mask"),
                use_train_flash=tc.teacher_flash, mesh=mesh,
            )
        return tc.kd_loss_scale * kd_loss(
            tc.kd_loss_type, batch["labels"], student_logits, teacher_logits,
            beta=beta, temperature=tc.kd_tmp,
        )
    labels = batch["labels"]
    shift_logits = student_logits[:, :-1]
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)


def _grads(loss, params) -> dict:
    """d loss / d every floating leaf of params, as a tree."""
    items = [(p, x) for p, x in tree_items(params) if x.requires_grad]
    gs = torch.autograd.grad(loss, [x for _, x in items])
    out: dict = {}
    for (path, _), g in zip(items, gs):
        _set(out, path, g)
    return out


def _with_grad(params) -> dict:
    return tree_map(lambda x: x.detach().requires_grad_(True) if x.is_floating_point() else x,
                    params)


def _new_params(state_params, opt_state, updates, opt_params=None, zero=None) -> dict:
    """The latents after an update: master.to(latent dtype) for the master
    wrappers (only on a cycle boundary for the accumulating one), else
    params + updates (`opt_params`: the latents as the optimizer saw them,
    by default the state's). Under ZeRO these are made on this rank's parts
    and placed back."""
    if isinstance(opt_state, MasterAccumState) and opt_state.count != 0:
        return state_params
    if opt_params is None:
        opt_params = state_params
    if isinstance(opt_state, (MasterAccumState, MasterWeightsState)):
        new = tree_map(lambda m, p: m.to(p.dtype), opt_state.master, opt_params)
    else:
        new = tree_map(lambda p, u: (p + u).to(p.dtype), opt_params, updates)
    return new if zero is None else zero.latents_from(new)


def _dp_inputs(state: TrainState):
    """(whole latents for the forward, the latents as the optimizer sees
    them): under ZeRO-3 a gather of the latents; the optimizer's view is
    this rank's own parts or views of the whole leaves, never a copy (the
    master wrappers read only its dtype)."""
    z = state.zero
    if z is None:
        return state.params, state.params
    full = z.gather_tree(state.params, "params")
    if isinstance(state.opt_state, (MasterWeightsState, MasterAccumState)):
        return full, state.params
    return full, z.opt_parts(full, state.params)


def _mesh(zero):
    return None if zero is None else zero.mesh


def _update(tc, opts: dict, state: TrainState, grads, opt_params):
    """One optimizer update: (the new latents, the optimizer state, the
    global gradient norm). The norm is computed once, for the metrics and
    the clip (where the clip sees these grads); under ZeRO it is the norm
    over the ranks, and `opts` holds the optimizer of each placement, built
    at its first step."""
    z = state.zero
    if z is None:
        gnorm = global_norm(tree_leaves(grads))
    else:
        gnorm = z.global_norm(tree_items(grads))
        if z not in opts:
            opts[z] = make_optimizer(tc, z.global_norm)
    updates, new_opt = opts[z].update(grads, state.opt_state, opt_params, g_norm=gnorm)
    new_params = _new_params(state.params, new_opt, updates, opt_params, z)
    return new_params, new_opt, gnorm


def make_train_step(cfg: ModelConfig, tc: TrainConfig, teacher_params=None) -> Callable:
    """(state, batch, beta[, teacher]) -> (state, metrics): one micro-step.
    batch: dict of [B, S] tensors (input_ids, labels, attention_mask). With
    no teacher the step trains with plain CE on the labels."""
    quantizer = make_quantizer(tc) if tc.quant_type else None
    opts = {None: make_optimizer(tc)}
    student_remat = _student_remat(tc, quantizer)

    def train_step(state: TrainState, batch, beta, teacher=None):
        t = teacher if teacher is not None else teacher_params
        full, opt_params = _dp_inputs(state)
        z = state.zero
        params = _with_grad(full)
        loss = _kd_or_ce_loss(cfg, tc, params, batch, beta, t, quantizer=quantizer,
                              student_remat=student_remat, mesh=_mesh(z))
        grads = _grads(loss, params)
        loss = loss.detach()
        del params, full
        if z is not None:
            grads, loss = z.reduce_grads(grads), z.mean(loss)
        new_params, new_opt, gnorm = _update(tc, opts, state, grads, opt_params)
        return (TrainState(params=new_params, opt_state=new_opt, step=state.step + 1, zero=z),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


def make_fused_train_step(cfg: ModelConfig, tc: TrainConfig, teacher_params=None) -> Callable:
    """One optimizer CYCLE a call (tc.fused_accum): the fake-quant forward
    runs once a cycle (`quantize_layer_weights`), each micro-batch's gradient
    w.r.t. the quantized weights accumulates in f32, and the averaged
    cotangent goes through the quantization's backward once; then clip +
    AdamW + the master sweep once. `batches` is a list of micro-batches."""
    assert tc.fused_accum, "make_fused_train_step requires tc.fused_accum"
    quantizer = make_quantizer(tc) if tc.quant_type else None
    opts = {None: make_optimizer(tc)}
    k = tc.grad_accum
    fused_remat = (tc.remat_policy if tc.gradient_checkpointing
                   and tc.remat_policy in ("save_dots", "save_qkvo")
                   else tc.gradient_checkpointing)

    def cycle_step(state: TrainState, batches, beta, teacher=None):
        t = teacher if teacher is not None else teacher_params
        full, opt_params = _dp_inputs(state)
        z = state.zero
        params = _with_grad(full)
        qparams = params if quantizer is None else llama.quantize_layer_weights(params, quantizer)
        q_items = tree_items(qparams)
        qleaf = _with_grad(qparams)
        acc = {path: torch.zeros_like(x, dtype=torch.float32) for path, x in q_items}
        losses = []
        for batch in batches:
            loss = _kd_or_ce_loss(cfg, tc, qleaf, batch, beta, t, quantizer=None,
                                  student_remat=fused_remat, mesh=_mesh(z))
            g = _grads(loss, qleaf)
            for path, _ in q_items:
                acc[path] += _get(g, path).to(torch.float32)
            losses.append(loss.detach())
            del g
        mean_q = {path: (acc[path] / k).to(x.dtype) for path, x in q_items}
        # the quantization's backward: quantized leaves through autograd,
        # the others (embedding, norms, lm_head) pass their cotangent on
        outs = [(path, x) for path, x in q_items if x.grad_fn is not None]
        srcs = [_get(params, path) for path, _ in outs]
        back = torch.autograd.grad([x for _, x in outs], srcs,
                                   grad_outputs=[mean_q[path] for path, _ in outs]) if outs else []
        grads: dict = {}
        for path, _ in q_items:
            _set(grads, path, mean_q[path])
        for (path, _), g in zip(outs, back):
            _set(grads, path, g)
        del params, full, qparams, qleaf, acc, mean_q, back
        losses = torch.stack(losses)
        if z is not None:  # one reduction a cycle: the mean of the ranks' cycle gradients
            grads, losses = z.reduce_grads(grads), z.mean(losses)
        new_params, new_opt, gnorm = _update(tc, opts, state, grads, opt_params)
        return (TrainState(params=new_params, opt_state=new_opt, step=state.step + 1, zero=z),
                {"loss": losses.mean(), "grad_norm": gnorm, "micro_losses": losses})

    return cycle_step


def make_cakld_beta_fn(cfg: ModelConfig, mesh=None) -> Callable:
    """Per-batch mean max-prob of the teacher (the CAKLD coefficient's terms;
    `mesh`: the teacher is a tp slice)."""

    @torch.no_grad()
    def batch_mean_prob(teacher_params, batch):
        logits, _ = llama.forward(teacher_params, cfg, batch["input_ids"],
                                  attn_mask=batch.get("attention_mask"), mesh=mesh)
        prob = torch.softmax(logits.to(torch.float32), dim=-1)
        return torch.amax(prob, dim=-1).mean()

    return batch_mean_prob


def estimate_cakld_beta(teacher_params, cfg, batches, fn=None, group=None,
                        mesh=None) -> torch.Tensor:
    """The mean of the teacher's mean max-prob over `batches`; with a
    process group (the dp ranks), over every rank's batches (each rank the
    same count: the mean of the ranks' means, an all-reduce). `mesh`: the
    teacher is a tp slice, and the tp ranks of a dp group agree already."""
    fn = fn or make_cakld_beta_fn(cfg, mesh)
    total, n = 0.0, 0
    for batch in batches:
        total = total + fn(teacher_params, batch)
        n += 1
    beta = total / max(n, 1)
    if group is not None:
        beta = torch.as_tensor(beta, dtype=torch.float32).clone()
        dist.all_reduce(beta, group=group)
        beta = beta / dist.get_world_size(group)
    return beta
