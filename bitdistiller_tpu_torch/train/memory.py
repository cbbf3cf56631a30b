"""Device-memory estimate for the CAKLD KD-QAT step (a restatement of the
JAX package's `train/memory.py:kd_train_memory_estimate`, plain
arithmetic): teacher + student latents + f32 master/Adam moments +
transients, each divided by the mesh axes its sharding spans (the port
runs one device: dp = tp = 1 unless a caller asks otherwise). The
parameter count sums the shape table that `init_params` fills
(`models/llama.py:param_table`), with nothing allocated.
"""

from __future__ import annotations

import math

import torch

from ..models.config import ModelConfig
from ..models.llama import param_shapes
from .trainer import TrainConfig, latent_dtype

GiB = 1024**3


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the dense tree `init_params(cfg)` makes, every family."""
    return sum(math.prod(shape) for shape in param_shapes(cfg).values())


def kd_train_memory_estimate(cfg: ModelConfig, tc: TrainConfig, *, dp: int = 1, tp: int = 1,
                             zero_stage: int = 2, batch: int = 2, seq: int = 1024) -> dict:
    """Heuristic bytes a device for one KD train step at a per-device
    micro-batch of `batch` x `seq`; the component dict plus "total" and
    "state_total" (persistent state only)."""
    n = param_count(cfg)
    latent_itemsize = torch.empty((), dtype=latent_dtype(tc)).element_size()
    has_master = latent_itemsize != 4
    param_div = dp * tp if zero_stage >= 3 else tp
    opt_div = dp * tp if zero_stage >= 2 else tp
    teacher = 2 * n / param_div if tc.train_kd else 0
    latent = latent_itemsize * n / param_div
    opt = ((4 if has_master else 0) + 8 + (4 if tc.grad_accum > 1 else 0)) * n / opt_div
    grads = latent_itemsize * n / param_div
    acts = 2 * batch * seq * cfg.hidden_size * cfg.num_layers * 2
    if tc.kd_loss_type == "cakld":
        logits = 2 * batch * seq * cfg.vocab_size * 2
    else:
        logits = 4 * batch * seq * cfg.vocab_size * 4
    embed = cfg.vocab_size * cfg.hidden_size
    quant_tmp = 4 * (n - embed) / max(cfg.num_layers, 1) / tp
    out = {"params": n, "teacher": teacher, "latent": latent, "opt_state": opt, "grads": grads,
           "activations": acts, "logits": logits, "quant_tmp": quant_tmp}
    out["state_total"] = teacher + latent + opt
    out["total"] = out["state_total"] + grads + acts + logits + quant_tmp
    return out


def format_estimate(est: dict, label: str = "") -> str:
    parts = ", ".join(f"{k} {est[k] / GiB:.2f}" for k in
                      ("teacher", "latent", "opt_state", "grads", "activations", "logits",
                       "quant_tmp"))
    return f"{label}{est['params'] / 1e9:.2f}B params: {est['total'] / GiB:.2f} GiB ({parts})"
