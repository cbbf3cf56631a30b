"""Device-memory estimate for the CAKLD KD-QAT step (a restatement of the
JAX package's `train/memory.py:kd_train_memory_estimate`, plain
arithmetic): teacher + student latents + f32 master/Adam moments +
transients, each divided by the mesh axes its sharding spans (the port
runs one device: dp = tp = 1 unless a caller asks otherwise). The
parameter count sums the shape table that `init_params` fills
(`models/llama.py:param_table`), with nothing allocated. `dp_train_scaling`
projects the step's efficiency over dp from a measured one-card step and
the link figures.
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


# NVIDIA's H100 SXM data sheet: 900 GB/s of NVLink a card, both directions
# together, so 450 GB/s each way (a data-sheet figure, not a measurement:
# one card cannot measure a collective). Between hosts, a DGX H100's data
# sheet gives eight 400 Gb/s ConnectX-7 ports, one a card: 50 GB/s each way.
H100_NVLINK_BW = 450e9
H100_HOST_BW = 50e9
CARDS_PER_HOST = 8


def dp_train_scaling(cfg: ModelConfig, tc: TrainConfig, *, t_step_s: float, dp: int,
                     tp: int = 1, cards_per_host: int = CARDS_PER_HOST,
                     link_bw: float = H100_NVLINK_BW, host_bw: float = H100_HOST_BW,
                     overlap: float = 0.0) -> dict:
    """Projected scaling efficiency of the KD step over dp (the JAX
    package's `train/memory.py:dp_train_scaling`, the same formula): the
    step adds one collective family, the gradient reduction (ZeRO 2's
    reduce-scatter and the latents' all-gather move the same ring bytes as
    an all-reduce: 2 (dp - 1) / dp of the latent-dtype gradient tree, 1 /
    tp of it a rank), over the links inside a host and, between hosts, a
    hierarchical share divided over the host's cards. `t_step_s` must be a
    measured one-card step: the model adds communication and invents no
    speed-up. `overlap`: the share of the communication hidden behind the
    backward; 0 by default because the port reduces after the backward
    (`parallel/zero.py`)."""
    n = param_count(cfg)
    grad_bytes = torch.empty((), dtype=latent_dtype(tc)).element_size() * n / tp
    if dp == 1:
        return {"dp": 1, "hosts": 1, "t_step_s": t_step_s, "t_comm_s": 0.0, "efficiency": 1.0}
    hosts = max((dp * tp + cards_per_host - 1) // cards_per_host, 1)
    t_link = 2 * (dp - 1) / dp * grad_bytes / link_bw
    t_host = 0.0
    if hosts > 1:
        t_host = 2 * (hosts - 1) / hosts * grad_bytes / cards_per_host / host_bw
    t_comm = (1.0 - overlap) * (t_link + t_host)
    return {"dp": dp, "hosts": hosts, "t_step_s": t_step_s + t_comm, "t_comm_s": t_comm,
            "efficiency": t_step_s / (t_step_s + t_comm)}
