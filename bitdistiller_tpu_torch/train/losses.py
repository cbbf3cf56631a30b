"""Knowledge-distillation losses for QAT self-distillation (PyTorch port of
the JAX package's `train/losses.py`).

All losses mask padding via labels != -100 (IGNORE_INDEX), sum over the
sequence and take the mean over the batch; log-softmax and KL terms in f32.
`cakld_loss_fused` (the train step's CAKLD) is a torch.autograd.Function
with the JAX package's analytic backward: it keeps per-token [B, S]
statistics and rebuilds the softmax from the saved log-sum-exps, so no f32
[B, S, V] residual lives until the backward.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def _mask(labels: torch.Tensor) -> torch.Tensor:
    return (labels != IGNORE_INDEX).to(torch.float32)


def _kl_div(log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """KL(q || p) summed over vocab: sum exp(log_q) * (log_q - log_p)."""
    return torch.sum(torch.exp(log_q) * (log_q - log_p), dim=-1)


def _log_softmax(z: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(z.to(torch.float32), dim=-1)


def cakld_loss(labels, student_logits, teacher_logits, beta) -> torch.Tensor:
    """Confidence-Aware KLD: beta * reverse-KL + (1 - beta) * forward-KL."""
    sl = _log_softmax(student_logits)
    tl = _log_softmax(teacher_logits)
    reverse_kl = _kl_div(tl, sl)
    forward_kl = _kl_div(sl, tl)
    kl = (beta * reverse_kl + (1.0 - beta) * forward_kl) * _mask(labels)
    return kl.sum(dim=-1).mean()


def _lse(z: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp over vocab in f32; the max in the input dtype."""
    zm = torch.amax(z, dim=-1, keepdim=True).detach()
    se = torch.sum(torch.exp((z - zm).to(torch.float32)), dim=-1, keepdim=True)
    return torch.log(se) + zm.to(torch.float32)


def _cakld_terms(zs: torch.Tensor, zt: torch.Tensor):
    """Per-token reverse/forward KL from probability-weighted logit moments:
    r = E_s[zs] - lse_s - E_s[zt] + lse_t, f = E_t[zt] - lse_t - E_t[zs] + lse_s."""
    lse_s, lse_t = _lse(zs), _lse(zt)
    zsf, ztf = zs.to(torch.float32), zt.to(torch.float32)
    s = torch.exp(zsf - lse_s)
    t = torch.exp(ztf - lse_t)
    e_s_zs = torch.sum(s * zsf, dim=-1, keepdim=True)
    e_s_zt = torch.sum(s * ztf, dim=-1, keepdim=True)
    e_t_zt = torch.sum(t * ztf, dim=-1, keepdim=True)
    e_t_zs = torch.sum(t * zsf, dim=-1, keepdim=True)
    r = (e_s_zs - lse_s - e_s_zt + lse_t)[..., 0]
    f = (e_t_zt - lse_t - e_t_zs + lse_s)[..., 0]
    return r, f, lse_s, lse_t


class CakldFused(torch.autograd.Function):
    """cakld_loss with the analytic backward of the JAX package's
    `_cakld_fused_bwd`:
      dL/dzs = w * [beta * s * ((ls - lt) - r) + (1 - beta) * (s - t)],
      dL/dbeta = sum w * (r - f),  w = mask / B * gbar;
    the teacher gets a zero gradient (call sites detach it)."""

    @staticmethod
    def forward(ctx, labels, zs, zt, beta):
        with torch.no_grad():
            r, f, lse_s, lse_t = _cakld_terms(zs, zt)
            kl = (beta * r + (1.0 - beta) * f) * _mask(labels)
            loss = kl.sum(dim=-1).mean()
        ctx.save_for_backward(labels, zs, zt, beta, r, f, lse_s, lse_t)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        labels, zs, zt, beta, r, f, lse_s, lse_t = ctx.saved_tensors
        w = (_mask(labels) / labels.shape[0] * gbar)[..., None]
        zsf, ztf = zs.to(torch.float32), zt.to(torch.float32)
        s = torch.exp(zsf - lse_s)
        t = torch.exp(ztf - lse_t)
        ls_minus_lt = (zsf - lse_s) - (ztf - lse_t)
        dzs = w * (beta * s * (ls_minus_lt - r[..., None]) + (1.0 - beta) * (s - t))
        dbeta = torch.sum(w[..., 0] * (r - f)).to(beta.dtype).reshape(beta.shape)
        return None, dzs.to(zs.dtype), torch.zeros_like(zt), dbeta


def cakld_loss_fused(labels, student_logits, teacher_logits, beta) -> torch.Tensor:
    """cakld_loss with an analytic backward (the same value and gradient)."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=student_logits.device)
    return CakldFused.apply(labels, student_logits, teacher_logits, beta)


def jsd_loss(labels, student_logits, teacher_logits, beta: float = 0.5) -> torch.Tensor:
    """Generalized JSD with mixture c = beta * t + (1 - beta) * s."""
    sp = torch.softmax(student_logits.to(torch.float32), dim=-1)
    tp = torch.softmax(teacher_logits.to(torch.float32), dim=-1)
    cp = beta * tp + (1.0 - beta) * sp
    log_c = torch.log(cp)
    eps = 1e-10
    kl_f = beta * torch.sum(tp * (torch.log(tp + eps) - log_c), dim=-1)
    kl_r = (1.0 - beta) * torch.sum(sp * (torch.log(sp + eps) - log_c), dim=-1)
    kl = (kl_f + kl_r) * _mask(labels)
    return kl.sum(dim=-1).mean()


def forward_kl_loss(labels, student_logits, teacher_logits,
                    temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student): the reference's 'forward' loss."""
    sl = _log_softmax(student_logits)
    tl = torch.log_softmax(teacher_logits.to(torch.float32) / temperature, dim=-1)
    kl = _kl_div(sl, tl) * _mask(labels)
    return kl.sum(dim=-1).mean()


def reverse_kl_loss(labels, student_logits, teacher_logits) -> torch.Tensor:
    """KL(student || teacher): the reference's 'reverse' loss."""
    sl = _log_softmax(student_logits)
    tl = _log_softmax(teacher_logits)
    kl = _kl_div(tl, sl) * _mask(labels)
    return kl.sum(dim=-1).mean()


def tlsd_loss(labels, student_logits, teacher_logits) -> torch.Tensor:
    """Token-scaled logit distillation: per-token CE of the teacher sets a
    softmax(ce / 10) token weight for the distillation CE."""
    s = student_logits[:, :-1, :].to(torch.float32)
    t = teacher_logits[:, :-1, :].to(torch.float32)
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe_labels = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    tl = torch.log_softmax(t, dim=-1)
    tc_ce = -torch.gather(tl, -1, safe_labels[..., None].long())[..., 0]
    tc_ce = torch.where(valid, tc_ce, torch.zeros_like(tc_ce))
    token_scale = torch.softmax(tc_ce / 10.0, dim=-1).detach()
    sl = torch.log_softmax(s, dim=-1)
    tp = torch.softmax(t, dim=-1)
    ce = -torch.sum(tp * sl, dim=-1)
    return torch.sum(ce * token_scale)


def mse_loss(student_logits, teacher_logits) -> torch.Tensor:
    return torch.mean((student_logits.to(torch.float32) - teacher_logits.to(torch.float32)) ** 2)


def kd_loss(loss_type: str, labels, student_logits, teacher_logits, *, beta=0.0,
            temperature: float = 1.0) -> torch.Tensor:
    """Dispatch as the JAX package's kd_loss (CAKLD through the fused form)."""
    if loss_type == "cakld":
        return cakld_loss_fused(labels, student_logits, teacher_logits, beta)
    if loss_type == "jsd":
        return jsd_loss(labels, student_logits, teacher_logits, 0.5)
    if loss_type == "forward":
        return forward_kl_loss(labels, student_logits, teacher_logits, temperature)
    if loss_type == "reverse":
        return reverse_kl_loss(labels, student_logits, teacher_logits)
    if loss_type == "tlsd":
        return tlsd_loss(labels, student_logits, teacher_logits)
    if loss_type == "mse":
        return mse_loss(student_logits, teacher_logits)
    raise ValueError(f"unknown kd loss type {loss_type!r}")
