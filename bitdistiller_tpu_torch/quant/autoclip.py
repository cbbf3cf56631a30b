"""AutoClip (PyTorch port of the JAX package's `quant/autoclip.py`): the
per-group clip search on calibration activations, and the clip cache.

  * targets: every linear of a layer but q and k (`clip_linears`);
  * per output column and K-group, a grid over shrinks (1 - i / 20,
    i < 10) of the group's max and min, max outer and min inner, each
    point's weights clamped, fake quantized (`ste=False`) and scored by the
    mean over the sampled tokens of (x_g . w_g - x_g . q_g)^2, the two
    products made apart and then subtracted; a point replaces the best only
    if strictly better (`search_layer_clip`). The products run in f32
    whatever the caller's TF32 setting;
  * activations: each layer's real block (`models/llama.py:_block`) with a
    capturing linear (`capture_block_inputs`), over the calibration blocks
    a chunk at a time (at most `CAPTURE_ELEMS` attention scores), keeping
    the rows `[::max(n_blocks * S // n_sample_token, 1)]` of each linear's
    input; the next layer's input comes from the UNCLIPPED block, the
    clipped weights go into a copy (`run_autoclip`);
  * as the JAX package (ROADMAP C4), the first hidden state is the
    embedding times the multiplier only, and the rope tables are unscaled:
    the embedding norm (Bloom), the learned positions (OPT) and the rope
    scaling (llama3, linear, longrope) are left out;
  * the cache: an .npz of "{layer}/{name}/max" and ".../min" arrays, [N,
    K/G] each, the same file in both packages (`save_clip_cache`,
    `load_clip_cache`), and the clamp of a tree by it (`apply_clip_cache`).

The search runs on the device of the params: the card by default, the CPU
where the caller's tree lies there.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from .._device import torch_dtype
from ..models.config import ModelConfig
from ..models.layers import (
    activation,
    alibi_bias,
    alibi_slopes,
    causal_attention,
    linear,
    rope_cos_sin,
    rope_inv_freq,
)
from .core import fake_quant_int, fake_quant_nf3

CLIP_SKIP = ("q", "k")  # the q.k product is hard to clip precisely
CAPTURE_ELEMS = 1 << 28  # f32 attention scores of one capture call (1 GiB)
SEARCH_ELEMS = 1 << 28  # f32 products [groups, tokens, columns] of one search chunk


def clip_linears(cfg: ModelConfig) -> tuple[str, ...]:
    """Clip targets for this architecture: every linear except q/k. Gated
    MLPs clip gate and up, plain MLPs (Falcon, MPT) only up."""
    names = ["v", "o"]
    if cfg.mlp_style == "gated":
        names += ["gate", "up"]
    else:
        names += ["up"]
    return tuple(names + ["down"])


@contextlib.contextmanager
def _f32_products():
    """Matmuls in full f32 on the card inside the block (TF32 off), the
    caller's setting restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@torch.no_grad()
def capture_block_inputs(cfg: ModelConfig, lp: dict, li: int, h: torch.Tensor, cos, sin,
                         mask, attn_bias=None) -> tuple[torch.Tensor, dict]:
    """Run layer li's real block (`llama._block`) on h [B, S, D] with a
    capturing linear: returns (next hidden, {linear name: its input}). The
    real block makes the capture right for every family flag (the parallel
    block, the plain MLP, LayerNorm leaves, sandwich and q/k norms, ALiBi,
    windows). Attention is the plain causal one with `mask` and `attn_bias`,
    as the JAX package's capture (no flash path)."""
    from ..models import llama

    caps: dict = {}

    def lin(name, x):
        caps[name] = x
        return linear(lp[name], x, li)

    def attend(q, k, v):
        return causal_attention(q, k, v, mask, attn_bias)

    with _f32_products():
        new_h = llama._block(cfg, lp, llama._layer_norms(cfg, lp), li, h, cos, sin, attend,
                             lin, activation(cfg.hidden_act))
    return new_h, caps


def _quantize_for_search(w, quant_type: str, n_bit: int, group_size: int):
    if quant_type == "int":
        return fake_quant_int(w, n_bit, group_size, ste=False)
    if quant_type == "nf3":
        return fake_quant_nf3(w, group_size, ste=False)
    raise ValueError(f"quant_type must be 'int' or 'nf3', got {quant_type!r}")


@torch.no_grad()
def search_layer_clip(
    w_kn: torch.Tensor,  # [K, N]
    input_feat: torch.Tensor,  # [T, K] sampled tokens
    *,
    quant_type: str,
    n_bit: int,
    group_size: int,
    n_grid: int = 20,
    max_shrink: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (best_max, best_min), each [N, K/G] f32: per output column and
    group, the clip of the grid point with the least error. The columns are
    searched in chunks of at most SEARCH_ELEMS products [K/G, T, chunk]
    (each column's search is independent of the others, so a chunk's size
    changes no value): one chunk a linear at TinyLlama's widths and 512
    tokens."""
    k, n = w_kn.shape
    g = group_size if group_size > 0 else k
    ng = k // g
    t = input_feat.shape[0]
    steps = int(max_shrink * n_grid)
    # the grid 1 - i / n_grid as the JAX package's compiled search holds it
    # (XLA on the CPU): the division becomes a product by the f32 reciprocal,
    # fused into one rounding on the max side (0.55 at i = 9 of 20) and
    # rounded twice on the min side (0.54999995)
    recip = float(torch.tensor(1.0 / n_grid, dtype=torch.float32))
    max_shrinks = [float(torch.tensor(1.0 - i * recip, dtype=torch.float32)) for i in range(steps)]
    min_shrinks = (1.0 - torch.arange(steps, dtype=torch.float32) * recip).tolist()
    combo = [(smax, smin) for smax in max_shrinks for smin in min_shrinks]  # max outer
    feat = input_feat.to(torch.float32).reshape(t, ng, g).transpose(0, 1).contiguous()
    chunk = max(1, SEARCH_ELEMS // (ng * t))
    best_max, best_min = [], []
    with _f32_products():
        for c0 in range(0, n, chunk):
            # [ng, C, G]: a group's weights along the last axis, as the JAX layout
            w = w_kn[:, c0:c0 + chunk].to(torch.float32).t().reshape(-1, ng, g).transpose(0, 1)
            w = w.contiguous()
            org_max = w.amax(dim=-1, keepdim=True)  # [ng, C, 1]
            org_min = w.amin(dim=-1, keepdim=True)
            org_out = torch.bmm(feat, w.transpose(1, 2))  # [ng, T, C]
            best_err = torch.full(org_max.shape, 1e9, dtype=torch.float32, device=w.device)
            bmax, bmin = org_max, org_min
            for smax, smin in combo:
                max_val = org_max * smax
                min_val = org_min * smin
                q = _quantize_for_search(torch.clamp(w, min_val, max_val), quant_type, n_bit, g)
                out = torch.bmm(feat, q.transpose(1, 2))
                err = out.sub_(org_out).square_().mean(dim=1)[..., None]  # [ng, C, 1]
                better = err < best_err
                best_err = torch.where(better, err, best_err)
                bmax = torch.where(better, max_val, bmax)
                bmin = torch.where(better, min_val, bmin)
            best_max.append(bmax[..., 0].t())
            best_min.append(bmin[..., 0].t())
    return torch.cat(best_max), torch.cat(best_min)


def _first_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The JAX package's AutoClip input: the embedding times the multiplier
    (rounded to the compute dtype first, as the forward's), nothing else
    (ROADMAP C4)."""
    cdt = torch_dtype(cfg.dtype)
    h = params["embed"][tokens].to(cdt)
    if cfg.embedding_multiplier != 1.0:
        h = h * torch.tensor(cfg.embedding_multiplier, dtype=cdt).item()
    return h


def _layer_args(cfg: ModelConfig, s: int, blocks: int, dev) -> tuple[list, object]:
    """What the JAX package's run_autoclip gives each layer's capture:
    ([(cos, sin, mask) a layer], ALiBi bias [blocks, Hq, S, S] or None).
    The rope tables are unscaled (C4); the window's mask goes to every layer
    (Phi-3, Mistral) or to the sliding layers of a per-layer pattern
    (Gemma-2/3, with their local theta), the other layers causal."""
    cdt = torch_dtype(cfg.dtype)
    dh = cfg.actual_head_dim
    positions = torch.arange(s, device=dev)[None, :]

    def rope(theta):
        if not cfg.use_rope:
            return None, None
        inv = torch.from_numpy(np.asarray(rope_inv_freq(dh, theta), np.float32)).to(dev)
        return rope_cos_sin(positions, inv, 1.0, cdt)

    glob = (*rope(cfg.rope_theta), None)
    per_layer = [glob] * cfg.num_layers
    if cfg.sliding_window:
        ar = torch.arange(s, device=dev)
        allow = (ar[None, :] <= ar[:, None]) & (ar[None, :] > ar[:, None] - cfg.sliding_window)
        if cfg.sliding_layers:
            local = (*rope(cfg.rope_local_theta or cfg.rope_theta), allow[None, None])
            per_layer = [local if slide else glob for slide in cfg.sliding_layers]
        else:
            per_layer = [(glob[0], glob[1], allow[None, None])] * cfg.num_layers
    attn_bias = None
    if cfg.alibi:  # full causal: the keys are the queries
        q_pos = positions.expand(blocks, s)
        attn_bias = alibi_bias(alibi_slopes(cfg.num_heads), q_pos, q_pos)
    return per_layer, attn_bias


@torch.no_grad()
def run_autoclip(
    params: dict,
    cfg: ModelConfig,
    calib_tokens,  # [n_blocks, block_size] int
    *,
    quant_type: str = "int",
    n_bit: int = 2,
    group_size: int = 128,
    n_sample_token: int = 512,
    apply: bool = True,
    progress: Callable[[str], None] = lambda s: None,
) -> dict:
    """Layer-wise clip search over the whole dense model, on the device of
    `params`. Returns {"clip": {layer: {name: (max, min)}}} (numpy [N, K/G]
    f32) and "params": with `apply`, a copy of the tree whose target
    linears' weights are clamped (the other leaves shared), else `params`
    itself."""
    dev = params["embed"].device
    tokens = torch.as_tensor(np.asarray(calib_tokens), dtype=torch.int64, device=dev)
    nb, s = tokens.shape
    h = _first_hidden(params, cfg, tokens)
    # blocks a capture call: at most CAPTURE_ELEMS f32 scores [cb, Hq, S, S]
    cb = min(nb, max(1, CAPTURE_ELEMS // (cfg.num_heads * s * s)))
    per_layer, attn_bias = _layer_args(cfg, s, cb, dev)

    targets = clip_linears(cfg)
    lp = params["layers"]
    out_layers = ({name: dict(lp[name], w=lp[name]["w"].clone()) for name in targets}
                  if apply else {})
    stride = max(nb * s // n_sample_token, 1)  # sampled rows of the flat [nb * S, K] input
    clip_results: dict = {}
    for li in range(cfg.num_layers):
        c, si, m = per_layer[li]
        feats: dict = {name: [] for name in targets}
        for b0 in range(0, nb, cb):
            b1 = min(b0 + cb, nb)
            bias = None if attn_bias is None else attn_bias[: b1 - b0]
            new_h, caps = capture_block_inputs(cfg, lp, li, h[b0:b1], c, si, m, bias)
            first = (-b0 * s) % stride  # the chunk's first sampled row
            for name in targets:
                x = caps[name]
                feats[name].append(x.reshape(-1, x.shape[-1])[first::stride].clone())
            del caps
            h[b0:b1] = new_h  # next-layer inputs from the UNCLIPPED block
        layer_clips = {}
        for name in targets:
            bmax, bmin = search_layer_clip(lp[name]["w"][li], torch.cat(feats.pop(name)),
                                           quant_type=quant_type, n_bit=n_bit,
                                           group_size=group_size)
            layer_clips[name] = (bmax.cpu().numpy(), bmin.cpu().numpy())
            if apply:
                out_layers[name]["w"][li] = apply_clip_to_weight(lp[name]["w"][li],
                                                                 *layer_clips[name])
        clip_results[li] = layer_clips
        progress(f"layer {li + 1}/{cfg.num_layers}")
    out = dict(params, layers=dict(lp, **out_layers)) if apply else params
    return {"clip": clip_results, "params": out}


def save_clip_cache(path: str, clip: dict) -> None:
    """The JAX package's file: np.savez of "{layer}/{name}/max" and ".../min"."""
    flat = {}
    for li, layer in clip.items():
        for name, (mx, mn) in layer.items():
            flat[f"{li}/{name}/max"] = mx
            flat[f"{li}/{name}/min"] = mn
    np.savez(path, **flat)


def load_clip_cache(path: str) -> dict:
    """{layer index: {linear name: (max [N, K/G], min [N, K/G])}} as numpy."""
    data = np.load(path)
    clip: dict = {}
    for key in data.files:
        li_s, name, kind = key.split("/")
        clip.setdefault(int(li_s), {}).setdefault(name, [None, None])
        clip[int(li_s)][name][0 if kind == "max" else 1] = data[key]
    return {li: {name: tuple(v) for name, v in layer.items()} for li, layer in clip.items()}


def apply_clip_to_weight(w_kn: torch.Tensor, max_val, min_val) -> torch.Tensor:
    """Clamp a [K, N] weight by per-(output column, group) ranges ([N, K/G])."""
    k, n = w_kn.shape
    mx = torch.as_tensor(np.asarray(max_val), dtype=torch.float32, device=w_kn.device)
    mn = torch.as_tensor(np.asarray(min_val), dtype=torch.float32, device=w_kn.device)
    ng = mx.shape[1]
    w = w_kn.to(torch.float32).t().reshape(n, ng, k // ng)
    w = torch.clamp(w, mn[..., None], mx[..., None])
    return w.reshape(n, k).t().to(w_kn.dtype)


def apply_clip_cache(params: dict, clip: dict) -> dict:
    """A copy of params with the cached layers' weights clamped (the
    original tree is not touched)."""
    layers = dict(params["layers"])
    for li, layer in clip.items():
        for name, (mx, mn) in layer.items():
            w = layers[name]["w"].clone()
            w[li] = apply_clip_to_weight(w[li], mx, mn)
            layers[name] = dict(layers[name], w=w)
    return dict(params, layers=layers)
