"""The clip cache of AutoClip (PyTorch port of the part of the JAX
package's `quant/autoclip.py` that training needs): load a cache written by
the JAX package's `save_clip_cache` (an .npz of "{layer}/{name}/max" and
".../min" arrays, [N, K/G] each) and clamp the dense weights with it. The
clip search itself is not ported (ROADMAP A8)."""

from __future__ import annotations

import numpy as np
import torch


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
