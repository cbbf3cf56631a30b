"""The decoder of every model family as plain functions over a stacked-layer
param dict (PyTorch port of the JAX package's `models/llama.py`).

Params keep the JAX layout: every layer leaf carries a leading [L] axis, and
the layer loop is a Python loop over `li` that reads each layer in place
(views, no copies). Packed leaves are stacked `PackedLinear`s: fused `qkv`
and `gate_up` where every part is present and unbiased, else one a linear
(biased q/k/v, a plain MLP's `up`).

The families are flags of one block (`ModelConfig`): LayerNorm or RMSNorm
(with Gemma's unit offset), the parallel block (Falcon, with a second norm
in the 40B style), sandwich norms, q/k norms, rope (with its scalings) or
ALiBi or learned positions, the gated or plain MLP and its activation, a
uniform or per-layer sliding window, biases, the embedding multiplier and
norm. What depends on the flags but not on the layer (the norms' kind and
offset, masks, rope tables, ALiBi bias, the attention route) is decided
once a forward.

Three forward cases:
  * cache-less prefill (`cache=None`), optionally returning each layer's
    fresh k/v [L, B, S, Hkv, D] (`return_kv=True`);
  * the training forward (also cache-less): the weight fake quantizer
    (`quantizer`), the padding mask (`attn_mask`), per-layer rematerialization
    (`remat`: True/"full", "save_quantized", "save_dots", "save_qkvo",
    through torch.utils.checkpoint(use_reentrant=False); values and
    gradients do not depend on the policy) and the training flash attention
    (`use_train_flash`, else BITDISTILLER_TRAIN_FLASH=1 as the JAX package
    reads it: B8's kernels on CUDA tensors) where the JAX package takes it:
    no ALiBi, no window;
  * decode against the head-major cache [L, B, Hkv, T, D] with a scalar or
    per-slot `cache_pos`. At S=1 without ALiBi, `kv_valid` or per-layer
    sliding, attention runs through the decode attention kernel
    (`ops/decode_attention.py`, with the uniform window and `attn_len`);
    otherwise through `cached_attention`. The fresh tokens are written back
    into the cache IN PLACE (the JAX package returns a new cache; here the
    returned cache is the same object).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .._device import resolve_device, torch_dtype
from ..ops.decode_attention import decode_attention_plain, flash_decode_stacked
from ..parallel.mesh import ROW_PARALLEL
from ..parallel.tensor import (copy_to_tp, gather_from_tp, reduce_from_tp, tp_config,
                               vocab_parallel_embed)
from ..quant.packing import PackedLinear
from .config import ModelConfig
from .layers import (
    activation,
    alibi_bias,
    alibi_slopes_on,
    apply_norm,
    apply_rope,
    cached_attention,
    causal_attention,
    flash_train_attention,
    layer_norm,
    linear,
    ring_linear,
    ring_ok,
    ring_tp_size,
    rms_norm,
    rope_cos_sin,
    rope_tables,
)

LAYER_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
REMAT_POLICIES = (True, "full", "save_quantized", "save_dots", "save_qkvo")

@dataclasses.dataclass
class KVCache:
    """Static KV cache, head-major [L, B, Hkv, T, D]: each (batch, head) is a
    contiguous [T, D] plane. dtype int8 keeps symmetric per-token codes with
    f32 scales [L, B, Hkv, T]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
             device="cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.actual_head_dim)
        if dtype == torch.int8:
            return KVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=dev),
                v=torch.zeros(shape, dtype=torch.int8, device=dev),
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            )
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
        )


# 1/127 rounded to f32: the JAX package's `amax / 127.0` compiles (XLA folds
# the division by a constant) to a product with this constant, and its
# engine quantizes the cache only inside compiled code (C10)
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-token quantization along the trailing head_dim:
    x [..., T, D] -> (codes int8 [..., T, D], scale f32 [..., T]). The scale
    is the f32 product amax * f32(1/127), as the JAX package's compiled
    program rounds it; the codes divide by it."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) * _INV_127
    codes = torch.round(xf / scale[..., None])
    return codes.to(torch.int8), scale


def param_table(cfg: ModelConfig) -> dict[tuple, tuple[tuple, object]]:
    """Every leaf of the dense param tree for the config, with its shape and
    how `init_params` fills it: {path: (shape, fill)}, fill "ones", "zeros"
    or the scale of a normal draw. The leaves are the JAX package's
    `init_params`'s (stacked [L, K, N] linears, unfused q/k/v and gate/up,
    biases zero, norms one: a tensor for RMSNorm, a {"w", "b"} dict for
    LayerNorm), in the order of the tree `init_params` returns."""
    d, dh, ffn, L = cfg.hidden_size, cfg.actual_head_dim, cfg.intermediate_size, cfg.num_layers
    table: dict[tuple, tuple[tuple, object]] = {("embed",): ((cfg.vocab_size, d), 0.02)}

    def norm(path, *shape):
        if cfg.norm_type == "layernorm":
            table[path + ("w",)] = (shape, "ones")
            table[path + ("b",)] = (shape, "zeros")
        else:
            table[path] = (shape, "ones")

    def lin(name, k_dim, n_dim, bias):
        table[("layers", name, "w")] = ((L, k_dim, n_dim), 1.0 / float(k_dim) ** 0.5)
        if bias:
            table[("layers", name, "b")] = ((L, n_dim), "zeros")

    norm(("final_norm",), d)
    norm(("layers", "input_norm"), L, d)
    if not cfg.parallel_block:
        norm(("layers", "post_attn_norm"), L, d)
    if cfg.parallel_mlp_norm:
        norm(("layers", "mlp_norm"), L, d)
    if cfg.sandwich_norm:
        norm(("layers", "pre_ffn_norm"), L, d)
        norm(("layers", "post_ffn_norm"), L, d)
    if cfg.qk_norm:
        table[("layers", "q_norm")] = ((L, dh), "ones")
        table[("layers", "k_norm")] = ((L, dh), "ones")
    lin("q", d, cfg.q_size, cfg.attention_bias)
    lin("k", d, cfg.kv_size, cfg.attention_bias)
    lin("v", d, cfg.kv_size, cfg.attention_bias)
    lin("o", cfg.q_size, d, cfg.attention_out_bias)
    if cfg.mlp_style == "gated":
        lin("gate", d, ffn, cfg.mlp_bias)
    lin("up", d, ffn, cfg.mlp_bias)
    lin("down", ffn, d, cfg.mlp_bias)
    if not cfg.tie_word_embeddings:
        table[("lm_head", "w")] = ((d, cfg.vocab_size), 1.0 / float(d) ** 0.5)
    if cfg.learned_pos_embeddings:
        table[("pos_embed",)] = ((cfg.max_position_embeddings + cfg.pos_embedding_offset, d), 0.02)
    if cfg.embedding_norm:
        table[("embed_norm", "w")] = ((d,), "ones")
        table[("embed_norm", "b")] = ((d,), "zeros")
    return table


def param_shapes(cfg: ModelConfig) -> dict[tuple, tuple]:
    """{leaf path: shape} of the dense param tree, nothing allocated."""
    return {path: shape for path, (shape, _) in param_table(cfg).items()}


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> dict:
    """Random dense params filling `param_table(cfg)`: normal * 1/sqrt(K)
    for the linears, * 0.02 for the embeddings, drawn in f32 on the device
    from a torch.Generator seeded with `seed` (other numbers than the JAX
    package's jax.random), the layers' linears first (a layer at a time: no
    full-size f32 copy), then the embedding, the lm_head and the positions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = param_table(cfg)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                * scale).to(dtype)

    def fill(shape, how):
        if how == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if how == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if len(shape) == 3:  # a stacked linear [L, K, N]
            w = torch.empty(shape, dtype=dtype, device=dev)
            for i in range(shape[0]):
                w[i] = normal(shape[1:], how)
            return w
        return normal(shape, how)

    leaves = {path: fill(*table[path]) for path in table if path[0] == "layers"}
    leaves.update({path: fill(*table[path]) for path in table if path[0] != "layers"})
    params: dict = {}
    for path in table:
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaves[path]
    return params


def _cache_mask(cache: KVCache, start, positions, s: int, kv_valid=None, window=None):
    """[B, 1, S, T+S] mask over cache ++ fresh: cache rows valid strictly
    below the slot's start (and where `kv_valid` [B, T] holds); fresh token
    j causally visible; with a window, keys at positions above the query's
    less the window."""
    b = start.shape[0]
    t = cache.k.shape[3]
    dev = start.device
    ar = torch.arange(s, device=dev)
    k_pos = torch.arange(t, device=dev)
    allow_cache = (k_pos[None, None, :] < start.reshape(-1, 1, 1)).expand(b, s, t)
    allow_new = (ar[None, :] <= ar[:, None]).expand(b, s, s)
    m = torch.cat([allow_cache, allow_new], dim=-1)
    if kv_valid is not None:
        pad = torch.ones((b, s), dtype=torch.bool, device=dev)
        m = m & torch.cat([kv_valid.to(torch.bool), pad], dim=-1)[:, None, :]
    if window:
        q_abs = positions.expand(b, s)
        k_abs = torch.cat([k_pos.expand(b, t), q_abs], dim=-1)
        m = m & (k_abs[:, None, :] > q_abs[:, :, None] - window)
    return m[:, None]


def _causal_mask(b: int, s: int, dev, attn_mask, window):
    """[B, 1, S, S] mask of the cache-less forward: causal, the padding
    mask's real keys and the window; None where the causal rule alone
    holds."""
    if attn_mask is None and not window:
        return None
    ar = torch.arange(s, device=dev)
    allow = ar[None, :] <= ar[:, None]
    if window:
        allow = allow & (ar[None, :] > ar[:, None] - window)
    if attn_mask is None:
        return allow[None, None].expand(b, 1, s, s)
    return allow[None, None] & attn_mask[:, None, None, :].to(torch.bool)


def _write_back(cache: KVCache, nk, nv, start, s: int) -> None:
    """Write fresh k/v [L, B, S, Hkv, D] into the cache at each slot's start,
    in place. Starts clamp to T - S, as XLA's dynamic_update_slice does."""
    b = start.shape[0]
    t = cache.k.shape[3]
    nk = nk.permute(0, 1, 3, 2, 4)  # [L, B, Hkv, S, D]
    nv = nv.permute(0, 1, 3, 2, 4)
    if cache.quantized:
        nk, nks = quantize_kv(nk)
        nv, nvs = quantize_kv(nv)
    st = torch.clamp(start.to(torch.int64), 0, t - s)
    t_idx = st[:, None] + torch.arange(s, device=st.device)[None, :]  # [B, S]
    b_idx = torch.arange(b, device=st.device)[:, None]
    # [L, B, H, T, D] viewed as [B, T, L, H, D]: index (slot, row) pairs
    cache.k.permute(1, 3, 0, 2, 4)[b_idx, t_idx] = nk.permute(1, 3, 0, 2, 4).to(cache.k.dtype)
    cache.v.permute(1, 3, 0, 2, 4)[b_idx, t_idx] = nv.permute(1, 3, 0, 2, 4).to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale.permute(1, 3, 0, 2)[b_idx, t_idx] = nks.permute(1, 3, 0, 2)
        cache.v_scale.permute(1, 3, 0, 2)[b_idx, t_idx] = nvs.permute(1, 3, 0, 2)


LAYER_NORMS = ("input_norm", "post_attn_norm", "mlp_norm", "pre_ffn_norm", "post_ffn_norm")


def _layer_norm_pair(x, wb, eps):
    return layer_norm(x, wb[0], wb[1], eps)


def _layer_norms(cfg: ModelConfig, lp: dict) -> dict:
    """The stacked norms of the layers, resolved once a forward (as
    `apply_norm` would resolve them at every call): name -> (fn, weights),
    applied as fn(x, weights[li], eps). A tensor is an RMSNorm, its weight
    taking the unit offset once over every layer; a {"w", "b"} dict is a
    LayerNorm over the layers' (w, b) pairs."""
    norms = {}
    for name in LAYER_NORMS:
        leaf = lp.get(name)
        if isinstance(leaf, dict):
            w, b = leaf["w"], leaf.get("b")
            norms[name] = (_layer_norm_pair,
                           list(zip(w.unbind(0), [None] * len(w) if b is None else b.unbind(0))))
        elif leaf is not None:
            norms[name] = (rms_norm, leaf.to(torch.float32) + cfg.norm_offset
                           if cfg.norm_offset else leaf)
    return norms


def _block(cfg: ModelConfig, lp: dict, norms: dict, li: int, h, cos, sin, attend, lin, act):
    """One decoder layer, as the JAX package's `_block`: input norm, q/k/v
    (fused or not), the q/k norms, rope, `attend(q, k, v)`, o; then the
    parallel block (attention and MLP from one norm, or the MLP from its
    own), the sandwich norms, or the sequential residual; the gated or plain
    MLP with `act`. `norms` is `_layer_norms`'; `lin(name, x)` applies layer
    li's linear `name`."""
    b, s = h.shape[:2]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.actual_head_dim
    eps = cfg.rms_norm_eps
    norm, w = norms["input_norm"]
    x = norm(h, w[li], eps)
    if "qkv" in lp:
        qkv = lin("qkv", x)
        q = qkv[..., : hq * dh].reshape(b, s, hq, dh)
        k = qkv[..., hq * dh : (hq + hkv) * dh].reshape(b, s, hkv, dh)
        v = qkv[..., (hq + hkv) * dh :].reshape(b, s, hkv, dh)
    else:
        q = lin("q", x).reshape(b, s, hq, dh)
        k = lin("k", x).reshape(b, s, hkv, dh)
        v = lin("v", x).reshape(b, s, hkv, dh)
    if cfg.qk_norm:  # no unit offset, as the JAX package (ROADMAP C4)
        q = rms_norm(q, lp["q_norm"][li], eps)
        k = rms_norm(k, lp["k_norm"][li], eps)
    if cfg.use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    attn = attend(q, k, v)
    attn_out = lin("o", attn.reshape(b, s, hq * dh).to(h.dtype))
    if cfg.parallel_block:
        mlp_in = x
        if cfg.parallel_mlp_norm:
            norm, w = norms["mlp_norm"]
            mlp_in = norm(h, w[li], eps)
    elif cfg.sandwich_norm:  # the post-attention norm on the attention's output
        norm, w = norms["post_attn_norm"]
        h = h + norm(attn_out, w[li], eps)
        norm, w = norms["pre_ffn_norm"]
        mlp_in = norm(h, w[li], eps)
    else:
        h = h + attn_out
        norm, w = norms["post_attn_norm"]
        mlp_in = norm(h, w[li], eps)
    if cfg.mlp_style == "plain":
        mid = act(lin("up", mlp_in))
    elif "gate_up" in lp:
        gu = lin("gate_up", mlp_in)
        mid = act(gu[..., : cfg.intermediate_size]) * gu[..., cfg.intermediate_size :]
    else:
        mid = act(lin("gate", mlp_in)) * lin("up", mlp_in)
    mlp = lin("down", mid)
    if cfg.parallel_block:
        return h + attn_out + mlp
    if cfg.sandwich_norm:
        norm, w = norms["post_ffn_norm"]
        mlp = norm(mlp, w[li], eps)
    return h + mlp


def _save_matmuls(mlp_width):
    """Selective-checkpoint policy: keep the outputs of the non-batched
    matmuls (the projections; attention's batched products are recomputed),
    all of them (mlp_width None: "save_dots"), or those whose weight has no
    dimension of the MLP width ("save_qkvo": q, k, v and o)."""

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.mm.default and (mlp_width is None or not any(
                d in (mlp_width, 2 * mlp_width) for d in args[1].shape)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _tp_linear(lin, lp, li, mesh, row_bias, ring, use_kernels):
    """`lin` on one tp rank's slice: a column-parallel linear's input goes
    through `copy_to_tp` (its gradient summed over tp), a row-parallel
    linear's partial output through `reduce_from_tp` (summed in f32, rounded
    once), and its bias (held apart in `row_bias`) is added once, after the
    sum. With `ring` (BITDISTILLER_RING_TP=1), an unbiased packed
    row-parallel linear whose N splits over tp takes the ring of chunk
    matmuls instead (`layers.ring_linear`)."""

    def tp_lin(name, x):
        if name not in ROW_PARALLEL:
            return lin(name, copy_to_tp(x, mesh))
        b = row_bias.get(name)
        if ring and b is None and ring_ok(lp[name], mesh.tp):
            return ring_linear(lp[name], x, li, mesh, use_kernels=use_kernels)
        out = reduce_from_tp(lin(name, x), mesh)
        return out if b is None else out + b[li].to(out.dtype)

    return tp_lin


def _layer(cfg, lp, norms, li, h, cos, sin, attend, act, quantizer, remat, use_kernels,
           tp=None):
    """Layer li, rematerialized by `remat` (False: not at all). `tp`: (mesh,
    the row-parallel biases, ring) on a tp rank's slice."""
    if remat not in (False, None) and remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; expected one of {REMAT_POLICIES}")
    weights = {}
    if remat in ("save_quantized", "save_dots", "save_qkvo") and quantizer is not None:
        # quantize outside the checkpoint: the quantized weights are kept for
        # the backward instead of being quantized again
        weights = {n: quantizer(lp[n]["w"][li]) for n in LAYER_LINEARS
                   if isinstance(lp.get(n), dict)}
        quantizer = None

    def run(h):
        def lin(name, x):
            if name in weights:
                out = x @ weights[name].to(x.dtype)
                b = lp[name].get("b")
                return out if b is None else out + b[li].to(out.dtype)
            return linear(lp[name], x, li, use_kernels=use_kernels, quantizer=quantizer)

        if tp is not None:
            lin = _tp_linear(lin, lp, li, *tp, use_kernels)
        return _block(cfg, lp, norms, li, h, cos, sin, attend, lin, act)

    if remat in (False, None):
        return run(h)
    if remat in ("save_dots", "save_qkvo"):
        policy = _save_matmuls(None if remat == "save_dots" else cfg.intermediate_size)
        return checkpoint(run, h, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       policy))
    return checkpoint(run, h, use_reentrant=False)


def train_flash_enabled(use_train_flash: Optional[bool]) -> bool:
    """The JAX package's rule: the argument if given, else
    BITDISTILLER_TRAIN_FLASH == "1"."""
    if use_train_flash is not None:
        return use_train_flash
    return os.environ.get("BITDISTILLER_TRAIN_FLASH", "0") == "1"


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    *,
    cache: Optional[KVCache] = None,
    cache_pos=0,  # int, 0-d tensor, or [B] tensor of per-slot positions
    kv_valid: Optional[torch.Tensor] = None,  # [B, T] bool: cache rows a slot may read
    attn_len: Optional[int] = None,  # the decode kernel reads only cache[:attn_len]
    return_kv: bool = False,
    kv_out: Optional[KVCache] = None,
    logits_dtype=torch.float32,
    use_kernels: bool = True,
    quantizer=None,
    attn_mask: Optional[torch.Tensor] = None,  # [B, S] padding mask (1 = real)
    remat=False,
    use_train_flash: Optional[bool] = None,
    mesh=None,
):
    """Returns (logits [B, S, V], cache | prompt KV | None).

    `use_kernels=False` routes the packed matmuls and the decode attention
    through their plain versions on any device: a reference run on the
    card. Otherwise CUDA tensors go through the kernels and CPU tensors
    through the plain versions. The training arguments apply to the
    cache-less forward: `quantizer` fake-quantizes every dense layer weight
    in its own dtype, `attn_mask` masks padded keys, `remat` checkpoints each
    layer (the "save_*" policies quantize the weights outside the
    checkpoint, so the quantized weights are kept; "save_dots" and
    "save_qkvo" also keep the projections' outputs), and the training flash
    attention replaces the causal attention where `train_flash_enabled` and
    the JAX package's rule allow (no ALiBi, no window). `attn_len` is
    dropped, as the JAX package drops it, at or above the cache length or
    where the decode kernel is not taken. `kv_out` (with `return_kv`): each
    layer's fresh k and v are written into its layer of kv_out's [L, B, S,
    Hkv, D] buffers as the layer runs, and kv_out is returned as the KV.

    `mesh` with tp > 1: `params` (and `cache`) are this rank's tp slice
    (`parallel.mesh.shard_params` / `shard_packed_model` by their specs:
    hq / tp and hkv / tp heads, intermediate / tp of the MLP, vocab / tp
    rows of the embedding and the lm_head), and the forward issues
    Megatron's collectives over the mesh's tp group (`parallel/tensor.py`):
    column-parallel q, k, v, gate, up; row-parallel o and down, summed in
    f32, their bias added once after the sum; the vocab-parallel embedding
    and lm_head, whose logits are gathered whole on every rank. A fused
    `qkv` or `gate_up` leaf raises there. With BITDISTILLER_RING_TP=1 a
    packed o or down whose N splits over tp (and with no bias) sums through
    the ring of chunk matmuls (`parallel/overlap.py`) instead of one
    all-reduce."""
    tp = 1 if mesh is None else mesh.tp
    lp = params["layers"]
    tp_args = None
    if tp > 1:
        for fused in ("qkv", "gate_up"):
            if fused in lp:
                raise ValueError(f"the fused leaf {fused!r} cannot be split over tp = {tp} "
                                 f"without mixing its parts: pack with pack_model(..., "
                                 f"fuse=False)")
        cfg = tp_config(cfg, tp)
        lp, row_bias = dict(lp), {}
        for name in ROW_PARALLEL:
            lp[name], row_bias[name] = _without_bias(lp[name])
        for name in ("q_norm", "k_norm"):  # applied to this rank's heads only
            if name in lp:
                lp[name] = copy_to_tp(lp[name], mesh)
        tp_args = (mesh, row_bias, ring_tp_size(mesh) > 1)
    h, positions, start = _embed(params, cfg, tokens, cache_pos, mesh)
    h, fresh_k, fresh_v = _stack(
        cfg, lp, h, positions, start, range(cfg.num_layers), cache=cache, kv_valid=kv_valid,
        attn_len=attn_len, return_kv=return_kv, use_kernels=use_kernels, quantizer=quantizer,
        attn_mask=attn_mask, remat=remat, use_train_flash=use_train_flash, tp_args=tp_args,
        kv_out=kv_out)
    out_cache = None
    if cache is not None:
        _write_back(cache, torch.stack(fresh_k), torch.stack(fresh_v), start, tokens.shape[1])
        out_cache = cache
    elif return_kv:
        out_cache = (kv_out if kv_out is not None
                     else KVCache(k=torch.stack(fresh_k), v=torch.stack(fresh_v)))
    return _head(params, cfg, h, mesh, logits_dtype), out_cache


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache_pos, mesh):
    """The decoder's input: (h [B, S, d] in the compute dtype, positions [1
    or B, S], each slot's start [B] int32), the embedding vocab-parallel on
    a tp slice, with the multiplier, the embedding norm and the learned
    positions."""
    b, s = tokens.shape
    dev = tokens.device
    cdt = torch_dtype(cfg.dtype)
    h = (params["embed"][tokens] if mesh is None or mesh.tp == 1
         else vocab_parallel_embed(params["embed"], tokens, mesh)).to(cdt)
    if cfg.embedding_multiplier != 1.0:  # the multiplier rounded to the compute dtype first
        h = h * torch.tensor(cfg.embedding_multiplier, dtype=cdt).item()

    pos = torch.as_tensor(cache_pos, device=dev)
    per_slot = pos.ndim == 1
    ar = torch.arange(s, device=dev)
    positions = pos[:, None] + ar[None, :] if per_slot else (ar + pos)[None, :]
    start = (pos if per_slot else pos.expand(b)).to(torch.int32)
    if cfg.embedding_norm:
        h = apply_norm(params["embed_norm"], h, cfg.rms_norm_eps)
    if cfg.learned_pos_embeddings:
        # clamped to the table's last row, as an XLA gather clamps (a padded
        # bucket or a long slot can index past it)
        table = params["pos_embed"]
        idx = torch.clamp(positions + cfg.pos_embedding_offset, 0, table.shape[0] - 1)
        h = h + table[idx].to(cdt)
    return h, positions, start


def _stack(cfg: ModelConfig, lp: dict, h, positions, start, layers: range, *, cache=None,
           kv_valid=None, attn_len=None, return_kv=False, use_kernels=True, quantizer=None,
           attn_mask=None, remat=False, use_train_flash=None, tp_args=None, kv_out=None):
    """The decoder layers `layers` (global indices; `lp` holds exactly
    those, stacked from layer layers.start) on h [B, S, d], each through
    `_layer`, with what depends on the flags but not on the layer decided
    once: rope tables, windows, masks, ALiBi, the attention route. `cfg` is
    the rank's (tp_config'd) config; `tp_args` (mesh, row-parallel biases,
    ring) on a tp slice. Returns (h, each layer's fresh k, fresh v: the
    attended ones with a cache or `return_kv`, else empty; with `kv_out`
    they go into its layers instead)."""
    b, s = h.shape[:2]
    dev = h.device
    cdt = torch_dtype(cfg.dtype)
    dh, L = cfg.actual_head_dim, cfg.num_layers
    mesh = None if tp_args is None else tp_args[0]

    # per-layer choices, made once: the global (scaled) rope and, for the
    # sliding layers of a per-layer pattern, the local theta and the window
    per_layer_sliding = bool(cfg.sliding_layers) and cfg.sliding_window is not None
    cos = sin = cos_l = sin_l = None
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions, *rope_tables(cfg, dh, cfg.rope_theta, dev), cdt)
        if per_layer_sliding:
            theta_l = cfg.rope_local_theta or cfg.rope_theta
            cos_l, sin_l = rope_cos_sin(positions, *rope_tables(cfg, dh, theta_l, dev, False),
                                        cdt)
    local = cfg.sliding_layers if per_layer_sliding else (False,) * L
    windows = [cfg.sliding_window if slide or not per_layer_sliding else None for slide in local]

    # ALiBi over [cache ++ fresh] keys (cache rows at positions 0..T-1)
    attn_bias = None
    if cfg.alibi:
        q_pos = positions.expand(b, s)
        k_pos = q_pos
        if cache is not None:
            t = cache.k.shape[3]
            k_pos = torch.cat([torch.arange(t, device=dev).expand(b, t), q_pos], dim=-1)
        if mesh is None:
            slopes = alibi_slopes_on(cfg.num_heads, dev)
        else:  # this rank's heads of the whole model's slopes
            slopes = alibi_slopes_on(cfg.num_heads * mesh.tp, dev).narrow(
                0, mesh.tp_rank * cfg.num_heads, cfg.num_heads)
        attn_bias = alibi_bias(slopes, q_pos, k_pos)

    # the decode attention kernel where the JAX package's flash_ok holds
    flash_ok = (cache is not None and s == 1 and not cfg.alibi and kv_valid is None
                and not per_layer_sliding)
    if cache is None or not flash_ok or (attn_len is not None and attn_len >= cache.k.shape[3]):
        attn_len = None
    decode_attend = flash_decode_stacked if use_kernels else decode_attention_plain
    train_flash = (cache is None and train_flash_enabled(use_train_flash) and not cfg.alibi
                   and cfg.sliding_window is None and not per_layer_sliding)
    masks = {}  # window -> mask, built once a forward
    if not (flash_ok or train_flash):
        for w in {windows[g] for g in layers}:
            masks[w] = (_cache_mask(cache, start, positions, s, kv_valid, w) if cache is not None
                        else _causal_mask(b, s, dev, attn_mask, w))

    norms = _layer_norms(cfg, lp)
    act = activation(cfg.hidden_act)
    fresh_k, fresh_v = [], []
    for g in layers:
        li = g - layers.start
        window = windows[g]
        c, sn = (cos_l, sin_l) if local[g] else (cos, sin)
        if cache is not None:
            def attend(q, k, v, li=li, mask=masks[window] if masks else None):
                # int8 cache: fresh k/v stay in the compute dtype here and are
                # quantized once at the write-back
                fresh_dtype = k.dtype if cache.quantized else cache.k.dtype
                k, v = k.to(fresh_dtype), v.to(fresh_dtype)
                fresh_k.append(k)
                fresh_v.append(v)
                if flash_ok:
                    return decode_attend(q, cache.k, cache.v, li, k, v, start,
                                         k_scale=cache.k_scale, v_scale=cache.v_scale,
                                         window=cfg.sliding_window, attn_len=attn_len)
                return cached_attention(
                    q, cache.k[li], cache.v[li], k, v, mask,
                    k_scale=cache.k_scale[li] if cache.quantized else None,
                    v_scale=cache.v_scale[li] if cache.quantized else None, bias=attn_bias,
                )
        else:
            if train_flash:
                inner = functools.partial(flash_train_attention, attn_mask=attn_mask)
            else:
                inner = functools.partial(causal_attention, mask=masks[window], bias=attn_bias)
            if return_kv and kv_out is not None:
                def attend(q, k, v, inner=inner, li=li):
                    kv_out.k[li].copy_(k)
                    kv_out.v[li].copy_(v)
                    return inner(q, k, v)
            elif return_kv:
                def attend(q, k, v, inner=inner):
                    fresh_k.append(k)
                    fresh_v.append(v)
                    return inner(q, k, v)
            else:
                attend = inner
        h = _layer(cfg, lp, norms, li, h, c, sn, attend, act, quantizer, remat,
                   use_kernels, tp_args)
    return h, fresh_k, fresh_v


def _head(params: dict, cfg: ModelConfig, h, mesh, logits_dtype):
    """The final norm and the lm_head (the tied embedding where there is
    none); on a tp slice vocab-parallel, the logits gathered whole."""
    tp = 1 if mesh is None else mesh.tp
    h = apply_norm(params["final_norm"], h, cfg.rms_norm_eps, cfg.norm_offset)
    if tp > 1:
        h = copy_to_tp(h, mesh)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = h @ params["embed"].t().to(h.dtype)
    else:
        logits = linear(params["lm_head"], h)
    if tp > 1:
        logits = gather_from_tp(logits, mesh)
    return logits.to(logits_dtype)


def _without_bias(leaf):
    """(the linear leaf without its bias, the bias or None)."""
    if isinstance(leaf, PackedLinear):
        return dataclasses.replace(leaf, bias=None), leaf.bias
    return {k: v for k, v in leaf.items() if k != "b"}, leaf.get("b")


def fake_quant_weights(params: dict, quantizer) -> dict:
    """Apply a fake quantizer to every layer linear weight once (PTQ-style),
    computed in f32 and stored back in the weight's dtype."""
    out = dict(params, layers=dict(params["layers"]))
    for name in LAYER_LINEARS:
        if name not in out["layers"]:
            continue
        leaf = out["layers"][name]
        w = leaf["w"]
        out["layers"][name] = dict(leaf, w=quantizer(w.to(torch.float32)).to(w.dtype))
    return out


def quantize_layer_weights(params: dict, quantizer) -> dict:
    """Differentiable one-shot weight quantization, the same values as
    `linear()` computes in the forward (the quantizer in the weight's own
    dtype), with the gradient paths of in-forward QAT. The returned tree goes
    into `forward(..., quantizer=None)` unchanged (the fused training step
    quantizes once a cycle through it)."""
    out = dict(params, layers=dict(params["layers"]))
    for name in LAYER_LINEARS:
        if name not in out["layers"]:
            continue
        leaf = out["layers"][name]
        out["layers"][name] = dict(leaf, w=quantizer(leaf["w"]))
    return out
