"""Export a model to the GPTQ packed format (PyTorch port of the JAX
package's `models/gptq_export.py`; the same tensors, bit for bit).

Each linear becomes the standard GPTQ tensor set per layer:

  qweight : int32 [K/pack, N]   word r packs code(k = r*pack + i) at bit i*bits
  qzeros  : int32 [K/G, N/pack] word c packs zero(n = c*pack + i) at bit i*bits
  scales  : f16   [K/G, N]
  g_idx   : int32 [K] = k // G

beside the norm and embedding tensors in f16 under HF names, with a
`quantize_config.json` and a `config.json`. A dense tree is quantized here
(RTN asym, `quant/core.py:quantize_int`); a packed serving tree is exported
without requantization: its pair-layout codes are unpacked and re-packed in
GPTQ's order, with its own f32 scales and zero points (fused qkv / gate_up
leaves are split along N, which is exact: the groups are per output column).

Like the JAX package's, `config.json` says `"model_type": "llama"` for every
family (ROADMAP C4), and the re-fused q/k/v of Falcon, Bloom and MPT are
quantized from the dense tree's split leaves.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..quant.core import quantize_int
from ..quant.packing import PackedLinear, unpack_codes
from . import safetensors_io
from .config import ModelConfig

_GPTQ_LAYER_MAP = {
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "o": "self_attn.o_proj",
    "gate": "mlp.gate_proj",
    "up": "mlp.up_proj",
    "down": "mlp.down_proj",
}

# per family: ours -> HF module path; a family whose HF layout fuses q/k/v
# carries a ("__qkv__", path) entry, re-fused in the family's layout
_FAMILY_LAYER_MAPS = {
    "llama": _GPTQ_LAYER_MAP,
    "falcon": {
        "__qkv__": "self_attention.query_key_value",
        "o": "self_attention.dense",
        "up": "mlp.dense_h_to_4h",
        "down": "mlp.dense_4h_to_h",
    },
    "bloom": {
        "__qkv__": "self_attention.query_key_value",
        "o": "self_attention.dense",
        "up": "mlp.dense_h_to_4h",
        "down": "mlp.dense_4h_to_h",
    },
    "mpt": {
        "__qkv__": "attn.Wqkv",
        "o": "attn.out_proj",
        "up": "ffn.up_proj",
        "down": "ffn.down_proj",
    },
    "opt": {
        "q": "self_attn.q_proj",
        "k": "self_attn.k_proj",
        "v": "self_attn.v_proj",
        "o": "self_attn.out_proj",
        "up": "fc1",
        "down": "fc2",
    },
}

_FAMILY_LAYER_PREFIX = {
    "llama": "model.layers", "opt": "model.decoder.layers",
    "falcon": "transformer.h", "bloom": "transformer.h",
    "mpt": "transformer.blocks",
}

# family: (embed, final_norm_w, final_norm_b or None, input_norm, post_attn_norm)
_FAMILY_AUX_NAMES = {
    "llama": ("model.embed_tokens.weight", "model.norm.weight", None,
              "input_layernorm", "post_attention_layernorm"),
    "opt": ("model.decoder.embed_tokens.weight", "model.decoder.final_layer_norm.weight",
            "model.decoder.final_layer_norm.bias", "self_attn_layer_norm", "final_layer_norm"),
    "falcon": ("transformer.word_embeddings.weight", "transformer.ln_f.weight",
               "transformer.ln_f.bias", "input_layernorm", "post_attention_layernorm"),
    "bloom": ("transformer.word_embeddings.weight", "transformer.ln_f.weight",
              "transformer.ln_f.bias", "input_layernorm", "post_attention_layernorm"),
    "mpt": ("transformer.wte.weight", "transformer.norm_f.weight", None, "norm_1", "norm_2"),
}

_U32 = 1 << 32


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the same bits as int32."""
    return torch.where(words >= (1 << 31), words - _U32, words).to(torch.int32)


def fuse_qkv_hf(cfg: ModelConfig, q_kn, k_kn, v_kn) -> torch.Tensor:
    """Re-fuse split q/k/v [K, N*] into the family's fused HF layout, as
    [K, N_fused]: the inverse of `hf_import`'s split (Falcon grouped or
    per-head, Bloom per-head, MPT sequential)."""
    K = q_kn.shape[0]
    dh, hq, hkv = cfg.actual_head_dim, cfg.num_heads, cfg.num_kv_heads
    if cfg.model_type == "mpt":
        return torch.cat([q_kn, k_kn, v_kn], dim=1)
    if cfg.model_type == "bloom" or (cfg.model_type == "falcon" and hkv == hq
                                     and not cfg.parallel_mlp_norm):
        # per-head interleave [H, 3, dh] (bloom always; falcon-rw MHA)
        g = torch.stack([q_kn.reshape(K, hq, dh), k_kn.reshape(K, hq, dh),
                         v_kn.reshape(K, hq, dh)], dim=2)
        return g.reshape(K, hq * 3 * dh)
    if cfg.model_type == "falcon":
        if cfg.parallel_mlp_norm:  # new-arch grouped layout [hkv, q_per + 2, dh]
            q_per = hq // hkv
            g = torch.cat([q_kn.reshape(K, hkv, q_per, dh), k_kn.reshape(K, hkv, 1, dh),
                           v_kn.reshape(K, hkv, 1, dh)], dim=2)
            return g.reshape(K, (hq + 2 * hkv) * dh)
        return torch.cat([q_kn, k_kn, v_kn], dim=1)  # falcon MQA: [q heads..., k, v]
    raise ValueError(f"no fused-qkv layout for family {cfg.model_type!r}")


def pack_gptq_qweight(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes [K, N] in [0, 2^bits) -> int32 [K/pack, N], k-sequential."""
    k, n = codes.shape
    pack = 32 // bits
    if k % pack:
        raise ValueError(f"K={k} is not a multiple of {pack} codes a word")
    q = codes.to(torch.int64).reshape(k // pack, pack, n)
    shifts = (torch.arange(pack, dtype=torch.int64, device=codes.device) * bits)[None, :, None]
    return _to_int32((q << shifts).sum(dim=1))


def pack_gptq_qzeros(zeros: torch.Tensor, bits: int) -> torch.Tensor:
    """zeros [K/G, N] -> int32 [K/G, N/pack], n-sequential."""
    ng, n = zeros.shape
    pack = 32 // bits
    if n % pack:
        raise ValueError(f"N={n} is not a multiple of {pack} zeros a word")
    z = zeros.to(torch.int64).reshape(ng, n // pack, pack)
    shifts = (torch.arange(pack, dtype=torch.int64, device=zeros.device) * bits)[None, None, :]
    return _to_int32((z << shifts).sum(dim=2))


def unpack_gptq_qweight(qweight: torch.Tensor, bits: int) -> torch.Tensor:
    """The inverse of `pack_gptq_qweight`: int32 [K/pack, N] -> codes [K, N]."""
    pack = 32 // bits
    mask = (1 << bits) - 1
    w = qweight.to(torch.int64) & (_U32 - 1)
    parts = [(w >> (i * bits)) & mask for i in range(pack)]
    return torch.stack(parts, dim=1).reshape(-1, qweight.shape[1]).to(torch.int32)


def _g_idx(k: int, group_size: int, device) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32, device=device) // group_size


def packed_layer_to_gptq(p: PackedLinear, li: int, bits: int, group_size: int) -> dict:
    """Layer `li` of a stacked PackedLinear -> its GPTQ tensors, without
    requantizing: the pair-layout codes unpacked to k order, the integer zero
    points recovered from szeros = zeros * scales, re-packed in GPTQ's order.
    The serving words and the GPTQ words hold the same integer codes."""
    if p.a8_order:
        raise ValueError("qweight is in A8 extraction order; the pair-layout unpack would "
                         "scramble k")
    scales = p.scales[li].to(torch.float32)
    szeros = p.szeros[li].to(torch.float32)
    codes = unpack_codes(p.qweight[li], bits, group_size)  # [K, N]
    zeros = torch.round(szeros / torch.where(scales == 0, torch.ones_like(scales), scales))
    return {
        "qweight": pack_gptq_qweight(codes, bits),
        "qzeros": pack_gptq_qzeros(zeros.to(torch.int32), bits),
        "scales": scales.to(torch.float16),
        "g_idx": _g_idx(codes.shape[0], group_size, codes.device),
    }


def split_packed_n(p: PackedLinear, splits: list[int]) -> list[PackedLinear]:
    """Split a stacked fused PackedLinear along N at the given widths (qkv ->
    q/k/v, gate_up -> gate/up): per-N arrays slice together, and the group
    statistics are per output column, so each part is what packing it alone
    would have made."""
    outs = []
    start = 0
    for width in splits:
        cut = lambda a: None if a is None else a[..., start: start + width]
        outs.append(dataclasses.replace(p, qweight=cut(p.qweight), scales=cut(p.scales),
                                        szeros=cut(p.szeros), combo=cut(p.combo),
                                        bias=cut(p.bias), out_features=width))
        start += width
    return outs


def layer_to_gptq(w_kn: torch.Tensor, bits: int, group_size: int) -> dict:
    """A dense [K, N] weight -> its GPTQ tensors (RTN asym, the training grid:
    groups run along K per output column, so the transpose is quantized)."""
    k, n = w_kn.shape
    codes_g, params = quantize_int(w_kn.to(torch.float32).T, bits, group_size)
    codes = codes_g.reshape(n, k).T  # [K, N]
    scales = params.scales.reshape(n, k // group_size).T  # [K/G, N]
    zeros = params.zeros.reshape(n, k // group_size).T.to(torch.int32)
    return {
        "qweight": pack_gptq_qweight(codes, bits),
        "qzeros": pack_gptq_qzeros(zeros, bits),
        "scales": scales.to(torch.float16),
        "g_idx": _g_idx(k, group_size, w_kn.device),
    }


def export_gptq(params: dict, cfg: ModelConfig, path: str, *, bits: int = 2,
                group_size: int = 128) -> None:
    """Write a GPTQ-format `model.safetensors`, `quantize_config.json` and
    `config.json` into `path`, for a dense tree (quantized here at `bits` and
    `group_size`) or a packed one (each leaf keeps its own bits and group)."""
    os.makedirs(path, exist_ok=True)
    family = cfg.model_type if cfg.model_type in _FAMILY_LAYER_MAPS else "llama"
    layer_map = _FAMILY_LAYER_MAPS[family]
    prefix = _FAMILY_LAYER_PREFIX[family]
    embed_name, fnw, fnb, in_norm, post_norm = _FAMILY_AUX_NAMES[family]
    f16 = lambda t: t.to(torch.float16)

    out: dict[str, torch.Tensor] = {embed_name: f16(params["embed"])}
    fn = params["final_norm"]
    if isinstance(fn, dict):
        out[fnw] = f16(fn["w"])
        if fnb:
            out[fnb] = f16(fn["b"])
    else:
        out[fnw] = f16(fn)
    if "lm_head" in params:
        out["lm_head.weight"] = f16(params["lm_head"]["w"]).T

    layers = dict(params["layers"])
    L = cfg.num_layers
    dh, hq, hkv = cfg.actual_head_dim, cfg.num_heads, cfg.num_kv_heads
    # fused packed leaves -> split views under the unfused names
    if isinstance(layers.get("qkv"), PackedLinear):
        q, k, v = split_packed_n(layers.pop("qkv"), [hq * dh, hkv * dh, hkv * dh])
        layers.update({"q": q, "k": k, "v": v})
    if isinstance(layers.get("gate_up"), PackedLinear):
        g, u = split_packed_n(layers.pop("gate_up"),
                              [cfg.intermediate_size, cfg.intermediate_size])
        layers.update({"gate": g, "up": u})

    def put(i: int, theirs: str, tensors: dict) -> None:
        for tname, t in tensors.items():
            out[f"{prefix}.{i}.{theirs}.{tname}"] = t

    for ours, theirs in layer_map.items():
        if ours == "__qkv__":
            for i in range(L):
                fused = fuse_qkv_hf(cfg, layers["q"]["w"][i], layers["k"]["w"][i],
                                    layers["v"]["w"][i])
                put(i, theirs, layer_to_gptq(fused, bits, group_size))
            continue
        if ours not in layers:
            continue
        leaf = layers[ours]
        for i in range(L):
            if isinstance(leaf, PackedLinear):
                put(i, theirs, packed_layer_to_gptq(leaf, i, leaf.bits, leaf.group_size))
            else:
                w = leaf["w"] if isinstance(leaf, dict) else leaf
                put(i, theirs, layer_to_gptq(w[i], bits, group_size))
            if isinstance(leaf, dict) and leaf.get("b") is not None:
                out[f"{prefix}.{i}.{theirs}.bias"] = f16(leaf["b"][i])
    for norm_ours, norm_theirs in (("input_norm", in_norm), ("post_attn_norm", post_norm),
                                   ("mlp_norm", "ln_mlp")):
        if norm_ours not in layers:
            continue
        leaf = layers[norm_ours]
        arr = leaf["w"] if isinstance(leaf, dict) else leaf
        for i in range(L):
            out[f"{prefix}.{i}.{norm_theirs}.weight"] = f16(arr[i])
            if isinstance(leaf, dict) and "b" in leaf:
                out[f"{prefix}.{i}.{norm_theirs}.bias"] = f16(leaf["b"][i])
    # falcon new-arch names its input norm ln_attn (dual-norm blocks)
    if family == "falcon" and "mlp_norm" in layers:
        for i in range(L):
            for suffix in ("weight", "bias"):
                key = f"{prefix}.{i}.{in_norm}.{suffix}"
                if key in out:
                    out[f"{prefix}.{i}.ln_attn.{suffix}"] = out.pop(key)

    safetensors_io.write(os.path.join(path, "model.safetensors"), out)
    quant = {"bits": bits, "group_size": group_size, "desc_act": False, "sym": False}
    with open(os.path.join(path, "quantize_config.json"), "w") as f:
        json.dump({**quant, "quant_method": "gptq"}, f, indent=2)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "llama",
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "quantization_config": {"quant_method": "gptq", **quant},
        }, f, indent=2)
