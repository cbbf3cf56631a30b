"""Load Hugging Face checkpoints into the port's stacked param tree, and save
a tree back (PyTorch port of the JAX package's `models/hf_import.py`).

Every family of the JAX loader: Llama and its kin (TinyLlama, Qwen2 with
q/k/v biases, Qwen3 q/k norms, Phi-3's fused qkv_proj / gate_up_proj,
Gemma-2/3 sandwich norms), Falcon (MQA, falcon-rw's per-head MHA, the
new-architecture grouped layout), MPT, OPT and Bloom. HF's [out, in]
weights become [K, N] (x @ W), stacked along a leading layer axis.

Files are read by the port's own safetensors reader (`safetensors_io`),
else as `pytorch_model*.bin` shards through `torch.load(weights_only=True)`.
Each stacked leaf is built on `device` one layer at a time: a layer's HF
tensor is moved there in its file dtype, split, transposed and cast (round
to nearest even, as the JAX loader's astype) into the leaf, so the host
holds no more than the file's mapping.

`save_hf_checkpoint` writes what the JAX package's writes, tensor for
tensor, with the same 11-field Llama `config.json`. Two faults of the JAX
save are kept as they are (ROADMAP C4): it writes the Llama layout and
`"model_type": "llama"` for every tree, so a Qwen3 tree's q/k norms are
saved but dropped on reload; and it cannot write a LayerNorm tree (its
`{"w", "b"}` norms), where the port raises a ValueError naming the family
before anything is written.
"""

from __future__ import annotations

import glob
import json
import os

import torch

from .._device import resolve_device
from . import safetensors_io
from .config import ModelConfig

_HF_LAYER_MAP = {
    "input_norm": ("input_layernorm.weight", False),
    "post_attn_norm": ("post_attention_layernorm.weight", False),
    "q": ("self_attn.q_proj.weight", True),
    "k": ("self_attn.k_proj.weight", True),
    "v": ("self_attn.v_proj.weight", True),
    "o": ("self_attn.o_proj.weight", True),
    "gate": ("mlp.gate_proj.weight", True),
    "up": ("mlp.up_proj.weight", True),
    "down": ("mlp.down_proj.weight", True),
    "q_norm": ("self_attn.q_norm.weight", False),
    "k_norm": ("self_attn.k_norm.weight", False),
    # gemma3 sandwich norms
    "pre_ffn_norm": ("pre_feedforward_layernorm.weight", False),
    "post_ffn_norm": ("post_feedforward_layernorm.weight", False),
}
_HF_BIAS_MAP = {
    "q": "self_attn.q_proj.bias",
    "k": "self_attn.k_proj.bias",
    "v": "self_attn.v_proj.bias",
}


def _load_all_tensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the checkpoint dir, on the host: each `*.safetensors`
    in sorted order (views of the files' mappings), else the
    `pytorch_model*.bin` shards."""
    tensors: dict[str, torch.Tensor] = {}
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if files:
        for f in files:
            tensors.update(safetensors_io.read(f))
        return tensors
    bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(f"no .safetensors or pytorch_model*.bin under {path}")
    for f in bins:
        tensors.update(torch.load(f, map_location="cpu", weights_only=True, mmap=True))
    return tensors


class _LeafMaker:
    """Makes the tree's leaves on `device` in `dtype` from host tensors."""

    def __init__(self, raw: dict, dtype: torch.dtype, device: torch.device):
        self.raw, self.dtype, self.device = raw, dtype, device

    def get(self, name: str) -> torch.Tensor:
        """A file tensor, on the device in its own dtype."""
        return self.raw[name].to(self.device)

    def one(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=self.dtype, device=self.device)
        return out.copy_(t)

    def stack(self, num_layers: int, part) -> torch.Tensor:
        """[L, ...] of part(i), cast into the leaf a layer at a time."""
        first = part(0)
        out = torch.empty((num_layers,) + tuple(first.shape), dtype=self.dtype,
                          device=self.device)
        out[0].copy_(first)
        for i in range(1, num_layers):
            out[i].copy_(part(i))
        return out


def _load_falcon(b: _LeafMaker, cfg: ModelConfig) -> dict:
    """Falcon (tiiuae/falcon-7b layout). The fused query_key_value weight has
    three layouts (HF modeling_falcon.py `_split_heads`):
    - multi-query (falcon-7b, num_kv_heads=1): sequential [H*dh | dh | dh]
    - full MHA (falcon-rw, multi_query=False): per-head interleave [H, 3, dh]
    - new_decoder_architecture (40B/180B, cfg.parallel_mlp_norm): kv-grouped
      interleave [Hkv, q_per_kv + 2, dh], with ln_attn / ln_mlp norms."""
    L = cfg.num_layers
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.actual_head_dim
    q_rows, kv_rows = hq * dh, hkv * dh
    raw = b.raw

    def split_qkv(qkv):  # [(hq + 2 hkv) dh, K] -> q, k, v in the model's head order
        kdim = qkv.shape[-1]
        if cfg.parallel_mlp_norm:
            q_per = hq // hkv
            g = qkv.reshape(hkv, q_per + 2, dh, kdim)
            return (g[:, :q_per].reshape(q_rows, kdim), g[:, q_per].reshape(kv_rows, kdim),
                    g[:, q_per + 1].reshape(kv_rows, kdim))
        if hkv == hq:  # falcon-rw full MHA: [H, 3, dh] per-head interleave
            g = qkv.reshape(hq, 3, dh, kdim)
            return tuple(g[:, j].reshape(q_rows, kdim) for j in range(3))
        return qkv[:q_rows], qkv[q_rows: q_rows + kv_rows], qkv[q_rows + kv_rows:]

    def qkv_part(j):
        return lambda i: split_qkv(
            b.get(f"transformer.h.{i}.self_attention.query_key_value.weight"))[j].T

    def lin(name):
        return {"w": b.stack(L, lambda i: b.get(f"transformer.h.{i}.{name}.weight").T)}

    def norm(name):
        return {"w": b.stack(L, lambda i: b.get(f"transformer.h.{i}.{name}.weight")),
                "b": b.stack(L, lambda i: b.get(f"transformer.h.{i}.{name}.bias"))}

    layers = {
        "input_norm": norm("ln_attn" if cfg.parallel_mlp_norm else "input_layernorm"),
        "q": {"w": b.stack(L, qkv_part(0))},
        "k": {"w": b.stack(L, qkv_part(1))},
        "v": {"w": b.stack(L, qkv_part(2))},
        "o": lin("self_attention.dense"),
        "up": lin("mlp.dense_h_to_4h"),
        "down": lin("mlp.dense_4h_to_h"),
    }
    if cfg.parallel_mlp_norm:
        layers["mlp_norm"] = norm("ln_mlp")
    if not cfg.parallel_block:  # falcon variants with parallel_attn=False
        layers["post_attn_norm"] = norm("post_attention_layernorm")
    params = {
        "embed": b.one(b.get("transformer.word_embeddings.weight")),
        "final_norm": {"w": b.one(b.get("transformer.ln_f.weight")),
                       "b": b.one(b.get("transformer.ln_f.bias"))},
        "layers": layers,
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in raw:
        params["lm_head"] = {"w": b.one(b.get("lm_head.weight").T)}
    return params


def _load_mpt(b: _LeafMaker, cfg: ModelConfig) -> dict:
    """MPT (mosaicml/mpt-7b layout). Wqkv [D + 2 kv, D] splits sequentially;
    LayerNorms without a bias in the file (no_bias=True) get zero biases,
    for the {"w", "b"} norm leaf."""
    L, d, kv = cfg.num_layers, cfg.hidden_size, cfg.kv_size
    raw = b.raw

    def norm(prefix):
        w = b.stack(L, lambda i: b.get(f"transformer.blocks.{i}.{prefix}.weight"))
        if f"transformer.blocks.0.{prefix}.bias" in raw:
            bias = b.stack(L, lambda i: b.get(f"transformer.blocks.{i}.{prefix}.bias"))
        else:
            bias = torch.zeros_like(w)
        return {"w": w, "b": bias}

    def wqkv(lo, hi):
        return lambda i: b.get(f"transformer.blocks.{i}.attn.Wqkv.weight")[lo:hi].T

    def lin(name):
        return {"w": b.stack(L, lambda i: b.get(f"transformer.blocks.{i}.{name}.weight").T)}

    layers = {
        "input_norm": norm("norm_1"),
        "post_attn_norm": norm("norm_2"),
        "q": {"w": b.stack(L, wqkv(0, d))},
        "k": {"w": b.stack(L, wqkv(d, d + kv))},
        "v": {"w": b.stack(L, wqkv(d + kv, None))},
        "o": lin("attn.out_proj"),
        "up": lin("ffn.up_proj"),
        "down": lin("ffn.down_proj"),
    }
    fw = b.one(b.get("transformer.norm_f.weight"))
    fb = (b.one(b.get("transformer.norm_f.bias")) if "transformer.norm_f.bias" in raw
          else torch.zeros_like(fw))
    return {"embed": b.one(b.get("transformer.wte.weight")),
            "final_norm": {"w": fw, "b": fb}, "layers": layers}


def _load_opt(b: _LeafMaker, cfg: ModelConfig) -> dict:
    """OPT (the facebook OPT layout, under `model.decoder.` or `decoder.`). The
    learned positions table keeps its +2 offset; every projection and norm
    has a bias."""
    L = cfg.num_layers
    raw = b.raw

    def t(name):
        key = f"model.decoder.{name}"
        if key not in raw:
            key = f"decoder.{name}"
        return b.get(key)

    def linear(name):
        leaf = {"w": b.stack(L, lambda i: t(f"layers.{i}.{name}.weight").T)}
        if f"model.decoder.layers.0.{name}.bias" in raw or f"decoder.layers.0.{name}.bias" in raw:
            leaf["b"] = b.stack(L, lambda i: t(f"layers.{i}.{name}.bias"))
        return leaf

    def norm(name):
        return {"w": b.stack(L, lambda i: t(f"layers.{i}.{name}.weight")),
                "b": b.stack(L, lambda i: t(f"layers.{i}.{name}.bias"))}

    layers = {
        "input_norm": norm("self_attn_layer_norm"),
        "post_attn_norm": norm("final_layer_norm"),
        "q": linear("self_attn.q_proj"),
        "k": linear("self_attn.k_proj"),
        "v": linear("self_attn.v_proj"),
        "o": linear("self_attn.out_proj"),
        "up": linear("fc1"),
        "down": linear("fc2"),
    }
    return {
        "embed": b.one(t("embed_tokens.weight")),
        "pos_embed": b.one(t("embed_positions.weight")),
        "final_norm": {"w": b.one(t("final_layer_norm.weight")),
                       "b": b.one(t("final_layer_norm.bias"))},
        "layers": layers,
    }


def _load_bloom(b: _LeafMaker, cfg: ModelConfig) -> dict:
    """Bloom (bigscience/bloom-* layout). The fused query_key_value weight and
    bias are per-head interleaved, [H, 3, dh, K] and [H, 3, dh]."""
    L, H, dh = cfg.num_layers, cfg.num_heads, cfg.actual_head_dim

    def h(i, name):
        return b.get(f"transformer.h.{i}.{name}")

    def norm(prefix):
        return {"w": b.stack(L, lambda i: h(i, f"{prefix}.weight")),
                "b": b.stack(L, lambda i: h(i, f"{prefix}.bias"))}

    def qkv(which):  # 0 = q, 1 = k, 2 = v
        w = lambda i: h(i, "self_attention.query_key_value.weight").reshape(
            H, 3, dh, -1)[:, which].reshape(H * dh, -1).T
        bias = lambda i: h(i, "self_attention.query_key_value.bias").reshape(
            H, 3, dh)[:, which].reshape(H * dh)
        return {"w": b.stack(L, w), "b": b.stack(L, bias)}

    def lin(name):
        return {"w": b.stack(L, lambda i: h(i, f"{name}.weight").T),
                "b": b.stack(L, lambda i: h(i, f"{name}.bias"))}

    layers = {
        "input_norm": norm("input_layernorm"),
        "post_attn_norm": norm("post_attention_layernorm"),
        "q": qkv(0),
        "k": qkv(1),
        "v": qkv(2),
        "o": lin("self_attention.dense"),
        "up": lin("mlp.dense_h_to_4h"),
        "down": lin("mlp.dense_4h_to_h"),
    }
    return {
        "embed": b.one(b.get("transformer.word_embeddings.weight")),
        "embed_norm": {"w": b.one(b.get("transformer.word_embeddings_layernorm.weight")),
                       "b": b.one(b.get("transformer.word_embeddings_layernorm.bias"))},
        "final_norm": {"w": b.one(b.get("transformer.ln_f.weight")),
                       "b": b.one(b.get("transformer.ln_f.bias"))},
        "layers": layers,
    }


def _load_llama(b: _LeafMaker, cfg: ModelConfig) -> dict:
    """Llama and its kin: TinyLlama, Qwen2/3, Phi-3 (fused), Gemma-2/3."""
    raw = b.raw

    def key(name):
        if name in raw:
            return name
        if "model." + name in raw:
            return "model." + name
        raise KeyError(name)

    def has(name):
        return name in raw or ("model." + name) in raw

    def get(name):
        return b.get(key(name))

    L = cfg.num_layers
    # Phi-3 stores fused qkv_proj / gate_up_proj: split into the unfused leaves
    phi3_fused = has("model.layers.0.self_attn.qkv_proj.weight")
    qs, kvs, ffn = cfg.q_size, cfg.kv_size, cfg.intermediate_size
    fused_rows = {"q": ("qkv_proj", 0, qs), "k": ("qkv_proj", qs, qs + kvs),
                  "v": ("qkv_proj", qs + kvs, None), "gate": ("gate_up_proj", 0, ffn),
                  "up": ("gate_up_proj", ffn, None)}

    layers: dict = {}
    for ours, (theirs, transpose) in _HF_LAYER_MAP.items():
        if ours in ("q_norm", "k_norm") and not cfg.qk_norm:
            continue
        if ours in ("pre_ffn_norm", "post_ffn_norm") and not cfg.sandwich_norm:
            continue
        if phi3_fused and ours in fused_rows:
            src, lo, hi = fused_rows[ours]
            mod = "self_attn" if src == "qkv_proj" else "mlp"
            part = (lambda i, mod=mod, src=src, lo=lo, hi=hi:
                    get(f"model.layers.{i}.{mod}.{src}.weight")[lo:hi].T)
        elif transpose:
            part = lambda i, theirs=theirs: get(f"model.layers.{i}.{theirs}").T
        else:
            part = lambda i, theirs=theirs: get(f"model.layers.{i}.{theirs}")
        layers[ours] = b.stack(L, part)

    for ours, theirs in _HF_BIAS_MAP.items():
        if has(f"model.layers.0.{theirs}"):
            bias = b.stack(L, lambda i, theirs=theirs: get(f"model.layers.{i}.{theirs}"))
            layers[ours] = {"w": layers[ours], "b": bias}
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        if not isinstance(layers[name], dict):
            layers[name] = {"w": layers[name]}

    params = {
        "embed": b.one(get("model.embed_tokens.weight")),
        "final_norm": b.one(get("model.norm.weight")),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings and has("lm_head.weight"):
        params["lm_head"] = {"w": b.one(get("lm_head.weight").T)}
    return params


def load_hf_checkpoint(path: str, cfg: ModelConfig | None = None, dtype=torch.bfloat16,
                       device="cuda") -> tuple[dict, ModelConfig]:
    """An HF checkpoint dir -> (params, cfg), the tree `forward`, `pack_model`
    and `run_training` take, every leaf in `dtype` on `device`. The config
    comes from the dir's config.json unless given."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = ModelConfig.from_pretrained(path)
    raw = _load_all_tensors(path)
    b = _LeafMaker(raw, dtype, dev)
    if any(k.startswith("transformer.blocks.") for k in raw):
        return _load_mpt(b, cfg), cfg
    if "transformer.word_embeddings_layernorm.weight" in raw:
        return _load_bloom(b, cfg), cfg
    if any(k.startswith("transformer.h.") for k in raw):
        return _load_falcon(b, cfg), cfg
    if any("decoder.layers." in k for k in raw):
        return _load_opt(b, cfg), cfg
    return _load_llama(b, cfg), cfg


def _layernorm_leaves(params: dict) -> list[str]:
    """The {"w", "b"} norms of a tree, which the Llama layout has no name for."""
    found = ["final_norm"] if isinstance(params["final_norm"], dict) else []
    for name, (_, transpose) in _HF_LAYER_MAP.items():
        if not transpose and isinstance(params["layers"].get(name), dict):
            found.append(f"layers.{name}")
    return found


def save_hf_checkpoint(params: dict, cfg: ModelConfig, path: str, dtype=None) -> None:
    """Write `model.safetensors` (one shard, HF's Llama names, [out, in]
    weights) and `config.json` into `path`, as the JAX package's save does.
    `dtype` casts the floating tensors (None keeps each leaf's own)."""
    norms = _layernorm_leaves(params)
    if norms:
        raise ValueError(
            f"save_hf_checkpoint writes the Llama layout, which has no LayerNorm bias: the "
            f"{cfg.model_type!r} tree's {norms} are {{'w', 'b'}} norms (the JAX package's save "
            f"cannot write them either)")
    os.makedirs(path, exist_ok=True)

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    out = {"model.embed_tokens.weight": cast(params["embed"]),
           "model.norm.weight": cast(params["final_norm"])}
    for ours, (theirs, transpose) in _HF_LAYER_MAP.items():
        if ours not in params["layers"]:
            continue
        leaf = params["layers"][ours]
        arr = leaf["w"] if isinstance(leaf, dict) else leaf
        for i in range(cfg.num_layers):
            out[f"model.layers.{i}.{theirs}"] = cast(arr[i].T if transpose else arr[i])
        if isinstance(leaf, dict) and "b" in leaf and ours in _HF_BIAS_MAP:
            for i in range(cfg.num_layers):
                out[f"model.layers.{i}.{_HF_BIAS_MAP[ours]}"] = cast(leaf["b"][i])
    if "lm_head" in params:
        out["lm_head.weight"] = cast(params["lm_head"]["w"].T)
    safetensors_io.write(os.path.join(path, "model.safetensors"), out)
    cfg_json = {
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_json, f, indent=2)
