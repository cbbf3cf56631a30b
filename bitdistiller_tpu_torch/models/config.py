"""Model configuration of the decoder families, restated for the PyTorch
port.

Field names and defaults are those of the JAX package's `ModelConfig`, so a
configuration (or a `quant_config.json` written by the JAX package) carries
across unchanged. `from_hf_config` reads a Hugging Face `config.json` dict
field for field as the JAX package's does: Llama/TinyLlama, Qwen2/3, Phi-3,
Gemma-2/3, Falcon (7B and 40B-style), MPT, OPT and Bloom. The port's forward
runs every flag (`models/llama.py`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    embedding_multiplier: float = 1.0
    hidden_act: str = "silu"
    sliding_window: Optional[int] = None
    sliding_layers: Optional[tuple] = None
    rope_local_theta: Optional[float] = None
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: Optional[int] = None
    rope_long_factor: Optional[tuple] = None
    rope_short_factor: Optional[tuple] = None
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_attention_factor: Optional[float] = None
    parallel_block: bool = False
    parallel_mlp_norm: bool = False
    alibi: bool = False
    use_rope: bool = True
    learned_pos_embeddings: bool = False
    pos_embedding_offset: int = 0
    attention_out_bias: bool = False
    embedding_norm: bool = False
    mlp_style: str = "gated"
    norm_type: str = "rms"
    norm_offset: float = 0.0
    sandwich_norm: bool = False
    dtype: str = "bfloat16"

    @property
    def actual_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_size(self) -> int:
        return self.num_heads * self.actual_head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.actual_head_dim

    @staticmethod
    def _rope_scaling_kwargs(cfg: dict) -> dict:
        """Normalize HF `rope_scaling` into ModelConfig fields. Supported:
        linear, llama3, longrope/su. 'default'/absent -> no scaling."""
        rs = cfg.get("rope_scaling") or {}
        if not rs:
            return {}
        typ = rs.get("rope_type", rs.get("type", "linear"))
        if typ == "default":
            return {}
        if typ == "su":  # phi3's historical name for longrope
            typ = "longrope"
        if typ not in ("linear", "llama3", "longrope", "yarn"):
            raise ValueError(
                f"unsupported rope_scaling type {typ!r}; "
                "supported: linear, llama3, longrope/su, yarn"
            )
        out = {
            "rope_scaling_type": typ,
            "rope_scaling_factor": float(rs.get("factor", 1.0)),
            "rope_original_max_position": rs.get(
                "original_max_position_embeddings",
                cfg.get("original_max_position_embeddings"),
            ),
        }
        if typ == "llama3":
            out["rope_low_freq_factor"] = float(rs.get("low_freq_factor", 1.0))
            out["rope_high_freq_factor"] = float(rs.get("high_freq_factor", 4.0))
        if typ == "longrope":
            out["rope_long_factor"] = tuple(float(x) for x in rs.get("long_factor", ()))
            out["rope_short_factor"] = tuple(float(x) for x in rs.get("short_factor", ()))
        if typ == "yarn":
            out["rope_beta_fast"] = float(rs.get("beta_fast", 32.0))
            out["rope_beta_slow"] = float(rs.get("beta_slow", 1.0))
            if rs.get("attention_factor") is not None:
                out["rope_attention_factor"] = float(rs["attention_factor"])
        return out

    @staticmethod
    def from_hf_config(cfg: dict) -> "ModelConfig":
        mc = ModelConfig._from_hf_config_inner(cfg)
        mt = cfg.get("model_type", "llama")
        # legacy falcon model_type aliases
        mt = {"RefinedWeb": "falcon", "RefinedWebModel": "falcon"}.get(mt, mt)
        return dataclasses.replace(mc, model_type=mt)

    @staticmethod
    def _from_hf_config_inner(cfg: dict) -> "ModelConfig":
        """Build from a HF config.json dict. Covers the reference's registry
        (clip_utils.py:234-290): llama/tinyllama, qwen2/3, phi3, gemma2/3,
        falcon, mpt."""
        model_type = cfg.get("model_type", "llama")
        if model_type == "falcon" or model_type == "RefinedWeb" or model_type == "RefinedWebModel":
            alibi = cfg.get("alibi", False)
            n_head = cfg.get("num_attention_heads", cfg.get("n_head"))
            # HF FalconConfig semantics (modeling_falcon.py): the 40B/180B
            # "new" architecture has grouped kv heads + dual ln_attn/ln_mlp;
            # the legacy "RefinedWeb" model_type is that same architecture.
            new_arch = cfg.get("new_decoder_architecture", model_type == "RefinedWeb")
            if new_arch:
                n_kv = cfg.get("num_kv_heads", cfg.get("n_head_kv", 1))
            elif cfg.get("multi_query", True):
                n_kv = 1
            else:
                n_kv = n_head  # falcon-rw: full MHA (per-head fused qkv)
            return ModelConfig(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg.get("ffn_hidden_size", 4 * cfg["hidden_size"]),
                num_layers=cfg.get("num_hidden_layers", cfg.get("n_layer")),
                num_heads=n_head,
                num_kv_heads=n_kv,
                parallel_mlp_norm=new_arch,
                rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                rope_theta=cfg.get("rope_theta", 10000.0),
                max_position_embeddings=cfg.get("max_position_embeddings", 2048),
                tie_word_embeddings=cfg.get("tie_word_embeddings", True),
                parallel_block=cfg.get("parallel_attn", True),
                alibi=alibi,
                use_rope=not alibi,
                hidden_act="gelu",
                mlp_style="plain",
                norm_type="layernorm",
            )
        if model_type == "opt":
            return ModelConfig(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg.get("ffn_dim", 4 * cfg["hidden_size"]),
                num_layers=cfg["num_hidden_layers"],
                num_heads=cfg["num_attention_heads"],
                num_kv_heads=cfg["num_attention_heads"],
                rms_norm_eps=1e-5,
                max_position_embeddings=cfg.get("max_position_embeddings", 2048),
                tie_word_embeddings=cfg.get("tie_word_embeddings", True),
                use_rope=False,
                learned_pos_embeddings=True,
                pos_embedding_offset=2,  # OPT's historical +2 table offset
                attention_bias=cfg.get("enable_bias", True),
                attention_out_bias=cfg.get("enable_bias", True),
                mlp_bias=cfg.get("enable_bias", True),
                hidden_act=cfg.get("activation_function", "relu"),
                mlp_style="plain",
                norm_type="layernorm",
            )
        if model_type == "bloom":
            d = cfg.get("hidden_size", cfg.get("n_embed"))
            return ModelConfig(
                vocab_size=cfg["vocab_size"],
                hidden_size=d,
                intermediate_size=4 * d,
                num_layers=cfg.get("num_hidden_layers", cfg.get("n_layer")),
                num_heads=cfg.get("num_attention_heads", cfg.get("n_head")),
                num_kv_heads=cfg.get("num_attention_heads", cfg.get("n_head")),
                rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                max_position_embeddings=2048,
                tie_word_embeddings=True,
                alibi=True,
                use_rope=False,
                embedding_norm=True,
                attention_bias=True,
                attention_out_bias=True,
                mlp_bias=True,
                hidden_act="gelu_tanh",  # BloomGelu is the tanh approximation
                mlp_style="plain",
                norm_type="layernorm",
            )
        if model_type == "mpt":
            attn_cfg = cfg.get("attn_config", {})
            d = cfg["d_model"]
            return ModelConfig(
                vocab_size=cfg["vocab_size"],
                hidden_size=d,
                intermediate_size=int(cfg.get("expansion_ratio", 4) * d),
                num_layers=cfg["n_layers"],
                num_heads=cfg["n_heads"],
                num_kv_heads=attn_cfg.get("kv_n_heads", cfg["n_heads"]),
                rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                max_position_embeddings=cfg.get("max_seq_len", 2048),
                tie_word_embeddings=True,
                alibi=attn_cfg.get("alibi", True),
                use_rope=not attn_cfg.get("alibi", True),
                hidden_act="gelu",
                mlp_style="plain",
                norm_type="layernorm",
            )
        # as the JAX package: only `hidden_act` is read, so a Gemma-3 config
        # that names its activation `hidden_activation` parses to "silu"
        # (ROADMAP C4; tests/test_torch_families.py pins it)
        act = cfg.get("hidden_act", "silu")
        if act == "gelu_pytorch_tanh":
            act = "gelu_tanh"
        # gemma2/3 interleave sliding(local-rope)/global layers
        # (reference supports gemma3 via clip_utils.py:259-267)
        sliding_layers = None
        rope_local_theta = None
        n_layers = cfg["num_hidden_layers"]
        if model_type in ("gemma2", "gemma3_text") and cfg.get("sliding_window"):
            layer_types = cfg.get("layer_types")
            if layer_types:
                sliding_layers = tuple(
                    lt == "sliding_attention" for lt in layer_types
                )
            else:
                # gemma3 default: every Nth layer global, the rest sliding;
                # gemma2: alternate (pattern 2)
                pattern = cfg.get(
                    "sliding_window_pattern", 6 if model_type == "gemma3_text" else 2
                )
                sliding_layers = tuple(
                    (i + 1) % pattern != 0 for i in range(n_layers)
                )
            rope_local_theta = cfg.get("rope_local_base_freq", 10000.0)
        return ModelConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get("attention_bias", model_type == "qwen2"),
            qk_norm=model_type in ("qwen3", "gemma3_text"),
            hidden_act=act,
            sandwich_norm=model_type in ("gemma2", "gemma3_text"),
            norm_offset=1.0 if model_type.startswith("gemma") else 0.0,
            embedding_multiplier=(
                cfg["hidden_size"] ** 0.5 if model_type.startswith("gemma") else 1.0
            ),
            # phi3/mistral set sliding_window directly; qwen2 gates it behind
            # use_sliding_window=False
            sliding_window=cfg.get("sliding_window")
            if cfg.get("use_sliding_window", True)
            else None,
            sliding_layers=sliding_layers,
            rope_local_theta=rope_local_theta,
            **ModelConfig._rope_scaling_kwargs(cfg),
        )

    @staticmethod
    def from_pretrained(path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return ModelConfig.from_hf_config(json.load(f))


TINY_TEST = ModelConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    max_position_embeddings=512,
)

TINYLLAMA_1B = ModelConfig(
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=22,
    num_heads=32,
    num_kv_heads=4,
    max_position_embeddings=2048,
)

LLAMA2_7B = ModelConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    max_position_embeddings=4096,
)

FALCON_7B = ModelConfig(
    vocab_size=65024,
    hidden_size=4544,
    intermediate_size=4 * 4544,
    num_layers=32,
    num_heads=71,
    num_kv_heads=1,  # falcon-7b multi-query attention
    rms_norm_eps=1e-5,  # the LayerNorm's eps
    max_position_embeddings=2048,
    parallel_block=True,
    hidden_act="gelu",
    mlp_style="plain",
    norm_type="layernorm",
    tie_word_embeddings=True,
)

MPT_7B = ModelConfig(
    vocab_size=50432,
    hidden_size=4096,
    intermediate_size=4 * 4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    max_position_embeddings=2048,
    alibi=True,
    use_rope=False,
    hidden_act="gelu",
    mlp_style="plain",
    norm_type="layernorm",
    tie_word_embeddings=True,
)
