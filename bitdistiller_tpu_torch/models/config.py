"""Model configuration for the Llama-family decoder, restated for the
PyTorch port.

Field names and defaults are those of the JAX package's `ModelConfig`, so a
configuration (or a `quant_config.json` written by the JAX package) carries
across unchanged. The port's forward supports the Llama family only and
raises on the other family flags (`models/llama.py:check_supported`).
"""

from __future__ import annotations

import dataclasses
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
