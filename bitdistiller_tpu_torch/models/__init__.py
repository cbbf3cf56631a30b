from .config import LLAMA2_7B, TINY_TEST, ModelConfig
from .llama import KVCache, forward, quantize_kv
from .quantized import (
    load_packed_checkpoint,
    pack_model,
    params_from_numpy,
    random_packed_params,
)

__all__ = [
    "LLAMA2_7B",
    "TINY_TEST",
    "KVCache",
    "ModelConfig",
    "forward",
    "load_packed_checkpoint",
    "pack_model",
    "params_from_numpy",
    "quantize_kv",
    "random_packed_params",
]
