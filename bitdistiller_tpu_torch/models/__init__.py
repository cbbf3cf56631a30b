from .config import FALCON_7B, LLAMA2_7B, MPT_7B, TINY_TEST, TINYLLAMA_1B, ModelConfig
from .llama import KVCache, forward, init_params, quantize_kv
from .quantized import (
    load_packed_checkpoint,
    pack_model,
    params_from_numpy,
    random_packed_params,
    train_state_from_numpy,
)

__all__ = [
    "FALCON_7B",
    "LLAMA2_7B",
    "MPT_7B",
    "TINY_TEST",
    "TINYLLAMA_1B",
    "KVCache",
    "ModelConfig",
    "forward",
    "init_params",
    "load_packed_checkpoint",
    "pack_model",
    "params_from_numpy",
    "quantize_kv",
    "random_packed_params",
    "train_state_from_numpy",
]
