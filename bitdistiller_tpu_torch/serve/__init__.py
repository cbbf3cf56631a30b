from .engine import Engine, Request
from .sampling import SamplingParams, sample_tokens, sample_tokens_batched

__all__ = ["Engine", "Request", "SamplingParams", "sample_tokens", "sample_tokens_batched"]
