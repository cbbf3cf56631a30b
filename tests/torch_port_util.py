"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
hand the JAX package's param trees to the port as numpy arrays."""

import dataclasses

import numpy as np
import torch

from bitdistiller_tpu.quant.packing import PackedLinear as JaxPackedLinear


def to_numpy_tree(tree):
    """JAX param tree -> nested dicts of numpy arrays; a PackedLinear becomes
    a dict of its arrays plus its meta fields (params_from_numpy's input)."""
    if isinstance(tree, JaxPackedLinear):
        out = {
            "qweight": np.asarray(tree.qweight), "scales": np.asarray(tree.scales),
            "szeros": np.asarray(tree.szeros),
            "bias": None if tree.bias is None else np.asarray(tree.bias),
            "bits": tree.bits, "group_size": tree.group_size,
            "in_features": tree.in_features, "out_features": tree.out_features,
            "a8_order": tree.a8_order,
        }
        if tree.combo is not None:
            out["combo"] = np.asarray(tree.combo)
        return out
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def torch_cfg(jax_cfg):
    """The port's ModelConfig with the same field values."""
    from bitdistiller_tpu_torch.models.config import ModelConfig

    return ModelConfig(**dataclasses.asdict(jax_cfg))


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
