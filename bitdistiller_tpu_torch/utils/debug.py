"""Numerics debugging for training (PyTorch port of the JAX package's
`utils/debug.py`): NaN/Inf detection when BITDISTILLER_DEBUG=1.

`checked(fn)` checks every floating tensor of a step's inputs, runs the
step under autograd's anomaly mode (a NaN coming out of any backward
function raises, naming the forward operation that made it) and checks its
outputs; JAX's checkify does the same inside its jitted step. `assert_tree_finite` raises
with the JAX package's message: every non-finite leaf by its path, with
its count.
"""

from __future__ import annotations

import dataclasses
import os

import torch

DEBUG = os.environ.get("BITDISTILLER_DEBUG", "0") == "1"


def enabled() -> bool:
    """BITDISTILLER_DEBUG=1 as the environment has it now (DEBUG keeps the
    value at import, as the JAX package's does)."""
    return os.environ.get("BITDISTILLER_DEBUG", "0") == "1"


def _leaves_with_path(node, path=""):
    """(path, tensor) of every tensor below node, the path written as
    jax.tree_util.keystr writes it: ['key'] for a dict, [i] for a list or
    tuple, .field for a named tuple or dataclass."""
    if isinstance(node, torch.Tensor):
        yield path, node
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves_with_path(node[k], f"{path}[{k!r}]")
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            yield from _leaves_with_path(getattr(node, f), f"{path}.{f}")
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            yield from _leaves_with_path(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _leaves_with_path(getattr(node, f.name), f"{path}.{f.name}")


def assert_tree_finite(tree, name: str = "tree"):
    """Raise ValueError naming every non-finite floating leaf of tree."""
    bad = []
    for path, leaf in _leaves_with_path(tree):
        if leaf.is_floating_point():
            n_bad = int((~torch.isfinite(leaf)).sum())
            if n_bad:
                bad.append(f"{path}: {n_bad} non-finite")
    if bad:
        raise ValueError(f"NaN or Inf detected in {name}:\n  " + "\n  ".join(bad))


def checked(fn):
    """fn with its inputs and outputs checked finite, run under anomaly
    mode (a NaN made inside raises where its operation ran)."""

    def wrapper(*args, **kwargs):
        assert_tree_finite((args, kwargs), "step inputs")
        with torch.autograd.detect_anomaly(check_nan=True):
            out = fn(*args, **kwargs)
        assert_tree_finite(out, "step outputs")
        return out

    return wrapper


def tap_check(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Print whether x is finite and its largest magnitude when debugging."""
    if not enabled():
        return x
    print(f"[debug] {name} finite={bool(torch.isfinite(x).all())} "
          f"max|x|={float(x.abs().max()):.3e}")
    return x
