"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry points run on the card by default. A CUDA device with no
    card present is an error, not a silent move to the CPU: the caller
    must ask for `device="cpu"` explicitly (the CPU tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def on_card(t: torch.Tensor) -> bool:
    """True for a tensor on the card: the one test by which every kernel
    wrapper chooses its kernel (a CUDA tensor) over its plain version (a CPU
    tensor)."""
    return t.is_cuda


_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    """`ModelConfig.dtype` string -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
