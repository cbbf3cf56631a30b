"""WikiText-2-style perplexity (PyTorch port of the JAX package's
`eval/ppl.py`).

Reference parity (test/general/wiki_ppl.py:46-137): concatenated test text is
split into non-overlapping seqlen-2048 blocks; per block, shift-NLL of
logits[:-1] vs tokens[1:] averaged over the S - 1 predicted tokens, then
scaled by S (the reference's quirk, kept); ppl = exp(sum(nll) / (nsamples *
seqlen)).

One forward a batch of blocks through the port's `forward` (packed trees
through the prefill kernels on the card); the f32 log-softmax is taken one
block of the batch at a time, so a batch holds one [S, V] copy beside its
logits, not a second [B, S, V].
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..quant.packing import PackedLinear


def prepare_blocks(token_ids: np.ndarray, seqlen: int = 2048) -> np.ndarray:
    """Flat token array -> [nsamples, seqlen] non-overlapping blocks."""
    flat = np.asarray(token_ids).reshape(-1)
    nsamples = len(flat) // seqlen
    return flat[: nsamples * seqlen].reshape(nsamples, seqlen).astype(np.int32)


def target_logprobs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log_softmax(logits, -1) at `targets`, in f32: [B, S, V], [B, S] -> [B, S].
    Row by row of the batch: the values of the whole-batch log-softmax, with
    one row's [S, V] copy live at a time."""
    out = torch.empty(targets.shape, dtype=torch.float32, device=logits.device)
    for b in range(logits.shape[0]):
        logp = torch.log_softmax(logits[b].to(torch.float32), dim=-1)
        out[b] = logp.gather(-1, targets[b, :, None].to(torch.int64))[:, 0]
        del logp
    return out


def make_nll_fn(cfg: ModelConfig, quantizer=None, *, use_kernels: bool = True) -> Callable:
    """fn(params, tokens [B, S]) -> summed shift-NLL a block [B] (f32).
    `use_kernels=False` runs the packed matmuls' plain versions on any device
    (the reference run on the card)."""

    @torch.no_grad()
    def nll(params, tokens):
        logits, _ = llama.forward(params, cfg, tokens, quantizer=quantizer,
                                  logits_dtype=torch.float32, use_kernels=use_kernels)
        tok_nll = -target_logprobs(logits[:, :-1], tokens[:, 1:])
        del logits
        # reference: mean CE over (seqlen-1) tokens, then * seqlen (wiki_ppl.py:129-130)
        return tok_nll.mean(dim=-1) * tokens.shape[1]

    return nll


def tree_tensors(tree):
    """Every tensor of a param tree (nested dicts, PackedLinear leaves)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, PackedLinear):
        for t in (tree.qweight, tree.scales, tree.szeros, tree.bias, tree.combo):
            if t is not None:
                yield t
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)


def check_params_device(params, device: torch.device) -> None:
    """Raise unless every leaf of `params` lies on `device`: the eval entry
    points never move a model."""
    for t in tree_tensors(params):
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"a param leaf lies on {t.device}, the eval runs on {device}; "
                             "move the model first")


def perplexity(
    params,
    cfg: ModelConfig,
    blocks: np.ndarray,  # [nsamples, seqlen]
    *,
    quantizer=None,
    batch_size: int = 1,
    progress: Optional[Callable[[int, int], None]] = None,
    device="cuda",
) -> float:
    dev = resolve_device(device)
    check_params_device(params, dev)
    nll_fn = make_nll_fn(cfg, quantizer)
    blocks = np.asarray(blocks)
    nsamples, seqlen = blocks.shape
    total = 0.0
    done = 0

    def run(batch):
        tokens = torch.as_tensor(batch, dtype=torch.int64, device=dev)
        return float(nll_fn(params, tokens).sum())

    for i in range(0, nsamples - nsamples % batch_size, batch_size):
        total += run(blocks[i : i + batch_size])
        done += batch_size
        if progress:
            progress(done, nsamples)
    rem = nsamples % batch_size
    if rem:
        total += run(blocks[nsamples - rem :])
        done += rem
        if progress:
            progress(done, nsamples)
    return math.exp(total / (done * seqlen))


def load_wikitext2_test(tokenizer, split: str = "test") -> np.ndarray:
    """Tokenize the wikitext-2-raw corpus joined with \\n\\n (wiki_ppl.py:28-29).

    Reads the hub dataset, or its fixture under BITDISTILLER_DATA_DIR
    (`data/offline.py`); offline callers may pass pre-tokenized blocks to
    `perplexity` directly.
    """
    from ..data.offline import load_dataset

    data = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
    text = "\n\n".join(data["text"])
    return np.asarray(tokenizer(text).input_ids, dtype=np.int32)
