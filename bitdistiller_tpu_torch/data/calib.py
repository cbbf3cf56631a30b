"""Calibration token blocks for AutoClip (a copy of the JAX package's
`data/calib.py`: pure Python and numpy, so both packages cut the same
blocks from the same text).

Each loader tokenizes samples, keeps those of 1 to 512 tokens, concatenates
them and splits the stream into `block_size` blocks. The hub sources
(`pile`, `code`, `nemotron_code`, `nemotron_math`, `epicoder`) need a
download, or fixtures under `BITDISTILLER_DATA_DIR` (`data/offline.py`);
`json` reads teacher-format JSONL ([[prompt, reply]]), `gsm8k`
query/response JSONL and `text` a plain text file, so the pipeline runs
offline.
"""

from __future__ import annotations

import json
import random
from typing import Callable

import numpy as np


def _blocks_from_lines(lines, tokenizer, n_samples: int, block_size: int,
                       max_tokens: int = 512):
    samples = []
    n_run = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        enc = tokenizer.encode(line)
        if len(enc) > max_tokens or len(enc) == 0:
            continue
        samples.append(enc)
        n_run += 1
        if n_run == n_samples:
            break
    if not samples:
        raise ValueError("no calibration samples <= 512 tokens found")
    cat = np.concatenate([np.asarray(s, np.int32) for s in samples])
    n_split = len(cat) // block_size
    if n_split == 0:
        raise ValueError(
            f"calibration corpus too small: {len(cat)} tokens < block {block_size}"
        )
    return [cat[i * block_size : (i + 1) * block_size][None, :] for i in range(n_split)]


def _hf_pile(tokenizer, n_samples, block_size):
    from .offline import load_dataset

    ds = load_dataset("mit-han-lab/pile-val-backup", split="validation")
    ds = ds.shuffle(seed=42)
    return _blocks_from_lines((d["text"] for d in ds), tokenizer, n_samples, block_size)


def _hf_code(tokenizer, n_samples, block_size):
    from .offline import load_dataset

    ds = load_dataset("nickrosh/Evol-Instruct-Code-80k-v1", split="train").shuffle(seed=42)
    lines = (f"Instruction:\n{d['instruction']}\nOutput:\n{d['output']}" for d in ds)
    return _blocks_from_lines(lines, tokenizer, n_samples, block_size)


def _hf_nemotron(split):
    def load(tokenizer, n_samples, block_size):
        from .offline import load_dataset

        ds = load_dataset("nvidia/Llama-Nemotron-Post-Training-Dataset", "SFT", split=split)
        lines = (f"{d['input'][0]['content']}\n\n{d['output']}" for d in ds)
        return _blocks_from_lines(lines, tokenizer, n_samples, block_size)

    return load


def _hf_epicoder(tokenizer, n_samples, block_size):
    from .offline import load_dataset

    ds = load_dataset("microsoft/EpiCoder-func-380k", split="train")
    lines = (f"{d['instruction']}\n\n<think></think>\n{d['output']}" for d in ds)
    return _blocks_from_lines(lines, tokenizer, n_samples, block_size)


def _local_json(tokenizer, n_samples, block_size, data_path):
    """Teacher-format JSONL: each line [[prompt, reply]]."""
    with open(data_path) as f:
        raw = f.readlines()
    lines = []
    for item in raw:
        item = item.strip()
        if not item:
            continue
        obj = json.loads(item)
        lines.append(f"{obj[0][0]}\n\n{obj[0][1]}")
    return _blocks_from_lines(lines, tokenizer, n_samples, block_size)


def _local_gsm8k_style(tokenizer, n_samples, block_size, data_path):
    """query/response JSONL, sampled with random.seed(42) as the JAX package."""
    with open(data_path) as f:
        dataset = [json.loads(x) for x in f if x.strip()]
    random.seed(42)
    dataset = random.sample(dataset, k=min(n_samples * 10, len(dataset)))
    lines = (f"Instruction:\n{d['query']}\nOutput:\n{d['response']}" for d in dataset)
    return _blocks_from_lines(lines, tokenizer, n_samples, block_size)


def _local_text(tokenizer, n_samples, block_size, data_path):
    with open(data_path) as f:
        text = f.read()
    enc = np.asarray(tokenizer.encode(text), np.int32)
    n_split = min(len(enc) // block_size, n_samples)
    return [enc[i * block_size : (i + 1) * block_size][None, :] for i in range(n_split)]


def get_calib_dataset(
    name: str,
    tokenizer,
    n_samples: int = 128,
    block_size: int = 1024,
    data_path: str | None = None,
) -> list[np.ndarray]:
    """Return a list of [1, block_size] int32 token blocks."""
    hub: dict[str, Callable] = {
        "pile": _hf_pile,
        "code": _hf_code,
        "nemotron_code": _hf_nemotron("code"),
        "nemotron_math": _hf_nemotron("math"),
        "epicoder": _hf_epicoder,
    }
    local = {
        "json": _local_json,
        "openr1_math": _local_json,
        "merged_gmc": _local_json,
        "gsm8k": _local_gsm8k_style,
        "text": _local_text,
    }
    if name in hub:
        return hub[name](tokenizer, n_samples, block_size)
    if name in local:
        if data_path is None:
            raise ValueError(f"calib dataset {name!r} needs --calib_path")
        return local[name](tokenizer, n_samples, block_size, data_path)
    raise ValueError(f"unknown calib dataset {name!r}")
