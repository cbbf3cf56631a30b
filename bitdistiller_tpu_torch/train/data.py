"""Teacher-data pipeline: JSONL of [[prompt, completion]] pairs -> padded
token batches (a restatement of the JAX package's `train/data.py`; pure
Python and numpy, so both packages see the same split, batch order and
arrays).

Each line is [[source, target]]; example = source + target + eos; labels
are a copy of input_ids; the first min(len // 10, 10) samples form the eval
split; padding uses the pad token for inputs and IGNORE_INDEX (-100) for
labels; attention_mask = 1 on real tokens. Batches pad to a bucket length
(powers of two from 64 up to model_max_length).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from .losses import IGNORE_INDEX


def load_teacher_jsonl(path: str) -> list[tuple[str, str]]:
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            pairs.append((item[0][0], item[0][1]))
    return pairs


@dataclass
class SupervisedDataset:
    sources: list[str]
    targets: list[str]

    @staticmethod
    def from_jsonl(path: str, eos_token: str, max_sample: Optional[int] = None,
                   split: str = "train", seed: int = 42) -> "SupervisedDataset":
        pairs = load_teacher_jsonl(path)
        sources = [p[0] for p in pairs]
        targets = [f"{p[1]}{eos_token}" for p in pairs]
        n = len(sources)
        max_sample = min(max_sample or n, n)
        if max_sample < n:
            idx = random.Random(seed).sample(range(n), max_sample)
            sources = [sources[i] for i in idx]
            targets = [targets[i] for i in idx]
        split_num = min(len(sources) // 10, 10)
        if split == "train":
            return SupervisedDataset(sources[split_num:], targets[split_num:])
        return SupervisedDataset(sources[:split_num], targets[:split_num])

    def __len__(self):
        return len(self.sources)


def _bucket_len(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Collator:
    """Tokenize source + target, pad to a length bucket, emit a numpy batch."""

    def __init__(self, tokenizer, model_max_length: int = 2048, pad_to_buckets: bool = True):
        self.tok = tokenizer
        self.max_len = model_max_length
        if pad_to_buckets:
            b, buckets = 64, []
            while b < model_max_length:
                buckets.append(b)
                b *= 2
            buckets.append(model_max_length)
            self.buckets = buckets
        else:
            self.buckets = [model_max_length]
        self.pad_id = tokenizer.pad_token_id
        if self.pad_id is None:
            self.pad_id = tokenizer.eos_token_id

    def __call__(self, sources: Sequence[str], targets: Sequence[str]) -> dict:
        ids = [self.tok.encode(s + t)[: self.max_len] for s, t in zip(sources, targets)]
        pad_len = _bucket_len(max(len(i) for i in ids), self.buckets)
        batch = len(ids)
        input_ids = np.full((batch, pad_len), self.pad_id, np.int32)
        labels = np.full((batch, pad_len), IGNORE_INDEX, np.int32)
        attention_mask = np.zeros((batch, pad_len), np.int32)
        for i, seq in enumerate(ids):
            input_ids[i, : len(seq)] = seq
            labels[i, : len(seq)] = seq
            attention_mask[i, : len(seq)] = 1
        return {"input_ids": input_ids, "labels": labels, "attention_mask": attention_mask}


def data_loader(ds: SupervisedDataset, collator: Collator, batch_size: int, *,
                shuffle: bool = True, seed: int = 0, drop_last: bool = True) -> Iterator[dict]:
    idx = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    for i in range(0, end, batch_size):
        chunk = idx[i : i + batch_size]
        yield collator([ds.sources[j] for j in chunk], [ds.targets[j] for j in chunk])
