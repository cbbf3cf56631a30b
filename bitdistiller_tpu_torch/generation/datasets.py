"""Prompt sources for teacher self-generation (a copy of the JAX package's
`generation/datasets.py`: pure Python, the same templates, sampling and
files).

Named prompt templates, and dataset getters that return a list of prompt
strings. The hub sources need a download, or fixtures under
`BITDISTILLER_DATA_DIR` (`data/offline.py`); `json`/`jsonl` read a local
file, so generation runs offline. As the JAX package, `wikitext` loads the
hub path with no config name (ROADMAP C4): its fixture is
`wikitext__default__train.jsonl`, not `wikitext-2-raw-v1`'s.
"""

from __future__ import annotations

import json
import random

WIKITEXT_MIN_CHARS = 128

PROMPT_STYLES = {
    "none": "{instruction}",
    "alpaca": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Response:"
    ),
    "solar": "### User:\n{instruction}\n\n### Assistant:\n",
    "code": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\nCreate a Python script for this problem:\n"
        "{instruction}\n\n### Response:"
    ),
    "math": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Response: Let's think step by step."
    ),
}


def _hub(name, split="train"):
    from ..data.offline import load_dataset

    return load_dataset(name, split=split)


def get_gen_prompts(
    dataset_name: str,
    max_sample: int = 5000,
    seed: int = 42,
    data_path: str | None = None,
) -> list[str]:
    """Return raw prompt strings (pre-template)."""
    rng = random.Random(seed)
    if dataset_name in ("json", "jsonl"):
        if data_path is None:
            raise ValueError("local dataset needs data_path")
        with open(data_path) as f:
            items = [json.loads(x) for x in f if x.strip()]
        prompts = []
        for it in items:
            if isinstance(it, str):
                prompts.append(it)
            elif isinstance(it, dict):
                prompts.append(it.get("instruction") or it.get("query") or it.get("prompt"))
            elif isinstance(it, list):  # teacher format [[p, r]]
                prompts.append(it[0][0])
    elif dataset_name == "wikitext":
        ds = _hub("wikitext", "train")  # no config name, as the JAX package (C4)
        prompts = [t[:WIKITEXT_MIN_CHARS] for t in ds["text"] if len(t) > WIKITEXT_MIN_CHARS]
    elif dataset_name == "alpaca":
        ds = _hub("tatsu-lab/alpaca")
        prompts = [d["instruction"] for d in ds if not d["input"]]
    elif dataset_name == "openorca":
        ds = _hub("Open-Orca/OpenOrca")
        prompts = [d["question"] for d in ds]
    elif dataset_name == "code":
        ds = _hub("nickrosh/Evol-Instruct-Code-80k-v1")
        prompts = [d["instruction"] for d in ds]
    elif dataset_name == "math":
        ds = _hub("meta-math/MetaMathQA")
        prompts = [d["query"] for d in ds]
    else:
        raise ValueError(f"unknown gen dataset {dataset_name!r}")
    prompts = [p for p in prompts if p]
    if len(prompts) > max_sample:
        prompts = rng.sample(prompts, max_sample)
    return prompts


def style_for_dataset(dataset_name: str) -> str:
    return {
        "alpaca": "alpaca",
        "openorca": "solar",
        "code": "code",
        "math": "math",
    }.get(dataset_name, "none")


def mix_data(path_a: str, path_b: str, out_path: str, seed: int = 42) -> int:
    """Concatenate and shuffle two teacher JSONL sets."""
    lines = []
    for p in (path_a, path_b):
        with open(p) as f:
            lines += [x for x in f if x.strip()]
    random.Random(seed).shuffle(lines)
    with open(out_path, "w") as f:
        f.writelines(x if x.endswith("\n") else x + "\n" for x in lines)
    return len(lines)


def merge_interleaved(paths: list, out_path: str) -> int:
    """Ratio-preserving interleaved merge of N teacher JSONL sets: each
    source's lines spread evenly through the output, not shuffled."""
    sources = []
    for p in paths:
        with open(p) as f:
            sources.append([x for x in f if x.strip()])
    total = sum(len(s) for s in sources)
    # each source at evenly spaced fractional positions
    tagged = []
    for si, src in enumerate(sources):
        n = len(src)
        for i, line in enumerate(src):
            tagged.append(((i + 0.5) / n, si, line))
    tagged.sort(key=lambda t: (t[0], t[1]))
    with open(out_path, "w") as f:
        for _, _, line in tagged:
            f.write(line if line.endswith("\n") else line + "\n")
    return total
