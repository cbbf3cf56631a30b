"""GSM8K generative evaluation (a copy of the JAX package's `eval/gsm8k.py`;
`run_gsm8k` takes the port's `Engine`): batched generation + regex answer extraction
with optional majority-voting ensemble.

Parity with test/gsm8k/{test.py,eval.py}: prompts use the instruction
template (test.py:60-67 style), generation at T=0.2 (test.sh), answers
extracted from '#### n' or 'The answer is: n' patterns (eval.py:7-60),
accuracy plus a majority-vote ensemble over multiple generation files
(eval.py:131-186).
"""

from __future__ import annotations

import collections
import json
import re
from typing import Iterable, Optional

PROMPT = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{query}\n\n### Response: Let's think step by step."
)

_NUM = r"-?[\d,]*\.?\d+"


def extract_answer(text: str) -> Optional[str]:
    """Last '#### x' marker, else last 'answer is x', else last number."""
    m = re.findall(r"####\s*(" + _NUM + ")", text)
    if not m:
        m = re.findall(r"[Tt]he answer is:?\s*\$?(" + _NUM + ")", text)
    if not m:
        m = re.findall(_NUM, text)
    if not m:
        return None
    return m[-1].replace(",", "").rstrip(".")


def _norm(x: Optional[str]) -> Optional[str]:
    if x is None:
        return None
    try:
        f = float(x)
        return str(int(f)) if f == int(f) else str(f)
    except ValueError:
        return x


def grade(predictions: Iterable[str], references: Iterable[str]) -> dict:
    """Accuracy of extracted answers vs gold ('#### n' in reference)."""
    correct = total = 0
    for pred, ref in zip(predictions, references):
        total += 1
        if _norm(extract_answer(pred)) == _norm(extract_answer(ref)):
            correct += 1
    return {"accuracy": correct / max(total, 1), "n": total}


def grade_ensemble(prediction_sets: list, references: list) -> dict:
    """Majority vote across k generations per question (eval.py:131-186)."""
    correct = total = 0
    for preds, ref in zip(zip(*prediction_sets), references):
        total += 1
        votes = [_norm(extract_answer(p)) for p in preds]
        votes = [v for v in votes if v is not None]
        if not votes:
            continue
        top = collections.Counter(votes).most_common(1)[0][0]
        if top == _norm(extract_answer(ref)):
            correct += 1
    return {"accuracy": correct / max(total, 1), "n": total}


def load_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def run_gsm8k(engine, tokenizer, dataset: list, *, max_new_tokens: int = 512,
              limit: Optional[int] = None) -> dict:
    """dataset: list of {'query': ..., 'response': ...} dicts (train_use.jsonl
    format). Returns accuracy + raw generations."""
    if limit:
        dataset = dataset[:limit]
    prompts = [PROMPT.format(query=d["query"]) for d in dataset]
    token_prompts = [tokenizer.encode(p) for p in prompts]
    outs = engine.generate(token_prompts, max_new_tokens=max_new_tokens)
    texts = [tokenizer.decode(o, skip_special_tokens=True) for o in outs]
    refs = [d["response"] for d in dataset]
    result = grade(texts, refs)
    result["generations"] = texts
    return result
