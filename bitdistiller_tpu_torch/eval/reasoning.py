"""Reasoning evals (a copy of the JAX package's `eval/reasoning.py`;
`run_reasoning` takes the port's `Engine`): AIME / MATH-500 style (boxed numeric answers) and GPQA
style (four-choice letter answers), over local JSONL data.

The reference fork runs these through lighteval + a sed-patched vLLM on its
cluster (scripts/sing/generate_sing_yaml.py:92-107 — tasks aime24,
gpqa:diamond, math_500; scripts/code_modify/modify_for_openr1_test_*.sh).
This is the same capability as a local harness: generate with the serving
engine, extract answers with lighteval-compatible rules (last \\boxed{...}
with brace matching, "answer is" fallback, final-number fallback; final
A-D letter for GPQA), exact-match after normalization, optional
majority-vote ensembling (the gsm8k eval's voting, eval.py:131-186).

Data formats (one JSON object per line):
  aime/math: {"problem": str, "answer": str|number}
  gpqa:      {"question": str, "choices": [str x4], "answer": "A".."D"|0..3}
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Optional

MATH_PROMPT = (
    "Solve the following problem. Put your final answer within \\boxed{{}}.\n\n"
    "{problem}\n\n"
)

GPQA_PROMPT = (
    "Answer the following multiple choice question. The last line of your "
    "response should be of the form 'Answer: X' where X is one of ABCD.\n\n"
    "{question}\n\nA) {a}\nB) {b}\nC) {c}\nD) {d}\n\n"
)


def extract_boxed(text: str) -> Optional[str]:
    """Content of the LAST \\boxed{...}, with brace matching."""
    idx = text.rfind("\\boxed")
    if idx == -1:
        return None
    i = text.find("{", idx)
    if i == -1:
        return None
    depth, start = 0, i + 1
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return text[start:j]
    return None


_ANSWER_IS = re.compile(r"answer\s*(?:is|:)\s*\$?([^\n.,$]+)", re.IGNORECASE)
_LAST_NUMBER = re.compile(r"-?\d[\d,]*(?:\.\d+)?")


def extract_math_answer(text: str) -> Optional[str]:
    boxed = extract_boxed(text)
    if boxed is not None:
        return boxed.strip()
    m = list(_ANSWER_IS.finditer(text))
    if m:
        return m[-1].group(1).strip()
    nums = _LAST_NUMBER.findall(text)
    return nums[-1] if nums else None


def normalize_math(ans: str) -> str:
    a = str(ans).strip().strip("$").strip()
    a = a.replace("\\!", "").replace("\\,", "").replace(" ", "").replace(",", "")
    a = re.sub(r"\\text\{[^}]*\}", "", a)
    a = a.rstrip(".")
    try:  # numeric canonicalization: 042 == 42 == 42.0
        f = float(a)
        return str(int(f)) if f == int(f) else repr(f)
    except ValueError:
        return a


def math_answers_match(pred: Optional[str], gold) -> bool:
    if pred is None:
        return False
    return normalize_math(pred) == normalize_math(str(gold))


_LETTER = re.compile(r"(?:answer\s*(?:is|:)?\s*\(?|^\(?)([ABCD])\)?\b",
                     re.IGNORECASE | re.MULTILINE)


def extract_letter(text: str) -> Optional[str]:
    m = list(_LETTER.finditer(text))
    if m:
        return m[-1].group(1).upper()
    # bare final letter on its own
    tail = text.strip()[-8:]
    m2 = re.findall(r"\b([ABCD])\b", tail)
    return m2[-1].upper() if m2 else None


def load_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _vote(answers: list) -> Optional[str]:
    answers = [a for a in answers if a is not None]
    if not answers:
        return None
    return Counter(answers).most_common(1)[0][0]


def run_reasoning(
    engine,
    tokenizer,
    docs: list,
    task: str,  # "aime" | "math500" | "gpqa"
    *,
    max_new_tokens: int = 2048,
    n_samples: int = 1,
    limit: Optional[int] = None,
) -> dict:
    if limit:
        docs = docs[:limit]
    if task in ("aime", "math500", "math"):
        prompts = [MATH_PROMPT.format(problem=d["problem"]) for d in docs]
        extract, match = extract_math_answer, math_answers_match
        golds = [d["answer"] for d in docs]
    elif task == "gpqa":
        prompts = [
            GPQA_PROMPT.format(question=d["question"], a=d["choices"][0],
                               b=d["choices"][1], c=d["choices"][2], d=d["choices"][3])
            for d in docs
        ]
        extract = extract_letter
        match = lambda p, g: p is not None and p == g
        golds = [
            g if isinstance(g, str) else "ABCD"[int(g)]
            for g in (d["answer"] for d in docs)
        ]
    else:
        raise ValueError(f"unknown reasoning task {task!r}")

    encoded = [tokenizer.encode(p) for p in prompts]
    per_doc_answers: list[list] = [[] for _ in docs]
    for _ in range(n_samples):
        outs = engine.generate(encoded, max_new_tokens=max_new_tokens)
        for i, o in enumerate(outs):
            text = tokenizer.decode(o, skip_special_tokens=True)
            per_doc_answers[i].append(extract(text))

    correct = sum(
        int(match(_vote(answers), gold))
        for answers, gold in zip(per_doc_answers, golds)
    )
    return {
        "task": task,
        "accuracy": correct / max(len(docs), 1),
        "n": len(docs),
        "n_samples": n_samples,
    }
