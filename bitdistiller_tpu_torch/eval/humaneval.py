"""HumanEval generative evaluation (a copy of the JAX package's
`eval/humaneval.py`; `run_humaneval` takes the port's `Engine`): code generation + functional-correctness
execution.

Parity with test/humaneval/{humaneval_gen.py,process_humaneval.py,eval.sh}:
completion post-processing strips markdown code fences and trailing prose
(process_humaneval.py:1-72 behavior), correctness runs each problem's
`check(candidate)` suite in a subprocess with a timeout (the human_eval
package's evaluate_functional_correctness role, without requiring it).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from typing import Optional

PROMPT = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\nCreate a Python script for this problem:\n{prompt}\n\n"
    "### Response:"
)


def postprocess_completion(text: str) -> str:
    """Extract the code body: prefer ```python fenced block, else raw text up
    to a dangling section marker."""
    m = re.search(r"```(?:python)?\n(.*?)```", text, re.DOTALL)
    if m:
        return m.group(1)
    for stop in ("### Instruction", "### Response", "```"):
        idx = text.find(stop)
        if idx != -1:
            text = text[:idx]
    return text


# Resource guard prepended to every candidate program: caps CPU time,
# address space, file size and subprocesses, and runs from an empty temp cwd.
# The reference routes through the human_eval package's guarded runner
# (test/humaneval/eval.sh); model-generated code must not be able to fork-
# bomb, fill the disk, or chew unbounded memory on the eval host.
_GUARD = """\
import resource as _r, os as _os, tempfile as _t
_r.setrlimit(_r.RLIMIT_CPU, ({cpu}, {cpu}))
_r.setrlimit(_r.RLIMIT_AS, ({mem}, {mem}))
_r.setrlimit(_r.RLIMIT_FSIZE, (1 << 20, 1 << 20))
try:
    _r.setrlimit(_r.RLIMIT_NPROC, (16, 16))
except (ValueError, OSError):
    pass
_os.chdir(_t.mkdtemp(prefix="humaneval_"))
"""


def check_correctness(problem: dict, completion: str, timeout: float = 10.0) -> bool:
    """Run the problem's test suite against the completion in a subprocess
    under rlimits (CPU = timeout, 2 GiB address space, 1 MiB file writes)."""
    guard = _GUARD.format(cpu=int(timeout), mem=2 << 30)
    program = "\n".join(
        [
            guard,
            problem.get("prompt", "") if _needs_prompt(completion, problem) else "",
            completion,
            problem["test"],
            f"check({problem['entry_point']})",
        ]
    )
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(program)
        path = f.name
    try:
        proc = subprocess.run(
            [sys.executable, path], capture_output=True, timeout=timeout,
            stdin=subprocess.DEVNULL,
        )
        return proc.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def _needs_prompt(completion: str, problem: dict) -> bool:
    # generated code may already restate the function signature
    entry = problem["entry_point"]
    return f"def {entry}" not in completion


def evaluate_functional_correctness(problems: list, completions: list,
                                    timeout: float = 10.0) -> dict:
    results = [
        check_correctness(p, postprocess_completion(c), timeout)
        for p, c in zip(problems, completions)
    ]
    return {"pass@1": sum(results) / max(len(results), 1), "results": results}


def load_problems(path: str) -> list:
    """HumanEval.jsonl format (task_id, prompt, test, entry_point)."""
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def run_humaneval(engine, tokenizer, problems: list, *, max_new_tokens: int = 512,
                  limit: Optional[int] = None) -> dict:
    if limit:
        problems = problems[:limit]
    prompts = [PROMPT.format(prompt=p["prompt"]) for p in problems]
    outs = engine.generate([tokenizer.encode(p) for p in prompts],
                           max_new_tokens=max_new_tokens)
    texts = [tokenizer.decode(o, skip_special_tokens=True) for o in outs]
    result = evaluate_functional_correctness(problems, texts)
    result["generations"] = texts
    return result
