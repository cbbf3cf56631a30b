"""The port's GSM8K, HumanEval and reasoning scoring (`eval/gsm8k.py`,
`eval/humaneval.py`, `eval/reasoning.py`: its own copies) against the JAX
package's functions, case by case, and `run_gsm8k`, `run_humaneval` and
`run_reasoning` on the port's engine against the JAX package's on the same
packed f32 TINY_TEST (greedy: equal results and generations)."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from bitdistiller_tpu.eval import gsm8k as jg
from bitdistiller_tpu.eval import humaneval as jh
from bitdistiller_tpu.eval import reasoning as jr
from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model as jax_pack_model
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu_torch.eval import gsm8k as tg
from bitdistiller_tpu_torch.eval import humaneval as th
from bitdistiller_tpu_torch.eval import reasoning as trs
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.serve import Engine, SamplingParams
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes and loops of small ops: one intra-op thread (the suite
    runs several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TEXTS = ["blah blah #### 42", "The answer is: 3,120.", "so we get 7 apples. The answer is 7",
         "= $18.50 total #### 18.50", "no numbers here", "-5 then #### -1,000", "1. 2. 3.",
         r"so \boxed{42}", r"\boxed{\frac{1}{2}}", r"\boxed{1} then \boxed{2}", r"\boxed{unclosed",
         "The answer is 17.", "... = 3 + 4 = 7", r"thus \boxed{042}", "answer: $12.$",
         "Answer: B", "I think (C) is right", "the answer is d", "A\nB\nfinally D",
         "nothing", "Answer: (a)"]


@pytest.mark.parametrize("text", TEXTS)
def test_extraction_equals_jax(text):
    assert tg.extract_answer(text) == jg.extract_answer(text)
    assert trs.extract_boxed(text) == jr.extract_boxed(text)
    assert trs.extract_math_answer(text) == jr.extract_math_answer(text)
    assert trs.extract_letter(text) == jr.extract_letter(text)
    assert th.postprocess_completion(text) == jh.postprocess_completion(text)


@pytest.mark.parametrize("ans", ["042", "1,000", "$12.$", "12.50", r"\text{cm}5", "x+1", "3.0",
                                 " 7 ", r"1\,000", "-0"])
def test_math_normalization_equals_jax(ans):
    assert trs.normalize_math(ans) == jr.normalize_math(ans)
    for gold in ("42", "1000", 12, "x+1", 7):
        assert trs.math_answers_match(ans, gold) == jr.math_answers_match(ans, gold)


@pytest.mark.parametrize("preds,refs", [
    (["#### 5", "the answer is 3", "#### 9"], ["#### 5", "#### 4", "#### 9.0"]),
    (["nothing"], ["#### 1"]), ([], []), (["#### 1,000"], ["#### 1000"])])
def test_gsm8k_grade_equals_jax(preds, refs):
    assert tg.grade(preds, refs) == jg.grade(preds, refs)


@pytest.mark.parametrize("sets,refs", [
    ([["#### 5"], ["#### 7"], ["#### 5"]], ["#### 5"]),
    ([["none", "#### 2"], ["x", "#### 3"]], ["#### 1", "#### 3"])])
def test_gsm8k_ensemble_equals_jax(sets, refs):
    assert tg.grade_ensemble(sets, refs) == jg.grade_ensemble(sets, refs)


@pytest.mark.parametrize("text", [
    "Sure!\n```python\ndef f():\n    return 1\n```\nHope it helps",
    "def g():\n    return 2\n### Instruction: more", "```\nx = 1\n```", "plain ``` tail"])
def test_humaneval_postprocess_equals_jax(text):
    assert th.postprocess_completion(text) == jh.postprocess_completion(text)


SOLUTIONS = {
    "Mini/0": "def add(a, b):\n    return a + b\n",
    "Mini/1": "def is_even(n):\n    return n % 2 == 0\n",
    "Mini/2": "def reverse_string(s):\n    return s[::-1]\n",
    "Mini/3": "def maximum(xs):\n    return max(xs)\n",
    "Mini/4": "def count_vowels(s):\n    return sum(c in 'aeiou' for c in s)\n",
    "Mini/5": "def factorial(n):\n    return 1 if n < 2 else n * factorial(n - 1)\n",
    "Mini/6": "def fib(n):\n    a, b = 0, 1\n    for _ in range(n):\n        a, b = b, a + b\n"
              "    return a\n",
    "Mini/7": "def unique_sorted(xs):\n    return sorted(set(xs))\n",
}


def test_humaneval_execution_on_the_mini_set_equals_jax():
    """The canonical solutions pass the port's rlimit-guarded runner; a wrong
    body, a body without its signature and an endless loop fail or pass as
    in the JAX package's."""
    problems = th.load_problems(str(FIXTURES / "humaneval_mini.jsonl"))
    assert problems == jh.load_problems(str(FIXTURES / "humaneval_mini.jsonl"))
    comps = [SOLUTIONS[p["task_id"]] for p in problems]
    got = th.evaluate_functional_correctness(problems, comps)
    assert got == jh.evaluate_functional_correctness(problems, comps)
    assert got["pass@1"] == 1.0
    add = problems[0]
    cases = ["def add(a, b):\n    return a - b\n", "    return a + b\n",
             "def add(a, b):\n    while True:\n        pass\n"]
    got = [th.check_correctness(add, c, timeout=2.0) for c in cases]
    assert got == [jh.check_correctness(add, c, timeout=2.0) for c in cases]
    assert got == [False, True, False]


@pytest.fixture(scope="module")
def engines():
    packed = jax_pack_model(init_params(CFG, jax.random.key(0), dtype=jnp.float32), CFG,
                            bits=2, group_size=64)
    jeng = JaxEngine(packed, CFG, max_slots=2, max_len=512, cache_dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0), eos_token_id=None)
    teng = Engine(params_from_numpy(to_numpy_tree(packed), "cpu"), torch_cfg(CFG), max_slots=2,
                  max_len=512, cache_dtype=torch.float32, sampling=SamplingParams(temperature=0.0),
                  eos_token_id=None, device="cpu")
    return jeng, teng


class CharTok:
    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


def test_run_gsm8k_equals_jax(engines):
    jeng, teng = engines
    data = [json.loads(x) for x in open(FIXTURES / "gsm8k_test200.jsonl")][:3]
    got = tg.run_gsm8k(teng, CharTok(), data, max_new_tokens=6, limit=2)
    want = jg.run_gsm8k(jeng, CharTok(), data, max_new_tokens=6, limit=2)
    assert got == want and got["n"] == 2 and len(got["generations"]) == 2


def test_run_humaneval_equals_jax(engines):
    jeng, teng = engines
    problems = th.load_problems(str(FIXTURES / "humaneval_mini.jsonl"))
    got = th.run_humaneval(teng, CharTok(), problems, max_new_tokens=5, limit=2)
    want = jh.run_humaneval(jeng, CharTok(), problems, max_new_tokens=5, limit=2)
    assert got == want and len(got["results"]) == 2


@pytest.mark.parametrize("task", ["math500", "gpqa"])
def test_run_reasoning_equals_jax(engines, task):
    jeng, teng = engines
    if task == "gpqa":
        docs = [{"question": "Pick one", "choices": ["w", "x", "y", "z"], "answer": 2},
                {"question": "Again", "choices": ["a", "b", "c", "d"], "answer": "A"}]
    else:
        docs = [{"problem": "1+1?", "answer": "2"}, {"problem": "2*3?", "answer": 6}]
    got = trs.run_reasoning(teng, CharTok(), docs, task, max_new_tokens=4, n_samples=2)
    want = jr.run_reasoning(jeng, CharTok(), docs, task, max_new_tokens=4, n_samples=2)
    assert got == want and got["n"] == 2 and got["n_samples"] == 2
    with pytest.raises(ValueError, match="unknown reasoning task"):
        trs.run_reasoning(teng, CharTok(), docs, "chess")
