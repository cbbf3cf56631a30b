"""Evaluation suite of the port: WikiText-2 perplexity, the loglikelihood and
generative task harness, GSM8K, HumanEval and the reasoning evals (the JAX
package's `eval` package, over the port's `forward` and `Engine`)."""
from .gsm8k import extract_answer, grade, grade_ensemble, run_gsm8k
from .humaneval import (
    evaluate_functional_correctness,
    postprocess_completion,
    run_humaneval,
)
from .ppl import load_wikitext2_test, make_nll_fn, perplexity, prepare_blocks
from .reasoning import run_reasoning
from .tasks import (
    GEN_TASKS,
    MMLU_SUBJECTS,
    TASK_REGISTRY,
    GenDoc,
    GreedyUntilFn,
    LogLikelihoodFn,
    MCDoc,
    evaluate_gen_task,
    evaluate_perplexity_task,
    evaluate_task,
    run_gen_tasks,
    run_tasks,
    trim_at_stops,
    wikitext_detokenizer,
)

__all__ = [
    "extract_answer",
    "grade",
    "grade_ensemble",
    "run_gsm8k",
    "evaluate_functional_correctness",
    "postprocess_completion",
    "run_humaneval",
    "load_wikitext2_test",
    "make_nll_fn",
    "perplexity",
    "prepare_blocks",
    "MMLU_SUBJECTS",
    "TASK_REGISTRY",
    "GenDoc",
    "GreedyUntilFn",
    "LogLikelihoodFn",
    "MCDoc",
    "evaluate_gen_task",
    "evaluate_perplexity_task",
    "evaluate_task",
    "GEN_TASKS",
    "run_gen_tasks",
    "run_tasks",
    "trim_at_stops",
    "wikitext_detokenizer",
    "run_reasoning",
]
