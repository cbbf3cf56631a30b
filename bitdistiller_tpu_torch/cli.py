"""The port's CLI, evaluation subcommands (the JAX package's `cli.py` for
`ppl`, `eval`, `gsm8k`, `humaneval` and `reasoning`: the same flags and the
same printed output):

    python -m bitdistiller_tpu_torch.cli <subcommand> [--device cuda|cpu] ...

Subcommands:
  ppl       — WikiText-2 perplexity eval (`--tokens_file` needs no tokenizer)
  eval      — MMLU/ARC/HellaSwag/PIQA/Winogrande/BoolQ loglikelihood tasks
  gsm8k     — generative GSM8K accuracy
  humaneval — generative HumanEval pass@1
  reasoning — AIME/MATH-500/GPQA-style generative evals

`--device` (default `cuda`) chooses where the model runs; without a card the
default raises. The method-stage subcommands (autoclip, generate, train,
pack, export_gptq, mix_data) and serve, chat and bench are not registered
here (ROADMAP A12, A3, A1).
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_model(path: str, dtype_str: str = "bfloat16", device="cuda"):
    import torch

    from .models.hf_import import load_hf_checkpoint

    dtype = torch.bfloat16 if dtype_str == "bfloat16" else torch.float32
    return load_hf_checkpoint(path, dtype=dtype, device=device)


def _load_tokenizer(path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, use_fast=True)


def _ptq_quantizer(args):
    """PTQ rounding (round half to even) grouped along K of the [K, N]
    weights — the reference eval paths pseudo-quantize with
    pseudo_quantize_tensor, NOT the STE quantizers (wiki_ppl.py:46-137,
    test_utils.py:68-85)."""
    if not args.quant_type:
        return None
    from .quant.core import make_fake_quantizer

    name = args.quant_type if args.quant_type != "int" else f"int{args.w_bit}"
    q = make_fake_quantizer(name, args.q_group_size)
    return lambda w: q(w.T).T


def cmd_ppl(args):
    import numpy as np

    from .eval.ppl import perplexity, prepare_blocks

    params, cfg = _load_model(args.model_path, args.dtype, args.device)
    if args.tokens_file:
        tokens = np.load(args.tokens_file)
    else:
        from .eval.ppl import load_wikitext2_test

        tok = _load_tokenizer(args.model_path)
        tokens = load_wikitext2_test(tok)
    blocks = prepare_blocks(tokens, args.seqlen)
    ppl = perplexity(
        params, cfg, blocks, quantizer=_ptq_quantizer(args), batch_size=args.batch_size,
        progress=lambda d, n: print(f"  {d}/{n}", end="\r", file=sys.stderr),
        device=args.device,
    )
    print(f"\nppl: {ppl:.4f}")


def _engine_for_eval(args):
    from .serve import Engine, SamplingParams

    tok = _load_tokenizer(args.model_path)
    if getattr(args, "load_quant", None):
        from .models.quantized import load_packed_checkpoint

        params, cfg = load_packed_checkpoint(args.load_quant, device=args.device)
    else:
        params, cfg = _load_model(args.model_path, device=args.device)
    eng = Engine(
        params, cfg, max_slots=args.max_batch, max_len=2048,
        sampling=SamplingParams(temperature=args.temperature),
        eos_token_id=tok.eos_token_id,
        decode_horizon=16,
        device=args.device,
    )
    return eng, tok


def cmd_eval(args):
    from .eval.tasks import GEN_TASKS, LogLikelihoodFn, run_tasks

    params, cfg = _load_model(args.model_path, device=args.device)
    tok = _load_tokenizer(args.model_path)
    # PTQ rounding, as in the reference task-eval path (test_utils.py:68-85)
    quantizer = _ptq_quantizer(args)
    tasks = args.tasks.split(",")
    results = {}
    fn = LogLikelihoodFn(params, cfg, tok, quantizer=quantizer,
                         batch_size=args.batch_size, device=args.device)
    if "wikitext" in tasks:
        # wikitext: the word-level lm-eval perplexity task (rolling
        # loglikelihood; tasks/wikitext.py metrics) PLUS the reference's
        # seqlen-2048 block token PPL as `ppl` (wiki_ppl.py:46-137 math)
        tasks.remove("wikitext")
        from .eval.ppl import load_wikitext2_test, perplexity, prepare_blocks

        wt = run_tasks(fn, ["wikitext"], limit=args.limit)["wikitext"]
        blocks = prepare_blocks(load_wikitext2_test(tok), 2048)
        wt["ppl"] = perplexity(params, cfg, blocks, quantizer=quantizer,
                               batch_size=args.batch_size, device=args.device)
        results["wikitext"] = wt
    gen_names = [t for t in tasks if t in GEN_TASKS]
    tasks = [t for t in tasks if t not in GEN_TASKS]
    if tasks:
        results.update(run_tasks(fn, tasks, limit=args.limit,
                                 mmlu_fewshot=args.num_fewshot))
    if gen_names:
        # generative (greedy_until) tasks run through the batching engine
        from .eval.tasks import GreedyUntilFn, run_gen_tasks
        from .serve import Engine, SamplingParams

        eng = Engine(
            params, cfg, max_slots=min(args.batch_size, 8),
            max_len=2048, sampling=SamplingParams(temperature=0.0),
            eos_token_id=getattr(tok, "eos_token_id", None), device=args.device,
        )
        gen_fn = GreedyUntilFn(eng, tok, max_new_tokens=args.max_new_tokens)
        results.update(run_gen_tasks(gen_fn, gen_names, limit=args.limit))
    print(json.dumps(results, indent=2, default=float))


def cmd_gsm8k(args):
    from .eval.gsm8k import load_jsonl, run_gsm8k

    eng, tok = _engine_for_eval(args)
    res = run_gsm8k(eng, tok, load_jsonl(args.data_path),
                    max_new_tokens=args.max_new_tokens, limit=args.limit)
    print(json.dumps({"accuracy": res["accuracy"], "n": res["n"]}))


def cmd_humaneval(args):
    from .eval.humaneval import load_problems, run_humaneval

    eng, tok = _engine_for_eval(args)
    res = run_humaneval(eng, tok, load_problems(args.data_path),
                        max_new_tokens=args.max_new_tokens, limit=args.limit)
    print(json.dumps({"pass@1": res["pass@1"]}))


def cmd_reasoning(args):
    from .eval.reasoning import load_jsonl, run_reasoning

    eng, tok = _engine_for_eval(args)
    res = run_reasoning(eng, tok, load_jsonl(args.data_path), args.task,
                        max_new_tokens=args.max_new_tokens,
                        n_samples=args.n_samples, limit=args.limit)
    print(json.dumps(res))


def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default; raises without a "
                   "card) or cpu (the plain PyTorch path)")


def build_parser():
    p = argparse.ArgumentParser(prog="bitdistiller_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("ppl", help="WikiText-2 perplexity")
    pp.add_argument("--model_path", "--model", dest="model_path", required=True)
    pp.add_argument("--quant_type", choices=["int", "nf3", None], default=None)
    pp.add_argument("--w_bit", "--bits", dest="w_bit", type=int, default=2)
    pp.add_argument("--q_group_size", "--group_size", dest="q_group_size", type=int, default=128)
    pp.add_argument("--seqlen", type=int, default=2048)
    pp.add_argument("--batch_size", type=int, default=1)
    pp.add_argument("--tokens_file", default=None, help="pre-tokenized .npy corpus")
    pp.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="the loaded weights' dtype (the forward computes in the "
                    "config's dtype, as the JAX package's does: ROADMAP C4)")
    _device_flag(pp)
    pp.set_defaults(fn=cmd_ppl)

    ev = sub.add_parser("eval", help="task accuracy eval (mmlu/arc/hellaswag/...)")
    ev.add_argument("--model_path", required=True)
    ev.add_argument("--tasks", default="arc_challenge,winogrande,hellaswag,piqa",
                    help="comma list; 'mmlu' expands to all hendrycksTest subjects")
    ev.add_argument("--quant_type", choices=["int", "nf3", None], default=None)
    ev.add_argument("--w_bit", "--bits", dest="w_bit", type=int, default=2)
    ev.add_argument("--q_group_size", type=int, default=128)
    ev.add_argument("--batch_size", type=int, default=8)
    ev.add_argument("--limit", type=int, default=None)
    ev.add_argument("--num_fewshot", type=int, default=5,
                    help="MMLU few-shot exemplars (llm_eval.py parity)")
    ev.add_argument("--max_new_tokens", type=int, default=256,
                    help="generative (greedy_until) tasks: generation budget")
    _device_flag(ev)
    ev.set_defaults(fn=cmd_eval)

    gs = sub.add_parser("gsm8k", help="GSM8K generative eval")
    gs.add_argument("--model_path", required=True)
    gs.add_argument("--data_path", required=True, help="test_use.jsonl (query/response)")
    gs.add_argument("--load_quant", default=None, help="packed checkpoint (else dense)")
    gs.add_argument("--temperature", type=float, default=0.2)
    gs.add_argument("--max_new_tokens", type=int, default=512)
    gs.add_argument("--max_batch", type=int, default=8)
    gs.add_argument("--limit", type=int, default=None)
    _device_flag(gs)
    gs.set_defaults(fn=cmd_gsm8k)

    he = sub.add_parser("humaneval", help="HumanEval generative eval")
    he.add_argument("--model_path", required=True)
    he.add_argument("--data_path", required=True, help="HumanEval.jsonl")
    he.add_argument("--load_quant", default=None)
    he.add_argument("--temperature", type=float, default=0.2)
    he.add_argument("--max_new_tokens", type=int, default=512)
    he.add_argument("--max_batch", type=int, default=8)
    he.add_argument("--limit", type=int, default=None)
    _device_flag(he)
    he.set_defaults(fn=cmd_humaneval)

    rs = sub.add_parser("reasoning", help="AIME/MATH-500/GPQA-style generative eval")
    rs.add_argument("--model_path", required=True)
    rs.add_argument("--task", choices=["aime", "math500", "gpqa"], required=True)
    rs.add_argument("--data_path", required=True, help="local JSONL (see eval/reasoning.py)")
    rs.add_argument("--load_quant", default=None)
    rs.add_argument("--temperature", type=float, default=0.6)
    rs.add_argument("--max_new_tokens", type=int, default=2048)
    rs.add_argument("--max_batch", type=int, default=8)
    rs.add_argument("--n_samples", type=int, default=1, help="majority-vote ensembling")
    rs.add_argument("--limit", type=int, default=None)
    _device_flag(rs)
    rs.set_defaults(fn=cmd_reasoning)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
