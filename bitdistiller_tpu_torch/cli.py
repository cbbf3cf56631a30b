"""The port's CLI (the JAX package's `cli.py` for the subcommands below:
the same flags and the same printed output, plus `--device`):

    python -m bitdistiller_tpu_torch.cli <subcommand> [--device cuda|cpu] ...

Subcommands:
  autoclip  — stage 1: clip-range search, saves a .npz clip cache
  generate  — stage 2: teacher self-generation to JSONL
  train     — stage 3: CAKLD KD-QAT (one process, or several with ZeRO 0/2/3)
  export_gptq — export to the GPTQ packed format
  mix_data  — merge+shuffle teacher JSONL sets
  ppl       — WikiText-2 perplexity eval (`--tokens_file` needs no tokenizer)
  pack      — quantize + pack a checkpoint for serving
  chat      — interactive packed-model chat
  serve     — JSON-over-HTTP online serving (continuous batching)
  eval      — MMLU/ARC/HellaSwag/PIQA/Winogrande/BoolQ loglikelihood tasks
  gsm8k     — generative GSM8K accuracy
  humaneval — generative HumanEval pass@1
  reasoning — AIME/MATH-500/GPQA-style generative evals

`--device` (default `cuda`) chooses where the model runs; without a card the
default raises. The tokenizer comes from the checkpoint through
`transformers` (except `ppl --tokens_file`, `pack`, `export_gptq` and
`mix_data`), by `_load_tokenizer`, the one place it is loaded. A run over
several processes passes `--coordinator_address host:port --num_processes
N --process_id R` to each (`train`, `generate`), or runs under torchrun,
whose variables are read when those flags are absent. `bench` is not
registered: it waits for the port's benchmark (ROADMAP A1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


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


def cmd_autoclip(args):
    import numpy as np

    from .data.calib import get_calib_dataset
    from .quant.autoclip import run_autoclip, save_clip_cache

    params, cfg = _load_model(args.model_path, device=args.device)
    tok = _load_tokenizer(args.model_path)
    blocks = get_calib_dataset(
        args.calib_dataset, tok, n_samples=args.n_samples, block_size=args.seqlen,
        data_path=args.calib_path,
    )
    result = run_autoclip(
        params, cfg, np.concatenate(blocks, axis=0), quant_type=args.quant_type,
        n_bit=args.w_bit, group_size=args.q_group_size,
        progress=lambda s: print(f"  autoclip {s}", file=sys.stderr),
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.dump_clip)), exist_ok=True)
    save_clip_cache(args.dump_clip, result["clip"])
    print(f"clip cache saved to {args.dump_clip}")


def cmd_train(args):
    """Returns run_training's summary (the process's exit ignores it)."""
    from .train.pipeline import run_training

    tok = _load_tokenizer(args.model_name_or_path)
    if getattr(tok, "pad_token", None) is None:
        tok.pad_token = tok.eos_token
    return run_training(args, tokenizer=tok)


def cmd_generate(args):
    from .generation.teacher import run_teacher_generation

    return run_teacher_generation(args, tokenizer=_load_tokenizer(args.base_model))


def cmd_export_gptq(args):
    from .models.gptq_export import export_gptq

    params, cfg = _load_model(args.model_path, "float32", args.device)
    export_gptq(params, cfg, args.output, bits=args.w_bit, group_size=args.q_group_size)
    print(f"GPTQ-format checkpoint saved to {args.output}")


def cmd_mix_data(args):
    from .generation.datasets import mix_data

    n = mix_data(args.path_a, args.path_b, args.out)
    print(f"wrote {n} lines to {args.out}")


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


def _cache_dtype(name: str):
    import torch

    return torch.int8 if name == "int8" else torch.bfloat16


def cmd_pack(args):
    from .models.quantized import pack_model, save_packed_checkpoint

    params, cfg = _load_model(args.model_path, device=args.device)
    packed = pack_model(params, cfg, bits=args.w_bit, group_size=args.q_group_size)
    save_packed_checkpoint(args.output, packed, cfg, bits=args.w_bit, group_size=args.q_group_size)
    print(f"packed checkpoint saved to {args.output}")


def cmd_serve(args):
    from .serve import Engine, SamplingParams
    from .serve.server import ServingFrontend

    tok = _load_tokenizer(args.model_path)
    if args.load_quant:
        from .models.quantized import load_packed_checkpoint

        params, cfg = load_packed_checkpoint(args.load_quant, device=args.device)
    else:
        params, cfg = _load_model(args.model_path, device=args.device)
    eng = Engine(
        params, cfg,
        max_slots=args.max_batch_size,
        max_len=args.max_seq_len,
        sampling=SamplingParams(temperature=args.temperature, top_p=args.top_p),
        eos_token_id=tok.eos_token_id,
        cache_dtype=_cache_dtype(args.kv_dtype),
        decode_horizon=args.decode_horizon,
        prompt_cache_size=args.prompt_cache_size,
        prompt_cache_bytes=(int(args.prompt_cache_gb * (1 << 30))
                            if args.prompt_cache_gb else None),
        spec_decode=args.spec_decode,
        spec_ngram=args.spec_ngram,
        device=args.device,
    )
    if args.warmup:
        print("warming the engine...", flush=True)
        eng.warmup(verbose=print)
    front = ServingFrontend(eng, tok, host=args.host, port=args.port,
                            template=args.template)
    import signal

    # graceful drain: in-flight requests finish, then the engine loop exits
    signal.signal(signal.SIGTERM, lambda *_: front.shutdown())
    signal.signal(signal.SIGINT, lambda *_: front.shutdown())
    print(f"serving on http://{front.address[0]}:{front.address[1]} "
          f"({args.max_batch_size} slots, max_len {args.max_seq_len})", flush=True)
    front.serve_forever()


def cmd_chat(args):
    from .models.quantized import load_packed_checkpoint
    from .serve import Engine, Request, SamplingParams
    from .utils.prompts import render_prompt

    params, cfg = load_packed_checkpoint(args.load_quant, device=args.device)
    tok = _load_tokenizer(args.model_path)
    eng = Engine(
        params,
        cfg,
        max_slots=args.max_batch_size,
        max_len=args.max_seq_len,
        sampling=SamplingParams(
            temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
            repetition_penalty=args.repetition_penalty,
        ),
        eos_token_id=tok.eos_token_id,
        cache_dtype=_cache_dtype(args.kv_dtype),
        spec_decode=args.spec_decode,
        device=args.device,
    )
    print("chat ready (ctrl-d to exit)")
    while True:
        try:
            user = input("USER: ")
        except EOFError:
            break
        ids = tok.encode(render_prompt(args.template, user))

        def stream(t):
            print(tok.decode([t]), end="", flush=True)

        print("ASSISTANT: ", end="", flush=True)
        t0 = time.time()
        req = Request(prompt_tokens=ids, max_new_tokens=args.max_new_tokens, stream=stream)
        eng.run([req])
        dt = time.time() - t0
        n = max(len(req.output_tokens), 1)
        print(f"\n[{n} tokens, {dt/n*1e3:.1f} ms/token]")


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
        # math/code generations are repetitive: n-gram drafting pays there
        spec_decode=args.spec_decode,
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
            eos_token_id=getattr(tok, "eos_token_id", None),
            spec_decode=args.spec_decode, device=args.device,
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


def _spec_flag(p):
    p.add_argument("--spec_decode", action="store_true",
                   help="n-gram speculative decoding: draft from each slot's own "
                   "history, verify k+1 tokens a forward (exact sampling; wins on "
                   "repetitive text such as math and code)")


def build_parser():
    p = argparse.ArgumentParser(prog="bitdistiller_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ac = sub.add_parser("autoclip", help="asymmetric clip search (stage 1)")
    ac.add_argument("--model_path", required=True)
    ac.add_argument("--w_bit", type=int, default=2)
    ac.add_argument("--q_group_size", type=int, default=128)
    ac.add_argument("--quant_type", choices=["int", "nf3"], default="int")
    ac.add_argument("--dump_clip", required=True)
    ac.add_argument("--calib_dataset", default="pile")
    ac.add_argument("--calib_path", default=None, help="local JSONL for generic loaders")
    ac.add_argument("--n_samples", type=int, default=128)
    ac.add_argument("--seqlen", type=int, default=1024)
    _device_flag(ac)
    ac.set_defaults(fn=cmd_autoclip)

    tr = sub.add_parser("train", help="KD-QAT training (stage 3)")
    tr.add_argument("--model_name_or_path", required=True)
    tr.add_argument("--data_path", required=True)
    tr.add_argument("--output_dir", required=True)
    tr.add_argument("--bits", type=int, default=2)
    tr.add_argument("--q_group_size", type=int, default=128)
    tr.add_argument("--quant_type", default="int2-asym")
    tr.add_argument("--clip", default=None)
    tr.add_argument("--train_kd", action="store_true", default=True)
    tr.add_argument("--kd_loss_type", default="cakld")
    tr.add_argument("--cakld_steps", type=int, default=10)
    tr.add_argument("--learning_rate", type=float, default=8e-6)
    tr.add_argument("--num_train_epochs", type=int, default=1)
    tr.add_argument("--per_device_train_batch_size", type=int, default=2)
    tr.add_argument("--gradient_accumulation_steps", type=int, default=8)
    tr.add_argument("--model_max_length", type=int, default=2048)
    tr.add_argument("--max_train_samples", type=int, default=None)
    tr.add_argument("--lr_scheduler_type", default="constant")
    tr.add_argument("--warmup_ratio", type=float, default=0.0)
    tr.add_argument("--save_steps", type=int, default=400)
    tr.add_argument("--eval_steps", type=int, default=200)
    tr.add_argument("--logging_steps", type=int, default=1)
    tr.add_argument("--seed", type=int, default=42)
    tr.add_argument("--dp", type=int, default=None,
                    help="data-parallel size (the number of processes)")
    tr.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size: each rank holds 1/tp of every layer "
                    "(Megatron's split); the ranks are dp x tp, tp innermost")
    tr.add_argument("--zero_stage", type=int, default=2, choices=[0, 2, 3],
                    help="0: replicated optimizer state; 2: the f32 master, Adam's moments "
                    "and the accumulators split over the ranks; 3: the latents too")
    tr.add_argument("--remat_policy", default="full",
                    choices=["full", "save_quantized", "save_dots"],
                    help="gradient-checkpoint policy: save_quantized keeps the fake-quantized "
                    "weights live across the backward; save_dots also keeps every "
                    "projection and MLP output")
    tr.add_argument("--param_dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="student latent dtype; bfloat16 keeps f32 master weights in the "
                    "optimizer")
    tr.add_argument("--fused_accum", action="store_true",
                    help="quantize once an accumulation cycle: each optimizer cycle is one "
                    "call over its micro-batches (same averaged gradient, one clip, one "
                    "Adam step)")
    tr.add_argument("--coordinator_address", default=None,
                    help="host:port of rank 0's store for a multi-process run (absent: one "
                    "process, or torchrun's variables)")
    tr.add_argument("--num_processes", type=int, default=None)
    tr.add_argument("--process_id", type=int, default=None)
    tr.add_argument("--eval_on_start", action="store_true",
                    help="run an eval pass before step 1")
    tr.add_argument("--resume", action="store_true")
    _device_flag(tr)
    tr.set_defaults(fn=cmd_train)

    gq = sub.add_parser("export_gptq",
                        help="export to GPTQ packed format (AutoGPTQ interop)")
    gq.add_argument("--model_path", required=True)
    gq.add_argument("--w_bit", type=int, default=2)
    gq.add_argument("--q_group_size", type=int, default=128)
    gq.add_argument("--output", required=True)
    _device_flag(gq)
    gq.set_defaults(fn=cmd_export_gptq)

    gen = sub.add_parser("generate", help="teacher data self-generation (stage 2)")
    gen.add_argument("--base_model", required=True)
    gen.add_argument("--dataset_name", default="alpaca")
    gen.add_argument("--data_path", default=None, help="local JSON for prompts")
    gen.add_argument("--out_path", required=True)
    gen.add_argument("--max_sample", type=int, default=5000)
    gen.add_argument("--max_new_tokens", type=int, default=1024)
    gen.add_argument("--temperature", type=float, default=0.7)
    gen.add_argument("--top_p", type=float, default=1.0)
    gen.add_argument("--max_batch", type=int, default=8)
    gen.add_argument("--max_seq_len", type=int, default=2048)
    gen.add_argument("--seed", type=int, default=42)
    gen.add_argument("--coordinator_address", default=None,
                     help="host:port of rank 0's store for multi-process generation")
    gen.add_argument("--num_processes", type=int, default=None)
    gen.add_argument("--process_id", type=int, default=None)
    _device_flag(gen)
    gen.set_defaults(fn=cmd_generate)

    mx = sub.add_parser("mix_data", help="merge+shuffle two teacher JSONL files")
    mx.add_argument("path_a")
    mx.add_argument("path_b")
    mx.add_argument("--out", required=True)
    mx.set_defaults(fn=cmd_mix_data)

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

    pk = sub.add_parser("pack", help="quantize+pack for serving")
    pk.add_argument("--model_path", required=True)
    pk.add_argument("--w_bit", type=int, default=2)
    pk.add_argument("--q_group_size", type=int, default=128)
    pk.add_argument("--output", required=True)
    pk.add_argument("--device", default="cuda",
                    help="where the weights are loaded and packed: cuda (the "
                    "default; PyTorch's packer on the card) or cpu (the C++ host "
                    "packer)")
    pk.set_defaults(fn=cmd_pack)

    sv = sub.add_parser("serve", help="JSON-over-HTTP online serving")
    sv.add_argument("--model_path", required=True, help="tokenizer source / HF dir")
    sv.add_argument("--load_quant", default=None, help="packed checkpoint dir")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--max_batch_size", "--max_slots", dest="max_batch_size",
                    type=int, default=8)
    sv.add_argument("--max_seq_len", type=int, default=2048)
    sv.add_argument("--temperature", type=float, default=0.7)
    sv.add_argument("--top_p", type=float, default=0.95)
    sv.add_argument("--decode_horizon", type=int, default=16)
    sv.add_argument("--kv_dtype", choices=["bf16", "int8"], default="bf16")
    sv.add_argument("--template", default="raw",
                    help="prompt template for /v1/chat/completions")
    sv.add_argument("--warmup", action="store_true",
                    help="run every admission size, horizon and cache bucket once "
                    "before accepting traffic")
    _spec_flag(sv)
    sv.add_argument("--spec_ngram", type=int, default=2,
                    help="context gram length for the draft lookup")
    sv.add_argument("--prompt_cache_gb", type=float, default=0.0,
                    help="device-memory budget of the prompt cache (LRU eviction "
                    "past it); 0 = entry-count cap only")
    sv.add_argument("--prompt_cache_size", type=int, default=0,
                    help="LRU entries of prompt-prefill KV kept on the device; "
                    "requests with cache_prompt=true skip prefill on repeat")
    _device_flag(sv)
    sv.set_defaults(fn=cmd_serve)

    ch = sub.add_parser("chat", help="interactive chat on a packed model")
    ch.add_argument("--model_path", required=True, help="tokenizer source")
    ch.add_argument("--load_quant", required=True, help="packed checkpoint dir")
    ch.add_argument("--template", default="llama2")
    ch.add_argument("--max_seq_len", type=int, default=2048)
    ch.add_argument("--max_batch_size", type=int, default=1)
    ch.add_argument("--max_new_tokens", type=int, default=512)
    ch.add_argument("--temperature", type=float, default=0.7)
    ch.add_argument("--top_p", type=float, default=0.95)
    ch.add_argument("--top_k", type=int, default=0)
    ch.add_argument("--repetition_penalty", type=float, default=1.0)
    _spec_flag(ch)
    ch.add_argument("--kv_dtype", choices=["bf16", "int8"], default="bf16",
                    help="int8 = quantized KV cache (halves decode KV traffic)")
    _device_flag(ch)
    ch.set_defaults(fn=cmd_chat)

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
    _spec_flag(ev)
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
    _spec_flag(gs)
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
    _spec_flag(he)
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
    _spec_flag(rs)
    _device_flag(rs)
    rs.set_defaults(fn=cmd_reasoning)
    return p


def main(argv=None):
    """Run a subcommand; returns what it returns (`train`: the run's
    summary, `generate`: the file written), for callers in process."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
