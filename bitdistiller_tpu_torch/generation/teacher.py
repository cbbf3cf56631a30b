"""Teacher-data self-generation (PyTorch port of the JAX package's
`generation/teacher.py`): sample completions of the full-precision model
on a prompt dataset through the port's continuous-batching `Engine`, and
write one `[[prompt, completion]]` JSON line a prompt, in prompt order.

One process only: the JAX package's multi-host sharding (a shard of the
prompts and a file per process) waits for ROADMAP A11, and the multi-host
arguments raise rather than being ignored.
"""

from __future__ import annotations

import json
import os

from .._device import resolve_device
from ..serve import Engine, Request, SamplingParams
from .datasets import PROMPT_STYLES, get_gen_prompts, style_for_dataset

_MULTI_HOST_ARGS = ("coordinator_address", "num_processes", "process_id")


def run_teacher_generation(args, *, tokenizer=None, model=None) -> str:
    """Generate with `args` (the JAX package's `generate` CLI namespace:
    base_model, dataset_name, data_path, out_path, max_sample,
    max_new_tokens, temperature, top_p, max_batch, max_seq_len, seed; plus
    `device`, default "cuda"). The model is the HF checkpoint at
    `args.base_model`, loaded in bf16, unless `model=(params, cfg)` is
    given; the tokenizer is `transformers.AutoTokenizer`'s unless given.
    Returns the path written."""
    for name in _MULTI_HOST_ARGS:
        if getattr(args, name, None) is not None:
            raise NotImplementedError(
                f"{name} is set: multi-host teacher generation is not ported (ROADMAP A11); "
                "the port generates in one process")
    device = resolve_device(getattr(args, "device", "cuda"))
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.base_model, use_fast=True)
    tok = tokenizer
    if model is None:
        from ..models.hf_import import load_hf_checkpoint

        params, cfg = load_hf_checkpoint(args.base_model, device=device)
    else:
        params, cfg = model

    prompts = get_gen_prompts(
        args.dataset_name, args.max_sample, args.seed, getattr(args, "data_path", None)
    )
    style = PROMPT_STYLES[style_for_dataset(args.dataset_name)]

    eng = Engine(
        params,
        cfg,
        max_slots=args.max_batch,
        max_len=args.max_seq_len,
        sampling=SamplingParams(temperature=args.temperature, top_p=args.top_p),
        eos_token_id=tok.eos_token_id,
        seed=args.seed,  # rank 0 of 1: the JAX package's seed + rank
        decode_horizon=16,  # batch generation: throughput over EOS latency
        device=device,
    )

    templated = [style.format(instruction=p) for p in prompts]
    reqs = [
        Request(prompt_tokens=tok.encode(t), max_new_tokens=args.max_new_tokens)
        for t in templated
    ]
    order = {id(r): i for i, r in enumerate(reqs)}
    results = [None] * len(reqs)
    for r in eng.run(reqs):
        results[order[id(r)]] = tok.decode(r.output_tokens, skip_special_tokens=True)

    out_path = args.out_path  # one process: the JAX package's single-process name
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        for prompt, completion in zip(templated, results):
            f.write(json.dumps([[prompt, completion]]) + "\n")
    return out_path
