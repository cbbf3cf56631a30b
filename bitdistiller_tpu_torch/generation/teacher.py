"""Teacher-data self-generation (PyTorch port of the JAX package's
`generation/teacher.py`): sample completions of the full-precision model
on a prompt dataset through the port's continuous-batching `Engine`, and
write one `[[prompt, completion]]` JSON line a prompt, in prompt order.

Several processes (`coordinator_address`, `num_processes`, `process_id`,
or torchrun's variables) split the prompts as the JAX package does: rank r
of n takes `prompts[r::n]`, samples with seed + r and writes its own file,
`{base}_T{temperature}_N{max_sample}_S{seed}_{r}{ext}` (the reference's
shard names); one process writes `out_path` itself.
"""

from __future__ import annotations

import json
import os

import torch.distributed as dist

from .._device import resolve_device
from ..parallel.distributed import (get_rank, get_world_size, init_distributed, local_device,
                                    shutdown_distributed)
from ..serve import Engine, Request, SamplingParams
from .datasets import PROMPT_STYLES, get_gen_prompts, style_for_dataset


def run_teacher_generation(args, *, tokenizer=None, model=None) -> str:
    """Generate with `args` (the JAX package's `generate` CLI namespace:
    base_model, dataset_name, data_path, out_path, max_sample,
    max_new_tokens, temperature, top_p, max_batch, max_seq_len, seed,
    coordinator_address, num_processes, process_id; plus `device`, default
    "cuda"). The model is the HF checkpoint at `args.base_model`, loaded in
    bf16, unless `model=(params, cfg)` is given; the tokenizer is
    `transformers.AutoTokenizer`'s unless given. Returns the path written."""
    device = resolve_device(getattr(args, "device", "cuda"))
    fresh = not dist.is_initialized()
    joined = init_distributed(getattr(args, "coordinator_address", None),
                              getattr(args, "num_processes", None),
                              getattr(args, "process_id", None), device=device)
    try:
        return _generate(args, local_device(device), tokenizer, model)
    finally:
        if fresh and joined:
            shutdown_distributed()


def _generate(args, device, tokenizer, model) -> str:
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
    # shard the prompts over the ranks (DistributedSampler's interleave)
    n_proc, rank = get_world_size(), get_rank()
    prompts = prompts[rank::n_proc]

    eng = Engine(
        params,
        cfg,
        max_slots=args.max_batch,
        max_len=args.max_seq_len,
        sampling=SamplingParams(temperature=args.temperature, top_p=args.top_p),
        eos_token_id=tok.eos_token_id,
        seed=args.seed + rank,
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

    base, ext = os.path.splitext(args.out_path)
    out_path = (f"{base}_T{args.temperature}_N{args.max_sample}_S{args.seed}_{rank}{ext or '.json'}"
                if n_proc > 1 else args.out_path)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        for prompt, completion in zip(templated, results):
            f.write(json.dumps([[prompt, completion]]) + "\n")
    return out_path
