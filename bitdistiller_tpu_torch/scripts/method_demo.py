"""The method, end to end, on a model the port trains itself (PyTorch port of
the JAX package's `scripts/method_demo.py`):

    RTN PTQ -> AutoClip -> teacher self-generation -> CAKLD KD-QAT -> pack

It trains a small decoder to real quality on a synthetic order-2 Markov
language (or byte-level Python source with `--corpus source`), then reports
held-out perplexity after each stage, for int2 and nf3 at the same group
size, with the packed int2 model served at A16 and at W2A8
(BITDISTILLER_QMM_A8=1, set for that row only). The claims are the method's,
in miniature: sub-4-bit RTN destroys quality, clipping helps, KD-QAT
recovers most of the gap, and the packed model reproduces the fake-quant
number.

    python -m bitdistiller_tpu_torch.scripts.method_demo [--device cpu]

The table goes to `--out` (default chiprun_out/method_demo.md; its section
rewritten, the rest of the file kept) and to stdout, followed by one JSON
line of the rows. The corpus is the JAX script's array for array; the
weights, the batches' order aside, come from torch generators, so the
numbers land near the JAX script's, not on them.

`--spec-bench` also runs n-gram speculative decoding on held-out prompts
through the packed int2 teacher (seven engine variants: plain, fixed
(n-gram, k) points and the adaptive policy, greedy) and writes its section
to `--out` too; `--spec-only` stops after it. `--teacher-ckpt PATH` loads
the teacher from a pickle of float32 numpy leaves if PATH exists, else
trains it and saves it there.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys
import sysconfig
import time

import numpy as np
import torch

from .._device import resolve_device
from ..eval.ppl import perplexity
from ..models import ModelConfig, init_params, pack_model
from ..ops.quant_matmul import A8_ENV, maybe_repack_a8
from ..quant.autoclip import run_autoclip
from ..quant.core import fake_quant_int_kaxis, fake_quant_nf3_kaxis
from ..serve import Engine, SamplingParams
from ..serve.engine import SPEC_STEP_COST
from ..train.trainer import (
    TrainConfig,
    estimate_cakld_beta,
    init_train_state,
    make_train_step,
    master_params,
    to_device,
    tree_leaves,
)

VOCAB = 256
SEQ = 256  # overridden by --corpus source (byte-level, longer blocks)
DEFAULT_OUT = os.path.join("chiprun_out", "method_demo.md")
# the reference's results file from before the port: this script never writes it
RESERVED_OUT = "RESULTS.md"


def source_corpus(max_bytes: int, root: str, hold_every: int = 20):
    """REAL text: the Python source under `root` (the interpreter's
    site-packages by default), byte-level (vocab 256). Deterministic file
    walk; every `hold_every`-th file is held out for eval. Raises if the root
    holds no Python files: never a silent fall back to the Markov language."""
    files = sorted(glob.glob(os.path.join(root, "**", "*.py"), recursive=True))
    if not files:
        raise SystemExit(f"--corpus source: no Python files under {root}")
    train_parts, eval_parts, total = [], [], 0
    for i, path in enumerate(files):
        if total >= max_bytes:
            break
        try:
            data = open(path, "rb").read()
        except OSError:
            continue
        if not (256 < len(data) < 1 << 20):
            continue
        (eval_parts if i % hold_every == 0 else train_parts).append(data)
        total += len(data)
    train = np.frombuffer(b"\n".join(train_parts), np.uint8).astype(np.int32)
    evl = np.frombuffer(b"\n".join(eval_parts), np.uint8).astype(np.int32)
    return train, evl


def make_corpus(n_tokens: int, seed: int, table_seed: int = 7) -> np.ndarray:
    """Order-2 Markov language: each (prev2, prev1) pair has a dominant next
    symbol (p=0.85) plus 4 alternatives — learnable structure with entropy.
    The transition TABLES come from table_seed (one fixed language); `seed`
    only drives the sampled trajectory, so train/eval are held-out samples
    of the SAME language."""
    table_rng = np.random.default_rng(table_seed)
    main = table_rng.integers(0, VOCAB, (VOCAB, VOCAB)).astype(np.int32)
    alts = table_rng.integers(0, VOCAB, (VOCAB, VOCAB, 4)).astype(np.int32)
    rng = np.random.default_rng(seed)
    out = np.empty(n_tokens, np.int32)
    out[0], out[1] = rng.integers(0, VOCAB, 2)
    r = rng.random(n_tokens)
    pick = rng.integers(0, 4, n_tokens)
    for t in range(2, n_tokens):
        a, b = out[t - 2], out[t - 1]
        out[t] = main[a, b] if r[t] < 0.85 else alts[a, b, pick[t]]
    return out


def blocks_of(stream: np.ndarray) -> np.ndarray:
    n = len(stream) // SEQ
    return stream[: n * SEQ].reshape(n, SEQ)


def batches_from_blocks(blocks: np.ndarray, bs: int, rng: np.random.Generator):
    while True:
        idx = rng.integers(0, len(blocks), bs)
        toks = blocks[idx]
        yield {
            "input_ids": toks,
            "labels": toks.copy(),
            "attention_mask": np.ones_like(toks),
        }


def train_teacher(cfg, blocks, steps, bs, log, lr=3e-3, device="cuda"):
    tc = TrainConfig(quant_type=None, train_kd=False, learning_rate=lr,
                     lr_scheduler="cosine", total_steps=steps,
                     gradient_checkpointing=False, max_grad_norm=1.0)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    state = init_train_state(params, tc)
    step = make_train_step(cfg, tc)
    it = batches_from_blocks(blocks, bs, np.random.default_rng(1))
    t0 = time.time()
    for i in range(steps):
        state, m = step(state, to_device(next(it), device), 0.0, None)
        if (i + 1) % max(steps // 5, 1) == 0:
            loss = float(m["loss"])
            log(f"  teacher step {i+1}/{steps} ce={loss:.3f} "
                f"({(time.time()-t0)/(i+1)*1e3:.0f} ms/step)")
    return master_params(state)


def teacher_generate(params, cfg, prompts, max_new, log, device="cuda"):
    eng = Engine(params, cfg, max_slots=32, max_len=SEQ,
                 sampling=SamplingParams(temperature=0.7, top_p=1.0),
                 eos_token_id=None, decode_horizon=16, device=device)
    t0 = time.time()
    outs = eng.generate([list(map(int, p)) for p in prompts], max_new_tokens=max_new)
    log(f"  teacher-gen: {len(prompts)} samples x {max_new} tokens "
        f"in {time.time()-t0:.1f}s")
    return outs


def kd_qat(cfg, student_init, teacher, gen_pairs, quant_type, gsize, steps, bs, log,
           device="cuda"):
    tc = TrainConfig(quant_type=quant_type, q_group_size=gsize, train_kd=True,
                     kd_loss_type="cakld", learning_rate=3e-4,
                     lr_scheduler="constant", total_steps=steps,
                     gradient_checkpointing=False)
    prompts, gens = gen_pairs
    plen, glen = len(prompts[0]), len(gens[0])
    toks = np.concatenate([np.asarray(prompts, np.int32),
                           np.asarray(gens, np.int32)], axis=1)
    labels = toks.copy()
    labels[:, :plen] = -100  # IGNORE prompt positions (collator semantics)
    rng = np.random.default_rng(2)

    def kd_batches():
        while True:
            idx = rng.integers(0, len(toks), bs)
            yield to_device({"input_ids": toks[idx], "labels": labels[idx],
                             "attention_mask": np.ones((bs, plen + glen), np.int32)}, device)

    it = kd_batches()
    beta = estimate_cakld_beta(teacher, cfg, [next(it) for _ in range(4)])
    log(f"  CAKLD beta = {float(beta):.4f}")
    state = init_train_state(student_init, tc)
    step = make_train_step(cfg, tc)
    t0 = time.time()
    for i in range(steps):
        state, m = step(state, next(it), beta, teacher)
        if (i + 1) % max(steps // 4, 1) == 0:
            log(f"  qat[{quant_type}] step {i+1}/{steps} loss={float(m['loss']):.3f} "
                f"({(time.time()-t0)/(i+1)*1e3:.0f} ms/step)")
    return master_params(state)


SPEC_VARIANTS = (  # (name, Engine keywords; None: the plain engine)
    ("plain", None),
    ("ng2k4", dict(spec_decode=True, spec_adaptive_k=False, spec_ngram=2, spec_k=4)),
    ("ng3k4", dict(spec_decode=True, spec_adaptive_k=False, spec_ngram=3, spec_k=4)),
    ("ng3k7", dict(spec_decode=True, spec_adaptive_k=False, spec_ngram=3, spec_k=7)),
    ("ng3k11", dict(spec_decode=True, spec_adaptive_k=False, spec_ngram=3, spec_k=11)),
    ("adaptive", dict(spec_decode=True, spec_ngram=2, spec_k=4)),
    ("adapt+bko", dict(spec_decode=True, spec_ngram=2, spec_k=4, spec_ngram_backoff=True)),
)


def spec_bench(params, cfg, eval_blocks, log, device="cuda") -> dict:
    """Greedy generation on held-out prompts (the first 64 tokens of 16
    eval blocks): the plain engine against n-gram speculative decoding,
    each variant once untimed and once timed (the engine's acceptance
    counters cover the timed pass). Returns {variant: {tok_s, outs, accept,
    k, rounds, the cache length reached, and the timed pass's decode steps
    and verify forwards by k}} and "prompts"; greedy agreement with plain
    is reported, not asserted (a bf16 argmax near a tie can flip between
    S = k + 1 and S = 1 forwards)."""
    prompts = [list(map(int, b[:64])) for b in eval_blocks[:16]]
    max_new = min(256, SEQ - 64 - 2)  # fits the engine's max_len
    res: dict = {}
    for mode, kw in SPEC_VARIANTS:
        eng = Engine(params, cfg, max_slots=16, max_len=SEQ,
                     sampling=SamplingParams(temperature=0.0), eos_token_id=None,
                     decode_horizon=16, device=device, **(kw or {}))
        eng.generate(prompts, max_new_tokens=max_new)
        eng.spec_tokens = eng.spec_rounds = 0
        steps0, forwards0 = eng.decode_steps, dict(eng.spec_forwards)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        outs = eng.generate(prompts, max_new_tokens=max_new)
        dt = time.time() - t0
        toks = sum(len(o) for o in outs)
        acc = eng.spec_tokens / max(eng.spec_rounds, 1)
        k = None if kw is None else eng._spec_k_last
        res[mode] = {"tok_s": toks / dt, "outs": outs, "accept": acc, "k": k,
                     "rounds": eng.spec_rounds, "decode_steps": eng.decode_steps - steps0,
                     "cache_len": eng._cache_len(),
                     "spec_forwards": {kk: n - forwards0.get(kk, 0)
                                       for kk, n in eng.spec_forwards.items()}}
        log(f"  {mode}: {toks / dt:.0f} tok/s"
            + (f", {acc:.2f}/{k + 1} tokens per verify round (k ends at {k})" if kw else ""))
    for mode, kw in SPEC_VARIANTS[1:]:
        same = sum(a == b for a, b in zip(res[mode]["outs"], res["plain"]["outs"]))
        res[mode]["agree"] = same
        log(f"  {mode} greedy agreement: {same}/{len(prompts)} sequences")
    res["prompts"] = prompts
    return res


def spec_section(res: dict, model_desc: str, device_name: str) -> tuple[str, list]:
    """The spec bench's markdown section: (header, lines)."""
    header = "## Speculative decoding on held-out text (the port)"
    lines = [
        header,
        "",
        f"n-gram drafting over held-out prompts through {model_desc}, greedy, on "
        f"{device_name}: the `Engine(spec_decode=True)` serving path, acceptance from the",
        "engine's spec_tokens / spec_rounds over the timed pass. `est x` is the",
        f"acceptance over a verify cost of (1 + {SPEC_STEP_COST} k) plain steps, the engine's",
        "SPEC_STEP_COST model; `tok/s` is this run's host clock.",
        "",
        "| engine | spec_k | accepted/round (of k+1) | est x | tok/s | agrees with plain |",
        "|---|---|---|---|---|---|",
    ]
    n = len(res["prompts"])
    for mode, _ in SPEC_VARIANTS:
        r = res[mode]
        if mode == "plain":
            lines.append(f"| plain | — | — | 1.00x | {r['tok_s']:.0f} | — |")
        else:
            est = r["accept"] / (1 + SPEC_STEP_COST * r["k"])
            lines.append(f"| {mode} | {r['k']} | {r['accept']:.2f}/{r['k'] + 1} | {est:.2f}x "
                         f"| {r['tok_s']:.0f} | {r['agree']}/{n} |")
    lines.append("")
    return header, lines


def load_teacher(path: str, device) -> dict:
    """A teacher pickled by this script (or the JAX script): nested dicts of
    float32 numpy leaves, taken as bf16 on `device`."""
    with open(path, "rb") as f:
        host = pickle.load(f)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node, np.float32)).to(device, torch.bfloat16)

    return walk(host)


def save_teacher(params: dict, path: str) -> None:
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.detach().to(torch.float32).cpu().numpy()

    with open(path, "wb") as f:
        pickle.dump(walk(params), f)


def replace_section(path: str, header: str, section: str):
    """Idempotently (re)write one `## ...` section of a markdown file,
    preserving everything else (missing file/section -> append)."""
    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        text = ""
    if header in text:
        pre = text[: text.index(header)]
        rest = text[text.index(header):]
        nxt = rest.find("\n## ", 1)
        text = pre + section + (rest[nxt + 1:] if nxt != -1 else "")
    else:
        text = text.rstrip() + ("\n\n" if text.strip() else "") + section
    with open(path, "w") as f:
        f.write(text)


def recovered(row: dict, teacher_ppl: float) -> float:
    """The share of the RTN-to-teacher gap that QAT recovers."""
    return (row["rtn"] - row["qat"]) / max(row["rtn"] - teacher_ppl, 1e-9)


def build_parser():
    ap = argparse.ArgumentParser(prog="bitdistiller_tpu_torch.scripts.method_demo")
    ap.add_argument("--corpus", choices=["markov", "source"], default="markov",
                    help="markov: synthetic order-2 language (tiny, fast); "
                    "source: byte-level REAL Python source under --source-root "
                    "(~26M-param model, headline g128 configs)")
    ap.add_argument("--source-root", default=sysconfig.get_paths()["purelib"],
                    help="--corpus source: the directory walked for *.py files "
                    "(default: this interpreter's site-packages)")
    ap.add_argument("--teacher-steps", type=int, default=None)
    ap.add_argument("--qat-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--gen-samples", type=int, default=256)
    ap.add_argument("--gen-tokens", type=int, default=128)
    ap.add_argument("--qat-batch", type=int, default=16)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers (default: the corpus's model, 6 or 8)")
    ap.add_argument("--eval-blocks", type=int, default=192)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spec-bench", action="store_true",
                    help="also measure n-gram speculative decoding on held-out prompts "
                    "through the packed int2 teacher")
    ap.add_argument("--spec-only", action="store_true",
                    help="train the teacher, run the spec bench, skip the quantization "
                    "pipeline")
    ap.add_argument("--teacher-ckpt", default=None,
                    help="pickle path: load the teacher from it if present, else train "
                    "and save it there")
    return ap


def run(args, log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """The pipeline for the parsed `args`: {"teacher": ppl, "rows": [...],
    "seconds": {stage: s}, "lines": the table's markdown lines, "spec": the
    spec bench's results (with its "lines" and the packed "params") or
    None, ...}. With --spec-only the rows and lines are empty."""
    global SEQ
    if os.path.basename(os.path.normpath(args.out)) == RESERVED_OUT:
        raise SystemExit(f"--out {args.out}: the port's demo never writes {RESERVED_OUT}")
    device = resolve_device(args.device)
    seconds: dict = {}
    clock = time.time()

    def lap(name):
        nonlocal clock
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.time()
        seconds[name] = seconds.get(name, 0.0) + now - clock
        clock = now

    if args.corpus == "source":
        SEQ = 512
        args.teacher_steps = args.teacher_steps or 4000
        args.qat_steps = args.qat_steps or 600
        G = args.group_size or 128
        cfg = ModelConfig(vocab_size=VOCAB, hidden_size=512,
                          intermediate_size=1408, num_layers=args.layers or 8, num_heads=8,
                          num_kv_heads=8, max_position_embeddings=SEQ)
        log("reading source corpus...")
        train_stream, eval_stream = source_corpus(48 << 20, args.source_root)
        train_blocks = blocks_of(train_stream)
        eval_blocks = blocks_of(eval_stream)[: args.eval_blocks]
        log(f"  {len(train_blocks)} train / {len(eval_blocks)} eval blocks of {SEQ}")
    else:
        SEQ = 256
        args.teacher_steps = args.teacher_steps or 1500
        args.qat_steps = args.qat_steps or 400
        G = args.group_size or 64
        cfg = ModelConfig(vocab_size=VOCAB, hidden_size=256, intermediate_size=512,
                          num_layers=args.layers or 6, num_heads=8, num_kv_heads=8,
                          max_position_embeddings=SEQ)
        log("building corpus...")
        train_blocks = blocks_of(make_corpus(1_200_000, seed=7))
        eval_blocks = blocks_of(make_corpus(64_000, seed=99))[: args.eval_blocks]
    calib_blocks = train_blocks[:16]
    lap("corpus")

    if args.teacher_ckpt and os.path.exists(args.teacher_ckpt):
        log(f"loading teacher from {args.teacher_ckpt}...")
        teacher = load_teacher(args.teacher_ckpt, device)
    else:
        log(f"training teacher ({args.teacher_steps} steps)...")
        teacher = train_teacher(cfg, train_blocks, args.teacher_steps, args.batch, log,
                                lr=1e-3 if args.corpus == "source" else 3e-3, device=device)
        if args.teacher_ckpt:
            save_teacher(teacher, args.teacher_ckpt)
            log(f"teacher saved to {args.teacher_ckpt}")
    lap("teacher")
    n_params = sum(x.numel() for x in tree_leaves(teacher))

    def ppl(params, quantizer=None):
        out = perplexity(params, cfg, eval_blocks, quantizer=quantizer, batch_size=32,
                         device=device)
        lap("eval")
        return out

    teacher_ppl = ppl(teacher)
    log(f"teacher ppl {teacher_ppl:.4f} ({n_params/1e6:.1f}M params)")

    spec = None
    if args.spec_bench or args.spec_only:
        # the PACKED teacher (int2 RTN, fused qkv/gate_up): the serving artifact
        log("spec-decode bench on held-out prompts (packed model)...")
        spec_params = pack_model(teacher, cfg, bits=2, group_size=G)
        spec = spec_bench(spec_params, cfg, eval_blocks, log, device=device)
        lap("spec")
        dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "the CPU")
        spec["header"], spec["lines"] = spec_section(
            spec, f"the int2-g{G} packed {n_params / 1e6:.1f}M decoder", dev_name)
        spec["params"] = spec_params
        if args.spec_only:
            return dict(teacher=teacher_ppl, rows=[], seconds=seconds, lines=[], header=None,
                        n_params=n_params, group_size=G, teacher_steps=args.teacher_steps,
                        qat_steps=args.qat_steps, spec=spec, cfg=cfg)

    prompts = train_blocks[np.random.default_rng(3).integers(0, len(train_blocks),
                                                             args.gen_samples)][:, :32]
    gens = teacher_generate(teacher, cfg, prompts, max_new=args.gen_tokens, log=log,
                            device=device)
    lap("generation")

    rows = []
    for qt, label in [("int2-asym", f"int2-g{G}"), ("ste-n2f3", f"nf3-g{G}")]:
        # PTQ-rounding eval quantizer on the K-axis grid (the grid QAT,
        # AutoClip and packing share)
        if qt == "int2-asym":
            q_eval = lambda w: fake_quant_int_kaxis(w, 2, G, ste=False)
            ac_type, nb = "int", 2
        else:
            q_eval = lambda w: fake_quant_nf3_kaxis(w, G, ste=False)
            ac_type, nb = "nf3", 3
        rtn_ppl = ppl(teacher, q_eval)
        log(f"[{label}] RTN ppl {rtn_ppl:.4f}")
        res = run_autoclip(teacher, cfg, calib_blocks, quant_type=ac_type,
                           n_bit=nb, group_size=G, n_sample_token=512, apply=True,
                           progress=lambda s: None)
        clipped = res["params"]
        lap("autoclip")
        clip_ppl = ppl(clipped, q_eval)
        log(f"[{label}] AutoClip ppl {clip_ppl:.4f}")
        qat = kd_qat(cfg, clipped, teacher, (prompts, gens), qt, G,
                     args.qat_steps, args.qat_batch, log, device=device)
        lap("qat")
        qat_ppl = ppl(qat, q_eval)
        log(f"[{label}] QAT ppl {qat_ppl:.4f}")
        row = {"label": label, "rtn": rtn_ppl, "clip": clip_ppl, "qat": qat_ppl}
        if qt == "int2-asym":
            packed = pack_model(qat, cfg, bits=2, group_size=G)
            lap("pack")
            row["packed"] = ppl(packed)
            log(f"[{label}] packed ppl {row['packed']:.4f}")
            # W2A8 serving mode (BITDISTILLER_QMM_A8=1): per-token int8
            # activations change numerics; the variable is set for this row only
            os.environ[A8_ENV] = "1"
            try:
                row["packed_a8"] = ppl(maybe_repack_a8(packed))
            finally:
                os.environ.pop(A8_ENV, None)
            log(f"[{label}] packed W2A8 ppl {row['packed_a8']:.4f}")
        rows.append(row)

    if args.corpus == "source":
        header = "## Real text, headline g128 configs (the port)"
        intro = [
            f"A {n_params/1e6:.1f}M-param decoder trained {args.teacher_steps} steps by the "
            "PyTorch port on **byte-level real text** (Python source under",
            f"`{args.source_root}`, held-out files as the eval split, {len(eval_blocks)} × "
            f"{SEQ}-token blocks), int2/nf3 at g{G}. Pipeline: RTN → AutoClip →",
            f"teacher self-generation (engine, T=0.7, {args.gen_samples}×{args.gen_tokens} "
            f"tokens) → CAKLD KD-QAT ({args.qat_steps} steps) → pack.",
            "`packed W2A8` = the same packed model with per-token int8 activations "
            "(`BITDISTILLER_QMM_A8=1`).",
            "Reproduce: `python -m bitdistiller_tpu_torch.scripts.method_demo --corpus "
            "source`.",
        ]
    else:
        header = "## Synthetic language (the port)"
        intro = [
            f"A {n_params/1e6:.1f}M-param decoder trained {args.teacher_steps} steps by the "
            f"PyTorch port on an order-2 Markov language (vocab {VOCAB}), int2/nf3 at g{G}",
            f"({len(eval_blocks)} × {SEQ}-token held-out blocks; {args.gen_samples}×"
            f"{args.gen_tokens} generated tokens; {args.qat_steps} QAT steps).",
            "Reproduce: `python -m bitdistiller_tpu_torch.scripts.method_demo`.",
        ]
    lines = [header, ""] + intro + [
        "",
        f"Teacher (bf16): **{teacher_ppl:.3f}** PPL",
        "",
        "| quant | RTN | +AutoClip | +CAKLD QAT | gap recovered | packed | packed W2A8 |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        packed = f"{r['packed']:.3f}" if "packed" in r else "—"
        packed_a8 = f"{r['packed_a8']:.3f}" if "packed_a8" in r else "—"
        lines.append(
            f"| {r['label']} | {r['rtn']:.3f} | {r['clip']:.3f} | {r['qat']:.3f} "
            f"| {recovered(r, teacher_ppl):.0%} | {packed} | {packed_a8} |"
        )
    lines.append("")
    return dict(teacher=teacher_ppl, rows=rows, seconds=seconds, lines=lines, header=header,
                n_params=n_params, group_size=G, teacher_steps=args.teacher_steps,
                qat_steps=args.qat_steps, spec=spec, cfg=cfg)


def main(argv=None):
    args = build_parser().parse_args(argv)
    result = run(args)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    # section-preserving writes: the other sections of the file survive
    spec = result["spec"]
    if spec is not None:
        replace_section(args.out, spec["header"], "\n".join(spec["lines"]))
        print("\n".join(spec["lines"]))
    if result["header"] is not None:
        replace_section(args.out, result["header"], "\n".join(result["lines"]))
        print("\n".join(result["lines"]))
    print(f"wrote {args.out}", file=sys.stderr, flush=True)
    summary = {"teacher": result["teacher"], "rows": result["rows"],
               "seconds": result["seconds"]}
    if spec is not None:
        summary["spec"] = {m: {k: spec[m][k] for k in ("tok_s", "accept", "k")}
                           for m, _ in SPEC_VARIANTS}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
