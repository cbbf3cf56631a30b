"""Dataset preparation utilities: the port's counterpart of the JAX
package's `scripts/prepare_datasets.py` (the same subcommands, flags and
files, byte for byte), which it keeps its own copy of rather than import.

    python -m bitdistiller_tpu_torch.scripts.prepare_datasets <subcommand> ...

Subcommands:
  export  — HF dataset -> teacher-format JSONL blocks ([[src, tgt]] per line,
            download_nemotron.py / download_OpenR1_math_220k.py /
            download_epicoder.py semantics), with optional char-length
            filtering (the "char16k" dataset variants) and 500k-row blocking.
  prepro  — {'input','text'} JSONL -> pair JSONL with the first 10 samples
            prepended as the eval split (prepro_data_efficacy.py:27 parity;
            train/data.py reserves the leading samples for eval).
  scrape  — walk checkpoint-*/ dirs for eval logs/JSON and collect metric
            curves into one CSV (get_scores_{mmlu,arc,aime}.py parity,
            generalized to any metric key).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import sys

# HF dataset -> (subset/split handling, (source, target) field extraction)
_EXPORT_PRESETS = {
    "nemotron-code": ("nvidia/Llama-Nemotron-Post-Training-Dataset", "SFT", "code",
                      lambda r: (r["input"][0]["content"], r["output"])),
    "nemotron-math": ("nvidia/Llama-Nemotron-Post-Training-Dataset", "SFT", "math",
                      lambda r: (r["input"][0]["content"], r["output"])),
    "openr1-math": ("open-r1/OpenR1-Math-220k", None, "train",
                    lambda r: (r["problem"], r["solution"])),
    "epicoder": ("microsoft/EpiCoder-func-380k", None, "train",
                 lambda r: (r["instruction"], r["output"])),
}


def cmd_export(args):
    from datasets import load_dataset

    if args.preset:
        repo, subset, split, extract = _EXPORT_PRESETS[args.preset]
    else:
        repo, subset, split = args.dataset, args.subset, args.split
        sfield, tfield = args.source_field, args.target_field
        extract = lambda r: (r[sfield], r[tfield])
    ds = load_dataset(repo, subset, split=split) if subset else load_dataset(repo, split=split)

    os.makedirs(args.out_dir, exist_ok=True)
    block, block_id, written, skipped = [], 0, 0, 0

    def flush():
        nonlocal block, block_id
        if not block:
            return
        path = os.path.join(args.out_dir, f"{args.name}_block_{block_id}.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            for pair in block:
                f.write(json.dumps(pair) + "\n")
        print(f"wrote {len(block)} pairs -> {path}", file=sys.stderr)
        block = []
        block_id += 1

    for rec in ds:
        src, tgt = extract(rec)
        if args.max_chars and len(src) + len(tgt) > args.max_chars:
            skipped += 1
            continue
        block.append([[src, tgt]])
        written += 1
        if len(block) >= args.block_size:
            flush()
        if args.limit and written >= args.limit:
            break
    flush()
    print(f"exported {written} pairs ({skipped} over --max-chars {args.max_chars})")


def cmd_prepro(args):
    samples = []
    with open(args.input, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            item = json.loads(line)
            if "input" not in item or "text" not in item:
                raise SystemExit(f"missing 'input'/'text' in record: {item.keys()}")
            samples.append([[item["input"], item["text"]]])
    # repeat the first N as leading eval samples (the reference prepends 10)
    samples = samples[: args.eval_samples] + samples
    with open(args.output, "w", encoding="utf-8") as f:
        for s in samples:
            f.write(json.dumps(s) + "\n")
    print(f"wrote {len(samples)} pairs ({args.eval_samples} duplicated for eval)")


_METRIC_RE = re.compile(
    r"[\"']?((?:[a-zA-Z0-9@-]+[-_])?(?:acc_norm|accuracy|acc|ppl|pass@1))[\"']?"
    r"\s*[:=]\s*([0-9.]+)"
)


def cmd_scrape(args):
    rows = []
    ckpt_re = re.compile(r"(?:checkpoint|step)[-_](\d+)$")
    for entry in sorted(os.listdir(args.base_dir)):
        m = ckpt_re.search(entry)
        if not m:
            continue
        step = int(m.group(1))
        metrics = {}
        sub = os.path.join(args.base_dir, entry)
        for root, _dirs, files in os.walk(sub):
            for fn in files:
                if not fn.endswith((".log", ".json", ".txt")):
                    continue
                try:
                    content = open(os.path.join(root, fn), errors="replace").read()
                except OSError:
                    continue
                for key, val in _METRIC_RE.findall(content):
                    metrics.setdefault(key, float(val))
        if metrics:
            rows.append({"step": step, **metrics})
    if not rows:
        print("no metrics found", file=sys.stderr)
        return
    keys = ["step"] + sorted({k for r in rows for k in r} - {"step"})
    out = args.output or os.path.join(args.base_dir, "scores.csv")
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in sorted(rows, key=lambda r: r["step"]):
            w.writerow(r)
    print(f"wrote {len(rows)} rows -> {out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="prepare_datasets")
    sub = p.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="HF dataset -> teacher JSONL blocks")
    ex.add_argument("--preset", choices=sorted(_EXPORT_PRESETS))
    ex.add_argument("--dataset", help="HF repo id (when no --preset)")
    ex.add_argument("--subset", default=None)
    ex.add_argument("--split", default="train")
    ex.add_argument("--source_field", default="input")
    ex.add_argument("--target_field", default="output")
    ex.add_argument("--name", default="export")
    ex.add_argument("--out_dir", required=True)
    ex.add_argument("--block_size", type=int, default=500_000)
    ex.add_argument("--max_chars", type=int, default=0,
                    help="skip pairs longer than this many chars (0 = keep all)")
    ex.add_argument("--limit", type=int, default=0)
    ex.set_defaults(fn=cmd_export)

    pr = sub.add_parser("prepro", help="input/text JSONL -> pair JSONL + eval head")
    pr.add_argument("--input", required=True)
    pr.add_argument("--output", required=True)
    pr.add_argument("--eval_samples", type=int, default=10)
    pr.set_defaults(fn=cmd_prepro)

    sc = sub.add_parser("scrape", help="collect metric curves from checkpoint dirs")
    sc.add_argument("--base_dir", required=True)
    sc.add_argument("--output", default=None)
    sc.set_defaults(fn=cmd_scrape)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
