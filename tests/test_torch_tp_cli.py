"""The tensor-parallel entry points a user calls, on 2 spawned gloo ranks:

- `cli train --tp 2` (each rank joins from its `--coordinator_address`,
  `--num_processes`, `--process_id` flags, as torchrun's ranks would) on a
  tiny HF Llama checkpoint (tests/hf_checkpoints.py, f32 loads), with a
  checkpoint every 2 micro-steps: its final loss, beta and final master
  against `cli train` in one process on the same flags, every rank's
  summary equal, and the checkpoints' manifest and parts at tp = 2. The
  checkpoint's config computes in bf16 (the HF import's dtype; f32
  latents), where any other summation order moves a run: on the tiny f32
  config switched to bf16 compute, dp = 2 alone lies 2.8e-3 to 4.6e-3 from
  one process in loss and 0.042 to 0.048 in the master's update gap, tp = 2
  1.8e-3 to 4.7e-3 and 0.089 to 0.107 (measured; tests/test_torch_tp_train.py
  holds tp's arithmetic in f32 compute, within 1e-7). Bounds here: the loss
  within 1e-2 relative, the update gap within 0.2, beta (the teacher's mean
  top probability over bf16 logits) within 1e-2 relative; measured 7.0e-4,
  0.080 and 3.6e-3;
- the dry run (`python -m bitdistiller_tpu_torch.scripts.dryrun_multichip
  --world 2 --device cpu`), its own entry point, to its summary."""

import json
import os
import subprocess
import sys

import torch

from bitdistiller_tpu_torch import cli as tcli
from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint
from bitdistiller_tpu_torch.train import trainer as ttr
from hf_checkpoints import build
from test_torch_dp_train import _update_gap
from test_torch_dp_worker import spawn
from torch_tp_worker import SmallTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(hf_dir, tmp_path, out):
    data = tmp_path / "data.jsonl"
    with open(data, "w") as f:
        for i in range(8):
            f.write(json.dumps([[f"prompt {i} " * 3, f"reply {i}"]]) + "\n")
    return ["train", "--model_name_or_path", hf_dir, "--data_path", str(data), "--output_dir",
            str(tmp_path / out), "--q_group_size", "32", "--cakld_steps", "1",
            "--learning_rate", "1e-4", "--gradient_accumulation_steps", "2",
            "--model_max_length", "48", "--save_steps", "2", "--eval_steps", "0", "--seed", "0",
            "--param_dtype", "float32", "--device", "cpu"]


def test_cli_train_tp2_equals_one_process(tmp_path, monkeypatch):
    hf_dir = build("llama_tied", str(tmp_path / "hf"))
    ranks = spawn({"kind": "call", "target": "torch_tp_worker:cli_train_job", "joins": True,
                   "argv": _argv(hf_dir, tmp_path, "tp2") + ["--tp", "2"]})
    monkeypatch.setattr(tcli, "_load_tokenizer", lambda path: SmallTok())
    one = tcli.main(_argv(hf_dir, tmp_path, "one"))
    assert ranks[0]["steps"] == ranks[1]["steps"] == one["steps"] == 4
    for r in ranks:
        assert r["final_loss"] == ranks[0]["final_loss"] and r["beta"] == ranks[0]["beta"]
        assert abs(r["final_loss"] - one["final_loss"]) <= 1e-2 * abs(one["final_loss"])
        assert abs(r["beta"] - one["beta"]) <= 1e-2 * abs(one["beta"])
    want = {"/".join(p): x for p, x in ttr.tree_items(one["master"])}
    assert sorted(ranks[0]["master"]) == sorted(want)
    for k in want:
        assert torch.equal(ranks[0]["master"][k], ranks[1]["master"][k])
    init, _ = load_hf_checkpoint(hf_dir, dtype=torch.float32, device="cpu")
    init = {"/".join(p): x for p, x in ttr.tree_items(init)}
    assert _update_gap(ranks[0]["master"], want, init) <= 0.2
    with open(tmp_path / "tp2" / "step_4" / "manifest.json") as f:
        manifest = json.load(f)
    assert (manifest["dp"], manifest["tp"]) == (1, 2)
    assert sorted(os.listdir(tmp_path / "tp2" / "step_4")) == [
        "manifest.json", "rank0.safetensors", "rank1.safetensors"]


def test_dryrun_multichip_on_two_gloo_ranks(tmp_path):
    out = tmp_path / "dryrun.json"
    proc = subprocess.run(
        [sys.executable, "-m", "bitdistiller_tpu_torch.scripts.dryrun_multichip", "--world", "2",
         "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(out.read_text())
    assert (got["world"], got["dp"], got["tp"]) == (2, 1, 2)
    assert got["logits_shape"] == [2, 1, 256] and got["attn_len_gap"] <= 2e-4
    assert got["run_training_steps"] == 4
    assert got["llama2_7b_zero3_dp8_bytes"] < 80e9
    for line in ("ZeRO-2 opt state has", "ZeRO-3 step ok", "fused-accum cycle ok",
                 "packed int2 TP decode ok", "run_training over dp x tp=2 ok", "7B estimate"):
        assert proc.stdout.count(line) == 2, line  # both ranks
