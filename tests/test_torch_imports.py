"""The port stands alone: importing every module of bitdistiller_tpu_torch and
chip_smoke.py loads neither jax nor the JAX package, the HF checkpoint path
runs with jax, the JAX package, safetensors, ml_dtypes and transformers all
blocked, and so do AutoClip (its calibration blocks, search and cache),
teacher generation, the CLI's `ppl --tokens_file`, the eval modules, the
method check and the serving path (the engine's speculation, prompt cache
and growth, the HTTP frontend under the load tester, the packed
checkpoint, the CLI's `pack` and the capacity planner) with `datasets`
blocked too. The tensor- and pipeline-parallel modules (`parallel.tensor`,
`parallel.overlap`, `parallel.pipeline`, `scripts.dryrun_multichip`) are
among those imported."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHECK = """
import importlib, pkgutil, sys
import bitdistiller_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bitdistiller_tpu_torch.__path__, "bitdistiller_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "bitdistiller_tpu" or m.startswith("bitdistiller_tpu."))
print(len(names), bad)
assert len(names) >= 12, names
for new in ("experimental.fused_mlp", "experimental.flash_decode", "scripts.bw_probe",
            "ops.train_attention", "quant.core", "quant.autoclip", "train.losses",
            "train.trainer", "train.data", "train.memory", "train.pipeline",
            "data.offline", "data.calib", "generation.datasets", "generation.teacher",
            "eval", "eval.ppl", "eval.tasks", "eval.gsm8k", "eval.humaneval", "eval.reasoning",
            "cli", "scripts.method_demo", "serve.capacity", "serve.server", "utils",
            "utils.prompts", "scripts.loadtest", "quant.native", "scripts.pack_timing",
            "parallel", "parallel.distributed", "parallel.mesh", "parallel.zero",
            "parallel.tensor", "scripts.dryrun_multichip", "parallel.overlap",
            "parallel.pipeline",
            "utils.debug", "utils.profiling"):
    assert "bitdistiller_tpu_torch." + new in names, names
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# The card's machine has no safetensors, ml_dtypes or transformers: the
# checkpoint path (load, train, save, reload, GPTQ export) must run without
# them, and without the JAX package.
_BLOCKED_RUN = """
import importlib, importlib.abc, json, pkgutil, sys, tempfile, types
from pathlib import Path

BLOCK = {"jax", "jaxlib", "bitdistiller_tpu", "safetensors", "ml_dtypes", "transformers"}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(name + " is blocked")
        return None


sys.meta_path.insert(0, Block())
import torch
import bitdistiller_tpu_torch
for m in pkgutil.walk_packages(bitdistiller_tpu_torch.__path__, "bitdistiller_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from bitdistiller_tpu_torch.models import TINY_TEST, init_params, pack_model, safetensors_io
from bitdistiller_tpu_torch.models.gptq_export import export_gptq, unpack_gptq_qweight
from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint, save_hf_checkpoint
from bitdistiller_tpu_torch.quant.packing import unpack_codes
from bitdistiller_tpu_torch.train.pipeline import run_training
from bitdistiller_tpu_torch.train.trainer import master_params, tree_items


class Tok:
    eos_token, eos_token_id, pad_token, pad_token_id = "</s>", 2, "</s>", 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s][:48]


d = Path(tempfile.mkdtemp())
save_hf_checkpoint(init_params(TINY_TEST, seed=0, device="cpu"), TINY_TEST, str(d / "src"))
with open(d / "data.jsonl", "w") as f:
    for i in range(8):
        f.write(json.dumps([[f"prompt {i} " * 3, f"reply {i}"]]) + "\\n")
args = types.SimpleNamespace(
    model_name_or_path=str(d / "src"), data_path=str(d / "data.jsonl"), output_dir=str(d / "out"),
    bits=2, q_group_size=64, quant_type="int2-asym", clip=None, train_kd=True,
    kd_loss_type="cakld", cakld_steps=1, learning_rate=1e-4, num_train_epochs=1,
    per_device_train_batch_size=2, gradient_accumulation_steps=2, model_max_length=48,
    max_train_samples=None, lr_scheduler_type="constant", warmup_ratio=0.0, save_steps=0,
    eval_steps=0, logging_steps=1, seed=0, dp=None, tp=1, resume=False,
    param_dtype="bfloat16", device="cpu")
try:
    run_training(args)
    raise SystemExit("run_training without a tokenizer did not import transformers")
except ImportError as e:
    assert "transformers is blocked" in str(e), e
summary = run_training(args, tokenizer=Tok())
master = dict(tree_items(master_params(summary["state"])))
back, cfg = load_hf_checkpoint(str(d / "out"), dtype=torch.float32, device="cpu")
back_leaves = dict(tree_items(back))
assert sorted(back_leaves) == sorted(master)
assert all(torch.equal(t, master[p]) for p, t in back_leaves.items())
packed = pack_model(back, cfg, bits=2, group_size=64)
export_gptq(packed, cfg, str(d / "gptq"))
out = safetensors_io.read(str(d / "gptq" / "model.safetensors"))
qkv = packed["layers"]["qkv"]
codes = unpack_codes(qkv.qweight[0], 2, 64)[:, : cfg.q_size]
assert torch.equal(unpack_gptq_qweight(out["model.layers.0.self_attn.q_proj.qweight"], 2), codes)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
assert not bad, bad
print("ok", summary["steps"])
"""


def test_checkpoint_path_runs_with_those_modules_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok 4" in res.stdout, res.stdout + res.stderr


# Stages 1 and 2 of the method on a tiny CPU model, with `datasets` blocked
# as well: calibration blocks from a text file, the clip search, the cache
# file, and teacher generation on an injected dense model.
_STAGES_BLOCKED = """
import importlib.abc, json, sys, tempfile, types
from pathlib import Path

BLOCK = {"jax", "jaxlib", "bitdistiller_tpu", "safetensors", "ml_dtypes", "transformers",
         "datasets"}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(name + " is blocked")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
from bitdistiller_tpu_torch.data.calib import get_calib_dataset
from bitdistiller_tpu_torch.generation.teacher import run_teacher_generation
from bitdistiller_tpu_torch.models import TINY_TEST, init_params
from bitdistiller_tpu_torch.quant.autoclip import load_clip_cache, run_autoclip, save_clip_cache


class Tok:
    eos_token, eos_token_id, pad_token, pad_token_id = "</s>", 2, "</s>", 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


d = Path(tempfile.mkdtemp())
(d / "calib.txt").write_text("the quick brown fox jumps over the lazy dog " * 20)
blocks = get_calib_dataset("text", Tok(), n_samples=4, block_size=64,
                           data_path=str(d / "calib.txt"))
params = init_params(TINY_TEST, seed=0, device="cpu")
res = run_autoclip(params, TINY_TEST, np.concatenate(blocks), group_size=64, n_sample_token=64)
save_clip_cache(str(d / "clip.npz"), res["clip"])
assert sorted(load_clip_cache(str(d / "clip.npz"))) == [0, 1]
with open(d / "prompts.jsonl", "w") as f:
    for i in range(3):
        f.write(json.dumps([[f"prompt {i}", "reply"]]) + "\\n")
args = types.SimpleNamespace(
    base_model="unused", dataset_name="json", data_path=str(d / "prompts.jsonl"),
    out_path=str(d / "teacher.jsonl"), max_sample=10, max_new_tokens=4, temperature=0.7,
    top_p=1.0, max_batch=2, max_seq_len=64, seed=0, device="cpu")
try:
    run_teacher_generation(args, model=(res["params"], TINY_TEST))
    raise SystemExit("generation without a tokenizer did not import transformers")
except ImportError as e:
    assert "transformers is blocked" in str(e), e
out = run_teacher_generation(args, tokenizer=Tok(), model=(params, TINY_TEST))
lines = [json.loads(x) for x in open(out)]
assert [x[0][0] for x in lines] == ["prompt 0", "prompt 1", "prompt 2"], lines
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
assert not bad, bad
print("ok", len(blocks), len(lines))
"""


def test_autoclip_and_generation_run_with_those_modules_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _STAGES_BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok 4 3" in res.stdout, res.stdout + res.stderr


def test_no_module_imports_them_but_the_lazy_tokenizer():
    """A grep of every import line in the port and chip_smoke.py: the only
    ones of jax, the JAX package, safetensors, ml_dtypes, transformers or
    datasets are the tokenizer imports of run_training and
    run_teacher_generation, made only when no tokenizer is given, the CLI's
    `_load_tokenizer`, made only by the subcommands that tokenize, the
    offline redirect's `datasets`, made only inside `load_dataset`, and
    `scripts/prepare_datasets.py`'s, made only by its `export`."""
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|bitdistiller_tpu|safetensors|"
                         r"ml_dtypes|transformers|datasets)\b")
    found = []
    for path in sorted((ROOT / "bitdistiller_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            if pattern.match(line):
                found.append((path.relative_to(ROOT).as_posix(), line.strip()))
    assert found == [("bitdistiller_tpu_torch/cli.py", "from transformers import AutoTokenizer"),
                     ("bitdistiller_tpu_torch/data/offline.py", "import datasets"),
                     ("bitdistiller_tpu_torch/data/offline.py", "import datasets"),
                     ("bitdistiller_tpu_torch/generation/teacher.py",
                      "from transformers import AutoTokenizer"),
                     ("bitdistiller_tpu_torch/scripts/prepare_datasets.py",
                      "from datasets import load_dataset"),
                     ("bitdistiller_tpu_torch/train/pipeline.py",
                      "from transformers import AutoTokenizer")], found


# Stage 4 and the method check with the same modules blocked: the CLI's
# `ppl --tokens_file` (no tokenizer), a perplexity, the task harness on a
# byte tokenizer, the generative scoring and a few steps of method_demo; the
# CLI's tokenizing subcommands reach for transformers and raise.
_EVAL_BLOCKED = """
import importlib.abc, io, json, contextlib, sys, tempfile, types
from pathlib import Path

BLOCK = {"jax", "jaxlib", "bitdistiller_tpu", "safetensors", "ml_dtypes", "transformers",
         "datasets"}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(name + " is blocked")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)  # tiny shapes; the suite runs several workers
from bitdistiller_tpu_torch import cli
from bitdistiller_tpu_torch.eval import (LogLikelihoodFn, MCDoc, evaluate_task, grade,
                                         perplexity, postprocess_completion, prepare_blocks)
from bitdistiller_tpu_torch.models import TINY_TEST, init_params
from bitdistiller_tpu_torch.models.hf_import import save_hf_checkpoint
from bitdistiller_tpu_torch.scripts import method_demo


class Tok:
    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]


d = Path(tempfile.mkdtemp())
params = init_params(TINY_TEST, seed=0, device="cpu")
save_hf_checkpoint(params, TINY_TEST, str(d / "m"))
np.save(d / "t.npy", np.arange(256, dtype=np.int32) % 200)
out = io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    cli.main(["ppl", "--model_path", str(d / "m"), "--tokens_file", str(d / "t.npy"),
              "--seqlen", "64", "--device", "cpu"])
assert out.getvalue().strip().startswith("ppl: "), out.getvalue()
try:
    cli.main(["ppl", "--model_path", str(d / "m"), "--seqlen", "64", "--device", "cpu"])
    raise SystemExit("ppl without --tokens_file did not import transformers")
except ImportError as e:
    assert "transformers is blocked" in str(e), e
ppl = perplexity(params, TINY_TEST, prepare_blocks(np.arange(128) % 200, 32), device="cpu")
fn = LogLikelihoodFn(params, TINY_TEST, Tok(), max_len=64, device="cpu")
res = evaluate_task(fn, [MCDoc("the sky is", [" blue", " green"], 0)])
assert res["n"] == 1 and np.isfinite(ppl)
assert grade(["#### 3"], ["#### 3"])["accuracy"] == 1.0
assert postprocess_completion("```python\\nx = 1\\n```") == "x = 1\\n"
with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
    method_demo.main(["--device", "cpu", "--layers", "1", "--teacher-steps", "2",
                      "--qat-steps", "1", "--gen-samples", "2", "--gen-tokens", "2",
                      "--eval-blocks", "2", "--batch", "2", "--qat-batch", "2",
                      "--out", str(d / "demo.md")])
assert "| int2-g64 |" in (d / "demo.md").read_text()
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
assert not bad, bad
print("ok")
"""


def test_eval_cli_and_method_demo_run_with_those_modules_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _EVAL_BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stdout + res.stderr


# The serving path with the same modules blocked: the engine's options, the
# HTTP frontend under the port's load tester, the packed checkpoint both
# ways, the CLI's `pack` (the native packer) and the capacity planner.
_SERVE_BLOCKED = """
import contextlib, importlib.abc, io, json, sys, tempfile, threading
from pathlib import Path

BLOCK = {"jax", "jaxlib", "bitdistiller_tpu", "safetensors", "ml_dtypes", "transformers",
         "datasets"}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(name + " is blocked")
        return None


sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from bitdistiller_tpu_torch import cli
from bitdistiller_tpu_torch.models import (TINY_TEST, init_params, load_packed_checkpoint,
                                           pack_model, save_packed_checkpoint)
from bitdistiller_tpu_torch.models.hf_import import save_hf_checkpoint
from bitdistiller_tpu_torch.scripts.loadtest import run_load
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.serve.capacity import serve_capacity
from bitdistiller_tpu_torch.serve.server import ServingFrontend


class Tok:
    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


d = Path(tempfile.mkdtemp())
dense = init_params(TINY_TEST, seed=0, device="cpu")
save_hf_checkpoint(dense, TINY_TEST, str(d / "m"))
with contextlib.redirect_stdout(io.StringIO()):
    cli.main(["pack", "--model_path", str(d / "m"), "--output", str(d / "p"), "--device", "cpu"])
params, cfg = load_packed_checkpoint(str(d / "p"), device="cpu")
save_packed_checkpoint(str(d / "p2"), params, cfg, bits=2, group_size=128)
eng = Engine(params, cfg, max_slots=2, max_len=128, eos_token_id=None, device="cpu",
             sampling=SamplingParams(temperature=0.0), spec_decode=True, prompt_cache_size=2)
r = Request(prompt_tokens=[5, 6, 7] * 4, max_new_tokens=12, cache_prompt=True)
eng.run([r])
assert len(r.output_tokens) == 12 and eng.growths == [] and eng._cache_len() == 64
front = ServingFrontend(Engine(params, cfg, max_slots=2, max_len=64, eos_token_id=None,
                               device="cpu"), Tok(), port=0)
host, port = front.address
box = {}


def client():
    try:
        box["s"] = run_load([f"http://{host}:{port}/generate", f"http://{host}:{port}/health"],
                            [{"prompt": "hi", "max_new_tokens": 3}, None], 2, timeout=30)
    finally:
        front.shutdown()


t = threading.Thread(target=client)
t.start()
front.serve_forever()
t.join(timeout=30)
assert box["s"]["ok"] == 2, box
assert serve_capacity(cfg, hbm_bytes=1 << 30)["max_slots"] > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
assert not bad, bad
print("ok")
"""


def test_serving_path_runs_with_those_modules_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _SERVE_BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stdout + res.stderr
