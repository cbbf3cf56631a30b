"""The port stands alone: importing every module of bitdistiller_tpu_torch and
chip_smoke.py loads neither jax nor the JAX package, and the HF checkpoint
path runs with jax, the JAX package, safetensors, ml_dtypes and transformers
all blocked."""

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
            "train.trainer", "train.data", "train.memory", "train.pipeline"):
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


def test_no_module_imports_them_but_the_lazy_tokenizer():
    """A grep of every import line in the port and chip_smoke.py: the only
    one of jax, the JAX package, safetensors, ml_dtypes or transformers is
    run_training's tokenizer import, made only when no tokenizer is given."""
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|bitdistiller_tpu|safetensors|"
                         r"ml_dtypes|transformers)\b")
    found = []
    for path in sorted((ROOT / "bitdistiller_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            if pattern.match(line):
                found.append((path.relative_to(ROOT).as_posix(), line.strip()))
    assert found == [("bitdistiller_tpu_torch/train/pipeline.py",
                      "from transformers import AutoTokenizer")], found
