"""The port stands alone: importing every module of bitdistiller_tpu_torch and
chip_smoke.py loads neither jax nor the JAX package."""

import os
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
