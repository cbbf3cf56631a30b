"""The port's scripts that had no counterpart (A14), on the CPU:
`scripts/prepare_datasets.py`'s subcommands writing byte-equal files to the
JAX package's script (run by path) on the same inputs (`export` through a
stand-in `datasets` module: nothing is downloaded); the job generator's
four checks of tests/test_job_generator.py, its commands parsed by the
port's own CLI parser; and every `cli` command of `train_7b_int2.sh`
parsed by that parser."""

import json
import os
import re
import shlex
import subprocess
import sys
import types
from pathlib import Path

import pytest

from bitdistiller_tpu_torch.cli import build_parser
from bitdistiller_tpu_torch.scripts import generate_gpu_jobs as jobs
from bitdistiller_tpu_torch.scripts import prepare_datasets as prep

ROOT = Path(__file__).resolve().parents[1]
JAX_PREP = ROOT / "scripts" / "prepare_datasets.py"
CLI = "python -m bitdistiller_tpu_torch.cli"


def _jax_prep(*argv):
    res = subprocess.run([sys.executable, str(JAX_PREP), *argv], capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_prepro_byte_equal_to_jax(tmp_path):
    src = tmp_path / "raw.jsonl"
    with open(src, "w") as f:
        for i in range(15):
            f.write(json.dumps({"input": f"q{i} é", "text": f"a{i}\n\"x\""}) + "\n")
        f.write("\n")
    _jax_prep("prepro", "--input", str(src), "--output", str(tmp_path / "jax.jsonl"),
              "--eval_samples", "10")
    prep.main(["prepro", "--input", str(src), "--output", str(tmp_path / "port.jsonl"),
               "--eval_samples", "10"])
    port = (tmp_path / "port.jsonl").read_bytes()
    assert port == (tmp_path / "jax.jsonl").read_bytes()
    assert len(port.splitlines()) == 25


def test_scrape_byte_equal_to_jax(tmp_path):
    base = tmp_path / "runs"
    for step, acc in ((100, 0.41), (200, 0.44), (50, 0.3)):
        d = base / f"checkpoint-{step}" / "sub"
        os.makedirs(d)
        (d / "MMLU.log").write_text(f"... {{'mmlu-acc': {acc}}} ppl = 7.5 done\n")
        with open(d.parent / "eval.json", "w") as f:
            json.dump({"accuracy": 0.3 + step / 1000, "arc-acc_norm": 0.25}, f)
    os.makedirs(base / "not-a-checkpoint")
    _jax_prep("scrape", "--base_dir", str(base), "--output", str(tmp_path / "jax.csv"))
    prep.main(["scrape", "--base_dir", str(base), "--output", str(tmp_path / "port.csv")])
    port = (tmp_path / "port.csv").read_bytes()
    assert port == (tmp_path / "jax.csv").read_bytes()
    assert port.splitlines()[0] == b"step,accuracy,arc-acc_norm,mmlu-acc,ppl"


def test_export_byte_equal_to_jax(tmp_path, monkeypatch):
    """Both scripts' `export` over one stand-in `datasets` module (blocks of
    2, a char limit, a row limit): the same block files, byte for byte."""
    rows = [{"problem": f"p{i}" * (i + 1), "solution": f"s{i}"} for i in range(9)]
    fake = types.ModuleType("datasets")
    fake.load_dataset = lambda repo, *a, split=None: iter(rows)
    monkeypatch.setitem(sys.modules, "datasets", fake)
    sys.path.insert(0, str(JAX_PREP.parent))
    try:
        import prepare_datasets as jax_prep  # the JAX package's script, by path
    finally:
        sys.path.remove(str(JAX_PREP.parent))
    argv = ["export", "--preset", "openr1-math", "--name", "m", "--block_size", "2",
            "--max_chars", "14", "--limit", "5"]
    jax_prep.main(argv + ["--out_dir", str(tmp_path / "jax")])
    prep.main(argv + ["--out_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


class _Args:
    def __init__(self, out_dir):
        self.checkpoints = ["/ckpts/TinyLlama_1.1B", "/ckpts/llama-2-7b"]
        self.modes = sorted(jobs.MODES)
        self.out_dir = out_dir
        self.artifact_dir = "/artifacts"
        self.data_path = "/data/teacher.jsonl"
        self.bits = 2
        self.group_size = 128
        self.quant_type = "int2-asym"
        self.image = "bitdistiller-tpu:latest"
        self.accelerator = "nvidia-h100-80gb"
        self.num_hosts = 2
        self.gpus_per_host = 8


def test_generates_one_yaml_per_checkpoint_mode(tmp_path):
    args = _Args(str(tmp_path))
    paths = jobs.generate(args)
    assert len(paths) == len(args.checkpoints) * len(args.modes)
    assert all(os.path.exists(p) for p in paths)
    assert set(jobs.MODES) == {"train", "autoclip", "eval_tasks", "eval_gsm8k", "ppl", "serve"}


def test_yaml_is_well_formed_and_sized(tmp_path):
    """One node and one card a single-rank job; `train` on every card of
    num_hosts nodes, with the rendezvous `init_distributed` reads."""
    yaml = pytest.importorskip("yaml")
    args = _Args(str(tmp_path))
    for p in jobs.generate(args):
        doc = yaml.safe_load(open(p))
        assert doc["kind"] == "JobSet"
        job = doc["spec"]["replicatedJobs"][0]
        mode = os.path.basename(p).rsplit("_", 1)[0]
        multi = mode == "train"
        assert job["replicas"] == (args.num_hosts if multi else 1)
        pod = job["template"]["spec"]["template"]["spec"]
        main = pod["containers"][0]
        assert main["resources"]["limits"]["nvidia.com/gpu"] == (args.gpus_per_host if multi
                                                                 else 1)
        assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == args.accelerator
        assert re.fullmatch(r"[a-z0-9]([a-z0-9-]{0,51})", doc["metadata"]["name"])
        env = {e["name"]: e.get("value", e.get("valueFrom")) for e in main.get("env", [])}
        if multi:
            assert env["WORLD_SIZE"] == str(args.num_hosts * args.gpus_per_host)
            assert env["LOCAL_WORLD_SIZE"] == str(args.gpus_per_host)
            assert env["MASTER_ADDR"].startswith(doc["metadata"]["name"] + "-workers-0-0.")
            assert env["MASTER_PORT"].isdigit() and "fieldRef" in env["NODE_RANK"]
            script = main["args"][0]
            assert "export LOCAL_RANK RANK=" in script and script.rstrip().endswith("wait")
        else:
            assert not env


def test_embedded_commands_parse_against_the_port_cli(tmp_path):
    parser = build_parser()
    args = _Args(str(tmp_path))
    checked = 0
    for p in jobs.generate(args):
        for line in open(p).read().splitlines():
            line = line.strip().removesuffix("&").strip()
            if line.startswith(CLI):
                argv = shlex.split(line)[3:]
                assert parser.parse_args(argv).cmd == argv[0]  # SystemExit(2) on drift
                checked += 1
    assert checked == len(args.checkpoints) * len(args.modes)


def test_job_generator_entrypoint_runs(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "bitdistiller_tpu_torch.scripts.generate_gpu_jobs",
         "--checkpoints", "/ckpts/m", "--modes", "ppl", "--out_dir", str(tmp_path / "jobs")],
        capture_output=True, text=True, timeout=60, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "jobs" / "ppl_m.yaml").exists()


def test_train_7b_script_commands_parse_against_the_port_cli():
    """Every `cli` command of the 7B pipeline script, its continuations
    joined and its shell variables given values, parses; the stages are the
    JAX script's, in its order."""
    text = (ROOT / "bitdistiller_tpu_torch" / "scripts" / "train_7b_int2.sh").read_text()
    text = text.replace("\\\n", " ")
    values = {"MODEL": "/ckpts/llama-2-7b", "OUT": "/artifacts/out", "BITS": "2", "GROUP": "128"}
    parser = build_parser()
    cmds = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith(CLI):
            continue
        line = re.sub(r"\$\{?(\w+)\}?", lambda m: values[m.group(1)], line)
        argv = shlex.split(line)[3:]
        ns = parser.parse_args(argv)
        cmds.append(ns.cmd)
        if ns.cmd == "train":
            assert (ns.bits, ns.q_group_size, ns.kd_loss_type) == (2, 128, "cakld")
    assert cmds == ["autoclip", "generate", "train", "ppl", "pack"]
    jax_cmds = re.findall(r"python -m bitdistiller_tpu\.cli (\w+)",
                          (ROOT / "scripts" / "train_7b_int2.sh").read_text())
    assert cmds == jax_cmds
