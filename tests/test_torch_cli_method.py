"""The port's method-stage subcommands (`python -m bitdistiller_tpu_torch.cli
autoclip | generate | train | export_gptq | mix_data`) against the JAX
package's CLI: the parser of each, option by option (flags, dest, default,
type, choices, required, action; `--device` the one addition, default
cuda, on the four that load a model), and each run on the CPU on a tiny HF
checkpoint (tests/hf_checkpoints.py, Llama, vocab 128) with a byte
tokenizer handed to both CLIs through their one tokenizer seam
(`_load_tokenizer`):
- autoclip: the clip cache against JAX's (the same keys, shapes and
  dtypes) and every search the CLIs made: the same weights; inputs apart
  by a few bf16 steps (the capture computes in the checkpoint config's
  bf16, where XLA keeps f32 between operations on the CPU and PyTorch
  rounds each; tests/test_torch_autoclip.py holds the capture and the
  search on f32 inputs within 1e-5, not repeated here); at least 90% of a search's
  clips equal and 97% over all (measured: 98.3%, the AutoClip tests ask
  99% of f32 inputs); and each package's clips no worse than the other's,
  within 1e-5, by the objective on its own inputs. Both CLIs load the
  weights in f32 here (their `_load_model` asked for float32);
- export_gptq: model.safetensors holds JAX's tensors bit for bit and the
  two JSON files are byte-equal. JAX's file is not: it writes its
  transposed tensors' memory in column-major order (ROADMAP C4, pinned in
  tests/test_torch_gptq_export.py); the port writes the values;
- mix_data: the output line-equal to JAX's, and the printed line;
- generate (greedy): the file byte-equal to JAX's `run_teacher_generation`
  on the namespace JAX's parser makes of the same flags (JAX's `generate`
  and `train` load their tokenizer themselves, past the seam);
- train: the final save equal, tensor for tensor, to the port's
  `run_training` on JAX's namespace of the same flags, and the metrics
  JAX's names.
The default device is the card: without one a subcommand raises."""

import argparse
import json
import types

import numpy as np
import pytest
import torch

from bitdistiller_tpu import cli as jcli
from bitdistiller_tpu.generation.teacher import run_teacher_generation as jax_generate
from bitdistiller_tpu_torch import cli as tcli
from bitdistiller_tpu_torch.models import safetensors_io
from bitdistiller_tpu_torch.train.pipeline import run_training
from bitdistiller_tpu.quant import autoclip as jclip
from bitdistiller_tpu_torch.quant import autoclip as tclip
from hf_checkpoints import build
from test_torch_autoclip import REL, _recorded_searches, objective

METHOD = ("autoclip", "generate", "train", "export_gptq", "mix_data")
WITH_DEVICE = ("autoclip", "generate", "train", "export_gptq")
CLIP_SHARE, CLIP_SHARE_ALL = 0.9, 0.97


class SmallTok:
    """A byte tokenizer inside the tiny model's 128 ids (3..122)."""

    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 120) + 3 for c in s][:64]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)

    def __call__(self, s, **kw):
        return types.SimpleNamespace(input_ids=self.encode(s))


@pytest.fixture(autouse=True)
def _tokenizer(monkeypatch):
    for cli in (jcli, tcli):
        monkeypatch.setattr(cli, "_load_tokenizer", lambda path: SmallTok())


def _f32_loads(monkeypatch):
    for cli in (jcli, tcli):
        def f32(path, dtype_str="bfloat16", *a, load=cli._load_model, **kw):
            return load(path, "float32", *a, **kw)

        monkeypatch.setattr(cli, "_load_model", f32)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return build("llama_untied", str(tmp_path_factory.mktemp("hf")))


def _options(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.type,
                            tuple(a.choices or ()), a.required, a.nargs, type(a).__name__)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items() if name in METHOD}


def test_parsers_equal_jax_plus_device():
    got, want = _options(tcli.build_parser()), _options(jcli.build_parser())
    assert sorted(got) == sorted(want) == sorted(METHOD)
    for name in METHOD:
        extra = {k: v for k, v in got[name].items() if k not in want[name]}
        assert {k: got[name][k] for k in want[name]} == want[name], name
        if name in WITH_DEVICE:
            assert extra == {"device": (("--device",), "cuda", None, (), False, None,
                                        "_StoreAction")}, name
        else:
            assert extra == {}, name
    assert got["train"]["zero_stage"][1:4] == (2, int, (0, 2, 3))


def _text(path, n=400):
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "kernel", "tensor", "group", "scale"]
    path.write_text(" ".join(rng.choice(words, size=n)))
    return str(path)


def test_autoclip_cache_equals_jax(hf_dir, tmp_path, monkeypatch):
    _f32_loads(monkeypatch)
    jcalls = _recorded_searches(monkeypatch, jclip)
    tcalls = _recorded_searches(monkeypatch, tclip)
    argv = ["autoclip", "--model_path", hf_dir, "--w_bit", "2", "--q_group_size", "32",
            "--calib_dataset", "text", "--calib_path", _text(tmp_path / "calib.txt"),
            "--n_samples", "2", "--seqlen", "32"]
    jcli.main(argv + ["--dump_clip", str(tmp_path / "jax.npz")])
    tcli.main(argv + ["--dump_clip", str(tmp_path / "port.npz"), "--device", "cpu"])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files) and got.files
    for key in want.files:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
    # every search: the same weights, clips CLIP_SHARE equal, and each package's clips no worse than the other's
    # on its own inputs (where they differ: ties, or the inputs' rounding)
    assert len(tcalls) == len(jcalls) == len(want.files) // 2
    shares = []
    for (jw, jfeat, jclips), (tw, tfeat, tclips) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tw, jw)
        same = (tclips[0] == jclips[0]) & (tclips[1] == jclips[1])
        shares.append(same.mean())
        assert shares[-1] >= CLIP_SHARE
        for feat, mine, other in ((tfeat, tclips, jclips), (jfeat, jclips, tclips)):
            o_mine = objective(tw, feat, *mine, "int", 2, 32)
            o_other = objective(tw, feat, *other, "int", 2, 32)
            assert np.all(o_mine <= o_other * (1 + REL) + 1e-30)
    assert np.mean(shares) >= CLIP_SHARE_ALL


def test_export_gptq_files_equal_jax(hf_dir, tmp_path, capsys, monkeypatch):
    import safetensors.numpy

    seen: dict = {}
    save = safetensors.numpy.save_file

    def capture(tensors, filename, *a, **k):  # JAX's tensors as computed
        seen.update(tensors)
        return save(tensors, filename, *a, **k)

    monkeypatch.setattr(safetensors.numpy, "save_file", capture)
    argv = ["export_gptq", "--model_path", hf_dir, "--w_bit", "2", "--q_group_size", "32"]
    jcli.main(argv + ["--output", str(tmp_path / "jax")])
    want_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "X")
    tcli.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "X") == want_out
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in ("quantize_config.json", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = safetensors_io.read(str(tmp_path / "port" / "model.safetensors"))
    assert sorted(got) == sorted(seen) and seen
    for name, want in seen.items():
        assert str(got[name].dtype).split(".")[1] == str(want.dtype), name
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)


def test_mix_data_equals_jax(tmp_path, capsys):
    for name, n in (("a", 7), ("b", 5)):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            for i in range(n):
                f.write(json.dumps([[f"{name} prompt {i}", f"reply {i}"]]) + "\n")
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    jcli.main(["mix_data", a, b, "--out", str(tmp_path / "jax.jsonl")])
    tcli.main(["mix_data", a, b, "--out", str(tmp_path / "port.jsonl")])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"wrote 12 lines to {tmp_path / 'jax.jsonl'}",
                   f"wrote 12 lines to {tmp_path / 'port.jsonl'}"]
    lines = (tmp_path / "port.jsonl").read_text().splitlines()
    assert lines == (tmp_path / "jax.jsonl").read_text().splitlines()
    assert sorted(lines) == sorted((tmp_path / "a.jsonl").read_text().splitlines()
                                   + (tmp_path / "b.jsonl").read_text().splitlines())


def test_generate_file_equals_jax(hf_dir, tmp_path):
    with open(tmp_path / "prompts.jsonl", "w") as f:
        for i in range(3):
            f.write(json.dumps([[f"question {i} " * (2 + i), "x"]]) + "\n")
    argv = ["generate", "--base_model", hf_dir, "--dataset_name", "json", "--data_path",
            str(tmp_path / "prompts.jsonl"), "--max_new_tokens", "6", "--temperature", "0",
            "--max_batch", "2", "--max_seq_len", "128", "--seed", "1"]
    jargs = jcli.build_parser().parse_args(argv + ["--out_path", str(tmp_path / "jax.jsonl")])
    jax_generate(jargs, tokenizer=SmallTok())
    path = tcli.main(argv + ["--out_path", str(tmp_path / "port.jsonl"), "--device", "cpu"])
    assert path == str(tmp_path / "port.jsonl")
    got = (tmp_path / "port.jsonl").read_bytes()
    assert got == (tmp_path / "jax.jsonl").read_bytes() and len(got.splitlines()) == 3


def _train_argv(hf_dir, tmp_path, out):
    data = tmp_path / "data.jsonl"
    with open(data, "w") as f:
        for i in range(8):
            f.write(json.dumps([[f"prompt {i} " * 3, f"reply {i}"]]) + "\n")
    return ["train", "--model_name_or_path", hf_dir, "--data_path", str(data), "--output_dir",
            str(tmp_path / out), "--q_group_size", "32", "--cakld_steps", "1",
            "--learning_rate", "1e-4", "--gradient_accumulation_steps", "2",
            "--model_max_length", "48", "--save_steps", "0", "--eval_steps", "0", "--seed", "0"]


def test_train_save_equals_run_training(hf_dir, tmp_path):
    """`cli train` (one process: no group) against run_training on the
    namespace the JAX parser makes of the same flags plus device."""
    argv = _train_argv(hf_dir, tmp_path, "cli")
    summary = tcli.main(argv + ["--device", "cpu"])
    args = jcli.build_parser().parse_args(_train_argv(hf_dir, tmp_path, "direct"))
    args.device = "cpu"
    direct = run_training(args, tokenizer=SmallTok())
    assert summary["steps"] == direct["steps"] == 4
    assert summary["final_loss"] == direct["final_loss"]
    got = safetensors_io.read(str(tmp_path / "cli" / "model.safetensors"))
    want = safetensors_io.read(str(tmp_path / "direct" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert (tmp_path / "cli" / "config.json").read_text() == \
        (tmp_path / "direct" / "config.json").read_text()
    metrics = [json.loads(x) for x in open(tmp_path / "cli" / "metrics.jsonl")]
    assert [m["step"] for m in metrics] == [1, 2, 3, 4]
    assert set(metrics[0]) == {"step", "epoch", "loss", "grad_norm", "seconds_per_step"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card default")
def test_default_device_is_the_card(hf_dir, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_train_argv(hf_dir, tmp_path, "x"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["export_gptq", "--model_path", hf_dir, "--output", str(tmp_path / "g")])
