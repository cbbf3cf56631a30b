"""The port's CLI eval subcommands (`python -m bitdistiller_tpu_torch.cli`)
against the JAX package's CLI on one checkpoint: a TINY_TEST written by the
JAX package's HF save, with the BPE tokenizer of
tests/test_offline_fixtures.py, hub data from the fixtures. Both CLIs load
the weights in bf16 (the default) and compute in the config's bf16, so the
printed perplexities agree within PPL_TOL relative (bf16 activations rounded
after f32 sums in another order, XLA's against PyTorch's); the `eval` JSON's
acc, acc_norm and n are equal."""

import argparse
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu import cli as jcli
from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.hf_import import save_hf_checkpoint
from bitdistiller_tpu_torch import cli as tcli

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
PPL_TOL = 5e-3
EVAL_SUBCOMMANDS = {"ppl", "eval", "gsm8k", "humaneval", "reasoning"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes and loops of small ops: one intra-op thread (the suite
    runs several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _data_dir(monkeypatch):
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_cli")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    corpus = [
        "the answer is 42 #### 42 question choices license software "
        "copyright permission the answer is A B C D mod compute " * 5
    ] * 40
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(
        corpus,
        trainers.BpeTrainer(vocab_size=200, special_tokens=["<unk>", "<s>", "</s>"]),
    )
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>", pad_token="</s>",
    )
    fast.save_pretrained(str(path))
    params = init_params(TINY_TEST, jax.random.key(0), dtype=jnp.float32)
    save_hf_checkpoint(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params),
                       TINY_TEST, str(path))
    tokens = np.random.default_rng(0).integers(0, TINY_TEST.vocab_size, 64 * 5)
    np.save(path / "tokens.npy", tokens.astype(np.int32))
    return path


def _ppl_line(out: str) -> float:
    return float([ln for ln in out.splitlines() if ln.startswith("ppl:")][-1].split()[1])


def _both(argv, capsys):
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    return got, want


@pytest.mark.parametrize("extra", [[], ["--quant_type", "int", "--w_bit", "2",
                                         "--q_group_size", "64"],
                                    ["--quant_type", "nf3", "--q_group_size", "64"]],
                         ids=["bf16", "ptq_int2_g64", "ptq_nf3_g64"])
def test_ppl_tokens_file_prints_jax_number(model_dir, capsys, extra):
    argv = ["ppl", "--model_path", str(model_dir), "--tokens_file",
            str(model_dir / "tokens.npy"), "--seqlen", "64", "--batch_size", "2"] + extra
    got, want = _both(argv, capsys)
    assert got.rstrip().splitlines()[-1].startswith("ppl: ")
    np.testing.assert_allclose(_ppl_line(got), _ppl_line(want), rtol=PPL_TOL)


def test_ppl_wikitext_through_the_tokenizer_prints_jax_number(model_dir, capsys):
    """Without --tokens_file: the wikitext fixture's test text through the
    checkpoint's tokenizer (`load_wikitext2_test`)."""
    argv = ["ppl", "--model_path", str(model_dir), "--seqlen", "128", "--batch_size", "64"]
    got, want = _both(argv, capsys)
    np.testing.assert_allclose(_ppl_line(got), _ppl_line(want), rtol=PPL_TOL)


def test_c4_ppl_dtype_float32_computes_in_the_config_dtype_as_jax(model_dir, capsys):
    """C4, matched: `--dtype float32` loads f32 weights, but both CLIs compute
    in the config's dtype, which `from_pretrained` leaves at bfloat16: the
    port's number is the in-process perplexity of the f32 tree under the bf16
    config, JAX's within PPL_TOL, and off the f32 config's."""
    from bitdistiller_tpu_torch.eval.ppl import perplexity, prepare_blocks
    from bitdistiller_tpu_torch.models.hf_import import load_hf_checkpoint

    argv = ["ppl", "--model_path", str(model_dir), "--tokens_file",
            str(model_dir / "tokens.npy"), "--seqlen", "64", "--batch_size", "5",
            "--dtype", "float32"]
    got, want = _both(argv, capsys)
    params, cfg = load_hf_checkpoint(str(model_dir), dtype=torch.float32, device="cpu")
    assert cfg.dtype == "bfloat16" and params["embed"].dtype == torch.float32
    blocks = prepare_blocks(np.load(model_dir / "tokens.npy"), 64)
    bf16 = perplexity(params, cfg, blocks, batch_size=5, device="cpu")
    f32 = perplexity(params, cfg.__class__(**dict(cfg.__dict__, dtype="float32")), blocks,
                     batch_size=5, device="cpu")
    assert _ppl_line(got) == float(f"{bf16:.4f}")
    np.testing.assert_allclose(_ppl_line(got), _ppl_line(want), rtol=PPL_TOL)
    assert abs(f32 - bf16) > 1e-4 * f32


def test_eval_arc_challenge_prints_jax_json(model_dir, capsys):
    argv = ["eval", "--model_path", str(model_dir), "--tasks", "arc_challenge",
            "--batch_size", "4"]
    got, want = _both(argv, capsys)
    assert json.loads(got) == json.loads(want)
    assert json.loads(got)["arc_challenge"]["n"] == 20


def test_eval_mmlu_subject_and_quantizer_print_jax_json(model_dir, capsys):
    argv = ["eval", "--model_path", str(model_dir), "--tasks",
            "hendrycksTest-abstract_algebra", "--num_fewshot", "2", "--batch_size", "8",
            "--quant_type", "int", "--w_bit", "2", "--q_group_size", "64", "--limit", "10"]
    got, want = _both(argv, capsys)
    assert json.loads(got) == json.loads(want)
    assert set(json.loads(got)) == {"hendrycksTest-abstract_algebra", "mmlu-acc"}


@pytest.mark.parametrize("cmd,data,extra,keys", [
    ("gsm8k", "gsm8k_test200.jsonl", [], {"accuracy", "n"}),
    ("humaneval", "humaneval_mini.jsonl", [], {"pass@1"}),
    ("reasoning", "gsm8k_test200.jsonl", ["--task", "math500"],
     {"task", "accuracy", "n", "n_samples"})])
def test_generative_subcommands_print_jax_keys(model_dir, capsys, cmd, data, extra, keys,
                                               tmp_path):
    """Sampled at the CLI's temperatures (the two packages' generators differ):
    the printed keys and counts are JAX's."""
    if cmd == "reasoning":
        rows = [{"problem": json.loads(x)["query"], "answer": "1"}
                for x in list(open(FIXTURES / data))[:2]]
        (tmp_path / "r.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        path = str(tmp_path / "r.jsonl")
    else:
        path = str(FIXTURES / data)
    argv = [cmd, "--model_path", str(model_dir), "--data_path", path, "--max_new_tokens", "4",
            "--max_batch", "2", "--limit", "2"] + extra
    got, want = _both(argv, capsys)
    g, w = json.loads(got.strip().splitlines()[-1]), json.loads(want.strip().splitlines()[-1])
    assert set(g) == set(w) == keys
    assert g.get("n") == w.get("n")


def _flags(parser: argparse.ArgumentParser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {(tuple(a.option_strings), a.dest, a.default, a.type, tuple(a.choices or ()))
                   for a in p._actions if a.option_strings and a.dest != "help"}
            for name, p in sub.choices.items()}


def test_parser_holds_jax_eval_flags_and_only_the_eval_subcommands():
    """The same flags as JAX's for the five eval subcommands, plus --device
    (default cuda) and, on `eval`, --spec_decode (JAX's has it on gsm8k,
    humaneval and reasoning only); the other subcommands are the serving
    ones (tests/test_torch_cli_serve.py holds their flags) and the method's
    stages (tests/test_torch_cli_method.py); JAX's `bench` alone is absent."""
    got, want = _flags(tcli.build_parser()), _flags(jcli.build_parser())
    assert set(got) == EVAL_SUBCOMMANDS | {"pack", "serve", "chat", "autoclip", "generate",
                                           "train", "export_gptq", "mix_data"}
    assert set(want) - set(got) == {"bench"}
    device = (("--device",), "device", "cuda", None, ())
    spec = (("--spec_decode",), "spec_decode", False, None, ())
    for name in EVAL_SUBCOMMANDS:
        assert got[name] == want[name] | {device} | ({spec} if name == "eval" else set()), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card default")
def test_default_device_is_the_card_and_raises_without_one(model_dir):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["ppl", "--model_path", str(model_dir), "--tokens_file",
                   str(model_dir / "tokens.npy"), "--seqlen", "64"])


def test_module_entry_point_runs(model_dir):
    """`python -m bitdistiller_tpu_torch.cli ppl --tokens_file ... --device cpu`
    in a child process."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "bitdistiller_tpu_torch.cli", "ppl", "--model_path",
         str(model_dir), "--tokens_file", str(model_dir / "tokens.npy"), "--seqlen", "64",
         "--device", "cpu"], cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert np.isfinite(_ppl_line(res.stdout)) and "5/5" in res.stderr
