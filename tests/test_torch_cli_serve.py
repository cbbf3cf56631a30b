"""The port's serving subcommands (`python -m bitdistiller_tpu_torch.cli`
`pack`, `chat`, `serve`) and `--spec_decode` on the generative evals, on the
CPU, over one checkpoint: a TINY_TEST written by the JAX package's HF save
with the BPE tokenizer of tests/test_torch_cli_eval.py.

`pack --device cpu` (the native packer) writes the JAX CLI's packed.npz
array for array; `chat` on scripted stdin prints the port engine's greedy
text; `serve` builds the engine and frontend its flags ask for; `gsm8k`
with --spec_decode prints what it prints without, its greedy streams held
to the plain engine's by chip_smoke.py's tie rule."""

import io
import json

import numpy as np
import pytest
import torch

from bitdistiller_tpu import cli as jcli
from bitdistiller_tpu_torch import cli as tcli
from bitdistiller_tpu_torch.models.quantized import load_packed_checkpoint
from bitdistiller_tpu_torch.serve import Engine, Request, SamplingParams
from bitdistiller_tpu_torch.serve.server import ServingFrontend
from bitdistiller_tpu_torch.utils.prompts import render_prompt
from test_torch_cli_eval import FIXTURES, _flags, model_dir  # noqa: F401 (fixture)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _data_dir(monkeypatch):
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))


@pytest.fixture(scope="module")
def packed_dir(model_dir, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("packed")
    tcli.main(["pack", "--model_path", str(model_dir), "--w_bit", "2", "--q_group_size", "64",
               "--output", str(out), "--device", "cpu"])
    return out


def test_pack_writes_the_jax_clis_arrays(model_dir, packed_dir, tmp_path, capsys):  # noqa: F811
    jcli.main(["pack", "--model_path", str(model_dir), "--w_bit", "2", "--q_group_size", "64",
               "--output", str(tmp_path)])
    with np.load(packed_dir / "packed.npz") as a, np.load(tmp_path / "packed.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = json.loads((packed_dir / "quant_config.json").read_text())
    want = json.loads((tmp_path / "quant_config.json").read_text())
    assert all(got["config"][k] == v for k, v in want["config"].items())
    assert "packed checkpoint saved to" in capsys.readouterr().out


def _greedy_engine(packed_dir, tok, **kw):
    params, cfg = load_packed_checkpoint(packed_dir, device="cpu")
    return Engine(params, cfg, max_slots=1, max_len=2048, sampling=SamplingParams(temperature=0.0),
                  eos_token_id=tok.eos_token_id, device="cpu", **kw)


def test_chat_on_scripted_stdin(model_dir, packed_dir, monkeypatch, capsys):  # noqa: F811
    """Two turns through stdin at temperature 0: each answer is the port
    engine's greedy continuation of the templated turn, decoded piece by
    piece, with the per-turn token line."""
    monkeypatch.setattr("sys.stdin", io.StringIO("the answer\nquestion choices\n"))
    tcli.main(["chat", "--model_path", str(model_dir), "--load_quant", str(packed_dir),
               "--template", "alpaca", "--temperature", "0", "--max_new_tokens", "6",
               "--device", "cpu"])
    out = capsys.readouterr().out
    tok = tcli._load_tokenizer(str(model_dir))
    eng = _greedy_engine(packed_dir, tok)
    want = ""
    for user in ("the answer", "question choices"):
        req = Request(prompt_tokens=tok.encode(render_prompt("alpaca", user)), max_new_tokens=6)
        eng.run([req])
        want += "ASSISTANT: " + "".join(tok.decode([t]) for t in req.output_tokens)
    got = "".join(part.split("\n[")[0] for part in out.split("USER: ")[1:])
    assert out.startswith("chat ready")
    assert got == want
    assert out.count(" tokens, ") == 2


def test_serve_builds_the_engine_and_frontend_its_flags_ask_for(model_dir, packed_dir,  # noqa: F811
                                                                monkeypatch, capsys):
    """serve --load_quant ... --spec_decode --kv_dtype int8 --warmup: the
    engine carries the flags, warmup ran, the frontend binds port 0; signal
    handlers are installed (recorded here, not set)."""
    seen = {}
    monkeypatch.setattr(ServingFrontend, "serve_forever", lambda self: seen.setdefault("f", self))
    monkeypatch.setattr("signal.signal", lambda sig, fn: seen.setdefault("signals", []).append(sig))
    tcli.main(["serve", "--model_path", str(model_dir), "--load_quant", str(packed_dir),
               "--port", "0", "--max_slots", "2", "--max_seq_len", "256", "--kv_dtype", "int8",
               "--spec_decode", "--spec_ngram", "3", "--prompt_cache_gb", "0.001",
               "--temperature", "0.5", "--warmup", "--device", "cpu"])
    front = seen["f"]
    try:
        eng = front.engine
        assert eng.max_slots == 2 and eng.max_len == 256 and eng.cache.quantized
        assert eng.spec_decode and eng.spec_ngram == 3 and eng._cache_len() == 256  # warmed
        assert eng.prompt_cache_bytes == int(0.001 * (1 << 30)) and eng.prompt_cache_size == 512
        assert eng.sampling.temperature == 0.5 and eng.sampling.top_p == 0.95
        assert front.address[1] > 0 and len(seen["signals"]) == 2
        out = capsys.readouterr().out
        assert "warmup done" in out and f":{front.address[1]} (2 slots" in out
    finally:
        front.httpd.server_close()


def test_serving_parsers_hold_the_jax_flags():
    """pack, serve and chat: JAX's flags plus --device (pack's help says
    where it packs)."""
    got, want = tcli.build_parser(), jcli.build_parser()
    g, w = _flags(got), _flags(want)
    device = (("--device",), "device", "cuda", None, ())
    for name in ("pack", "serve", "chat"):
        assert g[name] == w[name] | {device}, name


def test_gsm8k_spec_decode_gives_the_same_greedy_outputs(model_dir, capsys, monkeypatch):  # noqa: F811
    """--spec_decode at temperature 0: the printed JSON equals the plain
    run's, and the greedy token streams equal the plain engine's up to the
    tie rule of chip_smoke.py (the checkpoint computes in bf16, where an
    S = k + 1 verify and S = 1 steps can flip an argmax whose top-2 gap is
    within twice their largest logit difference)."""
    import chip_smoke
    from bitdistiller_tpu_torch.eval.gsm8k import PROMPT, load_jsonl

    argv = ["gsm8k", "--model_path", str(model_dir), "--data_path",
            str(FIXTURES / "gsm8k_test200.jsonl"), "--max_new_tokens", "24", "--max_batch", "2",
            "--limit", "3", "--temperature", "0", "--device", "cpu"]
    tcli.main(argv)
    plain_out = capsys.readouterr().out
    tcli.main(argv + ["--spec_decode"])
    assert capsys.readouterr().out == plain_out
    args = tcli.build_parser().parse_args(argv + ["--spec_decode"])
    eng, tok = tcli._engine_for_eval(args)
    assert eng.spec_decode
    docs = load_jsonl(args.data_path)[:3]
    prompts = [tok.encode(PROMPT.format(query=d["query"])) for d in docs]
    eng.eos = None  # whole streams, so that every draft length has tokens to verify
    spec = eng.generate(prompts, max_new_tokens=24)
    plain = Engine(eng.params, eng.cfg, max_slots=2, max_len=2048,
                   sampling=SamplingParams(temperature=0.0), eos_token_id=None,
                   device="cpu").generate(prompts, max_new_tokens=24)
    assert eng.spec_rounds > 0
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    delta = max(chip_smoke.delta_verify(eng.params, eng.cfg, prompts, plain, k)
                for k in eng.spec_k_ladder)
    ties = chip_smoke.tie_rule(eng.params, eng.cfg, prompts, plain, spec, delta, "gsm8k spec")
    assert ties["equal"] + len(ties["divergences"]) == 3
