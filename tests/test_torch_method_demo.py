"""The port's method check (`bitdistiller_tpu_torch/scripts/method_demo.py`):
its corpus, blocks and section writer equal the JAX script's, and the whole
pipeline (teacher, RTN, AutoClip, generation, CAKLD QAT, pack, A16 and W2A8
rows) runs on the CPU at a few steps. The packed row reads the QAT row's int2
grid through the plain packed matmul: within 1% of the QAT row (bf16
activations rounded in another order; a model this untrained sits near the
vocabulary's perplexity)."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from bitdistiller_tpu_torch.scripts import method_demo as tmd

ROOT = Path(__file__).resolve().parents[1]
PACKED_TOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes and loops of small ops: one intra-op thread (the suite
    runs several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmd():
    spec = importlib.util.spec_from_file_location("jax_method_demo",
                                                  ROOT / "scripts" / "method_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,seed,table_seed", [(5000, 7, 7), (3000, 99, 7), (100, 1, 3),
                                               (2, 0, 7)])
def test_make_corpus_equals_jax(jmd, n, seed, table_seed):
    got = tmd.make_corpus(n, seed=seed, table_seed=table_seed)
    want = jmd.make_corpus(n, seed=seed, table_seed=table_seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [256 * 3, 256 * 3 + 100, 255])
def test_blocks_of_equals_jax(jmd, n):
    stream = np.arange(n, dtype=np.int32)
    tmd.SEQ = jmd.SEQ = 256
    np.testing.assert_array_equal(tmd.blocks_of(stream), jmd.blocks_of(stream))


@pytest.mark.parametrize("text,header", [
    (None, "## A"), ("", "## A"), ("# Title\n\n## A\nold\n## B\nkeep\n", "## A"),
    ("# Title\n\n## B\nkeep\n", "## A"), ("## A\nold only\n", "## A")])
def test_replace_section_equals_jax(jmd, tmp_path, text, header):
    a, b = tmp_path / "a.md", tmp_path / "b.md"
    if text is not None:
        a.write_text(text)
        b.write_text(text)
    tmd.replace_section(str(a), header, f"{header}\nnew\n")
    jmd.replace_section(str(b), header, f"{header}\nnew\n")
    assert a.read_text() == b.read_text()


def test_batches_from_blocks_equal_jax(jmd):
    blocks = np.arange(40, dtype=np.int32).reshape(10, 4)
    g = tmd.batches_from_blocks(blocks, 3, np.random.default_rng(1))
    w = jmd.batches_from_blocks(blocks, 3, np.random.default_rng(1))
    for _ in range(3):
        x, y = next(g), next(w)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


TINY = ["--device", "cpu", "--layers", "2", "--teacher-steps", "20", "--qat-steps", "4",
        "--gen-samples", "4", "--gen-tokens", "8", "--eval-blocks", "32", "--batch", "8",
        "--qat-batch", "4"]


def test_the_pipeline_runs_on_the_cpu_and_returns_every_row(tmp_path, capsys):
    out = tmp_path / "demo.md"
    tmd.main(TINY + ["--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    rows = {r["label"]: r for r in res["rows"]}
    assert set(rows) == {"int2-g64", "nf3-g64"}
    assert set(rows["int2-g64"]) == {"label", "rtn", "clip", "qat", "packed", "packed_a8"}
    assert set(rows["nf3-g64"]) == {"label", "rtn", "clip", "qat"}
    vals = [v for r in res["rows"] for k, v in r.items() if k != "label"] + [res["teacher"]]
    assert all(np.isfinite(v) and v > 1.0 for v in vals)
    i2 = rows["int2-g64"]
    assert abs(i2["packed"] - i2["qat"]) <= PACKED_TOL * i2["qat"]
    assert {"teacher", "generation", "autoclip", "qat", "eval"} <= set(res["seconds"])
    text = out.read_text()
    assert text.startswith("## Synthetic language (the port)") and "| int2-g64 |" in text
    assert "| int2-g64 |" in "\n".join(lines[:-1])
    assert "BITDISTILLER_QMM_A8" not in os.environ


def test_out_never_names_results_md(tmp_path):
    assert tmd.build_parser().parse_args([]).out == "chiprun_out/method_demo.md"
    for bad in ("RESULTS.md", str(tmp_path / "RESULTS.md"), "./RESULTS.md"):
        with pytest.raises(SystemExit, match="never writes RESULTS.md"):
            tmd.main(TINY + ["--out", bad])
    assert not (tmp_path / "RESULTS.md").exists()


@pytest.mark.parametrize("flag", [["--spec-bench"], ["--spec-only"], ["--teacher-ckpt", "t.pkl"]])
def test_the_spec_bench_waits_for_a3(flag, tmp_path, capsys, monkeypatch):
    """The spec-bench flags, which waited for the engine's n-gram drafting
    (ROADMAP A3), run now.
    --spec-only: the seven variants on the packed teacher, their section in
    --out, no quantization rows. --spec-bench: the bench, then the whole
    pipeline (the bench's results stubbed here: --spec-only runs it).
    --teacher-ckpt: trains and pickles float32 numpy leaves, then a second
    run loads them instead of training."""
    out = tmp_path / "demo.md"
    argv = TINY + ["--out", str(out), "--eval-blocks", "4"]
    if flag[0] == "--spec-only":
        # three of the seven variants, 4 slots for the 4 prompts: CPU time
        monkeypatch.setattr(tmd, "SPEC_VARIANTS", tmd.SPEC_VARIANTS[:2] + tmd.SPEC_VARIANTS[5:6])
        engine = tmd.Engine
        monkeypatch.setattr(tmd, "Engine", lambda *a, **k: engine(*a, **dict(k, max_slots=4)))
        tmd.main(argv + flag)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["rows"] == [] and set(res["spec"]) == {m for m, _ in tmd.SPEC_VARIANTS}
        assert all(r["accept"] >= 1.0 for m, r in res["spec"].items() if m != "plain")
        text = out.read_text()
        assert text.startswith("## Speculative decoding on held-out text (the port)")
        assert "| adaptive |" in text and "Synthetic language" not in text
        return
    calls = []

    def stub(params, cfg, blocks, log, device="cuda"):
        calls.append(len(blocks))
        res = {m: {"tok_s": 1.0, "outs": [], "accept": 2.0, "k": 4, "agree": 0}
               for m, _ in tmd.SPEC_VARIANTS}
        return dict(res, prompts=[])

    monkeypatch.setattr(tmd, "spec_bench", stub)
    if flag[0] == "--spec-bench":
        tmd.main(argv + flag)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert calls == [4] and {r["label"] for r in res["rows"]} == {"int2-g64", "nf3-g64"}
        assert "## Speculative decoding" in out.read_text()
        return
    ckpt = tmp_path / flag[1]
    tmd.main(argv + ["--spec-only", "--teacher-ckpt", str(ckpt)])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    import pickle

    with open(ckpt, "rb") as f:
        host = pickle.load(f)
    assert host["embed"].dtype == np.float32 and isinstance(host["layers"]["q"]["w"], np.ndarray)
    # loaded as bf16, as the JAX script loads it
    loaded = tmd.load_teacher(str(ckpt), torch.device("cpu"))
    assert loaded["embed"].dtype == torch.bfloat16
    assert torch.equal(loaded["embed"], torch.from_numpy(host["embed"]).bfloat16())
    monkeypatch.setattr(tmd, "train_teacher", lambda *a, **k: pytest.fail("retrained"))
    tmd.main(argv + ["--spec-only", "--teacher-ckpt", str(ckpt)])
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(calls) == 2
    np.testing.assert_allclose(second["teacher"], first["teacher"], rtol=1e-3)


def test_source_corpus_raises_on_an_empty_root(tmp_path):
    with pytest.raises(SystemExit, match="no Python files"):
        tmd.main(["--device", "cpu", "--corpus", "source", "--source-root", str(tmp_path),
                  "--out", str(tmp_path / "x.md")])


def test_source_corpus_equals_jax(jmd, tmp_path, monkeypatch):
    """The port's walk over a root equals the JAX script's over its own root,
    redirected here: every 20th file held out, the tiny and the huge skipped."""
    for i in range(25):
        (tmp_path / f"m{i:02d}.py").write_text(f"# module {i}\n" + "x = 1\n" * (50 + i))
    (tmp_path / "tiny.py").write_text("x = 1\n")
    import glob

    real = glob.glob
    monkeypatch.setattr(glob, "glob", lambda pattern, recursive=False: real(
        str(tmp_path / "**" / "*.py"), recursive=recursive))
    want = jmd.source_corpus(1 << 20)
    monkeypatch.setattr(glob, "glob", real)
    got = tmd.source_corpus(1 << 20, str(tmp_path))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(want[0]) and len(want[1])
