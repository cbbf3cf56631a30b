"""Teacher self-generation on the port against the JAX package on the CPU:
the prompt sources, templates and merges (`generation/datasets.py`) give the
same prompts and the same files byte for byte; greedy `run_teacher_generation`
on a dense f32 TINY_TEST writes the same file as JAX's (both engines argmax
the same logits up to f32 summation order, as tests/test_torch_engine.py
holds for packed trees); the JAX package's `wikitext` fault is matched
(ROADMAP C4); the multi-host arguments raise."""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.generation import datasets as jds
from bitdistiller_tpu.generation.teacher import run_teacher_generation as jax_generate
from bitdistiller_tpu.models import TINY_TEST
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu_torch.generation import datasets as tds
from bitdistiller_tpu_torch.generation.teacher import run_teacher_generation
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
WORDS = ["alpha", "beta", "gamma", "delta", "kernel", "tensor", "group", "scale", "bits"]


class FakeTok:
    """The JAX package's tests' byte tokenizer (ids 3..252, prompts cut at 96)."""

    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s][:96]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


def _text(rng, lo, hi):
    return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


# ---- prompts, templates, merges ------------------------------------------------------------


def test_prompt_styles_match_jax():
    assert tds.PROMPT_STYLES == jds.PROMPT_STYLES
    assert tds.WIKITEXT_MIN_CHARS == jds.WIKITEXT_MIN_CHARS
    for name in ("json", "jsonl", "wikitext", "alpaca", "openorca", "code", "math", "x"):
        assert tds.style_for_dataset(name) == jds.style_for_dataset(name)


def test_local_prompts_match_jax(tmp_path):
    """Strings, dicts (instruction, query, prompt, none: dropped) and
    teacher-format lists; sampled down with the seed's random.Random."""
    rng = np.random.default_rng(0)
    items = []
    for i in range(40):
        kind = i % 5
        p = _text(rng, 2, 12)
        items.append([p, {"instruction": p}, {"query": p}, {"prompt": p},
                      [[p, "reply"]]][kind])
    items.append({"other": "x"})
    _write_jsonl(tmp_path / "p.jsonl", items)
    for name in ("json", "jsonl"):
        for max_sample, seed in ((5000, 42), (7, 42), (7, 3)):
            want = jds.get_gen_prompts(name, max_sample, seed, str(tmp_path / "p.jsonl"))
            assert tds.get_gen_prompts(name, max_sample, seed, str(tmp_path / "p.jsonl")) == want
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="data_path"):
            mod.get_gen_prompts("json")
        with pytest.raises(ValueError, match="unknown gen dataset"):
            mod.get_gen_prompts("squad")


HUB = {  # dataset name: (fixture file, a row)
    "alpaca": ("tatsu-lab_alpaca__default__train.jsonl",
               lambda p, i: {"instruction": p, "input": "" if i % 3 else "ctx"}),
    "openorca": ("Open-Orca_OpenOrca__default__train.jsonl", lambda p, i: {"question": p}),
    "code": ("nickrosh_Evol-Instruct-Code-80k-v1__default__train.jsonl",
             lambda p, i: {"instruction": p}),
    "math": ("meta-math_MetaMathQA__default__train.jsonl", lambda p, i: {"query": p}),
    "wikitext": ("wikitext__default__train.jsonl", lambda p, i: {"text": p * (i % 4)}),
}


@pytest.mark.parametrize("name", sorted(HUB))
def test_hub_prompts_match_jax(name, tmp_path, monkeypatch):
    fname, row = HUB[name]
    rng = np.random.default_rng(len(name))
    _write_jsonl(tmp_path / fname, [row(_text(rng, 3, 40), i) for i in range(50)])
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(tmp_path))
    for max_sample in (5000, 9):
        want = jds.get_gen_prompts(name, max_sample, 42)
        assert len(want) > 0
        assert tds.get_gen_prompts(name, max_sample, 42) == want


def test_wikitext_loads_no_config_name_as_jax(tmp_path, monkeypatch):
    """ROADMAP C4: `wikitext` asks the hub for ("wikitext", None, "train"),
    though its comment names wikitext-2-raw-v1: under the redirect it wants
    wikitext__default__train.jsonl and does not read the config's file."""
    rng = np.random.default_rng(1)
    rows = [{"text": _text(rng, 30, 60)} for _ in range(6)]
    _write_jsonl(tmp_path / "wikitext__wikitext-2-raw-v1__train.jsonl", rows)
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(tmp_path))
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError, match="wikitext__default__train.jsonl"):
            mod.get_gen_prompts("wikitext")
    (tmp_path / "wikitext__default__train.jsonl").write_text(
        (tmp_path / "wikitext__wikitext-2-raw-v1__train.jsonl").read_text())
    want = jds.get_gen_prompts("wikitext")
    assert tds.get_gen_prompts("wikitext") == want == [r["text"][:128] for r in rows]


def _teacher_file(path, n, seed):
    rng = np.random.default_rng(seed)
    lines = [json.dumps([[_text(rng, 2, 9), _text(rng, 2, 9)]]) for _ in range(n)]
    # the last line without its newline, and a blank line: both are handled
    path.write_text("\n".join(lines[:-1]) + "\n\n" + lines[-1])


def test_mix_data_matches_jax(tmp_path):
    _teacher_file(tmp_path / "a", 13, 1)
    _teacher_file(tmp_path / "b", 7, 2)
    for seed in (42, 5):
        n_t = tds.mix_data(str(tmp_path / "a"), str(tmp_path / "b"), str(tmp_path / "t"), seed)
        n_j = jds.mix_data(str(tmp_path / "a"), str(tmp_path / "b"), str(tmp_path / "j"), seed)
        assert n_t == n_j == 20
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_merge_interleaved_matches_jax(tmp_path):
    paths = []
    for i, n in enumerate((9, 4, 1, 6)):
        _teacher_file(tmp_path / f"s{i}", n, 10 + i)
        paths.append(str(tmp_path / f"s{i}"))
    n_t = tds.merge_interleaved(paths, str(tmp_path / "t"))
    n_j = jds.merge_interleaved(paths, str(tmp_path / "j"))
    assert n_t == n_j == 20
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


# ---- run_teacher_generation ----------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes and loops of small ops: one intra-op thread (the suite
    runs several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense():
    jp = jinit(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_numpy(to_numpy_tree(jp), "cpu")


def _args(tmp_path, out, **kw):
    base = dict(base_model="unused", dataset_name="json", data_path=str(tmp_path / "prompts"),
                out_path=str(tmp_path / out), max_sample=9, max_new_tokens=7, temperature=0.0,
                top_p=1.0, max_batch=2, max_seq_len=128, seed=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _prompts(tmp_path):
    rng = np.random.default_rng(4)
    rows = [{"instruction": _text(rng, 1, 14)} for _ in range(12)]  # 9 of 12 sampled
    rows[3]["instruction"] = _text(rng, 30, 40)  # cut at 96 tokens by the tokenizer
    _write_jsonl(tmp_path / "prompts", rows)


@pytest.mark.parametrize("dataset_name", ["json", "math"])
def test_greedy_generation_writes_jax_file(dataset_name, tmp_path, dense, monkeypatch):
    """Greedy, more prompts than slots, mixed prompt lengths, the "math"
    template on a hub fixture: byte-equal files, prompt order kept."""
    jp, tp = dense
    _prompts(tmp_path)
    if dataset_name == "math":
        rows = [json.loads(x) for x in open(tmp_path / "prompts")]
        _write_jsonl(tmp_path / "meta-math_MetaMathQA__default__train.jsonl",
                     [{"query": r["instruction"]} for r in rows])
        monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(tmp_path))
    want = jax_generate(_args(tmp_path, "jax.jsonl", dataset_name=dataset_name),
                        tokenizer=FakeTok(), model=(jp, CFG))
    got = run_teacher_generation(_args(tmp_path, "port/out.jsonl", dataset_name=dataset_name,
                                       device="cpu"),
                                 tokenizer=FakeTok(), model=(tp, torch_cfg(CFG)))
    assert got == str(tmp_path / "port/out.jsonl")
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    lines = [json.loads(x) for x in data.decode().splitlines()]
    assert len(lines) == 9
    style = tds.PROMPT_STYLES[tds.style_for_dataset(dataset_name)]
    prompts = tds.get_gen_prompts(dataset_name, 9, 0, str(tmp_path / "prompts"))
    assert [line[0][0] for line in lines] == [style.format(instruction=p) for p in prompts]
    assert all(len(line[0][1]) == 7 for line in lines)


class NumTok(FakeTok):
    """FakeTok whose decode writes the ids, so a completion names its tokens."""

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)


def test_generation_stops_at_eos_as_jax(tmp_path, dense):
    """An EOS id the model emits mid-horizon ends that request early, in
    both packages alike."""
    jp, tp = dense
    _prompts(tmp_path)
    free = run_teacher_generation(_args(tmp_path, "free.jsonl", device="cpu", max_new_tokens=10),
                                  tokenizer=NumTok(), model=(tp, torch_cfg(CFG)))
    first = [int(x) for x in json.loads(open(free).readline())[0][1].split()]

    class EosTok(NumTok):
        eos_token_id = first[3]

    want = jax_generate(_args(tmp_path, "jax.jsonl", max_new_tokens=10), tokenizer=EosTok(),
                        model=(jp, CFG))
    got = run_teacher_generation(_args(tmp_path, "port.jsonl", device="cpu", max_new_tokens=10),
                                 tokenizer=EosTok(), model=(tp, torch_cfg(CFG)))
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    ended = json.loads(data.decode().splitlines()[0])[0][1].split()
    assert ended == [str(t) for t in first[: first.index(first[3]) + 1]]


@pytest.mark.parametrize("name,value", [("coordinator_address", "localhost:1234"),
                                        ("num_processes", 2), ("process_id", 0)])
def test_multi_host_arguments_raise(name, value, tmp_path, dense):
    _, tp = dense
    _prompts(tmp_path)
    with pytest.raises(NotImplementedError, match="A11"):
        run_teacher_generation(_args(tmp_path, "x.jsonl", device="cpu", **{name: value}),
                               tokenizer=FakeTok(), model=(tp, torch_cfg(CFG)))
    assert not (tmp_path / "x.jsonl").exists()


def test_generation_defaults_to_the_card(tmp_path, dense):
    """Without `device`, generation runs on the card; with no card it
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    _, tp = dense
    _prompts(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_teacher_generation(_args(tmp_path, "x.jsonl"), tokenizer=FakeTok(),
                               model=(tp, torch_cfg(CFG)))
