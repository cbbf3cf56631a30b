"""The calibration loaders (`data/calib.py`) and the offline redirect
(`data/offline.py`) of the port against the JAX package's: the same blocks,
bit for bit, from every local reader and, through fixtures written here
under BITDISTILLER_DATA_DIR, from every hub loader; the same errors and the
same fixture names. Pure Python and numpy in both packages, so equality is
exact."""

import json

import numpy as np
import pytest

from bitdistiller_tpu.data import calib as jcalib
from bitdistiller_tpu.data import offline as joffline
from bitdistiller_tpu_torch.data import calib as tcalib
from bitdistiller_tpu_torch.data import offline as toffline


class Tok:
    """Byte-level: one token a character (ids 3..252)."""

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]


WORDS = ["alpha", "beta", "gamma", "delta", "kernel", "tensor", "group", "scale", "bits"]


def _text(rng, n_words):
    return " ".join(rng.choice(WORDS, size=n_words))


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def _rows(kind, n, seed):
    """Rows in a hub schema: some longer than 512 tokens (dropped), some empty."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        size = 150 if i % 7 == 3 else int(rng.integers(5, 60))  # ~150 words: > 512 chars
        a, b = _text(rng, size), _text(rng, int(rng.integers(3, 30)))
        if i % 11 == 5:
            a = b = ""
        rows.append({
            "text": {"text": a},
            "code": {"instruction": a, "output": b},
            "nemotron": {"input": [{"role": "user", "content": a}], "output": b},
            "epicoder": {"instruction": a, "output": b},
        }[kind])
    return rows


def _same_blocks(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("path,name,split", [
    ("mit-han-lab/pile-val-backup", None, "validation"),
    ("nvidia/Llama-Nemotron-Post-Training-Dataset", "SFT", "code"),
    ("wikitext", "wikitext-2-raw-v1", "test"),
    ("a/b/c", "", None),
])
def test_fixture_name_matches_jax(path, name, split):
    assert toffline.fixture_name(path, name, split) == joffline.fixture_name(path, name, split)
    assert toffline.ENV_VAR == joffline.ENV_VAR == "BITDISTILLER_DATA_DIR"


HUB = {  # calib name: (fixture file, row schema)
    "pile": ("mit-han-lab_pile-val-backup__default__validation.jsonl", "text"),
    "code": ("nickrosh_Evol-Instruct-Code-80k-v1__default__train.jsonl", "code"),
    "nemotron_code": ("nvidia_Llama-Nemotron-Post-Training-Dataset__SFT__code.jsonl", "nemotron"),
    "nemotron_math": ("nvidia_Llama-Nemotron-Post-Training-Dataset__SFT__math.jsonl", "nemotron"),
    "epicoder": ("microsoft_EpiCoder-func-380k__default__train.jsonl", "epicoder"),
}


@pytest.mark.parametrize("name", sorted(HUB))
def test_hub_loader_blocks_match_jax(name, tmp_path, monkeypatch):
    fname, kind = HUB[name]
    _write_jsonl(tmp_path / fname, _rows(kind, 60, seed=len(name)))
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(tmp_path))
    for n_samples, block in ((16, 64), (200, 128)):
        want = jcalib.get_calib_dataset(name, Tok(), n_samples, block)
        _same_blocks(tcalib.get_calib_dataset(name, Tok(), n_samples, block), want)


def test_load_dataset_serves_the_fixture_as_jax(tmp_path, monkeypatch):
    rows = _rows("code", 5, seed=1)
    _write_jsonl(tmp_path / "org_set__cfg__train.jsonl", rows)
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(tmp_path))
    got = toffline.load_dataset("org/set", "cfg", split="train")
    want = joffline.load_dataset("org/set", "cfg", split="train")
    assert type(got) is type(want) and list(got) == list(want) == rows
    for mod in (toffline, joffline):
        with pytest.raises(FileNotFoundError) as err:
            mod.load_dataset("org/none", split="train")
        assert "org_none__default__train.jsonl" in str(err.value)


def _json_file(path, n, seed):
    rng = np.random.default_rng(seed)
    _write_jsonl(path, [[[_text(rng, int(rng.integers(4, 90))),
                          _text(rng, int(rng.integers(2, 40)))]] for _ in range(n)])


def _gsm8k_file(path, n, seed):
    rng = np.random.default_rng(seed)
    _write_jsonl(path, [{"query": _text(rng, int(rng.integers(4, 60))),
                         "response": _text(rng, int(rng.integers(2, 40)))} for _ in range(n)])


@pytest.mark.parametrize("name", ["json", "openr1_math", "merged_gmc", "gsm8k", "text"])
def test_local_loader_blocks_match_jax(name, tmp_path):
    path = tmp_path / "data"
    if name == "gsm8k":
        _gsm8k_file(path, 300, seed=2)  # sampled with random.seed(42): min(n * 10, 300) rows
    elif name == "text":
        path.write_text(_text(np.random.default_rng(3), 3000))
    else:
        _json_file(path, 80, seed=4)
    for n_samples, block in ((4, 64), (25, 100), (1000, 256)):
        want = jcalib.get_calib_dataset(name, Tok(), n_samples, block, data_path=str(path))
        _same_blocks(tcalib.get_calib_dataset(name, Tok(), n_samples, block, str(path)), want)


def test_text_reader_on_the_wikitext_fixture():
    """The chip smoke's calibration text: the wikitext fixture's rows joined
    (284 663 characters, 277 blocks of 1024 bytes), 128 blocks used."""
    import os
    import tempfile

    fixture = os.path.join(os.path.dirname(__file__), "..", "fixtures",
                           "wikitext__wikitext-2-raw-v1__test.jsonl")
    with open(fixture) as f:
        text = "".join(json.loads(line)["text"] for line in f if line.strip())
    assert len(text) == 284663
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(text)
    try:
        got = tcalib.get_calib_dataset("text", Tok(), 128, 1024, f.name)
        _same_blocks(got, jcalib.get_calib_dataset("text", Tok(), 128, 1024, f.name))
        assert len(got) == 128 and len(text) // 1024 == 277
    finally:
        os.unlink(f.name)


def _err(fn):
    with pytest.raises((ValueError, FileNotFoundError)) as info:
        fn()
    return type(info.value), str(info.value)


def test_errors_match_jax(tmp_path, monkeypatch):
    long_only = tmp_path / "long.jsonl"
    _write_jsonl(long_only, [[["x" * 600, "y"]]] * 3)
    short = tmp_path / "short.jsonl"
    _write_jsonl(short, [[["ab", "cd"]]] * 3)
    cases = [
        ("json", dict(data_path=str(long_only))),  # no sample <= 512 tokens
        ("json", dict(data_path=str(short), block_size=64)),  # corpus below one block
        ("json", {}),  # a local reader without data_path
        ("gsm8k", {}),
        ("squad", {}),  # unknown
    ]
    for name, kw in cases:
        want = _err(lambda: jcalib.get_calib_dataset(name, Tok(), **kw))
        assert _err(lambda: tcalib.get_calib_dataset(name, Tok(), **kw)) == want
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(tmp_path))
    for name in sorted(HUB):  # the fixture missing: the same message naming it
        want = _err(lambda: jcalib.get_calib_dataset(name, Tok(), 4, 64))
        assert want[0] is FileNotFoundError
        assert _err(lambda: tcalib.get_calib_dataset(name, Tok(), 4, 64)) == want
