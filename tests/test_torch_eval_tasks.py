"""The port's task harness (`eval/tasks.py`) against the JAX package's on the
same inputs: an f32 TINY_TEST made by the JAX package and carried across as
numpy arrays. Tolerances: log-likelihood sums within 1e-4 relative (f32
forwards and log-softmaxes, sums in another order); greedy flags, task
dicts' acc / acc_norm / n and generated texts equal (f32 on the CPU: no argmax
ties at these scales); perplexity-task metrics within 1e-4 relative.
Hub tasks read the repo's fixtures through BITDISTILLER_DATA_DIR; the others
read synthetic rows through a patched `datasets.load_dataset`."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.eval import tasks as J
from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model as jax_pack_model
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu_torch.eval import tasks as T
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.serve import Engine, SamplingParams
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
LL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes and loops of small ops: one intra-op thread (the suite
    runs several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CharTok:
    """The JAX package's eval tests' tokenizer: one id a character."""

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


class MergeTok(CharTok):
    """Merges "ab" into one id: `encode(ctx + cont)` does not start with
    `encode(ctx)` when ctx ends in "a" and cont starts with "b"."""

    def encode(self, s):
        out, i = [], 0
        while i < len(s):
            if s[i: i + 2] == "ab":
                out.append(2)
                i += 2
            else:
                out.append((ord(s[i]) % 250) + 3)
                i += 1
        return out


class EosZeroTok(CharTok):
    eos_token_id = 0
    bos_token_id = 5


@pytest.fixture(scope="module")
def jparams():
    return init_params(CFG, jax.random.key(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(to_numpy_tree(jparams), "cpu")


def _fns(jparams, tparams, tok=None, **kw):
    tok = tok or CharTok()
    kw = dict(dict(max_len=128, batch_size=4), **kw)
    return (J.LogLikelihoodFn(jparams, CFG, tok, **kw),
            T.LogLikelihoodFn(tparams, TCFG, tok, device="cpu", **kw))


def _close(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=LL_TOL)
    assert [g[1] for g in got] == [w[1] for w in want]


PAIRS = [("hello ", "worl"), ("abc", " x"), ("a much longer context here", " y"),
         ("zz", " q"), ("the sky is", " blue"), ("", "an empty context"), ("q", "")]


def test_loglikelihood_sums_and_greedy_flags_equal_jax(jparams, tparams):
    jfn, tfn = _fns(jparams, tparams)
    _close(tfn(PAIRS), jfn(PAIRS))


def test_greedy_flag_is_set_where_the_continuation_is_the_argmax(jparams, tparams):
    """A continuation made of the model's own argmax tokens is greedy in both."""
    _, tfn = _fns(jparams, tparams)
    ctx = "seed text"
    toks = CharTok().encode(ctx)
    with torch.no_grad():
        for _ in range(4):
            logits, _ = T.llama.forward(tparams, TCFG, torch.as_tensor([toks]))
            toks.append(int(logits[0, -1].argmax()))
    cont = "".join(chr((t - 3) % 250) for t in toks[len(ctx):])
    if CharTok().encode(ctx + cont) != toks:
        pytest.skip("argmax ids fall outside the tokenizer's byte range")
    (ll, greedy), = tfn([(ctx, cont)])
    assert greedy and ll < 0


@pytest.mark.parametrize("ctx,cont", [("xxa", "bcd"), ("a", "b"), ("ab", "ab")])
def test_retokenization_fallback_equals_jax(jparams, tparams, ctx, cont):
    jfn, tfn = _fns(jparams, tparams, MergeTok())
    assert tfn._encode_pair(ctx, cont) == jfn._encode_pair(ctx, cont)
    _close(tfn([(ctx, cont)]), jfn([(ctx, cont)]))


@pytest.mark.parametrize("n_ctx,n_cont", [(150, 5), (100, 40), (10, 200), (127, 1)])
def test_max_len_cut_equals_jax(jparams, tparams, n_ctx, n_cont):
    jfn, tfn = _fns(jparams, tparams)
    ctx, cont = "abcdefghij" * (n_ctx // 10) + "k" * (n_ctx % 10), " z" * (n_cont // 2) + "w" * (n_cont % 2)
    enc = tfn._encode_pair(ctx, cont)
    assert enc == jfn._encode_pair(ctx, cont) and len(enc[0]) <= 128
    _close(tfn([(ctx, cont)]), jfn([(ctx, cont)]))


def test_buckets_and_length_sort_equal_jax(jparams, tparams):
    """Items of many lengths: 64 * 2^k buckets, sorted by length, in batches
    of 4, handed back in the caller's order."""
    jfn, tfn = _fns(jparams, tparams, max_len=512)
    rng = np.random.default_rng(0)
    pairs = [("w" * int(n), " " + "v" * int(m)) for n, m in
             zip(rng.integers(1, 400, 11), rng.integers(1, 30, 11))]
    _close(tfn(pairs), jfn(pairs))


@pytest.mark.parametrize("max_len", [128, 16])
def test_rolling_equals_jax(jparams, tparams, max_len):
    """One window (128) and many (16): each token scored once, the first
    window conditioned on the prefix token."""
    jfn, tfn = _fns(jparams, tparams, max_len=max_len)
    texts = ["hello rolling world", "another text, somewhat longer than the first one"]
    np.testing.assert_allclose(tfn.rolling(texts), jfn.rolling(texts), rtol=LL_TOL)


def test_rolling_prefix_falls_through_an_eos_of_zero_to_the_bos(jparams, tparams):
    """`eos or bos or 0`: an EOS id of 0 is falsy, so the BOS (5) leads."""
    jfn, tfn = _fns(jparams, tparams, tok=EosZeroTok())
    text = "prefix rule"
    (got,), (want,) = tfn.rolling([text]), jfn.rolling([text])
    np.testing.assert_allclose(got, want, rtol=LL_TOL)
    seq = [5] + CharTok().encode(text)
    with torch.no_grad():
        logits, _ = T.llama.forward(tparams, TCFG, torch.as_tensor([seq]))
    logp = torch.log_softmax(logits[0, :-1], -1)
    manual = float(sum(logp[i, seq[i + 1]] for i in range(len(seq) - 1)))
    np.testing.assert_allclose(got, manual, rtol=LL_TOL)


FIXTURE_TASKS = ["arc_challenge", "hendrycksTest-abstract_algebra",
                 "hendrycksTest-elementary_mathematics", "logiqa", "mathqa", "race"]


@pytest.mark.parametrize("task", FIXTURE_TASKS)
def test_run_tasks_over_every_fixture_equals_jax(jparams, tparams, task, monkeypatch):
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))
    jfn, tfn = _fns(jparams, tparams)
    want = J.run_tasks(jfn, [task], mmlu_fewshot=2)
    got = T.run_tasks(tfn, [task], mmlu_fewshot=2)
    assert got == want
    assert got[task]["n"] == len(J.TASK_REGISTRY[task]())


def test_run_tasks_aggregates_mmlu_and_qa_as_jax(monkeypatch):
    """The averages of tasks.py:756-790 over two fixtures with a
    deterministic scorer (shortest choice wins)."""
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))
    scorer = lambda pairs: [(-float(len(c)), True) for _, c in pairs]
    names = ["arc_challenge", "hendrycksTest-abstract_algebra", "mathqa"]
    got, want = T.run_tasks(scorer, names), J.run_tasks(scorer, names)
    assert got == want and {"mmlu-acc", "qa-avg"} <= set(got)


def test_evaluate_task_per_choice_contexts_equals_jax(jparams, tparams):
    """Winogrande-style docs: one context a choice, a shared continuation."""
    jfn, tfn = _fns(jparams, tparams)
    jdocs = [J.MCDoc(["Alice said ", "Bob said "], ["hello", "hello"], 1),
             J.MCDoc("the sky is", [" blue", " a very long wrong option"], 0)]
    tdocs = [T.MCDoc(d.context, d.choices, d.gold) for d in jdocs]
    assert T.evaluate_task(tfn, tdocs) == J.evaluate_task(jfn, jdocs)


def test_c4_acc_norm_counts_the_space_as_jax():
    """C4, matched: acc_norm divides by the space-prefixed option's length
    (3 and 7 here), as the JAX package does; lm-eval's raw lengths (2 and 6)
    would pick the other option."""
    docs = [T.MCDoc("q", [" ab", " abcdef"], 0)]
    jdocs = [J.MCDoc("q", [" ab", " abcdef"], 0)]
    scorer = lambda pairs: [(-3.0, False), (-7.5, False)]
    got, want = T.evaluate_task(scorer, docs), J.evaluate_task(scorer, jdocs)
    assert got == want == {"acc": 1.0, "acc_norm": 1.0, "n": 1}
    assert np.argmax([-3.0 / 2, -7.5 / 6]) == 1  # the raw-length rule flips it


def test_cloze_task_equals_jax(jparams, tparams):
    jfn, tfn = _fns(jparams, tparams)
    jdocs = [J.ClozeDoc("the cat sat on the", " mat"), J.ClozeDoc("a b c", " d"),
             J.ClozeDoc("x y", " z")]
    tdocs = [T.ClozeDoc(d.context, d.continuation) for d in jdocs]
    got, want = T.evaluate_cloze_task(tfn, tdocs), J.evaluate_cloze_task(jfn, jdocs)
    assert got["acc"] == want["acc"] and got["n"] == want["n"] == 3
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=LL_TOL)


def test_wikitext_word_task_equals_jax(jparams, tparams, monkeypatch):
    """run_tasks("wikitext"): the document-level variant is missing from the
    fixtures, so both fall back to the line-level test split joined into one
    document, scored by `rolling`."""
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))
    jfn, tfn = _fns(jparams, tparams, max_len=128, batch_size=32)
    text = T._wikitext_docs()[0][:6000]
    assert J._wikitext_docs()[0][:6000] == text
    got = T.evaluate_perplexity_task(tfn, [text])
    want = J.evaluate_perplexity_task(jfn, [text])
    assert got["n"] == want["n"] == 1
    for k in ("word_perplexity", "byte_perplexity", "bits_per_byte"):
        np.testing.assert_allclose(got[k], want[k], rtol=LL_TOL)
    assert T.wikitext_detokenizer(text) == J.wikitext_detokenizer(text)


def test_fixtureless_loaders_format_as_jax(monkeypatch):
    """The loaders without fixtures, on the synthetic hub rows of the JAX
    package's test_new_task_loaders_format and more: the same docs."""
    rows = {
        ("openbookqa",): [{"question_stem": "The sun is a",
                           "choices": {"label": ["A", "B"], "text": ["star", "planet"]},
                           "answerKey": "A"}],
        ("sciq",): [{"support": "Water boils at 100C.",
                     "question": "At what temperature does water boil?",
                     "distractor1": "50C", "distractor2": "75C", "distractor3": "10C",
                     "correct_answer": "100C"}],
        ("super_glue", "copa"): [{"premise": "The man fell.", "question": "cause",
                                  "choice1": "He tripped.", "choice2": "He flew.", "label": 0}],
        ("super_glue", "boolq"): [{"passage": "Cats purr.", "question": "do cats purr",
                                   "label": 1}],
        ("EleutherAI/lambada_openai", "en"): [{"text": "the cat sat on the mat"}],
        ("hellaswag",): [{"ctx_a": "A man is [title] cooking.", "ctx_b": "he stirs",
                          "activity_label": "Cooking", "endings": ["the pot.", "a [x] car."],
                          "label": "0"}],
        ("piqa",): [{"goal": "Open a jar", "sol1": "twist the lid", "sol2": "eat it",
                     "label": 0}],
        ("winogrande", "winogrande_xl"): [{"sentence": "Tom gave Bob a gift because _ was kind.",
                                           "option1": "Tom", "option2": "Bob", "answer": "1"}],
    }

    def fake_load(*args, split=None, **kw):
        key = tuple(a for a in args if isinstance(a, str))
        if key[0] == "openbookqa":
            key = ("openbookqa",)
        return rows[key]

    monkeypatch.delenv("BITDISTILLER_DATA_DIR", raising=False)
    monkeypatch.setattr("datasets.load_dataset", fake_load)
    for name in ("openbookqa", "sciq", "copa", "boolq", "hellaswag", "piqa", "winogrande"):
        got, want = T.TASK_REGISTRY[name](), J.TASK_REGISTRY[name]()
        assert [(d.context, d.choices, d.gold) for d in got] == \
            [(d.context, d.choices, d.gold) for d in want], name
    (d,) = T.TASK_REGISTRY["copa"]()
    assert d.context == "The man fell because" and d.choices == [" he tripped.", " he flew."]
    (got,), (want,) = T.CLOZE_TASKS["lambada_openai"](), J.CLOZE_TASKS["lambada_openai"]()
    assert (got.context, got.continuation) == (want.context, want.continuation)
    assert set(T.TASK_REGISTRY) == set(J.TASK_REGISTRY)
    assert T.MMLU_SUBJECTS == J.MMLU_SUBJECTS and T.TASK_METRICS == J.TASK_METRICS


@pytest.mark.parametrize("text,until", [("abc\ndef", ["\n"]), ("abcSTOPdef\nx", ["\n", "STOP"]),
                                        ("no stops here", ["\n"]), ("x", []), ("a:b", [":", ""])])
def test_trim_at_stops_equals_jax(text, until):
    assert T.trim_at_stops(text, until) == J.trim_at_stops(text, until)


@pytest.fixture(scope="module")
def engines(jparams):
    """Both engines on the same packed int2-g64 f32 TINY_TEST, greedy, f32
    KV caches."""
    packed = jax_pack_model(jparams, CFG, bits=2, group_size=64)
    tpacked = params_from_numpy(to_numpy_tree(packed), "cpu")
    jeng = JaxEngine(packed, CFG, max_slots=4, max_len=512, cache_dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0), eos_token_id=None)
    teng = Engine(tpacked, TCFG, max_slots=4, max_len=512, cache_dtype=torch.float32,
                  sampling=SamplingParams(temperature=0.0), eos_token_id=None, device="cpu")
    return jeng, teng


class _Record:
    def __init__(self, fn):
        self.fn, self.out = fn, []

    def __call__(self, requests):
        res = self.fn(requests)
        self.out += res
        return res


def test_greedy_until_equals_jax(engines):
    jeng, teng = engines
    reqs = [("Question: 2+2?\nAnswer:", ("\n",)), ("abc", ("a",)), ("hello", (":", "."))]
    got = T.GreedyUntilFn(teng, CharTok(), max_new_tokens=12)(reqs)
    want = J.GreedyUntilFn(jeng, CharTok(), max_new_tokens=12)(reqs)
    assert got == want


def test_run_gen_tasks_equals_jax(engines, monkeypatch):
    """gsm8k (0-shot docs from the fixture: the 5-shot prompts pass the
    tiny model's cache) and triviaqa from theirs, through both engines."""
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))
    for mod in (T, J):
        loader, post, match = mod.GEN_TASKS["gsm8k"]
        monkeypatch.setitem(mod.GEN_TASKS, "gsm8k",
                            (lambda m=mod: m._gsm8k_gen_docs(n_fewshot=0), post, match))
    jeng, teng = engines
    tgen = _Record(T.GreedyUntilFn(teng, CharTok(), max_new_tokens=6))
    jgen = _Record(J.GreedyUntilFn(jeng, CharTok(), max_new_tokens=6))
    got = T.run_gen_tasks(tgen, ["gsm8k", "triviaqa"], limit=3)
    want = J.run_gen_tasks(jgen, ["gsm8k", "triviaqa"], limit=3)
    assert got == want and got["gsm8k"]["n"] == 3 and got["triviaqa"]["n"] == 3
    assert tgen.out == jgen.out and len(tgen.out) == 6
    assert T._gsm8k_extract("so #### 1,234") == J._gsm8k_extract("so #### 1,234") == "1234"
    assert T._triviaqa_match(" Paris.", ["paris"]) and J._triviaqa_match(" Paris.", ["paris"])


def test_gsm8k_gen_docs_equal_jax(monkeypatch):
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))
    got, want = T._gsm8k_gen_docs(), J._gsm8k_gen_docs()
    assert len(got) == len(want) == 100
    assert [(d.context, d.target, d.until) for d in got] == \
        [(d.context, d.target, d.until) for d in want]
