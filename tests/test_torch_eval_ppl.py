"""The port's perplexity (`eval/ppl.py`) against the JAX package's on the same
inputs: an f32 TINY_TEST made by the JAX package and carried across as numpy
arrays, dense, under the CLI's PTQ int2-g64 quantizer, and packed at
int2-g64. Tolerances: the NLL a block within 2e-5 relative and the
perplexity within 2e-5 relative (f32 forwards, sums in another order);
`prepare_blocks` and the tokenized wikitext fixture equal."""

import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.eval import ppl as jppl
from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model as jax_pack_model
from bitdistiller_tpu.quant.core import make_fake_quantizer as jax_fake_quantizer
from bitdistiller_tpu_torch.eval import ppl as tppl
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.quant.core import make_fake_quantizer
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
NLL_TOL = 2e-5
PPL_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes and loops of small ops: one intra-op thread (the suite
    runs several workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ptq(make):
    """The CLI's PTQ quantizer: int2, groups of 64 along K of [K, N]."""
    q = make("int2", 64)
    return lambda w: q(w.T).T


@pytest.fixture(scope="module")
def trees():
    dense = init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    packed = jax_pack_model(dense, CFG, bits=2, group_size=64)
    return {
        "dense": (dense, params_from_numpy(to_numpy_tree(dense), "cpu"), None, None),
        "ptq_int2_g64": (dense, params_from_numpy(to_numpy_tree(dense), "cpu"),
                         _ptq(jax_fake_quantizer), _ptq(make_fake_quantizer)),
        "packed_int2_g64": (packed, params_from_numpy(to_numpy_tree(packed), "cpu"), None,
                            None),
    }


def _blocks(n, s, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (n, s)).astype(np.int32)


@pytest.mark.parametrize("n,seqlen", [(1000, 128), (2048, 2048), (4095, 2048), (7, 8), (3, 8)])
def test_prepare_blocks_equal(n, seqlen):
    tokens = np.random.default_rng(n).integers(0, 32000, n)
    got, want = tppl.prepare_blocks(tokens, seqlen), jppl.prepare_blocks(tokens, seqlen)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tree", ["dense", "ptq_int2_g64", "packed_int2_g64"])
def test_nll_per_block_equals_jax(trees, tree):
    jparams, tparams, jq, tq = trees[tree]
    tokens = _blocks(3, 48, seed=1)
    want = np.asarray(jppl.make_nll_fn(CFG, jq)(jparams, jnp.asarray(tokens)))
    got = tppl.make_nll_fn(TCFG, tq)(tparams, torch.as_tensor(tokens, dtype=torch.int64))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=NLL_TOL)


@pytest.mark.parametrize("tree", ["dense", "ptq_int2_g64", "packed_int2_g64"])
def test_perplexity_equals_jax_with_the_remainder_batch(trees, tree):
    """7 blocks at batch 3: two full batches and the remainder of 1, with the
    progress calls of each."""
    jparams, tparams, jq, tq = trees[tree]
    blocks = _blocks(7, 32, seed=2)
    jcalls, tcalls = [], []
    want = jppl.perplexity(jparams, CFG, blocks, quantizer=jq, batch_size=3,
                           progress=lambda d, n: jcalls.append((d, n)))
    got = tppl.perplexity(tparams, TCFG, blocks, quantizer=tq, batch_size=3,
                          progress=lambda d, n: tcalls.append((d, n)), device="cpu")
    assert tcalls == jcalls == [(3, 7), (6, 7), (7, 7)]
    np.testing.assert_allclose(got, want, rtol=PPL_TOL)


def test_batch_larger_than_the_blocks_takes_the_remainder_path(trees):
    jparams, tparams, _, _ = trees["dense"]
    blocks = _blocks(2, 16, seed=3)
    want = jppl.perplexity(jparams, CFG, blocks, batch_size=8)
    got = tppl.perplexity(tparams, TCFG, blocks, batch_size=8, device="cpu")
    np.testing.assert_allclose(got, want, rtol=PPL_TOL)


def test_target_logprobs_row_by_row_equals_the_whole_batch():
    logits = torch.randn(3, 5, 11, generator=torch.Generator().manual_seed(0))
    targets = torch.randint(0, 11, (3, 5), generator=torch.Generator().manual_seed(1))
    whole = torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    assert torch.equal(tppl.target_logprobs(logits, targets), whole)


def test_a_leaf_on_another_device_raises(trees):
    _, tparams, _, _ = trees["packed_int2_g64"]
    blocks = _blocks(2, 16)
    moved = dict(tparams, embed=tparams["embed"].to("meta"))
    with pytest.raises(ValueError, match="lies on meta"):
        tppl.perplexity(moved, TCFG, blocks, device="cpu")
    qkv = tparams["layers"]["qkv"]
    moved = dict(tparams, layers=dict(tparams["layers"],
                                      qkv=dataclasses.replace(qkv, combo=qkv.combo.to("meta"))))
    with pytest.raises(ValueError, match="lies on meta"):
        tppl.perplexity(moved, TCFG, blocks, device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        tppl.perplexity(tparams, TCFG, blocks, device="meta")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card default")
def test_default_device_is_the_card_and_raises_without_one(trees):
    _, tparams, _, _ = trees["dense"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tppl.perplexity(tparams, TCFG, _blocks(1, 8))


class _CallTok:
    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]

    def __call__(self, s, **kw):
        return types.SimpleNamespace(input_ids=self.encode(s))


def test_load_wikitext2_test_equals_jax(monkeypatch):
    monkeypatch.setenv("BITDISTILLER_DATA_DIR", str(FIXTURES))
    got = tppl.load_wikitext2_test(_CallTok())
    want = jppl.load_wikitext2_test(_CallTok())
    assert got.dtype == want.dtype == np.int32 and len(got) == 286297
    np.testing.assert_array_equal(got, want)
    assert tppl.prepare_blocks(got, 2048).shape == (139, 2048)
