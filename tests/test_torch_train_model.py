"""The port's training forward against the JAX package's `llama.forward`:
logits and the gradients of every param leaf, with the int2-asym STE weight
quantizer (g64) and a padding mask, under each remat policy (False, "full",
"save_quantized", "save_dots", "save_qkvo"), TINY_TEST widths in f32. Also
`fake_quant_weights`, `quantize_layer_weights`, the training flash rule
(BITDISTILLER_TRAIN_FLASH) and the port's own init_params.

Tolerance: f32 logits within 1e-4 of max|JAX| and gradients within 1e-3 of
each leaf's max|JAX| (the same f32 operations, summed in another order; a
quantized weight that sits on a rounding boundary could flip, and none
does at these inputs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST as JT
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.models import llama as jllama
from bitdistiller_tpu.quant.core import make_weight_quantizer as jmq
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.quant.core import make_weight_quantizer as tmq
from bitdistiller_tpu_torch.train.trainer import tree_items, tree_map
from torch_port_util import to_numpy_tree, torch_cfg

JCFG = dataclasses.replace(JT, dtype="float32")
TCFG = torch_cfg(JCFG)


@pytest.fixture(scope="module")
def setup():
    params = jinit(JCFG, jax.random.key(0), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, JCFG.vocab_size, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 29:] = 0
    return params, toks, mask


def _jax_loss(params, toks, mask, remat):
    q = jmq("int2-asym", 64)
    logits, _ = jllama.forward(params, JCFG, jnp.asarray(toks), quantizer=q,
                               attn_mask=jnp.asarray(mask), remat=remat)
    lp = jax.nn.log_softmax(logits)
    return (lp[..., 3] * mask).sum() / 80.0, logits


def _torch_loss(params, toks, mask, remat):
    logits, _ = tllama.forward(params, TCFG, torch.tensor(toks, dtype=torch.int64),
                               quantizer=tmq("int2-asym", 64),
                               attn_mask=torch.tensor(mask), remat=remat)
    lp = torch.log_softmax(logits, dim=-1)
    return (lp[..., 3] * torch.tensor(mask)).sum() / 80.0, logits


@pytest.mark.parametrize("remat", [False, "full", "save_quantized", "save_dots", "save_qkvo"])
def test_training_forward_logits_and_grads(setup, remat):
    params, toks, mask = setup
    (jl, jlogits), jg = jax.value_and_grad(_jax_loss, has_aux=True)(
        params, toks, mask, True if remat == "full" else remat)
    tparams = tree_map(lambda x: x.requires_grad_(True),
                       params_from_numpy(to_numpy_tree(params), "cpu"))
    tl, tlogits = _torch_loss(tparams, toks, mask, remat)
    tl.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4 * float(jnp.abs(jlogits).max()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    for path, leaf in tree_items(tparams):
        want = jflat[path]
        err = np.abs(leaf.grad.numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 1e-7, (path, err)


def test_train_flash_rule(setup, monkeypatch):
    """BITDISTILLER_TRAIN_FLASH=1 (or use_train_flash=True) routes attention
    through flash_train_attention: on the CPU its plain version, whose
    segment-id semantics match the mask path on the real rows."""
    params, toks, mask = setup
    tparams = params_from_numpy(to_numpy_tree(params), "cpu")
    args = (tparams, TCFG, torch.tensor(toks, dtype=torch.int64))
    ref, _ = tllama.forward(*args, attn_mask=torch.tensor(mask))
    monkeypatch.setenv("BITDISTILLER_TRAIN_FLASH", "1")
    assert tllama.train_flash_enabled(None) and not tllama.train_flash_enabled(False)
    fl, _ = tllama.forward(*args, attn_mask=torch.tensor(mask))
    keep = torch.tensor(mask).bool()
    assert (fl - ref)[keep].abs().max().item() <= 1e-4 * ref.abs().max().item()
    monkeypatch.setenv("BITDISTILLER_TRAIN_FLASH", "0")
    assert not tllama.train_flash_enabled(None) and tllama.train_flash_enabled(True)


@pytest.mark.parametrize("quant_type", ["int2-asym", "ste-n2f3", "int3"])
def test_fake_quant_and_quantize_layer_weights(setup, quant_type):
    params, _, _ = setup
    tparams = params_from_numpy(to_numpy_tree(params), "cpu")
    jf = jllama.fake_quant_weights(params, jmq(quant_type, 64))
    tf = tllama.fake_quant_weights(tparams, tmq(quant_type, 64))
    jq = jllama.quantize_layer_weights(params, jmq(quant_type, 64))
    tq = tllama.quantize_layer_weights(tparams, tmq(quant_type, 64))
    for j, t in ((jf, tf), (jq, tq)):
        jflat = dict(tree_items(jax.tree_util.tree_map(np.asarray, j)))
        for path, leaf in tree_items(t):
            np.testing.assert_allclose(leaf.numpy(), jflat[path], rtol=1e-6, atol=1e-7)


def test_init_params_layout_matches_jax():
    t = tllama.init_params(TCFG, seed=0, dtype=torch.float32, device="cpu")
    j = jinit(JCFG, jax.random.key(0), dtype=jnp.float32)
    jshapes = {p: np.shape(x) for p, x in tree_items(jax.tree_util.tree_map(np.asarray, j))}
    tshapes = {p: tuple(x.shape) for p, x in tree_items(t)}
    assert tshapes == jshapes
    w = t["layers"]["q"]["w"]
    assert abs(w.std().item() * JCFG.hidden_size ** 0.5 - 1.0) < 0.05
