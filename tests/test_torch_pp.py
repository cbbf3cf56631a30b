"""The port's GPipe (`parallel/pipeline.py`) on 4 spawned gloo ranks
(tests/torch_tp_worker.py:pp_job), the counterparts of the JAX package's
tests/test_pipeline_parallel.py: `pipeline_forward` over the first pp
ranks at (pp, n_micro) = (2, 2), (4, 2), (4, 4), (2, 1) on the tiny f32
config cut to 4 layers, against JAX's `pipeline_forward` on a pp CPU mesh
and the port's one-process forward, on every rank (ranks 2 and 3 lie
outside a pp = 2 pipeline and receive the logits all the same); the
fake-quant student (int2-g32 quantized in the forward) at pp = 4; a packed
int4-g64 tree at pp = 2 (its PackedLinear fields cut along L). Tolerance
2e-4 (rtol and atol). The spec table and the
refusals need no rank."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST
from bitdistiller_tpu.models import forward as jforward
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.parallel.pipeline import make_pp_mesh as jmake_pp_mesh
from bitdistiller_tpu.parallel.pipeline import pipeline_forward as jpipeline_forward
from bitdistiller_tpu.parallel.pipeline import shard_params_pp as jshard_params_pp
from bitdistiller_tpu.quant.core import make_fake_quantizer as jmake_fake_quantizer
from bitdistiller_tpu_torch.models import llama
from bitdistiller_tpu_torch.models.quantized import pack_model, params_from_numpy
from bitdistiller_tpu_torch.parallel.mesh import P
from bitdistiller_tpu_torch.parallel.pipeline import (PPMesh, make_pp_mesh, pipeline_forward,
                                                      pp_param_specs, shard_params_pp)
from bitdistiller_tpu_torch.quant.core import make_fake_quantizer
from bitdistiller_tpu_torch.quant.packing import PackedLinear
from test_torch_dp_worker import spawn
from torch_port_util import to_numpy_tree, torch_cfg

JCFG = dataclasses.replace(TINY_TEST, num_layers=4, dtype="float32")
TCFG = torch_cfg(JCFG)
CASES = [(2, 2), (4, 2), (4, 4), (2, 1)]
TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    jparams = jinit(JCFG, jax.random.key(0), dtype=jnp.float32)
    tparams = params_from_numpy(to_numpy_tree(jparams), "cpu")
    tokens = np.random.default_rng(0).integers(0, JCFG.vocab_size, (4, 16)).astype(np.int64)
    packed = pack_model(tparams, TCFG, bits=4, group_size=64, fuse=False)
    ranks = spawn({"kind": "call", "target": "torch_tp_worker:pp_job", "cfg": TCFG,
                   "params": tparams, "packed": packed, "tokens": torch.from_numpy(tokens),
                   "cases": CASES}, world=4)
    return jparams, tparams, packed, tokens, ranks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pp,n_micro", CASES)
def test_pipeline_forward_matches_jax_and_dense(setup, pp, n_micro):
    jparams, tparams, _, tokens, ranks = setup
    want = llama.forward(tparams, TCFG, torch.from_numpy(tokens))[0]
    mesh = jmake_pp_mesh(pp)
    jgot = jpipeline_forward(jshard_params_pp(jparams, mesh), JCFG, jnp.asarray(tokens, jnp.int32),
                             mesh, n_micro=n_micro)
    _close(want, jgot)
    for out in ranks:
        _close(out[(pp, n_micro)], want)
        _close(out[(pp, n_micro)], jgot)


def test_pipeline_forward_fake_quant(setup):
    """The KD-QAT quantize-on-forward closure rides through the stages."""
    jparams, tparams, _, tokens, ranks = setup
    q = make_fake_quantizer("int2", 32)
    want = llama.forward(tparams, TCFG, torch.from_numpy(tokens),
                         quantizer=lambda w: q(w.t()).t())[0]
    jq = jmake_fake_quantizer("int2", 32)
    jwant = jforward(jparams, JCFG, jnp.asarray(tokens, jnp.int32), quantizer=lambda w: jq(w.T).T)[0]
    _close(want, jwant)
    for out in ranks:
        _close(out["fake_quant"], want)


def test_pipeline_forward_packed(setup):
    _, _, packed, tokens, ranks = setup
    want = llama.forward(packed, TCFG, torch.from_numpy(tokens))[0]
    for out in ranks:
        _close(out["packed"], want)


def test_pipeline_specs_and_refusals(setup):
    _, tparams, packed, tokens, _ = setup
    specs = pp_param_specs(packed)
    for name, leaf in specs["layers"].items():
        parts = ([leaf.qweight, leaf.scales, leaf.szeros, leaf.combo]
                 if isinstance(leaf, PackedLinear) else [leaf])
        assert all(p == P("pp") for p in parts if p is not None), name
    assert specs["embed"] == P() and specs["final_norm"] == P()
    cut = shard_params_pp(packed, PPMesh(pp=2, stage=1))
    assert cut["layers"]["down"].qweight.shape[0] == 2
    assert torch.equal(cut["layers"]["down"].qweight, packed["layers"]["down"].qweight[2:])
    assert shard_params_pp(packed, PPMesh(pp=2, stage=None))["layers"] == {}
    toks = torch.from_numpy(tokens)
    with pytest.raises(ValueError, match="num_layers"):  # 4 layers over 3 stages
        pipeline_forward(tparams, TCFG, toks, PPMesh(pp=3), n_micro=2)
    with pytest.raises(ValueError, match="n_micro"):
        pipeline_forward(tparams, TCFG, toks, PPMesh(pp=2), n_micro=3)
    with pytest.raises(ValueError, match="device count"):  # one process, no group
        make_pp_mesh(2)
