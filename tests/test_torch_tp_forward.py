"""The port's tensor-parallel forward on 2 spawned gloo ranks (tp = 2,
tests/torch_tp_worker.py:forward_job), on the tiny f32 config (4 query and
2 kv heads: one kv head a rank), against the port's single process and
JAX's `forward` under `make_mesh(dp=1, tp=2)` (the JAX package's
tests/test_parallel.py:29 and :41 way):

- the dense forward's logits, and the gradients of every leaf (each rank's
  slice of the single process's gradient, by the leaf's spec; the whole one
  for a leaf replicated over tp), with and without remat "save_dots"; and
  so for eight tiny family trees (`FAMILIES`);
- the packed unfused int4-g64 prefill and per-slot decode step over a bf16
  and an int8 cache (the step through the decode attention's route), the
  bucketed attn_len, and each rank's cache slice (its kv head; int8 codes
  within one step).

Tolerances, one f32 run against another summed in another order (the
row-parallel o and down as two partial products summed in f32): logits and
gradients 1e-5 of the largest magnitude (measured: TINY_TEST's logits
5.4e-7, its gradients 1.1e-6, the families' 2.1e-6, the packed prefill and
step 1.5e-6); against JAX's mesh (XLA against PyTorch) 1e-4 (measured
5.8e-7). Every rank's logits are equal bit for bit: they are gathered."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST as JT
from bitdistiller_tpu.models import KVCache as JKVCache
from bitdistiller_tpu.models import forward as jforward
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.models.quantized import pack_model as jpack
from bitdistiller_tpu.parallel.mesh import make_mesh as jmake_mesh
from bitdistiller_tpu.parallel.mesh import param_specs as jparam_specs
from bitdistiller_tpu.parallel.mesh import shard_packed_model as jshard_packed
from bitdistiller_tpu.parallel.mesh import shard_params as jshard_params
from bitdistiller_tpu_torch.models.quantized import pack_model, params_from_numpy
from bitdistiller_tpu_torch.parallel.mesh import Mesh, param_specs, take
from bitdistiller_tpu_torch.train.trainer import _get
from test_torch_dp_worker import spawn
from test_torch_families import _params, _tcfg
from torch_port_util import to_numpy_tree, torch_cfg
from torch_tp_worker import CACHE_DTYPES, decode_run, dense_grads

JCFG = dataclasses.replace(JT, dtype="float32")
TCFG = torch_cfg(JCFG)
TOKENS = np.arange(16, dtype=np.int64).reshape(2, 8) * 7 % JCFG.vocab_size
TOL, JAX_TOL = 1e-5, 1e-4
# every family flag a tp slice meets: biases on both sides of the split
# (bloom, opt, qwen2), ALiBi's per-head slopes (bloom, mpt), the parallel
# block with its second norm (falcon40b), q/k norms applied to a rank's heads
# and per-layer windows (gemma_sliding, qwen3), learned positions (opt), the
# embedding norm (bloom), a uniform window (phi3), tied lm_heads
FAMILIES = ("bloom", "falcon40b", "gemma_sliding", "mpt", "opt", "phi3", "qwen2", "qwen3")
JCACHE = {"bf16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(scope="module")
def run():
    jparams = jinit(JCFG, jax.random.key(0), dtype=jnp.float32)
    tparams = params_from_numpy(to_numpy_tree(jparams), "cpu")
    families = {name: (_tcfg(name), _params(name)[1], _family_tokens())
                for name in FAMILIES}
    ranks = spawn({"kind": "call", "target": "torch_tp_worker:forward_job", "tp": 2,
                   "cfg": TCFG, "params": tparams, "tokens": torch.from_numpy(TOKENS),
                   "families": families})
    return jparams, tparams, ranks, families


def _family_tokens():
    return torch.from_numpy(np.random.default_rng(3).integers(0, 128, (2, 9)))


def _close(got, want, tol):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(scale, 1.0), (err, scale)


def _slice(whole, spec, rank):
    return take(whole, spec, Mesh(dp=1, tp=2, tp_rank=rank))


def test_dense_tp_forward_matches_single_and_jax(run):
    jparams, tparams, ranks, _ = run
    want, _ = dense_grads(tparams, TCFG, torch.from_numpy(TOKENS))
    assert torch.equal(ranks[0]["dense"][0], ranks[1]["dense"][0])
    _close(ranks[0]["dense"][0], want, TOL)
    mesh = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        sharded = jshard_params(jparams, mesh, jparam_specs(JCFG))
        jout, _ = jax.jit(lambda p, t: jforward(p, JCFG, t))(sharded,
                                                             jnp.asarray(TOKENS, jnp.int32))
    _close(ranks[0]["dense"][0], torch.from_numpy(np.asarray(jout)), JAX_TOL)


@pytest.mark.parametrize("which", ["dense", "remat"])
def test_dense_tp_gradients_are_the_single_process_slices(run, which):
    """Every leaf's gradient through copy_to_tp, reduce_from_tp,
    gather_from_tp and the vocab-parallel embedding (remat: the collectives
    issued again in the recompute) is the rank's slice of the whole one."""
    _, tparams, ranks, _ = run
    _, want = dense_grads(tparams, TCFG, torch.from_numpy(TOKENS))
    specs = param_specs(TCFG)
    for key, g in want.items():
        spec = _get(specs, tuple(key.split("/")))
        for r, out in enumerate(ranks):
            got = out["dense"][1][key] if which == "dense" else out["remat"][key]
            _close(got, _slice(g, spec, r), TOL)


@pytest.mark.parametrize("cache", sorted(CACHE_DTYPES))
def test_packed_tp_decode_matches_single(run, cache):
    """pack_model(fuse=False) cut by shard_packed_model: the prefill, the
    per-slot decode step and each rank's kv head of the cache equal the
    single process's; the prefill equals JAX's on its tp = 2 mesh over a
    cache of the same dtype."""
    jparams, tparams, ranks, _ = run
    packed = pack_model(tparams, TCFG, bits=4, group_size=64, fuse=False)
    pre, step, k = decode_run(packed, TCFG, cache_dtype=CACHE_DTYPES[cache])
    for r, out in enumerate(ranks):
        got_pre, got_step, got_k = out["packed"][cache]
        _close(got_pre, pre, TOL)
        _close(got_step, step, TOL)
        if cache == "int8":  # codes: a k a few ulps off may round to the next one
            assert float((got_k - k.narrow(2, r, 1)).abs().max()) <= 1
        else:
            _close(got_k, k.narrow(2, r, 1), TOL)
    if cache == "bf16":
        for out in ranks:  # the bucketed read: the same step
            _close(out["packed_attn_len"], step, TOL)
    jpacked = jpack(jparams, JCFG, bits=4, group_size=64, fuse=False)
    mesh = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        sp = jshard_packed(jpacked, mesh, JCFG)
        jcache = JKVCache.init(JCFG, batch=2, max_len=16, dtype=JCACHE[cache])
        jout, _ = jax.jit(lambda p, c, t: jforward(p, JCFG, t, cache=c, cache_pos=0))(
            sp, jcache, jnp.arange(8, dtype=jnp.int32).reshape(2, 4))
    _close(ranks[0]["packed"][cache][0], torch.from_numpy(np.asarray(jout)), JAX_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tp_forward_and_gradients(run, name):
    """Each family's dense forward at tp = 2 and every leaf's gradient, held
    as the TINY_TEST case (its randomized tree: biases off zero, norms off
    one)."""
    _, _, ranks, families = run
    cfg, params, tokens = families[name]
    want, grads = dense_grads(params, cfg, tokens)
    specs = param_specs(cfg)
    for r, out in enumerate(ranks):
        logits, got = out["families"][name]
        _close(logits, want, TOL)
        for key, g in grads.items():
            _close(got[key], _slice(g, _get(specs, tuple(key.split("/"))), r), TOL)
