"""The int8 KV cache against the JAX package's compiled one (C10).

The JAX engine quantizes its cache only inside compiled code (`_insert`
and the forward's write-back under `_decode` / `_spec`), where XLA turns
`amax / 127.0` into a product with f32(1/127): the port's `quantize_kv`
rounds its scales so, and its codes and scales are held bit-equal to
`jax.jit` of JAX's on the same inputs. The int8 cache after an insert and
after a write-back, fed the same k/v, is bit-equal to JAX's.

The long greedy stream (a 60-token prompt, 75 new tokens through 64 -> 256
rows on a packed int2-g64 f32 TINY_TEST) still leaves JAX's at token 40,
where the two engines split a near-tie: the prefill's f32 k/v differ between
XLA and PyTorch at the ulp level (the matmuls sum in another order), and
int8 codes with f32 scales pass that noise on where a bf16 cache absorbs it.
The stream is held by the tie rule instead (`chip_smoke.py:tie_rule` on the
CPU): equal up to the divergence, and from there every token of the port's
stream within MARGIN of the top logit of JAX's dense forward over that
stream. MARGIN is INT8_DELTA, the largest |logit| gap measured between JAX's
int8-cache path and its dense forward at the positions before the
divergence (0.0699 there, rounded up to 0.075). The largest margin the
port's stream reads is 0.0: it takes the dense forward's top token at every
position, the divergence too, where JAX's int8 token sits 0.0194 below."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models import llama as jl
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu.serve import Engine as JaxEngine
from bitdistiller_tpu.serve import SamplingParams as JaxSampling
from bitdistiller_tpu_torch.models import llama as tl
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.serve import Engine, SamplingParams
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TCFG = torch_cfg(CFG)
PROMPT_LEN, NEW = 60, 75
ENGINE = dict(max_slots=2, max_len=256, decode_horizon=2, eos_token_id=None)
INT8_DELTA = 0.075  # the int8 path's largest gap to the dense forward, measured 0.0699
MARGIN = INT8_DELTA


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jparams = pack_model(init_params(CFG, jax.random.key(0), dtype=jnp.float32),
                         CFG, bits=2, group_size=64)
    return jparams, params_from_numpy(to_numpy_tree(jparams), "cpu")


@pytest.fixture(scope="module")
def jax_engine(models):
    return JaxEngine(models[0], CFG, cache_dtype=jnp.int8, sampling=JaxSampling(temperature=0.0),
                     **ENGINE)


def _bits(x) -> np.ndarray:
    x = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 2, 4, 300, 32), (3, 7, 64), (2, 5, 128)])
def test_quantize_kv_bit_equal_to_jitted_jax(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1])[..., None])
    x = x.astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0  # a zero row: the scale's floor
    jx = jnp.asarray(x).astype(dtype)
    codes, scale = jax.jit(jl.quantize_kv)(jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tcodes, tscale = tl.quantize_kv(tx)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(_bits(tscale), _bits(scale))


def _jax_write_back(cache, nk, nv, pos):
    """The write-back of JAX's cached forward at per-slot positions
    (bitdistiller_tpu/models/llama.py:646-670, which has no entry of its
    own), compiled as there: fresh k/v [L, B, S, Hkv, D]."""
    nk = nk.transpose(0, 1, 3, 2, 4)
    nv = nv.transpose(0, 1, 3, 2, 4)
    nk, nks = jl.quantize_kv(nk)
    nv, nvs = jl.quantize_kv(nv)
    upd = jax.vmap(lambda b, n, p: jax.lax.dynamic_update_slice(b, n, (0, 0, p, 0)),
                   in_axes=(1, 1, 0), out_axes=1)
    supd = jax.vmap(lambda b, n, p: jax.lax.dynamic_update_slice(b, n, (0, 0, p)),
                    in_axes=(1, 1, 0), out_axes=1)
    return jl.KVCache(k=upd(cache.k, nk, pos), v=upd(cache.v, nv, pos),
                      k_scale=supd(cache.k_scale, nks, pos), v_scale=supd(cache.v_scale, nvs, pos))


def _assert_cache_equal(tc, jc):
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bits(getattr(tc, name)), _bits(getattr(jc, name)),
                                      err_msg=name)


def test_int8_cache_after_insert_and_write_back_equals_jax(models, jax_engine):
    """JAX's prefill k/v of two prompts, inserted into slots [1, 0] by the
    JAX engine's `_insert` and by the port's, then one fresh token's k/v
    written back at per-slot positions by both: every code and scale
    bit-equal."""
    jparams, tparams = models
    rng = np.random.default_rng(7)
    padded = np.zeros((2, 64), np.int32)
    padded[0, :50] = rng.integers(3, CFG.vocab_size, 50)
    padded[1, :33] = rng.integers(3, CFG.vocab_size, 33)
    _, kv = jax_engine._prefill(jparams, jnp.asarray(padded), jnp.asarray([49, 32], jnp.int32))
    jc = jax_engine._insert(jl.KVCache.init(CFG, 2, 128, jnp.int8), kv,
                            jnp.asarray([1, 0], jnp.int32), jnp.asarray([0, 1], jnp.int32),
                            jnp.asarray(2))
    eng = Engine(tparams, TCFG, cache_dtype=torch.int8, device="cpu", grow_cache=False,
                 **dict(ENGINE, max_len=128))
    tkv = tl.KVCache(k=torch.from_numpy(np.asarray(kv.k)), v=torch.from_numpy(np.asarray(kv.v)))
    eng._insert(tkv, ("prefill", 64, 2), [1, 0], [0, 1])
    _assert_cache_equal(eng.cache, jc)

    shape = (CFG.num_layers, 2, 1, CFG.num_kv_heads, CFG.actual_head_dim)
    nk, nv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = np.asarray([33, 50], np.int32)
    jc = jax.jit(_jax_write_back)(jc, jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(pos))
    tl._write_back(eng.cache, torch.from_numpy(nk), torch.from_numpy(nv),
                   torch.from_numpy(pos), 1)
    _assert_cache_equal(eng.cache, jc)


def test_long_int8_stream_holds_by_the_tie_rule(models, jax_engine):
    jparams, tparams = models
    prompt = np.random.default_rng(1).integers(3, CFG.vocab_size, PROMPT_LEN).tolist()
    ref = jax_engine.generate([prompt], max_new_tokens=NEW)[0]
    eng = Engine(tparams, TCFG, cache_dtype=torch.int8, device="cpu",
                 sampling=SamplingParams(temperature=0.0), **ENGINE)
    got = eng.generate([prompt], max_new_tokens=NEW)[0]
    assert len(got) == len(ref) == NEW
    div = next((j for j, (a, b) in enumerate(zip(ref, got)) if a != b), NEW)

    # the int8 noise: JAX's int8-cache path fed its own stream (its prefill
    # and insert, then S = 1 steps) against its dense forward over it
    dense = jax.jit(lambda p, t: jl.forward(p, CFG, t)[0][0])
    ref_logits = np.asarray(dense(jparams, jnp.asarray([prompt + ref], jnp.int32)))
    padded = np.zeros((1, 64), np.int32)
    padded[0, :PROMPT_LEN] = prompt
    last, kv = jax_engine._prefill(jparams, jnp.asarray(padded),
                                   jnp.asarray([PROMPT_LEN - 1], jnp.int32))
    cache = jax_engine._insert(jl.KVCache.init(CFG, 1, 256, jnp.int8), kv,
                               jnp.asarray([0], jnp.int32), jnp.asarray([0], jnp.int32),
                               jnp.asarray(1))
    step = jax.jit(lambda p, t, c, pos: jl.forward(p, CFG, t, cache=c, cache_pos=pos))
    gaps = [np.abs(np.asarray(last)[0] - ref_logits[PROMPT_LEN - 1]).max()]
    for j in range(div - 1):
        lg, cache = step(jparams, jnp.asarray([[ref[j]]], jnp.int32), cache,
                         jnp.asarray([PROMPT_LEN + j], jnp.int32))
        gaps.append(np.abs(np.asarray(lg)[0, 0] - ref_logits[PROMPT_LEN + j]).max())
    assert max(gaps) <= INT8_DELTA

    # the tie rule: the port's stream through JAX's dense forward
    logits = np.asarray(dense(jparams, jnp.asarray([prompt + got], jnp.int32)))
    at = logits[PROMPT_LEN - 1:PROMPT_LEN - 1 + NEW]
    margins = at.max(axis=1) - at[np.arange(NEW), got]
    assert (margins[div:] <= MARGIN).all(), (div, margins[div:].max())
    if div < NEW:  # the fork is a near-tie: JAX's own token there is within the margin too
        assert at[div].max() - at[div, ref[div]] <= MARGIN
