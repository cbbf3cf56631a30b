"""The port's serving capacity planner (`serve/capacity.py`) against the JAX
package's on every preset and on the families' published configs (the
full-width Hugging Face dicts chip_smoke.py serves, and the tiny Bloom and
OPT dicts): the packed weights' bytes, the KV bytes a slot and the slot
counts equal. The KV bytes equal the port's own KVCache.init; the packed
estimate lands near a real pack_model tree."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import bitdistiller_tpu.models.config as jconfig
from bitdistiller_tpu.serve import capacity as jcap
from bitdistiller_tpu_torch.models import KVCache, init_params, pack_model
from bitdistiller_tpu_torch.serve import capacity as tcap
from bitdistiller_tpu_torch.serve import engine as engine_mod
from chip_smoke import FAMILIES
from torch_port_util import torch_cfg

PRESETS = {n: getattr(jconfig, n) for n in ("TINY_TEST", "TINYLLAMA_1B", "LLAMA2_7B",
                                            "FALCON_7B", "MPT_7B")}
TINY_HF = {
    "bloom": {"model_type": "bloom", "vocab_size": 128, "hidden_size": 96, "n_layer": 2,
              "n_head": 6, "layer_norm_epsilon": 1e-5},
    "opt": {"model_type": "opt", "vocab_size": 128, "hidden_size": 64, "ffn_dim": 128,
            "num_hidden_layers": 2, "num_attention_heads": 4, "max_position_embeddings": 64,
            "activation_function": "relu", "enable_bias": True},
    "falcon40b": {"model_type": "falcon", "vocab_size": 128, "hidden_size": 64,
                  "num_hidden_layers": 2, "num_attention_heads": 4, "num_kv_heads": 2,
                  "new_decoder_architecture": True},
}
CONFIGS = {**PRESETS,
           **{name: jconfig.ModelConfig.from_hf_config(FAMILIES[name][0]) for name in FAMILIES},
           **{name: jconfig.ModelConfig.from_hf_config(hf) for name, hf in TINY_HF.items()}}
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8),
      "f32": (jnp.float32, torch.float32)}
GiB = 1 << 30


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_capacity_equals_jax(name):
    jc = CONFIGS[name]
    tc = torch_cfg(jc)
    g = 64 if jc.hidden_size % 128 else 128  # Falcon-7B's 4544
    for bits in (2, 4):
        assert tcap.packed_model_bytes(tc, bits=bits, group_size=g) == jcap.packed_model_bytes(
            jc, bits=bits, group_size=g)
    for jd, td in KV.values():
        assert tcap.kv_bytes_per_slot(tc, 2048, td) == jcap.kv_bytes_per_slot(jc, 2048, jd)
    for grow in (True, False):
        for jd, td in KV.values():
            kw = dict(bits=2, group_size=g, max_len=2048, hbm_bytes=80 * GiB, grow_cache=grow)
            assert _eager(tcap.serve_capacity(tc, kv_dtype=td, graphs=False, **kw)) == (
                jcap.serve_capacity(jc, kv_dtype=jd, **kw))
    kw = dict(group_size=g, hbm_bytes=16 * GiB, tp=2, prompt_cache_bytes=GiB)
    assert _eager(tcap.serve_capacity(tc, graphs=False, **kw)) == jcap.serve_capacity(jc, **kw)


def _eager(cap: dict) -> dict:
    """The plan without the graph route's rows, which JAX's has no key for
    (none under graphs=False)."""
    cap = dict(cap)
    assert cap.pop("graph_rows_bytes") == 0
    return cap


def test_graph_route_counts_its_prefill_rows():
    """The graph route's engine-owned prefill rows come out of the budget:
    on the 7B, k and v of 2048 rows of 32 layers at 32 bf16 heads of 128,
    1 GiB exactly."""
    cfg = torch_cfg(PRESETS["LLAMA2_7B"])
    on = tcap.serve_capacity(cfg, hbm_bytes=80 * GiB)
    off = tcap.serve_capacity(cfg, hbm_bytes=80 * GiB, graphs=False)
    assert on["graph_rows_bytes"] == GiB
    assert off["budget_bytes"] - on["budget_bytes"] == GiB
    assert on["max_slots"] <= off["max_slots"]


def test_graph_route_counts_a_tp_rank_prefill_rows():
    """Under a mesh the engine takes the graph route too: at tp = 2 a 7B
    rank's prefill rows hold its 16 kv heads, half a GiB, out of its
    budget; the rest of the plan is the eager one's."""
    cfg = torch_cfg(PRESETS["LLAMA2_7B"])
    kw = dict(hbm_bytes=80 * GiB, tp=2)
    on = tcap.serve_capacity(cfg, **kw)
    off = tcap.serve_capacity(cfg, graphs=False, **kw)
    assert on["graph_rows_bytes"] == engine_mod.graph_rows_bytes(cfg, 2) == GiB // 2
    assert off["budget_bytes"] - on["budget_bytes"] == GiB // 2
    assert on["max_slots"] <= off["max_slots"]
    for key in ("weights_bytes", "kv_bytes_per_slot"):
        assert on[key] == off[key]


@pytest.mark.parametrize("kv", sorted(KV))
def test_kv_bytes_equal_the_port_cache(kv):
    cfg = torch_cfg(PRESETS["TINY_TEST"])
    dtype = KV[kv][1]
    cache = KVCache.init(cfg, 3, 64, dtype, device="cpu")
    leaves = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale] if cache.quantized else [])
    assert tcap.kv_bytes_per_slot(cfg, 64, dtype) == sum(t.nbytes for t in leaves) // 3


def test_packed_estimate_near_a_real_tree():
    cfg = dataclasses.replace(torch_cfg(PRESETS["TINY_TEST"]), dtype="bfloat16")
    packed = pack_model(init_params(cfg, seed=0, device="cpu"), cfg, bits=4, group_size=64)

    def nbytes(node):
        if isinstance(node, dict):
            return sum(nbytes(v) for v in node.values())
        if isinstance(node, torch.Tensor):
            return node.nbytes
        return node.qweight.nbytes + node.combo.nbytes  # what the kernels read
    est = tcap.packed_model_bytes(cfg, bits=4, group_size=64)
    assert 0.8 <= est / nbytes(packed) <= 1.2


def test_7b_slot_ordering_and_growth_peak():
    """Int8 KV fits more slots than bf16; a growing cache plans fewer
    (old and new coexist during a copy); tp divides the weights."""
    cfg = torch_cfg(PRESETS["LLAMA2_7B"])
    bf16 = tcap.serve_capacity(cfg, hbm_bytes=80 * GiB, grow_cache=False)
    i8 = tcap.serve_capacity(cfg, hbm_bytes=80 * GiB, kv_dtype=torch.int8, grow_cache=False)
    grown = tcap.serve_capacity(cfg, hbm_bytes=80 * GiB)
    assert i8["max_slots"] > bf16["max_slots"] > grown["max_slots"] > 0
    assert grown["kv_bytes_per_slot"] == bf16["kv_bytes_per_slot"] * 3 // 2
    tp2 = tcap.serve_capacity(cfg, hbm_bytes=80 * GiB, tp=2, grow_cache=False)
    assert tp2["weights_bytes"] == bf16["weights_bytes"] // 2


def test_memory_defaults_to_the_card():
    """Without hbm_bytes the planner reads the current card's memory; with
    no card it raises instead of assuming a size."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; its memory is the default")
    with pytest.raises(RuntimeError, match="hbm_bytes"):
        tcap.serve_capacity(torch_cfg(PRESETS["LLAMA2_7B"]))
