"""The port's tensor-parallel tables and rules against the JAX package's,
with no process group:

- `pack_model(..., fuse=False)` gives JAX's words, scales, zeros, combo
  words and biases bit for bit (every tiny family tree, and TINY_TEST);
- `param_specs` (with and without fsdp), `packed_param_specs` and
  `kv_cache_specs` equal JAX's entry for entry, on every tiny family tree
  and the presets;
- what tp refuses: a head count or MLP width that tp does not divide
  (Falcon-7B's one kv head), a fused `qkv` / `gate_up` leaf (the port's
  choice: refused with its name, never split part by part), a row-parallel
  slice whose quantization groups would straddle a shard edge, a world that
  is not dp * tp, tp groups across hosts;
- `dp_train_scaling` and `tp_decode_scaling` equal JAX's at equal link
  figures (exactly: the same formula in f64), and the port's defaults are
  the H100's data-sheet figures, not JAX's v5e ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import config as jconfig
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.models.quantized import pack_model as jpack
from bitdistiller_tpu.parallel import mesh as jmesh
from bitdistiller_tpu.serve import capacity as jcap
from bitdistiller_tpu.train import memory as jmem
from bitdistiller_tpu.train import trainer as jtr
from bitdistiller_tpu_torch.models import config as tconfig
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import pack_model, params_from_numpy
from bitdistiller_tpu_torch.parallel import distributed as tdist
from bitdistiller_tpu_torch.parallel import mesh as tmesh
from bitdistiller_tpu_torch.parallel.tensor import tp_config
from bitdistiller_tpu_torch.serve import capacity as tcap
from bitdistiller_tpu_torch.train import memory as tmem
from bitdistiller_tpu_torch.train import trainer as ttr
from test_torch_families import MODELS, _params, _tcfg
from torch_port_util import t2n, to_numpy_tree, torch_cfg

PRESETS = ("TINY_TEST", "TINYLLAMA_1B", "LLAMA2_7B", "FALCON_7B", "MPT_7B")
TREES = sorted(MODELS) + list(PRESETS)
TP2 = tmesh.Mesh(dp=1, tp=2, tp_rank=0)  # a rank's coordinates; no collective is reached


def _configs(name):
    if name in MODELS:
        return MODELS[name], _tcfg(name)
    return getattr(jconfig, name), getattr(tconfig, name)


def _walk(j, t, where=()):
    """Every entry of JAX's spec tree against the port's, keys included."""
    if isinstance(t, dict):
        assert isinstance(j, dict) and sorted(j) == sorted(t), (where, sorted(j), sorted(t))
        for k in t:
            _walk(j[k], t[k], where + (k,))
    else:
        assert tuple(t) == tuple(j), (where, t, j)


@pytest.mark.parametrize("name", TREES)
def test_spec_trees_equal_jax(name):
    jcfg, tcfg = _configs(name)
    for fsdp in (None, "dp"):
        _walk(jmesh.param_specs(jcfg, fsdp_axis=fsdp), tmesh.param_specs(tcfg, fsdp))
    _walk(jmesh.packed_param_specs(jcfg), tmesh.packed_param_specs(tcfg))


def test_kv_cache_specs_equal_jax():
    for quantized in (False, True):
        j, t = jmesh.kv_cache_specs(quantized), tmesh.kv_cache_specs(quantized)
        for field in ("k", "v", "k_scale", "v_scale"):
            jf, tf = getattr(j, field), getattr(t, field)
            assert (jf is None) == (tf is None)
            if jf is not None:
                assert tuple(tf) == tuple(jf), field


def _packed_equal(tpk, jpk):
    assert sorted(tpk["layers"]) == sorted(jpk["layers"])
    for lname, jl in jpk["layers"].items():
        tl = tpk["layers"][lname]
        if not hasattr(jl, "qweight"):
            continue
        for f in ("qweight", "scales", "szeros", "combo", "bias"):
            a, b = getattr(tl, f), getattr(jl, f)
            assert (a is None) == (b is None), (lname, f)
            if b is not None:
                want = np.asarray(b, np.float32) if f == "bias" else np.asarray(b)
                np.testing.assert_array_equal(t2n(a), want)
        assert (tl.bits, tl.group_size, tl.in_features, tl.out_features) == (
            jl.bits, jl.group_size, jl.in_features, jl.out_features)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_unfused_pack_model_is_jax_bit_for_bit(name):
    jp, tp = _params(name)
    jpk = jpack(jp, MODELS[name], bits=2, group_size=32, fuse=False)
    tpk = pack_model(tp, _tcfg(name), bits=2, group_size=32, fuse=False)
    assert "qkv" not in tpk["layers"] and "gate_up" not in tpk["layers"]
    _packed_equal(tpk, jpk)


def test_unfused_pack_model_tiny_int4():
    jcfg = dataclasses.replace(jconfig.TINY_TEST, dtype="float32")
    jp = jinit(jcfg, jax.random.key(0), dtype=jnp.float32)
    tp = params_from_numpy(to_numpy_tree(jp), "cpu")
    _packed_equal(pack_model(tp, torch_cfg(jcfg), bits=4, group_size=64, fuse=False),
                  jpack(jp, jcfg, bits=4, group_size=64, fuse=False))


def test_a_config_tp_cannot_split_raises():
    with pytest.raises(ValueError, match="num_kv_heads = 1 is not a multiple of tp = 2"):
        tp_config(tconfig.FALCON_7B, 2)
    with pytest.raises(ValueError, match="num_heads = 71"):
        tp_config(dataclasses.replace(tconfig.FALCON_7B, num_kv_heads=2), 2)
    cfg = dataclasses.replace(tconfig.TINY_TEST, dtype="float32", num_kv_heads=1)
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="num_kv_heads = 1"):
        tllama.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int64), mesh=TP2)
    local = tp_config(tconfig.TINYLLAMA_1B, 2)  # 32/4 heads: 16/2 a rank
    assert (local.num_heads, local.num_kv_heads, local.actual_head_dim,
            local.intermediate_size, local.vocab_size) == (16, 2, 64, 2816, 16000)


def test_fused_leaves_are_refused_by_name():
    cfg = dataclasses.replace(tconfig.TINY_TEST, dtype="float32")
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    fused = pack_model(params, cfg, bits=4, group_size=64)
    assert "qkv" in fused["layers"]
    with pytest.raises(ValueError, match="'qkv' cannot be split over tp = 2"):
        tllama.forward(fused, cfg, torch.zeros((1, 4), dtype=torch.int64), mesh=TP2)
    with pytest.raises(ValueError, match="'qkv' cannot be split over tp = 2"):
        tmesh.shard_packed_model(fused, TP2, cfg)


def test_groups_may_not_straddle_a_shard_edge():
    """TINY_TEST's o has K = 128: at tp = 2 each rank holds 64 rows, whole
    groups of 64 but not of 128; per-channel groups span K and never split."""
    cfg = dataclasses.replace(tconfig.TINY_TEST, dtype="float32")
    params = tllama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tmesh.shard_packed_model(pack_model(params, cfg, bits=4, group_size=64, fuse=False), TP2,
                             cfg)
    with pytest.raises(ValueError, match="a group would straddle a shard edge"):
        tmesh.shard_packed_model(pack_model(params, cfg, bits=4, group_size=128, fuse=False),
                                 TP2, cfg)
    ttr.check_tp_groups(params, ttr.TrainConfig(q_group_size=64), 2)
    for g in (128, -1):
        with pytest.raises(ValueError, match="straddle a shard edge"):
            ttr.check_tp_groups(params, ttr.TrainConfig(q_group_size=g), 2)


def test_mesh_rules(monkeypatch):
    with pytest.raises(ValueError, match=r"dp\(0\) \* tp\(2\) != device count \(1\)"):
        tmesh.make_mesh(tp=2)  # no process group: one device
    with pytest.raises(ValueError, match="device count"):
        tdist.make_hybrid_mesh(tp=2)
    assert tmesh.make_mesh() == tmesh.Mesh(dp=1)
    # four ranks, one a host: a tp group would cross hosts (JAX's ICI rule)
    monkeypatch.setattr(tdist, "get_world_size", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="must divide the per-host device count 1"):
        tdist.make_hybrid_mesh(tp=2)


def test_take_cuts_by_the_spec():
    x = torch.arange(2 * 4 * 6).reshape(2, 4, 6)
    mesh = tmesh.Mesh(dp=2, tp=3, dp_rank=1, tp_rank=2)
    got = tmesh.take(x, tmesh.P(None, "dp", "tp"), mesh)
    assert torch.equal(got, x[:, 2:4, 4:6]) and got.is_contiguous()
    assert tmesh.take(x, tmesh.P(None, None, None), mesh) is x
    with pytest.raises(ValueError, match="does not divide over tp = 3"):
        tmesh.take(torch.zeros(4, 4), tmesh.P(None, "tp"), mesh)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("dp", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("pdt", ["bfloat16", "float32"])
def test_dp_train_scaling_equals_jax(dp, tp, pdt):
    for overlap in (0.0, 0.8):
        want = jmem.dp_train_scaling(jmem.LLAMA2_7B, jtr.TrainConfig(param_dtype=pdt),
                                     t_step_s=3.1, dp=dp, tp=tp, chips_per_host=8,
                                     ici_bw=300e9, dcn_bw=40e9, overlap=overlap)
        got = tmem.dp_train_scaling(tconfig.LLAMA2_7B, ttr.TrainConfig(param_dtype=pdt),
                                    t_step_s=3.1, dp=dp, tp=tp, cards_per_host=8,
                                    link_bw=300e9, host_bw=40e9, overlap=overlap)
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["TINYLLAMA_1B", "LLAMA2_7B", "FALCON_7B"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tp_decode_scaling_equals_jax(name, tp):
    jcfg, tcfg = getattr(jconfig, name), getattr(tconfig, name)
    want = jcap.tp_decode_scaling(jcfg, t_step_s=20.3e-3, batch=8, tp=tp, ici_bw=300e9,
                                  ici_latency=5e-6)
    got = tcap.tp_decode_scaling(tcfg, t_step_s=20.3e-3, batch=8, tp=tp, link_bw=300e9,
                                 link_latency_s=5e-6)
    assert got == pytest.approx(want, rel=1e-12)


def test_link_defaults_are_the_h100_data_sheet():
    """450 GB/s each way of the data sheet's 900 GB/s of NVLink a card, 50
    GB/s a card between DGX H100 hosts; not JAX's v5e ICI (45 GB/s) or DCN;
    the port overlaps nothing (overlap 0: ZeRO reduces after the backward)."""
    assert tmem.H100_NVLINK_BW == tcap.H100_NVLINK_BW == 450e9 != jmem.V5E_ICI_BW
    assert tmem.H100_HOST_BW == 50e9 != jmem.V5E_DCN_BW
    tc = ttr.TrainConfig()
    out = tmem.dp_train_scaling(tconfig.LLAMA2_7B, tc, t_step_s=3.1, dp=16)
    want = tmem.dp_train_scaling(tconfig.LLAMA2_7B, tc, t_step_s=3.1, dp=16, link_bw=450e9,
                                 host_bw=50e9, overlap=0.0, cards_per_host=8)
    assert out == want and out["hosts"] == 2 and out["efficiency"] < 1.0
