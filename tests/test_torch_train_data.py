"""The port's teacher-data pipeline, memory estimate and clip cache against
the JAX package's: the same split (random.Random(seed).sample), the same
batch order (np.random.default_rng(seed).shuffle) and the same collated
arrays, byte for byte; kd_train_memory_estimate equal; a clip cache written
by the JAX package applied alike (f32: exact)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST as JT
from bitdistiller_tpu.models import TINYLLAMA_1B as JTL
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.quant import autoclip as jclip
from bitdistiller_tpu.train import data as jdata
from bitdistiller_tpu.train import memory as jmem
from bitdistiller_tpu.train.trainer import TrainConfig as JTC
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.quant import autoclip as tclip
from bitdistiller_tpu_torch.train import data as tdata
from bitdistiller_tpu_torch.train import memory as tmem
from bitdistiller_tpu_torch.train.trainer import TrainConfig as TTC
from bitdistiller_tpu_torch.train.trainer import tree_items
from torch_port_util import to_numpy_tree, torch_cfg


class FakeTok:
    eos_token = "</s>"
    eos_token_id = 2
    pad_token = "</s>"
    pad_token_id = 0

    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s][:96]


@pytest.fixture
def jsonl(tmp_path):
    path = tmp_path / "teacher.jsonl"
    with open(path, "w") as f:
        for i in range(37):
            f.write(json.dumps([[f"prompt {i} " * (1 + i % 5), f"reply {i}"]]) + "\n")
    return str(path)


@pytest.mark.parametrize("max_sample", [None, 25])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_same_split_batches_and_arrays(jsonl, max_sample, split):
    jd = jdata.SupervisedDataset.from_jsonl(jsonl, "</s>", max_sample, split, seed=7)
    td = tdata.SupervisedDataset.from_jsonl(jsonl, "</s>", max_sample, split, seed=7)
    assert (td.sources, td.targets) == (jd.sources, jd.targets)
    jc, tc = jdata.Collator(FakeTok(), 128), tdata.Collator(FakeTok(), 128)
    for shuffle, drop in ((True, True), (False, False)):
        jb = list(jdata.data_loader(jd, jc, 3, shuffle=shuffle, seed=4, drop_last=drop))
        tb = list(tdata.data_loader(td, tc, 3, shuffle=shuffle, seed=4, drop_last=drop))
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [dict(), dict(param_dtype="float32"), dict(grad_accum=4),
                                dict(kd_loss_type="jsd", train_kd=True)])
@pytest.mark.parametrize("cfg_name", ["tiny", "tinyllama"])
def test_memory_estimate_equal(kw, cfg_name):
    jcfg = JT if cfg_name == "tiny" else JTL
    want = jmem.kd_train_memory_estimate(jcfg, JTC(**kw), batch=2, seq=1024)
    got = tmem.kd_train_memory_estimate(torch_cfg(jcfg), TTC(**kw), batch=2, seq=1024)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-12), k
    assert tmem.param_count(torch_cfg(jcfg)) == jmem.param_count(jcfg)


def test_jax_clip_cache_applied_alike(tmp_path):
    params = jinit(JT, jax.random.key(1), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    clip = {}
    for li in range(JT.num_layers):
        layer = {}
        for name in ("v", "o", "down"):
            k, n = params["layers"][name]["w"].shape[1:]
            mx = np.abs(rng.standard_normal((n, k // 64))).astype(np.float32) * 0.05
            layer[name] = (mx, -mx * 0.8)
        clip[li] = layer
    path = str(tmp_path / "clip.npz")
    jclip.save_clip_cache(path, clip)
    want = jclip.apply_clip_cache(params, jclip.load_clip_cache(path))
    tparams = params_from_numpy(to_numpy_tree(params), "cpu")
    got = tclip.apply_clip_cache(tparams, tclip.load_clip_cache(path))
    wflat = dict(tree_items(jax.tree_util.tree_map(np.asarray, want)))
    for p, leaf in tree_items(got):
        np.testing.assert_array_equal(leaf.numpy(), wflat[p])
    # the source tree is not touched
    assert torch.equal(tparams["layers"]["v"]["w"],
                       params_from_numpy(to_numpy_tree(params), "cpu")["layers"]["v"]["w"])
