"""The port's dp half of `parallel/` against the JAX package's: the spec
table and ZeRO's split dim on every leaf of every tiny family tree and
the 7B presets (exactly), the JAX `test_zero_extend_spec_rules` table,
`host_shard` with its remainder and error, tp > 1 refused in one process, the process
group's rendezvous (explicit arguments, partial ones, torchrun's
variables), and 2-rank teacher generation writing JAX's per-rank files
with the prompts split `[rank::2]` (greedy: the files byte-equal to JAX's
run with its process index and count set to each rank's)."""

import dataclasses
import itertools
import json
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import bitdistiller_tpu.generation.teacher as jteacher
from bitdistiller_tpu.models import config as jconfig
from bitdistiller_tpu.models import init_params as jinit
from bitdistiller_tpu.parallel import distributed as jdist
from bitdistiller_tpu.parallel import mesh as jmesh
from bitdistiller_tpu_torch.generation import datasets as tds
from bitdistiller_tpu_torch.models import config as tconfig
from bitdistiller_tpu_torch.models import llama as tllama
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.parallel import distributed as tdist
from bitdistiller_tpu_torch.parallel import mesh as tmesh
from bitdistiller_tpu_torch.train import pipeline
from bitdistiller_tpu_torch.train.trainer import _get, tree_items
from test_torch_families import MODELS, _tcfg
from test_torch_dp_worker import ByteTok, free_port, spawn
from torch_port_util import to_numpy_tree, torch_cfg

TREES = sorted(MODELS) + ["TINY_TEST", "TINYLLAMA_1B", "LLAMA2_7B", "FALCON_7B"]


def _configs(name):
    if name in MODELS:
        return MODELS[name], _tcfg(name)
    return getattr(jconfig, name), getattr(tconfig, name)


def _trees(name):
    """(JAX's abstract param tree, the port's tree on the meta device)."""
    jcfg, tcfg = _configs(name)
    jtree = jax.eval_shape(lambda: jinit(jcfg, jax.random.key(0), dtype=jnp.float32))
    ttree: dict = {}
    for path, shape in tllama.param_shapes(tcfg).items():
        d = ttree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = torch.empty(shape, device="meta")
    return jtree, ttree


@pytest.mark.parametrize("name", TREES)
def test_specs_and_zero_dims_equal_jax(name):
    """The spec table leaf for leaf, and the "dp" position of
    zero_extend_spec on it at ZeRO 2 (no fsdp) and 3 (fsdp "dp"), for dp in
    2, 3, 4, 8: the dim each leaf of the optimizer state is split along."""
    jtree, ttree = _trees(name)
    for fsdp in (None, "dp"):
        jspecs = jmesh.param_specs_from_params(jtree, fsdp_axis=fsdp)
        tspecs = tmesh.param_specs_from_params(ttree, fsdp_axis=fsdp)
        for path, leaf in tree_items(ttree):
            jspec, tspec = _get(jspecs, path), _get(tspecs, path)
            assert tuple(tspec) == tuple(jspec), (path, tspec, jspec)
            for dp in (2, 3, 4, 8):
                je = jmesh.zero_extend_spec(jspec, tuple(leaf.shape), dp)
                te = tmesh.zero_extend_spec(tspec, tuple(leaf.shape), dp)
                assert tuple(te) == tuple(je), (path, dp)
                want = tuple(je).index("dp") if "dp" in tuple(je) else None
                assert tmesh.dp_dim(te) == want


def test_zero_extend_spec_rules():
    """The JAX package's table (tests/test_parallel.py:184-195)."""
    P = tmesh.P
    assert tmesh.zero_extend_spec(P(None, None, "tp"), (2, 128, 64), 4) == P(None, "dp", "tp")
    assert tmesh.zero_extend_spec(P(None, None), (3, 128), 4) == P(None, "dp")
    assert tmesh.zero_extend_spec(P(None, "dp", "tp"), (2, 128, 64), 4) == P(None, "dp", "tp")
    assert tmesh.zero_extend_spec(P(None, None), (3, 5), 4) == P(None, None)
    # a stacked [L, K, N] leaf with L % dp == 0 splits the layer axis
    assert tmesh.zero_extend_spec(P(None, None, "tp"), (8, 128, 64), 4) == P("dp", None, "tp")
    assert tmesh.zero_extend_spec(JP(None, None), (3, 128), 4) == P(None, "dp")


def _state_specs(tree, spec_type):
    """{param path: {spec}} over the param-shaped spec trees of an
    optimizer state's spec tree (the dict keys of a leaf's path), and the
    set of its other (counter) specs."""
    per_path: dict = {}
    other = set()
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, spec_type))
    for kp, spec in leaves[0]:
        keys = tuple(k.key for k in kp if isinstance(k, jax.tree_util.DictKey))
        if keys:
            per_path.setdefault(keys, set()).add(tuple(spec))
        else:
            other.add(tuple(spec))
    return per_path, other


def test_opt_state_specs_follow_the_params():
    """The spec tree of each optimizer's state, the split ZeroPlan reads:
    every param-shaped tree takes JAX's spec leaf for leaf (the params' own
    at stage 0, extended over dp at 2, the fsdp spec at 3), every counter
    P(), as JAX's `opt_state_specs` on its optimizer gives them, at dp = 2."""
    from bitdistiller_tpu.train import trainer as jtr
    from bitdistiller_tpu_torch.train import trainer as ttr

    jtree, ttree = _trees("TINY_TEST")
    kws = (dict(grad_accum=2), dict(grad_accum=2, param_dtype="float32"),
           dict(fused_accum=True, grad_accum=2),
           dict(fused_accum=True, grad_accum=2, param_dtype="float32"))
    for stage, kw in itertools.product((0, 2, 3), kws):
        fsdp = "dp" if stage >= 3 else None
        jspecs = jmesh.param_specs_from_params(jtree, fsdp_axis=fsdp)
        tspecs = tmesh.param_specs_from_params(ttree, fsdp_axis=fsdp)
        jst = jmesh.opt_state_specs(jtr.make_optimizer(jtr.TrainConfig(**kw)), jtree, jspecs, 2,
                                    zero_stage=stage)
        tst = tmesh.opt_state_specs(ttr.make_optimizer(ttr.TrainConfig(**kw)), ttree, tspecs,
                                    2, zero_stage=stage)
        jpaths, jother = _state_specs(jst, JP)
        tpaths, tother = _state_specs(tst, tmesh.P)
        params = {p for p, _ in tree_items(ttree)}
        assert set(tpaths) == set(jpaths) == params, kw
        for path in params:
            assert len(jpaths[path]) == 1 and tpaths[path] == jpaths[path], (kw, path)
        assert tother == jother == {()}, kw
    assert tmesh.batch_spec() == tmesh.P("dp") and tuple(jmesh.batch_spec()) == ("dp",)


@pytest.mark.parametrize("n,count", [(10, 1), (10, 2), (10, 3), (7, 4), (4, 4), (3, 4)])
def test_host_shard_equals_jax(n, count):
    seq = list(range(n))
    for p in range(count):
        try:
            want = jdist.host_shard(seq, process_id=p, process_count=count)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tdist.host_shard(seq, process_id=p, process_count=count)
            continue
        assert tdist.host_shard(seq, process_id=p, process_count=count) == want
    if n >= count:  # every shard the same length: no rank sees a shorter last batch
        assert {len(tdist.host_shard(seq, p, count)) for p in range(count)} == {n // count}


def test_tp_is_refused():
    """tp > 1 needs a process group of dp * tp ranks: in one process (one
    device) the mesh, the hybrid mesh and run_training refuse it, as JAX's
    make_mesh refuses a device count it cannot split (tp = 2 itself runs in
    tests/test_torch_tp_*.py)."""
    with pytest.raises(ValueError, match="device count"):
        tdist.make_hybrid_mesh(tp=2)
    with pytest.raises(ValueError, match="device count"):
        tmesh.make_mesh(tp=2)
    with pytest.raises(ValueError, match="device count"):
        tmesh.make_mesh(dp=2)  # no process group: one device
    mesh = tdist.make_hybrid_mesh()
    assert (mesh.dp, mesh.tp) == (1, 1)
    args = types.SimpleNamespace(tp=2, dp=None, device="cpu")
    with pytest.raises(ValueError, match="device count"):
        pipeline.run_training(args, tokenizer=ByteTok(), model=({}, None))


def test_rendezvous_rules(monkeypatch):
    """All None: no group (unless torchrun's variables are set); a partial
    set raises; torchrun's variables make a group (gloo for the CPU) that
    is left again."""
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    assert tdist.init_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="go together"):
        tdist.init_distributed("127.0.0.1:1", None, 0, device="cpu")
    assert tdist.backend_for("cpu") == "gloo" and tdist.backend_for("cuda:1") == "nccl"
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        assert tdist.init_distributed(device="cpu") is True
        assert torch.distributed.get_backend() == "gloo"
        assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
        assert tdist.make_hybrid_mesh().dp == 1
    finally:
        tdist.shutdown_distributed()
    assert not torch.distributed.is_initialized()


class _AsRank:
    """The teacher module's view of jax: rank `rank` of `count` processes
    (the engine keeps the real module: one process)."""

    def __init__(self, rank, count):
        self.process_index = lambda: rank
        self.process_count = lambda: count

    def __getattr__(self, name):
        return getattr(jax, name)


def test_two_rank_generation_writes_jax_files(tmp_path, monkeypatch):
    """Each rank writes `{base}_T{t}_N{n}_S{seed}_{rank}{ext}` with the
    prompts [rank::2], seeded seed + rank; greedy, so each file equals the
    one JAX's run_teacher_generation writes as that rank of 2."""
    cfg = dataclasses.replace(jconfig.TINY_TEST, dtype="float32")
    jp = jinit(cfg, jax.random.key(0), dtype=jnp.float32)
    tp = params_from_numpy(to_numpy_tree(jp), "cpu")
    with open(tmp_path / "prompts.jsonl", "w") as f:
        for i in range(5):
            f.write(json.dumps([[f"prompt {i} " * (1 + i), "x"]]) + "\n")
    common = dict(base_model="unused", dataset_name="json", data_path=str(tmp_path / "prompts.jsonl"),
                  max_sample=5000, max_new_tokens=6, temperature=0.0, top_p=1.0, max_batch=4,
                  max_seq_len=128, seed=3)
    port = spawn({"kind": "generate", "params": tp, "cfg": torch_cfg(cfg),
                  "args": dict(common, out_path=str(tmp_path / "port" / "gen.jsonl"))})
    assert port == [str(tmp_path / "port" / f"gen_T0.0_N5000_S3_{r}.jsonl") for r in (0, 1)]
    prompts = [json.loads(x)[0][0] for x in open(tmp_path / "prompts.jsonl")]
    for rank in (0, 1):
        monkeypatch.setattr(jteacher, "jax", _AsRank(rank, 2))
        want = jteacher.run_teacher_generation(
            types.SimpleNamespace(**common, out_path=str(tmp_path / "jax" / "gen.jsonl")),
            tokenizer=ByteTok(), model=(jp, cfg))
        assert want.replace("/jax/", "/port/") == port[rank]
        got = open(port[rank], "rb").read()
        assert got == open(want, "rb").read()
        lines = [json.loads(x)[0][0] for x in got.decode().splitlines()]
        style = tds.PROMPT_STYLES[tds.style_for_dataset("json")]
        assert lines == [style.format(instruction=p) for p in prompts[rank::2]]
