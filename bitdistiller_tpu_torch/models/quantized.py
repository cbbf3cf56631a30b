"""Packed-model construction and checkpoint IO (PyTorch port of the JAX
package's `models/quantized.py`).

Every decoder linear becomes a stacked `PackedLinear` (int32 pair-layout
codes, group scales/zeros and their combo words); embeddings, norms and the
lm_head stay dense. `load_packed_checkpoint` reads the JAX package's
artifact (`packed.npz` + `quant_config.json`) byte for byte, and
`params_from_numpy` takes a JAX param tree (dense or packed) handed over as
numpy arrays, and `train_state_from_numpy` a JAX TrainState.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..quant.packing import PackedLinear, make_scale_combo, quantize_pack_linear
from .config import ModelConfig
from .llama import LAYER_LINEARS

_PACKED_FIELDS = ("qweight", "scales", "szeros", "bias", "__meta")


def _pack_stacked(w: torch.Tensor, bits: int, group_size: int, bias=None) -> PackedLinear:
    """Quantize+pack a stacked [L, K, N] dense weight, layer by layer; a
    bias [L, N] rides along unchanged."""
    L, k, n = w.shape
    layers = [quantize_pack_linear(w[i].to(torch.float32), bits, group_size) for i in range(L)]
    stack = lambda name: torch.stack([getattr(p, name) for p in layers])
    return PackedLinear(
        qweight=stack("qweight"), scales=stack("scales"), szeros=stack("szeros"),
        bias=bias, bits=bits, group_size=layers[0].group_size,
        in_features=k, out_features=n, combo=stack("combo"),
    )


_FUSED = (("qkv", ("q", "k", "v")), ("gate_up", ("gate", "up")))


def pack_model(params: dict, cfg: ModelConfig, bits: int, group_size: int = 128) -> dict:
    """Quantize+pack the layer linears of a dense param dict ([L, K, N]
    leaves) into stacked PackedLinears, as the JAX package's `pack_model`
    with fuse=True: q/k/v become "qkv" and gate/up "gate_up", concatenated
    along N, where every part is present and none has a bias (groups run
    along K, so the statistics are those of the unfused layout); every
    other linear is packed alone with its bias (Qwen2's q/k/v, a plain
    MLP's up and down). Same words as the JAX package's."""
    layers = params["layers"]
    out_layers = dict(layers)
    todo = [name for name in LAYER_LINEARS if name in layers]
    for fused, parts in _FUSED:
        if not all(p in layers for p in parts) or any(layers[p].get("b") is not None
                                                      for p in parts):
            continue
        w = torch.cat([layers[p]["w"] for p in parts], dim=-1)
        out_layers[fused] = _pack_stacked(w, bits, group_size)
        del w
        for p in parts:
            del out_layers[p]
            todo.remove(p)
    for name in todo:
        leaf = layers[name]
        out_layers[name] = _pack_stacked(leaf["w"], bits, group_size, leaf.get("b"))
    return dict(params, layers=out_layers)


def random_packed_params(
    cfg: ModelConfig, bits: int = 2, group_size: int = 128, dtype=torch.bfloat16,
    seed: int = 0, device="cuda",
) -> dict:
    """Random packed model at full size, built on the device without ever
    materialising fp weights (for kernel and serving runs where the weight
    values do not matter). Scales 0.01 and szeros 0.01 * 2^(bits-1), as the
    JAX package's version; like it, the Llama layout only (RMS norms, fused
    unbiased linears, gated MLP), with the q/k norms under `qk_norm`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, dh, L = cfg.hidden_size, cfg.actual_head_dim, cfg.num_layers
    shapes = {  # the fused layout
        "qkv": (d, (cfg.num_heads + 2 * cfg.num_kv_heads) * dh),
        "o": (cfg.num_heads * dh, d),
        "gate_up": (d, 2 * cfg.intermediate_size),
        "down": (cfg.intermediate_size, d),
    }
    pack = 32 // bits
    layers = {
        "input_norm": torch.ones((L, d), dtype=dtype, device=dev),
        "post_attn_norm": torch.ones((L, d), dtype=dtype, device=dev),
    }
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((L, dh), dtype=dtype, device=dev)
        layers["k_norm"] = torch.ones((L, dh), dtype=dtype, device=dev)
    for name, (k_dim, n_dim) in shapes.items():
        qweight = torch.randint(
            -(2**31), 2**31 - 1, (L, k_dim // pack, n_dim), dtype=torch.int32,
            device=dev, generator=gen,
        )
        ng = k_dim // group_size
        scales = torch.full((L, ng, n_dim), 0.01, dtype=torch.float32, device=dev)
        szeros = torch.full((L, ng, n_dim), 0.01 * 2 ** (bits - 1), dtype=torch.float32,
                            device=dev)
        layers[name] = PackedLinear(
            qweight=qweight, scales=scales, szeros=szeros, bias=None, bits=bits,
            group_size=group_size, in_features=k_dim, out_features=n_dim,
            combo=make_scale_combo(scales, szeros),
        )

    def normal(shape):
        return (torch.randn(shape, dtype=torch.float32, device=dev, generator=gen) * 0.02).to(dtype)

    params = {
        "embed": normal((cfg.vocab_size, d)),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": normal((d, cfg.vocab_size))}
    return params


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _packed_from(fields: dict, device) -> PackedLinear:
    scales = _tensor(fields["scales"], device).to(torch.float32)
    szeros = _tensor(fields["szeros"], device).to(torch.float32)
    combo = fields.get("combo")
    bias = fields.get("bias")
    return PackedLinear(
        qweight=_tensor(fields["qweight"], device),
        scales=scales, szeros=szeros,
        bias=None if bias is None else _tensor(bias, device),
        bits=int(fields["bits"]), group_size=int(fields["group_size"]),
        in_features=int(fields["in_features"]), out_features=int(fields["out_features"]),
        combo=make_scale_combo(scales, szeros) if combo is None else _tensor(combo, device),
        a8_order=bool(fields.get("a8_order", False)),
    )


def params_from_numpy(tree, device="cuda"):
    """A JAX param tree as nested dicts of numpy arrays -> the port's params.
    A dict holding "qweight" is a PackedLinear: qweight, scales, szeros,
    optional bias and combo, and the meta fields bits, group_size,
    in_features, out_features and a8_order (False when absent: pair-layout
    words). Arrays keep their dtypes (bf16 included)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        if "qweight" in tree:
            return _packed_from(tree, dev)
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if tree is None:
        return None
    return _tensor(np.asarray(tree), dev)


def load_packed_checkpoint(path, device="cuda"):
    """Read a packed checkpoint directory written by the JAX package's
    `save_packed_checkpoint` -> (params, cfg). Float leaves take the config's
    dtype; packed codes and scales are read as stored."""
    dev = resolve_device(device)
    with open(os.path.join(path, "quant_config.json")) as f:
        meta = json.load(f)
    cfg = ModelConfig(**meta["config"])
    dtype = torch_dtype(cfg.dtype)
    tree: dict = {}
    packed: dict = {}
    with np.load(os.path.join(path, "packed.npz")) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[-1] in _PACKED_FIELDS:
                packed.setdefault("/".join(parts[:-1]), {})[parts[-1]] = data[key]
                continue
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = _tensor(data[key], dev)
            node[parts[-1]] = arr.to(dtype) if arr.is_floating_point() else arr
    for prefix, fields in packed.items():
        b, g, kf, nf = (int(v) for v in fields.pop("__meta"))
        fields.update(bits=b, group_size=g, in_features=kf, out_features=nf)
        node = tree
        parts = prefix.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _packed_from(fields, dev)
    return tree, cfg


def _scalar(x) -> int:
    return int(np.asarray(x))


def _opt_state_from_numpy(node, device):
    """An optax state of the JAX package's optimizer (numpy leaves, its
    NamedTuple structure) -> the port's (train/trainer.py). Read by field
    names: MasterAccumState (master, acc, count, inner), MasterWeightsState
    (master, inner), MultiStepsState (mini_step, gradient_step,
    inner_opt_state, acc_grads), and the chain(clip, adamw) tuple, whose
    ScaleByAdamState (count, mu, nu) and ScaleByScheduleState (count) are
    found by their fields."""
    from ..train import trainer as tr

    tree = lambda t: params_from_numpy(t, device)
    fields = getattr(node, "_fields", ())
    if "master" in fields and "acc" in fields:
        return tr.MasterAccumState(tree(node.master), tree(node.acc), _scalar(node.count),
                                   _opt_state_from_numpy(node.inner, device))
    if "master" in fields:
        return tr.MasterWeightsState(tree(node.master), _opt_state_from_numpy(node.inner, device))
    if "mini_step" in fields:
        return tr.MultiStepsState(_scalar(node.mini_step), _scalar(node.gradient_step),
                                  _opt_state_from_numpy(node.inner_opt_state, device),
                                  tree(node.acc_grads))
    adam, sched = None, None
    stack = [node]
    while stack:  # the chain's nested tuples
        n = stack.pop()
        f = getattr(n, "_fields", ())
        if "mu" in f and "nu" in f:
            adam = n
        elif f == ("count",):
            sched = n
        elif isinstance(n, (tuple, list)):
            stack.extend(n)
    if adam is None or sched is None:
        raise ValueError("not the JAX package's chain(clip_by_global_norm, adamw) state")
    return tr.AdamWState(_scalar(adam.count), tree(adam.mu), tree(adam.nu), _scalar(sched.count))


def train_state_from_numpy(params, opt_state, step, device="cuda"):
    """A JAX TrainState handed over as numpy (params: the latent tree;
    opt_state: its optax state with numpy leaves; step) -> the port's
    TrainState: latents, f32 master, Adam moments, accumulators, counts and
    the step, so that one port step and one JAX step start from one state."""
    from ..train.trainer import TrainState

    dev = resolve_device(device)
    return TrainState(params=params_from_numpy(params, dev),
                      opt_state=_opt_state_from_numpy(opt_state, dev), step=_scalar(step))
