"""The port's W{2,4}A8 matmul half against the JAX package's on the CPU: the
extraction permutation, the A8 byte order (pack and repack, plain and
stacked), the plain A8 matmul against JAX's `quant_matmul_a8` with the
Pallas kernel in interpret mode, the dispatch and the switch.

Tolerances: packed words bit-equal. Integer-valued x with one 127 a row
quantizes with sx = 1 exactly, and every product and sum is an integer below
2^24 in f32: exact. Random x: within 1e-5 of max|ref| (f32 summation order,
and XLA divides by 127 as a multiply by the f32 reciprocal where the port
divides, which can move sx by one ulp)."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdistiller_tpu.ops.quant_matmul  # noqa: F401  (the package re-exports a function of the same name)
from bitdistiller_tpu.quant.packing import PackedLinear as JP
from bitdistiller_tpu.quant.packing import pack_codes as jpack
from bitdistiller_tpu_torch.ops import quant_matmul as tq
from bitdistiller_tpu_torch.quant.packing import PackedLinear as TP
from bitdistiller_tpu_torch.quant.packing import dequantize_linear, pack_codes

jq = sys.modules["bitdistiller_tpu.ops.quant_matmul"]

K, N = 256, 128
LAYOUTS = [(2, 64), (2, 128), (4, 64), (4, 128)]


def _layer(rng, bits, g, integer, layers=None, k=K, n=N):
    lead = () if layers is None else (layers,)
    codes = rng.integers(0, 2**bits, lead + (k, n)).astype(np.int32)
    if integer:
        scales = np.ones(lead + (k // g, n), np.float32)
        szeros = rng.integers(0, 2**bits, lead + (k // g, n)).astype(np.float32)
    else:
        scales = (rng.random(lead + (k // g, n)) * 0.05 + 0.01).astype(np.float32)
        szeros = (scales * rng.integers(0, 2**bits, lead + (k // g, n))).astype(np.float32)
    flat = codes.reshape(-1, k, n)
    qw = np.stack([np.asarray(jpack(jnp.asarray(c), bits, g)) for c in flat])
    return codes, qw.reshape(lead + qw.shape[1:]), scales, szeros


def _x(rng, m, integer, k=K):
    if integer:
        x = rng.integers(-5, 6, (m, k)).astype(np.float32)
        x[:, 0] = 127.0  # sx = 127 / 127 = 1: quantization is the identity
        return x
    return rng.standard_normal((m, k)).astype(np.float32)


def _jp(qw, scales, szeros, bits, g, k=K, n=N):
    return JP(qweight=jnp.asarray(qw), scales=jnp.asarray(scales), szeros=jnp.asarray(szeros),
              bias=None, bits=bits, group_size=g, in_features=k, out_features=n)


def _tp(qw, scales, szeros, bits, g, a8_order=False, k=K, n=N):
    return TP(qweight=torch.from_numpy(np.array(qw)), scales=torch.from_numpy(scales),
              szeros=torch.from_numpy(szeros), bias=None, bits=bits, group_size=g,
              in_features=k, out_features=n, a8_order=a8_order)


@pytest.mark.parametrize("bits,g", LAYOUTS)
def test_a8_perm_and_words_equal_jax(bits, g):
    """_a8_perm, pack_codes_a8 and its inverse, bit for bit."""
    np.testing.assert_array_equal(tq._a8_perm(bits, g), jq._a8_perm(bits, g))
    codes = np.random.default_rng(bits + g).integers(0, 2**bits, (K, N)).astype(np.int32)
    want = np.asarray(jq.pack_codes_a8(jnp.asarray(codes), bits, g))
    got = tq.pack_codes_a8(torch.from_numpy(codes), bits, g)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq.unpack_codes_a8(got, bits, g).numpy(), codes)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bits,g", LAYOUTS)
def test_repack_linear_a8_equals_jax(bits, g, stacked):
    rng = np.random.default_rng(7 * bits + g)
    _, qw, scales, szeros = _layer(rng, bits, g, True, layers=3 if stacked else None)
    want = jq.repack_linear_a8(_jp(qw, scales, szeros, bits, g))
    got = tq.repack_linear_a8(_tp(qw, scales, szeros, bits, g))
    assert got.a8_order and want.a8_order
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    assert tq.repack_linear_a8(got) is got  # already in A8 order


@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("bits,g", LAYOUTS)
def test_plain_a8_exact_on_integers_against_pallas(bits, g, repacked):
    rng = np.random.default_rng(3 * bits + g + repacked)
    codes, qw, scales, szeros = _layer(rng, bits, g, True)
    x = _x(rng, 8, True)
    jp = _jp(qw, scales, szeros, bits, g)
    tp = _tp(qw, scales, szeros, bits, g)
    if repacked:
        jp, tp = jq.repack_linear_a8(jp), tq.repack_linear_a8(tp)
    want = np.asarray(jq.quant_matmul_a8(jnp.asarray(x), jp, interpret=True))
    got = tq.quant_matmul_a8(torch.from_numpy(x), tp).numpy()
    np.testing.assert_array_equal(got, want)
    dense = x @ (codes * np.repeat(scales, g, 0) - np.repeat(szeros, g, 0))
    np.testing.assert_array_equal(got, dense)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [1, 8, 32, 33, 130])
def test_plain_a8_against_pallas_at_prefill_edges(m, bits, repacked, integer):
    """The plain A8 version, which the card holds the A8 kernels against, at
    their edges: 5 groups of 128 (a decode cluster's K split has a
    remainder), N = 320; M = 1, 8 and 32 on the decode kernel (one and two
    16-row fragments, masked rows), 33 and 130 on the s8 wgmma prefill
    kernel (just above the decode cap, ragged against 64- and 128-row
    tiles)."""
    k, n, g = 5 * 128, 320, 128
    rng = np.random.default_rng(2000 + 10 * m + 2 * bits + repacked)
    codes, qw, scales, szeros = _layer(rng, bits, g, integer, k=k, n=n)
    x = _x(rng, m, integer, k)
    jp, tp = _jp(qw, scales, szeros, bits, g, k, n), _tp(qw, scales, szeros, bits, g, k=k, n=n)
    if repacked:
        jp, tp = jq.repack_linear_a8(jp), tq.repack_linear_a8(tp)
    want = np.asarray(jq.quant_matmul_a8(jnp.asarray(x), jp, interpret=True))
    got = tq.quant_matmul_a8(torch.from_numpy(x), tp).numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, x @ (codes * np.repeat(scales, g, 0) - np.repeat(szeros, g, 0)))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("bits", [2, 4])
def test_plain_a8_close_on_random_against_pallas(bits, repacked):
    rng = np.random.default_rng(40 + bits + repacked)
    _, qw, scales, szeros = _layer(rng, bits, 128, False)
    x = _x(rng, 5, False)
    jp, tp = _jp(qw, scales, szeros, bits, 128), _tp(qw, scales, szeros, bits, 128)
    if repacked:
        jp, tp = jq.repack_linear_a8(jp), tq.repack_linear_a8(tp)
    want = np.asarray(jq.quant_matmul_a8(jnp.asarray(x), jp, interpret=True))
    got = tq.quant_matmul_a8(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_pair_layout_readers_raise_on_a8_order():
    rng = np.random.default_rng(1)
    _, qw, scales, szeros = _layer(rng, 2, 128, True)
    p = tq.repack_linear_a8(_tp(qw, scales, szeros, 2, 128))
    x = torch.from_numpy(_x(rng, 2, True))
    with pytest.raises(ValueError, match="A8"):
        tq.quant_matmul_plain(x, p.qweight, p.scales, p.szeros, 2, 128, p.a8_order)
    with pytest.raises(ValueError, match="A8"):
        dequantize_linear(p)


def test_dispatch_follows_jax_on_the_cpu(monkeypatch):
    """On the CPU an A8-ordered leaf goes to the plain A8 version; a
    pair-layout leaf stays A16 even with the switch on (as JAX's does off
    Pallas), so its result is the A16 one."""
    rng = np.random.default_rng(2)
    _, qw, scales, szeros = _layer(rng, 4, 128, False)
    x = torch.from_numpy(_x(rng, 3, False))
    pair = _tp(qw, scales, szeros, 4, 128)
    a16 = tq.quant_matmul_plain(x, pair.qweight, pair.scales, pair.szeros, 4, 128)
    a8 = tq.quant_matmul_a8_plain(x, pair.qweight, pair.scales, pair.szeros, 4, 128, False)
    assert not torch.equal(a16, a8)
    monkeypatch.setenv("BITDISTILLER_QMM_A8", "1")
    assert torch.equal(tq.quant_matmul(x, pair), a16)
    assert torch.equal(tq.quant_matmul(x, tq.repack_linear_a8(pair)), a8)


@pytest.mark.parametrize("value,on", [(None, False), ("", False), ("0", False), ("1", True),
                                      ("yes", True)])
def test_maybe_repack_a8_follows_the_switch(monkeypatch, value, on):
    """The JAX package's truth rule; stacked leaves are repacked layer by
    layer (layer 0 equals the single-layer repack); other leaves pass."""
    rng = np.random.default_rng(3)
    _, qw, scales, szeros = _layer(rng, 2, 64, True, layers=2)
    stacked = _tp(qw, scales, szeros, 2, 64)
    tree = {"layers": {"qkv": stacked, "norm": torch.ones(4)}, "embed": torch.zeros(4, 4)}
    if value is None:
        monkeypatch.delenv("BITDISTILLER_QMM_A8", raising=False)
    else:
        monkeypatch.setenv("BITDISTILLER_QMM_A8", value)
    assert tq.a8_enabled() == on == jq._a8_enabled()
    out = tq.maybe_repack_a8(tree)
    if not on:
        assert out is tree
        return
    leaf = out["layers"]["qkv"]
    assert leaf.a8_order and leaf.qweight.shape == stacked.qweight.shape
    assert out["embed"] is tree["embed"] and out["layers"]["norm"] is tree["layers"]["norm"]
    single = tq.repack_linear_a8(dataclasses.replace(
        stacked, qweight=stacked.qweight[0], scales=stacked.scales[0], szeros=stacked.szeros[0]))
    np.testing.assert_array_equal(leaf.qweight[0].numpy(), single.qweight.numpy())


def test_stacked_a8_layer_is_read_in_place(monkeypatch):
    """A layer of a stacked A8 leaf reaches the plain version as views:
    qweight, scales and szeros at the stacked base plus li layer strides."""
    rng = np.random.default_rng(4)
    _, qw, scales, szeros = _layer(rng, 2, 128, True, layers=3)
    p = tq.repack_linear_a8(_tp(qw, scales, szeros, 2, 128))
    seen = []
    real = tq.quant_matmul_a8_plain

    def spy(x, qweight, s, sz, *args):
        seen.append((qweight.data_ptr(), s.data_ptr(), sz.data_ptr()))
        return real(x, qweight, s, sz, *args)

    monkeypatch.setattr(tq, "quant_matmul_a8_plain", spy)
    x = torch.from_numpy(_x(rng, 2, True))
    before = tq.qmm_a8.launches
    for li in range(3):
        tq.quant_matmul(x, p, li)
    assert tq.qmm_a8.launches == before  # CPU tensors never reach the kernel
    base = lambda a: a.data_ptr()
    step = lambda a: a.stride(0) * a.element_size()
    assert seen == [(base(p.qweight) + li * step(p.qweight), base(p.scales) + li * step(p.scales),
                     base(p.szeros) + li * step(p.szeros)) for li in range(3)]


def test_pack_codes_a8_round_trips_natural_codes():
    """pack_codes (pair) and pack_codes_a8 hold the same codes in two
    orders: unpacking each gives the natural order back."""
    codes = torch.from_numpy(np.random.default_rng(5).integers(0, 4, (K, N)).astype(np.int32))
    pair = pack_codes(codes, 2, 128)
    a8 = tq.pack_codes_a8(codes, 2, 128)
    assert not torch.equal(pair, a8)
    assert torch.equal(tq.unpack_codes_a8(a8, 2, 128), codes)


PLANS_7B = {(12288, 4096): 6, (4096, 4096): 8, (22016, 4096): 4, (4096, 11008): 8}  # on 132 SMs


@pytest.mark.parametrize("n,k", sorted(PLANS_7B))
def test_decode_plan_puts_two_ctas_an_sm_at_7b_shapes(n, k):
    """qkv, o, gate_up and down of the 7B: the smallest cluster that puts
    2 x 132 CTAs of 256 columns on the card, or the largest (8) where none
    does (o and down, 16 tiles: 128 CTAs); never more CTAs in a cluster than
    K groups (86 for down: a remainder)."""
    cluster = tq.decode_plan(n, k // 128, 132)
    assert cluster == PLANS_7B[(n, k)]
    tiles = -(-n // tq.A8_DECODE_COLS)
    assert cluster == tq.MAX_CLUSTER or tiles * cluster >= 2 * 132 > tiles * (cluster - 1)
    assert cluster <= min(tq.MAX_CLUSTER, k // 128)


@pytest.mark.parametrize("n,groups,sms,want", [
    (320, 5, 132, 5),     # odd group count: the cluster stops at 5, short of 2 x SMs
    (4096, 1, 132, 1),    # one group: no K split
    (4096, 86, 8, 1),     # a small card: 16 tiles fill it alone
    (4096, 3, 132, 3),    # 3 groups: 48 CTAs, the most there can be
    (100, 86, 132, 8),    # N short of one tile: one cluster of the largest size
])
def test_decode_plan_at_odd_group_counts(n, groups, sms, want):
    assert tq.decode_plan(n, groups, sms) == want


def test_decode_ablation_patches_apply():
    """scripts/decode_ablation.py patches the A8 decode kernel's source by
    text: every patch still applies, once, and each variant differs from the
    kernel."""
    from bitdistiller_tpu_torch.ops import _build
    from bitdistiller_tpu_torch.scripts import decode_ablation

    src = (_build.CSRC_DIR / "quant_matmul_a8.cu").read_text()
    texts = decode_ablation.variants(src)
    assert texts["kernel"] == src
    assert len(set(texts.values())) == len(texts)
