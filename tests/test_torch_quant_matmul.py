"""The port's plain packed matmul against the JAX package's three paths on
the CPU: `quant_matmul_xla`, the Pallas kernel in interpret mode, and the
stacked Pallas kernel on a layer of a stacked weight.

Scales and szeros are rounded through bf16 before packing, so JAX's f32
`scales` and its bf16 `combo` describe the same weights. Tolerances:
integer-valued inputs are exact (every product and sum is an integer below
2^24 in f32); random f32 inputs differ only in f32 summation order
(rtol 1e-5 against XLA's f32 path; 1e-4 against the kernel, which feeds
bf16-exact activations to an f32 accumulator in another order)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdistiller_tpu.ops.quant_matmul  # noqa: F401  (the package re-exports a function of the same name)
from bitdistiller_tpu.quant.packing import PackedLinear as JP
from bitdistiller_tpu.quant.packing import make_scale_combo as jcombo
from bitdistiller_tpu.quant.packing import pack_codes as jpack
from bitdistiller_tpu_torch.ops import quant_matmul as tq
from bitdistiller_tpu_torch.quant.packing import PackedLinear as TP

jq = sys.modules["bitdistiller_tpu.ops.quant_matmul"]

K, N = 256, 128


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _layer(rng, bits, g, integer, k=K, n=N):
    codes = rng.integers(0, 2**bits, (k, n)).astype(np.int32)
    if integer:
        scales = np.ones((k // g, n), np.float32)
        szeros = rng.integers(0, 2**bits, (k // g, n)).astype(np.float32)
    else:
        scales = _bf16((rng.random((k // g, n)) * 0.05 + 0.01).astype(np.float32))
        szeros = _bf16((scales * rng.integers(0, 2**bits, (k // g, n))).astype(np.float32))
    qw = np.array(jpack(jnp.asarray(codes), bits, g))
    return codes, qw, scales, szeros


def _x(rng, m, integer, k=K):
    if integer:
        return rng.integers(-4, 5, (m, k)).astype(np.float32)
    return _bf16(rng.standard_normal((m, k)).astype(np.float32))


def _jp(qw, scales, szeros, bits, g, k=K, n=N):
    s, z = jnp.asarray(scales), jnp.asarray(szeros)
    return JP(qweight=jnp.asarray(qw), scales=s, szeros=z, bias=None, bits=bits,
              group_size=g, in_features=k, out_features=n, combo=jcombo(s, z))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("bits,g,m", [(2, 64, 4), (2, 128, 8), (4, 64, 40), (4, 128, 3)])
def test_plain_matches_jax_xla_and_pallas(bits, g, m, integer):
    rng = np.random.default_rng(bits * 100 + g + m)
    codes, qw, scales, szeros = _layer(rng, bits, g, integer)
    x = _x(rng, m, integer)
    got = tq.quant_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(scales),
        torch.from_numpy(szeros), bits, g,
    ).numpy()
    p = _jp(qw, scales, szeros, bits, g)
    xla = np.asarray(jq.quant_matmul_xla(jnp.asarray(x), p))
    pallas = np.asarray(jq.quant_matmul_pallas(jnp.asarray(x), p, interpret=True))
    if integer:
        np.testing.assert_array_equal(got, xla)
        np.testing.assert_array_equal(got, pallas)
        dense = x @ (codes.astype(np.float32) * np.repeat(scales, g, 0) - np.repeat(szeros, g, 0))
        np.testing.assert_array_equal(got, dense)
    else:
        np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [33, 130])
def test_plain_matches_pallas_at_prefill_edges(m, bits, integer):
    """The plain version, which the card holds the wgmma prefill kernel
    against, at that kernel's edges: M just above the decode cap (32) and
    ragged against 64- and 128-row tiles, 5 groups of 128 (no ring depth
    divides it), N = 320 (ragged against 128 columns)."""
    k, n, g = 5 * 128, 320, 128
    rng = np.random.default_rng(1000 + 10 * m + bits)
    codes, qw, scales, szeros = _layer(rng, bits, g, integer, k, n)
    x = _x(rng, m, integer, k)
    got = tq.quant_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(scales),
        torch.from_numpy(szeros), bits, g,
    ).numpy()
    want = np.asarray(jq.quant_matmul_pallas(
        jnp.asarray(x), _jp(qw, scales, szeros, bits, g, k, n), interpret=True))
    if integer:
        np.testing.assert_array_equal(got, want)
        dense = x @ (codes.astype(np.float32) * np.repeat(scales, g, 0) - np.repeat(szeros, g, 0))
        np.testing.assert_array_equal(got, dense)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,n,sms,rows", [
    (33, 4096, 132, 64), (256, 4096, 132, 64), (256, 12288, 132, 64),
    (256, 22016, 132, 128), (4096, 4096, 132, 128), (2048, 320, 132, 64), (2048, 320, 8, 128),
])
def test_prefill_tile_rows(m, n, sms, rows):
    """128-row tiles once the 128 x 128 grid fills the SMs twice over, else
    64: the 7B shapes at M=256 take 64 rows but gate_up, every shape at the
    engine's M=4096 takes 128."""
    assert tq.prefill_tile_m(m, n, sms) == rows


def test_group_sums_scratch_rows_are_whole_16_bytes():
    """[K/128, round_up(M, 4)]: each group's row is a whole number of TMA's
    16-byte units whatever M."""
    for m, want in ((33, 36), (128, 128), (130, 132)):
        t = tq.group_sums_scratch(m, 640, torch.float32, "cpu")
        assert t.shape == (5, want) and t.stride(0) * t.element_size() % 16 == 0


@pytest.mark.parametrize("integer", [True, False])
def test_stacked_layer_matches_stacked_pallas(integer):
    bits, g, L, m = 2, 64, 3, 4
    rng = np.random.default_rng(11)
    layers = [_layer(rng, bits, g, integer) for _ in range(L)]
    qw = np.stack([lay[1] for lay in layers])
    scales = np.stack([lay[2] for lay in layers])
    szeros = np.stack([lay[3] for lay in layers])
    x = _x(rng, m, integer)
    stacked = TP(
        qweight=torch.from_numpy(qw), scales=torch.from_numpy(scales),
        szeros=torch.from_numpy(szeros), bias=None, bits=bits, group_size=g,
        in_features=K, out_features=N,
    )
    jcombo_st = np.asarray(jcombo(jnp.asarray(scales), jnp.asarray(szeros)))
    for li in range(L):
        got = tq.quant_matmul(torch.from_numpy(x), stacked, li).numpy()
        want = np.asarray(jq._quant_matmul_pallas_2d_stacked(
            jnp.asarray(x), jnp.asarray(qw), jnp.asarray(jcombo_st), jnp.asarray(li, jnp.int32),
            bits=bits, group_size=g, block_m=8, block_n=128, groups_per_step=2,
            interpret=True,
        ))
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wrapper_reads_stacked_layer_in_place(monkeypatch):
    """On the CPU the wrapper hands the plain version a view of layer li:
    its data_ptr is the stacked base plus li layer strides."""
    rng = np.random.default_rng(5)
    layers = [_layer(rng, 2, 64, True) for _ in range(3)]
    qw = torch.from_numpy(np.stack([lay[1] for lay in layers]))
    stacked = TP(
        qweight=qw, scales=torch.from_numpy(np.stack([lay[2] for lay in layers])),
        szeros=torch.from_numpy(np.stack([lay[3] for lay in layers])), bias=None,
        bits=2, group_size=64, in_features=K, out_features=N,
    )
    seen = []
    real = tq.quant_matmul_plain

    def spy(x, qweight, *args):
        seen.append(qweight.data_ptr())
        return real(x, qweight, *args)

    monkeypatch.setattr(tq, "quant_matmul_plain", spy)
    x = torch.from_numpy(_x(rng, 2, True))
    for li in range(3):
        tq.quant_matmul(x, stacked, li)
    assert seen == [qw.data_ptr() + li * qw.stride(0) * qw.element_size() for li in range(3)]


def test_cpu_tensor_never_reaches_the_kernel():
    """A CPU tensor runs the plain version and counts no kernel launch."""
    rng = np.random.default_rng(6)
    _, qw, scales, szeros = _layer(rng, 4, 128, True)
    p = TP(qweight=torch.from_numpy(qw), scales=torch.from_numpy(scales),
           szeros=torch.from_numpy(szeros), bias=None, bits=4, group_size=128,
           in_features=K, out_features=N)
    before = (tq.qmm_decode.launches, tq.qmm_prefill.launches)
    out = tq.quant_matmul(torch.from_numpy(_x(rng, 5, True)).reshape(1, 5, K), p)
    assert out.shape == (1, 5, N)
    assert (tq.qmm_decode.launches, tq.qmm_prefill.launches) == before


def test_prefill_ablation_patches_apply():
    """scripts/prefill_ablation.py patches the prefill kernel's source by
    text: every patch still applies, and each ablation differs from the
    kernel and from the others."""
    from bitdistiller_tpu_torch.ops import _build
    from bitdistiller_tpu_torch.scripts import prefill_ablation

    src = (_build.CSRC_DIR / "quant_matmul.cu").read_text()
    texts = prefill_ablation.variants(src)
    assert texts["kernel"] == src and len(set(texts.values())) == len(texts) == 5


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [1, 16, 17, 32])
def test_plain_matches_pallas_at_decode_tiles(m, bits, integer):
    """The plain version, which the card holds the streaming decode kernel
    against, at that kernel's token tiles: one row, 16 (two 8-token tiles),
    17 (ragged against four) and 32 (the decode cap); 5 groups of 128 (a
    cluster's K split with a remainder), N = 320 (ragged against 128- and
    256-column tiles)."""
    k, n, g = 5 * 128, 320, 128
    rng = np.random.default_rng(2000 + 10 * m + bits)
    codes, qw, scales, szeros = _layer(rng, bits, g, integer, k, n)
    x = _x(rng, m, integer, k)
    got = tq.quant_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(scales),
        torch.from_numpy(szeros), bits, g,
    ).numpy()
    want = np.asarray(jq.quant_matmul_pallas(
        jnp.asarray(x), _jp(qw, scales, szeros, bits, g, k, n), interpret=True))
    if integer:
        np.testing.assert_array_equal(got, want)
        dense = x @ (codes.astype(np.float32) * np.repeat(scales, g, 0) - np.repeat(szeros, g, 0))
        np.testing.assert_array_equal(got, dense)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


A16_PLANS_7B = {  # (N, K): (cluster, columns a warp) on 132 SMs
    (12288, 4096): (6, 32), (4096, 4096): (8, 16), (22016, 4096): (4, 32), (4096, 11008): (8, 16)}


@pytest.mark.parametrize("n,k", sorted(A16_PLANS_7B))
def test_a16_decode_plan_at_7b_shapes(n, k):
    """qkv and gate_up take 32 columns a warp (256 a cluster) on the
    smallest cluster that puts 2 x 132 CTAs on the card; o and down (N =
    4096: 16 such tiles, 128 CTAs at the largest cluster) take 16 columns a
    warp, 32 tiles of 8 CTAs; never more CTAs in a cluster than K groups."""
    cluster, warp_cols = tq.a16_decode_plan(n, k // 128, 132)
    assert (cluster, warp_cols) == A16_PLANS_7B[(n, k)]
    assert warp_cols in tq.A16_WARP_COLS
    assert cluster == tq.decode_plan(n, k // 128, 132, cols=8 * warp_cols)
    assert cluster <= min(tq.MAX_CLUSTER, k // 128)


@pytest.mark.parametrize("n,groups,sms,want", [
    (320, 5, 132, (5, 16)),     # odd group count: no plan fills the card; 16 columns a warp
    (4096, 1, 132, (1, 16)),    # one group: no K split
    (4096, 86, 8, (1, 32)),     # a small card: 16 tiles of 256 fill it alone
    (4096, 3, 132, (3, 16)),    # 3 groups: 96 CTAs at most
    (100, 86, 132, (8, 16)),    # N short of one tile: one cluster of the largest size
])
def test_a16_decode_plan_at_odd_group_counts(n, groups, sms, want):
    assert tq.a16_decode_plan(n, groups, sms) == want


def test_decode_ablation_a16_patches_apply():
    """scripts/decode_ablation.py patches the A16 decode kernel's source by
    text: every patch still applies, once, and each variant differs from the
    kernel and from the others."""
    from bitdistiller_tpu_torch.ops import _build
    from bitdistiller_tpu_torch.scripts import decode_ablation

    src = (_build.CSRC_DIR / "quant_matmul.cu").read_text()
    texts = decode_ablation.a16_variants(src)
    assert texts["kernel"] == src
    assert len(set(texts.values())) == len(texts)


@pytest.mark.parametrize("kernel", ["a16", "attention"])
def test_decode_timeline_patches_apply(kernel):
    """scripts/decode_timeline.py stamps the A16 decode kernel and the decode
    attention by text patches: each still applies, once, and adds the stamp
    array and its reader."""
    from bitdistiller_tpu_torch.ops import _build
    from bitdistiller_tpu_torch.scripts import decode_timeline

    name, make = {"a16": ("quant_matmul.cu", decode_timeline.a16_source),
                  "attention": ("decode_attention.cu", decode_timeline.attention_source)}[kernel]
    src = (_build.CSRC_DIR / name).read_text()
    text = make(src)
    assert "stamp(0, 0);" in text and "stamp(6, 0);" in text and "bd_ts_copy" in text
