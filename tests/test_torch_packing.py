"""Packing in the port is bit-equal to the JAX package: pair-layout words,
combo words and the quantizer's codes, scales and zeros, at int2 and int4,
groups of 64, 128 and the whole K (-1). Tolerance: none (bit-equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdistiller_tpu.quant import packing as jp
from bitdistiller_tpu_torch.quant import packing as tp

K, N = 256, 48
CASES = [(b, g) for b in (2, 4) for g in (64, 128, -1)]


@pytest.mark.parametrize("bits,group", CASES)
def test_pack_unpack_codes_bit_equal(bits, group):
    rng = np.random.default_rng(bits * 1000 + group)
    codes = rng.integers(0, 2**bits, (K, N)).astype(np.int32)
    jw = np.asarray(jp.pack_codes(jnp.asarray(codes), bits, group))
    tw = tp.pack_codes(torch.from_numpy(codes), bits, group)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), jw)
    back = tp.unpack_codes(torch.from_numpy(np.array(jw)), bits, group).numpy()
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(
        back, np.asarray(jp.unpack_codes(jnp.asarray(jw), bits, group))
    )


def test_make_scale_combo_bit_equal():
    rng = np.random.default_rng(0)
    scales = (rng.random((6, N)) * 0.05).astype(np.float32)
    szeros = (rng.random((6, N)) * 0.2 - 0.05).astype(np.float32)
    jc = np.asarray(jp.make_scale_combo(jnp.asarray(scales), jnp.asarray(szeros)))
    tc = tp.make_scale_combo(torch.from_numpy(scales), torch.from_numpy(szeros))
    np.testing.assert_array_equal(tc.numpy(), jc)
    # the kernel's decode of a combo word is bf16-rounding of each half
    s, sz = tp.scales_from_combo(tc)
    np.testing.assert_array_equal(s.numpy(), torch.from_numpy(scales).bfloat16().float().numpy())
    np.testing.assert_array_equal(sz.numpy(), torch.from_numpy(szeros).bfloat16().float().numpy())


@pytest.mark.parametrize("bits,group", CASES)
def test_quantize_pack_linear_bit_equal(bits, group):
    rng = np.random.default_rng(7 + bits + group)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jpk = jp.quantize_pack_linear(jnp.asarray(w), bits, group)
    tpk = tp.quantize_pack_linear(torch.from_numpy(w), bits, group)
    for name in ("qweight", "scales", "szeros", "combo"):
        np.testing.assert_array_equal(
            getattr(tpk, name).numpy(), np.asarray(getattr(jpk, name)), err_msg=name
        )
    assert (tpk.group_size, tpk.in_features, tpk.out_features) == (
        jpk.group_size, jpk.in_features, jpk.out_features)
    np.testing.assert_array_equal(
        tp.dequantize_linear(tpk).numpy(), np.asarray(jp.dequantize_linear(jpk))
    )


def test_stacked_layer_is_a_view():
    rng = np.random.default_rng(3)
    packs = [tp.quantize_pack_linear(torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)), 2, 64)
             for _ in range(3)]
    stacked = tp.PackedLinear(
        qweight=torch.stack([p.qweight for p in packs]),
        scales=torch.stack([p.scales for p in packs]),
        szeros=torch.stack([p.szeros for p in packs]), bias=None, bits=2, group_size=64,
        in_features=K, out_features=N, combo=torch.stack([p.combo for p in packs]),
    )
    layer = stacked.layer(2)
    assert layer.qweight.data_ptr() == stacked.qweight.data_ptr() + 2 * stacked.qweight.stride(0) * 4
    assert layer.combo.data_ptr() == stacked.combo.data_ptr() + 2 * stacked.combo.stride(0) * 4
    np.testing.assert_array_equal(layer.qweight.numpy(), packs[2].qweight.numpy())
