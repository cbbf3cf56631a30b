"""The C1 repair's dispatch rule, on the CPU: every group size (32, 64, 128,
a multiple of 128 and per-channel), f32 activations and decode attention at
D = 256 (and f32 q) choose a kernel entry for tensors on the card, never a
plain version, and hand the kernel the group, the step order (kmap, above
g = 128) and the dtype flag. No kernel can launch here, so the device test
(`_device.on_card`) is made to answer "on the card" for CPU tensors, the
launchers are replaced by recording stubs, and every plain version raises
if it is called. B8's autograd Function takes the same route (its forward
and both backward kernels)."""

import numpy as np
import pytest
import torch

from bitdistiller_tpu_torch import _device
from bitdistiller_tpu_torch.experimental import fused_mlp as fm
from bitdistiller_tpu_torch.ops import decode_attention as da
from bitdistiller_tpu_torch.ops import quant_matmul as qm
from bitdistiller_tpu_torch.ops import train_attention as ta
from bitdistiller_tpu_torch.quant.packing import quantize_pack_linear


class _Stream:
    cuda_stream = 0


@pytest.fixture
def calls(monkeypatch):
    log = []

    def stub(name):
        def launch(*args):
            log.append((name, args))
            return 0
        return launch

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran for a tensor on the card")

    monkeypatch.setattr(_device, "on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    for mod in (qm, fm, da):
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    monkeypatch.setattr(qm, "_launcher", stub)
    monkeypatch.setattr(qm, "_a8_launcher", lambda: stub("bd_qmm_a8"))
    monkeypatch.setattr(fm, "_launcher", lambda: stub("bd_fused_mlp"))
    monkeypatch.setattr(da, "_launcher", lambda: stub("bd_flash_decode"))
    monkeypatch.setattr(ta, "_launcher", stub)
    for mod, name in ((qm, "quant_matmul_plain"), (qm, "quant_matmul_a8_plain"),
                      (fm, "fused_mlp_plain"), (da, "decode_attention_plain"),
                      (ta, "flash_train_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    return log


def _packed(k, n, group, seed=0):
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32))
    return quantize_pack_linear(w, 2, group)


GROUPS = [32, 64, 128, 256, -1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", [8, 40])
def test_a16_dispatch_takes_a_kernel(calls, m, group, dtype):
    k = 512
    p = _packed(k, 256, group)
    g = p.group_size
    before = qm.qmm_decode.launches + qm.qmm_prefill.launches
    qm.quant_matmul(torch.zeros((m, k), dtype=dtype), p)
    name, args = calls[-1]
    assert name == ("bd_qmm_decode" if m <= qm.DECODE_MAX_M else "bd_qmm_prefill")
    assert qm.qmm_decode.launches + qm.qmm_prefill.launches == before + 1
    if name == "bd_qmm_decode":  # x, qweight, combo, kmap, out, M, K, N, bits, g, ..., f32
        assert args[5:10] == (m, k, 256, 2, g) and args[-2] == int(dtype == torch.float32)
        assert (args[3] is not None) == (g > 128)
    else:  # x, qweight, combo, kmap, xb, xsum, out, M, K, N, bits, g, tile, f32
        assert args[7:12] == (m, k, 256, 2, g) and args[-2] == int(dtype == torch.float32)
        assert (args[3] is not None) == (g > 128)
        assert (args[4] is not None) == (g > 128 or dtype == torch.float32)


@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", GROUPS)
def test_a8_dispatch_takes_a_kernel(calls, monkeypatch, group, dtype, repacked):
    monkeypatch.setenv("BITDISTILLER_QMM_A8", "1")
    p = _packed(512, 256, group)
    if repacked:
        p = qm.repack_linear_a8(p)
    g = p.group_size
    before = qm.qmm_a8.launches
    for m in (8, 40):
        qm.quant_matmul(torch.zeros((m, 512), dtype=dtype), p)
        name, args = calls[-1]
        assert name == "bd_qmm_a8" and args[10:15] == (m, 512, 256, 2, g)
        assert args[-2] == int(dtype == torch.float32)
        assert (args[5] is not None) == (g > 128 or not repacked)  # kmap
    assert qm.qmm_a8.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", GROUPS)
def test_fused_mlp_dispatch_takes_a_kernel(calls, group, dtype):
    g = group if group > 0 else 256
    gate, up = _packed(256, 256, g, 1), _packed(256, 256, g, 2)
    down = _packed(256, 128, g, 3)
    before = fm.fused_mlp.launches
    fm.fused_mlp(torch.zeros((8, 256), dtype=dtype), gate, up, down, block_f=256)
    name, args = calls[-1]
    assert name == "bd_fused_mlp" and fm.fused_mlp.launches == before + 1
    assert args[15:21] == (8, 256, 256, 128, 2, g) and args[-2] == int(dtype == torch.float32)
    assert (args[10] is not None) == (g > 128) and (args[11] is not None) == (g > 128)


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 256])
def test_decode_attention_dispatch_takes_the_kernel(calls, d, qdtype):
    b, hq, hkv, t = 2, 8, 2, 16
    q = torch.zeros((b, 1, hq, d), dtype=qdtype)
    kv = torch.zeros((b, 1, hkv, d), dtype=qdtype)
    ck = torch.zeros((2, b, hkv, t, d), dtype=torch.bfloat16)
    before = da.flash_decode_stacked.launches
    da.flash_decode_stacked(q, ck, ck, 1, kv, kv, torch.tensor([3, 9], dtype=torch.int32))
    name, args = calls[-1]
    assert name == "bd_flash_decode" and da.flash_decode_stacked.launches == before + 1
    assert args[14] == d and args[-2] == int(qdtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_train_attention_dispatch_takes_the_kernels(calls, dtype):
    q = torch.zeros((2, 70, 4, 64), dtype=dtype, requires_grad=True)
    k = torch.zeros((2, 70, 2, 64), dtype=dtype, requires_grad=True)
    mask = torch.ones((2, 70), dtype=torch.int32)
    out = ta.flash_train_attention(q, k, k, mask)
    out.backward(torch.zeros_like(out))
    names = [name for name, _ in calls]
    assert names == ["bd_train_attn_fwd", "bd_train_attn_dkv", "bd_train_attn_dq"]
    for _, args in calls:
        assert args[-2] == int(dtype == torch.float32)
