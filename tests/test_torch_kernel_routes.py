"""The launch decisions of K2's and K3's backward wrappers, made in Python
before any launch, held at every training path shape of ``PERF.md`` §6:
how many blocks share a group's query heads in K2's dK/dV launch
(``flash_attention._dkdv_splits``) and which kernel K3's backward takes
(``moe_gmm._route``).  Shapes at full size use meta tensors, which carry
shapes, strides and offsets but no storage.  CPU tensors never reach these
kernels: they take the plain backwards of ``kernels/ref.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as k2      # noqa: E402
from repro_torch.kernels import moe_gmm as k3              # noqa: E402
from repro_torch.kernels import ops, ref                   # noqa: E402

BF = torch.bfloat16

# (path, B, H, Hkv, S, hd, splits): the trained families' K2 backward
TRAIN_K2 = [("recurrentgemma-9b train", 8, 16, 1, 1024, 256, 8),
            ("qwen3-0.6b train", 8, 16, 8, 1024, 128, 1),
            ("qwen3-moe-235b-a22b train", 8, 64, 4, 1024, 128, 1)]


@pytest.mark.parametrize("path,B,H,Hkv,S,hd,splits", TRAIN_K2)
def test_dkdv_splits_at_the_training_shapes(path, B, H, Hkv, S, hd, splits):
    """recurrentgemma-9b's MQA (128 dK/dV blocks, under two waves of 132
    SMs) splits its 16 heads in 8 (1,024 blocks, four waves); qwen3-0.6b
    (1,024 blocks) and the MoE (512) keep one block per kv head, and
    float32 never splits."""
    assert k2._dkdv_splits(B, Hkv, S, H, hd, BF) == splits
    assert k2._dkdv_splits(B, Hkv, S, H, hd, torch.float32) == 1


@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (2, 16, 1, 300, 256), (1, 16, 1, 4096, 256), (2, 32, 8, 1024, 160),
    (2, 16, 2, 130, 128), (2, 4, 1, 130, 32), (8, 12, 3, 1000, 64),
    (1, 8, 8, 64, 128), (4, 6, 1, 2048, 160)])
def test_dkdv_splits_divide_the_group_and_fill_the_waves(B, H, Hkv, S, hd):
    """One split where its blocks fill two waves of the SMs; else splits
    divides G = H / Hkv and is the least divisor whose blocks fill four
    waves, or G itself when none does."""
    G = H // Hkv
    splits = k2._dkdv_splits(B, Hkv, S, H, hd, BF)
    blocks = B * Hkv * -(-S // k2.DKDV_ROWS)
    assert G % splits == 0
    if blocks >= 2 * k2.SMS:
        assert splits == 1
        return
    assert blocks * splits >= 4 * k2.SMS or splits == G
    assert all(G % d or blocks * d < 4 * k2.SMS for d in range(1, splits))


def _k3(E, C, D, F, dtype=BF, pad_x=0, offset_x=0):
    """x (E, C, D), a view of (E, C, D + pad_x) starting offset_x elements
    in; w (E, D, F) as one layer's view of a stacked (2, E, D, F) leaf; dy
    (E, C, F); all on the meta device."""
    x = torch.empty((E, C, D + pad_x + offset_x), dtype=dtype,
                    device="meta")[..., offset_x:offset_x + D]
    w = torch.empty((2, E, D, F), dtype=dtype, device="meta")[1]
    dy = torch.empty((E, C, F), dtype=dtype, device="meta")
    return x, w, dy


@pytest.mark.parametrize("E,C,D,F", [(128, 640, 4096, 1536),
                                     (128, 640, 1536, 4096)])
def test_route_takes_wgmma_at_the_training_shapes(E, C, D, F):
    """qwen3-moe-235b-a22b's gate/up and down at the training capacity
    take the TMA / wgmma kernel; in float32 the CUDA-core one."""
    assert k3._route(*_k3(E, C, D, F)) == "wgmma"
    assert k3._route(*_k3(E, C, D, F, dtype=torch.float32)) == "f32"


@pytest.mark.parametrize("E,C,D,F,pad_x,offset_x,route", [
    (6, 37, 1000, 200, 96, 0, "wgmma"),     # strided but aligned x
    (128, 80, 4096, 1536, 0, 0, "wgmma"),   # the prefill capacity
    (3, 1, 64, 8, 0, 0, "wgmma"),           # C = 1, F = 8: 16-byte rows
    (4, 130, 520, 259, 8, 0, "tc"),         # F = 259: dy's rows unaligned
    (6, 37, 1000, 259, 0, 0, "tc"),         # D = 1000 with F = 259
    (5, 13, 300, 129, 0, 0, "tc"),          # F = 129
    (4, 130, 520, 260, 4, 0, "tc"),         # x's rows of 524: unaligned
    (4, 64, 512, 256, 8, 1, "tc")])         # x's base 2 bytes off
def test_route_sends_unaligned_operands_to_the_mma_sync_kernel(
        E, C, D, F, pad_x, offset_x, route):
    """TMA needs 16-byte aligned bases and row / expert strides: the
    ragged smoke shapes and unaligned views take ``gmm_bwd_tc``."""
    assert k3._route(*_k3(E, C, D, F, pad_x=pad_x, offset_x=offset_x)) \
        == route


def test_route_refuses_overlapping_rows():
    """An expanded (stride 0) operand is not a tensor TMA can map."""
    x, w, dy = _k3(4, 64, 512, 256)
    assert k3._route(x[:1].expand(4, 64, 512), w, dy) == "tc"


@pytest.mark.parametrize("causal,window,Hkv", [(True, 0, 1), (True, 3, 2),
                                               (False, 0, 4)])
def test_cpu_attention_gradient_is_the_plain_backward(causal, window, Hkv):
    """On the CPU ``ops.flash_attention`` is ``ref.attention``: its
    autograd gradient equals ``ref.attention_backward`` and no kernel is
    counted."""
    g = torch.Generator().manual_seed(0)
    B, H, T, S, hd = 2, 4, 9, 11, 32
    q = torch.randn((B, H, T, hd), generator=g).requires_grad_(True)
    k, v = (torch.randn((B, Hkv, S, hd), generator=g).requires_grad_(True)
            for _ in range(2))
    dout = torch.randn((B, H, T, hd), generator=g)
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=causal,
                                                  window=window),
                              (q, k, v), dout)
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        out, lse = ref.attention_lse(q, k, v, causal=causal, window=window)
        want = ref.attention_backward(q, k, v, out, lse, dout,
                                      causal=causal, window=window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        k2.backward(q, k, v, out, lse, dout, causal=causal, window=window)


@pytest.mark.parametrize("rows", [None, [0, 3, 5]])
def test_cpu_moe_gmm_gradient_is_the_plain_backward(rows):
    """On the CPU ``ops.moe_gmm`` is ``ref.moe_gmm``: its autograd gradient
    equals ``ref.moe_gmm_backward``, and no kernel or route is counted."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 5, 7), generator=g).requires_grad_(True)
    w = torch.randn((3, 7, 6), generator=g).requires_grad_(True)
    dy = torch.randn((3, 5, 6), generator=g)
    r = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.moe_gmm(x, w, r), (x, w), dy)
    assert not any(ops.launch_counts().values())
    assert not any(k3.bwd_routes.values())
    want = ref.moe_gmm_backward(x.detach(), w.detach(), dy, r)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        k3.backward(x.detach(), w.detach(), dy, r)
