"""The launch decisions of K2's, K3's and K4's backward wrappers, made in
Python before any launch, held at every training path shape of
``PERF.md`` §6: which kernels K2's backward takes
(``flash_attention._bwd_route``) and how many blocks share a group's query
heads in its dK/dV launch (``flash_attention._dkdv_splits``), which kernel
K3's forward and backward take (``moe_gmm._fwd_route``, ``_route``; dense
and ragged) and which K4's takes
(``rwkv_scan._bwd_route``).  Shapes at full size use meta tensors, which
carry shapes, strides and offsets but no storage.  CPU tensors never reach
these kernels: they take the plain backwards of ``kernels/ref.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as k2      # noqa: E402
from repro_torch.kernels import moe_gmm as k3              # noqa: E402
from repro_torch.kernels import ops, ref                   # noqa: E402
from repro_torch.kernels import rwkv_scan as k4            # noqa: E402

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


def _packed(E, M, D, F, dtype=BF, pad_x=0, offset_x=0, pad_dy=0):
    """The all-to-all dispatch's ragged operands on the meta device: x (M,
    D) packed, a view of (M, D + pad_x) starting offset_x elements in; w
    (E, D, F) as one layer's view of a stacked leaf; dy (M, F), a view of
    (M, F + pad_dy)."""
    x = torch.empty((M, D + pad_x + offset_x), dtype=dtype,
                    device="meta")[:, offset_x:offset_x + D]
    w = torch.empty((2, E, D, F), dtype=dtype, device="meta")[1]
    dy = torch.empty((M, F + pad_dy), dtype=dtype, device="meta")[:, :F]
    return x, w, dy


@pytest.mark.parametrize("E,M,D,F,pad_x,offset_x,pad_dy,route", [
    (8, 40960, 4096, 1536, 0, 0, 0, "wgmma"),   # one rank of 16x16 train_4k
    (8, 40960, 1536, 4096, 0, 0, 0, "wgmma"),   # its down product
    (128, 8192, 4096, 1536, 0, 0, 0, "wgmma"),  # mesh_moe's one rank
    (128, 4000, 256, 192, 0, 0, 0, "wgmma"),
    (4, 100, 520, 256, 8, 0, 8, "wgmma"),       # strided but aligned rows
    (4, 100, 13, 40, 0, 0, 0, "tc"),            # D = 13: x's rows, w's E
    (4, 100, 24, 259, 0, 0, 0, "tc"),           # F = 259: w's rows
    (4, 100, 512, 256, 0, 1, 0, "tc"),          # x's base 2 bytes off
    (4, 100, 512, 256, 4, 0, 0, "tc"),          # x's rows of 516
    (4, 100, 512, 256, 0, 0, 4, "tc")])         # dy's rows of 260
def test_route_on_packed_ragged_operands(E, M, D, F, pad_x, offset_x,
                                         pad_dy, route):
    """Ragged calls take the TMA / wgmma kernels, forward and backward,
    where TMA can read the packed 2-D x (and dy) and w: 16-byte aligned
    bases and row strides; else mma.sync; float32 the CUDA-core ones.  The
    forward reads no dy: an unaligned dy leaves it on wgmma."""
    x, w, dy = _packed(E, M, D, F, pad_x=pad_x, offset_x=offset_x,
                       pad_dy=pad_dy)
    assert k3._route(x, w, dy) == route
    assert k3._fwd_route(x, w, ragged=True) == \
        ("wgmma" if pad_dy else route)
    f32 = _packed(E, M, D, F, dtype=torch.float32, pad_x=pad_x,
                  offset_x=offset_x, pad_dy=pad_dy)
    assert k3._route(*f32) == "f32"
    assert k3._fwd_route(*f32[:2], ragged=True) == "f32"


@pytest.mark.parametrize("E,C,D,F", [(128, 640, 4096, 1536),
                                     (128, 80, 1536, 4096), (3, 1, 64, 8)])
def test_dense_forward_stays_on_the_mma_sync_kernel(E, C, D, F):
    """A dense bf16 forward takes "tc" even where TMA could read its
    operands (its backward takes wgmma); float32 "f32"."""
    x, w, dy = _k3(E, C, D, F)
    assert k3._route(x, w, dy) == "wgmma"
    assert k3._fwd_route(x, w, ragged=False) == "tc"
    assert k3._fwd_route(*_k3(E, C, D, F, dtype=torch.float32)[:2],
                         ragged=False) == "f32"


def test_route_refuses_overlapping_packed_rows():
    """An expanded (stride 0) packed x is not a tensor TMA can map."""
    x, w, dy = _packed(4, 100, 512, 256)
    assert k3._route(x[:1].expand(100, 512), w, dy) == "tc"


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
    assert not any(k3.bwd_routes.values()) and not any(k3.routes.values())
    want = ref.moe_gmm_backward(x.detach(), w.detach(), dy, r)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        k3.backward(x.detach(), w.detach(), dy, r)


def _k2(B, H, Hkv, T, S, hd, dtype=BF, pad=0, offset=0, layout="model"):
    """q, k, v, dout on the meta device: the model's (B, T, heads, hd)
    buffers seen as (B, heads, T, hd) ("model"), or contiguous (B, heads,
    T, hd) ("heads"); ``pad`` widens each row of q's buffer and ``offset``
    starts q that many elements in."""
    def view(n, rows, extra=0, off=0):
        if layout == "heads":
            t = torch.empty((B, n, rows, hd + extra + off), dtype=dtype,
                            device="meta")
            return t[..., off:off + hd]
        t = torch.empty((B, rows, n, hd + extra + off), dtype=dtype,
                        device="meta")
        return t[..., off:off + hd].transpose(1, 2)
    return (view(H, T, pad, offset), view(Hkv, S), view(Hkv, S), view(H, T))


# (path, B, H, Hkv, T, hd, route): the trained families' K2 backward
TRAIN_K2_ROUTES = [("qwen3-0.6b train", 8, 16, 8, 1024, 128, "wgmma"),
                   ("qwen3-moe-235b-a22b train", 8, 64, 4, 1024, 128,
                    "wgmma"),
                   ("recurrentgemma-9b train", 8, 16, 1, 1024, 256, "wide")]


@pytest.mark.parametrize("path,B,H,Hkv,T,hd,route", TRAIN_K2_ROUTES)
def test_k2_bwd_route_at_the_training_shapes(path, B, H, Hkv, T, hd, route):
    """bf16 at hd 128 in the model's transposed views takes the TMA /
    wgmma kernels, hd 256 the 8-warp mma.sync ones; float32 the CUDA-core
    ones; the same operands contiguous take the same route."""
    assert k2._bwd_route(*_k2(B, H, Hkv, T, T, hd)) == route
    assert k2._bwd_route(*_k2(B, H, Hkv, T, T, hd, layout="heads")) == route
    assert k2._bwd_route(*_k2(B, H, Hkv, T, T, hd,
                              dtype=torch.float32)) == "cc"


@pytest.mark.parametrize("B,H,Hkv,T,S,hd,pad,offset,route", [
    (2, 16, 8, 1000, 1000, 128, 0, 0, "wgmma"),    # ragged T, S
    (1, 4, 4, 50, 130, 128, 0, 0, "wgmma"),        # T < S
    (1, 16, 1, 1, 1, 128, 0, 0, "wgmma"),          # B = Hkv = T = 1
    (2, 16, 8, 1000, 1000, 128, 0, 1, "tc"),       # q 2 bytes off
    (2, 16, 8, 1000, 1000, 128, 4, 0, "tc"),       # q's rows of 132
    (2, 16, 8, 1000, 1000, 128, 8, 0, "wgmma"),    # q's rows of 136
    (2, 8, 8, 1000, 1000, 64, 0, 0, "tc"),         # hd 64
    (2, 4, 1, 100, 130, 32, 0, 0, "tc"),           # hd 32
    (2, 32, 8, 1024, 1024, 160, 0, 0, "wide")])    # pixtral's hd 160
def test_k2_bwd_route_sends_unaligned_or_other_head_dims_elsewhere(
        B, H, Hkv, T, S, hd, pad, offset, route):
    """TMA needs each base and each stride of a dim longer than 1 a
    multiple of 16 bytes: an unaligned q takes the 4-warp mma.sync kernels,
    as do hd 32 and 64; hd 160 and 256 the 8-warp ones."""
    assert k2._bwd_route(*_k2(B, H, Hkv, T, S, hd, pad=pad,
                              offset=offset)) == route


def test_k2_bwd_route_refuses_a_zero_stride():
    """An expanded (stride 0) k is no tensor TMA can map."""
    q, k, v, dout = _k2(2, 16, 8, 256, 256, 128)
    assert k2._bwd_route(q, k[:, :1].expand(2, 8, 256, 128), v, dout) == "tc"


@pytest.mark.parametrize("path,B,H,Hkv,S,hd,splits", [
    ("qwen3-0.6b train", 8, 16, 8, 1024, 128, 1),
    ("qwen3-moe-235b-a22b train", 8, 64, 4, 1024, 128, 1),
    ("recurrentgemma-9b train", 8, 16, 1, 1024, 256, 8),
    ("MQA at hd 128", 8, 16, 1, 1024, 128, 8),
    ("MQA at hd 128, B = 2", 2, 16, 1, 1024, 128, 16)])
def test_dkdv_splits_on_the_route_each_shape_takes(path, B, H, Hkv, S, hd,
                                                   splits):
    """The rule counts the route's dK/dV blocks in units of 64 keys (a
    wgmma block of 128 keys is two): the MoE's 256 wgmma blocks keep one
    split, as recurrentgemma-9b's MQA splits in 8; MQA at hd 128 takes the
    same splits on wgmma as its 64-key units give."""
    rows = k2.WGMMA_ROWS if k2._bwd_route(*_k2(B, H, Hkv, S, S, hd)) \
        == "wgmma" else k2.DKDV_ROWS
    assert k2._dkdv_splits(B, Hkv, S, H, hd, BF, rows) == splits


@pytest.mark.parametrize("B,H,T,M,dtype,route", [
    (8, 40, 1024, 64, BF, "tc"), (1, 40, 1000, 64, BF, "tc"),
    (4, 40, 1, 64, BF, "tc"), (2, 5, 1000, 40, BF, "tc"),
    (8, 40, 1024, 64, torch.float32, "cc"),
    (2, 5, 1000, 40, torch.float32, "cc")])
def test_k4_bwd_route(B, H, T, M, dtype, route):
    """K4's backward: bf16 r, k, v (rwkv6-3b's training shape, ragged T,
    the decode step, heads under 64) take the tensor-core kernels, in the
    model's (B, T, H, M) layout or contiguous; float32 the CUDA-core
    ones."""
    r = torch.empty((B, T, H, M), dtype=dtype, device="meta").transpose(1, 2)
    assert k4._bwd_route(r) == route
    assert k4._bwd_route(r.contiguous()) == route


def test_cpu_rwkv_gradient_is_the_plain_backward():
    """On the CPU ``ops.rwkv_scan`` is ``ref.rwkv_scan``: its autograd
    gradient equals ``ref.rwkv_scan_backward``, and no kernel or route is
    counted."""
    g = torch.Generator().manual_seed(2)
    B, H, T, M = 1, 2, 70, 8
    r, k, v = (torch.randn((B, H, T, M), generator=g).requires_grad_(True)
               for _ in range(3))
    logw = (-0.105 * torch.rand((B, H, T, M), generator=g)) \
        .requires_grad_(True)
    u = (0.1 * torch.randn((H, M), generator=g)).requires_grad_(True)
    do = torch.randn((B, H, T, M), generator=g)
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.rwkv_scan(r, k, v, logw, u)[0],
                              (r, k, v, logw, u), do)
    assert not any(ops.launch_counts().values())
    assert not any(k4.bwd_routes.values())
    assert not any(k2.bwd_routes.values())
    with torch.no_grad():
        want = ref.rwkv_scan_backward(r, k, v, logw, u, None, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
