"""The CUDA kernels on the card, each held against its plain PyTorch
version on the same inputs (2e-3 in float32, 2e-2 in bf16: the same math
summed in another order, bf16 output rounding), and the model's kernel path
against its plain path.  Every test here needs a card and skips without
one; this file imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs                            # noqa: E402
from repro_torch.kernels import ops, ref                   # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa
                                init_params)
from repro_torch.models.layers import attention              # noqa: E402
from repro_torch.models.transformer import clone_cache        # noqa: E402

TOLS = {"float32": 2e-3, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,causal,hd", [
    (128, 128, True, 64), (1024, 1024, True, 128), (50, 50, True, 32),
    (64, 192, True, 128), (40, 96, False, 256), (1024, 1024, True, 160),
    (77, 300, True, 160), (40, 96, False, 160)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, T, S, causal, hd):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((2, 8, T, hd), generator=g, device=cuda).to(dt)
    k = torch.randn((2, 4, S, hd), generator=g, device=cuda).to(dt)
    v = torch.randn((2, 4, S, hd), generator=g, device=cuda).to(dt)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1024, 0])
def test_cuda_flash_attention_mellum2_heads_match_plain(cuda, dtype, window):
    """Mellum2's attention: GQA 32/4 at hd 128 over 4,096 tokens, a
    windowed layer's (1,024) and a full layer's, on the model's transposed
    (B, T, H, hd) views."""
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    T = 4096
    q = torch.randn((1, T, 32, 128), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((1, T, 4, 128), generator=g, device=cuda).to(dt)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    want = ref.attention(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window", [(4096, 2048), (300, 100), (130, 64)])
def test_cuda_flash_attention_window_matches_plain(cuda, dtype, T, window):
    """recurrentgemma's local attention: MQA, hd=256, sliding window."""
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((1, 16, T, 256), generator=g, device=cuda).to(dt)
    k = torch.randn((1, 1, T, 256), generator=g, device=cuda).to(dt)
    v = torch.randn((1, 1, T, 256), generator=g, device=cuda).to(dt)
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    pos = torch.arange(T, device=cuda)
    for want in (ref.attention(q, k, v, window=window),
                 attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), pos, pos, window=window)
                 .transpose(1, 2)):         # the model's plain attention
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hkv,H,hd", [(4, 2048, 8, 16, 128),
                                          (4, 2048, 1, 16, 256),    # MQA
                                          (4, 2048, 4, 64, 128),    # G = 16
                                          # CUDA cores in bf16 too: hd
                                          # outside the mma set, hd > 256
                                          (4, 1000, 2, 8, 96),
                                          (4, 1000, 1, 2, 512)])
def test_cuda_decode_attention_matches_plain(cuda, dtype, B, S, Hkv, H, hd):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    cache = torch.randn((2, B, S, Hkv, hd), generator=g, device=cuda).to(dt)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(dt)
    k, v = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    lens = torch.tensor([1, S, 777, 64], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    want = ref.decode_attention(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 16])
def test_cuda_decode_attention_split_boundaries(cuda, dtype, hd, G):
    """K1's split over the cache at every boundary: lengths 1, tile - 1,
    tile, tile + 1, split - 1, split, split + 1 and S, on strided views of
    the model's (B, S, Hkv, hd) cache."""
    from repro_torch.kernels import decode_attention as k1
    Hkv, S = 2, 8192
    pl = k1.plan(8, G * Hkv, Hkv, S, hd)
    tile, split = k1.TILE, pl.keys_per_split
    assert split > tile + 1 and pl.splits > 1
    lens = [1, tile - 1, tile, tile + 1, split - 1, split, split + 1, S]
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    cache = torch.randn((2, 8, S, Hkv, hd), generator=g, device=cuda).to(dt)
    q = torch.randn((8, G * Hkv, hd), generator=g, device=cuda).to(dt)
    k, v = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for _ in range(2):          # the second call reuses the zeroed tickets
        got = ops.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        want = ref.decode_attention(q, k, v, lengths)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 160, 256])
@pytest.mark.parametrize("case", ["ragged", "T<S", "noncausal", "window",
                                  "unaligned_q"])
def test_cuda_flash_attention_bf16_tensor_cores(cuda, hd, case):
    """K2's bf16 path (tensor cores) at every head dim: ragged T and S,
    T < S, non-causal, a window, and a q view whose data_ptr is not 16-byte
    aligned (element loads instead of cp.async)."""
    T, S, causal, window = {"ragged": (100, 100, True, 0),
                            "T<S": (77, 300, True, 0),
                            "noncausal": (50, 130, False, 0),
                            "window": (300, 300, True, 100),
                            "unaligned_q": (128, 128, True, 0)}[case]
    g = torch.Generator(cuda).manual_seed(0)
    bf = torch.bfloat16
    if case == "unaligned_q":
        q = torch.randn((2, 8, T, hd + 1), generator=g,
                        device=cuda).to(bf)[..., 1:]
        assert q.data_ptr() % 16 and q.stride(-1) == 1
    else:
        q = torch.randn((2, 8, T, hd), generator=g, device=cuda).to(bf)
    k = torch.randn((2, 2, S, hd), generator=g, device=cuda).to(bf)
    v = torch.randn((2, 2, S, hd), generator=g, device=cuda).to(bf)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOLS["bfloat16"], atol=TOLS["bfloat16"])


@pytest.mark.cuda
def test_cuda_model_kernel_path_matches_plain_path(cuda):
    """Smoke qwen3 in float32: forward and a few decode steps through K1/K2
    against the same model with ``attn_impl="plain"`` on the card."""
    cfg = dataclasses.replace(configs.smoke("qwen3_0_6b"), dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="plain")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=cuda)
    ops.reset_launch_counts()
    got, _ = forward(cfg, params, {"tokens": toks})
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = forward(plain, params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=TOLS["float32"],
                               atol=TOLS["float32"])
    c_k, c_p = (init_cache(cfg, 2, 64, device=cuda) for _ in range(2))
    for t in range(3):
        lk, c_k = decode_step(cfg, params, c_k, toks[:, t:t + 1])
        lp, c_p = decode_step(plain, params, c_p, toks[:, t:t + 1])
        torch.testing.assert_close(lk, lp, rtol=TOLS["float32"],
                                   atol=TOLS["float32"])
    assert ops.launch_counts()["decode_attention"] == 3 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_pixtral_width_kernel_path_matches_plain_path(cuda, dtype):
    """pixtral-12b at its published widths (d 5120, 32 / 8 heads of 160,
    d_ff 14336, vocab 131072), 2 layers: a T = 100 forward through K2 at
    hd 160 and three decode steps through K1 at hd 160 against the same
    model with ``attn_impl="plain"``.  float32 at 2e-3; bf16 by relative L2
    at 5e-2 (the two paths round attention to bf16 at different points,
    as ``chip_smoke.py``'s ``LOGIT_REL_TOL``)."""
    cfg = dataclasses.replace(configs.get("pixtral_12b"), n_layers=2,
                              dtype=dtype)
    plain = dataclasses.replace(cfg, attn_impl="plain")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=g, device=cuda)

    def agree(got, want):
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=TOLS["float32"],
                                       atol=TOLS["float32"])
        else:
            got, want = got.float(), want.float()
            assert float((got - want).norm() / want.norm()) <= 5e-2
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _ = forward(cfg, params, {"tokens": toks})
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers
        agree(got, forward(plain, params, {"tokens": toks})[0])
        c_k, c_p = (init_cache(cfg, 2, 64, device=cuda) for _ in range(2))
        for t in range(3):
            lk, c_k = decode_step(cfg, params, c_k, toks[:, t:t + 1])
            lp, c_p = decode_step(plain, params, c_p, toks[:, t:t + 1])
            agree(lk, lp)
        assert ops.launch_counts()["decode_attention"] == 3 * cfg.n_layers


# smoke configs whose forward reaches K3, K4 or K5, the depth, and the
# launches of one loss_fn gradient under remat (each scanned layer's forward
# twice, the unrolled tail once)
GRAD_FAMILIES = [
    ("rwkv6_3b", 2, {"rwkv_scan": 4, "rwkv_scan_bwd": 2}),
    ("recurrentgemma_9b", 5, {"rglru_scan": 6, "rglru_scan_bwd": 4,
                              "flash_attention": 2,
                              "flash_attention_bwd": 1}),
    ("qwen3_moe_235b", 2, {"moe_gmm": 12, "moe_gmm_bwd": 6,
                           "flash_attention": 4, "flash_attention_bwd": 2})]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers,launches", GRAD_FAMILIES)
def test_cuda_gradients_kernel_path_match_plain_path(cuda, arch, n_layers,
                                                     launches):
    """Smoke rwkv6 / recurrentgemma (a scanned block of 3 under remat and
    an unrolled tail of 2) / qwen3-moe in float32: ``loss_fn`` gradients
    through K4, K5 + K2 or K3 + K2 and their backward kernels against the
    same model with ``attn_impl="plain"`` on the card, every leaf by
    relative L2 at 2e-3, with the launches of each kernel counted."""
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.models import loss_fn
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              n_layers=n_layers)
    plain = dataclasses.replace(cfg, attn_impl="plain")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 101), generator=g, device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ops.reset_launch_counts()
    got = torch.autograd.grad(loss_fn(cfg, params, batch), leaves)
    counts = ops.launch_counts()
    assert counts == {k: launches.get(k, 0) for k in counts}
    want = torch.autograd.grad(loss_fn(plain, params, batch), leaves)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 2e-3


@pytest.mark.cuda
def test_cuda_decode_attention_refuses_inputs_that_need_grad(cuda):
    """K1 is decode only and has no backward: on the card, with grad mode
    on, a query that requires grad raises instead of dropping its gradient;
    under ``torch.no_grad()`` the same call runs."""
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((2, 8, 64), generator=g, device=cuda).requires_grad_(True)
    k, v = (torch.randn((2, 2, 40, 64), generator=g, device=cuda)
            for _ in range(2))
    lens = torch.tensor([40, 17], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="decode_attention: .*no backward"):
        ops.decode_attention(q, k, v, lens)
    with torch.no_grad():
        out = ops.decode_attention(q, k, v, lens)
    torch.testing.assert_close(out, ref.decode_attention(q.detach(), k, v,
                                                         lens),
                               rtol=0, atol=TOLS["float32"])


def _scaled_close(got, want, tol):
    """Each gradient within ``tol`` of its largest entry, shape and dtype
    as the plain version's."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,a_val,strided", [
    (1, 4096, 4096, None, False), (3, 600, 4099, None, True),
    (2, 1, 33, None, False), (2, 15, 40, None, True),     # the short form
    (2, 16, 40, None, True), (1, 17, 64, None, False),
    (1, 257, 64, None, False), (1, 4097, 64, None, False),
    (1, 1000, 32, 1e-4, False), (1, 1000, 32, 0.999, False)])
def test_cuda_rglru_scan_backward_matches_plain(cuda, B, T, D, a_val,
                                                strided):
    """K5's backward against autograd of ``ref.rglru_scan`` and against
    the plain backward ``ref.rglru_scan_backward``: ragged T and
    D, B = 3, a and b read through B/T strides and dh through its strides
    (the gradient of a (T, B, D) buffer seen as (B, T, D)), the short form
    (T <= 16), strong decay and long memory; each gradient at 1e-4 of its
    largest entry (float32 sums in another order), with one forward and
    one backward launch."""
    g = torch.Generator(cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    if strided:
        a0 = torch.sigmoid(rand(B, T + 3, D + 5))[:, 1:T + 1, 2:D + 2]
        b0 = rand(T + 2, B, D + 7).transpose(0, 1)[:, :T, 3:D + 3]
        dh = rand(T, B, D).transpose(0, 1)
    else:
        a0, b0, dh = torch.sigmoid(rand(B, T, D)), rand(B, T, D), \
            rand(B, T, D)
    if a_val is not None:
        a0 = torch.full_like(a0, a_val)
    a, b = (t.detach().requires_grad_(True) for t in (a0, b0))
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.rglru_scan(a, b), (a, b), dh)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["rglru_scan"], counts["rglru_scan_bwd"]) == (1, 1)
    want = torch.autograd.grad(ref.rglru_scan(a, b), (a, b), dh)
    _scaled_close(got, want, 1e-4)
    with torch.no_grad():
        _scaled_close(got, ref.rglru_scan_backward(a, ref.rglru_scan(a, b),
                                                   dh), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [None, "partial", "zero", "odd"])
@pytest.mark.parametrize("E,C,D,F,strided", [
    (8, 640, 520, 260, False), (3, 1, 64, 8, False), (6, 37, 1000, 200, True),
    (4, 130, 520, 259, True), (5, 13, 300, 129, False),
    (8, 640, 512, 768, False)])
def test_cuda_moe_gmm_backward_matches_plain(cuda, dtype, rows, E, C, D, F,
                                             strided):
    """K3's backward against autograd of ``ref.moe_gmm`` and against the
    plain backward ``ref.moe_gmm_backward``: C = 1, 13, 37,
    130 and the training capacity of 640, ragged D and F, x read through a
    row stride and w as one layer's view of a stacked leaf, live rows
    None, partial (0, 1, C - 1, C, ...), none and "odd" (no multiple of
    64, empty experts among them); dx must be exact zeros past each
    expert's rows and dw zeros for an expert without one.  The call takes
    the route ``moe_gmm._route`` names: wgmma in bf16 where every row is a
    multiple of 16 bytes (D and F multiples of 8), the mma.sync kernel
    else, CUDA cores in float32.  Each gradient at 2e-3 (float32) or 2e-2
    (bf16) of its largest entry: the same float32 sums in another order,
    rounded once to bf16."""
    from repro_torch.kernels import moe_gmm as k3
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    x0 = torch.randn((E, C, D + 8 if strided else D), generator=g,
                     device=cuda).to(dt)[..., :D]
    w0 = torch.randn((2, E, D, F), generator=g, device=cuda).to(dt)[1]
    dy = torch.randn((E, C, F), generator=g, device=cuda).to(dt)
    n = {None: None, "zero": [0] * E,
         "partial": [(0, 1, C - 1, C, C // 2, 3, C // 3, 2)[e % 8]
                     for e in range(E)],
         "odd": [min(C, (0, 100, C, 1, 63, 65, 0, C - 1)[e % 8])
                 for e in range(E)]}[rows]
    r = None if n is None else torch.tensor(n, dtype=torch.int32,
                                            device=cuda)
    x, w = (t.detach().requires_grad_(True) for t in (x0, w0))
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.moe_gmm(x, w, r), (x, w), dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["moe_gmm"], counts["moe_gmm_bwd"]) == (1, 1)
    route = "f32" if dtype == "float32" else \
        "wgmma" if D % 8 == 0 and F % 8 == 0 else "tc"
    assert k3.bwd_routes == {k: int(k == route) for k in k3.bwd_routes}
    if r is not None:
        live = torch.arange(C, device=cuda)[None, :] < r[:, None]
        assert not got[0].masked_select(~live[..., None]).any()
        assert not got[1][r == 0].any()
    want = torch.autograd.grad(ref.moe_gmm(x, w, r), (x, w), dy)
    _scaled_close(got, want, TOLS[dtype])
    _scaled_close(got, ref.moe_gmm_backward(x.detach(), w.detach(), dy, r),
                  TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,M,with_s0,with_dst", [
    (2, 4, 1024, 64, False, False),     # the training form: no S0, no dS_T
    (3, 2, 130, 64, True, True), (1, 3, 1, 64, True, True),   # decode
    (2, 2, 64, 32, True, False), (1, 2, 65, 16, False, True),
    (2, 5, 1000, 40, True, True)])
def test_cuda_rwkv_scan_backward_matches_plain(cuda, dtype, B, H, T, M,
                                               with_s0, with_dst):
    """K4's backward against autograd of ``ref.rwkv_scan`` and against the
    plain backward ``ref.rwkv_scan_backward``: r, k and v as
    the model's transposed views, ragged T, heads under 64, B = 3, the
    decode step (T = 1), an S0 that requires grad and a non-zero gradient
    of the final state.  Each gradient at 2e-3 (float32) of its largest
    entry, the chunk form's float32 sums against the plain step-by-step
    ones (dlogw from sums that cancel against factors up to e^6.7), or
    2e-2 (bf16): dr, dk and dv are rounded to bf16 on both sides, and a
    rounding that falls the other way is one bf16 step, up to 2^-7 of the
    largest entry."""
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    leaves = [rand(B, T, H, M).to(dt).requires_grad_(True) for _ in range(3)]
    leaves.append((-0.105 * torch.sigmoid(rand(B, T, H, M)))
                  .requires_grad_(True))
    leaves.append((rand(H, M) * 0.1).requires_grad_(True))
    if with_s0:
        leaves.append((rand(B, H, M, M) * 0.5).requires_grad_(True))
    views = [t.transpose(1, 2) for t in leaves[:4]] + leaves[4:]
    if not with_s0:
        views.append(None)
    do = rand(B, T, H, M).transpose(1, 2)
    dS = rand(B, H, M, M) * 0.5 if with_dst else None

    def grads(fn):
        o, S = fn(*views)
        outs, cts = ([o, S], [do, dS]) if with_dst else ([o], [do])
        return torch.autograd.grad(outs, leaves, cts)
    ops.reset_launch_counts()
    got = grads(ops.rwkv_scan)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["rwkv_scan"], counts["rwkv_scan_bwd"]) == (1, 1)
    _scaled_close(got, grads(ref.rwkv_scan), TOLS[dtype])
    with torch.no_grad():
        want = ref.rwkv_scan_backward(*views, do, dS)
    # dr, dk, dv and dlogw of the (B,H,T,M) views are the leaves' transposed
    want = [t.transpose(1, 2) for t in want[:4]] + [
        t for t in want[4:] if t is not None]
    _scaled_close(got, want, TOLS[dtype])


# K2's backward: (B, H, Hkv, T, S, hd, causal, window), the cases
# chip_smoke.py checks: causal T = S, full, T < S, a window of 2048 at
# T = S = 4096 (MQA), ragged T and S, every head dim, G = 1, 2, 8 and 16,
# and Mellum2's heads (GQA 32/4 at hd 128) with its window of 1,024
K2_BWD_CASES = [
    (2, 16, 8, 1024, 1024, 128, True, 0),
    (2, 16, 8, 1024, 1024, 128, False, 0),
    (2, 16, 8, 512, 1024, 128, True, 0),
    (1, 16, 1, 4096, 4096, 256, True, 2048),
    (2, 8, 8, 1000, 1000, 64, True, 0), (2, 8, 4, 77, 300, 160, True, 0),
    (2, 32, 8, 1024, 1024, 160, True, 0), (2, 4, 1, 100, 130, 32, False, 0),
    (2, 16, 2, 130, 130, 128, True, 40), (1, 4, 4, 50, 130, 256, False, 0),
    (8, 16, 1, 1024, 1024, 256, True, 2048),   # recurrentgemma-9b training
    (2, 16, 1, 130, 300, 256, False, 0),       # 16 splits, ragged S
    (2, 32, 8, 1000, 1000, 160, True, 300),    # hd 160 with a window
    (1, 32, 4, 4096, 4096, 128, True, 1024)]   # mellum2-12b-a2.5b windowed


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,S,hd,causal,window", K2_BWD_CASES)
def test_cuda_flash_attention_backward_matches_plain(cuda, dtype, B, H, Hkv,
                                                     T, S, hd, causal,
                                                     window):
    """K2's lse and its backward kernel against ``ref.attention_lse`` and
    ``ref.attention_backward`` on the same inputs, passed as the model's
    transposed (B, T, H, hd) views, each gradient at 2e-3 (float32) or 2e-2
    (bf16) of its largest entry."""
    from repro_torch.kernels import flash_attention as k2
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dt)
    q = rand(B, T, H, hd).transpose(1, 2)
    k, v = (rand(B, S, Hkv, hd).transpose(1, 2) for _ in range(2))
    dout = rand(B, T, H, hd).transpose(1, 2)
    out, lse = ref.attention_lse(q, k, v, causal=causal, window=window)
    _, got_lse = k2.forward(q, k, v, causal, window, with_lse=True)
    got = k2.backward(q, k, v, out, lse, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_lse, lse, rtol=TOLS[dtype],
                               atol=TOLS[dtype])
    want = ref.attention_backward(q, k, v, out, lse, dout, causal=causal,
                                  window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=TOLS[dtype] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,S,hd,causal,window,splits", [
    (2, 16, 1, 130, 300, 256, False, 0, d) for d in (1, 2, 4, 8, 16)] + [
    (2, 16, 1, 200, 200, 128, True, 50, d) for d in (1, 4, 16)] + [
    (1, 16, 2, 100, 100, 160, True, 0, d) for d in (1, 2, 8)])
def test_cuda_flash_attention_backward_any_split_matches_plain(
        cuda, monkeypatch, B, H, Hkv, T, S, hd, causal, window, splits):
    """K2's backward in bf16 with a group's heads split over any divisor
    of G blocks (the rule ``_dkdv_splits`` substituted; the wide kernels
    at hd 160 / 256, the 4-warp ones at 128; G = 16 and 8), each gradient
    at 2e-2 of its largest entry."""
    from repro_torch.kernels import flash_attention as k2
    monkeypatch.setattr(k2, "_dkdv_splits", lambda *_: splits)
    g = torch.Generator(cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    q, dout = rand(B, H, T, hd), rand(B, H, T, hd)
    k, v = rand(B, Hkv, S, hd), rand(B, Hkv, S, hd)
    out, lse = ref.attention_lse(q, k, v, causal=causal, window=window)
    got = k2.backward(q, k, v, out, lse, dout, causal=causal, window=window)
    want = ref.attention_backward(q, k, v, out, lse, dout, causal=causal,
                                  window=window)
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=TOLS["bfloat16"] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("flash_attention_bwd", (8, 16, 1, 1024, 256, 2048)),  # recurrentgemma
    ("flash_attention_bwd", (8, 16, 8, 1024, 128, 0)),     # qwen3-0.6b
    ("flash_attention_bwd", (8, 64, 4, 1024, 128, 0)),     # the MoE
    ("moe_gmm_bwd", (128, 640, 4096, 1536)),               # gate / up
    ("moe_gmm_bwd", (128, 640, 1536, 4096))])              # down
def test_cuda_backward_kernels_are_deterministic_at_training_shapes(
        cuda, kernel, shape):
    """K2's and K3's backwards at the trained families' shapes, bf16: two
    calls give the same bits (no atomics; K2's head splits are summed in a
    fixed order), and K3 takes the wgmma route."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import moe_gmm as k3
    g = torch.Generator(cuda).manual_seed(0)
    bf = torch.bfloat16

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda).to(bf)
    if kernel == "flash_attention_bwd":
        B, H, Hkv, T, hd, window = shape
        q, k, v, dout = (rand(B, n, T, hd) for n in (H, Hkv, Hkv, H))
        out, lse = ref.attention_lse(q, k, v, window=window)

        def call():
            return k2.backward(q, k, v, out, lse, dout, window=window)
    else:
        E, C, D, F = shape
        x, w, dy = rand(E, C, D), rand(E, D, F), rand(E, C, F)
        ops.reset_launch_counts()

        def call():
            return k3.backward(x, w, dy)
    a, b = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    if kernel == "moe_gmm_bwd":
        assert k3.bwd_routes == {"wgmma": 2, "tc": 0, "f32": 0}


def _k2_bwd_case(cuda, B, H, Hkv, T, S, hd, unaligned=False):
    """bf16 q, k, v, dout as the model's transposed (B, T, H, hd) views,
    q 2 bytes off its buffer when ``unaligned``."""
    g = torch.Generator(cuda).manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    q = rand(B, T, H, hd + unaligned)[..., int(unaligned):].transpose(1, 2)
    k, v = (rand(B, S, Hkv, hd).transpose(1, 2) for _ in range(2))
    return q, k, v, rand(B, T, H, hd).transpose(1, 2)


def _k2_bwd_close(got, want):
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=TOLS["bfloat16"] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,S,causal,window,unaligned,route", [
    (2, 16, 8, 1024, 1024, True, 0, False, "wgmma"),
    (2, 64, 4, 1024, 1024, True, 0, False, "wgmma"),   # the MoE's G = 16
    (1, 16, 1, 300, 700, True, 100, False, "wgmma"),   # MQA, window, T < S
    (1, 4, 4, 50, 130, False, 0, False, "wgmma"),
    (2, 16, 8, 1000, 1000, True, 0, True, "tc")])      # q 2 bytes off
def test_cuda_flash_attention_backward_routes_at_hd128(
        cuda, B, H, Hkv, T, S, causal, window, unaligned, route):
    """K2's backward in bf16 at hd 128 on the route ``_bwd_route`` names
    (TMA and wgmma where every base and stride is 16-byte aligned, else the
    mma.sync kernels), counted in ``bwd_routes``, each gradient at 2e-2 of
    its largest entry of ``ref.attention_backward``."""
    from repro_torch.kernels import flash_attention as k2
    q, k, v, dout = _k2_bwd_case(cuda, B, H, Hkv, T, S, 128, unaligned)
    out, lse = ref.attention_lse(q, k, v, causal=causal, window=window)
    ops.reset_launch_counts()
    got = k2.backward(q, k, v, out, lse, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k2.bwd_routes == {r: int(r == route) for r in k2.bwd_routes}
    _k2_bwd_close(got, ref.attention_backward(q, k, v, out, lse, dout,
                                              causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "tc"])
@pytest.mark.parametrize("splits", [1, 2, 4, 16])
def test_cuda_flash_attention_backward_forced_route_and_split(
        cuda, monkeypatch, route, splits):
    """The same aligned hd 128 inputs (G = 16, ragged T, a window) forced
    onto either bf16 kernel pair and any split of the group: every choice
    matches the plain backward."""
    from repro_torch.kernels import flash_attention as k2
    monkeypatch.setattr(k2, "_bwd_route", lambda *_: route)
    monkeypatch.setattr(k2, "_dkdv_splits", lambda *_: splits)
    q, k, v, dout = _k2_bwd_case(cuda, 2, 16, 1, 200, 200, 128)
    out, lse = ref.attention_lse(q, k, v, window=50)
    ops.reset_launch_counts()
    got = k2.backward(q, k, v, out, lse, dout, window=50)
    torch.cuda.synchronize()
    assert k2.bwd_routes[route] == 1
    _k2_bwd_close(got, ref.attention_backward(q, k, v, out, lse, dout,
                                              window=50))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,M", [(2, 4, 1024, 64), (3, 2, 130, 37),
                                     (1, 3, 1, 64)])
def test_cuda_rwkv_scan_backward_bf16_route(cuda, B, H, T, M):
    """K4's backward in bf16 on the tensor-core kernels (the route
    ``_bwd_route`` names, counted in ``bwd_routes``) against
    ``ref.rwkv_scan_backward`` at 2e-2 of each gradient's largest entry,
    from an S0 with a non-zero gradient of the final state, heads of 64
    and 37, the decode step."""
    from repro_torch.kernels import rwkv_scan as k4
    route = "tc"
    g = torch.Generator(cuda).manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    r, k, v = (rand(B, T, H, M).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    logw = (-0.105 * torch.sigmoid(rand(B, T, H, M))).transpose(1, 2)
    u, S0 = rand(H, M) * 0.1, rand(B, H, M, M) * 0.5
    states = k4.forward(r, k, v, logw, u, S0)[2]
    do, dS = rand(B, T, H, M).transpose(1, 2), rand(B, H, M, M) * 0.5
    ops.reset_launch_counts()
    got = k4.backward(r, k, v, logw, u, S0, states, do, dS)
    torch.cuda.synchronize()
    assert k4.bwd_routes == {x: int(x == route) for x in k4.bwd_routes}
    want = ref.rwkv_scan_backward(r, k, v, logw, u, S0, do, dS)
    _scaled_close(got, want, TOLS["bfloat16"])


@pytest.mark.cuda
def test_cuda_rwkv_backward_is_deterministic_at_training_shape(cuda):
    """K4's backward at rwkv6-3b's training shape (B=8, H=40, T=1024,
    M=64), bf16: two calls give the same bits, on the tensor cores."""
    from repro_torch.kernels import rwkv_scan as k4
    g = torch.Generator(cuda).manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    B, H, T, M = 8, 40, 1024, 64
    r, k, v = (rand(B, T, H, M).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    logw = (-0.105 * torch.sigmoid(rand(B, T, H, M))).transpose(1, 2)
    u = rand(H, M) * 0.1
    states = k4.forward(r, k, v, logw, u)[2]
    do = rand(B, T, H, M).transpose(1, 2)
    ops.reset_launch_counts()
    a = k4.backward(r, k, v, logw, u, None, states, do)
    b = k4.backward(r, k, v, logw, u, None, states, do)
    torch.cuda.synchronize()
    assert k4.bwd_routes == {"tc": 2, "cc": 0}
    assert all(torch.equal(x, y) for x, y in zip(a[:5], b[:5]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_autograd(cuda, dtype):
    """Under grad mode ``ops.flash_attention`` goes through
    ``FlashAttention``: one forward launch, and one backward call that
    gives the plain attention's gradients."""
    g = torch.Generator(cuda).manual_seed(1)
    dt = getattr(torch, dtype)
    leaves = [torch.randn(s, generator=g, device=cuda).to(dt)
              .requires_grad_(True)
              for s in ((2, 100, 8, 64), (2, 100, 2, 64), (2, 100, 2, 64))]
    views = [t.transpose(1, 2) for t in leaves]
    dout = torch.randn((2, 8, 100, 64), generator=g, device=cuda).to(dt)
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.flash_attention(*views), leaves, dout)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
    want = torch.autograd.grad(ref.attention(*views), leaves, dout)
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=TOLS[dtype] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "pixtral_12b"])
def test_cuda_dense_gradients_kernel_path_match_plain_path(cuda, arch):
    """Smoke dense / VLM models in float32: ``loss_fn`` gradients through K2
    and its backward kernel (remat: two forward launches and one backward
    call per layer) against the same model with ``attn_impl="plain"`` on
    the card, each leaf by relative L2 at 2e-3."""
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.models import loss_fn
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="plain")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=g, device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.randn(
            (2, cfg.prefix_len, cfg.d_model), generator=g, device=cuda) * 0.1
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ops.reset_launch_counts()
    got = torch.autograd.grad(loss_fn(cfg, params, batch), leaves)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == cfg.n_layers
    want = torch.autograd.grad(loss_fn(plain, params, batch), leaves)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch,optimizer", [
    ("qwen3_0_6b", "adamw"), ("rwkv6_3b", "adamw"),
    ("recurrentgemma_9b", "adafactor"), ("qwen3_moe_235b", "adafactor")])
def test_cuda_training_steps_match_plain_path(cuda, arch, optimizer):
    """Three steps of a smoke model in float32 on one batch through the
    kernels (K2; K4; K5 and K2; K3 and K2, with their backward kernels)
    against the same steps with ``attn_impl="plain"``, with the optimizer
    each family trains with on the card: the losses agree to 1e-4 and the
    loss on the batch falls (over fresh batches, three steps move the loss
    less than the batches differ)."""
    from repro_torch.train import (OptConfig, TrainState, shard_batch,
                                   synthetic_batches)
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    opt = OptConfig(name=optimizer, lr=3e-3, warmup=2, decay_steps=20)
    losses = {}
    for impl in ("xla", "plain"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        ts = TrainState(c, opt, init_params(
            c, torch.Generator(cuda).manual_seed(0), device=cuda))
        batch = shard_batch(None, next(synthetic_batches(c.vocab, 4, 64)),
                            device=cuda)
        losses[impl] = [float(ts.step(batch)["loss"]) for _ in range(3)]
        assert ts.color == 3
    torch.testing.assert_close(losses["xla"], losses["plain"], rtol=1e-4,
                               atol=0)
    assert losses["xla"][-1] < losses["xla"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,M,with_s0", [
    (1, 40, 1024, 64, False), (1, 40, 1000, 64, False),   # ragged T
    (4, 40, 1, 64, True), (2, 3, 130, 32, True),          # decode; small M
    # B * H from 1 to 160, one chunk and its edges, each column tile width
    (1, 1, 1, 64, False), (1, 1, 63, 64, False), (1, 1, 64, 64, True),
    (1, 1, 65, 64, True), (4, 40, 1024, 64, True), (1, 40, 260, 64, True),
    (3, 2, 65, 16, False), (2, 5, 1000, 40, True)])
def test_cuda_rwkv_scan_matches_plain(cuda, dtype, B, H, T, M, with_s0):
    """K4 against ``ref.rwkv_scan``, o and S: the one-pass decode (T = 1)
    and the three-launch chunk-parallel prefill at 64, 32 and 16 value
    columns per block (by B * H * chunks), ragged T and heads under 64."""
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    # the model's layout: (B,T,H,M) projections seen as (B,H,T,M) views
    r, k, v = (rand(B, T, H, M).to(dt).transpose(1, 2) for _ in range(3))
    logw = (-0.105 * torch.sigmoid(rand(B, T, H, M))).transpose(1, 2)
    u = rand(H, M) * 0.1
    S0 = rand(B, H, M, M) * 0.5 if with_s0 else None
    o, S = ops.rwkv_scan(r, k, v, logw, u, S0)
    torch.cuda.synchronize()
    oe, Se = ref.rwkv_scan(r, k, v, logw, u, S0)
    torch.testing.assert_close(o, oe, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(S, Se, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,a_val,strided", [
    (1, 4096, 4096, None, False), (2, 1000, 4100, None, False),
    (4, 1, 4096, None, False), (1, 128, 32, 1e-4, False),  # strong decay
    # the decode kernel's last T and the windowed kernel's first, a window
    # of 256 steps -/+ 1, T = 4095; ragged D, B = 3 and B/T strides
    (1, 16, 4096, None, False), (1, 17, 4096, None, False),
    (1, 255, 4096, None, False), (1, 257, 4096, None, False),
    (1, 4095, 4096, None, False), (3, 600, 4099, None, True),
    (2, 513, 33, None, True), (1, 4096, 4096, 1e-4, False),
    (1, 4096, 4096, 0.999, False)])                       # long memory
def test_cuda_rglru_scan_matches_plain(cuda, B, T, D, a_val, strided):
    """K5 against ``ref.rglru_scan`` at rtol/atol 1e-4.  At a = 0.999 the
    absolute part is 1e-4 of the output's scale instead: both sides round
    in float32 at every step (the plain version multiplies, then adds; the
    kernel fuses), |h| reaches about 80, and the roundings accumulate over
    about 1 / (1 - a) = 1,000 steps, so that even a kernel that steps in
    the plain version's order, one thread per channel, differs from it by
    more than 1e-4 near h = 0."""
    g = torch.Generator(cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    if strided:          # a: a window of a wider buffer; b: (T, B, D) seen
        a = torch.sigmoid(rand(B, T + 3, D + 5))[:, 1:T + 1, 2:D + 2]
        b = rand(T + 2, B, D + 7).transpose(0, 1)[:, :T, 3:D + 3]
        assert not a.is_contiguous() and not b.is_contiguous()
    else:
        a, b = torch.sigmoid(rand(B, T, D)), rand(B, T, D)
    if a_val is not None:
        a = torch.full_like(a, a_val)
    h = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    want = ref.rglru_scan(a, b)
    scale = float(want.abs().max()) if a_val == 0.999 else 1.0
    torch.testing.assert_close(h, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers,kernels", [
    ("rwkv6_3b", 2, {"rwkv_scan": 2}),
    ("recurrentgemma_9b", 5, {"rglru_scan": 4, "flash_attention": 1})])
def test_cuda_recurrent_model_kernel_path_matches_plain_path(
        cuda, arch, n_layers, kernels):
    """Smoke rwkv6 / recurrentgemma (one scanned block and a tail of 2) in
    float32: forward through K4 or K2 + K5 and decode steps through a ring
    wrap (K4, or K1 + K5) against the same model with ``attn_impl="plain"``
    on the card."""
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              n_layers=n_layers)
    plain = dataclasses.replace(cfg, attn_impl="plain")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=g, device=cuda)
    ops.reset_launch_counts()
    got, _ = forward(cfg, params, {"tokens": toks})
    counts = ops.launch_counts()
    assert {k: counts[k] for k in kernels} == kernels
    want, _ = forward(plain, params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=TOLS["float32"],
                               atol=TOLS["float32"])
    c_k = init_cache(cfg, 2, 64, device=cuda)   # the ring wraps at 64
    c_p = clone_cache(c_k)
    for t in range(70):
        lk, c_k = decode_step(cfg, params, c_k, toks[:, t:t + 1])
        lp, c_p = decode_step(plain, params, c_p, toks[:, t:t + 1])
        torch.testing.assert_close(lk, lp, rtol=TOLS["float32"],
                                   atol=TOLS["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,strided", [
    (128, 80, 4096, 1536, False), (128, 4, 1536, 4096, False),  # the path
    (8, 80, 4100, 1540, False), (8, 4, 4100, 1540, True),       # ragged
    (3, 1, 64, 8, False), (5, 13, 300, 129, True), (4, 130, 520, 260, False),
    (6, 37, 1000, 200, False), (8, 16, 520, 260, False),
    (8, 17, 4100, 129, True), (8, 33, 1540, 1540, True)])
def test_cuda_moe_gmm_matches_plain(cuda, dtype, E, C, D, F, strided):
    """K3 against ``ref.moe_gmm``: every tile regime of C (bf16 on the
    tensor cores, in 4-warp blocks for C <= 32 and 8-warp blocks above;
    float32 on CUDA cores), ragged C, D and F, x read through a row stride
    and w as one layer's view of a stacked leaf."""
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn((E, C, D + 8 if strided else D), generator=g,
                    device=cuda).to(dt)[..., :D]
    w = torch.randn((2, E, D, F), generator=g, device=cuda).to(dt)[1]
    ops.reset_launch_counts()
    got = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gmm"] == 1
    torch.testing.assert_close(got.float(), ref.moe_gmm(x, w).float(),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", ["zero", "partial", "full"])
@pytest.mark.parametrize("E,C,D,F", [(8, 4, 4100, 1540), (8, 80, 4100, 1540),
                                     (6, 130, 520, 260), (8, 17, 300, 129)])
def test_cuda_moe_gmm_rows(cuda, dtype, rows, E, C, D, F):
    """K3 with ``rows``: rows c >= rows[e] are exact zeros and the rest the
    plain version's, with no row live, some rows (0, 1, C - 1, C, ... per
    expert) and all."""
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn((E, C, D), generator=g, device=cuda).to(dt)
    w = torch.randn((E, D, F), generator=g, device=cuda).to(dt)
    n = {"zero": [0] * E, "full": [C] * E,
         "partial": [(0, 1, C - 1, C, C // 2, 3, C // 3, 2)[e % 8]
                     for e in range(E)]}[rows]
    r = torch.tensor(n, dtype=torch.int32, device=cuda)
    got = ops.moe_gmm(x, w, r)
    torch.cuda.synchronize()
    live = (torch.arange(C, device=cuda)[None, :] < r[:, None])[..., None]
    assert not got.masked_select(~live).any()
    torch.testing.assert_close(got.float(), ref.moe_gmm(x, w, r).float(),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


def ragged_rows(kind, E, M):
    """(rows, starts) lists of a packed buffer of M rows, each expert's
    segment after the last: "odd" counts (segment ends no multiple of 16,
    empty experts) that leave rows of no expert at the end; "all": one
    expert holds all M rows; "full": seeded counts summing to M.  "gaps":
    the "odd" counts in reverse expert order, each segment after a gap of
    3 to 7 rows of no expert (the last experts' cut at M)."""
    if kind == "gaps":
        rows, starts, at = [0] * E, [0] * E, 0
        for e in reversed(range(E)):
            at = min(at + 3 + e % 5, M)
            rows[e] = min(M - at, (37, 0, 100, 1, 63, 65, 0, 19)[e % 8])
            starts[e] = at
            at += rows[e]
        return rows, starts
    if kind == "all":
        rows = [M if e == E // 2 else 0 for e in range(E)]
    elif kind == "odd":
        rows, left = [], M - 5
        for e in range(E):
            rows.append(min(left, (37, 0, 100, 1, 63, 65, 0, 19)[e % 8]))
            left -= rows[-1]
    else:
        g = torch.Generator().manual_seed(E * M)
        cut = torch.sort(torch.randint(0, M + 1, (E - 1,), generator=g))[0]
        edges = [0] + cut.tolist() + [M]
        rows = [b - a for a, b in zip(edges, edges[1:])]
    starts = [sum(rows[:e]) for e in range(E)]
    return rows, starts


# F = 260 and 129 leave w's rows unaligned for TMA (the mma.sync route in
# bf16); (128, 4000, 256, 192) and (8, 1000, 136, 264) take wgmma, the
# latter with a last D stage of 8 and a second N tile of 8 columns
RAGGED_SHAPES = [(8, 640, 520, 260), (4, 1000, 300, 129),
                 (128, 4000, 256, 192), (8, 1000, 136, 264)]


def _ragged_inputs(cuda, dtype, kind, E, M, D, F):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn((M, D), generator=g, device=cuda).to(dt)
    w = torch.randn((2, E, D, F), generator=g, device=cuda).to(dt)[1]
    rows, starts = (torch.tensor(v, dtype=torch.int32, device=cuda)
                    for v in ragged_rows(kind, E, M))
    owned = ref._segments(rows, starts, M).any(0)   # the rows of some expert
    return x, w, rows, starts, owned


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["odd", "all", "full", "gaps"])
@pytest.mark.parametrize("E,M,D,F", RAGGED_SHAPES)
def test_cuda_moe_gmm_ragged_matches_plain(cuda, dtype, kind, E, M, D, F):
    """Ragged K3 (``starts``, the all-to-all dispatch's packed buffer)
    against the ragged ``ref.moe_gmm``: segment ends no multiple of 16,
    empty experts, one expert holding every row, abutting segments and
    segments in reverse expert order with gaps, and rows of no expert,
    which must stay exact zeros; 128 experts (the tile search over more
    than one warp of counts); an F no 16-byte row divides.  The call takes
    the kernel ``moe_gmm._fwd_route`` names: wgmma in bf16 where TMA can
    read x and w, mma.sync else, CUDA cores in float32."""
    from repro_torch.kernels import moe_gmm as k3
    x, w, rows, starts, owned = _ragged_inputs(cuda, dtype, kind, E, M, D, F)
    ops.reset_launch_counts()
    got = ops.moe_gmm(x, w, rows, starts)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gmm"] == 1 and got.shape == (M, F)
    route = k3._fwd_route(x, w, ragged=True)
    assert route == ("f32" if dtype == "float32" else
                     "wgmma" if F % 8 == 0 else "tc")
    assert k3.routes == {k: int(k == route) for k in k3.routes}
    assert not got[~owned].any()
    torch.testing.assert_close(got.float(),
                               ref.moe_gmm(x, w, rows, starts).float(),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["odd", "all", "full", "gaps"])
@pytest.mark.parametrize("E,M,D,F", RAGGED_SHAPES)
def test_cuda_moe_gmm_ragged_backward_matches_plain(cuda, dtype, kind, E, M,
                                                    D, F):
    """Ragged K3's backward against autograd of the ragged ``ref.moe_gmm``
    and against ``ref.moe_gmm_backward``: dx exact zeros on the rows of no
    expert, dw zeros for an empty expert, on the route ``moe_gmm._route``
    names (``wgmma`` in bf16 where TMA can read x, w and dy, ``tc`` else,
    ``f32`` in float32), the forward on ``_fwd_route``'s; each gradient at
    its tolerance of its largest entry."""
    from repro_torch.kernels import moe_gmm as k3
    x0, w0, rows, starts, owned = _ragged_inputs(cuda, dtype, kind, E, M, D,
                                                 F)
    dy = torch.randn((M, F), generator=torch.Generator(cuda).manual_seed(1),
                     device=cuda).to(x0.dtype)
    x, w = (t.detach().requires_grad_(True) for t in (x0, w0))
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.moe_gmm(x, w, rows, starts), (x, w), dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["moe_gmm"], counts["moe_gmm_bwd"]) == (1, 1)
    route = k3._route(x, w, dy)
    assert route == ("f32" if dtype == "float32" else
                     "wgmma" if F % 8 == 0 else "tc")
    assert k3.bwd_routes == {k: int(k == route) for k in k3.bwd_routes}
    assert k3.routes == {k: int(k == route) for k in k3.routes}
    assert not got[0][~owned].any() and not got[1][rows == 0].any()
    want = torch.autograd.grad(ref.moe_gmm(x, w, rows, starts), (x, w), dy)
    _scaled_close(got, want, TOLS[dtype])
    _scaled_close(got, ref.moe_gmm_backward(x.detach(), w.detach(), dy, rows,
                                            starts), TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("D,F", [(4096, 1536), (1536, 4096)])
def test_cuda_moe_gmm_ragged_at_a_production_rank(cuda, D, F):
    """One rank of qwen3-moe-235b-a22b train_4k on 16 x 16: 8 experts,
    M = 40,960 packed rows of which seeded counts fill 33,059, gate/up and
    down in bf16: forward and backward on wgmma against the plain
    versions, the rows of no expert exact zeros."""
    from repro_torch.kernels import moe_gmm as k3
    E, M = 8, 40960
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((M, D), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((E, D, F), generator=g, device=cuda).to(torch.bfloat16)
    dy = torch.randn((M, F), generator=g, device=cuda).to(torch.bfloat16)
    rows, starts = (torch.tensor(v, dtype=torch.int32, device=cuda)
                    for v in ragged_rows("full", E, 33059))
    owned = ref._segments(rows, starts, M).any(0)
    x.requires_grad_(True)
    w.requires_grad_(True)
    ops.reset_launch_counts()
    y = ops.moe_gmm(x, w, rows, starts)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    torch.cuda.synchronize()
    assert k3.routes == {"wgmma": 1, "tc": 0, "f32": 0}
    assert k3.bwd_routes == {"wgmma": 1, "tc": 0, "f32": 0}
    assert not y[~owned].any() and not dx[~owned].any()
    with torch.no_grad():
        torch.testing.assert_close(y.float(),
                                   ref.moe_gmm(x, w, rows, starts).float(),
                                   rtol=TOLS["bfloat16"],
                                   atol=TOLS["bfloat16"])
        _scaled_close((dx, dw), ref.moe_gmm_backward(x, w, dy, rows, starts),
                      TOLS["bfloat16"])


def _a2a_nodrop_rows(cuda, holes):
    """(rows, starts) of the all-to-all dispatch at one rank with nothing
    dropped: 1,024 seeded tokens to their top 8 of 128 experts, M = 8,192
    packed rows sorted by expert; ``holes``: experts 5 and 77 emptied, so
    that their rows belong to no expert."""
    g = torch.Generator(cuda).manual_seed(4)
    probs = torch.softmax(torch.randn((1024, 128), generator=g,
                                      device=cuda), -1)
    rows = torch.bincount(probs.topk(8).indices.reshape(-1), minlength=128)
    starts = torch.cumsum(rows, 0) - rows
    if holes:
        rows[[5, 77]] = 0
    return rows.to(torch.int32), starts.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True])
def test_cuda_moe_gmm_float32_at_the_a2a_shape(cuda, holes):
    """The float32 route (``f32``, ``csrc/gmm_f32.cuh``) at the all-to-all
    dispatch's shape, E 128, M 8,192, D 4096, F 1536, the seeded no-drop
    routing (with two experts emptied, ``holes``): forward and backward
    against ``ref.moe_gmm`` / ``ref.moe_gmm_backward`` at 2e-3 (the
    gradients of their largest entry), the rows of no expert and an empty
    expert's dw exact zeros, and the backward the same bits twice."""
    from repro_torch.kernels import moe_gmm as k3
    E, M, D, F = 128, 8192, 4096, 1536
    rows, starts = _a2a_nodrop_rows(cuda, holes)
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((M, D), generator=g, device=cuda)
    w = torch.randn((E, D, F), generator=g, device=cuda)
    dy = torch.randn((M, F), generator=g, device=cuda)
    owned = ref._segments(rows, starts, M).any(0)
    ops.reset_launch_counts()
    y = ops.moe_gmm(x, w, rows, starts)
    dx, dw = k3.backward(x, w, dy, rows, starts)
    again = k3.backward(x, w, dy, rows, starts)
    torch.cuda.synchronize()
    assert k3.routes == {"wgmma": 0, "tc": 0, "f32": 1}
    assert k3.bwd_routes == {"wgmma": 0, "tc": 0, "f32": 2}
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    assert bool(owned.all()) != holes
    assert not y[~owned].any() and not dx[~owned].any()
    assert not dw[rows == 0].any()
    torch.testing.assert_close(y, ref.moe_gmm(x, w, rows, starts),
                               rtol=TOLS["float32"], atol=TOLS["float32"])
    _scaled_close((dx, dw), ref.moe_gmm_backward(x, w, dy, rows, starts),
                  TOLS["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, "partial", "zero"])
@pytest.mark.parametrize("C", [1, 4, 33, 80, 130])
@pytest.mark.parametrize("D,F,pad", [(4100, 259, 1), (520, 264, 0)])
def test_cuda_moe_gmm_float32_load_paths(cuda, D, F, pad, C, rows):
    """The float32 route's loads: x read through an odd row stride (D + 1:
    no row 16-byte aligned, four 4-byte copies a chunk) with F = 259 (w's
    and dy's rows unaligned, a ragged last chunk) and D = 4100 (a last
    stage of 4), or aligned rows (16-byte copies, zero filled tails); C
    on the split-D tiles (1, 4), the loop's 64-row tiles (33) and its
    80-row ones (80, 130); rows all, some (0, 1, C - 1, C, ...) or
    none.  Forward and backward against the plain versions at 2e-3, the
    rows past rows[e] and an expert without rows exact zeros, the
    backward the same bits twice."""
    from repro_torch.kernels import moe_gmm as k3
    E = 6
    g = torch.Generator(cuda).manual_seed(C)
    x = torch.randn((E, C, D + pad), generator=g, device=cuda)[..., :D]
    w = torch.randn((E, D, F), generator=g, device=cuda)
    dy = torch.randn((E, C, F), generator=g, device=cuda)
    n = {None: None, "zero": [0] * E,
         "partial": [(0, 1, C - 1, C, C // 2, 3)[e] for e in range(E)]}[rows]
    r = None if n is None else torch.tensor(n, dtype=torch.int32,
                                            device=cuda)
    ops.reset_launch_counts()
    y = ops.moe_gmm(x, w, r)
    dx, dw = k3.backward(x, w, dy, r)
    again = k3.backward(x, w, dy, r)
    torch.cuda.synchronize()
    assert k3.routes == {"wgmma": 0, "tc": 0, "f32": 1}
    assert k3.bwd_routes == {"wgmma": 0, "tc": 0, "f32": 2}
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    if r is not None:
        live = (torch.arange(C, device=cuda)[None, :] < r[:, None])[..., None]
        assert not y.masked_select(~live).any()
        assert not dx.masked_select(~live).any()
        assert not dw[r == 0].any()
    torch.testing.assert_close(y, ref.moe_gmm(x, w, r), rtol=TOLS["float32"],
                               atol=TOLS["float32"])
    _scaled_close((dx, dw), ref.moe_gmm_backward(x, w, dy, r),
                  TOLS["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "arctic_480b"])
def test_cuda_moe_model_kernel_path_matches_plain_path(cuda, arch):
    """Smoke MoE models in float32: forward (T = 100, the capacity drops
    tokens) and decode steps through K2/K1 and three K3 launches per layer
    against the same model with ``attn_impl="plain"`` on the card."""
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="plain")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=g, device=cuda)
    ops.reset_launch_counts()
    got, aux = forward(cfg, params, {"tokens": toks})
    assert ops.launch_counts()["moe_gmm"] == 3 * cfg.n_layers
    want, want_aux = forward(plain, params, {"tokens": toks})
    assert ops.launch_counts()["moe_gmm"] == 3 * cfg.n_layers
    torch.testing.assert_close(got, want, rtol=TOLS["float32"],
                               atol=TOLS["float32"])
    torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=1e-5)
    c_k, c_p = (init_cache(cfg, 2, 64, device=cuda) for _ in range(2))
    for t in range(4):
        lk, c_k = decode_step(cfg, params, c_k, toks[:, t:t + 1])
        lp, c_p = decode_step(plain, params, c_p, toks[:, t:t + 1])
        torch.testing.assert_close(lk, lp, rtol=TOLS["float32"],
                                   atol=TOLS["float32"])
    assert ops.launch_counts()["moe_gmm"] == 3 * cfg.n_layers * 5


# --------------------------------------------------------------------------
#  The DSM applications with their payloads on the card
# --------------------------------------------------------------------------
def _same_run(a, b):
    return (a.ops, a.makespan_us, a.net) == (b.ops, b.makespan_us, b.net)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["drust", "gam", "grappa"])
def test_cuda_gemm_and_dataframe_equal_their_cpu_runs(cuda, backend):
    from repro_torch.apps import run_dataframe, run_gemm
    for kw in (dict(n=256, tile=64), dict(n=256, tile=64, prefetch=True)):
        assert _same_run(run_gemm(4, backend, device="cuda", **kw),
                         run_gemm(4, backend, device="cpu", **kw))
    for kw in ({}, dict(use_tbox=True, use_spawn_to=True),
               dict(ooo=True, qps_per_thread=2)):
        card = run_dataframe(4, backend, device="cuda", **kw)
        host = run_dataframe(4, backend, device="cpu", **kw)
        assert _same_run(card, host)
        assert card.extra["result_digest"] == pytest.approx(
            host.extra["result_digest"], rel=1e-9, abs=0)


@pytest.mark.cuda
def test_cuda_gemm_default_device_puts_its_tiles_on_the_card(cuda,
                                                             monkeypatch):
    import repro_torch.apps.gemm as gemm
    clusters = []
    make = gemm.make_cluster
    monkeypatch.setattr(gemm, "make_cluster",
                        lambda *a, **k: clusters.append(make(*a, **k))
                        or clusters[-1])
    gemm.run_gemm(2, n=256, tile=64)
    tiles = [o.data for p in clusters[0].heap.partitions
             for o in p.objects.values() if isinstance(o.data, torch.Tensor)]
    assert len(tiles) >= 2 * 4 * 4
    assert {t.device.type for t in tiles} == {"cuda"}


@pytest.mark.cuda
def test_cuda_quick_equals_the_committed_bench_file(cuda):
    """``repro_torch.benchmarks.run.quick`` with GEMM's tiles, DataFrame's
    chunks and the serving weights on the card: every field of every
    section of ``BENCH_protocol.json`` but the wall-clock ones, exactly."""
    import json
    import pathlib
    from repro_torch.benchmarks import run
    base = json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "BENCH_protocol.json").read_text())
    diff = run.diff_sections(run.quick(device="cuda"), base)
    assert len(diff) == 11
    assert {s: bad for s, (_, bad) in diff.items() if bad} == {}


# --------------------------------------------------------------------------
#  the cost tooling on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_kernel_bench_rows_match_plain(cuda):
    """``kernel_bench.all_rows()``: each CUDA kernel on the reference's
    seeded float32 inputs, timed, within 2e-3 of its plain version."""
    from repro_torch.benchmarks import kernel_bench

    rows = kernel_bench.all_rows()
    cases = kernel_bench.cases()
    assert [r[0] for r in rows] == [f"kernel_{c[0]}" for c in cases]
    assert len(rows) == 5
    for (name, kernel, plain, args, _), (_, us, derived) in zip(cases, rows):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOLS["float32"],
                                   atol=TOLS["float32"], msg=name)
        assert us > 0
        assert derived <= TOLS["float32"] * (1 + float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_decode_dry_run_launches_equal_a_tick(cuda):
    """qwen3-0.6b's decode step at the serve phase's shape (B=4, a cache of
    2048): the dry-run's kernel launches equal a real step's on the card."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.serve.serve_step import make_serve_step

    cfg = configs.get("qwen3_0_6b")
    rec = trace_step(cfg, "decode", 4, 2048)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    cache = init_cache(cfg, 4, 2048, device=cuda)
    step = make_serve_step(cfg)
    tokens = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    with torch.no_grad():
        tokens, cache = step(params, cache, tokens)   # warm
        ops.reset_launch_counts()
        step(params, cache, tokens)
    torch.cuda.synchronize()
    real = {k: n for k, n in ops.launch_counts().items() if n}
    assert real == {k: v["launches"] for k, v in rec["kernels"].items()}
    assert real == {"decode_attention": 28}


# Adafactor's leaves at the MoE's layouts, cut in size: (shape, parameter
# dtype, gradient dtype); the last two take the one-element-a-thread path
# (C % 8 != 0) and a float32 gradient of a bf16 leaf (microbatches)
ADAFACTOR_LEAVES = {
    "w_gate": ((3, 8, 512, 192), "bfloat16", "bfloat16"),
    "w_down": ((3, 8, 192, 512), "bfloat16", "bfloat16"),
    "wq": ((3, 512, 64, 128), "bfloat16", "bfloat16"),
    "wk": ((3, 512, 4, 128), "bfloat16", "bfloat16"),
    "wo": ((3, 64, 128, 512), "bfloat16", "bfloat16"),
    "router": ((3, 512, 128), "float32", "float32"),
    "norm": ((3, 512), "bfloat16", "bfloat16"),
    "final_norm": ((512,), "bfloat16", "bfloat16"),
    "embed": ((5000, 512), "bfloat16", "bfloat16"),
    "lm_head": ((512, 5000), "bfloat16", "bfloat16"),
    "odd": ((3, 37, 101), "bfloat16", "bfloat16"),
    "f32_grad": ((4, 96, 200), "bfloat16", "float32"),
}


def _within_ulp(got, want):
    """bf16: at most one unit in the last place apart, beside 1e-8 for
    the float32 rounding of an update that all but cancels its parameter
    (where a bf16 ulp is smaller than that rounding); float32: 1e-5."""
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        return
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    over = (got.float() - w).abs() - ulp - 1e-8
    assert not bool((over > 0).any()), float(over.max())


def _adafactor_leaf(cuda, shape, dtype):
    from repro_torch.kernels.adafactor import _state_shapes
    g = torch.Generator(cuda).manual_seed(0)
    p = (torch.randn(shape, generator=g, device=cuda) * 0.05) \
        .to(getattr(torch, dtype))
    vr_shape, vc_shape = _state_shapes(shape)
    return p, torch.zeros(vr_shape, device=cuda), \
        torch.zeros(vc_shape, device=cuda), g


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ADAFACTOR_LEAVES))
def test_cuda_adafactor_matches_plain(cuda, kind):
    """Two steps of one leaf (decay 0, then 0.6) through the three kernel
    passes against ``ref.adafactor_*`` on the same inputs, scale, decay
    and learning rate: the sum of squares, vr and vc at rtol 1e-5, the
    parameters within one bf16 ulp (float32: 1e-5).  Each step starts both
    from the plain side's parameters: two roundings apart may add up to
    two ulps."""
    shape, dtype, gdtype = ADAFACTOR_LEAVES[kind]
    p, vr, vc, gen = _adafactor_leaf(cuda, shape, dtype)
    mine = [p.clone(), vr.clone(), vc.clone()]
    before = p.clone()
    for step, (decay, scale) in enumerate(((0.0, 0.7), (0.6, 1.0))):
        mine[0].copy_(p)
        g = (torch.randn(shape, generator=gen, device=cuda)
             * (1 + 3 * torch.rand(shape[-1:], generator=gen, device=cuda))
             ).to(getattr(torch, gdtype))
        args = [torch.tensor(x, device=cuda) for x in (scale, decay, 1e-3)]
        st = ops.adafactor_stats(g)
        ops.adafactor_update(*mine[:1], g, *mine[1:], st, *args, 1e-8, 0.01)
        want = ref.adafactor_stats(g)
        ref.adafactor_update(p, g, vr, vc, want, *args, 1e-8, 0.01)
        torch.cuda.synchronize()
        torch.testing.assert_close(st[0], want[0], rtol=1e-5, atol=0)
        for got, exp in zip(st[1:], want[1:]):
            if exp is not None:
                torch.testing.assert_close(got, exp, rtol=1e-5, atol=0)
        torch.testing.assert_close(mine[1], vr, rtol=1e-5, atol=1e-30)
        torch.testing.assert_close(mine[2], vc, rtol=1e-5, atol=1e-30)
        _within_ulp(mine[0], p)
        assert not torch.equal(mine[0], before), f"step {step}: p unchanged"
        before = p.clone()


@pytest.mark.cuda
def test_cuda_adafactor_full_size_expert_leaf(cuda):
    """The stacked ``w_gate`` of qwen3-moe-235b-a22b at 3 layers, (3, 128,
    4096, 1536) bf16: 2,415,919,104 elements, above 2^31, so any 32-bit
    offset shows.  One ``apply_updates`` step through the kernels against
    the plain passes on the same leaf: grad norm, vr and vc at 1e-5, the
    parameter within one bf16 ulp; the update allocates under 5% of the
    leaf's float32 size beyond its inputs."""
    from repro_torch.train import OptConfig, apply_updates, init_opt_state
    shape = (3, 128, 4096, 1536)
    cfg = OptConfig(name="adafactor", lr=1e-3, warmup=1)
    gen = torch.Generator(cuda).manual_seed(0)
    p = torch.empty(shape, dtype=torch.bfloat16, device=cuda)
    g = torch.empty_like(p)
    for i in range(shape[0]):                  # no float32 copy of the leaf
        p[i] = torch.randn(shape[1:], generator=gen, device=cuda) * 0.02
        g[i] = torch.randn(shape[1:], generator=gen, device=cuda) * 1e-4
    p0 = p.clone()
    state = init_opt_state(cfg, {"w": p})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    _, _, m = apply_updates(cfg, {"w": p}, {"w": g}, state)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < 0.05 * 4 * p.numel(), extra
    assert ops.launch_counts()["adafactor"] == 1
    # the plain passes on the same inputs, at the step's scale and lr
    want = ref.adafactor_stats(g)
    gnorm = torch.sqrt(want[0])
    torch.testing.assert_close(m["grad_norm"], gnorm, rtol=1e-5, atol=0)
    scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
    vr, vc = torch.zeros_like(state["vr"]["w"]), torch.zeros_like(
        state["vc"]["w"])
    ref.adafactor_update(p0, g, vr, vc, want, scale,
                         torch.zeros((), device=cuda), m["lr"], cfg.eps,
                         cfg.weight_decay)
    torch.cuda.synchronize()
    torch.testing.assert_close(state["vr"]["w"], vr, rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(state["vc"]["w"], vc, rtol=1e-5, atol=1e-30)
    for i in range(shape[0]):
        _within_ulp(p[i], p0[i])


def _adafactor_tree(cuda):
    """A small tree of the MoE's leaf kinds, bf16 but the router."""
    gen = torch.Generator(cuda).manual_seed(1)
    shapes = {"embed": ((600, 64), torch.bfloat16),
              "norm": ((64,), torch.bfloat16),
              "wq": ((2, 64, 4, 32), torch.bfloat16),
              "router": ((2, 64, 8), torch.float32),
              "w_gate": ((2, 8, 64, 48), torch.bfloat16)}
    params = {k: (torch.randn(s, generator=gen, device=cuda) * 0.05).to(d)
              for k, (s, d) in shapes.items()}
    grads = {k: torch.randn(s, generator=gen, device=cuda).to(d)
             for k, (s, d) in shapes.items()}
    return params, grads


@pytest.mark.cuda
def test_cuda_adafactor_step_makes_no_host_sync_and_counts_leaves(cuda):
    """One ``apply_updates`` step of a small tree under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing waits on the
    host; ``launch_counts()["adafactor"]`` is the number of leaves; the
    parameters are the plain passes' on the CPU within one bf16 ulp."""
    from repro_torch.train import OptConfig, apply_updates, init_opt_state
    cfg = OptConfig(name="adafactor", lr=1e-3, warmup=1)
    params, grads = _adafactor_tree(cuda)
    warm = {k: v.clone() for k, v in params.items()}
    apply_updates(cfg, warm, grads, init_opt_state(cfg, warm))  # the build
    plain = {k: v.cpu() for k, v in params.items()}
    state, pstate = init_opt_state(cfg, params), init_opt_state(cfg, plain)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        apply_updates(cfg, params, grads, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.launch_counts()["adafactor"] == len(params)
    apply_updates(cfg, plain, {k: v.cpu() for k, v in grads.items()},
                  pstate)
    torch.cuda.synchronize()
    for k in params:
        _within_ulp(params[k].cpu(), plain[k])
        torch.testing.assert_close(state["vr"][k].cpu(), pstate["vr"][k],
                                   rtol=1e-5, atol=1e-30)


# AdamW's leaf kinds: (shape, leaf dtype, gradient dtype, moment dtype,
# offset): a stacked bf16 matrix, a float32 vector (rwkv6's w0 and u), an
# odd length (n % 8 = 3: the scalar tail), bf16 moments, a float32
# gradient of a bf16 leaf (microbatches accumulate in float32), and a leaf
# that starts 2 bytes past a 16-byte boundary (one element at a time)
ADAMW_LEAVES = {
    "bf16_stacked": ((4, 256, 384), "bfloat16", "bfloat16", "float32", 0),
    "f32_vector": ((8192,), "float32", "float32", "float32", 0),
    "odd": ((3, 37, 101), "bfloat16", "bfloat16", "float32", 0),
    "bf16_moments": ((4, 128, 96), "bfloat16", "bfloat16", "bfloat16", 0),
    "f32_grad": ((4, 96, 200), "bfloat16", "float32", "float32", 0),
    "unaligned": ((5, 1000), "bfloat16", "bfloat16", "float32", 1),
}


def _adamw_plain_step(cfg, params, grads, state, gnorm):
    """``apply_updates``' AdamW branch through ``ref``'s passes on the card,
    at the global norm ``gnorm``: the kernel side's, so that both sides
    clip by the same scale and the update is compared alone."""
    from repro_torch.train.optimizer import _zip, schedule
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    state["count"] += 1
    count = state["count"].to(torch.float32)
    lr = schedule(cfg, count)
    bc1, bc2 = 1 - cfg.b1 ** count, 1 - cfg.b2 ** count
    for p, g, m, v in _zip(params, grads, state["mu"], state["nu"]):
        ref.adamw_update(p, g, m, v, scale, lr, bc1, bc2, b1=cfg.b1,
                         b2=cfg.b2, eps=cfg.eps, wd=cfg.weight_decay)


def _offset_leaf(shape, dtype, offset, cuda, gen, std):
    """A contiguous leaf of ``shape`` whose storage starts ``offset``
    elements into a buffer."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.randn(n + offset, generator=gen, device=cuda) * std
    return buf.to(dtype)[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ADAMW_LEAVES))
def test_cuda_adamw_matches_plain(cuda, kind):
    """Three ``apply_updates`` steps of one leaf through the kernels (the
    second above the clipping norm) against ``ref``'s passes on the card at
    the same scale: the gradient norm within 4e-6 of ``ref.adamw_sumsq``'s,
    the parameter within one ulp of its dtype, mu and nu within 1e-6."""
    from repro_torch.train import OptConfig, apply_updates, init_opt_state
    from repro_torch.train.optimizer import _zip
    shape, dtype, gdtype, mdt, offset = ADAMW_LEAVES[kind]
    dt, gdt = getattr(torch, dtype), getattr(torch, gdtype)
    cfg = OptConfig(lr=1e-2, warmup=2, decay_steps=5, moment_dtype=mdt)
    gen = torch.Generator(cuda).manual_seed(0)
    params = {"w": _offset_leaf(shape, dt, offset, cuda, gen, 0.05)}
    plain = {"w": params["w"].clone()}
    state, pstate = init_opt_state(cfg, params), init_opt_state(cfg, plain)
    if offset:
        for key in ("mu", "nu"):
            state[key]["w"] = _offset_leaf(shape, getattr(torch, mdt), offset,
                                           cuda, gen, 0.0)
    before = params["w"].clone()
    for step, norm in enumerate((0.1, 30.0, 0.5)):   # about the norms
        grads = {"w": _offset_leaf(shape, gdt, offset, cuda, gen,
                                   norm / before.numel() ** 0.5)}
        ops.reset_launch_counts()
        _, _, m = apply_updates(cfg, params, grads, state)
        assert ops.launch_counts()["adamw"] == 1
        want = torch.sqrt(ref.adamw_sumsq(grads["w"]))
        torch.testing.assert_close(m["grad_norm"], want, rtol=4e-6, atol=0)
        assert (float(m["grad_norm"]) > cfg.clip_norm) == (step == 1)
        _adamw_plain_step(cfg, plain, grads, pstate, m["grad_norm"])
        torch.cuda.synchronize()
        _within_ulp(params["w"], plain["w"])
        for (a, b) in _zip(state["mu"], pstate["mu"]) + _zip(
                state["nu"], pstate["nu"]):
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-6,
                                       atol=0)
        assert not torch.equal(params["w"], before), f"step {step}"
        before = params["w"].clone()


@pytest.mark.cuda
def test_cuda_adamw_full_size_channel_mix_leaf(cuda):
    """rwkv6-3b's stacked ``ck`` (32, 2560, 8960) bf16 with float32
    moments: 734 M elements, 2.9 GB a moment, so any 32-bit byte offset
    shows.  One ``apply_updates`` step through the kernels against ``ref``'s
    passes at the same scale: the norm within 4e-6, the parameter within
    one bf16 ulp, the moments within 1e-6; the step allocates under 1% of
    the leaf's float32 size beyond its inputs."""
    from repro_torch.train import OptConfig, apply_updates, init_opt_state
    shape = (32, 2560, 8960)
    cfg = OptConfig(lr=1e-3, warmup=1)
    gen = torch.Generator(cuda).manual_seed(0)
    p = torch.empty(shape, dtype=torch.bfloat16, device=cuda)
    g = torch.empty_like(p)
    for i in range(shape[0]):                  # no float32 copy of the leaf
        p[i] = torch.randn(shape[1:], generator=gen, device=cuda) * 0.02
        g[i] = torch.randn(shape[1:], generator=gen, device=cuda) * 1e-4
    p0 = p.clone()
    state = init_opt_state(cfg, {"w": p})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    _, _, m = apply_updates(cfg, {"w": p}, {"w": g}, state)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < 0.01 * 4 * p.numel(), extra
    assert ops.launch_counts()["adamw"] == 1
    torch.testing.assert_close(m["grad_norm"],
                               torch.sqrt(ref.adamw_sumsq(g)), rtol=4e-6,
                               atol=0)
    pstate = init_opt_state(cfg, {"w": p0})
    _adamw_plain_step(cfg, {"w": p0}, {"w": g}, pstate, m["grad_norm"])
    torch.cuda.synchronize()
    for i in range(shape[0]):
        _within_ulp(p[i], p0[i])
        for key in ("mu", "nu"):
            torch.testing.assert_close(state[key]["w"][i],
                                       pstate[key]["w"][i], rtol=1e-6,
                                       atol=0)


@pytest.mark.cuda
def test_cuda_adamw_step_makes_no_host_sync_and_counts_leaves(cuda):
    """One ``apply_updates`` step of a small tree (bf16 leaves, a float32
    one, a gradient laid out as a transpose, as a tied embedding's is)
    under ``torch.cuda.set_sync_debug_mode("error")``: nothing waits on the
    host; ``launch_counts()["adamw"]`` is the number of leaves; the
    parameters are the CPU path's within one ulp, the norm within 4e-6."""
    from repro_torch.train import OptConfig, apply_updates, init_opt_state
    cfg = OptConfig(lr=1e-3, warmup=1)
    gen = torch.Generator(cuda).manual_seed(1)
    shapes = {"embed": ((600, 64), torch.bfloat16),
              "norm": ((3, 64), torch.bfloat16),
              "u": ((3, 4, 16), torch.float32),
              "w": ((3, 64, 96), torch.bfloat16)}
    params = {k: (torch.randn(s, generator=gen, device=cuda) * 0.05).to(d)
              for k, (s, d) in shapes.items()}
    grads = {k: torch.randn(s, generator=gen, device=cuda).to(d)
             for k, (s, d) in shapes.items()}
    grads["embed"] = grads["embed"].t().contiguous().t()
    assert not grads["embed"].is_contiguous()
    warm = {k: v.clone() for k, v in params.items()}
    apply_updates(cfg, warm, grads, init_opt_state(cfg, warm))  # the build
    plain = {k: v.cpu() for k, v in params.items()}
    state, pstate = init_opt_state(cfg, params), init_opt_state(cfg, plain)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, m = apply_updates(cfg, params, grads, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.launch_counts()["adamw"] == len(params)
    _, _, pm = apply_updates(cfg, plain, {k: v.cpu() for k, v in
                                          grads.items()}, pstate)
    torch.cuda.synchronize()
    torch.testing.assert_close(m["grad_norm"].cpu(), pm["grad_norm"],
                               rtol=4e-6, atol=0)
    for k in params:
        _within_ulp(params[k].cpu(), plain[k])
