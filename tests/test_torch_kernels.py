"""Kernel parity.  On the CPU the port's ``ops`` take the plain versions in
``repro_torch.kernels.ref``; they are held against the JAX package's
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and
its ``ref`` oracles, at the shapes of ``tests/test_kernels.py``.  Tolerance
2e-3 in float32 and 2e-2 in bf16, as those tests use (the same math summed
in another order; bf16 rounds the output).

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops                      # noqa: E402
from repro.kernels import ref as jref                      # noqa: E402

from repro_torch.kernels import ops                        # noqa: E402

TOLS = {"float32": 2e-3, "bfloat16": 2e-2}


def arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def both(x, dtype):
    """The same numpy input for each package, in ``dtype``."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("B,H,Hkv,T,hd,bq,bk", [
    (1, 2, 2, 128, 64, 64, 64),       # MHA
    (2, 4, 2, 256, 64, 128, 128),     # GQA
    (1, 4, 1, 128, 128, 64, 64),      # MQA
    (1, 2, 2, 192, 64, 64, 64),       # non-power-of-two T
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, H, Hkv, T, hd, bq, bk, dtype):
    rng = np.random.default_rng(0)
    jq, q = both(arr(rng, B, H, T, hd), dtype)
    jk, k = both(arr(rng, B, Hkv, T, hd), dtype)
    jv, v = both(arr(rng, B, Hkv, T, hd), dtype)
    got = ops.flash_attention(q, k, v)
    close(got, jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk),
          dtype)
    close(got, jref.attention(jq, jk, jv), dtype)


def test_flash_attention_noncausal():
    rng = np.random.default_rng(1)
    jq, q = both(arr(rng, 1, 2, 64, 64), "float32")
    jk, k = both(arr(rng, 1, 2, 64, 64), "float32")
    jv, v = both(arr(rng, 1, 2, 64, 64), "float32")
    got = ops.flash_attention(q, k, v, causal=False)
    close(got, jops.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                    block_k=32), "float32")
    close(got, jref.attention(jq, jk, jv, causal=False), "float32")


@pytest.mark.parametrize("T,S,causal", [
    (64, 192, True),      # T < S: bottom-right aligned causal mask
    (50, 50, True),       # ragged T (no block size divides it)
    (37, 101, True),      # ragged T < ragged S
    (40, 96, False),      # non-causal, T != S
])
def test_flash_attention_shapes_beyond_pallas(T, S, causal):
    """Cases the Pallas grid cannot take (its causal mask is top-left
    aligned and it floor-divides ragged tails): the oracle decides."""
    rng = np.random.default_rng(2)
    jq, q = both(arr(rng, 2, 4, T, 32), "float32")
    jk, k = both(arr(rng, 2, 2, S, 32), "float32")
    jv, v = both(arr(rng, 2, 2, S, 32), "float32")
    close(ops.flash_attention(q, k, v, causal=causal),
          jref.attention(jq, jk, jv, causal=causal), "float32")


@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (2, 4, 2, 256, 64),
    (1, 8, 1, 512, 128),              # MQA long cache
    (3, 6, 6, 128, 64),
    (2, 16, 1, 256, 256),             # recurrentgemma's MQA: G*hd = 4096
])
def test_decode_attention_matches_pallas(B, H, Hkv, S, hd):
    rng = np.random.default_rng(3)
    jq, q = both(arr(rng, B, H, hd), "float32")
    jk, k = both(arr(rng, B, Hkv, S, hd), "float32")
    jv, v = both(arr(rng, B, Hkv, S, hd), "float32")
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens))
    close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                     block_k=128), "float32")
    close(got, jref.decode_attention(jq, jk, jv, jnp.asarray(lens)),
          "float32")


def test_decode_attention_strided_cache_views():
    """The model hands K1 permuted views of its (B,S,Hkv,hd) cache."""
    rng = np.random.default_rng(4)
    B, S, Hkv, H, hd = 2, 96, 2, 4, 32
    cache_k = arr(rng, B, S, Hkv, hd)
    cache_v = arr(rng, B, S, Hkv, hd)
    _, q = both(arr(rng, B, H, hd), "bfloat16")
    k = torch.from_numpy(cache_k).bfloat16().permute(0, 2, 1, 3)
    v = torch.from_numpy(cache_v).bfloat16().permute(0, 2, 1, 3)
    assert not k.is_contiguous() and k.stride(-1) == 1
    lens = torch.tensor([1, S], dtype=torch.int32)
    close(ops.decode_attention(q, k, v, lens),
          jref.decode_attention(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                                jnp.asarray(cache_k, jnp.bfloat16)
                                .transpose(0, 2, 1, 3),
                                jnp.asarray(cache_v, jnp.bfloat16)
                                .transpose(0, 2, 1, 3),
                                jnp.asarray(lens.numpy())), "bfloat16")


@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (4, 16, 8, 2048, 128),            # qwen3-0.6b serve
    (4, 16, 1, 2048, 256),            # recurrentgemma-9b serve (MQA)
    (4, 64, 4, 2048, 128),            # qwen3-moe-235b-a22b serve (G = 16)
])
def test_decode_plan_fills_the_card(B, H, Hkv, S, hd):
    """K1's split over the cache gives at least 128 blocks at every serve
    shape, keys per split a multiple of the tile, and one block per kv
    head's whole group (the cache is read once per group)."""
    from repro_torch.kernels import decode_attention as k1
    pl = k1.plan(B, H, Hkv, S, hd)
    assert pl.blocks >= 128
    assert pl.keys_per_split % k1.TILE == 0 and pl.keys_per_split >= 64
    assert pl.splits * pl.keys_per_split >= S > (pl.splits - 1) * \
        pl.keys_per_split
    assert pl.heads_per_block == H // Hkv and pl.head_groups == 1
    assert pl.blocks == B * Hkv * pl.splits
    assert pl.splits <= k1.MAX_SPLITS


def _split_combine(q, k, v, lens, kps, strides=4, tile=32, batch=4):
    """A float32 model of K1's algebra: splits of ``kps`` keys (splits at or
    past the length skipped), each walked in tiles by ``strides`` lane
    groups with an online softmax over batches of ``batch`` keys, the
    groups merged by exp(m_r - max m), then the splits combined the same
    way."""
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    out = np.zeros((B, H, hd), np.float32)
    for b in range(B):
        n = min(int(lens[b]), S)
        for h in range(Hkv):
            qs = q[b, h * G:(h + 1) * G] * np.float32(hd ** -0.5)
            parts = []
            for start in range(0, S, kps):
                if start >= n:
                    continue                          # an empty split
                end = min(start + kps, n)
                slots = []
                for r in range(strides):
                    m = np.full(G, -1e30, np.float32)
                    l = np.zeros(G, np.float32)
                    acc = np.zeros((G, hd), np.float32)
                    for t0 in range(start, end, tile):
                        keys = np.arange(t0 + r, min(t0 + tile, end),
                                         strides)
                        for j0 in range(0, len(keys), batch):
                            kj = keys[j0:j0 + batch]
                            s = qs @ k[b, h, kj].T
                            m_new = np.maximum(m, s.max(1))
                            corr = np.exp(m - m_new)
                            p = np.exp(s - m_new[:, None])
                            l = l * corr + p.sum(1)
                            acc = acc * corr[:, None] + p @ v[b, h, kj]
                            m = m_new
                    slots.append((m, l, acc))
                M = np.max([sl[0] for sl in slots], axis=0)
                w = [np.exp(sl[0] - M) for sl in slots]
                parts.append((M, sum(wi * sl[1] for wi, sl in zip(w, slots)),
                              sum(wi[:, None] * sl[2]
                                  for wi, sl in zip(w, slots))))
            if not parts:
                continue
            M = np.max([pt[0] for pt in parts], axis=0)
            w = [np.exp(pt[0] - M) for pt in parts]
            den = sum(wi * pt[1] for wi, pt in zip(w, parts))
            num = sum(wi[:, None] * pt[2] for wi, pt in zip(w, parts))
            out[b, h * G:(h + 1) * G] = num / np.maximum(den, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("kps", [64, 128, 256, 512])
@pytest.mark.parametrize("B,H,Hkv,hd", [(2, 4, 2, 32), (1, 16, 1, 64)])
def test_decode_split_combine_algebra(kps, B, H, Hkv, hd):
    """K1's split-and-combine algebra, in float32, against the reference
    oracle and the Pallas kernel (interpret mode) at 1e-5, for several
    split counts and with splits wholly past the length (lengths 1, 63,
    65, 200, 511)."""
    rng = np.random.default_rng(10)
    S = 512
    q = arr(rng, B, H, hd)
    k = arr(rng, B, Hkv, S, hd)
    v = arr(rng, B, Hkv, S, hd)
    for lens in ([1, 200][:B], [63, 511][:B], [65, S][:B]):
        lens = np.array(lens, np.int32)
        got = _split_combine(q, k, v, lens, kps)
        args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(lens))
        for want in (jref.decode_attention(*args),
                     jops.decode_attention(*args, block_k=128)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("T,S,window", [(96, 96, 32), (50, 50, 64),
                                          (40, 100, 17), (130, 130, 64)])
def test_flash_attention_window_matches_model_attention(T, S, window):
    """K2's sliding window is the reference model's ``_mask_bias`` (a query
    at position p sees keys in (p - window, p]), positions bottom-right
    aligned as in the oracle."""
    from repro.models.layers import attention as j_attention
    rng = np.random.default_rng(5)
    B, H, Hkv, hd = 2, 4, 1, 32
    q = arr(rng, B, T, H, hd)
    k = arr(rng, B, S, Hkv, hd)
    v = arr(rng, B, S, Hkv, hd)
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.arange(S - T, S), jnp.arange(S), window=window)
    got = ops.flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                                for a in (q, k, v)), window=window)
    close(got.transpose(1, 2), want, "float32")


def _rwkv_inputs(rng, B, H, T, M):
    r, k, v = (arr(rng, B, H, T, M) for _ in range(3))
    logw = (-0.105 / (1 + np.exp(-arr(rng, B, H, T, M)))).astype(np.float32)
    u = arr(rng, H, M) * 0.1
    return r, k, v, logw, u


@pytest.mark.parametrize("B,H,T,M,chunk", [
    (1, 1, 64, 16, 16),
    (2, 2, 128, 32, 32),
    (1, 2, 96, 16, 32),               # ragged chunk count
])
def test_rwkv_scan_matches_pallas(B, H, T, M, chunk):
    rng = np.random.default_rng(6)
    ins = _rwkv_inputs(rng, B, H, T, M)
    o, S = ops.rwkv_scan(*(torch.from_numpy(a) for a in ins))
    jins = [jnp.asarray(a) for a in ins]
    for oe, Se in (jops.rwkv_scan(*jins, chunk=chunk), jref.rwkv_scan(*jins)):
        close(o, oe, "float32")
        close(S, Se, "float32")


@pytest.mark.parametrize("T", [64, 1])
def test_rwkv_scan_continues_from_a_state(T):
    """``S0``: the port's scan from a nonzero state is the reference
    model's ``_wkv_chunk`` from that state (one chunk of T steps; T == 1
    is the decode step)."""
    from repro.models.rwkv import _wkv_chunk
    rng = np.random.default_rng(7)
    B, H, M = 2, 3, 16
    ins = _rwkv_inputs(rng, B, H, T, M)
    S0 = arr(rng, B, H, M, M)
    o, S = ops.rwkv_scan(*(torch.from_numpy(a) for a in ins),
                         torch.from_numpy(S0))
    oe, Se = _wkv_chunk(*(jnp.asarray(a) for a in ins), jnp.asarray(S0))
    np.testing.assert_allclose(o.numpy(), np.asarray(oe), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(Se), rtol=1e-4,
                               atol=1e-4)


def _chunk_parallel(r, k, v, logw, u, S0=None, jt=16, chunk=64, seg=4):
    """A float32 model of K4's algebra.  T == 1: the one-pass decode.
    T > 1, the chunk-parallel prefill: (1) per chunk and tile of ``jt``
    value columns, in any order, the cumsum of logw in ``seg`` segments per
    column, the chunk's state delta k_tail^T v and decay exp(cs_last); (2)
    the scan over the chunk states from S0, keeping each chunk's start;
    (3) per chunk and column tile, the chunk-local output
    tril(q_in k_in^T, -1) v + (r . u . k) v plus the cross term q_in S_c.
    Rows past a ragged T are zeros (logw 0)."""
    r, k, v, logw = (torch.as_tensor(a, dtype=torch.float32)
                     for a in (r, k, v, logw))
    u = torch.as_tensor(u, dtype=torch.float32)
    B, H, T, M = r.shape
    S = (torch.zeros((B, H, M, M)) if S0 is None
         else torch.as_tensor(S0, dtype=torch.float32).clone())
    uk = u[None, :, :, None]
    if T == 1:
        kv = k[:, :, 0, :, None] * v[:, :, 0, None, :]
        o = torch.einsum("bhm,bhmj->bhj", r[:, :, 0], S + uk * kv)
        return o[:, :, None], torch.exp(logw[:, :, 0])[..., None] * S + kv
    nc = -(-T // chunk)
    pad = (0, 0, 0, nc * chunk - T)
    r, k, v, logw = (torch.nn.functional.pad(a, pad).reshape(
        B, H, nc, chunk, M) for a in (r, k, v, logw))
    # the cumsum: each column in seg segments, totals passed on
    parts = logw.reshape(B, H, nc, seg, chunk // seg, M)
    before = torch.cumsum(parts.sum(4), dim=3) - parts.sum(4)
    cs = (before[:, :, :, :, None] + torch.cumsum(parts, dim=4)).reshape(
        B, H, nc, chunk, M)
    last = cs[:, :, :, -1]                                  # (B,H,nc,M)
    tiles = [slice(j0, min(j0 + jt, M)) for j0 in range(0, M, jt)]
    delta = torch.zeros((B, H, nc, M, M))
    for c in reversed(range(nc)):                           # (1) any order
        k_tail = k[:, :, c] * torch.exp(last[:, :, c, None] - cs[:, :, c])
        for j in tiles:
            delta[:, :, c, :, j] = torch.einsum(
                "bhtm,bhtj->bhmj", k_tail, v[:, :, c, :, j])
    starts = []
    for c in range(nc):                                     # (2) in order
        starts.append(S)
        S = torch.exp(last[:, :, c])[..., None] * S + delta[:, :, c]
    o = torch.zeros((B, H, nc, chunk, M))
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril(-1)
    for c in reversed(range(nc)):                           # (3) any order
        q_in = r[:, :, c] * torch.exp(cs[:, :, c] - logw[:, :, c])
        k_in = k[:, :, c] * torch.exp(-cs[:, :, c])
        sc = torch.einsum("bhtm,bhsm->bhts", q_in, k_in).masked_fill(~mask, 0)
        diag = torch.einsum("bhtm,hm,bhtm->bht", r[:, :, c], u, k[:, :, c])
        for j in tiles:
            vj = v[:, :, c, :, j]
            o[:, :, c, :, j] = (sc @ vj + diag[..., None] * vj
                                + q_in @ starts[c][..., j])
    return o.reshape(B, H, nc * chunk, M)[:, :, :T], S


@pytest.mark.parametrize("T", [1, 63, 64, 65, 1000, 1024])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv_chunk_parallel_algebra(T, with_s0):
    """K4's three phases (and its T == 1 pass), in float32, against the
    reference oracle at 1e-5 of the output's scale and, where T is a whole number of its chunks
    and there is no S0, the Pallas kernel (interpret mode) at 2e-3.  S0 is
    the oracle's state after a 16-step prefix, and the oracle runs prefix
    and sequence in one scan."""
    rng = np.random.default_rng(11)
    B, H, M, P = 1, 2, 32, 16 if with_s0 else 0
    ins = _rwkv_inputs(rng, B, H, P + T, M)
    o_all, S_want = jref.rwkv_scan(*(jnp.asarray(a) for a in ins))
    S0 = None
    if with_s0:
        S0 = np.array(jref.rwkv_scan(*(jnp.asarray(a[:, :, :P])
                                         for a in ins[:4]),
                                       jnp.asarray(ins[4]))[1])
    cur = [a[:, :, P:] for a in ins[:4]] + [ins[4]]
    o, S = _chunk_parallel(*cur, S0=S0)
    for got, want in ((o, np.asarray(o_all)[:, :, P:]),
                      (S, np.asarray(S_want))):
        # 1e-5 of the output's scale: at T = 1024 |o| reaches ~100 and the
        # JAX oracle and the port's step-by-step one (both float32) already
        # differ by 2.3e-5 there
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    if not with_s0 and T % 64 == 0:
        oe, Se = jops.rwkv_scan(*(jnp.asarray(a) for a in cur), chunk=64)
        close(o, oe, "float32")
        close(S, Se, "float32")


@pytest.mark.parametrize("B,T,D,chunk,bd", [
    (1, 64, 64, 32, 64),
    (2, 128, 128, 32, 64),
    (2, 256, 64, 64, 32),
])
def test_rglru_scan_matches_pallas(B, T, D, chunk, bd):
    rng = np.random.default_rng(8)
    a = (1 / (1 + np.exp(-arr(rng, B, T, D)))).astype(np.float32)
    b = arr(rng, B, T, D)
    h = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    close(h, jops.rglru_scan(ja, jb, chunk=chunk, block_d=bd), "float32")
    close(h, jref.rglru_scan(ja, jb), "float32")


def test_rglru_scan_strong_decay():
    """Near-zero a: finite, and the reference's 1e-4."""
    rng = np.random.default_rng(9)
    a = np.full((1, 128, 32), 1e-4, np.float32)
    b = arr(rng, 1, 128, 32)
    h = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.isfinite(h).all()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for want in (jops.rglru_scan(ja, jb, chunk=32, block_d=32),
                 jref.rglru_scan(ja, jb)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def _swz(cpr, r, c):
    """``swz<CPR>`` of ``csrc/mma_sync.cuh``: the 16-byte chunk slot (in
    the tile, row-major) of chunk c of row r."""
    main = cpr & ~7
    if main == cpr:
        return r * cpr + (c ^ (r & 7))
    return r * cpr + (c ^ (r & 7) if c < main
                      else main + ((c - main) ^ ((r >> 1) & 3)))


@pytest.mark.parametrize("cpr", [4, 8, 12, 16, 20, 24, 32])
def test_swizzle_keeps_rows_whole_and_banks_apart(cpr):
    """The shared tiles' XOR swizzle, for rows of 4 to 32 chunks (hd 32 to
    256; 20 is hd 160): every row's chunks stay in the row, and the 8 rows
    that one ldmatrix phase reads (r0 .. r0 + 7, r0 a multiple of 8) hit 8
    different groups of 4 banks for every chunk.  Rows of 4, 8, 16 and 32
    chunks, the only ones K1, K2 and K3 used before hd 160, keep their
    earlier layout."""
    for r in range(64):
        assert sorted(_swz(cpr, r, c) - r * cpr for c in range(cpr)) == \
            list(range(cpr))
        if cpr in (4, 8, 16, 32):
            old = [r * cpr + (c ^ ((r >> 1) & 3) if cpr == 4 else c ^ (r & 7))
                   for c in range(cpr)]
            assert [_swz(cpr, r, c) for c in range(cpr)] == old
    for r0 in range(0, 64, 8):
        for c in range(cpr):
            assert len({_swz(cpr, r0 + j, c) % 8 for j in range(8)}) == 8


def _window_schedule(a, b, steps=16, warps=16, lanes=32):
    """A float32 model of K5's schedule.  Channels in tiles of ``lanes`` (a
    block each, a ragged D padded and dropped); T in windows of ``warps *
    steps`` steps.  In each window warp w folds its ``steps`` steps from the
    identity into (A_w, B_w) (the reference's ``combine``); its carry-in is
    the block's carry run through the pairs before w, and the next window's
    carry is run through all of them; then warp w replays its steps from its
    carry-in.  Steps past T are the identity (a = 1, b = 0)."""
    a, b = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b))
    B, T, D = a.shape
    L = steps * warps
    nwin = -(-T // L)
    pad = (0, -D % lanes, 0, nwin * L - T)
    a = torch.nn.functional.pad(a, pad, value=1.0)
    b = torch.nn.functional.pad(b, pad, value=0.0)
    Dp = a.shape[2]
    a, b = (x.reshape(B, nwin, warps, steps, Dp) for x in (a, b))
    h = torch.empty_like(a)
    carry = torch.zeros((B, Dp))
    for wi in range(nwin):
        A, Bw = torch.ones((B, warps, Dp)), torch.zeros((B, warps, Dp))
        for i in range(steps):                   # 1. fold, every warp
            A = A * a[:, wi, :, i]
            Bw = a[:, wi, :, i] * Bw + b[:, wi, :, i]
        cin = []
        for w in range(warps):                   # 2. carry in and out
            cin.append(carry)
            carry = A[:, w] * carry + Bw[:, w]
        hw = torch.stack(cin, dim=1)
        for i in range(steps):                   # 3. replay, every warp
            hw = a[:, wi, :, i] * hw + b[:, wi, :, i]
            h[:, wi, :, i] = hw
    return h.reshape(B, nwin * L, Dp)[:, :T, :D]


@pytest.mark.parametrize("T,D", [(17, 40), (255, 33), (256, 64), (257, 40),
                                 (1000, 36), (4095, 32)])
@pytest.mark.parametrize("a_kind", ["sigmoid", "1e-4", "0.999"])
def test_rglru_window_schedule_algebra(T, D, a_kind):
    """K5's windowed schedule, in float32, against the reference oracle at
    1e-5 of the output's scale and, where the Pallas grid covers T and D
    (it floor-divides ragged tails), the Pallas kernel in interpret mode:
    ragged T and D, strong decay (a = 1e-4) and long memory (a = 0.999),
    B = 2.  (T <= 16 runs the decode kernel, one thread per channel, which
    steps as the oracle does.)"""
    rng = np.random.default_rng(12)
    B = 2
    a = {"sigmoid": (1 / (1 + np.exp(-arr(rng, B, T, D)))),
         "1e-4": np.full((B, T, D), 1e-4),
         "0.999": np.full((B, T, D), 0.999)}[a_kind].astype(np.float32)
    b = arr(rng, B, T, D)
    got = _window_schedule(a, b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    wants = [jref.rglru_scan(ja, jb)]
    if T % 256 == 0 and D % 32 == 0:
        wants.append(jops.rglru_scan(ja, jb, chunk=256, block_d=32))
    for want in wants:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def _wrapper_inputs(kernel):
    """Inputs each wrapper's ``check`` takes, on the CPU (so it would
    fail on the device only), float leaves as fresh leaf tensors."""
    x = torch.zeros
    return {"decode_attention": (x((1, 4, 32)), x((1, 2, 8, 32)),
                                 x((1, 2, 8, 32)),
                                 torch.ones((1,), dtype=torch.int32)),
            "flash_attention": (x((1, 4, 8, 32)), x((1, 2, 8, 32)),
                                x((1, 2, 8, 32))),
            "moe_gmm": (x((2, 3, 16)), x((2, 16, 8))),
            "rwkv_scan": (x((1, 2, 8, 16)), x((1, 2, 8, 16)),
                          x((1, 2, 8, 16)), x((1, 2, 8, 16)), x((2, 16))),
            "rglru_scan": (torch.full((2, 8, 16), 0.5), x((2, 8, 16)))}[
                kernel]


@pytest.mark.parametrize("kernel", ["decode_attention"])
def test_kernel_wrappers_refuse_inputs_that_need_grad(kernel):
    """The kernel without a backward (K1, decode only): its wrapper's
    ``check`` raises for an input that requires grad while grad mode is on,
    before it looks at the device; under ``torch.no_grad()`` the same
    inputs reach the device check as before.  The CPU path (``ops`` ->
    ``ref``) still differentiates."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    args = _wrapper_inputs(kernel)
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{kernel}: .*no backward"):
        mod.check(*args)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            mod.check(*args)
    args[1].requires_grad_(False)
    with pytest.raises(ValueError, match="CUDA"):
        mod.check(*args)                          # grad mode, no grad input
    args[1].requires_grad_(True)
    out = getattr(ops, kernel)(*args)
    (out * torch.linspace(0.5, 1.5, out.numel()).reshape(out.shape)
     ).sum().backward()
    assert args[1].grad is not None and args[1].grad.shape == args[1].shape


def _check_accepts_grad(kernel, *extra):
    """``kernel``'s ``check`` takes an input that requires grad under grad
    mode and fails these CPU tensors on the device only, and ``ops``
    differentiates them on the CPU."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    args = _wrapper_inputs(kernel)
    args[1].requires_grad_(True)
    assert torch.is_grad_enabled()
    with pytest.raises(ValueError, match="CUDA"):
        mod.check(*args, *extra)
    out = getattr(ops, kernel)(*args)
    out = out[0] if isinstance(out, tuple) else out
    (out * torch.linspace(0.5, 1.5, out.numel()).reshape(out.shape)
     ).sum().backward()
    assert args[1].grad is not None and args[1].grad.shape == args[1].shape


def test_flash_attention_check_accepts_inputs_that_need_grad():
    """K2 has a backward kernel: its ``check`` takes an input that
    requires grad under grad mode and fails these CPU tensors on the device
    only, and ``ops.flash_attention`` differentiates them on the CPU."""
    _check_accepts_grad("flash_attention", True)


@pytest.mark.parametrize("kernel", ["moe_gmm", "rwkv_scan", "rglru_scan"])
def test_kernel_wrappers_accept_inputs_that_need_grad(kernel):
    """K3, K4 and K5 have backward kernels too: each wrapper's ``check``
    takes an input that requires grad under grad mode and fails these CPU
    tensors on the device only, and ``ops`` differentiates them on the
    CPU."""
    _check_accepts_grad(kernel)


def test_flash_attention_wrapper_takes_head_dim_160():
    """pixtral-12b's head dim: K2's wrapper now fails its CPU tensors on
    the device only, as at every other instantiated head dim."""
    from repro_torch.kernels import flash_attention as k2
    assert 160 in k2.HEAD_DIMS
    q, k = torch.zeros((1, 32, 16, 160)), torch.zeros((1, 8, 16, 160))
    with pytest.raises(ValueError, match="CUDA"):
        k2.check(q, k, k, True)


def test_ops_refuse_other_devices():
    q = torch.zeros((1, 2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)


def test_kernel_wrappers_validate_inputs():
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    q = torch.zeros((1, 4, 8, 32))
    k = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        k2.check(q, k, k, True)                       # CPU tensors
    with pytest.raises(ValueError, match="head dim"):
        k2.check(torch.zeros((1, 4, 8, 48)), torch.zeros((1, 2, 8, 48)),
                 torch.zeros((1, 2, 8, 48)), True)
    with pytest.raises(ValueError, match="T <= S"):
        k2.check(torch.zeros((1, 4, 9, 32)), k, k, True)
    with pytest.raises(ValueError, match="dtypes"):
        k2.check(q.half(), k.half(), k.half(), True)
    with pytest.raises(ValueError, match="int32"):
        k1.check(q[:, :, 0], k, k, torch.zeros((1,), dtype=torch.int64))
    with pytest.raises(ValueError, match="stride"):
        k2.check(q, k, k.transpose(2, 3).contiguous().transpose(2, 3), False)
    with pytest.raises(ValueError, match="window"):
        k2.check(q, k, k, False, window=4)
    with pytest.raises(ValueError, match="head dim"):
        k1.check(torch.zeros((1, 2, 4096)), torch.zeros((1, 1, 8, 4096)),
                 torch.zeros((1, 1, 8, 4096)),
                 torch.zeros((1,), dtype=torch.int32))


def test_recurrence_wrappers_validate_inputs():
    from repro_torch.kernels import rglru_scan as k5
    from repro_torch.kernels import rwkv_scan as k4
    x = torch.zeros((1, 2, 8, 16))
    u = torch.zeros((2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        k4.check(x, x, x, x, u)                       # CPU tensors
    with pytest.raises(ValueError, match="M <= 64"):
        y = torch.zeros((1, 2, 8, 128))
        k4.check(y, y, y, y, torch.zeros((2, 128)))
    with pytest.raises(ValueError, match="float32"):
        k4.check(x, x, x, x.bfloat16(), u)
    with pytest.raises(ValueError, match="S0"):
        k4.check(x, x, x, x, u, torch.zeros((1, 2, 16, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        k4.check(x, x, x, x, u,
                 torch.zeros((1, 2, 16, 16)).transpose(2, 3))
    with pytest.raises(ValueError, match="65535"):
        y = torch.zeros((1, 2, 8, 16)).expand(70000, 2, 8, 16)
        k4.check(y, y, y, y, u)
    a = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        k5.check(a, a)
    with pytest.raises(ValueError, match="float32"):
        k5.check(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        k5.check(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="65535"):
        y = a[:1].expand(70000, 8, 16)
        k5.check(y, y)


def test_build_target_hashes_included_headers(tmp_path, monkeypatch):
    """An edited ``csrc/`` header changes the library name of every source
    that includes it, so those are rebuilt, and of no other."""
    import shutil

    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    before = {n: _build._target(n) for n in names}
    assert before == {n: _build._target(n) for n in names}   # stable
    header = csrc / "mma_sync.cuh"
    header.write_text(header.read_text() + "// edited\n")
    users = {n for n in names
             if '#include "mma_sync.cuh"' in (csrc / f"{n}.cu").read_text()}
    assert users == {"decode_attention", "flash_attention",
                     "flash_attention_bwd", "moe_gmm", "moe_gmm_bwd",
                     "rwkv_scan", "rwkv_scan_bwd"}
    for n in names:
        assert (_build._target(n) != before[n]) == (n in users), n


def _attention_inputs(rng, B, H, Hkv, T, S, hd):
    return (arr(rng, B, H, T, hd), arr(rng, B, Hkv, S, hd),
            arr(rng, B, Hkv, S, hd), arr(rng, B, H, T, hd))


@pytest.mark.parametrize("T,S,causal,G", [
    (24, 24, True, 1), (24, 24, True, 4), (24, 24, False, 1),
    (16, 40, True, 4), (16, 40, False, 4), (33, 57, True, 1)])
def test_attention_backward_matches_autograd_and_jax_vjp(T, S, causal, G):
    """K2's plain backward (the formula its kernel computes) against
    ``torch.autograd`` of the plain attention and ``jax.vjp`` of the JAX
    package's oracle, float32 at 1e-5: causal (T = S and T < S), full, and
    G = 1 and 4 query heads per kv head."""
    import jax
    from repro_torch.kernels import ref
    rng = np.random.default_rng(7)
    B, Hkv, hd = 2, 2, 32
    q, k, v, do = _attention_inputs(rng, B, G * Hkv, Hkv, T, S, hd)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = ref.attention_lse(tq, tk, tv, causal=causal)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    got = ref.attention_backward(tq.detach(), tk.detach(), tv.detach(),
                                 out.detach(), lse.detach(),
                                 torch.from_numpy(do), causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w, j in zip(got, want, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("T,S,window,G", [(40, 40, 9, 2), (30, 70, 16, 1),
                                          (64, 64, 64, 4)])
def test_attention_backward_window_matches_model_attention(T, S, window, G):
    """With a sliding window, the plain backward against ``torch.autograd``
    of the port's model attention (``layers.attention``, the (B,T,H,hd)
    layout and ``_mask_bias``), positions bottom-right aligned."""
    from repro_torch.kernels import ref
    from repro_torch.models.layers import attention
    rng = np.random.default_rng(8)
    B, Hkv, hd = 2, 2, 32
    q, k, v, do = _attention_inputs(rng, B, G * Hkv, Hkv, T, S, hd)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = attention(tq.transpose(1, 2), tk.transpose(1, 2),
                    tv.transpose(1, 2), torch.arange(S - T, S),
                    torch.arange(S), window=window).transpose(1, 2)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    o, lse = ref.attention_lse(tq.detach(), tk.detach(), tv.detach(),
                               window=window)
    got = ref.attention_backward(tq.detach(), tk.detach(), tv.detach(), o,
                                 lse, torch.from_numpy(do), window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("T,S,causal,window", [(24, 24, True, 0),
                                               (16, 40, True, 0),
                                               (16, 40, False, 0),
                                               (40, 40, True, 9)])
def test_attention_lse_matches_logsumexp(T, S, causal, window):
    """``ref.attention_lse``: the output of ``ref.attention`` and the
    logsumexp of each row's scaled, masked scores, in float64 here."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(9)
    q, k, v, _ = _attention_inputs(rng, 2, 4, 2, T, S, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = ref.attention_lse(tq, tk, tv, causal=causal, window=window)
    s = np.einsum("bkgth,bksh->bkgts", q.reshape(2, 2, 2, T, 32)
                  .astype(np.float64), k.astype(np.float64)) * 32 ** -0.5
    i, j = np.arange(T)[:, None] + S - T, np.arange(S)[None, :]
    seen = (j <= i) & (j > i - window) if window else j <= i
    s = np.where(seen if causal else True, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want.reshape(2, 4, T),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        out.numpy(), ref.attention(tq, tk, tv, causal=causal,
                                   window=window).numpy())
