"""MoE parity: the port's ``moe_gmm`` (K3's plain version on the CPU) and
``models.moe`` against the JAX package, inputs made with numpy from a seed.

``moe_gmm`` is held against the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and the reference's oracle at the
shapes and tolerances of ``tests/test_kernels.py``; ragged shapes, which
the Pallas grid floor-divides away, against the oracle alone.
``moe_block`` and an arctic layer with its dense residual are held in
float32 at 1e-4 (the same math summed in another order), with converted
parameters, including batches where the capacity drops tokens and experts
that get fewer tokens than their capacity.  ``moe_gmm``'s ``rows`` (the
live rows of each expert) is held against the Pallas kernel and the oracle
with the rows past it zeroed, and ``moe_block``'s use of it against the
routing's ``keep`` mask.  ``tests/test_torch_cuda.py`` holds K3 itself
against its plain version on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                      # noqa: E402
from repro.kernels import ops as jops                      # noqa: E402
from repro.kernels import ref as jref                      # noqa: E402
from repro.models import init_params as j_init_params      # noqa: E402
from repro.models import moe as j_moe                      # noqa: E402
from repro.models import transformer as j_transformer      # noqa: E402

from repro_torch import configs                            # noqa: E402
from repro_torch.convert import params_from_jax            # noqa: E402
from repro_torch.kernels import ops, ref                   # noqa: E402
from repro_torch.models import layers, moe                 # noqa: E402
from repro_torch.models import transformer                 # noqa: E402

TOL = 1e-4
MOE = ["qwen3_moe_235b", "arctic_480b"]


def arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
#  moe_gmm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,d,f", [
    (1, 64, 128, 64), (2, 128, 256, 128), (4, 64, 256, 64),
    (2, 128, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_matches_pallas(e, c, d, f, dtype):
    """The shapes of ``test_moe_gmm_property`` / ``test_moe_gmm_dtypes``,
    at their tolerances (rtol 2e-3, atol 2e-2; 5e-2 in bf16)."""
    rng = np.random.default_rng(0)
    x, w = arr(rng, e, c, d), arr(rng, e, d, f)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    got = ops.moe_gmm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (e, c, f)
    rtol, atol = (5e-2, 5e-1) if dtype == "bfloat16" else (2e-3, 2e-2)
    for want in (jops.moe_gmm(jx, jw, block_c=64, block_f=64, block_d=64),
                 jref.moe_gmm(jx, jw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("e,c,d,f", [
    (3, 5, 37, 11), (2, 80, 100, 130), (1, 1, 1, 1), (4, 4, 4100, 9)])
def test_moe_gmm_ragged_matches_reference_oracle(e, c, d, f):
    """C, D and F that no block divides: the Pallas grid floor-divides
    them away, so the oracle decides."""
    rng = np.random.default_rng(1)
    x, w = arr(rng, e, c, d), arr(rng, e, d, f)
    got = ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.moe_gmm(jnp.asarray(x),
                                                       jnp.asarray(w))),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("e,c,d,f,rows", [
    (4, 64, 128, 64, [0, 17, 64, 40]), (2, 128, 128, 128, [128, 1]),
    (3, 64, 128, 64, [0, 0, 0]), (2, 64, 128, 64, [64, 64])])
def test_moe_gmm_rows_matches_pallas(e, c, d, f, rows):
    """``rows``: each expert's first rows[e] rows are the Pallas kernel's
    and the oracle's, the rest are zeros; rows 0, partial and C, float32 at
    1e-5 (D = 128: a float32 sum of 128 unit products, reordered, stays
    well inside it; at D = 256 one element in 32,768 moves by 1.2e-5)."""
    rng = np.random.default_rng(2)
    x, w = arr(rng, e, c, d), arr(rng, e, d, f)
    r = torch.tensor(rows, dtype=torch.int32)
    got = ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w), r).numpy()
    live = np.arange(c)[None, :, None] < np.asarray(rows)[:, None, None]
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for want in (jops.moe_gmm(jx, jw, block_c=64, block_f=64, block_d=64),
                 jref.moe_gmm(jx, jw)):
        np.testing.assert_allclose(got, np.where(live, np.asarray(want), 0),
                                   rtol=1e-5, atol=1e-5)
    assert not got[~np.broadcast_to(live, got.shape)].any()
    torch.testing.assert_close(                 # rows = C is rows = None
        ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w),
                    torch.full((e,), c, dtype=torch.int32)),
        ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w)), rtol=0,
        atol=0)


# ragged moe_gmm (the all-to-all dispatch's packed buffer): (E, M, D, F,
# rows): segment ends no multiple of 16 and empty experts, one expert
# holding all M rows, rows of no expert at the end, and counts filling M
RAGGED = [(4, 100, 24, 40, [37, 0, 45, 13]), (3, 50, 16, 8, [0, 50, 0]),
          (5, 90, 20, 12, [17, 1, 0, 33, 19]), (2, 64, 32, 16, [64, 0]),
          (6, 128, 48, 24, [21, 0, 30, 0, 15, 62])]


def _ragged(case, seed):
    """x (M, D), w (E, D, F), dy (M, F) float32 from a seed, rows and
    starts (each segment after the last) as numpy int32."""
    E, M, D, F, rows = case
    rng = np.random.default_rng(seed)
    rows = np.asarray(rows, np.int32)
    starts = (np.cumsum(rows) - rows).astype(np.int32)
    return (arr(rng, M, D), arr(rng, E, D, F), arr(rng, M, F), rows,
            starts)


def _padded(x, rows, starts, C):
    """The packed rows as the dense form's (E, C, D) buffers: expert e's
    rows first, then zeros."""
    out = np.zeros((len(rows), C, x.shape[1]), x.dtype)
    for e, (s, n) in enumerate(zip(starts, rows)):
        out[e, :n] = x[s:s + n]
    return out


def _unpad(y, rows, starts, M):
    out = np.zeros((M, y.shape[2]), y.dtype)
    for e, (s, n) in enumerate(zip(starts, rows)):
        out[s:s + n] = y[e, :n]
    return out


@pytest.mark.parametrize("case", RAGGED, ids=[str(c[4]) for c in RAGGED])
def test_ragged_moe_gmm_matches_a_loop_and_the_padded_form(case):
    """Ragged ``ref.moe_gmm`` (``starts``) against a float64 loop over the
    experts' segments, the dense form over padded (E, C, D) buffers with
    ``rows``, and the JAX package's oracle over the same buffers; rows of
    no expert are exact zeros."""
    x, w, _, rows, starts = _ragged(case, 3)
    M, C = x.shape[0], int(rows.max())
    got = ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(rows), torch.from_numpy(starts))
    loop = np.zeros((M, w.shape[2]))
    for e, (s, n) in enumerate(zip(starts, rows)):
        loop[s:s + n] = x[s:s + n].astype(np.float64) @ w[e]
    np.testing.assert_allclose(got.numpy(), loop, rtol=1e-5, atol=1e-5)
    assert not got[int(rows.sum()):].any()
    xp = _padded(x, rows, starts, C)
    dense = ref.moe_gmm(torch.from_numpy(xp), torch.from_numpy(w),
                        torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(),
                               _unpad(dense.numpy(), rows, starts, M),
                               rtol=1e-5, atol=1e-5)
    oracle = np.asarray(jref.moe_gmm(jnp.asarray(xp), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), _unpad(oracle, rows, starts, M),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", RAGGED, ids=[str(c[4]) for c in RAGGED])
def test_ragged_moe_gmm_backward_matches_a_loop_and_the_padded_form(case):
    """Ragged ``ref.moe_gmm_backward`` against autograd of the ragged
    ``ref.moe_gmm``, a float64 loop over the segments (dx = dy w[e]^T on
    expert e's rows, zeros elsewhere; dw[e] = x^T dy over its rows only),
    the dense backward over the padded buffers, and ``jax.vjp`` of the
    oracle over them."""
    x, w, dy, rows, starts = _ragged(case, 4)
    M, C = x.shape[0], int(rows.max())
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    r, s = torch.from_numpy(rows), torch.from_numpy(starts)
    dx, dw = ref.moe_gmm_backward(tx.detach(), tw.detach(),
                                  torch.from_numpy(dy), r, s)
    auto = torch.autograd.grad(ref.moe_gmm(tx, tw, r, s), (tx, tw),
                               torch.from_numpy(dy))
    ldx, ldw = np.zeros(x.shape), np.zeros(w.shape)
    for e, (s0, n) in enumerate(zip(starts, rows)):
        d = dy[s0:s0 + n].astype(np.float64)
        ldx[s0:s0 + n] = d @ w[e].T
        ldw[e] = x[s0:s0 + n].T.astype(np.float64) @ d
    pdx, pdw = ref.moe_gmm_backward(
        torch.from_numpy(_padded(x, rows, starts, C)), torch.from_numpy(w),
        torch.from_numpy(_padded(dy, rows, starts, C)), r)
    _, vjp = jax.vjp(jref.moe_gmm, jnp.asarray(_padded(x, rows, starts, C)),
                     jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(_padded(dy, rows, starts, C)))
    for want_dx, want_dw in (
            (auto[0].numpy(), auto[1].numpy()), (ldx, ldw),
            (_unpad(pdx.numpy(), rows, starts, M), pdw.numpy()),
            (_unpad(np.asarray(jdx), rows, starts, M), np.asarray(jdw))):
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-5, atol=1e-5)
    assert not dx[int(rows.sum()):].any() and not dw[r == 0].any()


@pytest.mark.parametrize("bm", [4, 16, 64, 128])
@pytest.mark.parametrize("E,M", [(8, 640), (128, 4000), (3, 7), (40, 90)])
def test_ragged_tiles_cover_each_segment_once(E, M, bm):
    """``csrc/ragged.cuh``'s ``ragged_tile``, mirrored: over the grid's
    ceil(M / bm) + E row tiles, the prefix sums of ceil(rows[e] / bm) give
    each expert's tiles in order; every row of every segment falls in
    exactly one tile, no tile reaches past its segment, and the tiles past
    the last find no expert, for any counts (seeded, empty experts and one
    expert holding every row among them)."""
    rng = np.random.default_rng(E * M + bm)
    draws = [rng.multinomial(M, np.ones(E) / E),
             np.eye(E, dtype=np.int64)[E // 2] * M,
             np.minimum(rng.integers(0, 2 * M // E + 2, E), M // E)]
    for rows in draws:
        starts = np.cumsum(rows) - rows
        tiles = -(-rows // bm)
        seen = np.zeros(M, np.int64)
        for t in range(-(-M // bm) + E):
            hit = [(e, (t - first) * bm) for e, (first, n) in enumerate(
                zip(np.cumsum(tiles) - tiles, tiles)) if first <= t < first + n]
            assert len(hit) <= 1
            if t >= tiles.sum():
                assert hit == []
                continue
            e, m0 = hit[0]
            assert 0 <= m0 < rows[e]
            seen[starts[e] + m0:starts[e] + min(m0 + bm, rows[e])] += 1
        assert (seen[:rows.sum()] == 1).all() and not seen[rows.sum():].any()


# ``csrc/gmm_wgmma.cuh``'s ragged kernels (the all-to-all dispatch's
# bf16 forward and backward on wgmma), mirrored: (E, M, D, F, rows,
# starts) over M = 333 packed rows (no multiple of 128), D = 72 (a last
# stage of 8) and F = 264 (two N tiles): abutting segments with rows of no
# expert at the end, abutting segments filling M, segments with gaps,
# starts in reverse expert order with gaps, empty experts and one-row
# segments among them
WGMMA_RAGGED = {
    "abutting": (5, 333, 72, 264, [130, 0, 1, 129, 60], [0, 130, 130, 131,
                                                          260]),
    "filling": (4, 333, 72, 264, [200, 1, 0, 132], [0, 200, 201, 201]),
    "gaps": (5, 333, 72, 264, [50, 1, 0, 90, 70], [0, 60, 70, 75, 200]),
    "reversed": (5, 333, 72, 264, [40, 130, 1, 0, 100],
                 [290, 150, 140, 130, 10]),
}


def _wgmma_tiles(rows, starts, M, bm):
    """The (expert, first row within its segment) of each tile of the
    ragged grid, in grid order: ``ragged_tile``'s prefix sums of
    ceil(rows / bm) over the clamped segments."""
    tiles = []
    for e, (s0, n) in enumerate(zip(starts, rows)):
        s0 = min(max(s0, 0), M)
        tiles += [(e, m0) for m0 in range(0, min(max(n, 0), M - s0), bm)]
    return tiles


def _segment(rows, starts, e, M):
    s0 = min(max(starts[e], 0), M)
    return s0, min(max(rows[e], 0), M - s0)


def _box(t, r0, n):
    """Rows r0 .. r0 + n of t as a TMA box reads them: zeros past t's
    rows."""
    out = torch.zeros((n, t.shape[1]), dtype=t.dtype)
    out[:max(0, min(n, t.shape[0] - r0))] = t[r0:r0 + n]
    return out


def _wgmma_rows(a, b, rows, starts, order, dense_store=False, bm=128,
                bn=256, bk=64):
    """Y = A b[e] on each expert's packed rows (the forward: A = x, b = w;
    dx: A = dy, b = w^T), blocks run in ``order`` (a permutation of the
    grid's (tile, N tile) blocks; on the card they run in no order): a
    block's box of A starts at the segment's first row plus its tile's and
    runs on past the segment's end (the next expert's rows, zeros past M),
    D in stages of ``bk``, and its store stops at the segment's end, or
    with ``dense_store`` writes zeros over its tile's rows past it (the
    dense kernel's store)."""
    M = a.shape[0]
    F = b.shape[2]
    y = torch.zeros((M, F), dtype=a.dtype)
    blocks = [(t, n0) for t in _wgmma_tiles(rows, starts, M, bm)
              for n0 in range(0, F, bn)]
    for i in order(len(blocks)):
        (e, m0), n0 = blocks[i]
        s0, n = _segment(rows, starts, e, M)
        box = _box(a, s0 + m0, bm)
        acc = torch.zeros((bm, min(bn, F - n0)), dtype=a.dtype)
        for k0 in range(0, a.shape[1], bk):
            acc += box[:, k0:k0 + bk] @ b[e, k0:k0 + bk, n0:n0 + bn]
        stop = n - m0                        # the segment's rows in the tile
        if dense_store:
            acc[stop:] = 0
            stop = min(bm, M - s0 - m0)
        y[s0 + m0:s0 + m0 + min(bm, stop), n0:n0 + bn] = acc[:stop]
    return y


def _wgmma_dw(x, dy, rows, starts, zero_tail=True, bk=64):
    """dw[e] = x^T dy over expert e's rows: stages of ``bk`` rows from the
    segment's first row, whose boxes of x and dy run past its end (zeros
    past M); the last stage's rows past the end are zeroed in both (or not,
    without ``zero_tail``); an empty expert runs no stage."""
    M = x.shape[0]
    dw = []
    for e in range(len(rows)):
        s0, n = _segment(rows, starts, e, M)
        acc = torch.zeros((x.shape[1], dy.shape[1]), dtype=x.dtype)
        for k0 in range(0, n, bk):
            xs, ds = _box(x, s0 + k0, bk), _box(dy, s0 + k0, bk)
            if zero_tail:
                xs[n - k0:] = 0
                ds[n - k0:] = 0
            acc += xs.T @ ds
        dw.append(acc)
    return torch.stack(dw)


ORDERS = {"grid": lambda n: range(n), "reversed": lambda n: range(n)[::-1],
          "seeded": lambda n: np.random.default_rng(n).permutation(n)}


def _integers(rng, *shape):
    """float32 small integers: every product and sum below is exact, so
    each order of the sums gives the same bits."""
    return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", WGMMA_RAGGED)
def test_ragged_wgmma_indexing_matches_the_plain_version(kind, order):
    """The ragged wgmma forward, dx and dw, mirrored on float32 integers
    in any block order, equal ``ref.moe_gmm`` / ``ref.moe_gmm_backward``
    exactly, and leave the rows of no expert exact zeros."""
    E, M, D, F, rows, starts = WGMMA_RAGGED[kind]
    rng = np.random.default_rng(len(kind))
    x, w, dy = _integers(rng, M, D), _integers(rng, E, D, F),         _integers(rng, M, F)
    r, s = (torch.tensor(v, dtype=torch.int32) for v in (rows, starts))
    y = _wgmma_rows(x, w, rows, starts, ORDERS[order])
    assert torch.equal(y, ref.moe_gmm(x, w, r, s))
    dx = _wgmma_rows(dy, w.transpose(1, 2), rows, starts, ORDERS[order])
    dw = _wgmma_dw(x, dy, rows, starts)
    want_dx, want_dw = ref.moe_gmm_backward(x, w, dy, r, s)
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
    owned = ref._segments(r, s, M).any(0)
    assert not y[~owned].any() and not dx[~owned].any()
    assert not dw[r == 0].any()


def test_ragged_wgmma_needs_its_own_store_and_zeroed_tail():
    """The trap: with the dense kernel's store (zeros over the tile's rows
    past the segment's end) a block clobbers the next expert's rows of
    abutting segments when it runs after them; without zeroing the last
    dw stage's rows past the segment's end, dw[e] sums the next expert's
    rows."""
    E, M, D, F, rows, starts = WGMMA_RAGGED["abutting"]
    rng = np.random.default_rng(0)
    x, w, dy = _integers(rng, M, D), _integers(rng, E, D, F),         _integers(rng, M, F)
    r, s = (torch.tensor(v, dtype=torch.int32) for v in (rows, starts))
    want = ref.moe_gmm(x, w, r, s)
    assert torch.equal(_wgmma_rows(x, w, rows, starts, ORDERS["grid"],
                                   dense_store=True), want)
    assert not torch.equal(_wgmma_rows(x, w, rows, starts,
                                       ORDERS["reversed"], dense_store=True),
                           want)
    assert not torch.equal(_wgmma_dw(x, dy, rows, starts, zero_tail=False),
                           ref.moe_gmm_backward(x, w, dy, r, s)[1])


# ``csrc/gmm_f32.cuh``'s float32 loop (the forward but the dense one at
# 32 rows an expert or fewer, dx and dw), mirrored: its block heights
# with their tiles (TM rows a thread, BN columns), stages of 16 along K,
# and dw's 128 x 128 tiles
FFMA_TILES = {64: (4, 128), 80: (5, 128), 96: (6, 128), 128: (8, 128)}
FFMA_BK = 16


def _ffma_bm(R, ragged):
    """``ffma_bm``: 64 up to 64 rows an expert (the ragged mean raised by
    a quarter), else the height of 128, 96, 80, 64 that pads R least, the
    taller on a tie."""
    R += R // 4 if ragged else 0
    if R <= 64:
        return 64
    return min((128, 96, 80, 64), key=lambda bm: -(-R // bm) * bm - R)


def _ffma_rows(a, b, rows, starts, order, bm):
    """Y = A b[e] with Y's rows the expert's (the forward: A = x, b = w;
    dx: A = dy, b = w^T), on the float32 loop's (bm, BN) tiles, blocks in
    ``order``: dense (A (E, C, K), ``starts`` None) by (expert, M tile, N
    tile), rows c >= rows[e] written as zeros; ragged (A (M, K) packed)
    by ``ragged_tile``'s tiles, the store stopping at the segment's end.
    A's rows past the live rows are zero filled; a warp whose rows all lie
    past them skips its products; K runs in stages of ``FFMA_BK``."""
    TM, bn = FFMA_TILES[bm]
    warp_rows = 4 * TM                         # rows of a K-contiguous A
    E, K, F = b.shape
    ragged = starts is not None
    if ragged:
        M = a.shape[0]
        y = torch.zeros((M, F), dtype=a.dtype)
        tiles = _wgmma_tiles(rows, starts, M, bm)
    else:
        C = a.shape[1]
        y = torch.full((E, C, F), float("nan"), dtype=a.dtype)
        tiles = [(e, m0) for e in range(E) for m0 in range(0, C, bm)]
    blocks = [(t, n0) for t in tiles for n0 in range(0, F, bn)]
    for i in order(len(blocks)):
        (e, m0), n0 = blocks[i]
        if ragged:
            s0, mlim = _segment(rows, starts, e, M)
            mrows, src, dst = mlim, a[s0:], y[s0:]
        else:
            mrows, src, dst = C, a[e], y[e]
            mlim = C if rows is None else min(max(rows[e], 0), C)
        tile = torch.zeros((bm, K), dtype=a.dtype)
        n_in = max(0, min(bm, mlim - m0))      # zero filled past mlim
        tile[:n_in] = src[m0:m0 + n_in]
        acc = torch.zeros((bm, min(bn, F - n0)), dtype=a.dtype)
        if m0 < mlim:
            for k0 in range(0, K, FFMA_BK):
                acc += tile[:, k0:k0 + FFMA_BK] @ \
                    b[e, k0:k0 + FFMA_BK, n0:n0 + bn]
            for r0 in range(0, bm, warp_rows):  # warps past the live rows
                if r0 >= mlim - m0:
                    acc[r0:r0 + warp_rows] = 0
        acc[max(0, mlim - m0):] = 0            # dense rows past rows[e]
        stop = max(0, min(bm, mrows - m0))
        dst[m0:m0 + stop, n0:n0 + bn] = acc[:stop]
    return y


def _ffma_dw(x, dy, rows, starts, order, by_segment=True):
    """dw[e] = x^T dy on 128 x 128 tiles of (D, F), blocks in ``order``,
    the sum over the expert's rows in stages of ``FFMA_BK``: dense over
    c < rows[e]; ragged from the segment's first row, both operands zero
    filled past its end (``by_segment``) or, the trap, only past M."""
    ragged = starts is not None
    E = len(rows) if rows is not None else x.shape[0]
    D, F = x.shape[-1], dy.shape[-1]
    dw = torch.full((E, D, F), float("nan"), dtype=x.dtype)
    blocks = [(e, m0, n0) for e in range(E) for m0 in range(0, D, 128)
              for n0 in range(0, F, 128)]
    for i in order(len(blocks)):
        e, m0, n0 = blocks[i]
        if ragged:
            M = x.shape[0]
            s0, klim = _segment(rows, starts, e, M)
            if not by_segment:
                klim = -(-klim // FFMA_BK) * FFMA_BK    # stages run on
            xs, ds = x[s0:], dy[s0:]
        else:
            C = x.shape[1]
            klim = C if rows is None else min(max(rows[e], 0), C)
            xs, ds = x[e], dy[e]
        acc = torch.zeros((min(128, D - m0), min(128, F - n0)),
                          dtype=x.dtype)
        for k0 in range(0, klim, FFMA_BK):
            kn = min(FFMA_BK, klim - k0)        # zero filled past klim
            acc += xs[k0:k0 + kn, m0:m0 + 128].T @ ds[k0:k0 + kn,
                                                      n0:n0 + 128]
        dw[e, m0:m0 + 128, n0:n0 + 128] = acc
    return dw


@pytest.mark.parametrize("R,ragged,bm", [
    (33, False, 64), (40, False, 64), (64, False, 64), (80, False, 80),
    (96, False, 96), (130, False, 80), (200, False, 80), (640, False, 128),
    (64, True, 80), (51, True, 64), (52, True, 80), (125, True, 80),
    (8192, True, 128)])
def test_ffma_tile_height_follows_the_rows_an_expert(R, ragged, bm):
    """``ffma_bm``: the float32 loop's block height for R rows an expert
    (the all-to-all dispatch's 64 a ragged expert: 80, so that most counts
    around the mean, 46 to 92 at its seeded routing, fit one tile; the
    training capacity of 640: 128)."""
    assert _ffma_bm(R, ragged) == bm
    TM, bn = FFMA_TILES[bm]
    assert (bm // TM) * (bn // 8) == 256


def _kin(x, c, G, pair):
    """``kin<G, PAIR>``: the float offset of chunk c (4 floats along k) of
    row x of a K-contiguous stage (rows of ``FFMA_BK`` = 16 floats), keyed
    by the readers' group x / G: B's rows (``pair``, G = 4) two to a
    128-byte line, its 8 chunks XORed with the key; A's rows (G = TM) one
    each, the chunks XORed with the key's low bits."""
    key = (x // G) & 7
    if pair:
        return (x >> 1) * 32 + 4 * ((((x & 1) << 2) | c) ^ key)
    return x * FFMA_BK + 4 * (c ^ (key & 3))


@pytest.mark.parametrize("BX,G,pair", [
    (64, 4, False), (80, 5, False), (96, 6, False), (128, 8, False),
    (128, 4, True), (256, 4, True)])
def test_ffma_k_contiguous_stage_spreads_a_warps_reads(BX, G, pair):
    """A K-contiguous stage (BX rows of 16 floats) is a permutation of its
    floats in whole 16-byte chunks, and a warp's reads of one chunk fall
    in as many 16-byte bank groups as 128 bytes allow: B's rows 4 t + j
    of its 8 threads t along N (``pair``), A's rows t TM + i of its 4
    threads t along M (G = TM)."""
    offs = [_kin(x, c, G, pair) + f for x in range(BX) for c in range(4)
            for f in range(4)]
    assert sorted(offs) == list(range(BX * 16))

    def groups(xs, c):
        return len({_kin(x, c, G, pair) // 4 % 8 for x in xs})
    for c in range(4):
        if pair:
            for t0 in range(0, BX // 4, 8):
                for j in range(4):
                    assert groups([4 * (t0 + t) + j for t in range(8)],
                                  c) == 8
        else:
            for t0 in range(0, BX // G, 4):
                for i in range(G):
                    assert groups([(t0 + t) * G + i for t in range(4)],
                                  c) == 4


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", WGMMA_RAGGED)
def test_ragged_ffma_tiling_matches_the_plain_version(kind, order):
    """The float32 loop's ragged forward, dx and dw, mirrored on float32
    integers in any block order and at every block height, equal
    ``ref.moe_gmm`` / ``ref.moe_gmm_backward`` exactly and leave the rows
    of no expert and an empty expert's dw exact zeros."""
    E, M, D, F, rows, starts = WGMMA_RAGGED[kind]
    rng = np.random.default_rng(len(kind) + 7)
    x, w, dy = _integers(rng, M, D), _integers(rng, E, D, F), \
        _integers(rng, M, F)
    r, s = (torch.tensor(v, dtype=torch.int32) for v in (rows, starts))
    want_y = ref.moe_gmm(x, w, r, s)
    want_dx, want_dw = ref.moe_gmm_backward(x, w, dy, r, s)
    owned = ref._segments(r, s, M).any(0)
    for bm in FFMA_TILES:
        y = _ffma_rows(x, w, rows, starts, ORDERS[order], bm)
        dx = _ffma_rows(dy, w.transpose(1, 2), rows, starts, ORDERS[order],
                        bm)
        assert torch.equal(y, want_y) and torch.equal(dx, want_dx)
        assert not y[~owned].any() and not dx[~owned].any()
    dw = _ffma_dw(x, dy, rows, starts, ORDERS[order])
    assert torch.equal(dw, want_dw) and not dw[r == 0].any()


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", [None, "partial", "zero"])
@pytest.mark.parametrize("C", [37, 80, 96, 130, 200])
def test_dense_ffma_tiling_matches_the_plain_version(C, kind, order):
    """The float32 loop's dense forward, dx and dw, mirrored on float32
    integers in any block order, on the tile ``ffma_bm`` picks for C (a
    ragged last stage of D = 72 and F = 264, two N tiles), with all rows,
    some (0, 1, C - 1, C, ...) or none live: equal ``ref.moe_gmm`` /
    ``ref.moe_gmm_backward`` exactly, every element written, the rows past
    rows[e] and an expert without rows exact zeros."""
    E, D, F = 4, 72, 264
    rng = np.random.default_rng(C)
    x, w, dy = _integers(rng, E, C, D), _integers(rng, E, D, F), \
        _integers(rng, E, C, F)
    n = {None: None, "zero": [0] * E,
         "partial": [(0, 1, C - 1, C)[e] for e in range(E)]}[kind]
    r = None if n is None else torch.tensor(n, dtype=torch.int32)
    bm = _ffma_bm(C, False)
    y = _ffma_rows(x, w, n, None, ORDERS[order], bm)
    dx = _ffma_rows(dy, w.transpose(1, 2), n, None, ORDERS[order], bm)
    dw = _ffma_dw(x, dy, n, None, ORDERS[order])
    want_dx, want_dw = ref.moe_gmm_backward(x, w, dy, r)
    assert torch.equal(y, ref.moe_gmm(x, w, r))
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
    if r is not None:
        live = torch.arange(C)[None, :] < r[:, None]
        assert not y[~live].any() and not dx[~live].any()
        assert not dw[r == 0].any()


def test_ragged_ffma_dw_needs_zero_fill_by_the_segment():
    """The trap: dw's stages run over the segment's rows from its first
    one; zero filled only past M instead of past the segment's end, the
    last stage sums the next expert's rows into dw[e]."""
    E, M, D, F, rows, starts = WGMMA_RAGGED["abutting"]
    rng = np.random.default_rng(1)
    x, w, dy = _integers(rng, M, D), _integers(rng, E, D, F), \
        _integers(rng, M, F)
    r, s = (torch.tensor(v, dtype=torch.int32) for v in (rows, starts))
    want = ref.moe_gmm_backward(x, w, dy, r, s)[1]
    assert torch.equal(_ffma_dw(x, dy, rows, starts, ORDERS["grid"]), want)
    assert not torch.equal(_ffma_dw(x, dy, rows, starts, ORDERS["grid"],
                                    by_segment=False), want)


def test_moe_gmm_wrapper_validates_inputs():
    from repro_torch.kernels import moe_gmm as k3
    x, w = torch.zeros((2, 4, 8)), torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        k3.check(x, w)                                 # CPU tensors
    with pytest.raises(ValueError, match="want x"):
        k3.check(x, torch.zeros((2, 9, 16)))
    with pytest.raises(ValueError, match="dtypes"):
        k3.check(x.half(), w.half())
    with pytest.raises(ValueError, match="dtypes"):
        k3.check(x.bfloat16(), w)
    with pytest.raises(ValueError, match="unit stride"):
        k3.check(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="nonempty"):
        k3.check(torch.zeros((2, 0, 8)), w)
    with pytest.raises(ValueError, match="rows"):
        k3.check(x, w, torch.zeros((2,), dtype=torch.int64))
    with pytest.raises(ValueError, match="rows"):
        k3.check(x, w, torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        ops.moe_gmm(x.to("meta"), w.to("meta"))
    assert "moe_gmm" in ops.launch_counts()


def test_moe_gmm_wrapper_validates_ragged_inputs():
    """``starts`` comes with ``rows``, both (E,) int32 and contiguous, and
    with a 2-D x whose D is w's."""
    from repro_torch.kernels import moe_gmm as k3
    x, w = torch.zeros((10, 8)), torch.zeros((2, 8, 16))
    r = s = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        k3.check(x, w, r, s)                           # CPU tensors
    with pytest.raises(ValueError, match="ragged"):
        k3.check(torch.zeros((2, 10, 8)), w, r, s)
    with pytest.raises(ValueError, match="ragged"):
        k3.check(torch.zeros((10, 9)), w, r, s)
    with pytest.raises(ValueError, match="together with rows"):
        k3.check(x, w, None, s)
    with pytest.raises(ValueError, match="starts"):
        k3.check(x, w, r, torch.zeros((2,), dtype=torch.int64))
    with pytest.raises(ValueError, match="starts"):
        k3.check(x, w, r, torch.zeros((4,), dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="want x"):
        k3.check(x, w, r)                              # 2-D x, no starts


# ---------------------------------------------------------------------------
#  moe_block
# ---------------------------------------------------------------------------
def f32_pair(arch):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype="float32"),
            dataclasses.replace(configs.smoke(arch), dtype="float32"))


def layer0(arch, seed=0):
    """Layer 0 of the converted smoke model: (jcfg, cfg, JAX layer params,
    port layer params)."""
    jcfg, cfg = f32_pair(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"]),
            transformer._index(p["layers"], 0))


@pytest.mark.parametrize("n", [1, 3, 4, 16, 25, 100, 1024])
def test_capacity_matches_reference(n):
    for arch in MOE:
        for cfg in (configs.get(arch), configs.smoke(arch)):
            jcfg = dataclasses.replace(jconfigs.get(arch), n_experts=cfg
                                       .n_experts, top_k=cfg.top_k)
            assert moe._capacity(cfg, n) == j_moe._capacity(jcfg, n)
    assert moe._capacity(configs.get("qwen3_moe_235b"), 1024) == 80
    assert moe._capacity(configs.get("qwen3_moe_235b"), 4) == 4


def _loads(cfg, p, x):
    """Tokens routed to each expert (before the capacity drop)."""
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    ids = torch.topk(probs, cfg.top_k, dim=-1).indices
    return torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,T,cf", [
    (1, 4, 1.25), (2, 16, 1.25), (2, 64, 1.25), (4, 100, 1.25),
    (2, 16, 0.5), (4, 100, 0.5)])          # cf 0.5: the capacity binds
def test_moe_block_matches_jax(arch, B, T, cf):
    jcfg, cfg, jl, pl = layer0(arch)
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=cf)
                 for c in (jcfg, cfg))
    x = arr(np.random.default_rng(B * T), B, T, cfg.d_model)
    want, waux = j_moe.moe_block(jcfg, jl["moe"], jnp.asarray(x))
    got, aux = moe.moe_block(cfg, pl["moe"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL, atol=TOL)
    loads, C = _loads(cfg, pl["moe"], x), moe._capacity(cfg, B * T)
    if cf < 1:
        assert int(loads.max()) > C       # the capacity drops tokens
    else:
        assert int(loads.min()) < C       # an expert with fewer than C


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_jax(arch):
    """One whole layer through ``_block``: attention, the MoE and, for
    arctic, the dense residual MLP beside it; y and the layer's aux."""
    jcfg, cfg, jl, pl = layer0(arch, seed=3)
    assert ("mlp" in pl) == cfg.dense_residual
    B, T = 2, 96
    x = arr(np.random.default_rng(4), B, T, cfg.d_model)
    pos = np.arange(T, dtype=np.int32)
    want, _, waux = j_transformer._block(jcfg, jl, jnp.asarray(x),
                                         jnp.asarray(pos), None, None, 0)
    got, aux = transformer._block(cfg, pl, torch.from_numpy(x),
                                  torch.from_numpy(pos), None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL, atol=TOL)


def test_moe_block_runs_three_grouped_matmuls(monkeypatch):
    """The card's path: gate, up and down as three ``ops.moe_gmm`` calls
    over the (E, C, D) capacity buffers, and none with
    ``attn_impl="plain"``."""
    jcfg, cfg, jl, pl = layer0("qwen3_moe_235b")
    calls = []

    def counting(x, w, rows):
        calls.append((tuple(x.shape), tuple(w.shape), rows))
        return ref.moe_gmm(x, w, rows)
    monkeypatch.setattr(ops, "moe_gmm", counting)
    monkeypatch.setattr(layers, "use_kernels",
                        lambda c, x: c.attn_impl != "plain")
    x = torch.from_numpy(arr(np.random.default_rng(5), 2, 16, cfg.d_model))
    y, _ = moe.moe_block(cfg, pl["moe"], x)
    E, C, D, F = cfg.n_experts, moe._capacity(cfg, 32), cfg.d_model, cfg.e_ff
    assert [c[:2] for c in calls] == [((E, C, D), (E, D, F))] * 2 + [
        ((E, C, F), (E, F, D))]
    keep = moe._route(cfg, pl["moe"], x.reshape(32, D))[3]
    for c in calls:             # each expert's kept count, as int32
        assert c[2].dtype == torch.int32
        assert torch.equal(c[2], keep.sum(1, dtype=torch.int32))
    plain, _ = moe.moe_block(dataclasses.replace(cfg, attn_impl="plain"),
                             pl["moe"], x)
    assert len(calls) == 3
    torch.testing.assert_close(y, plain, rtol=0, atol=0)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,T,cf", [(1, 4, 1.25), (4, 100, 1.25),
                                    (4, 100, 0.5)])
def test_moe_route_keeps_a_prefix(arch, B, T, cf):
    """What K3's ``rows`` relies on: each expert's kept slots are a prefix
    of its capacity buffer, keep[e, :rows[e]] all true and the rest false,
    with and without capacity drops."""
    jcfg, cfg, jl, pl = layer0(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x = arr(np.random.default_rng(B * T + 1), B * T, cfg.d_model)
    keep = moe._route(cfg, pl["moe"], torch.from_numpy(x))[3]
    rows = keep.sum(1)
    prefix = torch.arange(keep.shape[1])[None, :] < rows[:, None]
    assert torch.equal(keep, prefix)
    assert int(rows.min()) < keep.shape[1] or cf < 1   # some partial rows
    if cf < 1:
        assert int(rows.max()) == keep.shape[1]          # and full ones


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,T,cf", [(2, 16, 1.25), (4, 100, 0.5)])
def test_moe_block_rows_changes_nothing(arch, B, T, cf, monkeypatch):
    """``moe_block`` gives the same output, bit for bit, when its matmuls
    ignore ``rows`` and compute every slot."""
    jcfg, cfg, jl, pl = layer0(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x = torch.from_numpy(arr(np.random.default_rng(B * T + 2), B, T,
                             cfg.d_model))
    got, aux = moe.moe_block(cfg, pl["moe"], x)
    plain_gmm = ref.moe_gmm
    monkeypatch.setattr(ref, "moe_gmm", lambda x, w, rows: plain_gmm(x, w))
    want, want_aux = moe.moe_block(cfg, pl["moe"], x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)


def test_moe_block_bf16_sums_in_float32():
    """In bf16 the port adds the experts' outputs in float32 and rounds
    once; it stays within bf16 rounding of the float32 block."""
    jcfg, cfg, jl, pl = layer0("qwen3_moe_235b")
    x = torch.from_numpy(arr(np.random.default_rng(6), 2, 16, cfg.d_model))
    want, _ = moe.moe_block(cfg, pl["moe"], x)
    pb = {k: (v if k == "router" else v.bfloat16())
          for k, v in pl["moe"].items()}
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    got, _ = moe.moe_block(bcfg, pb, x.bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_moe_params_keep_the_reference_layout():
    """Router (D, E) float32 in a bf16 model, experts (E, D, F) / (E, F, D)
    in the config's dtype, stacked over layers; no ``mlp`` leaf without
    the dense residual."""
    for arch in MOE:
        cfg = configs.smoke(arch)
        p = transformer.init_params(cfg, device="meta")["layers"]
        L, D, E, F = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.e_ff
        assert p["moe"]["router"].shape == (L, D, E)
        assert p["moe"]["router"].dtype == torch.float32
        assert p["moe"]["w_gate"].shape == p["moe"]["w_up"].shape \
            == (L, E, D, F)
        assert p["moe"]["w_down"].shape == (L, E, F, D)
        assert p["moe"]["w_down"].dtype == torch.bfloat16
        assert ("mlp" in p) == cfg.dense_residual
