"""The backward kernels' algorithms on the CPU.  The CUDA backwards of K2
``flash_attention``, K3 ``moe_gmm``, K4 ``rwkv_scan`` and K5
``rglru_scan`` (``csrc/*_bwd.cu``) run only on the card.  Their plain versions (``ref.*_backward``, explicit
formulas, the card's reference for each kernel) are held against autograd
through the port's plain forward (``repro_torch.kernels.ref``) and against
``jax.vjp`` of the JAX package's oracle (``repro.kernels.ref``, as the JAX
package's tests run it; its ``moe_gmm`` takes no ``rows`` and its
``rwkv_scan`` no S0, so those comparisons mask the rows and run from
zeros).  Each kernel's schedule is mirrored here, step for step, in
float64 plain torch, at small seeded numpy sizes, and held against the
same three.  Both plain versions compute in float32 (they cast their inputs),
so each gradient is held at ``TOL`` = 1e-5 of its largest entry: the
float32 rounding of their sequential sums, which reaches 2e-6 of the
scale here (dlogw, from the r- and k-side sums that cancel).

``tests/test_torch_cuda.py`` holds the kernels themselves against autograd
of the plain versions on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref                      # noqa: E402

from repro_torch.kernels import ref                        # noqa: E402

TOL = 1e-5                      # float64 mirror against float32 oracles


def close(got, want, tol):
    """Each pair within ``tol`` of the wanted gradient's largest entry."""
    def f64(t):
        if isinstance(t, torch.Tensor):
            return t.detach().to(torch.float64)
        return torch.tensor(np.array(t), dtype=torch.float64)
    for g, w in zip(got, want):
        g, w = f64(g), f64(w)
        assert g.shape == w.shape
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= tol * scale


def seeded(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def autograd(fn, inputs, cotangents):
    """Gradients of ``fn(*inputs)`` (float64 leaves) for the given
    cotangents of its outputs."""
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(
        out, leaves, [torch.tensor(c, dtype=torch.float64)
                      for c in cotangents])


def jax_vjp(fn, inputs, cotangents):
    f32 = [jnp.asarray(x, jnp.float32) for x in inputs]
    out, pull = jax.vjp(fn, *f32)
    ct = [jnp.asarray(c, jnp.float32) for c in cotangents]
    return pull(tuple(ct) if isinstance(out, tuple) else ct[0])


# ---------------------------------------------------------------------------
#  K5: the forward's window schedule run backwards in time
# ---------------------------------------------------------------------------
def _rglru_bwd_schedule(a, h, dh, steps=16, warps=16):
    """``csrc/rglru_scan_bwd.cu`` in float64: reversed step s is time
    t = T-1-s with coefficient c = a_{t+1} (0 at the last step), input
    x = dh_t and hp = h_{t-1}.  T <= ``steps`` walks the steps one by one
    (rglru_bwd_steps); longer T runs in windows of ``warps * steps``
    reversed steps, warp w folding its steps into (A_w, B_w), taking its
    carry-in from the block's carry through the pairs before it, then
    replaying (rglru_bwd_windows).  Steps before time 0 are the identity.
    Returns (da, db)."""
    a, h, dh = (torch.as_tensor(x, dtype=torch.float64) for x in (a, h, dh))
    B, T, D = a.shape
    zero = torch.zeros((B, 1, D), dtype=torch.float64)
    c = torch.cat([a[:, 1:], zero], 1).flip(1)
    x = dh.flip(1)
    hp = torch.cat([zero, h[:, :-1]], 1).flip(1)
    g = torch.empty_like(c)
    if T <= steps:
        carry = torch.zeros((B, D), dtype=torch.float64)
        for s in range(T):
            carry = c[:, s] * carry + x[:, s]
            g[:, s] = carry
    else:
        L = steps * warps
        nwin = -(-T // L)
        pad = (0, 0, 0, nwin * L - T)
        cp = torch.nn.functional.pad(c, pad, value=1.0)
        xp = torch.nn.functional.pad(x, pad, value=0.0)
        cp, xp = (y.reshape(B, nwin, warps, steps, D) for y in (cp, xp))
        gp = torch.empty_like(cp)
        carry = torch.zeros((B, D), dtype=torch.float64)
        for wi in range(nwin):
            A = torch.ones((B, warps, D), dtype=torch.float64)
            Bw = torch.zeros((B, warps, D), dtype=torch.float64)
            for i in range(steps):                    # 1. fold
                A = A * cp[:, wi, :, i]
                Bw = cp[:, wi, :, i] * Bw + xp[:, wi, :, i]
            cin = []
            for w in range(warps):                    # 2. carry in and out
                cin.append(carry)
                carry = A[:, w] * carry + Bw[:, w]
            gw = torch.stack(cin, dim=1)
            for i in range(steps):                    # 3. replay
                gw = cp[:, wi, :, i] * gw + xp[:, wi, :, i]
                gp[:, wi, :, i] = gw
        g = gp.reshape(B, nwin * L, D)[:, :T]
    return (g * hp).flip(1), g.flip(1)


def _rglru_case(B, T, D, a_kind):
    a = {"sigmoid": 1 / (1 + np.exp(-seeded(20, B, T, D))),
         "1e-4": np.full((B, T, D), 1e-4),
         "0.999": np.full((B, T, D), 0.999)}[a_kind]
    b, dh = seeded(21, B, T, D), seeded(22, B, T, D)
    h = np.zeros_like(a)                       # the forward, in float64
    for t in range(T):
        h[:, t] = a[:, t] * (h[:, t - 1] if t else 0.0) + b[:, t]
    return a, b, h, dh


def _rglru_plain_backward(a, b, dh):
    """``ref.rglru_scan_backward`` in float32 from float32 inputs, with h
    from ``ref.rglru_scan``."""
    a, b, dh = (torch.tensor(x, dtype=torch.float32) for x in (a, b, dh))
    return ref.rglru_scan_backward(a, ref.rglru_scan(a, b), dh)


@pytest.mark.parametrize("T,D", [(1, 8), (15, 8), (16, 8), (17, 40),
                                 (257, 33), (300, 33), (4097, 3)])
@pytest.mark.parametrize("a_kind", ["sigmoid", "1e-4", "0.999"])
def test_rglru_backward_schedule(T, D, a_kind):
    """K5's backward schedule: the decode-sized form (T = 1, 15, 16) and
    the reversed windows (T = 17: one window; 257: one step past it; 300:
    two, ragged; 4097: seventeen, one step into the last), a ragged D,
    B = 2, strong decay (a = 1e-4) and long memory (a = 0.999); against
    the plain backward, autograd and ``jax.vjp``."""
    a, b, h, dh = _rglru_case(2, T, D, a_kind)
    got = _rglru_bwd_schedule(a, h, dh)
    close(got, _rglru_plain_backward(a, b, dh), TOL)
    close(got, autograd(ref.rglru_scan, (a, b), (dh,)), TOL)
    close(got, jax_vjp(jref.rglru_scan, (a, b), (dh,)), TOL)


@pytest.mark.parametrize("T,D", [(1, 5), (15, 8), (17, 40), (257, 33)])
@pytest.mark.parametrize("a_kind", ["sigmoid", "1e-4", "0.999"])
def test_rglru_plain_backward(T, D, a_kind):
    """``ref.rglru_scan_backward`` (the explicit reverse scan the card's
    K5 backward is held to) against autograd of ``ref.rglru_scan`` and
    ``jax.vjp`` of the JAX oracle: ragged T and D, B = 3, strong decay and
    long memory; float32 throughout, at 1e-5 of each gradient's scale."""
    a, b, _, dh = _rglru_case(3, T, D, a_kind)
    got = _rglru_plain_backward(a, b, dh)
    assert all(g.dtype == torch.float32 for g in got)
    close(got, autograd(ref.rglru_scan, (a, b), (dh,)), TOL)
    close(got, jax_vjp(jref.rglru_scan, (a, b), (dh,)), TOL)


# ---------------------------------------------------------------------------
#  K3: the rows-masked NT and TN products
# ---------------------------------------------------------------------------
def _gmm_bwd_schedule(x, w, dy, rows, bk=32):
    """``csrc/moe_gmm_bwd.cu`` in float64: dx[e] = dy[e] w[e]^T summed over
    F in stages of ``bk`` with rows c >= rows[e] left zero (the NT
    product); dw[e] = x[e]^T dy[e] summed over the live rows only, in
    stages of ``bk`` (the TN product; no stage at all when rows[e] = 0)."""
    x, w, dy = (torch.as_tensor(t, dtype=torch.float64) for t in (x, w, dy))
    E, C, D = x.shape
    F = w.shape[2]
    dx = torch.zeros((E, C, D), dtype=torch.float64)
    dw = torch.zeros((E, D, F), dtype=torch.float64)
    for e in range(E):
        nv = C if rows is None else min(max(int(rows[e]), 0), C)
        for k0 in range(0, F, bk):
            dx[e, :nv] += dy[e, :nv, k0:k0 + bk] @ w[e, :, k0:k0 + bk].T
        for k0 in range(0, nv, bk):
            k1 = min(k0 + bk, nv)
            dw[e] += x[e, k0:k1].T @ dy[e, k0:k1]
    return dx, dw


@pytest.mark.parametrize("E,C,D,F", [(3, 1, 24, 8), (4, 37, 40, 19),
                                     (2, 130, 33, 70)])
@pytest.mark.parametrize("kind", [None, "partial", "zero"])
def test_moe_gmm_backward_schedule(E, C, D, F, kind):
    """K3's backward: C = 1, 37 and 130 (ragged against the 32-deep stages
    and the 128-row tiles), ragged D and F, rows None (all C), 0, 1,
    C - 1 and C by expert, and no live row at all."""
    x, w, dy = seeded(30, E, C, D), seeded(31, E, D, F), seeded(32, E, C, F)
    rows = None if kind is None else np.array(
        [0] * E if kind == "zero" else
        [(0, 1, C - 1, C)[e % 4] for e in range(E)], np.int32)
    got = _gmm_bwd_schedule(x, w, dy, rows)
    r = None if rows is None else torch.from_numpy(rows)
    close(got, autograd(lambda a, b: ref.moe_gmm(a, b, r), (x, w), (dy,)),
          TOL)
    live = np.ones((E, C), bool) if rows is None else \
        np.arange(C)[None, :] < rows[:, None]

    def masked(a, b):
        return jnp.where(live[..., None], jref.moe_gmm(a, b), 0.0)
    close(got, jax_vjp(masked, (x, w), (dy,)), TOL)
    close(got, ref.moe_gmm_backward(*(torch.tensor(t) for t in (x, w, dy)),
                                    r), TOL)
    if rows is not None:                  # dead rows pass no gradient
        assert not got[0].numpy()[~live].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", [None, "partial", "zero"])
@pytest.mark.parametrize("E,C,D,F", [(3, 1, 24, 8), (4, 37, 40, 19)])
def test_moe_gmm_plain_backward(E, C, D, F, kind, dtype):
    """``ref.moe_gmm_backward`` (the explicit dx = dy w^T, dw = x^T dy over
    the live rows the card's K3 backward is held to) against autograd of
    ``ref.moe_gmm`` and, in float32, ``jax.vjp`` of the JAX oracle with
    the dead rows masked: ragged C, D and F, rows None, 0/1/C-1/C by
    expert (so an expert with none) and none at all.  The gradients come
    back in the inputs' dtype; in bf16 each is the same float32 sum
    rounded once, so it equals autograd's to one bf16 step."""
    dt = getattr(torch, dtype)
    x, w, dy = (torch.tensor(seeded(s, *shape), dtype=torch.float32).to(dt)
                for s, shape in ((33, (E, C, D)), (34, (E, D, F)),
                                 (35, (E, C, F))))
    rows = None if kind is None else torch.tensor(
        [0] * E if kind == "zero" else
        [(0, 1, C - 1, C)[e % 4] for e in range(E)], dtype=torch.int32)
    got = ref.moe_gmm_backward(x, w, dy, rows)
    assert got[0].dtype == dt and got[1].dtype == dt
    leaves = [t.detach().requires_grad_(True) for t in (x, w)]
    want = torch.autograd.grad(ref.moe_gmm(*leaves, rows), leaves, dy)
    close(got, want, TOL if dtype == "float32" else 2 ** -7)
    if dtype == "float32":
        live = np.ones((E, C), bool) if rows is None else \
            np.arange(C)[None, :] < rows.numpy()[:, None]

        def masked(a, b):
            return jnp.where(live[..., None], jref.moe_gmm(a, b), 0.0)
        close(got, jax_vjp(masked, (x.numpy(), w.numpy()), (dy.numpy(),)),
              TOL)
    if rows is not None:
        assert not got[1][rows == 0].any()   # an empty expert: dw zeros


def _gmm_bwd_wgmma_schedule(x, w, dy, rows, bm=128, bk=64):
    """``csrc/moe_gmm_bwd.cu``'s wgmma kernel in float64: dx in tiles of
    ``bm`` rows, a tile wholly past rows[e] zeros without a product, the
    rows of a tile past rows[e] written as zeros, F in stages of ``bk``;
    dw over ceil(rows[e] / bk) stages of ``bk`` rows of C, the last one's
    rows c >= rows[e] zeroed in both x and dy before its product."""
    x, w, dy = (torch.as_tensor(t, dtype=torch.float64) for t in (x, w, dy))
    E, C, D = x.shape
    F = w.shape[2]
    dx = torch.zeros((E, C, D), dtype=torch.float64)
    dw = torch.zeros((E, D, F), dtype=torch.float64)
    for e in range(E):
        nv = C if rows is None else min(max(int(rows[e]), 0), C)
        for m0 in range(0, min(nv, C), bm):
            acc = torch.zeros((min(bm, C - m0), D), dtype=torch.float64)
            for k0 in range(0, F, bk):
                acc += dy[e, m0:m0 + bm, k0:k0 + bk] @ w[e, :, k0:k0 + bk].T
            acc[max(nv - m0, 0):] = 0
            dx[e, m0:m0 + bm] = acc
        for k0 in range(0, nv, bk):
            xs, ds = x[e, k0:k0 + bk].clone(), dy[e, k0:k0 + bk].clone()
            xs[nv - k0:] = 0
            ds[nv - k0:] = 0
            dw[e] += xs.T @ ds
    return dx, dw


@pytest.mark.parametrize("E,C,D,F", [(3, 1, 24, 8), (4, 37, 40, 19),
                                     (2, 130, 33, 70), (8, 200, 16, 24)])
@pytest.mark.parametrize("kind", [None, "partial", "zero", "odd"])
def test_moe_gmm_wgmma_backward_schedule(E, C, D, F, kind):
    """K3's backward on wgmma: 128-row tiles of dx and 64-deep stages, the
    last dw stage's dead rows zeroed in shared memory; C = 1, 37, 130 and
    200 (ragged against both), rows None, 0, 1, C - 1 and C by expert,
    none, and "odd" counts (65, 100, 63, 130, ... cut at C) that end
    inside a stage."""
    x, w, dy = seeded(36, E, C, D), seeded(37, E, D, F), seeded(38, E, C, F)
    pattern = {"partial": (0, 1, C - 1, C),
               "odd": (65, 100, 0, 63, 130, 1, 199, 64)}
    rows = None if kind is None else np.array(
        [0] * E if kind == "zero" else
        [min(C, pattern[kind][e % len(pattern[kind])]) for e in range(E)],
        np.int32)
    got = _gmm_bwd_wgmma_schedule(x, w, dy, rows)
    r = None if rows is None else torch.from_numpy(rows)
    close(got, autograd(lambda a, b: ref.moe_gmm(a, b, r), (x, w), (dy,)),
          TOL)
    live = np.ones((E, C), bool) if rows is None else \
        np.arange(C)[None, :] < rows[:, None]

    def masked(a, b):
        return jnp.where(live[..., None], jref.moe_gmm(a, b), 0.0)
    close(got, jax_vjp(masked, (x, w), (dy,)), TOL)
    close(got, ref.moe_gmm_backward(*(torch.tensor(t) for t in (x, w, dy)),
                                    r), TOL)
    if rows is not None:                  # dead rows pass no gradient
        assert not got[0].numpy()[~live].any()
        assert not got[1].numpy()[rows == 0].any()


# ---------------------------------------------------------------------------
#  K2: dK / dV with a group's query heads split across blocks
# ---------------------------------------------------------------------------
def _attn_bwd_split_schedule(q, k, v, dout, causal, window, splits,
                             tile=64):
    """``csrc/flash_attention_bwd.cu``'s (b), (s) and (c) in float64: a
    dK/dV block owns ``tile`` keys of one kv head and split z's G / splits
    query heads, and sums dS^T q and P^T dout over those heads and the
    query tiles of ``tile`` rows; the splits' partials are then added in
    order z = 0, 1, ..; dq sums dS k over key tiles.  P is recomputed from
    the logsumexp and masked entries are exactly 0."""
    q, k, v, dout = (torch.as_tensor(t, dtype=torch.float64)
                     for t in (q, k, v, dout))
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    qi, kj = torch.arange(T)[:, None], torch.arange(S)[None, :]
    vis = torch.ones((T, S), dtype=torch.bool)
    if causal:
        vis &= kj <= qi + S - T
    if window:
        vis &= kj > qi + S - T - window
    kf, vf = k[:, torch.arange(H) // G], v[:, torch.arange(H) // G]
    s = (q @ kf.transpose(-1, -2) * scale).masked_fill(~vis, -torch.inf)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    p = torch.where(vis, p, 0.0)
    D = (dout * (p @ vf)).sum(-1, keepdim=True)
    ds = p * (dout @ vf.transpose(-1, -2) - D)
    dq = torch.zeros_like(q)
    for k0 in range(0, S, tile):
        dq += ds[..., k0:k0 + tile] @ kf[:, :, k0:k0 + tile] * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for kvh in range(Hkv):
            for k0 in range(0, S, tile):
                parts = []
                for z in range(splits):
                    pk = torch.zeros_like(k[b, kvh, k0:k0 + tile])
                    pv = torch.zeros_like(pk)
                    for h in range(kvh * G + z * G // splits,
                                   kvh * G + (z + 1) * G // splits):
                        for q0 in range(0, T, tile):
                            rq = slice(q0, q0 + tile)
                            pk += ds[b, h, rq, k0:k0 + tile].T @ q[b, h, rq]
                            pv += p[b, h, rq, k0:k0 + tile].T @ dout[b, h, rq]
                    parts.append((pk * scale, pv))
                for pk, pv in parts:
                    dk[b, kvh, k0:k0 + tile] += pk
                    dv[b, kvh, k0:k0 + tile] += pv
    return dq, dk, dv


@pytest.mark.parametrize("B,H,Hkv,T,S,causal,window,splits", [
    (2, 8, 2, 130, 130, True, 0, 2), (1, 8, 1, 70, 150, True, 0, 4),
    (1, 8, 1, 70, 150, True, 0, 8), (2, 4, 1, 100, 100, True, 40, 2),
    (1, 6, 2, 50, 90, False, 0, 3), (1, 4, 1, 64, 64, True, 0, 1)])
def test_flash_attention_backward_split_schedule(B, H, Hkv, T, S, causal,
                                                 window, splits):
    """K2's backward with G / splits heads a dK/dV block and the partials
    summed in order: ragged T and S against the 64-key and 64-query
    tiles, T < S, a window, full attention, GQA and MQA, 1 to G splits;
    held against ``ref.attention_backward`` (on ``ref.attention_lse``'s
    out and lse), autograd of ``ref.attention`` and, without a window,
    ``jax.vjp`` of the JAX oracle."""
    hd = 32
    q, dout = seeded(40, B, H, T, hd), seeded(41, B, H, T, hd)
    k, v = seeded(42, B, Hkv, S, hd), seeded(43, B, Hkv, S, hd)
    got = _attn_bwd_split_schedule(q, k, v, dout, causal, window, splits)
    tq, tk, tv, tdo = (torch.tensor(t, dtype=torch.float32)
                       for t in (q, k, v, dout))
    out, lse = ref.attention_lse(tq, tk, tv, causal=causal, window=window)
    close(got, ref.attention_backward(tq, tk, tv, out, lse, tdo,
                                      causal=causal, window=window), TOL)
    close(got, autograd(lambda a, b, c: ref.attention(
        a, b, c, causal=causal, window=window), (q, k, v), (dout,)), TOL)
    if not window:
        close(got, jax_vjp(lambda a, b, c: jref.attention(
            a, b, c, causal=causal), (q, k, v), (dout,)), TOL)


def _query_tiles(T, S, causal, window, k0, bk, bq):
    """``query_tiles<bk, bq>``: the first query tile and the number of
    tiles of ``bq`` rows a dK/dV block of keys [k0, k0 + bk) walks."""
    off = S - T
    qbeg = (max(0, k0 - off) if causal else 0) // bq * bq
    qend = T
    if window:
        qend = min(qend, min(k0 + bk, S) - 1 - off + window)
    return qbeg, -(-(qend - qbeg) // bq) if qend > qbeg else 0


def _key_tiles(T, S, causal, window, q0, bk, bq):
    """``key_tiles<bk, bq>``: the first key tile and the number of tiles
    of ``bk`` keys a dQ block of queries [q0, q0 + bq) walks."""
    off = S - T
    kend = min(S, min(q0 + bq, T) - 1 + off + 1) if causal else S
    kbeg = max(0, (q0 + off - window + 1) // bk * bk) if window else 0
    return kbeg, -(-(kend - kbeg) // bk) if kend > kbeg else 0


def _attn_bwd_wgmma_schedule(q, k, v, dout, causal, window, splits):
    """``csrc/flash_attention_bwd.cu``'s wgmma kernels in float64: a dK/dV
    block owns 128 keys of one kv head, in two halves of 64 (its consumer
    warpgroups), and split z's G / splits query heads; it walks (head,
    query tile of 64) over the tiles ``query_tiles<128, 64>`` names, the
    splits' partials then added in order z = 0, 1, ..  A dQ block owns 128
    queries of one head in two halves of 64 and walks the key tiles of 64
    that ``key_tiles<64, 128>`` names.  Every (query, key) pair a block
    skips is asserted to be masked.  P is recomputed from the logsumexp
    and masked entries are exactly 0."""
    q, k, v, dout = (torch.as_tensor(t, dtype=torch.float64)
                     for t in (q, k, v, dout))
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    qi, kj = torch.arange(T)[:, None], torch.arange(S)[None, :]
    vis = torch.ones((T, S), dtype=torch.bool)
    if causal:
        vis &= kj <= qi + S - T
    if window:
        vis &= kj > qi + S - T - window
    kf, vf = k[:, torch.arange(H) // G], v[:, torch.arange(H) // G]
    s = (q @ kf.transpose(-1, -2) * scale).masked_fill(~vis, -torch.inf)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    p = torch.where(vis, p, 0.0)
    D = (dout * (p @ vf)).sum(-1, keepdim=True)
    ds = p * (dout @ vf.transpose(-1, -2) - D)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for kvh in range(Hkv):
            for k0 in range(0, S, 128):
                qbeg, nq = _query_tiles(T, S, causal, window, k0, 128, 64)
                walked = torch.zeros((T, S), dtype=torch.bool)
                walked[qbeg:qbeg + 64 * nq, k0:k0 + 128] = True
                assert not (vis[:, k0:k0 + 128]
                            & ~walked[:, k0:k0 + 128]).any()
                parts = []
                for z in range(splits):
                    pk = torch.zeros_like(k[b, kvh, k0:k0 + 128])
                    pv = torch.zeros_like(pk)
                    for h in range(kvh * G + z * G // splits,
                                   kvh * G + (z + 1) * G // splits):
                        for q0 in range(qbeg, qbeg + 64 * nq, 64):
                            rq = slice(q0, q0 + 64)
                            for half in range(2):         # warpgroups
                                lo = k0 + 64 * half
                                rk = slice(lo, lo + 64)
                                pk[64 * half:64 * half + 64] += \
                                    ds[b, h, rq, rk].T @ q[b, h, rq]
                                pv[64 * half:64 * half + 64] += \
                                    p[b, h, rq, rk].T @ dout[b, h, rq]
                    parts.append((pk * scale, pv))
                for pk, pv in parts:
                    n = pk.shape[0]
                    dk[b, kvh, k0:k0 + n] += pk
                    dv[b, kvh, k0:k0 + n] += pv
    dq = torch.zeros_like(q)
    for q0 in range(0, T, 128):
        kbeg, nk = _key_tiles(T, S, causal, window, q0, 64, 128)
        walked = torch.zeros((T, S), dtype=torch.bool)
        walked[q0:q0 + 128, kbeg:kbeg + 64 * nk] = True
        assert not (vis[q0:q0 + 128] & ~walked[q0:q0 + 128]).any()
        for k0 in range(kbeg, kbeg + 64 * nk, 64):
            rk = slice(k0, k0 + 64)
            for half in range(2):
                rq = slice(q0 + 64 * half, q0 + 64 * half + 64)
                dq[:, :, rq] += ds[:, :, rq, rk] @ kf[:, :, rk] * scale
    return dq, dk, dv


@pytest.mark.parametrize("B,H,Hkv,T,S,causal,window,splits", [
    (2, 8, 2, 130, 130, True, 0, 1), (2, 8, 2, 130, 130, True, 0, 2),
    (1, 8, 1, 70, 300, True, 0, 4), (1, 8, 1, 70, 150, True, 0, 8),
    (2, 4, 1, 200, 200, True, 40, 2), (1, 4, 1, 300, 300, True, 150, 1),
    (1, 6, 2, 50, 90, False, 0, 3), (1, 4, 4, 256, 256, True, 0, 1),
    (1, 16, 1, 129, 257, False, 0, 16)])
def test_flash_attention_backward_wgmma_schedule(B, H, Hkv, T, S, causal,
                                                 window, splits):
    """K2's backward on wgmma at hd 128: 128-key dK/dV blocks in two 64-key
    halves over 64-query tiles, 128-query dQ blocks over 64-key tiles,
    G / splits heads a dK/dV block and the partials summed in order;
    ragged T and S against both tile sizes, T < S, windows shorter and
    longer than a tile, full attention, GQA, MQA and one head a group;
    held against ``ref.attention_backward`` (on ``ref.attention_lse``'s
    out and lse), autograd of ``ref.attention`` and, without a window,
    ``jax.vjp`` of the JAX oracle.  The mirror runs at hd 32: the head
    dim is summed whole inside every product, so the tiling under test
    does not depend on it."""
    hd = 32
    q, dout = seeded(44, B, H, T, hd), seeded(45, B, H, T, hd)
    k, v = seeded(46, B, Hkv, S, hd), seeded(47, B, Hkv, S, hd)
    got = _attn_bwd_wgmma_schedule(q, k, v, dout, causal, window, splits)
    tq, tk, tv, tdo = (torch.tensor(t, dtype=torch.float32)
                       for t in (q, k, v, dout))
    out, lse = ref.attention_lse(tq, tk, tv, causal=causal, window=window)
    close(got, ref.attention_backward(tq, tk, tv, out, lse, tdo,
                                      causal=causal, window=window), TOL)
    close(got, autograd(lambda a, b, c: ref.attention(
        a, b, c, causal=causal, window=window), (q, k, v), (dout,)), TOL)
    if not window:
        close(got, jax_vjp(lambda a, b, c: jref.attention(
            a, b, c, causal=causal), (q, k, v), (dout,)), TOL)


# ---------------------------------------------------------------------------
#  K4: the reverse chunk scan
# ---------------------------------------------------------------------------
def _rwkv_bwd_schedule(r, k, v, logw, u, S0, do, dST, chunk=64):
    """``csrc/rwkv_scan_bwd.cu`` in float64, per (b, h), in chunks of
    ``chunk`` steps with cs the inclusive cumsum of logw in the chunk:
      1. each chunk's q_in^T do and decay e^{cs_last};
      2. from dS_T back, dS_c = e^{cs_last,c} dS_c+1 + q_in^T do_c, so that
         chunk c has the gradient of its end state and dS0 comes out;
      3. per chunk, from the chunk-start state S_c (run forward here, as
         the forward's state_scan leaves them) and dS' = e^{cs_last} dS_c+1:
         dr, dk, dv, the chunk's part of du, and
         dlogw_t = sum_{i>t} X_i - sum_{i>=t} Y_i + sum_{s<t} Z_s + Dm;
      4. du summed over b and the chunks.
    Returns (dr, dk, dv, dlogw, du, dS0)."""
    f = [torch.as_tensor(t, dtype=torch.float64)
         for t in (r, k, v, logw, u, do)]
    r, k, v, logw, u, do = f
    B, H, T, M = r.shape
    dST = torch.zeros((B, H, M, M), dtype=torch.float64) if dST is None \
        else torch.as_tensor(dST, dtype=torch.float64)
    S = torch.zeros((B, H, M, M), dtype=torch.float64) if S0 is None \
        else torch.as_tensor(S0, dtype=torch.float64)
    starts = list(range(0, T, chunk))
    cs = [torch.cumsum(logw[:, :, t0:t0 + chunk], 2) for t0 in starts]
    q_in = [r[:, :, t0:t0 + chunk] * torch.exp(c - logw[:, :, t0:t0 + chunk])
            for t0, c in zip(starts, cs)]
    k_in = [k[:, :, t0:t0 + chunk] * torch.exp(-c) for t0, c in
            zip(starts, cs)]
    dec = [torch.exp(c[:, :, -1]) for c in cs]                 # (B,H,M)
    S_c = []                          # chunk-start states, forward
    for i, t0 in enumerate(starts):
        S_c.append(S)
        k_tail = k_in[i] * dec[i][:, :, None, :]
        S = dec[i][..., None] * S + torch.einsum(
            "bhtm,bhtj->bhmj", k_tail, v[:, :, t0:t0 + chunk])
    dS_end = [None] * len(starts)     # 1 and 2: the reverse scan
    G = dST
    for i in reversed(range(len(starts))):
        t0 = starts[i]
        dS_end[i] = G
        G = dec[i][..., None] * G + torch.einsum(
            "bhtm,bhtj->bhmj", q_in[i], do[:, :, t0:t0 + chunk])
    dS0 = G
    out = [torch.zeros_like(r) for _ in range(4)]
    dr, dk, dv, dlogw = out
    du = torch.zeros((H, M), dtype=torch.float64)
    for i, t0 in enumerate(starts):   # 3: each chunk
        sl = slice(t0, t0 + chunk)
        n = min(chunk, T - t0)
        rr, kk, vv, oo = r[:, :, sl], k[:, :, sl], v[:, :, sl], do[:, :, sl]
        qi, ki = q_in[i], k_in[i]
        lower = torch.ones((n, n), dtype=torch.bool).tril(-1)
        A = torch.einsum("bhtm,bhsm->bhts", qi, ki) * lower
        P = torch.einsum("bhtj,bhsj->bhts", oo, vv) * lower
        bu = (rr * u[None, :, None, :] * kk).sum(-1)           # r . u . k
        dd = (vv * oo).sum(-1)                                 # v . do
        dSp = dec[i][..., None] * dS_end[i]                    # dS'
        dq = torch.einsum("bhtj,bhmj->bhtm", oo, S_c[i]) + P @ ki
        dki = P.transpose(-1, -2) @ qi
        dkt = torch.einsum("bhtj,bhmj->bhtm", vv, dSp)
        ucast = u[None, :, None, :]
        cprev = torch.cat([torch.zeros_like(cs[i][:, :, :1]),
                           cs[i][:, :, :-1]], 2)
        dr[:, :, sl] = torch.exp(cprev) * dq + ucast * kk * dd[..., None]
        dk[:, :, sl] = torch.exp(-cs[i]) * (dki + dkt) \
            + rr * ucast * dd[..., None]
        dv[:, :, sl] = ki @ dSp + A.transpose(-1, -2) @ oo \
            + bu[..., None] * oo
        du += (rr * kk * dd[..., None]).sum((0, 2))
        X, Y, Z = qi * dq, ki * dki, ki * dkt
        Dm = (dSp * S_c[i]).sum(-1)                            # (B,H,M)
        x_after = X.flip(2).cumsum(2).flip(2) - X              # sum_{i>t}
        y_from = Y.flip(2).cumsum(2).flip(2)                   # sum_{i>=t}
        z_before = Z.cumsum(2) - Z                             # sum_{s<t}
        dlogw[:, :, sl] = x_after - y_from + z_before + Dm[:, :, None, :]
    return dr, dk, dv, dlogw, du, dS0


def _rwkv_case(B, H, T, M, seed=40):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal
    logw = -0.105 / (1 + np.exp(-g((B, H, T, M))))      # the model's bound
    return dict(r=g((B, H, T, M)), k=g((B, H, T, M)), v=g((B, H, T, M)),
                logw=logw, u=g((H, M)) * 0.1, S0=g((B, H, M, M)) * 0.5,
                do=g((B, H, T, M)), dST=g((B, H, M, M)) * 0.5)


@pytest.mark.parametrize("T,M", [(1, 8), (63, 16), (64, 8), (130, 8)])
def test_rwkv_backward_schedule(T, M):
    """K4's backward: the decode step (T = 1, one chunk of one step), one
    chunk, its edge and three chunks (130: ragged), B = 2, H = 3, from an
    S0 with a non-zero gradient dS_T of the final state: dr, dk, dv, dlogw,
    du and dS0 against autograd of ``ref.rwkv_scan``; from zeros and
    against ``jax.vjp`` of the JAX oracle (dS0 aside)."""
    c = _rwkv_case(2, 3, T, M)
    ins = (c["r"], c["k"], c["v"], c["logw"], c["u"])
    got = _rwkv_bwd_schedule(*ins, c["S0"], c["do"], c["dST"])
    close(got, autograd(ref.rwkv_scan, ins + (c["S0"],),
                        (c["do"], c["dST"])), TOL)
    close(got, _rwkv_plain_backward(c, with_s0=True), TOL)
    got = _rwkv_bwd_schedule(*ins, None, c["do"], c["dST"])[:5]
    close(got, jax_vjp(jref.rwkv_scan, ins, (c["do"], c["dST"])), TOL)


def _rwkv_plain_backward(c, with_s0, with_dst=True):
    """``ref.rwkv_scan_backward`` in float32 on case ``c``."""
    f = {n: torch.tensor(x, dtype=torch.float32) for n, x in c.items()}
    return ref.rwkv_scan_backward(
        f["r"], f["k"], f["v"], f["logw"], f["u"],
        f["S0"] if with_s0 else None, f["do"],
        f["dST"] if with_dst else None)


@pytest.mark.parametrize("T,M,decay", [(1, 8, "model"), (37, 16, "model"),
                                       (70, 5, "strong"), (70, 8, "weak")])
def test_rwkv_plain_backward(T, M, decay):
    """``ref.rwkv_scan_backward`` (the explicit step-form formulas the
    card's K4 backward is held to) against autograd of ``ref.rwkv_scan``
    from an S0 with a non-zero gradient of the final state (dS0 too), and
    against ``jax.vjp`` of the JAX oracle from zeros: the decode step,
    ragged T and M, logw in the model's range [-0.105, 0], strong decay
    (logw near -3) and weak (near 0); B = 2, H = 3; float32, at 1e-5 of
    each gradient's scale."""
    c = _rwkv_case(2, 3, T, M, seed=42)
    if decay != "model":
        g = np.random.default_rng(43).uniform(size=c["logw"].shape)
        c["logw"] = -3.0 - g if decay == "strong" else -1e-3 * g
    ins = (c["r"], c["k"], c["v"], c["logw"], c["u"])
    got = _rwkv_plain_backward(c, with_s0=True)
    assert [g.dtype for g in got] == [torch.float32] * 6
    close(got, autograd(ref.rwkv_scan, ins + (c["S0"],),
                        (c["do"], c["dST"])), TOL)
    got = _rwkv_plain_backward(c, with_s0=False)
    assert got[5] is None
    close(got[:5], jax_vjp(jref.rwkv_scan, ins, (c["do"], c["dST"])), TOL)
    got = _rwkv_plain_backward(c, with_s0=False, with_dst=False)
    close(got[:5], jax_vjp(jref.rwkv_scan, ins,
                           (c["do"], np.zeros_like(c["dST"]))), TOL)


def test_rwkv_backward_schedule_without_final_state_gradient():
    """dS_T = None (the model's training loss ignores the final state) is
    zeros: the same gradients as autograd with a zero cotangent."""
    c = _rwkv_case(1, 2, 100, 8, seed=41)
    ins = (c["r"], c["k"], c["v"], c["logw"], c["u"], c["S0"])
    got = _rwkv_bwd_schedule(*ins, c["do"], None)
    close(got, autograd(ref.rwkv_scan, ins,
                        (c["do"], np.zeros((1, 2, 8, 8)))), TOL)


# ---------------------------------------------------------------------------
#  K4 on the tensor cores: the channel and value parts of each chunk
# ---------------------------------------------------------------------------
def _tf32(x):
    """x (float64) rounded to float32, then to TF32 (10 mantissa bits,
    round to nearest, ties away from zero: ``cvt.rna.tf32.f32``)."""
    bits = x.to(torch.float32).view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32).to(torch.float64)


def _bf16(x):
    """x (float64) rounded to float32, then to bf16 (round to nearest
    even: ``__floats2bfloat162_rn``)."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def _mm_exact(a, b):
    return a @ b


def _mm_tf32(a, b):
    """One TF32 product: both operands rounded, sums in float64."""
    return _tf32(a) @ _tf32(b)


def _mm_bf16(a, b):
    """One bf16 product: both operands rounded, sums in float64."""
    return _bf16(a) @ _bf16(b)


def _mm_split_bf16(a, b):
    """The kernel's split bf16: x = hi + lo, both bf16 (lo the rest of x
    rounded), and a b as lo_a hi_b + hi_a lo_b + hi_a hi_b."""
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a.to(torch.float32).double() - ah), \
        _bf16(b.to(torch.float32).double() - bh)
    return al @ bh + ah @ bl + ah @ bh


def _rwkv_bwd_parts_schedule(r, k, v, logw, u, S0, do, dST, mm=_mm_exact,
                             chunk=64):
    """``csrc/rwkv_scan_bwd.cu``'s bf16 kernels in float64, every product
    through ``mm`` (exact, or TF32 emulated): per chunk, q_in^T do for the
    reverse scan of the chunk-state gradients (as ``_rwkv_bwd_schedule``),
    then two parts, each summing only inside itself:
      the channel part: P = strict_lower(do v^T), once, then dq_in =
        do S_c^T + P k_in, dk_in = P^T q_in and v dS'^T; dr, dk, dlogw
        and du;
      the value part: A = strict_lower(q_in k_in^T), once, then dv =
        k_in dS' + A^T do + (r.u.k) do.
    P and A pass through ``mm``'s rounding once, as the kernel keeps them
    (split) in shared memory and reads P^T and A^T from the same tiles.
    Returns (dr, dk, dv, dlogw, du, dS0)."""
    f = [torch.as_tensor(t, dtype=torch.float64)
         for t in (r, k, v, logw, u, do)]
    r, k, v, logw, u, do = f
    B, H, T, M = r.shape
    dST = torch.zeros((B, H, M, M), dtype=torch.float64) if dST is None \
        else torch.as_tensor(dST, dtype=torch.float64)
    S = torch.zeros((B, H, M, M), dtype=torch.float64) if S0 is None \
        else torch.as_tensor(S0, dtype=torch.float64)
    starts = list(range(0, T, chunk))
    cs = [torch.cumsum(logw[:, :, t0:t0 + chunk], 2) for t0 in starts]
    q_in = [r[:, :, t0:t0 + chunk] * torch.exp(c - logw[:, :, t0:t0 + chunk])
            for t0, c in zip(starts, cs)]
    k_in = [k[:, :, t0:t0 + chunk] * torch.exp(-c) for t0, c in
            zip(starts, cs)]
    dec = [torch.exp(c[:, :, -1]) for c in cs]
    S_c = []
    for i, t0 in enumerate(starts):
        S_c.append(S)
        S = dec[i][..., None] * S + (k_in[i] * dec[i][:, :, None, :]) \
            .transpose(-1, -2) @ v[:, :, t0:t0 + chunk]
    dS_end, G = [None] * len(starts), dST
    for i in reversed(range(len(starts))):
        dS_end[i] = G
        G = dec[i][..., None] * G + mm(q_in[i].transpose(-1, -2),
                                       do[:, :, starts[i]:starts[i] + chunk])
    dS0 = G
    dr, dk, dv, dlogw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros((H, M), dtype=torch.float64)
    for i, t0 in enumerate(starts):
        sl = slice(t0, t0 + chunk)
        n = min(chunk, T - t0)
        rr, kk, vv, oo = r[:, :, sl], k[:, :, sl], v[:, :, sl], do[:, :, sl]
        qi, ki, c = q_in[i], k_in[i], cs[i]
        lower = torch.ones((n, n), dtype=torch.bool).tril(-1)
        dSp = dec[i][..., None] * dS_end[i]
        dd = (vv * oo).sum(-1)                                  # v . do
        P = mm(oo, vv.transpose(-1, -2)) * lower
        PT = P.transpose(-1, -2)
        cprev = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], 2)
        dq = mm(oo, S_c[i].transpose(-1, -2)) + mm(P, ki)   # channel part
        dki = mm(PT, qi)
        dkt = mm(vv, dSp.transpose(-1, -2))
        uc = u[None, :, None, :]
        dr[:, :, sl] = torch.exp(cprev) * dq + uc * kk * dd[..., None]
        dk[:, :, sl] = torch.exp(-c) * (dki + dkt) + rr * uc * dd[..., None]
        du += (rr * kk * dd[..., None]).sum((0, 2))
        X, Y, Z = qi * dq, ki * dki, ki * dkt
        Dm = (dSp * S_c[i]).sum(-1)
        dlogw[:, :, sl] = (X.flip(2).cumsum(2).flip(2) - X
                           - Y.flip(2).cumsum(2).flip(2)
                           + Z.cumsum(2) - Z + Dm[:, :, None, :])
        AT = (mm(qi, ki.transpose(-1, -2)) * lower).transpose(-1, -2)
        bu = (rr * u[None, :, None, :] * kk).sum(-1)            # r . u . k
        dv[:, :, sl] = mm(ki, dSp) + mm(AT, oo) + bu[..., None] * oo
    return dr, dk, dv, dlogw, du, dS0


@pytest.mark.parametrize("T,M", [(1, 8), (63, 16), (64, 64), (130, 8),
                                 (200, 37)])
def test_rwkv_backward_parts_schedule(T, M):
    """K4's backward on the tensor cores, its channel and value parts in
    float64: the decode step, one chunk, a full head of 64, three
    chunks (130: ragged) and an odd head size, B = 2, H = 3, from an S0
    with a non-zero gradient of the final state: dr, dk, dv, dlogw, du and
    dS0 against autograd of ``ref.rwkv_scan``; from zeros against ``jax.vjp``
    of the JAX oracle (dS0 aside)."""
    c = _rwkv_case(2, 3, T, M, seed=48)
    ins = (c["r"], c["k"], c["v"], c["logw"], c["u"])
    got = _rwkv_bwd_parts_schedule(*ins, c["S0"], c["do"], c["dST"])
    close(got, autograd(ref.rwkv_scan, ins + (c["S0"],),
                        (c["do"], c["dST"])), TOL)
    got = _rwkv_bwd_parts_schedule(*ins, None, c["do"], c["dST"])[:5]
    close(got, jax_vjp(jref.rwkv_scan, ins, (c["do"], c["dST"])), TOL)


def _scaled(got, want):
    return [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]


def test_rwkv_backward_operand_rounding():
    """Why the kernel splits each bf16 operand: at rwkv6-3b's head size
    (M = 64) and the model's logw bound (logw in [-0.105, 0], so factors
    e^{-cs} up to e^6.7 inside a chunk), from bf16 r, k, v, the products
    of the parts schedule with operands rounded to bf16 once leave dlogw,
    whose r- and k-side sums cancel, outside the float32 tolerance (2e-3
    of its scale) that its CUDA-core kernel met, and operands rounded to
    TF32 once keep every gradient inside it; in split bf16 every gradient
    is within 1e-4 of its scale of the exact schedule.  (The kernel takes
    split bf16 and not TF32: a TF32 form ran slower on the card.)"""
    c = _rwkv_case(1, 2, 200, 64, seed=49)
    for name in ("r", "k", "v"):                      # bf16 inputs
        c[name] = torch.tensor(c[name]).to(torch.bfloat16).double().numpy()
    ins = (c["r"], c["k"], c["v"], c["logw"], c["u"], c["S0"], c["do"],
           c["dST"])
    exact = _rwkv_bwd_parts_schedule(*ins)
    errs = {name: _scaled(_rwkv_bwd_parts_schedule(*ins, mm=mm), exact)
            for name, mm in (("bf16", _mm_bf16), ("tf32", _mm_tf32),
                             ("split", _mm_split_bf16))}
    assert max(errs["split"]) <= 1e-4, errs
    assert max(errs["tf32"]) <= 2e-3, errs
    assert errs["bf16"][3] > 2e-3, errs
