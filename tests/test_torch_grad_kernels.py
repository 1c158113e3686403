"""The backward kernels' algorithms on the CPU.  The CUDA backwards of K3
``moe_gmm``, K4 ``rwkv_scan`` and K5 ``rglru_scan`` (``csrc/*_bwd.cu``) run
only on the card.  Their plain versions (``ref.*_backward``, explicit
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
