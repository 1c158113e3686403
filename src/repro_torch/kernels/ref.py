"""Plain PyTorch versions of the kernels (the same math as
``repro.kernels.ref``).  The CPU tests use them, ``ops`` takes them for CPU
tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, causal: bool, window: int):
    """Scaled, masked float32 scores (B,Hkv,G,T,S) of q (B,H,T,hd) against
    k (B,Hkv,S,hd); masked entries are ``NEG_INF``."""
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, T, hd).float() * hd ** -0.5
    s = torch.einsum("bkgth,bksh->bkgts", qg, k.float())
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        if window:
            mask &= ~mask.tril(S - T - window)
        s = s.masked_fill(~mask, NEG_INF)
    return s


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,T,hd); k,v: (B,Hkv,S,hd) -> (B,H,T,hd).  The causal mask is
    bottom-right aligned: query i sees key j when j <= i + S - T, and with
    a ``window`` > 0 only when also j > i + S - T - window."""
    return attention_lse(q, k, v, causal=causal, window=window)[0]


def attention_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """``attention`` and the logsumexp of each query row's scaled, masked
    scores: (out (B,H,T,hd) in q.dtype, lse (B,H,T) float32), the ``lse``
    K2's forward writes for its backward."""
    B, H, T, hd = q.shape
    s = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksh->bkgth", p, v.float())
    return (o.reshape(B, H, T, hd).to(q.dtype),
            torch.logsumexp(s, dim=-1).reshape(B, H, T))


def attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                       window: int = 0):
    """The gradients of ``attention`` by the explicit formula K2's backward
    computes, in float32: P = exp(scores - lse), D = rowsum(dout * out),
    dS = P * (dout v^T - D), dq = scale dS k, dk = scale dS^T q and
    dv = P^T dout, dk and dv summed over each group of G = H / Hkv query
    heads.  Returns (dq (B,H,T,hd), dk, dv (B,Hkv,S,hd)) in the inputs'
    dtype."""
    B, H, T, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = hd ** -0.5
    s = _scores(q, k, causal, window)
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, T, 1))
    qf = q.float().reshape(B, Hkv, G, T, hd)
    do = dout.float().reshape(B, Hkv, G, T, hd)
    D = (do * out.float().reshape(B, Hkv, G, T, hd)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgth,bksh->bkgts", do, v.float()) - D)
    dq = torch.einsum("bkgts,bksh->bkgth", ds, k.float()) * scale
    dk = torch.einsum("bkgts,bkgth->bksh", ds, qf) * scale
    dv = torch.einsum("bkgts,bkgth->bksh", p, do)
    return (dq.reshape(B, H, T, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,Hkv,S,hd); lengths: (B,) -> (B,H,hd)."""
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, hd).float() * hd ** -0.5
    s = torch.einsum("bkgh,bksh->bkgs", qg, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def _segments(rows, starts, M: int):
    """(E, M) bool: row i of a packed buffer of M rows belongs to expert e
    when starts[e] <= i < starts[e] + rows[e], the start clamped into
    [0, M] and the count into [0, M - start] (as K3 reads them)."""
    s = starts.long().clamp(0, M)
    end = s + torch.minimum(rows.long().clamp_min(0), M - s)
    i = torch.arange(M, device=rows.device)
    return (i[None, :] >= s[:, None]) & (i[None, :] < end[:, None])


def moe_gmm(x, w, rows=None, starts=None):
    """x: (E,C,D); w: (E,D,F) -> (E,C,F): the products in float32, cast
    to x.dtype.  With ``rows`` (E,) int, rows c >= rows[e] are zeros.

    Ragged, with ``starts`` (E,) int beside ``rows``: x is one packed
    (M, D) buffer whose rows starts[e] .. starts[e] + rows[e] (segments
    that do not overlap) are expert e's, and y is (M, F): x @ w[e] on
    those rows, zeros on rows of no expert.  A masked loop over the
    experts, with static shapes: each expert multiplies every row."""
    if starts is not None:
        seg = _segments(rows, starts, x.shape[0])
        xf = x.float()
        y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                        device=x.device)
        for e in range(w.shape[0]):
            y = torch.where(seg[e][:, None], xf @ w[e].float(), y)
        return y.to(x.dtype)
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
    if rows is None:
        return y
    live = torch.arange(x.shape[1], device=x.device)[None, :] < rows[:, None]
    return torch.where(live[..., None], y, 0)


def moe_gmm_backward(x, w, dy, rows=None, starts=None):
    """The gradients of ``moe_gmm`` by the explicit formula K3's backward
    computes, in float32: with dy zeroed on the rows c >= rows[e] (they
    pass no gradient), dx = dy w^T and dw = x^T dy.  Returns (dx (E,C,D)
    in x.dtype, dw (E,D,F) in w.dtype).  Ragged (``starts``): dx (M, D)
    is dy w[e]^T on expert e's rows and zeros on rows of no expert, and
    dw[e] = x^T dy over expert e's rows only."""
    if starts is not None:
        seg = _segments(rows, starts, x.shape[0])
        xf, dyf = x.float(), dy.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = []
        for e in range(w.shape[0]):
            d = torch.where(seg[e][:, None], dyf, 0)
            dx = torch.where(seg[e][:, None], d @ w[e].float().T, dx)
            dw.append(xf.T @ d)
        return dx.to(x.dtype), torch.stack(dw).to(w.dtype)
    dyf = dy.float()
    if rows is not None:
        live = torch.arange(x.shape[1], device=x.device)[None, :] \
            < rows[:, None]
        dyf = torch.where(live[..., None], dyf, 0)
    dx = torch.einsum("ecf,edf->ecd", dyf, w.float())
    dw = torch.einsum("ecd,ecf->edf", x.float(), dyf)
    return dx.to(x.dtype), dw.to(w.dtype)


def rwkv_scan(r, k, v, logw, u, S0=None):
    """The WKV6 recurrence step by step, from ``S0`` (zeros if None):
        o_t = r_t (S + diag(u) k_t v_t^T);  S = diag(exp(logw_t)) S + k_t v_t^T
    r,k,v,logw: (B,H,T,M); u: (H,M); S0: (B,H,M,M) -> (o (B,H,T,M) f32,
    S (B,H,M,M) f32)."""
    B, H, T, M = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()[None, :, :, None]
    S = torch.zeros((B, H, M, M), dtype=torch.float32, device=r.device) \
        if S0 is None else S0.float()
    os = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        os.append(torch.einsum("bhm,bhmn->bhn", rf[:, :, t], S + uf * kv))
        S = w[:, :, t, :, None] * S + kv
    return torch.stack(os, dim=2), S


def rwkv_scan_backward(r, k, v, logw, u, S0, do, dS=None):
    """The gradients of ``rwkv_scan`` step by step, in float32, by the
    explicit formulas of the recurrence: with the states S_t rerun forward
    from ``S0`` and dS the gradient of S_t, carried back from ``dS`` (the
    gradient of the final state; None: zeros),
        dr_t = (S_{t-1} + diag(u) k_t v_t^T) do_t
        dk_t = r_t u (v_t . do_t) + dS_t v_t
        dv_t = (r_t u k_t)^T 1 do_t + dS_t^T k_t
        dlogw_t = exp(logw_t) rowsum(dS_t * S_{t-1})
        du = sum over b and t of r_t k_t (v_t . do_t)
        dS_{t-1} = diag(exp(logw_t)) dS_t + r_t do_t^T
    and dS0 the dS left at the start.  Returns (dr, dk, dv in their
    inputs' dtypes, dlogw float32, du (H,M) float32, dS0 (B,H,M,M) float32
    or None without S0)."""
    B, H, T, M = r.shape
    rf, kf, vf, dof = r.float(), k.float(), v.float(), do.float()
    w = torch.exp(logw.float())
    uf = u.float()[None]                                       # (1,H,M)
    S = torch.zeros((B, H, M, M), dtype=torch.float32, device=r.device) \
        if S0 is None else S0.float()
    states = []                                 # S_{t-1} for each step t
    for t in range(T):
        states.append(S)
        S = w[:, :, t, :, None] * S + kf[:, :, t, :, None] * vf[:, :, t, None]
    G = torch.zeros_like(S) if dS is None else dS.float()
    grads = [torch.empty((B, H, T, M), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dlogw = grads
    du = torch.zeros((H, M), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, ot = rf[:, :, t], kf[:, :, t], vf[:, :, t], dof[:, :, t]
        vo = (vt * ot).sum(-1, keepdim=True)                   # v_t . do_t
        ruk = (rt * uf * kt).sum(-1, keepdim=True)
        Sp = states[t]
        dr[:, :, t] = torch.einsum("bhmj,bhj->bhm", Sp, ot) + uf * kt * vo
        dk[:, :, t] = rt * uf * vo + torch.einsum("bhmj,bhj->bhm", G, vt)
        dv[:, :, t] = ruk * ot + torch.einsum("bhmj,bhm->bhj", G, kt)
        dlogw[:, :, t] = w[:, :, t] * (G * Sp).sum(-1)
        du += (rt * kt * vo).sum(0)
        G = w[:, :, t, :, None] * G + rt[..., None] * ot[:, :, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogw, du,
            None if S0 is None else G)


def rglru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, step by step.  a, b: (B,T,D)
    -> (B,T,D) f32."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_scan_backward(a, h, dh):
    """The gradients of ``rglru_scan`` by the explicit formula K5's
    backward computes, in float32, from ``a``, the forward's output ``h``
    and the gradient ``dh`` of h: g_t = dh_t + a_{t+1} g_{t+1} (g past the
    last step is zero) step by step, then da_t = g_t h_{t-1} (h_{-1} = 0)
    and db_t = g_t.  Returns (da, db) (B,T,D) float32."""
    af, hf, dhf = a.float(), h.float(), dh.float()
    g = torch.empty_like(dhf)
    carry = torch.zeros_like(dhf[:, 0])
    for t in reversed(range(a.shape[1])):
        carry = dhf[:, t] + (af[:, t + 1] * carry if t + 1 < a.shape[1]
                             else 0)
        g[:, t] = carry
    hp = torch.cat([torch.zeros_like(hf[:, :1]), hf[:, :-1]], dim=1)
    return g * hp, g


def adafactor_stats(g):
    """Adafactor's first pass over a gradient leaf, in float32: (its sum
    of squares, the sums of g^2 over each row and each column of its two
    trailing dims, kept as (..., R, 1) and (..., 1, C): the shapes of
    ``vr`` and ``vc``).  A leaf under two dims has no row or column sums
    (None)."""
    g2 = torch.square(g.float())
    sq = torch.sum(g2)
    if g.dim() < 2:
        return sq, None, None
    return sq, g2.sum(dim=-1, keepdim=True), g2.sum(dim=-2, keepdim=True)


def adafactor_update(p, g, vr, vc, stats, scale, decay, lr, eps: float,
                     wd: float) -> None:
    """Adafactor's second and third passes over leaf ``p``, in place, the
    arithmetic of ``csrc/adafactor.cu`` in float32: with ``stats`` from
    ``adafactor_stats`` (taken before the global norm gave ``scale``),
    vr <- decay vr + (1 - decay)(scale^2 mean_C(g^2) + 1e-30) and vc
    likewise over R (the reference's mean((scale g)^2 + 1e-30) with
    scale^2 taken out), u = scale g rsqrt(vr vc / max(mean_R(vr), 1e-30) +
    eps); a leaf under two dims keeps vr elementwise, vr <- decay vr + (1 -
    decay)((scale g)^2 + 1e-30), u = scale g rsqrt(vr + eps).  Then p <- p
    - lr (u / max(1, rms(u)) + wd p), rounded once to p's dtype."""
    _, rows, cols = stats
    gs = g.float() * scale
    if rows is None:
        vr.copy_(decay * vr + (1 - decay) * (gs * gs).add_(1e-30))
        u = torch.rsqrt(vr + eps).mul_(gs)
    else:
        s2 = scale * scale
        vr.copy_(decay * vr + (1 - decay) * (s2 * (rows / g.shape[-1])
                                             + 1e-30))
        vc.copy_(decay * vc + (1 - decay) * (s2 * (cols / g.shape[-2])
                                             + 1e-30))
        den = torch.clamp(vr.mean(dim=-2, keepdim=True), min=1e-30)
        u = (vr * vc).div_(den).add_(eps).rsqrt_().mul_(gs)
    del gs                              # two float32 copies of p at most
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
    u.div_(torch.clamp(rms, min=1.0))
    u.add_(p.to(torch.float32, copy=True).mul_(wd)).mul_(lr)
    p.copy_(p.to(torch.float32, copy=True).sub_(u))


def adamw_sumsq(g):
    """AdamW's first pass over a gradient leaf: its sum of squares in
    float32 (0-d), one term of ``train/optimizer.py::global_norm``."""
    return torch.sum(torch.square(g.float()))


def adamw_update(p, g, mu, nu, scale, lr, bc1, bc2, *, b1: float, b2: float,
                 eps: float, wd: float) -> None:
    """AdamW's update of leaf ``p`` and its moments ``mu``/``nu`` in place,
    in float32, each operation a PyTorch kernel (the arithmetic of
    ``csrc/adamw.cu``, rounded at the same places): with g' = scale g,
    mu <- b1 mu + (1 - b1) g', nu <- b2 nu + (1 - b2) g' g', p <- p - lr
    ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd p)."""
    g = g.float() * scale
    m2 = b1 * mu.float() + (1 - b1) * g
    v2 = b2 * nu.float() + (1 - b2) * g * g
    step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    step = step + wd * p.float()
    p.copy_(p.float() - lr * step)
    mu.copy_(m2)
    nu.copy_(v2)
