"""Adafactor's update on the card: the wrapper of ``csrc/adafactor.cu``.

No Pallas kernel stands behind it: the JAX package leaves its optimizer to
XLA (``src/repro/train/optimizer.py``).  One step of a leaf is three passes
over it (the design note in the source): ``stats`` is the first, run on
every leaf before the global norm is known; ``update`` runs the other two
once the clip scale is.  Each leaf is seen as a batch of matrices ``(Bt,
R, C)`` (``factored_view``); a leaf of fewer than two dims is not factored.

The wrapper checks its inputs and raises on anything the kernels do not
take, allocates the scratch (row and column sums the size of ``vr`` and
``vc``, tile partials a fraction of them, per-block partials; nothing the
size of the leaf), launches on the current stream and counts one launch a
leaf updated.  It runs only on CUDA tensors: ``ops.adafactor_stats`` and
``ops.adafactor_update`` send CPU tensors to ``ref`` instead.  The scale,
decay and learning rate stay 0-d float32 tensors on the device, read by the
kernels: nothing waits on the host.

A fake tensor (a trace on ``FakeTensorMode``, inside ``cost.card_path()``)
gets its outputs allocated and its update recorded in ``cost``, with
``cost.py``'s count of its work; nothing is launched or counted as a
launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, cost

launches = 0                    # leaves updated since the last reset
_stats_fn = None
_apply_fn = None

THREADS = 256                   # a block (csrc/adafactor.cu kThreads)
UNIT_ELEMS = 65536              # the elements a unit of work aims at
UNITS_PER_SM = 4                # a leaf spreads over at least this many
PARTS = 4096                    # block partials a pass: above any grid the
                                # card holds at once (132 SMs x 8 blocks)
DTYPES = (torch.bfloat16, torch.float32)


def _lib():
    global _stats_fn, _apply_fn
    if _stats_fn is None:
        lib = _build.load("adafactor")
        fn = lib.repro_adafactor_stats
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        ap = lib.repro_adafactor_apply
        ap.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        ap.restype = ctypes.c_int
        _stats_fn, _apply_fn = fn, ap
    return _stats_fn, _apply_fn


def factored_view(shape) -> tuple[int, int, int] | None:
    """(Bt, R, C) of a leaf Adafactor factors (two dims or more: R and C
    the two trailing dims, Bt the product of the rest), None otherwise."""
    if len(shape) < 2:
        return None
    return math.prod(shape[:-2]), shape[-2], shape[-1]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def geometry(Bt: int, R: int, C: int, vec: int, sms: int
             ) -> tuple[int, int, int, int]:
    """(cp, rs, nct, nrs): the threads across a column tile (a power of
    two <= 32, so a tile of cp * vec columns covers C or 32 * vec), the
    rows a unit (a multiple of the 256 / cp row groups, about UNIT_ELEMS
    elements a unit, fewer rows where the leaf would otherwise give under
    UNITS_PER_SM units an SM), the column tiles and the row units."""
    cp = 1
    while cp < 32 and cp * vec < C:
        cp *= 2
    rp = THREADS // cp
    tile = cp * vec
    nct = -(-C // tile)
    rs = min(_round_up(max(1, UNIT_ELEMS // tile), rp), _round_up(R, rp))
    want = UNITS_PER_SM * sms
    if Bt * nct * -(-R // rs) < want:
        splits = -(-want // (Bt * nct))
        rs = max(rp, -(-R // splits) // rp * rp)
    return cp, rs, nct, -(-R // rs)


def _vec(C: int, *ts) -> int:
    """8 elements a thread where every row starts 16-byte aligned, else 1."""
    return 8 if C % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts) \
        else 1


def _state_shapes(shape) -> tuple[tuple, tuple]:
    """The shapes of ``vr`` and ``vc`` beside a leaf of ``shape``
    (``train/optimizer.py::init_opt_state``)."""
    if len(shape) < 2:
        return tuple(shape), (1,) * len(shape)
    return (*shape[:-1], 1), (*shape[:-2], 1, shape[-1])


def _check_leaf(t) -> None:
    """Raise ``ValueError`` unless the kernels take leaf ``t``: nonempty,
    bf16 or float32, contiguous, on the card, its rows, columns and
    matrices (or its elements, unfactored) under 2**31."""
    if t.numel() < 1 or t.dtype not in DTYPES or not t.is_contiguous():
        raise ValueError(f"leaf {tuple(t.shape)} {t.dtype}: want a "
                         "nonempty contiguous bfloat16 or float32 tensor")
    view = factored_view(t.shape)
    if max(view or (t.numel(),)) >= 2 ** 31:
        raise ValueError(f"leaf {tuple(t.shape)}: the kernels take rows, "
                         "columns, matrices and unfactored leaves under "
                         "2**31")
    if not cost.on_card(t):
        raise ValueError(f"leaf on {t.device}: want a CUDA tensor")


def check(p, g, vr, vc) -> None:
    """Raise ``ValueError`` unless the kernels take this leaf (p and g of
    one shape, each as ``_check_leaf`` asks) and its state (vr and vc
    float32, contiguous, of the shapes ``init_opt_state`` gives), all on
    one device."""
    _check_leaf(p)
    _check_leaf(g)
    want_vr, want_vc = _state_shapes(p.shape)
    if g.shape != p.shape or tuple(vr.shape) != want_vr \
            or tuple(vc.shape) != want_vc or vr.dtype != torch.float32 \
            or vc.dtype != torch.float32:
        raise ValueError(f"p {tuple(p.shape)}, g {tuple(g.shape)}, vr "
                         f"{tuple(vr.shape)} {vr.dtype}, vc "
                         f"{tuple(vc.shape)} {vc.dtype}: want g of p's "
                         f"shape, vr and vc float32 {want_vr} and {want_vc}")
    if not (vr.is_contiguous() and vc.is_contiguous()) \
            or any(t.device != p.device for t in (g, vr, vc)):
        raise ValueError("vr and vc must be contiguous, and all on p's "
                         "device")


def _check_scalars(p, *ts) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.numel() != 1 \
                or t.device != p.device:
            raise ValueError(f"scale, decay and lr: want 0-d float32 on "
                             f"{p.device}; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def _geo(p, *ts):
    """(factored, Bt, R, C, vec, cp, rs, nct, nrs) of a leaf on the card,
    ``ts`` the tensors read in rows (the vector loads' alignment)."""
    view = factored_view(p.shape)
    Bt, R, C = (1, 1, p.numel()) if view is None else view
    vec = _vec(C, *ts) if view is not None else 1
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    return (view is not None, Bt, R, C, vec, *geometry(Bt, R, C, vec, sms))


def _scratch(n: int, device) -> torch.Tensor:
    return torch.empty(max(n, 1), dtype=torch.float32, device=device)


def stats(g):
    """Pass 1 of gradient leaf ``g`` -> (its sum of squares (0-d), the
    sums of g^2 over each row (..., R, 1) and over each column (..., 1,
    C); None, None under two dims), float32."""
    _check_leaf(g)
    factored = g.dim() >= 2
    sq = torch.empty((), dtype=torch.float32, device=g.device)
    rows, cols = (torch.empty(s, dtype=torch.float32, device=g.device)
                  for s in _state_shapes(g.shape)) if factored \
        else (None, None)
    if cost.is_fake(g):                 # a trace: the update records it
        return sq, rows, cols
    fn, _ = _lib()
    factored, Bt, R, C, vec, cp, rs, nct, nrs = _geo(g, g)
    rowpart = _scratch(Bt * R * nct if factored else 0, g.device)
    colpart = _scratch(Bt * nrs * C if factored else 0, g.device)
    parts = _scratch(PARTS, g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), int(g.dtype == torch.float32), int(factored),
                Bt, R, C, cp, rs, vec, rowpart.data_ptr(),
                colpart.data_ptr(), parts.data_ptr(), PARTS,
                rows.data_ptr() if factored else None,
                cols.data_ptr() if factored else None, sq.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"adafactor stats launch failed: cudaError_t {rc}")
    return sq, rows, cols


def update(p, g, vr, vc, st, scale, decay, lr, eps: float,
           wd: float) -> None:
    """Passes 2 and 3 of leaf ``p`` in place, after ``stats``: vr and vc
    take the step's decayed means, and p <- p - lr (u / max(1, rms(u)) +
    wd p) with u = scale g rsqrt(vr vc / mean_R(vr) + eps) (factored) or
    scale g rsqrt(vr + eps); ``scale``, ``decay`` and ``lr`` 0-d float32
    on p's device."""
    global launches
    check(p, g, vr, vc)
    _check_scalars(p, scale, decay, lr)
    view = factored_view(p.shape)
    if cost.is_fake(p):                 # a trace: count it, launch nothing
        Bt, R, C = (1, 1, p.numel()) if view is None else view
        cost.record("adafactor", Bt=Bt, R=R, C=C, g_dtype=g.dtype,
                    p_dtype=p.dtype, factored=view is not None)
        return
    _, fn = _lib()
    factored, Bt, R, C, vec, cp, rs, _, _ = _geo(p, g, p)
    den = _scratch(Bt if factored else 0, p.device)
    parts = _scratch(PARTS, p.device)
    rows = st[1].data_ptr() if factored else None
    cols = st[2].data_ptr() if factored else None
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(g.data_ptr(), int(g.dtype == torch.float32), p.data_ptr(),
                int(p.dtype == torch.float32), int(factored), Bt, R, C, cp,
                rs, vec, rows, cols, vr.data_ptr(), vc.data_ptr(),
                den.data_ptr(), parts.data_ptr(), PARTS, scale.data_ptr(),
                decay.data_ptr(), lr.data_ptr(), eps, wd, stream)
    if rc != 0:
        raise RuntimeError(f"adafactor update launch failed: cudaError_t "
                           f"{rc}")
    launches += 1
