"""One count of each kernel's work, and a recorder of the calls that a trace
on fake tensors makes.

Each function below takes a call's shapes, dtype and flags and returns a
``Cost``: the floating-point operations the call must do (2 a multiply-add),
the bytes it must move (each input read once, each output written once;
scratch that a kernel keeps for itself is not counted), and the operand
type whose peak rate bounds the operations.  The counts are the ones the
``bound_ms`` column of ``chip_smoke.py``'s ``kernels`` line has used since
the kernels were ported, and no kernel's tiles or route change them, so a
kernel made faster keeps the same bound:

  K1 ``decode_attention``  the keys under each row's ``lengths``
  K2 ``flash_attention``   the (query, key) pairs under the causal mask and
                           the window, times 4 H hd (10 for the backward)
  K3 ``moe_gmm``           the live rows of each expert (``rows``) and the
                           weights of the experts that have any
  K4 ``rwkv_scan``         the chunk form's multiply-adds, chunks of 64
  K5 ``rglru_scan``        one multiply-add an element (three backward)

Where the work depends on the data (K1's ``lengths``, K3's ``rows``), a
count takes the values; without them (``None``) it counts K1 at the full
cache and K3 at full capacity, an upper bound.

``bound_ms`` turns a count into the least time an NVIDIA H100 SXM could
take for it: the bytes over its HBM3 rate or the operations over the peak
rate of their type, the larger (NVIDIA's H100 SXM data sheet, dense, at
700 W).

The recorder: a kernel wrapper that is handed a ``FakeTensor`` (a trace
under ``FakeTensorMode``, as ``launch/dryrun.py`` makes) allocates its
outputs, calls ``record`` with its count and returns without launching
anything; ``recording()`` collects those records.  A fake tensor has no
data, so such a call counts K1 and K3 as upper bounds.

The card's path: the model takes its kernels for a tensor on the card
(``on_card``).  A trace's fake tensors sit on the CPU, because autograd
on fake CUDA tensors needs CUDA's device guard and stream hooks, which a
CPU-only build of PyTorch does not have; inside ``card_path()`` a fake
tensor takes the card's path all the same, so the trace runs the code the
card runs, kernel calls included.  A real tensor is never affected.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 bytes/s, and peak FLOP/s
# by operand type (bf16 on the tensor cores, float32 on the CUDA cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEM_BYTES = {"bfloat16": 2, "float32": 4}
RWKV_CHUNK = 64                 # K4's chunk (csrc/rwkv_scan.cu kC)
RWKV_STATE = 64                 # K4's float32 chunk states are 64 x 64


class Cost(NamedTuple):
    flops: int
    bytes: int
    dtype: str                  # the peak rate that bounds ``flops``


def dtype_name(dtype) -> str:
    """``"bfloat16"`` or ``"float32"`` for a torch dtype or its name."""
    name = str(dtype).removeprefix("torch.")
    if name not in ELEM_BYTES:
        raise ValueError(f"no kernel takes {dtype}")
    return name


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """(the least ms an H100 SXM takes for this work, "bytes" or
    "operations": which of the two times is the larger)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_pairs(T: int, S: int, causal: bool = True,
                    window: int = 0) -> int:
    """(query, key) pairs one head of K2 computes: query i sees key j when
    j <= i + S - T (causal, bottom-right aligned) and, with a window, j >
    i + S - T - window; every key without the mask."""
    if not causal:
        return T * S
    cap = min(S, window) if window else S
    # row i sees clamp(i + S - T + 1, 0, cap) keys: a ramp clipped at 0
    # and at cap, summed in closed form
    lo = S - T + 1                          # the keys row 0 sees, unclipped
    total = 0
    first = max(0, 1 - lo)                  # the first row that sees any
    full = max(first, min(T, cap - lo))     # the first row that sees cap
    if full > first:
        total += (full - first) * (lo + first + lo + full - 1) // 2
    total += (T - full) * cap
    return total


def decode_attention(B: int, H: int, Hkv: int, S: int, hd: int, dtype,
                     lengths=None) -> Cost:
    """K1: q (B,H,hd) against the first ``lengths[b]`` of S cached keys (all
    S when ``lengths`` is None): q, the live keys and values and lengths
    read, the output written; QK^T and PV over the live keys."""
    name = dtype_name(dtype)
    es = ELEM_BYTES[name]
    n_keys = B * S if lengths is None else sum(int(n) for n in lengths)
    return Cost(4 * n_keys * H * hd,
                es * 2 * B * H * hd + es * 2 * n_keys * Hkv * hd + 4 * B,
                name)


def flash_attention(B: int, H: int, Hkv: int, T: int, S: int, hd: int, dtype,
                    causal: bool = True, window: int = 0,
                    with_lse: bool = False) -> Cost:
    """K2's forward: q and the output (B,H,T,hd), k and v (B,Hkv,S,hd),
    and with ``with_lse`` the float32 lse (B,H,T) it writes for the
    backward; QK^T and PV over the pairs under the mask."""
    name = dtype_name(dtype)
    es = ELEM_BYTES[name]
    pairs = B * attention_pairs(T, S, causal, window)
    return Cost(4 * pairs * H * hd,
                es * (2 * B * H * T * hd + 2 * B * Hkv * S * hd)
                + (4 * B * H * T if with_lse else 0), name)


def flash_attention_bwd(B: int, H: int, Hkv: int, T: int, S: int, hd: int,
                        dtype, causal: bool = True, window: int = 0) -> Cost:
    """K2's backward: q, out, dout read and dq written (B,H,T,hd); k, v
    read and dk, dv written (B,Hkv,S,hd); lse read; the scores, dP, dV,
    dK and dQ products over the pairs under the mask (5 of the 4 H hd
    forward's 2)."""
    name = dtype_name(dtype)
    es = ELEM_BYTES[name]
    pairs = B * attention_pairs(T, S, causal, window)
    return Cost(10 * pairs * H * hd,
                es * (4 * B * H * T * hd + 4 * B * Hkv * S * hd)
                + 4 * B * H * T, name)


def _rows(E: int, C: int, rows) -> tuple[int, int]:
    """(live experts, live rows) of K3: every one without ``rows``."""
    if rows is None:
        return E, E * C
    rows = [min(int(n), C) for n in rows]
    return sum(n > 0 for n in rows), sum(rows)


def moe_gmm(E: int, C: int, D: int, F: int, dtype, rows=None) -> Cost:
    """K3: the live rows of x (E,C,D) and the weights (D,F) of the live
    experts read, all of y (E,C,F) written (dead rows as zeros), rows (E,)
    int32 read when given; 2 D F a live row."""
    name = dtype_name(dtype)
    es = ELEM_BYTES[name]
    live, n_rows = _rows(E, C, rows)
    return Cost(2 * n_rows * D * F,
                es * (n_rows * D + live * D * F + E * C * F)
                + (0 if rows is None else 4 * E), name)


def moe_gmm_bwd(E: int, C: int, D: int, F: int, dtype, rows=None) -> Cost:
    """K3's backward: the live rows of x and dy and the live experts' w
    read; all of dx (E,C,D) and dw (E,D,F) written; dx = dy w^T and dw =
    x^T dy over the live rows."""
    name = dtype_name(dtype)
    es = ELEM_BYTES[name]
    live, n_rows = _rows(E, C, rows)
    return Cost(4 * n_rows * D * F,
                es * (n_rows * D + live * D * F + n_rows * F + E * C * D
                      + E * D * F) + (0 if rows is None else 4 * E), name)


def _chunks(T: int) -> list[int]:
    return [min(RWKV_CHUNK, T - t0) for t0 in range(0, T, RWKV_CHUNK)]


def rwkv_scan(B: int, H: int, T: int, M: int, dtype,
              S0: bool = False) -> Cost:
    """K4: r, k, v (``dtype``) and logw (float32) read, o float32 written
    (B,H,T,M); u read; S0 read when given and S written (B,H,M,M) float32.
    Per chunk of n: the strict-lower scores, scores @ v with the diagonal,
    q_in @ S and the state update, 2 flops a multiply-add."""
    name = dtype_name(dtype)
    es = ELEM_BYTES[name]
    fmas = sum(n * (n - 1) // 2 * M + n * (n + 1) // 2 * M + 2 * n * M * M
               for n in _chunks(T))
    return Cost(2 * B * H * fmas,
                B * H * T * M * (3 * es + 2 * 4) + H * M * 4
                + (2 if S0 else 1) * B * H * M * M * 4, name)


def rwkv_scan_bwd(B: int, H: int, T: int, M: int, dtype, S0: bool = False,
                  dS: bool = False) -> Cost:
    """K4's backward: r, k, v, logw, do and the forward's chunk-start
    states (T > 1) read, dr, dk, dv, dlogw written; u read and du
    written; S0 read and dS0 written when given, dS read when given.  Per
    chunk of n: q_in^T do, do S_c^T, v dS'^T and k_in dS' (n M^2 each),
    the strict-lower A, P, P k_in, P^T q_in and A^T do (n (n - 1) / 2 M
    each)."""
    name = dtype_name(dtype)
    es = ELEM_BYTES[name]
    chunks = _chunks(T)
    fmas = sum(4 * n * M * M + 5 * n * (n - 1) // 2 * M for n in chunks)
    states = (B * H * len(chunks) * RWKV_STATE * RWKV_STATE * 4
              if T > 1 else 0)
    mm = B * H * M * M * 4
    return Cost(2 * B * H * fmas,
                B * H * T * M * (3 * es + 4 + 4 + 3 * es + 4) + states
                + 2 * H * M * 4 + (2 * mm if S0 else 0) + (mm if dS else 0),
                name)


def rglru_scan(B: int, T: int, D: int) -> Cost:
    """K5: a, b read and h written (B,T,D) float32; h = a h + b."""
    n = B * T * D
    return Cost(2 * n, 12 * n, "float32")


def rglru_scan_bwd(B: int, T: int, D: int) -> Cost:
    """K5's backward: a, h, dh read and da, db written (B,T,D) float32; g =
    a g + dh and da = g h."""
    n = B * T * D
    return Cost(3 * n, 20 * n, "float32")


# ---------------------------------------------------------------------------
#  the recorder of fake calls
# ---------------------------------------------------------------------------
class Record(NamedTuple):
    name: str                   # the kernel, "<kernel>_bwd" for a backward
    args: dict                  # the shapes, dtype and flags counted
    cost: Cost
    upper_bound: bool           # counted without the data it depends on


_records: list[Record] | None = None
_card_path = False


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor: the wrapper records, never launches."""
    return isinstance(t, FakeTensor)


def on_card(t) -> bool:
    """Whether ``t`` takes the card's path: a CUDA tensor, or a fake one
    inside ``card_path()``."""
    return t.is_cuda or (_card_path and isinstance(t, FakeTensor))


@contextlib.contextmanager
def card_path():
    """Send fake tensors down the card's path (kernels recorded, never
    launched) inside the block."""
    global _card_path
    prev, _card_path = _card_path, True
    try:
        yield
    finally:
        _card_path = prev


@contextlib.contextmanager
def recording():
    """Collect the fake calls made inside the block into the list it
    yields.  Blocks may not nest."""
    global _records
    if _records is not None:
        raise RuntimeError("cost.recording() is already open")
    _records = out = []
    try:
        yield out
    finally:
        _records = None


COUNTS = {"decode_attention": decode_attention,
          "flash_attention": flash_attention,
          "flash_attention_bwd": flash_attention_bwd,
          "moe_gmm": moe_gmm, "moe_gmm_bwd": moe_gmm_bwd,
          "rwkv_scan": rwkv_scan, "rwkv_scan_bwd": rwkv_scan_bwd,
          "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd}


def record(name: str, upper_bound: bool = False, **args) -> None:
    """Note one fake call of ``name`` with its count ``COUNTS[name](**args)``
    (its ``args`` replay it), while ``recording()`` is open."""
    if _records is not None:
        _records.append(Record(name, args, COUNTS[name](**args),
                               upper_bound))


def by_kernel(records) -> dict[str, dict]:
    """{kernel name: {"launches", "flops", "bytes", "upper_bound"}} over
    ``records``, the names sorted."""
    out: dict[str, dict] = {}
    for r in records:
        e = out.setdefault(r.name, {"launches": 0, "flops": 0, "bytes": 0,
                                    "upper_bound": False})
        e["launches"] += 1
        e["flops"] += r.cost.flops
        e["bytes"] += r.cost.bytes
        e["upper_bound"] |= r.upper_bound
    return dict(sorted(out.items()))
