"""Kernel micro-benchmarks (the counterpart of ``benchmarks/kernel_bench.py``):
the reference's five rows, on the same seeded numpy inputs, drawn in the
same order at the same shapes (float32).

On the card (``device="cuda"``, the default) each row is a hand-written
CUDA kernel: ``us`` its median time (CUDA events around one launch, L2
flushed before each, after a warm-up launch) and ``derived`` the largest
absolute difference from its plain version (``kernels/ref.py``) on the
same inputs on the card.  With ``device="cpu"`` the rows are named
``kernel_<name>_plain`` and time the plain version on the host (no device
metric), and ``derived`` is the largest absolute entry of the result (a
digest of it: there is no kernel to hold it against).  ``fast`` skips K4
and K5, as the reference does.

The reference's ``block_*`` / ``chunk`` arguments choose its Pallas
kernels' tiles; the port's kernels choose their own, so those arguments
have no counterpart here.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.transformer import resolve_device

# the reference's row names, and the decimals its ``derived`` keeps
ROWS = (("flash_attention", 6), ("decode_attention", 6), ("moe_gmm", 5),
        ("rwkv_scan", 6), ("rglru_scan", 6))


def inputs(fast: bool = False) -> dict[str, tuple]:
    """The reference's inputs as numpy float32 arrays, drawn from
    ``default_rng(0)`` in its order: {name: (arrays...)} (K1's lengths
    int32).  The draws are the reference's bit for bit; its float32
    sigmoid (K4's decay, K5's a) is ``torch.sigmoid`` here, which agrees
    with XLA's to one float32 rounding."""
    rng = np.random.default_rng(0)

    def arr(*s):
        return rng.standard_normal(s).astype(np.float32)

    def sigmoid(x):
        return torch.sigmoid(torch.from_numpy(x)).numpy()

    out = {}
    B, H, Hkv, T, hd = 1, 4, 2, 256, 64
    out["flash_attention"] = (arr(B, H, T, hd), arr(B, Hkv, T, hd),
                              arr(B, Hkv, T, hd))
    S = 512
    out["decode_attention"] = (arr(B, H, hd), arr(B, Hkv, S, hd),
                               arr(B, Hkv, S, hd),
                               np.full((B,), S, np.int32))
    E, C, D, F = 4, 128, 256, 128
    out["moe_gmm"] = (arr(E, C, D), arr(E, D, F))
    if not fast:
        B2, H2, T2, M = 1, 2, 128, 32
        r, k2, v2 = arr(B2, H2, T2, M), arr(B2, H2, T2, M), arr(B2, H2, T2, M)
        logw = (-0.105 * sigmoid(arr(B2, H2, T2, M))).astype(np.float32)
        u = (arr(H2, M) * 0.1).astype(np.float32)
        out["rwkv_scan"] = (r, k2, v2, logw, u)
        out["rglru_scan"] = (sigmoid(arr(2, 256, 128)), arr(2, 256, 128))
    return out


# the entry points, each returning the output the row compares
KERNEL = {"flash_attention": lambda q, k, v: ops.flash_attention(q, k, v),
          "decode_attention": ops.decode_attention,
          "moe_gmm": lambda x, w: ops.moe_gmm(x, w),
          "rwkv_scan": lambda *a: ops.rwkv_scan(*a)[0],
          "rglru_scan": ops.rglru_scan}
PLAIN = {"flash_attention": lambda q, k, v: ref.attention(q, k, v),
         "decode_attention": ref.decode_attention,
         "moe_gmm": lambda x, w: ref.moe_gmm(x, w),
         "rwkv_scan": lambda *a: ref.rwkv_scan(*a)[0],
         "rglru_scan": ref.rglru_scan}


def _time_host(fn, iters: int = 3) -> float:
    fn()                                      # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def _time_card(fn, dev, reps: int = 15) -> float:
    """Median us of one launch: CUDA events, L2 flushed (a 256 MB write)
    and the card kept busy (a device sleep) before each."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(300_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def cases(fast: bool = False, device="cuda"):
    """(name, kernel, plain, args, digits) for each row: the wrapper entry
    point (``ops``: the CUDA kernel on the card), the plain version, the
    inputs on ``device`` and the decimals of the row's ``derived``."""
    dev = resolve_device(device)
    arrays = inputs(fast)
    return [(name, KERNEL[name], PLAIN[name],
             [torch.from_numpy(a).to(dev) for a in arrays[name]], digits)
            for name, digits in ROWS if name in arrays]


def all_rows(fast: bool = False, device="cuda"):
    """(name, us, derived) for each kernel: see the module docstring."""
    dev = resolve_device(device)
    rows = []
    for name, kernel, plain, args, digits in cases(fast, dev):
        if dev.type == "cuda":
            got = kernel(*args)
            want = plain(*args)
            us = _time_card(lambda: kernel(*args), dev)
            rows.append((f"kernel_{name}", us, round(float(
                (got.float() - want.float()).abs().max()), digits)))
        else:
            got = plain(*args)
            us = _time_host(lambda: plain(*args))
            rows.append((f"kernel_{name}_plain", us,
                         round(float(got.abs().max()), digits)))
    return rows
