#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end, and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printed as one JSON object on its own line:

  1. device   the card (``nvidia-smi`` name and power limit); TF32 off.
  2. build    both CUDA kernels from ``src/repro_torch/kernels/csrc``,
              one ``nvcc`` per source, in parallel.
  3. kernels  each kernel against its plain PyTorch version on the card, in
              float32 and bf16 at the main path's shapes (tolerance 2e-3 /
              2e-2), then times (CUDA events, median, L2 flushed before
              every launch) beside the least time the card could take and
              one PyTorch library call computing the same function.
  4. prefill  full-width qwen3-0.6b in bf16 (random weights from a seeded
              ``torch.Generator``): ``make_prefill`` on B=1, T=1024 through
              K2, held against the same forward with plain attention.
  5. serve    a full-width ``ServeEngine`` on ``Cluster(4, "drust")`` with
              the int8 weight wire serves 8 requests (half share a
              1024-token prefix page); K1 must launch n_layers times per
              tick; a few decode steps are held against the plain path.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
...}``.  Any failed check raises, so the script exits non-zero and prints
no result; so does a machine without a card, or a directory that holds
this file and nothing else of the repository.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# One NVIDIA H100 SXM (data sheet, dense): HBM3 bytes/s and peak FLOP/s by
# operand type (bf16 on tensor cores; float32 on CUDA cores).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOLS = {"float32": 2e-3, "bfloat16": 2e-2}
# Prefill / decode logits, kernel path vs plain-attention path, both bf16:
# the two paths round attention to bf16 at different points in each of 28
# layers, so the logits agree only to a few bf16 ulps in relative L2.
LOGIT_REL_TOL = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import Cluster
    from repro_torch.core.torchstate import OwnedState, tree_leaves
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import decode_step, init_params
    from repro_torch.serve import ServeEngine, make_prefill

    dev = torch.device("cuda")

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {}
    for name in libs:
        log = _build.build_log(name)
        ptxas[name] = {
            "registers": sorted({int(r) for r in
                                 re.findall(r"Used (\d+) registers", log)}),
            "spill_bytes": max([int(s) for s in re.findall(
                r"(\d+) bytes spill stores", log)] or [0])}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(libs), "ptxas": ptxas})

    # 3. kernels -----------------------------------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def within(a, b, tol: float) -> bool:
        """|a - b| <= tol + tol * |b| everywhere (as assert_close)."""
        a, b = a.float(), b.float()
        return bool(((a - b).abs() <= tol + tol * b.abs()).all())

    def timed(fn, reps: int = 15) -> float:
        """Median ms of one launch, L2 flushed before each."""
        fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bound(nbytes: float, flops: float, dtype: str):
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    B, H, Hkv, hd, S = 4, 16, 8, 128, 2048
    k1_cases = []
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        cache = rand(2, B, S, Hkv, hd, dtype=dtype)     # the model's layout
        q = rand(B, H, hd, dtype=dtype)
        k, v = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
        lens = torch.tensor([1, S, 777, 1500], dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, k, v, lens)
        want = ref.decode_attention(q, k, v, lens)
        e = err(got, want)
        k1_cases.append({"dtype": dt, "lengths": lens.tolist(),
                         "max_abs_err": e, "tol": TOLS[dt]})
        need(within(got, want, TOLS[dt]), f"decode_attention {dt}: max err "
             f"{e}")

    k2_cases = []
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for T, Sk, causal in ((1024, 1024, True), (1024, 1024, False),
                              (1000, 1000, True), (512, 1024, True)):
            q = rand(1, 16, T, hd, dtype=dtype)
            k = rand(1, 8, Sk, hd, dtype=dtype)
            v = rand(1, 8, Sk, hd, dtype=dtype)
            got = ops.flash_attention(q, k, v, causal=causal)
            want = ref.attention(q, k, v, causal=causal)
            e = err(got, want)
            k2_cases.append({"dtype": dt, "T": T, "S": Sk, "causal": causal,
                             "max_abs_err": e, "tol": TOLS[dt]})
            need(within(got, want, TOLS[dt]), f"flash_attention {dt} T={T} "
                 f"S={Sk} causal={causal}: max err {e}")
    torch.cuda.synchronize()

    # times at the main path's shapes, bf16
    import torch.nn.functional as F
    bf = torch.bfloat16
    cache = rand(2, B, S, Hkv, hd, dtype=bf)
    q1 = rand(B, H, hd, dtype=bf)
    k1, v1 = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    k1_out = ops.decode_attention(q1, k1, v1, lens)
    k1_want = ref.decode_attention(q1, k1, v1, lens)
    k1_err = err(k1_out, k1_want)
    n_keys = int(lens.sum())
    k1_bound = bound(2 * (2 * B * H * hd) + 2 * n_keys * Hkv * hd * 2 + 4 * B,
                     4 * n_keys * H * hd, "bfloat16")
    k1_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:62",
        "shape": {"B": B, "H": H, "Hkv": Hkv, "S": S, "hd": hd,
                  "lengths": "S", "dtype": "bfloat16"},
        "max_abs_err": k1_err,
        "ms": timed(lambda: ops.decode_attention(q1, k1, v1, lens)),
        "plain_ms": timed(lambda: ref.decode_attention(q1, k1, v1, lens)),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            q1[:, :, None], k1, v1, enable_gqa=True)),
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1]}

    T2 = 1024
    q2 = rand(1, 16, T2, hd, dtype=bf)
    k2 = rand(1, 8, T2, hd, dtype=bf)
    v2 = rand(1, 8, T2, hd, dtype=bf)
    k2_out = ops.flash_attention(q2, k2, v2)
    k2_want = ref.attention(q2, k2, v2)
    k2_err = err(k2_out, k2_want)
    pairs = T2 * (T2 + 1) // 2                        # causal (i, j), T == S
    k2_bound = bound(2 * (2 * 16 * T2 * hd + 2 * 8 * T2 * hd),
                     4 * pairs * 16 * hd, "bfloat16")
    k2_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:68",
        "shape": {"B": 1, "H": 16, "Hkv": 8, "T": T2, "S": T2, "hd": hd,
                  "causal": True, "dtype": "bfloat16"},
        "max_abs_err": k2_err,
        "ms": timed(lambda: ops.flash_attention(q2, k2, v2)),
        "plain_ms": timed(lambda: ref.attention(q2, k2, v2)),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            q2, k2, v2, is_causal=True, enable_gqa=True)),
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1]}
    need(within(k1_out, k1_want, TOLS["bfloat16"])
         and within(k2_out, k2_want, TOLS["bfloat16"]),
         f"timed cases disagree: {k1_err}, {k2_err}")
    emit({"phase": "kernels", "decode_attention": k1_cases,
          "flash_attention": k2_cases,
          "times": [{k: r[k] for k in ("name", "shape", "ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by")}
                    for r in (k1_row, k2_row)]})
    del cache, flush_buf

    # 4. prefill -----------------------------------------------------------
    cfg = configs.get("qwen3_0_6b")
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (1, 1024), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    prefill = make_prefill(cfg)
    with torch.no_grad():
        prefill(params, {"tokens": toks})             # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        last, logits = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        k2_launches = ops.launch_counts()["flash_attention"]
        _, plain_logits = make_prefill(plain_cfg)(params, {"tokens": toks})
    rel = _rel(logits, plain_logits)
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1))
                  .float().mean())
    emit({"phase": "prefill", "arch": cfg.name, "params": n_params,
          "init_s": init_s, "B": toks.shape[0], "T": toks.shape[1],
          "prefill_ms": prefill_ms,
          "flash_attention_launches": k2_launches,
          "logits_shape": list(logits.shape),
          "rel_l2_vs_plain": rel, "tol": LOGIT_REL_TOL,
          "argmax_agreement": agree})
    need(k2_launches == cfg.n_layers,
         f"K2 launched {k2_launches} times, want {cfg.n_layers}")
    need(bool(torch.isfinite(logits.float()).all()), "non-finite logits")
    need(tuple(last.shape) == (1, cfg.vocab), f"last logits {last.shape}")
    need(rel <= LOGIT_REL_TOL, f"prefill logits rel err {rel}")
    del logits, plain_logits, last

    # 5. serve -------------------------------------------------------------
    weights = OwnedState("weights", params)
    cl = Cluster(4, backend="drust")
    engine = ServeEngine(cfg, weights, slots=4, max_len=2048, cluster=cl,
                         wire="int8", device=dev)
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab, cfg.attn_chunk)]
    reqs = []
    for i in range(8):
        tail = [int(t) for t in rng.integers(0, cfg.vocab, 8 if i % 2 == 0
                                             else 12)]
        reqs.append(engine.submit(prefix + tail if i % 2 == 0 else tail,
                                  max_new=16))
    ops.reset_launch_counts()
    ticks, tokens = [], 0
    t_serve = time.perf_counter()
    with torch.no_grad():
        while engine.queue or engine.active:
            t0 = time.perf_counter()
            tokens += engine.step()
            ticks.append((time.perf_counter() - t0) * 1e3)
            need(len(ticks) < 1000, "engine did not drain")
    serve_s = time.perf_counter() - t_serve
    counts = ops.launch_counts()
    st = engine.stats()
    emit({"phase": "serve", "servers": 4, "wire": "int8", "slots": 4,
          "max_len": 2048, "requests": len(reqs),
          "done": sum(r.done for r in reqs), "steps": engine.steps,
          "tokens": tokens, "tick_ms_median": statistics.median(ticks),
          "tick_ms_first": ticks[0], "decode_tok_s": tokens / serve_s,
          "decode_attention_launches": counts["decode_attention"],
          "flash_attention_launches": counts["flash_attention"],
          "kv": st["kv"], "wire_bytes": st["wire_bytes"],
          "weight_refreshes": st["weight_refreshes"],
          "weight_hits": st["weight_hits"],
          "round_trips": cl.sim.net.round_trips,
          "virtual_makespan_us": cl.makespan_us()})
    need(all(r.done for r in reqs), "not every request finished")
    need(counts["decode_attention"] == cfg.n_layers * engine.steps,
         f"K1 launched {counts['decode_attention']} times, want "
         f"{cfg.n_layers} x {engine.steps}")
    need(st["weight_refreshes"] >= 1, "no weight refresh")

    # a few decode ticks from the served cache: kernel path vs plain path
    ck = {**engine.cache, "layers": {k: t.clone() for k, t in
                                     engine.cache["layers"].items()}}
    cp = {**engine.cache, "layers": {k: t.clone() for k, t in
                                     engine.cache["layers"].items()}}
    gen_t = torch.Generator(dev).manual_seed(2)
    decode_checks = []
    with torch.no_grad():
        for _ in range(3):
            tok = torch.randint(0, cfg.vocab, (4, 1), device=dev,
                                generator=gen_t)
            lk, ck = decode_step(cfg, params, ck, tok)
            lp, cp = decode_step(plain_cfg, params, cp, tok)
            decode_checks.append({"length": ck["length"],
                                  "rel_l2_vs_plain": _rel(lk, lp),
                                  "max_abs_err": err(lk, lp)})
    emit({"phase": "decode_check", "checks": decode_checks,
          "tol": LOGIT_REL_TOL})
    need(all(c["rel_l2_vs_plain"] <= LOGIT_REL_TOL for c in decode_checks),
         "decode logits disagree with the plain path")

    k1_row["launches"] = counts["decode_attention"]
    k2_row["launches"] = k2_launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in keys} for r in (k1_row, k2_row)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


if __name__ == "__main__":
    sys.exit(main())
