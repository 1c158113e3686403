#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end, and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printed as one JSON object on its own line:

  1. device   the card (``nvidia-smi`` name and power limit); TF32 off.
  2. build    every CUDA kernel of ``src/repro_torch/kernels/csrc``, one
              ``nvcc`` per source, in parallel.
  3. kernels  each kernel against its plain PyTorch version on the card, in
              float32 and bf16 at the main paths' shapes (tolerance 2e-3 /
              2e-2), then times (each timed row's outputs again held at
              their dtype's tolerance; CUDA events, median, L2 flushed
              before every launch) beside the least time the card could
              take and one PyTorch library call computing the same
              function, where there is one.  K3 is also checked with ``rows`` (the live
              rows of each expert: none, some, all) and timed at the serve
              shape with the rows of a seeded top-8 draw for 4 tokens
              (the "serve, routed" rows, whose bound is the live experts'
              bytes); the all-rows rows stay as they were.  K4 is also
              checked at one chunk and its edges (T = 63, 64, 65) with
              B * H = 1.  K2 is also checked at pixtral-12b's head dim of
              160 (causal, ragged, T < S, full, an unaligned q) and K5 at
              T = 1, a window of 256 steps -/+ 1 and 4095, a ragged D,
              B = 3, B/T strides, a = 0.999 and a = 1e-4.  One line gives,
              for K3, K4 and K5 at their path shapes, the device time of
              each CUDA kernel that one wrapper call launches
              (``torch.profiler``, 10 calls; K4's prefill is three
              launches), and one the time of ``torch.add`` over K5's
              prefill bytes.  K1 is also checked at the boundaries of its
              split over the cache and timed at the length the serve path
              reaches (33), and one line gives the host time of one K1
              wrapper call (1,000 calls, no synchronise).  K2's ``lse``
              and its backward kernel are checked against
              ``ref.attention_lse`` / ``ref.attention_backward`` (causal,
              full, T < S, a window, ragged, every head dim, G = 1 to 16,
              the model's transposed views, recurrentgemma-9b's training
              shape, an unaligned q; each gradient at the tolerance of its
              largest entry; each case on the kernels ``K2_BWD_ROUTES``
              names, its head splits printed), and K2's forward and
              backward are timed at qwen3-0.6b's training shape (B=8,
              T=1024), the backward beside SDPA's backward, and at the
              training shapes of recurrentgemma-9b (hd 256, MQA 16/1: 8
              head splits) and qwen3-moe-235b-a22b, each backward first
              run twice (``torch.equal``) and traced (only its route's
              kernels: at hd 128 the wgmma ones; the dK/dV sum where the
              heads are split), and at recurrentgemma-9b's and the MoE's
              shapes against every head split and SDPA's backward in
              turns (``k2_bwd_splits``); and at mellum2-12b-a2.5b's
              (B=1, T=16,384, GQA 32/4), windowed (1,024) and full, held
              to the plain version over blocks of 2,048 queries.  The
              backward kernels of K5, K3 and K4,
              through the autograd Functions training calls, are checked
              against the plain backwards ``ref.*_backward`` (K5_BWD_CASES,
              K3_BWD_CASES, K4_BWD_CASES: the training shapes, ragged
              shapes, T = 1, 15, 16, 17, 257 and 4097 for K5, strides,
              B = 3, rows none / partial / zero with dead rows and empty
              experts exactly zero, the decode step, an S0 that requires
              grad, a non-zero gradient of the final state; each gradient
              at its tolerance of its largest entry; each K3 case's route,
              ``wgmma`` / ``tc`` / ``f32``, as ``K3_BWD_ROUTES`` says,
              and each K4 case's, ``tc`` in bf16 and ``cc`` in float32;
              K3's backward at the training shapes run twice,
              ``torch.equal``, and on ``wgmma``; K4's at rwkv6-3b's
              twice, ``torch.equal``, and traced: only the tensor-core
              kernels) and timed at the
              training shapes (B=8, T=1024) of recurrentgemma-9b,
              qwen3-moe-235b-a22b and rwkv6-3b beside the plain backward
              (and, for K3, two ``torch.bmm`` calls; for K5,
              ``k5_bwd_same_bytes``: a ``torch.add`` over the same bytes).
              Ragged K3 (``starts``: the all-to-all dispatch's packed
              buffer) and its backward are checked against the plain
              versions (K3_RAGGED_CASES: abutting segments, segments in
              reverse expert order after gaps, empty experts; the rows
              of no expert and the empty experts' dw exact zeros; each
              call on the route ``_route`` names, ``wgmma`` in bf16 where
              TMA can read the operands) and timed at the shape of the
              mesh phase's one-rank all-to-all runs (128 experts, M =
              8,192 rows of a seeded routing of 1,024 tokens to their top
              8, none dropped): gate/up and down and the backward in
              bf16 (``wgmma``), gate/up and the backward in float32
              (``f32``); these rows carry those runs' launches.  Then at
              one rank of the production mesh (qwen3-moe-235b-a22b
              train_4k on 16 x 16: M = 40,960 rows, 8 experts, a seeded
              routing at capacity factor 1.25), a shape no run here
              reaches: gate/up, down and the backward (``wgmma``), whose
              rows name the run their launches come from
              (``launches_from``, ``launches_at``); and an information
              row, the dense training capacity (E 128, C 640) as one
              packed buffer on the ragged forward.  Each row's route is
              checked on the route counters; each backward runs twice,
              ``torch.equal``; each row is beside its plain version and
              ``torch._grouped_mm`` with ``offs``, in float32 too.
              Float32 K3 (``f32``) is also timed at the dense shapes the
              float32 runs reach, beside float32 ``torch.bmm``: the MoE
              prefill held in float32 (C = 80, gate/up and down), its
              decode check (C = 4, all rows and routed) and the train
              phase's float32 gradient check's backward (C = 40, run
              twice, ``torch.equal``); these rows carry those runs'
              launches.  In ``kernel_traces`` each launch of K3's
              backward is labelled ``dx`` or ``dw``.
  4. train    five families at their published widths (TRAIN_CASES),
              each in turn: the float32 ``loss_fn`` gradients through the
              kernels and their backwards against ``attn_impl="plain"``
              (each leaf by relative L2 at 2e-3; qwen3-0.6b at 28 layers,
              B=2, T=1024; rwkv6-3b cut to 2 layers, recurrentgemma-9b to
              3, qwen3-moe-235b-a22b to 1, at B=2, T=256, each cut printed
              with its reason); 10 bf16 steps of ``TrainState`` with remat
              at B=8, T=1024 whose loss must fall, the first within 1e-2
              of the plain path's, with the exact kernel launches per step
              (qwen3-0.6b: K2 56 / 28 backward, AdamW 13, one a leaf;
              rwkv6-3b: K4 64 / 32, AdamW 20; recurrentgemma-9b: K5 50 /
              26 and K2 24 / 12, Adafactor 60, the loss in 4 sequence
              chunks; qwen3-moe-235b-a22b at 3 of 94 layers: K3 18 / 9
              and K2 6 / 3, Adafactor 15; mellum2-12b-a2.5b at one
              period, 4 of 28 layers, B=1, T=16,384, its float32
              gradients at T=2,048: K3 24 / 12 and K2 8 / 4, windowed and
              full, Adafactor 13; AdamW 0 in the Adafactor cases) and
              each backward's CUDA launches in the traced step (K2's
              backward 4 a call at recurrentgemma-9b's 8 head splits, 3
              elsewhere), no CUDA-core kernel of K2's backward, every
              K3 backward on ``wgmma``, and K2's and K4's backwards on
              the case's route (``bwd_routes``: K2 on wgmma at
              qwen3-0.6b and the MoE, wide at recurrentgemma-9b; K4 on
              the tensor cores), every call and every traced launch; ms per
              step, peak memory, each kernel's share of one traced step
              and PyTorch's bf16 / float32 fills and adds in it
              (``fill_add``); then, for qwen3-0.6b, the epoch color, the
              backup's promotion and a ``checkpoint`` round trip of the
              trained parameters (exact, and int8 within half a step).
  5. five models at their published widths, in bf16, random weights from
     a seeded ``torch.Generator``, one after the other (each freed before
     the next):
       qwen3-0.6b         prefill B=1, T=1024 (K2)
       rwkv6-3b           prefill B=1, T=1024 (K4)
       recurrentgemma-9b  prefill B=1, T=4096 > its window of 2048 (K2
                          with the window, K5)
       pixtral-12b        prefill B=1, T=1024 (K2 at hd 160; K1 at hd 160
                          in its serve), cut to 28 of its 40 layers, the
                          cut printed in its prefill line: at 40 layers the
                          int8 weight refresh would need about 81 GB (5
                          bytes per parameter, and 6 per element of the
                          largest leaf, as the MoE's measured peak reads)
       qwen3-moe-235b-a22b  prefill B=1, T=1024 (K2; K3 three times per
                          layer: the experts' gate, up and down matmuls),
                          cut to 3 of its 94 layers, the cut printed in its
                          prefill line: 470 GB of bf16 weights do not fit
                          one 80 GB card, and at 4 layers the int8 weight
                          refresh (owner's weights, int8 codes, the cached
                          bf16 copy and one leaf's float32 temporaries)
                          would need about 82 GB.
     The first three run at their published depths.
     For each, ``make_prefill`` is held against the same forward on the
     plain path (``attn_impl="plain"``: plain attention and recurrences);
     then a ``ServeEngine`` on ``Cluster(4, "drust")`` with the int8 weight
     wire serves 8 requests (half share a prefix page), every tick must
     launch each kernel of its decode path once per layer that runs it
     (K1; K4; K1 and K5; K1; K1 and three K3), and three decode steps from
     the served cache are held against the plain path.  qwen3-0.6b and
     pixtral-12b are held in bf16 (relative L2 5e-2).  The recurrent
     models are held in float32, with the same weights upcast (relative
     L2 2e-3): in bf16 their logits move by several percent for any
     change of summation order in one layer (a 1e-6 relative change of
     the recurrence's output, in float32, flips bf16 roundings that
     compound over 32 layers), so a bf16 comparison cannot tell a right
     kernel from a wrong one; the bf16
     numbers are printed beside it.  The MoE model is held in float32 too,
     for its routing: top-8 of 128 experts is discontinuous, and the two
     paths hand the router hidden states that differ by float32 summation
     order (about 1e-6) or by bf16 roundings (about 1e-2); with a typical
     gap of about 0.06 between a token's 8th and 9th router logits, an
     expert flips about once in 60,000 decisions in float32 and about once
     in 6 in bf16, where a flip changes that token's output wholesale.

  5b. cost    ``repro_torch.benchmarks.kernel_bench.all_rows()`` on the
              card (the reference's five seeded float32 inputs; each
              kernel held to its plain version at 2e-3), then
              ``launch.dryrun.trace_step`` on fake tensors on the card's
              path, on a one-rank mesh of an in-process fake process
              group: each TRAIN_CASES step at its train phase's shape,
              depth and optimizer, whose kernel launches by name must
              equal that phase's launches a step and whose parameter and
              optimizer-state bytes must equal the card's, printed with
              the traced FLOPs, the model FLOPs (6 N_active tokens), the
              phase's median step, the achieved TFLOP/s and ``mfu`` (at
              989 TFLOP/s) and the card's name and power limit, and the
              trace's temporaries beside the phase's peak (not held);
              then qwen3-0.6b's decode step at B=4, cache 2048, whose K1
              launches must equal a served tick's (28).
  6. apps     the paper's four DSM applications (``repro_torch.apps``) at
              their defaults on 4 servers, on drust, gam and grappa, GEMM's
              tiles and DataFrame's chunks on the card, each held to the
              same run on the CPU (ops, makespan and every ``NetStats``
              field exactly, DataFrame's float digest at 1e-9 relative),
              with its wall seconds; then GEMM at n = 8192 (tiles of 1024,
              the default's 8 x 8 grid): wall seconds, peak memory, the
              largest error against one ``torch.matmul`` of A and B, and
              the device time of its 512 tile products replayed back to
              back (CUDA events) beside that matmul and the float32 bound;
              then the port's borrow lint over its own app surface, which
              must report nothing.  No kernel of this repository runs here.
  7. protocol ``repro_torch.benchmarks.run.quick(device="cuda")``, the
              paper's protocol evaluation, held to the committed
              ``BENCH_protocol.json`` in every field of its eleven sections
              but the wall-clock ones (one line per section: fields
              compared, mismatches, wall seconds); then the live elastic
              rescale (``repro_torch.launch.elastic``'s
              ``run_protocol(4)``: crash, fail-over, grow), its report
              line and fail-over report held to the JAX package's.  No
              kernel runs here.
  8. mesh     the multi-device paths on a one-rank NCCL process group
              (a ``FileStore`` under ``build/``) and its (1, 1)
              ("data", "model") mesh on the card: qwen3-moe-235b-a22b cut
              to 3 of 94 layers, one B=1, T=1024 prefill through
              ``forward(mesh=)`` with the gather dispatch
              (``moe_shardmap``: K3 on the local experts, the partial
              outputs summed over ``model``), whose logits must equal the
              prefill without a mesh (``torch.equal``: a sum over one rank
              is the identity) with the same launches (K3 9, K2 3); then,
              at a capacity that drops no token (capacity factor E / k),
              the all-to-all dispatch (``moe_a2a``: ragged K3 over the
              received rows sorted by expert, 9 launches, in bf16 on
              ``wgmma``, the gather dispatch's on ``tc``; K2 3) against
              the gather dispatch, in bf16 (relative L2 5e-2) and in
              float32 (2e-3), each with its peak memory; in bf16 also
              each K3 call of one more all-to-all prefill against
              ``ref.moe_gmm`` on its own inputs (the routing's rows and
              starts, elementwise at 2e-2), and both dispatches on the
              plain path, whose relative L2s against each other and
              against the kernel runs are printed (not held: see the
              MoE's routing flips in bf16 under 5); then one gradient of
              ``loss_fn`` through the all-to-all dispatch at one layer,
              B=1, T=1024, in float32 and in bf16, against the plain path
              (each leaf by relative L2 at A2A_GRAD_TOL, 2e-3 / 1e-1; K3 6
              / 3 on the ``f32`` / ``wgmma`` routes, K2 2 / 1; in bf16
              the loss at 1e-2, each leaf at 2e-2 against the same path
              with K3 on its plain version, and each of the 3 K3 backward
              calls of one more gradient against ``ref.moe_gmm_backward``
              on its own inputs at 2e-2 of its largest entry).
              qwen3-0.6b at 28 layers: the DSM-backed engine as the serve
              phase runs it (8 requests of 16 tokens, ``Cluster(4,
              "drust")``, int8 wire)
              without a mesh, on the mesh (the same tokens; K1 28 a tick)
              and on the mesh with ``decode_shard_s`` (the cache's k/v in
              DTensor shards, the sharded partial softmax in place of K1;
              its median tick beside the others', a host cost); in bf16
              the sharded engine's tokens are printed beside the plain
              engine's, and in float32 (the weights upcast) they must be
              the same.  Then ``shard_batch`` and a checkpoint
              ``save``/``restore`` of qwen3-0.6b's parameters from and onto
              the mesh (DTensors laid out by ``param_specs``; exact), and
              ``pipeline_apply`` with one stage on the card against the
              stage applied directly.

Then one line ``{"kernels": [...]}`` with one entry per kernel and shape,
its launches counted on the path that runs it, and, last, ``{"ok": true,
"device": ...}``.  Any failed check raises, so the script exits non-zero
and prints no result; so does a machine without a card, or a directory
that holds this file and nothing else of the repository.  It imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TOLS = {"float32": 2e-3, "bfloat16": 2e-2}
# Prefill / decode logits, kernel path vs plain path, relative L2, by the
# dtype they are compared in: in bf16 the two paths round attention to bf16
# at different points in each of 28 layers, so the logits agree only to a
# few bf16 ulps; in float32 only the summation order differs.
LOGIT_REL_TOL = {"bfloat16": 5e-2, "float32": 2e-3}
# The all-to-all gradient step's leaves against the plain path, relative
# L2: float32 as the train phases hold theirs (the same products summed in
# another order).  bf16: the two paths round at different points (K2's
# bf16 probabilities against the plain attention's float32 softmax), and
# in bf16 that moves router logits enough to flip some of the 8,192 top-8
# choices (as in the bf16 prefill, PERF.md), each flip moving a whole row
# of two experts' gradients and the router's, and through them every
# token's (the H100: about 5.5e-2 in every leaf, PERF.md).  K3 itself is
# held at TOLS: each backward call on its own inputs, and the leaves
# against the same path with K3 on its plain version (``mesh_a2a_grad``).
A2A_GRAD_TOL = {"float32": 2e-3, "bfloat16": 1e-1}
NO_LIBRARY = "no single PyTorch call computes it"

# K3 on qwen3-moe-235b-a22b's path (E = 128 experts, d = 4096, expert
# d_ff = 1536): gate/up (D = d, F = d_ff) and down (D = d_ff, F = d), at
# the capacity of a T = 1024 prefill (C = 80) and of a 4-slot decode tick
# (C = 4)
K3_PATHS = [("qwen3-moe-235b-a22b prefill", 128, 80, 4096, 1536),
            ("qwen3-moe-235b-a22b prefill", 128, 80, 1536, 4096),
            ("qwen3-moe-235b-a22b serve", 128, 4, 4096, 1536),
            ("qwen3-moe-235b-a22b serve", 128, 4, 1536, 4096)]
# (E, C, D, F, strided x, rows): the path shapes, then C, D and F that no
# tile divides, C in every tile regime, x read through a row stride, and
# live rows per expert (None: all C; "partial": 0, 1, C - 1, C, ... by
# expert; "zero": none)
K3_CASES = [(E, C, D, F_, False, None) for _, E, C, D, F_ in K3_PATHS] + [
    (8, 80, 4100, 1540, False, None), (8, 4, 4100, 1540, True, None),
    (6, 37, 1000, 200, True, None), (3, 1, 64, 8, False, None),
    (5, 13, 300, 129, False, None), (4, 130, 520, 260, False, None),
    (128, 80, 4096, 1536, False, "partial"), (8, 4, 4100, 1540, True,
                                              "partial"),
    (6, 37, 1000, 200, True, "zero"), (4, 130, 520, 260, False, "partial")]

# K2's backward, (B, H, Hkv, T, S, hd, causal, window): causal T = S, full,
# T < S, a window of 2048 at T = S = 4096 (MQA), ragged T and S, every head
# dim, G = 1, 2, 4, 8 and 16; recurrentgemma-9b's training shape itself (8
# head splits in bf16), 16 splits with a ragged S at hd 256, hd 160 with a
# window (4 splits), and mellum2-12b-a2.5b's heads with its window
K2_BWD_CASES = [
    (2, 16, 8, 1024, 1024, 128, True, 0),
    (2, 16, 8, 1024, 1024, 128, False, 0),
    (2, 16, 8, 512, 1024, 128, True, 0),
    (1, 16, 1, 4096, 4096, 256, True, 2048),
    (2, 8, 8, 1000, 1000, 64, True, 0), (2, 8, 4, 77, 300, 160, True, 0),
    (2, 32, 8, 1024, 1024, 160, True, 0), (2, 4, 1, 100, 130, 32, False, 0),
    (2, 16, 2, 130, 130, 128, True, 40), (1, 4, 4, 50, 130, 256, False, 0),
    (8, 16, 1, 1024, 1024, 256, True, 2048),
    (2, 16, 1, 130, 300, 256, False, 0),
    (2, 32, 8, 1000, 1000, 160, True, 300),
    # since the wgmma kernels: G = 16 (the MoE's), MQA with ragged S and a
    # window, and q unaligned (2 bytes off), which must take the mma.sync
    # kernels (K2_BWD_ROUTES)
    (2, 64, 4, 1024, 1024, 128, True, 0),
    (1, 16, 1, 300, 700, 128, True, 100),
    (2, 16, 8, 1000, 1000, 128, True, -1),
    # mellum2-12b-a2.5b's heads (GQA 32/4) with its window of 1,024
    (1, 32, 4, 4096, 4096, 128, True, 1024)]
# the bf16 kernels each case takes (flash_attention._bwd_route): wgmma at
# hd 128 where TMA can read q, k, v and dout, tc at hd 32 / 64 and for the
# unaligned q, wide at hd 160 / 256; float32 takes cc
K2_BWD_ROUTES = ["wgmma", "wgmma", "wgmma", "wide", "tc", "wide", "wide",
                 "tc", "wgmma", "wide", "wide", "wide", "wide", "wgmma",
                 "wgmma", "tc", "wgmma"]

# The kernels of each backward route the training shapes take, as the
# profiler names them: K2's (flash_attention._bwd_route; bwd_dot and,
# where the heads are split, bwd_dkdv_sum run on every route) and K4's
# bf16 one (rwkv_scan._bwd_route; rwkv_bwd_scan and rwkv_bwd_du run on
# both routes)
K2_BWD_KERNELS = {"wgmma": ("bwd_dkdv_wgmma", "bwd_dq_wgmma"),
                  "wide": ("bwd_dkdv_wide<", "bwd_dq_wide<")}
K4_BWD_KERNELS = {"tc": ("rwkv_bwd_dstate_tc", "rwkv_bwd_chunk_tc")}
# K2's backward route at each trained head dim, and the training paths
# whose dK/dV head splits are swept (``k2_bwd_splits`` lines)
K2_TRAIN_ROUTES = {128: "wgmma", 256: "wide"}
K2_SPLIT_SWEEPS = ("recurrentgemma-9b train", "qwen3-moe-235b-a22b train")


def _k2_plain_blocks(torch, ref, block: int = 2048):
    """(attention_lse, attention_backward): ``ref``'s, over blocks of
    ``block`` queries, each against the keys its causal window reaches
    (the plain mask is bottom-right aligned, so a block's keys end at its
    last query).  At T = 16,384 the whole float32 score matrix of 32
    heads would be 34 GB.  The backward's dk and dv are summed over the
    blocks in float32 and rounded to k's dtype once."""
    def lse(q, k, v, *, window=0):
        outs, lses = [], []
        for t0 in range(0, q.shape[2], block):
            t1 = min(q.shape[2], t0 + block)
            k0 = max(0, t0 - window + 1) if window else 0
            o, l = ref.attention_lse(q[:, :, t0:t1], k[:, :, k0:t1],
                                     v[:, :, k0:t1], window=window)
            outs.append(o)
            lses.append(l)
        return torch.cat(outs, 2), torch.cat(lses, 2)

    def backward(q, k, v, out, lse, dout, *, window=0):
        dq = torch.empty_like(q)
        dk, dv = (torch.zeros(k.shape, dtype=torch.float32, device=k.device)
                  for _ in range(2))
        for t0 in range(0, q.shape[2], block):
            t1 = min(q.shape[2], t0 + block)
            k0 = max(0, t0 - window + 1) if window else 0
            q_, k_, v_, o_, do_ = (t.float() for t in (
                q[:, :, t0:t1], k[:, :, k0:t1], v[:, :, k0:t1],
                out[:, :, t0:t1], dout[:, :, t0:t1]))
            a, b, c = ref.attention_backward(q_, k_, v_, o_,
                                             lse[:, :, t0:t1], do_,
                                             window=window)
            dq[:, :, t0:t1] = a
            dk[:, :, k0:t1] += b
            dv[:, :, k0:t1] += c
        return dq, dk.to(k.dtype), dv.to(v.dtype)
    return lse, backward


def _k2_bwd_kernel_ok(name: str, route: str) -> bool:
    return any(p in name for p in ("bwd_dot<", "bwd_dkdv_sum")
               + K2_BWD_KERNELS[route])


def _k3_product(name: str) -> dict:
    """{"product": "dx" / "dw"} for a launch of K3's backward (its first
    template argument: A M-major is dw), else {}."""
    m = re.search(r"gmm_bwd_\w+<(true|false)", name)
    return {"product": "dw" if m.group(1) == "true" else "dx"} if m else {}


def _k4_bwd_kernel_ok(name: str, route: str) -> bool:
    return any(p in name for p in ("rwkv_bwd_scan", "rwkv_bwd_du")
               + K4_BWD_KERNELS[route])


# The backward kernels' checks, through the autograd Functions training
# calls, against the plain backwards (``ref.*_backward``).
# K5: (B, T, D, a, strided): the training shape, ragged T and D, B = 3
# with B/T strides (dh too), the short form (T <= 16: 1, 15, 16), one
# window, one step past it and past 16 of them, strong decay and long
# memory
K5_BWD_CASES = [(8, 1024, 4096, None, False), (3, 600, 4099, None, True),
                (2, 1, 33, None, False), (2, 15, 40, None, True),
                (2, 16, 40, None, False), (1, 17, 4096, None, False),
                (1, 257, 4096, None, False), (1, 4097, 4096, None, False),
                (1, 4096, 4096, 1e-4, False), (1, 4095, 4096, 0.999, False)]
# K3: (E, C, D, F, strided x, rows): the two training shapes, then C = 1,
# 13, 37 and 130 with ragged D and F, and rows none, partial and zero;
# rows that are no multiple of 64 with empty experts ("odd"), and a strided
# but 16-byte aligned x, which takes the wgmma route (K3_BWD_ROUTES)
K3_BWD_CASES = [(128, 640, 4096, 1536, False, "partial"),
                (128, 640, 1536, 4096, False, None),
                (3, 1, 64, 8, False, None), (5, 13, 300, 129, False, None),
                (6, 37, 1000, 200, True, "zero"),
                (4, 130, 520, 259, True, "partial"),
                (8, 640, 512, 768, False, "odd"),
                (6, 37, 1000, 200, True, "partial")]
# the bf16 kernel each case takes (moe_gmm._route): TMA needs 16-byte
# aligned rows, so F = 129 and 259 take the mma.sync kernel
K3_BWD_ROUTES = ["wgmma", "wgmma", "wgmma", "tc", "wgmma", "tc", "wgmma",
                 "wgmma"]
# ragged K3 (the all-to-all dispatch's packed buffer), forward and
# backward: (E, M, D, F, kind): abutting segments with rows of no expert
# at the end ("abutting"), segments in reverse expert order after gaps of
# rows of no expert ("gaps"), both with empty experts, one-row segments
# and ends no multiple of 16; rows TMA can read (wgmma in bf16: a last D
# stage of 8, a second N tile of 8 columns; 128 experts) and F = 260 (the
# mma.sync kernels)
K3_RAGGED_CASES = [(8, 1000, 136, 264, "abutting"),
                   (8, 1000, 136, 264, "gaps"),
                   (128, 4000, 256, 192, "gaps"),
                   (8, 640, 520, 260, "gaps")]
# K4: (B, H, T, M, S0, dS_T): the training shape (no S0, no final-state
# gradient), ragged T, B = 3, the decode step, heads under 64, an S0 that
# requires grad and a non-zero gradient of the final state
K4_BWD_CASES = [(8, 40, 1024, 64, False, False), (1, 40, 1000, 64, True, True),
                (3, 2, 130, 64, True, True), (4, 40, 1, 64, True, True),
                (1, 1, 65, 64, True, False), (2, 5, 1000, 40, True, True)]
# The tolerance of each backward, of each gradient's largest entry: K5's
# (float32) 1e-4, the same products summed in another order; K3's and
# K4's TOLS by dtype: float32 sums in another order (K4's dlogw from sums
# that cancel against factors up to e^6.7), and in bf16 a gradient rounded
# to bf16 on both sides, where a rounding that falls the other way is one
# bf16 step, up to 2^-7 of the largest entry.
K5_BWD_TOL = 1e-4

# (model, prefill length, kernel launches per prefill / per decode tick,
# the dtype the kernel path is held to the plain path in, depth cut or
# None; see the module docstring).  The MoE model runs last, after the
# others are freed: its serve phase needs the most memory.
MOE_LAYERS = 3
PIXTRAL_LAYERS = 28
# the runs of the all-to-all MoE dispatch (ragged K3) in ``mesh_moe``:
# its prefill and gradient step, in bf16 and in float32.  The kernel
# rows at their shape take these runs' launches; those at one production
# rank's shape name the run theirs come from (``launches_from``)
A2A_BF16 = "qwen3-moe-235b-a22b a2a bf16"
A2A_F32 = "qwen3-moe-235b-a22b a2a float32"
MODELS = [
    ("qwen3_0_6b", 1024, {"flash_attention": 28}, {"decode_attention": 28},
     "bfloat16", None),
    ("rwkv6_3b", 1024, {"rwkv_scan": 32}, {"rwkv_scan": 32}, "float32",
     None),
    ("recurrentgemma_9b", 4096, {"flash_attention": 12, "rglru_scan": 26},
     {"decode_attention": 12, "rglru_scan": 26}, "float32", None),
    ("pixtral_12b", 1024, {"flash_attention": PIXTRAL_LAYERS},
     {"decode_attention": PIXTRAL_LAYERS}, "bfloat16",
     {"n_layers": PIXTRAL_LAYERS,
      "why": "int8 refresh peak on one 80 GB card: about 81 GB at 40 "
             "layers, 59 GB at 28"}),
    ("qwen3_moe_235b", 1024,
     {"flash_attention": MOE_LAYERS, "moe_gmm": 3 * MOE_LAYERS},
     {"decode_attention": MOE_LAYERS, "moe_gmm": 3 * MOE_LAYERS}, "float32",
     {"n_layers": MOE_LAYERS,
      "why": "int8 refresh peak on one 80 GB card"}),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def main() -> int:
    t_start = time.perf_counter()
    # the training phases free and allocate large float32 temporaries (the
    # logits, the plain path's copies) beside a full-size model: without
    # expandable segments the allocator's cache fragments (measured on the
    # H100, when the optimizer still made leaf-sized float32 copies: 20 GB
    # reserved but unallocated when a 9 GB temporary of the MoE failed)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.kernels import _build

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
                r"(\d+) bytes spill stores", log)] or [0]),
            # each kernel's entry function (mangled) and its registers
            "entries": {f: int(r) for f, r in re.findall(
                r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                log, re.S)},
            # the entries that spill, and their spill stores in bytes
            "spills": {f: int(b) for f, b in re.findall(
                r"Compiling entry function '(\w+)'.*?"
                r"(\d+) bytes spill stores", log, re.S) if int(b)}}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(libs), "ptxas": ptxas})

    # 3. kernels -----------------------------------------------------------
    rows = kernel_phase(torch, dev)

    # 4. training, then the models -----------------------------------------
    phases = [lambda c=c: train_phase(torch, dev, c) for c in TRAIN_CASES] + [
        lambda m=m: model_phases(torch, dev, *m) for m in MODELS]
    for phase in phases:
        take_launches(rows, phase())
        gc.collect()
        torch.cuda.empty_cache()

    # 5b. the cost tooling ---------------------------------------------------
    t0 = time.perf_counter()
    cost_phase(torch, dev, smi)
    emit({"phase": "cost_total", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the DSM applications ----------------------------------------------
    t0 = time.perf_counter()
    apps_phase(torch, dev)
    emit({"phase": "apps_total", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the protocol evaluation and the elastic rescale --------------------
    t0 = time.perf_counter()
    protocol_phase(dev)
    emit({"phase": "protocol_total", "seconds": time.perf_counter() - t0})

    # 8. the multi-device paths on a one-card mesh --------------------------
    t0 = time.perf_counter()
    take_launches(rows, mesh_phase(torch, dev))
    emit({"phase": "mesh_total", "seconds": time.perf_counter() - t0})

    keys = ("name", "route", "source", "replaces", "path", "shape",
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    need(all(r["launches"] > 0 for r in rows),
         f"a kernel did not launch on its path: "
         f"{[(r['name'], r['path']) for r in rows if not r['launches']]}")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def take_launches(rows: list[dict], launches: dict) -> None:
    """Give each kernel row its launches in a phase's ``launches`` (keyed
    by path): those of its path's part before a comma ("<model> serve,
    routed": serve), or of the run its shape's ``launches_from`` names."""
    for row in rows:
        path = row["shape"].get("launches_from", row["path"].split(",")[0])
        if path in launches:
            row["launches"] = launches[path][row["name"]]


# ---------------------------------------------------------------------------
#  kernels against their plain versions, then times
# ---------------------------------------------------------------------------
def kernel_phase(torch, dev) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.kernels.decode_attention import TILE as K1_TILE
    from repro_torch.kernels.decode_attention import plan as k1_plan
    from repro_torch.models.layers import attention

    gen = torch.Generator(dev).manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def timed(fn, reps: int = 15) -> float:
        """Median ms of one launch, L2 flushed before each.  A device sleep
        (about 0.15 ms) follows the flush, so that the card is still busy
        when the host has enqueued the start event and the launch: the
        events then span the device's work and not the host's."""
        fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            torch.cuda._sleep(300_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    # -- inputs at the main paths' shapes -----------------------------------
    def k1_inputs(B, H, Hkv, S, hd, dtype, lens):
        cache = rand(2, B, S, Hkv, hd, dtype=dtype)     # the model's layout
        return (rand(B, H, hd, dtype=dtype), cache[0].permute(0, 2, 1, 3),
                cache[1].permute(0, 2, 1, 3),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    def k2_inputs(H, Hkv, T, S, hd, dtype):
        return (rand(1, H, T, hd, dtype=dtype), rand(1, Hkv, S, hd,
                                                     dtype=dtype),
                rand(1, Hkv, S, hd, dtype=dtype))

    def k4_inputs(B, H, T, M, dtype, with_s0):
        # the model's layout: (B,T,H,M) projections seen as (B,H,T,M)
        r, k, v = (rand(B, T, H, M, dtype=dtype).transpose(1, 2)
                   for _ in range(3))
        logw = (-0.105 * torch.sigmoid(rand(B, T, H, M))).transpose(1, 2)
        u = rand(H, M) * 0.1
        S0 = rand(B, H, M, M) * 0.5 if with_s0 else None
        return r, k, v, logw, u, S0

    def k3_rows(E, C, kind):
        """(E,) int32 live rows: None (all C), "partial", "zero", or
        "routed": each expert's tokens among 4 that each pick 8 of the E
        experts (a seeded draw), at most C."""
        if kind is None:
            return None
        if kind == "routed":
            g = torch.Generator(dev).manual_seed(3)
            ids = torch.randn((4, E), generator=g, device=dev).topk(8).indices
            n = torch.bincount(ids.reshape(-1), minlength=E).clamp(max=C)
            return n.to(torch.int32)
        pattern = {"partial": (0, 1, C - 1, C, C // 2, 3, C // 3, 2),
                   "odd": (0, 100, C, 1, 63, 65, 0, C - 1)}
        n = [0] * E if kind == "zero" else \
            [pattern[kind][e % 8] for e in range(E)]
        return torch.tensor(n, dtype=torch.int32, device=dev)

    def k3_ragged_rows(kind, E, M):
        """(rows, starts) (E,) int32 of a packed buffer of M rows: the
        counts 37, 0, 100, 1, 63, 65, 0, 19 by expert, cut to fit;
        "abutting": each segment right after the last, rows of no expert
        at the end; "gaps": in reverse expert order, each segment after 3
        to 7 rows of no expert."""
        rows, starts, at = [0] * E, [0] * E, 0
        for e in (reversed(range(E)) if kind == "gaps" else range(E)):
            at = min(at + (3 + e % 5 if kind == "gaps" else 0), M - 5)
            rows[e] = min(M - 5 - at, (37, 0, 100, 1, 63, 65, 0, 19)[e % 8])
            starts[e] = at
            at += rows[e]
        return (torch.tensor(rows, dtype=torch.int32, device=dev),
                torch.tensor(starts, dtype=torch.int32, device=dev))

    def k3_inputs(E, C, D, F_, dtype, strided=False):
        """x (E,C,D), or a view of a wider buffer when ``strided``, and w
        (E,D,F) as one layer's view of a stacked (2,E,D,F) leaf."""
        x = rand(E, C, D + 96 if strided else D, dtype=dtype)[..., :D]
        w = torch.empty((2, E, D, F_), dtype=dtype, device=dev)
        for e in range(E):                 # one expert at a time: no f32 copy
            w[1, e] = rand(D, F_, dtype=dtype)
        return x, w[1]

    def a2a_rank_rows(E_all=128, n_model=16, N=4096, k=8, cf=1.25):
        """(rows, starts, M) of rank 0 of the all-to-all dispatch, as
        ``moe_a2a_block`` fills it: each of n_model source ranks routes N
        seeded tokens to their top-k of E_all experts and sends rank 0 its
        top-cap (token, expert) pairs for rank 0's E_all / n_model experts
        by gate; rows (E_loc,) int32 each expert's count, starts their
        exclusive sums, M = n_model cap the packed buffer's rows."""
        E_loc = E_all // n_model
        cap = min(max(4, -(-int(N * k * cf / n_model) // 4) * 4), N * k)
        g = torch.Generator(dev).manual_seed(4)
        rows = torch.zeros(E_loc, dtype=torch.int64, device=dev)
        for _ in range(n_model):
            probs = torch.softmax(torch.randn((N, E_all), generator=g,
                                              device=dev), -1)
            top_p, top_ids = probs.topk(k)
            score = torch.where(top_ids < E_loc, top_p, float("-inf"))
            kept, idx = score.reshape(-1).topk(cap)
            ids = top_ids.reshape(-1)[idx][kept > float("-inf")]
            rows += torch.bincount(ids, minlength=E_loc)
        rows = rows.to(torch.int32)
        return rows, torch.cumsum(rows, 0, dtype=torch.int32) - rows, \
            n_model * cap

    def k5_inputs(B, T, D, a_val=None, strided=False):
        """a, b (B,T,D) float32; ``strided``: a is a window of a wider
        buffer and b a (T,B,D) buffer seen as (B,T,D)."""
        if strided:
            a = torch.sigmoid(rand(B, T + 3, D + 5))[:, 1:T + 1, 2:D + 2]
            b = rand(T + 2, B, D + 7).transpose(0, 1)[:, :T, 3:D + 3]
        else:
            a, b = torch.sigmoid(rand(B, T, D)), rand(B, T, D)
        if a_val is not None:
            a = torch.full_like(a, a_val)
        return a, b

    # -- correctness: every case, float32 and bf16 --------------------------
    checks = []

    def check(name, case, got, want, tol):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e = max(_err(g, w) for g, w in zip(got, want))
        ok = all(_within(g, w, tol) for g, w in zip(got, want))
        checks.append({"kernel": name, **case, "max_abs_err": e, "tol": tol,
                       "ok": ok})
        need(ok, f"{name} {case}: max err {e}")

    for dt in ("float32", "bfloat16"):
        dtype, tol = getattr(torch, dt), TOLS[dt]
        for B, H, Hkv, S, hd, lens in ((4, 16, 8, 2048, 128,
                                        [1, 2048, 777, 1500]),
                                       (4, 16, 1, 2048, 256,
                                        [1, 2048, 64, 1999]),
                                       (4, 64, 4, 2048, 128,    # G = 16
                                        [1, 2048, 33, 1000]),
                                       (4, 32, 8, 2048, 160,    # pixtral
                                        [1, 2048, 33, 1000])):
            ins = k1_inputs(B, H, Hkv, S, hd, dtype, lens)
            check("decode_attention", {"dtype": dt, "H": H, "Hkv": Hkv,
                                       "hd": hd, "lengths": lens},
                  ops.decode_attention(*ins), ref.decode_attention(*ins), tol)
        # K1's split over the cache at its boundaries, B = 8, each path's
        # heads: lengths 1, tile -/+ 1, split -/+ 1 and S
        for H, Hkv, hd in ((16, 8, 128), (16, 1, 256), (64, 4, 128)):
            S = 2048
            kps = k1_plan(8, H, Hkv, S, hd).keys_per_split
            lens = [1, K1_TILE - 1, K1_TILE + 1, kps - 1, kps, kps + 1,
                    2 * kps + 1, S]
            ins = k1_inputs(8, H, Hkv, S, hd, dtype, lens)
            check("decode_attention", {"dtype": dt, "H": H, "Hkv": Hkv,
                                       "hd": hd, "lengths": lens,
                                       "keys_per_split": kps},
                  ops.decode_attention(*ins), ref.decode_attention(*ins), tol)
        for H, Hkv, T, S, hd, causal, window in (
                (16, 8, 1024, 1024, 128, True, 0),
                (16, 8, 1024, 1024, 128, False, 0),
                (16, 8, 1000, 1000, 128, True, 0),
                (16, 8, 512, 1024, 128, True, 0),
                (64, 4, 1024, 1024, 128, True, 0),
                (16, 8, 1024, 1024, 64, True, 0),
                (16, 8, 1000, 1000, 128, True, -1),    # q not 16-byte aligned
                (16, 1, 4096, 4096, 256, True, 2048),
                # pixtral-12b's head dim: causal, full, ragged, T < S and
                # an unaligned q
                (32, 8, 1024, 1024, 160, True, 0),
                (32, 8, 1024, 1024, 160, False, 0),
                (32, 8, 1000, 1000, 160, True, 0),
                (32, 8, 512, 1024, 160, True, 0),
                (32, 8, 1000, 1000, 160, True, -1)):
            unaligned = window < 0
            window = max(window, 0)
            ins = k2_inputs(H, Hkv, T, S, hd, dtype)
            if unaligned:
                ins = (rand(1, H, T, hd + 1, dtype=dtype)[..., 1:],) + ins[1:]
            case = {"dtype": dt, "Hkv": Hkv, "T": T, "S": S, "hd": hd,
                    "causal": causal, "window": window,
                    "q_unaligned": unaligned}
            got = ops.flash_attention(*ins, causal=causal, window=window)
            check("flash_attention", case, got,
                  ref.attention(*ins, causal=causal, window=window), tol)
            if window:           # and the model's own plain attention
                pos = torch.arange(T, device=dev)
                want = attention(*(t.transpose(1, 2) for t in ins), pos,
                                 pos, window=window).transpose(1, 2)
                check("flash_attention", {**case, "vs": "layers.attention"},
                      got, want, tol)
        # K2's lse against the plain version's, and its backward against
        # ref.attention_backward on the same (q, k, v, out, lse, dout), the
        # inputs as the model's transposed (B, T, H, hd) views; each
        # gradient at the tolerance of its largest entry
        for case, route in zip(K2_BWD_CASES, K2_BWD_ROUTES):
            B, H, Hkv, T, S, hd, causal, window = case
            unaligned = window < 0          # q 2 bytes off its buffer
            window = max(window, 0)
            q = rand(B, T, H, hd + unaligned, dtype=dtype)[
                ..., int(unaligned):].transpose(1, 2)
            k, v = (rand(B, S, Hkv, hd, dtype=dtype).transpose(1, 2)
                    for _ in range(2))
            dout = rand(B, T, H, hd, dtype=dtype).transpose(1, 2)
            out, lse = ref.attention_lse(q, k, v, causal=causal,
                                         window=window)
            _, got_lse = k2.forward(q, k, v, causal, window, with_lse=True)
            ops.reset_launch_counts()
            got = k2.backward(q, k, v, out, lse, dout, causal=causal,
                              window=window)
            route = route if dt == "bfloat16" else "cc"
            need(k2.bwd_routes == {r: int(r == route) for r in k2.bwd_routes},
                 f"flash_attention_bwd {dt} {case}: routes {k2.bwd_routes}, "
                 f"want one {route}")
            want = ref.attention_backward(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
            errs = [_scaled_err(g, w) for g, w in zip(got, want)]
            lse_err = _err(got_lse, lse)
            checks.append({"kernel": "flash_attention_bwd", "dtype": dt,
                           "case": case, "route": route,
                           "splits": k2._bwd_plan(q, k, v, dout)[1],
                           "grad_err_of_scale": errs,
                           "lse_max_abs_err": lse_err, "tol": tol,
                           "ok": max(errs) <= tol and lse_err <= tol})
            need(checks[-1]["ok"], f"flash_attention_bwd {dt} {case}: "
                 f"errors {errs}, lse {lse_err}")
            del q, k, v, dout, out, lse, got, want
        for B, H, T, with_s0 in ((1, 40, 1024, False), (1, 40, 1000, False),
                                 (4, 40, 1, True), (1, 1, 63, False),
                                 (1, 1, 64, True), (1, 1, 65, True)):
            ins = k4_inputs(B, H, T, 64, dtype, with_s0)
            check("rwkv_scan", {"dtype": dt, "B": B, "H": H, "T": T,
                                "M": 64, "S0": with_s0},
                  ops.rwkv_scan(*ins), ref.rwkv_scan(*ins), TOLS["float32"])
        # K3: the four path shapes, then ragged C, D and F, strided x and
        # live rows
        for E, C, D, F_, strided, kind in K3_CASES:
            x, w = k3_inputs(E, C, D, F_, dtype, strided)
            r = k3_rows(E, C, kind)
            got = ops.moe_gmm(x, w, r)
            if r is not None:             # the rows past rows[e]: zeros
                live = torch.arange(C, device=dev)[None, :] < r[:, None]
                need(not got.masked_select(~live[..., None]).any(),
                     f"moe_gmm rows {kind}: nonzero rows past rows[e]")
            check("moe_gmm", {"dtype": dt, "E": E, "C": C, "D": D, "F": F_,
                              "strided_x": strided, "rows": kind},
                  got, ref.moe_gmm(x, w, r), tol)
            del x, w, got
    # K5: the path shapes and strong decay, then T = 1, a window of 256
    # steps -/+ 1 and 4095, a ragged D with B = 3 and B/T strides, and long
    # memory
    for B, T, D, a_val, strided in (
            (1, 4096, 4096, None, False), (2, 1000, 4100, None, False),
            (4, 1, 4096, None, False), (1, 4096, 4096, 1e-4, False),
            (1, 1, 4096, None, False), (1, 255, 4096, None, False),
            (1, 257, 4096, None, False), (1, 4095, 4096, None, False),
            (3, 1000, 4099, None, False), (3, 600, 4099, None, True),
            (1, 4096, 4096, 0.999, False)):
        ins = k5_inputs(B, T, D, a_val, strided)
        check("rglru_scan", {"dtype": "float32", "B": B, "T": T, "D": D,
                             "a": a_val, "strided": strided},
              ops.rglru_scan(*ins), ref.rglru_scan(*ins), TOLS["float32"])

    # the backward kernels of K3, K4 and K5, through their autograd
    # Functions as training calls them, against the plain backwards
    # (``ref.*_backward``, explicit formulas) on the same inputs, each
    # gradient at its tolerance of its largest entry
    def grad_check(name, case, got, want, tol):
        errs = [_scaled_err(g, w) for g, w in zip(got, want)]
        checks.append({"kernel": name, **case, "grad_err_of_scale": errs,
                       "tol": tol, "ok": max(errs) <= tol})
        need(checks[-1]["ok"], f"{name} {case}: errors {errs}")

    from repro_torch.kernels import moe_gmm as k3
    from repro_torch.kernels import rwkv_scan as k4

    def leaf(t):
        return t.detach().requires_grad_(True)

    for B, T, D, a_val, strided in K5_BWD_CASES:
        a, b = (leaf(t) for t in k5_inputs(B, T, D, a_val, strided))
        dh = rand(T, B, D).transpose(0, 1) if strided else rand(B, T, D)
        got = torch.autograd.grad(ops.rglru_scan(a, b), (a, b), dh)
        with torch.no_grad():
            want = ref.rglru_scan_backward(a, ref.rglru_scan(a, b), dh)
        grad_check("rglru_scan_bwd", {"dtype": "float32", "B": B, "T": T,
                                      "D": D, "a": a_val,
                                      "strided": strided},
                   got, want, K5_BWD_TOL)
        del a, b, dh, got, want
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for (E, C, D, F_, strided, kind), route in zip(K3_BWD_CASES,
                                                       K3_BWD_ROUTES):
            x, w = (leaf(t) for t in k3_inputs(E, C, D, F_, dtype, strided))
            r = k3_rows(E, C, kind)
            dy = rand(E, C, F_, dtype=dtype)
            ops.reset_launch_counts()
            got = torch.autograd.grad(ops.moe_gmm(x, w, r), (x, w), dy)
            route = route if dt == "bfloat16" else "f32"
            need(k3.bwd_routes == {k: int(k == route) for k in k3.bwd_routes},
                 f"moe_gmm_bwd {E, C, D, F_, kind} {dt}: routes "
                 f"{k3.bwd_routes}, want one {route}")
            grad_check("moe_gmm_bwd", {"dtype": dt, "E": E, "C": C, "D": D,
                                       "F": F_, "strided_x": strided,
                                       "rows": kind, "route": route},
                       got, ref.moe_gmm_backward(x.detach(), w.detach(), dy,
                                                 r), TOLS[dt])
            if r is not None:       # dead rows and empty experts: zeros
                live = torch.arange(C, device=dev)[None, :] < r[:, None]
                need(not got[0].masked_select(~live[..., None]).any()
                     and not got[1][r == 0].any(),
                     f"moe_gmm_bwd {E, C, D, F_, kind}: a dead row or an "
                     "empty expert got a non-zero gradient")
            del x, w, dy, got
        for E, M, D, F_, kind in K3_RAGGED_CASES:
            rows_r, starts_r = k3_ragged_rows(kind, E, M)
            x, w = leaf(rand(M, D, dtype=dtype)), \
                leaf(k3_inputs(E, 1, D, F_, dtype)[1])
            dy = rand(M, F_, dtype=dtype)
            ops.reset_launch_counts()
            y = ops.moe_gmm(x, w, rows_r, starts_r)
            got = torch.autograd.grad(y, (x, w), dy)
            route = "f32" if dt == "float32" else \
                "wgmma" if F_ % 8 == 0 else "tc"
            case = {"dtype": dt, "E": E, "M": M, "D": D, "F": F_,
                    "ragged": kind, "route": route}
            need(k3._route(x, w, dy) == route
                 and k3.routes == {k: int(k == route) for k in k3.routes}
                 and k3.bwd_routes == {k: int(k == route)
                                       for k in k3.bwd_routes},
                 f"moe_gmm ragged {case}: routes {k3.routes} / "
                 f"{k3.bwd_routes}")
            owned = ref._segments(rows_r, starts_r, M).any(0)
            need(not y[~owned].any() and not got[0][~owned].any()
                 and not got[1][rows_r == 0].any(),
                 f"moe_gmm ragged {case}: a row of no expert or an empty "
                 "expert is not zero")
            with torch.no_grad():
                check("moe_gmm", case, y, ref.moe_gmm(x, w, rows_r,
                                                      starts_r), TOLS[dt])
                grad_check("moe_gmm_bwd", case, got,
                           ref.moe_gmm_backward(x, w, dy, rows_r, starts_r),
                           TOLS[dt])
            del x, w, dy, y, got
        for B, H, T, M, with_s0, with_dst in K4_BWD_CASES:
            ins = [None if t is None else leaf(t)
                   for t in k4_inputs(B, H, T, M, dtype, with_s0)]
            do = rand(B, T, H, M).transpose(1, 2)
            dS = rand(B, H, M, M) * 0.5 if with_dst else None
            ops.reset_launch_counts()
            o, S = ops.rwkv_scan(*ins)
            outs, cts = ([o, S], [do, dS]) if with_dst else ([o], [do])
            got = torch.autograd.grad(outs, [t for t in ins if t is not None],
                                      cts)
            route = "tc" if dt == "bfloat16" else "cc"
            need(k4.bwd_routes == {r: int(r == route) for r in k4.bwd_routes},
                 f"rwkv_scan_bwd {dt} {B, H, T, M}: routes {k4.bwd_routes}, "
                 f"want one {route}")
            with torch.no_grad():
                want = ref.rwkv_scan_backward(*ins, do, dS)
            grad_check("rwkv_scan_bwd", {"dtype": dt, "B": B, "H": H,
                                         "T": T, "M": M, "S0": with_s0,
                                         "dS_T": with_dst, "route": route},
                       got, [t for t in want if t is not None], TOLS[dt])
            del ins, do, dS, o, S, got, want
    torch.cuda.synchronize()

    # -- times at the main paths' shapes -------------------------------------
    bf = torch.bfloat16
    rows = []
    traces = []

    def trace(name, path, fn, calls: int = 10):
        """Device time and count, per wrapper call, of each CUDA kernel that
        ``fn`` launches, from torch.profiler over ``calls`` calls.  The
        profiler now and then reports no kernel at all for a window (seen
        on the H100): such a window is taken again, at most three in all."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, 4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            kernels = [{"kernel": e.key[:90],
                        "us_per_call": e.device_time_total / calls,
                        "launches_per_call": e.count / calls,
                        **_k3_product(e.key)}
                       for e in prof.key_averages()
                       if e.device_time_total > 0]
            if kernels:
                break
        traces.append({"name": name, "path": path, "windows": attempt,
                       "kernels": kernels})

    def row(name, path, shape, ins, kernel, plain, library, work, replaces,
            scaled=False, plain_reps=15):
        """One timed row, its outputs held to the plain version's at TOLS
        of their dtype; ``work``: the call's count (``kernels/cost.py``),
        whose bound the row gives; ``scaled``: each output is held at the
        tolerance relative to its largest entry (gradients), not
        elementwise; ``plain_reps``: fewer launches for a plain version
        that takes seconds."""
        got, want = kernel(*ins), plain(*ins)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e = max(_err(g, w) for g, w in zip(got, want))
        tol = TOLS[str(got[0].dtype).removeprefix("torch.")]
        ok = (all(_scaled_err(g, w) <= tol for g, w in zip(got, want))
              if scaled else
              all(_within(g, w, tol) for g, w in zip(got, want)))
        need(ok, f"timed {name} {shape}: max err {e}")
        bound, bound_by = cost.bound_ms(*work)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "path": path, "shape": shape,
            "launches": 0, "max_abs_err": e,
            "ms": timed(lambda: kernel(*ins)),
            "plain_ms": timed(lambda: plain(*ins), plain_reps),
            "library_ms": None if library is None
            else timed(lambda: library(*ins)),
            "library_note": NO_LIBRARY if library is None else None,
            "bound_ms": bound, "bound_by": bound_by})

    K1 = "src/repro/kernels/decode_attention.py:62"
    # full lengths, then the lengths the serve path reaches (<= 33), where
    # most splits are empty
    for path, (B, H, Hkv, S, hd), length in (
            ("qwen3-0.6b serve", (4, 16, 8, 2048, 128), 2048),
            ("recurrentgemma-9b serve", (4, 16, 1, 2048, 256), 2048),
            ("qwen3-moe-235b-a22b serve", (4, 64, 4, 2048, 128), 2048),
            ("qwen3-0.6b serve", (4, 16, 8, 2048, 128), 33),
            ("qwen3-moe-235b-a22b serve", (4, 64, 4, 2048, 128), 33),
            ("pixtral-12b serve", (4, 32, 8, 2048, 160), 2048)):
        ins = k1_inputs(B, H, Hkv, S, hd, bf, [length] * B)
        pl = k1_plan(B, H, Hkv, S, hd)

        def sdpa_decode(q, k, v, lens, n=length):
            return F.scaled_dot_product_attention(
                q[:, :, None], k[:, :, :n], v[:, :, :n], enable_gqa=True)

        row("decode_attention", path,
            {"B": B, "H": H, "Hkv": Hkv, "S": S, "hd": hd,
             "lengths": "S" if length == S else length, "dtype": "bfloat16",
             "splits": pl.splits, "keys_per_split": pl.keys_per_split,
             "blocks": pl.blocks}, ins, ops.decode_attention,
            ref.decode_attention, sdpa_decode,
            cost.decode_attention(B, H, Hkv, S, hd, bf, [length] * B), K1)

    # the float32 K1 (CUDA cores) at the same shapes, beside the bf16 rows
    # (tensor cores): what the CUDA-core design costs as G grows
    k1_f32 = []
    for path, (B, H, Hkv, S, hd), length in (
            ("qwen3-0.6b serve", (4, 16, 8, 2048, 128), 2048),
            ("recurrentgemma-9b serve", (4, 16, 1, 2048, 256), 2048),
            ("qwen3-moe-235b-a22b serve", (4, 64, 4, 2048, 128), 2048),
            ("qwen3-0.6b serve", (4, 16, 8, 2048, 128), 33),
            ("recurrentgemma-9b serve", (4, 16, 1, 2048, 256), 33),
            ("qwen3-moe-235b-a22b serve", (4, 64, 4, 2048, 128), 33)):
        ins = k1_inputs(B, H, Hkv, S, hd, torch.float32, [length] * B)
        k1_f32.append({"path": path, "lengths": length,
                       "ms": timed(lambda: ops.decode_attention(*ins))})
    emit({"phase": "k1_float32", "route": "CUDA cores", "times": k1_f32})

    # host time of one K1 wrapper call: a host clock over 1,000 calls at
    # the serve path's shape and length, without synchronising; the events
    # around the same calls give the device's time for them back to back
    ins = k1_inputs(4, 16, 8, 2048, 128, bf, [33] * 4)
    for _ in range(20):
        ops.decode_attention(*ins)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(1000):
        ops.decode_attention(*ins)
    host_us = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    emit({"phase": "k1_host", "shape": "qwen3-0.6b serve, lengths 33",
          "calls": 1000, "host_us_per_call": host_us,
          "events_us_per_call": start.elapsed_time(end)})

    K2 = "src/repro/kernels/flash_attention.py:68"
    for path, (H, Hkv, T, hd, window) in (
            ("qwen3-0.6b prefill", (16, 8, 1024, 128, 0)),
            ("recurrentgemma-9b prefill", (16, 1, 4096, 256, 2048)),
            ("qwen3-moe-235b-a22b prefill", (64, 4, 1024, 128, 0)),
            ("pixtral-12b prefill", (32, 8, 1024, 160, 0))):
        ins = k2_inputs(H, Hkv, T, T, hd, bf)
        mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        if window:
            mask &= ~mask.tril(-window)

        def sdpa(q, k, v, mask=mask if window else None):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        row("flash_attention", path,
            {"B": 1, "H": H, "Hkv": Hkv, "T": T, "S": T, "hd": hd,
             "causal": True, "window": window, "dtype": "bfloat16"}, ins,
            lambda q, k, v, w=window: ops.flash_attention(q, k, v, window=w),
            lambda q, k, v, w=window: ref.attention(q, k, v, window=w),
            sdpa, cost.flash_attention(1, H, Hkv, T, T, hd, bf,
                                       window=window), K2)

    # the training paths: K2's forward and its backward at each trained
    # family's shape, the backward beside SDPA's backward (only the
    # torch.autograd.grad call is timed); mellum2-12b-a2.5b's two kinds at
    # the benchmark cell's 16,384 tokens, held to the plain version over
    # blocks of queries (``_k2_plain_blocks``)
    for path, (B, H, Hkv, T, hd, window) in (
            ("qwen3-0.6b train", (8, 16, 8, 1024, 128, 0)),
            ("recurrentgemma-9b train", (8, 16, 1, 1024, 256, 2048)),
            ("qwen3-moe-235b-a22b train", (8, 64, 4, 1024, 128, 0)),
            ("mellum2-12b-a2.5b train, windowed",
             (1, 32, 4, 16384, 128, 1024)),
            ("mellum2-12b-a2.5b train, full", (1, 32, 4, 16384, 128, 0))):
        plain_lse, plain_bwd = (ref.attention_lse, ref.attention_backward) \
            if T <= 4096 else _k2_plain_blocks(torch, ref)
        tshape = {"B": B, "H": H, "Hkv": Hkv, "T": T, "S": T, "hd": hd,
                  "causal": True, "window": window, "dtype": "bfloat16"}
        mask = None
        if window:
            mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
            mask &= ~mask.tril(-window)
        q, k, v, dout = (rand(B, n, T, hd, dtype=bf)
                         for n in (H, Hkv, Hkv, H))

        def sdpa(q, k, v, mask=mask, repeat=T > 4096 and window):
            if repeat:
                # GQA by repeated k and v: the memory-efficient kernel then
                # takes the mask, where the math one would hold 32 x
                # 16,384^2 scores
                k, v = (t.repeat_interleave(q.shape[1] // t.shape[1], 1)
                        for t in (k, v))
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=not repeat)
        row("flash_attention", path, tshape, (q, k, v),
            lambda q, k, v, w=window: ops.flash_attention(q, k, v, window=w),
            lambda q, k, v, w=window: plain_lse(q, k, v, window=w)[0],
            sdpa, cost.flash_attention(B, H, Hkv, T, T, hd, bf, window=window),
            K2, plain_reps=15 if T <= 4096 else 3)
        out, lse = plain_lse(q, k, v, window=window)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = sdpa(*leaves)
        route, splits = k2._bwd_plan(q, k, v, dout)
        need(route == K2_TRAIN_ROUTES[hd], f"flash_attention_bwd {path}: "
             f"route {route}, want {K2_TRAIN_ROUTES[hd]}")
        # deterministic: no atomics, the splits' partials added in order
        twice = [k2.backward(q, k, v, out, lse, dout, window=window)
                 for _ in range(2)]
        need(all(torch.equal(a, b) for a, b in zip(*twice)),
             f"flash_attention_bwd {path}: two runs differ")
        del twice
        row("flash_attention_bwd", path, {**tshape, "splits": splits,
                                          "route": route},
            (q, k, v, out, lse, dout),
            lambda *a, w=window: k2.backward(*a, window=w),
            lambda *a, w=window: plain_bwd(*a, window=w),
            lambda *_: torch.autograd.grad(sdpa_out, leaves, dout,
                                           retain_graph=True),
            cost.flash_attention_bwd(B, H, Hkv, T, T, hd, bf, window=window),
            "none: no Pallas backward; the reference takes jax.grad of "
            "src/repro/models/layers.py:51", scaled=True,
            plain_reps=15 if T <= 4096 else 3)
        trace("flash_attention_bwd", path,
              lambda: k2.backward(q, k, v, out, lse, dout, window=window))
        names = [t["kernel"] for t in traces[-1]["kernels"]]
        # bf16 runs on the tensor cores: only the route's kernels (at hd
        # 128 the wgmma ones), and the sum of the splits' partials exactly
        # when there are splits
        need(all(_k2_bwd_kernel_ok(n, route) for n in names)
             and any("bwd_dkdv_sum" in n for n in names) == (splits > 1),
             f"flash_attention_bwd {path} (splits {splits}) ran {names}")
        if path in K2_SPLIT_SWEEPS:
            # every split of the group (the rule substituted by each) beside
            # the rule's choice and SDPA's backward, in turns (forward,
            # then backward), medians
            sweep = {d: [] for d in range(1, H // Hkv + 1)
                     if (H // Hkv) % d == 0}
            sdpa_ms, rule = [], k2._dkdv_splits
            try:
                for order in (list(sweep), list(sweep)[::-1]):
                    sdpa_ms.append(timed(lambda: torch.autograd.grad(
                        sdpa_out, leaves, dout, retain_graph=True)))
                    for d in order:
                        k2._dkdv_splits = lambda *_, d=d: d
                        sweep[d].append(timed(lambda: k2.backward(
                            q, k, v, out, lse, dout, window=window)))
            finally:
                k2._dkdv_splits = rule
            emit({"phase": "k2_bwd_splits", "path": path, "rule": splits,
                  "ms": {d: statistics.median(t) for d, t in sweep.items()},
                  "sdpa_backward_ms": statistics.median(sdpa_ms)})
        del q, k, v, dout, out, lse, leaves, sdpa_out, mask
    # the training paths' rows as soon as they are timed (the kernels line
    # comes only at the end of the run)
    emit({"phase": "k2_train", "rows": [r for r in rows if r["name"] in (
        "flash_attention", "flash_attention_bwd") and "train" in r["path"]]})

    # all C rows of every expert (rows=None), then the serve
    # path's routed decode: the rows of a seeded top-8 draw for 4 tokens,
    # bound by the live experts' bytes; torch.bmm computes every expert
    for path, E, C, D, F_ in K3_PATHS + [
            ("qwen3-moe-235b-a22b serve, routed", *p[1:]) for p in K3_PATHS
            if "serve" in p[0]]:
        x, w = k3_inputs(E, C, D, F_, bf)
        shape = {"E": E, "C": C, "D": D, "F": F_, "dtype": "bfloat16"}
        r = k3_rows(E, C, "routed" if "routed" in path else None)
        live, n_rows = E, E * C
        if r is not None:
            live, n_rows = int((r > 0).sum()), int(r.sum())
            shape.update(rows="routed", live_experts=live, live_rows=n_rows)
        row("moe_gmm", path, shape, (x, w, r), ops.moe_gmm, ref.moe_gmm,
            lambda x, w, r: torch.bmm(x, w),
            cost.moe_gmm(E, C, D, F_, bf, None if r is None else r.tolist()),
            "src/repro/kernels/moe_gmm.py:42")
        if D == 4096:                      # gate/up: prefill and routed
            trace("moe_gmm", path, lambda: ops.moe_gmm(x, w, r))
        del x, w

    for path, (B, T, with_s0) in (("rwkv6-3b prefill", (1, 1024, False)),
                                  ("rwkv6-3b serve", (4, 1, True))):
        H, M = 40, 64
        ins = k4_inputs(B, H, T, M, bf, with_s0)
        row("rwkv_scan", path,
            {"B": B, "H": H, "T": T, "M": M, "S0": with_s0,
             "dtype": "bfloat16"}, ins, ops.rwkv_scan, ref.rwkv_scan, None,
            cost.rwkv_scan(B, H, T, M, bf, S0=with_s0),
            "src/repro/kernels/rwkv_scan.py:61")
        trace("rwkv_scan", path, lambda: ops.rwkv_scan(*ins))

    for path, (B, T) in (("recurrentgemma-9b prefill", (1, 4096)),
                         ("recurrentgemma-9b serve", (4, 1))):
        D = 4096
        ins = k5_inputs(B, T, D)
        row("rglru_scan", path, {"B": B, "T": T, "D": D,
                                 "dtype": "float32"},
            ins, ops.rglru_scan, ref.rglru_scan, None,
            cost.rglru_scan(B, T, D), "src/repro/kernels/rglru_scan.py:42")
        trace("rglru_scan", path, lambda: ops.rglru_scan(*ins))
    # K5's prefill bytes (read a and b, write h) in one elementwise pass:
    # what the card's memory gives a plain streaming kernel, beside the
    # bound's 3.35 TB/s
    a, b = k5_inputs(1, 4096, 4096)
    h = torch.empty_like(a)
    emit({"phase": "k5_same_bytes", "shape": [1, 4096, 4096],
          "bytes": 3 * a.numel() * 4,
          "torch_add_ms": timed(lambda: torch.add(a, b, out=h))})
    del a, b, h

    # the backward kernels at the training shapes (B=8, T=1024), each
    # beside its plain backward (``ref.*_backward``)
    from repro_torch.kernels import rglru_scan as k5
    no_pallas = ("none: no Pallas backward; the reference takes jax.grad of "
                 "src/repro/models/")

    B, T, D = 8, 1024, 4096
    a, b = k5_inputs(B, T, D)
    n = a.numel()
    row("rglru_scan", "recurrentgemma-9b train",
        {"B": B, "T": T, "D": D, "dtype": "float32"}, (a, b),
        ops.rglru_scan, ref.rglru_scan, None, cost.rglru_scan(B, T, D),
        "src/repro/kernels/rglru_scan.py:42", plain_reps=3)
    dh = rand(B, T, D)
    h = k5.forward(a, b)
    row("rglru_scan_bwd", "recurrentgemma-9b train",
        {"B": B, "T": T, "D": D, "dtype": "float32"}, (a, h, dh),
        k5.backward, ref.rglru_scan_backward, None,
        cost.rglru_scan_bwd(B, T, D), no_pallas + "rglru.py:80", scaled=True,
        plain_reps=3)
    trace("rglru_scan_bwd", "recurrentgemma-9b train",
          lambda: k5.backward(a, h, dh))
    # the same bytes in one elementwise pass (two reads, one write)
    x = torch.empty(20 * n // 12, dtype=torch.float32, device=dev)
    y, z = torch.empty_like(x), torch.empty_like(x)
    emit({"phase": "k5_bwd_same_bytes", "shape": [B, T, D],
          "bytes": 20 * n,
          "torch_add_ms": timed(lambda: torch.add(x, y, out=z))})
    del a, b, dh, h, x, y, z

    for path, E, C, D, F_ in (("qwen3-moe-235b-a22b train", 128, 640, 4096,
                               1536),
                              ("qwen3-moe-235b-a22b train", 128, 640, 1536,
                               4096)):
        x, w = k3_inputs(E, C, D, F_, bf)
        dy = rand(E, C, F_, dtype=bf)
        twice = [k3.backward(x, w, dy) for _ in range(2)]
        need(all(torch.equal(a, b) for a, b in zip(*twice)),
             f"moe_gmm_bwd {path} {D}: two runs differ")
        del twice
        ops.reset_launch_counts()
        row("moe_gmm", path, {"E": E, "C": C, "D": D, "F": F_,
                              "dtype": "bfloat16"}, (x, w, None),
            ops.moe_gmm, ref.moe_gmm, lambda x, w, r: torch.bmm(x, w),
            cost.moe_gmm(E, C, D, F_, bf), "src/repro/kernels/moe_gmm.py:42",
            plain_reps=3)
        row("moe_gmm_bwd", path, {"E": E, "C": C, "D": D, "F": F_,
                                  "dtype": "bfloat16",
                                  "route": k3._route(x, w, dy)}, (x, w, dy),
            k3.backward, ref.moe_gmm_backward,
            lambda x, w, dy: (torch.bmm(dy, w.transpose(1, 2)),
                              torch.bmm(x.transpose(1, 2), dy)),
            cost.moe_gmm_bwd(E, C, D, F_, bf), no_pallas + "moe.py:76",
            scaled=True, plain_reps=3)
        need(rows[-1]["shape"]["route"] == "wgmma" and k3.bwd_launches > 0
             and k3.bwd_routes == {"wgmma": k3.bwd_launches, "tc": 0,
                                   "f32": 0},
             f"moe_gmm_bwd {path} {D}: routes {k3.bwd_routes}, want wgmma")
        trace("moe_gmm_bwd", path, lambda: k3.backward(x, w, dy))
        del x, w, dy

    # float32 K3 at the dense shapes the runs reach in float32 (``f32``:
    # the loop of csrc/gmm_f32.cuh, the split-D tiles at 32 rows or fewer):
    # the MoE prefill held in float32 (C = 80) and its decode check
    # (C = 4, all rows and routed), and the train phase's float32
    # gradient check (B=2, T=256: C = 40), its backward; each beside
    # float32 ``torch.bmm``, the backward twice ``torch.equal``
    moe = "qwen3-moe-235b-a22b"
    f32 = torch.float32
    for path, C, D, F_, bwd in (
            (f"{moe} prefill float32", 80, 4096, 1536, False),
            (f"{moe} prefill float32", 80, 1536, 4096, False),
            (f"{moe} decode float32", 4, 4096, 1536, False),
            (f"{moe} decode float32", 4, 1536, 4096, False),
            (f"{moe} decode float32, routed", 4, 4096, 1536, False),
            (f"{moe} decode float32, routed", 4, 1536, 4096, False),
            (f"{moe} train float32", 40, 4096, 1536, True),
            (f"{moe} train float32", 40, 1536, 4096, True)):
        E = 128
        x, w = k3_inputs(E, C, D, F_, f32)
        r = k3_rows(E, C, "routed" if "routed" in path else None)
        shape = {"E": E, "C": C, "D": D, "F": F_, "dtype": "float32",
                 "route": "f32"}
        if r is not None:
            shape.update(rows="routed", live_experts=int((r > 0).sum()),
                         live_rows=int(r.sum()))
        ops.reset_launch_counts()
        if not bwd:
            row("moe_gmm", path, shape, (x, w, r), ops.moe_gmm, ref.moe_gmm,
                lambda x, w, r: torch.bmm(x, w),
                cost.moe_gmm(E, C, D, F_, f32,
                             None if r is None else r.tolist()),
                "src/repro/kernels/moe_gmm.py:42", plain_reps=3)
            need(k3.routes == {"wgmma": 0, "tc": 0, "f32": k3.launches}
                 and k3.launches > 0,
                 f"moe_gmm {path} {D}: routes {k3.routes}, want f32")
            if D == 4096 and r is None:
                trace("moe_gmm", path, lambda: ops.moe_gmm(x, w))
            del x, w
            continue
        dy = rand(E, C, F_)
        twice = [k3.backward(x, w, dy) for _ in range(2)]
        need(all(torch.equal(a, b) for a, b in zip(*twice)),
             f"moe_gmm_bwd {path} {D}: two runs differ")
        del twice
        ops.reset_launch_counts()
        row("moe_gmm_bwd", path, shape, (x, w, dy), k3.backward,
            ref.moe_gmm_backward,
            lambda x, w, dy: (torch.bmm(dy, w.transpose(1, 2)),
                              torch.bmm(x.transpose(1, 2), dy)),
            cost.moe_gmm_bwd(E, C, D, F_, f32), no_pallas + "moe.py:76",
            scaled=True, plain_reps=3)
        need(k3.bwd_routes == {"wgmma": 0, "tc": 0, "f32": k3.bwd_launches}
             and k3.bwd_launches > 0,
             f"moe_gmm_bwd {path} {D}: routes {k3.bwd_routes}, want f32")
        trace("moe_gmm_bwd", path, lambda: k3.backward(x, w, dy))
        del x, w, dy

    # ragged K3 (``starts``): first at the shape of ``mesh_moe``'s one-rank
    # all-to-all runs (E_loc 128, M 8,192: 1,024 tokens to their top 8 of
    # 128, none dropped), in bf16 and float32 (each dtype's prefill and
    # gradient step), whose launches these rows carry; then at one rank of
    # the production mesh (qwen3-moe-235b-a22b train_4k on 16 x 16: E_loc
    # 8, M 16 x 2,560, cf 1.25), a shape no run of this script reaches,
    # whose rows name the run their launches come from (``launches_from``);
    # last an information row: the dense training capacity (E 128, C 640)
    # seen as one packed buffer (starts[e] = 640 e, rows[e] = 640) on the
    # ragged forward, beside the dense row above (the dense forward keeps
    # its mma.sync kernel), held against the dense plain version, which
    # computes the same function.  Each row names its route, checked on
    # the route counters, and is beside ``torch._grouped_mm`` with
    # ``offs`` (the segments' ends), which takes float32 too.
    nodrop = {"n_model": 1, "N": 1024, "cf": 128 / 8}
    elsewhere = {"launches_from": A2A_BF16,
                 "launches_at": "E 128, M 8192: no run reaches this shape"}
    packed = {"launches_from": A2A_BF16, "information": "the dense "
              "training capacity as one packed buffer: no run reaches this "
              "form; the dense forward keeps mma.sync"}
    for path, at, dt, products, bwd, label in (
            (A2A_BF16 + ", one rank, no drop", nodrop, bf,
             ((4096, 1536), (1536, 4096)), True, {}),
            (A2A_F32 + ", one rank, no drop", nodrop, torch.float32,
             ((4096, 1536),), True, {}),
            (A2A_BF16 + ", one rank of 16x16 train_4k", {}, bf,
             ((4096, 1536), (1536, 4096)), True, elsewhere),
            ("qwen3-moe-235b-a22b train, packed (information)", None, bf,
             ((4096, 1536),), False, packed)):
        if at is None:                    # E 128 x C 640 as packed rows
            E, C = 128, 640
            rows_a = torch.full((E,), C, dtype=torch.int32, device=dev)
            starts_a = torch.arange(0, E * C, C, dtype=torch.int32,
                                    device=dev)
            M = E * C
        else:
            rows_a, starts_a, M = a2a_rank_rows(**at)
            E = rows_a.shape[0]
        offs = torch.cumsum(rows_a, 0, dtype=torch.int32)
        dname = str(dt).removeprefix("torch.")
        for D, F_ in products:
            x = rand(M, D, dtype=dt)
            w = k3_inputs(E, 1, D, F_, dt)[1]
            shape = {"E": E, "M": M, "D": D, "F": F_, "dtype": dname,
                     "ragged": True, "live_rows": int(rows_a.sum()),
                     "rows": rows_a.tolist(),
                     "route": k3._fwd_route(x, w, ragged=True), **label}
            plain = ref.moe_gmm if at is not None else (
                lambda x, w, r, s: ref.moe_gmm(
                    x.view(E, C, D), w).reshape(E * C, F_))
            ops.reset_launch_counts()
            row("moe_gmm", path, shape, (x, w, rows_a, starts_a),
                ops.moe_gmm, plain,
                lambda x, w, r, s: torch._grouped_mm(x, w, offs=offs),
                cost.moe_gmm(E, M, D, F_, dt, rows_a.tolist(), ragged=True),
                "src/repro/kernels/moe_gmm.py:42", plain_reps=3)
            route = "wgmma" if dt == bf else "f32"
            need(shape["route"] == route and k3.launches > 0 and
                 k3.routes == {**{r: 0 for r in k3.routes},
                               route: k3.launches},
                 f"moe_gmm {path} {D}: routes {k3.routes}, want {route}")
            if D == 4096:
                trace("moe_gmm", path,
                      lambda: ops.moe_gmm(x, w, rows_a, starts_a))
            if D != 4096 or not bwd:
                del x, w
                continue
            dy = rand(M, F_, dtype=dt)
            twice = [k3.backward(x, w, dy, rows_a, starts_a)
                     for _ in range(2)]
            need(all(torch.equal(a, b) for a, b in zip(*twice)),
                 f"moe_gmm_bwd {path}: two runs differ")
            del twice
            ops.reset_launch_counts()
            row("moe_gmm_bwd", path,
                {**shape, "route": k3._route(x, w, dy)},
                (x, w, dy, rows_a, starts_a), k3.backward,
                ref.moe_gmm_backward,
                lambda x, w, dy, r, s: (
                    torch._grouped_mm(dy, w.transpose(1, 2), offs=offs),
                    torch._grouped_mm(x.t(), dy, offs=offs)),
                cost.moe_gmm_bwd(E, M, D, F_, dt, rows_a.tolist(),
                                 ragged=True), no_pallas + "moe.py:76",
                scaled=True, plain_reps=3)
            need(rows[-1]["shape"]["route"] == route and k3.bwd_launches > 0
                 and k3.bwd_routes == {**{r: 0 for r in k3.bwd_routes},
                                       route: k3.bwd_launches},
                 f"moe_gmm_bwd {path}: routes {k3.bwd_routes}, "
                 f"want {route}")
            trace("moe_gmm_bwd", path,
                  lambda: k3.backward(x, w, dy, rows_a, starts_a))
            del x, w, dy

    B, H, T, M = 8, 40, 1024, 64
    r, k, v, logw, u, _ = k4_inputs(B, H, T, M, bf, False)
    row("rwkv_scan", "rwkv6-3b train",
        {"B": B, "H": H, "T": T, "M": M, "S0": False, "dtype": "bfloat16"},
        (r, k, v, logw, u), ops.rwkv_scan, ref.rwkv_scan, None,
        cost.rwkv_scan(B, H, T, M, bf), "src/repro/kernels/rwkv_scan.py:61",
        plain_reps=3)
    states = k4.forward(r, k, v, logw, u)[2]
    do = rand(B, T, H, M).transpose(1, 2)
    need(k4._bwd_route(r) == "tc", "rwkv_scan_bwd train: route "
         f"{k4._bwd_route(r)}, want tc")
    # deterministic: every sum inside one block, du summed in a fixed order
    twice = [k4.backward(r, k, v, logw, u, None, states, do)[:5]
             for _ in range(2)]
    need(all(torch.equal(a, b) for a, b in zip(*twice)),
         "rwkv_scan_bwd rwkv6-3b train: two runs differ")
    del twice
    row("rwkv_scan_bwd", "rwkv6-3b train",
        {"B": B, "H": H, "T": T, "M": M, "S0": False, "dS_T": False,
         "dtype": "bfloat16", "route": "tc"}, (r, k, v, logw, u, states, do),
        lambda r, k, v, logw, u, st, do: k4.backward(
            r, k, v, logw, u, None, st, do)[:5],
        lambda r, k, v, logw, u, st, do: ref.rwkv_scan_backward(
            r, k, v, logw, u, None, do)[:5], None,
        cost.rwkv_scan_bwd(B, H, T, M, bf), no_pallas + "rwkv.py:64",
        scaled=True, plain_reps=3)
    trace("rwkv_scan_bwd", "rwkv6-3b train",
          lambda: k4.backward(r, k, v, logw, u, None, states, do))
    names = [t["kernel"] for t in traces[-1]["kernels"]]
    need(len(names) == 4 and all(_k4_bwd_kernel_ok(n, "tc") for n in names),
         f"rwkv_scan_bwd rwkv6-3b train ran {names}")
    del r, k, v, logw, u, states, do

    # Adafactor's update of the MoE's stacked w_gate at 3 layers, (3, 128,
    # 4096, 1536) bf16, 2.4 G parameters, at a step past the first (decay
    # 0.6): its three kernel passes against the plain passes of ``ref``
    # (the float32 PyTorch chain the optimizer ran before the kernels),
    # the parameter held within one bf16 ulp and the state at 1e-5
    shape = (3, 128, 4096, 1536)
    p = torch.empty(shape, dtype=bf, device=dev)
    g = torch.empty_like(p)
    for i in range(shape[0]):              # no float32 copy of the leaf
        p[i] = rand(*shape[1:], dtype=bf) * 0.02
        g[i] = rand(*shape[1:], dtype=bf) * 1e-4
    vr = torch.rand((*shape[:-1], 1), generator=gen, device=dev) * 1e-8
    vc = torch.rand((*shape[:-2], 1, shape[-1]), generator=gen,
                    device=dev) * 1e-8
    step = [torch.tensor(x, device=dev) for x in (0.9, 0.6, 1e-3)]

    def af_kernel(p, g, vr, vc):
        st = ops.adafactor_stats(g)
        ops.adafactor_update(p, g, vr, vc, st, *step, 1e-8, 0.01)

    def af_plain(p, g, vr, vc):
        ref.adafactor_update(p, g, vr, vc, ref.adafactor_stats(g), *step,
                             1e-8, 0.01)

    got, want = [p.clone(), vr.clone(), vc.clone()], [p.clone(), vr, vc]
    af_kernel(got[0], g, got[1], got[2])
    af_plain(want[0], g, want[1], want[2])
    torch.cuda.synchronize()
    # within one bf16 ulp, beside 1e-8 for the float32 rounding of an
    # update that all but cancels its parameter
    w = want[0].float()
    diff = (got[0].float() - w).abs()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    ulps = float((diff / (ulp + 1e-8)).max())         # at most 1
    need(ulps <= 1
         and all(_within(a, b, 1e-5) for a, b in zip(got[1:], want[1:])),
         f"adafactor w_gate: {ulps} bf16 ulps, vr/vc err "
         f"{[_err(a, b) for a, b in zip(got[1:], want[1:])]}")
    del diff, ulp
    bound, bound_by = cost.bound_ms(*cost.adafactor(384, 4096, 1536, bf,
                                                    bf))
    rows.append({
        "name": "adafactor", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adafactor.cu",
        "replaces": "none: the JAX package leaves its optimizer to XLA "
                    "(src/repro/train/optimizer.py:116)",
        "path": "qwen3-moe-235b-a22b train",
        "shape": {"leaf": "layers.moe.w_gate", "shape": list(shape),
                  "dtype": "bfloat16", "decay": 0.6,
                  "max_err_in_ulps_beside_1e-8": ulps},
        "launches": 0, "max_abs_err": _err(got[0], want[0]),
        "ms": timed(lambda: af_kernel(p, g, vr, vc)),
        "plain_ms": timed(lambda: af_plain(p, g, vr, vc), 5),
        "library_ms": None, "library_note": NO_LIBRARY,
        "bound_ms": bound, "bound_by": bound_by})
    trace("adafactor", "qwen3-moe-235b-a22b train",
          lambda: af_kernel(p, g, vr, vc))
    del p, g, vr, vc, got, want, w

    # AdamW's update of rwkv6-3b's stacked channel-mix key ``layers.ck``,
    # (32, 2560, 8960) bf16 with float32 moments, 734 M parameters, at step
    # 3 with the clip's scale 0.7: its two kernel passes (the norm's sum of
    # squares, then the fused update) against the plain passes of ``ref``
    # (the float32 PyTorch chain the optimizer ran before the kernels), the
    # sum at 8e-6, the parameter within one bf16 ulp and the moments at
    # 1e-6; the update pass is also timed alone against its 22 bytes a
    # parameter
    shape = (32, 2560, 8960)
    p = torch.empty(shape, dtype=bf, device=dev)
    g = torch.empty_like(p)
    mu = torch.empty(shape, device=dev)
    nu = torch.empty(shape, device=dev)
    for i in range(shape[0]):              # no float32 copy of the leaf
        p[i] = rand(*shape[1:], dtype=bf) * 0.02
        g[i] = rand(*shape[1:], dtype=bf) * 1e-4
        mu[i] = rand(*shape[1:]) * 1e-6
        nu[i] = rand(*shape[1:]).square_() * 1e-10
    hyper = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "wd": 0.01}
    step = [torch.tensor(x, device=dev) for x in
            (0.7, 1e-3, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]   # scale, lr, bc1, bc2

    def aw_update(p, g, mu, nu):
        ops.adamw_update(p, g, mu, nu, *step, **hyper)

    def aw_kernel(p, g, mu, nu):
        ops.adamw_sumsq(g)
        aw_update(p, g, mu, nu)

    def aw_plain(p, g, mu, nu):
        ref.adamw_sumsq(g)
        ref.adamw_update(p, g, mu, nu, *step, **hyper)

    sq, sq_want = ops.adamw_sumsq(g), ref.adamw_sumsq(g)
    got, want = [p.clone(), mu.clone(), nu.clone()], [p, mu, nu]
    ops.adamw_update(got[0], g, got[1], got[2], *step, **hyper)
    want = [t.clone() for t in want]
    ref.adamw_update(want[0], g, want[1], want[2], *step, **hyper)
    torch.cuda.synchronize()
    sq_err = abs(float(sq) / float(sq_want) - 1)
    w = want[0].float()
    diff = (got[0].float() - w).abs()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    ulps = float((diff / (ulp + 1e-8)).max())         # at most 1
    need(sq_err <= 8e-6 and ulps <= 1
         and all(_within(a, b, 1e-6) for a, b in zip(got[1:], want[1:])),
         f"adamw ck: sum of squares err {sq_err}, {ulps} bf16 ulps, mu/nu "
         f"err {[_err(a, b) for a, b in zip(got[1:], want[1:])]}")
    max_err = _err(got[0], want[0])
    del diff, ulp, w, got, want
    bound, bound_by = cost.bound_ms(*cost.adamw(p.numel(), bf, bf,
                                                torch.float32))
    up_bound, _ = cost.bound_ms(*cost.adamw(p.numel(), bf, bf, torch.float32,
                                            norm=False))
    rows.append({
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "none: the JAX package leaves its optimizer to XLA "
                    "(src/repro/train/optimizer.py:96)",
        "path": "rwkv6-3b train",
        "shape": {"leaf": "layers.ck", "shape": list(shape),
                  "dtype": "bfloat16", "moments": "float32", "step": 3,
                  "sumsq_rel_err": sq_err,
                  "max_err_in_ulps_beside_1e-8": ulps,
                  "update_ms": timed(lambda: aw_update(p, g, mu, nu)),
                  "update_bound_ms": up_bound},
        "launches": 0, "max_abs_err": max_err,
        "ms": timed(lambda: aw_kernel(p, g, mu, nu)),
        "plain_ms": timed(lambda: aw_plain(p, g, mu, nu), 5),
        "library_ms": None,
        "library_note": "no single PyTorch call computes it: "
                        "torch._fused_adamw_ keeps the moments in the "
                        "parameter's dtype and decays the parameter first",
        "bound_ms": bound, "bound_by": bound_by})
    trace("adamw", "rwkv6-3b train", lambda: aw_kernel(p, g, mu, nu))
    del p, g, mu, nu, sq, sq_want

    emit({"phase": "kernel_traces", "traces": traces})
    emit({"phase": "kernels", "checks": checks,
          "times": [{k: r[k] for k in ("name", "path", "shape", "ms",
                                        "plain_ms", "library_ms",
                                        "library_note", "bound_ms",
                                        "bound_by")} for r in rows]})
    return rows


# ---------------------------------------------------------------------------
#  training: gradient parity, steps (and, for qwen3-0.6b, epochs and
#  checkpoints)
# ---------------------------------------------------------------------------
TRAIN_STEPS = 10
# The profiler's names of each kernel's CUDA launches; a name counts for
# the first entry it matches, the backwards first.  A backward call is
# BWD_CUDA_PER_CALL CUDA launches, unless its train case says otherwise
# ("cuda_per_call": K2's backward is four launches where its heads are
# split, the fourth the dK/dV sum, bwd_dkdv_sum).
CUDA_NAMES = {
    "flash_attention_bwd": ("bwd_dot", "bwd_dkdv", "bwd_dq"),
    "moe_gmm_bwd": ("gmm_bwd_wgmma", "gmm_bwd_tc", "gmm_bwd_ffma"),
    "rwkv_scan_bwd": ("rwkv_bwd_",),
    "rglru_scan_bwd": ("rglru_bwd_",),
    "flash_attention": ("flash_attention_tc", "flash_attention_kernel"),
    "moe_gmm": ("moe_gmm_wgmma", "moe_gmm_tc", "moe_gmm_ffma",
                "moe_gmm_kernel"),
    "rwkv_scan": ("chunk_state", "state_scan", "chunk_out", "rwkv_decode"),
    "rglru_scan": ("rglru_scan_windows", "rglru_scan_steps"),
    "adafactor": ("adafactor_",),
    "adamw": ("adamw_",),
}
BWD_CUDA_PER_CALL = {"flash_attention_bwd": 3, "moe_gmm_bwd": 2,
                     "rwkv_scan_bwd": 4, "rglru_scan_bwd": 1}
# The families trained on the card, at their published widths, bf16,
# remat (each scanned layer's forward runs twice a step, the unrolled tail
# once): optimizer, learning rate (warmup 5, cosine over 20), batch, the
# kernel launches per step, and the float32 gradient parity's batch, depth
# cut and launches.  The depth of the bf16 run is the published one but
# for the MoE, which serves at 3 of 94 layers on one card (MOE_LAYERS).
# qwen3-0.6b takes a fresh batch each step; the others take one batch ten
# times ("one_batch"): over fresh batches their first ten losses move with
# the batch more than with training (launch/train.py on the H100: the
# MoE's loss at steps 5 and 10 lies 0.020-0.027 above step 1's for every
# lr from 5e-5 to 5e-4, recurrentgemma-9b's within 0.005 of it up to
# 1e-3), so only a fixed batch shows whether the steps descend.
TRAIN_CASES = [
    {"arch": "qwen3_0_6b", "optimizer": "adamw", "lr": 5e-4, "B": 8,
     "T": 1024, "checkpoints": True,
     "per_step": {"flash_attention": 56, "flash_attention_bwd": 28,
                  "adamw": 13},
     "bwd_routes": {"flash_attention_bwd": "wgmma"},
     "parity": {"B": 2, "T": 1024}},
    {"arch": "rwkv6_3b", "optimizer": "adamw", "lr": 3e-4, "B": 8,
     "T": 1024, "one_batch": True,
     "per_step": {"rwkv_scan": 64, "rwkv_scan_bwd": 32, "adamw": 20},
     "bwd_routes": {"rwkv_scan_bwd": "tc"},
     "parity": {"B": 2, "T": 256, "n_layers": 2,
                "launches": {"rwkv_scan": 4, "rwkv_scan_bwd": 2},
                "why": "the plain recurrence steps through T in Python: "
                       "2 layers at T=256 keep its float32 gradient to "
                       "seconds"}},
    # AdamW's float32 moments (84 GB) do not fit beside the parameters
    # and gradients (42 GB); Adafactor's factored ones do.  Its float32
    # logits at B=8, T=1024 would be 8.4 GB: the loss runs in 4 sequence
    # chunks (chunked_ce)
    {"arch": "recurrentgemma_9b", "optimizer": "adafactor", "lr": 1e-4,
     "B": 8, "T": 1024, "one_batch": True, "chunked_ce": 4,
     "per_step": {"rglru_scan": 50, "rglru_scan_bwd": 26,
                  "flash_attention": 24, "flash_attention_bwd": 12,
                  "adafactor": 60},
     "bwd_routes": {"flash_attention_bwd": "wide"},
     # MQA: 128 dK/dV blocks, its 16 heads split in 8 (_dkdv_splits)
     "cuda_per_call": {"flash_attention_bwd": 4},
     "parity": {"B": 2, "T": 256, "n_layers": 3,
                "launches": {"rglru_scan": 4, "rglru_scan_bwd": 2,
                             "flash_attention": 2,
                             "flash_attention_bwd": 1},
                "why": "float32 parameters and gradients of 38 layers "
                       "(84 GB) do not fit one 80 GB card; 3 layers are "
                       "one scanned block under remat: two RG-LRU layers "
                       "and a local-attention layer"}},
    {"arch": "qwen3_moe_235b", "optimizer": "adafactor", "lr": 1e-4,
     "B": 8, "T": 1024, "one_batch": True,
     "cut": {"n_layers": MOE_LAYERS,
             "why": "one 80 GB card holds 3 of the 94 layers, as it "
                    "serves"},
     "per_step": {"moe_gmm": 18, "moe_gmm_bwd": 9, "flash_attention": 6,
                  "flash_attention_bwd": 3, "adafactor": 15},
     "bwd_routes": {"flash_attention_bwd": "wgmma"},
     "parity": {"B": 2, "T": 256, "n_layers": 1,
                "launches": {"moe_gmm": 6, "moe_gmm_bwd": 3,
                             "flash_attention": 2,
                             "flash_attention_bwd": 1},
                "why": "float32 parameters and gradients of 3 layers "
                       "(about 70 GB) do not fit beside the activations"}},
    # one period of mellum2-12b-a2.5b's pattern, three windowed layers
    # (1,024) and a full one with YaRN, at the benchmark cell's 16,384
    # tokens: K2 of both kinds in one step (its training rows take these
    # launches)
    {"arch": "mellum2_12b_a2_5b", "optimizer": "adafactor", "lr": 1e-4,
     "B": 1, "T": 16384, "one_batch": True,
     "cut": {"n_layers": 4,
             "why": "one period of the layer pattern; the benchmark cell "
                    "trains 16 layers"},
     "per_step": {"moe_gmm": 24, "moe_gmm_bwd": 12, "flash_attention": 8,
                  "flash_attention_bwd": 4, "adafactor": 13},
     "bwd_routes": {"flash_attention_bwd": "wgmma"},
     "parity": {"B": 1, "T": 2048,
                "launches": {"moe_gmm": 24, "moe_gmm_bwd": 12,
                             "flash_attention": 8,
                             "flash_attention_bwd": 4}}},
]


# What each train phase measured, by model name, for the cost phase: the
# median ms per step, the kernel launches of a step (held exactly every
# step), the bytes of the parameters and optimizer state on the card, and
# the peak memory allocated
TRAIN_MEASURED: dict[str, dict] = {}


def _train_cfg(case):
    """(the config a TRAIN_CASES entry trains, its cut or None)."""
    from repro_torch import configs

    cfg = configs.get(case["arch"])
    reduced = None
    if "cut" in case:
        reduced = {"n_layers": [cfg.n_layers, case["cut"]["n_layers"]],
                   "why": case["cut"]["why"]}
        cfg = dataclasses.replace(cfg, n_layers=case["cut"]["n_layers"])
    return dataclasses.replace(cfg, chunked_ce=case.get("chunked_ce", 0)), \
        reduced


def _train_opt(case):
    """The optimizer a TRAIN_CASES entry trains with (warmup 5, cosine
    over 20 steps)."""
    from repro_torch.train import OptConfig

    return OptConfig(name=case["optimizer"], lr=case["lr"], warmup=5,
                     decay_steps=2 * TRAIN_STEPS)


def _kernel_of(name: str):
    """The kernel (a key of CUDA_NAMES) a profiler name belongs to."""
    for kernel, parts in CUDA_NAMES.items():
        if any(p in name for p in parts):
            return kernel
    return None


def train_phase(torch, dev, case) -> dict:
    """One family of TRAIN_CASES at its published widths, random weights
    from a seeded generator: float32 ``loss_fn`` gradients through the
    kernels and their backwards against ``attn_impl="plain"``, then
    TRAIN_STEPS bf16 steps of ``TrainState``.  Returns the kernel launches
    of the bf16 training run, keyed ``"<name> train"``, and of the float32
    gradient check, ``"<name> train float32"``."""
    import contextlib
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import restore, save
    from repro_torch.core.torchstate import tree_leaves, tree_map
    from repro_torch.dist.compression import error_bound
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv_scan as rk
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train import TrainState, shard_batch, synthetic_batches

    cfg, reduced = _train_cfg(case)
    L = cfg.n_layers
    per_step = case["per_step"]

    def expect(counts, want, what):
        full = {k: want.get(k, 0) for k in counts}
        need(counts == full, f"{cfg.name} train {what}: launches {counts}, "
             f"want {full}")

    # 1. float32 gradient parity, kernel path against the plain path ------
    par = case["parity"]
    torch.cuda.reset_peak_memory_stats()
    c32 = dataclasses.replace(cfg, dtype="float32",
                              n_layers=par.get("n_layers", L))
    params = init_params(c32, torch.Generator(dev).manual_seed(0),
                         device=dev)
    batch = shard_batch(None, next(synthetic_batches(
        cfg.vocab, par["B"], par["T"], seed=0)), device=dev)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss_k = loss_fn(c32, params, batch)
    got = torch.autograd.grad(loss_k, leaves)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    loss_p = loss_fn(dataclasses.replace(c32, attn_impl="plain"), params,
                     batch)
    want = torch.autograd.grad(loss_p, leaves)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rels = [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(got, want)]
    emit({"phase": "train_grad_parity", "arch": cfg.name,
          "layers": c32.n_layers,
          "reduced": None if c32.n_layers == L else
          {"n_layers": [L, c32.n_layers], "why": par["why"]},
          "dtype": "float32", "B": par["B"], "T": par["T"],
          "remat": c32.remat, "loss": float(loss_k.detach()),
          "plain_loss": float(loss_p.detach()),
          "leaves": len(rels), "max_leaf_rel_l2": max(rels), "tol": 2e-3,
          "launches": counts, "kernel_path_s": kernel_s,
          "plain_path_s": plain_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    model_kernels = {k: n for k, n in per_step.items()
                     if k not in ("adamw", "adafactor")}
    expect(counts, par.get("launches", model_kernels), "float32 gradient")
    counts32 = counts                 # the float32 gradient check's launches
    need(max(rels) <= 2e-3, f"{cfg.name} train gradients: largest leaf rel "
         f"L2 {max(rels)} > 2e-3")
    del params, batch, leaves, got, want, loss_k, loss_p
    gc.collect()
    torch.cuda.empty_cache()

    # 2. bf16 training through the kernels ----------------------------------
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    data = synthetic_batches(cfg.vocab, case["B"], case["T"], seed=0)
    batches = [shard_batch(None, next(data), device=dev)
               for _ in range(1 if case.get("one_batch") else TRAIN_STEPS)]
    batches *= TRAIN_STEPS // len(batches)
    with torch.no_grad():
        plain_loss = float(loss_fn(dataclasses.replace(cfg,
                                                       attn_impl="plain"),
                                   params, batches[0]))
    # lr 5e-4: at 3e-3 and 1e-3 (warmup 5) qwen3-0.6b's loss rose again
    # after the warmup in 10 steps (measured on the H100): Adam's near-sign
    # steps on the tied embedding (std 0.02) add more spread to the logits
    # than the step takes out
    opt = _train_opt(case)
    ts = TrainState(cfg, opt, params)
    if case.get("checkpoints"):
        ts.replicate()                             # the epoch backup
    losses, times, total, profiled, routes = [], [], None, None, {}
    bwd_routes = {}                 # K2's and K4's backward calls by route
    for i, batch in enumerate(batches, start=1):
        # step 2 is traced, and the next one if the profiler's window came
        # back empty (seen now and then on the H100); the traced step is
        # left out of the times
        traced = profiled is None and i >= 2
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = ts.step(batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        expect(counts, per_step, f"step {i}")
        total = counts if total is None else {
            k: total[k] + n for k, n in counts.items()}
        routes = {k: routes.get(k, 0) + n for k, n in gmm.bwd_routes.items()}
        for name, mod in (("flash_attention_bwd", fa),
                          ("rwkv_scan_bwd", rk)):
            for r, n in mod.bwd_routes.items():
                key = f"{name} {r}"
                bwd_routes[key] = bwd_routes.get(key, 0) + n
        if not traced:
            times.append((i, dt))
            continue
        kernels = [(e.key, e.device_time_total, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0]
        if kernels:
            profiled = (i, kernels)
    need(profiled is not None, "the profiler recorded no kernel in steps "
         f"2 to {TRAIN_STEPS}")
    TRAIN_MEASURED[cfg.name] = {
        "ms": statistics.median([t for i, t in times if i >= 3]),
        "per_step": {k: n for k, n in counts.items() if n},
        "state_bytes": sum(t.numel() * t.element_size()
                           for t in tree_leaves(ts.state.read())),
        "peak": torch.cuda.max_memory_allocated()}
    step_traced, kernels = profiled
    dev_us = sum(t for _, t, _ in kernels)
    shares, cuda_launches = {}, {}
    for k, t, c in kernels:
        kernel = _kernel_of(k)
        if kernel is not None:
            shares[kernel] = shares.get(kernel, 0.0) + t / dev_us
            cuda_launches[kernel] = cuda_launches.get(kernel, 0) + c
    ms_steps = [t for i, t in times if i >= 3]
    # PyTorch's fills and adds by dtype: [device ms, launches] in the
    # traced step (the stacked layer leaves' gradients were written with
    # them, once per layer, before the forward took its layers with
    # torch.unbind)
    fill_add = {}
    for group, pat in (("bf16 fill", "FillFunctor<c10::BFloat16>"),
                       ("float32 fill", "FillFunctor<float>"),
                       ("bf16 add", "CUDAFunctor_add<c10::BFloat16>"),
                       ("float32 add", "CUDAFunctor_add<float>")):
        hits = [(t, c) for k, t, c in kernels if pat in k]
        fill_add[group] = [sum(t for t, _ in hits) / 1e3,
                           sum(c for _, c in hits)]
    emit({"phase": "train", "arch": cfg.name, "layers": L,
          "reduced": reduced, "dtype": cfg.dtype, "B": case["B"],
          "T": case["T"], "remat": cfg.remat,
          "optimizer": case["optimizer"], "lr": case["lr"],
          "chunked_ce": cfg.chunked_ce,
          "one_batch": bool(case.get("one_batch")),
          "steps": TRAIN_STEPS, "losses": losses,
          "plain_first_loss": plain_loss,
          "first_loss_rel_vs_plain": abs(losses[0] - plain_loss) / plain_loss,
          "launches_per_step": per_step, "launches": total,
          "ms_per_step_median": statistics.median(ms_steps),
          "ms_per_step": [t for _, t in times],
          "traced_step": step_traced, "device_ms_traced_step": dev_us / 1e3,
          "kernel_shares": shares, "kernel_cuda_launches": cuda_launches,
          "moe_gmm_bwd_routes": routes, "bwd_routes": bwd_routes,
          "top_kernels": [(k[:80], t / 1e3, c) for k, t, c in
                          sorted(kernels, key=lambda x: -x[1])[:8]],
          "fill_add": fill_add,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    need(all(np.isfinite(losses)), f"non-finite losses {losses}")
    need(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    need(abs(losses[0] - plain_loss) <= 1e-2 * plain_loss,
         f"first loss {losses[0]} against the plain path's {plain_loss}")
    for name, per_call in BWD_CUDA_PER_CALL.items():
        per_call = case.get("cuda_per_call", {}).get(name, per_call)
        want_cuda = per_step.get(name, 0) * per_call
        need(cuda_launches.get(name, 0) == want_cuda,
             f"{cuda_launches.get(name, 0)} CUDA launches of {name} in the "
             f"traced step, want {want_cuda}")
    # bf16 on the tensor cores: no CUDA-core kernel of K2's backward, and
    # every K3 backward on wgmma
    need(not any("bwd_dkdv_cc" in k or "bwd_dq_cc" in k
                  for k, _, _ in kernels), "a CUDA-core kernel of "
         "flash_attention_bwd ran in the bf16 step")
    need(routes["wgmma"] == per_step.get("moe_gmm_bwd", 0) * TRAIN_STEPS
         and routes["tc"] == routes["f32"] == 0,
         f"moe_gmm_bwd routes {routes} in {TRAIN_STEPS} steps")
    # K2's and K4's backwards on the case's route only, every call and
    # every CUDA launch of the traced step
    want_routes = {f"{name} {r}": 0 for name in ("flash_attention_bwd",
                                                 "rwkv_scan_bwd")
                   for r in (fa if name[0] == "f" else rk).bwd_routes}
    for name, route in case.get("bwd_routes", {}).items():
        want_routes[f"{name} {route}"] = per_step[name] * TRAIN_STEPS
        ok = _k2_bwd_kernel_ok if name[0] == "f" else _k4_bwd_kernel_ok
        bad = [k for k, _, _ in kernels
               if _kernel_of(k) == name and not ok(k, route)]
        need(not bad, f"{name} off its {route} route in the traced step: "
             f"{bad}")
    need(bwd_routes == want_routes, f"backward routes {bwd_routes} in "
         f"{TRAIN_STEPS} steps, want {want_routes}")
    if not case.get("checkpoints"):
        del ts, batches, params
        return {f"{cfg.name} train": total,
                f"{cfg.name} train float32": counts32}

    # 3. epochs, the backup and checkpoints ---------------------------------
    need(ts.color == TRAIN_STEPS, f"color {ts.color} after {TRAIN_STEPS} "
         "steps")
    trained = ts.params()
    good = [t.clone() for t in tree_leaves(trained)[:2]]
    for t in tree_leaves(ts.state._tree):          # a crash, out of band
        t.zero_()
    need(ts.restore_from_backup() == TRAIN_STEPS, "backup color")
    trained = ts.params()
    need(all(torch.equal(a, b) for a, b in zip(tree_leaves(trained), good)),
         "the backup did not restore the trained parameters")
    state = {"params": trained, "count": ts.state.read()[1]["count"]}
    ckpt = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        save(Path(d) / "exact", state, color=ts.color, step=ts.color)
        back, manifest = restore(Path(d) / "exact", state)
        ckpt["exact_s"] = time.perf_counter() - t0
        need(manifest["color"] == TRAIN_STEPS, "checkpoint color")
        need(all(torch.equal(a, b) for a, b in
                 zip(tree_leaves(back), tree_leaves(state))),
             "checkpoint round trip is not exact")
        del back
        t0 = time.perf_counter()
        save(Path(d) / "int8", state, color=ts.color, step=ts.color,
             quantize=True)
        f32 = tree_map(lambda t: torch.empty(
            t.shape, device=dev, dtype=torch.float32
            if t.is_floating_point() else t.dtype), state)
        back, manifest = restore(Path(d) / "int8", f32)
        ckpt["int8_s"] = time.perf_counter() - t0
        with np.load(Path(d) / "int8.npz") as npz:
            scales = {k[:-len("::scale")]: float(npz[k]) for k in npz.files
                      if k.endswith("::scale")}
        worst = 0.0                     # largest error, in quantization steps
        for (k, entry), a, b in zip(manifest["leaves"].items(),
                                    tree_leaves(back), tree_leaves(state)):
            err = float((a.double() - b.double()).abs().max())
            if entry.get("quantized"):
                need(err <= error_bound(scales[k]), f"int8 checkpoint {k}: "
                     f"error {err}, scale {scales[k]}")
                worst = max(worst, err / scales[k])
            else:
                need(err == 0, f"checkpoint {k} not exact")
        ckpt["int8_worst_error_in_steps"] = worst
        ckpt["int8_leaves"] = len(scales)
        ckpt["bytes"] = {n: (Path(d) / f"{n}.npz").stat().st_size
                         for n in ("exact", "int8")}
        del back, f32
    emit({"phase": "train_state", "color": ts.color,
          "restored_color": ts.color, "checkpoint": ckpt,
          "leaves": len(tree_leaves(state))})
    del ts, trained, state, batches, params
    return {f"{cfg.name} train": total,
            f"{cfg.name} train float32": counts32}


# ---------------------------------------------------------------------------
#  the cost tooling: the kernel bench, and dry-runs held to measured steps
# ---------------------------------------------------------------------------
def cost_phase(torch, dev, smi: str) -> None:
    """``kernel_bench.all_rows()`` on the card, each kernel held to its
    plain version; then ``launch.dryrun.trace_step`` (the function the
    dry-run's ``lower_cell`` runs) on fake tensors on a one-rank mesh of
    a fake process group, on the card's path: each TRAIN_CASES step at its
    train phase's shape, depth and optimizer, whose kernel launches by name
    must equal that phase's launches per step and whose parameter and
    optimizer-state argument bytes must equal the real state's on the
    card, beside the phase's median step (model FLOPs 6 N_active tokens,
    the traced FLOPs, the achieved TFLOP/s and ``mfu`` at 989 TFLOP/s);
    the trace's temporaries are printed beside the phase's peak, not held;
    last, qwen3-0.6b's decode step at the serve phase's shape (B=4, cache
    2048), whose K1 launches must equal a served tick's."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.benchmarks import kernel_bench, roofline
    from repro_torch.kernels import cost
    from repro_torch.launch.dryrun import init_fake_group, trace_step
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    rows = kernel_bench.all_rows()
    errs = {}
    for name, kernel, plain, args, _ in kernel_bench.cases():
        got, want = kernel(*args), plain(*args)
        errs[name] = _err(got, want)
        need(_within(got, want, TOLS["float32"]),
             f"kernel_bench {name}: max err {errs[name]}")
    emit({"phase": "cost_kernel_bench", "nvidia_smi": smi,
          "rows": [{"name": n, "us": us, "derived": d} for n, us, d in rows],
          "max_abs_err": errs, "tol": TOLS["float32"],
          "seconds": time.perf_counter() - t0})

    init_fake_group(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for case in TRAIN_CASES:
            cfg, reduced = _train_cfg(case)
            meas = TRAIN_MEASURED[cfg.name]
            B, T = case["B"], case["T"]
            rec = trace_step(cfg, "train", B, T, mesh, opt=_train_opt(case))
            launches = {k: v["launches"] for k, v in rec["kernels"].items()}
            parts = rec["memory"]["argument_bytes"]
            model = roofline.model_flops({
                "active_params": cfg.active_param_count(), "batch": B,
                "seq": T, "mode": "train"})
            traced = rec["cost_raw"]["flops"]
            s = meas["ms"] / 1e3
            emit({"phase": "cost", "arch": cfg.name, "layers": cfg.n_layers,
                  "reduced": reduced, "B": B, "T": T,
                  "optimizer": case["optimizer"], "nvidia_smi": smi,
                  "traced_flops": traced,
                  "aten_flops": rec["cost_raw"]["aten_flops"],
                  "kernel_flops": {k: v["flops"]
                                   for k, v in rec["kernels"].items()},
                  "model_flops": model, "ms_per_step_median": meas["ms"],
                  "achieved_tflops": traced / s / 1e12,
                  "model_tflops": model / s / 1e12,
                  "mfu": model / (s * cost.PEAK_FLOPS["bfloat16"]),
                  "traced_launches": launches,
                  "measured_launches": meas["per_step"],
                  "state_bytes_traced": parts["params"] + parts["opt_state"],
                  "state_bytes_measured": meas["state_bytes"],
                  "temp_estimate_bytes":
                      rec["memory"]["temp_size_in_bytes"],
                  "max_memory_allocated": meas["peak"],
                  "trace_s": rec["compile_s"],
                  "traced_ops": rec["traced_ops"]})
            need(launches == meas["per_step"], f"{cfg.name} dry-run "
                 f"launches {launches}, the train phase's a step "
                 f"{meas['per_step']}")
            need(parts["params"] + parts["opt_state"] == meas["state_bytes"],
                 f"{cfg.name} dry-run state bytes {parts}, the card's "
                 f"{meas['state_bytes']}")
        arch, _, _, per_tick = MODELS[0][:4]
        cfg = configs.get(arch)
        rec = trace_step(cfg, "decode", 4, 2048, mesh)
        launches = {k: v["launches"] for k, v in rec["kernels"].items()}
        emit({"phase": "cost_decode", "arch": cfg.name, "B": 4, "cache": 2048,
              "traced_flops": rec["cost_raw"]["flops"],
              "traced_launches": launches, "served_per_tick": per_tick,
              "kernels": rec["kernels"], "trace_s": rec["compile_s"]})
        need(launches == per_tick, f"{cfg.name} decode dry-run launches "
             f"{launches}, a served tick's {per_tick}")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
#  one model: prefill, serve, decode from the served cache
# ---------------------------------------------------------------------------
def model_phases(torch, dev, arch, T, per_prefill, per_tick, held_in,
                 cut=None) -> dict:
    """Run one model's phases in bf16, holding the kernel path to the plain
    path in ``held_in``; ``cut`` ({"n_layers": N, "why": ...}) reduces the
    depth.  Returns the kernel launches counted on each of its paths, keyed
    ``"<name> prefill"`` / ``"<name> serve"``, and in float32 those of the
    held prefill and decode check, ``"<name> prefill float32"`` /
    ``"<name> decode float32"``."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import Cluster
    from repro_torch.core.torchstate import OwnedState, tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.transformer import clone_cache
    from repro_torch.serve import ServeEngine, make_prefill

    cfg = configs.get(arch)
    reduced = None
    if cut:
        reduced = {"n_layers": [cfg.n_layers, cut["n_layers"]],
                   "why": cut["why"]}
        cfg = dataclasses.replace(cfg, n_layers=cut["n_layers"])
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")
    tol = LOGIT_REL_TOL[held_in]
    bf16 = held_in == "bfloat16"

    held_counts = {}

    def held(fn, what):
        """``fn()`` with the weights (and the caches it casts) in
        ``held_in``; the weights are cast back to their own dtypes after.
        In float32 its kernel launches are kept as ``"<name> <what>
        float32"`` (the plain path it compares with launches none)."""
        if bf16:
            return fn()
        _cast_tree(params, torch.float32)
        ops.reset_launch_counts()
        try:
            return fn()
        finally:
            held_counts[f"{cfg.name} {what} float32"] = ops.launch_counts()
            _cast_tree(params, init_params(cfg, device="meta"))

    def expect(counts, want, what):
        full = {k: want.get(k, 0) for k in counts}
        need(counts == full, f"{cfg.name} {what}: launches {counts}, want "
             f"{full}")

    # prefill ---------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (1, T), device=dev,
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
        prefill_counts = ops.launch_counts()
        t0 = time.perf_counter()
        _, plain_logits = make_prefill(plain_cfg)(params, {"tokens": toks})
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    rel_bf16 = _rel(logits, plain_logits)
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1))
                  .float().mean())
    finite = bool(torch.isfinite(logits).all())
    shape = list(logits.shape)
    del logits, plain_logits

    def prefill_pair():
        with torch.no_grad():
            _, lk = prefill(params, {"tokens": toks})
            _, lp = make_prefill(plain_cfg)(params, {"tokens": toks})
        return _rel(lk, lp)
    rel = rel_bf16 if bf16 else held(prefill_pair, "prefill")
    emit({"phase": "prefill", "arch": cfg.name, "reduced": reduced,
          "params": n_params,
          "init_s": init_s, "B": toks.shape[0], "T": toks.shape[1],
          "prefill_ms": prefill_ms, "plain_prefill_ms": plain_ms,
          "launches": prefill_counts, "logits_shape": shape,
          "held_in": held_in, "rel_l2_vs_plain": rel, "tol": tol,
          "bf16_rel_l2_vs_plain": rel_bf16,
          "bf16_argmax_agreement": agree,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    expect(prefill_counts, per_prefill, "prefill")
    need(finite, "non-finite logits")
    need(tuple(last.shape) == (1, cfg.vocab), f"last logits {last.shape}")
    need(rel <= tol, f"{cfg.name} prefill logits rel err {rel} ({held_in})")
    del last

    # serve -----------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
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
    serve_counts = ops.launch_counts()
    st = engine.stats()
    emit({"phase": "serve", "arch": cfg.name, "servers": 4, "wire": "int8",
          "slots": 4, "max_len": 2048, "requests": len(reqs),
          "done": sum(r.done for r in reqs), "steps": engine.steps,
          "tokens": tokens, "tick_ms_median": statistics.median(ticks),
          "tick_ms_first": ticks[0], "decode_tok_s": tokens / serve_s,
          "launches": serve_counts,
          "kv": st["kv"], "wire_bytes": st["wire_bytes"],
          "weight_refreshes": st["weight_refreshes"],
          "weight_hits": st["weight_hits"],
          "round_trips": cl.sim.net.round_trips,
          "virtual_makespan_us": cl.makespan_us(),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    need(all(r.done for r in reqs), "not every request finished")
    expect(serve_counts, {k: n * engine.steps for k, n in per_tick.items()},
           f"serve ({engine.steps} ticks)")
    need(st["weight_refreshes"] >= 1, "no weight refresh")

    # a few decode steps from the served cache: kernel path vs plain path
    served = engine.cache
    del engine, weights
    gc.collect()                 # the engine's weight cache is in a cycle
    torch.cuda.empty_cache()

    def decode_pairs():
        ck, cp = clone_cache(served), clone_cache(served)
        if not bf16:
            _cast_tree(ck, torch.float32)
            _cast_tree(cp, torch.float32)
        gen_t = torch.Generator(dev).manual_seed(2)
        out = []
        with torch.no_grad():
            for _ in range(3):
                tok = torch.randint(0, cfg.vocab, (4, 1), device=dev,
                                    generator=gen_t)
                lk, ck = decode_step(cfg, params, ck, tok)
                lp, cp = decode_step(plain_cfg, params, cp, tok)
                out.append({"length": ck["length"],
                            "rel_l2_vs_plain": _rel(lk, lp),
                            "max_abs_err": _err(lk, lp)})
        return out
    decode_checks = held(decode_pairs, "decode")
    emit({"phase": "decode_check", "arch": cfg.name, "held_in": held_in,
          "checks": decode_checks, "tol": tol})
    need(all(c["rel_l2_vs_plain"] <= tol for c in decode_checks),
         f"{cfg.name} decode logits disagree with the plain path")
    return {f"{cfg.name} prefill": prefill_counts,
            f"{cfg.name} serve": serve_counts, **held_counts}


# ---------------------------------------------------------------------------
#  the paper's DSM applications, with their payloads on the card
# ---------------------------------------------------------------------------
APP_BACKENDS = ("drust", "gam", "grappa")
APPS_ON_CARD = ("gemm", "dataframe")     # the apps whose payloads are tensors
# GEMM at a size that gives the card real work: the default's 8 x 8 tile
# grid (the same simulated run), each tile product 1024^3
GEMM_N, GEMM_TILE = 8192, 1024


def apps_phase(torch, dev) -> None:
    """Each app at its defaults on 4 servers, on every backend, held to the
    same run on the CPU (ops, makespan and every ``NetStats`` field
    exactly; DataFrame's float digest at 1e-9 relative: the card sums each
    chunk in another order); GEMM at n = 8192 against one ``torch.matmul``
    of A and B; the port's borrow lint over its own app surface."""
    import numpy as np

    from repro_torch.analysis import lint_paths
    from repro_torch.analysis.lint import default_targets
    from repro_torch.apps import APPS, run_gemm
    from repro_torch.kernels import cost

    for app, fn in APPS.items():
        for backend in APP_BACKENDS:
            kw = {"device": "cuda"} if app in APPS_ON_CARD else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = fn(4, backend=backend, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            host = fn(4, backend=backend,
                      **({"device": "cpu"} if kw else {}))
            what = f"{app} {backend}"
            need((card.ops, card.makespan_us, card.net)
                 == (host.ops, host.makespan_us, host.net),
                 f"{what}: the run on the card differs from the CPU's")
            extra, host_extra = dict(card.extra), dict(host.extra)
            rel = None
            if app == "dataframe":
                a, b = extra.pop("result_digest"), host_extra.pop(
                    "result_digest")
                rel = abs(a - b) / max(abs(b), 1e-300)
                need(rel <= 1e-9, f"{what}: digest rel err {rel}")
            need(extra == host_extra, f"{what}: {extra} != {host_extra}")
            emit({"phase": "apps", "app": app, "backend": backend,
                  "servers": 4, "payloads": "cuda" if kw else "host",
                  "wall_s": wall, "ops": card.ops,
                  "makespan_us": card.makespan_us,
                  "round_trips": card.net["round_trips"],
                  "bytes_moved": card.net["bytes_moved"],
                  "digest_rel_err": rel})

    # GEMM at n = 8192: wall, peak memory, the error against the oracle
    n, tile = GEMM_N, GEMM_TILE
    nt = n // tile
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_gemm(4, "drust", n=n, tile=tile, device="cuda", out=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    need(r.ops == nt ** 3, f"gemm n={n}: {r.ops} tile products")
    rng = np.random.default_rng(0)                # run_gemm's draws
    A = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev)
    B = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev)
    oracle = A @ B
    err = _err(out, oracle)
    need(bool(torch.isfinite(out).all()), f"gemm n={n}: non-finite product")
    need(bool(((out - oracle).abs() <= 5e-2 + 2e-3 * oracle.abs()).all()),
         f"gemm n={n}: max abs err {err} against torch.matmul")
    del out, oracle

    # device time of the run's tile products and accumulations, replayed
    # back to back from the same tiles (CUDA events), beside one
    # torch.matmul of A and B and the float32 bound.  A device sleep of
    # about 0.1 s runs ahead of the start event, so the host has enqueued
    # the replay's 1,088 launches before the card reaches them and the
    # events span the card's work, not the host's; the host's enqueue time
    # is printed beside it.
    At = A.view(nt, tile, nt, tile).permute(0, 2, 1, 3).contiguous()
    Bt = B.view(nt, tile, nt, tile).permute(0, 2, 1, 3).contiguous()

    def products():
        for i in range(nt):
            for j in range(nt):
                acc = torch.zeros((tile, tile), dtype=torch.float32,
                                  device=dev)
                for k in range(nt):
                    acc += At[i, k] @ Bt[k, j]

    def events_ms(fn, reps=3):
        fn()
        times, host = [], []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), statistics.median(host)

    tiles_ms, tiles_host_ms = events_ms(products)
    matmul_ms, _ = events_ms(lambda: A @ B)
    bound_ms = 2.0 * n ** 3 / cost.PEAK_FLOPS["float32"] * 1e3
    emit({"phase": "apps_gemm", "app": "gemm", "backend": "drust",
          "servers": 4, "n": n, "tile": tile, "tile_products": r.ops,
          "wall_s": wall, "makespan_us": r.makespan_us,
          "round_trips": r.net["round_trips"],
          "tile_products_ms": tiles_ms,
          "tile_products_host_ms": tiles_host_ms, "matmul_ms": matmul_ms,
          "bound_ms": bound_ms, "bound_by": "operations (float32)",
          "max_abs_err": err, "peak_gb": peak / 1e9,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    del A, B, At, Bt

    # the port's borrow lint over its own app surface
    targets = default_targets()
    violations = lint_paths(targets)
    need(violations == [], "lint: " + "; ".join(v.format()
                                                for v in violations))
    emit({"phase": "apps_lint", "targets": len(targets), "violations": 0})


# ``repro.launch.elastic.run_protocol(4)`` on the JAX package: its report
# line, and the fail-over report's fields, which the port must reproduce
ELASTIC_LINE = ("elastic protocol rescale 4->3->4: OK (rehomed 8, orphans 0, "
                "makespan 9.7us)")
ELASTIC_REPORT = {"server": 3, "rehomed_boxes": 8, "orphaned_cids": 0,
                  "lost_writes": 1, "restored_bytes": 2048,
                  "makespan_us": 9.689600000000041}


def protocol_phase(dev) -> None:
    """``repro_torch.benchmarks.run.quick`` with its tensors on ``dev``,
    held to the committed ``BENCH_protocol.json`` in every field but the
    wall-clock ones (one line per section: fields, mismatches, wall
    seconds), then the live elastic rescale, held to the reference's
    report."""
    from repro_torch.benchmarks import run
    from repro_torch.launch import elastic

    base = json.loads((ROOT / "BENCH_protocol.json").read_text())
    seconds: dict = {}
    summary = run.quick(device=dev, seconds=seconds)
    diff = run.diff_sections(summary, base)
    for section, (n, bad) in diff.items():
        emit({"phase": "protocol", "section": section, "fields": n,
              "mismatches": len(bad), "first_mismatches": bad[:5],
              "seconds": seconds.get(section)})
    need(len(diff) == 11, f"sections {sorted(diff)}")
    bad = [b for _, (_, bs) in diff.items() for b in bs]
    need(not bad, f"quick() differs from BENCH_protocol.json in {len(bad)} "
                  f"fields: {bad[:10]}")

    t0 = time.perf_counter()
    ok, cl, rep = elastic.rescale(4)         # run_protocol(4)'s rescale
    wall = time.perf_counter() - t0
    line = elastic.report_line(4, ok, rep)
    print(line, flush=True)
    report = {k: getattr(rep, k) for k in ELASTIC_REPORT}
    emit({"phase": "elastic", "servers": "4->3->4", "ok": ok,
          "report": report, "round_trips": cl.sim.net.round_trips,
          "bytes_moved": cl.sim.net.bytes_moved, "wall_s": wall})
    need(ok, "the elastic rescale failed its own checks")
    need(line == ELASTIC_LINE, f"elastic line {line!r} != {ELASTIC_LINE!r}")
    need(report == ELASTIC_REPORT, f"elastic report {report}")


# ---------------------------------------------------------------------------
#  the multi-device paths on a one-card NCCL mesh
# ---------------------------------------------------------------------------
def mesh_phase(torch, dev) -> dict:
    """``mesh_moe``, ``mesh_serve`` and ``mesh_state`` on the (1, 1)
    ("data", "model") mesh of a one-rank NCCL process group.  Returns
    ``mesh_moe``'s launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    store = ROOT / "build" / "mesh_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        emit({"phase": "mesh", "backend": dist.get_backend(),
              "world_size": dist.get_world_size(),
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
              "device_type": mesh.device_type})
        need(mesh.device_type == "cuda", "the mesh is not on the card")
        launches = mesh_moe(torch, dev, mesh)
        for part in (mesh_serve, mesh_state):
            gc.collect()
            torch.cuda.empty_cache()
            part(torch, dev, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return launches


def mesh_moe(torch, dev, mesh) -> dict:
    """qwen3-moe-235b-a22b at MOE_LAYERS layers: a B=1, T=1024 prefill
    without a mesh and through ``moe_shardmap``'s gather dispatch on
    ``mesh`` (equal logits, equal launches), then at a capacity that drops
    nothing, in bf16 and in float32, the all-to-all dispatch (ragged K3)
    against the gather one; in bf16 also each K3 call of one all-to-all
    prefill against ``ref.moe_gmm`` on its own inputs, and both dispatches
    on the plain path; then one float32 and one bf16 gradient through
    the all-to-all dispatch (``mesh_a2a_grad``).  K3's launches by kernel
    (``moe_gmm.routes``): the bf16 all-to-all dispatch's on ``wgmma``, the
    other bf16 runs' on ``tc``, float32 on ``f32``.  Returns the
    all-to-all runs' kernel launches, keyed A2A_BF16 and A2A_F32 (each
    dtype's prefill and gradient step)."""
    from repro_torch import configs
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params
    from repro_torch.serve import make_prefill

    cfg = dataclasses.replace(configs.get("qwen3_moe_235b"),
                              n_layers=MOE_LAYERS)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (1, 1024), device=dev,
        generator=torch.Generator(dev).manual_seed(1))}

    routes = {}                 # K3's launches by kernel, per run below

    def run(c, m, name):
        """(logits, launches, ms) of the second of two prefills; its K3
        launches by kernel go to ``routes[name]``."""
        prefill = make_prefill(c, mesh=m)
        with torch.no_grad():
            prefill(params, batch)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _, logits = prefill(params, batch)
            torch.cuda.synchronize()
        routes[name] = {k: v for k, v in gmm.routes.items() if v}
        return logits, ops.launch_counts(), (time.perf_counter() - t0) * 1e3

    def run_a2a(c, name):
        """``run`` of the all-to-all dispatch, with its peak memory."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = run(dataclasses.replace(c, moe_a2a=True), mesh, name)
        return (*out, torch.cuda.max_memory_allocated())

    def k3_held(c):
        """One more all-to-all prefill of ``c`` in which each K3 call is
        held against ``ref.moe_gmm`` on its own inputs (the routing's rows
        and starts), elementwise at TOLS: a line per call."""
        kernel, calls = ops.moe_gmm, []

        def held(x, w, rows=None, starts=None):
            y = kernel(x, w, rows, starts)
            want = ref.moe_gmm(x, w, rows, starts)
            tol = TOLS[str(x.dtype).removeprefix("torch.")]
            calls.append({"E": w.shape[0], "M": x.shape[0],
                          "D": x.shape[1], "F": w.shape[2],
                          "ragged": starts is not None,
                          "live_rows": int(rows.sum()),
                          "max_abs_err": _err(y, want),
                          "ok": _within(y, want, tol)})
            return y

        ops.moe_gmm = held
        try:
            with torch.no_grad():
                make_prefill(dataclasses.replace(c, moe_a2a=True),
                             mesh=mesh)(params, batch)
        finally:
            ops.moe_gmm = kernel
        return calls

    plain, plain_counts, plain_ms = run(cfg, None, "no mesh")
    gather, gather_counts, gather_ms = run(cfg, mesh, "gather")
    equal = torch.equal(plain, gather)
    del plain, gather
    # capacity factor E / k: every expert takes every token it is routed
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    gbf, gbf_counts, gbf_ms = run(nodrop, mesh, "gather bf16")
    abf, abf_counts, abf_ms, abf_peak = run_a2a(nodrop, "a2a bf16")
    rel_bf16 = _rel(abf, gbf)
    finite = bool(torch.isfinite(abf).all())
    k3_calls = k3_held(nodrop)
    # both dispatches on the plain path (no kernel): how far bf16 alone
    # moves these logits, beside the kernels' a2a against gather
    no_kernels = dataclasses.replace(nodrop, attn_impl="plain")
    pa, pa_counts, _ = run(dataclasses.replace(no_kernels, moe_a2a=True),
                           mesh, "a2a plain")
    pg, pg_counts, _ = run(no_kernels, mesh, "gather plain")
    bf16_rel = {"a2a_vs_gather": rel_bf16, "a2a_vs_a2a_plain": _rel(abf, pa),
                "gather_vs_gather_plain": _rel(gbf, pg),
                "a2a_plain_vs_gather_plain": _rel(pa, pg)}
    del gbf, abf, pa, pg
    _cast_tree(params, torch.float32)
    g32, g32_counts, g32_ms = run(nodrop, mesh, "gather float32")
    a2a, a2a_counts, a2a_ms, a2a_peak = run_a2a(nodrop, "a2a float32")
    rel = _rel(a2a, g32)
    finite &= bool(torch.isfinite(a2a).all())
    emit({"phase": "mesh_moe", "arch": cfg.name,
          "reduced": {"n_layers": [configs.get("qwen3_moe_235b").n_layers,
                                   MOE_LAYERS]},
          "B": 1, "T": 1024, "gather_equals_no_mesh": equal,
          "launches": {"no_mesh": plain_counts, "gather": gather_counts,
                       "gather_bf16_nodrop": gbf_counts,
                       "a2a_bf16_nodrop": abf_counts,
                       "gather_float32_nodrop": g32_counts,
                       "a2a_float32_nodrop": a2a_counts},
          "prefill_ms": {"no_mesh": plain_ms, "gather": gather_ms,
                         "gather_bf16_nodrop": gbf_ms,
                         "a2a_bf16_nodrop": abf_ms,
                         "gather_float32_nodrop": g32_ms,
                         "a2a_float32_nodrop": a2a_ms},
          "a2a_vs_gather_rel_l2": {"bfloat16": rel_bf16, "float32": rel},
          "k3_routes": routes,
          "bf16_rel_l2": bf16_rel, "a2a_bf16_k3_calls": k3_calls,
          "tol": {dt: LOGIT_REL_TOL[dt] for dt in ("bfloat16", "float32")},
          "a2a_peak_memory": {"bfloat16": abf_peak, "float32": a2a_peak},
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    want = {"flash_attention": MOE_LAYERS, "moe_gmm": 3 * MOE_LAYERS}
    for name, counts in (("no mesh", plain_counts),
                         ("gather", gather_counts),
                         ("gather bf16", gbf_counts),
                         ("a2a bf16", abf_counts),
                         ("gather float32", g32_counts),
                         ("a2a float32", a2a_counts)):
        need({k: v for k, v in counts.items() if v} == want,
             f"MoE prefill {name}: launches {counts}, want {want}")
        # the bf16 all-to-all dispatch on wgmma, the gather's dense calls
        # on mma.sync, float32 on CUDA cores
        route = ("f32" if "float32" in name else
                 "wgmma" if name == "a2a bf16" else "tc")
        need(routes[name] == {route: 3 * MOE_LAYERS},
             f"MoE prefill {name}: K3 routes {routes[name]}, want {route}")
    need(not any(pa_counts.values()) and not any(pg_counts.values()),
         f"the plain path launched {pa_counts} / {pg_counts}")
    need(len(k3_calls) == 3 * MOE_LAYERS and all(
        c["ragged"] and c["ok"] for c in k3_calls),
         f"bf16 a2a prefill: K3 calls against ref.moe_gmm {k3_calls}")
    need(equal, "the gather-dispatch prefill on the mesh differs from the "
                "prefill without a mesh")
    need(finite, "non-finite a2a logits")
    need(rel_bf16 <= LOGIT_REL_TOL["bfloat16"],
         f"bf16 a2a logits rel L2 {rel_bf16} against the gather dispatch")
    need(rel <= LOGIT_REL_TOL["float32"],
         f"a2a logits rel L2 {rel} against the gather dispatch")
    del params, a2a, g32, batch
    gc.collect()
    torch.cuda.empty_cache()
    grads = {dt: mesh_a2a_grad(torch, dev, mesh, nodrop, dt)
             for dt in ("float32", "bfloat16")}
    return {A2A_BF16: {k: abf_counts[k] + n
                       for k, n in grads["bfloat16"].items()},
            A2A_F32: {k: a2a_counts[k] + n
                      for k, n in grads["float32"].items()}}


def mesh_a2a_grad(torch, dev, mesh, cfg, dtype: str) -> dict:
    """One gradient of ``loss_fn`` through ``moe_shardmap``'s all-to-all
    dispatch on ``mesh`` in ``dtype``: ``cfg`` (no token dropped) at one
    layer, B=1, T=1024, the kernel path (K2, ragged K3 and their
    backwards) against the plain path, each leaf by relative L2 at
    A2A_GRAD_TOL; in bf16 also the loss at 1e-2 of the plain path's, as
    the train phases hold their first bf16 loss, each leaf at TOLS against
    the kernel path with only K3 on its plain version (no routing choice
    can flip: the one layer routes before K3), and, in one more kernel
    gradient, each K3 backward call against ``ref.moe_gmm_backward`` on
    its own inputs (the routing's rows and starts) at TOLS of its largest
    entry.  Returns the kernel path's launches."""
    from repro_torch import configs
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train import shard_batch, synthetic_batches

    c = dataclasses.replace(cfg, dtype=dtype, n_layers=1, moe_a2a=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(c, torch.Generator(dev).manual_seed(0),
                         device=dev)
    batch = shard_batch(None, next(synthetic_batches(c.vocab, 1, 1024,
                                                     seed=0)), device=dev)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss_k = loss_fn(c, params, batch, mesh=mesh)
    got = torch.autograd.grad(loss_k, leaves)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = {"forward": dict(gmm.routes), "backward": dict(gmm.bwd_routes)}
    t0 = time.perf_counter()
    loss_p = loss_fn(dataclasses.replace(c, attn_impl="plain"), params,
                     batch, mesh=mesh)
    want = torch.autograd.grad(loss_p, leaves)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    def rel_l2(xs, ys):
        return [float((a.float() - b.float()).norm()
                      / b.float().norm().clamp_min(1e-30))
                for a, b in zip(xs, ys)]

    rels = rel_l2(got, want)
    del want
    calls, k3_rels = [], []
    if dtype == "bfloat16":
        # the same path with only K3 and its backward on their plain
        # versions (K2 the kernel in both): one layer routes before K3, so
        # no top-8 choice can flip, and what is left is K3's own rounding
        kernel_fwd = ops.moe_gmm
        ops.moe_gmm = ref.moe_gmm
        try:
            k3_rels = rel_l2(got, torch.autograd.grad(
                loss_fn(c, params, batch, mesh=mesh), leaves))
        finally:
            ops.moe_gmm = kernel_fwd
        kernel = gmm.backward

        def held(x, w, dy, rows=None, starts=None):
            out = kernel(x, w, dy, rows, starts)
            errs = [_scaled_err(a, b) for a, b in zip(
                out, ref.moe_gmm_backward(x, w, dy, rows, starts))]
            calls.append({"M": x.shape[0], "D": x.shape[1],
                          "F": w.shape[2], "live_rows": int(rows.sum()),
                          "route": gmm._route(x, w, dy),
                          "grad_err_of_scale": errs,
                          "ok": max(errs) <= TOLS[dtype]})
            return out

        gmm.backward = held
        try:
            torch.autograd.grad(loss_fn(c, params, batch, mesh=mesh), leaves)
        finally:
            gmm.backward = kernel
    del got
    tol = A2A_GRAD_TOL[dtype]
    expect = {"moe_gmm": 6, "moe_gmm_bwd": 3, "flash_attention": 2,
              "flash_attention_bwd": 1}
    route = "wgmma" if dtype == "bfloat16" else "f32"
    emit({"phase": "mesh_moe_a2a_grad", "arch": c.name, "layers": 1,
          "reduced": {"n_layers": [configs.get("qwen3_moe_235b").n_layers,
                                   1], "why": "the parameters and two sets "
                      "of gradients of one layer at full width on one "
                      "card"},
          "dtype": dtype, "B": 1, "T": 1024,
          "capacity_factor": c.capacity_factor,
          "loss": float(loss_k.detach()), "plain_loss": float(loss_p.detach()),
          "leaves": len(rels), "leaf_rel_l2": rels,
          "max_leaf_rel_l2": max(rels), "tol": tol,
          "leaf_rel_l2_vs_plain_k3": k3_rels,
          "launches": counts, "moe_gmm_routes": routes,
          "k3_bwd_calls": calls,
          "kernel_path_s": kernel_s, "plain_path_s": plain_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    need({k: v for k, v in counts.items() if v} == expect,
         f"a2a gradient {dtype}: launches {counts}, want {expect}")
    need(routes == {"forward": {**{r: 0 for r in gmm.routes}, route: 6},
                    "backward": {**{r: 0 for r in gmm.bwd_routes},
                                 route: 3}},
         f"a2a gradient {dtype}: K3 routes {routes}, want {route}")
    need(max(rels) <= tol, f"a2a gradients {dtype}: largest leaf rel L2 "
         f"{max(rels)} > {tol}")
    if dtype == "bfloat16":
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        need(abs(lk - lp) <= 1e-2 * abs(lp),
             f"a2a gradient bf16: loss {lk} against the plain path's {lp}")
        need(max(k3_rels) <= TOLS[dtype],
             f"a2a gradients bf16 against plain K3: largest leaf rel L2 "
             f"{max(k3_rels)} > {TOLS[dtype]}")
        need(len(calls) == 3 and all(k["ok"] and k["route"] == route
                                     for k in calls),
             f"a2a gradient bf16: K3 backward calls {calls}")
    return counts


def mesh_serve(torch, dev, mesh) -> None:
    """qwen3-0.6b's DSM-backed engine (the serve phase's requests) without
    a mesh, on ``mesh``, and on ``mesh`` with ``decode_shard_s``; the last
    two again in float32."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import Cluster
    from repro_torch.core.torchstate import OwnedState
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = configs.get("qwen3_0_6b")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)

    def serve(c, m):
        engine = ServeEngine(c, OwnedState("weights", params), slots=4,
                             max_len=2048, cluster=Cluster(4, "drust"),
                             wire="int8", device=dev, mesh=m)
        rng = np.random.default_rng(0)
        prefix = [int(t) for t in rng.integers(0, c.vocab, c.attn_chunk)]
        reqs = []
        for i in range(8):
            tail = [int(t) for t in rng.integers(0, c.vocab, 8 if i % 2 == 0
                                                 else 12)]
            reqs.append(engine.submit(prefix + tail if i % 2 == 0 else tail,
                                      max_new=16))
        ops.reset_launch_counts()
        ticks = []
        with torch.no_grad():
            while engine.queue or engine.active:
                t0 = time.perf_counter()
                engine.step()
                ticks.append((time.perf_counter() - t0) * 1e3)
                need(len(ticks) < 1000, "engine did not drain")
        need(all(r.done for r in reqs), "not every request finished")
        return {"tokens": [list(r.generated) for r in reqs],
                "steps": engine.steps, "launches": ops.launch_counts(),
                "tick_ms_median": statistics.median(ticks),
                "cache": type(engine.cache["layers"]["k"]).__name__}

    sharded = dataclasses.replace(cfg, decode_shard_s=True)
    runs = {}
    # each twice, in turns A B C C B A, so that an order effect shows
    turns = [("no_mesh", cfg, None), ("mesh", cfg, mesh),
             ("mesh_decode_shard_s", sharded, mesh)]
    for key, c, m in turns + turns[::-1]:
        r = serve(c, m)
        if key in runs:
            need(r["tokens"] == runs[key]["tokens"],
                 f"{key}: a second run served other tokens")
            runs[key]["tick_ms_median"] = [runs[key]["tick_ms_median"],
                                           r["tick_ms_median"]]
        else:
            runs[key] = r
    _cast_tree(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype="float32")      # the cache's dtype
    runs["float32_no_mesh"] = serve(c32, None)
    runs["float32_mesh_decode_shard_s"] = serve(
        dataclasses.replace(c32, decode_shard_s=True), mesh)
    base, base32 = runs["no_mesh"]["tokens"], runs["float32_no_mesh"]["tokens"]
    same = {k: sum(a == b for a, b in zip(
        r["tokens"], base32 if k.startswith("float32") else base))
        for k, r in runs.items()}
    emit({"phase": "mesh_serve", "arch": cfg.name, "servers": 4,
          "wire": "int8", "requests": 8,
          "runs": {k: {kk: v for kk, v in r.items() if kk != "tokens"}
                   for k, r in runs.items()},
          "requests_with_the_no_mesh_tokens": same})
    for k, r in runs.items():
        want = {} if "decode_shard_s" in k else {
            "decode_attention": cfg.n_layers * r["steps"]}
        need({n: v for n, v in r["launches"].items() if v} == want,
             f"{k}: launches {r['launches']}, want {want}")
    need(runs["mesh"]["tokens"] == base, "the engine on the mesh served "
                                         "other tokens")
    need(runs["mesh_decode_shard_s"]["cache"] == "DTensor",
         "the decode_shard_s cache is not in DTensor shards")
    need(runs["float32_mesh_decode_shard_s"]["tokens"] == base32,
         "the decode_shard_s engine served other tokens (float32)")


def mesh_state(torch, dev, mesh) -> None:
    """``shard_batch`` and a checkpoint round trip of qwen3-0.6b's
    parameters from and onto ``mesh``, then ``pipeline_apply`` with one
    stage on the card."""
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.dist.sharding import is_spec, param_specs, place
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import shard_batch, synthetic_batches

    cfg = configs.get("qwen3_0_6b")
    batch = next(synthetic_batches(cfg.vocab, 8, 1024))
    placed = shard_batch(mesh, batch)
    need(all(isinstance(v, DTensor) and v.device.type == "cuda"
             and bool((v.full_tensor().cpu() == torch.from_numpy(batch[k]))
                      .all()) for k, v in placed.items()),
         "shard_batch on the mesh")

    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    specs = param_specs(mesh, params)
    flat = tree_leaves(specs, is_leaf=is_spec)
    on_mesh = place(params, specs, mesh)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        save(Path(d) / "ck", on_mesh, color=2)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, manifest = restore(Path(d) / "ck", init_params(
            cfg, device="meta"), mesh=mesh, specs=specs)
        restore_s = time.perf_counter() - t0
    exact = all(isinstance(b, DTensor) and torch.equal(b.full_tensor(), a)
                for a, b in zip(tree_leaves(params), tree_leaves(back)))
    n_sharded = sum(any(e is not None for e in s) for s in flat)
    del back, on_mesh

    pod = make_mesh((1,), ("pod",))
    gen = torch.Generator(dev).manual_seed(3)
    w = torch.randn((1, 1024, 1024), device=dev, generator=gen) * 0.03
    x = torch.randn((8, 256, 1024), device=dev, generator=gen)
    with torch.no_grad():
        y = pipeline_apply(lambda p, xb: torch.tanh(xb @ p), pod, w, x,
                           n_microbatches=4)
        want = torch.tanh(x @ w[0])
    pipe_err = _err(y, want)
    emit({"phase": "mesh_state", "arch": cfg.name,
          "shard_batch": {k: [str(p) for p in v.placements]
                          for k, v in placed.items()},
          "checkpoint": {"exact": exact, "color": manifest["color"],
                         "leaves": len(flat), "sharded_specs": n_sharded,
                         "save_s": save_s, "restore_s": restore_s},
          "pipeline_single_stage_max_abs_err": pipe_err})
    need(exact and manifest["color"] == 2,
         "checkpoint round trip onto the mesh is not exact")
    need(pipe_err <= 1e-4, f"pipeline_apply error {pipe_err}")


def _cast_tree(tree, like) -> None:
    """Cast the floating leaves of a dict/list tree in place, one leaf at a
    time (so the peak is the tree and one leaf), to ``like`` (a dtype) or to
    the dtype of the matching leaf of the tree ``like``."""
    import torch
    for k in list(tree.keys() if isinstance(tree, dict)
                  else range(len(tree))):
        want = like if isinstance(like, torch.dtype) else like[k]
        leaf = tree[k]
        if isinstance(leaf, (dict, list)):
            _cast_tree(leaf, want)
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            tree[k] = leaf.to(want if isinstance(want, torch.dtype)
                              else want.dtype)


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _within(a, b, tol: float) -> bool:
    """|a - b| <= tol + tol * |b| everywhere (as assert_close)."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def _scaled_err(a, b) -> float:
    """max |a - b| over max |b|: a gradient's error at its own scale."""
    return _err(a, b) / max(float(b.float().abs().max()), 1e-30)


def _rel(a, b) -> float:
    """Relative L2 of a against b, accumulated in float32 row by row so a
    (1, 4096, 256000) logits tensor needs no float32 copy of itself."""
    num = den = 0.0
    for x, y in zip(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])):
        x, y = x.float(), y.float()
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return (num / den) ** 0.5


if __name__ == "__main__":
    sys.exit(main())
