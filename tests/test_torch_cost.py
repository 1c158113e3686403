"""The port's count of each kernel's work (``kernels/cost.py``), the kernels'
fake path (a wrapper handed a fake tensor records its call and launches
nothing), ``build_batch_spec`` and the dry-run (``launch/dryrun.py``),
against the JAX package where it has a counterpart.  Everything here runs
on the CPU: fake tensors hold no data and no card is needed."""

import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode  # noqa
from torch.utils.flop_counter import FlopCounterMode          # noqa: E402

from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.kernels import cost, ops, ref                 # noqa: E402
from repro_torch.launch import dryrun                          # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF = "bfloat16"

# --------------------------------------------------------------------------
#  cost.py: the Bound column of PERF.md §6's kernel table, every path shape
# --------------------------------------------------------------------------
# qwen3-moe's routed decode: 4 tokens pick 8 of 128 experts each; the
# seeded draw gives 31 live experts, one of them twice (32 rows)
ROUTED = [2] + [1] * 30 + [0] * 97
BOUNDS = [
    ("K1 qwen3-0.6b serve", cost.decode_attention(
        4, 16, 8, 2048, 128, BF, [2048] * 4), "0.0100", "bytes"),
    ("K1 recurrentgemma-9b serve", cost.decode_attention(
        4, 16, 1, 2048, 256, BF, [2048] * 4), "0.0025", "bytes"),
    ("K1 qwen3-moe serve", cost.decode_attention(
        4, 64, 4, 2048, 128, BF, [2048] * 4), "0.0050", "bytes"),
    ("K1 qwen3-0.6b serve, lengths 33", cost.decode_attention(
        4, 16, 8, 2048, 128, BF, [33] * 4), "0.00017", "bytes"),
    ("K1 qwen3-moe serve, lengths 33", cost.decode_attention(
        4, 64, 4, 2048, 128, BF, [33] * 4), "0.00012", "bytes"),
    ("K1 pixtral-12b serve", cost.decode_attention(
        4, 32, 8, 2048, 160, BF, [2048] * 4), "0.0125", "bytes"),
    ("K2 qwen3-0.6b prefill", cost.flash_attention(
        1, 16, 8, 1024, 1024, 128, BF), "0.0043", "operations"),
    ("K2 recurrentgemma-9b prefill", cost.flash_attention(
        1, 16, 1, 4096, 4096, 256, BF, window=2048), "0.1042", "operations"),
    ("K2 qwen3-moe prefill", cost.flash_attention(
        1, 64, 4, 1024, 1024, 128, BF), "0.0174", "operations"),
    ("K2 pixtral-12b prefill", cost.flash_attention(
        1, 32, 8, 1024, 1024, 160, BF), "0.0109", "operations"),
    ("K2 qwen3-0.6b train", cost.flash_attention(
        8, 16, 8, 1024, 1024, 128, BF), "0.0348", "operations"),
    ("K2 recurrentgemma-9b train", cost.flash_attention(
        8, 16, 1, 1024, 1024, 256, BF, window=2048), "0.0696", "operations"),
    ("K2 qwen3-moe train", cost.flash_attention(
        8, 64, 4, 1024, 1024, 128, BF), "0.1391", "operations"),
    ("K2 backward qwen3-0.6b train", cost.flash_attention_bwd(
        8, 16, 8, 1024, 1024, 128, BF), "0.0869", "operations"),
    ("K2 backward recurrentgemma-9b train", cost.flash_attention_bwd(
        8, 16, 1, 1024, 1024, 256, BF, window=2048), "0.1739", "operations"),
    ("K2 backward qwen3-moe train", cost.flash_attention_bwd(
        8, 64, 4, 1024, 1024, 128, BF), "0.3478", "operations"),
    ("K3 prefill gate/up", cost.moe_gmm(128, 80, 4096, 1536, BF), "0.5152",
     "bytes"),
    ("K3 prefill down", cost.moe_gmm(128, 80, 1536, 4096, BF), "0.5152",
     "bytes"),
    ("K3 serve gate/up", cost.moe_gmm(128, 4, 4096, 1536, BF), "0.4825",
     "bytes"),
    ("K3 serve down", cost.moe_gmm(128, 4, 1536, 4096, BF), "0.4825",
     "bytes"),
    ("K3 serve, routed, gate/up", cost.moe_gmm(128, 4, 4096, 1536, BF,
                                               ROUTED), "0.1170", "bytes"),
    ("K3 serve, routed, down", cost.moe_gmm(128, 4, 1536, 4096, BF, ROUTED),
     "0.1177", "bytes"),
    ("K3 train gate/up", cost.moe_gmm(128, 640, 4096, 1536, BF), "1.0423",
     "operations"),
    ("K3 train down", cost.moe_gmm(128, 640, 1536, 4096, BF), "1.0423",
     "operations"),
    ("K3 backward train gate/up", cost.moe_gmm_bwd(128, 640, 4096, 1536, BF),
     "2.0845", "operations"),
    ("K3 backward train down", cost.moe_gmm_bwd(128, 640, 1536, 4096, BF),
     "2.0845", "operations"),
    ("K4 rwkv6-3b prefill", cost.rwkv_scan(1, 40, 1024, 64, BF), "0.0112",
     "bytes"),
    ("K4 rwkv6-3b serve", cost.rwkv_scan(4, 40, 1, 64, BF, S0=True),
     "0.0016", "bytes"),
    ("K4 rwkv6-3b train", cost.rwkv_scan(8, 40, 1024, 64, BF), "0.0892",
     "bytes"),
    ("K4 backward rwkv6-3b train", cost.rwkv_scan_bwd(8, 40, 1024, 64, BF),
     "0.1753", "bytes"),
    ("K5 recurrentgemma-9b prefill", cost.rglru_scan(1, 4096, 4096),
     "0.0601", "bytes"),
    ("K5 recurrentgemma-9b serve", cost.rglru_scan(4, 1, 4096), "5.9e-05",
     "bytes"),
    ("K5 recurrentgemma-9b train", cost.rglru_scan(8, 1024, 4096), "0.1202",
     "bytes"),
    ("K5 backward recurrentgemma-9b train", cost.rglru_scan_bwd(8, 1024,
                                                                4096),
     "0.2003", "bytes"),
]


def _printed(value: float, like: str) -> str:
    """``value`` with the digits ``like`` was printed with."""
    if "e" in like:
        return f"{value:.{len(like.split('e')[0]) - 2}e}"
    return f"{value:.{len(like.split('.')[1])}f}"


@pytest.mark.parametrize("path,work,printed,by", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_gives_perf_tables_bound(path, work, printed, by):
    bound, bound_by = cost.bound_ms(*work)
    assert _printed(bound, printed) == printed
    assert bound_by == by


@pytest.mark.parametrize("T,S,causal,window", [
    (1, 1, True, 0), (17, 17, True, 0), (17, 40, True, 0), (40, 40, True, 7),
    (33, 100, True, 64), (130, 130, True, 200), (9, 13, False, 0)])
def test_attention_pairs_counts_the_mask(T, S, causal, window):
    i = np.arange(T)[:, None] + S - T
    j = np.arange(S)[None, :]
    mask = np.ones((T, S), bool) if not causal else \
        (j <= i) & ((j > i - window) if window else True)
    assert cost.attention_pairs(T, S, causal, window) == int(mask.sum())


def _fake_flops(fn, *shapes, dtype=torch.float32):
    with FakeTensorMode(), FlopCounterMode(display=False) as fc:
        fn(*(torch.empty(s, dtype=dtype) for s in shapes))
    return fc.get_total_flops()


@pytest.mark.parametrize("E,C,D,F", [(4, 128, 256, 128), (128, 640, 4096,
                                                          1536), (3, 1, 5, 7)])
def test_k3_count_is_flop_counters_count_of_the_plain_version(E, C, D, F):
    want = _fake_flops(lambda x, w: ref.moe_gmm(x, w), (E, C, D), (E, D, F))
    assert cost.moe_gmm(E, C, D, F, BF).flops == want


@pytest.mark.parametrize("B,H,Hkv,T,S,hd", [(1, 4, 2, 256, 256, 64),
                                            (2, 16, 8, 100, 300, 128),
                                            (1, 16, 1, 64, 64, 256)])
def test_k2_count_is_flop_counters_count_of_full_attention(B, H, Hkv, T, S,
                                                           hd):
    want = _fake_flops(lambda q, k, v: ref.attention(q, k, v, causal=False),
                       (B, H, T, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    assert cost.flash_attention(B, H, Hkv, T, S, hd, BF,
                                causal=False).flops == want


def test_counts_with_data_and_without():
    """K1 and K3 count the live keys and rows when given them, and all of
    them (an upper bound) without."""
    full = cost.decode_attention(2, 4, 2, 100, 64, BF)
    assert full == cost.decode_attention(2, 4, 2, 100, 64, BF, [100, 100])
    part = cost.decode_attention(2, 4, 2, 100, 64, BF, [10, 0])
    assert part.flops == full.flops // 20 and part.bytes < full.bytes
    assert cost.moe_gmm(4, 8, 16, 32, BF, [8] * 4).flops == \
        cost.moe_gmm(4, 8, 16, 32, BF).flops
    assert cost.moe_gmm(4, 8, 16, 32, BF, [0, 0, 3, 9]).flops == \
        2 * 11 * 16 * 32
    assert cost.moe_gmm_bwd(4, 8, 16, 32, BF, [0] * 4).flops == 0
    # ragged: C packed rows, each once; rows and starts read
    rag = cost.moe_gmm(4, 40, 16, 32, BF, ragged=True)
    assert rag.flops == 2 * 40 * 16 * 32
    assert rag.bytes == 2 * (40 * 16 + 4 * 16 * 32 + 40 * 32) + 8 * 4
    part = cost.moe_gmm(4, 40, 16, 32, BF, [0, 7, 0, 20], ragged=True)
    assert part.flops == 2 * 27 * 16 * 32
    assert part.bytes == 2 * (27 * 16 + 2 * 16 * 32 + 40 * 32) + 8 * 4
    assert cost.moe_gmm_bwd(4, 40, 16, 32, BF, [0, 7, 0, 20],
                            ragged=True).flops == 4 * 27 * 16 * 32
    with pytest.raises(ValueError):
        cost.dtype_name(torch.float16)


# --------------------------------------------------------------------------
#  The fake path: a wrapper handed a fake tensor records, never launches
# --------------------------------------------------------------------------
def _fake(*shape, dtype=torch.float32, grad=False):
    t = torch.empty(shape, dtype=dtype)
    return t.requires_grad_(True) if grad else t


# (kernel, the call on fake tensors, its forward count, its backward count
# or None)
def _k1():
    q, k, v = _fake(2, 8, 64), _fake(2, 4, 100, 64), _fake(2, 4, 100, 64)
    with torch.no_grad():
        ops.decode_attention(q, k, v, torch.empty(2, dtype=torch.int32))


def _k2():
    q = _fake(2, 8, 50, 64, dtype=torch.bfloat16, grad=True)
    k = _fake(2, 4, 50, 64, dtype=torch.bfloat16, grad=True)
    v = _fake(2, 4, 50, 64, dtype=torch.bfloat16, grad=True)
    ops.flash_attention(q, k, v, window=16).float().sum().backward()


def _k3():
    x = _fake(4, 8, 32, dtype=torch.bfloat16, grad=True)
    w = _fake(4, 32, 16, dtype=torch.bfloat16, grad=True)
    ops.moe_gmm(x, w, torch.empty(4, dtype=torch.int32)).float().sum() \
        .backward()


def _k3_ragged():
    x = _fake(40, 32, dtype=torch.bfloat16, grad=True)
    w = _fake(4, 32, 16, dtype=torch.bfloat16, grad=True)
    rows = torch.empty(4, dtype=torch.int32)
    ops.moe_gmm(x, w, rows, torch.empty(4, dtype=torch.int32)).float() \
        .sum().backward()


def _k4():
    r, k, v = (_fake(2, 3, 130, 64, dtype=torch.bfloat16, grad=True)
               for _ in range(3))
    logw, u = _fake(2, 3, 130, 64, grad=True), _fake(3, 64, grad=True)
    o, S = ops.rwkv_scan(r, k, v, logw, u)
    (o.sum() + S.sum()).backward()


def _k5():
    a, b = _fake(2, 40, 96, grad=True), _fake(2, 40, 96, grad=True)
    ops.rglru_scan(a, b).sum().backward()


def _adafactor():
    """One Adafactor step of a stacked bf16 matrix and a float32 vector."""
    from repro_torch.train import OptConfig, apply_updates, init_opt_state
    cfg = OptConfig(name="adafactor")
    params = {"w": _fake(3, 16, 8, dtype=torch.bfloat16), "b": _fake(8)}
    grads = {"w": _fake(3, 16, 8, dtype=torch.bfloat16), "b": _fake(8)}
    apply_updates(cfg, params, grads, init_opt_state(cfg, params))


def _adamw():
    """One AdamW step of a stacked bf16 matrix and a float32 vector."""
    from repro_torch.train import OptConfig, apply_updates, init_opt_state
    cfg = OptConfig()
    params = {"w": _fake(3, 16, 8, dtype=torch.bfloat16), "b": _fake(8)}
    grads = {"w": _fake(3, 16, 8, dtype=torch.bfloat16), "b": _fake(8)}
    apply_updates(cfg, params, grads, init_opt_state(cfg, params))


BF16 = torch.bfloat16
FAKE_CALLS = [
    ("decode_attention", _k1,
     [("decode_attention", cost.decode_attention(2, 8, 4, 100, 64,
                                                  torch.float32), True)]),
    ("flash_attention", _k2,
     [("flash_attention", cost.flash_attention(2, 8, 4, 50, 50, 64, BF16,
                                               window=16, with_lse=True),
       False),
      ("flash_attention_bwd", cost.flash_attention_bwd(
          2, 8, 4, 50, 50, 64, BF16, window=16), False)]),
    ("moe_gmm", _k3,
     [("moe_gmm", cost.moe_gmm(4, 8, 32, 16, BF16), True),
      ("moe_gmm_bwd", cost.moe_gmm_bwd(4, 8, 32, 16, BF16), True)]),
    ("moe_gmm_ragged", _k3_ragged,
     [("moe_gmm", cost.moe_gmm(4, 40, 32, 16, BF16, ragged=True), True),
      ("moe_gmm_bwd", cost.moe_gmm_bwd(4, 40, 32, 16, BF16, ragged=True),
       True)]),
    ("rwkv_scan", _k4,
     [("rwkv_scan", cost.rwkv_scan(2, 3, 130, 64, BF16), False),
      ("rwkv_scan_bwd", cost.rwkv_scan_bwd(2, 3, 130, 64, BF16, dS=True),
       False)]),
    ("rglru_scan", _k5,
     [("rglru_scan", cost.rglru_scan(2, 40, 96), False),
      ("rglru_scan_bwd", cost.rglru_scan_bwd(2, 40, 96), False)]),
    ("adafactor", _adafactor,
     [("adafactor", cost.adafactor(3, 16, 8, BF16, BF16), False),
      ("adafactor", cost.adafactor(1, 1, 8, torch.float32, torch.float32,
                                   factored=False), False)]),
    ("adamw", _adamw,
     [("adamw", cost.adamw(384, BF16, BF16, torch.float32), False),
      ("adamw", cost.adamw(8, torch.float32, torch.float32, torch.float32),
       False)]),
]


@pytest.mark.parametrize("kernel,call,want", FAKE_CALLS,
                         ids=[c[0] for c in FAKE_CALLS])
def test_fake_call_records_its_count_and_launches_nothing(kernel, call,
                                                          want):
    ops.reset_launch_counts()
    with FakeTensorMode(), cost.card_path(), cost.recording() as calls:
        call()
    assert [(r.name, r.cost, r.upper_bound) for r in calls] == want
    for r in calls:                          # a record's args replay its count
        assert cost.COUNTS[r.name](**r.args) == r.cost
    assert not any(ops.launch_counts().values())


def test_no_module_global_holds_a_fake_tensor():
    from repro_torch.kernels import decode_attention
    with FakeTensorMode(), cost.card_path(), cost.recording():
        for _, call, _ in FAKE_CALLS:
            call()
    gc.collect()
    held = []
    for mod in list(ops.KERNELS.values()) + [ops, cost]:
        for name, val in vars(mod).items():
            vals = val.values() if isinstance(val, dict) else [val]
            if any(isinstance(v, FakeTensor) for v in vals):
                held.append(f"{mod.__name__}.{name}")
    assert held == [] and not any(isinstance(t, FakeTensor) for t in
                                  decode_attention._tickets.values())
    assert cost._records is None and cost._card_path is False


def test_real_cpu_tensors_take_the_plain_path_inside_card_path():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 16, 32), generator=g) for _ in range(3))
    ops.reset_launch_counts()
    with cost.card_path(), cost.recording() as calls:
        got = ops.flash_attention(q, k, v)
        assert not cost.on_card(q)
        from repro_torch.models.layers import use_kernels
        assert not use_kernels(tconfigs.smoke("qwen3_0_6b"), q)
    assert calls == [] and not any(ops.launch_counts().values())
    assert torch.equal(got, ref.attention(q, k, v))
    with FakeTensorMode():
        fake = torch.empty(2)
        assert not cost.on_card(fake)            # outside card_path()
        with cost.card_path():
            assert cost.on_card(fake)


def test_recording_does_not_nest():
    with cost.recording():
        with pytest.raises(RuntimeError):
            with cost.recording():
                pass


# --------------------------------------------------------------------------
#  build_batch_spec, the cells and the overrides against the reference's
# --------------------------------------------------------------------------
def test_build_batch_spec_matches_the_reference_for_every_config():
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import build_batch_spec as jspec
    from repro_torch.models import build_batch_spec as tspec

    for arch in tconfigs.ARCHS:
        for cfg_of in (tconfigs.get, tconfigs.smoke):
            cfg = cfg_of(arch)
            jcfg = (jconfigs.get if cfg_of is tconfigs.get
                    else jconfigs.smoke)(arch)
            for mode in ("train", "prefill", "decode"):
                mine = tspec(cfg, 4, 64, mode=mode)
                theirs = jspec(jcfg, 4, 64, mode=mode)
                assert list(mine) == list(theirs)
                for key, t in mine.items():
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == tuple(theirs[key].shape)
                    assert jnp.dtype(str(t.dtype).removeprefix("torch.")) \
                        == theirs[key].dtype


def test_cells_and_optimized_overrides_match_the_reference():
    from repro import configs as jconfigs
    # the reference's dryrun module sets XLA_FLAGS at import: read its
    # policy from the source instead of importing it into this process
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    start = src.index("SMALL_DENSE = ")
    end = src.index("\n\n\ndef input_specs")
    ns = {}
    exec(src[start:end], ns)                      # SMALL_DENSE and the fn
    assert tconfigs.cells() == jconfigs.cells()
    assert dryrun.SMALL_DENSE == ns["SMALL_DENSE"]
    for arch, shape in jconfigs.cells():
        assert dryrun.optimized_overrides(arch, shape) == \
            ns["optimized_overrides"](arch, shape)


# --------------------------------------------------------------------------
#  collective_bytes: the reference's ring factors
# --------------------------------------------------------------------------
def test_collective_bytes_gives_the_references_values():
    """``tests/test_system.py``'s three expected values, from records of
    the same collectives (its HLO: an all-gather in a while body, an
    all-reduce over pairs, a reduce-scatter over 4)."""
    out = dryrun.collective_bytes([
        ("all-gather", 16 * 256 * 4096 * 2, 4, True),
        ("all-reduce", 1024 * 4, 2, False),
        ("reduce-scatter", 64 * 64 * 4, 4, False)], while_mult=10)
    assert out["all-gather"] == int(16 * 256 * 4096 * 2 * (3 / 4) * 10)
    assert out["all-reduce"] == int(1024 * 4 * 2 * (1 / 2))
    assert out["reduce-scatter"] == 64 * 64 * 4 * 3
    out = dryrun.collective_bytes([("all-to-all", 800, 8, False),
                                   ("collective-permute", 96, 2, True)],
                                  while_mult=3)
    assert out == {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                   "all-to-all": 700, "collective-permute": 288}


# --------------------------------------------------------------------------
#  The dry-run
# --------------------------------------------------------------------------
def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_dryrun_cli_smoke_cell(tmp_path):
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b",
                "--shape", "train_4k", "--mesh", "2x4", "--smoke", "--out",
                str(tmp_path)])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "ALL 1 cells OK" in out.stdout
    rec = json.loads((tmp_path / "qwen3_0_6b_train_4k_custom_smoke.json")
                     .read_text())
    assert rec["kernels"]["flash_attention"]["launches"] == 4     # remat
    assert rec["kernels"]["flash_attention_bwd"]["launches"] == 2


def test_dryrun_full_size_cell_on_the_production_mesh(tmp_path):
    """qwen3-0.6b ``decode_32k`` at its published widths on the 16x16 fake
    mesh: one token against 128 caches of 32,768 (K1 counted at the full
    cache, an upper bound)."""
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b",
                "--shape", "decode_32k", "--out", str(tmp_path)])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "ALL 1 cells OK" in out.stdout
    rec = json.loads((tmp_path / "qwen3_0_6b_decode_32k_pod1.json")
                     .read_text())
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert (rec["seq"], rec["batch"], rec["mode"]) == (32768, 128, "decode")
    k1 = rec["kernels"]["decode_attention"]
    assert k1["launches"] == 28 and k1["upper_bound"]
    assert k1["flops"] == 28 * cost.decode_attention(
        128, 16, 8, 32768, 128, BF).flops


# the reference's cells, compared: (arch, shape); its record's flops are
# XLA's count of the partitioned program per device, the port's the traced
# total over the 8 devices.  Measured ratios (port / reference) and why:
#   qwen3-0.6b train_4k   1.462: XLA counts the scanned layers' body once
#                         (a smoke cell is not calibrated), the port every
#                         layer, remat's recomputed forward included
#   qwen3-0.6b decode_32k 0.333: XLA counts the elementwise work of the
#                         cache update and the masked softmax over every
#                         cache entry; the port's K1 counts 4 H hd a key
#   qwen3-moe train_4k    0.963: the body counted once against XLA's
#                         elementwise count of the routing
REF_CELLS = {("qwen3_0_6b", "train_4k"): 1.462,
             ("qwen3_0_6b", "decode_32k"): 0.333,
             ("qwen3_moe_235b", "train_4k"): 0.963}
# the --optimized MoE cells (``optimized_overrides``: the all-to-all
# dispatch, ``moe_a2a``), compared the same way.  Measured ratios (port /
# reference) and why: the port's a2a records count within 0.4% of its
# gather records of the same cells (0.963, 0.952, 1.206, 1.228 of the
# reference's gather records), because ragged K3 multiplies each received
# row once, by its own expert; the reference's a2a records count 1.80x
# (qwen3-moe) and 1.55x (arctic) its gather records, because its dispatch
# multiplies every one of the n_model C received rows by each of its
# E_loc local experts and masks (E_loc = 2 at smoke: 63 M of the 405 M
# FLOPs a device it adds in the train cell; the rest is the rest of the
# dispatch as XLA counts it: the top-k and masked copies a destination)
A2A_CELLS = {("qwen3_moe_235b", "train_4k"): 0.532,
             ("qwen3_moe_235b", "prefill_32k"): 0.535,
             ("arctic_480b", "train_4k"): 0.773,
             ("arctic_480b", "prefill_32k"): 0.790}
# the port's decode takes the cache's ``length`` as a Python int, where
# the reference's cache carries it as an int32 device scalar
LENGTH_LEAF = 4


@pytest.fixture(scope="module")
def reference_records():
    """The reference's records of REF_CELLS, then of A2A_CELLS with its
    ``optimized_overrides``, from one JAX subprocess on 8 host devices (the
    reference's own test setting) and a 2x4 mesh."""
    code = (
        "import json\n"
        "import repro.launch.dryrun as d\n"
        "from repro.launch.mesh import make_mesh\n"
        "mesh = make_mesh((2, 4), ('data', 'model'))\n"
        f"recs = [d.lower_cell(a, s, mesh, smoke=True, verbose=False) "
        f"for a, s in {list(REF_CELLS)!r}]\n"
        f"recs += [d.lower_cell(a, s, mesh, smoke=True, verbose=False, "
        f"overrides=d.optimized_overrides(a, s)) "
        f"for a, s in {list(A2A_CELLS)!r}]\n"
        "print(json.dumps(recs))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_mesh_2x4():
    """A 2x4 mesh over an in-process fake process group of 8 ranks,
    destroyed when the module's tests are done."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    dryrun.init_fake_group(8)
    try:
        yield make_mesh((2, 4), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cell", list(REF_CELLS),
                         ids=["_".join(c) for c in REF_CELLS])
def test_dryrun_record_matches_the_references(cell, reference_records,
                                              fake_mesh_2x4):
    theirs = reference_records[list(REF_CELLS).index(cell)]
    mine = dryrun.lower_cell(*cell, fake_mesh_2x4, smoke=True, verbose=False)
    for key in ("arch", "shape", "mode", "mesh", "seq", "batch", "params",
                "active_params"):
        assert mine[key] == theirs[key], key
    args = theirs["memory"]["argument_size_in_bytes"]
    assert mine["memory"]["argument_size_in_bytes"] == \
        args - (LENGTH_LEAF if mine["mode"] == "decode" else 0)
    assert set(mine["collectives"]) == set(theirs["collectives"])
    ratio = mine["cost"]["flops"] / theirs["cost"]["flops"]
    assert abs(ratio / REF_CELLS[cell] - 1) < 0.05, ratio
    assert mine["cost"]["calibrated"] is True
    assert mine["cost"]["flops"] * 8 == mine["cost_raw"]["flops"]


def test_dryrun_on_a_mesh_records_the_ports_own_collectives(fake_mesh_2x4):
    """Dense layers issue none (their tensors stay replicated); the MoE's
    gather dispatch enters its region, sums over ``model`` and gathers
    over ``data``."""
    dense = dryrun.lower_cell("qwen3_0_6b", "prefill_32k", fake_mesh_2x4,
                              smoke=True, verbose=False)
    assert sum(dense["collectives"].values()) == 0
    moe = dryrun.lower_cell("qwen3_moe_235b", "prefill_32k", fake_mesh_2x4,
                            smoke=True, verbose=False)
    assert moe["collectives"]["all-reduce"] > 0
    assert moe["collectives"]["all-gather"] > 0
    assert moe["collectives"]["all-to-all"] == 0


@pytest.mark.parametrize("cell", list(A2A_CELLS),
                         ids=["_".join(c) for c in A2A_CELLS])
def test_dryrun_optimized_moe_cell_matches_the_references(
        cell, reference_records, fake_mesh_2x4):
    """The ``--optimized`` MoE train and prefill cells (the all-to-all
    dispatch) record on the 2x4 fake mesh: parameters, active parameters
    and argument bytes equal to the reference's record of the same cell,
    all-to-all bytes in both, K3 and (training) its backward recorded as
    ragged upper bounds, and the FLOPs at A2A_CELLS's ratio."""
    theirs = reference_records[len(REF_CELLS) + list(A2A_CELLS).index(cell)]
    overrides = dryrun.optimized_overrides(*cell)
    assert overrides == {"moe_a2a": True}
    mine = dryrun.lower_cell(*cell, fake_mesh_2x4, smoke=True, verbose=False,
                             overrides=overrides)
    for key in ("arch", "shape", "mode", "mesh", "seq", "batch", "params",
                "active_params"):
        assert mine[key] == theirs[key], key
    assert mine["memory"]["argument_size_in_bytes"] == \
        theirs["memory"]["argument_size_in_bytes"]
    assert mine["collectives"]["all-to-all"] > 0
    assert theirs["collectives"]["all-to-all"] > 0
    k3 = mine["kernels"]["moe_gmm"]
    assert k3["launches"] == 6 * (2 if mine["mode"] == "train" else 1)
    assert k3["upper_bound"]
    assert ("moe_gmm_bwd" in mine["kernels"]) == (mine["mode"] == "train")
    ratio = mine["cost"]["flops"] / theirs["cost"]["flops"]
    assert abs(ratio / A2A_CELLS[cell] - 1) < 0.05, ratio


def test_a2a_dispatch_runs_on_fake_tensors(fake_mesh_2x4):
    """``moe_a2a_block`` has one static form: on fake tensors it runs on
    the plain path, and on the card's path it records three ragged K3
    calls over the n_model C received rows (upper bounds) and, through
    the backward, three of K3's backward, launching nothing."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(tconfigs.smoke("qwen3_moe_235b"), moe_a2a=True)
    n_model = 4
    E_loc, D, F = cfg.n_experts // n_model, cfg.d_model, cfg.e_ff
    B, T = 2, 8
    # the a2a capacity a destination, as moe_a2a_block sizes it
    M = n_model * min(max(4, -(-int(B * T * cfg.top_k * cfg.capacity_factor
                                    / n_model) // 4) * 4), B * T * cfg.top_k)
    ops.reset_launch_counts()
    with FakeTensorMode():
        p = {"router": _fake(D, cfg.n_experts),
             "w_gate": _fake(E_loc, D, F, grad=True),
             "w_up": _fake(E_loc, D, F, grad=True),
             "w_down": _fake(E_loc, F, D, grad=True)}
        x = _fake(B, T, D, grad=True)
        y, aux = moe.moe_a2a_block(cfg, p, x, n_model, mesh=fake_mesh_2x4)
        assert isinstance(y, FakeTensor) and y.shape == (B, T, D)
        with cost.card_path(), cost.recording() as calls:
            y, aux = moe.moe_a2a_block(cfg, p, x, n_model,
                                       mesh=fake_mesh_2x4)
            (y.sum() + aux).backward()
    assert y.shape == (B, T, D) and x.grad.shape == x.shape
    assert [(r.name, r.upper_bound) for r in calls] == \
        [("moe_gmm", True)] * 3 + [("moe_gmm_bwd", True)] * 3
    assert all(r.args["ragged"] and r.args["C"] == M and r.args["E"] == E_loc
               for r in calls)
    assert not any(ops.launch_counts().values())


def test_trace_notes_an_all_to_all(fake_mesh_2x4):
    """A c10d collective writes its result into its first argument: the
    trace counts that argument's bytes."""
    from repro_torch.dist import collectives as coll
    with FakeTensorMode():
        t = torch.empty(4, 8, 16)
        with dryrun._Trace(t) as trace:
            coll.all_to_all(t, coll.groups(fake_mesh_2x4, ("model",))[0])
    assert trace.collectives == [("all-to-all", 4 * 8 * 16 * 4, 4, False)]


def test_trace_notes_dtensor_redistributes(fake_mesh_2x4):
    """A DTensor redistribute is a functional collective: the trace notes
    its kind, result bytes and group size."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with FakeTensorMode():
        local = torch.empty(4, 32)
        d = DTensor.from_local(local, fake_mesh_2x4, [Shard(0), Replicate()],
                               run_check=False)
        with dryrun._Trace(local) as trace:
            d.redistribute(fake_mesh_2x4, [Replicate(), Replicate()])
    assert trace.collectives == [("all-gather", 8 * 32 * 4, 2, False)]


# the plain counterpart of each kernel as the model calls it: the module
# and attribute the plain path looks up at each call
PLAIN_FNS = [("repro_torch.models.layers", "attention"),
             ("repro_torch.kernels.ref", "moe_gmm"),
             ("repro_torch.kernels.ref", "rwkv_scan"),
             ("repro_torch.kernels.ref", "rglru_scan")]


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "rwkv6_3b",
                                  "recurrentgemma_9b", "qwen3_moe_235b"])
def test_kernel_and_plain_traces_reconcile(arch, monkeypatch):
    """A prefill traced on the card's path and on the plain path: the
    plain path's FLOPs are the kernel path's aten FLOPs plus, call for
    call, the FLOPs of the plain counterparts of the recorded kernels; the
    train step records each kernel's forward twice a layer (remat) and its
    backward once, then AdamW's update once a leaf, and its FLOPs are
    aten's plus ``cost.py``'s counts."""
    import importlib

    from repro_torch.models import init_params
    from repro_torch.train.optimizer import _zip

    cfg = dataclasses.replace(tconfigs.smoke(arch), n_layers=3)
    plain_calls = []

    def counted(fn):
        def wrapper(*a, **kw):
            with FlopCounterMode(display=False) as fc:
                out = fn(*a, **kw)
            plain_calls.append(fc.get_total_flops())
            return out
        return wrapper

    for mod, name in PLAIN_FNS:
        m = importlib.import_module(mod)
        monkeypatch.setattr(m, name, counted(getattr(m, name)))
    card = dryrun.trace_step(cfg, "prefill", 2, 64, device="cuda")
    assert plain_calls == []                       # every call a kernel's
    plain = dryrun.trace_step(cfg, "prefill", 2, 64, device="cpu")
    launches = sum(k["launches"] for k in card["kernels"].values())
    assert len(plain_calls) == launches > 0 and plain["kernels"] == {}
    assert plain["cost_raw"]["flops"] == \
        card["cost_raw"]["aten_flops"] + sum(plain_calls)
    assert card["cost_raw"]["flops"] == card["cost_raw"]["aten_flops"] + \
        sum(k["flops"] for k in card["kernels"].values())

    from repro_torch.train.optimizer import OptConfig
    train = dryrun.trace_step(cfg, "train", 2, 64, opt=OptConfig())
    model = {k: v for k, v in train["kernels"].items() if k != "adamw"}
    leaves = len(_zip(init_params(cfg, device="meta")))
    assert train["kernels"]["adamw"]["launches"] == leaves
    fwd = {k: v["launches"] for k, v in model.items()
           if not k.endswith("_bwd")}
    bwd = {k[:-4]: v["launches"] for k, v in model.items()
           if k.endswith("_bwd")}
    assert fwd == {k: 2 * v for k, v in bwd.items()}   # remat: twice
    assert fwd == {k: 2 * v["launches"] for k, v in card["kernels"].items()}
    assert train["cost_raw"]["flops"] == train["cost_raw"]["aten_flops"] + \
        sum(k["flops"] for k in train["kernels"].values())
