"""The port's cost and benchmark tooling against the reference's
``benchmarks/``: the roofline (``roofline.analyze`` with the reference's TPU
constants gives its numbers; with the H100's, the hand-computed terms),
``perf_iter``, the paper's figures and tables (every row equal but the one
wall-clock column), the kernel bench's seeded inputs and outputs, and the
full and ``--fast`` runs of ``benchmarks.run``.  Everything runs on the CPU
(``device="cpu"``); the reference's modules that set ``XLA_FLAGS`` at
import (``perf_iter``) are read from their source instead."""

import ast
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import paper_figs as jfigs                    # noqa: E402
from benchmarks import roofline as jroof                      # noqa: E402

from repro_torch.benchmarks import kernel_bench               # noqa: E402
from repro_torch.benchmarks import paper_figs as tfigs        # noqa: E402
from repro_torch.benchmarks import perf_iter                  # noqa: E402
from repro_torch.benchmarks import roofline as troof          # noqa: E402
from repro_torch.benchmarks import run as trun                # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WALL = "table2_deref_fastpath_wall"       # its us is a wall-clock time
TPU = dict(PEAK_FLOPS=197e12, HBM_BW=819e9, NET_BW=50e9)   # the reference's


# --------------------------------------------------------------------------
#  roofline
# --------------------------------------------------------------------------
def _rec(mode, mesh, seq, batch, flops, nbytes, coll, mem, n_active=5e8):
    return {"arch": "qwen3_0_6b", "shape": {"train": "train_4k",
                                            "prefill": "prefill_32k",
                                            "decode": "decode_32k"}[mode],
            "mode": mode, "mesh": mesh, "seq": seq, "batch": batch,
            "active_params": n_active,
            "cost": {"flops": flops, "bytes_accessed": nbytes,
                     "calibrated": True},
            "collectives": {"all-gather": coll, "all-reduce": 2 * coll,
                            "reduce-scatter": 0, "all-to-all": coll // 3,
                            "collective-permute": 0},
            "memory": {"argument_size_in_bytes": mem,
                       "output_size_in_bytes": mem // 2,
                       "temp_size_in_bytes": 3 * mem}}


RECORDS = [
    _rec("train", {"data": 16, "model": 16}, 4096, 256, 3.1e15, 2.2e12,
         4_000_000, 9_000_000_000),
    _rec("prefill", {"pod": 2, "data": 16, "model": 16}, 32768, 32, 8.8e13,
         6.1e11, 70_000_000, 1_000_000_000),
    _rec("decode", {"data": 16, "model": 16}, 32768, 128, 6.1e8, 5.2e8,
         17_000_000, 2_400_000_000),
]


@pytest.mark.parametrize("rec", RECORDS, ids=[r["mode"] for r in RECORDS])
def test_roofline_with_the_references_constants_is_the_references(
        rec, monkeypatch):
    for name, value in TPU.items():
        monkeypatch.setattr(troof, name, value)
    assert troof.analyze(rec) == jroof.analyze(rec)
    assert troof.model_flops(rec) == jroof.model_flops(rec)


@pytest.mark.parametrize("rec", RECORDS, ids=[r["mode"] for r in RECORDS])
def test_roofline_with_the_h100s_constants(rec):
    a = troof.analyze(rec)
    n_dev = int(np.prod(list(rec["mesh"].values())))
    mem = rec["memory"]
    floor = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
             + 2 * mem["temp_size_in_bytes"]) / 3.35e12
    coll = sum(rec["collectives"].values()) / 50e9
    assert a["compute_s"] == rec["cost"]["flops"] / 989e12
    assert a["memory_s"] == rec["cost"]["bytes_accessed"] / 3.35e12
    assert a["memory_floor_s"] == floor and a["collective_s"] == coll
    step = max(a["compute_s"], floor, coll)
    mf = troof.model_flops(rec) / n_dev
    assert a["roofline_frac"] == pytest.approx(mf / 989e12 / step, rel=1e-12)
    assert a["bottleneck"] == max(
        {"compute": a["compute_s"], "memory": floor, "collective": coll}
        .items(), key=lambda kv: kv[1])[0]
    assert troof.PEAK_FLOPS == 989e12 and troof.HBM_BW == 3.35e12
    assert troof.NET_BW == 50e9 and troof.NVLINK_BW == 900e9


def test_roofline_tables_over_artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(troof, "ARTIFACTS", tmp_path)
    for rec, name in zip(RECORDS, ("a_train_4k_pod1", "b_prefill_32k_pod2",
                                   "c_decode_32k_pod1")):
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    opt = dict(RECORDS[0], collectives={k: 0 for k in
                                        RECORDS[0]["collectives"]})
    (tmp_path / "a_train_4k_pod1_opt.json").write_text(json.dumps(opt))
    (tmp_path / "a_train_4k_pod1_smoke.json").write_text(json.dumps(opt))
    rows = troof.all_rows()
    assert [r[0] for r in rows] == [
        "roofline_qwen3_0_6bxtrain_4k_16x16",
        "roofline_qwen3_0_6bxdecode_32k_16x16",
        "roofline_qwen3_0_6bxprefill_32k_2x16x16",
        "roofline_opt_qwen3_0_6bxtrain_4k_16x16"]
    assert troof.table().count("\n") == 3
    assert "qwen3_0_6bxtrain_4k" in troof.opt_comparison()
    monkeypatch.setattr(troof, "ARTIFACTS", tmp_path / "none")
    assert troof.all_rows() == []


# --------------------------------------------------------------------------
#  perf_iter
# --------------------------------------------------------------------------
def _reference_parse_val():
    """``benchmarks/perf_iter.py::parse_val`` from its source: importing
    the module would set ``XLA_FLAGS`` in this process."""
    src = (ROOT / "benchmarks" / "perf_iter.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "parse_val")
    ns = {}
    exec(compile(ast.Module([fn], []), "perf_iter.py", "exec"), ns)
    return ns["parse_val"]


def test_parse_val_is_the_references():
    theirs = _reference_parse_val()
    for v in ("true", "False", "TRUE", "0", "-3", "17", "1.5", "1e-3",
              "nan", "abc", "2x4", ""):
        mine = perf_iter.parse_val(v)
        assert type(mine) is type(theirs(v)) and (
            mine == theirs(v) or (mine != mine and theirs(v) != theirs(v)))


def test_perf_iter_runs_one_cell(capsys):
    import torch.distributed as dist
    a = perf_iter.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--set", "decode_shard_s=true"])
    assert not dist.is_initialized()
    assert a["cell"] == "qwen3_0_6bxdecode_32k" and a["mesh"] == "16x16"
    assert 0 < a["useful_frac"] <= 1 and a["collective_s"] > 0
    assert '"cell": "qwen3_0_6bxdecode_32k"' in capsys.readouterr().out


# --------------------------------------------------------------------------
#  the paper's figures and tables
# --------------------------------------------------------------------------
def _same(mine, theirs):
    """Row for row, the names and values equal but the wall-clock us."""
    assert [r[0] for r in mine] == [r[0] for r in theirs]
    for m, t in zip(mine, theirs):
        if m[0] == WALL:
            assert m[2] == t[2]
        else:
            assert m == t, (m, t)


@pytest.fixture(scope="module")
def reference_full_figs():
    """The reference's rows of the full run (its figures run once here: the
    JAX package's GEMM is slow on a loaded CPU)."""
    return jfigs.all_rows()


def _fast_of(full):
    """The reference's ``all_rows(fast=True)`` from its full rows: every
    row is one deterministic run, and ``fast`` runs Fig. 5 at 1 and 8
    nodes and the QP sweep at depths 16 and 64 only."""
    def kept(name):
        if name.startswith("fig5_"):
            return name.endswith(("_1n", "_8n"))
        return not name.startswith("qpsweep_depth224_")
    return [r for r in full if kept(r[0])]


def test_paper_figs_fast_rows_are_the_references(reference_full_figs):
    _same(tfigs.all_rows(fast=True, device="cpu"),
          _fast_of(reference_full_figs))


def test_fig5_scaling_rows_are_the_references(reference_full_figs):
    mine = tfigs.fig5_scaling(device="cpu")
    _same(mine, reference_full_figs[:len(mine)])
    assert len(mine) == 4 * 3 * 4 + 4


# --------------------------------------------------------------------------
#  the kernel bench
# --------------------------------------------------------------------------
def _reference_inputs():
    """The reference's draws, in its order (``benchmarks/kernel_bench.py``):
    float32 standard normals from ``default_rng(0)`` and its sigmoids."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)

    def arr(*s):
        return jnp.asarray(rng.standard_normal(s), jnp.float32)

    q, k, v = arr(1, 4, 256, 64), arr(1, 2, 256, 64), arr(1, 2, 256, 64)
    q1, k1, v1 = arr(1, 4, 64), arr(1, 2, 512, 64), arr(1, 2, 512, 64)
    x, w = arr(4, 128, 256), arr(4, 256, 128)
    r, k2, v2 = arr(1, 2, 128, 32), arr(1, 2, 128, 32), arr(1, 2, 128, 32)
    logw = -0.105 * jax.nn.sigmoid(arr(1, 2, 128, 32))
    u = arr(2, 32) * 0.1
    a, b = jax.nn.sigmoid(arr(2, 256, 128)), arr(2, 256, 128)
    return {"flash_attention": (q, k, v),
            "decode_attention": (q1, k1, v1, jnp.full((1,), 512, jnp.int32)),
            "moe_gmm": (x, w), "rwkv_scan": (r, k2, v2, logw, u),
            "rglru_scan": (a, b)}


# the inputs that pass through a float32 sigmoid: XLA's and torch's agree
# to two float32 roundings (measured: 3 of 65,536 entries differ, by 2^-23)
SIGMOID = {("rwkv_scan", 3), ("rglru_scan", 0)}


def test_kernel_bench_draws_the_references_inputs():
    theirs = _reference_inputs()
    mine = kernel_bench.inputs()
    assert list(mine) == list(theirs)
    assert list(kernel_bench.inputs(fast=True)) == list(theirs)[:3]
    for name, arrays in mine.items():
        for i, (m, t) in enumerate(zip(arrays, theirs[name], strict=True)):
            t = np.asarray(t)
            assert m.dtype == t.dtype and m.shape == t.shape
            if (name, i) in SIGMOID:
                np.testing.assert_allclose(m, t, rtol=2 ** -22, atol=0)
            else:
                assert np.array_equal(m, t), (name, i)


def test_kernel_bench_outputs_agree_with_the_reference_kernels():
    """Each plain version on the bench's inputs against ``repro.kernels.
    ref`` on the same arrays, at ``tests/test_kernels.py``'s float32
    tolerance (2e-3)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    jfn = {"flash_attention": jref.attention,
           "decode_attention": jref.decode_attention,
           "moe_gmm": jref.moe_gmm,
           "rwkv_scan": lambda *a: jref.rwkv_scan(*a)[0],
           "rglru_scan": jref.rglru_scan}
    cases = kernel_bench.cases(device="cpu")
    assert [c[0] for c in cases] == [n for n, _ in kernel_bench.ROWS]
    for name, kernel, plain, args, _ in cases:
        got = plain(*args).numpy()
        want = np.asarray(jfn[name](*(jnp.asarray(a.numpy())
                                      for a in args)))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                   err_msg=name)
        np.testing.assert_array_equal(kernel(*args).numpy(), got)
    rows = kernel_bench.all_rows(device="cpu")
    assert [r[0] for r in rows] == [f"kernel_{n}_plain"
                                    for n, _ in kernel_bench.ROWS]
    assert all(r[1] > 0 and r[2] > 0 for r in rows)


# --------------------------------------------------------------------------
#  benchmarks.run: the full run and --fast
# --------------------------------------------------------------------------
def _csv(capsys):
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    return [line.split(",") for line in lines[1:]]


def _expected(figs, fast):
    """The reference's rows of a run, as (name, us, derived) strings: the
    figures, then the protocol micro-benchmarks (the committed summary's
    names), then the kernel bench with the CPU's row names."""
    micro = json.loads((ROOT / "BENCH_protocol.json").read_text())["micro"]
    kernels = [n for n, _ in kernel_bench.ROWS][:3 if fast else 5]
    return ([(n, f"{us:.2f}", str(d)) for n, us, d in figs],
            sorted(micro), [f"kernel_{n}_plain" for n in kernels])


def _check_run(rows, figs, fast):
    want_figs, want_micro, want_kernels = _expected(figs, fast)
    n_figs, n_micro = len(want_figs), len(want_micro)
    got_figs = [tuple(r) for r in rows[:n_figs]]
    for got, want in zip(got_figs, want_figs, strict=True):
        assert got[0] == want[0]
        assert got[1:] == want[1:] or (got[0] == WALL and got[2] == want[2])
    assert sorted(r[0] for r in rows[n_figs:n_figs + n_micro]) == want_micro
    end = n_figs + n_micro + len(want_kernels)
    assert [r[0] for r in rows[n_figs + n_micro:end]] == want_kernels
    # then the roofline's rows, one a dry-run record in artifacts/
    assert all(r[0].startswith("roofline_") for r in rows[end:])


def test_run_fast_prints_the_references_rows(capsys, reference_full_figs):
    assert trun.main(["--fast", "--device", "cpu"]) == 0
    _check_run(_csv(capsys), _fast_of(reference_full_figs), fast=True)


def test_run_full_prints_the_references_rows(capsys, reference_full_figs):
    assert trun.main(["--device", "cpu"]) == 0
    _check_run(_csv(capsys), reference_full_figs, fast=False)
