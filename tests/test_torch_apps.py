"""The paper's four DSM applications in the port, held to the JAX package on
the CPU: every app on drust, gam and grappa at 1, 2 and 4 servers under
each of its modes gives the reference's ops, makespan, ``NetStats`` and
digests (DataFrame's float digest within 1e-12: torch and numpy sum
float64 in different orders); the ``apps``, ``prefetch``,
``placement_sweep`` and ``lock_sweep`` sections of ``BENCH_protocol.json``
are reproduced exactly by the port's runners (``repro_torch.benchmarks``)
and equal the reference's runners' rows; and the
reference's app-level assertions (``tests/test_apps.py``) hold for the
port.  Everything runs on virtual clocks, so equality is exact."""

import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps as japps                                   # noqa: E402

from benchmarks import protocol_micro as jpm                 # noqa: E402
from benchmarks import run as jrun                           # noqa: E402

import repro_torch.apps as tapps                             # noqa: E402
import repro_torch.core as tcore                             # noqa: E402
from repro_torch.benchmarks import protocol_micro as tpm     # noqa: E402
from repro_torch.benchmarks import run as trun               # noqa: E402
from repro_torch.core.ownership import _clone                # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCH_protocol.json").read_text())
BACKENDS = ("drust", "gam", "grappa")
ON_DEVICE = ("gemm", "dataframe")        # the apps whose payloads are tensors

# tests/test_apps.py's SMALL sizes
SMALL = {
    "gemm": dict(n=256, tile=64),
    "dataframe": dict(n_columns=4, chunks_per_column=8, n_ops=2),
    "kvstore": dict(n_keys=64, n_ops=200),
    "socialnet": dict(n_requests=40),
}
OOO = dict(ooo=True, qps_per_thread=2)
# (app, mode, kwargs): each app's planes and options
MODES = [
    *[(app, "base", {}) for app in SMALL],
    *[(app, "ooo", OOO) for app in ("dataframe", "kvstore", "socialnet")],
    *[(app, "unbatched", dict(batch_io=False))
      for app in ("dataframe", "socialnet")],
    *[(app, "manual", dict(coalesce="manual"))
      for app in ("dataframe", "socialnet")],
    ("gemm", "prefetch", dict(prefetch=True)),
    ("kvstore", "window8", dict(prefetch_window=8)),
    ("kvstore", "txn", dict(txn_frac=0.3)),
    ("kvstore", "delegate", dict(lock_mode="delegate")),
    ("kvstore", "txn_delegate_ooo", dict(txn_frac=0.3, lock_mode="delegate",
                                         **OOO)),
    ("dataframe", "tbox", dict(use_tbox=True)),
    ("dataframe", "spawn_to", dict(use_spawn_to=True)),
    ("dataframe", "tbox_spawn_to_ooo", dict(use_tbox=True, use_spawn_to=True,
                                            **OOO)),
    ("socialnet", "by_value", dict(by_value=True)),
    ("socialnet", "by_value_ooo", dict(by_value=True, **OOO)),
]


def _run(apps, app, *args, **kw):
    """One run of ``app`` from either package; the port's on the CPU."""
    if apps is tapps and app in ON_DEVICE:
        kw["device"] = "cpu"
    return apps.APPS[app](*args, **kw)


def _assert_same(mine, ref):
    assert (mine.app, mine.backend, mine.n_servers, mine.ops,
            mine.makespan_us, mine.net) == (ref.app, ref.backend,
                                            ref.n_servers, ref.ops,
                                            ref.makespan_us, ref.net)
    extra, ref_extra = dict(mine.extra), dict(ref.extra)
    if mine.app == "dataframe" and "skew" not in extra:
        digest = extra.pop("result_digest")
        assert digest == pytest.approx(ref_extra.pop("result_digest"),
                                       rel=1e-12, abs=0)
    assert extra == ref_extra


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("app,mode,kw", MODES,
                         ids=[f"{a}-{m}" for a, m, _ in MODES])
def test_app_matches_jax(app, mode, kw, backend, n):
    mine = _run(tapps, app, n, backend=backend, **SMALL[app], **kw)
    ref = _run(japps, app, n, backend=backend, **SMALL[app], **kw)
    _assert_same(mine, ref)
    assert mine.ops > 0 and mine.makespan_us > 0


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gemm_product_matches_reference_oracle(backend, prefetch):
    """The distributed product against the reference's ``A @ B`` (numpy,
    the same seed), at the reference's tolerance."""
    n, tile = 256, 64
    out = torch.zeros((n, n), dtype=torch.float32)
    tapps.run_gemm(2, backend, n=n, tile=tile, prefetch=prefetch,
                   device="cpu", out=out)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    np.testing.assert_allclose(out.numpy(), A @ B, rtol=2e-3, atol=5e-2)


def test_gemm_and_dataframe_refuse_cuda_without_a_card(monkeypatch):
    """No fallback: with no card, the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapps.run_gemm(1, n=128, tile=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapps.run_dataframe(1, n_columns=1, chunks_per_column=2, n_ops=1)


# --------------------------------------------------------------------------
#  Tensor payloads: the same costs as numpy payloads; a cache holds a copy
# --------------------------------------------------------------------------
def _tile_reads(backend, make):
    cl = tcore.Cluster(2, backend=backend)
    boot = cl.main_thread(0)
    hs = [cl.backend.alloc(boot, 64 * 64 * 4,
                           make(np.full((64, 64), i, np.float32)),
                           server=i % 2) for i in range(4)]
    reader = cl.main_thread(0)
    reader.server = 1
    sums = []
    for h in hs + hs:                        # the second pass hits caches
        with h.read(reader) as v:
            sums.append(float(v.sum()))
    return dataclasses.asdict(cl.sim.net), cl.makespan_us(), sums


@pytest.mark.parametrize("backend", BACKENDS)
def test_tensor_payloads_cost_what_numpy_payloads_cost(backend):
    assert (_tile_reads(backend, torch.from_numpy)
            == _tile_reads(backend, lambda a: a))


@pytest.mark.parametrize("backend", BACKENDS)
def test_remote_tensor_read_is_a_copy_not_an_alias(backend):
    cl = tcore.Cluster(2, backend=backend)
    owner = cl.main_thread(0)
    h = cl.backend.alloc(owner, 1024, torch.arange(256.0), server=0)
    raw = tcore.addr.clear_color(h.g) if hasattr(h, "g") else h.raw
    home = cl.heap.get(raw).data
    reader = cl.main_thread(0)
    reader.server = 1
    with h.read(reader) as v:
        assert torch.equal(v, home)
        assert v.untyped_storage().data_ptr() != \
            home.untyped_storage().data_ptr()


def test_clone_keeps_device_and_dtype_and_copies():
    t = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    c = _clone(t)
    assert c.dtype == t.dtype and c.device == t.device and torch.equal(c, t)
    c += 1
    assert t[0, 0] == 0


# --------------------------------------------------------------------------
#  BENCH_protocol.json, reproduced by the port's runners
#  (repro_torch.benchmarks), each held to the committed file and to the
#  reference's runners (benchmarks/run.py, benchmarks/protocol_micro.py)
# --------------------------------------------------------------------------
# benchmarks/run.py::quick's "apps" runs (benchmarks/run.py:83-94)
REF_APPS = {
    "socialnet": dict(n_requests=120),
    "dataframe": dict(n_columns=4, chunks_per_column=8, n_ops=4,
                      use_tbox=True),
}
REF_APP_MODES = (("batched", dict(batch_io=True, coalesce="manual")),
                 ("unbatched", dict(batch_io=False, coalesce="manual")),
                 ("auto", dict(batch_io=True, coalesce="auto")))


def _ref_apps_entry(app):
    """``benchmarks/run.py::quick``'s ``apps`` row of ``app``."""
    entry = {mode: jrun._app_stats(japps.APPS[app](4, "drust", **mkw,
                                                   **REF_APPS[app]))
             for mode, mkw in REF_APP_MODES}
    entry["rtt_ratio"] = round(entry["unbatched"]["round_trips"]
                               / max(1, entry["batched"]["round_trips"]), 2)
    return entry


@pytest.mark.parametrize("app", ["dataframe", "socialnet"])
def test_bench_apps_rows_reproduced_exactly(app):
    mine = trun.apps_entry(app, device="cpu")
    assert mine == BENCH["apps"][app]
    assert mine == _ref_apps_entry(app)


# benchmarks/run.py::quick's "prefetch" runs
REF_PREFETCH = {
    "gemm_prefetch": ("gemm", dict(n=256, tile=64, prefetch=True)),
    "kvstore_window8": ("kvstore", dict(n_keys=256, n_ops=600,
                                        prefetch_window=8)),
}


def _ref_prefetch_row(name):
    app, kw = REF_PREFETCH[name]
    r = japps.APPS[app](4, "drust", **kw)
    return {"makespan_us": round(r.makespan_us, 2),
            **{k: r.net[k] for k in ("round_trips", "speculative_fetches",
                                     "late_fences", "wasted_prefetches")}}


@pytest.mark.parametrize("name", sorted(REF_PREFETCH))
def test_bench_prefetch_rows_reproduced_exactly(name):
    assert set(trun.PREFETCH) == set(REF_PREFETCH)
    mine = trun.prefetch_entry(name, device="cpu")
    assert mine == BENCH["prefetch"][name]
    assert mine == _ref_prefetch_row(name)


@functools.cache
def _placement(pm, n):
    """A package's placement rows at ``n`` servers (both apps)."""
    kw = {"device": "cpu"} if pm is tpm else {}
    return pm.placement_summary((n,), **kw)


def _of(rows, app):
    return {k: v for k, v in rows.items() if k.startswith(f"{app}_")}


@pytest.mark.parametrize("n", [2, 8, 16, 64])
@pytest.mark.parametrize("app", ["socialnet", "dataframe"])
def test_bench_placement_rows_reproduced_exactly(app, n):
    mine = _of(_placement(tpm, n), app)
    assert len(mine) == 3
    assert mine == {k: BENCH["placement_sweep"][k] for k in mine}
    assert mine == _of(_placement(jpm, n), app)
    assert mine[f"{app}_auto_{n}srv"]["auto_beats_static"]


@pytest.mark.parametrize("n", [2, 8, 64])
def test_bench_lock_sweep_rows_reproduced_exactly(n):
    mine = tpm.lock_sweep_summary((n,))
    assert len(mine) == 3
    assert mine == {k: BENCH["lock_sweep"][k] for k in mine}
    assert mine == jpm.lock_sweep_summary((n,))


def test_zipf_keys_match_jax():
    for alpha, seed in ((0.99, 0), (0.5, 7), (1.2, 3)):
        np.testing.assert_array_equal(
            tapps.zipf_keys(500, 64, alpha, seed),
            japps.zipf_keys(500, 64, alpha, seed))


# --------------------------------------------------------------------------
#  The reference's app-level assertions (tests/test_apps.py), on the port
# --------------------------------------------------------------------------
@pytest.mark.parametrize("app", list(SMALL))
def test_drust_beats_baselines_at_scale(app):
    """Fig. 5 ordering: DRust fastest on every app at 8 nodes."""
    spans = {b: _run(tapps, app, 8, backend=b, **SMALL[app]).makespan_us
             for b in BACKENDS}
    assert spans["drust"] < spans["gam"]
    assert spans["drust"] < spans["grappa"]


def test_affinity_annotations_help():
    base = tapps.run_dataframe(8, "drust", device="cpu").makespan_us
    both = tapps.run_dataframe(8, "drust", use_tbox=True, use_spawn_to=True,
                               device="cpu").makespan_us
    assert both < base                  # Fig. 6: +TBox+spawn_to speeds up


def test_single_node_overhead_small():
    """DRust adds <= ~5% over the plain program on one node."""
    from repro_torch.apps.gemm import plain_gemm_us
    r = tapps.run_gemm(1, backend="drust", n=512, tile=128, device="cpu")
    assert r.makespan_us / plain_gemm_us(n=512, tile=128) - 1.0 < 0.05


@pytest.mark.parametrize("backend", BACKENDS)
def test_kvstore_two_node_dip(backend):
    """Fig. 5d: every DSM dips when going 1 -> 2 nodes."""
    one = tapps.run_kvstore(1, backend=backend, n_keys=512, n_ops=600)
    two = tapps.run_kvstore(2, backend=backend, n_keys=512, n_ops=600)
    assert two.ops / two.makespan_us < one.ops / one.makespan_us * 1.35


def test_socialnet_reference_passing_beats_by_value():
    ref_run = tapps.run_socialnet(4, backend="drust", n_requests=60)
    val_run = tapps.run_socialnet(4, backend="drust", n_requests=60,
                                  by_value=True)
    assert ref_run.makespan_us < val_run.makespan_us


EQUIV_KW = {"socialnet": dict(n_requests=120),
            "dataframe": dict(n_columns=4, chunks_per_column=8, n_ops=4)}
DIGEST_KEY = {"socialnet": "payload_digest", "dataframe": "result_digest"}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("app", ["socialnet", "dataframe"])
def test_auto_coalescing_matches_or_beats_manual(app, n):
    auto = _run(tapps, app, n, "drust", coalesce="auto", **EQUIV_KW[app])
    manual = _run(tapps, app, n, "drust", coalesce="manual",
                  **EQUIV_KW[app])
    assert (auto.extra["coalesce"], manual.extra["coalesce"]) \
        == ("auto", "manual")
    assert auto.net["round_trips"] <= manual.net["round_trips"]
    assert auto.net["bytes_moved"] <= manual.net["bytes_moved"]
    assert auto.extra[DIGEST_KEY[app]] == manual.extra[DIGEST_KEY[app]]
    if n == 8:
        assert auto.makespan_us <= manual.makespan_us


def test_socialnet_drain_order_deterministic():
    from repro_torch.apps.socialnet import drain_order
    scrambled = {(3, 1): [3], (0, 2): [0], (2, 0): [2], (1, 2): [1],
                 (2, 3): [99]}
    assert drain_order(scrambled) == [(0, 2), (1, 2), (2, 0), (2, 3), (3, 1)]


def test_gemm_prefetch_mode_hides_round_trips():
    base = tapps.run_gemm(4, "drust", n=256, tile=64, device="cpu")
    pre = tapps.run_gemm(4, "drust", n=256, tile=64, prefetch=True,
                         device="cpu")
    assert pre.net["speculative_fetches"] > 0
    assert pre.net["late_fences"] == pre.net["speculative_fetches"]
    assert pre.net["wasted_prefetches"] == 0
    assert pre.net["round_trips"] < base.net["round_trips"]
    assert pre.makespan_us < base.makespan_us


def test_kvstore_prefetch_window_overlaps_fetches():
    base = tapps.run_kvstore(4, "drust", n_keys=256, n_ops=600)
    pre = tapps.run_kvstore(4, "drust", n_keys=256, n_ops=600,
                            prefetch_window=8)
    assert pre.net["late_fences"] > 0 and pre.net["wasted_prefetches"] > 0
    assert (pre.net["late_fences"] + pre.net["wasted_prefetches"]
            == pre.net["speculative_fetches"])
    assert pre.makespan_us < base.makespan_us


def test_plain_times_match_jax():
    from repro.apps import (dataframe as jdf, gemm as jgemm,
                            kvstore as jkv, socialnet as jsn)
    from repro_torch.apps import (dataframe as tdf, gemm as tgemm,
                                  kvstore as tkv, socialnet as tsn)
    assert tgemm.plain_gemm_us() == jgemm.plain_gemm_us()
    assert tdf.plain_dataframe_us() == jdf.plain_dataframe_us()
    assert tkv.plain_kvstore_us() == jkv.plain_kvstore_us()
    assert tsn.plain_socialnet_us() == jsn.plain_socialnet_us()
    assert tapps.plain_time_us(1e6, 100, 4) == japps.plain_time_us(1e6, 100, 4)
