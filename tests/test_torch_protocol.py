"""The paper's protocol evaluation in the port: ``repro_torch.benchmarks.
run.quick(device="cpu")`` against the committed ``BENCH_protocol.json``,
every field of all eleven sections with ``==`` except the wall-clock ones
(the two ``clone_*_fastpath_speedup`` rows of ``micro``, and
``wall_ms_off``, ``wall_ms_on`` and ``overhead_x`` of
``sanitize_overhead``), and through the regression gate
(``benchmarks/check_regression.py``) at a tolerance of zero; the live
elastic rescale (``repro_torch.launch.elastic``) against the reference's
(``NetStats`` and the fail-over report, exactly); and whether the serving
sweep's reads ever return other than a box's current value, in both
packages.  Everything here runs on virtual clocks."""

import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore                                   # noqa: E402
from benchmarks import check_regression                      # noqa: E402
from benchmarks import protocol_micro as jpm                 # noqa: E402

from repro_torch.benchmarks import protocol_micro as tpm     # noqa: E402
from repro_torch.benchmarks import run as trun               # noqa: E402
from repro_torch.launch import elastic                       # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE_PATH = ROOT / "BENCH_protocol.json"
BASELINE = json.loads(BASELINE_PATH.read_text())
SECTIONS = sorted(BASELINE)
WALL_ROWS = ("clone_dict_fastpath_speedup", "clone_list_fastpath_speedup")
WALL_FIELDS = ("wall_ms_off", "wall_ms_on", "overhead_x")


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """One ``quick(device="cpu")`` from an empty working directory: the
    summary, what the directory holds after it, and the committed file's
    digest before and after."""
    cwd = tmp_path_factory.mktemp("quick")
    before = _digest(BASELINE_PATH)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        summary = trun.quick(device="cpu")
    finally:
        os.chdir(old)
    return summary, sorted(os.listdir(cwd)), before, _digest(BASELINE_PATH)


def _fields(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_fields(v, (*path, k)))
        return out
    return {path: tree}


def _wall_clock(section, path):
    if section == "micro":
        return path[0] in WALL_ROWS
    return section == "sanitize_overhead" and path[-1] in WALL_FIELDS


def test_baseline_has_the_eleven_sections():
    assert SECTIONS == ["apps", "coalesce_sweep", "lock_sweep", "micro",
                        "placement_sweep", "prefetch", "qp_sweep",
                        "recovery", "recovery_slo", "sanitize_overhead",
                        "serve"]
    assert len(BASELINE["micro"]) == 95


@pytest.mark.parametrize("section", SECTIONS)
def test_quick_section_equals_the_committed_file(quick_run, section):
    summary = quick_run[0]
    assert set(summary) == set(SECTIONS)
    mine, want = _fields(summary[section]), _fields(BASELINE[section])
    assert set(mine) == set(want)
    held = [k for k in want if not _wall_clock(section, k)]
    assert len(want) - len(held) == {"micro": 4,
                                     "sanitize_overhead": 6}.get(section, 0)
    for k in held:
        assert mine[k] == want[k], (section, k)
        assert type(mine[k]) is type(want[k]), (section, k)


def test_regression_gate_at_zero_tolerance(quick_run):
    assert check_regression.compare(BASELINE, quick_run[0], 0.0) == []


def test_sanitizer_trace_and_span_held_exactly(quick_run):
    got = quick_run[0]["sanitize_overhead"]
    for app in ("kvstore", "socialnet"):
        assert got[app]["trace_events"] == \
            BASELINE["sanitize_overhead"][app]["trace_events"]
        assert got[app]["span_identical"] is True


def test_the_port_diff_helper_agrees(quick_run):
    """``run.diff_sections``, which the card's smoke run reports with,
    finds nothing here and counts every field held above."""
    diff = trun.diff_sections(quick_run[0], BASELINE)
    assert sorted(diff) == SECTIONS
    for section, (n, bad) in diff.items():
        assert bad == [], section
        assert n == sum(1 for k in _fields(BASELINE[section])
                        if not _wall_clock(section, k))
    broken = json.loads(json.dumps(quick_run[0]))
    broken["serve"]["poisson_4srv"]["round_trips"] += 1
    assert trun.diff_sections(broken, BASELINE)["serve"][1] == [
        "serve/poisson_4srv/round_trips"]


def test_quick_without_a_path_writes_nothing(quick_run):
    _, listing, before, after = quick_run
    assert listing == []
    assert before == after


def test_quick_refuses_the_committed_file_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="baseline"):
        trun.quick(out_path=str(BASELINE_PATH), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.quick()


def test_cli_prints_the_reference_csv_and_writes_only_to_out(
        quick_run, tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert trun.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[-1] == "quick_recovery_slo_ok,0.00,True"
    assert len(lines) == 1 + 95 + 2 + 6 + 3 + 2 + 8 + 9 + 4 + 24 + 1
    assert "quick_serve_poisson_8srv_p99,1212.52," in "\n".join(lines)
    written = json.loads(out.read_text())
    assert trun.diff_sections(written, BASELINE) == \
        trun.diff_sections(quick_run[0], BASELINE)
    assert sorted(os.listdir(tmp_path)) == ["bench.json"]


# --------------------------------------------------------------------------
#  The live elastic rescale
# --------------------------------------------------------------------------
def _reference_rescale(n_servers):
    """``src/repro/launch/elastic.py::run_protocol`` over ``repro.core``
    (that module sets ``XLA_FLAGS`` at import, so it is not imported
    here).  Returns (ok, cluster, report)."""
    cl = jcore.Cluster(n_servers, "drust", replicate=True, qps_per_thread=2,
                       ooo=True, coalesce="auto")
    ths = [cl.main_thread(s) for s in range(n_servers)]
    victim = n_servers - 1
    boxes = []
    for s, th in enumerate(ths):
        for i in range(8):
            b = cl.backend.alloc(th, 256, i + 100 * s, server=s)
            cl.backend.write(th, b, i + 1000 * s)
            boxes.append((s, i, b))
    cl.replicator.flush_epoch()
    dirty = cl.backend.alloc(ths[victim], 256, "dirty", server=victim)
    cl.backend.write(ths[victim], dirty, "unflushed")
    cl.recovery.crash(victim)
    declared = []
    while not declared:
        declared = cl.controller.probe_failures(ths[0])
    report = cl.recovery.reports[-1]
    ok = declared == [victim] and report.server == victim
    ok &= report.rehomed_boxes >= 8 and report.lost_writes >= 1
    for s, i, b in boxes:
        ok &= cl.backend.read(ths[0], b) == i + 1000 * s
    try:
        cl.backend.read(ths[0], dirty)
        ok = False
    except jcore.ServerLostError:
        pass
    s_new = cl.add_server()
    nb = cl.backend.alloc(cl.main_thread(s_new), 256, "fresh", server=s_new)
    ok &= cl.backend.read(ths[0], nb) == "fresh"
    ok &= s_new == n_servers and len(cl.sim.alive_servers()) == n_servers
    return bool(ok), cl, report


@pytest.mark.parametrize("n_servers", [4, 8])
def test_elastic_rescale_matches_the_reference(n_servers):
    ok, cl, rep = elastic.rescale(n_servers)
    jok, jcl, jrep = _reference_rescale(n_servers)
    assert ok and jok
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert (rep.rehomed_boxes, rep.orphaned_cids, rep.lost_writes,
            rep.makespan_us) == (jrep.rehomed_boxes, jrep.orphaned_cids,
                                 jrep.lost_writes, jrep.makespan_us)
    assert dataclasses.asdict(cl.sim.net) == dataclasses.asdict(jcl.sim.net)
    assert cl.makespan_us() == jcl.makespan_us()


def test_elastic_cli_prints_the_reference_line(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.elastic", "--protocol"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    assert elastic.main(["--protocol"]) == 0
    mine = capsys.readouterr().out
    assert mine == ref.stdout
    assert mine.startswith("elastic protocol rescale 4->3->4: OK")


def test_elastic_checkpoint_reshard_is_not_ported(capfd):
    """The checkpoint reshard, which earlier slices left out, runs: on two
    gloo ranks of its own, from a 1x2 mesh onto 2x1, with the reference's
    line; meshes of different sizes are refused.  (The reference's 2x4
    reshards: ``tests/test_torch_dist.py``.)"""
    assert elastic.main(["--from-mesh", "1x2", "--to-mesh", "2x1"]) == 0
    assert capfd.readouterr().out == ("elastic reshard (1, 2) -> (2, 1): "
                                       "OK (epoch color 3)\n")
    with pytest.raises(ValueError, match="differ in size"):
        elastic.main(["--from-mesh", "2x4", "--to-mesh", "3x2"])


# --------------------------------------------------------------------------
#  Fault 4 on the serving path: does a served read ever come back stale?
# --------------------------------------------------------------------------
def _watched(cluster_cls, log):
    """A ``Cluster`` factory whose backend records each box's current value
    (at alloc and at every write-guard store) and checks every ``read`` and
    ``read_many`` against it; stale reads go to ``log["stale"]``."""
    def make(*args, **kw):
        cl = cluster_cls(*args, **kw)
        be = cl.backend
        current = {}                        # id(box) -> (box, value)
        alloc, write_set = be.alloc, be._write_set
        read, read_many = be.read, be.read_many

        def check(box, value):
            log["reads"] += 1
            held = current.get(id(box))
            if held is not None and value != held[1]:
                log["stale"].append((log["reads"], value, held[1]))

        def w_alloc(th, size, data=None, *a, **k):
            box = alloc(th, size, data, *a, **k)
            current[id(box)] = (box, data)
            return box

        def w_write_set(th, box, token, data):
            write_set(th, box, token, data)
            current[id(box)] = (box, data)
            log["writes"] += 1

        def w_read(th, box):
            value = read(th, box)
            check(box, value)
            return value

        def w_read_many(th, boxes):
            values = read_many(th, boxes)
            for box, value in zip(boxes, values):
                check(box, value)
            return values

        be.alloc, be._write_set = w_alloc, w_write_set
        be.read, be.read_many = w_read, w_read_many
        return cl
    return make


def _served_reads(pm, monkeypatch, n, trace, **kw):
    log = {"reads": 0, "writes": 0, "stale": []}
    with monkeypatch.context() as m:
        m.setattr(pm, "Cluster", _watched(pm.Cluster, log))
        pm._serve_run(n, trace, **kw)
    return log


@pytest.mark.parametrize("name,n,trace", tpm.SERVE_POINTS)
def test_served_reads_are_never_stale(name, n, trace, monkeypatch):
    """The engine chains KV pages with ``tie_to`` (the shape of fault 4's
    schedule).  At each point of the serving sweep, in both packages,
    every page read returns its box's current value."""
    mine = _served_reads(tpm, monkeypatch, n, trace, device="cpu")
    ref = _served_reads(jpm, monkeypatch, n, trace)
    assert mine["writes"] > 0 and mine["reads"] > 0
    assert mine == ref
    assert mine["stale"] == []


def test_chip_smoke_protocol_phase_on_the_cpu(capsys):
    """``chip_smoke.py``'s protocol phase, run here with the CPU for the
    card: it passes, and the report it holds the port to is the
    reference's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, _, jrep = _reference_rescale(4)
    assert smoke.ELASTIC_REPORT == {k: getattr(jrep, k)
                                    for k in smoke.ELASTIC_REPORT}
    smoke.protocol_phase(torch.device("cpu"))
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["section"] for r in rows if r["phase"] == "protocol"] \
        == SECTIONS
    assert all(r["mismatches"] == 0 for r in rows if r["phase"] == "protocol")
    assert smoke.ELASTIC_LINE in lines
