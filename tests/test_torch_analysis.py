"""The port's ownership analysis tools, held to the JAX package's: the AST
borrow lint gives the reference's violations on the lint corpus and on
``src/repro/apps``, the port's own app surface is clean, the CLI's three
formats and exit codes behave as the reference's, and the race certifier
gives the reference's ``Certificate`` on the sanitizer traces of the same
app runs and raises ``RaceError`` on the same bad traces."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import linter as jlinter                  # noqa: E402
from repro.analysis import races as jraces                    # noqa: E402
from repro.analysis import sanitizer as jsanitizer            # noqa: E402
import repro.apps as japps                                    # noqa: E402

from repro_torch.analysis import (LintViolation, RaceError,   # noqa: E402
                                  certify, lint_file, lint_paths)
from repro_torch.analysis.lint import default_targets         # noqa: E402
from repro_torch.analysis.races import Certificate            # noqa: E402
from repro_torch.analysis.sanitizer import Event, Sanitizer   # noqa: E402
from repro_torch.core import Cluster                          # noqa: E402
import repro_torch.apps as tapps                              # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "data" / "lint_corpus"
FIXTURES = sorted(CORPUS.glob("*.py"))


def _rows(violations):
    return [(v.code, v.line, v.col, v.message) for v in violations]


# --------------------------------------------------------------------------
#  The linter
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_corpus_fixture_matches_jax(fixture):
    mine = _rows(lint_file(fixture))
    assert mine, f"{fixture.name}: no violation found"
    assert mine == _rows(jlinter.lint_file(fixture))


@pytest.mark.parametrize("target", ["src/repro/apps", "tests/data/lint_corpus",
                                    "src/repro_torch/apps"])
def test_lint_paths_matches_jax(target):
    mine = lint_paths([REPO / target])
    assert [dataclasses.asdict(v) for v in mine] == \
        [dataclasses.asdict(v) for v in jlinter.lint_paths([REPO / target])]


def test_rules_match_jax():
    from repro_torch.analysis.linter import RULES
    assert RULES == jlinter.RULES


def test_port_default_targets_are_clean():
    targets = default_targets()
    names = {t.name for t in targets}
    assert {"apps", "serve", "sync.py"} <= names
    assert {"torch_dsm_apps.py", "torch_quickstart.py", "torch_serve_kv.py",
            "torch_train_lm.py"} <= names
    assert all("repro_torch" in t.parts or t.parent.name == "examples"
               for t in targets)
    vs = lint_paths(targets)
    assert vs == [], "\n".join(v.format() for v in vs)


def test_port_examples_are_clean_under_the_jax_linter():
    files = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(files) == 4
    assert jlinter.lint_paths(files) == []


@pytest.mark.parametrize("src,codes", [
    ("""
     def probe(index, col, th, choreograph, cl):
         if choreograph:
             srcs = cl.backend.read_many(th, [index[0]])[-1]
         else:
             with index[0].read(th) as v:
                 srcs = v
         acc = 0.0
         for s_idx in srcs:
             with col[s_idx].read(th) as chunk:
                 acc += float(chunk.sum())
         return acc
     """, ["E102"]),
    ("""
     def probe(index, th):
         with index[0].read(th) as v:
             srcs = v.clone()
         return srcs
     """, []),
    ("""
     def f(cl, th, h):
         cl.backend.borrow(th, h)  # lint: allow(raw-verb)
         cl.backend.deref(th, h)
     """, ["E101"]),
], ids=["branch-tail-escape", "tensor-copy-in-guard", "allow-one-rule"])
def test_snippets_match_jax(tmp_path, src, codes):
    f = tmp_path / "case.py"
    f.write_text(textwrap.dedent(src))
    mine = lint_file(f)
    assert [v.code for v in mine] == codes
    assert _rows(mine) == _rows(jlinter.lint_file(f))
    assert all(isinstance(v, LintViolation) for v in mine)


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)


def test_cli_clean_tree_exits_zero():
    p = _cli("repro_torch.analysis.lint")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "repro_torch.analysis.lint: 0 violations" in p.stderr


@pytest.mark.parametrize("fmt,fixture", [
    ("text", "e103_guard_live_conflict.py"),
    ("github", "e101_raw_verb.py"),
    ("json", "e105_spawn_capture.py")])
def test_cli_formats_match_jax(fmt, fixture):
    path = str(CORPUS / fixture)
    mine = _cli("repro_torch.analysis.lint", f"--format={fmt}", path)
    ref = _cli("repro.analysis.lint", f"--format={fmt}", path)
    assert mine.returncode == ref.returncode == 1
    assert mine.stdout == ref.stdout
    if fmt == "json":
        assert {r["code"] for r in json.loads(mine.stdout)} == {"E105"}
    if fmt == "github":
        assert mine.stdout.startswith("::error ")


# --------------------------------------------------------------------------
#  The race certifier
# --------------------------------------------------------------------------
APPS = {
    "socialnet": dict(n_requests=40),
    "dataframe": dict(n_ops=2),
    "kvstore": dict(n_keys=128, n_ops=200, txn_frac=0.3),
}


def _trace(pkg, sanitizer, app, backend, **plane):
    kw = dict(APPS[app], **plane)
    if pkg is tapps and app == "dataframe":
        kw["device"] = "cpu"
    pkg.APPS[app](4, backend=backend, **kw)
    return list(sanitizer.Sanitizer.last.trace)


def _cert_fields(cert):
    return (cert.events, cert.boxes, cert.reads, cert.writes, cert.edges,
            cert.threads)


@pytest.mark.parametrize("plane", ["inorder", "ooo"])
@pytest.mark.parametrize("backend", ("drust", "gam", "grappa"))
@pytest.mark.parametrize("app", sorted(APPS))
def test_app_traces_certify_as_jax(app, backend, plane, monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    kw = dict(qps_per_thread=4, ooo=True) if plane == "ooo" else {}
    from repro_torch.analysis import sanitizer as tsanitizer
    cert = certify(_trace(tapps, tsanitizer, app, backend, **kw))
    ref = jraces.certify(_trace(japps, jsanitizer, app, backend, **kw))
    assert isinstance(cert, Certificate)
    assert _cert_fields(cert) == _cert_fields(ref)
    if backend == "drust":
        assert cert.reads > 0 and cert.edges > 0


def _stale_read_cluster(inject):
    cl = Cluster(2, backend="drust", sanitize=True)
    t0 = cl.main_thread(0)
    t1 = cl.main_thread(1)
    h = cl.backend.alloc(t0, 4096, {"n": 0})
    with h.write(t0) as w:
        w.set({"n": 1})                       # epoch bump
    cl.backend.transfer(t0, h, 1)             # the ownership edge
    if inject:
        cl.sanitizer.inject_stale_reads = 1   # next read observes epoch-1
    with h.read(t1):
        pass
    cl.makespan_us()
    return cl


def test_live_injection_trips():
    with pytest.raises(RaceError, match="stale replica"):
        certify(_stale_read_cluster(True).sanitizer.trace)


def test_without_injection_the_same_run_certifies():
    assert certify(_stale_read_cluster(False).sanitizer.trace).edges >= 2


def test_trace_surgery_stale_epoch_trips(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    tapps.run_dataframe(4, "drust", n_ops=2, device="cpu")
    tr = list(Sanitizer.last.trace)
    idx = next(i for i, e in enumerate(tr)
               if e.kind == "read_open" and e.epoch > 0)
    tr[idx] = dataclasses.replace(tr[idx], epoch=tr[idx].epoch - 1)
    with pytest.raises(RaceError, match="stale replica") as err:
        certify(tr)
    assert any(e.seq == tr[idx].seq for e in err.value.events)


def _ev(event, seq, kind, tid, key=1, epoch=0, src=None):
    return event(seq, kind, tid, key, epoch, float(seq), src, "")


SYNTHETIC = {
    "read_during_open_write": ([(0, "write_open", 1), (1, "read_open", 2)],
                               "conflicting open guards"),
    "write_during_open_read": ([(0, "read_open", 1), (1, "write_open", 2)],
                               "conflicting open guards"),
    "phantom_epoch": ([(0, "read_open", 1, 1, 3)], "phantom epoch"),
    "ordered_handoff": ([(0, "write_open", 1), (1, "write_close", 1, 1, 1),
                         (2, "read_open", 2, 1, 1), (3, "read_close", 2)],
                        None),
    "failover_settles_dead_guards": ([(0, "read_open", 1),
                                      (1, "failover", -1),
                                      (2, "write_open", 2),
                                      (3, "write_close", 2, 1, 1)], None),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_traces_match_jax(name):
    rows, message = SYNTHETIC[name]
    mine = [_ev(Event, *r) for r in rows]
    ref = [_ev(jsanitizer.Event, *r) for r in rows]
    if message is None:
        assert _cert_fields(certify(mine)) == \
            _cert_fields(jraces.certify(ref))
        return
    with pytest.raises(RaceError, match=message) as err:
        certify(mine)
    with pytest.raises(jraces.RaceError) as jerr:
        jraces.certify(ref)
    assert str(err.value) == str(jerr.value)
