"""The port's examples (``examples/torch_*.py``) run on the CPU with small
arguments, each in its own process, and print what the JAX package's
examples print for the same simulated runs."""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.apps as japps                                   # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, str(REPO / "examples" / name),
                        "--device", "cpu", *args], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout.splitlines()


def _reference_output(name, fn="main"):
    """Run a function of the JAX package's example ``name`` in-process."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name[:-3]}", REPO / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        getattr(mod, fn)()
    return out.getvalue().splitlines()


def test_quickstart_matches_jax():
    mine = _example("torch_quickstart.py")
    ref = _reference_output("quickstart.py")
    assert mine[:3] == ref[:3]           # Listing 2 on the simulated cluster
    assert mine[4].startswith("weight cache on cpu: 1 zero-comm hits, "
                              "2 refreshes")


def test_dsm_apps_table_matches_jax():
    from repro.apps.gemm import plain_gemm_us
    from repro.apps.kvstore import plain_kvstore_us
    mine = _example("torch_dsm_apps.py", "gemm", "kvstore",
                    "--servers", "1", "2")
    want = []
    for app, plain in (("gemm", plain_gemm_us()),
                       ("kvstore", plain_kvstore_us())):
        want += ["", f"== {app} (normalized to the original single-node "
                     "program)", "   backend  1n      2n      "]
        for backend in ("drust", "gam", "grappa"):
            row = [f"{plain / japps.APPS[app](n, backend=backend).makespan_us:5.2f}x "
                   for n in (1, 2)]
            want.append(f"   {backend:8s} " + " ".join(row))
    assert mine == want


def test_dsm_apps_rejects_an_unknown_app():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, str(REPO / "examples" /
                                            "torch_dsm_apps.py"), "bogus",
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=120)
    assert p.returncode == 2 and "unknown app" in p.stderr


def test_serve_kv_matches_jax_dsm_plane():
    mine = _example("torch_serve_kv.py", "--requests", "4")
    assert mine[0].startswith("decode ticks on cpu: ")
    assert "ONE page" in mine[1]
    assert mine[-2:] == _reference_output("serve_kv.py", "dsm_plane")


def test_train_lm_runs_and_checkpoints(tmp_path):
    mine = _example("torch_train_lm.py", "--steps", "50", "--d-model", "64",
                    "--layers", "2", "--batch", "2", "--seq", "32",
                    "--ckpt-dir", str(tmp_path))
    assert mine[0] == "model: 2L d=64 -> 0.8M params on cpu"
    assert mine[-1].endswith("checkpoints at colors [50]")
    assert (tmp_path / "ckpt_00000050.npz").exists()
