"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  The build happens at first use, into
``build/repro_torch_kernels/`` at the root of the checkout, under a name
keyed by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is not.  ``build_all`` starts one ``nvcc`` per source
at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and this
machine may have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    out, tmp, proc = job
    text, _ = proc.communicate()
    out.with_suffix(".log").write_text(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
    os.replace(tmp, out)                      # atomic: readers never see half


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build every kernel (or ``names``) in parallel; returns the library
    paths.  Already-built libraries are reused."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start(n) for n in names}
    try:
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    finally:
        for job in jobs.values():             # never leave nvcc running
            if job is not None and job[2].poll() is None:
                job[2].kill()
                job[2].wait()
    return {n: _target(n) for n in names}


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said (registers, shared memory, spills)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
