"""The port stands alone: importing ``repro_torch`` and every module in it
(``repro_torch.benchmarks``, ``repro_torch.launch.elastic`` and the
multi-device modules ``dist.{sharding,pipeline,collectives}``,
``launch.mesh`` and ``models.decode_sharded`` among them)
loads neither ``jax``, anything of the JAX package ``repro``, nor the
reference's ``benchmarks`` folder, and no source file of the port,
``chip_smoke.py`` or the port's examples (``examples/torch_*.py``) imports
them."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "repro" \
        or name.startswith("repro.") or name.startswith("jaxlib") \
        or name == "benchmarks" or name.startswith("benchmarks.")


def test_importing_every_port_module_loads_no_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 30
    assert {"repro_torch.benchmarks", "repro_torch.benchmarks.protocol_micro",
            "repro_torch.benchmarks.run",
            "repro_torch.launch.elastic", "repro_torch.dist.sharding",
            "repro_torch.dist.pipeline", "repro_torch.dist.collectives",
            "repro_torch.launch.mesh",
            "repro_torch.models.decode_sharded"} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.engine" in loaded
    assert "repro_torch.benchmarks.run" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): name for f in files
           for name in _imports(f) if _forbidden(name)}
    assert bad == {}


def test_port_examples_import_no_jax_or_repro():
    files = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [f.name for f in files] == [
        "torch_dsm_apps.py", "torch_quickstart.py", "torch_serve_kv.py",
        "torch_train_lm.py"]
    bad = {f.name: name for f in files for name in _imports(f)
           if _forbidden(name)}
    assert bad == {}
    assert all(any(n.startswith("repro_torch") for n in _imports(f))
               for f in files)
