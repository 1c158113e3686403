"""Guards of the benchmark: what it may import, that every file is found
by name, that a new cell is a new file, and that a run without a card
gives no result."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import spec, weights
from perfbench.run import forbidden_modules
from perfbench_tiny import cells, leaf_shapes

HERE = Path(spec.__file__).resolve().parent
ROOT = HERE.parent


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (the name before
    the first dot, whole), relative imports left out."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in _imports(path)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert forbidden_modules(["repro_torch", "repro_torch.models",
                              "torch", "jaxtyping"]) == []
    assert forbidden_modules(["repro_torch", "repro.core", "jax.numpy",
                              "flax"]) == ["flax", "jax", "repro"]
    monkeypatch.setitem(sys.modules, "repro.fake_sub", object())
    assert "repro" in forbidden_modules()


def test_every_name_and_unit_and_file_is_found():
    bench = spec.load_benchmark()
    assert len(bench["configs"]) == len({c["name"] for c in bench["configs"]})
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] == "train"
        assert cell.limits and set(cell.limits) <= {
            "loss_gap", "grad_gap", "change_gap", "rows_gap", "leaves"}
        for number, names in cell.limits.get("leaves", {}).items():
            assert number in cell.limits
            assert names and set(names) <= set(cell.config["leaves"])
        assert {m["name"] for m in cell.end_to_end} == {
            "train_tokens_per_s", "peak_mem_gib", "setup_s"}
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert spec.metric_file(m["name"]).is_file()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(bench["paths"][0] + "/")
        conf = spec.read_json(ROOT / c["file"])
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        for key in conf["reduced"]:
            assert key in conf["published"] and conf[key] != conf["published"][key]


# published keys that every configuration maps to a value of ``model``
COMMON = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "vocab_size": "vocab", "tie_word_embeddings": "tie_embeddings",
          "torch_dtype": "dtype"}


@pytest.mark.parametrize("name", [c["name"] for c in
                                  spec.load_benchmark()["configs"]])
def test_the_run_takes_the_published_values(name):
    """Each value of ``model`` that the published configuration gives
    (``model_keys``: published key -> ``model`` key) is the published
    one, or the run's value of a departure the file states (what the port
    fixes otherwise)."""
    conf = spec.read_json(ROOT / "perfbench" / "configs" / f"{name}.json")
    model, departures = conf["model"], conf["departures"]
    table = conf["model_keys"]
    assert table.items() >= COMMON.items()
    for key, mkey in table.items():
        want = departures[key]["run"] if key in departures else conf[key]
        assert model[mkey] == want, (key, mkey)
    for key, dep in departures.items():
        assert dep["published"] != dep["run"] and dep["why"]
        assert key not in conf["reduced"]


@pytest.mark.parametrize("name", cells())
def test_config_leaves_are_the_ports_tree(name):
    """The leaves a configuration file lists, which the benchmark draws,
    are the port's parameter tree for that configuration (on the meta
    device: shapes and dtypes only)."""
    import torch
    from repro_torch.models import init_params
    from perfbench import training
    conf = spec.load_cell(name).config
    cfg = training.port_config(conf)
    meta = weights.flat_program(init_params(cfg, device="meta"))
    drawn = {p: (dt, (n,) + shape if n else shape)
             for p, dt, shape, _, n in weights.leaves(conf)}
    assert drawn == {p: (t.dtype, tuple(t.shape)) for p, t in meta.items()}
    assert {k: list(v) for k, v in leaf_shapes(conf).items()} == {
        k: list(v[1]) for k, v in conf["leaves"].items()}
    assert cfg.dtype == conf["model"]["dtype"] == "bfloat16"
    assert torch.empty(0, dtype=getattr(torch, cfg.dtype)).dtype == torch.bfloat16


def test_a_new_cell_is_new_files_only(tmp_path):
    """A workload added to ``BENCHMARK.json`` with its own traffic and
    limits files is found by name, with no code edited."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dense-train-b1t512",
                               "config": "qwen3-0.6b",
                               "traffic": "train-b1t512", "chips": 1,
                               "why": "a throwaway cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / HERE.name / "traffic" / "train-b1t512.json").write_text(
        json.dumps({"kind": "train", "stream": "markov", "batch": 1,
                    "seq_len": 512, "successors": 8, "setup_steps": 3}))
    (root / HERE.name / "limits" / "dense-train-b1t512.json").write_text(
        json.dumps({"loss_gap": 1, "grad_gap": 1, "change_gap": 1}))
    cell = spec.load_cell("dense-train-b1t512", root=root)
    assert cell.traffic["seq_len"] == 512
    assert cell.config["name"] == "qwen3-0.6b"
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", root=root)


def test_bad_names_are_refused():
    for bad in ("a b", "a,b", "a/b", "", "-x", "x" * 65, "µs"):
        with pytest.raises(ValueError):
            spec.check_name(bad, "test")
    assert spec.check_name("k2_fwd_roofline", "test")


def test_a_run_without_a_card_gives_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", cells()[0],
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr
