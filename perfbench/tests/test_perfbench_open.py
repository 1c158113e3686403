"""A new architecture is new files: its reference module is found by name
(``reference/<name>.py``, with its ``loss`` and ``model_flops``), its
layers may form stacks of their own (``"stacks"``), and a model key the
port lacks is refused."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from perfbench import counts, spec, trace, training, weights  # noqa: E402
from perfbench.reference import optim  # noqa: E402
from perfbench.reference import train as reference  # noqa: E402
from perfbench_tiny import cells, tiny_cell  # noqa: E402

HERE = Path(spec.__file__).resolve().parent
SEED = 2_147_483_659

THREE = ["moe-train-b2t4096", "rwkv6-train-b2t4096", "dense-train-b4t4096"]
NEW = "copy-train-b4t4096"

_COPY_RUN = """
import json, sys
sys.path.insert(0, "perfbench/tests")
import torch
import perfbench
from perfbench import training
from perfbench.reference import train
from perfbench_tiny import tiny_cell
out = {"package": perfbench.__file__}
for name in ("%s", "dense-train-b4t4096"):
    cell = tiny_cell(name)
    out[name] = {"file": train.model(cell.config).__file__}
    res = training.run(cell, int(sys.argv[1]), 0.05, True,
                       torch.device("cpu"), 0.0, log=lambda *a, **k: None)
    out[name].update(correct=res["correct"], compared=res["compared"],
                     metrics=sorted(res["metrics"]))
print(json.dumps(out))
""" % NEW


def test_a_new_architecture_is_new_files_and_entries(tmp_path):
    """In a copy of the harness, a configuration with its own reference
    module (a copy of ``qwen3.py`` under a new name), its own cell and
    limits, added as files and ``BENCHMARK.json`` entries with no file
    edited, runs at the tiny size on the CPU: ``correct``, with the same
    readings as the cell it was copied from, and ``train_mfu`` from the
    new module."""
    root = tmp_path / "checkout"
    here = root / HERE.name
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "reference" / "qwen3.py",
                here / "reference" / "qwen3-copy.py")
    conf = spec.read_json(HERE / "configs" / "qwen3-0.6b.json")
    conf.update(name="qwen3-copy-0.6b", reference="qwen3-copy",
                stacks={"layers": conf["model"]["n_layers"]})
    conf["tests"]["tiny"]["stacks"] = {"layers": 2}
    (here / "configs" / "qwen3-copy-0.6b.json").write_text(json.dumps(conf))
    shutil.copy(HERE / "limits" / "dense-train-b4t4096.json",
                here / "limits" / f"{NEW}.json")
    bench = spec.read_json(HERE.parent / "BENCHMARK.json")
    entry = dict(next(c for c in bench["configs"]
                      if c["name"] == "qwen3-0.6b"),
                 name=conf["name"], file=f"{HERE.name}/configs/"
                 f"{conf['name']}.json")
    bench["configs"].append(entry)
    bench["workloads"].append({"name": NEW, "config": conf["name"],
                               "traffic": "train-b4t4096", "chips": 1,
                               "why": "a copy of the dense cell"})
    for m in bench["per_layer"]:
        if "dense-train-b4t4096" in m.get("workloads", []):
            m["workloads"].append(NEW)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "copy_run.py").write_text(_COPY_RUN)
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    proc = subprocess.run([sys.executable, "copy_run.py", str(SEED)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert Path(out["package"]).parent == here
    new, old = out[NEW], out["dense-train-b4t4096"]
    assert new["file"] == str(here / "reference" / "qwen3-copy.py")
    assert new["correct"] and old["correct"]
    assert new["compared"] == old["compared"]
    assert "train_mfu" in new["metrics"] and new["metrics"] == old["metrics"]
    for rel in ("reference/qwen3.py", "reference/train.py", "weights.py",
                "tests/perfbench_tiny.py", "configs/qwen3-0.6b.json"):
        assert (here / rel).read_bytes() == (HERE / rel).read_bytes()


@pytest.mark.parametrize("name", ["../qwen3", "no_such_model"])
def test_a_bad_or_missing_reference_names_its_path(name):
    with pytest.raises((ValueError, FileNotFoundError)) as err:
        reference.model({"reference": name})
    assert str(HERE / "reference" / f"{name}.py") in str(err.value)


@pytest.mark.parametrize("name", THREE)
def test_the_reference_counts_the_frozen_model_flops(name):
    conf = spec.load_cell(name).config
    mod = reference.model(conf)
    for B, T in ((2, 4096), (4, 4096), (1, 17)):
        assert mod.model_flops(conf["model"], B, T) == \
            counts.model_flops(conf["model"], B, T)


def _window(cell, ref: str, steps=3, window_s=2.0):
    return trace.Window(device_ops=[("k", 0.0, 1.0)], host_ops=[],
                        window_s=window_s, steps=steps, launches={},
                        model=cell.config["model"], traffic=cell.traffic,
                        reference=ref)


def _read(window):
    return trace.read_metrics(window, [{"name": "train_mfu", "unit": "%"}])


@pytest.mark.parametrize("name", THREE)
def test_train_mfu_reads_the_cells_reference(name):
    cell = spec.load_cell(name)
    tr = cell.traffic
    flops = counts.model_flops(cell.config["model"], tr["batch"],
                               tr["seq_len"])
    got = _read(_window(cell, cell.config["reference"]))["train_mfu"]
    assert got["value"] == 100.0 * flops * 3 / 2.0 / counts.PEAK_BF16_FLOPS


def test_train_mfu_of_a_reference_without_model_flops_raises():
    """``common.py`` is a module of ``reference/`` with no
    ``model_flops``: the reader fails, it does not take another count."""
    cell = spec.load_cell(THREE[0])
    with pytest.raises(AttributeError, match="model_flops"):
        _read(_window(cell, "common"))


@pytest.mark.parametrize("name", cells())
def test_a_traced_run_reports_train_mfu_from_its_reference(name):
    """A traced run at the tiny size on the CPU hands the window its
    configuration's reference; ``train_mfu`` is that module's count."""
    cell = tiny_cell(name)
    res = training.run(cell, SEED, 0.05, True, torch.device("cpu"), 0.0,
                       log=lambda *a, **k: None)
    assert res["correct"]
    tr = cell.traffic
    flops = reference.model(cell.config).model_flops(
        cell.config["model"], tr["batch"], tr["seq_len"])
    assert res["metrics"]["train_mfu"]["value"] == pytest.approx(
        100.0 * flops * res["attempted"] / res["device"]["window_s"]
        / counts.PEAK_BF16_FLOPS, rel=1e-12)


def _two_stacks():
    """The tiny dense configuration with a second stack of one layer,
    ``dense_layers``, holding a copy of the MLP's leaves."""
    conf = copy.deepcopy(tiny_cell("dense-train-b4t4096").config)
    conf["stacks"] = {"layers": 2, "dense_layers": 1}
    conf["leaves"].update({"dense_layers." + k[len("layers."):]: v
                           for k, v in conf["leaves"].items()
                           if k.startswith("layers.mlp.")})
    return conf


def test_a_second_stack_is_drawn_once_stacked_over_its_layers():
    conf = _two_stacks()
    tree = weights.program_params(conf, SEED, "cpu")
    flat = weights.flat_program(tree)
    ref = weights.reference_params(conf, SEED, "cpu")
    shapes = {k: tuple(s) for k, (_, s, _) in conf["leaves"].items()}
    for path, t in flat.items():
        n = {"layers": 2, "dense_layers": 1}.get(path.split(".")[0], 0)
        assert t.shape == ((n,) if n else ()) + shapes[path], path
        assert len(ref[path]) == max(n, 1)
        for j, r in enumerate(ref[path]):
            assert torch.equal(t[j] if n else t, r)
            assert torch.equal(r, weights.draw(conf, SEED, path, j, "cpu"))
    assert not torch.equal(flat["dense_layers.mlp.w_up"][0],
                           flat["layers.mlp.w_up"][0])
    slices = weights.layer_slices(conf, tree)
    assert [len(slices[k]) for k in ("layers.mlp.w_up",
                                     "dense_layers.mlp.w_up", "embed")] \
        == [2, 1, 1]
    assert slices["embed"][0] is flat["embed"]
    layer = weights.layer_params(ref, "dense_layers", 0)
    assert set(layer) == {"mlp.w_gate", "mlp.w_up", "mlp.w_down"}
    assert layer["mlp.w_up"] is ref["dense_layers.mlp.w_up"][0]
    del conf["stacks"]
    assert weights.program_params(conf, SEED, "cpu")["dense_layers"]["mlp"][
        "w_up"].shape == shapes["dense_layers.mlp.w_up"]


@pytest.mark.parametrize("count", [0, -1, 1.5, True])
def test_a_stack_needs_a_whole_number_of_layers(count):
    conf = _two_stacks()
    conf["stacks"]["dense_layers"] = count
    with pytest.raises(ValueError, match="dense_layers"):
        weights.leaves(conf)


@pytest.mark.parametrize("name", THREE)
def test_the_default_stack_draws_the_same_bits(name):
    conf = tiny_cell(name).config
    explicit = dict(conf, stacks={"layers": conf["model"]["n_layers"]})
    a = weights.flat_program(weights.program_params(conf, SEED, "cpu"))
    b = weights.flat_program(weights.program_params(explicit, SEED, "cpu"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ra = weights.reference_params(conf, SEED, "cpu")
    rb = weights.reference_params(explicit, SEED, "cpu")
    assert ra.keys() == rb.keys()
    assert all(len(ra[k]) == len(rb[k]) and all(
        torch.equal(x, y) for x, y in zip(ra[k], rb[k])) for k in ra)


@pytest.mark.parametrize("name", THREE)
def test_port_config_refuses_a_key_the_port_lacks(name):
    conf = copy.deepcopy(spec.load_cell(name).config)
    assert training.port_config(conf).n_layers == conf["model"]["n_layers"]
    conf["model"]["kv_lora_rank"] = 512
    with pytest.raises(ValueError, match="kv_lora_rank"):
        training.port_config(conf)


STACKED = {"layers.a": (3, 5), "layers.b": (3, 4, 6), "dense.a": (1, 5),
           "dense.b": (1, 4, 6), "dense.c": (1, 2, 4, 6), "x": (7,),
           "y": (5, 6)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_the_reference_optimizer_follows_a_stack_of_one(name, monkeypatch):
    """Three steps of the reference's optimizer on the layer slices of two
    stacks, one of a single layer, equal the port's on the stacked tree."""
    from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                             init_opt_state)
    opt = dict(name=name, lr=1e-2, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.01, clip_norm=1.0, moment_dtype="float32",
               warmup=2, decay_steps=50, min_lr_frac=0.1)
    conf = {"model": {"n_layers": 3}, "stacks": {"layers": 3, "dense": 1}}
    monkeypatch.setattr(optim, "BLOCK", 16)
    g = torch.Generator().manual_seed(4)

    def nest(flat):
        return weights._nest({k: v.clone() for k, v in flat.items()})

    tree = nest({k: torch.randn(s, generator=g) for k, s in STACKED.items()})
    ref = {k: [t.clone() for t in ts]
           for k, ts in weights.layer_slices(conf, tree).items()}
    cfg = OptConfig(**opt)
    state = init_opt_state(cfg, tree)
    rstate = optim.init_state(opt, ref)
    for step in range(1, 4):
        grads = nest({k: torch.randn(s, generator=g) * 3
                      for k, s in STACKED.items()})
        rgrads = weights.layer_slices(conf, grads)
        apply_updates(cfg, tree, grads, state)
        scale, _ = optim.clip_scale(opt, rgrads)
        optim.step(opt, ref, rgrads, rstate, step, scale)
        got = weights.layer_slices(conf, tree)
        for k, ts in ref.items():
            assert len(ts) == len(got[k])
            for r, p in zip(ts, got[k]):
                assert torch.allclose(r, p, rtol=1e-5, atol=1e-6), (step, k)
