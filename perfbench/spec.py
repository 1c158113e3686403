"""``BENCHMARK.json`` and the files its names lead to.

A cell (``workloads`` entry) names a configuration and a traffic mix; each
is found by name: ``configs/<config>.json`` (the path ``configs`` gives
for it), ``traffic/<traffic>.json`` and ``limits/<cell>.json``.  A
per-layer metric is read by ``metrics/<name>.py``.  Names and units are
checked against the benchmark's rules before anything runs.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One cell: its entry, configuration, traffic, limits and the
    metrics it reports (end-to-end and per-layer entries of
    ``BENCHMARK.json``)."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    bench = read_json(root / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            check_name(entry["name"], key)
    for entry in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(entry["unit"]):
            raise ValueError(f"unit {entry['unit']!r} of {entry['name']}")
        if entry["better"] not in ("lower", "higher"):
            raise ValueError(f"better of {entry['name']}")
    return bench


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it names."""
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[check_name(w["config"], "config")]
    config = read_json(root / conf_entry["file"])
    here = root / HERE.name
    traffic = read_json(here / "traffic"
                        / f"{check_name(w['traffic'], 'traffic')}.json")
    limits = read_json(here / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{check_name(name, 'metric')}.py"
