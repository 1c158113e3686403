"""Cells at the sizes the tests run them: each benchmark cell's
configuration in float32, the same leaves and the same recipe, at the
model values its file gives under ``tests`` (``tiny`` on a batch of 2 x
64 tokens for the CPU, ``small`` over ``tiny`` on 2 x 256 for the card).
A file that states ``stacks`` gives ``tiny`` its own ``stacks`` too."""

from __future__ import annotations

import copy

from perfbench import spec
from perfbench.reference import train as reference


def leaf_shapes(config: dict) -> dict:
    """{path: one layer's shape} of the port's parameter tree for the
    configuration's ``model``, as its reference module states it."""
    return reference.model(config).leaf_shapes(config["model"])


def _resize(conf: dict, values: dict) -> None:
    """``conf`` at the model values ``values`` (its ``stacks`` with them),
    every leaf in float32."""
    values = dict(values)
    if "stacks" in values:
        conf["stacks"] = values.pop("stacks")
    conf["model"].update(values, dtype="float32")
    shapes = leaf_shapes(conf)
    conf["leaves"] = {k: ["float32", shapes[k], init]
                      for k, (_, _, init) in conf["leaves"].items()}


def tiny_cell(name: str, limits: dict | None = None) -> spec.Cell:
    """The cell ``name`` cut to the tiny size, in float32."""
    cell = spec.load_cell(name)
    conf = copy.deepcopy(cell.config)
    if "stacks" in conf and "stacks" not in conf["tests"]["tiny"]:
        raise KeyError(f"{conf['name']} states stacks; its tests.tiny "
                       f"does not")
    _resize(conf, conf["tests"]["tiny"])
    return spec.Cell(name=cell.name, chips=1, config=conf,
                     traffic=dict(cell.traffic, batch=2, seq_len=64),
                     limits=limits or cell.limits,
                     end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def small_cell(name: str) -> spec.Cell:
    """The cell ``name`` at the card tests' small size, in float32."""
    cell = tiny_cell(name)
    _resize(cell.config, cell.config["tests"]["small"])
    cell.traffic.update(batch=2, seq_len=256)
    return cell


def cells() -> list:
    return [w["name"] for w in spec.load_benchmark()["workloads"]]
