"""What a traced window gives the per-layer metrics.

``Window`` holds the device operations of a ``torch.profiler`` trace
(name, start, duration in seconds), the host operations, the window's
wall time and what ran in it.  The device's busy time is the union of
the device operations' intervals, so operations that overlap count once.
Each per-layer metric is read by ``metrics/<name>.py``, whose
``read(window)`` returns a number, or None when the window holds nothing
it reads; a None leaves the metric out of the run's line.
"""

from __future__ import annotations

import bisect
import importlib.util
import re
from dataclasses import dataclass

from . import spec


@dataclass
class Window:
    device_ops: list            # [(name, start_s, dur_s)], sorted by start
    host_ops: list              # [(name, start_s, dur_s)], sorted by start
    window_s: float             # the traced window's wall time
    steps: int                  # steps that ran in it
    launches: dict              # the program's kernel calls in it, by name
    model: dict                 # the configuration's ``model``
    traffic: dict               # the traffic mix
    reference: str              # the configuration's reference module


def from_profiler(prof, **kw) -> Window:
    """A ``Window`` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            dev.append(item)
        elif not item[0].startswith("cu"):     # not a CUDA API call
            host.append(item)
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return Window(device_ops=dev, host_ops=host, **kw)


def union(intervals) -> list:
    """The union of [(start, end)] as disjoint sorted intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(ops) -> float:
    """Seconds in which at least one of ``ops`` ran."""
    return sum(e - s for s, e in union((s, s + d) for _, s, d in ops))


def matching(ops, pattern: str) -> list:
    """The ops whose name matches the regular expression ``pattern``."""
    rx = re.compile(pattern)
    return [op for op in ops if rx.search(op[0])]


def device_s(ops) -> float:
    """Summed device time of ``ops`` (each op's own duration)."""
    return sum(d for _, _, d in ops)


def top_ops(ops, n: int = 10) -> list:
    """[[name, seconds]] of the n names with the most device time."""
    by: dict = {}
    for name, _, d in ops:
        by[name] = by.get(name, 0.0) + d
    return [[k[:120], v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(window: Window, n: int = 10) -> list:
    """[[host op, seconds]]: the device's idle gaps between its busy
    intervals, each named by the innermost host operation running when
    it began, summed by name, the n largest."""
    busy = union((s, s + d) for _, s, d in window.device_ops)
    host = window.host_ops
    starts = [s for _, s, _ in host]
    by: dict = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        name = "(none)"
        i = bisect.bisect_right(starts, e0) - 1
        for j in range(i, max(i - 400, -1), -1):
            hn, hs, hd = host[j]
            if hs <= e0 < hs + hd:
                name = hn
                break
        by[name] = by.get(name, 0.0) + (s1 - e0)
    return [[k[:120], v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read_metrics(window: Window, metrics: list) -> dict:
    """{name: {"value", "unit"}} of each per-layer metric entry whose
    reader finds something to read."""
    out = {}
    for m in metrics:
        path = spec.metric_file(m["name"])
        mod_spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{m['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
