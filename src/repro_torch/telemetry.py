"""Spans and counters inside the train step and the serve tick.

Recording is on exactly while ``torch.profiler`` runs
(``torch.autograd._profiler_enabled()``): ``launch/train.py --profile N``,
``launch/serve.py --profile N`` and the benchmark's traced runs turn it on.
Off, ``span`` returns one shared no-op object after that one check and
``count`` returns at once: nothing is allocated, recorded or launched.

On, a span records its name, its parent (a thread-local stack), its host
start and end on the profiler's clock (``time.time_ns``), and a
``_RecordFunctionFast`` range of the same name.  That range is a plain
``cpu_op`` of the trace, so it names the device's idle gaps it covers;
``record_function`` would open a user annotation instead, which the trace
copies onto the device's timeline as if it were a kernel.  Once CUDA is in
use a span also records a pair of timing events on the current stream
(no synchronise); its device ms are worked out from them when read, after
the caller's synchronise.  On the CPU a span's device ms are None.

A span opened on a thread with no open span of its own, as autograd's
device thread runs remat's recompute inside the backward, is a child of
the innermost span open on the thread that opened the root.

Each root span (``repro_torch/step``, ``repro_torch/tick``) goes into a
ring of the last ``RING`` trees when it closes, with the counts made under
it (a count made outside any root is not kept).  ``steps(n)`` gives the last n trees as dicts, device ms resolved;
``counters()`` the counts summed over the ring, read from the device only
then.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

RING = 64
STEP = "repro_torch/step"


class _NoSpan:
    """The span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "children", "counts", "t0", "t1",
                 "ev0", "ev1", "rf", "ms")

    def __init__(self, name: str):
        self.name = name
        self.children: list = []
        self.counts = None          # {name: [int | device tensor]} on a root
        self.ev0 = self.ev1 = self.rf = self.ms = None

    def __enter__(self):
        _REC.open(self)
        return self

    def __exit__(self, *exc):
        _REC.close(self)
        return False


class Recorder:
    """The ring of root trees, each thread's stack of open spans and the
    free timing events."""

    def __init__(self):
        self.ring: collections.deque = collections.deque(maxlen=RING)
        self._local = threading.local()
        self._root = None           # the open root span
        self._root_stack = None     # the stack of the thread that opened it
        self._pool: list = []

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        return self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)

    def open(self, sp: _Span) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else (
            self._root_stack[-1] if self._root_stack else None)
        sp.parent = parent
        if parent is None:
            sp.counts = {}
            self._root, self._root_stack = sp, stack
        else:
            parent.children.append(sp)
        stack.append(sp)
        sp.rf = _RecordFunctionFast(sp.name)
        sp.rf.__enter__()
        if torch.cuda.is_initialized():
            sp.ev0 = self._event()
            sp.ev0.record()
        sp.t0 = time.time_ns()

    def close(self, sp: _Span) -> None:
        sp.t1 = time.time_ns()
        if sp.ev0 is not None:
            sp.ev1 = self._event()
            sp.ev1.record()
        sp.rf.__exit__(None, None, None)
        sp.rf = None
        self._stack().pop()
        if sp.parent is None:
            self._root = self._root_stack = None
            if len(self.ring) == self.ring.maxlen:
                self._release(self.ring[0])
            self.ring.append(sp)

    def add(self, name: str, value) -> None:
        if self._root is None:          # a count outside any root is not kept
            return
        if isinstance(value, torch.Tensor):
            value = value.sum(dtype=torch.int64)        # stays on the device
        self._root.counts.setdefault(name, []).append(value)

    def _release(self, sp: _Span) -> None:
        """Gives a tree's unread events back to the pool."""
        for s in _spans(sp):
            if s.ev0 is not None:
                self._pool += [s.ev0, s.ev1]
                s.ev0 = s.ev1 = None

    def device_ms(self, sp: _Span):
        if sp.ms is None and sp.ev1 is not None:
            sp.ev1.synchronize()
            sp.ms = sp.ev0.elapsed_time(sp.ev1)
            self._pool += [sp.ev0, sp.ev1]
            sp.ev0 = sp.ev1 = None
        return sp.ms

    def tree(self, sp: _Span) -> dict:
        out = {"name": sp.name, "start_ns": sp.t0, "end_ns": sp.t1,
               "host_ms": (sp.t1 - sp.t0) / 1e6,
               "device_ms": self.device_ms(sp),
               "children": [self.tree(c) for c in sp.children]}
        if sp.counts is not None:
            out["counts"] = {k: _total(v) for k, v in sp.counts.items()}
        return out


def _spans(sp: _Span):
    yield sp
    for c in sp.children:
        yield from _spans(c)


def _total(values: list) -> int:
    """The sum of a count's host ints and device scalars, which are read
    here and replaced by it."""
    ts = [v for v in values if isinstance(v, torch.Tensor)]
    n = sum(v for v in values if not isinstance(v, torch.Tensor))
    if ts:
        n += int(torch.stack(ts).sum())
    values[:] = [n]
    return n


_REC = Recorder()


def span(name: str):
    """A context manager that records the span ``name`` while the
    profiler runs, and does nothing otherwise."""
    if not _profiler_enabled():
        return NOOP
    return _Span(name)


def count(name: str, value) -> None:
    """Adds ``value`` (an int, or a tensor whose sum is added on the
    device) to the counter ``name`` of the open root span while the
    profiler runs."""
    if _profiler_enabled():
        _REC.add(name, value)


def steps(n: int | None = None, name: str | None = STEP) -> list:
    """The last ``n`` (all, for None) recorded root trees named ``name``
    (any root, for None), oldest first, as dicts: ``name``, ``start_ns``,
    ``end_ns``, ``host_ms``, ``device_ms`` (None off the card),
    ``children`` and, on the root, ``counts``."""
    roots = [r for r in _REC.ring if name is None or r.name == name]
    if n is not None:
        roots = roots[-n:] if n > 0 else []
    return [_REC.tree(r) for r in roots]


def counters() -> dict:
    """Every counter summed over the ring."""
    out: dict = {}
    for r in _REC.ring:
        for k, v in r.counts.items():
            out[k] = out.get(k, 0) + _total(v)
    return out


def clear() -> None:
    """Forgets every recorded tree."""
    for r in _REC.ring:
        _REC._release(r)
    _REC.ring.clear()


def walk(tree: dict):
    """Every node of a tree from ``steps``, the root first."""
    yield tree
    for c in tree["children"]:
        yield from walk(c)


def table(trees: list) -> list:
    """[(name, calls, host ms, device ms, self device ms)] summed over the
    nodes of ``trees``, by name in order of first appearance; the device
    columns are None off the card.  Self device ms is a span's less its
    children's."""
    rows: dict = {}
    for t in trees:
        for s in walk(t):
            r = rows.setdefault(s["name"], [0, 0.0, None, None])
            r[0] += 1
            r[1] += s["host_ms"]
            if s["device_ms"] is not None:
                kids = sum(c["device_ms"] or 0.0 for c in s["children"])
                r[2] = (r[2] or 0.0) + s["device_ms"]
                r[3] = (r[3] or 0.0) + s["device_ms"] - kids
    return [(k, *v) for k, v in rows.items()]
