"""The span readers (``fwd_device_ms``, ``bwd_device_ms``,
``opt_device_ms``, ``moe_drop_share``) on hand-made step trees, and, on the
card, a traced small window: the spans stay off the device timeline and
time each phase of the step.  The card test is marked ``cuda`` and skips
where there is no card.

    python -m pytest -q perfbench/tests/test_perfbench_spans.py
"""

from __future__ import annotations

import pytest
import torch

from perfbench import trace, training, traffic
from perfbench_tiny import cells, small_cell
from test_perfbench_metrics import _window, read

SPAN_METRICS = ("fwd_device_ms", "bwd_device_ms", "opt_device_ms",
                "moe_drop_share")


def _span(name, ms, children=(), counts=None):
    node = {"name": f"repro_torch/{name}", "start_ns": 0, "end_ns": 1,
            "host_ms": 1.0, "device_ms": ms, "children": list(children)}
    if counts is not None:
        node["counts"] = counts
    return node


def test_span_readers_take_the_windows_step_trees(monkeypatch):
    from repro_torch import telemetry
    old = _span("step", 100.0, [
        _span("forward", 9.0), _span("backward", 9.0),
        _span("optimizer", 9.0)], {"moe/routed_pairs": 1000,
                                    "moe/kept_pairs": 0})
    trees = [old, _span("step", 60.0, [
        _span("forward", 10.0, [_span("loss_head", 2.0), _span("moe", 3.0)]),
        _span("forward", 12.0),                 # a second microbatch
        _span("backward", 30.0, [_span("moe", 4.0)]),
        _span("optimizer", 5.0)], {"moe/routed_pairs": 100,
                                   "moe/kept_pairs": 90}),
        _span("step", 70.0, [
            _span("forward", 20.0), _span("backward", 40.0),
            _span("optimizer", 7.0)], {"moe/routed_pairs": 100,
                                       "moe/kept_pairs": 80})]
    monkeypatch.setattr(telemetry, "steps",
                        lambda n=None, name=telemetry.STEP: trees[-n:])
    w = _window([], steps=2)
    assert read("fwd_device_ms", w) == pytest.approx((22.0 + 20.0) / 2)
    assert read("bwd_device_ms", w) == pytest.approx((30.0 + 40.0) / 2)
    assert read("opt_device_ms", w) == pytest.approx((5.0 + 7.0) / 2)
    assert read("moe_drop_share", w) == pytest.approx(100 * (1 - 170 / 200))
    assert read("fwd_device_ms", _window([], steps=1)) == pytest.approx(20.0)
    # a dense model counts no pair
    for t in trees:
        t["counts"] = {}
    assert read("moe_drop_share", w) is None
    assert read("opt_device_ms", w) == pytest.approx(6.0)
    # trees without device time (the CPU) give nothing
    for t in trees:
        for n in telemetry.walk(t):
            n["device_ms"] = None
    for name in SPAN_METRICS:
        assert read(name, w) is None


def test_span_readers_find_nothing_in_a_program_that_recorded_nothing():
    from repro_torch import telemetry
    telemetry.clear()
    w = _window([("k", 0.0, 1.0)], steps=3)
    for name in SPAN_METRICS:
        assert read(name, w) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _traced(ts, pool, card, cell):
    """A window of ``len(pool)`` steps under the profiler, as the
    benchmark's traced run takes it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0, w1, losses = training.window(ts, pool, 0.0, len(pool), card,
                                         lambda *a, **k: None)
    return trace.from_profiler(prof, window_s=w1 - w0, steps=len(losses),
                               launches={}, model=cell.config["model"],
                               traffic=cell.traffic,
                               reference=cell.config["reference"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_spans_stay_off_the_device_timeline_and_time_each_phase(
        name, card, monkeypatch):
    """The spans are host operations of the trace, never device ones; the
    three phases have device time; and recording launches nothing but the
    MoE's one sum a ``moe_block`` call: the same steps with the recording
    held off show that many fewer device operations."""
    from repro_torch import telemetry
    cell = small_cell(name)
    seed = 4_000_000_011
    ts = training.train_state(cell.config, seed, card)
    pool = traffic.device_batches(cell.traffic, cell.config["model"]["vocab"],
                                  4, seed, card)
    ts.step(pool[0])
    torch.cuda.synchronize(card)
    telemetry.clear()
    win = _traced(ts, pool[1:3], card, cell)
    assert [op for op in win.device_ops
            if op[0].startswith("repro_torch/")] == []
    assert {op[0] for op in win.host_ops
            if op[0].startswith("repro_torch/")} >= {
        "repro_torch/step", "repro_torch/forward", "repro_torch/backward",
        "repro_torch/optimizer", "repro_torch/loss_head"}
    for metric in ("fwd_device_ms", "bwd_device_ms", "opt_device_ms"):
        got = trace.read_metrics(win, [{"name": metric, "unit": "ms/step"}])
        assert got[metric]["value"] > 0, metric
    trees = telemetry.steps(2)
    moe_calls = sum(n["name"] == "repro_torch/moe"
                    for n in telemetry.walk(trees[-1]))
    assert (moe_calls > 0) == (cell.config["model"]["family"] == "moe")
    on = len(win.device_ops) // 2
    monkeypatch.setattr(telemetry, "_profiler_enabled", lambda: False)
    off = len(_traced(ts, pool[1:3], card, cell).device_ops) // 2
    assert on - off == moe_calls, (on, off, moe_calls)
