"""The port's spans and counters (``repro_torch.telemetry``) on the CPU:
nothing recorded with the profiler off, the train step's tree under it,
each span a plain host operation of the trace (never a user annotation,
which the trace would copy onto the device's timeline), the MoE's
counters, the ring's bound, a span opened on another thread, the serve
tick's spans and ``launch/trace.py::profiled``'s table."""

from __future__ import annotations

import dataclasses
import json
import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, telemetry
from repro_torch.core import Cluster
from repro_torch.core.torchstate import OwnedState
from repro_torch.launch import trace
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptConfig, TrainState, shard_batch,
                               synthetic_batches)

STEP, FWD, BWD, OPT, HEAD, MOE = (
    f"repro_torch/{n}" for n in ("step", "forward", "backward", "optimizer",
                                 "loss_head", "moe"))
MOE_ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(autouse=True)
def empty_ring():
    telemetry.clear()
    yield
    telemetry.clear()


def _state(arch="qwen3-0.6b", **kw):
    cfg = dataclasses.replace(configs.smoke(arch), **kw)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = OptConfig(lr=1e-3, warmup=1, decay_steps=10)
    return cfg, TrainState(cfg, opt, params)


def _batch(cfg, B=2, T=32):
    return shard_batch(None, next(synthetic_batches(cfg.vocab, B, T)),
                       device="cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _shape(tree):
    return (tree["name"], [_shape(c) for c in tree["children"]])


def test_with_the_profiler_off_nothing_is_recorded():
    cfg, ts = _state()
    ts.step(_batch(cfg))
    assert telemetry.span(STEP) is telemetry.NOOP
    with telemetry.span(STEP):
        pass

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"count read {name} with the profiler off")

    telemetry.count("moe/kept_pairs", Untouchable())
    assert telemetry.steps() == [] and telemetry.counters() == {}


def test_a_profiled_step_records_its_tree_with_nested_host_times():
    cfg, ts = _state()
    batch = _batch(cfg)
    _profiled(lambda: ts.step(batch))
    (tree,) = telemetry.steps()
    assert _shape(tree) == (STEP, [(FWD, [(HEAD, [])]), (BWD, []),
                                   (OPT, [])])
    for node in telemetry.walk(tree):
        assert node["device_ms"] is None                # no card here
        assert node["start_ns"] <= node["end_ns"]
        for c in node["children"]:
            assert node["start_ns"] <= c["start_ns"] <= c["end_ns"] \
                <= node["end_ns"]
    kids = tree["children"]
    assert [a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:])] \
        == [True, True]


def test_spans_are_plain_host_operations_of_the_trace():
    cfg, ts = _state()
    batch = _batch(cfg)
    prof = _profiled(lambda: ts.step(batch))
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("repro_torch/")]
    assert sorted(e.name() for e in evs) == sorted([STEP, FWD, HEAD, BWD,
                                                    OPT])
    for e in evs:
        assert e.device_type() == DeviceType.CPU
        assert e.activity_type() == "cpu_op"
        assert not e.is_user_annotation()
    # the trace's clock is the spans' own
    (tree,) = telemetry.steps()
    (step,) = [e for e in evs if e.name() == STEP]
    assert abs(step.start_ns() - tree["start_ns"]) < 5e6


def test_the_moe_counts_its_routed_and_kept_pairs():
    cfg, ts = _state(MOE_ARCH)
    B, T = 2, 32
    batch = _batch(cfg, B, T)
    _profiled(lambda: ts.step(batch))
    (tree,) = telemetry.steps()
    moes = [n for n in telemetry.walk(tree) if n["name"] == MOE]
    under_fwd = [n for n in telemetry.walk(tree["children"][0])
                 if n["name"] == MOE]
    assert len(under_fwd) == cfg.n_layers
    counts = telemetry.counters()
    assert counts == tree["counts"]
    routed, kept = counts["moe/routed_pairs"], counts["moe/kept_pairs"]
    assert routed == len(moes) * B * T * cfg.top_k
    assert 0 <= 100 * (1 - kept / routed) < 100


def test_the_ring_keeps_the_last_64_roots():
    def body():
        for i in range(70):
            with telemetry.span(STEP):
                telemetry.count("n", i)
        telemetry.count("n", 1000)                      # not kept: no root
    _profiled(body)
    assert len(telemetry.steps()) == telemetry.RING == 64
    assert [t["counts"]["n"] for t in telemetry.steps(3)] == [67, 68, 69]
    assert telemetry.steps(0) == []
    assert telemetry.counters() == {"n": sum(range(6, 70))}


def test_a_span_on_a_thread_with_none_open_joins_the_innermost_open_one():
    """As autograd's device thread runs remat's recompute in the backward
    (the engine carries the profiler's state to it; a plain thread does
    not see the profiler, so the span is made directly here)."""
    def recompute():
        with telemetry._Span(MOE):
            telemetry._REC.add("moe/routed_pairs", 4)

    def body():
        with telemetry.span(STEP), telemetry.span(BWD):
            t = threading.Thread(target=recompute)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    _profiled(body)
    (tree,) = telemetry.steps()
    assert _shape(tree) == (STEP, [(BWD, [(MOE, [])])])
    assert tree["counts"] == {"moe/routed_pairs": 4}


def test_a_profiled_serve_tick_records_admit_read_pages_and_decode():
    cfg = configs.smoke("qwen3-0.6b")
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, OwnedState("w", p), slots=2, max_len=128,
                      device="cpu", cluster=Cluster(2, backend="drust"))
    eng.submit([1, 2, 3, 4], max_new=2)
    _profiled(eng.step)
    (tick,) = telemetry.steps(name="repro_torch/tick")
    assert _shape(tick) == ("repro_torch/tick", [
        ("repro_torch/admit", []), ("repro_torch/read_pages", []),
        ("repro_torch/decode", [])])
    assert telemetry.steps() == []                      # no train step


def test_profiled_prints_the_span_table_and_the_drop_share(capsys):
    cfg, ts = _state(MOE_ARCH)
    batch = _batch(cfg)
    assert trace.profiled(lambda: ts.step(batch), 1, torch.device("cpu"),
                          unit="steps") == 1
    out = capsys.readouterr().out
    rows = {line.split()[0]: line.split()[1:] for line in out.splitlines()
            if line.startswith("repro_torch/")}
    assert set(rows) == {STEP, FWD, HEAD, MOE, BWD, OPT}
    assert rows[STEP][0] == "1" and rows[STEP][2:] == ["-", "-"]
    line = json.loads(out.splitlines()[-1])
    assert line["profile_steps"] == 1 and line["device_busy_ms"] == 0.0
    assert line["counters"]["moe/routed_pairs"] > 0
    assert 0 <= line["moe_drop_share"] < 100


def test_profiled_counts_overlapping_kernels_once():
    ms = 1_000_000
    assert trace._busy_ms([(0, 4 * ms), (1 * ms, 2 * ms), (5 * ms, 6 * ms),
                           (5 * ms + 500_000, 7 * ms)]) == pytest.approx(6.0)
    assert trace._busy_ms([]) == 0.0
