"""The counts and readers of a model whose attention layers differ in kind
(``metrics/_swa.py``, ``k2_swa_*_roofline``, ``attn_*_ms``) and of K3
over its kept pairs (``metrics/_kept.py``, ``k3_kept_*_roofline``)
against hand counts, and the reference's windowed attention and model
FLOPs."""

from __future__ import annotations

import pytest
import torch

from perfbench import counts, spec
from perfbench.metrics import _swa
from perfbench.reference import common
from perfbench.reference import train as reference
from test_perfbench_metrics import _window, read

CELL = "mellum2-train-b1t16384"


def _brute_pairs(T: int, W: int) -> int:
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    return int(((j <= i) & (j > i - W)).sum())


def test_window_pairs_by_hand():
    assert _swa.window_pairs(16384, 1024) == 16_253_440
    for T, W in ((1, 1), (5, 5), (7, 3), (100, 17), (64, 16), (300, 299)):
        assert _swa.window_pairs(T, W) == _brute_pairs(T, W), (T, W)


@pytest.mark.parametrize("T", [1, 2, 511, 1023, 1024])
def test_window_pairs_are_causal_within_the_window(T):
    assert _swa.window_pairs(T, 1024) == counts.causal_pairs(T)


def test_the_cells_pattern_and_pairs():
    m = spec.load_cell(CELL).config["model"]
    assert _swa.layer_windows(m) == [1024, 1024, 1024, 0] * 4
    pairs = _swa.layer_pairs(m, 16384)
    assert pairs.count(counts.causal_pairs(16384)) == 4
    assert pairs.count(16_253_440) == 12
    dense = spec.load_cell("dense-train-b4t4096").config["model"]
    assert _swa.layer_pairs(dense, 4096) == \
        [counts.causal_pairs(4096)] * dense["n_layers"]


def test_the_references_model_flops_at_the_cells_shape():
    c = spec.load_cell(CELL)
    mod = reference.model(c.config)
    assert mod.model_flops(c.config["model"], 1, 16384) == \
        169_799_149_682_688
    # every layer full: the frozen count of the other cells
    full = dict(c.config["model"], window=0)
    for B, T in ((1, 16384), (2, 4096), (1, 17)):
        assert mod.model_flops(full, B, T) == counts.model_flops(full, B, T)


def test_k2_swa_bounds_a_call_by_hand():
    """2.224 ms (full) and 0.269 ms (windowed) a forward call, 5.559 and
    0.673 ms a backward one, averaged 4 : 12 over the pattern."""
    m = spec.load_cell(CELL).config["model"]
    fwd = [counts.bound_s(*_swa.k2_fwd(1, 32, 4, 16384, 128, p))
           for p in (counts.causal_pairs(16384), 16_253_440)]
    bwd = [counts.bound_s(*_swa.k2_bwd(1, 32, 4, 16384, 128, p))
           for p in (counts.causal_pairs(16384), 16_253_440)]
    assert [round(1e3 * b, 3) for b in fwd + bwd] == \
        [2.224, 0.269, 5.559, 0.673]
    assert _swa.mean_bound(m, 1, 16384, _swa.k2_fwd) == \
        pytest.approx((4 * fwd[0] + 12 * fwd[1]) / 16)
    assert _swa.mean_bound(m, 1, 16384, _swa.k2_bwd) == \
        pytest.approx((4 * bwd[0] + 12 * bwd[1]) / 16)
    # at the causal pairs the counts are the frozen ones
    assert _swa.k2_fwd(2, 64, 4, 4096, 128, counts.causal_pairs(4096)) == \
        counts.k2_fwd(2, 64, 4, 4096, 128)
    assert _swa.k2_bwd(2, 64, 4, 4096, 128, counts.causal_pairs(4096)) == \
        counts.k2_bwd(2, 64, 4, 4096, 128)


def test_k2_swa_rooflines():
    m = spec.load_cell(CELL).config["model"]
    fwd = _swa.mean_bound(m, 1, 16384, _swa.k2_fwd)
    bwd = _swa.mean_bound(m, 1, 16384, _swa.k2_bwd)
    ops = [("void flash_attention_tc<128>(...)", 0.0, 32 * fwd),
           ("bwd_dot(float const*)", 2.0, 4 * bwd),
           ("void bwd_dkdv_wgmma<64>()", 3.0, 6 * bwd),
           ("void bwd_dq_wgmma<64>()", 4.0, 6 * bwd),
           ("moe_gmm_tc", 5.0, 1.0)]
    w = _window(ops, {"flash_attention": 32, "flash_attention_bwd": 16},
                cell=CELL)
    assert read("k2_swa_fwd_roofline", w) == pytest.approx(100.0)
    assert read("k2_swa_bwd_roofline", w) == pytest.approx(100.0)
    # a model without a window, or without K2, reads nothing
    assert read("k2_swa_fwd_roofline", _window(ops, {"flash_attention": 1})) \
        is None
    assert read("k2_swa_bwd_roofline", _window(ops, {}, cell=CELL)) is None


def _span(name, ms, children=()):
    return {"name": f"repro_torch/{name}", "start_ns": 0, "end_ns": 1,
            "host_ms": 1.0, "device_ms": ms, "children": list(children)}


def test_attn_span_readers(monkeypatch):
    from repro_torch import telemetry
    trees = [_span("step", 100.0, [
        _span("forward", 40.0, [_span("attn_window", 1.0),
                                _span("attn_window", 2.0),
                                _span("attn_full", 5.0)]),
        _span("backward", 50.0, [_span("attn_full", 6.0),
                                 _span("attn_window", 3.0)])])
        for _ in range(2)]
    trees[1]["children"][0]["children"][2]["device_ms"] = 7.0
    monkeypatch.setattr(telemetry, "steps",
                        lambda n=None, name=telemetry.STEP: trees[-n:])
    w = _window([], steps=2, cell=CELL)
    assert read("attn_window_ms", w) == pytest.approx(6.0)
    assert read("attn_full_ms", w) == pytest.approx((11.0 + 13.0) / 2)
    # a program without the spans (or a step without any) reads nothing
    for t in trees:
        t["children"] = [_span("forward", 1.0)]
    assert read("attn_window_ms", w) is None
    assert read("attn_full_ms", w) is None


def _moe_step(kept_a_call: int, calls: int):
    step = _span("step", 100.0, [_span("moe", 1.0) for _ in range(calls)])
    step["counts"] = {"moe/kept_pairs": kept_a_call * calls,
                      "moe/routed_pairs": 131072 * calls}
    return step


def test_k3_kept_rooflines(monkeypatch):
    """At 32,768 kept pairs a call (75% of the cell's 131,072 routed pairs
    dropped) a forward call is bound by its bytes, 0.1415 ms, and a
    backward call by its products, 0.2736 ms; the routed count reads
    higher on the same launches."""
    from perfbench.metrics import _kept
    from repro_torch import telemetry
    m = spec.load_cell(CELL).config["model"]
    P, E, d, f = 32768, m["n_experts"], m["d_model"], m["moe_d_ff"]
    fwd = (2 * counts.bound_s(*counts.k3_fwd(P, E, d, f))
           + counts.bound_s(*counts.k3_fwd(P, E, f, d))) / 3
    bwd = (2 * counts.bound_s(*counts.k3_bwd(P, E, d, f))
           + counts.bound_s(*counts.k3_bwd(P, E, f, d))) / 3
    assert (round(1e3 * fwd, 4), round(1e3 * bwd, 4)) == (0.1415, 0.2736)
    trees = [_moe_step(P, 32) for _ in range(2)]
    monkeypatch.setattr(telemetry, "steps",
                        lambda n=None, name=telemetry.STEP: trees[-n:])
    ops = [("void moe_gmm_tc<64>(...)", 0.0, 2 * 96 * fwd),
           ("void gmm_bwd_wgmma<128>(...)", 1.0, 2 * 48 * bwd),
           ("void flash_attention_tc<128>(...)", 2.0, 1.0)]
    w = _window(ops, {"moe_gmm": 2 * 96, "moe_gmm_bwd": 2 * 48}, steps=2,
                cell=CELL)
    assert _kept.pairs_a_call(w) == P
    assert read("k3_kept_fwd_roofline", w) == pytest.approx(100.0)
    assert read("k3_kept_bwd_roofline", w) == pytest.approx(100.0)
    assert read("k3_fwd_roofline", w) > 150.0
    # no MoE span, or no kept pair: nothing to read
    trees[:] = [_span("step", 100.0, [_span("forward", 1.0)])] * 2
    assert read("k3_kept_fwd_roofline", w) is None
    trees[:] = [_moe_step(0, 32) for _ in range(2)]
    assert read("k3_kept_bwd_roofline", w) is None


def test_the_references_window_attention_is_the_masked_softmax():
    mod = reference.module("mellum2")
    g = torch.Generator().manual_seed(7)
    B, T, H, Hkv, hd, W = 2, 37, 4, 2, 8, 6
    q = torch.randn(B, T, H, hd, generator=g)
    k = torch.randn(B, T, Hkv, hd, generator=g)
    v = torch.randn(B, T, Hkv, hd, generator=g)
    got = mod.window_attention("f32", q, k, v, W, block=5)
    kk = k.repeat_interleave(H // Hkv, dim=2)
    vv = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, kk) * hd ** -0.5
    i, j = torch.arange(T)[:, None], torch.arange(T)[None, :]
    s = s.masked_fill(~((j <= i) & (j > i - W)), float("-inf"))
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), vv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # a window as long as the sequence is causal attention
    torch.testing.assert_close(
        mod.window_attention("f32", q, k, v, T, block=5),
        common.causal_attention("f32", q, k, v, block=5),
        rtol=1e-5, atol=1e-5)


def test_the_references_yarn_is_the_ports():
    """The reference's YaRN, written from the paper, and the port's agree
    at Mellum2's values and at the tiny test's (where the ramp blends
    pairs 1 and 2 of 8)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import layers as L
    mod = reference.module("mellum2")
    conf = spec.load_cell(CELL).config
    g = torch.Generator().manual_seed(8)
    for values, hd in (({}, 128), (conf["tests"]["tiny"], 16)):
        m = dict(conf["model"], **values)
        cfg = dataclasses.replace(configs.get(conf["arch"]),
                                  **{k: m[k] for k in (
                                      "rope_theta", "yarn_factor",
                                      "yarn_original_len")})
        x = torch.randn(1, 64, 2, hd, generator=g)
        pos = torch.arange(64)      # far positions: float32 angles differ
        t = mod.yarn_temperature(m["yarn_factor"])
        torch.testing.assert_close(mod.yarn_rope(m, x, pos) * t,
                                   L.rope(x, pos, cfg.rope_theta, cfg),
                                   rtol=1e-4, atol=1e-4)


def test_the_references_yarn_constants_are_the_published_values():
    """The beta_fast, beta_slow and attention_factor that the published
    configuration gives and the model has no key for are the reference's
    constants and its 0.1 ln s + 1."""
    mod = reference.module("mellum2")
    conf = spec.load_cell(CELL).config
    full = conf["rope_parameters"]["full_attention"]
    assert (full["beta_fast"], full["beta_slow"]) == (mod.BETA_FAST,
                                                      mod.BETA_SLOW)
    assert mod.yarn_temperature(conf["model"]["yarn_factor"]) == \
        full["attention_factor"]
