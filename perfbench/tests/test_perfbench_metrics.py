"""The metric arithmetic on synthetic profiler events: the union of
overlapping kernels, the idle share and its gaps, the window rate, and
each per-layer reader."""

from __future__ import annotations

import pytest

from perfbench import counts, spec, trace

MOE = "moe-train-b2t4096"


def _window(ops, launches=None, host=(), window_s=1.0, steps=2, cell=MOE):
    c = spec.load_cell(cell)
    return trace.Window(device_ops=sorted(ops, key=lambda o: o[1]),
                        host_ops=sorted(host, key=lambda o: o[1]),
                        window_s=window_s, steps=steps,
                        launches=launches or {}, model=c.config["model"],
                        traffic=c.traffic, reference=c.config["reference"])


def test_union_counts_overlap_once():
    ops = [("a", 0.0, 0.4), ("b", 0.1, 0.2), ("c", 0.5, 0.1),
           ("d", 0.55, 0.2)]
    assert trace.union([(s, s + d) for _, s, d in ops]) == [
        [0.0, 0.4], [0.5, 0.75]]
    assert trace.busy_s(ops) == pytest.approx(0.65)
    assert trace.device_s(ops) == pytest.approx(0.9)


def test_idle_share_and_gaps():
    ops = [("k1", 0.0, 0.4), ("k2", 0.1, 0.1), ("k3", 0.6, 0.3)]
    host = [("aten::step", 0.0, 1.0), ("aten::copy_", 0.35, 0.1),
            ("aten::item", 0.45, 0.2)]
    w = _window(ops, host=host, window_s=1.0)
    assert read("device_idle_share", w) == pytest.approx(100 * (1 - 0.7))
    gaps = trace.idle_gaps(w)
    assert gaps == [["aten::copy_", pytest.approx(0.2)]]
    assert trace.top_ops(ops + [("k1", 1.0, 0.1)], 2) == [
        ["k1", pytest.approx(0.5)], ["k3", pytest.approx(0.3)]]


def read(name, window):
    return trace.read_metrics(window, [{"name": name, "unit": "%"}]).get(
        name, {}).get("value")


def test_readers_find_nothing_in_an_empty_window():
    w = _window([], steps=0)
    for m in spec.load_benchmark()["per_layer"]:
        assert read(m["name"], w) is None


def test_k2_rooflines():
    c = spec.load_cell(MOE)
    B, T = c.traffic["batch"], c.traffic["seq_len"]
    fwd = counts.bound_s(*counts.k2_fwd(B, 64, 4, T, 128))
    bwd = counts.bound_s(*counts.k2_bwd(B, 64, 4, T, 128))
    ops = [("void flash_attention_tc<128>(...)", 0.0, 2 * fwd),
           ("void flash_attention_tc<128>(...)", 1.0, 2 * fwd),
           ("bwd_dot(float const*)", 2.0, bwd),
           ("void bwd_dkdv_wgmma<64>()", 3.0, bwd),
           ("void bwd_dq_wgmma<64>()", 4.0, 2 * bwd),
           ("ampere_bf16_s16816gemm_bf16_128x128", 5.0, 1.0)]
    w = _window(ops, {"flash_attention": 2, "flash_attention_bwd": 1})
    assert read("k2_fwd_roofline", w) == pytest.approx(50.0)
    assert read("k2_bwd_roofline", w) == pytest.approx(25.0)
    assert read("k4_fwd_roofline", w) is None


def test_k3_and_k4_rooflines():
    c = spec.load_cell(MOE)
    m = c.config["model"]
    pairs = c.traffic["batch"] * c.traffic["seq_len"] * m["top_k"]
    up = counts.bound_s(*counts.k3_fwd(pairs, 128, 4096, 1536))
    down = counts.bound_s(*counts.k3_fwd(pairs, 128, 1536, 4096))
    ops = [("moe_gmm_tc", 0.0, up), ("moe_gmm_tc", 1.0, up),
           ("moe_gmm_tc", 2.0, down)]
    w = _window(ops, {"moe_gmm": 3})
    assert read("k3_fwd_roofline", w) == pytest.approx(100.0)
    r = spec.load_cell("rwkv6-train-b2t4096")
    b = counts.bound_s(*counts.k4_fwd(2, 40, 4096, 64))
    ops = [("chunk_state", 0.0, b), ("state_scan", 1.0, b),
           ("chunk_out", 2.0, 2 * b)]
    w = _window(ops, {"rwkv_scan": 1}, cell=r.name)
    assert read("k4_fwd_roofline", w) == pytest.approx(25.0)
    assert read("k3_fwd_roofline", w) is None


def test_pointwise_leaves_out_the_ports_kernels_and_gemms():
    ops = [("void at::native::vectorized_elementwise_kernel<4>()", 0.0, 0.003),
           ("Memcpy DtoD (Device -> Device)", 0.1, 0.001),
           ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", 0.2, 0.5),
           ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.3, 0.5),
           ("moe_gmm_wgmma", 0.4, 0.5), ("rwkv_bwd_chunk_tc", 0.5, 0.5),
           ("flash_attention_tc", 0.6, 0.5)]
    assert read("torch_pointwise_ms", _window(ops, steps=2)) == \
        pytest.approx(2.0)


def test_train_mfu():
    c = spec.load_cell(MOE)
    flops = counts.model_flops(c.config["model"], 2, 4096)
    w = _window([("k", 0.0, 1.0)], steps=3, window_s=3 * flops / 989e12 * 4)
    assert read("train_mfu", w) == pytest.approx(25.0)
