"""Attention layers of two kinds in one model (Mellum2): windowed layers
with plain RoPE and every ``global_every``-th layer full with YaRN's RoPE,
on the CPU.  YaRN's frequencies against its formula, the reach of a token
through the full layers only, the window each layer hands K2, the spans
of each kind, and the decode entry points that refuse such a model.  The
port against the plain float32 reference is
``perfbench/tests/test_perfbench_reference.py``."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, telemetry
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

MELLUM = "mellum2-12b-a2.5b"
ROOT = Path(__file__).resolve().parents[1]


def _tiny(**kw) -> ModelConfig:
    """Two periods of three windowed layers and one full one at a small
    width, a window of 4 and YaRN's ramp acting over 16 positions; the
    experts' capacity drops no token (it would couple every position)."""
    base = dict(n_layers=8, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=32, moe_d_ff=16, vocab=64, n_experts=4,
                top_k=2, capacity_factor=2.0, window=4,
                yarn_original_len=16, rope_theta=100.0,
                dtype="float32", attn_chunk=64, max_target_len=64)
    return dataclasses.replace(configs.get(MELLUM), **{**base, **kw})


def _params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


def test_mellum2_is_reached_by_name_and_left_out_of_archs():
    cfg = configs.get(MELLUM)
    assert "mellum2_12b_a2_5b" not in configs.ARCHS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.n_experts, cfg.top_k, cfg.e_ff, cfg.vocab) == \
        (28, 2304, 32, 4, 128, 64, 8, 896, 98304)
    assert cfg.mixed_attn and not cfg.tie_embeddings and not cfg.qk_norm


def test_the_layer_pattern_is_the_published_layer_types():
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / "mellum2-12b-a2.5b-16l.json").read_text())
    cfg = configs.get(MELLUM)
    kinds = ["sliding_attention" if cfg.layer_window(i) else
             "full_attention" for i in range(cfg.n_layers)]
    assert kinds == conf["layer_types"]
    assert {cfg.layer_window(i) for i in range(cfg.n_layers)} == \
        {0, conf["sliding_window"]}
    full = conf["rope_parameters"]["full_attention"]
    assert (cfg.yarn_factor, cfg.yarn_original_len, L.YARN_BETA_FAST,
            L.YARN_BETA_SLOW, L.yarn_attn_factor(cfg), cfg.rope_theta) == (
        full["factor"], full["original_max_position_embeddings"],
        full["beta_fast"], full["beta_slow"], full["attention_factor"],
        full["rope_theta"])
    # the dotted keys the guard test compares are the nested values
    for key, value in conf.items():
        if key.startswith("rope_parameters."):
            _, kind, name = key.split(".")
            assert conf["rope_parameters"][kind][name] == value, key


def test_a_config_without_the_new_fields_has_one_kind():
    for name in configs.ARCHS:
        cfg = configs.get(name)
        assert not cfg.mixed_attn and not cfg.yarn_factor
        assert {cfg.layer_window(i) for i in range(cfg.n_layers)} == \
            {cfg.window}


def test_yarn_frequencies_at_mellum2s_values():
    """Pairs 0-18 keep theta^(-i/64), 35-63 are divided by 16 and 19-34
    blend the two linearly between the correction dims 18.08 and 34.98
    (floored and ceiled); the attention factor is 0.1 ln 16 + 1."""
    cfg = configs.get(MELLUM)
    got = L.yarn_freqs(cfg, 128, "cpu").double()
    i = torch.arange(64, dtype=torch.float64)
    base = 500000.0 ** (-i / 64)
    ramp = ((i - 18) / 17).clamp(0, 1)
    want = base * (1 - ramp) + base / 16 * ramp
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    ratio = got / base
    assert torch.allclose(ratio[:19], torch.ones(19, dtype=torch.float64),
                          rtol=2e-6)
    assert torch.allclose(ratio[35:], torch.full((29,), 1 / 16,
                                                 dtype=torch.float64),
                          rtol=2e-6)
    assert ((ratio[19:35] < 0.999) & (ratio[19:35] > 1 / 16 + 1e-3)).all()
    assert torch.all(ratio[19:35].diff() < 0)
    def dim(r):
        return 128 * math.log(8192 / (2 * math.pi * r)) / (2 * math.log(5e5))
    assert (round(dim(32), 2), round(dim(1), 2)) == (18.08, 34.98)
    assert L.yarn_ramp(cfg, 128) == (18, 35)
    assert L.yarn_attn_factor(cfg) == pytest.approx(0.1 * math.log(16) + 1,
                                                    rel=1e-15)


def test_yarn_rope_scales_cos_and_sin_and_plain_rope_is_unchanged():
    cfg = configs.get(MELLUM)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 40, 2, 128, generator=g)
    pos = torch.arange(40) * 400                # past the original 8,192
    af = L.yarn_attn_factor(cfg)
    freqs = L.yarn_freqs(cfg, 128, "cpu")
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :64], x[..., 64:]
    want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1) * af
    torch.testing.assert_close(L.rope(x, pos, cfg.rope_theta, cfg), want,
                               rtol=1e-5, atol=1e-5)
    # plain RoPE preserves the norm; YaRN's multiplies it by af
    plain = L.rope(x, pos, cfg.rope_theta)
    torch.testing.assert_close(plain.norm(dim=-1), x.norm(dim=-1))
    torch.testing.assert_close(L.rope(x, pos, cfg.rope_theta, cfg)
                               .norm(dim=-1), x.norm(dim=-1) * af)


@pytest.mark.parametrize("window", [0, 4])
def test_project_qkv_takes_yarn_on_full_layers_only(window):
    cfg = _tiny()
    p = _params(cfg)["layers"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(1, 20, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(20)
    q, k, _ = L.project_qkv(cfg, p, x, pos, window)
    q0 = torch.einsum("btd,dnh->btnh", x, p["wq"])
    yarn = cfg if not window else None
    torch.testing.assert_close(q, L.rope(q0, pos, cfg.rope_theta, yarn))
    plain = dataclasses.replace(cfg, yarn_factor=0.0)
    same = torch.equal(L.project_qkv(plain, p, x, pos, window)[0], q)
    assert same == bool(window)


def _logits(cfg, params, tokens):
    with torch.no_grad():
        return T.forward(cfg, params, {"tokens": tokens})[0]


def test_a_far_token_reaches_a_query_only_through_the_full_layers():
    """Changing token 0 moves the logits at a position further back than
    all eight layers' windows could carry it together: through the full
    layers.  With those layers windowed too (``global_every`` 0, the same
    weights) the logits there do not move."""
    cfg = _tiny()
    params = _params(cfg)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, 48), generator=g)
    other = tokens.clone()
    other[0, 0] = (tokens[0, 0] + 1) % cfg.vocab
    far = cfg.n_layers * (cfg.window - 1) + 1        # 25: out of reach
    mixed = [_logits(cfg, params, t) for t in (tokens, other)]
    assert not torch.allclose(mixed[0][:, far:], mixed[1][:, far:])
    windowed = dataclasses.replace(cfg, global_every=0)
    local = [_logits(windowed, params, t) for t in (tokens, other)]
    assert torch.equal(local[0][:, far:], local[1][:, far:])
    assert not torch.equal(local[0][:, :far], local[1][:, :far])


def test_each_layer_hands_the_kernel_its_window(monkeypatch):
    """On the card's path (``use_kernels``) every layer calls K2 with its
    own window, in the forward and in remat's recompute."""
    from repro_torch.kernels import ops, ref
    cfg = _tiny()
    calls = []

    def k2(q, k, v, causal=True, window=0):
        calls.append(window)
        return ref.attention(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(L, "use_kernels", lambda cfg, x: True)
    monkeypatch.setattr(ops, "flash_attention", k2)
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(4))
    _logits(cfg, params, tokens)
    pattern = [4, 4, 4, 0] * 2
    assert calls == pattern
    calls.clear()
    params["embed"].requires_grad_(True)
    x, _ = T.forward_hidden(cfg, params, {"tokens": tokens})
    x.sum().backward()
    # the forward, then remat's recompute from the last layer back
    assert calls == pattern + pattern[::-1]


def _span_counts(cfg):
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab, (1, 16),
                           generator=torch.Generator().manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span(telemetry.STEP):
            _logits(cfg, params, tokens)
    tree = telemetry.steps(1)[0]
    names = [n["name"] for n in telemetry.walk(tree)]
    telemetry.clear()
    return (names.count("repro_torch/attn_window"),
            names.count("repro_torch/attn_full"))


def test_the_kind_spans_open_only_in_a_mixed_model():
    telemetry.clear()
    assert _span_counts(_tiny()) == (6, 2)
    assert _span_counts(_tiny(global_every=0)) == (0, 0)
    assert _span_counts(_tiny(window=0, yarn_factor=0.0)) == (0, 0)


def test_decode_refuses_a_mixed_model():
    cfg = _tiny()
    with pytest.raises(NotImplementedError, match="ring cache"):
        T.init_cache(cfg, 1, 32, device="cpu")
    windowed = dataclasses.replace(cfg, global_every=0)
    cache = T.init_cache(windowed, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="ring cache"):
        T.decode_step(cfg, _params(cfg), cache,
                      torch.zeros((1, 1), dtype=torch.long))
