"""Model parity: the PyTorch port against the JAX package, with parameters
converted leaf by leaf from ``repro.models.init_params``, in float32 on the
CPU.  Tolerance 1e-4 (float32 on both sides, summed in another order)
unless a test says otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                        # noqa: E402
from repro.models import decode_step as j_decode_step        # noqa: E402
from repro.models import forward as j_forward                # noqa: E402
from repro.models import init_cache as j_init_cache          # noqa: E402
from repro.models import init_params as j_init_params        # noqa: E402
from repro.models.layers import attention as j_attention     # noqa: E402

from repro_torch import configs                               # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params)
from repro_torch.models.layers import attention               # noqa: E402

TOL = 1e-4
# every windowless dense / vlm / audio architecture
ARCHS = [a for a in configs.ARCHS
         if configs.get(a).family in ("dense", "vlm", "audio")
         and not configs.get(a).window]


def f32(arch):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype="float32"),
            dataclasses.replace(configs.smoke(arch), dtype="float32"))


def converted(arch, seed=0):
    jcfg, cfg = f32(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, p


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def test_windowless_dense_archs_listed():
    assert set(ARCHS) == {"qwen3_0_6b", "gemma_7b", "granite_34b",
                          "starcoder2_3b", "pixtral_12b", "musicgen_medium"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, cfg, jp, p = converted(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jb, b = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.prefix_len:
        pre = (rng.standard_normal((2, cfg.prefix_len, cfg.d_model))
               * 0.1).astype(np.float32)
        jb["prefix_embeds"] = jnp.asarray(pre)
        b["prefix_embeds"] = torch.from_numpy(pre)
    want, _ = j_forward(jcfg, jp, jb)
    got, aux = forward(cfg, p, b)
    assert aux == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax(arch):
    jcfg, cfg, jp, p = converted(arch)
    rng = np.random.default_rng(1)
    B, T = 2, 4
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    jc = j_init_cache(jcfg, B, 64)
    c = init_cache(cfg, B, 64, device="cpu")
    for t in range(T):
        want, jc = j_decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, c = decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
        assert c["length"] == int(jc["length"]) == t + 1
    np.testing.assert_allclose(_np(c["layers"]["k"]),
                               np.asarray(jc["layers"]["k"]), rtol=TOL,
                               atol=TOL)


def test_decode_append_clamps_at_cache_end():
    """``lax.dynamic_update_slice`` clamps the start to S - T: at
    length >= S the token lands at S-1, RoPE keeps the unclamped position
    and every cache entry is valid (``lengths = min(length+1, S)``)."""
    jcfg, cfg, jp, p = converted("qwen3_0_6b")
    rng = np.random.default_rng(2)
    B, S = 2, 64
    jc = j_init_cache(jcfg, B, S)
    assert jc["layers"]["k"].shape[2] == S
    filled = rng.standard_normal(jc["layers"]["k"].shape).astype(np.float32)
    for length in (S - 1, S, S + 3):
        jc = {"layers": {"k": jnp.asarray(filled),
                         "v": jnp.asarray(filled[::-1].copy())},
              "tail": [], "length": jnp.asarray(length, jnp.int32)}
        c = cache_from_jax(jax.tree.map(np.asarray, jc), cfg, device="cpu")
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        want, jc2 = j_decode_step(jcfg, jp, jc, jnp.asarray(tok))
        got, c2 = decode_step(cfg, p, c, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"length {length}")
        np.testing.assert_allclose(_np(c2["layers"]["v"]),
                                   np.asarray(jc2["layers"]["v"]), rtol=TOL,
                                   atol=TOL)
        assert c2["length"] == length + 1


@pytest.mark.parametrize("S,window", [(2500, 0), (3072, 0), (2200, 300)])
def test_attention_chunked_branch_matches_jax(S, window):
    """S > max(2*chunk, 2048) takes the online-softmax loop over chunks
    (ragged S pads the last chunk)."""
    rng = np.random.default_rng(3)
    B, T, H, Hkv, hd = 1, 3, 4, 2, 16
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    q_pos = np.arange(S - T, S, dtype=np.int32)
    k_pos = np.arange(S, dtype=np.int32)
    want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(q_pos), jnp.asarray(k_pos),
                       window=window, chunk=1024)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), torch.from_numpy(q_pos),
                    torch.from_numpy(k_pos), window=window, chunk=1024)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_decode_matches_prefill_port_only():
    """``tests/test_models.py::test_decode_matches_prefill`` on the port
    alone, in the config's bf16, at the reference's 5e-2."""
    cfg = configs.smoke("qwen3_0_6b")
    gen = torch.Generator("cpu").manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    rng = np.random.default_rng(1)
    B, T = 2, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)))
    full, _ = forward(cfg, params, {"tokens": toks})
    cache = init_cache(cfg, B, 64, device="cpu")
    steps = []
    for t in range(T):
        lg, cache = decode_step(cfg, params, cache, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(steps, 1).float()),
                               _np(full.float()), rtol=5e-2, atol=5e-2)


def test_stacked_layers_keep_reference_layout():
    jcfg, cfg, jp, p = converted("qwen3_0_6b")
    assert p["layers"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                               cfg.n_heads, cfg.hd)
    assert p["layers"]["attn"]["wo"].shape == (cfg.n_layers, cfg.n_heads,
                                               cfg.hd, cfg.d_model)
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    mine = jax.tree.map(lambda x: tuple(x.shape),
                        init_params(cfg, device="meta"))
    assert shapes == mine


def test_unported_families_name_their_roadmap_item():
    for arch, item in (("qwen3_moe_235b", "item 6"), ("rwkv6_3b", "item 7"),
                       ("recurrentgemma_9b", "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            init_params(configs.smoke(arch), device="cpu")


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(configs.smoke("qwen3_0_6b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(configs.smoke("qwen3_0_6b"), 2, 64)
    from repro_torch.core.torchstate import OwnedState
    from repro_torch.serve import ServeEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(configs.smoke("qwen3_0_6b"), OwnedState("w", {}))
