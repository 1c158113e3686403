"""Model parity: the PyTorch port against the JAX package, with parameters
converted leaf by leaf from ``repro.models.init_params``, in float32 on the
CPU.  Tolerance 1e-4 (float32 on both sides, summed in another order)
unless a test says otherwise.  The recurrent and MoE families run their
smoke configs, recurrentgemma with 5 layers: one scanned block of 3 and an
unrolled tail of 2 (``smoke()`` alone has no tail)."""

import dataclasses
import functools

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
RECURRENT = ["rwkv6_3b", "recurrentgemma_9b"]
MOE = ["qwen3_moe_235b", "arctic_480b"]
N_LAYERS = {"recurrentgemma_9b": 5}


def smoke_pair(arch, **kw):
    """(JAX config, port config) of ``arch``'s smoke variant."""
    kw.setdefault("n_layers", N_LAYERS.get(arch, configs.smoke(arch)
                                           .n_layers))
    return (dataclasses.replace(jconfigs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def f32(arch):
    return smoke_pair(arch, dtype="float32")


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


@pytest.mark.parametrize("arch", ARCHS + RECURRENT + MOE)
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
    want, want_aux = j_forward(jcfg, jp, jb)
    got, aux = forward(cfg, p, b)
    if cfg.n_experts:            # the Switch aux loss summed over layers
        assert float(want_aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL,
                                   atol=TOL)
    else:
        assert aux == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_head_dim_160_matches_jax():
    """pixtral-12b's head dim of 160: its smoke config at hd 160 (2 layers,
    d_model 128, 4 heads over 2 kv heads), the forward with its prefix
    embeddings and 4 decode steps, against the reference."""
    jcfg, cfg = smoke_pair("pixtral_12b", dtype="float32", head_dim=160,
                           n_layers=2)
    assert cfg.hd == 160 and cfg.prefix_len
    jp = j_init_params(jcfg, jax.random.PRNGKey(3))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    pre = (rng.standard_normal((2, cfg.prefix_len, cfg.d_model))
           * 0.1).astype(np.float32)
    want, _ = j_forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                   "prefix_embeds": jnp.asarray(pre)})
    got, _ = forward(cfg, p, {"tokens": torch.from_numpy(toks),
                              "prefix_embeds": torch.from_numpy(pre)})
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    jc = j_init_cache(jcfg, 2, 64)
    c = init_cache(cfg, 2, 64, device="cpu")
    for t in range(4):
        want, jc = j_decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, c = decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")


def assert_tree_close(got, want, tol=TOL):
    """Every leaf of a port tree against the JAX tree's, dtypes too."""
    flat = jax.tree_util.tree_flatten_with_path
    mine, theirs = flat(got)[0], flat(jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        name = jax.tree_util.keystr(path)
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name, name
        np.testing.assert_allclose(_np(a), b, rtol=tol, atol=tol,
                                   err_msg=name)


# dense archs: 4 steps; rwkv and MoE: 8; recurrentgemma: 70, through a wrap
# of its 64-slot ring
STEPS = {"rwkv6_3b": 8, "recurrentgemma_9b": 70, "qwen3_moe_235b": 8,
         "arctic_480b": 8}


@pytest.mark.parametrize("arch", ARCHS + RECURRENT + MOE)
def test_decode_step_logits_match_jax(arch):
    jcfg, cfg, jp, p = converted(arch)
    rng = np.random.default_rng(1)
    B, T = 2, STEPS.get(arch, 4)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    jc = j_init_cache(jcfg, B, 64)
    c = init_cache(cfg, B, 64, device="cpu")
    j_step = jax.jit(functools.partial(j_decode_step, jcfg))
    for t in range(T):
        want, jc = j_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, c = decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
        assert c["length"] == int(jc["length"]) == t + 1
    assert_tree_close({"layers": c["layers"], "tail": c["tail"]},
                      {"layers": jc["layers"], "tail": jc["tail"]})


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


def test_ring_cache_wraps_like_jax():
    """A preset recurrentgemma cache (ring, recurrent states and tail) at
    lengths around and past its W = 64 slots: the shared scalar length
    keeps growing, the slot is ``length % W``.  One decode step from each,
    logits and every new cache leaf against the reference."""
    jcfg, cfg, jp, p = converted("recurrentgemma_9b")
    rng = np.random.default_rng(4)
    B = 2
    empty = jax.tree.map(np.asarray, j_init_cache(jcfg, B, 64))
    W = empty["layers"][2]["k"].shape[2]
    assert W == cfg.window == 64
    for length in (W - 1, W, W + 3, 3 * W + 5):
        # the ring after `length` tokens: slot s holds the latest position
        # p < length with p % W == s, or the sentinel if none was written
        slots = np.arange(W)
        pos = slots + (length - 1 - slots) // W * W
        pos = np.where(pos >= 0, pos, -(1 << 30)).astype(np.int32)
        jc = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
            empty)
        jc["layers"][2]["slot_pos"] = np.broadcast_to(
            pos, empty["layers"][2]["slot_pos"].shape).copy()
        jc["length"] = np.asarray(length, np.int32)
        c = cache_from_jax(jc, cfg, device="cpu")
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        want, jc2 = j_decode_step(jcfg, jp, jax.tree.map(jnp.asarray, jc),
                                  jnp.asarray(tok))
        got, c2 = decode_step(cfg, p, c, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"length {length}")
        assert_tree_close({"layers": c2["layers"], "tail": c2["tail"]},
                          {"layers": jc2["layers"], "tail": jc2["tail"]})
        assert c2["length"] == length + 1


@pytest.mark.parametrize("block", ["rglru", "time_mix"])
def test_streamed_halves_match_one_shot(block):
    """A recurrent block fed in two halves, the second from the first's
    state, equals the reference's one-shot call (the reference's own test
    holds its halves at 2e-3)."""
    from repro.models import rglru as j_rglru
    from repro.models import rwkv as j_rwkv
    from repro_torch.models import rglru, rwkv
    arch = "recurrentgemma_9b" if block == "rglru" else "rwkv6_3b"
    jcfg, cfg, jp, p = converted(arch)
    if block == "rglru":
        jp_b, p_b = jp["layers"][0]["rec"], p["layers"][0]["rec"]
        jp_b, p_b = jax.tree.map(lambda a: a[0], jp_b), \
            {k: t[0] for k, t in p_b.items()}
        j_fn = lambda x, st: j_rglru.rglru_block(jcfg, jp_b, x, st)  # noqa
        fn = lambda x, st: rglru.rglru_block(cfg, p_b, x, st)        # noqa
    else:
        jp_b = jax.tree.map(lambda a: a[0], jp["layers"])
        p_b = {k: t[0] for k, t in p["layers"].items()}
        j_fn = lambda x, st: j_rwkv.time_mix(jcfg, jp_b, x, st)      # noqa
        fn = lambda x, st: rwkv.time_mix(cfg, p_b, x, st)            # noqa
    x = (np.random.default_rng(5).standard_normal((2, 70, cfg.d_model))
         * 0.5).astype(np.float32)
    want, wst = j_fn(jnp.asarray(x), None)
    xt = torch.from_numpy(x)
    y1, st1 = fn(xt[:, :33], None)
    y2, st2 = fn(xt[:, 33:], st1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), np.asarray(want),
                               rtol=2e-3, atol=2e-3)
    for k in wst:
        np.testing.assert_allclose(_np(st2[k]), np.asarray(wst[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


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


@pytest.mark.parametrize("arch", ["qwen3_0_6b"] + RECURRENT)
def test_decode_matches_prefill_port_only(arch):
    """``tests/test_models.py::test_decode_matches_prefill`` on the port
    alone, in the config's bf16, at the reference's 5e-2."""
    cfg = smoke_pair(arch)[1]
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


def _layout(tree):
    return jax.tree.map(lambda x: (tuple(x.shape),
                                   str(x.dtype).removeprefix("torch.")), tree)


@pytest.mark.parametrize("arch", ["qwen3_0_6b"] + RECURRENT + MOE)
def test_stacked_layers_keep_reference_layout(arch):
    """Shapes and dtypes of the bf16 parameters and caches, as the
    reference's ``init_params`` / ``init_cache`` lay them out: stacked
    leaves, a list of per-position stacks and a tail for the hybrid, and
    the leaves the reference keeps in float32 (RWKV's u / w0, RG-LRU's
    lam, the recurrent states, the MoE router)."""
    jcfg, cfg = smoke_pair(arch)
    key = jax.random.PRNGKey(0)
    jp = jax.eval_shape(functools.partial(j_init_params, jcfg), key)
    assert _layout(init_params(cfg, device="meta")) == jax.tree.map(
        lambda x: (x.shape, x.dtype.name), jp)
    jc = jax.eval_shape(lambda: j_init_cache(jcfg, 2, 64))
    c = init_cache(cfg, 2, 64, device="meta")
    assert c["length"] == 0
    assert _layout({"layers": c["layers"], "tail": c["tail"]}) \
        == jax.tree.map(lambda x: (x.shape, x.dtype.name),
                        {"layers": jc["layers"], "tail": jc["tail"]})
    # conversion keeps each leaf's dtype
    p = params_from_jax(jax.tree.map(np.asarray, j_init_params(jcfg, key)),
                        cfg, device="cpu")
    assert _layout(p) == _layout(init_params(cfg, device="meta"))
    if arch == "qwen3_0_6b":
        assert p["layers"]["attn"]["wq"].shape == (
            cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd)
    elif arch == "rwkv6_3b":
        assert p["layers"]["u"].dtype == torch.float32
        assert p["layers"]["wr"].dtype == torch.bfloat16
    elif arch in MOE:
        assert p["layers"]["moe"]["router"].dtype == torch.float32
        assert p["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
        assert ("mlp" in p["layers"]) == (arch == "arctic_480b")
    else:
        assert len(p["layers"]) == 3 and len(p["tail"]) == 2
        assert p["tail"][0]["rec"]["lam"].dtype == torch.float32


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_config_inits_on_meta(arch):
    """Every published configuration, the MoE ones included, lays out its
    parameters and a decode cache (shapes and dtypes only, no memory) as
    the reference's ``init_params`` / ``init_cache`` do."""
    cfg = configs.get(arch)
    jcfg = jconfigs.get(arch)
    jp = jax.eval_shape(functools.partial(j_init_params, jcfg),
                        jax.random.PRNGKey(0))
    p = init_params(cfg, device="meta")
    assert _layout(p) == jax.tree.map(lambda x: (x.shape, x.dtype.name), jp)
    c = init_cache(cfg, 1, 64, device="meta")
    jc = jax.eval_shape(lambda: j_init_cache(jcfg, 1, 64))
    assert _layout({"layers": c["layers"], "tail": c["tail"]}) \
        == jax.tree.map(lambda x: (x.shape, x.dtype.name),
                        {"layers": jc["layers"], "tail": jc["tail"]})


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
