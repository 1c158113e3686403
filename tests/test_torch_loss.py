"""Loss parity: the port's ``loss_fn`` and its autograd gradients against
``jax.value_and_grad(repro.models.loss_fn)``, with parameters converted
leaf by leaf (``convert.params_from_jax``), float32 smoke configs of every
family on the CPU, full and chunked cross entropy (``chunked_ce`` 0 and
2), pixtral's and musicgen's prefix embeddings sliced off the loss.
Tolerance ``TOL`` of ``tests/test_torch_models.py`` (float32 on both
sides, summed in another order), for each gradient relative to its leaf's
largest entry.  recurrentgemma runs 5 layers: a scanned block of 3 under
remat and an unrolled tail of 2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                        # noqa: E402
from repro.models import init_params as j_init_params        # noqa: E402
from repro.models import loss_fn as j_loss_fn                # noqa: E402

from repro_torch import configs                               # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten as paths  # noqa
from repro_torch.convert import params_from_jax               # noqa: E402
from repro_torch.core.torchstate import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import loss_fn                        # noqa: E402

TOL = 1e-4
N_LAYERS = {"recurrentgemma_9b": 5}


def pair(arch, **kw):
    """(JAX config, port config) of ``arch``'s float32 smoke variant."""
    kw.setdefault("n_layers", N_LAYERS.get(arch, configs.smoke(arch)
                                           .n_layers))
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jconfigs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def make_batch(cfg, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.prefix_len:
        b["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)) * 0.1).astype(np.float32)
    return b


def torch_value_and_grad(cfg, params, batch):
    """(loss, gradient tree) of the port's ``loss_fn``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), params)
    loss = loss_fn(cfg, tree, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return float(loss.detach()), tree_map(lambda _: next(it), params)


def assert_grads_close(got, want, tol=TOL):
    got, want = paths(got), paths(want)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k].detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)


@pytest.mark.parametrize("chunked_ce", [0, 2])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_loss_and_grads_match_jax(arch, chunked_ce):
    jcfg, cfg = pair(arch, chunked_ce=chunked_ce)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    batch = make_batch(cfg)
    want_loss, want = jax.value_and_grad(
        lambda q: j_loss_fn(jcfg, q, jax.tree.map(jnp.asarray, batch)))(jp)
    loss, grads = torch_value_and_grad(cfg, p, batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=TOL, atol=TOL)
    assert_grads_close(grads, want)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "recurrentgemma_9b",
                                  "qwen3_moe_235b"])
def test_remat_gives_equal_gradients(arch):
    """``cfg.remat`` recomputes each scanned layer in the backward
    (``torch.utils.checkpoint``): the loss and gradients are those without
    it, up to the order gradients are summed in."""
    _, cfg = pair(arch)
    p = params_from_jax(jax.tree.map(np.asarray, j_init_params(
        pair(arch)[0], jax.random.PRNGKey(1))), cfg, device="cpu")
    batch = make_batch(cfg, seed=1)
    loss_on, g_on = torch_value_and_grad(
        dataclasses.replace(cfg, remat=True), p, batch)
    loss_off, g_off = torch_value_and_grad(
        dataclasses.replace(cfg, remat=False), p, batch)
    assert loss_on == loss_off
    assert_grads_close(g_on, g_off, tol=1e-6)


def test_chunked_ce_needs_whole_chunks():
    _, cfg = pair("qwen3_0_6b", chunked_ce=3)
    p = params_from_jax(jax.tree.map(np.asarray, j_init_params(
        pair("qwen3_0_6b")[0], jax.random.PRNGKey(0))), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    with pytest.raises(ValueError, match="does not divide"):
        loss_fn(cfg, p, batch)
