"""The backward through the stacked layer leaves.  ``forward_hidden`` takes
each stacked leaf's layers with one ``torch.unbind``, so each leaf's
gradient is written into its stack once (``UnbindBackward0``), where
indexing one layer at a time (``SelectBackward0``) wrote a zeroed
full-stack tensor per layer and added it into the leaf.  The two paths add
the same numbers (the indexed path only adds exact zeros), so their
gradients are held equal with ``torch.equal``.  The decode cache keeps the
indexed views, which take in-place writes, and still matches the JAX
package (tolerance 1e-4, float32 on both sides).  Float32 smoke configs of
the four training families; recurrentgemma runs 5 layers, a scanned block
of 3 and an unrolled tail of 2."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                        # noqa: E402
from repro.models import decode_step as j_decode_step        # noqa: E402
from repro.models import init_cache as j_init_cache          # noqa: E402
from repro.models import init_params as j_init_params        # noqa: E402

from repro_torch import configs                               # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten as paths  # noqa
from repro_torch.convert import params_from_jax               # noqa: E402
from repro_torch.core.torchstate import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import decode_step, init_cache, loss_fn  # noqa
from repro_torch.models import transformer                    # noqa: E402

TOL = 1e-4
FAMILIES = ["qwen3_0_6b", "rwkv6_3b", "recurrentgemma_9b", "qwen3_moe_235b"]
N_LAYERS = {"recurrentgemma_9b": 5}


def _pair(arch, **kw):
    kw.setdefault("n_layers", N_LAYERS.get(arch, configs.smoke(arch)
                                           .n_layers))
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jconfigs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def _converted(arch, seed=0, **kw):
    jcfg, cfg = _pair(arch, **kw)
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")


def _batch(cfg, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])}


def _leaves_requiring_grad(params):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    return tree_map(lambda _: next(it), params), leaves


def _stacked_leaves(params):
    """The leaves of ``params["layers"]``: stacked (n_steps, ...) tensors."""
    return tree_leaves(params["layers"])


def _graph_nodes(root):
    seen, stack, out = set(), [root], []
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        out.append(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return out


def _scanned_by_index(cfg, tree, *, unbind=False):
    """The per-layer-indexing path, as ``forward_hidden`` took the scanned
    layers before: one ``tree[i]`` view per layer, whatever ``unbind``."""
    if not cfg.scan_layers:
        return list(tree)
    period = cfg.attn_every or 1
    groups = [tree] if period == 1 else tree
    n_steps = transformer._layer_plan(cfg)[0] // period
    return [transformer._index(groups[j], s) for s in range(n_steps)
            for j in range(period)]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_no_select_backward_on_a_stacked_leaf(arch, remat):
    """Every stacked leaf reaches the loss through one ``UnbindBackward0``
    and through no ``SelectBackward0``."""
    _, cfg, _, p = _converted(arch, remat=remat)
    assert cfg.scan_layers
    tree, _ = _leaves_requiring_grad(p)
    stacked = {id(t) for t in _stacked_leaves(tree)}
    loss = loss_fn(cfg, tree, _batch(cfg))
    unbound, selected = set(), set()
    for fn in _graph_nodes(loss.grad_fn):
        for nxt, _ in fn.next_functions:
            var = getattr(nxt, "variable", None)
            if var is None or id(var) not in stacked:
                continue
            if type(fn).__name__ == "SelectBackward0":
                selected.add(id(var))
            if type(fn).__name__ == "UnbindBackward0":
                unbound.add(id(var))
    assert not selected
    assert unbound == stacked


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_equal_the_per_layer_indexing_path(arch, monkeypatch):
    _, cfg, _, p = _converted(arch, seed=1)
    batch = _batch(cfg, seed=1)

    def grads():
        tree, leaves = _leaves_requiring_grad(p)
        loss = loss_fn(cfg, tree, batch)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss, got = grads()
    with monkeypatch.context() as m:
        m.setattr(transformer, "_scanned", _scanned_by_index)
        want_loss, want = grads()
    assert loss == want_loss
    names = list(paths(p))
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_updates_the_cache_in_place(arch):
    """Under grad mode, with parameters that require grad, each decode step
    writes into the cache's own tensors and gives the reference's logits
    and cache."""
    jcfg, cfg, jp, p = _converted(arch, seed=2)
    p, _ = _leaves_requiring_grad(p)
    rng = np.random.default_rng(2)
    B, T = 2, 4
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    jc = j_init_cache(jcfg, B, 64)
    c = init_cache(cfg, B, 64, device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(c["layers"])]
    before = [t.clone() for t in tree_leaves(c["layers"])]
    j_step = jax.jit(functools.partial(j_decode_step, jcfg))
    for t in range(T):
        want, jc = j_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, c = decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=f"step {t}")
    after = tree_leaves(c["layers"])
    assert [t.data_ptr() for t in after] == ptrs
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    mine = paths({"layers": c["layers"], "tail": c["tail"]})
    theirs = paths(jax.tree.map(np.asarray, {"layers": jc["layers"],
                                             "tail": jc["tail"]}))
    assert set(mine) == set(theirs)
    for k, w in theirs.items():
        np.testing.assert_allclose(mine[k].detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=TOL,
                                   atol=TOL, err_msg=k)
