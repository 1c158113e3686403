"""Checkpoints across the two packages: a checkpoint written by either
restores in the other, with the same manifest (leaf paths, shapes, dtypes,
color, step).  ``quantize=False`` restores every leaf exactly (bf16 leaves
through float32); ``quantize=True`` restores each float leaf within half a
quantization step of the saved value (``dist.compression.error_bound``:
scale / 2, plus float32 rounding), both packages to the same numbers.  The
state is a bf16 smoke model's parameters and AdamW state after one update,
so every leaf is non-trivial."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt                        # noqa: E402
from repro import configs as jconfigs                        # noqa: E402
from repro.models import init_params as j_init_params        # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402

from repro_torch import checkpoint as ckpt                    # noqa: E402
from repro_torch import configs                               # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten        # noqa: E402
from repro_torch.convert import params_from_jax               # noqa: E402
from repro_torch.core.torchstate import tree_leaves, tree_map  # noqa: E402
from repro_torch.dist.compression import error_bound          # noqa: E402
from repro_torch.models import init_params                    # noqa: E402
from repro_torch.train import (OptConfig, TrainState,  # noqa: E402
                               shard_batch, synthetic_batches)


def _states():
    """The same (params, opt_state) as a JAX tree and as a port tree."""
    jcfg, cfg = jconfigs.smoke("qwen3_0_6b"), configs.smoke("qwen3_0_6b")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    jo = jopt.OptConfig()
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), jp)
    jp, js, _ = jopt.apply_updates(jo, jp, grads,
                                   jopt.init_opt_state(jo, jp))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    s = {"count": torch.tensor(int(js["count"]), dtype=torch.int32)}
    for key in ("mu", "nu"):                            # float32 moments
        s[key] = tree_map(
            lambda a: torch.from_numpy(np.array(a, np.float32)),
            jax.tree.map(np.asarray, js[key]))
    return (jp, js), (p, s)


def _as_f32(tree):
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    tree)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_in_either_package(tmp_path, writer, quantize):
    jtree, tree = _states()
    path = tmp_path / "ckpt"
    if writer == "jax":
        jckpt.save(path, jtree, color=7, step=7, quantize=quantize)
    else:
        ckpt.save(path, tree, color=7, step=7, quantize=quantize)
    # the other package writes the same manifest
    other = tmp_path / "other"
    (ckpt.save if writer == "jax" else jckpt.save)(
        other, tree if writer == "jax" else jtree, color=7, step=7,
        quantize=quantize)
    manifest = json.loads((tmp_path / "ckpt.json").read_text())
    assert manifest == json.loads((tmp_path / "other.json").read_text())
    assert manifest["color"] == 7 and manifest["step"] == 7

    got, m = ckpt.restore(path, tree)
    assert m == manifest
    jgot, _ = jckpt.restore(path, jtree)
    got, jgot = _flatten(got), _flatten(jgot)
    want = _flatten(tree)
    assert set(got) == set(jgot) == set(want) == set(manifest["leaves"])
    with np.load(str(path) + ".npz") as data:
        scales = {k[:-len("::scale")]: float(data[k]) for k in data.files
                  if k.endswith("::scale")}
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(jgot[k], np.float32),
                                      err_msg=k)
        if not manifest["leaves"][k].get("quantized"):
            torch.testing.assert_close(got[k], w, rtol=0, atol=0)
    if quantize:
        # the dequantized float32 values, before a cast back to bf16
        f32, _ = ckpt.restore(path, _as_f32(tree))
        for k, w in _flatten(tree).items():
            if manifest["leaves"][k].get("quantized"):
                err = float((_flatten(f32)[k].double() - w.double())
                            .abs().max())
                assert err <= error_bound(scales[k]), k
        assert any(e.get("quantized") for e in manifest["leaves"].values())


def test_manager_hook_fires_every_n_epochs(tmp_path):
    cfg = configs.smoke("qwen3_0_6b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    ts = TrainState(cfg, OptConfig(lr=3e-3, warmup=2, decay_steps=20),
                    params)
    mgr = ckpt.CheckpointManager(tmp_path, ts.state, every_n_epochs=2,
                                 keep=2)
    data = synthetic_batches(cfg.vocab, 2, 16)
    for _ in range(7):
        ts.step(shard_batch(None, next(data), device="cpu"))
    assert [c for c, _ in mgr.saved] == [4, 6]
    assert not (tmp_path / "ckpt_00000002.npz").exists()
    assert (tmp_path / "ckpt_00000006.json").exists()
    live = tree_leaves(ts.state.read())
    tree, manifest = mgr.restore_latest(ts.state.read())
    assert manifest["color"] == 6 and ts.color == 6
    assert int(tree[1]["count"]) == 6
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(tree), live))


def test_restore_onto_a_mesh_raises(tmp_path):
    """Restore onto a (1, 1) mesh of a one-rank gloo group: every leaf of
    the parameters comes back a DTensor placed by ``param_specs``, equal to
    the saved leaf; a spec that splits a dim over mesh dims out of the
    mesh's order has no DTensor layout and raises.  (Several ranks:
    ``tests/test_torch_dist.py``.)"""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.sharding import P, param_specs
    from repro_torch.launch.mesh import make_mesh

    _, tree = _states()
    ckpt.save(tmp_path / "c", tree)
    params = tree[0]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        specs = (param_specs(mesh, params),
                 tree_map(lambda leaf: None, tree[1]))
        got, manifest = ckpt.restore(tmp_path / "c", tree, mesh=mesh,
                                     specs=specs)
        for a, b in zip(tree_leaves(got[0]), tree_leaves(params)):
            assert isinstance(a, DTensor) and torch.equal(a.full_tensor(), b)
        for a, b in zip(tree_leaves(got[1]), tree_leaves(tree[1])):
            assert not isinstance(a, DTensor) and torch.equal(a, b)
        bad = (tree_map(lambda leaf: P(("model", "data")), params),
               specs[1])
        with pytest.raises(ValueError, match="mesh order"):
            ckpt.restore(tmp_path / "c", tree, mesh=mesh, specs=bad)
    finally:
        dist.destroy_process_group()
