"""Training parity on the CPU: optimizer updates, the schedule, gradient
clipping, microbatch accumulation and the synthetic data stream of the port
against the JAX package (float32, rtol 1e-6 where the arithmetic is the
same step for step), and ``TrainState`` as ``tests/test_train_serve.py``
drives the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                        # noqa: E402
from repro.models import init_params as j_init_params        # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro.train import synthetic_batches as j_batches       # noqa: E402

from repro_torch import configs                               # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten as _paths  # noqa
from repro_torch.convert import params_from_jax               # noqa: E402
from repro_torch.core.torchstate import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import init_params                    # noqa: E402
from repro_torch.train import (OptConfig, TrainState,  # noqa: E402
                               apply_updates, init_opt_state,
                               make_train_step, shard_batch,
                               synthetic_batches)
from repro_torch.train import optimizer as opt_mod            # noqa: E402

RTOL = 1e-6


def _tree(rng):
    """A parameter-shaped tree: a matrix, stacked layer leaves (3-D and
    2-D), a vector in an unrolled tail."""
    return {"embed": rng.standard_normal((24, 16)),
            "layers": {"w": rng.standard_normal((3, 16, 8)) * 0.1,
                       "norm": rng.standard_normal((3, 16)) * 0.01},
            "tail": [{"b": rng.standard_normal((8,))}]}


def _both(tree):
    """The numpy tree as float32 JAX arrays and as float32 tensors."""
    return (jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
            tree_map(lambda a: torch.from_numpy(a.astype(np.float32)), tree))


def _assert_tree_close(got, want, rtol=RTOL, atol=1e-8):
    got, want = _paths(got), _paths(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            torch.as_tensor(got[k]).float().numpy(),
            np.asarray(want[k], np.float32), rtol=rtol, atol=atol,
            err_msg=k)


@pytest.mark.parametrize("name,moment_dtype", [("adamw", "float32"),
                                               ("adamw", "bfloat16"),
                                               ("adafactor", "float32")])
def test_updates_match_jax(name, moment_dtype):
    """Three updates from the same parameters and gradients (the second
    above the clipping norm) give the reference's parameters, state and
    metrics.  Each update is written in place into the port's trees."""
    kw = dict(name=name, moment_dtype=moment_dtype, lr=1e-2, warmup=2,
              decay_steps=5)
    jcfg, cfg = jopt.OptConfig(**kw), OptConfig(**kw)
    rng = np.random.default_rng(0)
    jp, p = _both(_tree(rng))
    js, s = jopt.init_opt_state(jcfg, jp), init_opt_state(cfg, p)
    for step, gscale in enumerate((0.1, 30.0, 0.5)):
        jg, g = _both(jax.tree.map(lambda a: a * gscale, _tree(rng)))
        jp, js, jm = jopt.apply_updates(jcfg, jp, jg, js)
        p2, s2, m = apply_updates(cfg, p, g, s)
        assert p2 is p and s2 is s
        _assert_tree_close(p, jp)
        _assert_tree_close(s, js)
        assert int(s["count"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL)


# Adafactor's leaf kinds: (shape, dtype); the layouts of the MoE's leaves
ADAFACTOR_LEAVES = {
    "vector": ((40,), "bfloat16"),                  # unfactored: vr whole
    "tall": ((48, 8), "bfloat16"),                  # R > C
    "wide": ((6, 40), "bfloat16"),                  # C > R
    "stacked4d": ((3, 4, 16, 24), "bfloat16"),      # (layers, experts, R, C)
    "float32": ((3, 16, 8), "float32"),             # the router's dtype
}


@pytest.mark.parametrize("kind", list(ADAFACTOR_LEAVES))
def test_adafactor_leaf_kinds_match_jax(kind):
    """Three Adafactor updates of one leaf of each kind beside a float32
    matrix (the second step above the clipping norm) through the plain
    version of the card's three passes (``kernels/ref.py``: scale^2 taken
    out of the row and column means) give the reference's gradient norm at
    4e-6 and state at 1e-5 (float32 sums of a leaf of a thousand squares
    in two orders differ by about 1e-6, and vr and vc carry scale^2), and
    its parameters within one ulp of their dtype (bf16's 2^-8 relative,
    float32's 1e-6)."""
    shape, dtype = ADAFACTOR_LEAVES[kind]
    kw = dict(name="adafactor", lr=1e-2, warmup=2, decay_steps=5)
    jcfg, cfg = jopt.OptConfig(**kw), OptConfig(**kw)
    rng = np.random.default_rng(3)

    def tree():
        return {"w": rng.standard_normal(shape) * 0.1,
                "m": rng.standard_normal((10, 12))}

    def both(t):
        jt, tt = _both(t)
        jt["w"] = jt["w"].astype(getattr(jnp, dtype))
        tt["w"] = tt["w"].to(getattr(torch, dtype))
        return jt, tt

    jp, p = both(tree())
    js, s = jopt.init_opt_state(jcfg, jp), init_opt_state(cfg, p)
    ptol = 2.0 ** -8 if dtype == "bfloat16" else RTOL
    for gscale in (0.1, 30.0, 0.5):
        jg, g = both(jax.tree.map(lambda a: a * gscale, tree()))
        jp, js, jm = jopt.apply_updates(jcfg, jp, jg, js)
        m = apply_updates(cfg, p, g, s)[2]
        assert p["w"].dtype == getattr(torch, dtype)
        _assert_tree_close(p, jp, rtol=ptol)
        _assert_tree_close(s, js, rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=4e-6)


def test_schedule_matches_jax():
    kw = dict(lr=3e-3, warmup=10, decay_steps=100, min_lr_frac=0.1)
    jcfg, cfg = jopt.OptConfig(**kw), OptConfig(**kw)
    for step in (0, 1, 10, 100, 150):
        np.testing.assert_allclose(
            float(opt_mod.schedule(cfg, step)),
            float(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32))),
            rtol=RTOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    jg, g = _both(_tree(np.random.default_rng(1)))
    np.testing.assert_allclose(float(opt_mod.global_norm(g)),
                               float(jopt.global_norm(jg)), rtol=RTOL)
    clipped, norm = opt_mod.clip_by_global_norm(g, max_norm)
    jclipped, jnorm = jopt.clip_by_global_norm(jg, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    _assert_tree_close(clipped, jclipped)
    assert float(opt_mod.global_norm(clipped)) <= max_norm * (1 + 1e-6)


def _f32_setup():
    jcfg = dataclasses.replace(jconfigs.smoke("qwen3_0_6b"), dtype="float32")
    cfg = dataclasses.replace(configs.smoke("qwen3_0_6b"), dtype="float32")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    opt = dict(lr=3e-3, warmup=2, decay_steps=50)
    return jcfg, cfg, jp, opt


def _port_params(jp, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def test_microbatch_grads_match_full_batch():
    """As the reference's test of the same name, with its tolerances: one
    step with 4 microbatches against one with the full batch."""
    _, cfg, jp, kw = _f32_setup()
    opt = OptConfig(**kw)
    batch = shard_batch(None, next(synthetic_batches(cfg.vocab, 8, 32)),
                        device="cpu")
    results = []
    for micro in (1, 4):
        p = _port_params(jp, cfg)
        p, _, m = make_train_step(cfg, opt, microbatches=micro)(
            p, init_opt_state(opt, p), batch)
        results.append((p, m))
    (p1, m1), (p4, m4) = results
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-2)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2,
                                   atol=5e-3)


def test_microbatch_step_matches_jax():
    """One step with 4 microbatches against the reference's
    ``make_train_step(..., microbatches=4)``: loss and gradient norm at the
    model tests' 1e-4, parameters at the reference microbatch test's
    tolerances (Adam's first step moves each weight by about lr times the
    sign of its gradient, so a gradient near zero may take either sign)."""
    jcfg, cfg, jp, kw = _f32_setup()
    jo, opt = jopt.OptConfig(**kw), OptConfig(**kw)
    batch = next(synthetic_batches(cfg.vocab, 8, 32))
    jp2, _, jm = jax.jit(j_make_train_step(jcfg, jo, microbatches=4))(
        jp, jopt.init_opt_state(jo, jp), jax.tree.map(jnp.asarray, batch))
    p = _port_params(jp, cfg)
    p, _, m = make_train_step(cfg, opt, microbatches=4)(
        p, init_opt_state(opt, p), shard_batch(None, batch, device="cpu"))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4)
    _assert_tree_close(p, jp2, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("prefix_len", [0, 8])
def test_synthetic_batches_match_jax(prefix_len):
    """Three batches: the same tokens and labels; the prefix embeddings
    are the same draws (float32 here, bf16 there: numpy has no bf16)."""
    kw = dict(seed=3, prefix_len=prefix_len, d_model=16)
    got = synthetic_batches(97, 4, 12, **kw)
    want = j_batches(97, 4, 12, **kw)
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        if prefix_len:
            np.testing.assert_array_equal(
                torch.from_numpy(g["prefix_embeds"]).bfloat16().float(),
                np.asarray(w["prefix_embeds"], np.float32))


def test_shard_batch_places_on_a_device_and_refuses_a_mesh(tmp_path):
    """Off a mesh: tensors on the device.  On the (1, 1) mesh of a
    one-rank gloo group: DTensors laid out by ``batch_specs`` whose
    ``full_tensor()`` is the batch.  A mesh the process group cannot fill
    is refused.  (Several ranks: ``tests/test_torch_dist.py``.)"""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh

    batch = next(synthetic_batches(50, 2, 8))
    placed = shard_batch(None, batch, device="cpu")
    assert placed["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(placed["labels"].numpy(), batch["labels"])
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        on_mesh = shard_batch(mesh, batch)
        for k, v in on_mesh.items():
            assert isinstance(v, DTensor)
            assert [str(p) for p in v.placements] == ["S(0)", "R"]
            np.testing.assert_array_equal(v.full_tensor().numpy(), batch[k])
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_mesh((2, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _setup(**opt_kw):
    cfg = configs.smoke("qwen3_0_6b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, params, OptConfig(lr=3e-3, warmup=2, decay_steps=50,
                                  **opt_kw)


def _losses(ts, cfg, steps, B, T):
    data = synthetic_batches(cfg.vocab, B, T)
    return [float(ts.step(shard_batch(None, next(data), device="cpu"))
                  ["loss"]) for _ in range(steps)]


def test_train_state_loss_decreases():
    cfg, params, opt = _setup()
    ts = TrainState(cfg, opt, params)
    losses = _losses(ts, cfg, 12, 8, 64)
    assert losses[-1] < losses[0], f"no improvement: {losses}"
    assert ts.color == 12               # one epoch per step


def test_adafactor_runs_and_improves():
    cfg, params, opt = _setup(name="adafactor")
    ts = TrainState(cfg, opt, params)
    losses = _losses(ts, cfg, 10, 8, 64)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_adafactor_memory_factored():
    _, params, _ = _setup()

    def nbytes(state):
        return sum(t.numel() * t.element_size() for t in tree_leaves(state))
    fac = init_opt_state(OptConfig(name="adafactor"), params)
    adam = init_opt_state(OptConfig(name="adamw"), params)
    assert nbytes(fac) < nbytes(adam) * 0.1   # factored moments are tiny


def test_backup_promotion_restores_epoch():
    cfg, params, opt = _setup()
    ts = TrainState(cfg, opt, params)
    ts.replicate()
    _losses(ts, cfg, 1, 4, 32)
    good = tree_leaves(ts.params())[0].clone()
    color = ts.color
    # corrupt the live buffers out of band (a crash is not a write epoch)
    for t in tree_leaves(ts.state._tree):
        t.zero_()
    assert ts.restore_from_backup() == color
    torch.testing.assert_close(tree_leaves(ts.params())[0], good, rtol=0,
                               atol=0)
    assert int(ts.state.read()[1]["count"]) == 1


def test_train_step_keeps_callers_requires_grad():
    """The step differentiates through aliases of the parameters: the
    caller's tensors keep ``requires_grad`` False (so they serve under
    ``torch.no_grad()`` as before) and are updated in place."""
    cfg, params, opt = _setup()
    before = tree_leaves(params)[0].clone()
    step = make_train_step(cfg, opt)
    batch = shard_batch(None, next(synthetic_batches(cfg.vocab, 2, 16)),
                        device="cpu")
    p, _, _ = step(params, init_opt_state(opt, params), batch)
    assert p is params
    assert not any(t.requires_grad for t in tree_leaves(params))
    assert not torch.equal(tree_leaves(params)[0], before)


def test_train_driver_runs_on_the_cpu(tmp_path, capsys):
    """``launch/train.py`` on the smoke config: checkpoints every 2 epochs,
    a failure injected at step 3 (the backup's promotion keeps the epoch),
    and one traced step."""
    from repro_torch.launch import train
    losses = train.main(["--device", "cpu", "--steps", "6", "--batch", "2",
                         "--seq", "32", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "2", "--fail-at", "3",
                         "--profile", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert "injecting failure at step 3" in out
    assert '"profile_steps": 1' in out
    assert "checkpoints: 3, latest color 6" in out
    assert sorted(p.name for p in tmp_path.glob("*.json")) == [
        "ckpt_00000002.json", "ckpt_00000004.json", "ckpt_00000006.json"]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "qwen3-moe-235b-a22b"])
def test_launch_train_takes_each_family(arch, capsys):
    """``launch/train.py`` trains the RWKV6, RG-LRU and MoE families (on
    the card through K4, K5 and K2, K3 and K2 and their backward kernels)
    with the options their full sizes need on one card: Adafactor, no
    epoch backup, the loss in sequence chunks."""
    from repro_torch.launch import train
    losses = train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--optimizer",
                         "adafactor", "--no-backup", "--chunked-ce", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "optimizer=adafactor" in out
