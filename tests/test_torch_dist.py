"""The port's multi-device paths over gloo, held to the JAX package on the
same mesh shapes.

The port's side runs in gloo process groups of 1, 2, 4 and 8 CPU ranks
(``repro_torch.launch.mesh.spawn``), one launch per world size for every
check of that size; the reference's side runs in one JAX subprocess with 8
host devices (``--xla_force_host_platform_device_count``, as
``tests/test_pipeline.py`` does), both at once.  Inputs come from
``numpy.random.default_rng``, parameters from ``jax.random`` converted with
``repro_torch.convert``; everything is float32.

* the MoE's gather dispatch on (2, 2) and (1, 4) and its all-to-all
  dispatch on (1, 2) and (1, 4), at capacity factor 8 (no drops) and at
  the config's own (drops): y and aux at 2e-3 (``tests/test_perf_variants``),
  and the gradients of a loss through the gather dispatch on (2, 2) and
  through the all-to-all dispatch on (1, 2) and (1, 4), at 1e-4;
* the sharded-S decode (``decode_shard_s``, granite-34b smoke, 6 tokens)
  on (1, 2) and (2, 2): logits at 2e-3 and the gathered k/v shards, and
  the fall-back when S does not divide;
* ``pipeline_apply`` with 1, 2 and 4 stages against tanh chains and the
  reference, and its validation;
* ``shard_batch`` on (2, 2), ``ServeEngine`` on (1, 2) with
  ``decode_shard_s``, the ulysses forward on (1, 1);
* ``restore`` onto 2x4, 4x2 and 8x1, of the port's checkpoint and of the
  reference's, and the elastic reshard CLI.

The workers below run in spawned processes, which import this module:
it imports no JAX at its top.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_CFS = (8.0, 1.25)
DECODE_B, DECODE_LEN, DECODE_STEPS = 4, 64, 6
TOL = 2e-3                                  # tests/test_perf_variants.py


# --------------------------------------------------------------------------
#  the reference, in one JAX subprocess with 8 host devices
# --------------------------------------------------------------------------
REF = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.dist.pipeline import pipeline_apply
    from repro.models import decode_step, forward, init_cache, init_params
    from repro.models.moe import moe_params, moe_shardmap

    KEY = jax.random.PRNGKey(0)
    inp = dict(np.load(sys.argv[1]))
    B, LEN, STEPS, CFS = {consts}
    out = {{}}

    def mesh(shape, axes=("data", "model")):
        n = int(np.prod(shape))
        return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                             axis_types=(jax.sharding.AxisType.Auto,)
                             * len(axes))

    def moe(cfg, m):
        return jax.jit(lambda p, x: moe_shardmap(cfg, m, p, x))

    moe_cfg = configs.smoke("qwen3_moe_235b")
    p = moe_params(dataclasses.replace(moe_cfg, dtype="float32"), KEY,
                   jnp.float32)
    x = jnp.asarray(inp["moe_x"])
    for cf in CFS:
        cfg = dataclasses.replace(moe_cfg, dtype="float32",
                                  capacity_factor=cf)
        for shape in ((2, 2), (1, 4)):
            y, aux = moe(cfg, mesh(shape))(p, x)
            out[f"gather_{{shape}}_{{cf}}_y"] = np.asarray(y)
            out[f"gather_{{shape}}_{{cf}}_aux"] = np.asarray(aux)
        a2a = dataclasses.replace(cfg, moe_a2a=True)
        for shape in ((1, 2), (1, 4)):
            y, aux = moe(a2a, mesh(shape))(p, x)
            out[f"a2a_{{shape}}_{{cf}}_y"] = np.asarray(y)
            out[f"a2a_{{shape}}_{{cf}}_aux"] = np.asarray(aux)

    cfg = dataclasses.replace(moe_cfg, dtype="float32", capacity_factor=8.0)
    w = jnp.asarray(inp["moe_w"])
    def loss(p, x):
        y, aux = moe_shardmap(cfg, mesh((2, 2)), p, x)
        return jnp.sum(y * w) + aux
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    out["grad_x"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"grad_{{k}}"] = np.asarray(v)
    for shape in ((1, 2), (1, 4)):
        def a2a_loss(p, x, m=mesh(shape),
                     c=dataclasses.replace(cfg, moe_a2a=True)):
            y, aux = moe_shardmap(c, m, p, x)
            return jnp.sum(y * w) + aux
        gp, gx = jax.jit(jax.grad(a2a_loss, argnums=(0, 1)))(p, x)
        out[f"a2a_{{shape}}_grad_x"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"a2a_{{shape}}_grad_{{k}}"] = np.asarray(v)

    g = dataclasses.replace(configs.smoke("granite_34b"), dtype="float32",
                            decode_shard_s=True)
    gparams = init_params(g, KEY)
    toks = jnp.asarray(inp["decode_tokens"])
    for name, c, shape in (("(1, 2)", g, (1, 2)), ("(2, 2)", g, (2, 2)),
                           ("fallback", dataclasses.replace(g, attn_chunk=65),
                            (1, 2))):
        step = jax.jit(lambda p, cache, t, c=c, m=mesh(shape):
                       decode_step(c, p, cache, t, mesh=m))
        cache = init_cache(c, B, LEN)
        outs = []
        for t in range(STEPS):
            lg, cache = step(gparams, cache, toks[:, t:t + 1])
            outs.append(lg)
        out[f"decode_{{name}}"] = np.asarray(jnp.concatenate(outs, axis=1))
        out[f"decode_{{name}}_k"] = np.asarray(cache["layers"]["k"])
        out[f"decode_{{name}}_v"] = np.asarray(cache["layers"]["v"])

    for S in (2, 4):
        W = jnp.asarray(inp[f"pipe_w{{S}}"])
        y = pipeline_apply(lambda p, xb: jnp.tanh(xb @ p),
                           mesh((S,), ("pod",)), W, jnp.asarray(inp["pipe_x"]),
                           n_microbatches=4)
        out[f"pipe_{{S}}"] = np.asarray(y)

    from repro.train import OptConfig, init_opt_state, make_train_step
    from repro.train.data import synthetic_batches
    tcfg = dataclasses.replace(moe_cfg, dtype="float32", capacity_factor=8.0)
    opt = OptConfig(lr=1e-3, warmup=1, decay_steps=10)
    tp = init_params(tcfg, KEY)
    batch = next(synthetic_batches(tcfg.vocab, 4, 16))
    tp, _, met = jax.jit(make_train_step(tcfg, opt, mesh=mesh((2, 2))))(
        tp, init_opt_state(opt, tp),
        {{k: jnp.asarray(v) for k, v in batch.items()}})
    out["train_loss"] = np.asarray(met["loss"])
    out["train_grad_norm"] = np.asarray(met["grad_norm"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out["train_p/" + name] = np.asarray(leaf)

    gem = dataclasses.replace(configs.smoke("gemma_7b"), dtype="float32")
    lg, _ = forward(gem, init_params(gem, KEY),
                    {{"tokens": jnp.asarray(inp["uly_tokens"])}},
                    mesh=mesh((1, 1)))
    out["ulysses_base"] = np.asarray(lg)
    np.savez(sys.argv[2], **out)
    print("REF_OK")
""").format(consts=(DECODE_B, DECODE_LEN, DECODE_STEPS, MOE_CFS))


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {
        "moe_x": (rng.standard_normal((4, 16, 128)) * 0.3).astype(np.float32),
        "moe_w": rng.standard_normal((4, 16, 128)).astype(np.float32),
        "decode_tokens": rng.integers(0, 512, (DECODE_B, DECODE_STEPS))
        .astype(np.int32),
        "pipe_x": rng.standard_normal((8, 3, 4)).astype(np.float32),
        "pipe_w2": (rng.standard_normal((2, 4, 4)) * 0.5).astype(np.float32),
        "pipe_w4": (rng.standard_normal((4, 4, 4)) * 0.5).astype(np.float32),
        "uly_tokens": rng.integers(0, 512, (2, 32)).astype(np.int32),
    }


# --------------------------------------------------------------------------
#  the port, in gloo ranks (these run in spawned processes)
# --------------------------------------------------------------------------
def _moe_cfg(cf, **kw):
    from repro_torch import configs
    return dataclasses.replace(configs.smoke("qwen3_moe_235b"),
                               dtype="float32", capacity_factor=cf, **kw)


@functools.lru_cache(maxsize=None)
def _mesh(shape, axes=("data", "model")):
    """One mesh of each shape a rank uses (each new mesh makes process
    groups, a collective of every rank)."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes)


def _moe(out, inp, moe_p, gather_shapes, a2a_shapes):
    from repro_torch.models.moe import moe_shardmap
    p = {k: torch.from_numpy(v) for k, v in moe_p.items()}
    x = torch.from_numpy(inp["moe_x"])
    for cf in MOE_CFS:
        for kind, shapes in (("gather", gather_shapes), ("a2a", a2a_shapes)):
            for shape in shapes:
                cfg = _moe_cfg(cf, moe_a2a=kind == "a2a")
                y, aux = moe_shardmap(cfg, _mesh(shape), p, x)
                out[f"{kind}_{shape}_{cf}_y"] = y.numpy()
                out[f"{kind}_{shape}_{cf}_aux"] = aux.numpy()


def _moe_grads(out, inp, moe_p, kind="gather", shape=(2, 2)):
    """The gradients of one loss through ``moe_shardmap``'s ``kind``
    dispatch on ``shape``: keys ``grad_*`` for the gather dispatch,
    ``a2a_<shape>_grad_*`` for the all-to-all one."""
    from repro_torch.models.moe import moe_shardmap
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in moe_p.items()}
    x = torch.from_numpy(inp["moe_x"]).requires_grad_(True)
    y, aux = moe_shardmap(_moe_cfg(8.0, moe_a2a=kind == "a2a"),
                          _mesh(shape), p, x)
    (torch.sum(y * torch.from_numpy(inp["moe_w"])) + aux).backward()
    pre = "" if kind == "gather" else f"a2a_{shape}_"
    out[pre + "grad_x"] = x.grad.numpy()
    for k, v in p.items():
        out[f"{pre}grad_{k}"] = v.grad.numpy()


def _decode(out, inp, gparams, name, shape):
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.models import decode_step, init_cache
    cfg = dataclasses.replace(configs.smoke("granite_34b"), dtype="float32",
                              decode_shard_s=True)
    if name == "fallback":
        cfg = dataclasses.replace(cfg, attn_chunk=65)
    params = params_from_jax(gparams, cfg, device="cpu")
    mesh = _mesh(shape)
    cache = init_cache(cfg, DECODE_B, DECODE_LEN, device="cpu", mesh=mesh)
    toks = torch.from_numpy(inp["decode_tokens"])
    outs = []
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            lg, cache = decode_step(cfg, params, cache, toks[:, t:t + 1],
                                    mesh=mesh)
            outs.append(lg)
    out[f"decode_{name}"] = torch.cat(outs, dim=1).numpy()
    for key in ("k", "v"):
        leaf = cache["layers"][key]
        out[f"decode_{name}_{key}_local_shape"] = tuple(
            leaf.to_local().shape if isinstance(leaf, DTensor)
            else leaf.shape)
        out[f"decode_{name}_{key}"] = (
            leaf.full_tensor() if isinstance(leaf, DTensor) else leaf).numpy()


def _pipeline(out, inp, S):
    from repro_torch.dist.pipeline import pipeline_apply
    y = pipeline_apply(lambda p, xb: torch.tanh(xb @ p),
                       _mesh((S,), ("pod",)),
                       torch.from_numpy(inp[f"pipe_w{S}"]),
                       torch.from_numpy(inp["pipe_x"]), n_microbatches=4)
    out[f"pipe_{S}"] = y.numpy()


def _world1(inp, uly_params):
    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.models import forward
    out = {}
    cfg = dataclasses.replace(configs.smoke("gemma_7b"), dtype="float32")
    params = params_from_jax(uly_params, cfg, device="cpu")
    b = {"tokens": torch.from_numpy(inp["uly_tokens"])}
    mesh = _mesh((1, 1))
    with torch.no_grad():
        out["ulysses_base"] = forward(cfg, params, b, mesh=mesh)[0].numpy()
        out["ulysses"] = forward(dataclasses.replace(cfg, ulysses=True),
                                 params, b, mesh=mesh)[0].numpy()

    pod = _mesh((1,), ("pod",))
    x = torch.from_numpy(inp["pipe_x"])
    w = torch.full((1, 4, 4), 2.0)
    out["single_stage"] = pipeline_apply(lambda p, xb: xb @ p, pod, w, x,
                                         n_microbatches=4).numpy()
    w = torch.from_numpy(inp["pipe_w2"][:1])
    out["single_stage_m"] = [
        pipeline_apply(lambda p, xb: torch.tanh(xb @ p), pod, w, x,
                       n_microbatches=m).numpy() for m in (1, 2, 8)]
    errors = []
    for stages, xs, m in ((torch.ones((1, 4, 4)), torch.ones((6, 4)), 4),
                          (torch.ones((3, 4, 4)), torch.ones((6, 4)), 1),
                          (torch.ones((1, 4, 4)), torch.ones((6, 4)), 0)):
        try:
            pipeline_apply(lambda p, xb: xb @ p, pod, stages, xs,
                           n_microbatches=m)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["pipeline_errors"] = errors
    return out


def _world2(inp, moe_p, gparams):
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.torchstate import OwnedState
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    out = {"rank": dist.get_rank()}
    _moe(out, inp, moe_p, (), ((1, 2),))
    _moe_grads(out, inp, moe_p, "a2a", (1, 2))
    _decode(out, inp, gparams, "(1, 2)", (1, 2))
    _decode(out, inp, gparams, "fallback", (1, 2))
    _pipeline(out, inp, 2)

    cfg = dataclasses.replace(configs.smoke("qwen3_0_6b"), dtype="float32",
                              decode_shard_s=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (70, 5, 9, 66, 12, 3)]
    mesh = _mesh((1, 2))
    for key, m in (("engine_mesh", mesh), ("engine_plain", None)):
        eng = ServeEngine(cfg, OwnedState("weights", params), slots=4,
                          max_len=128, mesh=m, device="cpu")
        reqs = [eng.submit(p, max_new=8) for p in prompts]
        with torch.no_grad():
            eng.run(max_steps=500)
        out[key] = [list(r.generated) for r in reqs]
        out[key + "_cache_type"] = type(
            eng.cache["layers"]["k"]).__name__
    return out


def _world4(inp, moe_p, gparams, tparams):
    import torch.distributed as dist
    from repro_torch.dist.sharding import batch_specs
    from repro_torch.train.data import shard_batch, synthetic_batches
    out = {"rank": dist.get_rank()}
    _moe(out, inp, moe_p, ((2, 2), (1, 4)), ((1, 4),))
    _moe_grads(out, inp, moe_p)
    _moe_grads(out, inp, moe_p, "a2a", (1, 4))
    _decode(out, inp, gparams, "(2, 2)", (2, 2))
    _pipeline(out, inp, 4)

    mesh = _mesh((2, 2))
    batch = next(synthetic_batches(50, 8, 16, prefix_len=4, d_model=6))
    placed = shard_batch(mesh, batch)
    specs = batch_specs(mesh, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    out["batch"] = {k: (v.to_local().numpy(), v.full_tensor().numpy(),
                        tuple(specs[k]), [str(p) for p in v.placements])
                    for k, v in placed.items()}
    out["coord"] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    _train(out, mesh, tparams)
    return out


def _train(out, mesh, tparams):
    """One AdamW step of the MoE smoke model (no token dropped, remat on)
    on ``mesh`` from the reference's parameters, with a ``shard_batch``
    batch."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.convert import params_from_jax
    from repro_torch.train import (OptConfig, init_opt_state,
                                   make_train_step, shard_batch,
                                   synthetic_batches)
    cfg = _moe_cfg(8.0)
    opt = OptConfig(lr=1e-3, warmup=1, decay_steps=10)
    p = params_from_jax(tparams, cfg, device="cpu")
    batch = next(synthetic_batches(cfg.vocab, 4, 16))
    p, _, metrics = make_train_step(cfg, opt, mesh=mesh)(
        p, init_opt_state(opt, p), shard_batch(mesh, batch))
    out["train_loss"] = float(metrics["loss"])
    out["train_grad_norm"] = float(metrics["grad_norm"])
    out["train_p"] = {k: v.numpy() for k, v in _flatten(p).items()}


def _world8(ckpt_dir, ref_ckpt, ref_params):
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint import restore, save
    from repro_torch.convert import params_from_jax
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.dist.sharding import (is_spec, param_specs, place,
                                           to_placements)
    from repro_torch.launch.elastic import _same
    from repro_torch.models import init_params
    cfg = configs.smoke("qwen3_0_6b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    like = init_params(cfg, device="meta")
    a = _mesh((2, 4))
    save(f"{ckpt_dir}/port", place(params, param_specs(a, params), a),
         color=5)
    out = {"rank": dist.get_rank()}
    sources = {"port": (f"{ckpt_dir}/port", params),
               "reference": (ref_ckpt,
                             params_from_jax(ref_params, cfg, device="cpu"))}
    for shape in ((2, 4), (4, 2), (8, 1)):
        mesh = _mesh(shape)
        specs = param_specs(mesh, like)
        for src, (path, want) in sources.items():
            tree, manifest = restore(path, like, mesh=mesh, specs=specs)
            exact = placed = True
            spec_leaves = tree_leaves(specs, is_leaf=is_spec)
            for got, ref, spec in zip(tree_leaves(tree), tree_leaves(want),
                                      spec_leaves):
                placed &= tuple(got.placements) == tuple(
                    to_placements(mesh, spec))
                exact &= _same(got, ref)
            n_sharded = sum(any(e is not None for e in s)
                            for s in spec_leaves)
            out[f"{src}_{shape}"] = (exact, placed, manifest["color"],
                                     n_sharded)
    return out


# --------------------------------------------------------------------------
#  one run of everything
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint import save as jsave
    from repro.models import init_params as j_init_params
    from repro.models.moe import moe_params
    from repro_torch.launch.mesh import spawn

    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, str(d / "inputs.npz"), str(d / "ref.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        key = jax.random.PRNGKey(0)
        tree = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
        moe_cfg = dataclasses.replace(jconfigs.smoke("qwen3_moe_235b"),
                                      dtype="float32")
        moe_p = tree(moe_params(moe_cfg, key, jax.numpy.float32))
        gcfg = dataclasses.replace(jconfigs.smoke("granite_34b"),
                                   dtype="float32", decode_shard_s=True)
        gparams = tree(j_init_params(gcfg, key))
        ucfg = dataclasses.replace(jconfigs.smoke("gemma_7b"),
                                   dtype="float32")
        uparams = tree(j_init_params(ucfg, key))
        tparams = tree(j_init_params(moe_cfg, key))
        qparams = j_init_params(jconfigs.smoke("qwen3_0_6b"), key)
        jsave(d / "ref_ckpt", qparams, color=7)

        port = {
            1: spawn(_world1, 1, inp, uparams, timeout=300),
            2: spawn(_world2, 2, inp, moe_p, gparams, timeout=300),
            4: spawn(_world4, 4, inp, moe_p, gparams, tparams, timeout=300),
            8: spawn(_world8, 8, str(d), str(d / "ref_ckpt"), tree(qparams),
                     timeout=300),
        }
        stdout, stderr = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    return inp, dict(np.load(d / "ref.npz")), port


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


# --------------------------------------------------------------------------
#  the checks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("kind,shape", [("gather", (2, 2)),
                                        ("gather", (1, 4)),
                                        ("a2a", (1, 2)), ("a2a", (1, 4))])
def test_moe_shardmap_matches_the_reference(runs, kind, shape, cf):
    """y and aux on every rank of the mesh against the reference's
    ``moe_shardmap`` on the same mesh shape."""
    _, ref, port = runs
    ranks = port[int(np.prod(shape))]
    key = f"{kind}_{shape}_{cf}"
    for r in ranks:
        _close(r[key + "_y"], ref[key + "_y"])
        _close(r[key + "_aux"], ref[key + "_aux"])
    assert np.abs(ref[key + "_y"]).max() > 0.05


def test_moe_capacity_drops_differ_from_no_drops(runs):
    """The config's own capacity factor drops tokens (so the drop path
    is covered): its y differs from the no-drop y."""
    _, ref, port = runs
    y8, y1 = port[4][0]["gather_(2, 2)_8.0_y"], port[4][0][
        "gather_(2, 2)_1.25_y"]
    assert np.abs(y8 - y1).max() > 1e-2


def test_moe_gradients_through_the_gather_dispatch_match_jax_grad(runs):
    """On (2, 2), each rank's gradients of one loss through
    ``moe_shardmap`` (x and every expert leaf) equal ``jax.grad`` of the
    reference's."""
    _, ref, port = runs
    keys = [k for k in ref if k.startswith("grad_")]
    assert len(keys) == 5
    for r in port[4]:
        for k in keys:
            _close(r[k], ref[k], 1e-4)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_moe_gradients_through_the_a2a_dispatch_match_jax_grad(runs, shape):
    """On (1, 2) and (1, 4), each rank's gradients of one loss through
    ``moe_shardmap``'s all-to-all dispatch (the ragged grouped matmuls'
    plain version on the CPU; x, the router and every expert leaf) equal
    ``jax.grad`` of the reference's."""
    _, ref, port = runs
    keys = [k for k in ref if k.startswith(f"a2a_{shape}_grad_")]
    assert len(keys) == 5
    for r in port[int(np.prod(shape))]:
        for k in keys:
            _close(r[k], ref[k], 1e-4)
        assert np.abs(r[f"a2a_{shape}_grad_w_gate"]).max() > 0


@pytest.mark.parametrize("name,world", [("(1, 2)", 2), ("(2, 2)", 4),
                                        ("fallback", 2)])
def test_sharded_decode_matches_the_reference(runs, name, world):
    """Logits of 6 decode steps at 2e-3 and the cache (gathered from its
    shards) against the reference's ``decode_step(mesh=)``."""
    _, ref, port = runs
    for r in port[world]:
        _close(r[f"decode_{name}"], ref[f"decode_{name}"])
        for key in ("k", "v"):
            _close(r[f"decode_{name}_{key}"], ref[f"decode_{name}_{key}"])


def test_sharded_decode_keeps_the_cache_local(runs):
    """Each rank holds (L, B / dp, S / n_model, Hkv, hd) of k and v; the
    fall-back (S = 65 on two ranks) holds the whole cache."""
    _, ref, port = runs
    L, B, S, Hkv, hd = ref["decode_(1, 2)_k"].shape
    assert port[2][0]["decode_(1, 2)_k_local_shape"] == (L, B, S // 2, Hkv,
                                                         hd)
    assert port[4][0]["decode_(2, 2)_k_local_shape"] == (L, B // 2, S // 2,
                                                         Hkv, hd)
    fb = ref["decode_fallback_k"].shape
    assert fb[2] == 65
    assert port[2][1]["decode_fallback_k_local_shape"] == fb


@pytest.mark.parametrize("S,world", [(2, 2), (4, 4)])
def test_pipeline_matches_a_tanh_chain_and_the_reference(runs, S, world):
    inp, ref, port = runs
    want = inp["pipe_x"]
    for s in range(S):
        want = np.tanh(want @ inp[f"pipe_w{S}"][s])
    for r in port[world]:
        np.testing.assert_allclose(r[f"pipe_{S}"], want, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"pipe_{S}"], ref[f"pipe_{S}"],
                                   rtol=1e-4, atol=1e-5)


def test_pipeline_single_stage_and_microbatch_counts(runs):
    inp, _, port = runs
    w1 = port[1][0]
    np.testing.assert_allclose(w1["single_stage"], inp["pipe_x"] @ np.full(
        (4, 4), 2.0, np.float32), rtol=1e-5)
    outs = w1["single_stage_m"]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-6)


def test_pipeline_validates_microbatching_and_stages(runs):
    errors = runs[2][1][0]["pipeline_errors"]
    assert "not divisible into 4 microbatches" in errors[0]
    assert "no mesh axis of size 3" in errors[1]
    assert "not divisible into 0 microbatches" in errors[2]


def test_shard_batch_places_each_rank_its_slice(runs):
    """Each rank's local shard is the slice ``batch_specs`` assigns to its
    coordinates, and ``full_tensor()`` is the batch."""
    from repro_torch.train.data import synthetic_batches
    batch = next(synthetic_batches(50, 8, 16, prefix_len=4, d_model=6))
    sizes = {"data": 2, "model": 2}
    for r in runs[2][4]:
        for k, (local, full, spec, placements) in r["batch"].items():
            np.testing.assert_array_equal(full, batch[k])
            assert spec[0] == "data" and placements == ["S(0)", "R"]
            want = batch[k]
            for dim, axes in enumerate(spec):
                if axes is None:
                    continue
                axes = axes if isinstance(axes, tuple) else (axes,)
                idx, n = 0, 1
                for a in axes:
                    idx, n = idx * sizes[a] + r["coord"][a], n * sizes[a]
                size = want.shape[dim] // n
                want = np.take(want, range(idx * size, (idx + 1) * size),
                               axis=dim)
            np.testing.assert_array_equal(local, want)


def test_engine_on_a_mesh_serves_the_same_tokens(runs):
    """``ServeEngine`` on (1, 2) with ``decode_shard_s`` (its cache in
    DTensor shards) gives every rank the tokens of the engine without a
    mesh."""
    for r in runs[2][2]:
        assert r["engine_mesh_cache_type"] == "DTensor"
        assert r["engine_plain_cache_type"] == "Tensor"
        assert all(len(g) == 8 for g in r["engine_plain"])
        assert r["engine_mesh"] == r["engine_plain"]


def test_train_step_on_a_mesh_matches_the_reference(runs):
    """``make_train_step(mesh=)`` on (2, 2) through the MoE's sharded
    gather dispatch (a ``shard_batch`` batch, remat recomputing the
    collectives in the backward): every rank's loss (its aux averaged
    over the data shards, as the reference's), gradient norm and updated
    parameters against the reference's step on the same mesh, at the
    tolerances of ``test_torch_train.py::test_microbatch_step_matches_jax``
    (Adam's first step moves each weight by about lr times the sign of
    its gradient, so a gradient near zero may take either sign)."""
    _, ref, port = runs
    want = {k[len("train_p/"):]: v for k, v in ref.items()
            if k.startswith("train_p/")}
    for r in port[4]:
        np.testing.assert_allclose(r["train_loss"], ref["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["train_grad_norm"],
                                   ref["train_grad_norm"], rtol=1e-4)
        assert set(r["train_p"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["train_p"][k], v, rtol=5e-2,
                                       atol=5e-3, err_msg=k)


def test_ulysses_forward_matches_the_baseline(runs):
    """At (1, 1) the ulysses forward equals the baseline, which equals the
    reference's forward on the same mesh."""
    _, ref, port = runs
    w1 = port[1][0]
    np.testing.assert_allclose(w1["ulysses"], w1["ulysses_base"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(w1["ulysses_base"], ref["ulysses_base"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("src", ["port", "reference"])
def test_restore_onto_a_mesh_is_exact(runs, src, shape):
    """A checkpoint of the port's (saved from 2x4 DTensors) or of the
    reference's restores onto each mesh exactly, every leaf placed by its
    spec, with its epoch color."""
    for r in runs[2][8]:
        exact, placed, color, n_sharded = r[f"{src}_{shape}"]
        assert exact and placed
        assert color == (5 if src == "port" else 7)
        assert n_sharded > 0


@pytest.fixture(scope="module")
def elastic_cli():
    """``python -m repro_torch.launch.elastic --from-mesh 2x4 --to-mesh
    4x2`` and ``... 8x1``, both at once: each starts its own 8 gloo
    ranks."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("WORLD_SIZE", None)
    procs = {to: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.elastic",
         "--from-mesh", "2x4", "--to-mesh", to],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for to in ("4x2", "8x1")}
    try:
        return {to: (p.communicate(timeout=300), p.returncode)
                for to, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("to", ["4x2", "8x1"])
def test_elastic_reshard_cli_prints_ok(elastic_cli, to):
    """The CLI prints the reference's line
    (``tests/test_elastic_straggler.py:119-129``)."""
    (stdout, stderr), rc = elastic_cli[to]
    assert rc == 0, stdout[-1500:] + stderr[-1500:]
    shape = tuple(int(x) for x in to.split("x"))
    assert stdout.strip() == (f"elastic reshard (2, 4) -> {shape}: OK "
                              f"(epoch color 3)")
