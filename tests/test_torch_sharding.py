"""The port's sharding rules and pipeline schedule held to the JAX package's
(``repro.dist.sharding``, ``repro.dist.pipeline``): every leaf's spec of
every config, on odd and production-sized meshes, under every rule flag,
compared as tuples, plus the cases of ``tests/test_dist.py``.  No process
group is started: the spec functions take stand-in meshes."""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import pipeline as jpipeline  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import init_opt_state as j_init_opt  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist import pipeline, sharding  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402

KEY = jax.random.PRNGKey(0)

MESHES = {
    "3x5": dict(data=3, model=5),
    "7x2": dict(data=7, model=2),
    "3x2x9": dict(pod=3, data=2, model=9),
    "1x1": dict(data=1, model=1),
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
}
FLAGS = [{}, {"dp_only": True}, {"serve_weights": True}, {"ulysses": True}]
NO_FLAGS = dict(ulysses=False, dp_only=False, serve_weights=False)


def fake_mesh(**shape):
    return types.SimpleNamespace(shape=shape)


def teardown_function(_fn=None):
    for mod in (jsh, sharding):
        mod.set_mesh(None)
        mod.set_rule_flags(**NO_FLAGS)


def _set_flags(**flags):
    jsh.set_rule_flags(**flags)
    sharding.set_rule_flags(**flags)


def _flat_ref(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _flat_port(specs, prefix="") -> dict:
    if isinstance(specs, sharding.PartitionSpec):
        return {prefix: tuple(specs)}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """The reference's abstract trees and the port's meta trees of one
    smoke config: params, AdamW and Adafactor states, cache, batch."""
    jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
    jp = jax.eval_shape(lambda k: j_init_params(jcfg, k), KEY)
    pp = init_params(cfg, device="meta")
    opts = {}
    for name in ("adamw", "adafactor"):
        opts[name] = (jax.eval_shape(
            lambda p: j_init_opt(JOptConfig(name=name), p), jp),
            init_opt_state(OptConfig(name=name), pp))
    cache = (jax.eval_shape(lambda: j_init_cache(jcfg, 4, 128)),
             init_cache(cfg, 4, 128, device="meta"))
    shapes = {"tokens": (16, 64), "labels": (16, 64)}
    if cfg.prefix_len:
        shapes["prefix_embeds"] = (16, cfg.prefix_len, cfg.d_model)
    batch = ({k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, s in shapes.items()},
             {k: torch.empty(s, device="meta") for k, s in shapes.items()})
    return jp, pp, opts, cache, batch


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["none", "dp_only", "serve_weights", "ulysses"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_spec_matches_the_reference(arch, mesh, flags):
    """param, optimizer-state (AdamW and Adafactor), batch and cache specs,
    leaf by leaf, as tuples."""
    jp, pp, opts, (jc, pc), (jb, pb) = _trees(arch)
    m = fake_mesh(**MESHES[mesh])
    _set_flags(**flags)
    pairs = [(jsh.param_specs(m, jp), sharding.param_specs(m, pp)),
             (jsh.batch_specs(m, jb), sharding.batch_specs(m, pb)),
             (jsh.cache_specs(m, jc), sharding.cache_specs(m, pc))]
    for jo, po in opts.values():
        pairs.append((jsh.opt_state_specs(m, jo, jp),
                      sharding.opt_state_specs(m, po, pp)))
    for ref, port in pairs:
        want = _flat_ref(ref)
        assert want
        assert _flat_port(port) == want


def _check_divisible(mesh, tree, specs):
    flat_specs = _flat_port(specs)
    flat = {}
    sharding._map_with_path(
        lambda path, leaf: flat.__setitem__(sharding._path_str(path), leaf),
        tree)
    assert set(flat) == set(flat_specs)
    for k, leaf in flat.items():
        for dim, axes in zip(sharding._shape(leaf), flat_specs[k]):
            if axes is None:
                continue
            n = 1
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                n *= mesh.shape[a]
            assert dim % n == 0, f"{k}: {leaf.shape} vs {flat_specs[k]}"


@pytest.mark.parametrize("shape", [MESHES[k] for k in
                                   ("3x5", "7x2", "3x2x9", "1x1")])
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen3_moe_235b", "rwkv6_3b",
                                  "recurrentgemma_9b"])
def test_param_specs_fit_odd_meshes(shape, arch):
    """Every rule degrades to a dividing (or replicated) spec on meshes
    whose sizes share no factor with the tensor dims."""
    m = fake_mesh(**shape)
    pp = _trees(arch)[1]
    _check_divisible(m, pp, sharding.param_specs(m, pp))


@pytest.mark.parametrize("spec,shape", [
    ((("model", "data")), (8,)), (((("data", "model"),)), (8,)),
    ((("data",)), (8, 8)), (((("pod", "data"), None)), (12, 5)),
    ((("model", ("data", "pod"))), (10, 6))])
def test_fit_matches_the_reference(spec, shape):
    """Absent axes drop, a longer spec truncates, a tuple keeps its
    longest dividing prefix."""
    m = fake_mesh(data=4, pod=3)
    want = jsh._fit(m, JP(*spec), shape)
    got = sharding._fit(m, P(*spec), shape)
    assert tuple(got) == tuple(want)
    assert sharding._fit(m, P("model", "data"), (8,)) == P(None)
    assert sharding._fit(m, P(("data", "model")), (8,)) == P(("data",))
    assert sharding._fit(m, P("data"), (8, 8)) == P("data", None)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_specs_tie_moments_to_params(name):
    m = fake_mesh(data=2, model=4)
    _, pp, opts, _, _ = _trees("qwen3_0_6b")
    po = opts[name][1]
    specs = sharding.opt_state_specs(m, po, pp)
    assert specs["count"] == P()
    key = [k for k in po if k != "count"][0]
    _check_divisible(m, po[key], specs[key])
    if name == "adafactor":
        # collapsed factored dims (size 1) must never stay sharded
        flat = {}
        sharding._map_with_path(
            lambda path, leaf: flat.__setitem__(sharding._path_str(path),
                                                leaf), po["vr"])
        fs = _flat_port(specs["vr"])
        for k, leaf in flat.items():
            for dim, axes in zip(leaf.shape, fs[k]):
                assert not (dim == 1 and axes is not None)


def test_cache_specs_shard_sequence_over_model():
    m = fake_mesh(data=2, model=4)
    pc = _trees("qwen3_0_6b")[3][1]
    _check_divisible(m, pc, sharding.cache_specs(m, pc))
    k = {"k": torch.empty((4, 128, 4, 32), device="meta")}
    spec = sharding.cache_specs(m, k)["k"]
    want = jsh.cache_specs(m, {"k": jax.ShapeDtypeStruct((4, 128, 4, 32),
                                                         jnp.bfloat16)})["k"]
    assert tuple(spec) == tuple(want)
    assert spec[1] == "model" and spec[0] in (("data",), "data")


def test_cache_specs_dp_only_never_duplicates_axes():
    """Under dp_only the batch spreads over every axis; the sequence dim
    must not reuse ``model`` (``to_placements`` rejects a mesh dim named
    twice, as NamedSharding does)."""
    m = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    _set_flags(dp_only=True)
    k = {"k": torch.empty((4, 128, 4, 32), device="meta")}
    spec = sharding.cache_specs(m, k)["k"]
    assert tuple(spec) == tuple(jsh.cache_specs(
        fake_mesh(data=1, model=1),
        {"k": jax.ShapeDtypeStruct((4, 128, 4, 32), jnp.bfloat16)})["k"])
    placements = sharding.to_placements(m, spec)
    assert [str(p) for p in placements] == ["S(0)", "S(0)"]
    with pytest.raises(ValueError, match="twice"):
        sharding.to_placements(m, P("model", "model"))


def test_serve_weights_flag_drops_fsdp_axes():
    m = fake_mesh(data=8, model=4)
    jp, pp = _trees("gemma_7b")[:2]
    _set_flags(serve_weights=True)
    specs = sharding.param_specs(m, pp)
    assert _flat_port(specs) == _flat_ref(jsh.param_specs(m, jp))
    for spec in _flat_port(specs).values():
        for axes in spec:
            axes = axes if isinstance(axes, tuple) else (axes,)
            assert "data" not in axes and "pod" not in axes


def test_ulysses_flag_shards_sequence_in_batch_specs():
    m = fake_mesh(data=2, model=4)
    b = {"tokens": torch.empty((8, 64), dtype=torch.int32, device="meta")}
    jb = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32)}
    assert sharding.batch_specs(m, b)["tokens"][1] is None
    _set_flags(ulysses=True)
    uly = sharding.batch_specs(m, b)["tokens"]
    assert uly[1] == "model"
    assert tuple(uly) == tuple(jsh.batch_specs(m, jb)["tokens"])


@pytest.mark.parametrize("dp_only,shape", [
    (False, (9, 25, 7)), (False, (8, 24, 7)), (True, (15, 25, 7)),
    (False, ()), (False, (6,))])
def test_activation_spec_matches_the_reference(dp_only, shape):
    m = fake_mesh(data=3, model=5)
    _set_flags(dp_only=dp_only)
    assert tuple(sharding.activation_spec(m, shape)) == \
        tuple(jsh.activation_spec(m, shape))
    if shape == (9, 25, 7) and not dp_only:
        assert sharding.activation_spec(m, shape) == \
            P(("data",), "model", None)


def test_ulysses_heads_and_shard_act_are_the_identity_off_a_mesh():
    x = torch.ones((2, 8, 4, 16))
    assert sharding.ulysses_heads(x) is x
    assert sharding.shard_act(x) is x
    # a plain tensor is replicated already: returned as it is on a mesh too
    assert sharding.shard_act(x, fake_mesh(data=2, model=2)) is x


def test_set_rule_flags_rejects_unknown():
    with pytest.raises(ValueError):
        sharding.set_rule_flags(zeRO=True)
    assert sharding.rule_flags() == jsh.rule_flags()


def test_dp_only_rules_shard_first_dim_at_full_size():
    """At gemma-7b's published widths on a 16x16 mesh (the reference's
    ``test_dp_only_rules_shard_first_dim``), every leaf's ZeRO-3 spec."""
    m = fake_mesh(data=16, model=16)
    _set_flags(dp_only=True)
    jp = jax.eval_shape(lambda k: j_init_params(jconfigs.get("gemma_7b"), k),
                        KEY)
    pp = init_params(configs.get("gemma_7b"), device="meta")
    specs = sharding.param_specs(m, pp)
    assert _flat_port(specs) == _flat_ref(jsh.param_specs(m, jp))
    wg = specs["layers"]["mlp"]["w_gate"]
    assert "model" in (wg[1] if isinstance(wg[1], tuple) else (wg[1],))


def test_partition_spec_normalises_like_jax():
    for entries in [(("data",),), (("pod", "data"),), ((),), (None, "x")]:
        assert tuple(P(*entries)) == tuple(JP(*entries))


def test_to_placements_orders_tuple_entries_by_the_mesh():
    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                              shape=(2, 2, 2))
    got = sharding.to_placements(m, P(("pod", "data"), "model"))
    assert [str(p) for p in got] == ["S(0)", "S(0)", "S(1)"]
    assert [str(p) for p in sharding.to_placements(m, P(None, None))] == \
        ["R", "R", "R"]
    with pytest.raises(ValueError, match="mesh order"):
        sharding.to_placements(m, P(("data", "pod")))


# ----------------------------------------------------------------- pipeline
@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_bubble_accounting_matches_the_reference(S):
    for M in (1, 2, 4, 8, 16, 64):
        assert pipeline.schedule_steps(S, M) == jpipeline.schedule_steps(S, M)
        assert pipeline.bubble_stage_steps(S, M) == \
            jpipeline.bubble_stage_steps(S, M)
        assert pipeline.bubble_fraction(S, M) == \
            jpipeline.bubble_fraction(S, M)


def test_bubble_accounting():
    assert pipeline.schedule_steps(1, 4) == 4
    assert pipeline.schedule_steps(4, 8) == 11
    assert pipeline.bubble_stage_steps(1, 4) == 0
    assert pipeline.bubble_stage_steps(4, 8) == 4 * 3
    assert pipeline.bubble_fraction(1, 16) == 0.0
    np.testing.assert_allclose(pipeline.bubble_fraction(4, 8), 3 / 11)
    # more microbatches shrink the bubble monotonically
    fracs = [pipeline.bubble_fraction(4, m) for m in (1, 2, 4, 16, 64)]
    assert all(a > b for a, b in zip(fracs, fracs[1:]))


@pytest.mark.parametrize("shape,n", [({"pod": 2, "data": 2}, 2),
                                     ({"data": 4, "model": 2}, 2),
                                     ({"data": 4, "model": 3}, 3),
                                     ({"data": 4}, 4)])
def test_pick_axis_matches_the_reference(shape, n):
    m = fake_mesh(**shape)
    assert pipeline._pick_axis(m, n, None) == jpipeline._pick_axis(m, n, None)
    with pytest.raises(ValueError):
        pipeline._pick_axis(m, 5, None)
