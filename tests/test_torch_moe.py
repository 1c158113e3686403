"""MoE parity: the port's ``moe_gmm`` (K3's plain version on the CPU) and
``models.moe`` against the JAX package, inputs made with numpy from a seed.

``moe_gmm`` is held against the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and the reference's oracle at the
shapes and tolerances of ``tests/test_kernels.py``; ragged shapes, which
the Pallas grid floor-divides away, against the oracle alone.
``moe_block`` and an arctic layer with its dense residual are held in
float32 at 1e-4 (the same math summed in another order), with converted
parameters, including batches where the capacity drops tokens and experts
that get fewer tokens than their capacity.  ``moe_gmm``'s ``rows`` (the
live rows of each expert) is held against the Pallas kernel and the oracle
with the rows past it zeroed, and ``moe_block``'s use of it against the
routing's ``keep`` mask.  ``tests/test_torch_cuda.py`` holds K3 itself
against its plain version on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                      # noqa: E402
from repro.kernels import ops as jops                      # noqa: E402
from repro.kernels import ref as jref                      # noqa: E402
from repro.models import init_params as j_init_params      # noqa: E402
from repro.models import moe as j_moe                      # noqa: E402
from repro.models import transformer as j_transformer      # noqa: E402

from repro_torch import configs                            # noqa: E402
from repro_torch.convert import params_from_jax            # noqa: E402
from repro_torch.kernels import ops, ref                   # noqa: E402
from repro_torch.models import layers, moe                 # noqa: E402
from repro_torch.models import transformer                 # noqa: E402

TOL = 1e-4
MOE = ["qwen3_moe_235b", "arctic_480b"]


def arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
#  moe_gmm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,d,f", [
    (1, 64, 128, 64), (2, 128, 256, 128), (4, 64, 256, 64),
    (2, 128, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_matches_pallas(e, c, d, f, dtype):
    """The shapes of ``test_moe_gmm_property`` / ``test_moe_gmm_dtypes``,
    at their tolerances (rtol 2e-3, atol 2e-2; 5e-2 in bf16)."""
    rng = np.random.default_rng(0)
    x, w = arr(rng, e, c, d), arr(rng, e, d, f)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    got = ops.moe_gmm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (e, c, f)
    rtol, atol = (5e-2, 5e-1) if dtype == "bfloat16" else (2e-3, 2e-2)
    for want in (jops.moe_gmm(jx, jw, block_c=64, block_f=64, block_d=64),
                 jref.moe_gmm(jx, jw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("e,c,d,f", [
    (3, 5, 37, 11), (2, 80, 100, 130), (1, 1, 1, 1), (4, 4, 4100, 9)])
def test_moe_gmm_ragged_matches_reference_oracle(e, c, d, f):
    """C, D and F that no block divides: the Pallas grid floor-divides
    them away, so the oracle decides."""
    rng = np.random.default_rng(1)
    x, w = arr(rng, e, c, d), arr(rng, e, d, f)
    got = ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.moe_gmm(jnp.asarray(x),
                                                       jnp.asarray(w))),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("e,c,d,f,rows", [
    (4, 64, 128, 64, [0, 17, 64, 40]), (2, 128, 128, 128, [128, 1]),
    (3, 64, 128, 64, [0, 0, 0]), (2, 64, 128, 64, [64, 64])])
def test_moe_gmm_rows_matches_pallas(e, c, d, f, rows):
    """``rows``: each expert's first rows[e] rows are the Pallas kernel's
    and the oracle's, the rest are zeros; rows 0, partial and C, float32 at
    1e-5 (D = 128: a float32 sum of 128 unit products, reordered, stays
    well inside it; at D = 256 one element in 32,768 moves by 1.2e-5)."""
    rng = np.random.default_rng(2)
    x, w = arr(rng, e, c, d), arr(rng, e, d, f)
    r = torch.tensor(rows, dtype=torch.int32)
    got = ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w), r).numpy()
    live = np.arange(c)[None, :, None] < np.asarray(rows)[:, None, None]
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for want in (jops.moe_gmm(jx, jw, block_c=64, block_f=64, block_d=64),
                 jref.moe_gmm(jx, jw)):
        np.testing.assert_allclose(got, np.where(live, np.asarray(want), 0),
                                   rtol=1e-5, atol=1e-5)
    assert not got[~np.broadcast_to(live, got.shape)].any()
    torch.testing.assert_close(                 # rows = C is rows = None
        ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w),
                    torch.full((e,), c, dtype=torch.int32)),
        ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w)), rtol=0,
        atol=0)


def test_moe_gmm_wrapper_validates_inputs():
    from repro_torch.kernels import moe_gmm as k3
    x, w = torch.zeros((2, 4, 8)), torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        k3.check(x, w)                                 # CPU tensors
    with pytest.raises(ValueError, match="want x"):
        k3.check(x, torch.zeros((2, 9, 16)))
    with pytest.raises(ValueError, match="dtypes"):
        k3.check(x.half(), w.half())
    with pytest.raises(ValueError, match="dtypes"):
        k3.check(x.bfloat16(), w)
    with pytest.raises(ValueError, match="unit stride"):
        k3.check(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="nonempty"):
        k3.check(torch.zeros((2, 0, 8)), w)
    with pytest.raises(ValueError, match="rows"):
        k3.check(x, w, torch.zeros((2,), dtype=torch.int64))
    with pytest.raises(ValueError, match="rows"):
        k3.check(x, w, torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        ops.moe_gmm(x.to("meta"), w.to("meta"))
    assert "moe_gmm" in ops.launch_counts()


# ---------------------------------------------------------------------------
#  moe_block
# ---------------------------------------------------------------------------
def f32_pair(arch):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype="float32"),
            dataclasses.replace(configs.smoke(arch), dtype="float32"))


def layer0(arch, seed=0):
    """Layer 0 of the converted smoke model: (jcfg, cfg, JAX layer params,
    port layer params)."""
    jcfg, cfg = f32_pair(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"]),
            transformer._index(p["layers"], 0))


@pytest.mark.parametrize("n", [1, 3, 4, 16, 25, 100, 1024])
def test_capacity_matches_reference(n):
    for arch in MOE:
        for cfg in (configs.get(arch), configs.smoke(arch)):
            jcfg = dataclasses.replace(jconfigs.get(arch), n_experts=cfg
                                       .n_experts, top_k=cfg.top_k)
            assert moe._capacity(cfg, n) == j_moe._capacity(jcfg, n)
    assert moe._capacity(configs.get("qwen3_moe_235b"), 1024) == 80
    assert moe._capacity(configs.get("qwen3_moe_235b"), 4) == 4


def _loads(cfg, p, x):
    """Tokens routed to each expert (before the capacity drop)."""
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    ids = torch.topk(probs, cfg.top_k, dim=-1).indices
    return torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,T,cf", [
    (1, 4, 1.25), (2, 16, 1.25), (2, 64, 1.25), (4, 100, 1.25),
    (2, 16, 0.5), (4, 100, 0.5)])          # cf 0.5: the capacity binds
def test_moe_block_matches_jax(arch, B, T, cf):
    jcfg, cfg, jl, pl = layer0(arch)
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=cf)
                 for c in (jcfg, cfg))
    x = arr(np.random.default_rng(B * T), B, T, cfg.d_model)
    want, waux = j_moe.moe_block(jcfg, jl["moe"], jnp.asarray(x))
    got, aux = moe.moe_block(cfg, pl["moe"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL, atol=TOL)
    loads, C = _loads(cfg, pl["moe"], x), moe._capacity(cfg, B * T)
    if cf < 1:
        assert int(loads.max()) > C       # the capacity drops tokens
    else:
        assert int(loads.min()) < C       # an expert with fewer than C


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_jax(arch):
    """One whole layer through ``_block``: attention, the MoE and, for
    arctic, the dense residual MLP beside it; y and the layer's aux."""
    jcfg, cfg, jl, pl = layer0(arch, seed=3)
    assert ("mlp" in pl) == cfg.dense_residual
    B, T = 2, 96
    x = arr(np.random.default_rng(4), B, T, cfg.d_model)
    pos = np.arange(T, dtype=np.int32)
    want, _, waux = j_transformer._block(jcfg, jl, jnp.asarray(x),
                                         jnp.asarray(pos), None, None, 0)
    got, aux = transformer._block(cfg, pl, torch.from_numpy(x),
                                  torch.from_numpy(pos), None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL, atol=TOL)


def test_moe_block_runs_three_grouped_matmuls(monkeypatch):
    """The card's path: gate, up and down as three ``ops.moe_gmm`` calls
    over the (E, C, D) capacity buffers, and none with
    ``attn_impl="plain"``."""
    jcfg, cfg, jl, pl = layer0("qwen3_moe_235b")
    calls = []

    def counting(x, w, rows):
        calls.append((tuple(x.shape), tuple(w.shape), rows))
        return ref.moe_gmm(x, w, rows)
    monkeypatch.setattr(ops, "moe_gmm", counting)
    monkeypatch.setattr(layers, "use_kernels",
                        lambda c, x: c.attn_impl != "plain")
    x = torch.from_numpy(arr(np.random.default_rng(5), 2, 16, cfg.d_model))
    y, _ = moe.moe_block(cfg, pl["moe"], x)
    E, C, D, F = cfg.n_experts, moe._capacity(cfg, 32), cfg.d_model, cfg.e_ff
    assert [c[:2] for c in calls] == [((E, C, D), (E, D, F))] * 2 + [
        ((E, C, F), (E, F, D))]
    keep = moe._route(cfg, pl["moe"], x.reshape(32, D))[3]
    for c in calls:             # each expert's kept count, as int32
        assert c[2].dtype == torch.int32
        assert torch.equal(c[2], keep.sum(1, dtype=torch.int32))
    plain, _ = moe.moe_block(dataclasses.replace(cfg, attn_impl="plain"),
                             pl["moe"], x)
    assert len(calls) == 3
    torch.testing.assert_close(y, plain, rtol=0, atol=0)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,T,cf", [(1, 4, 1.25), (4, 100, 1.25),
                                    (4, 100, 0.5)])
def test_moe_route_keeps_a_prefix(arch, B, T, cf):
    """What K3's ``rows`` relies on: each expert's kept slots are a prefix
    of its capacity buffer, keep[e, :rows[e]] all true and the rest false,
    with and without capacity drops."""
    jcfg, cfg, jl, pl = layer0(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x = arr(np.random.default_rng(B * T + 1), B * T, cfg.d_model)
    keep = moe._route(cfg, pl["moe"], torch.from_numpy(x))[3]
    rows = keep.sum(1)
    prefix = torch.arange(keep.shape[1])[None, :] < rows[:, None]
    assert torch.equal(keep, prefix)
    assert int(rows.min()) < keep.shape[1] or cf < 1   # some partial rows
    if cf < 1:
        assert int(rows.max()) == keep.shape[1]          # and full ones


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,T,cf", [(2, 16, 1.25), (4, 100, 0.5)])
def test_moe_block_rows_changes_nothing(arch, B, T, cf, monkeypatch):
    """``moe_block`` gives the same output, bit for bit, when its matmuls
    ignore ``rows`` and compute every slot."""
    jcfg, cfg, jl, pl = layer0(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x = torch.from_numpy(arr(np.random.default_rng(B * T + 2), B, T,
                             cfg.d_model))
    got, aux = moe.moe_block(cfg, pl["moe"], x)
    plain_gmm = ref.moe_gmm
    monkeypatch.setattr(ref, "moe_gmm", lambda x, w, rows: plain_gmm(x, w))
    want, want_aux = moe.moe_block(cfg, pl["moe"], x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)


def test_moe_block_bf16_sums_in_float32():
    """In bf16 the port adds the experts' outputs in float32 and rounds
    once; it stays within bf16 rounding of the float32 block."""
    jcfg, cfg, jl, pl = layer0("qwen3_moe_235b")
    x = torch.from_numpy(arr(np.random.default_rng(6), 2, 16, cfg.d_model))
    want, _ = moe.moe_block(cfg, pl["moe"], x)
    pb = {k: (v if k == "router" else v.bfloat16())
          for k, v in pl["moe"].items()}
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    got, _ = moe.moe_block(bcfg, pb, x.bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_moe_params_keep_the_reference_layout():
    """Router (D, E) float32 in a bf16 model, experts (E, D, F) / (E, F, D)
    in the config's dtype, stacked over layers; no ``mlp`` leaf without
    the dense residual."""
    for arch in MOE:
        cfg = configs.smoke(arch)
        p = transformer.init_params(cfg, device="meta")["layers"]
        L, D, E, F = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.e_ff
        assert p["moe"]["router"].shape == (L, D, E)
        assert p["moe"]["router"].dtype == torch.float32
        assert p["moe"]["w_gate"].shape == p["moe"]["w_up"].shape \
            == (L, E, D, F)
        assert p["moe"]["w_down"].shape == (L, E, F, D)
        assert p["moe"]["w_down"].dtype == torch.bfloat16
        assert ("mlp" in p) == cfg.dense_residual
