"""Adafactor's kernels on the CPU: the work split of ``csrc/adafactor.cu``'s
first pass (``kernels/adafactor.py::geometry`` and the kernel's unit and
partial indexing, mirrored here) covers each element once and adds up to
the plain version's sums; the wrapper refuses what the kernels do not
take; the CPU path launches nothing.  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``-m cuda``)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adafactor, ops, ref           # noqa: E402
from repro_torch.train import (OptConfig, apply_updates,        # noqa: E402
                               init_opt_state)

H100_SMS = 132
# (Bt, R, C) of the qwen3-moe-235b-a22b leaves at 3 layers: w_gate / w_up,
# w_down, wq, wk / wv, wo, the router, a stacked norm, embed, lm_head
MOE_VIEWS = [(384, 4096, 1536), (384, 1536, 4096), (12288, 64, 128),
             (12288, 4, 128), (192, 128, 4096), (3, 4096, 128), (1, 3, 4096),
             (1, 151936, 4096), (1, 4096, 151936)]


def _stats_mirror(g, vec, sms):
    """Pass 1 as the kernel indexes it: each unit u = (b nrs + s) nct + ct
    writes rowpart[(b R + r) nct + ct] for its rows and colpart[(b nrs +
    s) C + c] for its columns; then adafactor_reduce's sums.  Returns
    (rows (Bt, R), cols (Bt, C), the times each partial was written)."""
    Bt, R, C = adafactor.factored_view(tuple(g.shape))
    cp, rs, nct, nrs = adafactor.geometry(Bt, R, C, vec, sms)
    tile = cp * vec
    x2 = g.double().reshape(Bt, R, C).square().numpy()
    rowpart = np.zeros(Bt * R * nct)
    colpart = np.zeros(Bt * nrs * C)
    writes = [np.zeros(Bt * R * nct, int), np.zeros(Bt * nrs * C, int)]
    for u in range(Bt * nrs * nct):
        ct, t = u % nct, u // nct
        s, b = t % nrs, t // nrs
        r0, r1 = s * rs, min(R, s * rs + rs)
        c0, c1 = ct * tile, min(C, ct * tile + tile)
        rows = (b * R + np.arange(r0, r1)) * nct + ct
        rowpart[rows] = x2[b, r0:r1, c0:c1].sum(axis=1)
        writes[0][rows] += 1
        cols = (b * nrs + s) * C + np.arange(c0, c1)
        colpart[cols] = x2[b, r0:r1, c0:c1].sum(axis=0)
        writes[1][cols] += 1
    rowsum = rowpart.reshape(Bt * R, nct).sum(axis=1).reshape(Bt, R)
    colsum = colpart.reshape(Bt, nrs, C).sum(axis=1)
    return rowsum, colsum, writes


@pytest.mark.parametrize("shape,vec,sms", [
    ((3, 4, 16, 24), 8, 132), ((3, 4, 16, 24), 1, 132),
    ((48, 8), 8, 2), ((6, 40), 1, 132), ((3, 700, 5), 1, 4),
    ((2, 3, 33, 300), 1, 8), ((1000, 264), 8, 132), ((5, 1, 9), 1, 1)])
def test_first_pass_split_covers_each_element_once(shape, vec, sms):
    g = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    rows, cols, writes = _stats_mirror(g, vec, sms)
    assert all((w == 1).all() for w in writes)
    _, want_rows, want_cols = ref.adafactor_stats(g)
    np.testing.assert_allclose(rows.ravel(), want_rows.numpy().ravel(),
                               rtol=1e-6)
    np.testing.assert_allclose(cols.ravel(), want_cols.numpy().ravel(),
                               rtol=1e-6)


@pytest.mark.parametrize("view", MOE_VIEWS, ids=[str(v) for v in MOE_VIEWS])
@pytest.mark.parametrize("vec", [8, 1])
def test_geometry_at_the_moe_leaves(view, vec):
    """A tile is a power of two of threads across at most 32 (cp vec
    columns), a unit a multiple of the 256 / cp row groups, the units
    cover every row and column, spread over at least UNITS_PER_SM units an
    SM where the leaf has the rows for it, and, 8 columns a thread, the
    tile partials of the large leaves stay under 2% of the leaf's
    elements."""
    Bt, R, C = view
    cp, rs, nct, nrs = adafactor.geometry(Bt, R, C, vec, H100_SMS)
    rp = adafactor.THREADS // cp
    assert cp in (1, 2, 4, 8, 16, 32) and rs % rp == 0
    assert nct * cp * vec >= C > (nct - 1) * cp * vec
    assert nrs * rs >= R > (nrs - 1) * rs
    assert cp == 32 or cp * vec >= C
    units = Bt * nct * nrs
    assert units >= adafactor.UNITS_PER_SM * H100_SMS or rs == rp
    n = Bt * R * C
    if n > 2 ** 28 and vec == 8:
        assert Bt * R * nct + Bt * nrs * C < 0.02 * n


def test_large_leaf_offsets_need_64_bits():
    """The stacked expert leaf's elements pass 2^31: the kernels' offsets
    are 64-bit (``long long``), and the wrapper takes it."""
    Bt, R, C = adafactor.factored_view((3, 128, 4096, 1536))
    assert Bt * R * C > 2 ** 31 and max(Bt, R, C) < 2 ** 31


def _leaf(shape=(3, 16, 8), dtype=torch.bfloat16):
    p = torch.zeros(shape, dtype=dtype)
    vr_shape, vc_shape = adafactor._state_shapes(shape)
    return p, p.clone(), torch.zeros(vr_shape), torch.zeros(vc_shape)


@pytest.mark.parametrize("case", ["shape", "dtype", "state", "stride",
                                  "empty", "device"])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(case):
    p, g, vr, vc = _leaf()
    if case == "shape":
        g = torch.zeros((3, 16, 9), dtype=torch.bfloat16)
    elif case == "dtype":
        p, g = p.half(), g.half()
    elif case == "state":
        vr = torch.zeros((3, 1, 8))
    elif case == "stride":
        p = torch.zeros((3, 8, 16), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "empty":
        p, g, vr, vc = _leaf((0, 8))
    with pytest.raises(ValueError):
        adafactor.check(p, g, vr, vc)       # "device": all on the CPU


def test_state_shapes_are_the_optimizers():
    params = {"a": torch.zeros(7), "b": torch.zeros(3, 5),
              "c": torch.zeros(2, 3, 4, 6), "d": torch.zeros(())}
    state = init_opt_state(OptConfig(name="adafactor"), params)
    for k, p in params.items():
        want = adafactor._state_shapes(tuple(p.shape))
        assert (tuple(state["vr"][k].shape), tuple(state["vc"][k].shape)) \
            == want


def test_cpu_update_takes_the_plain_path_and_launches_nothing():
    cfg = OptConfig(name="adafactor", lr=1e-2, warmup=1)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 16, 8), generator=g).bfloat16(),
              "b": torch.randn(8, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype)
             for k, v in params.items()}
    before = {k: v.clone() for k, v in params.items()}
    ops.reset_launch_counts()
    _, state, metrics = apply_updates(cfg, params, grads,
                                      init_opt_state(cfg, params))
    assert ops.launch_counts()["adafactor"] == 0
    want = math.sqrt(sum(float(v.double().square().sum())
                         for v in grads.values()))
    assert float(metrics["grad_norm"]) == pytest.approx(want, rel=1e-6)
    assert all(not torch.equal(params[k], before[k]) for k in params)
    # step 1 decays nothing: vr holds the clipped gradient's row means
    scale = min(1.0, 1.0 / want)
    rows = (grads["w"].double() * scale).square().mean(-1, keepdim=True)
    np.testing.assert_allclose(state["vr"]["w"].numpy(), rows.numpy(),
                               rtol=1e-5)
