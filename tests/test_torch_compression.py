"""int8 wire parity: the port's ``dist.compression`` gives the JAX
package's codes, scales and ``wire_bytes`` exactly (both round half to even
and compute the scale with the same float32 operations), for tensors and
for nested trees with stacked leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import compression as jc                    # noqa: E402

from repro_torch.core.torchstate import tree_map            # noqa: E402
from repro_torch.dist import compression as tc              # noqa: E402


def _tree(rng):
    return {
        "embed": rng.standard_normal((96, 32)).astype(np.float32) * 0.02,
        "final_norm": rng.standard_normal((32,)).astype(np.float32),
        "layers": {                                     # stacked: (L, ...)
            "attn": {"wq": rng.standard_normal((3, 32, 4, 8))
                     .astype(np.float32)},
            "norm1": rng.standard_normal((3, 32)).astype(np.float32),
        },
        "tail": [rng.standard_normal((8, 8)).astype(np.float32),
                 np.arange(100, dtype=np.int32)],
    }


def _flat(tree, is_leaf):
    out = []

    def walk(t, path):
        if is_leaf(t):
            out.append((path, t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, t))
    walk(tree, "")
    return out


@pytest.mark.parametrize("axis", [None, 0, (1,)])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_quantize_int8_identical(axis, scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 40)) * scale).astype(np.float32)
    x[3, 5] = 0.5 * np.abs(x).max()           # a value near a half step
    jq, js = jc.quantize_int8(jnp.asarray(x), axis=axis)
    q, s = tc.quantize_int8(torch.from_numpy(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tc.dequantize_int8(q, s).numpy(),
        np.asarray(jc.dequantize_int8(jq, js)))


def test_quantize_int8_bf16_input_identical():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    jq, js = jc.quantize_int8(jnp.asarray(x, jnp.bfloat16))
    q, s = tc.quantize_int8(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_round_half_to_even_like_jnp():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    jq, _ = jc.quantize_int8(jnp.asarray(x))
    q, _ = tc.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def _model_tree(arch):
    """A bf16 smoke model's parameters from the JAX package (recurrentgemma
    with a tail) and the port's conversion of them, which keeps the
    reference's float32 leaves."""
    from repro import configs as jconfigs
    from repro.models import init_params as j_init_params
    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    kw = {"n_layers": 5} if arch == "recurrentgemma_9b" else {}
    jcfg = dataclasses.replace(jconfigs.smoke(arch), **kw)
    tree = jax.tree.map(np.asarray,
                        j_init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(configs.smoke(arch), **kw)
    return tree, params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("leaves", ["numpy", "torch", "rwkv6_3b",
                                    "recurrentgemma_9b"])
def test_quantize_tree_identical(leaves):
    rng = np.random.default_rng(2)
    if leaves in ("numpy", "torch"):
        tree = _tree(rng)
        mine = tree if leaves == "numpy" else tree_map(torch.from_numpy,
                                                       tree)
    else:
        tree, mine = _model_tree(leaves)
    jp = jc.quantize_tree(tree)
    tp = tc.quantize_tree(mine)
    assert tc.wire_bytes(tp) == jc.wire_bytes(jp)
    assert tc.wire_bytes(mine) == jc.wire_bytes(tree)
    jl, tl = (_flat(jp, jc._is_packed), _flat(tp, tc._is_packed))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        if jc._is_packed(a):
            assert tc._is_packed(b), path
            np.testing.assert_array_equal(b["q"].numpy(), np.asarray(a["q"]))
            np.testing.assert_array_equal(b["scale"].numpy(),
                                          np.asarray(a["scale"]))
        else:
            np.testing.assert_array_equal(np.asarray(torch.as_tensor(b)
                                                     .float()),
                                          np.asarray(a, np.float32))
    if leaves not in ("numpy", "torch"):
        # the float32 leaves quantize from float32 and dequantize back to it
        f32 = tp["layers"]["u"] if leaves == "rwkv6_3b" \
            else tp["tail"][0]["rec"]["lam"]
        assert f32["dtype"] == torch.float32
        assert tc.dequantize_tree(tp)["embed"].dtype == torch.bfloat16
        return
    # a stacked leaf gets one scale, as in the reference
    assert tp["layers"]["attn"]["wq"]["scale"].numel() == 1
    back = tc.dequantize_tree(tp)
    jback = jc.dequantize_tree(jp)
    np.testing.assert_array_equal(back["layers"]["attn"]["wq"].numpy(),
                                  np.asarray(jback["layers"]["attn"]["wq"]))
    assert back["embed"].dtype == torch.float32


def test_dequantize_keeps_bf16_dtype():
    x = torch.randn((8, 16), generator=torch.Generator().manual_seed(0))
    back = tc.dequantize_tree(tc.quantize_tree({"w": x.bfloat16()}))
    assert back["w"].dtype == torch.bfloat16
