"""int8 wire parity: the port's ``dist.compression`` gives the JAX
package's codes, scales and ``wire_bytes`` exactly (both round half to even
and compute the scale with the same float32 operations), for tensors and
for nested trees with stacked leaves."""

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


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_quantize_tree_identical(leaves):
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    mine = tree if leaves == "numpy" else tree_map(torch.from_numpy, tree)
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
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
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
