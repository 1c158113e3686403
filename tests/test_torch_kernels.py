"""Kernel parity.  On the CPU the port's ``ops`` take the plain versions in
``repro_torch.kernels.ref``; they are held against the JAX package's
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and
its ``ref`` oracles, at the shapes of ``tests/test_kernels.py``.  Tolerance
2e-3 in float32 and 2e-2 in bf16, as those tests use (the same math summed
in another order; bf16 rounds the output).

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops                      # noqa: E402
from repro.kernels import ref as jref                      # noqa: E402

from repro_torch.kernels import ops                        # noqa: E402

TOLS = {"float32": 2e-3, "bfloat16": 2e-2}


def arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def both(x, dtype):
    """The same numpy input for each package, in ``dtype``."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("B,H,Hkv,T,hd,bq,bk", [
    (1, 2, 2, 128, 64, 64, 64),       # MHA
    (2, 4, 2, 256, 64, 128, 128),     # GQA
    (1, 4, 1, 128, 128, 64, 64),      # MQA
    (1, 2, 2, 192, 64, 64, 64),       # non-power-of-two T
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, H, Hkv, T, hd, bq, bk, dtype):
    rng = np.random.default_rng(0)
    jq, q = both(arr(rng, B, H, T, hd), dtype)
    jk, k = both(arr(rng, B, Hkv, T, hd), dtype)
    jv, v = both(arr(rng, B, Hkv, T, hd), dtype)
    got = ops.flash_attention(q, k, v)
    close(got, jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk),
          dtype)
    close(got, jref.attention(jq, jk, jv), dtype)


def test_flash_attention_noncausal():
    rng = np.random.default_rng(1)
    jq, q = both(arr(rng, 1, 2, 64, 64), "float32")
    jk, k = both(arr(rng, 1, 2, 64, 64), "float32")
    jv, v = both(arr(rng, 1, 2, 64, 64), "float32")
    got = ops.flash_attention(q, k, v, causal=False)
    close(got, jops.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                    block_k=32), "float32")
    close(got, jref.attention(jq, jk, jv, causal=False), "float32")


@pytest.mark.parametrize("T,S,causal", [
    (64, 192, True),      # T < S: bottom-right aligned causal mask
    (50, 50, True),       # ragged T (no block size divides it)
    (37, 101, True),      # ragged T < ragged S
    (40, 96, False),      # non-causal, T != S
])
def test_flash_attention_shapes_beyond_pallas(T, S, causal):
    """Cases the Pallas grid cannot take (its causal mask is top-left
    aligned and it floor-divides ragged tails): the oracle decides."""
    rng = np.random.default_rng(2)
    jq, q = both(arr(rng, 2, 4, T, 32), "float32")
    jk, k = both(arr(rng, 2, 2, S, 32), "float32")
    jv, v = both(arr(rng, 2, 2, S, 32), "float32")
    close(ops.flash_attention(q, k, v, causal=causal),
          jref.attention(jq, jk, jv, causal=causal), "float32")


@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (2, 4, 2, 256, 64),
    (1, 8, 1, 512, 128),              # MQA long cache
    (3, 6, 6, 128, 64),
])
def test_decode_attention_matches_pallas(B, H, Hkv, S, hd):
    rng = np.random.default_rng(3)
    jq, q = both(arr(rng, B, H, hd), "float32")
    jk, k = both(arr(rng, B, Hkv, S, hd), "float32")
    jv, v = both(arr(rng, B, Hkv, S, hd), "float32")
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens))
    close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                     block_k=128), "float32")
    close(got, jref.decode_attention(jq, jk, jv, jnp.asarray(lens)),
          "float32")


def test_decode_attention_strided_cache_views():
    """The model hands K1 permuted views of its (B,S,Hkv,hd) cache."""
    rng = np.random.default_rng(4)
    B, S, Hkv, H, hd = 2, 96, 2, 4, 32
    cache_k = arr(rng, B, S, Hkv, hd)
    cache_v = arr(rng, B, S, Hkv, hd)
    _, q = both(arr(rng, B, H, hd), "bfloat16")
    k = torch.from_numpy(cache_k).bfloat16().permute(0, 2, 1, 3)
    v = torch.from_numpy(cache_v).bfloat16().permute(0, 2, 1, 3)
    assert not k.is_contiguous() and k.stride(-1) == 1
    lens = torch.tensor([1, S], dtype=torch.int32)
    close(ops.decode_attention(q, k, v, lens),
          jref.decode_attention(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                                jnp.asarray(cache_k, jnp.bfloat16)
                                .transpose(0, 2, 1, 3),
                                jnp.asarray(cache_v, jnp.bfloat16)
                                .transpose(0, 2, 1, 3),
                                jnp.asarray(lens.numpy())), "bfloat16")


def test_ops_refuse_other_devices():
    q = torch.zeros((1, 2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)


def test_kernel_wrappers_validate_inputs():
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    q = torch.zeros((1, 4, 8, 32))
    k = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        k2.check(q, k, k, True)                       # CPU tensors
    with pytest.raises(ValueError, match="head dim"):
        k2.check(torch.zeros((1, 4, 8, 48)), torch.zeros((1, 2, 8, 48)),
                 torch.zeros((1, 2, 8, 48)), True)
    with pytest.raises(ValueError, match="T <= S"):
        k2.check(torch.zeros((1, 4, 9, 32)), k, k, True)
    with pytest.raises(ValueError, match="dtypes"):
        k2.check(q.half(), k.half(), k.half(), True)
    with pytest.raises(ValueError, match="int32"):
        k1.check(q[:, :, 0], k, k, torch.zeros((1,), dtype=torch.int64))
    with pytest.raises(ValueError, match="stride"):
        k2.check(q, k, k.transpose(2, 3).contiguous().transpose(2, 3), False)
