"""The CUDA kernels on the card, each held against its plain PyTorch
version on the same inputs (2e-3 in float32, 2e-2 in bf16: the same math
summed in another order, bf16 output rounding), and the model's kernel path
against its plain path.  Every test here needs a card and skips without
one; this file imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs                            # noqa: E402
from repro_torch.kernels import ops, ref                   # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa
                                init_params)

TOLS = {"float32": 2e-3, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,causal,hd", [
    (128, 128, True, 64), (1024, 1024, True, 128), (50, 50, True, 32),
    (64, 192, True, 128), (40, 96, False, 256)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, T, S, causal, hd):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((2, 8, T, hd), generator=g, device=cuda).to(dt)
    k = torch.randn((2, 4, S, hd), generator=g, device=cuda).to(dt)
    v = torch.randn((2, 4, S, hd), generator=g, device=cuda).to(dt)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_attention_matches_plain(cuda, dtype):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    B, S, Hkv, H, hd = 4, 2048, 8, 16, 128
    cache = torch.randn((2, B, S, Hkv, hd), generator=g, device=cuda).to(dt)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(dt)
    k, v = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    lens = torch.tensor([1, S, 777, 64], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    want = ref.decode_attention(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


@pytest.mark.cuda
def test_cuda_model_kernel_path_matches_plain_path(cuda):
    """Smoke qwen3 in float32: forward and a few decode steps through K1/K2
    against the same model with ``attn_impl="plain"`` on the card."""
    cfg = dataclasses.replace(configs.smoke("qwen3_0_6b"), dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="plain")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=cuda)
    ops.reset_launch_counts()
    got, _ = forward(cfg, params, {"tokens": toks})
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = forward(plain, params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=TOLS["float32"],
                               atol=TOLS["float32"])
    c_k, c_p = (init_cache(cfg, 2, 64, device=cuda) for _ in range(2))
    for t in range(3):
        lk, c_k = decode_step(cfg, params, c_k, toks[:, t:t + 1])
        lp, c_p = decode_step(plain, params, c_p, toks[:, t:t + 1])
        torch.testing.assert_close(lk, lp, rtol=TOLS["float32"],
                                   atol=TOLS["float32"])
    assert ops.launch_counts()["decode_attention"] == 3 * cfg.n_layers
