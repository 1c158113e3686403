"""The frozen counts against numbers worked by hand, and against the
port's ``kernels/cost.py``: equal where the two agree (K2), and the
difference stated where they do not (K3's capacity rows, K4's chunk
terms, the parameters ``mfu`` counted)."""

from __future__ import annotations

import dataclasses

import pytest

from perfbench import counts, spec


def test_k2_by_hand():
    # B=1, H=2, Hkv=1, T=4, hd=8: 10 causal pairs a head
    assert counts.causal_pairs(4) == 10
    assert counts.k2_fwd(1, 2, 1, 4, 8) == (4 * 10 * 2 * 8,
                                            2 * (2 * 2 * 4 * 8 + 2 * 4 * 8)
                                            + 4 * 2 * 4)
    assert counts.k2_bwd(1, 2, 1, 4, 8) == (10 * 10 * 2 * 8,
                                            2 * (4 * 2 * 4 * 8 + 4 * 4 * 8)
                                            + 4 * 2 * 4)


@pytest.mark.parametrize("shape", [(2, 64, 4, 4096, 128), (4, 16, 8, 4096, 128),
                                   (1, 3, 1, 17, 16)])
def test_k2_equals_the_ports_count(shape):
    from repro_torch.kernels import cost
    B, H, Hkv, T, hd = shape
    fwd = cost.flash_attention(B, H, Hkv, T, T, hd, "bfloat16",
                               with_lse=True)
    bwd = cost.flash_attention_bwd(B, H, Hkv, T, T, hd, "bfloat16")
    assert counts.k2_fwd(B, H, Hkv, T, hd) == (fwd.flops, fwd.bytes)
    assert counts.k2_bwd(B, H, Hkv, T, hd) == (bwd.flops, bwd.bytes)


def test_k3_by_hand_and_against_capacity():
    from repro_torch.kernels import cost
    # 6 routed pairs, 2 experts, 3 -> 5
    assert counts.k3_fwd(6, 2, 3, 5) == (2 * 6 * 3 * 5,
                                         2 * (6 * 8 + 2 * 3 * 5))
    assert counts.k3_bwd(6, 2, 3, 5) == (4 * 6 * 3 * 5,
                                         2 * (2 * 6 * 3 + 6 * 5 + 2 * 2 * 3 * 5))
    # the port counts every capacity slot (E C rows) without ``rows``; the
    # frozen count the routed pairs: at the MoE cell 65,536 against 81,920
    E, C, D, F = 128, 640, 4096, 1536
    pairs = 2 * 4096 * 8
    port = cost.moe_gmm(E, C, D, F, "bfloat16")
    ours = counts.k3_fwd(pairs, E, D, F)
    assert port.flops - ours[0] == 2 * (E * C - pairs) * D * F


def test_k4_by_hand_and_against_the_chunk_form():
    from repro_torch.kernels import cost
    B, H, T, M = 1, 1, 2, 4
    assert counts.k4_fwd(B, H, T, M) == (
        2 * (5 * 16 + 16), 2 * 4 * (6 + 8) + 4 * 4 + 16 * 4)
    assert counts.k4_bwd(B, H, T, M)[0] == 2 * counts.k4_fwd(B, H, T, M)[0]
    # the port's backward reads the forward's float32 chunk-start states
    # (64 x 64 a chunk of 64 a head); the frozen count does not
    B, H, T, M = 2, 40, 4096, 64
    port = cost.rwkv_scan_bwd(B, H, T, M, "bfloat16")
    ours = counts.k4_bwd(B, H, T, M)
    assert port.bytes - ours[1] == B * H * (T // 64) * 64 * 64 * 4
    # and counts the chunk form's multiply-adds, not the recurrence's
    assert cost.rwkv_scan(B, H, T, M, "bfloat16").flops != \
        counts.k4_fwd(B, H, T, M)[0]


def _model(name):
    return spec.load_cell(name).config


def test_model_flops_by_hand():
    moe = _model("moe-train-b2t4096")["model"]
    per_layer = 71_303_168 + 4096 * 128 + 8 * 3 * 4096 * 1536
    assert counts.matmul_params(moe) == 3 * per_layer + 4096 * 151936
    attn = 12 * 2 * 4096 * 4097 // 2 * 64 * 128 * 3
    assert counts.model_flops(moe, 2, 4096) == \
        6 * counts.matmul_params(moe) * 8192 + attn
    dense = _model("dense-train-b4t4096")["model"]
    assert counts.matmul_params(dense) == 28 * (
        2 * 1024 * 16 * 128 + 2 * 1024 * 8 * 128 + 3 * 1024 * 3072) \
        + 1024 * 151936
    rwkv = _model("rwkv6-train-b2t4096")["model"]
    assert counts.model_flops(rwkv, 2, 4096) == 6 * 8192 * (
        32 * (6 * 2560 ** 2 + 2 * 2560 * 32 + 2 * 2560 * 8960)
        + 2560 * 65536)


@pytest.mark.parametrize("name", ["moe-train-b2t4096", "dense-train-b4t4096",
                                  "rwkv6-train-b2t4096"])
def test_mfu_parameters_against_the_ports(name):
    """``active_param_count`` (the ``mfu`` of ``chip_smoke.py``) counts
    the untied input embedding and the norms, which do no matrix
    product; for RWKV it counts its own guess of the block."""
    from repro_torch import configs
    m = _model(name)["model"]
    cfg = dataclasses.replace(configs.get(_model(name)["arch"]),
                              n_layers=m["n_layers"])
    d, L, V = m["d_model"], m["n_layers"], m["vocab"]
    diff = cfg.active_param_count() - counts.matmul_params(m)
    embed = 0 if m["tie_embeddings"] else V * d
    if m["family"] == "rwkv":
        ff = m["d_ff"]
        port_layer = 5 * d * d + 2 * d + 12 * d * 32 + 2 * d * ff \
            + d * d // 8 + 2 * d
        ours_layer = 6 * d * d + 2 * d * 32 + 2 * d * ff
        assert diff == embed + d + L * (port_layer - ours_layer)
    else:
        assert diff == embed + d + L * 2 * d
