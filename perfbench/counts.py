"""The benchmark's own count of each kernel's work and of the model's,
frozen here so that a change to a kernel cannot move its own yardstick.

Each count gives the floating-point operations a call must do (2 a
multiply-add) and the bytes it must move, each input read once and each
output written once, from the shapes alone: no tile, chunk, capacity
padding or scratch of any implementation.  ``bound_s`` is the least time
an NVIDIA H100 SXM could take (its data sheet, dense, at 700 W): the
larger of the bytes over the HBM3 rate and the operations over the
tensor cores' bf16 rate.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / PEAK_BF16_FLOPS)


def causal_pairs(T: int) -> int:
    """(query, key) pairs of one head of causal attention over T."""
    return T * (T + 1) // 2


def k2_fwd(B, H, Hkv, T, hd, es=2):
    """K2 under grad: QK^T and PV over the causal pairs (4 H hd a pair);
    q, k, v read, the output and the float32 log-sum-exp written."""
    flops = 4 * B * causal_pairs(T) * H * hd
    nbytes = es * (2 * B * H * T * hd + 2 * B * Hkv * T * hd) \
        + F32 * B * H * T
    return flops, nbytes


def k2_bwd(B, H, Hkv, T, hd, es=2):
    """K2's backward: the scores, dP, dV, dK and dQ products over the
    causal pairs (10 H hd a pair); q, out, dout read and dq written, k,
    v read and dk, dv written, the log-sum-exp read."""
    flops = 10 * B * causal_pairs(T) * H * hd
    nbytes = es * (4 * B * H * T * hd + 4 * B * Hkv * T * hd) \
        + F32 * B * H * T
    return flops, nbytes


def k3_fwd(pairs, E, d_in, d_out, es=2):
    """One K3 product over the routed (token, expert) pairs: each pair's
    row of d_in read, its row of d_out written, and the d_in x d_out
    weights of the E experts that receive tokens read once."""
    return 2 * pairs * d_in * d_out, \
        es * (pairs * (d_in + d_out) + E * d_in * d_out)


def k3_bwd(pairs, E, d_in, d_out, es=2):
    """K3's backward of that product: dx = dy w^T and dw = x^T dy over
    the pairs; x, dy and w read, dx and dw written."""
    return 4 * pairs * d_in * d_out, \
        es * (2 * pairs * d_in + pairs * d_out + 2 * E * d_in * d_out)


def k4_fwd(B, H, T, M, es=2):
    """K4: the recurrence's own work, a step and a head: the state's
    decay and outer-product update (3 M^2), its read-out (2 M^2) and the
    bonus term (4 M).  r, k, v read in the model's type, the float32
    decay read and output written, u read, the final state written."""
    flops = B * H * T * (5 * M * M + 4 * M)
    nbytes = B * H * T * M * (3 * es + F32 + F32) + H * M * F32 \
        + B * H * M * M * F32
    return flops, nbytes


def k4_bwd(B, H, T, M, es=2):
    """K4's backward: twice the forward's work; r, k, v, the decay and the
    output's gradient read, their four gradients written, u read and du
    written.  No chunk-start state is counted."""
    flops = 2 * B * H * T * (5 * M * M + 4 * M)
    nbytes = B * H * T * M * (3 * es + F32 + F32 + 3 * es + F32) \
        + 2 * H * M * F32
    return flops, nbytes


def matmul_params(model: dict) -> int:
    """Parameters that take part in a matrix product for each token: the
    layers' projections (the MoE: the router and the top-k experts) and
    the output head; not the input embedding's lookup."""
    d, L, V = model["d_model"], model["n_layers"], model["vocab"]
    if model["family"] == "rwkv":
        r = model.get("lora_r", 32)
        layer = 6 * d * d + 2 * d * r + 2 * d * model["d_ff"]
    else:
        H, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
        layer = 2 * d * H * hd + 2 * d * Hkv * hd
        if model.get("n_experts"):
            layer += d * model["n_experts"] \
                + model["top_k"] * 3 * d * model["moe_d_ff"]
        else:
            layer += 3 * d * model["d_ff"]
    return L * layer + d * V


def model_flops(model: dict, B: int, T: int) -> int:
    """A training step's model FLOPs: 6 x matmul parameters x tokens, and
    for attention 12 x causal pairs x H x hd a layer (forward and
    backward); recomputation is not counted."""
    flops = 6 * matmul_params(model) * B * T
    if model["family"] != "rwkv":
        flops += 12 * B * causal_pairs(T) * model["n_heads"] \
            * model["head_dim"] * model["n_layers"]
    return flops
