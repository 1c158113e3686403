"""Tiny cells for the CPU tests: each benchmark cell's configuration at a
small size and in float32, the same leaves and the same recipe, on a
batch of 2 x 64 tokens."""

from __future__ import annotations

import copy

from perfbench import spec

TINY = {
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, vocab=512, n_experts=8, top_k=2, moe_d_ff=32,
                d_ff=32),
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab=512),
    "rwkv": dict(n_layers=2, d_model=128, d_ff=256, vocab=512,
                 rwkv_head_dim=64),
}


def leaf_shapes(m: dict) -> dict:
    """{path: one layer's shape} of the port's parameter tree for the
    ``model`` dict ``m``."""
    d, V = m["d_model"], m["vocab"]
    out = {"embed": [V, d], "final_norm": [d]}
    if not m["tie_embeddings"]:
        out["lm_head"] = [d, V]
    out["layers.norm1"] = out["layers.norm2"] = [d]
    if m["family"] == "rwkv":
        M, r, f = m["rwkv_head_dim"], m["lora_r"], m["d_ff"]
        out.update({"layers.mu": [5, d], "layers.w0": [d],
                    "layers.w_lora_a": [d, r], "layers.w_lora_b": [r, d],
                    "layers.u": [d // M, M], "layers.ln_x": [d],
                    "layers.mu_c": [2, d], "layers.ck": [d, f],
                    "layers.cv": [f, d]})
        for k in ("wr", "wk", "wv", "wg", "wo", "cr"):
            out[f"layers.{k}"] = [d, d]
        return out
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out.update({"layers.attn.wq": [d, H, hd], "layers.attn.wk": [d, Hkv, hd],
                "layers.attn.wv": [d, Hkv, hd], "layers.attn.wo": [H, hd, d],
                "layers.attn.q_norm": [hd], "layers.attn.k_norm": [hd]})
    if m.get("n_experts"):
        E, f = m["n_experts"], m["moe_d_ff"]
        out.update({"layers.moe.router": [d, E],
                    "layers.moe.w_gate": [E, d, f],
                    "layers.moe.w_up": [E, d, f],
                    "layers.moe.w_down": [E, f, d]})
    else:
        f = m["d_ff"]
        out.update({"layers.mlp.w_gate": [d, f], "layers.mlp.w_up": [d, f],
                    "layers.mlp.w_down": [f, d]})
    return out


def tiny_cell(name: str, limits: dict | None = None) -> spec.Cell:
    """The cell ``name`` cut to the tiny size, in float32."""
    cell = spec.load_cell(name)
    conf = copy.deepcopy(cell.config)
    conf["model"].update(TINY[conf["model"]["family"]], dtype="float32")
    shapes = leaf_shapes(conf["model"])
    conf["leaves"] = {k: ["float32", shapes[k], init]
                      for k, (_, _, init) in conf["leaves"].items()}
    return spec.Cell(name=cell.name, chips=1, config=conf,
                     traffic=dict(cell.traffic, batch=2, seq_len=64),
                     limits=limits or cell.limits,
                     end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def cells() -> list:
    return [w["name"] for w in spec.load_benchmark()["workloads"]]
