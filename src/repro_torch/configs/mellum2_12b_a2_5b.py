"""mellum2-12b-a2.5b [hf:JetBrains/Mellum2-12B-A2.5B-Instruct]: 28L, d=2304,
32H GQA(kv=4) of 128, MoE 64 experts of 896 top-8 in every layer, vocab
98304 untied; three sliding-window layers (1024, plain RoPE) then one full
layer (YaRN: factor 16 over 8192 positions, beta 32 / 1, attention factor
1 + 0.1 ln 16), repeated.  Not in ``ARCHS``: the JAX package has no such
model, so it takes no part in the parity tests."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mellum2-12b-a2.5b", family="moe",
    n_layers=28, d_model=2304, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=7168, vocab=98304, rope_theta=500000.0, norm_eps=1e-6,
    n_experts=64, top_k=8, moe_d_ff=896,
    window=1024, global_every=4,
    yarn_factor=16.0, yarn_original_len=8192,
    max_target_len=131072,
)
