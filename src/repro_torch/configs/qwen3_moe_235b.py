"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B]: 94L, d=4096, 64H GQA(kv=4),
expert d_ff=1536, vocab=151936, MoE 128 experts top-8, qk-norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, qk_norm=True,
    n_experts=128, top_k=8, moe_d_ff=1536,
)
