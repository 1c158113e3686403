"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B]: 28L, d=1024, 16H GQA(kv=8), head_dim=128,
d_ff=3072, vocab=151936, qk-norm, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab=151936, qk_norm=True, tie_embeddings=True,
)
