"""gemma-7b [arXiv:2403.08295]: 28L, d=3072, 16H MHA (kv=16), head_dim=256,
GeGLU d_ff=24576, vocab=256000, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="geglu", tie_embeddings=True,
    rope_theta=10000.0,
)
