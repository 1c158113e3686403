"""musicgen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens,
48L, d=1536, 24H MHA(kv=24), d_ff=6144, vocab=2048; the EnCodec frontend is a
STUB (precomputed frame embeddings via prefix)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, prefix_len=128,
)
