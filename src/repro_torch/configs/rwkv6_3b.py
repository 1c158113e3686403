"""rwkv6-3b "Finch" [arXiv:2404.05892]: 32L, d=2560, attention-free
(data-dependent decay WKV), d_ff=8960, vocab=65536."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, rwkv_head_dim=64,
)
