"""recurrentgemma-9b (Griffin) [arXiv:2402.19427]: 38L, d=4096, RG-LRU
recurrent blocks + local attention (window 2048) in a 2:1 pattern,
16H MQA(kv=1) head_dim=256 on attention layers, d_ff=12288, vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="rglru",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000, act="geglu",
    attn_every=3, window=2048, lru_width=4096, rope_theta=10000.0,
)
