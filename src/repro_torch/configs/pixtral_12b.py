"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]: mistral-nemo decoder backbone,
40L, d=5120, 32H GQA(kv=8), d_ff=14336, vocab=131072; ViT patch frontend is a
STUB (input_specs supplies precomputed patch embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=14336, vocab=131072, prefix_len=256,
)
