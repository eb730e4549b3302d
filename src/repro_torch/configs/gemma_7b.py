"""Gemma-7B (dense, GeGLU, head_dim=256). [arXiv:2403.08295; hf]
MQA applies to the 2b variant only; 7b is MHA (kv=16)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, mlp_act="gelu", tie_embeddings=True,
)
