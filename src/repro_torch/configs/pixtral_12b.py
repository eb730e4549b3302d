"""Pixtral-12B (vlm: pixtral-ViT frontend STUB + mistral-nemo backbone).
[hf:mistralai/Pixtral-12B-2409; unverified]

Per the assignment spec, only the transformer BACKBONE is modeled; the ViT
frontend is a stub -- input_specs() supplies precomputed patch embeddings
(n_frontend_tokens x d_model) that are prepended to the token sequence."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, mlp_act="silu", rope_theta=1e6,
    frontend="vision", n_frontend_tokens=256,
)
