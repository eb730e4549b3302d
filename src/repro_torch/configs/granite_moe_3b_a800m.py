"""Granite-MoE 3B-a800m. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Assigned config string specifies "MoE 40e top-8" while the margin note says
32 experts; we follow the explicit field (40 experts, top-8)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, mlp_act="silu",
    n_experts=40, experts_per_token=8, tie_embeddings=True,
)
