"""DeepSeek-V3 671B (MLA + 1 shared + 256 routed top-8 + MTP).
[arXiv:2412.19437; hf]

Assigned d_ff=2048 is used for BOTH the routed/shared experts and the 3
dense lead-in layers (the released model uses 18432 for dense layers; we
stay literal to the assigned config -- recorded deviation)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280, mlp_act="silu",
    n_experts=256, experts_per_token=8, n_shared_experts=1,
    n_dense_layers=3,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    mtp=True,
)
