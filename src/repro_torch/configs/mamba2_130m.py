"""Mamba2-130M (attention-free SSD). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, ssm=True, ssm_state=128, ssm_head_p=64,
    ssm_expand=2,
)
