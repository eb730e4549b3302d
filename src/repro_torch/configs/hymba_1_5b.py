"""Hymba-1.5B (hybrid: parallel attention + mamba heads per layer, SWA).
[arXiv:2411.13676; hf]

Simplifications recorded in DESIGN.md: all layers use sliding-window
attention (the real model keeps 3 global layers + meta tokens and shares KV
cross-layer); the SSM branch runs at d_inner = d_model in parallel with the
attention branch, outputs averaged."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, mlp_act="silu",
    hybrid=True, ssm_state=16, ssm_head_p=64, sliding_window=1024,
)
