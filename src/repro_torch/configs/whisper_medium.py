"""Whisper-medium (enc-dec audio backbone; conv frontend STUB).
[arXiv:2212.04356; unverified]

input_specs() supplies precomputed frame embeddings (B, S_enc, d_model) in
place of the conv1d+mel frontend. Encoder: bidirectional attention;
decoder: causal self-attn + cross-attn. LayerNorm + GELU (original arch),
learned positions approximated with RoPE=off / absolute embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, mlp_act="gelu", rope_theta=0.0,
    enc_dec=True, n_enc_layers=24, frontend="audio",
)
