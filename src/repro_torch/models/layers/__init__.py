"""The LM stack's layers: attention, MLA, SSM, MoE, MLP and primitives."""
