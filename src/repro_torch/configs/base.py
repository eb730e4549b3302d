"""Architecture config schema, input shapes, and the registry.

Every assigned architecture is one ``<id>.py`` in this package exporting
``CONFIG``; ``repro_torch.configs.get(name)`` loads it. ``reduced()``
produces the CPU-smoke-test variant of the same family (tiny dims, same
code paths).

The port keeps its own copy of the reference's ``repro.configs``: the
fields, their defaults and every config's values are the same, so
``dataclasses.asdict`` of a config (and of its ``reduced()``) compares
equal across the two packages.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ----------------------------------------------------------------- shapes --

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


# ----------------------------------------------------------------- config --

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # norm / act / rope
    mlp_act: str = "silu"        # silu = SwiGLU, gelu = GeGLU
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0      # leading dense layers (deepseek: 3)
    moe_dispatch: str = "ragged"  # ragged | dense | sharded (see layers/moe)
    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False            # multi-token-prediction aux head
    # SSM / hybrid
    ssm: bool = False            # attention-free (mamba2)
    hybrid: bool = False         # parallel attn+ssm heads (hymba)
    ssm_state: int = 0
    ssm_head_p: int = 64
    ssm_expand: int = 2
    sliding_window: int = 0      # hymba SWA
    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    n_frontend_tokens: int = 0   # vision: patches prepended to the sequence
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.n_heads == 0:          # attention-free (mamba2)
            return 0
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the unembedding shards over any
        power-of-two 'model' axis (logits are the largest activation; an
        unshardable vocab replicates them -- 13 GB/device at train_4k)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        if self.hybrid:
            return self.d_model          # parallel heads share width (hymba)
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (see DESIGN.md SSArch-applicability)."""
        return self.ssm or self.hybrid

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch decodes (whisper via its decoder)

    def shapes(self) -> Tuple[InputShape, ...]:
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic:
            out.append(LONG_500K)
        return tuple(out)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128, vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            n_dense_layers=min(self.n_dense_layers, 1),
            q_lora_rank=32 if self.mla else 0,
            kv_lora_rank=16 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 0,
            qk_nope_dim=16 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_p=16 if (self.ssm or self.hybrid) else 64,
            sliding_window=min(self.sliding_window, 32),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            dtype="float32",
        )


ARCH_IDS = (
    "mistral_large_123b", "gemma_7b", "starcoder2_3b", "qwen3_4b",
    "hymba_1_5b", "pixtral_12b", "whisper_medium", "granite_moe_3b_a800m",
    "deepseek_v3_671b", "mamba2_130m",
)


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


def all_configs():
    return {n: get(n) for n in ARCH_IDS}
