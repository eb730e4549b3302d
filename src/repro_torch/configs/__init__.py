"""Architecture configs of the LM stack (a copy of ``repro.configs``)."""

from repro_torch.configs.base import (ALL_SHAPES, ARCH_IDS, ArchConfig,
                                      InputShape, all_configs, get,
                                      TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K)

__all__ = ["ALL_SHAPES", "ARCH_IDS", "ArchConfig", "InputShape",
           "all_configs", "get", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K"]
