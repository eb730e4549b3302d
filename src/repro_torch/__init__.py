"""PyTorch/CUDA port of the many-core Belief Propagation system.

A package beside the JAX reference ``repro`` that mirrors its module names
(``repro.core.messages`` <-> ``repro_torch.core.messages``, ...). It imports
torch and numpy, never JAX and nothing of ``repro``. Entry points run on
the GPU (``device="cuda"``) unless the caller asks for the CPU; the fused
message update is a hand-written CUDA kernel for Hopper
(``repro_torch.kernels``).
"""

from repro_torch.core import (BPConfig, BPEngine, BPResult, BPState, PGM,
                              build_pgm, build_pgm_uniform, get_scheduler,
                              list_backends, list_schedulers)

__all__ = ["BPConfig", "BPEngine", "BPResult", "BPState", "PGM", "build_pgm",
           "build_pgm_uniform", "get_scheduler", "list_backends",
           "list_schedulers"]
