"""The port's command-line drivers: the counterparts of the reference's
``examples/*.py``, run as ``python -m repro_torch.examples.<name>``.

- ``quickstart``: LBP stalls where RBP and RnBP converge (Ising 40 x 40);
- ``stereo_bp``: a stereo MRF decoded by max-product;
- ``ldpc_decode``: a Gallager code over AWGN, coded against uncoded BER;
- ``bp_serving``: a request stream through ``serve_async`` or
  ``serve_routed``, with every knob of the serving pipeline;
- ``distributed_bp``: sharded and banded BP in a ``torch.distributed``
  world (``torchrun``);
- ``train_lm``: a reduced LM trained with a checkpoint and an exact
  resume.

Each parses the reference's flags and defaults and prints the reference's
lines, plus ``--device`` (``cuda`` by default; it raises without a GPU,
``cpu`` runs the plain torch path). The work sits in a ``run`` function
that returns what is printed. On the card the BP drivers take the kernel
backends: sum-product through ``"triton"`` (``fused_update_e``),
max-product through ``make_triton_update(semiring="max")``; on the CPU
the plain versions, ``"ref"`` and ``"maxprod"``.
"""

from __future__ import annotations

import torch

__all__ = ["sum_backend", "max_backend", "generator", "sync"]


def sum_backend(device: torch.device) -> str:
    """The sum-product backend: the fused kernel on the card, the plain
    version on the CPU."""
    return "triton" if device.type == "cuda" else "ref"


def max_backend(device: torch.device):
    """The max-product backend: the fused kernel at ``semiring="max"`` on
    the card (bitwise ``"maxprod"``), the plain version on the CPU."""
    if device.type != "cuda":
        return "maxprod"
    from repro_torch.kernels.ops import make_triton_update
    return make_triton_update(semiring="max")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (for wall times); a no-op on the
    CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
