"""The kernels' dispatcher ops, in the ``repro_torch`` namespace.

Each kernel wrapper calls its op through ``torch.ops.repro_torch.<name>``,
and the dispatcher picks the implementation from the operands: the plain
torch version for CPU tensors, the ``ctypes`` launch of the hand-written
kernel for CUDA tensors, and a shapes-only version for fake tensors
(``FakeTensorMode``, the meta device). Being one dispatched op is what
lets ``roofline.op_cost`` see the fused kernel as one call and charge it
by its cost model, and lets a BP round run on fake tensors.

The registration is ``torch.library.Library.impl`` with plain Python
functions: no autograd wrapper (nothing differentiates through a BP
update) and no schema inference, the least the dispatcher adds to a call.
"""

from __future__ import annotations

import torch

__all__ = ["NAMESPACE", "define"]

NAMESPACE = "repro_torch"


def define(schema: str, *, cpu, cuda, fake) -> torch.library.Library:
    """Define the op of ``schema`` in ``NAMESPACE`` with its three
    implementations; returns the ``Library`` that holds the registration
    (keep it: the registration lives as long as it does)."""
    lib = torch.library.Library(NAMESPACE, "FRAGMENT")
    name = schema.split("(", 1)[0]
    lib.define(schema)
    lib.impl(name, cpu, "CPU")
    lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=lib)
    return lib
