"""Roofline model of the port: the fused update's hand cost model
(``kernel_model``: ``fused_update_cost``, the bound on the card it gives,
and ``round_cost``, one engine round counted), the op-level counter
(``op_cost``, the counterpart of the reference's ``jaxpr_cost``) and the
roofline terms of a step (``analysis``: ``HW``, ``collective_bytes``,
``RooflineReport``, ``analyze``, ``model_flops``)."""

from repro_torch.roofline.analysis import (HW, RooflineReport, analyze,
                                           collective_bytes, model_flops)
from repro_torch.roofline.kernel_model import (CARD_PEAKS, bound_ms,
                                               card_peaks, fused_update_cost,
                                               predicted_intensity,
                                               round_cost)
from repro_torch.roofline.op_cost import Cost, OpCounter, trace_cost

# ``op_cost`` stays the module (its function is ``op_cost.op_cost``)
__all__ = ["CARD_PEAKS", "Cost", "HW", "OpCounter", "RooflineReport",
           "analyze", "bound_ms", "card_peaks", "collective_bytes",
           "fused_update_cost", "model_flops", "predicted_intensity",
           "round_cost", "trace_cost"]
