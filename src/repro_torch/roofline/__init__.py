"""Roofline model of the port: the fused update's hand cost model
(``kernel_model``) and the bound on the card it gives, and the LM stack's
model FLOPs (``analysis.model_flops``)."""

from repro_torch.roofline.analysis import model_flops
from repro_torch.roofline.kernel_model import (CARD_PEAKS, Cost, bound_ms,
                                               card_peaks, fused_update_cost,
                                               predicted_intensity)

__all__ = ["CARD_PEAKS", "Cost", "bound_ms", "card_peaks",
           "fused_update_cost", "model_flops", "predicted_intensity"]
