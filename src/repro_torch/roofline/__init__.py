"""Roofline model of the port: the fused update's hand cost model
(``kernel_model``) and the bound on the card it gives."""

from repro_torch.roofline.kernel_model import (CARD_PEAKS, Cost, bound_ms,
                                               card_peaks, fused_update_cost,
                                               predicted_intensity)

__all__ = ["CARD_PEAKS", "Cost", "bound_ms", "card_peaks",
           "fused_update_cost", "predicted_intensity"]
