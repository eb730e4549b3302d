"""LM-family model stack for the assigned architectures (a port of
``repro.models``): ``Model`` (an ``nn.Module`` per config, on the GPU
unless ``device="cpu"``), ``build_model`` and the weight carry
``params_from_reference``."""

from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model", "params_from_reference"]
