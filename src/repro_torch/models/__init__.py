"""LM-family model stack for the assigned architectures (a port of
``repro.models``): ``Model`` (an ``nn.Module`` per config, on the GPU
unless ``device="cpu"``), ``build_model`` and the weight carry
``params_from_reference``, and ``shard_state_dict`` for a model on a mesh."""

from repro_torch.models.convert import params_from_reference, shard_state_dict
from repro_torch.models.model import (Model, ShardedCache, build_model,
                                      param_specs)

__all__ = ["Model", "ShardedCache", "build_model", "param_specs",
           "params_from_reference", "shard_state_dict"]
