"""Training of the LM stack (a port of ``repro.train``): AdamW with
float32 masters and moments, and the train step with microbatch
accumulation and per-layer remat."""

from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.train.step import (TrainState, make_train_step,
                                    train_state_specs)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "TrainState",
           "make_train_step", "train_state_specs"]
