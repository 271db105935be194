"""Training substrate (counterpart of ``repro.train``): optimizers from
scratch, schedules, the generic train step (gradient compression,
clipping, microbatch accumulation), step-atomic checkpointing and the
fault-tolerant loop, over plain dicts of tensors walked in
``jax.tree_util``'s order (:mod:`repro_torch.tree`)."""

from . import checkpoint, loop, optimizer, schedule, step
from .step import TrainConfig, init_train_state, make_train_step, state_from_numpy

__all__ = ["checkpoint", "loop", "optimizer", "schedule", "step", "TrainConfig",
           "init_train_state", "make_train_step", "state_from_numpy"]
