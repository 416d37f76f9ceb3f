"""Detector training of the port: the assigner, the loss, the step, the
optimizer chain and EMA (the JAX package's mesh, tensor-parallel and
depth-training names are not ported yet)."""
from .dsla import dynamic_soft_label_assign  # noqa: F401
from .train import (  # noqa: F401
    AdamWChain, TrainState, create_train_state,
    detector_loss, ema_decay_schedule, ema_update, make_optimizer,
    make_train_step, warmup_cosine_decay_schedule,
)
