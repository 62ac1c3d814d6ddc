"""Training: the train step (``train_step.py``) and the optimizer it runs
(``optim.py``, the port's copy of the optax pieces the JAX step uses)."""

from .optim import adamw, chain, clip_by_global_norm, warmup_cosine_decay_schedule
from .train_step import (STEP_METRICS, TrainState, default_optimizer,
                         init_train_state, make_train_step)

__all__ = ["STEP_METRICS", "TrainState", "adamw", "chain", "clip_by_global_norm",
           "default_optimizer", "init_train_state", "make_train_step",
           "warmup_cosine_decay_schedule"]
