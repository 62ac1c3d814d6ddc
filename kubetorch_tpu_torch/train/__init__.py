"""Training: the train step (``train_step.py``), the optimizer it runs
(``optim.py``, the port's copy of the optax pieces the JAX step uses) and
host→device prefetch (``data.py``)."""

from .data import prefetch_to_device
from .optim import (adam, adamw, chain, clip_by_global_norm,
                    warmup_cosine_decay_schedule)
from .train_step import (STEP_METRICS, TrainState, default_optimizer,
                         init_train_state, make_train_step)

__all__ = ["STEP_METRICS", "TrainState", "adam", "adamw", "chain",
           "clip_by_global_norm", "default_optimizer", "init_train_state",
           "make_train_step", "prefetch_to_device",
           "warmup_cosine_decay_schedule"]
