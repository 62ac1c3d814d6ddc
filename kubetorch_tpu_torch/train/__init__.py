"""Training: the train step (``train_step.py``), the optimizer it runs
(``optim.py``, the port's copy of the optax pieces the JAX step uses),
host→device prefetch (``data.py``) and checkpoints on the store protocol
with the trainer's side of a live weight rollout (``checkpoint.py``)."""

from .checkpoint import (Checkpointer, async_save_state, commit_info,
                         local_restore, local_save, publish_rollout,
                         restore_state, save_state, train_state_from_tree,
                         train_state_tree, tree_fingerprint)
from .data import prefetch_to_device
from .optim import (adam, adamw, chain, clip_by_global_norm, sgd, trace,
                    warmup_cosine_decay_schedule)
from .train_step import (STEP_METRICS, TrainState, default_optimizer,
                         init_train_state, make_train_step)

__all__ = ["Checkpointer", "STEP_METRICS", "TrainState", "adam", "adamw",
           "async_save_state", "chain", "clip_by_global_norm", "commit_info",
           "default_optimizer", "init_train_state", "local_restore",
           "local_save", "make_train_step", "prefetch_to_device",
           "publish_rollout", "restore_state", "save_state", "sgd", "trace",
           "train_state_from_tree", "train_state_tree", "tree_fingerprint",
           "warmup_cosine_decay_schedule"]
