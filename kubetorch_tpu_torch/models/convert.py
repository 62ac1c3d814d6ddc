"""Carry a JAX param tree, or a whole JAX train state, across as the
port's tensors.

The caller turns each leaf into numpy (``np.asarray`` on a JAX array) and
hands the tree over; the result has the same nesting and the same stacked
``(L, ...)`` layout, on ``device``. A JAX bf16 leaf arrives as numpy's
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects: its bits are
reinterpreted through a ``uint16`` view, so the conversion is exact.

``train_state_from_numpy`` carries a JAX ``TrainState`` (params, the optax
chain's state, step) into the port's ``train.TrainState``: optax's state
classes map by name onto their copies in ``train/optim.py``, so a run
resumes from the same moments and counts, not only the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .common import resolve_device


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict/list of numpy arrays → the same structure of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _leaf(np.asarray(tree), device)


def _opt_state(node: Any, device: torch.device) -> Any:
    from ..train import optim

    if hasattr(node, "_fields"):   # an optax state NamedTuple
        cls = getattr(optim, type(node).__name__, None)
        if cls is None or getattr(cls, "_fields", None) != node._fields:
            raise ValueError(f"no port counterpart for optimizer state "
                             f"{type(node).__name__}{node._fields}")
        return cls(*(_opt_state(v, device) for v in node))
    if isinstance(node, tuple):
        return tuple(_opt_state(v, device) for v in node)
    return params_from_numpy(node, device)


def train_state_from_numpy(state: Any, device=None):
    """A JAX ``TrainState`` whose leaves were turned into numpy
    (``jax.tree_util.tree_map(np.asarray, state)``) → the port's
    ``TrainState`` on ``device``, for an optimizer built the same way
    (e.g. ``default_optimizer`` on both sides)."""
    from ..train.train_step import TrainState

    device = resolve_device(device)
    return TrainState(params=params_from_numpy(state.params, device),
                      opt_state=_opt_state(state.opt_state, device),
                      step=_leaf(np.asarray(state.step), device))
