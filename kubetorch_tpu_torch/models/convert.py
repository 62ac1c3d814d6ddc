"""Carry a JAX param tree, or a whole JAX train state, across as the
port's tensors, and a tensor tree back to the host as numpy.

The caller turns each leaf into numpy (``np.asarray`` on a JAX array) and
hands the tree over; the result has the same nesting and the same stacked
``(L, ...)`` layout, on ``device``. A JAX bf16 leaf arrives as numpy's
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects: its bits are
reinterpreted through a ``uint16`` view, so the conversion is exact.

``train_state_from_numpy`` carries a JAX ``TrainState`` (params, the optax
chain's state, step) into the port's ``train.TrainState``: optax's state
classes map by name onto their copies in ``train/optim.py``, so a run
resumes from the same moments and counts, not only the same weights.

``resnet_from_flax`` carries a flax ResNet's ``variables`` (``params``
and ``batch_stats``, as numpy) into the port's pair of trees under the
same module names; the one change of layout is the conv kernel, flax's
HWIO turned into PyTorch's (O, I, kh, kw).

``params_to_numpy`` is the way back (the host hand-off of a checkpoint or
a weight rollout): each tensor becomes a C-contiguous numpy array of its
own, copied off the device. numpy has no bf16, so a bf16 tensor crosses
as its bits, an ``int16`` view read back as ``uint16``: the bytes, and
with them every content hash, are those of the JAX package's ml_dtypes
bfloat16 leaf, and ``params_from_numpy`` brings it back as the same bf16
tensor.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .common import resolve_device


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a, order="C")   # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor → a numpy array of its own on the host (never a view of
    the tensor, so later in-place updates do not reach it); bf16 as its
    bits in ``uint16``."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def params_to_numpy(tree: Any) -> Any:
    """Nested dict/list of tensors → the same structure of numpy arrays
    (:func:`leaf_to_numpy`); numpy leaves pass through."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return leaf_to_numpy(tree)
    return np.asarray(tree, order="C")


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


def _is_conv(path: str, leaf: np.ndarray) -> bool:
    return path.endswith("kernel") and np.ndim(leaf) == 4


def _map_paths(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def resnet_from_flax(variables: Any, device=None):
    """A flax ResNet's ``variables`` as numpy (``{"params": ...,
    "batch_stats": ...}``, e.g. ``jax.tree_util.tree_map(np.asarray,
    variables)``) → the port's ``(params, batch_stats)`` on ``device``
    (``models.resnet``), module names kept; conv kernels HWIO → (O, I,
    kh, kw), dense kernels stay (in, out)."""
    device = resolve_device(device)

    def leaf(path, a):
        a = np.asarray(a)
        if _is_conv(path, a):
            a = a.transpose(3, 2, 0, 1)
        return _leaf(a, device)

    return (_map_paths(leaf, variables["params"]),
            params_from_numpy(variables.get("batch_stats", {}), device))
