"""Carry a JAX param tree across as the port's tensors.

The caller turns each leaf into numpy (``np.asarray`` on a JAX array) and
hands the tree over; the result has the same nesting and the same stacked
``(L, ...)`` layout, on ``device``. A JAX bf16 leaf arrives as numpy's
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects: its bits are
reinterpreted through a ``uint16`` view, so the conversion is exact.
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
