"""Shared model-family helpers."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type, Union

import torch


def config_from_dict(cls: Type, d: Dict[str, Any]):
    """Build a config dataclass from a dict, ignoring unknown keys (wire
    metadata can carry extra fields; each family's config takes what it
    knows). One definition for every model family."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one. Never falls back quietly — no card and no explicit request raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
