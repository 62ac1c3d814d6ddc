"""Checks and ctypes plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def check_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                       device: torch.device) -> None:
    """What every kernel needs of a tensor it reads through strides: the
    same device and dtype as the rest, a unit-stride last dim, and 16-byte
    alignment of every row it loads (base pointer and leading strides; TMA
    refuses anything else)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride in its last dim, "
                         f"got strides {t.stride()}")
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
        raise ValueError(f"{name} rows must be 16-byte aligned "
                         f"(strides {t.stride()}, pointer {t.data_ptr():#x})")


def check_dtype_and_head_dim(dtype: torch.dtype, hd: int) -> None:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes {sorted(map(str, DTYPE_CODES))}, got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dims {HEAD_DIMS}, got {hd}")


def strides_arg(values: Sequence[int]):
    return (ctypes.c_longlong * len(values))(*values)


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")
