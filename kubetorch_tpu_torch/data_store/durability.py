"""Crash-safe file commits, the port's copy of ``durable_replace`` and
``durable_write_bytes`` in ``kubetorch_tpu/data_store/durability.py``: a
file appears under its final name whole or not at all, and, with
``KT_STORE_FSYNC`` on (the default), its bytes and the directory entry are
on disk before the call returns. The JAX package also reads the layered
config's ``store_fsync``; the port reads the environment only."""

from __future__ import annotations

import os
import uuid
from pathlib import Path
from typing import Union

_FALSY = ("0", "false", "off", "no", "")


def fsync_enabled() -> bool:
    """``KT_STORE_FSYNC`` (default on): pair commit renames with data and
    parent-directory fsyncs."""
    raw = os.environ.get("KT_STORE_FSYNC")
    return raw is None or raw.strip().lower() not in _FALSY


def _fsync_path(path: Path, flags: int = os.O_RDONLY) -> None:
    fd = os.open(path, flags)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def durable_replace(tmp: Union[str, Path], final: Union[str, Path]) -> None:
    """fsync ``tmp``'s bytes, rename it over ``final``, fsync the parent
    directory: a crash at any point leaves the old or the new content
    whole, never a truncated file under the final name."""
    tmp, final = Path(tmp), Path(final)
    if fsync_enabled():
        _fsync_path(tmp)
    os.replace(tmp, final)
    if fsync_enabled():
        _fsync_path(final.parent, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))


def durable_write_bytes(path: Union[str, Path], data: bytes) -> None:
    """Publish ``data`` at ``path`` through a uniquely named sibling and
    :func:`durable_replace`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{uuid.uuid4().hex[:8]}.tmp")
    try:
        tmp.write_bytes(data)
        durable_replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
