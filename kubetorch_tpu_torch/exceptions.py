"""Typed exceptions of the port, copies of their counterparts in
``kubetorch_tpu/exceptions.py`` (``KubetorchError`` and ``RolloutError``),
with the same names, attributes and message texts, so a caller can handle
either package's refusal alike."""

from __future__ import annotations

from typing import Optional


class KubetorchError(Exception):
    """Base for every kubetorch-tpu exception."""


class RolloutError(KubetorchError):
    """A live weight rollout refused to swap.

    Raised by ``serve/rollout.py`` — the only weight-swap site — when a
    staged delta fails its bit-equality gate (index/manifest fingerprint
    mismatch, a leaf whose shape/dtype no longer matches the engine's
    compiled step, or a manifest pointing at weights the store no longer
    holds). The engine's live params are untouched whenever this raises:
    every check runs BEFORE the batch-boundary swap, so a bad manifest
    can never leave a replica mixed-version."""

    def __init__(self, message: str = "weight rollout refused",
                 reason: Optional[str] = None,
                 version: Optional[int] = None,
                 expected: Optional[str] = None,
                 actual: Optional[str] = None):
        super().__init__(message)
        self.reason = reason
        self.version = version
        self.expected = expected
        self.actual = actual
