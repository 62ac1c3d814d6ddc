"""The drain half of the elastic contract: the port's copy of the
cooperative drain flag in ``kubetorch_tpu/serving/elastic.py``.

A preempted rank gets SIGTERM and a grace window before SIGKILL. With
:func:`install_sigterm_drain` in place, SIGTERM no longer kills the
process: it flips a process-local flag, and a loop that polls
:func:`drain_requested` each iteration flushes a committed checkpoint
inside the window and returns, so a graceful preemption loses no step.
The flywheel's harvester (``flywheel/harvester.py``) is such a loop.

- :func:`request_drain` sets the flag (idempotent: the first reason
  wins) and counts ``kt_elastic_drains_total``, the JAX package's
  counter, with an ``elastic.drain`` event on the current span;
- :func:`drain_requested`, :func:`drain_reason`, :func:`clear_drain`;
- ``DRAIN_GRACE_ENV`` (``KT_SCHED_DRAIN_GRACE_S``), the window's length
  as the scheduler gives it.

The flag is process-global: whoever sets it in a test clears it.

Not ported: ``ElasticPolicy`` and ``ElasticCoordinator`` (the typed
death-cause policy, the split restart budgets, the re-mesh) and
``batch_scale``. They belong to the fabric's supervisors, which stay the
JAX package's; a torch rank takes only this flag from them.
"""

from __future__ import annotations

import signal as signal_mod
import threading
from typing import Optional

from .. import telemetry

_DRAINS = telemetry.counter(
    "kt_elastic_drains_total",
    "Cooperative drain requests observed (SIGTERM grace-window path)")

# shared with the scheduler: the SIGTERM -> eviction window a preempted pod
# gets, so "how long do I have to checkpoint" is one number
DRAIN_GRACE_ENV = "KT_SCHED_DRAIN_GRACE_S"

_drain = threading.Event()
_drain_reason: Optional[str] = None


def request_drain(reason: Optional[str] = None) -> None:
    """Mark this process as draining: the step loop should checkpoint and
    return at the next opportunity. Idempotent."""
    global _drain_reason
    if not _drain.is_set():
        _drain_reason = reason
        _DRAINS.inc()
        telemetry.add_event("elastic.drain", reason=reason or "")
    _drain.set()


def drain_requested() -> bool:
    """True once a drain was requested: flush a committed checkpoint and
    return (one Event read, cheap enough for every iteration)."""
    return _drain.is_set()


def drain_reason() -> Optional[str]:
    return _drain_reason


def clear_drain() -> None:
    global _drain_reason
    _drain_reason = None
    _drain.clear()


def install_sigterm_drain() -> None:
    """Make SIGTERM flip the drain flag instead of killing the process.
    The sender's SIGKILL after the grace window stays the backstop for a
    loop that never polls. Only the main thread can install a handler;
    elsewhere this does nothing."""
    def _handler(signum, frame):  # noqa: ARG001 — signal signature
        request_drain("SIGTERM")

    try:
        signal_mod.signal(signal_mod.SIGTERM, _handler)
    except (ValueError, OSError):   # not the main thread / unsupported
        pass


__all__ = ["DRAIN_GRACE_ENV", "request_drain", "drain_requested",
           "drain_reason", "clear_drain", "install_sigterm_drain"]
