"""Typed exceptions of the port, copies of their counterparts in
``kubetorch_tpu/exceptions.py`` (``KubetorchError``, ``RolloutError``,
``StaleStageEpochError``, the flywheel cursor's ``StaleLeaseError``, the
compile cache's ``AOTCacheMissError`` and ``AOTCacheCorruptError``,
ktsync's ``SyncError``, the data store's ``DataStoreError``,
``StoreFullError``, ``RingEpochMismatch`` and ``DataCorruptionError``, and
``CircuitOpenError``), with the same names, attributes and message texts,
so a caller can handle either package's refusal alike.
:func:`rehydrate_exception` rebuilds one of these from the JSON body a
store server sends with a 409 or a 507 (the JAX package's
``package_exception`` layout: ``error_type``, ``message``, ``attrs``)."""

from __future__ import annotations

from typing import Any, Dict, Optional


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


class StaleStageEpochError(KubetorchError):
    """A pipeline stage acted under a fenced-off membership epoch.

    Elastic pipeline parallelism (``parallel/pipeline_elastic.py``) stamps
    every stage gang with a membership epoch and bumps it on every
    re-group — a stage death, a straggler demotion, a partial-gang
    preemption. A zombie stage from before the re-group (SIGSTOPped, GC
    paused, or just slow) that wakes up and tries to confirm its
    assignment or publish a boundary activation is refused with this
    error instead of silently double-driving layers the survivors already
    absorbed. The stale side's only valid move is to exit; the membership
    brain has already re-placed its layer shard. ``current_epoch`` names
    the membership that actually holds."""

    def __init__(self, message: str = "stage membership epoch is stale",
                 job: Optional[str] = None,
                 stage: Optional[int] = None,
                 epoch: Optional[int] = None,
                 current_epoch: Optional[int] = None):
        super().__init__(message)
        self.job = job
        self.stage = stage
        self.epoch = epoch
        self.current_epoch = current_epoch


class StaleLeaseError(KubetorchError):
    """An actor carried a fenced-off lease epoch.

    The flywheel's trainer cursor (``flywheel/ledger.py``) takes a
    store-held fencing epoch on ``acquire`` and re-reads it on every poll
    and commit: a trainer whose epoch another trainer has since bumped is
    refused with this error instead of folding records the new holder
    folds too. (The JAX package raises it from its federation's placement
    leases as well, with a ``region``.) The stale side's only valid move is
    to stop; ``current_epoch``/``current_region`` name the lease that
    actually holds."""

    def __init__(self, message: str = "placement lease epoch is stale",
                 workload: Optional[str] = None,
                 region: Optional[str] = None,
                 epoch: Optional[int] = None,
                 current_epoch: Optional[int] = None,
                 current_region: Optional[str] = None):
        super().__init__(message)
        self.workload = workload
        self.region = region
        self.epoch = epoch
        self.current_epoch = current_epoch
        self.current_region = current_region


class AOTCacheMissError(KubetorchError):
    """The compile cache (``serve/aot_cache.py``) holds no entry for this
    key and name: a key never built, or one whose fields moved (a torch or
    CUDA upgrade, another card, an edited kernel source, a bucket change).
    Always recoverable: the caller builds the library fresh and publishes
    it, so the fleet pays each build once per distinct key. ``reason``
    tells ``absent`` (never built) from ``incompatible`` (the name exists
    under another key digest)."""

    def __init__(self, message: str = "AOT compile cache miss",
                 key: Optional[str] = None, name: Optional[str] = None,
                 reason: str = "absent"):
        super().__init__(message)
        self.key = key
        self.name = name
        self.reason = reason


class AOTCacheCorruptError(AOTCacheMissError):
    """A cached library failed its content check: its blake2b does not
    match the sidecar's, or the sidecar is unreadable. A miss all the same
    (the caller rebuilds and republishes), counted apart
    (``kt_aot_cache_total{result="corrupt"}``) because it means bit rot or a
    torn write, never a version skew. The hash check runs before the
    library is ever loaded."""

    def __init__(self, message: str = "AOT cache entry corrupt",
                 key: Optional[str] = None, name: Optional[str] = None,
                 expected: Optional[str] = None,
                 actual: Optional[str] = None):
        super().__init__(message, key=key, name=name, reason="corrupt")
        self.expected = expected
        self.actual = actual


class SyncError(KubetorchError):
    """Code/data synchronisation to or from the cluster failed (a directory
    tree's push or pull, ``data_store/sync.py``)."""


class DataStoreError(KubetorchError):
    """Data-store operation (put/get/ls/rm/broadcast) failed."""


class StoreFullError(DataStoreError):
    """The data store's disk is full (ENOSPC/EDQUOT mid-write → HTTP 507).

    Non-retryable by design: a 507 is a capacity verdict, not a transient
    blip — retrying would hammer a full disk. ``path`` is the server-side
    file that failed, when known."""

    def __init__(self, message: str = "data store is out of disk space",
                 path: Optional[str] = None):
        super().__init__(message)
        self.path = path


class RingEpochMismatch(DataStoreError):
    """The client's view of the store ring is stale (HTTP 409).

    ``expected`` is the server's epoch, ``actual`` the stale one the client
    sent; ``data_store.ring.StoreRing.request`` refreshes its view and
    re-routes, so callers only see this when the refresh keeps failing."""

    def __init__(self, message: str = "store ring epoch mismatch",
                 expected: Optional[int] = None,
                 actual: Optional[int] = None):
        super().__init__(message)
        self.expected = expected
        self.actual = actual


class DataCorruptionError(DataStoreError):
    """Fetched bytes do not match their content address (blake2b-160 of
    the index or of the kv meta). The P2P fetcher repairs before raising:
    it evicts the corrupt source (the pod-cache entry, or the peer through
    ``/route/failed``) and fetches from the store."""

    def __init__(self, message: str = "content hash mismatch on fetch",
                 key: Optional[str] = None, expected: Optional[str] = None,
                 actual: Optional[str] = None, source: Optional[str] = None):
        super().__init__(message)
        self.key = key
        self.expected = expected
        self.actual = actual
        self.source = source


class CircuitOpenError(KubetorchError):
    """A circuit breaker is open: the target has failed repeatedly and calls
    are being rejected locally until the cool-down elapses. ``retry_after``
    is the seconds remaining until the breaker half-opens."""

    def __init__(self, message: str = "Circuit breaker is open",
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.retry_after = retry_after


_REGISTRY = {cls.__name__: cls for cls in (
    KubetorchError, SyncError, DataStoreError, StoreFullError,
    RingEpochMismatch, DataCorruptionError, CircuitOpenError,
    StaleLeaseError)}


def rehydrate_exception(data: Dict[str, Any]) -> BaseException:
    """The exception a store's error body names: a type of this module
    with its ``attrs``, else a ``KubetorchError`` carrying the name and
    message (the JAX package also maps builtins and makes a subclass)."""
    name = data.get("error_type", "Exception")
    message = data.get("message", "")
    cls = _REGISTRY.get(name)
    if cls is None:
        return KubetorchError(f"{name}: {message}")
    try:
        return cls(message, **data.get("attrs", {}))
    except TypeError:
        return cls(message)
