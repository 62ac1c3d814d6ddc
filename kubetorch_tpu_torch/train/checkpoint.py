"""Checkpoint/resume and rollout publishing on the store protocol: the
port's copy of ``kubetorch_tpu/train/checkpoint.py``.

Every call takes the store as an argument (``data_store/commands.py``
states the protocol; ``store=None`` raises ``TypeError``). What reaches the
store is a numpy tree: tensors cross to the host through
``models.convert.params_to_numpy`` (bf16 as its ``uint16`` bits), and a
restore returns numpy, which :func:`train_state_from_tree` lands on a
device in the dtypes of a live state.

**The train-state layout** is the JAX package's: ``{"params",
"opt_state", "step"}`` with the optimizer state flattened to one key per
leaf path (``_path_key``: ``"1/0/mu/layers/wq"``; the port's optimizer
states are the optax NamedTuples of ``train/optim.py``, which the JAX
paths name field by field). So a JAX ``save_state`` restores into the
port's ``TrainState`` and the port's into JAX's, for the same optimizer.

**The commit-marker protocol.** :class:`Checkpointer` never overwrites the
checkpoint it would fall back to: saves ping-pong between two slot keys
(``<base>/slot-0``, ``slot-1``), and a commit marker (``<base>/
__kt_commit__`` → {step, slot}) is written strictly after the slot's
leaves and index. A save torn anywhere before the marker leaves the
marker on the previous, intact slot. The store's content skip makes a
save of unchanged leaves move no bytes.

**The async snapshot** (:func:`_snapshot_async`): ``maybe_save`` copies
every device leaf into pinned host memory with non-blocking copies on the
caller's current stream, records an event, and hands the gather, which
waits on that event, to the one IO thread. Stream order does the rest: a
training step issued next on the same stream (``make_train_step(donate=
True)`` writes params and optimizer state in place) runs after the copies,
so the saved bytes are the step's that was saved. ``KT_CKPT_INLINE_GATHER
=1`` gathers inline instead, as in JAX.

**Left out:** the federation's cross-region marker fallback (``commit_info``
reads one store), spans, and the mesh and reshard arguments of restore.
``local_save``/``local_restore`` write a torch file (``torch.save`` of the
train-state layout), not the JAX package's orbax directory, so a JAX local
checkpoint does not load into the port.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..data_store import commands as ds
from ..models.convert import leaf_to_numpy
from ..models.common import resolve_device
from .optim import tree_leaves, tree_map
from .train_step import TrainState

# One IO thread: overlapping saves serialize instead of racing the store,
# and a training loop can fire-and-forget every N steps.
_CKPT_EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="kt-ckpt")

_CKPT_SECONDS = telemetry.histogram(
    "kt_checkpoint_seconds",
    "Checkpoint commit/restore wall-clock seconds",
    labels=("op",))

COMMIT_MARKER = "__kt_commit__"
_SLOTS = ("slot-0", "slot-1")


def train_state_tree(state: TrainState) -> Dict[str, Any]:
    """The saved layout of a train state: params, the optimizer state
    keyed by leaf path, the step."""
    return {"params": state.params, "opt_state": _jsonable_opt(state.opt_state),
            "step": state.step}


def _land(host: Any, like: torch.Tensor, device) -> torch.Tensor:
    """One saved leaf as a tensor of ``like``'s dtype and shape on
    ``device``. A bf16 leaf arrives as 2-byte words: ``uint16`` from the
    port, ml_dtypes' bfloat16 from the JAX package."""
    host = np.asarray(host, order="C")
    if like.dtype == torch.bfloat16 and host.dtype.itemsize == 2:
        t = torch.from_numpy(host.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(host.copy())
    if t.dtype != like.dtype or tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {host.dtype}{tuple(host.shape)} "
                         f"does not fit {like.dtype}{tuple(like.shape)}")
    return t.to(device)


def train_state_from_tree(tree: Dict[str, Any], like: TrainState,
                          device=None) -> TrainState:
    """A saved train state (numpy, :func:`train_state_tree`'s layout) →
    the port's ``TrainState`` on ``device`` (``cuda`` unless named), in
    the structure, dtypes and shapes of ``like``."""
    device = resolve_device(device)
    saved: dict = tree["opt_state"]
    flat_like = _flatten_with_path(like.opt_state)
    if len(saved) != len(flat_like):
        raise ValueError(
            f"Checkpoint opt_state has {len(saved)} leaves, expected "
            f"{len(flat_like)} — optimizer config changed?")
    for k, _ in flat_like:
        if k not in saved:
            raise ValueError(f"Checkpoint opt_state missing leaf {k!r}")
    it = iter([saved[k] for k, _ in flat_like])
    opt_state = tree_map(lambda leaf: _land(next(it), leaf, device),
                         like.opt_state)
    params = tree_map(lambda leaf, host: _land(host, leaf, device),
                      like.params, tree["params"])
    return TrainState(params=params, opt_state=opt_state,
                      step=_land(tree["step"], like.step, device))


def save_state(key: str, state: TrainState, store: Any = None) -> dict:
    return ds.require_store(store).put(key, _host_tree(train_state_tree(state)))


def async_save_state(key: str, state: TrainState,
                     store: Any = None) -> "Future[dict]":
    """Non-blocking checkpoint: the device→host copies start now
    (:func:`_snapshot_async`), the gather and the upload run on the IO
    thread. ``.result()`` confirms the save."""
    store = ds.require_store(store)
    gather = _snapshot_async(train_state_tree(state))
    return _CKPT_EXECUTOR.submit(lambda: store.put(key, gather()))


def restore_state(key: str, like: TrainState, store: Any = None,
                  device=None) -> TrainState:
    """Restore into the structure of ``like`` (an initialized TrainState
    for the same optimizer), on ``device``."""
    tree = ds.require_store(store).get(key)
    return train_state_from_tree(tree, like, device)


def _path_key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_path(node: Any, path: Tuple = ()) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs in ``tree_map``'s order, each path named as
    ``jax.tree_util.tree_flatten_with_path`` names it (dict key, sequence
    index, NamedTuple field)."""
    if isinstance(node, dict):
        items = list(node.items())
    elif hasattr(node, "_fields"):
        items = list(zip(node._fields, node))
    elif isinstance(node, (list, tuple)):
        items = list(enumerate(node))
    else:
        return [(_path_key(path), node)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out += _flatten_with_path(v, path + (k,))
    return out


def _jsonable_opt(opt_state: Any) -> Dict[str, Any]:
    """Optimizer states are nested NamedTuples; the store speaks dict/list
    trees. Flatten to a path-keyed dict (the structure is recovered from a
    live TrainState at restore)."""
    return dict(_flatten_with_path(opt_state))


# ---------------------------------------------------------------------------
# Committed, resumable checkpoints
# ---------------------------------------------------------------------------


def _marker_key(base_key: str) -> str:
    return f"{base_key}/{COMMIT_MARKER}"


def _slot_key(base_key: str, slot: int) -> str:
    return f"{base_key}/{_SLOTS[slot]}"


def _host_tree(tree: Any) -> Any:
    """Snapshot device tensors to the host now (blocking); a numpy tree
    passes through."""
    return _snapshot_async(tree)()


def _snapshot_async(tree: Any):
    """Two-phase device→host snapshot of a tensor tree.

    Phase 1 (inline): every CUDA leaf is copied into a pinned host buffer
    of its own with a non-blocking copy on the current stream, and one
    event is recorded after the copies; CPU tensors are copied at once;
    numpy leaves pass through. Phase 2 (the returned ``gather()``, run on
    the checkpoint IO thread): wait on the event, then read the buffers as
    numpy (bf16 as ``uint16`` bits). The pinned buffers live in the
    closure, and the returned arrays keep them alive, until nothing
    references them.

    The copies sit on the stream the training step runs on, so the next
    step, which updates params and optimizer state in place under
    ``donate=True``, waits for them on the device: no race, and the host
    is not held up. ``KT_CKPT_INLINE_GATHER=1`` gathers before returning.
    """
    def start(x):
        if not isinstance(x, torch.Tensor):
            return x
        if not x.is_cuda:
            return leaf_to_numpy(x)
        return _Pinned(x.detach())

    staged = tree_map(start, tree)
    event = None
    if any(isinstance(x, _Pinned) for x in tree_leaves(staged)):
        event = torch.cuda.Event()
        event.record()

    def gather():
        if event is not None:
            event.synchronize()
        return tree_map(lambda x: x.numpy() if isinstance(x, _Pinned) else x,
                        staged)

    if os.environ.get("KT_CKPT_INLINE_GATHER", "").strip().lower() in (
            "1", "true", "on"):
        host = gather()
        return lambda: host
    return gather


class _Pinned:
    """A device leaf's pinned host buffer, filled by a non-blocking copy
    issued on the current stream; bf16 travels as its int16 bits."""

    __slots__ = ("buf", "bf16")

    def __init__(self, x: torch.Tensor):
        self.bf16 = x.dtype == torch.bfloat16
        if self.bf16:
            x = x.view(torch.int16)
        self.buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.buf.copy_(x, non_blocking=True)

    def numpy(self) -> np.ndarray:
        host = self.buf.numpy()     # keeps the pinned buffer alive
        return host.view(np.uint16) if self.bf16 else host


def tree_fingerprint(tree: Any) -> str:
    """Content fingerprint of a tree: blake2b over the sorted per-leaf
    (path, content-hash) pairs, composed through ``tree_fingerprint_of_
    hashes``, so it equals the JAX package's for the same bytes (a port
    bf16 tensor hashes as the JAX ml_dtypes leaf it matches). The bit-
    equality gate of every live weight swap (``serve/rollout.py``) and of
    a resumed run against its checkpoint."""
    leaves: Dict[str, Any] = {}
    ds._flatten(tree, "", leaves)
    return ds.tree_fingerprint_of_hashes(ds.hash_leaves(leaves))


def commit_info(base_key: str, store: Any = None
                ) -> Optional[Dict[str, int]]:
    """The committed-checkpoint marker, ``{"step": n, "slot": k}``, or None
    when nothing was ever committed under ``base_key`` (a torn first
    upload counts as never). Read at quorum; a store that fails raises,
    never reads as "start from step 0"."""
    info, _origin = commit_info_ex(base_key, store=store)
    return info


def commit_info_ex(base_key: str, store: Any = None
                   ) -> Tuple[Optional[Dict[str, int]], Optional[str]]:
    """:func:`commit_info` plus the origin that answered: always None, the
    store given (the JAX package's cross-region fallback is not ported)."""
    marker = ds.require_store(store).get_json(_marker_key(base_key),
                                              quorum=True)
    if marker is None:
        return None, None
    try:
        return {"step": int(marker["step"]), "slot": int(marker["slot"])}, None
    except (KeyError, TypeError, ValueError):
        return None, None         # unreadable marker == no commit


class Checkpointer:
    """Commit-marked, delta-synced checkpointing for one job on ``store``.

    ``maybe_save`` is the periodic in-step hook (the device→host copies
    are started inline, gathered and uploaded on the IO thread); ``save``
    is the synchronous commit; ``restore`` returns the last committed
    checkpoint as numpy, never a torn one (the module docstring has the
    protocol).
    """

    def __init__(self, base_key: str, store: Any = None, every: int = 1):
        self.base_key = base_key
        self.store = ds.require_store(store)
        self.every = max(1, int(every))
        self._pending: Optional[Future] = None
        info = commit_info(base_key, store=self.store)
        self._slot: Optional[int] = info["slot"] if info else None
        self.last_committed_step: Optional[int] = info["step"] if info \
            else None

    # -- queries -------------------------------------------------------------

    def committed(self) -> Optional[Dict[str, int]]:
        """A fresh marker read (another writer, or a torn upload, may have
        moved it)."""
        return commit_info(self.base_key, store=self.store)

    def committed_key(self) -> Optional[str]:
        info = self.committed()
        if info is None:
            return None
        return _slot_key(self.base_key, info["slot"])

    # -- saving --------------------------------------------------------------

    def save(self, tree: Any, step: int) -> Dict[str, Any]:
        """Synchronous commit: upload into the non-committed slot, then
        write the marker. Raises on failure, and a failure anywhere before
        the marker leaves the previous commit intact."""
        return self._save_host(_host_tree(tree), step)

    def _save_host(self, host: Any, step: int) -> Dict[str, Any]:
        target = 1 - self._slot if self._slot is not None else 0
        t0 = time.monotonic()
        stats = self.store.put(_slot_key(self.base_key, target), host)
        # marker LAST: this PUT is the commit point
        self.store.put_json(_marker_key(self.base_key),
                            {"step": int(step), "slot": int(target)})
        seconds = time.monotonic() - t0
        _CKPT_SECONDS.observe(seconds, op="save")
        self._slot = target
        self.last_committed_step = step
        return {**stats, "step": step, "slot": target,
                "seconds": round(seconds, 4)}

    def maybe_save(self, tree: Any, step: int) -> Optional["Future[Dict]"]:
        """Every ``every``-th step: start the device→host copies inline
        (observed as ``kt_train_step_seconds{phase="snapshot_stall"}``)
        and commit on the IO thread. At most one upload is in flight: a
        save still running skips this step's snapshot."""
        if step % self.every:
            return None
        if self._pending is not None and not self._pending.done():
            return None
        with telemetry.timed(telemetry.train_metrics()["step_seconds"],
                             phase="snapshot_stall"):
            gather = _snapshot_async(tree)
            self._pending = _CKPT_EXECUTOR.submit(
                lambda: self._save_host(gather(), step))
        return self._pending

    def flush(self, timeout: Optional[float] = None) -> Optional[int]:
        """Wait for the in-flight async save (if any) and return the last
        committed step; a failed upload raises here."""
        if self._pending is not None:
            try:
                self._pending.result(timeout=timeout)
            finally:
                self._pending = None
        return self.last_committed_step

    # -- restoring -----------------------------------------------------------

    def restore(self) -> Optional[Tuple[Any, int]]:
        """(numpy tree, step) of the last committed checkpoint, or None
        when nothing is committed."""
        info = self.committed()
        if info is None:
            return None
        t0 = time.monotonic()
        tree = self.store.get(_slot_key(self.base_key, info["slot"]))
        _CKPT_SECONDS.observe(time.monotonic() - t0, op="restore")
        self._slot = info["slot"]
        self.last_committed_step = info["step"]
        return tree, info["step"]


# ---------------------------------------------------------------------------
# Live weight rollout publishing
# ---------------------------------------------------------------------------


def publish_rollout(service: str, tree: Any, step: int, store: Any = None,
                    *, phase: str = "fleet", canary: Optional[str] = None,
                    key: Optional[str] = None) -> Dict[str, Any]:
    """Trainer side of the online-learning loop: push the serving weight
    tree (only changed leaves move bytes) and then the manifest, the
    commit point: a trainer killed before it leaves the fleet on the old
    version. ``phase="canary"`` with ``canary=<replica-id>`` swaps only
    that replica until a ``phase="fleet"`` publish. Returns ``{**put
    stats, "manifest", "fingerprint"}``."""
    store = ds.require_store(store)
    host = _host_tree(tree)
    fingerprint = tree_fingerprint(host)
    from ..serve import rollout as _rollout

    weights_key = key or _rollout.weights_key(service)
    t0 = time.monotonic()
    stats = store.put(weights_key, host)
    manifest = _rollout.publish_manifest(
        service, key=weights_key, step=int(step), fingerprint=fingerprint,
        phase=phase, canary=canary, store=store,
        index_blake2b=stats.get("index_blake2b"))
    _CKPT_SECONDS.observe(time.monotonic() - t0, op="rollout_publish")
    return {**stats, "manifest": manifest, "fingerprint": fingerprint}


def local_save(path: str, state: TrainState) -> None:
    """A file checkpoint (no store): ``torch.save`` of the train-state
    layout, tensors on the host."""
    tree = tree_map(lambda t: t.detach().cpu(), train_state_tree(state))
    torch.save(tree, path)


def local_restore(path: str, like: TrainState, device=None) -> TrainState:
    """A :func:`local_save` file → the port's ``TrainState`` on ``device``,
    its optimizer state in the structure of ``like``'s."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return train_state_from_tree(tree_map(leaf_to_numpy, tree), like, device)
