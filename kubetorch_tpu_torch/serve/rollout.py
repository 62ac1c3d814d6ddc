"""Live weight rollout: the port's copy of ``kubetorch_tpu/serve/rollout.py``.

THE weight-swap site: a running :class:`~kubetorch_tpu_torch.serve.engine.
GenerationEngine` has its weights changed from nowhere else, because a swap
that skips this path skips every guarantee the online-learning loop rests
on (train, checkpoint, publish, then swap live between decode batches):

- **Delta fetch, off the decode thread.** The trainer pushes the weight
  tree through the store's content-addressed ``put`` (only changed leaves
  move bytes) and then publishes a *rollout manifest* with ``put_json``
  (``train.checkpoint.publish_rollout``). Each replica's
  :class:`WeightRollout` polls the manifest, diffs the index's per-leaf
  blake2b hashes against its own verified ledger, and fetches exactly the
  changed leaves. The store is an argument (``data_store/commands.py``
  has the protocol); the JAX package's broadcast tree between pods is not
  ported, so every byte comes from the store (``kt_rollout_bytes_total
  {source="origin"}``).
- **Bit-equality gate before any swap.** The fetched index's composed
  fingerprint must equal the manifest's ``fingerprint``, the trainer's
  ``tree_fingerprint`` of the tree it published; the tree's structure
  must be the engine's; every staged leaf must have the engine leaf's
  shape and dtype. Any failure is a typed :class:`~kubetorch_tpu_torch.
  exceptions.RolloutError` with the JAX package's ``reason``, and the
  engine is untouched: a replica is always wholly on one version.
- **Swap between decode batches, in place.** The swap runs on the engine's
  stepping thread through ``engine.at_batch_boundary``, so no decode step
  is in flight. Leaf by leaf, it stashes the old bytes on the host (the
  rollback needs no refetch) and then writes the new bytes into the tensor
  the engine already holds, with ``copy_`` from host memory: the engine's
  dict, its views and any other holder of the tensor see the new weights,
  and the swap takes no device memory. (The JAX swap deletes each old
  device buffer and lands a new one with ``device_put``, so any other
  holder of the old buffer fails.) A numpy tree (:class:`HostEngine`) has
  its leaves replaced instead, as in JAX.
- **Canary-first, rollback.** A ``phase="canary"`` manifest swaps only the
  named replica; :class:`CanaryRollout` pins a router slice to it, bakes,
  then promotes (``phase="fleet"``) or publishes a ``phase="rollback"``
  manifest, which the canary applies from its stash.

The gate maps the store's dtype names onto torch's: ``bfloat16`` (a JAX
host tree's ml_dtypes leaf) and ``uint16`` (the port's own bf16 hand-off,
``models.convert.params_to_numpy``) onto ``torch.bfloat16``; ``float32``,
``int8`` and ``uint8`` onto themselves (the dtypes of plain and quantized
weights). No weight the port serves is held in ``uint16``, so that name
is free; any other name is refused.

Telemetry, with the JAX package's names and help texts:
``kt_rollout_seconds{phase}`` (fetch, stage, swap, verify),
``kt_rollout_bytes_total{source}``, ``kt_rollout_rollbacks_total{reason}``
and the ``kt_rollout_version`` gauge. The JAX ``rollout.swap`` span is not
ported; a manifest's ``trace`` field is carried and never read.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import telemetry
from ..data_store import commands as ds
from ..exceptions import RolloutError

_ROLLOUT_SECONDS = telemetry.histogram(
    "kt_rollout_seconds",
    "Live weight rollout wall-clock per phase "
    "(fetch: delta over the broadcast tree; stage: host staging + "
    "fingerprint gate; swap: batch-boundary donation swap; verify: "
    "post-swap ledger/fingerprint check)",
    labels=("phase",))
_ROLLOUT_BYTES = telemetry.counter(
    "kt_rollout_bytes_total",
    "Rollout delta bytes moved, by serving source (origin: the store "
    "ring; peer: the P2P broadcast tree / pod cache)",
    labels=("source",))
_ROLLBACKS = telemetry.counter(
    "kt_rollout_rollbacks_total",
    "Weight rollbacks applied, by reason",
    labels=("reason",))
_ROLLOUT_VERSION = telemetry.gauge(
    "kt_rollout_version",
    "Rollout manifest version this process's engine is serving")

# the store's dtype names → the engine leaf's torch dtype (module docstring)
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "uint16": torch.bfloat16,
                 "float32": torch.float32, "int8": torch.int8,
                 "uint8": torch.uint8}

# live WeightRollout instances in this process (the status surface)
_LOCAL: "weakref.WeakSet[WeightRollout]" = weakref.WeakSet()


def manifest_key(service: str) -> str:
    return f"rollout/{service}/manifest"


def weights_key(service: str) -> str:
    return f"rollout/{service}/weights"


def read_manifest(service: str, store: Any = None) -> Optional[Dict]:
    """The fleet's current rollout manifest, read at quorum; None when no
    rollout has ever been published for ``service``."""
    m = ds.require_store(store).get_json(manifest_key(service), quorum=True)
    return m if isinstance(m, dict) else None


def publish_manifest(service: str, *, key: str, step: Optional[int] = None,
                     fingerprint: Optional[str] = None,
                     phase: str = "fleet", canary: Optional[str] = None,
                     reason: Optional[str] = None, store: Any = None,
                     version: Optional[int] = None,
                     index_blake2b: Optional[str] = None) -> Dict:
    """Write the rollout manifest with ``put_json`` (the PUT is the commit
    point: replicas act only on what this publishes). ``version``
    auto-increments over the previous manifest. The manifest is the JAX
    package's; its ``trace`` is None (spans are not ported)."""
    if phase not in ("canary", "fleet", "rollback"):
        raise ValueError(f"unknown rollout phase {phase!r}")
    prev = read_manifest(service, store=store)
    if version is None:
        version = (int(prev.get("version", 0)) + 1) if prev else 1
    manifest = {
        "service": service,
        "version": int(version),
        "key": key,
        "step": None if step is None else int(step),
        "fingerprint": fingerprint,
        "phase": phase,
        "canary": canary,
        "reason": reason,
        "index_blake2b": index_blake2b,
        "published_at": round(time.time(), 6),
        "trace": None,
    }
    store.put_json(manifest_key(service), manifest)
    return manifest


def local_status() -> List[Dict]:
    """Status of every live rollout coordinator in this process."""
    return [w.status() for w in list(_LOCAL)]


# ---------------------------------------------------------------------------
# pytree path helpers (paths are commands._flatten's "a/b/0/c" shape)
# ---------------------------------------------------------------------------


def _get_leaf(tree: Any, path: str) -> Any:
    node = tree
    for part in path.split("/"):
        if isinstance(node, dict):
            node = node[part]
        elif isinstance(node, (list, tuple)):
            node = node[int(part)]
        else:
            raise KeyError(path)
    return node


def _set_leaf(tree: Any, path: str, value: Any) -> None:
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        if isinstance(node, dict):
            node = node[part]
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            raise RolloutError(
                f"cannot swap into immutable container at {path!r}",
                reason="immutable_container")
    last = parts[-1]
    if isinstance(node, dict):
        node[last] = value
    elif isinstance(node, list):
        node[int(last)] = value
    else:
        raise RolloutError(
            f"cannot swap into immutable container at {path!r}",
            reason="immutable_container")


def _same_dtype(host: np.ndarray, cur: Any) -> bool:
    if isinstance(cur, torch.Tensor):
        return _TORCH_DTYPES.get(str(host.dtype)) == cur.dtype
    return str(host.dtype) == str(cur.dtype)


def _host_tensor(host: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor over ``host``'s bytes (no copy), of ``dtype``: a
    2-byte leaf bound for bf16 goes through an int16 view."""
    host = np.asarray(host, order="C")
    if dtype == torch.bfloat16:
        return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(host)


# ---------------------------------------------------------------------------
# the per-replica coordinator
# ---------------------------------------------------------------------------


class WeightRollout:
    """One engine's live-rollout coordinator.

    ``engine`` is any object with a mutable ``params`` tree and the
    ``at_batch_boundary(fn, timeout=)`` contract: :class:`~kubetorch_tpu_torch.
    serve.engine.GenerationEngine`, or :class:`HostEngine` on the CPU.
    ``store`` is the store (``data_store/commands.py``); ``replica_id`` is
    how canary manifests name this replica (defaults to ``POD_IP``, then
    the hostname).

    Drive it with :meth:`poll_once` or :meth:`start` the background poll
    thread. One apply at a time (an internal lock); ``status()`` is safe
    from any thread.
    """

    def __init__(self, engine: Any, service: str, *,
                 replica_id: Optional[str] = None, store: Any = None,
                 poll_s: float = 2.0, swap_timeout_s: float = 120.0):
        import socket

        self.engine = engine
        self.service = service
        self.store = ds.require_store(store)
        self.replica_id = (replica_id or os.environ.get("POD_IP")
                           or socket.gethostname())
        self.poll_s = float(poll_s)
        self.swap_timeout_s = float(swap_timeout_s)
        self.version = 0
        self.step: Optional[int] = None
        self.phase: Optional[str] = None
        self.fingerprint: Optional[str] = None
        self.applied_at: Optional[float] = None
        self.last_error: Optional[str] = None
        self.bytes_moved = {"origin": 0, "peer": 0}
        self.swaps = 0
        self.rollbacks = 0
        # the thread the last swap ran on (the engine's stepping thread)
        self.last_swap_thread: Optional[str] = None
        self._leaf_hashes: Optional[Dict[str, str]] = None
        # pre-swap stash of the LAST swap's replaced leaves (host, delta-
        # sized): what makes rollback a local batch-boundary swap
        self._undo: Optional[Dict[str, Any]] = None
        self._apply_lock = threading.Lock()
        self._swapping = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _LOCAL.add(self)

    # -- ledger --------------------------------------------------------------

    def _ensure_ledger(self) -> None:
        """Per-leaf content hashes of the engine's CURRENT params. Computed
        once (every leaf pulled to the host and hashed: the price of
        joining the verified world from unverified initial weights); every
        later apply updates it from already-verified index hashes."""
        if self._leaf_hashes is not None:
            return
        leaves: Dict[str, Any] = {}
        ds._flatten(self.engine.params, "", leaves)
        self._leaf_hashes = ds.hash_leaves(leaves)
        self.fingerprint = ds.tree_fingerprint_of_hashes(self._leaf_hashes)

    # -- polling -------------------------------------------------------------

    def poll_once(self) -> Optional[Dict]:
        """Read the manifest and converge toward it. Returns the apply/
        rollback summary when something changed, None otherwise.
        RolloutError from a bad manifest is recorded on ``last_error`` and
        re-raised."""
        manifest = read_manifest(self.service, store=self.store)
        if manifest is None:
            return None
        try:
            version = int(manifest.get("version", 0))
        except (TypeError, ValueError):
            return None
        if version <= self.version:
            return None
        phase = manifest.get("phase", "fleet")
        if phase == "canary" and manifest.get("canary") != self.replica_id:
            # non-canary replicas never swap on a canary manifest: they
            # wait for the fleet promotion (or absorb the rollback bump)
            return None
        try:
            if phase == "rollback":
                return self._apply_rollback(manifest)
            return self.apply(manifest)
        except RolloutError as e:
            self.last_error = str(e)
            raise

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except RolloutError:
                pass                     # recorded on last_error
            except Exception as e:       # noqa: BLE001 — poll must survive
                self.last_error = str(e)
            self._stop.wait(self.poll_s)

    def start(self) -> "WeightRollout":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="kt-weight-rollout")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- apply ---------------------------------------------------------------

    def apply(self, manifest: Dict) -> Dict:
        with self._apply_lock:
            return self._apply_locked(manifest)

    def _fetch(self, key: str, index: Dict, paths: List[str],
               version: int) -> Dict[str, np.ndarray]:
        def one(path):
            arr = self.store.get_leaf(key, path, index["leaves"][path])
            if arr is None:
                raise RolloutError(
                    f"rollout v{version}: missing leaf {key}/{path}",
                    reason="missing_leaf", version=version)
            return path, arr

        if not paths:
            return {}
        with ThreadPoolExecutor(max_workers=min(8, len(paths))) as ex:
            return dict(ex.map(one, paths))

    def _apply_locked(self, manifest: Dict) -> Dict:
        version = int(manifest["version"])
        key = manifest.get("key") or weights_key(self.service)
        m_fp = manifest.get("fingerprint")

        # ---- fetch: the index, checked against the manifest's content
        # address, then only the changed leaves, off the decode thread
        t0 = time.monotonic()
        index = self.store.get_index(key,
                                     expect_hash=manifest.get("index_blake2b"))
        if index is None:
            raise RolloutError(
                f"rollout v{version}: weights index {key!r} not in the "
                "store", reason="missing_index", version=version)
        target = {p: m["blake2b"] for p, m in index["leaves"].items()}
        want_fp = ds.tree_fingerprint_of_hashes(target)
        if m_fp is not None and want_fp != m_fp:
            # the index does not add up to what the trainer committed:
            # refuse before moving bulk bytes or touching the engine
            raise RolloutError(
                f"rollout v{version}: index fingerprint {want_fp} != "
                f"manifest {m_fp}", reason="fingerprint_mismatch",
                version=version, expected=m_fp, actual=want_fp)
        self._ensure_ledger()
        if set(target) != set(self._leaf_hashes):
            raise RolloutError(
                f"rollout v{version}: weight tree structure changed "
                f"({len(target)} leaves vs engine's "
                f"{len(self._leaf_hashes)}) — a live engine cannot change "
                "compiled shapes; redeploy instead",
                reason="structure_mismatch", version=version)
        changed = [p for p in target if target[p] != self._leaf_hashes[p]]
        staged = self._fetch(key, index, changed, version)
        nbytes = sum(int(a.nbytes) for a in staged.values())
        self.bytes_moved["origin"] += nbytes
        _ROLLOUT_BYTES.inc(nbytes, source="origin")
        _ROLLOUT_SECONDS.observe(time.monotonic() - t0, phase="fetch")

        # ---- stage: shape/dtype gate against the engine's leaves
        t0 = time.monotonic()
        for path, arr in staged.items():
            cur = _get_leaf(self.engine.params, path)
            if (tuple(arr.shape) != tuple(cur.shape)
                    or not _same_dtype(arr, cur)):
                raise RolloutError(
                    f"rollout v{version}: leaf {path!r} is "
                    f"{arr.dtype}{tuple(arr.shape)}, engine holds "
                    f"{cur.dtype}{tuple(cur.shape)} — the compiled "
                    "step's shapes are frozen",
                    reason="shape_mismatch", version=version)
        _ROLLOUT_SECONDS.observe(time.monotonic() - t0, phase="stage")

        # ---- swap: between decode batches, leaf by leaf, in place
        t0 = time.monotonic()
        self._swapping = True
        try:
            undo = self.engine.at_batch_boundary(
                lambda: self._swap_leaves(staged),
                timeout=self.swap_timeout_s)
        finally:
            self._swapping = False
        _ROLLOUT_SECONDS.observe(time.monotonic() - t0, phase="swap")

        # ---- verify: ledger + composed fingerprint bit-equality
        t0 = time.monotonic()
        old_hashes = {p: self._leaf_hashes[p] for p in changed}
        self._undo = {"version": self.version,
                      "fingerprint": self.fingerprint,
                      "leaves": undo, "hashes": old_hashes}
        self._leaf_hashes.update({p: target[p] for p in changed})
        got_fp = ds.tree_fingerprint_of_hashes(self._leaf_hashes)
        if m_fp is not None and got_fp != m_fp:
            raise RolloutError(
                f"rollout v{version}: post-swap fingerprint "
                f"{got_fp} != manifest {m_fp}",
                reason="verify_failed", version=version,
                expected=m_fp, actual=got_fp)
        self.fingerprint = got_fp
        self.version = version
        self.step = manifest.get("step")
        self.phase = manifest.get("phase", "fleet")
        self.applied_at = time.time()
        self.swaps += 1
        self.last_error = None
        _ROLLOUT_VERSION.set(version)
        _ROLLOUT_SECONDS.observe(time.monotonic() - t0, phase="verify")
        return {"version": version, "leaves_changed": len(changed),
                "fingerprint": got_fp, "bytes": {"store": nbytes}}

    def _swap_leaves(self, staged: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """The swap (stepping thread, between batches): per leaf, stash the
        old bytes on the host for rollback, then write the new bytes into
        the engine's tensor in place (a synchronous copy from host memory,
        done before the next leaf). A numpy leaf is replaced in its
        container, as the JAX swap replaces every leaf."""
        self.last_swap_thread = threading.current_thread().name
        params = self.engine.params
        undo: Dict[str, Any] = {}
        for path, host_new in staged.items():
            cur = _get_leaf(params, path)
            if isinstance(cur, torch.Tensor):
                undo[path] = ds.host_leaf(cur)      # a host copy of its own
                cur.copy_(_host_tensor(host_new, cur.dtype))
            else:
                undo[path] = np.array(cur, copy=True)
                _set_leaf(params, path, host_new)
        return undo

    # -- rollback ------------------------------------------------------------

    def _apply_rollback(self, manifest: Dict) -> Dict:
        with self._apply_lock:
            version = int(manifest["version"])
            reason = manifest.get("reason") or "manifest"
            target_fp = manifest.get("fingerprint")
            self._ensure_ledger()
            if target_fp is not None and target_fp == self.fingerprint:
                # never swapped to the bad version (non-canary replica, or
                # a replica that already rolled back): adopt the version
                # number, touch nothing
                self.version = version
                self.phase = "rollback"
                _ROLLOUT_VERSION.set(version)
                return {"version": version, "rolled_back": False,
                        "fingerprint": self.fingerprint}
            undo = self._undo
            if undo is None or (target_fp is not None
                                and undo["fingerprint"] != target_fp):
                if manifest.get("key") and target_fp is not None:
                    # no matching local stash (e.g. replica restarted):
                    # converge by an ordinary verified apply toward the
                    # good version the manifest names
                    out = self._apply_locked(manifest)
                    self.rollbacks += 1
                    _ROLLBACKS.inc(reason=reason)
                    return out
                raise RolloutError(
                    f"rollback v{version}: no pre-swap stash and no "
                    "target weights to refetch", reason="no_undo",
                    version=version)
            t0 = time.monotonic()
            self._swapping = True
            try:
                self.engine.at_batch_boundary(
                    lambda: self._swap_leaves(undo["leaves"]),
                    timeout=self.swap_timeout_s)
            finally:
                self._swapping = False
            _ROLLOUT_SECONDS.observe(time.monotonic() - t0, phase="swap")
            self._leaf_hashes.update(undo["hashes"])
            self.fingerprint = ds.tree_fingerprint_of_hashes(
                self._leaf_hashes)
            self.version = version
            self.step = manifest.get("step")
            self.phase = "rollback"
            self.applied_at = time.time()
            self.rollbacks += 1
            self._undo = None
            _ROLLBACKS.inc(reason=reason)
            _ROLLOUT_VERSION.set(version)
            return {"version": version, "rolled_back": True,
                    "fingerprint": self.fingerprint}

    # -- introspection -------------------------------------------------------

    def status(self) -> Dict:
        return {
            "service": self.service,
            "replica": self.replica_id,
            "version": self.version,
            "step": self.step,
            "phase": self.phase,
            "fingerprint": self.fingerprint,
            "applied_at": self.applied_at,
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "swapping": self._swapping,
            "bytes": dict(self.bytes_moved),
            "last_error": self.last_error,
            "polling": self._thread is not None and self._thread.is_alive(),
        }


# ---------------------------------------------------------------------------
# canary-first control
# ---------------------------------------------------------------------------


class CanaryRollout:
    """Fleet-level canary-first driver over any router with
    ``set_canary(replica, fraction=)``, ``canary_verdict(min_requests=,
    ttft_factor=, err_threshold=)`` and ``clear_canary()``.

    Publishes the new version as a canary manifest (only the named replica
    swaps), pins a slice of router traffic to it, and bakes: a
    ``"regressed"`` verdict publishes a rollback manifest to the previous
    fingerprint; a clean bake promotes to ``phase="fleet"``.
    """

    def __init__(self, service: str, router: Any, *, store: Any = None,
                 slice_fraction: float = 0.1, bake_s: float = 10.0,
                 min_requests: int = 20, ttft_factor: float = 2.0,
                 err_threshold: float = 0.05, poll_s: float = 0.25):
        self.service = service
        self.router = router
        self.store = ds.require_store(store)
        self.slice_fraction = slice_fraction
        self.bake_s = bake_s
        self.min_requests = min_requests
        self.ttft_factor = ttft_factor
        self.err_threshold = err_threshold
        self.poll_s = poll_s

    def run(self, publish, canary_replica: str) -> str:
        """Drive one canary-first rollout. ``publish(phase=..., canary=...)``
        is the trainer-side publisher (typically a partial of
        ``train.checkpoint.publish_rollout`` over the new tree), called once
        for the canary manifest and, on a clean bake, once more for the
        fleet promotion. Returns ``"promoted"`` or ``"rolled_back"``. A
        first-ever rollout promotes directly: there is no good version to
        regress against or roll back to."""
        prev = read_manifest(self.service, store=self.store)
        if prev is None or not prev.get("fingerprint"):
            publish(phase="fleet")
            return "promoted"
        publish(phase="canary", canary=canary_replica)
        self.router.set_canary(canary_replica,
                               fraction=self.slice_fraction)
        verdict = "warming"
        deadline = time.monotonic() + self.bake_s
        try:
            while time.monotonic() < deadline:
                verdict = self.router.canary_verdict(
                    min_requests=self.min_requests,
                    ttft_factor=self.ttft_factor,
                    err_threshold=self.err_threshold)
                if verdict == "regressed":
                    break
                time.sleep(self.poll_s)
        finally:
            self.router.clear_canary()
        if verdict == "regressed":
            publish_manifest(
                self.service, key=prev["key"], step=prev.get("step"),
                fingerprint=prev["fingerprint"], phase="rollback",
                reason="canary_regression", store=self.store)
            return "rolled_back"
        publish(phase="fleet")
        return "promoted"


# ---------------------------------------------------------------------------
# CPU-proxy engine (tests)
# ---------------------------------------------------------------------------


class HostEngine:
    """Host-side engine stand-in with the exact swap contract
    ``WeightRollout`` needs (a mutable ``params`` tree, a stepping loop,
    ``at_batch_boundary``), so the rollout path is drivable without a
    model. Each "decode batch" advances every in-flight request one token
    and touches a param leaf, so a torn swap would show as an exception or
    a dropped request."""

    def __init__(self, params: Dict[str, Any], step_s: float = 0.001):
        self.params = params
        self.step_s = float(step_s)
        self.steps = 0
        # the same continuous-learning tap as GenerationEngine.feedback_sink
        self.feedback_sink = None
        self._req_seq = 0
        self._reqs: List[Dict[str, Any]] = []
        self._hooks: "deque[tuple]" = deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def submit(self, n_tokens: int = 4) -> Dict[str, Any]:
        req = {"left": int(n_tokens), "done": threading.Event(),
               "error": None}
        with self._lock:
            # a unique id per engine: a feedback ledger dedups records by
            # content, so two requests retiring alike must not hash alike
            self._req_seq += 1
            req["id"] = self._req_seq
            self._reqs.append(req)
        self._work.set()
        return req

    def at_batch_boundary(self, fn, timeout: Optional[float] = None):
        thread = self._thread
        if (thread is None or not thread.is_alive()
                or threading.current_thread() is thread):
            return fn()
        box: Dict[str, Any] = {"done": threading.Event()}
        self._hooks.append((fn, box))
        self._work.set()
        if not box["done"].wait(timeout):
            raise TimeoutError("HostEngine batch boundary not reached")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _step_once(self) -> int:
        while self._hooks:
            fn, box = self._hooks.popleft()
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001
                box["error"] = e
            finally:
                box["done"].set()
        with self._lock:
            active = list(self._reqs)
        for req in active:
            try:
                # touch a leaf: a half-swapped tree (missing leaf, None
                # placeholder) would throw here and fail the request
                leaves: Dict[str, Any] = {}
                ds._flatten(self.params, "", leaves)
                next(iter(leaves.values())).ravel()[0]
                req["left"] -= 1
            except Exception as e:      # noqa: BLE001
                req["error"] = e
                req["left"] = 0
            if req["left"] <= 0:
                with self._lock:
                    if req in self._reqs:
                        self._reqs.remove(req)
                if self.feedback_sink is not None:
                    try:
                        self.feedback_sink({
                            "request_id": req.get("id"),
                            "generated": int(req.get("tokens", 0)),
                            "error": (str(req["error"])[:120]
                                      if req.get("error") else None),
                            "step": self.steps})
                    except Exception:  # noqa: BLE001 — never stall stepping
                        pass
                req["done"].set()
        self.steps += 1
        if self.step_s:
            time.sleep(self.step_s)
        with self._lock:
            return len(self._reqs)

    def _run(self) -> None:
        while not self._stop.is_set():
            n = self._step_once()
            if n == 0 and not self._hooks:
                self._work.clear()
                self._work.wait(timeout=0.1)

    def start(self) -> "HostEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="kt-host-engine")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
