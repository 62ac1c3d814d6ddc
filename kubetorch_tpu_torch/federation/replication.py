"""The cross-region store tier: the port's copy of
``kubetorch_tpu/federation/replication.py``.

Writes stay in their region's ring, where the ring's own quorum keeps
them; :class:`XRegionReplicator` copies them to other regions' rings
asynchronously (list, diff, push what is missing) and exposes the lag as
``kt_store_xregion_lag_seconds{region}`` instead of hiding it. Two rules
make a lagging copy resumable:

- **Markers land last.** Within a sweep data leaves push first, pytree
  indexes (``.__kt_index__``) second, commit markers (``__kt_commit__``)
  last (:func:`_key_tier`), so a reader that sees a marker in the other
  region finds the whole slot it names; a sweep cut off halfway leaves the
  target on its previous committed checkpoint.
- **Newest wins.** A marker or index is pushed only when the source's
  ``stored_at`` is not older than the target's, so a workload already
  writing in the target region is never rolled back by a stale sweep;
  ``stored_at`` travels unchanged with every push.

Its scope is the kv surface (pytree leaves and indexes, JSON control
values: what ``put`` and ``put_json`` write, so every checkpoint and
rollout key); directory trees move through ktsync, not here. The read side
is :func:`fallback_commit`, which ``train/checkpoint.py`` asks when its
own ring has no answer.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import telemetry
from ..data_store import commands as ds
from ..data_store import netpool, ring
from ..exceptions import DataStoreError
from . import topology

_INDEX_SUFFIX = ".__kt_index__"
_MARKER_NAME = "__kt_commit__"


def _key_tier(key: str) -> int:
    """Push order within a sweep: data leaves (0) < pytree indexes (1) <
    commit markers (2); a marker never outruns the slot it points at."""
    if key.endswith(f"/{_MARKER_NAME}") or key == _MARKER_NAME:
        return 2
    if key.endswith(_INDEX_SUFFIX):
        return 1
    return 0


class XRegionReplicator:
    """One pump from a source region's ring to target regions' rings.

    ``source`` and each target are ring seeds: one URL or a comma-joined
    explicit fleet (``topology.store_spec`` renders them). ``prefixes``
    bounds a sweep to the key namespaces worth shipping (checkpoint bases,
    rollout manifests); empty means every kv key. ``lag_s`` holds each
    region's lag at its last sweep."""

    def __init__(self, source: str, targets: Dict[str, str],
                 prefixes: Tuple[str, ...] = (), interval_s: float = 5.0):
        self.source = source
        self.targets = dict(targets)
        self.prefixes = tuple(prefixes)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.lag_s: Dict[str, float] = {r: 0.0 for r in targets}
        self._metrics = telemetry.xregion_metrics()

    def _source_keys(self) -> List[Dict[str, Any]]:
        r = ring.ring_for(self.source).request(
            "GET", "/keys", timeout=netpool.store_timeout(30))
        if r.status_code != 200:
            raise DataStoreError(
                f"xregion sweep: /keys failed ({r.status_code})")
        keys = [k for k in (r.json().get("keys") or [])
                if k.get("kind") == "kv"]
        if self.prefixes:
            keys = [k for k in keys
                    if any(k["key"].startswith(p) for p in self.prefixes)]
        return keys

    @staticmethod
    def _head_meta(spec: str, key: str) -> Optional[Dict[str, Any]]:
        try:
            r = ring.ring_for(spec).request(
                "HEAD", f"/kv/{netpool.urlkey(key)}", key=key,
                timeout=netpool.store_timeout(15))
        except (*netpool.TRANSPORT_ERRORS, DataStoreError):
            return None
        if r.status_code != 200:
            return None
        return ds._response_meta(r)

    def sweep(self) -> Dict[str, Any]:
        """One anti-entropy round against every target region: ``{keys,
        targets: {region: {pushed, skipped, failed, lag_s}}}``. A target
        that cannot be reached costs recorded lag and an error count,
        never an exception."""
        keys = sorted(self._source_keys(), key=lambda k: _key_tier(k["key"]))
        source_meta: Dict[str, Dict[str, Any]] = {}
        for entry in keys:
            meta = self._head_meta(self.source, entry["key"])
            if meta and meta.get("blake2b"):
                source_meta[entry["key"]] = meta
        report: Dict[str, Any] = {"keys": len(source_meta), "targets": {}}
        for region, spec in self.targets.items():
            report["targets"][region] = self._sync_target(
                region, spec, keys, source_meta)
        return report

    def _sync_target(self, region: str, spec: str,
                     keys: List[Dict[str, Any]],
                     source_meta: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        now = time.time()
        pushed, skipped, failed = 0, 0, []
        with telemetry.span("fed.xregion_sweep", region=region,
                            keys=len(source_meta)):
            current = ds._kv_diff(spec, {k: m["blake2b"]
                                         for k, m in source_meta.items()})
            for entry in keys:               # tier order
                key = entry["key"]
                meta = source_meta.get(key)
                if meta is None:
                    continue
                if key in current:
                    skipped += 1
                    continue
                if _key_tier(key) > 0:
                    # a mutable value: never roll the target back
                    tmeta = self._head_meta(spec, key)
                    if tmeta and float(tmeta.get("stored_at") or 0.0) \
                            > float(meta.get("stored_at") or 0.0):
                        skipped += 1
                        continue
                try:
                    self._push(spec, key, meta)
                    pushed += 1
                    self._metrics["pushed"].inc(region=region)
                except (*netpool.TRANSPORT_ERRORS, DataStoreError):
                    self._metrics["errors"].inc(region=region)
                    failed.append(key)
        # the age of the oldest write the target still lacks, 0 converged
        pending_ts = [float(source_meta[k].get("stored_at") or now)
                      for k in failed]
        lag = (now - min(pending_ts)) if pending_ts else 0.0
        self.lag_s[region] = lag
        self._metrics["lag"].set(lag, region=region)
        self._metrics["pending"].set(float(len(failed)), region=region)
        return {"pushed": pushed, "skipped": skipped,
                "failed": len(failed), "lag_s": round(lag, 3)}

    def _push(self, spec: str, key: str, meta: Dict[str, Any]) -> None:
        r = ring.ring_for(self.source).request(
            "GET", f"/kv/{netpool.urlkey(key)}", key=key,
            timeout=netpool.store_timeout())
        if r.status_code != 200:
            raise DataStoreError(
                f"xregion push: source GET {key!r} → {r.status_code}")
        # stored_at travels as written (the store keeps a stored_at a PUT
        # carries), so newest-wins compares against the original write
        push_meta = {k: v for k, v in ds._response_meta(r).items()
                     if k != "size"}
        push_meta.setdefault("stored_at", meta.get("stored_at"))
        ds._kv_put(spec, key, r.content, push_meta)

    def start(self) -> "XRegionReplicator":
        """Sweep every ``interval_s`` on a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kt-fed-xregion")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sweep()
            except Exception as e:  # noqa: BLE001 - the pump outlives a sweep
                telemetry.add_event("fed.xregion_sweep_failed",
                                    error=str(e)[:200])
            self._stop.wait(self.interval_s)

    def status(self) -> Dict[str, Any]:
        return {"source": self.source,
                "targets": {r: {"lag_s": round(self.lag_s.get(r, 0.0), 3)}
                            for r in self.targets}}


def fallback_commit(base_key: str, exclude: Optional[str] = None
                    ) -> Optional[Tuple[Dict[str, int], str]]:
    """``base_key``'s commit marker from another region's ring.

    Quorum-reads the marker on every region ``KT_FED_STORES`` declares,
    less ``exclude`` (the ring the caller already asked) and this
    process's own region, and returns ``(marker, store spec)`` for the
    newest committed step found, or None."""
    from ..train import checkpoint as ckpt

    best: Optional[Tuple[Dict[str, int], str]] = None
    for _region, spec in topology.fallback_store_specs(exclude).items():
        try:
            marker = ds.get_json(ckpt._marker_key(base_key), store_url=spec,
                                 quorum=True)
        except (*netpool.TRANSPORT_ERRORS, DataStoreError):
            continue
        if marker is None:
            continue
        try:
            info = {"step": int(marker["step"]), "slot": int(marker["slot"])}
        except (KeyError, TypeError, ValueError):
            continue
        if best is None or info["step"] > best[0]["step"]:
            best = (info, spec)
    if best is not None:
        telemetry.add_event("fed.fallback_commit", key=base_key,
                            step=best[0]["step"], origin=best[1][:120])
    return best
