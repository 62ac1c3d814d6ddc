"""Consistent-hash ring over the store fleet: the port's copy of
``kubetorch_tpu/data_store/ring.py`` (placement, routing, failover).

- **Placement**, :class:`HashRing`: blake2b of the raw key → a point on the
  ring; a key's replica set is the first R distinct nodes clockwise. The
  same function over the same membership as the JAX client and the store
  nodes, so all agree without coordination.
- **Routing**, :class:`StoreRing`: ``nodes_for`` (the replica set, then
  handoff targets, recently failed nodes last), ``request`` with failover
  along them, the ``X-KT-Ring-Epoch`` header on a multi-node ring and one
  transparent ``/ring`` refresh after a stale-epoch 409.
- **Origin**, :func:`resolve_origin`: an explicit URL first, then
  ``KT_DATA_STORE_URL``, then ``data_store_url`` in the client's config
  file (``KT_CONFIG_PATH``, default ``~/.kt/config``, read when PyYAML
  imports); with none, a typed error.

A seed URL that is itself a comma-separated list names an explicit fleet
(the federation's form, ``a,b,c``); otherwise ``KT_STORE_NODES`` names the
fleet, and without it the ring is the single origin with no extra requests.
Left out: discovering the store through the controller, and the
controller's tunnel for clients outside the cluster.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..exceptions import (CircuitOpenError, DataCorruptionError,
                          DataStoreError, RingEpochMismatch,
                          rehydrate_exception)
from . import netpool

DEFAULT_REPLICATION = 2
DEFAULT_NODE_TTL_S = 30.0
DEFAULT_VNODES = 64

RING_EPOCH_HEADER = "X-KT-Ring-Epoch"
REPLICATED_HEADER = "X-KT-Replicated"

_FAILOVERS = telemetry.counter(
    "kt_store_failovers_total",
    "Client-side failovers to a sibling store replica",
    labels=("kind",))


def _env_number(name: str, default, cast):
    try:
        return cast(os.environ[name])
    except (KeyError, ValueError):
        return default


def replication_factor() -> int:
    """R — how many nodes hold each key (``KT_STORE_REPLICATION``)."""
    return max(1, _env_number("KT_STORE_REPLICATION", DEFAULT_REPLICATION,
                              int))


def suspect_cooldown_s() -> float:
    """How long a failed node stays demoted (``KT_STORE_SUSPECT_COOLDOWN_S``;
    unset or <= 0: ``min(KT_STORE_NODE_TTL_S, 5)``)."""
    v = _env_number("KT_STORE_SUSPECT_COOLDOWN_S", 0.0, float)
    if v > 0:
        return v
    return min(_env_number("KT_STORE_NODE_TTL_S", DEFAULT_NODE_TTL_S, float),
               5.0)


def key_point(key: str) -> int:
    """Position of a raw (unquoted) key on the ring."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Deterministic consistent-hash ring over node base URLs; points come
    from the URLs, so membership order does not matter."""

    def __init__(self, nodes: List[str], vnodes: int = DEFAULT_VNODES):
        self.nodes = sorted({n.rstrip("/") for n in nodes if n})
        self._points: List[Tuple[int, str]] = []
        for node in self.nodes:
            for v in range(vnodes):
                h = int.from_bytes(
                    hashlib.blake2b(f"{node}#{v}".encode(),
                                    digest_size=8).digest(), "big")
                self._points.append((h, node))
        self._points.sort()
        self._keys = [p[0] for p in self._points]

    def walk(self, key: str) -> List[str]:
        """Every node, ordered by ring distance from ``key``."""
        if len(self.nodes) <= 1:
            return list(self.nodes)
        start = bisect_right(self._keys, key_point(key))
        seen: List[str] = []
        n = len(self._points)
        for i in range(n):
            node = self._points[(start + i) % n][1]
            if node not in seen:
                seen.append(node)
                if len(seen) == len(self.nodes):
                    break
        return seen


class StoreRing:
    """Client view of the fleet: placement and liveness-ordered failover.
    ``size == 1`` is the single origin: no epoch header, no failover."""

    def __init__(self, seed_url: str, nodes: Optional[List[str]] = None,
                 epoch: Optional[int] = None):
        self.seed_url = seed_url.rstrip("/")
        self._lock = threading.Lock()
        self.epoch = epoch
        self._ring = HashRing(nodes or [self.seed_url])
        self._down: Dict[str, float] = {}
        self.down_cooldown_s = suspect_cooldown_s()

    @property
    def size(self) -> int:
        return len(self._ring.nodes)

    @property
    def nodes(self) -> List[str]:
        return list(self._ring.nodes)

    def record_failure(self, url: str) -> None:
        with self._lock:
            self._down[url.rstrip("/")] = time.monotonic()

    def record_success(self, url: str) -> None:
        with self._lock:
            self._down.pop(url.rstrip("/"), None)

    def _suspect(self, url: str) -> bool:
        with self._lock:
            ts = self._down.get(url)
            if ts is None:
                return False
            if time.monotonic() - ts > self.down_cooldown_s:
                del self._down[url]
                return False
            return True

    def nodes_for(self, key: str) -> List[str]:
        """The key's replica set, then the rest of the ring as handoff
        targets; recently failed nodes sink to the back of each part."""
        walk = self._ring.walk(key)
        r = replication_factor()
        primary, rest = walk[:r], walk[r:]
        return ([u for u in primary if not self._suspect(u)]
                + [u for u in primary if self._suspect(u)]
                + [u for u in rest if not self._suspect(u)]
                + [u for u in rest if self._suspect(u)])

    def ordered_nodes(self) -> List[str]:
        """All nodes, healthy first (key-less control ops)."""
        nodes = self.nodes
        return ([u for u in nodes if not self._suspect(u)]
                + [u for u in nodes if self._suspect(u)])

    def adopt(self, nodes: List[str], epoch: Optional[int]) -> None:
        with self._lock:
            self._ring = HashRing(nodes)
            self.epoch = epoch
            self._down = {u: ts for u, ts in self._down.items()
                          if u in self._ring.nodes}

    def refresh(self) -> bool:
        """Re-learn membership and epoch from any reachable node's
        ``/ring``; True when a view was adopted."""
        for base in self.ordered_nodes():
            try:
                r = netpool.session().get(f"{base}/ring", timeout=5)
            except netpool.TRANSPORT_ERRORS:
                self.record_failure(base)
                continue
            if r.status_code != 200:
                continue
            try:
                body = r.json()
                nodes = [str(u) for u in body.get("nodes") or []]
                epoch = body.get("epoch")
            except (ValueError, TypeError, AttributeError):
                continue
            if nodes:
                self.adopt(nodes, int(epoch) if epoch is not None else None)
                return True
        return False

    def request(self, method: str, path: str, key: Optional[str] = None,
                timeout: Optional[float] = None, verify=None, **kwargs):
        """``netpool.request`` against the right replica, with failover.

        ``path`` is server-relative (``/kv/<quoted>``); ``key``, when given,
        is the raw key placement hashes. Each candidate gets the full retry
        policy; the router moves on when one is unreachable, circuit-broken
        or still answers 502/503/504; a stale-epoch 409 refreshes the view
        and re-routes (twice at most). ``verify(resp)`` runs on every 200:
        a ``DataCorruptionError`` fails the replica over like a dead one.
        The last candidate's outcome surfaces unchanged. ``data_factory``
        and ``stream`` go through to :func:`netpool.request`: each attempt
        on each candidate gets a fresh body."""
        refreshes = 0
        while True:
            bases = self.nodes_for(key) if key is not None \
                else self.ordered_nodes()
            last_exc: Optional[BaseException] = None
            resp = None
            rerouted = False
            for i, base in enumerate(bases):
                final = i == len(bases) - 1
                headers = dict(kwargs.get("headers") or {})
                if self.epoch is not None and self.size > 1:
                    headers[RING_EPOCH_HEADER] = str(self.epoch)
                kw = dict(kwargs, headers=headers)
                try:
                    resp = netpool.request(method, f"{base}{path}",
                                           timeout=timeout, **kw)
                except CircuitOpenError:
                    last_exc = None
                    if final:
                        raise
                    self._failover("breaker", base)
                    continue
                except netpool.TRANSPORT_ERRORS as e:
                    self.record_failure(base)
                    last_exc = e
                    if final:
                        raise
                    self._failover("connect", base)
                    continue
                if resp.status_code == 409:
                    mism = _epoch_mismatch(resp)
                    if mism is not None:
                        if refreshes < 2 and self.refresh():
                            refreshes += 1
                            self._failover("epoch", base)
                            rerouted = True
                            break
                        raise mism
                if resp.status_code in (502, 503, 504) and not final:
                    self.record_failure(base)
                    self._failover("status", base)
                    continue
                if resp.status_code == 200 and verify is not None:
                    try:
                        verify(resp)
                    except DataCorruptionError:
                        if final:
                            raise
                        self._failover("corruption", base)
                        continue
                self.record_success(base)
                return resp
            if rerouted:
                continue
            if resp is not None:
                return resp
            if last_exc is not None:
                raise last_exc
            raise DataStoreError(
                f"store ring has no reachable node for {path!r}")

    def _failover(self, kind: str, base: str) -> None:
        _FAILOVERS.inc(kind=kind)
        telemetry.add_event("store.failover", kind=kind, node=base)


def _epoch_mismatch(resp) -> Optional[RingEpochMismatch]:
    try:
        data = resp.json()
    except ValueError:
        return None
    if isinstance(data, dict) and data.get("error_type") == "RingEpochMismatch":
        exc = rehydrate_exception(data)
        if isinstance(exc, RingEpochMismatch):
            return exc
    return None


_RINGS: Dict[Tuple[str, Optional[str]], StoreRing] = {}
_RINGS_LOCK = threading.Lock()


def ring_for(seed_url: str) -> StoreRing:
    """The router for ``seed_url``'s fleet, cached per (seed,
    ``KT_STORE_NODES``). A comma-separated seed is an explicit fleet and
    bypasses ``KT_STORE_NODES``; a multi-node ring learns its epoch from
    ``/ring`` when built."""
    seed = seed_url.rstrip("/")
    if "," in seed_url:
        nodes = [u.strip().rstrip("/") for u in seed_url.split(",")
                 if u.strip()]
        cache_key = (seed_url, "__explicit_fleet__")
        seed = nodes[0]
    else:
        env = os.environ.get("KT_STORE_NODES") or None
        cache_key = (seed, env)
        nodes = None
        if env:
            nodes = [u.strip().rstrip("/") for u in env.split(",")
                     if u.strip()]
            if seed not in nodes:
                nodes.append(seed)
    with _RINGS_LOCK:
        ring = _RINGS.get(cache_key)
    if ring is not None:
        return ring
    ring = StoreRing(seed, nodes=nodes)
    if nodes is not None:
        ring.refresh()          # learn the epoch; best-effort
    with _RINGS_LOCK:
        return _RINGS.setdefault(cache_key, ring)


def reset_rings() -> None:
    with _RINGS_LOCK:
        _RINGS.clear()


def _config_store_url() -> Optional[str]:
    path = os.environ.get("KT_CONFIG_PATH",
                          os.path.expanduser("~/.kt/config"))
    if not os.path.isfile(path):
        return None
    try:
        import yaml
    except ImportError:
        return None
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    url = data.get("data_store_url") if isinstance(data, dict) else None
    return str(url) if url else None


def resolve_origin(explicit: Optional[str] = None) -> str:
    """The seed store URL: ``explicit``, else ``KT_DATA_STORE_URL``, else
    the config file's ``data_store_url``; with none, a typed error."""
    if explicit:
        return explicit.rstrip("/")
    url = os.environ.get("KT_DATA_STORE_URL") or _config_store_url()
    if not url:
        raise DataStoreError(
            "No data store configured (set KT_DATA_STORE_URL or "
            "config.data_store_url, or pass store_url=)")
    return url.rstrip("/")
