"""The port's data-store client: its copy of
``kubetorch_tpu/data_store/commands.py`` (``put``/``get``/``ls``/``rm``,
``put_json``/``get_json``, the broadcast window, the P2P broadcast tree,
directory trees through ktsync, ``sync.py``),
the store protocol its checkpoint and rollout take, and
:class:`HttpStore`, that protocol over a store by URL.

**The wire** is the JAX client's (``data_store/netpool.py`` speaks it on
the standard library): a pytree is one ``/kv/<key>/<path>`` per leaf and
its index ``<key>.__kt_index__`` (``{"leaves": {path: {"dtype",
"shape", "kind": "array", "blake2b"}}, "structure"}``) written last;
every leaf PUT carries its blake2b in ``X-KT-Meta``; a ``POST /kv/diff``
first asks which leaves the store holds current, and their bytes do not
move (``put`` returns ``{leaves, bytes, skipped, index_blake2b}``). So a
tree either client puts, the other reads bitwise, and a repeated put
moves 0 bytes.

**Getting.** :func:`get` returns numpy host arrays with neither
``device`` nor ``mesh``, as JAX's ``get`` does with no sharding. With
``device=`` each leaf lands as a tensor there: its fetch worker decodes
it into the worker's pinned host buffer and copies it to the device on
the worker's stream, so leaf k's copy runs behind leaf k+1's transfer (as
JAX's ``_get_pytree`` puts ``device_put`` in the worker); the worker
waits on its last copy before the buffer is used again, and ``get`` waits
on every worker's before it returns. With ``mesh=`` and ``rules=`` each
leaf becomes a DTensor placed by ``rules.placements_for(path, mesh)``:
the rank cuts its own block out of the host bytes and copies only that
to the device (``DTensor.from_local``), so no rank holds a whole sharded
leaf on the device.

**Dtype names.** numpy has no bf16. A torch bf16 leaf is put under the
name ``bfloat16`` (what the JAX package's ml_dtypes leaf records) with
its bits; a ``bfloat16`` leaf lands as ``torch.bfloat16`` on a device and
as its ``uint16`` bits in a numpy tree. A numpy ``uint16`` leaf (the
port's host form of bf16, ``models.convert.params_to_numpy``) lands as
``torch.bfloat16`` where ``like`` holds a bf16 tensor at its path, as the
rollout's gate maps it.

**The broadcast tree** (:class:`_RoutedFetcher`): the store's ``/route``
names a parent pod that already holds the key, or the store itself; a
leaf comes from the pod cache (``peer_cache.py``), then the parent's
``/_kt/data/``, then the store, every source checked against the index's
blake2b (a corrupt cache entry is evicted; a corrupt or dead parent is
reported on ``/route/failed`` and, up to ``KT_ROUTE_RETRIES`` times, a
fresh parent is asked for); each fetched leaf is cached, and one
``/route/complete`` makes this pod a parent. A parent that runs the
fabric's ``ktblobd`` (its address ``http://$POD_IP:$KT_BLOBD_PORT``, sent
as ``self_blob_url`` on ``/route`` and as ``blob_url`` on
``/route/complete``) serves its cache entries' files from the daemon:
the child asks ``/blob/<entry hash>.json`` (its key must match) and then
``.bin``, and takes the parent's ``/_kt/data/`` only when the daemon
cannot be reached or answers garbage. Per-source bytes are on
``bytes_by_source`` (a daemon's bytes count as ``peer``); each fetch is a
``store.fetch`` span and counts in ``kt_store_fetches_total{source}``,
its bytes in the port's ``kt_store_fetch_bytes_total{source}``. Peer mode
is on inside a pod (``POD_IP`` set) unless ``peer=`` says otherwise.

**Directory trees**: ``put`` of a directory pushes it with ktsync
(``sync.push_tree``), and ``get(key, dest=)`` of a key whose
``/tree/<key>/manifest`` answers pulls it there (``sync.pull_tree``).

**The store protocol** that ``train/checkpoint.py`` and
``serve/rollout.py`` take as ``store=`` (every caller goes through
:func:`require_store`; ``store=None`` raises ``TypeError``):

- ``put(key, tree) -> dict``: store a pytree as above.
- ``get(key) -> tree``: the pytree of numpy arrays; raises when ``key``
  holds none.
- ``put_json(key, obj) -> dict``: one small JSON value, re-put in place
  (commit markers, rollout manifests).
- ``get_json(key, quorum=False, default=None)``: that value, ``default``
  when the key is absent; ``quorum=True`` reads every replica and takes
  the newest.
- ``get_index(key, expect_hash=None) -> dict | None``: the pytree index
  of ``key``, None when absent; given ``expect_hash``, the index's bytes
  must hash to it or the call raises.
- ``get_leaf(key, path, meta) -> np.ndarray | None``: one leaf, decoded
  to ``meta``'s dtype and shape, its bytes checked against
  ``meta["blake2b"]`` (raises on a mismatch); None when absent.
- optional, ``url``: the ring spec of a store reached by URL
  (``HttpStore``). The checkpoint reads a legacy pytree marker, and in a
  federation the other regions' rings, only from such a store.
- optional, ``reader(key, peer=None, content_alias=False)``: a
  :class:`TreeReader` of its own. :func:`reader` takes it where a store
  has one (``HttpStore``: the broadcast tree) and otherwise reads through
  ``get_index``/``get_leaf``, so a caller of :func:`reader` has one path
  for every store.

**Copied** from the JAX module under its names, besides the client:
``_INDEX_SUFFIX``, ``_is_arraylike`` (which here also takes a torch
tensor), ``_flatten``, ``_structure_of``, ``_unflatten``, ``_leaf_buffer``,
``_leaf_hash``, ``tree_fingerprint_of_hashes``, ``_verify_content`` and
``_response_meta``. :func:`hash_leaves` is the port's own: ``_leaf_hash``
over many leaves at once.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import telemetry
from ..exceptions import DataCorruptionError, DataStoreError
from ..models.convert import leaf_to_numpy
from . import netpool, ring
from .ring import resolve_origin as _store_url
from .types import BroadcastWindow

_FETCHES = telemetry.counter(
    "kt_store_fetches_total",
    "Blob/leaf fetches by serving source",
    labels=("source",))
_FETCH_BYTES = telemetry.counter(
    "kt_store_fetch_bytes_total",
    "Bytes of blob/leaf fetches by serving source",
    labels=("source",))

_INDEX_SUFFIX = ".__kt_index__"


def require_store(store: Any) -> Any:
    """``store``, or ``TypeError`` when it is None (no default store)."""
    if store is None:
        raise TypeError(
            "store is required: an object with put/get/put_json/get_json/"
            "get_index/get_leaf (kubetorch_tpu_torch/data_store/commands.py); "
            "the port has no default store")
    return store


def _is_arraylike(obj: Any) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    return (type(obj).__module__.startswith("numpy")
            and hasattr(obj, "dtype") and hasattr(obj, "shape"))


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if _is_arraylike(tree):
        out[prefix or "value"] = tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}" if prefix else str(i), out)
        return
    raise TypeError(f"Unsupported leaf {type(tree).__name__} in pytree")


def _structure_of(tree: Any) -> Any:
    if _is_arraylike(tree):
        return "leaf"
    if isinstance(tree, dict):
        return {k: _structure_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure_of(v) for v in tree]
    raise TypeError(f"Unsupported node {type(tree).__name__}")


def _unflatten(structure: Any, prefix: str, leaves: Dict[str, Any]) -> Any:
    if structure == "leaf":
        return leaves[prefix or "value"]
    if isinstance(structure, dict):
        return {k: _unflatten(v, f"{prefix}/{k}" if prefix else str(k), leaves)
                for k, v in structure.items()}
    if isinstance(structure, list):
        return [_unflatten(v, f"{prefix}/{i}" if prefix else str(i), leaves)
                for i, v in enumerate(structure)]
    raise ValueError("corrupt pytree index")


def _leaf_buffer(host):
    """Zero-copy bytes-like view of a leaf's raw bytes. Reinterprets the
    buffer as uint8 first: numpy refuses to export buffers for extension
    dtypes (ml_dtypes bfloat16 raises ``ValueError: cannot include dtype
    in a buffer``), but a uint8 view of the same memory always exports.
    Falls back to a tobytes copy for non-contiguous or otherwise
    unviewable arrays."""
    if host.flags["C_CONTIGUOUS"]:
        try:
            return host.reshape(-1).view(np.uint8).data
        except (ValueError, TypeError):
            pass
    return host.tobytes()


def _leaf_hash(host) -> str:
    """blake2b-20 of the leaf's raw bytes — the content address the delta
    protocol diffs on."""
    return hashlib.blake2b(_leaf_buffer(host), digest_size=20).hexdigest()


def tree_fingerprint_of_hashes(leaf_hashes: Dict[str, str]) -> str:
    """Compose per-leaf content hashes into ONE pytree fingerprint:
    blake2b over the sorted (path, leaf-blake2b) pairs. The single
    definition every fingerprint comparer shares — a trainer's
    ``train.checkpoint.tree_fingerprint`` of its live state, a rollout
    manifest's claimed fingerprint, and a serving replica's ledger of
    already-verified leaf hashes (``serve/rollout.py``) are bit-comparable
    *because* they all compose through here."""
    h = hashlib.blake2b(digest_size=20)
    for path in sorted(leaf_hashes):
        h.update(path.encode())
        h.update(leaf_hashes[path].encode())
    return h.hexdigest()


def host_leaf(x: Any) -> np.ndarray:
    """A leaf as a C-contiguous host array: a tensor through
    ``leaf_to_numpy`` (a copy; bf16 as ``uint16`` bits), numpy as it is."""
    if isinstance(x, torch.Tensor):
        return leaf_to_numpy(x)
    return np.asarray(x, order="C")


def hash_leaves(leaves: Dict[str, Any]) -> Dict[str, str]:
    """``_leaf_hash`` of every leaf of a ``_flatten``ed tree, several at a
    time: hashlib drops the GIL on large buffers, so the threads add up.
    Device tensors reach the host inside the workers, on a side stream
    that first waits for the work queued so far, so a decode loop on the
    default stream runs on beside the copies; at most one leaf per worker
    is on the host at once."""
    side = None
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves.values()):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())

    def one(item):
        path, x = item
        if side is not None and isinstance(x, torch.Tensor) and x.is_cuda:
            with torch.cuda.stream(side):
                host = host_leaf(x)
        else:
            host = host_leaf(x)
        return path, _leaf_hash(host)

    workers = max(1, min(8, os.cpu_count() or 1, len(leaves)))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return dict(ex.map(one, leaves.items()))


def _is_pytree_of_arrays(obj: Any) -> bool:
    if _is_arraylike(obj):
        return True
    if isinstance(obj, dict) and obj:
        return all(_is_pytree_of_arrays(v) for v in obj.values())
    if isinstance(obj, (list, tuple)) and obj:
        return all(_is_pytree_of_arrays(v) for v in obj)
    return False


def _response_meta(r) -> Dict:
    try:
        return json.loads(r.headers.get("X-KT-Meta") or "{}")
    except ValueError:
        return {}


def _verify_content(content, meta: Dict, expect_hash: Optional[str],
                    key: str, source: str) -> None:
    """End-to-end integrity check on fetched bytes against ``expect_hash``
    (the index's record) or the meta's blake2b; a key stored without one
    is unverifiable. Raises :class:`DataCorruptionError`."""
    want = expect_hash or (meta or {}).get("blake2b")
    if not want:
        return
    actual = hashlib.blake2b(content, digest_size=20).hexdigest()
    if actual != want:
        raise DataCorruptionError(
            f"content hash mismatch fetching {key!r} from {source}: "
            f"expected {want}, got {actual}",
            key=key, expected=want, actual=actual, source=source)


# ---------------------------------------------------------------------------
# put
# ---------------------------------------------------------------------------


def put(key: str, src: Any, store_url: Optional[str] = None,
        broadcast: Optional[BroadcastWindow] = None) -> Dict:
    """Store a file or a pytree of arrays (torch tensors or numpy) under
    ``key``. With ``broadcast=`` the put then joins the store-side quorum
    barrier for the key's group, as the producer."""
    url = _store_url(store_url)
    if broadcast is not None:
        result = put(key, src, store_url=url)
        join_broadcast(key, broadcast, store_url=url, member="producer")
        return result
    if isinstance(src, (str, os.PathLike)):
        path = os.fspath(src)
        if os.path.isdir(path):
            from .sync import push_tree
            return push_tree(url, key, path)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return _kv_put(url, key, f.read(), {"kind": "file"})
        raise DataStoreError(f"put: path {path!r} does not exist")
    if _is_pytree_of_arrays(src):
        return _put_pytree(url, key, src)
    raise DataStoreError(
        f"put: unsupported payload type {type(src).__name__}; expected a "
        "path, an array, or a pytree of arrays")


def _put_pytree(url: str, key: str, tree: Any) -> Dict:
    leaves: Dict[str, Any] = {}
    _flatten(tree, "", leaves)
    index: Dict[str, Any] = {"leaves": {}, "structure": _structure_of(tree)}
    # hash every leaf first (one /kv/diff decides which leaves move);
    # host copies are not kept across the pass: a leaf that uploads is
    # staged again in its worker, so host memory stays one leaf a worker
    hashes = hash_leaves(leaves)
    for path, x in leaves.items():
        index["leaves"][path] = {"dtype": dtype_name(x),
                                 "shape": [int(d) for d in x.shape],
                                 "kind": "array", "blake2b": hashes[path]}
    current = _kv_diff(
        url, {f"{key}/{p}": m["blake2b"] for p, m in index["leaves"].items()})
    to_upload = [p for p in leaves if f"{key}/{p}" not in current]

    def _upload(path: str) -> int:
        host = host_leaf(leaves[path])
        _kv_put(url, f"{key}/{path}", _leaf_buffer(host),
                index["leaves"][path])
        return host.nbytes

    total = sum(netpool.map_concurrent(_upload, to_upload))
    # the index lands last: a reader that sees it sees complete leaves
    index_bytes = json.dumps(index).encode()
    index_hash = hashlib.blake2b(index_bytes, digest_size=20).hexdigest()
    _kv_put(url, f"{key}{_INDEX_SUFFIX}", index_bytes, {"kind": "index"})
    return {"leaves": len(leaves), "bytes": total,
            "skipped": len(leaves) - len(to_upload),
            "index_blake2b": index_hash}


def _kv_diff(url: str, hashes: Dict[str, str]) -> set:
    """The keys of ``hashes`` the store already holds current
    (``{keys: {key: blake2b}} → {missing: [...]}``, the body compressed
    past ``COMPRESS_MIN_BYTES``). A store without the endpoint, or any
    failure, skips nothing."""
    if not hashes:
        return set()
    try:
        payload = json.dumps({"keys": hashes}).encode()
        headers = {"Content-Type": "application/json",
                   "Accept-Encoding": netpool.offered_codings()}
        coding = netpool.best_coding(netpool.offered_codings())
        if coding and len(payload) >= netpool.COMPRESS_MIN_BYTES:
            payload = netpool.compress_body(payload, coding)
            headers["Content-Encoding"] = coding
        r = ring.ring_for(url).request("POST", "/kv/diff", data=payload,
                                       headers=headers,
                                       timeout=netpool.store_timeout(60))
        if r.status_code != 200:
            return set()
        body = r.content
        resp_coding = (r.headers.get("Content-Encoding") or "").lower()
        if resp_coding in ("zstd", "zlib"):
            body = netpool.decompress_body(body, resp_coding)
        return set(hashes) - set(json.loads(body)["missing"])
    except (*netpool.TRANSPORT_ERRORS, ValueError, KeyError, DataStoreError):
        return set()


def _kv_put(url: str, key: str, data, meta: Dict) -> Dict:
    # routed on the raw key: the PUT lands on the key's primary replica
    # and fails over along its replica set
    r = ring.ring_for(url).request(
        "PUT", f"/kv/{netpool.urlkey(key)}", key=key, data=data,
        headers={"X-KT-Meta": json.dumps(meta)},
        timeout=netpool.store_timeout())
    if r.status_code != 200:
        raise DataStoreError(f"put {key!r} failed: {r.status_code} "
                             f"{r.text[:200]}")
    return r.json()


# ---------------------------------------------------------------------------
# get, through the P2P broadcast tree
# ---------------------------------------------------------------------------


def _server_port() -> int:
    """This pod's server port: ``KT_SERVER_PORT``, else 32300 (the JAX
    package's ``constants.server_port``)."""
    try:
        return int(os.environ.get("KT_SERVER_PORT") or 32300)
    except ValueError:
        return 32300


class _RoutedFetcher:
    """Fetch subkeys of one key through the store-coordinated fan-out (the
    module docstring has the protocol). Thread-safe: one fetcher serves
    every worker of a get; the route resolves once under ``_lock``, the
    peer's no-progress window (``KT_PEER_WAIT_S``, 60 s) is shared, and
    ``/route/complete`` fires at most once.

    ``content_alias=True`` keys the pod cache and the parent's route by
    ``subkey@hash12`` instead of the subkey, so a key re-put in place (a
    rollout's weights) rides the tree without a parent ever serving the
    previous version's bytes; the store is always asked for the subkey."""

    def __init__(self, store_url: str, key: str, peer: Optional[bool],
                 content_alias: bool = False):
        self.store_url = store_url
        self.key = key
        self.content_alias = bool(content_alias)
        self.ring = ring.ring_for(store_url)
        self.enabled = (bool(os.environ.get("POD_IP"))
                        if peer is None else bool(peer))
        self.peer_url: Optional[str] = None
        self.peer_blob_url: Optional[str] = None
        self._resolved = False
        self._fetched = False
        self._deadline: Optional[float] = None
        self._lock = threading.Lock()
        self._complete_sent = False
        self._reroutes = 0
        try:
            self._max_reroutes = int(os.environ.get("KT_ROUTE_RETRIES", "2"))
        except ValueError:
            self._max_reroutes = 2
        self.bytes_by_source: Dict[str, int] = {}

    def _sess(self) -> netpool.Session:
        return netpool.session()

    def _coord_url(self) -> str:
        """The key's primary replica coordinates its fan-out, so every pod
        asks the same node and the tree stays one tree."""
        nodes = self.ring.nodes_for(self.key)
        return nodes[0] if nodes else self.store_url

    def head(self, subkey: str) -> bool:
        """Existence probe against the store only."""
        try:
            r = self.ring.request("HEAD", f"/kv/{netpool.urlkey(subkey)}",
                                  key=subkey, timeout=netpool.store_timeout(30))
            return r.status_code == 200
        except (*netpool.TRANSPORT_ERRORS, DataStoreError):
            return False

    def _self_url(self) -> Optional[str]:
        ip = os.environ.get("POD_IP")
        if not ip:
            return None
        return f"http://{ip}:{_server_port()}"

    @staticmethod
    def _self_blob_url() -> Optional[str]:
        """This pod's ``ktblobd`` address (the fabric's pod server spawns
        the daemon and exports ``KT_BLOBD_PORT``), None without one."""
        ip = os.environ.get("POD_IP")
        port = os.environ.get("KT_BLOBD_PORT")
        if ip and port:
            return f"http://{ip}:{port}"
        return None

    def _resolve(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self._resolved:
                return
            self._resolved = True
            try:
                r = self._sess().post(
                    f"{self._coord_url()}/route",
                    json={"key": self.key, "self_url": self._self_url(),
                          "self_blob_url": self._self_blob_url()}, timeout=10)
                body = r.json() if r.status_code == 200 else {}
                if body.get("source") == "peer":
                    self.peer_url = body["url"]
                    self.peer_blob_url = body.get("blob_url")
            except netpool.TRANSPORT_ERRORS:
                self.peer_url = None

    def fetch(self, subkey: str, timeout: Optional[float] = None,
              expect_hash: Optional[str] = None):
        """GET one subkey in a ``store.fetch`` span tagged with the source
        (``pod-cache``, ``peer``, ``store``) and the byte count."""
        return self._fetch_sourced(subkey, timeout, expect_hash)[0]

    def _fetch_sourced(self, subkey: str, timeout: Optional[float] = None,
                       expect_hash: Optional[str] = None):
        """:meth:`fetch`, and the source that answered."""
        sp = (telemetry.span("store.fetch", key=subkey) if telemetry.enabled()
              else telemetry.NOOP_SPAN)
        with sp:
            r, source = self._fetch_inner(subkey, timeout, expect_hash, sp)
            if sp:
                sp.set_attr("status", r.status_code)
                sp.set_attr("bytes", len(r.content))
        return r, source

    def _fetch_inner(self, subkey: str, timeout: Optional[float],
                     expect_hash: Optional[str], sp):
        """The pod cache, then the assigned parent, then the store; every
        200 is hash-checked. A parent's 404 means "not yet" (the rolling
        join) until its no-progress window is spent; a parent that cannot
        be reached, is corrupt or stays silent is evicted. Only bytes the
        store itself serves corrupt surface, as ``DataCorruptionError``."""
        if timeout is None:
            timeout = netpool.store_timeout()
        ck = self._peer_key(subkey, expect_hash)
        if self.enabled:
            from .peer_cache import cache_evict, cache_get
            hit = cache_get(ck)
            if hit is not None:
                try:
                    _verify_content(hit[0], hit[1], expect_hash, subkey,
                                    "pod-cache")
                    self._fetched = True
                    sp.set_attr("source", "pod-cache")
                    _FETCHES.inc(source="pod-cache")
                    self._account("pod-cache", hit[0])
                    return _CachedResponse(*hit), "pod-cache"
                except DataCorruptionError:
                    cache_evict(ck)
        while True:
            # resolve inside the loop: an eviction that armed a re-route
            # cleared _resolved, so this pass asks for a fresh parent
            self._resolve()
            with self._lock:
                peer = self.peer_url
                if peer is not None and self._deadline is None:
                    self._deadline = time.monotonic() + float(
                        os.environ.get("KT_PEER_WAIT_S", "60"))
            if peer is None:
                break
            try:
                r = self._fetch_from_peer(ck, timeout)
            except netpool.TRANSPORT_ERRORS:
                if self._evict_peer(peer):
                    continue
                break
            if r.status_code == 200:
                try:
                    _verify_content(r.content, _response_meta(r),
                                    expect_hash, subkey, "peer")
                except DataCorruptionError:
                    if self._evict_peer(peer):
                        continue
                    break
                with self._lock:
                    if self.peer_url == peer:
                        self._deadline = None    # progress re-arms it
                self._cache(ck, r)
                sp.set_attr("source", "peer")
                _FETCHES.inc(source="peer")
                self._account("peer", r.content)
                return r, "peer"
            if r.status_code != 404:
                break
            with self._lock:
                expired = (self.peer_url == peer
                           and self._deadline is not None
                           and time.monotonic() >= self._deadline)
            if expired:
                if self._evict_peer(peer):
                    continue
                break
            time.sleep(0.25)

        def _verify(resp):
            _verify_content(resp.content, _response_meta(resp), expect_hash,
                            subkey, "store")

        r = self.ring.request("GET", f"/kv/{netpool.urlkey(subkey)}",
                              key=subkey, timeout=timeout, verify=_verify)
        if r.status_code == 200:
            self._cache(ck, r)
            _FETCHES.inc(source="store")
            self._account("store", r.content)
        sp.set_attr("source", "store")
        return r, "store"

    def _peer_key(self, subkey: str, expect_hash: Optional[str]) -> str:
        if self.content_alias and expect_hash:
            return f"{subkey}@{expect_hash[:12]}"
        return subkey

    def _account(self, source: str, content) -> None:
        with self._lock:
            self.bytes_by_source[source] = (
                self.bytes_by_source.get(source, 0) + len(content))
        _FETCH_BYTES.inc(len(content), source=source)

    def _evict_peer(self, peer: str) -> bool:
        """Drop ``peer`` as parent (the first evictor wins), report it on
        ``/route/failed`` and, within ``KT_ROUTE_RETRIES``, arm a fresh
        ``/route``. True when a re-route was armed."""
        with self._lock:
            if self.peer_url != peer:
                return False
            self.peer_url = None
            self.peer_blob_url = None
            self._deadline = None
            reroute = self._reroutes < self._max_reroutes
            if reroute:
                self._reroutes += 1
                self._resolved = False
        try:
            self._sess().post(f"{self._coord_url()}/route/failed",
                              json={"key": self.key, "url": peer}, timeout=10)
        except netpool.TRANSPORT_ERRORS:
            pass
        return reroute

    def _fetch_from_peer(self, subkey: str, timeout: float):
        """One attempt at the parent: its ``ktblobd`` first, when it runs
        one (the entry's meta, then its bytes), else its ``/_kt/data/``.
        The daemon's 404 is the pod route's "not yet". A daemon that cannot
        be reached or answers garbage turns the fast path off for this
        fetcher; the parent is then judged by its pod route."""
        peer_url, blob_url = self.peer_url, self.peer_blob_url
        if peer_url is None:
            raise ConnectionError("the parent was evicted by another worker")
        if blob_url is not None:
            from .peer_cache import entry_hash
            h = entry_hash(subkey)
            try:
                # the meta lands last in cache_put, so its presence says
                # the .bin is whole
                rm = self._sess().get(f"{blob_url}/blob/{h}.json", timeout=30)
                if rm.status_code == 200:
                    entry = json.loads(rm.content)
                    if entry.get("key") == subkey:
                        rb = self._sess().get(f"{blob_url}/blob/{h}.bin",
                                              timeout=timeout)
                        if rb.status_code == 200:
                            return _CachedResponse(rb.content,
                                                   entry.get("meta", {}))
                elif rm.status_code == 404:
                    return rm
            except (*netpool.TRANSPORT_ERRORS, ValueError, AttributeError):
                self.peer_blob_url = None
        return self._sess().get(f"{peer_url}/_kt/data/{netpool.urlkey(subkey)}",
                                timeout=timeout)

    def _cache(self, subkey: str, r) -> None:
        if not self.enabled or self._self_url() is None:
            return
        from .peer_cache import cache_put
        try:
            cache_put(subkey, r.content, _response_meta(r))
            self._fetched = True
        except OSError:
            pass                    # cache full or unwritable: still a getter

    def complete(self) -> None:
        """Become a parent for later joiners, once, when holding data."""
        self_url = self._self_url()
        if not (self.enabled and self._fetched and self_url):
            return
        with self._lock:
            if self._complete_sent:
                return
            self._complete_sent = True
        try:
            self._sess().post(f"{self._coord_url()}/route/complete",
                              json={"key": self.key, "url": self_url,
                                    "blob_url": self._self_blob_url()},
                              timeout=10)
        except netpool.TRANSPORT_ERRORS:
            pass


class _CachedResponse:
    """A pod-cache hit in the shape of a store response."""

    status_code = 200

    def __init__(self, content: bytes, meta: Dict):
        self.content = content
        self.headers = {"X-KT-Meta": json.dumps(meta)} if meta else {}


def get(key: str, dest: Optional[str] = None, store_url: Optional[str] = None,
        device=None, mesh=None, rules=None, like: Any = None,
        peer: Optional[bool] = None) -> Any:
    """Fetch ``key``: a pytree (numpy, tensors on ``device``, or DTensors
    on ``mesh`` by ``rules``; the module docstring), a file (to ``dest``,
    else its bytes), an array, or a directory tree (into ``dest``, which
    it needs; returns the pull's stats). Inside a pod, bytes ride the broadcast
    tree; ``peer=False`` reads the store only. The key's kind is probed
    with HEADs on the store first."""
    if (mesh is None) != (rules is None):
        raise ValueError("get onto a mesh needs both mesh= and rules=")
    url = _store_url(store_url)
    fetcher = _RoutedFetcher(url, key, peer)
    place = Placement(device, mesh, rules, like)

    if fetcher.head(f"{key}{_INDEX_SUFFIX}"):
        r = fetcher.fetch(f"{key}{_INDEX_SUFFIX}", timeout=60)
        tree = _get_pytree(key, json.loads(r.content), fetcher, place)
        fetcher.complete()
        return tree
    if fetcher.head(key):
        r = fetcher.fetch(key)
        if r.status_code == 200:
            return _finish_raw(r, dest, place, fetcher)
    r = ring.ring_for(url).request(
        "GET", f"/tree/{netpool.urlkey(key)}/manifest", key=key,
        timeout=netpool.store_timeout(60))
    if r.status_code == 200:
        if not dest:
            raise DataStoreError(f"get: {key!r} is a directory tree; pass dest=")
        from .sync import pull_tree
        return pull_tree(url, key, dest)
    # the store lost the key, but parents may hold it (the tail of a
    # rolling broadcast): probe the tree for the index, then the raw key
    if fetcher.enabled:
        r = fetcher.fetch(f"{key}{_INDEX_SUFFIX}", timeout=60)
        if r.status_code == 200:
            tree = _get_pytree(key, json.loads(r.content), fetcher, place)
            fetcher.complete()
            return tree
        r = fetcher.fetch(key)
        if r.status_code == 200:
            return _finish_raw(r, dest, place, fetcher)
    raise DataStoreError(f"get: no such key {key!r}")


def _finish_raw(r, dest, place: "Placement", fetcher: _RoutedFetcher) -> Any:
    meta = _response_meta(r)
    fetcher.complete()
    if meta.get("kind") == "array":
        return place.land("value", r.content, meta)
    if dest:
        with open(dest, "wb") as f:
            f.write(r.content)
        return dest
    return bytes(r.content)


def _get_pytree(key: str, index: Dict, fetcher: _RoutedFetcher,
                place: "Placement") -> Any:
    def one(item):
        path, meta = item
        r = fetcher.fetch(f"{key}/{path}", expect_hash=meta.get("blake2b"))
        if r.status_code != 200:
            raise DataStoreError(f"get: missing leaf {key}/{path}")
        # decode and the device copy run in the worker: leaf k's copy
        # runs behind leaf k+1's transfer
        return path, place.land(path, r.content, meta)

    try:
        pairs = netpool.map_concurrent(one, index["leaves"].items())
    finally:
        place.finish()
    return _unflatten(index["structure"], "", dict(pairs))


_HOST_DTYPES = {"bfloat16": np.uint16}
_TORCH_OF = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float16": torch.float16, "float64": torch.float64,
             "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
             "uint16": torch.uint16, "int32": torch.int32,
             "int64": torch.int64, "bool": torch.bool}


_NAME_OF = {v: k for k, v in _TORCH_OF.items()}


def dtype_name(x: Any) -> str:
    """The index's dtype name of a leaf: numpy's name, and for a tensor
    the name of its numpy twin (``bfloat16`` for bf16, which JAX's
    ml_dtypes leaf records too)."""
    if isinstance(x, torch.Tensor):
        try:
            return _NAME_OF[x.dtype]
        except KeyError:
            raise DataStoreError(f"no store dtype for {x.dtype}") from None
    return str(np.asarray(x).dtype)


def host_dtype(name: str) -> np.dtype:
    """numpy's dtype for an index dtype name (``bfloat16``: its ``uint16``
    bits)."""
    return np.dtype(_HOST_DTYPES.get(name, name))


def torch_dtype(name: str, like: Optional[torch.dtype] = None) -> torch.dtype:
    """torch's dtype for an index dtype name; ``uint16`` is bf16 where
    ``like`` is."""
    if name == "uint16" and like == torch.bfloat16:
        return torch.bfloat16
    try:
        return _TORCH_OF[name]
    except KeyError:
        raise DataStoreError(f"leaf dtype {name!r} has no torch dtype") from None


def decode_array(data, meta: Dict) -> np.ndarray:
    """A leaf's bytes as a numpy array of ``meta``'s dtype and shape,
    decoded into a new buffer (bf16 as ``uint16``)."""
    arr = np.empty(meta["shape"], dtype=host_dtype(meta["dtype"]))
    view = arr.reshape(-1).view(np.uint8)
    if view.nbytes != len(data):
        raise DataStoreError(
            f"leaf byte-size mismatch: body is {len(data)}B, meta "
            f"{meta['dtype']}{meta['shape']} needs {view.nbytes}B")
    view[:] = np.frombuffer(data, dtype=np.uint8)
    return arr


def _like_dtype(like: Any, path: str) -> Optional[torch.dtype]:
    if like is None:
        return None
    node = like
    for part in path.split("/"):
        if isinstance(node, dict):
            node = node.get(part)
        elif isinstance(node, (list, tuple)) and part.isdigit() \
                and int(part) < len(node):
            node = node[int(part)]
        else:
            return None
    return node.dtype if isinstance(node, torch.Tensor) else None


class Placement:
    """Where one get lands its leaves: numpy (no device, no mesh), a
    device, or a mesh by rules. On a device each worker thread keeps one
    pinned host buffer, one stream and the event of its last copy."""

    def __init__(self, device, mesh, rules, like):
        self.mesh, self.rules, self.like = mesh, rules, like
        self.device = None
        if mesh is not None:
            self.device = torch.device(mesh.device_type)
        elif device is not None:
            from ..models.common import resolve_device
            self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._workers: Dict[int, list] = {}

    def land(self, path: str, data, meta: Dict) -> Any:
        if self.device is None:
            return decode_array(data, meta)
        dtype = torch_dtype(meta["dtype"], _like_dtype(self.like, path))
        shape = tuple(meta["shape"])
        if len(data):
            with warnings.catch_warnings():
                # read only: the bytes are copied out, never written
                warnings.simplefilter("ignore", UserWarning)
                host = torch.frombuffer(data, dtype=torch.uint8)
        else:
            host = torch.empty(0, dtype=torch.uint8)
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if host.numel() != want:
            raise DataStoreError(
                f"leaf byte-size mismatch: body is {host.numel()}B, meta "
                f"{meta['dtype']}{list(shape)} needs {want}B")
        whole = host.view(dtype).view(shape)
        if self.mesh is None:
            return self._to_device(whole)
        from torch.distributed.tensor import DTensor

        from ..parallel.sharding import local_slice
        placements = self.rules.placements_for(path, self.mesh)
        local = self._to_device(local_slice(whole, self.mesh, placements))
        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False, shape=whole.shape,
                                  stride=whole.stride())

    def _to_device(self, src: torch.Tensor) -> torch.Tensor:
        """``src`` (host) copied to the device: on the CPU a copy, on CUDA
        through this worker's pinned buffer and stream, asynchronously."""
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        if self.device.type != "cuda":
            out.copy_(src)
            return out
        nbytes = out.numel() * out.element_size()
        if nbytes == 0:
            return out
        with self._lock:
            state = self._workers.setdefault(threading.get_ident(),
                                             [None, None, None])
        buf, stream, event = state
        if event is not None:
            event.synchronize()      # the buffer's last copy has finished
        if buf is None or buf.numel() < nbytes:
            buf = state[0] = torch.empty(nbytes, dtype=torch.uint8,
                                         pin_memory=True)
        if stream is None:
            stream = state[1] = torch.cuda.Stream(device=self.device)
        staged = buf[:nbytes].view(src.dtype).view(src.shape)
        staged.copy_(src)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out.copy_(staged, non_blocking=True)
        out.record_stream(stream)
        event = state[2] = torch.cuda.Event()
        event.record(stream)
        return out

    def finish(self) -> None:
        """Wait for every worker's last copy: the caller's stream then sees
        complete leaves, and the pinned buffers may go."""
        with self._lock:
            states = list(self._workers.values())
            self._workers.clear()
        for _buf, _stream, event in states:
            if event is not None:
                event.synchronize()


def join_broadcast(key: str, window: BroadcastWindow,
                   store_url: Optional[str] = None,
                   member: Optional[str] = None) -> List[str]:
    """Join the quorum barrier for ``key`` (on the key's ring primary);
    returns the member list once ``window.world_size`` have arrived."""
    import socket
    import uuid

    url = _store_url(store_url)
    member = member or f"{socket.gethostname()}-{uuid.uuid4().hex[:6]}"
    r = ring.ring_for(url).request("POST", "/barrier", key=key, json={
        "group": window.group_id or f"bcast/{key}",
        "world_size": window.world_size,
        "member": member,
        "timeout": window.timeout,
    }, timeout=window.timeout + 10)
    if r.status_code == 408:
        data = r.json()
        raise DataStoreError(
            f"Broadcast window for {key!r} timed out: "
            f"{len(data['joined'])}/{data['world_size']} joined")
    if r.status_code != 200:
        raise DataStoreError(f"barrier join failed: {r.status_code}")
    return r.json()["members"]


def get_broadcast(key: str, window: BroadcastWindow,
                  store_url: Optional[str] = None, **get_kwargs) -> Any:
    """Consumer side of a coordinated broadcast: join the window, then
    :func:`get` (``device``/``mesh``/``rules`` pass through)."""
    join_broadcast(key, window, store_url=store_url)
    return get(key, store_url=store_url, **get_kwargs)


# ---------------------------------------------------------------------------
# ls / rm
# ---------------------------------------------------------------------------


def ls(prefix: str = "", store_url: Optional[str] = None) -> List[Dict]:
    url = _store_url(store_url)
    r = ring.ring_for(url).request("GET", "/keys", params={"prefix": prefix},
                                   timeout=netpool.store_timeout(60))
    if r.status_code != 200:
        raise DataStoreError(f"ls failed: {r.status_code}")
    return [k for k in r.json()["keys"] if not k["key"].endswith(_INDEX_SUFFIX)]


def rm(key: str, store_url: Optional[str] = None) -> bool:
    url = _store_url(store_url)
    rg = ring.ring_for(url)
    timeout = netpool.store_timeout(60)
    existed = False
    index_key = f"{key}{_INDEX_SUFFIX}"
    r = rg.request("GET", f"/kv/{netpool.urlkey(index_key)}", key=index_key,
                   timeout=timeout)
    if r.status_code == 200:
        index = json.loads(r.content)
        netpool.map_concurrent(
            lambda path: rg.request(
                "DELETE", f"/kv/{netpool.urlkey(key + '/' + path)}",
                key=f"{key}/{path}", timeout=timeout),
            index["leaves"])
        rg.request("DELETE", f"/kv/{netpool.urlkey(index_key)}",
                   key=index_key, timeout=timeout)
        existed = True
    rd = rg.request("DELETE", f"/kv/{netpool.urlkey(key)}", key=key,
                    timeout=timeout)
    existed = existed or (rd.status_code == 200 and rd.json().get("existed"))
    rt = rg.request("DELETE", f"/tree/{netpool.urlkey(key)}", key=key,
                    timeout=timeout)
    existed = existed or (rt.status_code == 200 and rt.json().get("existed"))
    return bool(existed)


# ---------------------------------------------------------------------------
# small mutable JSON values (checkpoint markers), one key, read at quorum
# ---------------------------------------------------------------------------


def put_json(key: str, obj: Any, store_url: Optional[str] = None) -> Dict:
    """Store a small JSON document as one kv key (no index, no leaves)."""
    url = _store_url(store_url)
    data = json.dumps(obj).encode()
    meta = {"kind": "json",
            "blake2b": hashlib.blake2b(data, digest_size=20).hexdigest()}
    return _kv_put(url, key, data, meta)


def get_json(key: str, store_url: Optional[str] = None,
             quorum: bool = False, default: Any = None) -> Any:
    """Fetch a :func:`put_json` value; ``default`` when absent.
    ``quorum=True`` on a multi-node ring reads the key from every member
    of its replica set (strictly local reads) and returns the copy with
    the newest server-stamped ``stored_at``."""
    url = _store_url(store_url)
    rg = ring.ring_for(url)
    path = f"/kv/{netpool.urlkey(key)}"
    if quorum and rg.size > 1:
        best: Optional[tuple] = None
        for base in rg.nodes_for(key)[:ring.replication_factor()]:
            try:
                r = netpool.request("GET", f"{base}{path}",
                                    headers={ring.REPLICATED_HEADER: "1"},
                                    timeout=netpool.store_timeout(30))
            except (*netpool.TRANSPORT_ERRORS, DataStoreError):
                rg.record_failure(base)
                continue
            if r.status_code != 200:
                continue
            meta = _response_meta(r)
            try:
                _verify_content(r.content, meta, None, key, "store")
            except DataCorruptionError:
                continue
            at = float(meta.get("stored_at") or 0.0)
            if best is None or at > best[0]:
                best = (at, r.content)
        return json.loads(best[1]) if best is not None else default
    try:
        r = rg.request("GET", path, key=key, timeout=netpool.store_timeout(30))
    except DataStoreError:
        return default
    if r.status_code != 200:
        return default
    try:
        return json.loads(r.content)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# the store protocol over a store by URL
# ---------------------------------------------------------------------------


class TreeReader:
    """One read of a pytree's index and some of its leaves from a store of
    the protocol, through its ``get_index``/``get_leaf``. Its
    ``bytes_by_source`` holds the leaves' bytes by source, here all the
    store's; ``complete()`` ends the read."""

    def __init__(self, store: Any, key: str):
        self.store, self.key = store, key
        self.bytes_by_source: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _count(self, source: str, nbytes: int) -> None:
        with self._lock:
            self.bytes_by_source[source] = (
                self.bytes_by_source.get(source, 0) + int(nbytes))

    def index(self, expect_hash: Optional[str] = None,
              fresh: bool = False) -> Optional[Dict]:
        """The key's index, None when absent; ``expect_hash`` as
        ``get_index`` takes it. ``fresh=True`` reads past any cache."""
        return self.store.get_index(self.key, expect_hash=expect_hash)

    def _leaf(self, path: str, meta: Dict) -> Optional[np.ndarray]:
        arr = self.store.get_leaf(self.key, path, meta)
        if arr is not None:
            self._count("store", arr.nbytes)
        return arr

    def leaves(self, index: Dict, paths: List[str]) -> Dict[str, Any]:
        """``{path: numpy leaf, or None when the store holds none}``."""
        return dict(netpool.map_concurrent(
            lambda p: (p, self._leaf(p, index["leaves"][p])), paths))

    def complete(self) -> None:
        pass


class _RoutedReader(TreeReader):
    """A :class:`TreeReader` over the broadcast tree: one
    :class:`_RoutedFetcher` for the index and the leaves;
    ``complete()`` makes this pod a parent."""

    def __init__(self, url: str, key: str, peer: Optional[bool],
                 content_alias: bool):
        super().__init__(None, key)
        self.url = url
        self.fetcher = _RoutedFetcher(url, key, peer,
                                      content_alias=content_alias)

    def index(self, expect_hash: Optional[str] = None,
              fresh: bool = False) -> Optional[Dict]:
        """``fresh=True`` evicts the pod cache's entry (a publisher without
        the index's content address may have left the previous version's
        there) and reads the store alone."""
        sub = f"{self.key}{_INDEX_SUFFIX}"
        fetcher = self.fetcher
        if fresh:
            from .peer_cache import cache_evict
            cache_evict(sub)
            fetcher = _RoutedFetcher(self.url, self.key, False)
        r = fetcher.fetch(sub, timeout=60, expect_hash=expect_hash)
        return json.loads(r.content) if r.status_code == 200 else None

    def _leaf(self, path: str, meta: Dict) -> Optional[np.ndarray]:
        r, source = self.fetcher._fetch_sourced(
            f"{self.key}/{path}", expect_hash=meta.get("blake2b"))
        if r.status_code != 200:
            return None
        self._count(source, len(r.content))
        return decode_array(r.content, meta)

    def complete(self) -> None:
        self.fetcher.complete()


def reader(store: Any, key: str, peer: Optional[bool] = None,
           content_alias: bool = False) -> TreeReader:
    """A :class:`TreeReader` of ``key`` on ``store``: the store's own
    (``reader`` of the protocol) where it has one, else one over
    ``get_index``/``get_leaf``. ``peer`` and ``content_alias`` are the
    broadcast tree's; a store without one ignores them."""
    own = getattr(store, "reader", None)
    if own is not None:
        return own(key, peer=peer, content_alias=content_alias)
    return TreeReader(store, key)


class HttpStore:
    """The store protocol (module docstring) over a store server:
    ``store_url`` (a URL, a ring spec ``a,b,c``, or None for
    ``KT_DATA_STORE_URL``). ``peer`` is the broadcast-tree switch of its
    :meth:`reader` (None: on inside a pod), through which the rollout
    reads; ``get``, ``get_index`` and ``get_leaf`` read the store only, as
    the JAX package's checkpoint does (its keys are re-put in place)."""

    def __init__(self, store_url: Optional[str] = None,
                 peer: Optional[bool] = None):
        self.url = _store_url(store_url)
        self.peer = peer

    def put(self, key: str, tree: Any) -> Dict:
        return put(key, tree, store_url=self.url)

    def get(self, key: str) -> Any:
        return get(key, store_url=self.url, peer=False)

    def put_json(self, key: str, obj: Any) -> Dict:
        return put_json(key, obj, store_url=self.url)

    def get_json(self, key: str, quorum: bool = False,
                 default: Any = None) -> Any:
        return get_json(key, store_url=self.url, quorum=quorum,
                        default=default)

    def get_index(self, key: str, expect_hash: Optional[str] = None):
        r = _RoutedFetcher(self.url, key, False).fetch(
            f"{key}{_INDEX_SUFFIX}", timeout=60, expect_hash=expect_hash)
        return json.loads(r.content) if r.status_code == 200 else None

    def get_leaf(self, key: str, path: str, meta: Dict):
        r = _RoutedFetcher(self.url, key, False).fetch(
            f"{key}/{path}", expect_hash=meta.get("blake2b"))
        return decode_array(r.content, meta) if r.status_code == 200 else None

    def reader(self, key: str, peer: Optional[bool] = None,
               content_alias: bool = False) -> TreeReader:
        """A read of ``key`` over the broadcast tree (``peer``: None takes
        this store's)."""
        return _RoutedReader(self.url, key, self.peer if peer is None
                             else peer, content_alias)
