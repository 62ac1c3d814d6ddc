"""ktsync, the port's copy of ``kubetorch_tpu/data_store/sync.py``:
content-hash delta sync of directory trees over the store's wire.

Push (one round trip for a warm no-op push, three for a cold one):

1. ``POST /tree/<key>/diff`` with ``{files: {path: {hash, size, mode}}}``
   answers ``{missing: [hash, ...]}``, the blobs the store lacks;
2. ``PUT /blob/<hash>``, the raw bytes of each missing blob, routed to its
   hash's replica set;
3. ``POST /tree/<key>/commit`` with the manifest points the tree at it
   (409 while a blob is still missing).

Pull fetches ``GET /tree/<key>/manifest``, skips every file whose hash
already matches (by the previous pull's ``.ktsync-manifest.json`` or by
hashing it), and streams each changed blob from its replica set into a
``.ktsync-tmp`` file, checked against its blake2b before the rename; a
transport error or a corrupt blob fails over to the next replica. With
``delete=True`` a file the previous pull wrote and the manifest no
longer names is removed; files ktsync did not write are never touched.

Blobs move concurrently over ``netpool.map_concurrent``; an upload streams
from the open file (reopened on a retry) and a download streams to disk,
so memory stays O(chunk) a worker. Stats dicts, excludes, the hash cache
under ``.ktsync/`` and the 10 GiB file cap are the JAX package's.

**Where the port differs:** ``pull_tree`` refuses, with ``SyncError`` and
before any byte moves, a manifest path that is absolute or that
``os.path.normpath`` resolves outside ``dest``, and the same of a path the
previous manifest would have it delete. The JAX package joins such a path
onto ``dest`` as it is and writes outside it. Transport failures (the
port's ``netpool.TRANSPORT_ERRORS``) and HTTP errors become ``SyncError``,
as the JAX package's ``requests`` exceptions do.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import stat
from pathlib import Path
from typing import Dict, List

from ..exceptions import DataCorruptionError, SyncError
from . import netpool, ring

EXCLUDE_DIRS = {".git", "__pycache__", ".pytest_cache", ".mypy_cache",
                "node_modules", ".venv", "venv", ".ktsync"}
EXCLUDE_SUFFIXES = (".pyc", ".pyo", ".so.tmp")
# sanitizer binaries the JAX package's CI builds beside its sources,
# excluded by exact name
EXCLUDE_NAMES = {"ktblobd_asan", "kt_native_asan", "kt_native_tsan"}
MANIFEST_FILE = ".ktsync-manifest.json"
HASH_CACHE_FILE = os.path.join(".ktsync", "hash-cache.json")
MAX_FILE_SIZE = 10 * 1024 ** 3
CHUNK = 1 << 20


class _StatusError(http.client.HTTPException):
    """A store answered with an error status: handled as a transport
    failure (the next replica, then ``SyncError``), as a ``requests``
    ``HTTPError`` is in the JAX package."""


def _check(resp, what: str) -> None:
    if resp.status_code != 200:
        raise _StatusError(f"{what}: {resp.status_code} {resp.text[:200]}")


def file_hash(path: str, chunk: int = CHUNK) -> str:
    h = hashlib.blake2b(digest_size=20)
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def build_manifest(root: str) -> Dict[str, Dict]:
    """``{relpath: {hash, size, mode}}`` for every syncable file under
    ``root``. Hashes are kept in ``.ktsync/hash-cache.json`` by (size,
    mtime_ns), so a warm push hashes only the files whose stat changed (an
    edit that keeps both is taken as unchanged, as rsync's quick check
    does); a missing or unreadable cache only costs hashing."""
    if not Path(root).is_dir():
        raise SyncError(f"Sync root {root!r} is not a directory")
    cache = _load_hash_cache(root)
    new_cache: Dict[str, Dict] = {}
    out: Dict[str, Dict] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in EXCLUDE_DIRS]
        for fname in filenames:
            if (fname.endswith(EXCLUDE_SUFFIXES) or fname == MANIFEST_FILE
                    or fname in EXCLUDE_NAMES):
                continue
            fpath = os.path.join(dirpath, fname)
            try:
                st = os.stat(fpath)
            except OSError:
                continue
            if not stat.S_ISREG(st.st_mode) or st.st_size > MAX_FILE_SIZE:
                continue
            rel = os.path.relpath(fpath, root)
            cached = cache.get(rel)
            if (cached and cached.get("size") == st.st_size
                    and cached.get("mtime_ns") == st.st_mtime_ns):
                digest = cached["hash"]
            else:
                digest = file_hash(fpath)
            new_cache[rel] = {"hash": digest, "size": st.st_size,
                              "mtime_ns": st.st_mtime_ns}
            out[rel] = {"hash": digest, "size": st.st_size,
                        "mode": st.st_mode & 0o777}
    _save_hash_cache(root, new_cache)
    return out


def _load_hash_cache(root: str) -> Dict[str, Dict]:
    try:
        cache = json.loads(Path(root, HASH_CACHE_FILE).read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(cache, dict):
        return {}
    return {k: v for k, v in cache.items()
            if isinstance(v, dict) and "hash" in v}


def _save_hash_cache(root: str, cache: Dict[str, Dict]) -> None:
    path = os.path.join(root, HASH_CACHE_FILE)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        Path(tmp).write_text(json.dumps(cache))
        os.replace(tmp, path)
    except OSError:
        pass                    # a read-only tree: every push hashes again


def push_tree(store_url: str, key: str, root: str) -> Dict:
    """Delta-push ``root`` to the store under ``key``: ``{files, uploaded,
    uploaded_bytes}``. Each blob goes to its hash's replica set and the
    manifest to the key's, every request failing over along the ring."""
    base = store_url.rstrip("/")
    rg = ring.ring_for(base)
    manifest = build_manifest(root)
    tree = f"/tree/{netpool.urlkey(key)}"
    try:
        r = rg.request("POST", f"{tree}/diff", key=key,
                       json={"files": manifest},
                       timeout=netpool.store_timeout(60))
        _check(r, "diff")
        missing: List[str] = r.json()["missing"]
        by_hash: Dict[str, str] = {}
        for rel, info in manifest.items():
            by_hash.setdefault(info["hash"], rel)
        for h in missing:
            if h not in by_hash:
                raise SyncError(f"Server requested unknown blob {h}")

        def _upload(h: str) -> int:
            fpath = os.path.join(root, by_hash[h])
            opened: List = []

            def _body():
                # every attempt sends a fresh file: the one a failed
                # attempt read from is spent
                while opened:
                    opened.pop().close()
                opened.append(open(fpath, "rb"))
                return opened[-1]

            try:
                ru = rg.request("PUT", f"/blob/{h}", key=h,
                                data_factory=_body,
                                timeout=netpool.store_timeout())
            finally:
                while opened:
                    opened.pop().close()
            _check(ru, f"PUT blob {h}")
            return os.path.getsize(fpath)

        uploaded_bytes = sum(netpool.map_concurrent(_upload, missing))
        rc = rg.request("POST", f"{tree}/commit", key=key,
                        json={"files": manifest},
                        timeout=netpool.store_timeout(60))
        _check(rc, "commit")
        return {"files": len(manifest), "uploaded": len(missing),
                "uploaded_bytes": uploaded_bytes}
    except netpool.TRANSPORT_ERRORS as e:
        raise SyncError(f"push_tree({key}) to {store_url} failed: {e}") from e


def _refuse_escapes(dest: str, paths, what: str) -> None:
    """``SyncError`` when a path is absolute or resolves outside ``dest``."""
    for rel in paths:
        norm = os.path.normpath(rel)
        if (os.path.isabs(rel) or norm in (os.curdir, os.pardir)
                or norm.startswith(os.pardir + os.sep)):
            raise SyncError(f"{what} path {rel!r} does not lie inside "
                            f"{dest!r}; nothing was written")


def pull_tree(store_url: str, key: str, dest: str,
              delete: bool = True) -> Dict:
    """Delta-pull ``key`` into ``dest``: ``{files, fetched, deleted}``.
    Only changed blobs are fetched."""
    base = store_url.rstrip("/")
    rg = ring.ring_for(base)
    try:
        r = rg.request("GET", f"/tree/{netpool.urlkey(key)}/manifest",
                       key=key, timeout=netpool.store_timeout(60))
        if r.status_code == 404:
            raise SyncError(f"No tree {key!r} in store")
        _check(r, "manifest")
        remote: Dict[str, Dict] = r.json()["files"]
        _refuse_escapes(dest, remote, "manifest")
        prev = _load_prev_manifest(dest)
        gone = set(prev) - set(remote) if delete else set()
        _refuse_escapes(dest, gone, "previous manifest")

        os.makedirs(dest, exist_ok=True)
        to_fetch = []
        for rel, info in remote.items():
            target = os.path.join(dest, rel)
            if os.path.isfile(target):
                local_prev = prev.get(rel)
                if (local_prev and local_prev.get("hash") == info["hash"]
                        and os.path.getsize(target) == info["size"]):
                    continue
                if file_hash(target) == info["hash"]:
                    continue
            to_fetch.append((rel, info))

        def _fetch_one(node: str, rel: str, info: Dict, target: str) -> None:
            rb = netpool.request("GET", f"{node}/blob/{info['hash']}",
                                 timeout=netpool.store_timeout(), stream=True)
            _check(rb, f"GET blob {info['hash']}")
            os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
            tmp = target + ".ktsync-tmp"
            # the URL's hash is the blob's blake2b: a mismatch (rot in the
            # store) must never land under the final name
            hasher = hashlib.blake2b(digest_size=20)
            with open(tmp, "wb") as f:
                for chunk in rb.iter_content(CHUNK):
                    f.write(chunk)
                    hasher.update(chunk)
            actual = hasher.hexdigest()
            if actual != info["hash"]:
                os.unlink(tmp)
                raise DataCorruptionError(
                    f"blob {info['hash']} for {rel!r} arrived corrupt "
                    f"(got {actual}); the store copy needs repair "
                    "(scrub + re-push)",
                    key=info["hash"], expected=info["hash"], actual=actual,
                    source="store")
            os.chmod(tmp, info.get("mode", 0o644))
            os.replace(tmp, target)

        def _download(item) -> None:
            rel, info = item
            target = os.path.join(dest, rel)
            # the blob's replica set in ring order: a node that dies or
            # rots mid-stream is covered by the next one
            nodes = rg.nodes_for(info["hash"]) or [base]
            for i, node in enumerate(nodes):
                last = i == len(nodes) - 1
                try:
                    _fetch_one(node, rel, info, target)
                    rg.record_success(node)
                    return
                except netpool.TRANSPORT_ERRORS:
                    if last:
                        raise
                    rg.record_failure(node)
                    rg._failover("connect", node)
                except DataCorruptionError:
                    if last:
                        raise
                    rg._failover("corruption", node)

        netpool.map_concurrent(_download, to_fetch)

        deleted = 0
        for rel in gone:
            path = os.path.join(dest, rel)
            if os.path.isfile(path):
                os.unlink(path)
                deleted += 1
        _save_prev_manifest(dest, remote)
        return {"files": len(remote), "fetched": len(to_fetch),
                "deleted": deleted}
    except netpool.TRANSPORT_ERRORS as e:
        raise SyncError(f"pull_tree({key}) from {store_url} failed: {e}") from e


def _load_prev_manifest(dest: str) -> Dict[str, Dict]:
    path = os.path.join(dest, MANIFEST_FILE)
    if os.path.isfile(path):
        try:
            return json.loads(Path(path).read_text()).get("files", {})
        except (ValueError, OSError):
            return {}
    return {}


def _save_prev_manifest(dest: str, files: Dict[str, Dict]) -> None:
    Path(dest, MANIFEST_FILE).write_text(json.dumps({"files": files}))
