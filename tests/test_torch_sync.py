"""ktsync in the port (``kubetorch_tpu_torch/data_store/sync.py`` and the
tree branches of ``commands.put``/``get``) against the JAX package's, over
real store servers on the CPU.

- JAX's tree cases one for one: excludes and the hash cache
  (``tests/test_data_store.py:45``, ``:291``), cold/warm/delta push, pull
  with delete, a missing tree (``:56-105``), a node stopped between push and
  pull (``tests/test_store_ring.py:376``), a corrupt blob that never lands
  (``tests/test_store_chaos.py:226``).
- Against JAX: ``build_manifest`` equal; the same push/pull sequence gives
  equal stats and equal trees; a tree either package pushes, the other
  pulls with the same files and modes; ``put(dir)``/``get(key, dest=)``
  equal JAX's ``ds.put``/``ds.get``.
- Streaming: an upload retried after a 503, and one resent on a fresh
  connection, each sends the whole file again; a 64 MiB pull and push keep
  tracemalloc's peak far under the file.
- The fault of both packages: a manifest path that leaves ``dest``. JAX
  writes (or deletes) outside ``dest``; the port raises ``SyncError``
  before any byte lands.
"""

import hashlib
import json
import os
import shutil
import threading
import tracemalloc
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubetorch_tpu.data_store import commands as jds
from kubetorch_tpu.data_store import ring as jring
from kubetorch_tpu.data_store import sync as jsync
from kubetorch_tpu.data_store.store_server import create_store_app
from kubetorch_tpu.exceptions import SyncError as JSyncError
from kubetorch_tpu_torch.data_store import commands as ds
from kubetorch_tpu_torch.data_store import netpool
from kubetorch_tpu_torch.data_store import ring as pring
from kubetorch_tpu_torch.data_store import sync
from kubetorch_tpu_torch.exceptions import (DataCorruptionError,
                                            DataStoreError, SyncError)
from tests.assets.store_fleet import ThreadedStoreFleet
from tests.assets.threaded_server import ThreadedAiohttpServer

pytestmark = pytest.mark.level("unit")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for var in ("POD_IP", "KT_STORE_NODES", "KT_DATA_STORE_URL",
                "KT_STORE_CONCURRENCY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("KT_STORE_FSYNC", "0")
    monkeypatch.setenv("KT_SCRUB_INTERVAL_S", "0")
    monkeypatch.setenv("KT_STORE_RETRY_BASE_S", "0.01")
    monkeypatch.setenv("KT_STORE_RETRY_MAX_S", "0.05")
    jring.reset_rings()
    pring.reset_rings()
    yield
    jring.reset_rings()
    pring.reset_rings()


def _store(root):
    return ThreadedAiohttpServer(lambda: create_store_app(str(root)))


@pytest.fixture
def store(tmp_path):
    with _store(tmp_path / "store") as srv:
        yield srv.url


def _project(root):
    (root / "pkg").mkdir(parents=True)
    (root / "pkg" / "mod.py").write_text("x = 1\n")
    (root / "main.py").write_text("print('hello')\n")
    (root / "__pycache__").mkdir()
    (root / "__pycache__" / "junk.pyc").write_text("junk")
    (root / ".git").mkdir()
    (root / ".git" / "HEAD").write_text("ref")
    return root


@pytest.fixture
def project(tmp_path):
    return _project(tmp_path / "proj")


def _files(root):
    """``{relpath: (bytes, mode)}`` of the synced files under ``root``."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != ".ktsync"]
        for f in filenames:
            if f == sync.MANIFEST_FILE:
                continue
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = (
                    fh.read(), os.stat(p).st_mode & 0o777)
    return out


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------


def test_manifest_excludes(project):
    m = sync.build_manifest(str(project))
    assert set(m) == {"pkg/mod.py", "main.py"}
    assert all("hash" in v and "size" in v for v in m.values())
    assert m == jsync.build_manifest(str(project))


def test_manifest_equals_jax(tmp_path):
    root = tmp_path / "tree"
    (root / "a" / "b").mkdir(parents=True)
    (root / "a" / "b" / "w.bin").write_bytes(os.urandom(3 << 20))
    (root / "run.sh").write_text("#!/bin/sh\n")
    os.chmod(root / "run.sh", 0o755)
    (root / "x.pyo").write_text("skip")
    (root / "ktblobd_asan").write_text("skip")
    (root / sync.MANIFEST_FILE).write_text("{}")
    (root / "node_modules").mkdir()
    (root / "node_modules" / "m.js").write_text("skip")
    os.symlink(root / "run.sh", root / "link")
    port = sync.build_manifest(str(root))
    # a link to a file syncs as the file it names (os.stat follows it)
    assert set(port) == {"a/b/w.bin", "run.sh", "link"}
    assert port["run.sh"]["mode"] == 0o755
    assert port["link"]["hash"] == port["run.sh"]["hash"]
    assert port == jsync.build_manifest(str(root))
    with pytest.raises(SyncError, match="not a directory"):
        sync.build_manifest(str(root / "run.sh"))


def test_manifest_hash_cache(project, monkeypatch):
    calls = []
    real = sync.file_hash
    monkeypatch.setattr(sync, "file_hash",
                        lambda p, **k: calls.append(p) or real(p, **k))

    first = sync.build_manifest(str(project))
    assert len(calls) == 2
    calls.clear()
    assert sync.build_manifest(str(project)) == first     # warm: no hashing
    assert calls == []

    (project / "main.py").write_text("print('bye')\n")    # one re-hash
    m = sync.build_manifest(str(project))
    assert [os.path.basename(p) for p in calls] == ["main.py"]
    assert m["main.py"]["hash"] != first["main.py"]["hash"]
    assert m["pkg/mod.py"] == first["pkg/mod.py"]

    for corrupt in ("not json", '"oops"', '{"main.py": "zzz"}'):
        (project / ".ktsync" / "hash-cache.json").write_text(corrupt)
        calls.clear()
        assert sync.build_manifest(str(project)) == m
        assert len(calls) == 2
    # JAX reads the port's cache and the reverse
    assert jsync.build_manifest(str(project)) == m


# ---------------------------------------------------------------------------
# JAX's tree cases, one for one
# ---------------------------------------------------------------------------


def test_push_pull_roundtrip(store, project, tmp_path):
    stats = sync.push_tree(store, "code/svc1", str(project))
    assert stats == {"files": 2, "uploaded": 2,
                     "uploaded_bytes": stats["uploaded_bytes"]}
    dest = tmp_path / "dest"
    out = sync.pull_tree(store, "code/svc1", str(dest))
    assert out["files"] == 2 and out["fetched"] == 2
    assert (dest / "pkg" / "mod.py").read_text() == "x = 1\n"
    assert (dest / "main.py").read_text() == "print('hello')\n"


def test_delta_push_only_changed(store, project, tmp_path):
    sync.push_tree(store, "code/svc2", str(project))
    assert sync.push_tree(store, "code/svc2", str(project))["uploaded"] == 0
    (project / "main.py").write_text("print('v2')\n")
    assert sync.push_tree(store, "code/svc2", str(project))["uploaded"] == 1

    dest = tmp_path / "dest2"
    sync.pull_tree(store, "code/svc2", str(dest))
    (project / "pkg" / "mod.py").write_text("x = 3\n")
    sync.push_tree(store, "code/svc2", str(project))
    out = sync.pull_tree(store, "code/svc2", str(dest))
    assert out["fetched"] == 1
    assert (dest / "pkg" / "mod.py").read_text() == "x = 3\n"


def test_pull_deletes_removed_files(store, project, tmp_path):
    sync.push_tree(store, "code/svc3", str(project))
    dest = tmp_path / "dest3"
    sync.pull_tree(store, "code/svc3", str(dest))
    assert (dest / "main.py").exists()
    (dest / "user_scratch.txt").write_text("mine")
    (project / "main.py").unlink()
    sync.push_tree(store, "code/svc3", str(project))
    out = sync.pull_tree(store, "code/svc3", str(dest))
    assert out["deleted"] == 1
    assert not (dest / "main.py").exists()
    assert (dest / "user_scratch.txt").exists()


def test_pull_missing_tree_raises(store, tmp_path):
    with pytest.raises(SyncError, match="No tree"):
        sync.pull_tree(store, "code/nope", str(tmp_path / "x"))


def test_push_pull_tree_survive_node_stop(tmp_path, monkeypatch):
    with ThreadedStoreFleet(tmp_path, n=3) as fleet:
        for k, v in fleet.client_env().items():
            monkeypatch.setenv(k, v)
        pring.reset_rings()
        proj = tmp_path / "proj"
        proj.mkdir()
        for i in range(6):
            (proj / f"mod{i}.py").write_text(f"x = {i}\n" * 50)
        assert sync.push_tree(fleet.urls[0], "code/app",
                              str(proj))["uploaded"] == 6
        fleet.stop_node(0)                       # a replica and the seed
        dest = tmp_path / "dest"
        out = sync.pull_tree(fleet.urls[0], "code/app", str(dest))
        assert out["fetched"] == 6
        for i in range(6):
            assert (dest / f"mod{i}.py").read_text() == f"x = {i}\n" * 50


def test_pull_tree_detects_corrupt_blob(tmp_path):
    import requests

    root = tmp_path / "store"
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "model.py").write_text("weights = 42\n")
    with _store(root) as srv:
        sync.push_tree(srv.url, "code/app", str(proj))
        blob = next(p for p in (root / "blobs").rglob("*") if p.is_file())
        raw = bytearray(blob.read_bytes())
        raw[0] ^= 0xFF
        blob.write_bytes(bytes(raw))

        dest = tmp_path / "dest"
        with pytest.raises(DataCorruptionError):
            sync.pull_tree(srv.url, "code/app", str(dest))
        assert not (dest / "model.py").exists()
        assert not list(dest.glob("*.ktsync-tmp"))

        requests.post(f"{srv.url}/scrub/run", timeout=60)
        sync.push_tree(srv.url, "code/app", str(proj))
        sync.pull_tree(srv.url, "code/app", str(dest))
        assert (dest / "model.py").read_text() == "weights = 42\n"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _sequence(push, pull, url, project, dest):
    """Cold, warm and delta pushes, pulls with a user file and a delete:
    every stats dict in order."""
    out = [push(url, "code/seq", str(project)),
           push(url, "code/seq", str(project))]
    (project / "main.py").write_text("print('v2')\n")
    out.append(push(url, "code/seq", str(project)))
    out.append(pull(url, "code/seq", str(dest)))
    out.append(pull(url, "code/seq", str(dest)))
    (project / "pkg" / "mod.py").write_text("x = 3\n")
    (project / "pkg" / "new.bin").write_bytes(bytes(range(256)) * 64)
    (dest / "user_scratch.txt").write_text("mine")
    out.append(push(url, "code/seq", str(project)))
    out.append(pull(url, "code/seq", str(dest)))
    (project / "main.py").unlink()
    out.append(push(url, "code/seq", str(project)))
    out.append(pull(url, "code/seq", str(dest)))
    (project / "pkg" / "new.bin").unlink()
    out.append(push(url, "code/seq", str(project)))
    out.append(pull(url, "code/seq", str(dest), delete=False))
    return out


def test_stats_equal_jax_sequence(tmp_path):
    runs = {}
    for name, push, pull in (("jax", jsync.push_tree, jsync.pull_tree),
                             ("port", sync.push_tree, sync.pull_tree)):
        project = _project(tmp_path / name / "proj")
        os.chmod(project / "main.py", 0o700)
        dest = tmp_path / name / "dest"
        with _store(tmp_path / name / "store") as srv:
            runs[name] = (_sequence(push, pull, srv.url, project, dest),
                          _files(dest))
    assert runs["port"] == runs["jax"]
    stats, files = runs["port"]
    assert [s.get("uploaded", s.get("fetched")) for s in stats] == \
        [2, 0, 1, 2, 0, 2, 2, 0, 0, 0, 0]
    assert stats[-3]["deleted"] == 1 and "main.py" not in files
    assert stats[-1]["deleted"] == 0 and "pkg/new.bin" in files
    assert files["user_scratch.txt"][0] == b"mine"


def _mixed_tree(root):
    (root / "ckpt" / "shards").mkdir(parents=True)
    (root / "ckpt" / "shards" / "w0.bin").write_bytes(os.urandom(5 << 20))
    (root / "ckpt" / "config.json").write_text('{"dim": 8}')
    (root / "bin").mkdir()
    (root / "bin" / "serve").write_text("#!/bin/sh\necho ok\n")
    os.chmod(root / "bin" / "serve", 0o755)
    (root / "ro.txt").write_text("read only")
    os.chmod(root / "ro.txt", 0o444)
    (root / "empty").write_bytes(b"")
    return root


@pytest.mark.parametrize("pusher", ["jax", "port"])
def test_a_tree_one_package_pushes_the_other_pulls(store, tmp_path, pusher):
    src = _mixed_tree(tmp_path / "src")
    push, pull = ((jsync.push_tree, sync.pull_tree) if pusher == "jax"
                  else (sync.push_tree, jsync.pull_tree))
    stats = push(store, "trees/mixed", str(src))
    assert stats["files"] == stats["uploaded"] == 5
    dest = tmp_path / "dest"
    assert pull(store, "trees/mixed", str(dest)) == {
        "files": 5, "fetched": 5, "deleted": 0}
    assert _files(dest) == _files(src)
    # the other package's warm push of the same tree moves nothing
    other = sync.push_tree if pusher == "jax" else jsync.push_tree
    assert other(store, "trees/mixed", str(src))["uploaded"] == 0


def test_put_dir_and_get_dest_equal_jax(tmp_path):
    got = {}
    for name, client in (("jax", jds), ("port", ds)):
        src = _project(tmp_path / name / "proj")
        with _store(tmp_path / name / "store") as srv:
            put = client.put("code/app", str(src), store_url=srv.url)
            again = client.put("code/app", str(src), store_url=srv.url)
            dest = tmp_path / name / "dest"
            pulled = client.get("code/app", dest=str(dest), store_url=srv.url)
            other = jds if client is ds else ds
            cross = other.get("code/app", dest=str(tmp_path / name / "x"),
                              store_url=srv.url)
            with pytest.raises(Exception) as ei:
                client.get("code/app", store_url=srv.url)
            got[name] = (put, again, pulled, cross, _files(dest),
                         str(ei.value), type(ei.value).__name__)
    assert got["port"] == got["jax"]
    assert got["port"][0]["uploaded"] == 2 and got["port"][1]["uploaded"] == 0
    assert got["port"][-1] == "DataStoreError"
    assert "is a directory tree; pass dest=" in got["port"][-2]
    with pytest.raises(DataStoreError, match="does not exist"):
        ds.put("code/none", str(tmp_path / "nowhere"), store_url="http://x")


# ---------------------------------------------------------------------------
# streaming bodies
# ---------------------------------------------------------------------------


class _BlobSink:
    """The store's tree wire, enough for a push: every blob missing, and
    PUT /blob/<hash> answering ``fail_first`` 503s before it keeps a
    body; ``close`` drops the connection after every reply without saying
    so (a server closing an idle keep-alive connection)."""

    def __init__(self, fail_first=0, close=False):
        sink = self
        self.bodies = []
        self.fail_left = fail_first

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def reply(self, status, obj):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                self.close_connection = close

            def _body(self):
                return self.rfile.read(int(self.headers["Content-Length"]))

            def do_POST(self):
                files = json.loads(self._body())["files"]
                if self.path.endswith("/diff"):
                    return self.reply(200, {"missing": sorted(
                        {f["hash"] for f in files.values()})})
                self.reply(200, {"ok": True})

            def do_PUT(self):
                data = self._body()
                if sink.fail_left:
                    sink.fail_left -= 1
                    return self.reply(503, {"error": "busy"})
                sink.bodies.append((self.path, data))
                self.reply(200, {"ok": True})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_upload_retry_reopens_the_file(tmp_path, monkeypatch):
    monkeypatch.setenv("KT_STORE_CONCURRENCY", "1")
    proj = tmp_path / "proj"
    proj.mkdir()
    payload = os.urandom(3 << 20)
    (proj / "w.bin").write_bytes(payload)
    opened = []
    real_open = open

    def counting_open(path, mode="r", *a, **k):
        if str(path).endswith("w.bin") and "b" in mode:
            opened.append(path)
        return real_open(path, mode, *a, **k)

    monkeypatch.setattr("builtins.open", counting_open)
    sink = _BlobSink(fail_first=2)
    try:
        stats = sync.push_tree(sink.url, "code/r", str(proj))
    finally:
        sink.close()
    h = hashlib.blake2b(payload, digest_size=20).hexdigest()
    assert stats == {"files": 1, "uploaded": 1, "uploaded_bytes": len(payload)}
    assert sink.bodies == [(f"/blob/{h}", payload)]
    # hashed once for the manifest, then one file per attempt: 2 x 503 + 1
    assert len(opened) == 1 + 3


def test_resend_on_a_fresh_connection_makes_the_body_again(tmp_path):
    path = tmp_path / "body.bin"
    payload = os.urandom(1 << 20)
    path.write_bytes(payload)
    sink = _BlobSink(close=True)
    made = []

    def body():
        made.append(1)
        return open(path, "rb")

    try:
        sess = netpool.Session()
        for i in range(2):
            r = sess.request("PUT", f"{sink.url}/blob/{i}", data_factory=body,
                             timeout=10)
            assert r.status_code == 200
        sess.close()
    finally:
        sink.close()
    # the second request met the connection the server had closed and was
    # sent again on a fresh one, with a fresh file
    assert len(made) == 3
    assert sink.bodies == [("/blob/0", payload), ("/blob/1", payload)]


def test_streamed_push_and_pull_keep_memory_bounded(store, tmp_path):
    proj = tmp_path / "big"
    proj.mkdir()
    size = 64 << 20
    with open(proj / "weights.bin", "wb") as f:
        for i in range(64):
            f.write(os.urandom(1 << 20))
    dest = tmp_path / "dest"
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        assert sync.push_tree(store, "code/big", str(proj))["uploaded"] == 1
        push_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.reset_peak()
        assert sync.pull_tree(store, "code/big", str(dest))["fetched"] == 1
        pull_peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert push_peak < size // 8, push_peak
    assert pull_peak < size // 8, pull_peak
    assert sync.file_hash(str(dest / "weights.bin")) == \
        sync.file_hash(str(proj / "weights.bin"))


# ---------------------------------------------------------------------------
# the fault of both packages: a manifest path outside dest
# ---------------------------------------------------------------------------


def _commit_by_hand(url, key, files):
    """Put each blob and commit ``{path: bytes}`` as the tree's manifest,
    paths as given."""
    manifest = {}
    for rel, data in files.items():
        h = hashlib.blake2b(data, digest_size=20).hexdigest()
        assert netpool.request("PUT", f"{url}/blob/{h}", data=data,
                               timeout=10).status_code == 200
        manifest[rel] = {"hash": h, "size": len(data), "mode": 0o644}
    r = netpool.request("POST", f"{url}/tree/{key}/commit",
                        json={"files": manifest}, timeout=10)
    assert r.status_code == 200


def test_escaping_manifest_path_is_refused(store, tmp_path):
    base = tmp_path / "a"
    dest = base / "b"                        # two levels inside tmp_path
    absolute = tmp_path / "abs.txt"
    _commit_by_hand(store, "evil/up", {"../escaped": b"out", "ok.txt": b"in"})
    _commit_by_hand(store, "evil/abs", {str(absolute): b"abs"})
    for key in ("evil/up", "evil/abs"):
        with pytest.raises(SyncError, match="does not lie inside"):
            sync.pull_tree(store, key, str(dest))
    assert not dest.exists() and not (base / "escaped").exists()
    assert not absolute.exists()
    # the JAX package writes both outside dest
    assert jsync.pull_tree(store, "evil/up", str(dest))["fetched"] == 2
    assert (base / "escaped").read_bytes() == b"out"
    jsync.pull_tree(store, "evil/abs", str(tmp_path / "c" / "d"))
    assert absolute.read_bytes() == b"abs"


def test_delete_of_an_escaping_previous_path_is_refused(store, tmp_path):
    dest = tmp_path / "a" / "b"
    victim = tmp_path / "a" / "victim"
    _commit_by_hand(store, "code/k", {"ok.txt": b"in"})
    for pull in (sync.pull_tree, jsync.pull_tree):
        dest.mkdir(parents=True, exist_ok=True)
        victim.write_text("keep me")
        (dest / sync.MANIFEST_FILE).write_text(json.dumps(
            {"files": {"../victim": {"hash": "0" * 40, "size": 7}}}))
        if pull is sync.pull_tree:
            with pytest.raises(SyncError, match="previous manifest"):
                pull(store, "code/k", str(dest))
            assert victim.exists() and not (dest / "ok.txt").exists()
        else:
            assert pull(store, "code/k", str(dest))["deleted"] == 1
            assert not victim.exists()        # JAX unlinked it
        shutil.rmtree(dest)
    # with delete=False the port has nothing to unlink and pulls
    dest.mkdir(parents=True)
    (dest / sync.MANIFEST_FILE).write_text(json.dumps(
        {"files": {"../victim": {"hash": "0" * 40, "size": 7}}}))
    assert sync.pull_tree(store, "code/k", str(dest), delete=False) == {
        "files": 1, "fetched": 1, "deleted": 0}


def test_transport_failure_is_a_sync_error(tmp_path):
    from kubetorch_tpu.utils.procs import free_port
    dead = f"http://127.0.0.1:{free_port()}"
    proj = _project(tmp_path / "proj")
    with pytest.raises(SyncError, match="push_tree") as ei:
        sync.push_tree(dead, "code/x", str(proj))
    assert isinstance(ei.value.__cause__, netpool.TRANSPORT_ERRORS)
    with pytest.raises(SyncError, match="pull_tree"):
        sync.pull_tree(dead, "code/x", str(tmp_path / "d"))
    with pytest.raises(JSyncError, match="push_tree"):
        jsync.push_tree(dead, "code/x", str(proj))
