"""The port's client side of the fabric's ``ktblobd`` route
(``kubetorch_tpu_torch/data_store/commands.py:_RoutedFetcher``) against
the daemon built from ``kubetorch_tpu/native/ktblobd.cpp``, on the CPU.

- The twin of ``tests/test_blobd.py:110``, case for case: a child routed to
  a parent with a daemon takes the bytes from the daemon (meta checked
  against the key), a missing entry is the parent's "not yet" 404, and a
  dead daemon turns the fast path off so that the parent is judged by its
  pod route.
- The ``/route`` and ``/route/complete`` bodies the port posts equal
  JAX's for the same ``POD_IP``/``KT_BLOBD_PORT``/``KT_SERVER_PORT``.
- A routed tree get: pod A fetches from the store and becomes a parent
  whose daemon serves its cache while its pod route is down; pod B's get
  comes all from the daemon, with JAX's ``bytes_by_source``.

The daemon is built with ``g++ -O3 -std=c++17`` into this run's temp
directory (a second build into ``kubetorch_tpu/native/`` could race
``tests/test_blobd.py``'s ``make`` under several workers).
"""

import json
import os
import subprocess
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from kubetorch_tpu.data_store import commands as jds
from kubetorch_tpu.data_store import ring as jring
from kubetorch_tpu.data_store.store_server import create_store_app
from kubetorch_tpu.utils.procs import free_port
from kubetorch_tpu_torch.data_store import commands as ds
from kubetorch_tpu_torch.data_store import netpool, peer_cache
from kubetorch_tpu_torch.data_store import ring as pring
from tests.assets.threaded_server import ThreadedAiohttpServer

pytestmark = pytest.mark.level("unit")

SOURCE = os.path.join(os.path.dirname(__file__), os.pardir, "kubetorch_tpu",
                      "native", "ktblobd.cpp")


@pytest.fixture(scope="module")
def blobd_bin(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("blobd") / "ktblobd")
    rc = subprocess.run(["g++", "-O3", "-std=c++17", "-o", out, SOURCE],
                        capture_output=True, text=True)
    assert rc.returncode == 0, rc.stderr
    return out


class _Daemon:
    """ktblobd over ``root`` on localhost; ``url`` once it printed its
    port."""

    def __init__(self, binary, root):
        self.proc = subprocess.Popen(
            [binary, "--root", str(root), "--host", "127.0.0.1", "--port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        line = self.proc.stdout.readline().strip()
        assert line.startswith("PORT "), line
        self.port = int(line.split()[1])
        self.url = f"http://127.0.0.1:{self.port}"

    def stop(self):
        self.proc.terminate()
        assert self.proc.wait(timeout=5) == 0


@pytest.fixture
def daemon(blobd_bin, tmp_path):
    d = _Daemon(blobd_bin, tmp_path)
    yield tmp_path, d.url
    d.stop()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for var in ("POD_IP", "KT_BLOBD_PORT", "KT_SERVER_PORT", "KT_STORE_NODES",
                "KT_DATA_STORE_URL", "KT_DATA_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("KT_STORE_FSYNC", "0")
    monkeypatch.setenv("KT_SCRUB_INTERVAL_S", "0")
    monkeypatch.setenv("KT_STORE_RETRY_MAX_S", "0.05")
    jring.reset_rings()
    pring.reset_rings()
    yield
    jring.reset_rings()
    pring.reset_rings()


def test_fetcher_prefers_blobd_and_falls_back(daemon, monkeypatch):
    root, blob_url = daemon
    monkeypatch.setenv("KT_DATA_CACHE_DIR", str(root))
    # the parent's cache, as a completed fetch leaves it
    peer_cache.cache_put("weights/step1", b"W" * 100_000, {"codec": "raw"})

    fetcher = ds._RoutedFetcher.__new__(ds._RoutedFetcher)
    fetcher.store_url = "http://127.0.0.1:9"     # the store is unreachable
    fetcher.key = "weights"
    fetcher.enabled = False
    fetcher._resolved = True
    fetcher._fetched = False
    fetcher._deadline = None
    fetcher.peer_url = "http://127.0.0.1:9"      # so is the pod route
    fetcher.peer_blob_url = blob_url

    r = fetcher._fetch_from_peer("weights/step1", timeout=10)
    assert r.status_code == 200
    assert r.content == b"W" * 100_000
    assert json.loads(r.headers["X-KT-Meta"]) == {"codec": "raw"}

    # a missing entry: 404, the parent's "not yet"
    r = fetcher._fetch_from_peer("weights/step2", timeout=10)
    assert r.status_code == 404

    # the daemon gone: the fast path turns itself off, and the parent is
    # judged by its pod route (unreachable here: a transport error, on
    # which fetch() evicts the parent and goes to the store)
    fetcher.peer_blob_url = "http://127.0.0.1:9"
    with pytest.raises(netpool.TRANSPORT_ERRORS):
        fetcher._fetch_from_peer("weights/step1", timeout=3)
    assert fetcher.peer_blob_url is None


def test_blobd_entry_of_another_key_is_not_taken(daemon, monkeypatch):
    """An entry whose meta names another key (a hash collision) is passed
    over for the pod route, as JAX's check does."""
    root, blob_url = daemon
    monkeypatch.setenv("KT_DATA_CACHE_DIR", str(root))
    peer_cache.cache_put("k/a", b"A" * 10, {})
    h = peer_cache.entry_hash("k/b")
    os.replace(root / f"{peer_cache.entry_hash('k/a')}.json", root / f"{h}.json")
    os.replace(root / f"{peer_cache.entry_hash('k/a')}.bin", root / f"{h}.bin")
    for client in (ds, jds):
        f = client._RoutedFetcher.__new__(client._RoutedFetcher)
        f.sess = None
        f.peer_url = "http://127.0.0.1:9"
        f.peer_blob_url = blob_url
        with pytest.raises(Exception) as ei:
            f._fetch_from_peer("k/b", timeout=3)
        assert ei.value.__class__.__name__ in ("ConnectionRefusedError",
                                               "ConnectionError")
        assert f.peer_blob_url == blob_url       # the daemon was not at fault


class _RouteRecorder:
    """A store's /route family that records each body and roots every
    caller at the store."""

    def __init__(self):
        rec = self.bodies = []

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                rec.append((self.path, body))
                out = json.dumps({"source": "store", "depth": 1}
                                 if self.path == "/route" else {"ok": True})
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out.encode())

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("blobd_port", ["7070", None])
def test_route_bodies_equal_jax(monkeypatch, blobd_port):
    monkeypatch.setenv("POD_IP", "10.1.2.3")
    monkeypatch.setenv("KT_SERVER_PORT", "32311")
    if blobd_port:
        monkeypatch.setenv("KT_BLOBD_PORT", blobd_port)
    bodies = {}
    for name, client in (("jax", jds), ("port", ds)):
        rec = _RouteRecorder()
        try:
            f = client._RoutedFetcher(rec.url, "ckpt/w", peer=True)
            f._resolve()
            f._fetched = True
            f.complete()
            f.complete()                       # once only
        finally:
            rec.close()
        bodies[name] = rec.bodies
    assert bodies["port"] == bodies["jax"]
    blob = f"http://10.1.2.3:{blobd_port}" if blobd_port else None
    assert bodies["port"] == [
        ("/route", {"key": "ckpt/w", "self_url": "http://10.1.2.3:32311",
                    "self_blob_url": blob}),
        ("/route/complete", {"key": "ckpt/w", "url": "http://10.1.2.3:32311",
                             "blob_url": blob})]


def _routed_get(client, store, blobd_bin, base, monkeypatch, tree):
    """Pod A gets ``tree`` from the store and becomes a parent whose daemon
    serves its cache (its pod route is down); pod B is routed to A. B's
    fetcher's ``bytes_by_source``, B's tree and A's daemon's GETs."""
    fetchers = []

    class Recording(client._RoutedFetcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            fetchers.append(self)

    monkeypatch.setattr(client, "_RoutedFetcher", Recording)
    cache_a = base / "cache-a"
    cache_a.mkdir(parents=True)
    d = _Daemon(blobd_bin, cache_a)
    try:
        monkeypatch.setenv("POD_IP", "127.0.0.1")
        monkeypatch.setenv("KT_SERVER_PORT", str(free_port()))  # nobody
        monkeypatch.setenv("KT_BLOBD_PORT", str(d.port))
        monkeypatch.setenv("KT_DATA_CACHE_DIR", str(cache_a))
        client.put("w/tree", tree, store_url=store)
        client.get("w/tree", store_url=store, peer=True)
        monkeypatch.setenv("KT_SERVER_PORT", str(free_port()))
        monkeypatch.delenv("KT_BLOBD_PORT")
        monkeypatch.setenv("KT_DATA_CACHE_DIR", str(base / "cache-b"))
        got = client.get("w/tree", store_url=store, peer=True)
    finally:
        d.stop()
    b = fetchers[-1]
    return dict(b.bytes_by_source), got, b.peer_blob_url


def test_routed_tree_get_through_blobd(blobd_bin, tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"layers": [{"w": rng.standard_normal((64, 32)).astype(np.float32),
                        "b": np.arange(32, dtype=np.int32)}
                       for _ in range(3)],
            "head": rng.standard_normal(100).astype(np.float16)}
    runs = {}
    for name, client in (("jax", jds), ("port", ds)):
        with ThreadedAiohttpServer(
                lambda n=name: create_store_app(str(tmp_path / n / "store"))) \
                as srv:
            runs[name] = _routed_get(client, srv.url, blobd_bin,
                                     tmp_path / name, monkeypatch, tree)
    by_source, got, blob_url = runs["port"]
    assert by_source == runs["jax"][0]
    leaf_bytes = sum(x.nbytes for layer in tree["layers"]
                     for x in layer.values()) + tree["head"].nbytes
    assert set(by_source) == {"peer"} and by_source["peer"] > leaf_bytes
    assert blob_url is not None              # the fast path stayed on
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            np.testing.assert_array_equal(got["layers"][i][k], v)
    np.testing.assert_array_equal(got["head"], tree["head"])
