"""Persistent compile cache for the serving engine: the port of
``kubetorch_tpu/serve/aot_cache.py``.

A fresh serving replica pays, before it serves, for whatever its first
passes compile. Under JAX that is XLA's executables; in the port it is the
kernel libraries ``ops/_build.py`` compiles with ``nvcc`` at first use
(tens of seconds a pod). They are a pure function of the kernel sources,
the flags, torch and CUDA and the card, so the fleet builds each once:

- :class:`AOTKey` canonicalizes what an engine's libraries depend on into
  a content digest: the engine's shape knobs as in JAX, and, where JAX
  keys jax/jaxlib and the backend, ``torch.__version__``,
  ``torch.version.cuda``, the card's name and compute capability and a
  digest of every source's ``library_path`` name (each hashes its ``.cu``,
  every ``.cuh`` and the flags). A stale library can never be found, only
  missed. ``nvcc``'s version is not in the key: a pod that hits may have
  no ``nvcc``.
- :class:`AOTCompileCache` is a local directory of built libraries with a
  blake2b gate in front of every load, and an optional store layer
  (content-addressed put/get through the port's store client) so the
  first replica to build publishes for the whole fleet.
- :func:`warm_engine` resolves every library the engine's passes launch
  through the cache, then runs one prefill per bucket and one decode block,
  so the first request pays no lazy initialisation.

Misses are typed and counted (``kt_aot_cache_total{result}``): an absent
entry, a key mismatch (``incompatible``) and a corrupt payload all build
afresh through ``_build.build``, the one path that compiles; nothing gives
way to a plain version. A pod with no entry and no ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import telemetry
from ..exceptions import AOTCacheCorruptError, AOTCacheMissError
from ..ops import _build

_DIGEST_LEN = 32          # hex chars of the key digest (128 bits)
_BIN_SUFFIX = ".bin"      # the library's bytes
_META_SUFFIX = ".json"    # sidecar: content hash and provenance


def _canon(v: Any) -> Any:
    """Canonicalize a value for the key JSON: dataclasses to sorted dicts,
    tuples to lists, dtypes and everything else exotic to ``str``: the
    digest must be stable across processes."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {k: _canon(getattr(v, k))
                for k in sorted(f.name for f in dataclasses.fields(v))}
    if isinstance(v, dict):
        return {str(k): _canon(v[k]) for k in sorted(v, key=str)}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def kernels_digest() -> str:
    """A digest of the ``library_path`` names of every kernel source: it
    moves when any ``.cu``, any ``.cuh`` or the flags do."""
    names = [_build.library_path(n).name for n in _build.sources()]
    return hashlib.blake2b(json.dumps(names).encode(),
                           digest_size=16).hexdigest()


@dataclasses.dataclass(frozen=True)
class AOTKey:
    """Everything a built library is a function of. Two engines with equal
    keys can exchange libraries; anything else is a miss."""

    model: Any                      # model config (dataclass or dict)
    mesh_shape: Optional[tuple]     # ((axis, size), ...) or None (no mesh)
    buckets: tuple                  # engine._buckets (sorted, deduped)
    slots: int
    max_len: int
    quantize_kv: bool
    decode_block: int
    # top_k is an engine knob outside cfg; JAX bakes it into every
    # executable, so it takes part in the digest here as well: two engines
    # differing only in top_k never share a cache line
    top_k: Optional[int] = None
    torch_version: str = ""
    cuda_version: str = ""
    device: str = ""                # the card's name, "cpu" on the CPU
    capability: str = ""            # compute capability, "9.0" on an H100
    kernels: str = ""               # kernels_digest()

    @staticmethod
    def for_engine(engine) -> "AOTKey":
        mesh = getattr(engine, "_mesh", None)
        mesh_shape = (tuple(sorted(zip(mesh.mesh_dim_names, mesh.shape)))
                      if mesh is not None else None)
        device = getattr(engine, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            name = torch.cuda.get_device_name(device)
            capability = "%d.%d" % torch.cuda.get_device_capability(device)
        else:
            name, capability = "cpu", ""
        return AOTKey(
            model=_canon(engine.cfg),
            mesh_shape=mesh_shape,
            buckets=tuple(engine._buckets),
            slots=engine.slots,
            max_len=engine.max_len,
            quantize_kv=engine.quantize_kv,
            decode_block=engine.decode_block,
            top_k=engine.top_k,
            torch_version=torch.__version__,
            cuda_version=str(torch.version.cuda),
            device=name,
            capability=capability,
            kernels=kernels_digest(),
        )

    def describe(self) -> Dict[str, Any]:
        return _canon(self)

    def digest(self) -> str:
        blob = json.dumps(self.describe(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.blake2b(blob, digest_size=_DIGEST_LEN // 2).hexdigest()


def default_cache_root() -> Path:
    """``KT_AOT_CACHE_DIR``, else ``~/.cache/kubetorch_tpu_torch/aot``: the
    port's own root, apart from the JAX package's, so neither reads the
    other's lines as an ``incompatible`` key."""
    env = os.environ.get("KT_AOT_CACHE_DIR", "").strip()
    if env:
        return Path(env)
    return Path.home() / ".cache" / "kubetorch_tpu_torch" / "aot"


def _blake2b(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class AOTCompileCache:
    """Layered library cache: a local directory and an optional store.

    Layout: ``<root>/<digest>/<name>.bin`` (a library built from
    ``csrc/<name>.cu``) beside ``<name>.json`` (its blake2b, its size, its
    ``library_path`` name) and one ``key.json`` describing the digest's
    key for operators. Writes commit through ``durable_replace``, so a
    crash mid-publish leaves no truncated payload under a final name;
    reads check the sidecar's hash before the bytes are installed where
    ``_build.load`` finds them, so a corrupt entry becomes a typed
    :class:`AOTCacheCorruptError` (counted, then rebuilt) and is never
    loaded. ``counts`` mirrors ``kt_aot_cache_total`` for this object,
    counted per library where JAX counts per executable.
    """

    def __init__(self, root: Optional[os.PathLike] = None, *,
                 store: bool = False, store_url: Optional[str] = None):
        self.root = Path(root) if root is not None else default_cache_root()
        self.store = bool(store)
        self.store_url = store_url
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()   # warm_engine resolves in threads

    # -- accounting ---------------------------------------------------------

    def _count(self, result: str) -> None:
        with self._lock:
            self.counts[result] = self.counts.get(result, 0) + 1
        telemetry.cold_start_metrics()["aot"].inc(result=result)

    # -- paths --------------------------------------------------------------

    def entry_dir(self, key: AOTKey) -> Path:
        return self.root / key.digest()

    def _store_key(self, key: AOTKey, name: str, content_hash: str) -> str:
        # content-addressed: the blake2b of the bytes is part of the name,
        # so a fetched payload is checked against its own key before
        # anything loads it
        return f"aot/{key.digest()}/{name}/{content_hash}"

    def _store_ptr_key(self, key: AOTKey, name: str) -> str:
        return f"aot/{key.digest()}/{name}.ptr"

    # -- store layer --------------------------------------------------------
    #
    # Trust model: a cached payload is a shared library, and loading one
    # runs its code (its initialisers run at dlopen). The content-addressed
    # key pins the payload to the hash its publisher named: a torn copy, a
    # partial overwrite, or a blob swapped under an existing key is
    # rejected before the library is ever installed. What it cannot
    # provide is provenance: a writer who controls BOTH the pointer and
    # the payload can still name its own hash. Enabling ``store=True``
    # therefore asserts that every principal with write access to the
    # ``aot/`` prefix (and to the local cache dir) is trusted to run code
    # on this fleet, the same trust the weight-distribution path already
    # extends to the store.

    def _store_fetch(self, key: AOTKey, name: str, bin_path: Path) -> bool:
        """Pull ``name`` from the store into the local layer. Any failure
        (store down, key absent, content-address mismatch) is a plain
        miss: the store speeds the fleet up and is never needed for a
        right answer."""
        if not self.store:
            return False
        tmp = bin_path.with_name(f"{bin_path.name}.fetch.tmp")
        try:
            from ..data_store import commands as ds
            tmp.parent.mkdir(parents=True, exist_ok=True)
            try:
                ds.get(self._store_ptr_key(key, name), dest=str(tmp),
                       store_url=self.store_url)
                want = tmp.read_bytes().decode("ascii").strip()
            finally:
                tmp.unlink(missing_ok=True)
            if len(want) != 32 or not all(c in "0123456789abcdef"
                                          for c in want):
                self._count("store_corrupt")
                return False
            ds.get(self._store_key(key, name, want), dest=str(tmp),
                   store_url=self.store_url)
            data = tmp.read_bytes()
            tmp.unlink(missing_ok=True)
            if _blake2b(data) != want:
                # the payload does not match the hash its own key names:
                # never install it, never cache it locally
                self._count("store_corrupt")
                return False
            self._write_entry(key, name, data)
            self._count("store_hit")
            return True
        except Exception:
            tmp.unlink(missing_ok=True)
            return False

    def _store_publish(self, key: AOTKey, name: str, bin_path: Path) -> None:
        if not self.store:
            return
        try:
            from ..data_store import commands as ds
            content_hash = _blake2b(bin_path.read_bytes())
            # payload first, pointer last: a reader that wins the race
            # sees either a complete pair or a plain miss
            ds.put(self._store_key(key, name, content_hash), str(bin_path),
                   store_url=self.store_url)
            ptr = bin_path.with_name(f"{bin_path.name}.ptr.tmp")
            ptr.write_text(content_hash)
            try:
                ds.put(self._store_ptr_key(key, name), str(ptr),
                       store_url=self.store_url)
            finally:
                ptr.unlink(missing_ok=True)
            self._count("store_publish")
        except Exception:
            pass

    # -- local layer --------------------------------------------------------

    def _write_entry(self, key: AOTKey, name: str, data: bytes) -> None:
        from ..data_store.durability import durable_write_bytes

        d = self.entry_dir(key)
        d.mkdir(parents=True, exist_ok=True)
        keyfile = d / "key.json"
        if not keyfile.exists():
            durable_write_bytes(keyfile, json.dumps(
                key.describe(), indent=2, sort_keys=True).encode())
        meta = {
            "blake2b": _blake2b(data),
            "nbytes": len(data),
            "library": _build.library_path(name).name,
            "torch": torch.__version__,
            "created": time.time(),
        }
        # bin first, meta last: a reader requires BOTH, so a crash between
        # the two commits reads as an absent entry, not a corrupt one
        durable_write_bytes(d / f"{name}{_BIN_SUFFIX}", data)
        durable_write_bytes(d / f"{name}{_META_SUFFIX}",
                            json.dumps(meta).encode())

    def _other_digest_has(self, digest: str, name: str) -> bool:
        """A sibling cache line holding this name means the miss is a key
        MISMATCH (a version, card, source or bucket drift), not a cold
        cache: operators want those told apart."""
        try:
            for p in self.root.iterdir():
                if (p.is_dir() and p.name != digest
                        and (p / f"{name}{_BIN_SUFFIX}").exists()):
                    return True
        except OSError:
            pass
        return False

    def load(self, key: AOTKey, name: str) -> ctypes.CDLL:
        """The loaded library for ``(key, name)``, or a typed miss. Never a
        wrong library: the digest gates compatibility, the sidecar's hash
        integrity, both before ``ctypes.CDLL`` sees the file. A hit is
        installed at ``_build.library_path(name)`` and loaded through
        ``_build.load``, so every later ``load`` of the name in this
        process, and of any process on this checkout, needs no ``nvcc``."""
        d = self.entry_dir(key)
        bin_path = d / f"{name}{_BIN_SUFFIX}"
        meta_path = d / f"{name}{_META_SUFFIX}"
        if not (bin_path.exists() and meta_path.exists()):
            if not self._store_fetch(key, name, bin_path):
                reason = ("incompatible"
                          if self._other_digest_has(key.digest(), name)
                          else "absent")
                raise AOTCacheMissError(
                    f"AOT cache {reason} for {name!r}",
                    key=key.digest(), name=name, reason=reason)
        data = bin_path.read_bytes()
        try:
            meta = json.loads(meta_path.read_text())
            expected = meta["blake2b"]
        except Exception as e:
            raise AOTCacheCorruptError(
                f"AOT cache sidecar unreadable for {name!r}: {e}",
                key=key.digest(), name=name) from e
        actual = _blake2b(data)
        if actual != expected:
            raise AOTCacheCorruptError(
                f"AOT cache content hash mismatch for {name!r}",
                key=key.digest(), name=name,
                expected=expected, actual=actual)
        path = _build.install(name, data)
        try:
            return _build.load(name)
        except OSError as e:
            # bytes that hash right but do not load: take them out of the
            # build directory, or the next build would take them as built
            path.unlink(missing_ok=True)
            raise AOTCacheCorruptError(
                f"AOT cache library does not load for {name!r}: {e}",
                key=key.digest(), name=name, expected=expected,
                actual=actual) from e

    def put(self, key: AOTKey, name: str, library: os.PathLike) -> None:
        """Store the library file ``library`` under ``(key, name)`` and
        (when the store layer is on) publish it for the fleet."""
        self._write_entry(key, name, Path(library).read_bytes())
        self._count("publish")
        self._store_publish(key, name,
                            self.entry_dir(key) / f"{name}{_BIN_SUFFIX}")

    def get_or_compile(self, key: AOTKey, name: str,
                       build: Callable[[], os.PathLike]
                       ) -> Tuple[ctypes.CDLL, str]:
        """The engine-facing path: a hit loads the cached library; any
        typed miss runs ``build()`` (``_build.build`` for the name: it
        leaves the library at ``library_path(name)`` and returns that
        path), publishes the result and loads it. The second element is
        the result tag (``hit``/``miss``/``incompatible``/``corrupt``)."""
        try:
            lib = self.load(key, name)
            self._count("hit")
            return lib, "hit"
        except AOTCacheCorruptError:
            result = "corrupt"
        except AOTCacheMissError as e:
            result = e.reason if e.reason == "incompatible" else "miss"
        self._count(result)
        path = build()
        try:
            self.put(key, name, path)
        except Exception:
            # a failed publish (read-only dir, disk full) must never fail
            # the boot that just paid for the build
            pass
        return _build.load(name), result


# -- engine warm-up ----------------------------------------------------------

def engine_libraries(engine) -> Dict[tuple, tuple]:
    """The libraries each of the engine's common signatures launches, keyed
    as JAX's executable table: ``("prefill", bucket)`` launches A1
    (``flash_fwd``) where the flash branch takes the bucket, and
    ``("decode", decode_block)`` B1 or B2 (``decode_attention``); both
    launch B3 (``quant_matmul``) when the tree holds int4 leaves. On the
    CPU the wrappers run their plain versions and every entry is empty."""
    from ..models.generate import _flash_prefill_wanted
    from ..models.quant import Q4KEY

    device = torch.device(engine.device)
    cuda = device.type == "cuda"
    q4 = ("quant_matmul",) if cuda and any(
        isinstance(w, dict) and Q4KEY in w
        for w in engine.params["layers"].values()) else ()
    table = {("prefill", b): (("flash_fwd",) if cuda and _flash_prefill_wanted(
        engine.cfg, b, device) else ()) + q4 for b in engine._buckets}
    table[("decode", engine.decode_block)] = (
        ("decode_attention",) if cuda else ()) + q4
    return table


def warm_engine(engine, cache: AOTCompileCache,
                key: Optional[AOTKey] = None) -> Dict[tuple, tuple]:
    """Resolve, through the cache, every library the engine's passes
    launch (:func:`engine_libraries`), one thread per library, so a cold
    pod's ``nvcc`` runs overlap; then run one prefill per bucket and one
    decode block on the engine's device, so the first request pays no lazy
    initialisation (cuBLAS handles, the allocator's first blocks, the
    libraries' first calls). The warm passes launch the kernels and count
    on their wrappers like any other pass. The decode block writes rows
    0..decode_block-1 of every slot; they are put back as they were, so the
    engine's state is a fresh engine's.

    Returns the table ``engine._aot_exec``: ``("prefill", b)`` and
    ``("decode", k)`` as JAX's, each naming the libraries the signature
    launches. On the CPU there are no libraries: the table and the warm
    passes still run, and the cache's counts stay empty."""
    from . import engine as _eng

    t0 = time.monotonic()
    table = engine_libraries(engine)
    names = sorted({n for libs in table.values() for n in libs})
    if names:
        if key is None:
            key = AOTKey.for_engine(engine)
        with ThreadPoolExecutor(max_workers=len(names)) as ex:
            list(ex.map(lambda n: cache.get_or_compile(
                key, n, functools.partial(_build.build, n)), names))

    dev = engine.device
    k = engine.decode_block
    cache_rows = [t[:, :, :k].clone() for t in engine._cache]
    greedy = _eng._Sampling(temp=0.0, top_p=1.0, top_k=engine.top_k,
                            gen=None, pen_row=None, counts_row=None,
                            bias_row=None)
    with engine._mesh_scope():
        for b in engine._buckets:
            _eng._prefill(engine.params,
                          torch.zeros((1, b), dtype=torch.long, device=dev), 1,
                          engine.cfg, engine._freqs, greedy)
        slots = engine.slots
        _eng._decode_block(
            engine.params, engine._cache,
            torch.zeros(slots, dtype=torch.int32, device=dev),
            torch.zeros(slots, dtype=torch.long, device=dev), engine.cfg,
            engine._freqs, k, engine._temps.copy(), engine.top_k,
            engine._top_ps.copy(), [None] * slots)
        for t, rows in zip(engine._cache, cache_rows):
            t[:, :, :k].copy_(rows)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    telemetry.cold_start_metrics()["phase_seconds"].observe(
        time.monotonic() - t0, phase="compile_or_cache")
    return table
