"""The port's compile cache (``kubetorch_tpu_torch/serve/aot_cache.py``)
against the JAX package's, on the CPU.

The cached artifact is a real shared library: a one-function source built
through ``ops/_build.py``'s own ``build`` with ``g++`` standing in for
``nvcc`` (in a temporary ``csrc/`` and build directory), loaded with
ctypes. A "fresh pod" is the same checkout with its build directory
emptied and nothing loaded: a hit there must load with no compiler run.

- Each green case of ``tests/test_cold_start.py``'s ``TestAOTCache`` and
  ``TestAOTStoreLayer`` has a counterpart here that also runs the JAX
  cache through the same events (a jitted ``x + 1`` as its executable)
  and holds the port's counts and result tags to JAX's.
- The two cases that fail in JAX on this machine (executing a
  deserialized executable on the 8-device CPU setup) are held to the
  sequences their asserts spell out, without JAX: a miss that builds and
  publishes, then a hit; a second root that hits from the store.
- The engine: a tiny fp32 Llama engine with ``aot_cache=`` gives the
  greedy tokens of the engine without one and of JAX's engine, has JAX's
  ``aot_stats`` keys (``executables`` = buckets + 1), and its grid is a
  fresh engine's after the warm passes.
"""

import ctypes
import functools
import shutil
from pathlib import Path

import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu import telemetry as jax_telemetry
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.serve.aot_cache import AOTCompileCache as JaxCache
from kubetorch_tpu.serve.aot_cache import AOTKey as JaxKey
from kubetorch_tpu_torch import telemetry
from kubetorch_tpu_torch.exceptions import AOTCacheCorruptError
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.llama import LlamaConfig
from kubetorch_tpu_torch.ops import _build
from kubetorch_tpu_torch.serve import GenerationEngine
from kubetorch_tpu_torch.serve import aot_cache
from kubetorch_tpu_torch.serve.aot_cache import (AOTCompileCache, AOTKey,
                                                 engine_libraries)

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

PROBE_SRC = 'extern "C" float kt_probe_add(float x) { return x + 1.0f; }\n'


@pytest.fixture
def probe(tmp_path, monkeypatch):
    """``_build`` over a temporary csrc/ holding ``probe.cu``, compiled by
    ``g++`` in ``nvcc``'s place; returns a function that empties the build
    directory and forgets every loaded library (a fresh pod)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ builds the stand-in library")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "probe.cu").write_text(PROBE_SRC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        ("-x", "c++", "-O1", "-shared", "-fPIC"))
    monkeypatch.setattr(_build, "nvcc", lambda: gxx)
    monkeypatch.setattr(_build, "_libs", {})

    def fresh_pod():
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        _build._libs.clear()
    return fresh_pod


def _key(**over):
    base = dict(model={"kind": "probe"}, mesh_shape=None, buckets=(8,),
                slots=2, max_len=64, quantize_kv=False, decode_block=1,
                torch_version=torch.__version__)
    base.update(over)
    return AOTKey(**base)


def _jkey(**over):
    base = dict(model={"kind": "probe"}, mesh_shape=None, buckets=(8,),
                slots=2, max_len=64, quantize_kv=False, decode_block=1,
                jax_version=jax.__version__)
    base.update(over)
    return JaxKey(**base)


_build_probe = functools.partial(_build.build, "probe")


def _jax_build():
    return jax.jit(lambda x: x + 1.0).lower(
        jnp.zeros((4,), jnp.float32)).compile()


def _runs():
    return _build.build.nvcc_runs


def _add(lib, x=1.0):
    fn = lib.kt_probe_add
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn(x)


# ---------------------------------------------------------------------------
# the local layer
# ---------------------------------------------------------------------------


def test_absent_is_a_typed_miss(tmp_path, probe):
    for cache, key in ((AOTCompileCache(tmp_path / "p"), _key()),
                       (JaxCache(tmp_path / "j"), _jkey())):
        with pytest.raises(Exception) as e:
            cache.load(key, "probe")
        assert e.type.__name__ == "AOTCacheMissError"
        assert e.value.reason == "absent"
        assert cache.counts == {}


def test_miss_compiles_publishes_then_hits(tmp_path, probe):
    """The sequence of JAX's red case: a miss builds (one compiler run)
    and publishes; a second boot on the same root, as a fresh pod, is a
    pure hit with no compiler run, and the library computes x + 1."""
    runs = _runs()
    cache = AOTCompileCache(tmp_path)
    lib, tag = cache.get_or_compile(_key(), "probe", _build_probe)
    assert tag == "miss" and _runs() == runs + 1
    assert _add(lib) == 2.0
    probe()
    cache2 = AOTCompileCache(tmp_path)
    lib2, tag2 = cache2.get_or_compile(_key(), "probe", _build_probe)
    assert tag2 == "hit"
    assert _runs() == runs + 1
    assert _build.library_path("probe").exists()
    assert _add(lib2, 3.0) == 4.0
    assert cache.counts == {"miss": 1, "publish": 1}
    assert cache2.counts == {"hit": 1}


def test_key_mismatch_is_incompatible_not_absent(tmp_path, probe):
    tags = {}
    for side, cache, key, build in (
            ("port", AOTCompileCache(tmp_path / "p"), _key, _build_probe),
            ("jax", JaxCache(tmp_path / "j"), _jkey, _jax_build)):
        cache.get_or_compile(key(), "probe", build)
        with pytest.raises(Exception) as e:
            cache.load(key(buckets=(8, 16)), "probe")
        assert e.value.reason == "incompatible"
        _, tag = cache.get_or_compile(key(buckets=(8, 16)), "probe", build)
        tags[side] = (tag, dict(cache.counts))
    assert tags["port"] == tags["jax"]
    assert tags["port"][0] == "incompatible"


def _jax_corrupt_sequence(root):
    cache = JaxCache(root)
    cache.get_or_compile(_jkey(), "probe", _jax_build)
    (cache.entry_dir(_jkey()) / "probe.bin").write_bytes(b"garbage")
    with pytest.raises(Exception):
        cache.load(_jkey(), "probe")
    tags = [cache.get_or_compile(_jkey(), "probe", _jax_build)[1],
            cache.get_or_compile(_jkey(), "probe", _jax_build)[1]]
    return tags, cache.counts


def test_corrupt_payload_recompiles_with_typed_count(tmp_path, probe):
    cache = AOTCompileCache(tmp_path / "p")
    key = _key()
    cache.get_or_compile(key, "probe", _build_probe)
    good = _build.library_path("probe").read_bytes()
    (cache.entry_dir(key) / "probe.bin").write_bytes(b"garbage, not an ELF")
    with pytest.raises(AOTCacheCorruptError) as e:
        cache.load(key, "probe")
    assert e.value.expected != e.value.actual
    # the rotten bytes never reached the build directory
    assert _build.library_path("probe").read_bytes() == good
    lib, tag = cache.get_or_compile(key, "probe", _build_probe)
    assert tag == "corrupt" and _add(lib) == 2.0
    # the rebuild re-published a good entry: the next load is a hit
    tags = [tag, cache.get_or_compile(key, "probe", _build_probe)[1]]
    assert (tags, cache.counts) == _jax_corrupt_sequence(tmp_path / "j")


@pytest.mark.parametrize("fault", ["unreadable_sidecar", "missing_sidecar"])
def test_sidecar_faults(tmp_path, probe, fault):
    """An unreadable sidecar is corrupt; a crash between the .bin and the
    .json commits (no sidecar) reads as absent. JAX alike."""
    reasons = []
    for cache, key, build in ((AOTCompileCache(tmp_path / "p"), _key(),
                               _build_probe),
                              (JaxCache(tmp_path / "j"), _jkey(),
                               _jax_build)):
        cache.get_or_compile(key, "probe", build)
        meta = cache.entry_dir(key) / "probe.json"
        if fault == "unreadable_sidecar":
            meta.write_text("{not json")
        else:
            meta.unlink()
        with pytest.raises(Exception) as e:
            cache.load(key, "probe")
        reasons.append((type(e.value).__name__, e.value.reason))
    want = (("AOTCacheCorruptError", "corrupt")
            if fault == "unreadable_sidecar" else
            ("AOTCacheMissError", "absent"))
    assert reasons == [want, want]


@pytest.mark.parametrize("field,value", [
    ("buckets", (8, 16)), ("top_k", 40), ("torch_version", "99.0"),
    ("cuda_version", "99.9"), ("device", "NVIDIA A100-SXM4-80GB"),
    ("capability", "8.0"), ("kernels", "0" * 32), ("quantize_kv", True),
    ("mesh_shape", (("data", 2),))])
def test_digest_is_stable_and_key_sensitive(field, value):
    assert _key().digest() == _key().digest()
    assert _key().digest() != _key(**{field: value}).digest()
    # top_k: two engines differing only in it never share a cache line
    assert _key(top_k=5).digest() != _key(top_k=40).digest()


def test_engine_key_carries_top_k_and_the_device():
    class _Eng:
        cfg = {"kind": "probe"}
        _mesh = None
        _buckets = [8]
        slots, max_len = 2, 64
        quantize_kv, decode_block = False, 1
        top_k = 7
        device = torch.device("cpu")
    key = AOTKey.for_engine(_Eng())
    assert key.top_k == 7 == JaxKey.for_engine(_Eng()).top_k
    assert (key.device, key.capability) == ("cpu", "")
    assert key.torch_version == torch.__version__
    assert key.kernels == aot_cache.kernels_digest()


def test_an_edited_source_or_header_changes_the_key(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    digests = [aot_cache.kernels_digest()]
    src = copy / "decode_attention.cu"
    src.write_text(src.read_text() + "\n")
    digests.append(aot_cache.kernels_digest())
    header = copy / "sm90.cuh"
    header.write_text(header.read_text() + "\n")
    digests.append(aot_cache.kernels_digest())
    assert len(set(digests)) == 3
    assert _key(kernels=digests[0]).digest() != _key(
        kernels=digests[1]).digest()


def test_default_cache_root_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("KT_AOT_CACHE_DIR", raising=False)
    root = aot_cache.default_cache_root()
    assert root.parts[-3:] == (".cache", "kubetorch_tpu_torch", "aot")
    monkeypatch.setenv("KT_AOT_CACHE_DIR", str(tmp_path))
    assert aot_cache.default_cache_root() == tmp_path


def test_a_pod_without_an_entry_or_nvcc_raises(tmp_path, probe, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    cache = AOTCompileCache(tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cache.get_or_compile(_key(), "probe", _build_probe)
    assert cache.counts == {"miss": 1}


def test_install_writes_a_private_name_then_renames(probe):
    path = _build.install("probe", b"first")
    inode = path.stat().st_ino
    assert _build.install("probe", b"first") == path
    assert path.stat().st_ino == inode           # same bytes: untouched
    _build.install("probe", b"second")
    assert path.read_bytes() == b"second"
    assert path.stat().st_ino != inode           # replaced, not rewritten
    assert [p.name for p in _build.BUILD_DIR.iterdir()] == [path.name]


def test_counts_reach_kt_aot_cache_total(tmp_path, probe):
    fam = telemetry.cold_start_metrics()["aot"]
    before = fam.value(result="miss"), fam.value(result="publish")
    AOTCompileCache(tmp_path).get_or_compile(_key(), "probe", _build_probe)
    assert (fam.value(result="miss"), fam.value(result="publish")) == (
        before[0] + 1, before[1] + 1)
    assert set(telemetry.cold_start_metrics()) == set(
        jax_telemetry.cold_start_metrics())
    assert [telemetry.cold_start_metrics()[k].name
            for k in sorted(telemetry.cold_start_metrics())] == [
        jax_telemetry.cold_start_metrics()[k].name
        for k in sorted(jax_telemetry.cold_start_metrics())]
    assert telemetry.COLD_START_PHASES == jax_telemetry.COLD_START_PHASES


# ---------------------------------------------------------------------------
# the store layer
# ---------------------------------------------------------------------------


class _FakeStore:
    """In-memory stand-in for the store client's put/get (path-based)."""

    def __init__(self):
        self.blobs = {}

    def put(self, key, src, store_url=None, **kw):
        self.blobs[key] = Path(src).read_bytes()

    def get(self, key, dest=None, store_url=None, **kw):
        if key not in self.blobs:
            raise KeyError(key)
        Path(dest).write_bytes(self.blobs[key])


@pytest.fixture
def stores(monkeypatch):
    """One fake store behind the port's client, one behind JAX's."""
    from kubetorch_tpu.data_store import commands as jds
    from kubetorch_tpu_torch.data_store import commands as ds
    mine, theirs = _FakeStore(), _FakeStore()
    for mod, store in ((ds, mine), (jds, theirs)):
        monkeypatch.setattr(mod, "put", store.put)
        monkeypatch.setattr(mod, "get", store.get)
    return mine, theirs


def test_publish_is_content_addressed_and_second_node_hits(tmp_path, probe,
                                                           stores):
    """The sequence of JAX's red case, on a fresh pod: the payload's key
    names its blake2b, the pointer is put last, and a second root hits
    from the store with no compiler run."""
    store, _ = stores
    c1 = AOTCompileCache(tmp_path / "node1", store=True)
    c1.get_or_compile(_key(), "probe", _build_probe)
    assert list(store.blobs)[-1].endswith(".ptr")       # pointer last
    ptr_key = [k for k in store.blobs if k.endswith(".ptr")]
    assert len(ptr_key) == 1
    want = store.blobs[ptr_key[0]].decode()
    payload_keys = [k for k in store.blobs if not k.endswith(".ptr")]
    assert payload_keys == [ptr_key[0][:-len(".ptr")] + "/" + want]
    assert c1.counts == {"miss": 1, "publish": 1, "store_publish": 1}
    probe()
    runs = _runs()
    c2 = AOTCompileCache(tmp_path / "node2", store=True)
    lib, tag = c2.get_or_compile(_key(), "probe", _build_probe)
    assert tag == "hit" and _runs() == runs
    assert c2.counts == {"store_hit": 1, "hit": 1}
    assert _add(lib) == 2.0


@pytest.mark.parametrize("tamper", ["payload", "pointer"])
def test_tampered_store_entries_never_load(tmp_path, probe, stores, tamper):
    """A swapped payload or a pointer that is no hash: a counted
    ``store_corrupt`` and a plain miss that builds, never a load. The
    counts and tags equal JAX's on the same events."""
    out = []
    for store, cache_cls, key, build in (
            (stores[0], AOTCompileCache, _key, _build_probe),
            (stores[1], JaxCache, _jkey, _jax_build)):
        side = tmp_path / cache_cls.__module__.split(".")[0]
        cache_cls(side / "node1", store=True).get_or_compile(
            key(), "probe", build)
        for k in list(store.blobs):
            if k.endswith(".ptr") == (tamper == "pointer"):
                store.blobs[k] = (b"../../etc/not-a-hash" if tamper == "pointer"
                                  else b"swapped blob, arbitrary code inside")
        c2 = cache_cls(side / "node2", store=True)
        _, tag = c2.get_or_compile(key(), "probe", build)
        out.append((tag, c2.counts))
    assert out[0] == out[1]
    assert out[0][0] == "miss" and out[0][1]["store_corrupt"] == 1
    assert "store_hit" not in out[0][1]


def test_a_dead_store_is_a_plain_miss(tmp_path, probe, monkeypatch):
    from kubetorch_tpu_torch.data_store import commands as ds

    def down(*a, **kw):
        raise ConnectionError("store down")
    monkeypatch.setattr(ds, "put", down)
    monkeypatch.setattr(ds, "get", down)
    cache = AOTCompileCache(tmp_path, store=True)
    lib, tag = cache.get_or_compile(_key(), "probe", _build_probe)
    assert tag == "miss" and _add(lib) == 2.0
    assert cache.counts == {"miss": 1, "publish": 1}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


PROMPTS = ([5, 17, 42], list(range(1, 101)), [9, 8], [300, 2, 7, 7, 1])
NEW = (6, 5, 7, 4)            # the 100-token prompt takes bucket 128: flash


@pytest.fixture(scope="module")
def tree():
    return np_params(JaxConfig.tiny(), seed=11)


def _drive(eng):
    hs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def _cfg():
    return LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")


def test_engine_with_cache_tokens_equal_plain_and_jax(tree, tmp_path):
    jcfg = JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla")
    jeng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, slots=2,
                     max_len=128, prefill_buckets=(8, 128), aot_cache=None)
    want = _drive(jeng)
    params = params_from_numpy(tree, device="cpu")
    kw = dict(slots=2, max_len=128, prefill_buckets=(8, 128), device="cpu")
    plain = GenerationEngine(params, _cfg(), **kw)
    assert plain.aot_stats() == jeng.aot_stats() == {"executables": 0}
    assert _drive(plain) == want
    for boot in range(2):
        eng = GenerationEngine(params, _cfg(),
                               aot_cache=AOTCompileCache(tmp_path), **kw)
        # buckets 8 and 128 (max_len), and the decode block; on the CPU no
        # library is resolved, so no lookup is counted
        assert eng.aot_stats() == {"executables": len(eng._buckets) + 1}
        assert sorted(eng._aot_exec) == [("decode", 1), ("prefill", 8),
                                         ("prefill", 128)]
        assert set(eng._aot_exec.values()) == {()}
        assert _drive(eng) == want


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_warm_passes_leave_a_fresh_grid(tree, tmp_path, quantize_kv):
    params = params_from_numpy(tree, device="cpu")
    kw = dict(slots=3, max_len=64, prefill_buckets=(8,), decode_block=4,
              quantize_kv=quantize_kv, device="cpu")
    fresh = GenerationEngine(params, _cfg(), **kw)
    warm = GenerationEngine(params, _cfg(), aot_cache=AOTCompileCache(
        tmp_path), **kw)
    for a, b in zip(fresh._cache, warm._cache):
        assert torch.equal(a, b)
    key = AOTKey.for_engine(warm)
    assert (key.quantize_kv, key.decode_block, key.slots, key.buckets) == (
        quantize_kv, 4, 3, (8, 64))
    assert key.model == aot_cache._canon(_cfg())
    s = warm.stats()
    assert (s.admitted_total, s.tokens_generated, s.decode_steps) == (0, 0, 0)
    assert not warm._pos.any() and not warm._tok.any()


class _StubEngine:
    def __init__(self, device, params, attn_impl="auto", buckets=(40, 128, 256)):
        self.device = torch.device(device)
        self.cfg = LlamaConfig.tiny(attn_impl=attn_impl)
        self.params = params
        self._buckets = list(buckets)
        self.decode_block = 2


def test_engine_libraries_name_what_each_signature_launches():
    from kubetorch_tpu_torch.models.quant import Q4KEY
    dense = {"layers": {"wq": torch.zeros(1)}}
    int4 = {"layers": {"wq": {Q4KEY: torch.zeros(1), "scale": torch.zeros(1)}}}
    table = engine_libraries(_StubEngine("cuda", dense))
    assert table == {("prefill", 40): (), ("prefill", 128): ("flash_fwd",),
                     ("prefill", 256): ("flash_fwd",),
                     ("decode", 2): ("decode_attention",)}
    table = engine_libraries(_StubEngine("cuda", int4, attn_impl="xla"))
    assert table == {("prefill", 40): ("quant_matmul",),
                     ("prefill", 128): ("quant_matmul",),
                     ("prefill", 256): ("quant_matmul",),
                     ("decode", 2): ("decode_attention", "quant_matmul")}
    assert set(engine_libraries(_StubEngine("cpu", int4)).values()) == {()}
