"""The port's live weight rollout (``kubetorch_tpu_torch/serve/rollout.py``),
its content fingerprints and the engine's service hooks, against the JAX
package on the CPU.

A real store server (the JAX package's, as ``tests/test_rollout.py`` starts
it) backs every case; :class:`JaxStore` puts the port's store protocol
(``kubetorch_tpu_torch/data_store/commands.py``) over the JAX package's
client. Engines are ``tiny`` in fp32. What must hold:

- fingerprints of the same weights equal JAX's exactly, for fp32, bf16,
  int8 and int4-packed trees;
- every JAX rollout scenario (delta swap, fingerprint gate, structure and
  shape refusals, canary scoping and rollback, a trainer killed before
  its manifest, the canary controller) gives the port the same outcome
  and the same ``reason``;
- a JAX-published tree, bf16 included, swaps into a port replica, and a
  port-published fp32 or int8 tree into a JAX replica; a port bf16 tree
  is refused by a JAX replica (its index says ``uint16``);
- a live port engine swaps between batches, its in-flight streams
  finish, and its greedy tokens afterwards equal a JAX engine's on the
  new tree; a registered prefix keeps its old rows in both engines;
- ``__kt_metrics__`` has the JAX engine's keys; the feedback payloads
  have the JAX engine's keys and feed JAX's flywheel ledger;
- the rollout metrics render the JAX package's text.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu import telemetry as jax_tel
from kubetorch_tpu.data_store import commands as ds
from kubetorch_tpu.data_store import ring as ring_mod
from kubetorch_tpu.models import quant as jq
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.serve import rollout as jro
from kubetorch_tpu.train import checkpoint as jck
from kubetorch_tpu_torch import telemetry as pt_tel
from kubetorch_tpu_torch.exceptions import RolloutError
from kubetorch_tpu_torch.models import quant as pq
from kubetorch_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from kubetorch_tpu_torch.models.llama import LlamaConfig
from kubetorch_tpu_torch.serve import GenerationEngine, SpeculativeEngine
from kubetorch_tpu_torch.serve import rollout as ro
from kubetorch_tpu_torch.train import checkpoint as ck
from tests.assets.threaded_server import ThreadedAiohttpServer

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

JCFG = JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla")
PCFG = LlamaConfig.tiny(dtype=torch.float32)


class JaxStore:
    """The port's store protocol over the JAX package's store client (the
    bytes cross the wire to a real store server)."""

    def __init__(self, url: str):
        self.url = url

    def put(self, key, tree):
        return ds.put(key, tree, store_url=self.url)

    def get(self, key):
        return ds.get(key, store_url=self.url, peer=False)

    def put_json(self, key, obj):
        return ds.put_json(key, obj, store_url=self.url)

    def get_json(self, key, quorum=False, default=None):
        return ds.get_json(key, store_url=self.url, quorum=quorum,
                           default=default)

    def get_index(self, key, expect_hash=None):
        r = ds._RoutedFetcher(self.url, key, False).fetch(
            f"{key}{ds._INDEX_SUFFIX}", timeout=60, expect_hash=expect_hash)
        return json.loads(r.content) if r.status_code == 200 else None

    def get_leaf(self, key, path, meta):
        r = ds._RoutedFetcher(self.url, key, False).fetch(
            f"{key}/{path}", expect_hash=meta.get("blake2b"))
        if r.status_code != 200:
            return None
        return ds._decode_array(r.content, meta, None)


@pytest.fixture
def store_url(tmp_path, monkeypatch):
    monkeypatch.setenv("KT_STORE_FSYNC", "0")
    monkeypatch.setenv("KT_SCRUB_INTERVAL_S", "0")
    from kubetorch_tpu.data_store.store_server import create_store_app
    ring_mod.reset_rings()
    with ThreadedAiohttpServer(
            lambda: create_store_app(str(tmp_path / "store"))) as srv:
        yield srv.url
    ring_mod.reset_rings()


@pytest.fixture
def store(store_url):
    return JaxStore(store_url)


def _tree():
    return {"layers": {"w1": np.arange(64, dtype=np.float32).reshape(8, 8),
                       "w2": np.ones((4, 4), np.float32)},
            "norm": np.full((8,), 2.0, np.float32)}


def _zeros_like_tree():
    return {"layers": {"w1": np.zeros((8, 8), np.float32),
                       "w2": np.zeros((4, 4), np.float32)},
            "norm": np.zeros((8,), np.float32)}


def _publish(who, store, service, tree, step, **kw):
    """The trainer side, from either package, onto the same store."""
    if who == "port":
        return ck.publish_rollout(service, tree, step, store=store, **kw)
    return jck.publish_rollout(service, tree, step, store_url=store.url, **kw)


PUBLISHERS = [pytest.param("port", id="port_publish"),
              pytest.param("jax", id="jax_publish")]


@pytest.fixture
def engine():
    eng = ro.HostEngine(_zeros_like_tree(), step_s=0.0005).start()
    yield eng
    eng.stop()


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def _fp_trees(kind):
    """(port tensor tree, JAX-side numpy tree) of the same weights."""
    tree = np_params(JaxConfig.tiny(), seed=3)
    if kind == "fp32":
        return params_from_numpy(tree, device="cpu"), tree
    if kind == "bf16":
        jt = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
        pt = params_from_numpy(tree, device="cpu")
        return jax.tree_util.tree_map(lambda t: t.bfloat16(), pt), jt
    jfn, pfn = {"int8": (jq.quantize_params, pq.quantize_params),
                "int4": (jq.quantize_params_int4,
                         pq.quantize_params_int4)}[kind]
    jt = jax.tree_util.tree_map(
        np.asarray, jfn(jax.tree_util.tree_map(jnp.asarray, tree)))
    return pfn(params_from_numpy(tree, device="cpu")), jt


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4"])
def test_tree_fingerprint_equals_jax(kind):
    """Tensors (bf16 through the uint16 hand-off) and the numpy hand-off
    both fingerprint as JAX's numpy tree does."""
    pt, jt = _fp_trees(kind)
    want = jck.tree_fingerprint(jt)
    assert ck.tree_fingerprint(pt) == want
    assert ck.tree_fingerprint(params_to_numpy(pt)) == want


def test_params_to_numpy_round_trips_bf16_bits():
    t = torch.randn(3, 5).bfloat16()
    host = params_to_numpy({"w": t})["w"]
    assert host.dtype == np.uint16 and host.flags["C_CONTIGUOUS"]
    back = params_from_numpy({"w": host.view(jnp.bfloat16)}, device="cpu")["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    before = host.copy()
    t.add_(1)                       # the hand-off is a copy, not a view
    np.testing.assert_array_equal(host, before)


# ---------------------------------------------------------------------------
# JAX's WeightRollout scenarios on the port's coordinator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("who", PUBLISHERS)
def test_apply_and_delta_swap(store, engine, who):
    tree1 = _tree()
    out1 = _publish(who, store, "svc", tree1, 1)
    wr = ro.WeightRollout(engine, "svc", store=store, replica_id="r1")
    req = engine.submit(50)            # decode stream across the swap
    res = wr.poll_once()
    assert res["version"] == 1 and res["leaves_changed"] == 3
    assert res["bytes"] == {"store": 64 * 4 + 16 * 4 + 8 * 4}
    assert wr.fingerprint == out1["fingerprint"]
    assert wr.last_swap_thread == "kt-host-engine"
    np.testing.assert_array_equal(engine.params["layers"]["w1"],
                                  tree1["layers"]["w1"])
    assert req["done"].wait(10) and req["error"] is None
    # delta push: only the changed leaf moves/swaps
    tree2 = _tree()
    tree2["layers"]["w2"] = np.full((4, 4), 5.0, np.float32)
    _publish(who, store, "svc", tree2, 2)
    res2 = wr.poll_once()
    assert res2["leaves_changed"] == 1 and res2["bytes"] == {"store": 64}
    np.testing.assert_array_equal(engine.params["layers"]["w2"],
                                  tree2["layers"]["w2"])
    assert wr.poll_once() is None      # already converged


def test_fingerprint_gate_refuses_before_touching_engine(store, engine):
    store.put(ro.weights_key("svc"), _tree())
    ro.publish_manifest("svc", key=ro.weights_key("svc"),
                        fingerprint="deadbeef" * 5, store=store)
    wr = ro.WeightRollout(engine, "svc", store=store)
    with pytest.raises(RolloutError) as ei:
        wr.poll_once()
    assert ei.value.reason == "fingerprint_mismatch"
    assert wr.version == 0 and wr.swaps == 0
    np.testing.assert_array_equal(engine.params["layers"]["w1"],
                                  np.zeros((8, 8), np.float32))
    assert wr.status()["last_error"]


@pytest.mark.parametrize("who", PUBLISHERS)
def test_structure_change_is_typed_refusal(store, engine, who):
    bad = {"layers": {"w1": np.ones((8, 8), np.float32)}}   # missing leaves
    _publish(who, store, "svc", bad, 1)
    wr = ro.WeightRollout(engine, "svc", store=store)
    with pytest.raises(RolloutError) as ei:
        wr.poll_once()
    assert ei.value.reason == "structure_mismatch"
    assert wr.swaps == 0


@pytest.mark.parametrize("who", PUBLISHERS)
def test_shape_change_is_typed_refusal(store, engine, who):
    bad = _zeros_like_tree()
    bad["layers"]["w2"] = np.ones((2, 2), np.float32)       # wrong shape
    _publish(who, store, "svc", bad, 1)
    wr = ro.WeightRollout(engine, "svc", store=store)
    with pytest.raises(RolloutError) as ei:
        wr.poll_once()
    assert ei.value.reason == "shape_mismatch"
    assert wr.swaps == 0


def test_missing_index_is_typed_refusal(store, engine):
    ro.publish_manifest("svc", key="rollout/svc/nothing", store=store)
    with pytest.raises(RolloutError) as ei:
        ro.WeightRollout(engine, "svc", store=store).poll_once()
    assert ei.value.reason == "missing_index"


def test_canary_scoping_and_rollback(store):
    """Canary manifests swap ONLY the named replica; the rollback manifest
    rolls the canary back from its pre-swap stash and bumps everyone
    else's version without touching their weights."""
    eng1 = ro.HostEngine(_zeros_like_tree(), step_s=0.0).start()
    eng2 = ro.HostEngine(_zeros_like_tree(), step_s=0.0).start()
    try:
        wr1 = ro.WeightRollout(eng1, "svc", store=store, replica_id="r1")
        wr2 = ro.WeightRollout(eng2, "svc", store=store, replica_id="r2")
        tree1 = _tree()
        out1 = ck.publish_rollout("svc", tree1, 1, store=store)
        assert wr1.poll_once()["version"] == 1
        assert wr2.poll_once()["version"] == 1
        tree2 = _tree()
        tree2["norm"] = np.full((8,), 9.0, np.float32)
        out2 = ck.publish_rollout("svc", tree2, 2, store=store,
                                  phase="canary", canary="r1")
        assert wr1.poll_once()["version"] == 2
        assert wr2.poll_once() is None          # non-canary never swaps
        assert wr2.fingerprint == out1["fingerprint"]
        counter = pt_tel.counter("kt_rollout_rollbacks_total",
                                 labels=("reason",))
        before = counter.value(reason="canary_regression")
        ro.publish_manifest("svc", key=out2["manifest"]["key"], step=1,
                            fingerprint=out1["fingerprint"],
                            phase="rollback", reason="canary_regression",
                            store=store)
        res = wr1.poll_once()
        assert res["rolled_back"] is True
        np.testing.assert_array_equal(eng1.params["norm"], tree1["norm"])
        assert wr1.fingerprint == out1["fingerprint"]
        res2 = wr2.poll_once()
        assert res2["rolled_back"] is False and wr2.swaps == 1
        assert wr1.version == wr2.version == 3
        assert counter.value(reason="canary_regression") == before + 1
        assert any(s["replica"] == "r1" for s in ro.local_status())
    finally:
        eng1.stop()
        eng2.stop()


def test_trainer_killed_before_manifest_leaves_fleet_on_old_version(
        store, engine):
    """The manifest PUT is the commit point: weights pushed without a
    manifest change nothing fleet-side."""
    out1 = ck.publish_rollout("svc", _tree(), 1, store=store)
    wr = ro.WeightRollout(engine, "svc", store=store)
    wr.poll_once()
    torn = _tree()
    torn["layers"]["w1"] = np.full((8, 8), 123.0, np.float32)
    store.put(ro.weights_key("svc"), torn)
    assert wr.poll_once() is None
    assert wr.version == 1 and wr.fingerprint == out1["fingerprint"]


def test_canary_rollout_controller_promote_and_rollback(store):
    """CanaryRollout over JAX's Router: publish→bake→promote when the
    canary serves cleanly, publish→bake→typed rollback manifest when its
    requests fail (the Router's own error-rate verdict)."""
    import asyncio

    from kubetorch_tpu.serving.router import Router
    from tests.test_serve_router import FakePool

    canary, ips = "10.1.0.2", ["10.1.0.1", "10.1.0.2", "10.1.0.3"]

    class TrafficRouter(Router):
        """Pinning the canary sends it 5 requests, failing or not."""

        def __init__(self, failing):
            super().__init__(fn_name="f")
            self.failing = failing

        def set_canary(self, replica, fraction=0.1):
            super().set_canary(replica, fraction=fraction)
            pool = FakePool()
            if self.failing:
                pool.app_error.add(replica)

            async def go():
                for _ in range(5):
                    try:
                        await self.dispatch(
                            pool=pool, ips=ips, my_ip="9.9.9.9", method=None,
                            args=[], kwargs={}, headers=None, timeout=None,
                            local_call=None)
                    except ValueError:
                        pass
            asyncio.run(go())

    calls = []

    def publish(phase, canary=None):
        calls.append(phase)
        return ck.publish_rollout("svc", _tree(), len(calls), store=store,
                                  phase=phase, canary=canary)["manifest"]

    def controller(failing):
        return ro.CanaryRollout("svc", TrafficRouter(failing), store=store,
                                slice_fraction=1.0, bake_s=0.3,
                                min_requests=5)

    # first-ever rollout: no baseline to regress from → straight to fleet
    assert controller(False).run(publish, canary) == "promoted"
    assert calls == ["fleet"]
    ctl = controller(False)
    assert ctl.run(publish, canary) == "promoted"
    assert calls == ["fleet", "canary", "fleet"]
    assert ctl.router.canary_state() is None          # cleared after the bake
    prev = ro.read_manifest("svc", store=store)
    assert prev["phase"] == "fleet"
    # a failing canary: the Router reads "regressed" → a typed rollback
    # manifest to the PREVIOUS fingerprint, never a fleet promote
    assert controller(True).run(publish, canary) == "rolled_back"
    assert calls == ["fleet", "canary", "fleet", "canary"]
    m = ro.read_manifest("svc", store=store)
    assert m["phase"] == "rollback"
    assert m["reason"] == "canary_regression"
    assert m["fingerprint"] == prev["fingerprint"]


@pytest.mark.parametrize("call", [
    lambda: ro.read_manifest("svc"),
    lambda: ro.WeightRollout(ro.HostEngine({}), "svc"),
    lambda: ro.CanaryRollout("svc", object()),
    lambda: ck.publish_rollout("svc", _tree(), 1),
])
def test_store_is_required(call):
    with pytest.raises(TypeError, match="store is required"):
        call()


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_published_tree_swaps_into_a_port_replica(store, dtype):
    """A JAX trainer's tree (ml_dtypes bf16 leaves for bf16) lands in a
    port replica's torch tensors, in place, bit for bit."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    params = {"layers": {"w1": torch.zeros(8, 8, dtype=tdt),
                         "w2": torch.zeros(4, 4, dtype=tdt)},
              "norm": torch.zeros(8, dtype=tdt)}
    held = params["layers"]["w1"]
    eng = ro.HostEngine(params, step_s=0.0).start()
    try:
        host = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, dtype)), _tree())
        out = jck.publish_rollout("svc", host, 1, store_url=store.url)
        wr = ro.WeightRollout(eng, "svc", store=store)
        res = wr.poll_once()
        assert res["leaves_changed"] == 3
        assert wr.fingerprint == out["fingerprint"]
        assert eng.params["layers"]["w1"] is held          # in place
        want = torch.from_numpy(np.asarray(host["layers"]["w1"]).astype(
            np.float32)).to(tdt)
        assert torch.equal(held, want)
        assert ck.tree_fingerprint(eng.params) == out["fingerprint"]
    finally:
        eng.stop()


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_port_published_tree_swaps_into_a_jax_replica(store, kind):
    pt, jt = _fp_trees(kind)
    zeros = jax.tree_util.tree_map(np.zeros_like, jt)
    eng = jro.HostEngine(zeros, step_s=0.0).start()
    try:
        out = ck.publish_rollout("svc", pt, 1, store=store)
        wr = jro.WeightRollout(eng, "svc", store_url=store.url, peer=False)
        res = wr.poll_once()
        assert res["version"] == 1
        assert wr.fingerprint == out["fingerprint"] == jck.tree_fingerprint(jt)
        for (path, got), want in zip(
                jax.tree_util.tree_leaves_with_path(eng.params),
                jax.tree_util.tree_leaves(jt)):
            np.testing.assert_array_equal(got, want, err_msg=str(path))
    finally:
        eng.stop()


def test_port_bf16_tree_is_refused_by_a_jax_replica(store):
    """The port's bf16 hand-off records uint16 in the index; JAX's gate
    compares dtype names and refuses (ROADMAP Queue C)."""
    pt, jt = _fp_trees("bf16")
    eng = jro.HostEngine(jax.tree_util.tree_map(np.zeros_like, jt),
                         step_s=0.0)
    out = ck.publish_rollout("svc", pt, 1, store=store)
    assert out["fingerprint"] == jck.tree_fingerprint(jt)
    wr = jro.WeightRollout(eng, "svc", store_url=store.url, peer=False)
    with pytest.raises(jro.RolloutError) as ei:
        wr.poll_once()
    assert ei.value.reason == "shape_mismatch"


# ---------------------------------------------------------------------------
# the live engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def np_tree():
    return np_params(JaxConfig.tiny(), seed=21)


def _engine(tree, **kw):
    return GenerationEngine(params_from_numpy(tree, device="cpu"), PCFG,
                            slots=2, max_len=64, prefill_buckets=(16,),
                            device="cpu", **kw)


def test_at_batch_boundary_runs_on_the_step_thread(np_tree):
    eng = _engine(np_tree)
    # no loop thread: runs inline on the caller
    assert eng.at_batch_boundary(lambda: threading.get_ident()) \
        == threading.get_ident()
    eng.start()
    try:
        h = eng.submit([1, 2, 3], max_new_tokens=8)
        seen = {}

        def hook():
            seen["thread"] = threading.current_thread().name
            return 42

        assert eng.at_batch_boundary(hook, timeout=60) == 42
        assert seen["thread"] == "kt-gen-engine"
        assert len(h.result(timeout=60)) == 8
        # an erroring hook reaches the CALLER; the loop survives
        with pytest.raises(RuntimeError, match="boom"):
            eng.at_batch_boundary(
                lambda: (_ for _ in ()).throw(RuntimeError("boom")),
                timeout=60)
        h2 = eng.submit([4, 5], max_new_tokens=4)
        assert len(h2.result(timeout=60)) == 4
    finally:
        eng.stop()


def test_stop_runs_a_hook_queued_in_the_stop_race(np_tree):
    eng = _engine(np_tree)
    box = {"done": threading.Event()}
    eng._boundary_hooks.append((lambda: 7, box))
    eng.stop()
    assert box["done"].is_set() and box["result"] == 7


def _jax_engine(tree):
    return JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree), JCFG,
                     slots=2, max_len=64, prefill_buckets=(16,))


def _jax_tokens(eng, prompts, n, **kw):
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def _perturbed(tree):
    new = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)
    new["layers"]["wq"] = new["layers"]["wq"] * 1.5
    new["final_norm"] = new["final_norm"] * 0.5
    return new


def test_live_engine_swap_gives_the_new_trees_tokens(store, np_tree):
    """A port engine decoding on its loop thread swaps a published delta
    between batches: the in-flight stream finishes, the swapped leaves are
    the engine's own tensors, updated in place, and its greedy tokens
    afterwards equal a JAX engine's built on the new tree."""
    eng = _engine(np_tree)
    held = eng.params["layers"]["wq"]
    eng.start()
    try:
        h = eng.submit([1, 2, 3], max_new_tokens=24)
        new = _perturbed(np_tree)
        out = ck.publish_rollout("llm", new, 1, store=store)
        wr = ro.WeightRollout(eng, "llm", store=store)
        res = wr.poll_once()
        assert res["leaves_changed"] == 2
        assert wr.fingerprint == out["fingerprint"]
        assert wr.last_swap_thread == "kt-gen-engine"
        assert eng.params["layers"]["wq"] is held
        np.testing.assert_array_equal(held.numpy(), new["layers"]["wq"])
        assert len(h.result(timeout=120)) == 24
        prompts = [[5, 6, 7, 8], [9, 10]]
        got = [eng.submit(p, max_new_tokens=6).result(timeout=120)
               for p in prompts]
    finally:
        eng.stop()
    assert got == _jax_tokens(_jax_engine(new), prompts, 6)


def test_swap_keeps_registered_prefix_rows_like_jax(store, np_tree):
    """Neither rollout touches an engine's registered prefixes: after the
    swap a prefix hit still attends the rows computed with the old
    weights, in the port engine as in the JAX engine."""
    prefix, suffix = [3, 1, 4, 1, 5, 9, 2, 6], [5, 3]
    new = _perturbed(np_tree)
    eng, jeng = _engine(np_tree), _jax_engine(np_tree)
    pid, jpid = eng.register_prefix(prefix), jeng.register_prefix(prefix)
    ck.publish_rollout("llm", new, 1, store=store)
    ro.WeightRollout(eng, "llm", store=store).poll_once()
    jro.WeightRollout(jeng, "llm", store_url=store.url, peer=False).poll_once()
    got = _jax_tokens(eng, [suffix], 5, prefix_id=pid)
    assert got == _jax_tokens(jeng, [suffix], 5, prefix_id=jpid)
    fresh = _engine(new)
    pid = fresh.register_prefix(prefix)
    h = fresh.submit(suffix, max_new_tokens=5, prefix_id=pid)
    while fresh.step():
        pass
    assert h.result(timeout=0) != got       # the old rows made a difference


# ---------------------------------------------------------------------------
# service hooks
# ---------------------------------------------------------------------------


def test_kt_metrics_keys_equal_jax(np_tree):
    eng = _engine(np_tree)
    eng.submit([1, 2], max_new_tokens=3)
    while eng.step():
        pass
    m = eng.__kt_metrics__()
    assert all(isinstance(v, float) for v in m.values())
    assert m["engine_finished_total"] == 1.0
    assert m["engine_tokens_generated"] == 3.0
    assert m["engine_slots"] == 2.0 and m["engine_slots_free"] == 2.0
    jeng = _jax_engine(np_tree)
    assert set(m) == set(jeng.__kt_metrics__())
    assert eng.aot_stats() == {"executables": 0} == jeng.aot_stats()


def test_spec_engine_kt_metrics(np_tree):
    dtree = np_params(JaxConfig.tiny(), seed=22)
    spec = SpeculativeEngine(params_from_numpy(np_tree, device="cpu"), PCFG,
                             params_from_numpy(dtree, device="cpu"), PCFG,
                             spec_k=2, slots=2, max_len=64,
                             prefill_buckets=(16,), device="cpu")
    h = spec.submit([1, 2], max_new_tokens=5)
    while spec.step():
        pass
    sm = spec.__kt_metrics__()
    assert sm["engine_spec_rounds"] >= 1.0
    assert sm["engine_spec_draft_len"] == float(spec.k)
    assert 0.0 <= sm["engine_spec_acceptance_rate"] <= 1.0
    plain = _engine(np_tree).__kt_metrics__()   # JAX's keys (test above)
    assert set(sm) == set(plain) | {"engine_spec_rounds",
                                    "engine_spec_acceptance_rate",
                                    "engine_spec_draft_len"}
    assert len(h.result(timeout=0)) == 5
    # the spec loop runs boundary hooks too
    spec.start()
    try:
        assert spec.at_batch_boundary(
            lambda: threading.current_thread().name, timeout=60) \
            == "kt-gen-engine"
    finally:
        spec.stop()


def test_feedback_sink_payloads_feed_the_jax_ledger(store_url, np_tree):
    from kubetorch_tpu.flywheel import ledger as fl

    def collect(eng, sink):
        seen = []

        def tap(payload):
            seen.append(payload)
            sink(payload)
        eng.feedback_sink = tap
        eng.submit([1, 2, 3], max_new_tokens=4)
        h = eng.submit([4, 5], max_new_tokens=6)
        eng.step()
        h.cancel()                 # retires mid-decode, cancelled=True
        while eng.step():
            pass
        return seen

    led = fl.FeedbackLedger("svc", "r1", store_url=store_url, sample_rate=1.0)
    got = collect(_engine(np_tree), fl.engine_feedback_hook(led))
    want = collect(_jax_engine(np_tree), lambda p: None)
    assert len(got) == 2
    assert [set(p) for p in got] == [set(p) for p in want]
    assert [(p["generated"], p["prompt"], p["cancelled"]) for p in got] == \
        [(p["generated"], p["prompt"], p["cancelled"]) for p in want]
    assert all(p["ttft_s"] is not None and p["ttft_s"] >= 0 for p in got
               if p["generated"])
    assert len(fl.read_all_hashes("svc", ["r1"], store_url=store_url)) \
        == len(got)

    def boom(payload):
        raise RuntimeError("sink")
    eng = _engine(np_tree)
    eng.feedback_sink = boom
    h = eng.submit([1], max_new_tokens=2)
    while eng.step():
        pass
    assert len(h.result(timeout=0)) == 2      # a raising sink stalls nothing


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_rollout_metrics_render_the_jax_text():
    """Counter text equals JAX's for the same observations, and the
    rollout family's headers equal JAX's."""
    assert pt_tel.Counter("x", "", ()).render() == \
        jax_tel.Counter("x", "", ()).render()
    texts = []
    for mod in (pt_tel, jax_tel):
        c = mod.Counter("kt_t_bytes_total", "Bytes \"moved\"", ("source",))
        c.inc(3, source="origin")
        c.inc(2.5, source="peer\n1")
        c.inc(source="origin")
        texts.append(c.render())
    assert texts[0] == texts[1]
    gauges = [pt_tel.Gauge("kt_t_version", "Version"),
              jax_tel.Gauge("kt_t_version", "Version", ())]
    hists = [pt_tel.Histogram("kt_t_seconds", "Seconds", ("phase",)),
             jax_tel.Histogram("kt_t_seconds", "Seconds", ("phase",))]
    for g, h in zip(gauges, hists):
        g.set(3)
        for v, ph in ((0.004, "fetch"), (1.58, "swap"), (0.2, "swap")):
            h.observe(v, phase=ph)
    assert gauges[0].render() == gauges[1].render()
    assert hists[0].render() == hists[1].render()
    for name in ("kt_rollout_seconds", "kt_rollout_bytes_total",
                 "kt_rollout_rollbacks_total", "kt_rollout_version",
                 "kt_checkpoint_seconds"):
        port = pt_tel._REGISTRY[name]
        jax_m = jax_tel.REGISTRY._metrics[name]
        assert port.render()[:2] == jax_m.render()[:2], name
