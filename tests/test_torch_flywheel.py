"""The port's continuous-learning flywheel (``kubetorch_tpu_torch/flywheel/``,
the drain half of ``serving/elastic.py``, ``chaos.flywheel_kill_plan``)
against the JAX package on the CPU.

A real store server (the JAX package's, as ``tests/test_flywheel.py``
starts it) backs the twins, reached through the port's ``HttpStore``;
the engine case puts the port's ledger on an in-process store. Engines
are ``tiny`` in fp32, weights carried across by ``params_from_numpy``.
What must hold:

- every non-slow case of ``tests/test_flywheel.py`` that covers a ported
  piece (ledger, cursor, harvester, promoter, status snapshot, kill plan)
  and the drain-flag case of ``tests/test_elastic.py`` gives the port
  JAX's outcome;
- either package's cursor polls the other's appends in the same order,
  and restores the other's committed cursor state, checksum and all;
  ``record_hash`` equals JAX's on drawn payloads;
- a port engine with the port's hook and a JAX engine with JAX's hook
  write the same payloads (timings aside) and the same greedy tokens;
- the port's ``Promoter`` drives a port engine under ``WeightRollout``
  through promoted, gate_rejected and rolled_back, and the engine's
  tokens then equal JAX's ``generate`` over the tree each verdict leaves
  live;
- a trainer subprocess killed by ``kill-flywheel:9@2`` and a second one
  resuming it lose no acked record and train none twice, by the JAX
  package's ``check_flywheel_ledger``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from kubetorch_tpu.data_store import commands as jds
from kubetorch_tpu.data_store import ring as jring
from kubetorch_tpu.flywheel import ledger as jfl
from kubetorch_tpu.models import generate as jax_gen
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.soak import history as H
from kubetorch_tpu_torch import chaos
from kubetorch_tpu_torch import telemetry as pt_tel
from kubetorch_tpu_torch.data_store import commands as ds
from kubetorch_tpu_torch.data_store import ring as pring
from kubetorch_tpu_torch.exceptions import DataCorruptionError, StaleLeaseError
from kubetorch_tpu_torch.flywheel import harvester as hv
from kubetorch_tpu_torch.flywheel import ledger as fl
from kubetorch_tpu_torch.flywheel import promoter as pm
from kubetorch_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_loss_chunked
from kubetorch_tpu_torch.models.lora import LoraConfig, lora_init, lora_loss, merge_lora
from kubetorch_tpu_torch.serve import GenerationEngine
from kubetorch_tpu_torch.serve import rollout as ro
from kubetorch_tpu_torch.serving import elastic
from kubetorch_tpu_torch.train import adam, init_train_state, make_train_step
from kubetorch_tpu_torch.train import checkpoint as ck
from tests.assets.threaded_server import ThreadedAiohttpServer

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla")
PCFG = LlamaConfig.tiny(dtype=torch.float32)
DRILL_TIMEOUT_S = 30


def _store_app(tmp_path, monkeypatch, chaos_spec=None):
    monkeypatch.setenv("KT_STORE_FSYNC", "0")
    monkeypatch.setenv("KT_SCRUB_INTERVAL_S", "0")
    if chaos_spec:
        monkeypatch.setenv("KT_CHAOS", chaos_spec)
    from kubetorch_tpu.data_store.store_server import create_store_app
    return ThreadedAiohttpServer(
        lambda: create_store_app(str(tmp_path / "store")))


@pytest.fixture
def store_url(tmp_path, monkeypatch):
    jring.reset_rings()
    pring.reset_rings()
    with _store_app(tmp_path, monkeypatch) as srv:
        yield srv.url
    jring.reset_rings()
    pring.reset_rings()


@pytest.fixture
def store(store_url):
    return ds.HttpStore(store_url, peer=False)


class DictStore:
    """The JSON half of the store protocol in this process's memory (each
    value kept as its JSON text, as a store keeps bytes)."""

    def __init__(self):
        self.kv = {}

    def put_json(self, key, obj):
        self.kv[key] = json.dumps(obj)
        return {"key": key}

    def get_json(self, key, quorum=False, default=None):
        v = self.kv.get(key)
        return default if v is None else json.loads(v)


def _tree(scale=1.0):
    return {"w": np.arange(16, dtype=np.float32) * scale,
            "b": np.ones((4,), np.float32)}


# ---------------------------------------------------------------------------
# FeedbackLedger: the append/durability boundary (twins)
# ---------------------------------------------------------------------------


def test_append_returns_hashes_and_roundtrips(store):
    led = fl.FeedbackLedger("svc", "r1", store=store)
    p1, p2 = {"prompt": 1, "reward": 0.5}, {"prompt": 2, "reward": 0.9}
    hashes = led.append([p1, p2])
    assert hashes == [fl.record_hash(p1), fl.record_hash(p2)]
    assert led.next_seq == 1
    assert fl.read_all_hashes("svc", ["r1"], store=store) == hashes
    head = store.get_json(fl.head_key("svc", "r1"))
    assert head["seq"] == 0


def test_append_rejects_an_oversized_segment(store):
    led = fl.FeedbackLedger("svc", "r1", store=store)
    with pytest.raises(ValueError):
        led.append([{"i": i} for i in range(fl.MAX_SEGMENT_RECORDS + 1)])


def test_restarted_replica_probes_past_a_torn_head(store):
    led = fl.FeedbackLedger("svc", "r1", store=store)
    led.append([{"i": 0}])
    store.put_json(fl.segment_key("svc", "r1", 1),
                   {"replica": "r1", "seq": 1,
                    "records": [{"hash": fl.record_hash({"i": 1}),
                                 "payload": {"i": 1}}], "at": 0.0})
    led2 = fl.FeedbackLedger("svc", "r1", store=store)
    assert led2.next_seq == 2
    led2.append([{"i": 2}])
    assert len(fl.read_all_hashes("svc", ["r1"], store=store)) == 3


def test_sample_rate_gates_and_coin_is_deterministic(store):
    led = fl.FeedbackLedger("svc", "r1", store=store, sample_rate=0.5)
    assert led.sample({"i": 1}, coin=0.9) is None
    assert led.sample({"i": 1}, coin=0.1) == [fl.record_hash({"i": 1})]
    off = fl.FeedbackLedger("svc", "r2", store=store, sample_rate=0.0)
    assert off.sample({"i": 2}) is None
    assert fl.read_all_hashes("svc", ["r2"], store=store) == []


def test_sample_rate_env_and_store_required(store, monkeypatch):
    monkeypatch.setenv(fl.SAMPLE_RATE_ENV, "0.25")
    assert fl.FeedbackLedger("svc", "r1", store=store).sample_rate == 0.25
    for make in (lambda: fl.FeedbackLedger("svc", "r1"),
                 lambda: fl.LedgerCursor("svc", ["r1"]),
                 lambda: fl.read_all_hashes("svc", ["r1"]),
                 lambda: pm.Promoter("svc", object()),
                 lambda: pm.flywheel_status("svc", ["r1"])):
        with pytest.raises(TypeError, match="store is required"):
            make()


def test_engine_feedback_hook_never_raises():
    led = fl.FeedbackLedger.__new__(fl.FeedbackLedger)
    led.service, led.replica_id = "svc", "r1"
    led.store, led.retries = ds.HttpStore("http://127.0.0.1:9"), 0
    led.sample_rate, led._seq = 1.0, 0
    sink = fl.engine_feedback_hook(led)
    sink({"request_id": "x"})           # must not raise


# ---------------------------------------------------------------------------
# crash windows (twins)
# ---------------------------------------------------------------------------


def test_ack_dropped_append_commits_once(tmp_path, monkeypatch):
    """drop-ack: the store commits the segment's PUT and drops the ack;
    the re-put absorbs it, the record exists once, append returns it."""
    jring.reset_rings()
    pring.reset_rings()
    with _store_app(tmp_path, monkeypatch, "drop-ack@0") as srv:
        st_ = ds.HttpStore(srv.url, peer=False)
        led = fl.FeedbackLedger("svc", "r1", store=st_)
        hashes = led.append([{"i": 1}])
        assert hashes == [fl.record_hash({"i": 1})]
        assert fl.read_all_hashes("svc", ["r1"], store=st_) == hashes
    jring.reset_rings()
    pring.reset_rings()


def test_replica_death_after_commit_before_ack_dedups_at_consume(store):
    payload = {"prompt": 7, "reward": 0.25}
    fl.FeedbackLedger("svc", "r1", store=store).append([payload])
    fl.FeedbackLedger("svc", "r1", store=store).append([payload])
    assert len(fl.read_all_hashes("svc", ["r1"], store=store)) == 2
    cur = fl.LedgerCursor("svc", ["r1"], store=store)
    deduped = pt_tel.flywheel_metrics()["deduped"]
    before = deduped.value(service="svc")
    batch = cur.poll()
    assert [r["hash"] for r in batch] == [fl.record_hash(payload)]
    assert deduped.value(service="svc") == before + 1
    cur.commit_state(1)
    assert cur.poll() == []


def test_torn_cursor_state_refuses_restore(store):
    cur = fl.LedgerCursor("svc", ["r1"], store=store)
    fl.FeedbackLedger("svc", "r1", store=store).append([{"i": 1}])
    cur.poll()
    state = cur.commit_state(1)
    torn = dict(state)
    torn["positions"] = {"r1": 99}
    store.put_json(fl.cursor_state_key("svc", 1), torn)
    fresh = fl.LedgerCursor("svc", ["r1"], store=store)
    with pytest.raises(DataCorruptionError):
        fresh.restore(1)
    with pytest.raises(DataCorruptionError):
        fl.LedgerCursor("svc", ["r1"], store=store).restore(42)


def test_crash_between_state_put_and_checkpoint_commit_repolls(store):
    fl.FeedbackLedger("svc", "r1", store=store).append([{"i": 1}])
    cur = fl.LedgerCursor("svc", ["r1"], store=store)
    batch = cur.poll()
    assert len(batch) == 1
    cur.commit_state(1)                 # state put... then "crash" here
    redo = fl.LedgerCursor("svc", ["r1"], store=store)
    assert redo.restore(None) is False
    assert [r["hash"] for r in redo.poll()] == [b["hash"] for b in batch]
    done = fl.LedgerCursor("svc", ["r1"], store=store)
    assert done.restore(1) is True
    assert done.step == 1 and done.poll() == []


def test_two_trainers_racing_one_cursor_epoch_fence(store):
    c1 = fl.LedgerCursor("svc", ["r1"], store=store, owner="t1")
    assert c1.acquire() == 1
    fl.FeedbackLedger("svc", "r1", store=store).append([{"i": 1}])
    c1.poll()
    c2 = fl.LedgerCursor("svc", ["r1"], store=store, owner="t2")
    assert c2.acquire() == 2
    with pytest.raises(StaleLeaseError) as ei:
        c1.poll()
    assert (ei.value.workload, ei.value.epoch, ei.value.current_epoch) == \
        ("flywheel/svc", 1, 2)
    with pytest.raises(StaleLeaseError):
        c1.commit_state(1)
    c2.poll()
    c2.commit_state(1)


def test_cursor_lag_counts_unconsumed_segments(store):
    led = fl.FeedbackLedger("svc", "r1", store=store)
    cur = fl.LedgerCursor("svc", ["r1"], store=store)
    assert cur.lag_records() == 0
    led.append([{"i": 1}])
    led.append([{"i": 2}])
    assert cur.lag_records() == 2
    cur.poll()
    cur.commit_state(1)
    assert cur.lag_records() == 0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _append(who, store, replica, payloads):
    if who == "port":
        return fl.FeedbackLedger("svc", replica, store=store).append(payloads)
    return jfl.FeedbackLedger("svc", replica, store_url=store.url).append(
        payloads)


def _cursor(who, store, **kw):
    if who == "port":
        return fl.LedgerCursor("svc", ["r1", "r2"], store=store, **kw)
    return jfl.LedgerCursor("svc", ["r1", "r2"], store_url=store.url, **kw)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_cursor_polls_the_other_packages_appends(store, writer):
    """Two replicas written by one package (a re-sampled payload among
    them); both packages' cursors poll the same records in the same order,
    in two polls bounded at segment boundaries."""
    other = "jax" if writer == "port" else "port"
    acked = []
    acked += _append(writer, store, "r1", [{"i": 0}, {"i": 1}])
    acked += _append(other, store, "r2", [{"i": 2, "t": [1, 2]}])
    acked += _append(writer, store, "r1", [{"i": 3, "x": None}])
    acked += _append(writer, store, "r2", [{"i": 0}, {"f": 0.25}])
    polls = {}
    for who in ("port", "jax"):
        cur = _cursor(who, store)
        first = [r["hash"] for r in cur.poll(max_records=2)]
        cur.commit_state(1)
        polls[who] = [first, [r["hash"] for r in cur.poll()]]
    assert polls["port"] == polls["jax"]
    assert polls["port"][0] == acked[:2]
    # r1 then r2; the re-sampled {"i": 0} on r2 is deduplicated
    assert polls["port"][1] == [acked[3], acked[2], acked[5]]
    assert fl.read_all_hashes("svc", ["r1", "r2"], store=store) == \
        jfl.read_all_hashes("svc", ["r1", "r2"], store_url=store.url)


@pytest.mark.parametrize("committer", ["port", "jax"])
def test_cursor_state_crosses_packages(store, committer):
    """A state one package's cursor commits, the other restores: the same
    positions, seen hashes and step, the checksum valid under both."""
    other = "jax" if committer == "port" else "port"
    _append("port", store, "r1", [{"i": 1}, {"i": 2}])
    _append("jax", store, "r2", [{"i": 3}])
    cur = _cursor(committer, store)
    assert len(cur.poll()) == 3
    cur.commit_state(4)
    doc = store.get_json(fl.cursor_state_key("svc", 4))
    assert doc["checksum"] == fl._state_checksum(
        doc["positions"], doc["seen"], doc["step"]) == jfl._state_checksum(
        doc["positions"], doc["seen"], doc["step"])
    back = _cursor(other, store)
    assert back.restore(4) is True
    assert (back.positions, back.seen, back.step) == \
        (cur.positions, cur.seen, cur.step)
    assert back.poll() == []
    _append(committer, store, "r1", [{"i": 4}, {"i": 1}])
    assert [r["payload"] for r in back.poll()] == [{"i": 4}]


_JSON = st.recursive(
    st.none() | st.booleans() | st.integers(-2 ** 70, 2 ** 70)
    | st.floats() | st.text(max_size=12),
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(st.text(max_size=6), inner, max_size=4),
    max_leaves=16)


@settings(max_examples=60, deadline=None)
@given(payload=st.dictionaries(st.text(max_size=8), _JSON, max_size=6))
def test_record_hash_equals_jax(payload):
    assert fl.record_hash(payload) == jfl.record_hash(payload)
    assert fl.segment_key("s", "r", 7) == jfl.segment_key("s", "r", 7)
    assert fl.head_key("s", "r") == jfl.head_key("s", "r")
    assert fl.cursor_state_key("s", 3) == jfl.cursor_state_key("s", 3)
    assert fl.cursor_lease_key("s") == jfl.cursor_lease_key("s")


# ---------------------------------------------------------------------------
# HarvestPolicy / Harvester (twins)
# ---------------------------------------------------------------------------


def test_harvest_policy_headroom_matrix():
    pol = hv.HarvestPolicy(slo_ms=100.0, headroom=0.25)
    assert pol.decide(50.0) == hv.HARVEST
    assert pol.decide(75.0) == hv.HARVEST
    assert pol.decide(80.0, harvesting=True) == hv.VACATE
    assert pol.decide(80.0, harvesting=False) == hv.IDLE
    quiet = hv.HarvestPolicy(slo_ms=-1.0, headroom=0.25,
                             min_headroom_ms=1.0)
    quiet.slo_ms = 0.0
    assert quiet.decide(0.5) == hv.HARVEST
    assert quiet.decide(10.0, harvesting=True) == hv.VACATE


def test_harvest_settings_come_from_the_environment(monkeypatch):
    """No layered config in the port: the environment variable JAX's
    config reads, else JAX's default."""
    assert hv.HarvestPolicy().headroom == 0.25
    assert hv.HarvestPolicy().slo_ms == 0.0
    h = hv.Harvester(hv.HarvestPolicy(), lambda: 0.0, lambda: None,
                     lambda: None)
    assert h.drain_grace_s == 20.0
    monkeypatch.setenv(hv.HEADROOM_ENV, "0.5")
    monkeypatch.setenv(hv.SLO_ENV, "200")
    monkeypatch.setenv(elastic.DRAIN_GRACE_ENV, "3.5")
    pol = hv.HarvestPolicy()
    assert (pol.headroom, pol.slo_ms) == (0.5, 200.0)
    assert pol.decide(100.0) == hv.HARVEST and pol.decide(101.0) == hv.IDLE
    assert hv.Harvester(pol, lambda: 0.0, lambda: None,
                        lambda: None).drain_grace_s == 3.5
    monkeypatch.setenv(pm.GATE_ENV, "0.1")
    assert pm.Promoter("svc", object(), store=DictStore()).gate_tolerance \
        == 0.1


def test_harvester_trains_until_drained_and_vacates_in_grace():
    stepped = []

    def train_step():
        if len(stepped) >= 3:
            return None
        stepped.append(1)
        return len(stepped)

    flushed = []
    harv = hv.Harvester(hv.HarvestPolicy(slo_ms=100.0, headroom=0.25),
                        scrape=lambda: 10.0, train_step=train_step,
                        flush=lambda: flushed.append(1),
                        drain_grace_s=5.0, idle_s=0.01)
    out = harv.run_cycle()
    assert out["reason"] == "drained" and out["steps"] == 3
    assert out["within_grace"] and flushed == [1]
    assert harv.harvested_steps == 3 and harv.vacates == 1


def test_harvester_exits_on_drain_request():
    elastic.clear_drain()
    try:
        harv = hv.Harvester(hv.HarvestPolicy(slo_ms=100.0),
                            scrape=lambda: 0.0,
                            train_step=lambda: 1,
                            flush=lambda: None, drain_grace_s=5.0)
        elastic.request_drain("preempted")
        out = harv.run_cycle(max_steps=100)
        assert out["reason"] == "drain" and out["steps"] == 0
    finally:
        elastic.clear_drain()


def test_harvester_vacates_on_a_drain_mid_cycle():
    """The drain flag flipped inside a step: the loop leaves at the next
    iteration and flushes once; a cleared flag lets the next cycle run."""
    elastic.clear_drain()
    steps = []

    def train_step():
        steps.append(1)
        if len(steps) == 2:
            elastic.request_drain("preempted")
        return len(steps)

    flushed = []
    harv = hv.Harvester(hv.HarvestPolicy(slo_ms=100.0), scrape=lambda: 0.0,
                        train_step=train_step,
                        flush=lambda: flushed.append(len(steps)),
                        drain_grace_s=5.0)
    try:
        out = harv.run_cycle(max_steps=10)
        assert (out["reason"], out["steps"], flushed) == ("drain", 2, [2])
        assert out["within_grace"]
        elastic.clear_drain()
        out = harv.run_cycle(max_steps=3)
        assert (out["reason"], out["steps"]) == ("max-steps", 3)
    finally:
        elastic.clear_drain()


def test_harvester_policy_vacate_mid_cycle():
    waits = iter([10.0, 10.0, 90.0, 90.0])
    harv = hv.Harvester(hv.HarvestPolicy(slo_ms=100.0, headroom=0.25),
                        scrape=lambda: next(waits),
                        train_step=lambda: 1,
                        flush=lambda: None, drain_grace_s=5.0)
    out = harv.run_cycle(max_steps=100)
    assert out["reason"] == "policy" and out["steps"] == 2


def test_harvest_record_is_batch_tier_preemptible():
    rec = hv.harvest_record("svc")
    assert rec["scheduling"] == {"priority": "batch", "preemptible": True}
    assert rec["name"] == "flywheel-svc"


# ---------------------------------------------------------------------------
# the drain half of the elastic contract (twins)
# ---------------------------------------------------------------------------


def test_drain_flag_helpers():
    elastic.clear_drain()
    assert not elastic.drain_requested()
    elastic.request_drain("SIGTERM")
    assert elastic.drain_requested()
    assert elastic.drain_reason() == "SIGTERM"
    elastic.request_drain("other")              # idempotent: first wins
    assert elastic.drain_reason() == "SIGTERM"
    elastic.clear_drain()
    assert not elastic.drain_requested()


def test_sigterm_flips_the_drain_flag():
    drains = pt_tel._REGISTRY["kt_elastic_drains_total"]
    before = drains.value()
    prev = signal.getsignal(signal.SIGTERM)
    elastic.clear_drain()
    try:
        elastic.install_sigterm_drain()
        # never signal a process whose handler did not take
        assert signal.getsignal(signal.SIGTERM) not in (prev, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not elastic.drain_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert elastic.drain_reason() == "SIGTERM"
        assert drains.value() == before + 1
    finally:
        signal.signal(signal.SIGTERM, prev)
        elastic.clear_drain()


# ---------------------------------------------------------------------------
# Promoter (twins)
# ---------------------------------------------------------------------------


class ScriptedRouter:
    def __init__(self, verdict="ok"):
        self.verdict = verdict
        self.pinned = None

    def set_canary(self, replica, fraction=0.1):
        self.pinned = (replica, fraction)

    def clear_canary(self):
        self.pinned = None

    def canary_verdict(self, **kw):
        return self.verdict


def _promoter(store, verdict="ok", eval_fn=None, tol=0.05, router=None):
    return pm.Promoter("svc", router or ScriptedRouter(verdict), store=store,
                       eval_fn=eval_fn, gate_tolerance=tol,
                       bake_s=0.2, min_requests=1, poll_s=0.02)


def _l1(t):
    return float(np.abs(t["w"]).mean())


def test_promoter_good_delta_promotes_and_commits_baseline(store):
    p = _promoter(store, eval_fn=_l1)
    assert p.promote(_tree(), step=1) == pm.PROMOTED
    m = ro.read_manifest("svc", store=store)
    assert m["phase"] == "fleet" and m["step"] == 1
    base = store.get_json(pm.eval_baseline_key("svc"))
    assert base is not None and base["step"] == 1


def test_promoter_eval_gate_rejects_before_any_manifest(store):
    p = _promoter(store, eval_fn=_l1)
    assert p.promote(_tree(), step=1) == pm.PROMOTED
    before = ro.read_manifest("svc", store=store)["version"]
    assert p.promote(_tree(scale=100.0), step=2) == pm.GATE_REJECTED
    assert ro.read_manifest("svc", store=store)["version"] == before
    assert p.history[-1]["verdict"] == pm.GATE_REJECTED


def test_promoter_break_glass_bad_delta_rolled_back(store, monkeypatch):
    p = _promoter(store, eval_fn=_l1)
    assert p.promote(_tree(), step=1) == pm.PROMOTED
    assert p.promote(_tree(scale=0.5), step=2) == pm.PROMOTED
    prev = ro.read_manifest("svc", store=store)
    monkeypatch.setenv(pm.BREAK_ENV, pm.BREAK_PROMOTE_BAD)
    bad = _promoter(store, verdict="regressed", eval_fn=_l1)
    assert bad.promote(_tree(scale=100.0), step=3) == pm.ROLLED_BACK
    m = ro.read_manifest("svc", store=store)
    assert m["phase"] == "rollback"
    assert m["fingerprint"] == prev["fingerprint"]
    base = store.get_json(pm.eval_baseline_key("svc"))
    assert base["step"] == 2


def test_flywheel_status_snapshot(store):
    led = fl.FeedbackLedger("svc", "r1", store=store)
    led.append([{"i": 1}])
    cur = fl.LedgerCursor("svc", ["r1"], store=store, owner="t1")
    cur.acquire()
    cur.poll()
    cur.commit_state(1)
    p = _promoter(store)
    assert p.promote(_tree(), step=1) == pm.PROMOTED
    out = pm.flywheel_status("svc", ["r1"], store=store)
    assert set(out["lag_seconds"]) == set(pm.LAG_STAGES)
    for stage in pm.LAG_STAGES:
        assert out["lag_seconds"][stage] is not None
    assert out["lease"]["epoch"] == 1 and out["cursor"]["step"] == 1
    assert out["manifest"]["phase"] == "fleet"
    lag = pt_tel.flywheel_metrics()["lag"]
    assert lag.value(stage="collect") == pytest.approx(
        out["lag_seconds"]["collect"], abs=1e-3)
    # JAX's snapshot of the same store reads the same documents
    from kubetorch_tpu.flywheel import promoter as jpm
    want = jpm.flywheel_status("svc", ["r1"], store_url=store.url)
    for k in ("replicas", "cursor", "lease", "manifest", "eval_baseline"):
        assert out[k] == want[k], k


def test_flywheel_kill_plan_reads_spec_and_env(monkeypatch):
    assert chaos.flywheel_kill_plan("kill-flywheel:9@2") == {2: 9}
    assert chaos.flywheel_kill_plan("kill-rank:9@2") == {}
    monkeypatch.setenv("KT_CHAOS", "kill-flywheel:15@1,delay:0.1")
    assert chaos.flywheel_kill_plan() == {1: 15}
    monkeypatch.delenv("KT_CHAOS")
    assert chaos.flywheel_kill_plan() == {}


def test_flywheel_metrics_headers_equal_jax():
    from kubetorch_tpu import telemetry as jax_tel
    jm, pmx = jax_tel.flywheel_metrics(), pt_tel.flywheel_metrics()
    assert set(jm) == set(pmx)
    for k in jm:
        assert pmx[k].render()[:2] == jm[k].render()[:2], k
        assert pmx[k].labelnames == tuple(jm[k].labelnames), k


# ---------------------------------------------------------------------------
# the engine: payloads and tokens against JAX's engine and hook
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def np_tree():
    return np_params(JaxConfig.tiny(), seed=23)


def _engine(tree):
    return GenerationEngine(params_from_numpy(tree, device="cpu"), PCFG,
                            slots=2, max_len=64, prefill_buckets=(16,),
                            device="cpu")


def _jax_engine(tree):
    return JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree), JCFG,
                     slots=2, max_len=64, prefill_buckets=(16,))


def _serve(eng, prompts, n, cancel=None):
    hs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    if cancel is not None:
        eng.step()
        hs[cancel].cancel()
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def _payloads(read_json, replica):
    out, seq = [], 0
    while True:
        seg = read_json(fl.segment_key("svc", replica, seq))
        if seg is None:
            return out
        out += [r["payload"] for r in seg["records"]]
        seq += 1


def test_engine_feedback_ledger_equals_jax(store_url, np_tree):
    """The same requests through the port's engine and hook (ledger on an
    in-process store) and JAX's (ledger on the store server): the same
    payloads in the same order, timings aside, prompts as Python ints, and
    the same greedy tokens."""
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14]]
    mem = DictStore()
    eng = _engine(np_tree)
    eng.feedback_sink = fl.engine_feedback_hook(
        fl.FeedbackLedger("svc", "r0", store=mem, sample_rate=1.0))
    jeng = _jax_engine(np_tree)
    jeng.feedback_sink = jfl.engine_feedback_hook(
        jfl.FeedbackLedger("svc", "r0", store_url=store_url, sample_rate=1.0))
    got = _serve(eng, prompts, 6, cancel=1)
    want = _serve(jeng, prompts, 6, cancel=1)
    assert [len(o) for o in got] == [len(o) for o in want]
    assert [o for i, o in enumerate(got) if i != 1] == \
        [o for i, o in enumerate(want) if i != 1]
    mine = _payloads(mem.get_json, "r0")
    theirs = _payloads(lambda k: jds.get_json(k, store_url=store_url), "r0")
    assert len(mine) == len(prompts) == len(theirs)
    timings = ("ttft_s", "latency_s")
    assert [{k: v for k, v in p.items() if k not in timings} for p in mine] \
        == [{k: v for k, v in p.items() if k not in timings} for p in theirs]
    assert any(p["cancelled"] for p in mine)
    assert all(type(t) is int for p in mine for t in p["prompt"])
    assert fl.read_all_hashes("svc", ["r0"], store=mem) == \
        [fl.record_hash(p) for p in mine]


# ---------------------------------------------------------------------------
# the promoter end to end: a port engine under WeightRollout
# ---------------------------------------------------------------------------


class ReplicaRouter(ScriptedRouter):
    """A scripted router whose pinned canary replica converges on the
    manifest at once (its rollout coordinator polls when pinned)."""

    def __init__(self, rollout, verdict="ok"):
        super().__init__(verdict)
        self.rollout = rollout
        self.canary_tokens = None
        self.probe = None

    def set_canary(self, replica, fraction=0.1):
        super().set_canary(replica, fraction)
        assert self.rollout.poll_once() is not None
        if self.probe is not None:
            self.canary_tokens = self.probe()


def _jax_generate(tree, prompts, n):
    out = jax_gen.generate(jax.tree_util.tree_map(jnp.asarray, tree),
                           jnp.asarray(prompts, jnp.int32), JCFG,
                           max_new_tokens=n)
    return np.asarray(out)[:, len(prompts[0]):].tolist()


def test_promoter_drives_a_port_engine_through_each_verdict(
        store, np_tree, monkeypatch):
    """Promoted, gate_rejected, rolled_back on a port engine whose rollout
    coordinator is the canary replica; after each, the engine's greedy
    tokens equal JAX's generate over the tree that verdict leaves live."""
    prompts, n = [[3, 1, 4, 1], [5, 9, 2, 6]], 6
    lcfg = LoraConfig(rank=4, targets=("wq", "wv"))
    base = params_from_numpy(np_tree, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, PCFG.vocab_size, (2, 17)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    held = torch.from_numpy(rng.integers(0, PCFG.vocab_size, (2, 17)))
    opt = adam(1e-2)
    step = make_train_step(lora_loss(base, PCFG, lcfg), opt)
    state = init_train_state(lora_init(base, lcfg, seed=1), opt)
    for _ in range(3):
        state, _ = step(state, batch)
    good = params_to_numpy(merge_lora(base, state.params, lcfg))
    bad_adapter = {"layers": {k: v * (10.0 if k.endswith("__b") else 1.0)
                              for k, v in state.params["layers"].items()}}
    bad = params_to_numpy(merge_lora(base, bad_adapter, lcfg))

    def held_out_loss(tree):
        params = params_from_numpy(tree, device="cpu")
        with torch.no_grad():
            return float(llama_loss_chunked(params, held[:, :-1],
                                            held[:, 1:], PCFG))

    assert held_out_loss(bad) > held_out_loss(good) * 1.01
    eng = _engine(np_tree)
    ck.publish_rollout("svc", np_tree, 0, store=store)     # the fleet's v1
    wr = ro.WeightRollout(eng, "svc", store=store, replica_id="canary")
    assert wr.poll_once()["leaves_changed"] == 0
    router = ReplicaRouter(wr)
    router.probe = lambda: _serve(eng, prompts, n)
    p = _promoter(store, eval_fn=held_out_loss, tol=0.01, router=router)

    want_good = _jax_generate(good, prompts, n)
    assert p.promote(good, step=1) == pm.PROMOTED
    assert router.canary_tokens == want_good
    assert wr.poll_once()["leaves_changed"] == 0 and wr.phase == "fleet"
    promoted = ro.read_manifest("svc", store=store)
    assert wr.fingerprint == promoted["fingerprint"] == \
        ck.tree_fingerprint(good)
    assert _serve(eng, prompts, n) == want_good

    router.canary_tokens = None
    assert p.promote(bad, step=2) == pm.GATE_REJECTED
    assert router.canary_tokens is None
    assert ro.read_manifest("svc", store=store)["version"] == \
        promoted["version"]
    assert wr.poll_once() is None
    assert _serve(eng, prompts, n) == want_good

    monkeypatch.setenv(pm.BREAK_ENV, pm.BREAK_PROMOTE_BAD)
    router.verdict = "regressed"
    assert p.promote(bad, step=3) == pm.ROLLED_BACK
    assert router.canary_tokens == _jax_generate(bad, prompts, n)
    res = wr.poll_once()
    assert res["rolled_back"]
    m = ro.read_manifest("svc", store=store)
    assert m["phase"] == "rollback"
    assert m["fingerprint"] == promoted["fingerprint"] == wr.fingerprint
    assert store.get_json(pm.eval_baseline_key("svc"))["step"] == 1
    assert _serve(eng, prompts, n) == want_good
    assert [h["verdict"] for h in p.history] == \
        [pm.PROMOTED, pm.GATE_REJECTED, pm.ROLLED_BACK]


# ---------------------------------------------------------------------------
# the kill-and-resume drill: trainer subprocesses on the port
# ---------------------------------------------------------------------------

# The port's copy of the JAX package's flywheel trainer asset: it folds
# the ledger through LedgerCursor (acquired) and commits through the
# two-slot Checkpointer, cursor state first, and writes the JAX trainer's
# JSONL lines. KT_CHAOS's kill-flywheel verb kills it before a poll.
_TRAINER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from kubetorch_tpu_torch import chaos
from kubetorch_tpu_torch.data_store.commands import HttpStore
from kubetorch_tpu_torch.flywheel.ledger import LedgerCursor
from kubetorch_tpu_torch.train.checkpoint import Checkpointer, tree_fingerprint

url, result, resume, owner = sys.argv[2], sys.argv[3], sys.argv[4] == "1", \
    sys.argv[5]

def emit(rec):
    with open(result, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())

store = HttpStore(url, peer=False)
kill_plan = chaos.flywheel_kill_plan()
ckpt = Checkpointer("drill/ckpt", store=store)
cursor = LedgerCursor("fly", ["r1", "r2"], store=store, owner=owner)
cursor.acquire()
state = {"w": np.random.default_rng(19).standard_normal(64).astype(np.float32)}
step = 0
if resume:
    restored = ckpt.restore()
    if restored is not None:
        state, step = restored
        emit({"restored": step, "fingerprint": tree_fingerprint(state)})
    else:
        emit({"restored": None})
    cursor.restore(step if restored is not None else None)
    emit({"cursor_restored": step if restored else None})
op = 0
while True:
    if op in kill_plan:
        emit({"dying_at_op": op})
        os.kill(os.getpid(), kill_plan[op])
    batch = cursor.poll(max_records=3)
    op += 1
    if not batch:
        break
    step += 1
    w = state["w"] * np.float32(0.95)
    for rec in batch:
        w = w + np.float32(int(rec["hash"][:8], 16) / float(1 << 32))
    state = {"w": w}
    emit({"consumed": [r["hash"] for r in batch], "step": step})
    cursor.commit_state(step)
    ckpt.save(state, step)
    emit({"cursor_committed": step})
    emit({"committed": step, "fingerprint": tree_fingerprint(state)})
emit({"done": True, "final_step": step,
      "fingerprint": tree_fingerprint(state)})
"""


def _trainer(url, result, resume, owner, env):
    return subprocess.run(
        [sys.executable, "-c", _TRAINER, REPO, url, str(result),
         "1" if resume else "0", owner],
        env=env, capture_output=True, text=True, timeout=DRILL_TIMEOUT_S)


def _history(hist, result):
    """The trainer's JSONL as the soak conductor imports it."""
    with open(result) as f:
        for line in f:
            rec = json.loads(line)
            if "consumed" in rec:
                hist.record("flywheel", event="consumed",
                            hashes=rec["consumed"], step=rec.get("step"))
            elif "cursor_committed" in rec:
                hist.record("flywheel", event="cursor-committed",
                            step=rec["cursor_committed"])
            elif "cursor_restored" in rec:
                hist.record("flywheel", event="cursor-restored",
                            step=rec["cursor_restored"])
            elif "dying_at_op" in rec:
                hist.record("flywheel", event="dying", op=rec["dying_at_op"])


def test_kill_and_resume_drill_loses_nothing_and_trains_nothing_twice(
        store, tmp_path):
    """Two replicas ack 8 segments (a re-sampled payload among them); a
    port trainer dies by SIGKILL before its third poll; a second one
    takes the cursor over, restores the last committed step and drains
    the ledger. JAX's check_flywheel_ledger finds no violation, and every
    acked hash was folded into exactly one committed step."""
    hist = H.History()
    for i in range(8):
        replica = ("r1", "r2")[i % 2]
        payloads = [{"i": i, "k": k} for k in range(3)]
        if i == 5:
            payloads[0] = {"i": 0, "k": 0}     # re-sampled by a restart
        hashes = fl.FeedbackLedger("fly", replica, store=store).append(
            payloads)
        hist.record("flywheel", event="acked", hashes=hashes)
    env = dict(os.environ, KT_CHAOS="kill-flywheel:9@2")
    env.pop("KT_CHAOS_RANK", None)
    t0 = time.monotonic()
    first = _trainer(store.url, tmp_path / "t1.jsonl", False, "t1", env)
    assert first.returncode == -signal.SIGKILL, first.stderr[-2000:]
    env.pop("KT_CHAOS")
    second = _trainer(store.url, tmp_path / "t2.jsonl", True, "t2", env)
    assert second.returncode == 0, second.stderr[-2000:]
    took = time.monotonic() - t0
    _history(hist, tmp_path / "t1.jsonl")
    _history(hist, tmp_path / "t2.jsonl")
    hist.record("flywheel", event="settle-read",
                hashes=fl.read_all_hashes("fly", ["r1", "r2"], store=store))
    records = hist.records()
    assert H.check_flywheel_ledger(records) == []
    events = [r["event"] for r in records]
    assert "dying" in events and "cursor-restored" in events
    committed = {r["step"] for r in records
                 if r["event"] == "cursor-committed"}
    folded = [h for r in records if r["event"] == "consumed"
              and r["step"] in committed for h in r["hashes"]]
    acked = {h for r in records if r["event"] == "acked" for h in r["hashes"]}
    assert sorted(folded) == sorted(acked)          # each exactly once
    assert store.get_json(fl.cursor_lease_key("fly"))["epoch"] == 2
    print(f"kill-and-resume drill: {took:.2f}s for both trainers")
