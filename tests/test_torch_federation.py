"""The port's federation tier (``kubetorch_tpu_torch/federation/``:
``XRegionReplicator``, ``fallback_commit``; ``train/checkpoint.py:
commit_info_ex``) over real store fleets on the CPU, twins of
``tests/test_federation.py:397-486``, and the store ring's failover and
quorum reads through the port's client.

- The replicator's cases one for one: ``_key_tier`` equal to JAX's, a
  sweep that replicates and converges, never rolling back a newer target,
  a target region down then back (bounded lag, then 0; the port's client
  has no ``KT_CHAOS`` partition verb), the metrics under JAX's names.
- A port ``Checkpointer`` commits in region A over ``HttpStore``, a
  replicator (the port's, and JAX's) copies it to region B, A dies: with
  ``KT_FED_STORES`` set the port's ``commit_info`` finds the marker in B
  and ``restore`` reads the slot there, fingerprint-equal to what was
  saved.
- Across the packages: the port's replicator moves a JAX checkpoint and
  JAX's moves a port's, with JAX's pushed/skipped counts on the same
  stores.
- Unfederated, a dead store raises: it never reads as "no checkpoint".
- A two-node ring: a write survives one node's death, ``get_json`` at
  quorum reads the newest marker, the topology's parsing equals JAX's.
"""

import time

import numpy as np
import pytest

from kubetorch_tpu import telemetry as jtel
from kubetorch_tpu.data_store import commands as jds
from kubetorch_tpu.data_store import ring as jring
from kubetorch_tpu.data_store.store_server import create_store_app
from kubetorch_tpu.federation import replication as jrep
from kubetorch_tpu.federation import topology as jtopo
from kubetorch_tpu.federation.replication import XRegionReplicator
from kubetorch_tpu.train import checkpoint as jck
from kubetorch_tpu.utils.procs import free_port
from kubetorch_tpu_torch import federation as pfed
from kubetorch_tpu_torch import telemetry as ptel
from kubetorch_tpu_torch.data_store import commands as ds
from kubetorch_tpu_torch.data_store import ring as pring
from kubetorch_tpu_torch.federation import replication as prep
from kubetorch_tpu_torch.federation import topology as ptopo
from kubetorch_tpu_torch.train import checkpoint as ck
from tests.assets.store_fleet import ThreadedStoreFleet
from tests.assets.threaded_server import ThreadedAiohttpServer

pytestmark = pytest.mark.level("unit")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("KT_FED_STORES", "KT_FED_REGIONS", "KT_FED_SELF_REGION",
                "KT_REGION", "KT_STORE_NODES", "KT_DATA_STORE_URL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("KT_STORE_RETRY_MAX_S", "0.05")
    jring.reset_rings()
    pring.reset_rings()
    yield
    jring.reset_rings()
    pring.reset_rings()


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {f"w{i}": rng.standard_normal(32).astype(np.float32)
                       for i in range(4)}}


def _spec(fleet) -> str:
    return ",".join(fleet.urls)


def test_checkpoint_fallback_read_after_region_death(tmp_path, monkeypatch):
    _swept_checkpoint_restores_after_region_death(tmp_path, monkeypatch,
                                                  XRegionReplicator)


def test_port_replicator_then_region_death(tmp_path, monkeypatch):
    _swept_checkpoint_restores_after_region_death(tmp_path, monkeypatch,
                                                  pfed.XRegionReplicator)


def _swept_checkpoint_restores_after_region_death(tmp_path, monkeypatch, rep):
    east = ThreadedStoreFleet(tmp_path / "east", n=2)
    with east, ThreadedStoreFleet(tmp_path / "west", n=2) as west:
        ckpt = ck.Checkpointer("ckpt/fedjob",
                               store=ds.HttpStore(_spec(east)))
        tree = _tree(seed=11)
        ckpt.save(tree, 7)
        want_fp = ck.tree_fingerprint(tree)
        assert jck.tree_fingerprint(tree) == want_fp
        rep(_spec(east), {"west": _spec(west)}).sweep()
        monkeypatch.setenv(
            "KT_FED_STORES",
            f"east={'|'.join(east.urls)},west={'|'.join(west.urls)}")
        for i in range(east.n):
            east.stop_node(i)                  # region A dies wholesale
        pring.reset_rings()
        dead = ds.HttpStore(_spec(east))
        info, origin = ck.commit_info_ex("ckpt/fedjob", store=dead)
        assert info == {"step": 7, "slot": 0}
        assert origin == _spec(west)
        restored = ck.Checkpointer("ckpt/fedjob", store=dead).restore()
        assert restored is not None
        got, step = restored
        assert step == 7
        assert ck.tree_fingerprint(got) == want_fp


def test_unfederated_dead_store_still_raises(tmp_path):
    east = ThreadedStoreFleet(tmp_path / "east", n=1)
    with east:
        ds.put_json("ckpt/solo/__kt_commit__", {"step": 1, "slot": 0},
                    store_url=_spec(east))
        assert ck.commit_info("ckpt/solo", store=ds.HttpStore(east.urls[0])) \
            == {"step": 1, "slot": 0}
    pring.reset_rings()
    with pytest.raises(OSError):
        ck.commit_info("ckpt/solo", store=ds.HttpStore(east.urls[0]))


def test_ring_failover_and_quorum_marker(tmp_path, monkeypatch):
    with ThreadedStoreFleet(tmp_path / "ring", n=2) as fleet:
        for k, v in fleet.client_env().items():
            monkeypatch.setenv(k, v)
        store = ds.HttpStore(fleet.urls[0])
        tree = _tree(seed=3)
        ckpt = ck.Checkpointer("ckpt/ring", store=store)
        ckpt.save(tree, 1)
        ckpt.save(_tree(seed=4), 2)
        # the JAX client reads what the port wrote, at quorum
        assert jck.commit_info("ckpt/ring", store_url=fleet.urls[0]) == {
            "step": 2, "slot": 1}
        fleet.stop_node(0)
        pring.reset_rings()
        assert ck.commit_info("ckpt/ring", store=ds.HttpStore(fleet.urls[1])) \
            == {"step": 2, "slot": 1}
        got, step = ck.Checkpointer("ckpt/ring",
                                    store=ds.HttpStore(fleet.urls[1])).restore()
        assert step == 2
        assert ck.tree_fingerprint(got) == ck.tree_fingerprint(_tree(seed=4))


def test_topology_parsing_equals_jax(monkeypatch):
    monkeypatch.setenv("KT_FED_STORES",
                       "iowa=http://s1|http://s2/, oregon=http://s3,bad")
    monkeypatch.setenv("KT_FED_SELF_REGION", "iowa")
    for fn in ("fed_stores", "fed_regions", "self_region", "federated"):
        assert getattr(ptopo, fn)() == getattr(jtopo, fn)()
    for exclude in (None, "oregon", "http://s3", "http://s1,http://s2"):
        assert ptopo.fallback_store_specs(exclude) == \
            jtopo.fallback_store_specs(exclude)
    assert ptopo.store_spec("iowa") == jtopo.store_spec("iowa")


# ---------------------------------------------------------------------------
# the push side: XRegionReplicator, twins of tests/test_federation.py:397-456
# ---------------------------------------------------------------------------


def test_key_tier_ordering():
    keys = ["ckpt/job/slot-0/layers/w0", "ckpt/job/slot-0.__kt_index__",
            "ckpt/job/__kt_commit__", "__kt_commit__", "a/b__kt_commit__",
            "x.__kt_index__/w", "rollout/m", ""]
    assert [prep._key_tier(k) for k in keys] == \
        [jrep._key_tier(k) for k in keys]
    assert prep._key_tier("ckpt/job/slot-0/layers/w0") == 0
    assert prep._key_tier("ckpt/job/slot-0.__kt_index__") == 1
    assert prep._key_tier("ckpt/job/__kt_commit__") == 2


def test_xregion_sweep_replicates_and_converges(tmp_path):
    with ThreadedStoreFleet(tmp_path / "east", n=2) as east, \
            ThreadedStoreFleet(tmp_path / "west", n=2) as west:
        tree = _tree(seed=3)
        ds.put("ckpt/fedjob/slot-0", tree, store_url=_spec(east))
        ds.put_json("ckpt/fedjob/__kt_commit__", {"step": 4, "slot": 0},
                    store_url=_spec(east))
        rep = pfed.XRegionReplicator(_spec(east), {"west": _spec(west)})
        report = rep.sweep()
        assert report["targets"]["west"]["pushed"] >= 5  # leaves+index+marker
        assert report["targets"]["west"]["failed"] == 0
        assert rep.lag_s["west"] == 0.0
        got = ds.get("ckpt/fedjob/slot-0", store_url=_spec(west))
        assert ck.tree_fingerprint(got) == ck.tree_fingerprint(tree)
        assert ds.get_json("ckpt/fedjob/__kt_commit__",
                           store_url=_spec(west)) == {"step": 4, "slot": 0}
        report2 = rep.sweep()                      # converged: moves nothing
        assert report2["targets"]["west"]["pushed"] == 0
        assert report2["targets"]["west"]["lag_s"] == 0.0
        assert rep.status() == {"source": _spec(east),
                                "targets": {"west": {"lag_s": 0.0}}}


def test_xregion_sweep_never_rolls_back_newer_target(tmp_path):
    with ThreadedStoreFleet(tmp_path / "east", n=1) as east, \
            ThreadedStoreFleet(tmp_path / "west", n=1) as west:
        ds.put_json("ckpt/fedjob/__kt_commit__", {"step": 5, "slot": 1},
                    store_url=_spec(east))
        time.sleep(0.05)   # the target's copy is strictly newer
        ds.put_json("ckpt/fedjob/__kt_commit__", {"step": 9, "slot": 1},
                    store_url=_spec(west))
        report = pfed.XRegionReplicator(_spec(east),
                                        {"west": _spec(west)}).sweep()
        assert report["targets"]["west"] == {"pushed": 0, "skipped": 1,
                                             "failed": 0, "lag_s": 0.0}
        assert ds.get_json("ckpt/fedjob/__kt_commit__",
                           store_url=_spec(west)) == {"step": 9, "slot": 1}


def test_stored_at_travels_unchanged(tmp_path):
    with ThreadedStoreFleet(tmp_path / "east", n=1) as east, \
            ThreadedStoreFleet(tmp_path / "west", n=1) as west:
        ds.put_json("j/__kt_commit__", {"step": 1, "slot": 0},
                    store_url=_spec(east))
        time.sleep(0.05)
        pfed.XRegionReplicator(_spec(east), {"west": _spec(west)}).sweep()
        head = prep.XRegionReplicator._head_meta
        src, dst = head(_spec(east), "j/__kt_commit__"), \
            head(_spec(west), "j/__kt_commit__")
        assert dst["stored_at"] == src["stored_at"]
        assert dst["blake2b"] == src["blake2b"]


def test_target_down_shows_as_bounded_lag_not_crash(tmp_path):
    """The twin of JAX's partition case: the port's client has no
    ``KT_CHAOS`` partition verb, so the target region's store is stopped
    and then served again on the same port and disk."""
    port = free_port()
    west_url = f"http://127.0.0.1:{port}"
    west_root = str(tmp_path / "west")
    with ThreadedStoreFleet(tmp_path / "east", n=1) as east:
        ds.put_json("ckpt/j/__kt_commit__", {"step": 1, "slot": 0},
                    store_url=_spec(east))
        rep = pfed.XRegionReplicator(_spec(east), {"west": west_url})
        report = rep.sweep()       # nothing listens: lag, no raise
        assert report["targets"]["west"]["failed"] == 1
        assert report["targets"]["west"]["pushed"] == 0
        assert rep.lag_s["west"] > 0.0
        lag = ptel.xregion_metrics()["lag"]
        assert lag.value(region="west") == rep.lag_s["west"]
        assert ptel.xregion_metrics()["pending"].value(region="west") == 1.0
        with ThreadedAiohttpServer(lambda: create_store_app(west_root),
                                   port=port):
            pring.reset_rings()
            report2 = rep.sweep()
            assert report2["targets"]["west"]["pushed"] == 1
            assert rep.lag_s["west"] == 0.0
            assert lag.value(region="west") == 0.0
            assert ds.get_json("ckpt/j/__kt_commit__",
                               store_url=west_url) == {"step": 1, "slot": 0}


def test_background_pump_sweeps_until_stopped(tmp_path):
    with ThreadedStoreFleet(tmp_path / "east", n=1) as east, \
            ThreadedStoreFleet(tmp_path / "west", n=1) as west:
        ds.put_json("p/__kt_commit__", {"step": 2, "slot": 0},
                    store_url=_spec(east))
        rep = pfed.XRegionReplicator(_spec(east), {"west": _spec(west)},
                                     interval_s=0.05)
        assert rep.start() is rep.start()
        deadline = time.monotonic() + 10
        while ds.get_json("p/__kt_commit__", store_url=_spec(west)) is None:
            assert time.monotonic() < deadline, "the pump never swept"
            time.sleep(0.05)
        rep.stop()
        assert rep._thread is None


def _two_sweeps(rep_cls, east, west, prefixes=()):
    rep = rep_cls(_spec(east), {"west": _spec(west)}, prefixes=prefixes)
    return [rep.sweep() for _ in range(2)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replicators_move_each_others_checkpoints(tmp_path, writer):
    """A checkpoint one package wrote (plus a key outside the prefix)
    through each package's replicator into its own target region: equal
    reports, both converged, and the other package restores it."""
    with ThreadedStoreFleet(tmp_path / "east", n=2) as east, \
            ThreadedStoreFleet(tmp_path / "wj", n=2) as west_j, \
            ThreadedStoreFleet(tmp_path / "wp", n=2) as west_p:
        tree = _tree(seed=21)
        if writer == "jax":
            c = jck.Checkpointer("ckpt/x", store_url=_spec(east))
            c.save(tree, 3)
            c.save(_tree(seed=22), 4)
            jds.put_json("other/meta", {"v": 1}, store_url=_spec(east))
        else:
            c = ck.Checkpointer("ckpt/x", store=ds.HttpStore(_spec(east)))
            c.save(tree, 3)
            c.save(_tree(seed=22), 4)
            ds.put_json("other/meta", {"v": 1}, store_url=_spec(east))
        for prefixes in ((), ("ckpt/",)):
            reports = {"jax": _two_sweeps(XRegionReplicator, east, west_j,
                                          prefixes),
                       "port": _two_sweeps(pfed.XRegionReplicator, east,
                                           west_p, prefixes)}
            assert reports["port"] == reports["jax"]
        first, second = reports["port"]
        assert first["targets"]["west"]["failed"] == 0
        assert second["targets"]["west"]["pushed"] == 0
        for west in (west_j, west_p):
            assert ds.get_json("other/meta", store_url=_spec(west)) == {"v": 1}
        # each region restores with the package that did not write it
        if writer == "jax":
            got, step = ck.Checkpointer(
                "ckpt/x", store=ds.HttpStore(_spec(west_p))).restore()
        else:
            got, step = jck.Checkpointer("ckpt/x",
                                         store_url=_spec(west_j)).restore()
        assert step == 4
        assert ck.tree_fingerprint(got) == ck.tree_fingerprint(_tree(seed=22))


def test_metrics_read_under_jax_names(tmp_path):
    with ThreadedStoreFleet(tmp_path / "east", n=1) as east, \
            ThreadedStoreFleet(tmp_path / "west", n=1) as west:
        ds.put_json("m/__kt_commit__", {"step": 1, "slot": 0},
                    store_url=_spec(east))
        before = ptel.xregion_metrics()["pushed"].value(region="metrics")
        pfed.XRegionReplicator(_spec(east), {"metrics": _spec(west)}).sweep()
    names = {m.name: m for m in ptel.xregion_metrics().values()}
    jax_names = ("kt_store_xregion_lag_seconds",
                 "kt_store_xregion_pending_keys",
                 "kt_store_xregion_pushed_total",
                 "kt_store_xregion_errors_total")
    assert set(names) == set(jax_names)
    for name in jax_names:
        jm = jtel.REGISTRY._metrics[name]
        assert (names[name].kind, tuple(names[name].labelnames)) == \
            (jm.kind, tuple(jm.labelnames))
    assert names["kt_store_xregion_pushed_total"].value(
        region="metrics") == before + 1
    lines = "\n".join(names["kt_store_xregion_lag_seconds"].render())
    assert 'kt_store_xregion_lag_seconds{region="metrics"} 0' in lines
