"""The port's checkpoints (``kubetorch_tpu_torch/train/checkpoint.py``)
against the JAX package's, on a real store server, on the CPU.

- ``Checkpointer``'s commit-marker cases of ``tests/test_elastic.py``:
  commit, restore and the delta skip; a torn async upload never commits
  and resume falls back; a torn marker PUT leaves the earlier commit.
- The train-state layout is JAX's: the optimizer's leaf-path keys equal
  JAX's; a JAX ``save_state`` restores into the port's ``TrainState``
  (equal, bit for bit, to ``train_state_from_numpy`` of the same state)
  and a port ``save_state`` into JAX's. One more step on each side then
  agrees within the train tests' tolerances (``tests/test_torch_train.py``:
  losses and grad norms 1e-5 relative, params 5e-6 absolute).
- A port run resumed from a checkpoint equals the uninterrupted run bit
  for bit, and an async snapshot followed at once by an in-place
  (``donate=True``) step holds the bytes of the step it saved.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.data_store import commands as ds
from kubetorch_tpu.train import checkpoint as jck
from kubetorch_tpu.train import train_step as jax_ts
from kubetorch_tpu_torch import telemetry as pt_tel
from kubetorch_tpu_torch.data_store import commands as pds
from kubetorch_tpu_torch.models import llama as pt_llama
from kubetorch_tpu_torch.models.convert import train_state_from_numpy
from kubetorch_tpu_torch.train import checkpoint as ck
from kubetorch_tpu_torch.train import train_step as pt_ts

from .test_torch_rollout import store, store_url  # noqa: F401 (fixtures)
from .test_torch_train import (CHUNK, TOL_STEP_PARAM, _assert_metrics_close,
                               _optimizers, _run_jax, _run_port,
                               assert_leaves_abs, batch, np_params, pcfg,
                               pt_tree)

pytestmark = pytest.mark.level("unit")


def _tensor_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 8, generator=g),
            "h": torch.randn(4, 4, generator=g).bfloat16(),
            "frozen": torch.ones(4, dtype=torch.int8)}


def _equal_trees(a, b):
    fa, fb = {}, {}
    pds._flatten(a, "", fa)
    pds._flatten(b, "", fb)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = (pds.host_leaf(v) for v in (fa[k], fb[k]))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# the commit-marker protocol (tests/test_elastic.py's cases)
# ---------------------------------------------------------------------------


def test_checkpointer_commit_restore_and_delta(store):
    c = ck.Checkpointer("job/a", store=store)
    assert c.committed() is None and c.restore() is None
    tree = {"w": np.arange(8.0), "frozen": np.ones(4)}
    c.save(tree, 1)
    tree["w"] = tree["w"] + 1
    c.save(tree, 2)
    restored, step = c.restore()
    assert step == 2 and (restored["w"] == np.arange(8.0) + 1).all()
    # ping-pong slot 0 again: the unchanged leaf moves zero bytes
    stats = c.save(tree, 3)
    assert stats["skipped"] >= 1
    # a fresh process (respawned rank) sees the same committed state
    c2 = ck.Checkpointer("job/a", store=store)
    assert c2.last_committed_step == 3


def test_torn_async_upload_never_commits_and_falls_back(store, monkeypatch):
    """A rank dies while an async upload is in flight: the torn slot is
    never marked committed, and resume falls back to the previous
    committed checkpoint."""
    c = ck.Checkpointer("job/torn", store=store)
    good = {"w": np.arange(16.0)}
    c.save(good, 5)
    orig = ds._kv_put
    state = {"puts": 0}

    def dying_mid_upload(url, key, data, meta, sess=None):
        state["puts"] += 1
        if state["puts"] >= 2:
            raise jck.DataStoreError("membership change: rank died")
        return orig(url, key, data, meta, sess)

    monkeypatch.setattr(ds, "_kv_put", dying_mid_upload)
    fut = c.maybe_save({"w": torch.zeros(16, dtype=torch.float64)}, 6)
    assert fut is not None
    with pytest.raises(jck.DataStoreError):
        c.flush()
    monkeypatch.setattr(ds, "_kv_put", orig)
    assert ck.commit_info("job/torn", store=store)["step"] == 5
    restored, step = ck.Checkpointer("job/torn", store=store).restore()
    assert step == 5 and (restored["w"] == good["w"]).all()


def test_torn_marker_put_leaves_the_earlier_commit(store):
    c = ck.Checkpointer("job/marker", store=store)
    c.save(_tensor_tree(0), 1)

    class MarkerDies:
        def __getattr__(self, name):
            return getattr(store, name)

        def put_json(self, key, obj):
            raise OSError("store lost mid-commit")

    c.store = MarkerDies()
    with pytest.raises(OSError):
        c.save(_tensor_tree(1), 2)
    assert ck.commit_info("job/marker", store=store) == {"step": 1, "slot": 0}
    restored, step = ck.Checkpointer("job/marker", store=store).restore()
    assert step == 1
    _equal_trees(restored, ck._host_tree(_tensor_tree(0)))


def test_second_save_of_the_same_state_moves_no_bytes(store):
    c = ck.Checkpointer("job/delta", store=store)
    tree = _tensor_tree(2)
    first = c.save(tree, 1)
    c.save(tree, 1)                 # slot 1: every leaf new there
    again = c.save(tree, 1)         # slot 0 again: all held already
    assert first["bytes"] > 0
    assert again["skipped"] == again["leaves"] == 3 and again["bytes"] == 0


def test_commit_info_raises_when_the_store_fails():
    class Dead:
        def get_json(self, key, quorum=False, default=None):
            raise ConnectionError("store down")

    with pytest.raises(ConnectionError):
        ck.commit_info("job/x", store=Dead())


@pytest.mark.parametrize("call", [
    lambda: ck.save_state("k", None),
    lambda: ck.async_save_state("k", None),
    lambda: ck.restore_state("k", None),
    lambda: ck.commit_info("k"),
    lambda: ck.Checkpointer("k"),
])
def test_store_is_required(call):
    with pytest.raises(TypeError, match="store is required"):
        call()


def test_checkpoint_seconds_and_snapshot_stall_are_observed(store):
    hist = pt_tel.histogram("kt_checkpoint_seconds", labels=("op",))
    step_hist = pt_tel.train_metrics()["step_seconds"]
    n = (hist.count(op="save"), hist.count(op="restore"),
         step_hist.count(phase="snapshot_stall"))
    c = ck.Checkpointer("job/obs", store=store)
    c.maybe_save(_tensor_tree(3), 1)
    c.flush()
    c.restore()
    assert (hist.count(op="save"), hist.count(op="restore"),
            step_hist.count(phase="snapshot_stall")) == (n[0] + 1, n[1] + 1,
                                                          n[2] + 1)


# ---------------------------------------------------------------------------
# the train state across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["default", "adamw"])
def test_opt_state_path_keys_equal_jax(which):
    tree = np_params(1)
    j_opt, p_opt = _optimizers(which)
    j_state = jax_ts.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, tree), j_opt)
    p_state = pt_ts.init_train_state(pt_tree(tree), p_opt)
    want = jck._jsonable_opt(j_state.opt_state)
    got = ck._jsonable_opt(p_state.opt_state)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


def test_jax_save_state_restores_into_the_port(store):
    """Two JAX steps, saved by JAX; the port restores them, equal bit for
    bit to ``train_state_from_numpy`` of the same state (and of the same
    fingerprint), and one more step on each side agrees."""
    tree = np_params(9)
    tokens, targets = batch(seed=9)
    j_opt, p_opt = _optimizers("default")
    j_state, _ = _run_jax(tree, j_opt, 2, tokens, targets)
    jck.save_state("job/jax", j_state, store_url=store.url)
    like = pt_ts.init_train_state(pt_tree(tree), p_opt)
    got = ck.restore_state("job/jax", like, store=store, device="cpu")
    want = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_state), device="cpu")
    _equal_trees(ck.train_state_tree(got), ck.train_state_tree(want))
    assert ck.tree_fingerprint(ck.train_state_tree(got)) == \
        jck.tree_fingerprint({"params": j_state.params,
                              "opt_state": jck._jsonable_opt(j_state.opt_state),
                              "step": j_state.step})
    j_state, j_ms = _run_jax(None, j_opt, 1, tokens, targets, state=j_state)
    p_state, p_ms = _run_port(None, p_opt, 1, tokens, targets, state=got)
    _assert_metrics_close(p_ms, j_ms)
    assert_leaves_abs(p_state.params, j_state.params, TOL_STEP_PARAM)


def test_port_save_state_restores_into_jax(store):
    tree = np_params(10)
    tokens, targets = batch(seed=10)
    j_opt, p_opt = _optimizers("default")
    p_state, _ = _run_port(pt_tree(tree), p_opt, 2, tokens, targets)
    ck.save_state("job/port", p_state, store=store)
    j_like = jax_ts.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, tree), j_opt)
    j_state = jck.restore_state("job/port", j_like, store_url=store.url)
    j_state = jax.tree_util.tree_map(jnp.asarray, j_state)
    assert int(j_state.step) == 2 and int(j_state.opt_state[1][0].count) == 2
    assert_leaves_abs(p_state.params, j_state.params, 0.0)
    j_state, j_ms = _run_jax(None, j_opt, 1, tokens, targets, state=j_state)
    p_state, p_ms = _run_port(None, p_opt, 1, tokens, targets, state=p_state)
    _assert_metrics_close(p_ms, j_ms)
    assert_leaves_abs(p_state.params, j_state.params, TOL_STEP_PARAM)


def _port_step(opt):
    cfg = pcfg()
    return pt_ts.make_train_step(
        lambda p, t, y: pt_llama.llama_loss_chunked(p, t, y, cfg, chunk=CHUNK),
        optimizer=opt)


@pytest.mark.parametrize("inline", ["", "1"])
def test_resumed_run_equals_the_uninterrupted_run_bitwise(store, monkeypatch,
                                                          inline):
    """Step 1, an async checkpoint, steps 2-3; then a fresh state restored
    from the checkpoint and steps 2-3 again: the same bits, and the async
    snapshot held step 1's bytes although step 2 updated the state in
    place right after it was taken (gathered on the IO thread, and with
    ``KT_CKPT_INLINE_GATHER=1`` before ``maybe_save`` returns)."""
    monkeypatch.setenv("KT_CKPT_INLINE_GATHER", inline)
    tree = np_params(12)
    tokens, targets = (torch.from_numpy(x) for x in batch(seed=12))
    b = {"tokens": tokens, "targets": targets}
    _, p_opt = _optimizers("default")
    step = _port_step(p_opt)
    state, _ = step(pt_ts.init_train_state(pt_tree(tree), p_opt), b)
    want_fp = ck.tree_fingerprint(ck.train_state_tree(state))
    c = ck.Checkpointer("job/resume", store=store)
    assert c.maybe_save(ck.train_state_tree(state), 1) is not None
    losses = []
    for _ in range(2):                 # donate=True: in place, at once
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert c.flush() == 1
    restored, at = c.restore()
    assert at == 1 and ck.tree_fingerprint(restored) == want_fp
    like = pt_ts.init_train_state(pt_tree(tree), p_opt)
    resumed = ck.train_state_from_tree(restored, like, device="cpu")
    again = []
    for _ in range(2):
        resumed, m = step(resumed, b)
        again.append(float(m["loss"]))
    assert again == losses
    _equal_trees(ck.train_state_tree(resumed), ck.train_state_tree(state))


def test_train_state_from_tree_refuses_a_mismatched_leaf(store):
    tree = np_params(13)
    _, p_opt = _optimizers("adamw")
    state = pt_ts.init_train_state(pt_tree(tree), p_opt)
    saved = ck._host_tree(ck.train_state_tree(state))
    saved["params"]["embed"] = saved["params"]["embed"][:, :4]
    with pytest.raises(ValueError, match="does not fit"):
        ck.train_state_from_tree(saved, state, device="cpu")
    del saved["opt_state"]["0/mu/embed"]
    with pytest.raises(ValueError, match="opt_state has"):
        ck.train_state_from_tree(saved, state, device="cpu")


def test_bf16_state_round_trips_through_the_store(store):
    tree = np_params(14)
    _, p_opt = _optimizers("default")
    params = {k: v for k, v in pt_tree(tree).items()}
    params["embed"] = params["embed"].bfloat16()
    state = pt_ts.init_train_state(params, p_opt)
    ck.save_state("job/bf16", state, store=store)
    back = ck.restore_state("job/bf16", state, store=store, device="cpu")
    assert back.params["embed"].dtype == torch.bfloat16
    _equal_trees(ck.train_state_tree(back), ck.train_state_tree(state))


def test_local_save_and_restore(tmp_path):
    tree = np_params(15)
    tokens, targets = batch(seed=15)
    _, p_opt = _optimizers("default")
    state, _ = _run_port(pt_tree(tree), p_opt, 1, tokens, targets)
    path = str(tmp_path / "ckpt.pt")
    ck.local_save(path, state)
    like = pt_ts.init_train_state(pt_tree(np_params(16)), p_opt)
    back = ck.local_restore(path, like, device="cpu")
    _equal_trees(ck.train_state_tree(back), ck.train_state_tree(state))
