"""The port's warm template (``kubetorch_tpu_torch/serving/warm_template.py``),
its weight segments (``serving/shm_ring.py``) and kill plans (``chaos.py``)
against the JAX package's, on the CPU.

- Weight segments: the round trip of ``tests/test_cold_start.py``'s
  ``TestWeightSegment`` case for case, bf16 tensor leaves as their
  ``uint16`` bits; fp32, fp64 and integer segments attach across the
  packages both ways with the same manifest and bytes; a corrupt segment
  raises the typed error; unlinking by name is idempotent.
- Kill plans: ``TestTemplateChaosVerbs``' cases, and the port's parser
  against JAX's over specs that mix in every other verb and malformed
  tokens.
- The supervisor's spawn deadline, as ``TestSupervisorSpawnDeadline``.
- The fork drill of ``TestTemplateForkDrill`` with a tiny fp32 Llama:
  ``kill-joiner@0,kill-template:9@2`` converges with one respawn, and a
  clean burst of 2 lands; every replica's ``import`` phase is 0.0, its
  probe tokens equal an in-process engine's on the same weights, and no
  ``kt-shm-*`` segment outlives the supervisor.
"""

import glob
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from kubetorch_tpu import chaos as jax_chaos
from kubetorch_tpu.exceptions import DataCorruptionError as JaxCorruption
from kubetorch_tpu.serving import shm_ring as jax_shm
from kubetorch_tpu_torch import chaos
from kubetorch_tpu_torch.exceptions import DataCorruptionError
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
from kubetorch_tpu_torch.serve import GenerationEngine
from kubetorch_tpu_torch.serving import shm_ring
from kubetorch_tpu_torch.serving import warm_template as wt

pytestmark = pytest.mark.level("unit")

REPO = Path(__file__).resolve().parent.parent
ENGINE = {"slots": 2, "max_len": 64, "prefill_buckets": [8]}
PROBE = [1, 2, 3]


def _params():
    return {"wte": np.arange(12, dtype=np.float32).reshape(3, 4),
            "blocks": [{"w": np.ones((2, 2), np.float64)},
                       {"w": np.full((2, 2), 7, np.int32)}],
            "head": (np.zeros(5, np.float32),)}


def _leaks(seen):
    """Segments a supervisor's templates left: ``seen`` holds (template
    pid, segment name) pairs. A template names its segments
    ``kt-shm-<pid>-...``, so its pid finds any it staged, while tests of
    the JAX package running beside these stage under other pids."""
    return {p for pid, _ in seen for p in glob.glob(f"/dev/shm/kt-shm-{pid}-*")
            } | {n for _, n in seen if Path(f"/dev/shm/{n}").exists()}


def _note(sup, seen):
    seen.append((sup.proc.pid, sup.segment_name))


# ---------------------------------------------------------------------------
# weight segments
# ---------------------------------------------------------------------------


def test_roundtrip_preserves_structure_and_values():
    params = _params()
    params["bf16"] = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    seg = shm_ring.create_weight_segment(params, tag="t")
    try:
        assert seg.manifest["total_bytes"] > 0
        assert seg.name.startswith("kt-shm-")
        tree = shm_ring.attach_weight_segment(seg.manifest)
    finally:
        seg.close()
    assert isinstance(tree["blocks"], list)
    assert isinstance(tree["head"], tuple)
    np.testing.assert_array_equal(tree["wte"], params["wte"])
    np.testing.assert_array_equal(tree["blocks"][1]["w"],
                                  params["blocks"][1]["w"])
    assert tree["blocks"][0]["w"].dtype == np.float64
    # a bf16 tensor crosses as its bits, and lands back bitwise
    assert tree["bf16"].dtype == np.uint16
    back = wt.params_onto({"x": tree["bf16"]}, "cpu")["x"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16),
                       params["bf16"].view(torch.int16))
    # the attached tree owns its memory: the unlink above left it valid
    assert float(tree["head"][0].sum()) == 0.0


def test_owner_close_unlinks_segment():
    seg = shm_ring.create_weight_segment(_params(), tag="t")
    manifest = seg.manifest
    seg.close()
    with pytest.raises(FileNotFoundError):
        shm_ring.attach_weight_segment(manifest)


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_segments_attach_across_packages(creator):
    """fp32, fp64 and int leaves: the same manifest and bytes from either
    package, and each attaches the other's."""
    make, attach = ((jax_shm.create_weight_segment,
                     shm_ring.attach_weight_segment) if creator == "jax" else
                    (shm_ring.create_weight_segment,
                     jax_shm.attach_weight_segment))
    params = _params()
    seg = make(params, tag="x")
    try:
        tree = attach(seg.manifest)
        twin = (shm_ring if creator == "jax" else jax_shm
                ).create_weight_segment(params, tag="x")
        try:
            same = {k: v for k, v in twin.manifest.items() if k != "name"}
            assert same == {k: v for k, v in seg.manifest.items()
                            if k != "name"}
        finally:
            twin.close()
    finally:
        seg.close()
    for got, want in ((tree["wte"], params["wte"]),
                      (tree["blocks"][0]["w"], params["blocks"][0]["w"]),
                      (tree["blocks"][1]["w"], params["blocks"][1]["w"]),
                      (tree["head"][0], params["head"][0])):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_a_jax_bf16_segment_attaches_as_bits():
    x = np.array([1.5, -2.25, 3.0e-3], dtype=ml_dtypes.bfloat16)
    seg = jax_shm.create_weight_segment({"x": x}, tag="b")
    try:
        got = shm_ring.attach_weight_segment(seg.manifest)["x"]
    finally:
        seg.close()
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, x.view(np.uint16))


def test_corrupt_segment_raises_typed_never_wrong_weights():
    seg = shm_ring.create_weight_segment(_params(), tag="t")
    try:
        bad = dict(seg.manifest, blake2b="00" * 16)
        with pytest.raises(DataCorruptionError) as e:
            shm_ring.attach_weight_segment(bad)
        assert e.value.source == "shm"
        # JAX raises its own type on the same segment and manifest
        with pytest.raises(JaxCorruption):
            jax_shm.attach_weight_segment(bad)
        tree = shm_ring.attach_weight_segment(bad, verify=False)
        np.testing.assert_array_equal(tree["wte"], _params()["wte"])
    finally:
        seg.close()


def test_unlink_by_name_is_idempotent():
    seg = shm_ring.create_weight_segment(_params(), tag="t")
    name = seg.manifest["name"]
    seg.close(unlink=False)           # a SIGKILLed owner
    assert shm_ring.unlink_weight_segment(name) is True
    assert shm_ring.unlink_weight_segment(name) is False


# ---------------------------------------------------------------------------
# kill plans
# ---------------------------------------------------------------------------


def test_kill_plans_parse_signal_and_op_index():
    assert chaos.template_kill_plan("kill-template@0") == {0: 9}
    assert chaos.template_kill_plan("kill-template:15@2,kill-joiner@1") \
        == {2: 15}
    assert chaos.joiner_kill_plan("kill-joiner:TERM@1,kill-template@0") \
        == {1: 15}
    assert chaos.template_kill_plan("") == {}
    assert chaos.joiner_kill_plan("") == {}


def test_default_op_index_is_zero():
    assert chaos.template_kill_plan("kill-template") == {0: 9}


@pytest.mark.parametrize("spec", [
    "kill-template@0,delay:0.2,503:1@/x,kill-joiner:9@3*2",
    "term-rank:3@1,kill-joiner:INT@4,partition:50,kill-template@5",
    "kill-region:2@iowa,kill-joiner@0,shed:0.1,torn-write:64,kill-peer@2",
    "stall-stage:1.5@1,kill-flywheel@0,kill-stage:9@2,kill-template:HUP@1",
    "kill-template@x", "bogus,kill-template@1", "kill-template:NOPE@1",
    "kill-joiner%0.5@2", "drop-ack:1,kill-template@0", "delay,kill-joiner@1",
    "kill-joiner@1*x", "partition:200,kill-template@0"])
def test_kill_plans_and_parse_equal_jax(spec, capsys):
    """Every verb JAX's grammar knows parses alike (the same faults, or the
    same refusal), and both plans come out the same."""
    for mine, theirs in ((chaos.template_kill_plan,
                          jax_chaos.template_kill_plan),
                         (chaos.joiner_kill_plan,
                          jax_chaos.joiner_kill_plan)):
        assert mine(spec) == theirs(spec)

    def parsed(mod):
        try:
            return [f.__dict__ for f in mod.parse_spec(spec)]
        except mod.ChaosError as e:
            return str(e)

    assert parsed(chaos) == parsed(jax_chaos)
    capsys.readouterr()


def test_kill_plans_read_kt_chaos_and_its_rank_scope(monkeypatch):
    monkeypatch.setenv("KT_CHAOS", "kill-template@1,kill-joiner:15@0")
    monkeypatch.setenv("RANK", "0")
    assert chaos.template_kill_plan() == {1: 9}
    assert chaos.joiner_kill_plan() == {0: 15}
    monkeypatch.setenv("KT_CHAOS_RANK", "1")
    assert chaos.template_kill_plan() == {} == jax_chaos.template_kill_plan()


# ---------------------------------------------------------------------------
# the supervisor's spawn deadline
# ---------------------------------------------------------------------------


def _patch_template_cmd(monkeypatch, code):
    """Make TemplateSupervisor._spawn launch ``python -c code`` in place of
    the template module."""
    procs = []

    def fake_popen(cmd, **kw):
        p = subprocess.Popen([sys.executable, "-c", code],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True)
        procs.append(p)
        return p

    monkeypatch.setattr(wt, "subprocess", types.SimpleNamespace(
        Popen=fake_popen, PIPE=subprocess.PIPE, DEVNULL=subprocess.DEVNULL))
    return procs


def test_silent_wedged_template_times_out_and_is_killed(tmp_path,
                                                        monkeypatch):
    procs = _patch_template_cmd(monkeypatch, "import time; time.sleep(60)")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        wt.TemplateSupervisor({"weights": str(tmp_path / "w.npy"),
                               "result_dir": str(tmp_path)}, timeout=1.0)
    assert time.monotonic() - t0 < 10
    procs[0].wait(timeout=10)
    assert procs[0].poll() is not None, "wedged template leaked"


def test_dead_template_raises_promptly(tmp_path, monkeypatch):
    _patch_template_cmd(monkeypatch, "pass")
    with pytest.raises(RuntimeError, match="died before READY"):
        wt.TemplateSupervisor({"weights": str(tmp_path / "w.npy"),
                               "result_dir": str(tmp_path)}, timeout=30.0)


# ---------------------------------------------------------------------------
# the fork drill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="xla", remat=False)
    params = llama_init(cfg, seed=0, device="cpu")
    eng = GenerationEngine(params, cfg, device="cpu",
                           **dict(ENGINE, prefill_buckets=(8,)))
    want = eng.generate(list(PROBE), max_new_tokens=2)
    return params, want


def _spec(tmp_path, params, chaos_spec):
    wpath = tmp_path / "weights.npy"
    wt.save_weights(wpath, params)
    return {"weights": str(wpath), "model": {"kind": "llama-tiny"},
            "device": "cpu", "engine": ENGINE, "probe_prompt": PROBE,
            "probe_tokens": 2, "result_dir": str(tmp_path / "out"),
            "aot_root": str(tmp_path / "aot"), "chaos": chaos_spec}


def _wait_results(out_dir, names, timeout=120.0):
    deadline = time.monotonic() + timeout
    results = {}
    while time.monotonic() < deadline:
        for n in names:
            p = Path(out_dir) / f"{n}.json"
            if n not in results and p.exists():
                results[n] = json.loads(p.read_text())
        if len(results) == len(names):
            return results
        time.sleep(0.05)
    raise TimeoutError(f"missing results: {set(names) - set(results)}")


def _check_replica(rec, want):
    assert rec["ok"] is True, rec
    assert rec["phases"]["import"] == 0.0, "a forked replica re-paid import"
    assert rec["tokens"] == want
    # buckets 8 and max_len 64, and the decode block; no library on the CPU
    assert rec["aot"] == {"executables": 3}


def test_sigkill_template_and_joiner_converge_with_no_shm_leak(dense,
                                                               tmp_path):
    params, want = dense
    # joiner 0 dies mid-boot (weights attached, engine never up); the
    # re-fork of 0 is fork op 2, where the template itself is SIGKILLed:
    # the supervisor respawns it with the schedule consumed and still
    # lands both replicas
    spec = _spec(tmp_path, params, "kill-joiner@0,kill-template:9@2")
    seen = []
    with wt.TemplateSupervisor(spec, timeout=120.0, cwd=str(REPO)) as sup:
        _note(sup, seen)
        sup.fork(0)
        sup.fork(1)
        got = _wait_results(spec["result_dir"], ["replica_1"])
        _check_replica(got["replica_1"], want)
        assert not (Path(spec["result_dir"]) / "replica_0.json").exists()
        out = sup.fork(0)                 # kill-template fires here
        _note(sup, seen)
        assert out.get("ok") is True
        assert sup.respawns == 1, \
            "the SIGKILLed template was not respawned exactly once"
        got = _wait_results(spec["result_dir"], ["replica_0"])
        _check_replica(got["replica_0"], want)
    assert len({n for _, n in seen}) == 2
    assert _leaks(seen) == set(), "leaked /dev/shm segments"


def test_clean_burst_all_replicas_land(dense, tmp_path):
    params, want = dense
    spec = _spec(tmp_path, params, "")
    seen = []
    with wt.TemplateSupervisor(spec, timeout=120.0, cwd=str(REPO)) as sup:
        _note(sup, seen)
        for i in range(2):
            assert sup.fork(i).get("ok") is True
        got = _wait_results(spec["result_dir"], ["replica_0", "replica_1"])
        for rec in got.values():
            _check_replica(rec, want)
        assert sup.respawns == 0
    assert _leaks(seen) == set()
