"""Pre-warmed template fork: replica boot without import or pickle, the
port of ``kubetorch_tpu/serving/warm_template.py``.

A cold serving replica pays four bills one after another: python import
(torch and the engine, seconds), weight load (a multi-GB read), the kernel
libraries (``nvcc`` at first use, tens of seconds) and the first token.
This module takes the first two to ~0 and hands the third to the compile
cache (``serve/aot_cache.py``):

- The **template** process imports torch and the engine, stages the
  model's weights into ONE shared-memory segment
  (``shm_ring.create_weight_segment``), binds a unix socket and waits. It
  never initialises CUDA and runs no torch op: a CUDA context does not
  survive ``fork()``, nor do torch's intra-op thread pools, so the
  template stays a python + numpy process (weights as numpy, bf16 as
  ``uint16`` bits) and each forked child brings CUDA up fresh. The
  library win comes from the on-disk compile cache, not an inherited
  context.
- A **fork request** makes the template ``os.fork()``; the child attaches
  the weight segment (one memcpy per leaf, no pickle), copies the leaves
  onto its device, builds the engine through the compile cache, generates
  a probe and writes its boot by phase to the result dir, then exits.
- The **supervisor** (the caller's side) spawns the template, requests forks,
  respawns the template if it dies (the ``kill-template`` chaos verb),
  re-forks children that die mid-boot (``kill-joiner``), and unlinks the
  weight segment by name on teardown: a SIGKILLed template runs no
  destructor, so crash cleanup is the supervisor's job and ``/dev/shm``
  never leaks across generations.

Chaos determinism (``chaos.py``): the TEMPLATE consumes both kill plans
(it is the sole forker). ``kill-template@N`` self-delivers at its N-th
fork op; ``kill-joiner@N`` is popped from the plan when fork index N is
first requested and the signal rides the fork into that child, so a
re-forked survivor with the same index lives and the drill converges.

The spec's ``device`` (default ``"cuda"``) is where each replica serves.
Model kinds: ``llama-tiny`` (fp32, plain attention) and ``llama3-1b``
(Llama-3.2-1B's shape, bf16).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from . import shm_ring

READY_PREFIX = "KT_TEMPLATE_READY "


# -- weights on disk (numpy only: the template runs no torch op) ------------

def save_weights(path: os.PathLike, params: Any) -> None:
    """Write a params tree as a numpy-pickled blob that a process loads
    without torch: tensor leaves through ``models.convert.leaf_to_numpy``
    (bf16 as ``uint16`` bits)."""
    def _np(o):
        if isinstance(o, dict):
            return {k: _np(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(_np(v) for v in o)
        if type(o).__module__.startswith("torch"):
            from ..models.convert import leaf_to_numpy
            return leaf_to_numpy(o)
        return np.asarray(o)

    np.save(os.fspath(path), np.array(_np(params), dtype=object),
            allow_pickle=True)


def load_weights(path: os.PathLike) -> Any:
    return np.load(os.fspath(path), allow_pickle=True).item()


def params_onto(tree: Any, device) -> Any:
    """A numpy weight tree as tensors on ``device``; a ``uint16`` leaf is a
    bf16 leaf's bits (no weight the port serves is held in ``uint16``)."""
    import torch

    if isinstance(tree, dict):
        return {k: params_onto(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_onto(v, device) for v in tree)
    a = np.ascontiguousarray(tree)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# -- model spec → config (built in the CHILD, after the fork) ---------------

def _build_cfg(model: Dict[str, Any]):
    """Config object from the spec's model dict: ``llama-tiny`` (fp32,
    plain attention, the tests' model) and ``llama3-1b`` (Llama-3.2-1B's
    shape at its published widths, bf16, the kernels' path on a card).
    Real deployments construct the engine directly and use only the cache
    and segment layers."""
    import torch

    from ..models.llama import LlamaConfig

    kind = model.get("kind", "llama-tiny")
    kwargs = dict(model.get("kwargs") or {})
    kwargs.setdefault("remat", False)
    if kind == "llama-tiny":
        kwargs.setdefault("attn_impl", "xla")
        return LlamaConfig.tiny(dtype=torch.float32, **kwargs)
    if kind == "llama3-1b":
        return LlamaConfig.llama3_1b(dtype=torch.bfloat16, **kwargs)
    raise ValueError(f"unknown template model kind {kind!r}")


# -- the forked replica (and the cold-boot A/B arm) -------------------------

def _kernel_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counts and ``nvcc`` runs in this
    process so far."""
    from ..ops import _build
    from ..ops.attention import flash_attention
    from ..ops.decode_attention import decode_attention, decode_attention_quant
    from ..ops.quant_matmul import q4_matmul

    return {"flash_fwd": flash_attention.launches,
            "decode_attention": decode_attention.launches,
            "decode_attention_quant": decode_attention_quant.launches,
            "q4_matmul": q4_matmul.launches,
            "nvcc_runs": _build.build.nvcc_runs}


def _boot_engine(spec: Dict, params_np, phases: Dict[str, float],
                 aot_root: Optional[str]):
    """Shared engine-boot tail: the host weights onto the device (the
    attach phase's second half), the engine through the compile cache,
    one probe request. Returns (engine, the boot's record: aot_stats,
    probe tokens, decode steps, kernel counts)."""
    import torch

    device = torch.device(spec.get("device", "cuda"))
    t = time.monotonic()
    params = params_onto(params_np, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["weight_attach"] = phases.get("weight_attach", 0.0) + (
        time.monotonic() - t)

    cache = None
    if aot_root:
        from ..serve.aot_cache import AOTCompileCache
        store_url = spec.get("aot_store_url")
        cache = AOTCompileCache(aot_root, store=bool(store_url),
                                store_url=store_url)
    t = time.monotonic()
    from ..serve.engine import GenerationEngine
    eng = GenerationEngine(params, _build_cfg(spec.get("model") or {}),
                           aot_cache=cache, device=device,
                           **(spec.get("engine") or {}))
    phases["compile_or_cache"] = time.monotonic() - t

    t = time.monotonic()
    probe = spec.get("probe_prompt") or [1, 2, 3]
    h = eng.submit(list(probe), max_new_tokens=int(
        spec.get("probe_tokens", 2)))
    while eng.step():
        pass
    tokens = h.result(timeout=0)
    phases["first_token"] = time.monotonic() - t
    return eng, {"aot": eng.aot_stats() if cache else {}, "tokens": tokens,
                 "decode_steps": eng.stats().decode_steps,
                 "counts": _kernel_counts()}


def _write_result(spec: Dict, name: str, payload: Dict) -> None:
    out = Path(spec["result_dir"])
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f".{name}.tmp"
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, out / f"{name}.json")


def _observe_phases(phases: Dict[str, float], total: float) -> None:
    from .. import telemetry
    fam = telemetry.cold_start_metrics()
    for phase, dt in phases.items():
        fam["phase_seconds"].observe(dt, phase=phase)
    fam["total"].set(total)
    fam["boot_ts"].set(time.time())


def _replica_main(spec: Dict, manifest: Dict, idx: int,
                  kill_sig: Optional[int]) -> None:
    """Runs in the forked child: attach → (chaos) → engine → probe →
    result file. Never returns (``os._exit``), so the child cannot fall
    back into the template's accept loop."""
    code = 0
    try:
        # the supervisor stops reading the template's stdout at READY: a
        # child's prints go to the template's log instead of filling a pipe
        os.dup2(2, 1)
        t_start = time.monotonic()
        phases: Dict[str, float] = {"import": 0.0}   # the template paid it
        t = time.monotonic()
        params_np = shm_ring.attach_weight_segment(manifest)
        phases["weight_attach"] = time.monotonic() - t
        if kill_sig is not None:
            # kill-joiner: die mid-boot, weights attached, not serving
            os.kill(os.getpid(), kill_sig)
        eng, rec = _boot_engine(spec, params_np, phases,
                                spec.get("aot_root"))
        total = time.monotonic() - t_start
        _observe_phases(phases, total)
        _write_result(spec, f"replica_{idx}",
                      {"idx": idx, "pid": os.getpid(), "mode": "fork",
                       "ok": True, "phases": phases, "total_s": total, **rec})
        eng.stop()
    except BaseException as e:  # noqa: BLE001 — the child reports, never raises
        code = 1
        try:
            _write_result(spec, f"replica_{idx}",
                          {"idx": idx, "pid": os.getpid(), "mode": "fork",
                           "ok": False, "error": f"{type(e).__name__}: {e}"})
        except Exception:  # noqa: BLE001
            pass
    finally:
        os._exit(code)


def cold_boot_main(spec_path: str, idx: int, import_t0: float) -> None:
    """The A/B baseline: a fresh interpreter that pays import, weight load
    and the libraries with no template (and, on a fresh pod, an empty
    cache). ``import_t0`` is the wall-clock the parent recorded at spawn;
    the import phase ends once torch and the engine are imported, the set
    the template imports before it forks."""
    import torch  # noqa: F401

    from ..serve import aot_cache, engine  # noqa: F401

    spec = json.loads(Path(spec_path).read_text())
    t_start = time.monotonic()
    phases: Dict[str, float] = {"import": max(0.0, time.time() - import_t0)}
    t = time.monotonic()
    params_np = load_weights(spec["weights"])
    phases["weight_fetch"] = time.monotonic() - t
    eng, rec = _boot_engine(spec, params_np, phases, spec.get("aot_root"))
    total = phases["import"] + (time.monotonic() - t_start)
    _observe_phases(phases, total)
    _write_result(spec, f"cold_{idx}",
                  {"idx": idx, "pid": os.getpid(), "mode": "cold",
                   "ok": True, "phases": phases, "total_s": total, **rec})
    eng.stop()


# -- the template process ---------------------------------------------------

def _assert_no_cuda(torch) -> None:
    assert not torch.cuda.is_initialized(), \
        "the template initialised CUDA: forked children would inherit a " \
        "context that does not survive fork()"


def template_main(spec_path: str) -> None:
    """The template's whole life: load weights (numpy), stage the shm
    segment, announce readiness on stdout, serve fork requests over the
    unix socket until ``shutdown``. No CUDA and no torch op, ever: see the
    module docstring."""
    spec = json.loads(Path(spec_path).read_text())
    chaos_spec = spec.get("chaos")            # None: read KT_CHAOS
    from ..chaos import joiner_kill_plan, template_kill_plan
    kill_plan = template_kill_plan(chaos_spec)
    joiner_plan = dict(joiner_kill_plan(chaos_spec))

    # Pre-pay the import bill for every future child: torch and the engine
    # are safe to import before a fork (no CUDA context, no thread pool
    # started; asserted here and before each fork) though not to run.
    import torch

    from ..serve import aot_cache, engine  # noqa: F401
    _assert_no_cuda(torch)

    params_np = load_weights(spec["weights"])
    seg = shm_ring.create_weight_segment(params_np, tag="template")
    del params_np
    sock_path = spec["socket"]
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(16)
    print(f"{READY_PREFIX}{json.dumps({'segment': seg.name})}", flush=True)

    fork_op = 0
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    req = json.loads(conn.makefile("r").readline() or "{}")
                except ValueError:
                    continue
                cmd = req.get("cmd")
                if cmd == "ping":
                    conn.sendall(b'{"ok": true}\n')
                elif cmd == "manifest":
                    conn.sendall((json.dumps(
                        {"ok": True, "manifest": seg.manifest}) + "\n")
                        .encode())
                elif cmd == "shutdown":
                    conn.sendall(b'{"ok": true}\n')
                    return
                elif cmd == "fork":
                    sig_no = kill_plan.get(fork_op)
                    fork_op += 1
                    if sig_no is not None:
                        # kill-template: die on the fork op, BEFORE the
                        # fork: the supervisor sees EOF and respawns
                        os.kill(os.getpid(), sig_no)
                    idx = int(req.get("idx", fork_op - 1))
                    child_sig = joiner_plan.pop(idx, None)
                    _assert_no_cuda(torch)
                    pid = os.fork()
                    if pid == 0:
                        try:
                            srv.close()
                        except Exception:  # noqa: BLE001
                            pass
                        _replica_main(spec, seg.manifest, idx, child_sig)
                        # unreachable: _replica_main os._exits
                    conn.sendall((json.dumps(
                        {"ok": True, "pid": pid, "idx": idx}) + "\n")
                        .encode())
                else:
                    conn.sendall(b'{"ok": false, "error": "bad cmd"}\n')
            # reap exited children so a long burst accumulates no zombies
            try:
                while os.waitpid(-1, os.WNOHANG)[0]:
                    pass
            except ChildProcessError:
                pass
    finally:
        seg.close()                           # owner: close AND unlink
        try:
            srv.close()
            os.unlink(sock_path)
        except Exception:  # noqa: BLE001
            pass


# -- the supervisor, on the caller's side ----------------------------------

class TemplateSupervisor:
    """Owns one template subprocess: spawn, fork-by-socket, respawn on
    death, crash-safe segment cleanup. A dead template (kill-template) is
    respawned with its chaos schedule consumed; a dead joiner
    (kill-joiner) is re-forked by the caller through :meth:`fork` with the
    same index. ``cwd`` is the template's working directory, where
    ``python -m`` finds the package (default: this process's); the
    template's stderr goes to a log in the supervisor's temp dir, whose
    tail a spawn failure quotes."""

    def __init__(self, spec: Dict, *, timeout: float = 120.0,
                 cwd: Optional[str] = None):
        self.spec = dict(spec)
        self.spec.setdefault("chaos", os.environ.get("KT_CHAOS") or None)
        self.timeout = timeout
        self.cwd = cwd
        self.proc: Optional[subprocess.Popen] = None
        self.segment_name: Optional[str] = None
        self.respawns = 0
        self._tmp = Path(tempfile.mkdtemp(prefix="kt-template-"))
        self.spec.setdefault("socket", str(self._tmp / "template.sock"))
        self._spawn()

    # -- lifecycle ----------------------------------------------------------

    def log_tail(self, n: int = 2000) -> str:
        try:
            return (self._tmp / f"template_{self.respawns}.log").read_text()[-n:]
        except OSError:
            return ""

    def _spawn(self) -> None:
        import select

        spec_file = self._tmp / f"spec_{self.respawns}.json"
        spec_file.write_text(json.dumps(self.spec))
        with open(self._tmp / f"template_{self.respawns}.log", "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "kubetorch_tpu_torch.serving.warm_template",
                 str(spec_file)],
                stdout=subprocess.PIPE, stderr=log, text=True, cwd=self.cwd)
        deadline = time.monotonic() + self.timeout
        # select() on the stdout fd so the deadline holds while nothing is
        # printed: a template that wedges before READY must time out and
        # die, not hang the supervisor on a blocking readline
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.proc.kill()
                try:
                    self.proc.wait(timeout=10)
                except Exception:  # noqa: BLE001
                    pass
                raise TimeoutError("template not READY in time")
            readable, _, _ = select.select([self.proc.stdout], [], [],
                                           min(remaining, 1.0))
            if not readable:
                if self.proc.poll() is not None:
                    raise RuntimeError(
                        f"template died before READY: {self.log_tail()}")
                continue
            # READY is one short flush()ed print, an atomic pipe write: a
            # readable fd means the whole line arrives without blocking
            line = self.proc.stdout.readline()
            if line.startswith(READY_PREFIX):
                self.segment_name = json.loads(
                    line[len(READY_PREFIX):])["segment"]
                break
            if not line:
                # EOF before READY: the template is dead
                try:
                    self.proc.wait(timeout=5)
                except Exception:  # noqa: BLE001
                    self.proc.kill()
                raise RuntimeError(
                    f"template died before READY: {self.log_tail()}")

    def _respawn(self) -> None:
        old = self.segment_name
        try:
            if self.proc is not None:
                self.proc.kill()
                self.proc.wait(timeout=10)
        except Exception:  # noqa: BLE001
            pass
        # the dead template ran no destructor: reclaim its segment by name
        # so the burst leaks nothing even under SIGKILL
        if old:
            shm_ring.unlink_weight_segment(old)
        self.respawns += 1
        # the schedule is consumed once per lineage: the respawned template
        # must not re-arm the verb that just killed it
        self.spec["chaos"] = ""
        self._spawn()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    # -- protocol -----------------------------------------------------------

    def _call(self, req: Dict, timeout: float = 30.0) -> Dict:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(timeout)
        try:
            c.connect(self.spec["socket"])
            c.sendall((json.dumps(req) + "\n").encode())
            line = c.makefile("r").readline()
            if not line:
                raise ConnectionError("template hung up")
            return json.loads(line)
        finally:
            c.close()

    def fork(self, idx: int) -> Dict:
        """Request fork ``idx``; if the template is dead (or dies on this
        very request: kill-template), respawn once and retry. Counted in
        ``kt_template_forks_total``."""
        from .. import telemetry
        forks = telemetry.cold_start_metrics()["forks"]
        try:
            out = self._call({"cmd": "fork", "idx": idx})
            forks.inc(outcome="ok" if out.get("ok") else "error")
            return out
        except (OSError, ValueError):
            forks.inc(outcome="template_dead")
            self._respawn()
            out = self._call({"cmd": "fork", "idx": idx})
            forks.inc(outcome="ok" if out.get("ok") else "error")
            return out

    def manifest(self) -> Dict:
        return self._call({"cmd": "manifest"})["manifest"]

    def shutdown(self) -> None:
        try:
            self._call({"cmd": "shutdown"}, timeout=10)
        except Exception:  # noqa: BLE001
            pass
        try:
            if self.proc is not None:
                self.proc.wait(timeout=10)
        except Exception:  # noqa: BLE001
            try:
                self.proc.kill()
            except Exception:  # noqa: BLE001
                pass
        if self.segment_name:
            # idempotent: a clean template already unlinked it
            shm_ring.unlink_weight_segment(self.segment_name)

    def __enter__(self) -> "TemplateSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def main(argv) -> None:
    if argv and argv[0] == "--cold":
        cold_boot_main(argv[1], int(argv[2]), float(argv[3]))
    else:
        template_main(argv[0])


if __name__ == "__main__":
    main(sys.argv[1:])
