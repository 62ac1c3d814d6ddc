"""Gated promotion: the port's copy of
``kubetorch_tpu/flywheel/promoter.py``, a trained delta reaches the live
fleet through one path, and a bad one never stays there.

    held-out eval gate -> publish (canary) -> bake -> verdict
        -> promote, or typed rollback

The **eval gate** runs before any manifest exists: ``eval_fn`` scores the
candidate on a held-out batch (a loss), and a score above the promoted
baseline's times ``1 + gate_tolerance`` stops it
(``kt_flywheel_gate_total{verdict="gate_rejected"}``). A candidate that
passes goes through the port's :class:`~kubetorch_tpu_torch.serve.rollout.
CanaryRollout` over :func:`~kubetorch_tpu_torch.train.checkpoint.
publish_rollout`: canary manifest, router slice, bake, then a fleet
manifest or a rollback manifest to the previous fingerprint. The baseline
moves only on a promotion. ``KT_FLYWHEEL_BREAK=promote-bad-delta`` blinds
the eval gate on purpose, so a drill can show the canary catching what
slips past it; it is read from the environment of the process only.

:func:`flywheel_status` is the loop's freshness snapshot and sets the
``kt_flywheel_lag_seconds{stage=collect|train|publish|promote}`` gauges.

Port idiom: the store is an argument (``store=``, required), and the gate
tolerance is the argument, else ``KT_FLYWHEEL_EVAL_GATE``, else 0.02. The
JAX package's ``kt flywheel status`` command stays the fabric's.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

from .. import telemetry
from ..data_store.commands import require_store
from ..serve import rollout as ro
from ..train import checkpoint as ck
from . import ledger as fl

BREAK_ENV = "KT_FLYWHEEL_BREAK"
BREAK_PROMOTE_BAD = "promote-bad-delta"
GATE_ENV = "KT_FLYWHEEL_EVAL_GATE"

GATE_REJECTED = "gate_rejected"
PROMOTED = "promoted"
ROLLED_BACK = "rolled_back"

LAG_STAGES = ("collect", "train", "publish", "promote")


def eval_baseline_key(service: str) -> str:
    return f"flywheel/{service}/eval-baseline"


class Promoter:
    """One service's publish -> bake -> promote path.

    ``eval_fn(tree) -> float`` scores a candidate on the held-out batch
    (lower is better). ``router`` is what the canary bake reads
    (``set_canary``, ``clear_canary``, ``canary_verdict``: the
    ``CanaryRollout`` contract). The canary knobs pass straight through."""

    def __init__(self, service: str, router: Any, *, store: Any = None,
                 eval_fn: Optional[Callable[[Any], float]] = None,
                 gate_tolerance: Optional[float] = None,
                 slice_fraction: float = 0.1, bake_s: float = 10.0,
                 min_requests: int = 20, ttft_factor: float = 2.0,
                 err_threshold: float = 0.05, poll_s: float = 0.25):
        self.service = service
        self.router = router
        self.store = require_store(store)
        self.eval_fn = eval_fn
        if gate_tolerance is None:
            gate_tolerance = fl.env_float(GATE_ENV, 0.02)
        self.gate_tolerance = max(0.0, gate_tolerance)
        self._canary_kw = dict(slice_fraction=slice_fraction,
                               bake_s=bake_s, min_requests=min_requests,
                               ttft_factor=ttft_factor,
                               err_threshold=err_threshold, poll_s=poll_s)
        self._candidate_loss: Optional[float] = None
        self.history: List[Dict[str, Any]] = []

    # -- the eval gate -------------------------------------------------------

    def _gate(self, tree: Any, step: int) -> Optional[Dict[str, Any]]:
        """Score the candidate: a dict (the regression) stops the
        promotion before any manifest exists; None passes."""
        if self.eval_fn is None:
            return None
        if os.environ.get(BREAK_ENV, "") == BREAK_PROMOTE_BAD:
            telemetry.add_event("flywheel.gate_bypassed",
                                service=self.service, step=step)
            return None
        loss = float(self.eval_fn(tree))
        base = self.store.get_json(eval_baseline_key(self.service),
                                   quorum=True, default=None)
        if base is not None:
            limit = float(base["loss"]) * (1.0 + self.gate_tolerance)
            if loss > limit:
                return {"loss": loss, "baseline": float(base["loss"]),
                        "limit": limit}
        self._candidate_loss = loss
        return None

    def _commit_baseline(self, step: int) -> None:
        loss = self._candidate_loss
        if loss is None:
            return
        self.store.put_json(eval_baseline_key(self.service),
                            {"loss": float(loss), "step": int(step),
                             "at": time.time()})
        self._candidate_loss = None

    # -- the one promotion path ----------------------------------------------

    def promote(self, tree: Any, step: int,
                canary_replica: str = "canary") -> str:
        """Drive one delta through the whole gate; returns the verdict
        (``promoted``, ``rolled_back`` or ``gate_rejected``), counted into
        ``kt_flywheel_gate_total``. The fleet's version is never left
        half new: unchanged, promoted, or restored by the rollback
        manifest."""
        m = telemetry.flywheel_metrics()
        self._candidate_loss = None
        t0 = time.monotonic()
        rejected = self._gate(tree, step)
        if rejected is not None:
            m["gate"].inc(verdict=GATE_REJECTED)
            telemetry.add_event("flywheel.gate_rejected",
                                service=self.service, step=step,
                                **{k: round(v, 6)
                                   for k, v in rejected.items()})
            self.history.append({"verdict": GATE_REJECTED, "step": step,
                                 **rejected, "at": time.time()})
            return GATE_REJECTED

        def publish(phase: str, canary: Optional[str] = None) -> Dict:
            out = ck.publish_rollout(self.service, tree, step,
                                     store=self.store, phase=phase,
                                     canary=canary)
            return out["manifest"]

        verdict = ro.CanaryRollout(
            self.service, self.router, store=self.store,
            **self._canary_kw).run(publish, canary_replica)
        m["gate"].inc(verdict=verdict)
        if verdict == PROMOTED:
            self._commit_baseline(step)
        m["lag"].set(0.0, stage="promote" if verdict == PROMOTED
                     else "publish")
        telemetry.add_event("flywheel.promotion", service=self.service,
                            step=step, verdict=verdict,
                            seconds=round(time.monotonic() - t0, 4))
        self.history.append({"verdict": verdict, "step": step,
                             "at": time.time()})
        return verdict


def flywheel_status(service: str, replicas: List[str],
                    store: Any = None) -> Dict[str, Any]:
    """One snapshot of the loop's freshness; also sets the
    ``kt_flywheel_lag_seconds`` gauges:

    - ``collect``: age of the newest acked ledger append;
    - ``train``: age of the newest committed cursor state;
    - ``publish``: age of the newest rollout manifest (any phase);
    - ``promote``: age of the newest fleet-phase manifest.
    """
    store = require_store(store)
    now = time.time()
    m = telemetry.flywheel_metrics()
    out: Dict[str, Any] = {"service": service, "replicas": {},
                           "lag_seconds": {}}
    newest_append: Optional[float] = None
    for replica in replicas:
        head = store.get_json(fl.head_key(service, replica), quorum=True,
                              default=None)
        out["replicas"][replica] = head
        if head and head.get("at"):
            at = float(head["at"])
            newest_append = max(newest_append or at, at)
    cursor = store.get_json(fl.cursor_last_key(service), quorum=True,
                            default=None)
    out["cursor"] = cursor
    out["lease"] = store.get_json(fl.cursor_lease_key(service), quorum=True,
                                  default=None)
    manifest = ro.read_manifest(service, store=store)
    out["manifest"] = manifest
    out["eval_baseline"] = store.get_json(eval_baseline_key(service),
                                          quorum=True, default=None)
    published = (float(manifest["published_at"])
                 if manifest and manifest.get("published_at") else None)
    lags: Dict[str, Optional[float]] = {
        "collect": (now - newest_append) if newest_append else None,
        "train": (now - float(cursor["at"])) if cursor else None,
        "publish": (now - published) if published else None,
        # a rollback manifest is a publish, not a promotion: promote lag
        # ages until a fleet-phase manifest lands
        "promote": ((now - published) if published
                    and manifest.get("phase") == "fleet" else None),
    }
    for stage in LAG_STAGES:
        lag = lags.get(stage)
        out["lag_seconds"][stage] = (None if lag is None
                                     else round(lag, 3))
        if lag is not None:
            m["lag"].set(lag, stage=stage)
    return out


__all__ = ["Promoter", "flywheel_status", "eval_baseline_key",
           "BREAK_ENV", "BREAK_PROMOTE_BAD", "GATE_REJECTED", "PROMOTED",
           "ROLLED_BACK", "LAG_STAGES"]
