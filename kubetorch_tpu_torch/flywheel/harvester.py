"""Harvest and vacate: the port's copy of
``kubetorch_tpu/flywheel/harvester.py``, continuous training on the
capacity serving leaves idle.

The flywheel trainer is a batch-tier workload (:func:`harvest_record`:
``priority="batch"``, preemptible), so any serving or training deploy
preempts it, and preemption arrives as the drain contract: SIGTERM flips
:func:`~kubetorch_tpu_torch.serving.elastic.drain_requested`, the loop
flushes a committed checkpoint inside ``drain_grace_s`` and returns. A
cycle cut mid-step resumes at the last committed step.

:class:`HarvestPolicy` decides: harvest while the serving queue wait
leaves the SLO its headroom, vacate the moment it does not.
:class:`Harvester` is the loop (poll, train, commit), timed into
``kt_flywheel_harvest_seconds{phase=harvest|vacate|idle}``.

Settings, as the port has no layered config: each argument, else the
environment variable JAX's config reads for it (``KT_SERVE_SLO_MS``,
``KT_HARVEST_HEADROOM``, ``KT_SCHED_DRAIN_GRACE_S``), else JAX's default
(no SLO, 0.25, 20 s).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from .. import telemetry
from ..serving import elastic
from .ledger import env_float

HARVEST = "harvest"
VACATE = "vacate"
IDLE = "idle"

SLO_ENV = "KT_SERVE_SLO_MS"
HEADROOM_ENV = "KT_HARVEST_HEADROOM"


def harvest_record(service: str, *, width: int = 1,
                   device_class: str = "cpu") -> Dict[str, Any]:
    """The scheduler submission record of a flywheel harvester: batch
    priority and preemptible, so it never outranks serving and is
    reclaimed first, through the drain window the vacate honours."""
    return {
        "name": f"flywheel-{service}",
        "device_class": device_class,
        "replicas": width,
        "scheduling": {"priority": "batch",
                       "preemptible": True},
    }


@dataclass
class HarvestPolicy:
    """Harvest/vacate verdicts from the scraped serving queue wait.

    ``headroom`` is the fraction of the queue-wait SLO that must stay free
    to harvest: with ``slo_ms=100`` and ``headroom=0.25`` harvesting goes
    on while the wait is at most 75 ms. With no SLO, harvest only while
    the wait is at most ``min_headroom_ms``."""

    slo_ms: float = 0.0                  # 0: KT_SERVE_SLO_MS, else none
    headroom: float = -1.0               # < 0: KT_HARVEST_HEADROOM, or 0.25
    min_headroom_ms: float = 1.0

    def __post_init__(self):
        if self.headroom < 0:
            self.headroom = max(0.0, min(1.0,
                                         env_float(HEADROOM_ENV, 0.25)))
        if self.slo_ms <= 0:
            self.slo_ms = max(0.0, env_float(SLO_ENV, 0.0))

    def decide(self, queue_wait_ms: float,
               harvesting: bool = False) -> str:
        """One scrape -> HARVEST, VACATE or IDLE. VACATE only while
        harvesting; an idle harvester under pressure stays idle."""
        if self.slo_ms <= 0:
            quiet = queue_wait_ms <= self.min_headroom_ms
            return HARVEST if quiet else (VACATE if harvesting else IDLE)
        limit = self.slo_ms * (1.0 - self.headroom)
        if queue_wait_ms <= limit:
            return HARVEST
        return VACATE if harvesting else IDLE


class Harvester:
    """The poll/train/commit loop over harvested capacity.

    ``scrape()`` returns the serving queue wait in ms; ``train_step()``
    polls the cursor itself, folds one batch and returns the new step
    (None when the ledger is drained); ``flush()`` blocks until the last
    step's checkpoint is committed. The loop polls
    :func:`elastic.drain_requested` every iteration and leaves through
    :meth:`vacate` when it flips or the policy calls time."""

    def __init__(self, policy: HarvestPolicy,
                 scrape: Callable[[], float],
                 train_step: Callable[[], Optional[int]],
                 flush: Callable[[], None],
                 drain_grace_s: Optional[float] = None,
                 idle_s: float = 0.2):
        self.policy = policy
        self.scrape = scrape
        self.train_step = train_step
        self.flush = flush
        if drain_grace_s is None:
            drain_grace_s = env_float(elastic.DRAIN_GRACE_ENV, 20.0)
        self.drain_grace_s = max(0.0, drain_grace_s)
        self.idle_s = idle_s
        self.harvested_steps = 0
        self.vacates = 0
        self.last_vacate_s: Optional[float] = None

    def vacate(self) -> float:
        """Give the capacity back: flush to a committed checkpoint, timed.
        It must land inside ``drain_grace_s``; past it the sender's
        SIGKILL wins and the cycle resumes from the previous commit."""
        m = telemetry.flywheel_metrics()
        t0 = time.monotonic()
        self.flush()
        took = time.monotonic() - t0
        m["harvest"].observe(took, phase=VACATE)
        self.vacates += 1
        self.last_vacate_s = took
        telemetry.add_event("flywheel.vacate", seconds=round(took, 4),
                            grace_s=self.drain_grace_s,
                            within_grace=took <= self.drain_grace_s)
        return took

    def run_cycle(self, max_steps: int = 0,
                  deadline_s: float = 0.0) -> Dict[str, Any]:
        """One harvest cycle: step while the policy allows and no drain is
        requested, then vacate. ``max_steps``/``deadline_s`` bound it (0:
        unbounded). Returns the cycle's summary."""
        m = telemetry.flywheel_metrics()
        steps = 0
        harvesting = False
        t_start = time.monotonic()
        reason = "policy"
        while True:
            if elastic.drain_requested():
                reason = "drain"
                break
            if max_steps and steps >= max_steps:
                reason = "max-steps"
                break
            if deadline_s and time.monotonic() - t_start >= deadline_s:
                reason = "deadline"
                break
            verdict = self.policy.decide(self.scrape(),
                                         harvesting=harvesting)
            if verdict == VACATE:
                reason = "policy"
                break
            if verdict == IDLE:
                harvesting = False
                t0 = time.monotonic()
                time.sleep(self.idle_s)
                m["harvest"].observe(time.monotonic() - t0, phase=IDLE)
                continue
            harvesting = True
            t0 = time.monotonic()
            stepped = self.train_step()
            m["harvest"].observe(time.monotonic() - t0, phase=HARVEST)
            if stepped is None:          # ledger drained
                reason = "drained"
                break
            steps += 1
            self.harvested_steps += 1
        vacate_s = self.vacate() if harvesting or steps else 0.0
        return {"steps": steps, "reason": reason,
                "vacate_s": round(vacate_s, 4),
                "within_grace": vacate_s <= self.drain_grace_s,
                "cycle_s": round(time.monotonic() - t_start, 4)}


__all__ = ["HarvestPolicy", "Harvester", "harvest_record",
           "HARVEST", "VACATE", "IDLE"]
