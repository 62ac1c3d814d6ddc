"""Process-wide metrics, the counterpart of ``kubetorch_tpu/telemetry.py``.

What the port's engines and train step export, with the JAX package's
metric names and exposition text:

- a labelled counter (``inc``, ``value``, one line per label set) and
  ``counter()``; the rollout's ``kt_rollout_bytes_total{source}`` and
  ``kt_rollout_rollbacks_total{reason}``;
- a gauge, label-less or labelled (``set``, ``value``, one line per label
  set) and ``gauge()``'s get-or-create registry; ``spec_metrics()``, the
  speculative engine's (``kt_spec_accept_rate``, ``kt_spec_draft_len``);
- a labelled histogram (``observe``, ``count``, cumulative ``_bucket``
  lines with ``le``, ``_sum``, ``_count``), ``histogram()``, ``timed()``
  (a block's wall-clock observed into a histogram) and ``train_metrics()``
  (``kt_train_step_seconds{phase}``, observed by ``make_train_step``, and
  the ``kt_train_mfu`` gauge), ``pipeline_metrics()`` (the elastic
  pipeline's ``kt_pipeline_*`` family) and ``cold_start_metrics()`` (a
  replica's boot by phase, ``kt_cold_start_*``, and the compile cache's
  ``kt_aot_cache_total{result}``), ``xregion_metrics()`` (the
  cross-region replicator's ``kt_store_xregion_*{region}``) and
  ``flywheel_metrics()`` (the continuous-learning loop's
  ``kt_flywheel_*``: appends, consumes and dedups by service, gate
  verdicts, harvest phases, per-stage lag).

And spans (``span``, ``current_span``, ``current_header``, ``add_event``,
the ``TraceRing`` ``RING``) with the JAX package's wire format: the
``X-KT-Trace`` header value ``<trace_id>-<span_id>``, which a rollout
manifest carries, so a span opened here parents onto a trace the JAX
package started and the reverse. ``KT_TRACE=0`` turns tracing off: ``span``
then returns one shared no-op span and allocates nothing.

The rest of the JAX module (the registry's exposition text, the
waterfall, span shipping between processes) waits for the port's
benchmark work.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union


def escape_label_value(value: Any) -> str:
    """Prometheus exposition label-value escaping: backslash, double-quote,
    and newline (the three the format defines)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _label_str(labelnames: Tuple[str, ...], labelvalues: Tuple[str, ...],
               extra: str = "") -> str:
    parts = [f'{k}="{escape_label_value(v)}"'
             for k, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _header(name: str, help: str, kind: str) -> List[str]:
    out = [f"# HELP {name} {help}"] if help else []
    out.append(f"# TYPE {name} {kind}")
    return out


def _label_key(name: str, labelnames: Tuple[str, ...],
               labels: Dict[str, Any]) -> Tuple[str, ...]:
    """A labelled metric's key for ``labels``, which must be exactly the
    declared names."""
    if set(labels) != set(labelnames):
        raise ValueError(f"{name}: got labels {sorted(labels)}, "
                         f"declared {sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        return _label_key(self.name, self.labelnames, labels)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = _header(self.name, self.help, self.kind)
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        for key, v in items:
            out.append(f"{self.name}{_label_str(self.labelnames, key)} "
                       f"{_format_value(v)}")
        return out


class Gauge(Counter):
    """A value that is set, not only added to; without labels it renders
    its one line even before it is first set."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


# Default latency buckets: sub-ms (header parse), request-scale, and the
# multi-second tail a first call or a multi-GB fetch produces.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], Dict[str, Any]] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        return _label_key(self.name, self.labelnames, labels)

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            entry = self._values.get(key)
            if entry is None:
                entry = self._values[key] = {
                    "buckets": [0] * len(self.buckets), "sum": 0.0,
                    "count": 0}
            for i, le in enumerate(self.buckets):
                if value <= le:
                    entry["buckets"][i] += 1
            entry["sum"] += value
            entry["count"] += 1

    def count(self, **labels: Any) -> int:
        with self._lock:
            entry = self._values.get(self._key(labels))
            return entry["count"] if entry else 0

    def render(self) -> List[str]:
        out = _header(self.name, self.help, self.kind)
        with self._lock:
            items = sorted((k, {"buckets": list(v["buckets"]),
                                "sum": v["sum"], "count": v["count"]})
                           for k, v in self._values.items())
        for key, entry in items:
            for le, n in zip(self.buckets, entry["buckets"]):
                lbl = _label_str(self.labelnames, key,
                                 extra=f'le="{_format_value(le)}"')
                out.append(f"{self.name}_bucket{lbl} {n}")
            lbl = _label_str(self.labelnames, key, extra='le="+Inf"')
            out.append(f"{self.name}_bucket{lbl} {entry['count']}")
            base = _label_str(self.labelnames, key)
            out.append(f"{self.name}_sum{base} "
                       f"{_format_value(entry['sum'])}")
            out.append(f"{self.name}_count{base} {entry['count']}")
        return out


_REGISTRY: Dict[str, Union[Counter, Gauge, Histogram]] = {}
_REGISTRY_LOCK = threading.Lock()


def _get_or_create(cls, name: str, *args, **kwargs):
    """The first declaration of ``name`` wins; another kind raises."""
    with _REGISTRY_LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = cls(name, *args, **kwargs)
        elif type(m) is not cls:
            raise ValueError(f"metric {name!r} already registered as {m.kind}")
        return m


def counter(name: str, help: str = "", labels=()) -> Counter:
    return _get_or_create(Counter, name, help, tuple(labels))


def gauge(name: str, help: str = "", labels=()) -> Gauge:
    return _get_or_create(Gauge, name, help, tuple(labels))


def histogram(name: str, help: str = "", labels=(),
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return _get_or_create(Histogram, name, help, tuple(labels),
                          buckets=buckets)


class _HistTimer:
    """``with timed(hist, phase="compute"):`` observes the block's
    wall-clock into ``hist``."""

    __slots__ = ("hist", "labels", "_t0")

    def __init__(self, hist: Histogram, labels: Dict[str, Any]):
        self.hist = hist
        self.labels = labels

    def __enter__(self) -> "_HistTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.hist.observe(time.perf_counter() - self._t0, **self.labels)


def timed(hist: Histogram, **labels: Any) -> _HistTimer:
    """Time a block into ``hist`` (no span)."""
    return _HistTimer(hist, labels)


_TRAIN_METRICS: Optional[Dict[str, Union[Gauge, Histogram]]] = None


def train_metrics() -> Dict[str, Union[Gauge, Histogram]]:
    """Get-or-create the step-time anatomy family:

    - ``kt_train_step_seconds{phase=...}``: where one training step's
      wall-clock goes. ``compute`` is the step call, observed by
      ``make_train_step`` from call to return; CUDA runs asynchronously,
      so that is the host's time to issue the step unless something in it
      waits for the device. ``grad_sync`` and ``snapshot_stall`` are the
      JAX package's other phases, observed by the loops that own them.
    - ``kt_train_mfu``: achieved model-FLOPs utilization, set by the loops
      that know the model's FLOPs per token.
    """
    global _TRAIN_METRICS
    if _TRAIN_METRICS is None:
        _TRAIN_METRICS = {
            "step_seconds": histogram(
                "kt_train_step_seconds",
                "Train-step wall-clock anatomy (phase: compute, grad_sync, "
                "snapshot_stall)",
                labels=("phase",)),
            "mfu": gauge(
                "kt_train_mfu",
                "Achieved model-FLOPs utilization of the training step"),
        }
    return _TRAIN_METRICS


_SPEC_METRICS: Optional[Dict[str, Gauge]] = None


def spec_metrics() -> Dict[str, Gauge]:
    """Get-or-create the gauges of the speculative engine's draft-length
    controller: the acceptance EWMA it steers by and the draft length it
    chose."""
    global _SPEC_METRICS
    if _SPEC_METRICS is None:
        _SPEC_METRICS = {
            "accept_rate": gauge(
                "kt_spec_accept_rate",
                "EWMA of the speculative-decode acceptance rate "
                "(accepted/proposed per round)"),
            "draft_len": gauge(
                "kt_spec_draft_len",
                "Current speculative draft length k (adaptive within "
                "KT_SPEC_K_MIN..KT_SPEC_K_MAX)"),
        }
    return _SPEC_METRICS


_PIPELINE_METRICS: Optional[Dict[str, Union[Counter, Gauge, Histogram]]] = None


def pipeline_metrics() -> Dict[str, Union[Counter, Gauge, Histogram]]:
    """Get-or-create the ``kt_pipeline_*`` family: elastic pipeline-parallel
    health. ``parallel/pipeline_elastic.py`` (the only stage-membership
    site) sets the gauges and counts re-groups and stale-epoch refusals;
    ``regroup_seconds`` is for the loop that owns a re-group's stall."""
    global _PIPELINE_METRICS
    if _PIPELINE_METRICS is None:
        _PIPELINE_METRICS = {
            "regroups": counter(
                "kt_pipeline_regroups_total",
                "Pipeline stage re-groups by watchdog-classified cause "
                "(Crashed, Killed, OOMKilled, Preempted, Evicted, Slow)",
                labels=("cause",)),
            "stale": counter(
                "kt_pipeline_stale_epoch_total",
                "Zombie-stage confirms/publishes refused with "
                "StaleStageEpochError",),
            "epoch": gauge(
                "kt_pipeline_stage_epoch",
                "Current stage-membership epoch (bumped on every re-group)"),
            "stages": gauge(
                "kt_pipeline_stages",
                "Live pipeline stages in the current membership"),
            "bubble": gauge(
                "kt_pipeline_bubble_fraction",
                "Pipeline bubble fraction of the current schedule, "
                "slowdown-adjusted for nonuniform stage widths"),
            "regroup_seconds": histogram(
                "kt_pipeline_regroup_seconds",
                "Stage loss detected -> first post-re-group step committed",
                buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120)),
        }
    return _PIPELINE_METRICS


# A replica's boot by phase: ``import`` (python and module import),
# ``weight_fetch`` (weights read or pulled), ``weight_attach`` (the shared
# segment attached and the leaves copied onto the device),
# ``compile_or_cache`` (the kernel libraries resolved through the compile
# cache, building on a miss, and the warm passes), ``engine_init`` and
# ``first_token`` (submit to the probe's first token).
COLD_START_PHASES = ("import", "weight_fetch", "weight_attach",
                     "compile_or_cache", "engine_init", "first_token")

_COLD_START_METRICS: Optional[Dict[str, Union[Counter, Gauge, Histogram]]] = None


def cold_start_metrics() -> Dict[str, Union[Counter, Gauge, Histogram]]:
    """Get-or-create the replica cold-start family under the JAX package's
    names: the boot's phases (``kt_cold_start_seconds{phase}``, phases in
    :data:`COLD_START_PHASES`), the last full boot and when it ended (the
    gauges the controller's fast-scale gate reads), the compile cache's
    lookups by result, the template's forks by outcome and the router's
    readiness-fence decisions."""
    global _COLD_START_METRICS
    if _COLD_START_METRICS is None:
        _COLD_START_METRICS = {
            "phase_seconds": histogram(
                "kt_cold_start_seconds",
                "Replica cold-start anatomy by phase (import, weight_fetch, "
                "weight_attach, compile_or_cache, engine_init, first_token)",
                labels=("phase",)),
            "total": gauge(
                "kt_cold_start_total_seconds",
                "Wall-clock of this replica's last full cold start "
                "(0 until one has been measured)"),
            "boot_ts": gauge(
                "kt_cold_start_timestamp_seconds",
                "Unix time this replica last completed a measured cold "
                "start"),
            "aot": counter(
                "kt_aot_cache_total",
                "AOT compile-cache lookups by result (hit, miss, "
                "incompatible, corrupt, publish, store_hit, "
                "store_publish, store_corrupt)",
                labels=("result",)),
            "forks": counter(
                "kt_template_forks_total",
                "Template-process fork requests by outcome (ok, error, "
                "template_dead)",
                labels=("outcome",)),
            "fence": counter(
                "kt_serve_readiness_fence_total",
                "Router readiness-fence decisions for still-warming "
                "replicas (admitted, blocked, expired, departed)",
                labels=("result",)),
        }
    return _COLD_START_METRICS


_XREGION_METRICS: Optional[Dict[str, Union[Counter, Gauge]]] = None


def xregion_metrics() -> Dict[str, Union[Counter, Gauge]]:
    """Get-or-create the cross-region replicator's family under the JAX
    package's names, each by target ``region``: the age of the oldest
    commit a region still lacks, the keys pending for it, keys pushed and
    failed pushes (``federation/replication.py:XRegionReplicator``)."""
    global _XREGION_METRICS
    if _XREGION_METRICS is None:
        _XREGION_METRICS = {
            "lag": gauge(
                "kt_store_xregion_lag_seconds",
                "Age of the oldest local commit not yet replicated to the "
                "region", labels=("region",)),
            "pending": gauge(
                "kt_store_xregion_pending_keys",
                "Keys awaiting cross-region replication to the region",
                labels=("region",)),
            "pushed": counter(
                "kt_store_xregion_pushed_total",
                "Keys replicated cross-region, by target region",
                labels=("region",)),
            "errors": counter(
                "kt_store_xregion_errors_total",
                "Cross-region replication attempts that failed (partition, "
                "node loss)", labels=("region",)),
        }
    return _XREGION_METRICS


_FLYWHEEL_METRICS: Optional[Dict[str, Union[Counter, Gauge, Histogram]]] = None


def flywheel_metrics() -> Dict[str, Union[Counter, Gauge, Histogram]]:
    """Get-or-create the ``kt_flywheel_*`` family under the JAX package's
    names and help texts: ``flywheel/ledger.py`` counts appends, consumes
    and dedups, the harvester times its phases, and the promoter counts
    gate verdicts and sets each stage's lag."""
    global _FLYWHEEL_METRICS
    if _FLYWHEEL_METRICS is None:
        _FLYWHEEL_METRICS = {
            "appended": counter(
                "kt_flywheel_appended_total",
                "Feedback records durably acked into the ledger "
                "(counted only after the segment's quorum write)",
                labels=("service",)),
            "consumed": counter(
                "kt_flywheel_consumed_total",
                "Fresh feedback records handed to the trainer by the "
                "cursor (post-dedup)",
                labels=("service",)),
            "deduped": counter(
                "kt_flywheel_deduped_total",
                "Duplicate records dropped by the cursor's hash dedup "
                "(at-least-once retries, re-polled segments)",
                labels=("service",)),
            "gate": counter(
                "kt_flywheel_gate_total",
                "Promotion-gate verdicts (promoted, rolled_back, "
                "gate_rejected)",
                labels=("verdict",)),
            "harvest": histogram(
                "kt_flywheel_harvest_seconds",
                "Harvester wall-clock by phase (harvest = one training "
                "step on harvested capacity, vacate = flush-and-yield, "
                "idle = waiting for SLO headroom)",
                labels=("phase",),
                buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2.5, 5,
                         10, 30)),
            "lag": gauge(
                "kt_flywheel_lag_seconds",
                "Freshness of each flywheel stage (collect = newest "
                "acked append, train = newest committed cursor state, "
                "publish = newest rollout manifest, promote = newest "
                "fleet-phase promotion)",
                labels=("stage",)),
        }
    return _FLYWHEEL_METRICS


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

TRACE_HEADER = "X-KT-Trace"
TRACE_ENV = "KT_TRACE"
RING_ENV = "KT_TRACE_RING"

_FALSY = ("0", "false", "off", "no", "")


def enabled() -> bool:
    """Tracing switch: ``KT_TRACE``, default on, read per call."""
    raw = os.environ.get(TRACE_ENV)
    if raw is None:
        return True
    return raw.strip().lower() not in _FALSY


class TraceContext:
    """A remote parent: what crossed the wire in ``X-KT-Trace``."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


def parse_trace(value: Optional[str]) -> Optional[TraceContext]:
    """``"<trace_id>-<span_id>"`` → :class:`TraceContext`; None on absent or
    malformed input (a bad header must never fail a request)."""
    if not value:
        return None
    trace_id, sep, span_id = value.partition("-")
    if not sep or not trace_id or not span_id:
        return None
    return TraceContext(trace_id.strip(), span_id.strip())


class Span:
    """One timed operation. Entering binds it as the current span; exiting
    records the end time (and ``status="error"`` on an exception) and puts
    it into :data:`RING`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end",
                 "status", "attrs", "events", "_token")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.time()
        self.end: Optional[float] = None
        self.status = "ok"
        self.attrs = attrs
        self.events: List[Tuple[float, str, Dict[str, Any]]] = []
        self._token = None

    def __bool__(self) -> bool:
        return True

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append((time.time(), name, attrs))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end if self.end is not None else time.time(),
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": [{"ts": ts, "name": n, "attrs": a}
                       for ts, n, a in self.events],
        }

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end = time.time()
        if exc is not None:
            self.status = "error"
            self.attrs.setdefault("error", type(exc).__name__)
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        RING.add(self.to_dict())


class _NoopSpan:
    """The shared do-nothing span of the tracing-off path."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def to_dict(self) -> None:
        return None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NOOP_SPAN = _NoopSpan()

_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "kt_current_span", default=None)


def _new_id(nbytes: int) -> str:
    return uuid.uuid4().hex[: nbytes * 2]


def span(name: str, parent: Optional[TraceContext] = None, **attrs: Any):
    """Open a span. ``parent`` (a remote :class:`TraceContext`) continues a
    wire-propagated trace; otherwise the current span in this context is
    the parent; otherwise this is a new root. :data:`NOOP_SPAN` when
    tracing is off."""
    if not enabled():
        return NOOP_SPAN
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        cur = _current.get()
        if cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
        else:
            trace_id, parent_id = _new_id(8), None
    return Span(name, trace_id, _new_id(4), parent_id, attrs)


def current_span() -> Optional[Span]:
    return _current.get()


def current_header() -> Optional[str]:
    """The active context's wire value, or None (tracing off, no span)."""
    cur = _current.get()
    if cur is None or not enabled():
        return None
    return f"{cur.trace_id}-{cur.span_id}"


def add_event(name: str, **attrs: Any) -> None:
    """Record an event on the active span; nothing without one."""
    cur = _current.get()
    if cur is not None:
        cur.add_event(name, **attrs)


class TraceRing:
    """Bounded store of finished spans, newest last, keyed by
    ``(trace_id, span_id)`` so a re-added span replaces itself. Capacity
    from ``KT_TRACE_RING`` (default 2048); the oldest go first."""

    def __init__(self):
        self._spans: "OrderedDict[Tuple[str, str], Dict]" = OrderedDict()
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        try:
            return max(16, int(os.environ.get(RING_ENV, "2048")))
        except ValueError:
            return 2048

    def add(self, span_dict: Optional[Dict]) -> bool:
        """Upsert; True when this span was not in the ring yet."""
        if not span_dict:
            return False
        key = (span_dict.get("trace_id", ""), span_dict.get("span_id", ""))
        with self._lock:
            fresh = key not in self._spans
            self._spans[key] = span_dict
            self._spans.move_to_end(key)
            cap = self.capacity
            while len(self._spans) > cap:
                self._spans.popitem(last=False)
        return fresh

    def find(self, query: str) -> List[Dict]:
        """Spans whose ``trace_id``, or ``request_id`` attr, equals
        ``query`` (the whole trace of a matched request), oldest first."""
        with self._lock:
            spans = list(self._spans.values())
        trace_ids = {s["trace_id"] for s in spans
                     if s["trace_id"] == query
                     or s.get("attrs", {}).get("request_id") == query}
        return sorted((s for s in spans if s["trace_id"] in trace_ids),
                      key=lambda s: s.get("start", 0.0))


RING = TraceRing()
