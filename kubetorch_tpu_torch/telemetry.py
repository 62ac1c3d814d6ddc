"""Process-wide metrics, the counterpart of ``kubetorch_tpu/telemetry.py``.

What the port's engines and train step export, with the JAX package's
metric names and exposition text:

- a labelled counter (``inc``, ``value``, one line per label set) and
  ``counter()``; the rollout's ``kt_rollout_bytes_total{source}`` and
  ``kt_rollout_rollbacks_total{reason}``;
- a label-less gauge (``set``, ``value``, its own Prometheus lines) and
  ``gauge()``'s get-or-create registry; ``spec_metrics()``, the
  speculative engine's (``kt_spec_accept_rate``, ``kt_spec_draft_len``);
- a labelled histogram (``observe``, ``count``, cumulative ``_bucket``
  lines with ``le``, ``_sum``, ``_count``), ``histogram()``, ``timed()``
  (a block's wall-clock observed into a histogram) and ``train_metrics()``
  (``kt_train_step_seconds{phase}``, observed by ``make_train_step``, and
  the ``kt_train_mfu`` gauge).

The rest of the JAX module (tracing and its spans, labelled gauges, the
registry's exposition text) waits for the port's benchmark work.
"""

from __future__ import annotations

import threading
import time
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


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self) -> List[str]:
        return _header(self.name, self.help, self.kind) + [
            f"{self.name} {_format_value(self.value())}"]


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
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as {m.kind}")
        return m


def counter(name: str, help: str = "", labels=()) -> Counter:
    return _get_or_create(Counter, name, help, tuple(labels))


def gauge(name: str, help: str = "") -> Gauge:
    return _get_or_create(Gauge, name, help)


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
