"""Process-wide metrics, the counterpart of ``kubetorch_tpu/telemetry.py``.

Only what the speculative engine (``serve/spec_engine.py``) exports is
here: a label-less gauge (``set``, ``value``, its own Prometheus lines),
``gauge()``'s get-or-create registry and ``spec_metrics()``, with the JAX
package's metric names (``kt_spec_accept_rate``, ``kt_spec_draft_len``).
The rest of the JAX module (labels, counters, histograms, ``timed``, the
``mfu`` gauge, the registry's exposition text) waits for the port's
benchmark work.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


def _format_value(v: float) -> str:
    return str(int(v)) if v.is_integer() else repr(v)


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
        out = [f"# HELP {self.name} {self.help}"] if self.help else []
        out.append(f"# TYPE {self.name} {self.kind}")
        out.append(f"{self.name} {_format_value(self.value())}")
        return out


_REGISTRY: Dict[str, Gauge] = {}
_REGISTRY_LOCK = threading.Lock()


def gauge(name: str, help: str = "") -> Gauge:
    """Get-or-create: the first declaration of ``name`` wins."""
    with _REGISTRY_LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = Gauge(name, help)
        return m


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
