"""The process kill plans, the port's copy of ``template_kill_plan``,
``joiner_kill_plan`` and ``flywheel_kill_plan`` in
``kubetorch_tpu/chaos.py``.

A ``KT_CHAOS`` spec is a comma-separated list of tokens
``VERB[:ARG][@SUFFIX][%PROB][*COUNT]``. The parser below is the JAX
package's, token for token: every verb it knows parses (so a spec that
also schedules HTTP or store faults gives the same plans), a malformed
spec is reported and yields no plan, and for the op-index verbs the
``@``-suffix is a 0-based op index (default 0). The port consumes three
verbs, each process-fatal:

- ``kill-template[:SIG]@N``: the template self-delivers SIG (default 9)
  at its N-th fork request, before forking;
- ``kill-joiner[:SIG]@N``: forked replica N self-delivers SIG mid-boot,
  after attaching the weights and before serving;
- ``kill-flywheel[:SIG]@N``: a flywheel trainer self-delivers SIG before
  its N-th ledger poll (:func:`flywheel_kill_plan`). Only the trainer loop
  reads this plan; no middleware does.

With no spec given, ``KT_CHAOS`` is read, and ``KT_CHAOS_RANK`` scopes the
plans to one ``RANK`` as in JAX. The HTTP middleware, the store verbs
(``drop-ack`` among them: the store server stays the fabric's) and the
soak schedule stay in the JAX package.
"""

from __future__ import annotations

import os
import signal as signal_mod
from dataclasses import dataclass
from typing import Dict, List, Optional

CHAOS_ENV = "KT_CHAOS"
CHAOS_RANK_ENV = "KT_CHAOS_RANK"

# the JAX registry's verb names, in its order (the parser's error message
# lists them)
_KINDS = ("delay", "status", "reset", "truncate", "oom", "evict", "preempt",
          "shed", "disk-full", "pass", "corrupt-blob", "torn-write",
          "kill-rank", "term-rank", "shm-corrupt", "kill-store-node",
          "kill-peer", "kill-template", "kill-joiner", "kill-stage",
          "stall-stage", "kill-flywheel", "drop-ack", "kill-region",
          "partition")

# verbs whose @-suffix is a 0-based op index rather than a path prefix
_OP_INDEX_KINDS = ("kill-rank", "term-rank", "shm-corrupt", "kill-store-node",
                   "kill-peer", "drop-ack", "kill-template", "kill-joiner",
                   "kill-stage", "stall-stage", "kill-flywheel")
# verbs whose @-suffix names a region (their op index rides :ARG)
_REGION_KINDS = ("kill-region",)
# verbs whose :ARG is a signal (default SIGKILL)
_SIGNAL_KINDS = ("kill-rank", "kill-store-node", "kill-peer", "kill-template",
                 "kill-joiner", "kill-stage", "kill-flywheel")


@dataclass
class Fault:
    kind: str
    seconds: float = 0.0               # delay, stall-stage
    status: int = 503                  # status faults
    retry_after: Optional[float] = None
    path: Optional[str] = None         # path-prefix filter
    prob: Optional[float] = None       # None: deterministic schedule token
    signal_no: int = 9                 # the signal a kill verb delivers
    op_index: int = 0                  # 0-based op index of the op verbs
    torn_bytes: int = 4096             # torn-write
    grace_s: float = 5.0               # term-rank
    region: Optional[str] = None       # kill-region
    pct: float = 1.0                   # partition


class ChaosError(ValueError):
    """Malformed ``KT_CHAOS`` spec."""


def parse_spec(spec: str) -> List[Fault]:
    faults: List[Fault] = []
    for raw in spec.split(","):
        token = raw.strip()
        if not token:
            continue
        count = 1
        if "*" in token:
            token, _, n = token.rpartition("*")
            try:
                count = int(n)
            except ValueError:
                raise ChaosError(f"bad repeat count in {raw!r}")
        prob = None
        if "%" in token:
            token, _, p = token.partition("%")
            try:
                prob = float(p)
            except ValueError:
                raise ChaosError(f"bad probability in {raw!r}")
        path = None
        if "@" in token:
            token, _, path = token.partition("@")
        fault = _parse_one(token.strip(), raw)
        if fault.kind in _OP_INDEX_KINDS:
            try:
                fault.op_index = int(path) if path else 0
            except ValueError:
                raise ChaosError(f"bad op index in {raw!r}")
        elif fault.kind in _REGION_KINDS:
            fault.region = (path or "").strip() or None
        else:
            fault.path = path or None
        fault.prob = prob
        faults.extend([Fault(**fault.__dict__) for _ in range(count)])
    return faults


def _parse_signal(arg: str, raw: str) -> int:
    name = arg.strip().upper()
    if name.isdigit():
        return int(name)
    if name and not name.startswith("SIG"):
        name = "SIG" + name
    sig = getattr(signal_mod, name, None)
    if sig is None:
        raise ChaosError(f"unknown signal in {raw!r}")
    return int(sig)


def _float_arg(arg: str, raw: str, what: str) -> float:
    try:
        return float(arg)
    except ValueError:
        raise ChaosError(f"bad {what} in {raw!r}")


def _parse_one(token: str, raw: str) -> Fault:
    head, _, arg = token.partition(":")
    if head in _SIGNAL_KINDS:
        return Fault(kind=head, signal_no=_parse_signal(arg or "9", raw))
    if head == "drop-ack":
        if arg:
            raise ChaosError(
                f"drop-ack takes no :ARG in {raw!r} (the @-suffix is "
                f"the mutating-op index)")
        return Fault(kind="drop-ack")
    if head == "stall-stage":
        if not arg:
            raise ChaosError(f"stall-stage needs SECONDS in {raw!r}")
        return Fault(kind="stall-stage",
                     seconds=_float_arg(arg, raw, "stall-stage seconds"))
    if head == "term-rank":
        fault = Fault(kind="term-rank")
        if arg:
            fault.grace_s = max(0.0, _float_arg(arg, raw, "grace window"))
        return fault
    if head == "delay":
        return Fault(kind="delay", seconds=_float_arg(arg, raw, "delay"))
    if head == "torn-write":
        fault = Fault(kind="torn-write")
        if arg:
            try:
                fault.torn_bytes = max(0, int(arg))
            except ValueError:
                raise ChaosError(f"bad torn-write byte count in {raw!r}")
        return fault
    if head == "kill-region":
        fault = Fault(kind="kill-region", signal_no=9)
        if arg:
            try:
                fault.op_index = max(0, int(arg))
            except ValueError:
                raise ChaosError(f"bad kill-region op index in {raw!r}")
        return fault
    if head == "partition":
        fault = Fault(kind="partition")
        if arg:
            fault.pct = _float_arg(arg, raw, "partition fraction")
            if fault.pct > 1.0:       # "partition:50" reads as 50%
                fault.pct = fault.pct / 100.0
            if not 0.0 <= fault.pct <= 1.0:
                raise ChaosError(f"bad partition fraction in {raw!r}")
        return fault
    if head in ("disk-full", "corrupt-blob", "shm-corrupt"):
        return Fault(kind=head)
    if head.isdigit():
        fault = Fault(kind="status", status=int(head))
        if arg:
            fault.retry_after = _float_arg(arg, raw, "Retry-After")
        return fault
    if head == "shed":
        fault = Fault(kind="shed")
        if arg:
            fault.retry_after = _float_arg(arg, raw, "shed Retry-After")
        return fault
    if head in ("reset", "truncate", "oom", "evict", "preempt", "pass"):
        return Fault(kind=head)
    raise ChaosError(f"unknown chaos fault {raw!r} "
                     f"(kinds: {', '.join(_KINDS)})")


def _rank_in_scope() -> bool:
    """``KT_CHAOS_RANK`` narrows the process verbs to one global rank.
    Unset: every rank is in scope."""
    want = os.environ.get(CHAOS_RANK_ENV)
    if not want:
        return True
    return os.environ.get("RANK", "0") == want.strip()


def _rank_faults(kind: str, spec: Optional[str]) -> List[Fault]:
    """The faults of one process-level verb. A malformed spec is reported,
    not raised: dying at spawn over a typo would read as the very crash
    loop this machinery exists to diagnose."""
    raw = spec if spec is not None else os.environ.get(CHAOS_ENV, "")
    if kind not in (raw or ""):
        return []
    if spec is None and not _rank_in_scope():
        return []
    try:
        faults = parse_spec(raw)
    except ChaosError as e:
        print(f"[kt] chaos: ignoring malformed {CHAOS_ENV}: {e}")
        return []
    return [f for f in faults if f.kind == kind]


def template_kill_plan(spec: Optional[str] = None) -> Dict[int, int]:
    """``{fork-op index → signal}`` from the ``kill-template`` verbs: the
    warm template (``serving/warm_template.py``) consults it as fork
    requests arrive and self-delivers the signal before forking."""
    return {f.op_index: f.signal_no
            for f in _rank_faults("kill-template", spec)}


def joiner_kill_plan(spec: Optional[str] = None) -> Dict[int, int]:
    """``{fork index → signal}`` from the ``kill-joiner`` verbs: a forked
    replica whose index is in the plan self-delivers the signal mid-boot
    (after the weight attach, before it reports ready)."""
    return {f.op_index: f.signal_no
            for f in _rank_faults("kill-joiner", spec)}


def flywheel_kill_plan(spec: Optional[str] = None) -> Dict[int, int]:
    """``{ledger-poll index -> signal}`` from the ``kill-flywheel`` verbs:
    the flywheel trainer consults it before each cursor poll and
    self-delivers the signal mid-harvest. The resumed trainer restores the
    cursor state its last committed checkpoint names, so the batch that
    died uncommitted re-polls and nothing is trained twice."""
    return {f.op_index: f.signal_no
            for f in _rank_faults("kill-flywheel", spec)}
