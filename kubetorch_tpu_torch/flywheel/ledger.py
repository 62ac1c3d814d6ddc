"""The durable feedback ledger: the port's copy of
``kubetorch_tpu/flywheel/ledger.py``, serving traffic in, training batches
out, with no acked record lost and none trained twice.

Serving replicas hand finished-request payloads to :class:`FeedbackLedger`
(through :func:`engine_feedback_hook`, the engine's ``feedback_sink``),
which writes them as content-hashed, sequence-numbered **segments** with
the store's ``put_json``: the ack :meth:`FeedbackLedger.append` returns
means the segment is stored. The trainer reads through
:class:`LedgerCursor`, at least once, and drops duplicates by record hash.

Every key, the segment and cursor-state documents, :func:`record_hash` and
the state checksum are the JAX package's byte for byte, so a JAX trainer
folds a ledger the port's replicas wrote, a port cursor restores a state a
JAX cursor committed, and the reverse.

The crash windows, closed as in JAX:

- **A replica dies between the store's commit and its ack** (or the ack
  is dropped): the retry re-puts the same key with the same content, and
  a restarted replica that re-samples the payload into a new segment is
  deduplicated by hash at poll time.
- **A replica restarts**: the head names its last sequence number, and
  the constructor probes past it (quorum reads) in case the crash fell
  between the segment's commit and the head's update, so no acked
  segment is overwritten.
- **The trainer dies between poll and checkpoint**: the cursor state of
  step N is written BEFORE the step-N checkpoint commits
  (:meth:`LedgerCursor.commit_state`) and adopted on restore only when
  that checkpoint committed (:meth:`LedgerCursor.restore`). An
  uncommitted batch re-polls; a committed one is skipped.
- **Two trainers race one cursor**: :meth:`LedgerCursor.acquire` bumps a
  store-held fencing epoch; every poll and commit re-reads it, and the
  stale side raises :class:`~kubetorch_tpu_torch.exceptions.
  StaleLeaseError`.

Port idiom: every store access goes through an explicit ``store`` (the
protocol of ``data_store/commands.py``: ``put_json``, ``get_json(key,
quorum=, default=)``); ``store=None`` raises ``TypeError``. The sample
rate is the argument, else ``KT_FLYWHEEL_SAMPLE_RATE``, else 1.0 (the
port has no layered config). The append's retry catches the store's
``DataStoreError``, as JAX's does.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

from .. import telemetry
from ..data_store.commands import require_store
from ..exceptions import DataCorruptionError, DataStoreError, StaleLeaseError

# one segment per append keeps the ack latency one store write; the cap
# only guards against a pathological single append
MAX_SEGMENT_RECORDS = 256

SAMPLE_RATE_ENV = "KT_FLYWHEEL_SAMPLE_RATE"


def env_float(name: str, default: float) -> float:
    """``float(os.environ[name])``, ``default`` when unset or unparsable."""
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def record_hash(payload: Any) -> str:
    """Content hash of one feedback payload: blake2b-160 of its canonical
    JSON. The dedup identity of the whole at-least-once pipeline."""
    data = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.blake2b(data, digest_size=20).hexdigest()


def _ledger_prefix(service: str) -> str:
    return f"flywheel/{service}/ledger"


def segment_key(service: str, replica: str, seq: int) -> str:
    return f"{_ledger_prefix(service)}/{replica}/seg-{seq:08d}"


def head_key(service: str, replica: str) -> str:
    return f"{_ledger_prefix(service)}/{replica}/head"


def cursor_state_key(service: str, step: int) -> str:
    return f"flywheel/{service}/cursor/state-{step:08d}"


def cursor_lease_key(service: str) -> str:
    return f"flywheel/{service}/cursor/lease"


def cursor_last_key(service: str) -> str:
    return f"flywheel/{service}/cursor/last"


def _state_checksum(positions: Dict[str, int], seen: List[str],
                    step: int) -> str:
    body = json.dumps({"positions": positions, "seen": seen,
                       "step": step}, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.blake2b(body, digest_size=20).hexdigest()


class FeedbackLedger:
    """The replica-side appender, one per serving replica. ``append`` is
    the durability boundary: it returns the record hashes only after the
    segment's write succeeded, and retries a failed write by re-putting
    the same segment (same key, same content)."""

    def __init__(self, service: str, replica_id: str, store: Any = None,
                 sample_rate: Optional[float] = None, retries: int = 2):
        self.service = service
        self.replica_id = replica_id
        self.store = require_store(store)
        self.retries = max(0, int(retries))
        if sample_rate is None:
            sample_rate = env_float(SAMPLE_RATE_ENV, 1.0)
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        head = self.store.get_json(head_key(service, replica_id),
                                   quorum=True, default=None)
        seq = int(head["seq"]) + 1 if head else 0
        # quorum here too: a stale single-copy read would end the probe
        # early and the next put would overwrite an acked segment
        while self.store.get_json(segment_key(service, replica_id, seq),
                                  quorum=True, default=None) is not None:
            seq += 1
        self._seq = seq

    @property
    def next_seq(self) -> int:
        return self._seq

    def append(self, payloads: List[Any]) -> List[str]:
        """Durably append one segment of payloads; returns their record
        hashes once the write committed. Raises the store's error when it
        cannot ack."""
        if not payloads:
            return []
        if len(payloads) > MAX_SEGMENT_RECORDS:
            raise ValueError(
                f"segment too large ({len(payloads)} > "
                f"{MAX_SEGMENT_RECORDS}); split the append")
        records = [{"hash": record_hash(p), "payload": p}
                   for p in payloads]
        seq = self._seq
        segment = {"replica": self.replica_id, "seq": seq,
                   "records": records, "at": time.time()}
        key = segment_key(self.service, self.replica_id, seq)
        last: Optional[BaseException] = None
        for _ in range(self.retries + 1):
            try:
                self.store.put_json(key, segment)
                last = None
                break
            except DataStoreError as e:
                # the ack may have been lost after the store committed:
                # re-putting the same content is the idempotent retry
                last = e
        if last is not None:
            raise last
        self._seq = seq + 1
        try:
            self.store.put_json(head_key(self.service, self.replica_id),
                                {"seq": seq, "at": time.time()})
        except DataStoreError:
            pass    # advisory only: the constructor probes past the head
        m = telemetry.flywheel_metrics()
        m["appended"].inc(len(records), service=self.service)
        return [r["hash"] for r in records]

    def sample(self, payload: Any,
               coin: Optional[float] = None) -> Optional[List[str]]:
        """The sampled one-record append the feedback hook makes. ``coin``
        is a uniform [0, 1) draw; by default it comes from the payload's
        hash, so sampling is reproducible."""
        if self.sample_rate <= 0.0:
            return None
        if coin is None:
            coin = int(record_hash(payload)[:8], 16) / float(1 << 32)
        if coin >= self.sample_rate:
            return None
        return self.append([payload])


class LedgerCursor:
    """The trainer-side reader: polls every replica's segments in order,
    drops records already seen by hash, and commits its positions under
    the training loop's own checkpoint commit (module docstring)."""

    def __init__(self, service: str, replicas: List[str], store: Any = None,
                 owner: str = "trainer-0", seen_cap: int = 8192):
        self.service = service
        self.replicas = list(replicas)
        self.store = require_store(store)
        self.owner = owner
        self.seen_cap = int(seen_cap)
        self.positions: Dict[str, int] = {r: 0 for r in self.replicas}
        self.seen: List[str] = []          # insertion-ordered, capped
        self._seen_set = set()
        self.step = 0
        self.epoch = 0                     # 0: fence not acquired
        self._pending_positions: Dict[str, int] = {}
        self._pending_hashes: List[str] = []

    # -- fencing -------------------------------------------------------------

    def acquire(self) -> int:
        """Take (or take over) the cursor by bumping the store-held
        fencing epoch; the previous holder's next poll or commit raises
        :class:`StaleLeaseError`."""
        cur = self.store.get_json(cursor_lease_key(self.service),
                                  quorum=True, default=None)
        epoch = int(cur["epoch"]) + 1 if cur else 1
        self.store.put_json(cursor_lease_key(self.service),
                            {"epoch": epoch, "owner": self.owner,
                             "at": time.time()})
        self.epoch = epoch
        telemetry.add_event("flywheel.cursor_acquire",
                            service=self.service, epoch=epoch)
        return epoch

    def _validate_fence(self) -> None:
        if self.epoch <= 0:
            return                      # unfenced single-trainer mode
        cur = self.store.get_json(cursor_lease_key(self.service),
                                  quorum=True, default=None)
        held = int(cur["epoch"]) if cur else 0
        if held != self.epoch:
            raise StaleLeaseError(
                f"flywheel cursor for {self.service!r} is held at epoch "
                f"{held}; this trainer's epoch {self.epoch} is fenced "
                f"off — stop training",
                workload=f"flywheel/{self.service}",
                epoch=self.epoch, current_epoch=held)

    # -- consume -------------------------------------------------------------

    def _remember(self, h: str) -> None:
        self._seen_set.add(h)
        self.seen.append(h)
        while len(self.seen) > self.seen_cap:
            self._seen_set.discard(self.seen.pop(0))

    def poll(self, max_records: int = 256) -> List[Dict[str, Any]]:
        """One at-least-once read: fresh records across every replica's
        stream, deduplicated by hash. Positions advance only in memory
        until :meth:`commit_state`. Segments are taken whole, so
        ``max_records`` is checked at segment boundaries."""
        self._validate_fence()
        m = telemetry.flywheel_metrics()
        batch: List[Dict[str, Any]] = []
        pending_hashes: List[str] = []
        pending_set: set = set()
        pending_pos: Dict[str, int] = {}
        for replica in self.replicas:
            seq = self.positions[replica]
            while len(batch) < max_records:
                seg = self.store.get_json(
                    segment_key(self.service, replica, seq), quorum=True,
                    default=None)
                if seg is None:
                    break
                for rec in seg.get("records", []):
                    h = rec.get("hash")
                    if h in self._seen_set or h in pending_set:
                        m["deduped"].inc(service=self.service)
                        continue
                    batch.append(rec)
                    pending_hashes.append(h)
                    pending_set.add(h)
                seq += 1
            pending_pos[replica] = seq
        self._pending_positions = pending_pos
        self._pending_hashes = pending_hashes
        if batch:
            m["consumed"].inc(len(batch), service=self.service)
        return batch

    # -- commit / restore ----------------------------------------------------

    def commit_state(self, step: int) -> Dict[str, Any]:
        """Fold the last poll into the durable cursor state of ``step``.
        Call it BEFORE the step-``step`` checkpoint commits: restore adopts
        only the state a committed checkpoint names, so a crash between
        the two leaves the previous state in force and the batch re-polls;
        a torn document fails its embedded checksum."""
        self._validate_fence()
        self.positions.update(self._pending_positions)
        for h in self._pending_hashes:
            self._remember(h)
        self._pending_positions = {}
        self._pending_hashes = []
        self.step = int(step)
        state = {"positions": dict(self.positions),
                 "seen": list(self.seen), "step": self.step,
                 "epoch": self.epoch, "at": time.time(),
                 "checksum": _state_checksum(self.positions, self.seen,
                                             self.step)}
        self.store.put_json(cursor_state_key(self.service, self.step),
                            state)
        try:
            # advisory freshness pointer (the lag gauges, flywheel_status);
            # restore never reads it
            self.store.put_json(cursor_last_key(self.service),
                                {"step": self.step, "at": state["at"],
                                 "epoch": self.epoch})
        except DataStoreError:
            pass
        return state

    def restore(self, committed_step: Optional[int]) -> bool:
        """Adopt the cursor state the last committed checkpoint names
        (``committed_step``, from the trainer's ``Checkpointer.restore``).
        None (nothing committed) resets to the stream heads. Raises
        :class:`DataCorruptionError` when the named state is missing or
        fails its checksum."""
        if committed_step is None:
            self.positions = {r: 0 for r in self.replicas}
            self.seen = []
            self._seen_set = set()
            self.step = 0
            return False
        state = self.store.get_json(
            cursor_state_key(self.service, int(committed_step)),
            quorum=True, default=None)
        if state is None:
            raise DataCorruptionError(
                f"flywheel cursor state for committed step "
                f"{committed_step} is missing — the ledger cannot prove "
                f"which records were folded; refusing to re-train blind")
        want = _state_checksum(state.get("positions", {}),
                               state.get("seen", []),
                               int(state.get("step", -1)))
        if state.get("checksum") != want:
            raise DataCorruptionError(
                f"flywheel cursor state for step {committed_step} failed "
                f"its checksum (torn write?) — refusing to adopt it")
        self.positions = {r: int(state["positions"].get(r, 0))
                          for r in self.replicas}
        self.seen = list(state.get("seen", []))
        self._seen_set = set(self.seen)
        self.step = int(state["step"])
        self._pending_positions = {}
        self._pending_hashes = []
        return True

    def lag_records(self) -> int:
        """Committed segments not yet consumed, over every replica (one
        head read each)."""
        lag = 0
        for replica in self.replicas:
            head = self.store.get_json(head_key(self.service, replica),
                                       quorum=True, default=None)
            if head is not None:
                lag += max(0, int(head["seq"]) + 1
                           - self.positions.get(replica, 0))
        return lag


def read_all_hashes(service: str, replicas: List[str],
                    store: Any = None) -> List[str]:
    """Every record hash readable from the ledger, over all replicas' full
    streams: the settle-time oracle that acked records are still there."""
    store = require_store(store)
    out: List[str] = []
    for replica in replicas:
        seq = 0
        while True:
            seg = store.get_json(segment_key(service, replica, seq),
                                 quorum=True, default=None)
            if seg is None:
                break
            out.extend(r.get("hash") for r in seg.get("records", []))
            seq += 1
    return out


def engine_feedback_hook(ledger: FeedbackLedger):
    """A ``GenerationEngine.feedback_sink``: samples each finished
    request's payload into ``ledger``. It runs on the engine's stepping
    thread, and an error never leaves it: a lost sample was never acked,
    a raising sink would stall decoding."""
    def _sink(payload: Dict[str, Any]) -> None:
        try:
            ledger.sample(payload)
        except Exception:  # noqa: BLE001 — sampling must never stall decode
            pass
    return _sink


__all__ = ["FeedbackLedger", "LedgerCursor", "record_hash",
           "segment_key", "head_key", "cursor_state_key",
           "cursor_lease_key", "read_all_hashes", "engine_feedback_hook",
           "MAX_SEGMENT_RECORDS"]
