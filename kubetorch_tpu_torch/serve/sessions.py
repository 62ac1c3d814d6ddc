"""Session → prefix-cache glue for the serving front door, the counterpart
of ``kubetorch_tpu/serve/sessions.py``.

The engine-side half of affinity routing. The router keeps a session
sticky to one replica; this module makes that stickiness worth something
on the replica: a returning session's conversation header is already
resident as registered prefix K/V, so only the new turn's suffix is
prefilled.

Free of torch and engine imports — the engine is passed in — so a server
process can import the session types without pulling the device runtime.

Two pieces:

- :class:`SessionStats` / :func:`session_key` — the shared vocabulary
  (header name, key derivation) both halves agree on.
- :class:`EngineSessionBinder` — binds sessions to registered prefixes on
  a :class:`~kubetorch_tpu_torch.serve.engine.GenerationEngine`, LRU-capped
  so resident prefixes (each pins 2·L·P·NKV·Hd values on the device) can't
  grow without bound. Turn 1 pays one extra prefill to register the
  prompt; every later turn of the session prefills only its suffix.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

# The wire name the router and the engine side both key on. The port keeps
# its own copy of the JAX package's constant (``kubetorch_tpu/constants.py``)
# rather than importing it.
SESSION_HEADER = "X-KT-Session"


def session_key(headers: Optional[Dict[str, str]] = None,
                kwargs: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Derive the affinity key for one call: the explicit session header
    wins; else well-known body kwargs (``session_id``, ``session``,
    ``prefix_id``, ``adapter_id``) in that order — a request pinned to a
    cached prefix or a LoRA adapter benefits from landing where that state
    is resident even when the caller never named a session."""
    if headers:
        for name in (SESSION_HEADER, SESSION_HEADER.lower()):
            val = headers.get(name)
            if val:
                return str(val)
    if kwargs:
        for field_name in ("session_id", "session", "prefix_id",
                           "adapter_id"):
            val = kwargs.get(field_name)
            if val is not None:
                return f"{field_name}:{val}"
    return None


@dataclass
class SessionStats:
    sessions: int
    hits: int
    misses: int
    evictions: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class EngineSessionBinder:
    """Per-engine session residency: session id → registered prefix.

    ``submit(session_id, prompt, ...)`` strips the session's resident
    prefix off the prompt (suffix-only prefill — the prefix-cache win the
    router's affinity routing exists to compound) and, on first sight of a
    session, registers its prompt as the resident prefix for the next
    turn. ``advance=True`` rolls the resident prefix forward to each
    turn's full prompt (next turn's suffix is just the new text) at the
    cost of one extra registration prefill per turn; the default keeps the
    turn-1 header resident, which already covers the dominant
    system-prompt + few-shot share of multi-turn traffic.

    LRU-capped: the coldest session's prefix is unregistered (freeing its
    device K/V) when ``capacity`` is exceeded. Thread-safe — engines are
    driven from server executors and the engine loop concurrently.
    """

    def __init__(self, engine, capacity: int = 64, *,
                 advance: bool = False, min_prefix_tokens: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.engine = engine
        self.capacity = int(capacity)
        self.advance = bool(advance)
        # below this length a registration costs more than it saves
        self.min_prefix_tokens = int(min_prefix_tokens)
        # session id → (prefix_id, tokens tuple, adapter_id)
        self._resident: "OrderedDict[str, Tuple[int, tuple, Any]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self._hits = self._misses = self._evictions = 0
        self.created_at = time.monotonic()

    # -- residency ----------------------------------------------------------

    def lookup(self, session_id: str, prompt: Sequence[int],
               adapter_id: Optional[int] = None):
        """(prefix_id, suffix) when the session's resident prefix is a
        proper prefix of ``prompt`` under the same adapter; (None, prompt)
        otherwise. Bumps LRU recency on hit."""
        prompt = list(prompt)
        with self._lock:
            entry = self._resident.get(session_id)
            if entry is None:
                return None, prompt
            pid, toks, aid = entry
            n = len(toks)
            if (aid == adapter_id and n < len(prompt)
                    and list(toks) == prompt[:n]):
                self._resident.move_to_end(session_id)
                return pid, prompt[n:]
            return None, prompt

    def _register(self, session_id: str, prompt: List[int],
                  adapter_id: Optional[int]) -> None:
        if len(prompt) < self.min_prefix_tokens:
            return
        try:
            pid = self.engine.register_prefix(prompt, adapter_id=adapter_id)
        except Exception:  # noqa: BLE001 — residency is an optimization;
            # a prompt the engine refuses (too long for max_len headroom)
            # must never fail the request that carried it
            return
        with self._lock:
            old = self._resident.pop(session_id, None)
            self._resident[session_id] = (pid, tuple(prompt), adapter_id)
            evict = []
            while len(self._resident) > self.capacity:
                _sid, (opid, _t, _a) = self._resident.popitem(last=False)
                evict.append(opid)
                self._evictions += 1
        if old is not None:
            self.engine.unregister_prefix(old[0])
        for opid in evict:
            self.engine.unregister_prefix(opid)

    def release(self, session_id: str) -> bool:
        """Drop a session's resident prefix (client disconnect, TTL)."""
        with self._lock:
            entry = self._resident.pop(session_id, None)
        if entry is None:
            return False
        self.engine.unregister_prefix(entry[0])
        return True

    # -- the submit path ----------------------------------------------------

    def submit(self, session_id: Optional[str], prompt: Sequence[int],
               adapter_id: Optional[int] = None, **kwargs):
        """``engine.submit`` with session-aware prefix reuse. A keyless
        call passes straight through. Returns the engine's handle."""
        if session_id is None:
            return self.engine.submit(prompt, adapter_id=adapter_id,
                                      **kwargs)
        prompt = [int(t) for t in prompt]
        pid, suffix = self.lookup(session_id, prompt, adapter_id)
        if pid is not None:
            with self._lock:
                self._hits += 1
            handle = self.engine.submit(suffix, prefix_id=pid,
                                        adapter_id=adapter_id, **kwargs)
            if self.advance:
                self._register(session_id, prompt, adapter_id)
            return handle
        with self._lock:
            self._misses += 1
            known = session_id in self._resident
        handle = self.engine.submit(prompt, adapter_id=adapter_id, **kwargs)
        # first sight (or a prompt that diverged from the resident prefix):
        # make THIS prompt resident so the session's next turn hits
        if not known or self.advance:
            self._register(session_id, prompt, adapter_id)
        return handle

    # -- introspection ------------------------------------------------------

    def resident_sessions(self) -> List[str]:
        with self._lock:
            return list(self._resident)

    def stats(self) -> SessionStats:
        with self._lock:
            return SessionStats(sessions=len(self._resident),
                                hits=self._hits, misses=self._misses,
                                evictions=self._evictions)

    def __kt_metrics__(self) -> Dict[str, float]:
        """Pod-scrape hook merge (same contract as the engine's): session
        residency and hit rate on ``/metrics`` under ``kt_user_``."""
        s = self.stats()
        out = {"sessions_resident": float(s.sessions),
               "session_prefix_hits": float(s.hits),
               "session_prefix_misses": float(s.misses),
               "session_prefix_hit_rate": float(s.hit_rate),
               "session_evictions": float(s.evictions)}
        inner = getattr(self.engine, "__kt_metrics__", None)
        if inner is not None:
            out.update(inner())
        return out
