"""The port's session binder (kubetorch_tpu_torch/serve/sessions.py) over
the port's engine on the CPU (``tiny``, fp32), mirroring the binder cases
of tests/test_serve_router.py: a returning session prefills only its
suffix behind its resident prefix and decodes the tokens of its whole
prompt; an adapter mismatch is a miss; the LRU cap unregisters the coldest
session's prefix on the engine. The key derivation and the binder's
bookkeeping are also held to the JAX package's over the same fake engine.
"""

import pytest
import torch

from kubetorch_tpu.serve import sessions as jax_sessions
from kubetorch_tpu_torch.models import generate as pt_gen
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
from kubetorch_tpu_torch.serve import (EngineSessionBinder, GenerationEngine,
                                       SessionStats, session_key)
from kubetorch_tpu_torch.serve import sessions as pt_sessions

pytestmark = pytest.mark.level("unit")

CFG = LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return llama_init(CFG, seed=5, device="cpu")


def engine(params, **kw):
    return GenerationEngine(params, CFG, slots=2, max_len=64,
                            prefill_buckets=(8, 16, 32), device="cpu", **kw)


def finish(eng, handle):
    while eng.step():
        pass
    return handle.result(timeout=0)


def solo(params, prompt, n):
    out = pt_gen.generate(params, torch.tensor([prompt]), CFG,
                          max_new_tokens=n)
    return out[0, len(prompt):].tolist()


class FakeEngine:
    """The engine surface the binder uses, recording what it is asked."""

    def __init__(self):
        self.next_pid = 0
        self.registered = {}          # pid -> (tokens, adapter)
        self.submits = []             # (prompt, prefix_id, adapter_id)

    def register_prefix(self, tokens, adapter_id=None):
        pid = self.next_pid
        self.next_pid += 1
        self.registered[pid] = (list(tokens), adapter_id)
        return pid

    def unregister_prefix(self, pid):
        return self.registered.pop(pid, None) is not None

    def submit(self, prompt, prefix_id=None, adapter_id=None, **kw):
        self.submits.append((list(prompt), prefix_id, adapter_id))
        return f"handle-{len(self.submits)}"


def test_binder_reuses_session_prefix_for_later_turns(params):
    eng = engine(params)
    b = EngineSessionBinder(eng, capacity=4, min_prefix_tokens=2)
    turn1 = list(range(1, 21))
    assert finish(eng, b.submit("s1", turn1, max_new_tokens=4)) == solo(
        params, turn1, 4)
    assert len(eng._prefixes) == 1 and eng._prefix_hits == 0
    (pid, pref), = eng._prefixes.items()
    assert list(pref.tokens) == turn1
    turn2 = turn1 + [100, 101, 102]
    got = finish(eng, b.submit("s1", turn2, max_new_tokens=5))
    # only the suffix prefilled, behind the resident prefix, and the tokens
    # are those of the whole prompt
    assert eng._prefix_hits == 1
    assert got == solo(params, turn2, 5)
    s = b.stats()
    assert (s.hits, s.misses, s.sessions, s.evictions) == (1, 1, 1, 0)
    assert s.hit_rate == 0.5


def test_binder_adapter_mismatch_is_a_miss(params):
    eng = engine(params)
    b = EngineSessionBinder(eng, capacity=4, min_prefix_tokens=2)
    prompt = list(range(1, 11))
    finish(eng, b.submit("s1", prompt, max_new_tokens=2))
    assert b.lookup("s1", prompt + [99], adapter_id=7) == (None, prompt + [99])
    assert b.lookup("s1", prompt + [99])[0] is not None
    # the miss reaches the engine, which has no adapter 7 and fails the
    # submit as the JAX engine does
    with pytest.raises(KeyError, match="unknown adapter_id 7"):
        b.submit("s1", prompt + [99], adapter_id=7, max_new_tokens=2)
    assert b.stats().misses == 2 and b.stats().hits == 0


def test_binder_lru_eviction_unregisters_device_state(params):
    eng = engine(params)
    b = EngineSessionBinder(eng, capacity=2, min_prefix_tokens=2)
    for i in range(3):
        finish(eng, b.submit(f"s{i}", list(range(1, 11 + i)),
                             max_new_tokens=2))
    assert len(eng._prefixes) == 2                 # LRU evicted and freed
    assert b.stats().evictions == 1
    assert b.resident_sessions() == ["s1", "s2"]
    assert b.release("s2") and len(eng._prefixes) == 1
    assert not b.release("s2")
    assert b.__kt_metrics__()["sessions_resident"] == 1.0


def test_binder_skips_short_and_refused_prompts(params):
    eng = engine(params)
    b = EngineSessionBinder(eng, capacity=2, min_prefix_tokens=8)
    finish(eng, b.submit("short", [1, 2, 3], max_new_tokens=2))
    assert not eng._prefixes
    # a keyless call passes straight through
    assert finish(eng, b.submit(None, [5, 6], max_new_tokens=3)) == solo(
        params, [5, 6], 3)
    assert b.stats() == SessionStats(sessions=0, hits=0, misses=1,
                                     evictions=0)
    with pytest.raises(ValueError):
        EngineSessionBinder(eng, capacity=0)


@pytest.mark.parametrize("headers,kwargs", [
    ({"X-KT-Session": "abc"}, {"session_id": "x"}),
    ({"x-kt-session": "low"}, None),
    (None, {"session_id": "s"}), (None, {"session": 3}),
    (None, {"prefix_id": 0}), (None, {"adapter_id": 2}),
    ({}, {}), (None, None), ({"X-KT-Session": ""}, {"prefix_id": 7}),
])
def test_session_key_matches_jax(headers, kwargs):
    assert session_key(headers, kwargs) == jax_sessions.session_key(
        headers, kwargs)
    assert pt_sessions.SESSION_HEADER == jax_sessions.SESSION_HEADER


@pytest.mark.parametrize("advance", [False, True])
def test_binder_bookkeeping_matches_jax_over_a_fake_engine(advance):
    """The same call sequence through both binders over fake engines: the
    same submits, registrations and stats."""
    fakes = []
    for mod in (jax_sessions, pt_sessions):
        eng = FakeEngine()
        b = mod.EngineSessionBinder(eng, capacity=2, advance=advance,
                                    min_prefix_tokens=2)
        turn = list(range(20))
        b.submit("s1", turn)
        b.submit("s1", turn + [100, 101])
        b.submit("s1", list(range(5)))               # diverged: a miss
        b.submit("s2", [7, 7, 7], adapter_id=3)
        b.submit("s3", [8, 8, 8, 8])                 # evicts s1
        b.submit(None, [1])
        fakes.append((eng.submits, eng.registered, b.stats(),
                      b.resident_sessions()))
    assert fakes[0][:2] == fakes[1][:2]
    assert vars(fakes[0][2]) == vars(fakes[1][2])
    assert fakes[0][3] == fakes[1][3]
