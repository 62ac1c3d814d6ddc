"""The port's speculative engine (kubetorch_tpu_torch/serve/spec_engine.py)
against the JAX package's, on ``tiny`` configs in fp32 on the CPU, with the
models of ``test_torch_speculative.py`` (numpy weights from a seed carried
across with ``params_from_numpy``).

Tolerances:

- ``_grid_ingest``: fp32 logits within 1e-5 relative L2 per row (one
  position's logits over the vocab), and the cache rows it writes within
  1e-5 per row (int8 grids: the rows dequantized), on a grid of mixed
  progress: one slot at a full window, one partial, one idle at length 0.
- Engines: greedy tokens equal, not close, to JAX's ``generate`` of each
  prompt alone where the JAX package's tests hold its engine to that, and
  to the JAX ``SpeculativeEngine`` on the same scenario (with the same
  acceptance statistics where both run the same draft).
- Refusals: the same exception type and message as the JAX engine.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import lora as jl
from kubetorch_tpu.models.generate import KVCache as JaxKV
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.serve import spec_engine as jax_se
from kubetorch_tpu.serve.kv_quant import QuantKVCache as JaxQKV
from kubetorch_tpu_torch import telemetry
from kubetorch_tpu_torch.models.generate import KVCache
from kubetorch_tpu_torch.models.llama import LlamaConfig, apply_rope, rope_freqs
from kubetorch_tpu_torch.ops.tolerance import row_rel_err
from kubetorch_tpu_torch.serve import QuantKVCache, SpeculativeEngine
from kubetorch_tpu_torch.serve import dequantize_rows, quantize_rows
from kubetorch_tpu_torch.serve import spec_engine as pt_se

from .test_torch_lora import _plcfg, _pt, _rand_adapters
from .test_torch_speculative import DRAFT, dense, moe, solo

pytestmark = pytest.mark.level("unit")

RTOL = 1e-5
GRID = dict(slots=2, max_len=64, prefill_buckets=(4, 8))


@pytest.fixture(scope="module")
def target():
    return dense(11)


@pytest.fixture(scope="module")
def draft():
    return dense(12, **DRAFT)


@pytest.fixture(scope="module")
def moe_target():
    return moe()


def jax_engine(tm, dm, **kw):
    return jax_se.SpeculativeEngine(tm.j, tm.jcfg, dm.j, dm.jcfg, **kw)


def pt_engine(tm, dm, **kw):
    return SpeculativeEngine(tm.p, tm.pcfg, dm.p, dm.pcfg, device="cpu",
                             **kw)


def drain(eng):
    while eng.step():
        pass


def run(eng, *requests):
    """Submit (prompt, kwargs) pairs, step the engine dry, return tokens."""
    hs = [eng.submit(p, **kw) for p, kw in requests]
    drain(eng)
    return [h.result(timeout=0) for h in hs]


def stats(eng):
    s = eng.spec_stats
    return s.rounds, s.proposed, s.accepted


def both(tm, dm, scenario, **kw):
    """``scenario(engine, side)`` on the JAX and the port's engine, built
    alike; their results must be equal. Returns the port's engine and
    result."""
    want = scenario(jax_engine(tm, dm, **kw), "jax")
    eng = pt_engine(tm, dm, **kw)
    got = scenario(eng, "pt")
    assert got == want
    return eng, got


# ---------------------------------------------------------------------------
# _grid_ingest
# ---------------------------------------------------------------------------

# a grid of mixed progress: slot 0 a full window at row 6, slot 1 three
# real tokens at row 11, slot 2 idle (length 0 at row 0)
START, TRUE_LEN, W, S_MAX = [6, 11, 0], [5, 3, 0], 5, 32


def _banks(cfg, rank=4, n=3, seed=5):
    """A bank of n adapters per attention projection, index 0 the zero
    adapter: numpy (A (L, n, D, R), B (L, n, R, O))."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.dim, cfg.dim // cfg.n_heads
    outs = dict(wq=cfg.n_heads * hd, wk=cfg.n_kv_heads * hd,
                wv=cfg.n_kv_heads * hd, wo=d)
    ins = dict(wq=d, wk=d, wv=d, wo=cfg.n_heads * hd)
    banks = {}
    for t in ("wq", "wk", "wv", "wo"):
        a = rng.standard_normal((cfg.n_layers, n, ins[t], rank)) * 0.3
        b = rng.standard_normal((cfg.n_layers, n, rank, outs[t])) * 0.3
        a[:, 0] = b[:, 0] = 0.0
        banks[t] = (a.astype(np.float32), b.astype(np.float32))
    return banks


@pytest.mark.parametrize("case,s_eff", [("fp", 16), ("fp", None),
                                        ("int8", 16), ("lora", 16),
                                        ("moe", 16)])
def test_grid_ingest_matches_jax(target, moe_target, case, s_eff):
    m = moe_target if case == "moe" else target
    cfg = m.pcfg
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, 3, S_MAX, cfg.n_kv_heads, cfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    blocks = rng.integers(0, cfg.vocab_size, (3, W))
    start, tl = np.array(START), np.array(TRUE_LEN)
    jkw, pkw = {}, {}
    if case == "lora":
        banks = _banks(m.jcfg)
        aidx = np.array([1, 0, 2])
        jkw = dict(banks={t: (jnp.asarray(a), jnp.asarray(b))
                          for t, (a, b) in banks.items()},
                   aidx=jnp.asarray(aidx, jnp.int32), lora_scale=2.0)
        pkw = dict(banks={t: (torch.from_numpy(a), torch.from_numpy(b))
                          for t, (a, b) in banks.items()},
                   aidx=torch.from_numpy(aidx), lora_scale=2.0)
    if case == "int8":
        (kq, ks), (vq, vs) = (quantize_rows(torch.from_numpy(k0)),
                              quantize_rows(torch.from_numpy(v0)))
        pc = QuantKVCache(kq, ks, vq, vs)
        jc = JaxQKV(*(jnp.asarray(t.numpy()) for t in pc))
        pc = QuantKVCache(*(t.clone() for t in pc))
    else:
        pc = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
        jc = JaxKV(jnp.asarray(k0), jnp.asarray(v0))
    want, jc = jax_se._grid_ingest(
        m.j, jc, jnp.asarray(blocks, jnp.int32), jnp.asarray(start, jnp.int32),
        jnp.asarray(tl, jnp.int32), m.jcfg, s_eff=s_eff, **jkw)
    got = pt_se._grid_ingest(m.p, pc, torch.from_numpy(blocks),
                             torch.from_numpy(start), torch.from_numpy(tl),
                             cfg, s_eff=s_eff, **pkw)
    assert got.shape == (3, W, cfg.vocab_size) and got.dtype == torch.float32
    assert row_rel_err(got, torch.from_numpy(np.array(want))) <= RTOL
    if case == "int8":
        rows = [(dequantize_rows(pc.kq, pc.ks), jc.kq, jc.ks),
                (dequantize_rows(pc.vq, pc.vs), jc.vq, jc.vs)]
        rows = [(g, dequantize_rows(torch.from_numpy(np.array(q)),
                                    torch.from_numpy(np.array(s))))
                for g, q, s in rows]
    else:
        rows = [(pc.k, torch.from_numpy(np.array(jc.k))),
                (pc.v, torch.from_numpy(np.array(jc.v)))]
    for g, w in rows:
        assert row_rel_err(g, w) <= RTOL


def test_rope_grid_is_rope_per_row():
    """``_rope_grid`` at per-(slot, offset) positions equals the model's
    ``apply_rope`` at each slot's own positions."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 4, 16)).astype(np.float32))
    freqs = rope_freqs(cfg, 20)
    posm = torch.tensor([[4, 5, 6], [10, 11, 12]])
    got = pt_se._rope_grid(x, freqs[posm])
    for b in range(2):
        want = apply_rope(x[b:b + 1], freqs[posm[b]])
        assert torch.allclose(got[b:b + 1], want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# exactness (tests/test_spec_engine.py TestExactness, one for one)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_concurrent_requests_match_solo_generate(target, draft, k):
    prompts = [[5, 17, 42], [100, 200, 300, 400, 401], [1, 2]]
    ns = [8, 11, 5]

    def scenario(eng, side):
        toks = run(eng, *[(p, dict(max_new_tokens=n))
                          for p, n in zip(prompts, ns)])
        return toks, stats(eng)

    eng, (got, st) = both(target, draft, scenario, spec_k=k, slots=4,
                          max_len=64, prefill_buckets=(8,))
    assert got == [solo(target, p, n) for p, n in zip(prompts, ns)]
    assert st[0] >= 1


def test_self_draft_accepts_everything(target):
    """Draft == target: every proposal accepted, the grid advancing k+1
    tokens per slot per round."""
    prompts = [[3, 4, 5], [9, 8, 7]]
    eng = pt_engine(target, target, spec_k=3, slots=2, max_len=64,
                    prefill_buckets=(8,))
    got = run(eng, *[(p, dict(max_new_tokens=12)) for p in prompts])
    assert got == [solo(target, p, 12) for p in prompts]
    assert eng.spec_stats.acceptance_rate == 1.0
    # 12 tokens = 1 (prefill) + rounds x 4: 3 rounds per slot
    assert eng.spec_stats.rounds <= 2 * 3 + 1


def test_mid_flight_admission(target, draft):
    """A request admitted while its neighbour is mid-speculation perturbs
    neither."""
    pa, pb = [5, 17, 42, 99], [7, 7, 7]

    def scenario(eng, side):
        ha = eng.submit(pa, max_new_tokens=10)
        eng.step()
        eng.step()
        hb = eng.submit(pb, max_new_tokens=6)
        drain(eng)
        return [ha.result(timeout=0), hb.result(timeout=0)], stats(eng)

    _, (got, _) = both(target, draft, scenario, spec_k=3, slots=2,
                       max_len=64, prefill_buckets=(8,))
    assert got == [solo(target, pa, 10), solo(target, pb, 6)]


def test_slot_reuse_after_retirement(target, draft):
    eng = pt_engine(target, draft, spec_k=2, slots=1, max_len=64,
                    prefill_buckets=(8,))
    for prompt, n in [([5, 17], 5), ([42, 43, 44], 7), ([1], 4)]:
        assert run(eng, (prompt, dict(max_new_tokens=n))) == [
            solo(target, prompt, n)]
        # retirement cleared the slot's ledgers (_free_slot_ledgers)
        assert eng._spec_valid[0] == 0 and eng._slot_pending[0] == []


def test_eos_retires_early(target, draft):
    ref = solo(target, [5, 17, 42], 12)
    eos = ref[4]

    def scenario(eng, side):
        got = run(eng, ([5, 17, 42], dict(max_new_tokens=12)))
        # the slot is free again
        more = run(eng, ([9, 8], dict(max_new_tokens=3)))
        return got, [len(t) for t in more]

    _, (got, more) = both(target, draft, scenario, spec_k=3, slots=2,
                          max_len=64, prefill_buckets=(8,), eos_id=eos)
    assert got == [ref[:ref.index(eos) + 1]] and more == [3]


def test_stop_sequence_retires_early(target, draft):
    """A stop sequence matched inside an accepted run ends the request
    there, and the round's later tokens are dropped."""
    ref = solo(target, [5, 17, 42], 12)
    stop = ref[5:7]

    def scenario(eng, side):
        return run(eng, ([5, 17, 42], dict(max_new_tokens=12, stop=stop)),
                   ([9, 8], dict(max_new_tokens=6))), stats(eng)

    _, (got, _) = both(target, target, scenario, spec_k=3, **GRID)
    cut = next(i for i in range(2, 13) if ref[i - 2:i] == stop)
    assert got[0] == ref[:cut] and got[1] == solo(target, [9, 8], 6)


def test_background_loop(target, draft):
    eng = pt_engine(target, draft, spec_k=2, **GRID)
    try:
        got = eng.generate([5, 6, 7], 8, timeout=300)
    finally:
        eng.stop()
    assert got == solo(target, [5, 6, 7], 8)


def test_randomized_interleavings_match_jax(target, draft):
    """Random prompts, budgets, k and slot counts, submissions staggered
    across rounds: every request equals the JAX engine's run of the same
    interleaving, which equals its solo generate."""
    rng = random.Random(0xC0FFEE)
    for trial in range(3):
        k = rng.choice([1, 2, 3, 4])
        slots = rng.choice([1, 2, 3])
        reqs = [([rng.randrange(target.jcfg.vocab_size)
                  for _ in range(rng.randint(1, 10))], rng.randint(1, 12))
                for _ in range(rng.randint(2, 5))]

        def scenario(eng, side):
            hs = [eng.submit(reqs[0][0], max_new_tokens=reqs[0][1])]
            for prompt, n in reqs[1:]:
                eng.step()
                hs.append(eng.submit(prompt, max_new_tokens=n))
            drain(eng)
            return [h.result(timeout=0) for h in hs]

        _, got = both(target, draft, scenario, spec_k=k, slots=slots,
                      max_len=64, prefill_buckets=(4, 8))
        for (prompt, n), toks in zip(reqs, got):
            assert toks == solo(target, prompt, n), (trial, k, slots)


# ---------------------------------------------------------------------------
# features: int8 KV, multi-LoRA, prefixes, chunked prefill, MoE
# ---------------------------------------------------------------------------


def test_int8_kv_matches_jax_engines(target, draft):
    """The target's grid in int8, the draft's in fp32: equal to the JAX
    speculative engine, and to the JAX plain engine over the same int8
    grid (the JAX package's own oracle for this case)."""
    prompts = [[5, 17, 42], [1, 2]]

    def scenario(eng, side):
        assert isinstance(eng._cache, QuantKVCache if side == "pt" else JaxQKV)
        return run(eng, *[(p, dict(max_new_tokens=8)) for p in prompts]), \
            stats(eng)

    _, (got, st) = both(target, draft, scenario, spec_k=3, quantize_kv=True,
                        **GRID)
    for toks, p in zip(got, prompts):
        plain = JaxEngine(target.j, target.jcfg, slots=1, max_len=64,
                          prefill_buckets=(4, 8), quantize_kv=True)
        assert toks == run(plain, (p, dict(max_new_tokens=8)))[0]
    assert st[0] > 0


def test_multi_lora_matches_jax_engine(target, draft):
    """An adapter request beside a base one: the target's windows gather
    each slot's adapter; unregistering repoints the slot at the base."""
    lcfg = jl.LoraConfig(rank=4)
    ad = _rand_adapters(7, target.j, lcfg)

    def scenario(eng, side):
        tree, cfg = ((ad, lcfg) if side == "jax" else (_pt(ad), _plcfg(lcfg)))
        aid = eng.register_adapter(tree, cfg)
        got = run(eng, ([5, 17, 42], dict(max_new_tokens=8, adapter_id=aid)),
                  ([1, 2], dict(max_new_tokens=6)))
        assert eng.unregister_adapter(aid) is True
        after = run(eng, ([5, 17, 42], dict(max_new_tokens=4)))
        return got, after

    _, (got, after) = both(target, draft, scenario, spec_k=3, **GRID)
    assert got[1] == solo(target, [1, 2], 6)
    # the adapter changes the stream; after eviction the base comes back
    assert got[0] != solo(target, [5, 17, 42], 8)
    assert after == [solo(target, [5, 17, 42], 4)]


def test_prefix_matches_jax_engine_and_full_prompt(target, draft):
    prefix, suffix = [5, 17, 42], [9, 11]

    def scenario(eng, side):
        pid = eng.register_prefix(prefix)
        got = run(eng, (suffix, dict(max_new_tokens=8, prefix_id=pid)),
                  ([1, 2], dict(max_new_tokens=5)))
        assert eng.unregister_prefix(pid)
        # both models' prefixes are gone
        assert pid not in eng._draft_prefixes
        # the headroom counts the prefix's stored width
        pid2 = eng.register_prefix([1] * 8)
        with pytest.raises(ValueError, match="verify window"):
            eng.submit([2] * 8, max_new_tokens=48, prefix_id=pid2)
        return got

    _, got = both(target, draft, scenario, spec_k=3, **GRID)
    assert got == [solo(target, prefix + suffix, 8), solo(target, [1, 2], 5)]


@pytest.mark.parametrize("with_prefix", [False, True])
def test_chunked_prefill_matches_jax_engine(target, draft, with_prefix):
    """Both models' accumulators advance one chunk per step, from zero or
    behind a cached prefix, beside a short neighbour."""
    prefix = [5, 17, 42]
    long = list(range(30, 41))

    def scenario(eng, side):
        kw = {}
        if with_prefix:
            kw["prefix_id"] = eng.register_prefix(prefix)
        return run(eng, (long, dict(max_new_tokens=8, **kw)),
                   ([1, 2], dict(max_new_tokens=5)))

    _, got = both(target, draft, scenario, spec_k=3, slots=2, max_len=64,
                  prefill_buckets=(4, 16), prefill_chunk=4)
    full = (prefix if with_prefix else []) + long
    assert got == [solo(target, full, 8), solo(target, [1, 2], 5)]


def test_cancel_mid_chunking(target, draft):
    eng = pt_engine(target, draft, spec_k=2, slots=2, max_len=64,
                    prefill_buckets=(4, 16), prefill_chunk=4)
    h = eng.submit(list(range(5, 16)), max_new_tokens=6)
    eng.step()
    assert eng._chunking is not None and h.cancel() is True
    drain(eng)
    assert h.result(timeout=0) == []
    assert run(eng, ([9], dict(max_new_tokens=3))) == [solo(target, [9], 3)]


def test_moe_target_matches_jax_engine(moe_target, draft):
    prompts = [[5, 17, 42, 99], [7] * 6]
    ns = [9, 7]

    def scenario(eng, side):
        return run(eng, *[(p, dict(max_new_tokens=n))
                          for p, n in zip(prompts, ns)]), stats(eng)

    _, (got, _) = both(moe_target, draft, scenario, spec_k=3, **GRID)
    assert got == [solo(moe_target, p, n) for p, n in zip(prompts, ns)]


# ---------------------------------------------------------------------------
# the draft-length controller, refusals, headroom
# ---------------------------------------------------------------------------


def _stub(cls, k, k_min, k_max, every):
    """An engine object with only the controller's state: no weights, no
    compile."""
    eng = object.__new__(cls)
    eng.k, eng.k_min, eng.k_max = k, k_min, k_max
    eng._adapt_every, eng._rounds_since_adapt = every, 0
    eng._accept_ewma = None
    return eng


ROUNDS = [(8, 8), (8, 8), (7, 8), (8, 8), (0, 0), (6, 8), (1, 8), (0, 8),
          (0, 8), (0, 8), (2, 8), (0, 8), (0, 8), (8, 8), (8, 8), (8, 8),
          (8, 8), (8, 8), (8, 8), (8, 8), (8, 8), (3, 8), (5, 8)]


@pytest.mark.parametrize("k,k_min,k_max,every", [(3, 1, 6, 1), (2, 1, 4, 2),
                                                 (3, 3, 3, 1)])
def test_note_round_trajectory_matches_jax(k, k_min, k_max, every):
    j = _stub(jax_se.SpeculativeEngine, k, k_min, k_max, every)
    p = _stub(SpeculativeEngine, k, k_min, k_max, every)
    ks, ewmas = [], []
    for accepted, proposed in ROUNDS:
        j._note_round(accepted, proposed)
        p._note_round(accepted, proposed)
        ks.append((j.k, p.k))
        ewmas.append((j._accept_ewma, p._accept_ewma))
    assert all(a == b for a, b in ks), ks
    assert all(a == b for a, b in ewmas), ewmas
    moved = len({a for a, _ in ks}) > 1
    assert moved == (k_min != k_max)
    gauges = telemetry.spec_metrics()
    assert gauges["draft_len"].value() == p.k
    assert gauges["accept_rate"].value() == p._accept_ewma
    assert any(line.startswith("kt_spec_draft_len ")
               for line in gauges["draft_len"].render())


CTOR_REFUSALS = [dict(temperature=0.7), dict(top_p=0.9),
                 dict(decode_block=2), dict(auto_prefix=True),
                 dict(spec_k=0), dict(spec_k=2, spec_k_min=3, spec_k_max=4)]


@pytest.mark.parametrize("kw", CTOR_REFUSALS,
                         ids=[next(iter(kw)) for kw in CTOR_REFUSALS])
def test_constructor_refusals_match_jax(target, draft, kw):
    with pytest.raises(Exception) as want:
        jax_engine(target, draft, **GRID, **kw)
    with pytest.raises(Exception) as got:
        pt_engine(target, draft, **GRID, **kw)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


SUBMIT_REFUSALS = [dict(temperature=0.5), dict(top_p=0.9),
                   dict(frequency_penalty=0.5), dict(presence_penalty=0.5),
                   dict(logit_bias={1: 2.0}), dict(seed=3),
                   dict(prefix_id=99), dict(max_new_tokens=20)]


@pytest.mark.parametrize("kw", SUBMIT_REFUSALS,
                         ids=[next(iter(kw)) for kw in SUBMIT_REFUSALS])
def test_submit_refusals_match_jax(target, draft, kw):
    """Sampling, steering and seeds are refused (the acceptance rule is
    the target's plain argmax); an unknown prefix is a KeyError; 8 + 20 +
    a verify window of 5 rows does not fit in 32."""
    kw = {"max_new_tokens": 3, **kw}
    grid = dict(spec_k=2, slots=2, max_len=32, prefill_buckets=(8,))
    with pytest.raises(Exception) as want:
        jax_engine(target, draft, **grid).submit([1] * 8, **kw)
    with pytest.raises(Exception) as got:
        pt_engine(target, draft, **grid).submit([1] * 8, **kw)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_registration_validation(target, draft):
    eng = pt_engine(target, draft, spec_k=2, slots=1, max_len=32,
                    prefill_buckets=(8,))
    with pytest.raises(ValueError, match="empty"):
        eng.register_prefix([])
    with pytest.raises(ValueError, match="max_len"):
        eng.register_prefix([1] * 32)
    small = dense(13, vocab_size=256, **DRAFT)
    with pytest.raises(ValueError, match="vocab_size"):
        pt_engine(target, small, **GRID)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_headroom_boundary(target, draft, with_prefix):
    """A request whose prefix width + prompt + budget + verify window is
    exactly max_len is admitted and runs to its last token (every window
    row inside the grid); one more token is refused. Self-draft, so the
    windows run at their widest on every round."""
    k, max_len = 2, 32
    prefix, prompt = [5, 17, 42], [9, 11, 3, 4, 8]

    def scenario(eng, side):
        kw, width = {}, 0
        if with_prefix:
            pid = kw["prefix_id"] = eng.register_prefix(prefix)
            # the prefix's stored width (its bucket)
            width = eng._prefixes[pid][0].shape[2]
        n = max_len - width - len(prompt) - (2 * k + 1)
        with pytest.raises(ValueError, match="verify window"):
            eng.submit(prompt, max_new_tokens=n + 1, **kw)
        return run(eng, (prompt, dict(max_new_tokens=n, **kw))), n

    eng, (got, n) = both(target, target, scenario, spec_k=k, slots=1,
                         max_len=max_len, prefill_buckets=(4, 8))
    full = (prefix if with_prefix else []) + prompt
    assert got == [solo(target, full, n)]
    assert eng.spec_stats.acceptance_rate == 1.0


def test_bounds_default_to_static(target):
    eng = pt_engine(target, target, spec_k=3, slots=1, max_len=64,
                    prefill_buckets=(8,), spec_adapt_every=1)
    run(eng, ([3, 4, 5], dict(max_new_tokens=16)))
    assert eng.k == eng.k_min == eng.k_max == 3


def test_perfect_draft_grows_k(target):
    eng = pt_engine(target, target, spec_k=2, spec_k_min=1, spec_k_max=4,
                    spec_adapt_every=1, slots=1, max_len=128,
                    prefill_buckets=(8,))
    assert run(eng, ([3, 4, 5], dict(max_new_tokens=24))) == [
        solo(target, [3, 4, 5], 24)]
    assert eng.k == 4


def test_bad_draft_shrinks_k(target, draft):
    eng = pt_engine(target, draft, spec_k=3, spec_k_min=1, spec_k_max=3,
                    spec_adapt_every=1, slots=1, max_len=128,
                    prefill_buckets=(8,))
    assert run(eng, ([7, 8, 9], dict(max_new_tokens=24))) == [
        solo(target, [7, 8, 9], 24)]
    assert eng.k == 1


@pytest.mark.parametrize("slots", [1, 3])
def test_shrink_after_full_accept(target, slots):
    """k shrinks right after a round in which a slot accepted all k
    proposals (self-draft, an acceptance EWMA preset low): that slot's
    next window holds k_old + 1 pending tokens, more than the new k + 1.
    The windows widen to the ledgers, and the tokens stay solo
    generate's. (The JAX engine sizes its windows from k alone and fails
    this round: ROADMAP Queue C.)"""
    prompts = [[3, 4, 5], [9, 8, 7], [1, 2]][:slots]
    eng = pt_engine(target, target, spec_k=3, spec_k_min=1, spec_k_max=3,
                    spec_adapt_every=1, slots=slots, max_len=64,
                    prefill_buckets=(8,))
    eng._accept_ewma = 0.0
    ks = []
    hs = [eng.submit(p, max_new_tokens=14) for p in prompts]
    while eng.step():
        ks.append(eng.k)
    assert [h.result(timeout=0) for h in hs] == [solo(target, p, 14)
                                                for p in prompts]
    assert ks[:2] == [2, 1]
    assert eng.spec_stats.acceptance_rate == 1.0


def test_env_bounds_and_gauges(target, monkeypatch):
    monkeypatch.setenv("KT_SPEC_K_MIN", "1")
    monkeypatch.setenv("KT_SPEC_K_MAX", "5")
    eng = pt_engine(target, target, spec_k=2, spec_adapt_every=1, slots=1,
                    max_len=128, prefill_buckets=(8,))
    assert (eng.k_min, eng.k_max) == (1, 5)
    run(eng, ([1, 2], dict(max_new_tokens=12)))
    gauges = telemetry.spec_metrics()
    assert gauges["draft_len"].value() == eng.k
    assert gauges["accept_rate"].value() > 0.9
