"""The port's engine request features against the JAX engine, on ``tiny`` in
fp32 on the CPU: cached prefixes (``register_prefix``/``prefix_id``,
``auto_prefix``), chunked prefill (``prefill_chunk``), frequency and
presence penalties and ``logit_bias``. Each scenario runs on the JAX engine
(``kubetorch_tpu.serve.GenerationEngine``) and on the port's, built from
the same numpy tree; greedy tokens must be equal, not close, and equal to
the port's ``generate`` of the whole prompt where the JAX package's own
tests hold them to its ``generate``. Sampled streams come from
``torch.Generator`` in the port, so sampled cases compare the port with
itself (chunked against one-shot). The suffix pass itself is held to JAX's
``_prefill_suffix`` on the same inputs: log-probabilities over the whole
vocab (the logits less their log-sum-exp) within 1e-5 relative L2, K/V rows
within 1e-5 per row.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.models.llama import llama_forward as jax_llama_forward
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.serve import engine as jax_engine_mod
from kubetorch_tpu_torch.models import generate as pt_gen
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.llama import LlamaConfig, rope_freqs
from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
from kubetorch_tpu_torch.serve import GenerationEngine, QuantKVCache
from kubetorch_tpu_torch.serve import engine as pt_engine_mod

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

SUFFIX_RTOL = 1e-5


@pytest.fixture(scope="module")
def tree():
    return np_params(JaxConfig.tiny(), seed=11)


@pytest.fixture(scope="module")
def params(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


JCFG = JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla")
# "flash": bucketed prefills of 128 take the flash branch (its plain version
# on the CPU); suffix passes take the plain masked attention, as in JAX
PCFG = LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")


def both(jparams, params, scenario, **engine_kw):
    """Run ``scenario(engine)`` on a JAX and a port engine built alike;
    their results must be equal. Returns the port's."""
    want = scenario(JaxEngine(jparams, JCFG, **engine_kw))
    got = scenario(GenerationEngine(params, PCFG, device="cpu", **engine_kw))
    assert got == want
    return got


def run(eng, *requests):
    """Submit (prompt, kwargs) pairs, step the engine dry, return tokens."""
    hs = [eng.submit(p, **kw) for p, kw in requests]
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def solo(params, prompt, n):
    out = pt_gen.generate(params, torch.tensor([prompt]), PCFG,
                          max_new_tokens=n)
    return out[0, len(prompt):].tolist()


GRIDS = [pytest.param(False, id="model_dtype_grid"),
         pytest.param(True, id="int8_grid")]


# ---------------------------------------------------------------------------
# the suffix pass
# ---------------------------------------------------------------------------


def test_prefill_suffix_matches_jax(tree, jparams, params):
    """One suffix pass behind a 5-token prefix in an 8-row bucket, a
    3-token suffix in a 4-row bucket, both sides fed the same prefix rows
    (JAX's prefill of the prefix). JAX's ``_prefill_suffix`` reports one
    log-probability per call, so it runs once per vocab entry under vmap,
    ``pen_row`` steering the choice to that entry."""
    prefix, suffix = [11, 12, 13, 14, 15], [21, 22, 23]
    key = jax.random.PRNGKey(0)
    zero = jnp.zeros((1,), jnp.float32)
    ppad = np.zeros((1, 8), np.int32)
    ppad[0, :5] = prefix
    _, pk, pv, _ = jax_engine_mod._prefill(jparams, jnp.asarray(ppad),
                                           jnp.int32(5), key, zero, JCFG)
    spad = np.zeros((1, 4), np.int32)
    spad[0, :3] = suffix

    def jax_suffix(pen_row=None):
        return jax_engine_mod._prefill_suffix(
            jparams, jnp.asarray(spad), jnp.int32(3), pk, pv, jnp.int32(5),
            key, zero, JCFG, pen_row=pen_row)

    first, jk, jv, _ = jax_suffix()
    vocab = JCFG.vocab_size
    steer = 1e30 * (1.0 - np.eye(vocab, dtype=np.float32))
    want_lp = np.asarray(jax.vmap(lambda r: jax_suffix(r)[3])(steer))[:, 0]

    logits, k, v = pt_engine_mod._prefill_suffix_logits(
        params, torch.from_numpy(spad).long(), 3,
        torch.from_numpy(np.array(pk)), torch.from_numpy(np.array(pv)), 5,
        PCFG, rope_freqs(PCFG, 12))
    got_lp = torch.log_softmax(logits, dim=-1)[0].numpy()
    rel = np.linalg.norm(got_lp - want_lp) / np.linalg.norm(want_lp)
    assert rel <= SUFFIX_RTOL, rel
    assert int(logits.argmax()) == int(first[0])
    assert k.shape == jk.shape == (PCFG.n_layers, 1, 12, PCFG.n_kv_heads,
                                   PCFG.head_dim)
    # rows 9-11 were never written (zeros on both sides): compare the rest
    for got, want in ((k, jk), (v, jv)):
        want = torch.from_numpy(np.array(want))
        assert row_rel_err(got[:, :, :9], want[:, :, :9]) <= SUFFIX_RTOL
        assert torch.equal(got[:, :, 9:], want[:, :, 9:])


# ---------------------------------------------------------------------------
# prefix cache (tests/test_serve_engine.py TestPrefixCache, TestPrefixLifecycle)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize_kv", GRIDS)
def test_prefix_cached_matches_full_prompt(jparams, params, quantize_kv):
    prefix = [11, 12, 13, 14, 15]
    suffixes = [[21, 22], [31, 32, 33]]

    def scenario(eng):
        pid = eng.register_prefix(prefix)
        return run(eng, *((s, dict(max_new_tokens=6, prefix_id=pid))
                          for s in suffixes))

    got = both(jparams, params, scenario, slots=2, max_len=64,
               prefill_buckets=(4, 8), quantize_kv=quantize_kv)
    if not quantize_kv:
        assert got == [solo(params, prefix + s, 6) for s in suffixes]


def test_prefix_and_plain_requests_interleave(jparams, params):
    def scenario(eng):
        pid = eng.register_prefix([50, 51, 52])
        return run(eng, ([60], dict(max_new_tokens=5, prefix_id=pid)),
                   ([1, 2, 3], dict(max_new_tokens=5)))

    got = both(jparams, params, scenario, slots=2, max_len=64,
               prefill_buckets=(4,))
    assert got == [solo(params, [50, 51, 52, 60], 5), solo(params, [1, 2, 3], 5)]


def test_prefix_validation(jparams, params):
    for eng in (JaxEngine(jparams, JCFG, slots=1, max_len=16,
                          prefill_buckets=(4,)),
                GenerationEngine(params, PCFG, slots=1, max_len=16,
                                 prefill_buckets=(4,), device="cpu")):
        with pytest.raises(KeyError):
            eng.submit([1], max_new_tokens=1, prefix_id=99)
        pid = eng.register_prefix([1, 2, 3, 4])
        with pytest.raises(ValueError, match=r"prefix bucket \(4\) \+ prompt "
                           r"\(8\) \+ max_new_tokens \(8\)"):
            eng.submit([1] * 8, max_new_tokens=8, prefix_id=pid)
        with pytest.raises(ValueError, match=r"prefix bucket \(0\)"):
            eng.submit([1] * 12, max_new_tokens=8)
        with pytest.raises(ValueError, match="empty prefix"):
            eng.register_prefix([])
        with pytest.raises(ValueError, match="room under max_len"):
            eng.register_prefix(list(range(16)))


def test_unregister_frees_and_queued_request_fails_cleanly(jparams, params):
    def scenario(eng):
        pid = eng.register_prefix([1, 2, 3])
        h_ok = eng.submit([4], max_new_tokens=3, prefix_id=pid)
        eng.step()                 # h_ok takes the only slot
        h_fail = eng.submit([5], max_new_tokens=3, prefix_id=pid)
        assert eng.unregister_prefix(pid) is True
        assert eng.unregister_prefix(pid) is False
        while eng.step():
            pass
        with pytest.raises(KeyError):
            h_fail.result(timeout=0)
        # the loop survived: plain requests still serve
        return [h_ok.result(timeout=0), run(eng, ([6, 7], dict(max_new_tokens=2)))]

    got = both(jparams, params, scenario, slots=1, max_len=64,
               prefill_buckets=(4,))
    assert got == [solo(params, [1, 2, 3, 4], 3), [solo(params, [6, 7], 2)]]


def test_prefix_in_oversized_bucket_config(jparams, params):
    """The only bucket is max_len: the stored rows trim to the prefix's
    exact length instead of eating the whole budget."""
    def scenario(eng):
        pid = eng.register_prefix([11, 12, 13])
        assert eng._prefixes[pid][0].shape[2] == 3
        return run(eng, ([60], dict(max_new_tokens=4, prefix_id=pid)))

    got = both(jparams, params, scenario, slots=1, max_len=16,
               prefill_buckets=(16,))
    assert got == [solo(params, [11, 12, 13, 60], 4)]


@pytest.mark.parametrize("chunk", [None, 2])
def test_stored_prefix_rows_unchanged_after_use(params, chunk):
    eng = GenerationEngine(params, PCFG, slots=2, max_len=64,
                           prefill_buckets=(4, 8), prefill_chunk=chunk,
                           device="cpu")
    pid = eng.register_prefix([11, 12, 13, 14, 15])
    pref = eng._prefixes[pid]
    keep = pref.k.clone(), pref.v.clone()
    got = run(eng, ([21, 22, 23], dict(max_new_tokens=4, prefix_id=pid)),
              ([31, 32], dict(max_new_tokens=4, prefix_id=pid)))
    assert torch.equal(pref.k, keep[0]) and torch.equal(pref.v, keep[1])
    assert eng._prefix_hits == 2
    assert got == [solo(params, [11, 12, 13, 14, 15, 21, 22, 23], 4),
                   solo(params, [11, 12, 13, 14, 15, 31, 32], 4)]


# ---------------------------------------------------------------------------
# auto_prefix (tests/test_serve_engine.py TestAutoPrefix)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize_kv", GRIDS)
def test_auto_prefix_longest_match_reused_and_exact(jparams, params,
                                                    quantize_kv):
    short, long, tail = [5, 17], [5, 17, 42, 7], [9, 11]

    def scenario(eng):
        eng.register_prefix(short)
        pid_long = eng.register_prefix(long)
        first = run(eng, (long + tail, dict(max_new_tokens=6)))
        hits = eng._prefix_hits
        second = run(eng, ([5, 17, 200], dict(max_new_tokens=4)))
        assert eng.unregister_prefix(pid_long)
        return first + second + [hits, eng._prefix_hits]

    got = both(jparams, params, scenario, slots=2, max_len=64,
               prefill_buckets=(4, 8), auto_prefix=True,
               quantize_kv=quantize_kv)
    assert got[2:] == [1, 2]
    if not quantize_kv:
        assert got[:2] == [solo(params, long + tail, 6),
                           solo(params, [5, 17, 200], 4)]


def test_auto_prefix_no_match_and_exact_equal_prompt_fall_back(jparams,
                                                               params):
    def scenario(eng):
        eng.register_prefix([5, 17, 42])
        # a prompt equal to the prefix leaves no suffix: full prefill
        return run(eng, ([5, 17, 42], dict(max_new_tokens=4)),
                   ([9, 9], dict(max_new_tokens=3))) + [eng._prefix_hits]

    got = both(jparams, params, scenario, slots=1, max_len=64,
               prefill_buckets=(4,), auto_prefix=True)
    assert got == [solo(params, [5, 17, 42], 4), solo(params, [9, 9], 3), 0]


def test_auto_prefix_eviction_between_submit_and_admission(jparams, params):
    def scenario(eng):
        pid = eng.register_prefix([5, 17, 42])
        blocker = eng.submit([8, 8], max_new_tokens=3)     # holds slot 0
        h = eng.submit([5, 17, 42, 9], max_new_tokens=4)   # queued, matched
        eng.unregister_prefix(pid)                          # evicted
        while eng.step():
            pass
        return [blocker.result(timeout=0), h.result(timeout=0),
                eng._prefix_hits]

    got = both(jparams, params, scenario, slots=1, max_len=64,
               prefill_buckets=(4, 8), auto_prefix=True)
    assert got == [solo(params, [8, 8], 3), solo(params, [5, 17, 42, 9], 4), 0]


# ---------------------------------------------------------------------------
# chunked prefill (tests/test_serve_engine.py TestChunkedPrefill)
# ---------------------------------------------------------------------------


def test_chunked_long_prompt_exact_with_active_neighbor(jparams, params):
    long_prompt = list(range(5, 16))               # 11 tokens: 4 + 4 + 3

    def scenario(eng):
        return run(eng, ([1, 2], dict(max_new_tokens=8)),
                   (long_prompt, dict(max_new_tokens=6)))

    got = both(jparams, params, scenario, slots=2, max_len=64,
               prefill_buckets=(4, 16), prefill_chunk=4, decode_block=2)
    assert got == [solo(params, [1, 2], 8), solo(params, long_prompt, 6)]


def test_chunked_short_prompt_still_one_shot(jparams, params):
    got = both(jparams, params,
               lambda eng: run(eng, ([7, 8], dict(max_new_tokens=4))),
               slots=1, max_len=32, prefill_buckets=(4,), prefill_chunk=4)
    assert got == [solo(params, [7, 8], 4)]


@pytest.mark.parametrize("quantize_kv", GRIDS)
def test_chunked_behind_registered_prefix(jparams, params, quantize_kv):
    prefix, suffix = [5, 17, 42], list(range(30, 39))   # 9: 4 + 4 + 1

    def scenario(eng):
        eng.register_prefix(prefix)
        return run(eng, (prefix + suffix, dict(max_new_tokens=5))) + [
            eng._prefix_hits]

    got = both(jparams, params, scenario, slots=1, max_len=64,
               prefill_buckets=(4, 8), prefill_chunk=4, auto_prefix=True,
               quantize_kv=quantize_kv)
    assert got[1] == 1
    if not quantize_kv:
        assert got[0] == solo(params, prefix + suffix, 5)


@pytest.mark.parametrize("quantize_kv", GRIDS)
def test_chunked_matches_one_shot(jparams, params, quantize_kv):
    long_prompt = list(range(5, 14))
    runs = [both(jparams, params,
                 lambda eng: run(eng, (long_prompt, dict(max_new_tokens=6))),
                 slots=1, max_len=64, prefill_buckets=(4, 16),
                 prefill_chunk=chunk, quantize_kv=quantize_kv)
            for chunk in (None, 4)]
    assert runs[0] == runs[1]


def test_chunked_penalties_match_one_shot(jparams, params):
    long_prompt = list(range(50, 60))
    kw = dict(max_new_tokens=8, frequency_penalty=0.7, presence_penalty=0.3)
    runs = [both(jparams, params, lambda eng: run(eng, (long_prompt, kw)),
                 slots=1, max_len=64, prefill_buckets=(4, 16),
                 prefill_chunk=chunk)
            for chunk in (None, 4)]
    assert runs[0] == runs[1]


def test_cancel_mid_chunking(jparams, params):
    def scenario(eng):
        nbr = eng.submit([1, 2], max_new_tokens=6)
        h = eng.submit(list(range(5, 16)), max_new_tokens=6)
        eng.step()                       # chunk 1 ran; admission in flight
        assert eng.stats().queued == 1
        assert h.cancel() is True
        assert h.cancel() is False
        while eng.step():
            pass
        # the reserved slot was released: a new request admits and runs
        return [nbr.result(timeout=0), h.result(timeout=0),
                run(eng, ([9], dict(max_new_tokens=3)))]

    got = both(jparams, params, scenario, slots=2, max_len=64,
               prefill_buckets=(4, 16), prefill_chunk=4)
    assert got == [solo(params, [1, 2], 6), [], [solo(params, [9], 3)]]


def test_chunked_sampled_mode_matches_one_shot(params):
    """A chunk that samples nothing draws nothing from the request's
    generator: a sampled request decodes the same tokens chunked or not
    (its first token's logits agree to rounding)."""
    long_prompt = list(range(40, 51))
    runs = []
    for chunk in (None, 4):
        eng = GenerationEngine(params, PCFG, slots=1, max_len=64,
                               prefill_buckets=(4, 16), prefill_chunk=chunk,
                               seed=11, device="cpu")
        runs.append(run(eng, (long_prompt, dict(max_new_tokens=8,
                                                temperature=0.9, top_p=0.8))))
    assert runs[0] == runs[1]


def test_chunked_fills_to_exact_max_len(jparams, params):
    """29 tokens in chunks of 8: the last chunk's padding rows reach
    position 31 + 3 = max_len + 2, inside the accumulator's max_len + C
    rows and the RoPE table."""
    prompt = list(range(1, 30))
    got = both(jparams, params,
               lambda eng: run(eng, (prompt, dict(max_new_tokens=1))),
               slots=1, max_len=32, prefill_buckets=(4, 32), prefill_chunk=8)
    assert got == [solo(params, prompt, 1)]


def test_chunked_prefix_plus_long_suffix_at_boundary(jparams, params):
    prefix, suffix = [5, 17, 42], list(range(100, 159))   # 4 + 59 + 1 = 64

    def scenario(eng):
        eng.register_prefix(prefix)
        return run(eng, (prefix + suffix, dict(max_new_tokens=1))) + [
            eng._prefix_hits]

    got = both(jparams, params, scenario, slots=1, max_len=64,
               prefill_buckets=(4,), prefill_chunk=8, auto_prefix=True)
    assert got == [solo(params, prefix + suffix, 1), 1]


def test_two_long_prompts_queue_for_the_chunker(jparams, params,
                                                monkeypatch):
    """A second long prompt waits for the chunker; every from-zero prefill
    ran at the chunk's width (a one-shot fallback would show 16)."""
    widths = []
    real = pt_engine_mod._prefill_logits

    def spy(params_, tokens, *a, **kw):
        widths.append(tokens.shape[1])
        return real(params_, tokens, *a, **kw)

    monkeypatch.setattr(pt_engine_mod, "_prefill_logits", spy)
    p1, p2 = list(range(5, 16)), list(range(60, 73))
    got = both(jparams, params,
               lambda eng: run(eng, (p1, dict(max_new_tokens=5)),
                               (p2, dict(max_new_tokens=5))),
               slots=4, max_len=64, prefill_buckets=(4, 16), prefill_chunk=4)
    assert got == [solo(params, p1, 5), solo(params, p2, 5)]
    assert widths == [4, 4], widths


def test_prefill_chunk_validation(params):
    with pytest.raises(ValueError, match="prefill_chunk"):
        GenerationEngine(params, PCFG, slots=1, max_len=16,
                         prefill_chunk=0, device="cpu")


# ---------------------------------------------------------------------------
# logit_bias (tests/test_serve_engine.py TestLogitBias)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decode_block", [1, 4])
def test_positive_bias_forces_token(jparams, params, decode_block):
    prompt = [5, 17, 42]
    forced = (solo(params, prompt, 1)[0] + 123) % PCFG.vocab_size
    got = both(jparams, params,
               lambda eng: run(eng, (prompt, dict(
                   max_new_tokens=6, logit_bias={forced: 1000.0}))),
               slots=2, max_len=64, prefill_buckets=(4,),
               decode_block=decode_block)
    assert got == [[forced] * 6]


def test_negative_bias_suppresses_token(jparams, params):
    prompt = [5, 17, 42]
    want = solo(params, prompt, 6)
    got = both(jparams, params,
               lambda eng: run(eng, (prompt, dict(
                   max_new_tokens=6, logit_bias={want[0]: -1000.0}))),
               slots=1, max_len=64, prefill_buckets=(4,))
    assert want[0] not in got[0] and got[0] != want


def test_bias_is_slot_isolated_and_cleared_on_reuse(jparams, params):
    prompt = [5, 17, 42]
    want = solo(params, prompt, 6)
    forced = (want[0] + 7) % PCFG.vocab_size

    def scenario(eng):
        first = run(eng, (prompt, dict(max_new_tokens=6,
                                       logit_bias={forced: 1000.0})),
                    (prompt, dict(max_new_tokens=6)))
        return first + run(eng, (prompt, dict(max_new_tokens=6)),
                           (prompt, dict(max_new_tokens=6)))

    got = both(jparams, params, scenario, slots=2, max_len=64,
               prefill_buckets=(4,))
    assert got == [[forced] * 6, want, want, want]


@pytest.mark.parametrize("decode_block", [1, 4])
def test_bias_block_path_matches_one_step(jparams, params, decode_block):
    got = both(jparams, params,
               lambda eng: run(eng, ([9, 9, 9], dict(
                   max_new_tokens=7, logit_bias={3: 5.0, 11: -5.0}))),
               slots=1, max_len=64, prefill_buckets=(4,),
               decode_block=decode_block)
    one = GenerationEngine(params, PCFG, slots=1, max_len=64,
                           prefill_buckets=(4,), device="cpu")
    assert got == run(one, ([9, 9, 9], dict(max_new_tokens=7,
                                            logit_bias={3: 5.0, 11: -5.0})))


@pytest.mark.parametrize("bias,match", [
    ({PCFG.vocab_size + 5: 1.0}, "vocab"), ({-1: 1.0}, "vocab"),
    ({3: math.inf}, "finite"), ({3: math.nan}, "finite")])
def test_bias_validation(jparams, params, bias, match):
    for eng in (JaxEngine(jparams, JCFG, slots=1, max_len=32),
                GenerationEngine(params, PCFG, slots=1, max_len=32,
                                 device="cpu")):
        with pytest.raises(ValueError, match=match):
            eng.submit([1, 2], max_new_tokens=2, logit_bias=bias)


# ---------------------------------------------------------------------------
# repetition penalties (tests/test_sampling.py TestRepetitionPenalties,
# tests/test_serve_engine.py test_block_penalties_match_one_step)
# ---------------------------------------------------------------------------


def test_block_penalties_match_one_step(jparams, params):
    reqs = (([5, 17, 42, 99], dict(max_new_tokens=10, frequency_penalty=0.8)),
            ([1, 2], dict(max_new_tokens=6, presence_penalty=1.1)))
    runs = [both(jparams, params, lambda eng: run(eng, *reqs), slots=2,
                 max_len=64, prefill_buckets=(4,), decode_block=block)
            for block in (1, 4)]
    assert runs[0] == runs[1]
    # the penalties bit: the penalized stream differs from the plain one
    assert runs[0][0] != solo(params, [5, 17, 42, 99], 10)


@pytest.mark.parametrize("decode_block", [1, 4])
def test_huge_presence_penalty_never_repeats(jparams, params, decode_block):
    prompt = [5, 17, 42]
    got = both(jparams, params,
               lambda eng: run(eng, (prompt, dict(max_new_tokens=10,
                                                  presence_penalty=1e9))),
               slots=1, max_len=64, prefill_buckets=(8,),
               decode_block=decode_block)[0]
    seen = set(prompt)
    for t in got:
        assert t not in seen, (t, got)
        seen.add(t)


@pytest.mark.parametrize("decode_block", [1, 4])
def test_zero_penalty_neighbor_is_bit_exact(params, decode_block):
    """Tokens and logprobs of an unpenalized, unbiased neighbour equal a
    run without the penalized and biased requests, bit for bit."""
    def neighbour(with_others):
        eng = GenerationEngine(params, PCFG, slots=3, max_len=64,
                               prefill_buckets=(8,), decode_block=decode_block,
                               device="cpu")
        h = eng.submit([100, 200, 300], max_new_tokens=6)
        if with_others:
            eng.submit([7, 8, 9], max_new_tokens=6, frequency_penalty=5.0)
            eng.submit([7, 8], max_new_tokens=6, logit_bias={4: 3.0})
        while eng.step():
            pass
        return h.result(timeout=0), h.logprobs

    alone, beside = neighbour(False), neighbour(True)
    assert beside == alone
    assert alone[0] == solo(params, [100, 200, 300], 6)


def test_first_token_respects_prompt_counts(jparams, params):
    prompt = [4, 4, 4]
    prompt2 = prompt + solo(params, prompt, 1)
    got = both(jparams, params,
               lambda eng: run(eng, (prompt2, dict(max_new_tokens=3,
                                                   presence_penalty=1e9))),
               slots=1, max_len=64, prefill_buckets=(8,))
    assert got[0][0] not in set(prompt2)


def test_slot_reuse_clears_penalties(jparams, params):
    def scenario(eng):
        return run(eng, ([9, 9], dict(max_new_tokens=4,
                                      frequency_penalty=3.0))) + run(
            eng, ([1, 2, 3], dict(max_new_tokens=5)))

    got = both(jparams, params, scenario, slots=1, max_len=64,
               prefill_buckets=(8,))
    assert got[1] == solo(params, [1, 2, 3], 5)


def test_penalties_behind_a_prefix_count_the_prefix(jparams, params):
    """The prefix is text so far: under a huge presence penalty no token of
    the prefix, the suffix or the completion repeats."""
    prefix, suffix = [5, 17, 42, 7], [9, 11]

    def scenario(eng):
        pid = eng.register_prefix(prefix)
        return run(eng, (suffix, dict(max_new_tokens=8, prefix_id=pid,
                                      presence_penalty=1e9)))

    got = both(jparams, params, scenario, slots=1, max_len=64,
               prefill_buckets=(4, 8))[0]
    seen = set(prefix + suffix)
    for t in got:
        assert t not in seen
        seen.add(t)


def test_logprobs_stay_raw_under_penalties(jparams, params):
    """Penalties steer the choice; each reported logprob is the raw model's
    score of the chosen token (JAX's forward over the whole sequence)."""
    prompt = [5, 17, 42]
    eng = GenerationEngine(params, PCFG, slots=1, max_len=64,
                           prefill_buckets=(8,), device="cpu")
    h = eng.submit(prompt, max_new_tokens=5, presence_penalty=1e9,
                   logit_bias={3: 2.0})
    while eng.step():
        pass
    toks = h.result(timeout=0)
    logits = np.asarray(jax_llama_forward(
        jparams, jnp.asarray([prompt + toks], jnp.int32), JCFG))
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    for i, (t, lp) in enumerate(zip(toks, h.logprobs)):
        assert abs(lp - logp[0, len(prompt) - 1 + i, t]) < 1e-4, i


# ---------------------------------------------------------------------------
# int8 grid with a prefix (tests/test_kv_quant.py, the prefix half of
# test_quantized_with_prefix_and_lora)
# ---------------------------------------------------------------------------


def test_quantized_grid_with_prefix(jparams, params):
    def scenario(eng):
        pid = eng.register_prefix([11, 12, 13])
        return run(eng, ([60, 61], dict(max_new_tokens=4, prefix_id=pid)),
                   ([4, 4], dict(max_new_tokens=5)))

    got = both(jparams, params, scenario, slots=2, max_len=64,
               prefill_buckets=(8,), quantize_kv=True)
    assert [len(g) for g in got] == [4, 5]


def test_quantized_prefix_rows_quantize_at_the_splice(params):
    """Prefix rows stay in the model dtype; the slot's int8 rows are the
    suffix pass's rows quantized at the splice."""
    from kubetorch_tpu_torch.serve import quantize_rows
    eng = GenerationEngine(params, PCFG, slots=1, max_len=64,
                           prefill_buckets=(8,), quantize_kv=True,
                           device="cpu")
    assert isinstance(eng._cache, QuantKVCache)
    pid = eng.register_prefix([11, 12, 13])
    pref = eng._prefixes[pid]
    assert pref.k.dtype == PCFG.dtype
    h = eng.submit([60, 61], max_new_tokens=1, prefix_id=pid)
    while eng.step():
        pass
    h.result(timeout=0)
    padded = torch.zeros((1, 8), dtype=torch.long)
    padded[0, :2] = torch.tensor([60, 61])
    _, k, v = pt_engine_mod._prefill_suffix_logits(
        params, padded, 2, pref.k, pref.v, 3, PCFG, eng._freqs)
    kq, ks = quantize_rows(k[:, 0])
    assert torch.equal(eng._cache.kq[:, 0, :16], kq)
    assert torch.equal(eng._cache.ks[:, 0, :16], ks)


def test_generate_passes_request_features(params):
    eng = GenerationEngine(params, PCFG, slots=1, max_len=64,
                           prefill_buckets=(8,), device="cpu")
    pid = eng.register_prefix([11, 12, 13])
    try:
        out = eng.generate([60], max_new_tokens=4, timeout=60, prefix_id=pid,
                           logit_bias={5: 1000.0})
    finally:
        eng.stop()
    assert out == [5] * 4
    assert eng._prefix_hits == 1


def test_chunked_rows_match_one_shot_rows(params):
    """The slot's rows after a chunked admission equal a one-shot
    prefill's, at every layer, within the fp32 row tolerance."""
    prompt = list(range(5, 16))
    rows = []
    for chunk in (None, 4):
        eng = GenerationEngine(params, PCFG, slots=1, max_len=32,
                               prefill_buckets=(16,), prefill_chunk=chunk,
                               device="cpu")
        h = eng.submit(prompt, max_new_tokens=1)
        while eng.step():
            pass
        h.result(timeout=0)
        rows.append((eng._cache.k[:, 0, :11].clone(),
                     eng._cache.v[:, 0, :11].clone()))
    for got, want in zip(rows[1], rows[0]):
        assert row_rel_err(got, want) <= ROW_RTOL[torch.float32]
