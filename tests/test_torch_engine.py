"""The port's continuous-batching engine (kubetorch_tpu_torch/serve) against
the JAX engine and against the port's own ``generate``, on ``tiny`` in
fp32 on the CPU. Greedy tokens must be equal, not close: both sides do the
same fp32 math, and a one-token difference would show a wrong position,
mask or cache row, not rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu_torch.models import generate as pt_gen
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.llama import LlamaConfig
from kubetorch_tpu_torch.serve import GenerationEngine
from kubetorch_tpu_torch.serve.engine import _decode_step_impl

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

PROMPTS = ([5, 17, 42], list(range(1, 101)), [9, 8], [300, 2, 7, 7, 1])
NEW = (6, 5, 7, 4)


@pytest.fixture(scope="module")
def tree():
    return np_params(JaxConfig.tiny(), seed=11)


@pytest.fixture(scope="module")
def params(tree):
    return params_from_numpy(tree, device="cpu")


def cfg(**kw):
    # "flash": bucketed prefills of 128 take the flash branch (its plain
    # version on the CPU); decode goes through the decode-attention wrapper
    kw.setdefault("attn_impl", "flash")
    return LlamaConfig.tiny(dtype=torch.float32, **kw)


def drive(eng, prompts=PROMPTS, new=NEW, **submit_kw):
    """Interleaved admission: two requests up front, then one more per
    step while the grid decodes (slots=2 makes later ones queue)."""
    hs = [eng.submit(p, max_new_tokens=n, **submit_kw)
          for p, n in zip(prompts[:2], new[:2])]
    rest = list(zip(prompts[2:], new[2:]))
    while True:
        if rest:
            p, n = rest.pop(0)
            hs.append(eng.submit(p, max_new_tokens=n, **submit_kw))
        if not eng.step() and not rest:
            break
    return [h.result(timeout=0) for h in hs]


def test_engine_greedy_tokens_equal_jax_engine_and_generate(tree, params):
    jcfg = JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla")
    jeng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, slots=2,
                     max_len=160, prefill_buckets=(8, 128))
    want = drive(jeng)
    eng = GenerationEngine(params, cfg(), slots=2, max_len=160,
                           prefill_buckets=(8, 128), device="cpu")
    got = drive(eng)
    assert got == want
    for p, n, toks in zip(PROMPTS, NEW, got):
        solo = pt_gen.generate(params, torch.tensor([p]), cfg(),
                               max_new_tokens=n)
        assert solo[0, len(p):].tolist() == toks
    s = eng.stats()
    assert (s.admitted_total, s.finished_total, s.active, s.queued) == (4, 4, 0, 0)
    assert s.tokens_generated == sum(NEW)


def test_decode_block_overshoot_past_max_len_is_unobservable(params):
    """Slots that retire mid-block keep decoding garbage; positions past
    S_max clamp instead of indexing out of bounds, and the tokens equal the
    one-step engine's."""
    prompts = ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [4, 4])
    new = (6, 3)      # the first ends at row 15 of a 16-row grid
    outs = []
    for block in (1, 4):
        eng = GenerationEngine(params, cfg(attn_impl="xla"), slots=2,
                               max_len=16, prefill_buckets=(16,),
                               decode_block=block, device="cpu")
        outs.append(drive(eng, prompts, new))
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == list(new)


def test_decode_step_clamps_positions(params):
    c = cfg(attn_impl="xla")
    cache = pt_gen.init_cache(c, 2, 8, device="cpu")
    freqs = torch.zeros(8, c.head_dim // 2, dtype=torch.complex64)
    logits = _decode_step_impl(params, cache, torch.tensor([9, 3], dtype=torch.int32),
                               torch.tensor([1, 2]), c, freqs)
    assert logits.shape == (2, c.vocab_size) and torch.isfinite(logits).all()


def test_seeded_request_same_tokens_in_any_slot(params):
    prompt = [3, 1, 4, 1, 5]
    eng = GenerationEngine(params, cfg(), slots=2, max_len=32,
                           prefill_buckets=(8,), device="cpu")
    alone = eng.submit(prompt, max_new_tokens=8, temperature=0.9, seed=1234)
    while eng.step():
        pass
    first = alone.result(timeout=0)
    # a neighbour in slot 0 (sampled, unseeded), the seeded one in slot 1
    eng2 = GenerationEngine(params, cfg(), slots=2, max_len=32,
                            prefill_buckets=(8,), device="cpu", seed=99,
                            decode_block=3)
    other = eng2.submit([7, 7, 7], max_new_tokens=10, temperature=1.0)
    eng2.step()
    second = eng2.submit(prompt, max_new_tokens=8, temperature=0.9, seed=1234)
    while eng2.step():
        pass
    assert second.result(timeout=0) == first
    assert len(other.result(timeout=0)) == 10


def test_top_p_and_logprobs(params):
    eng = GenerationEngine(params, cfg(), slots=2, max_len=32, top_p=0.5,
                           temperature=1.0, prefill_buckets=(8,), device="cpu")
    h = eng.submit([1, 2, 3], max_new_tokens=5, seed=0)
    g = eng.submit([1, 2, 3], max_new_tokens=5, temperature=0.0)
    while eng.step():
        pass
    assert len(h.result(timeout=0)) == 5
    g.result(timeout=0)
    lps = g.logprobs
    assert len(lps) == 5 and all(lp <= 0.0 for lp in lps)
    solo = pt_gen.generate(params, torch.tensor([[1, 2, 3]]), cfg(),
                           max_new_tokens=5)
    assert g.result(timeout=0) == solo[0, 3:].tolist()


def test_eos_stop_and_cancel(params):
    eng = GenerationEngine(params, cfg(), slots=2, max_len=32,
                           prefill_buckets=(8,), device="cpu")
    ref = eng.submit([5, 17, 42], max_new_tokens=6)
    while eng.step():
        pass
    toks = ref.result(timeout=0)
    eos = toks[2]
    stop = [9999, toks[3]], toks[2:4]       # a list of two stop sequences
    eng_eos = GenerationEngine(params, cfg(), slots=2, max_len=32,
                               prefill_buckets=(8,), eos_id=eos,
                               device="cpu")
    h_eos = eng_eos.submit([5, 17, 42], max_new_tokens=6)
    h_stop = eng.submit([5, 17, 42], max_new_tokens=6, stop=stop)
    h_cancel = eng.submit([1, 2], max_new_tokens=6)
    assert eng.cancel(h_cancel.request_id)
    assert not eng.cancel(h_cancel.request_id)
    while eng_eos.step() + eng.step():
        pass
    assert h_eos.result(timeout=0) == toks[:toks.index(eos) + 1]
    got = h_stop.result(timeout=0)
    # ends at the first place the generated tokens end with toks[2:4]
    end = next(i + 2 for i in range(len(toks) - 1) if toks[i:i + 2] == toks[2:4])
    assert got == toks[:end]
    assert h_cancel.result(timeout=0) == []


def test_background_loop_generate(params):
    eng = GenerationEngine(params, cfg(), slots=2, max_len=32,
                           prefill_buckets=(8,), device="cpu")
    try:
        out = eng.generate([5, 17, 42], max_new_tokens=4, timeout=60)
    finally:
        eng.stop()
    assert eng._thread is None
    solo = pt_gen.generate(params, torch.tensor([[5, 17, 42]]), cfg(),
                           max_new_tokens=4)
    assert out == solo[0, 3:].tolist()


def test_submit_validation(params):
    eng = GenerationEngine(params, cfg(), slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(1, 12)), max_new_tokens=6)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([1, 512], max_new_tokens=2)
    with pytest.raises(ValueError, match="top_p"):
        eng.submit([1], max_new_tokens=2, top_p=1.5)


@pytest.mark.parametrize("ctor_kw", [{"aot_cache": "cache"},
                                     {"mesh": object()}])
def test_unported_engine_knobs_raise(params, ctor_kw, tmp_path):
    """No engine knob is refused any more. ``aot_cache`` is ported
    (``serve/aot_cache.py``, held against JAX in
    ``tests/test_torch_aot_cache.py``): on the CPU the engine takes a cache
    and warms its buckets and decode block with no library to resolve. A
    mesh is ported, for quantized weight trees too: a quantized tree of
    plain tensors meets the mesh's layout check as any plain tree does
    (``ValueError``: every param must be a DTensor on the mesh), not a
    refusal of the feature. LoRA banks on a real mesh are held against the
    plain engine in ``tests/test_torch_mesh_serve.py`` and against JAX in
    ``tests/test_torch_mesh_lora_spec.py``."""
    from kubetorch_tpu_torch.models.quant import quantize_params
    if "aot_cache" in ctor_kw:
        from kubetorch_tpu_torch.serve.aot_cache import AOTCompileCache
        eng = GenerationEngine(params, cfg(), slots=1, max_len=16,
                               device="cpu",
                               aot_cache=AOTCompileCache(tmp_path))
        assert eng.aot_stats() == {"executables": len(eng._buckets) + 1}
        return
    with pytest.raises(ValueError, match="DTensor"):
        GenerationEngine(quantize_params(params), cfg(), slots=1, max_len=16,
                         device="cpu", **ctor_kw)


@pytest.mark.parametrize("submit_kw", [{"adapter_id": 1}])
def test_unported_request_knobs_raise(tree, params, submit_kw):
    """An adapter id the engine never registered fails as on the JAX
    engine: KeyError at submit and at register_prefix; an empty adapter
    tree fails registration with the JAX engine's error and type."""
    from kubetorch_tpu.models.lora import LoraConfig as JaxLoraConfig
    from kubetorch_tpu_torch.models.lora import LoraConfig
    jeng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree),
                     JaxConfig.tiny(dtype=jnp.float32, remat=False,
                                    attn_impl="xla"),
                     slots=1, max_len=16, prefill_buckets=(8,))
    eng = GenerationEngine(params, cfg(), slots=1, max_len=16, device="cpu")
    errors = []
    for e, lcfg in ((jeng, JaxLoraConfig()), (eng, LoraConfig())):
        with pytest.raises(KeyError, match="unknown adapter_id 1"):
            e.submit([1, 2], max_new_tokens=2, **submit_kw)
        with pytest.raises(KeyError, match="unknown adapter_id 1"):
            e.register_prefix([1, 2], **submit_kw)
        with pytest.raises(KeyError) as err:
            e.register_adapter({}, lcfg)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert not eng._prefixes and eng._banks is None


def test_engine_without_card_or_explicit_cpu_raises(params):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(params, cfg(), slots=1, max_len=16)


def test_params_on_another_device_raise(params):
    meta = {**params, "embed": params["embed"].to("meta")}
    with pytest.raises(ValueError, match="params are on"):
        GenerationEngine(meta, cfg(), slots=1, max_len=16, device="cpu")


def test_a_live_handle_holds_its_engines_grid(params):
    """A request handle references its engine, and with it the grid: a
    harness that keeps a handle (a loop variable) past ``del engine``
    keeps the grid's bytes allocated while the next engine allocates its
    own. This was the mesh engine's 2.14 GB "lower peak" on the card: the
    engine run first outlived its run through one handle. With the
    handles gone, the grid's bytes are freed."""
    import gc
    import weakref

    eng = GenerationEngine(params, cfg(), slots=2, max_len=32,
                           prefill_buckets=(8,), device="cpu")
    hs = [eng.submit(p, max_new_tokens=2) for p in (PROMPTS[0], PROMPTS[2])]
    while eng.step():
        pass
    for h in hs:
        h.result(timeout=0)
    grid = [weakref.ref(t) for t in eng._cache]
    c = cfg()
    # K and V: (layers, slots, max_len, KV heads, head dim) fp32 each
    assert sum(r().nbytes for r in grid) == 2 * (
        c.n_layers * 2 * 32 * c.n_kv_heads * c.head_dim * 4)
    del eng, hs
    gc.collect()
    assert all(r() is not None for r in grid)    # the loop variable h
    del h
    gc.collect()
    assert all(r() is None for r in grid)
