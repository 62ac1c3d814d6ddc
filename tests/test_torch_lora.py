"""The port's LoRA serving (kubetorch_tpu_torch/models/lora.py and the
engine's adapter banks) against the JAX package on Llama ``tiny``, fp32,
on the CPU. Base weights come from numpy with a seed; adapters are JAX
``lora_init`` factors with B drawn at random (``lora_init``'s zero B
would make every check vacuous), carried across with
``params_from_numpy``.

Tolerances:

- ``merge_lora``, ``lora_delta``, ``lora_proj``: 1e-5 absolute (fp32,
  outputs of order 1, differing only in the order of fp32 sums); over an
  int4 leaf, per row ``ops/tolerance.py``'s fp32 1e-4, as the plain int4
  matmul is held to the Pallas kernel. ``gather_slot_adapters``: equal.
- Engines: identical greedy tokens. A base request beside adapters is
  bit-identical, logprobs included, to an engine without banks: the zero
  adapter adds exactly 0.0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import lora as jl
from kubetorch_tpu.models import quant as jq
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu_torch.models import generate as pt_gen
from kubetorch_tpu_torch.models import lora as pl
from kubetorch_tpu_torch.models import quant as pq
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
from kubetorch_tpu_torch.ops import quant_matmul as ops_q4
from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
from kubetorch_tpu_torch.serve import GenerationEngine
from kubetorch_tpu_torch.serve import engine as engine_mod

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

TOL = 1e-5
NARROW = dict(dim=256, ffn_dim=512, n_heads=4, n_kv_heads=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(**kw):
    return JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla", **kw)


def _pcfg(**kw):
    kw.setdefault("attn_impl", "flash")
    return LlamaConfig.tiny(dtype=torch.float32, **kw)


def _rand_adapters(seed, jparams, lcfg, scale=0.05):
    """JAX ``lora_init`` factors with B drawn at random: a distinct,
    non-trivial adapter per seed (numpy tree)."""
    adap = _np(jl.lora_init(jax.random.PRNGKey(seed), jparams, lcfg))
    rng = np.random.default_rng(seed + 1000)
    adap["layers"] = {k: (v if k.endswith("__a") else
                          (rng.standard_normal(v.shape) * scale).astype(v.dtype))
                      for k, v in adap["layers"].items()}
    return adap


@pytest.fixture(scope="module")
def base():
    tree = np_params(_jcfg(), seed=11)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def bank(base):
    jp, _ = base
    lcfg = jl.LoraConfig(rank=4)
    return lcfg, _rand_adapters(7, jp, lcfg), _rand_adapters(8, jp, lcfg)


def _pt(adapters):
    return params_from_numpy(adapters, device="cpu")


def _plcfg(lcfg):
    return pl.LoraConfig(rank=lcfg.rank, alpha=lcfg.alpha,
                         targets=tuple(lcfg.targets))


# ---------------------------------------------------------------------------
# the module's functions
# ---------------------------------------------------------------------------


def test_lora_init_shapes_zero_b_and_errors(base):
    _, pp = base
    lcfg = pl.LoraConfig(rank=4, targets=("wq", "wv"))
    ad = pl.lora_init(pp, lcfg, seed=3)
    assert sorted(ad["layers"]) == ["wq__a", "wq__b", "wv__a", "wv__b"]
    L, d = 2, 64
    assert ad["layers"]["wq__a"].shape == (L, d, 4)
    assert ad["layers"]["wv__b"].shape == (L, 4, pp["layers"]["wv"].shape[-1])
    assert not ad["layers"]["wq__b"].any() and ad["layers"]["wq__a"].std() > 0
    merged = pl.merge_lora(pp, ad, lcfg)
    for t in ("wq", "wv"):
        assert torch.equal(merged["layers"][t], pp["layers"][t])
    assert merged["layers"]["wk"] is pp["layers"]["wk"]
    # A factors (L, 64, 4) twice, B factors (L, 4, 64) for wq, (L, 4, 32)
    # for wv
    assert pl.adapter_count(ad) == 2 * (L * d * 4) + L * 4 * 64 + L * 4 * 32
    with pytest.raises(KeyError, match="w_nope"):
        pl.lora_init(pp, pl.LoraConfig(targets=("w_nope",)))
    with pytest.raises(ValueError, match="quantized"):
        pl.lora_init(pq.quantize_params(pp), lcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_equals_jax(base, bank, dtype):
    jp, pp = base
    lcfg, ad, _ = bank
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), jp)
    pp = {**pp, "layers": {k: v.to(pdt) for k, v in pp["layers"].items()}}
    jad = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), ad)
    pad = {"layers": {k: v.to(pdt) for k, v in _pt(ad)["layers"].items()}}
    want = jl.merge_lora(jp, jad, lcfg)["layers"]
    got = pl.merge_lora(pp, pad, _plcfg(lcfg))["layers"]
    for t in lcfg.targets:
        assert got[t].dtype == pdt
        w = np.asarray(want[t].astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got[t].numpy(), w, atol=TOL)
        else:
            # the fp32 sums may round to neighbouring bf16 values
            np.testing.assert_allclose(got[t].float().numpy(), w, rtol=2 ** -7,
                                       atol=1e-6)


def test_lora_delta_both_layouts_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    a2, b2 = (rng.standard_normal((64, 4)).astype(np.float32),
              rng.standard_normal((4, 32)).astype(np.float32))
    a3, b3 = (rng.standard_normal((3, 64, 4)).astype(np.float32),
              rng.standard_normal((3, 4, 32)).astype(np.float32))
    for a, b in ((a2, b2), (a3, b3)):
        want = jl.lora_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), 0.5)
        got = pl.lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                            torch.from_numpy(b), 0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # the activation type comes back; zero factors add exactly zero
    xb = torch.from_numpy(x).bfloat16()
    z = pl.lora_delta(xb, torch.zeros(3, 64, 4), torch.zeros(3, 4, 32), 2.0)
    assert z.dtype == torch.bfloat16 and not z.any()


@pytest.mark.parametrize("leaf", ["plain", "int4"])
def test_lora_proj_equals_jax(monkeypatch, leaf):
    """Over a plain weight and a packed-int4 one (which ``wdot`` takes to
    B3's plain version, as JAX takes it to its Pallas kernel)."""
    calls = []
    real = ops_q4.q4_matmul
    monkeypatch.setattr(ops_q4, "q4_matmul",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 512)) / 16).astype(np.float32)
    a = rng.standard_normal((256, 8)).astype(np.float32) / 16
    b = rng.standard_normal((8, 512)).astype(np.float32) / 4
    jw = jnp.asarray(w) if leaf == "plain" else jq._quantize_leaf_int4(jnp.asarray(w))
    pw = params_from_numpy(_np(jw), device="cpu")
    jlora = ({"wq": (jnp.asarray(a), jnp.asarray(b))}, 2.0)
    plora = ({"wq": (torch.from_numpy(a), torch.from_numpy(b))}, 2.0)
    for target in ("wq", "wk"):            # wk carries no factors here
        want = np.asarray(jl.lora_proj(jnp.asarray(x), jw, jlora, target))
        got = pl.lora_proj(torch.from_numpy(x), pw, plora, target)
        if leaf == "plain":
            np.testing.assert_allclose(got.numpy(), want, atol=TOL)
        else:
            assert row_rel_err(got, torch.from_numpy(want.copy())) <= ROW_RTOL[torch.float32]
    assert len(calls) == (2 if leaf == "int4" else 0)
    assert torch.equal(pl.lora_proj(torch.from_numpy(x), pw, None, "wq"),
                       pq.wdot(torch.from_numpy(x), pw))


def test_gather_slot_adapters_equals_jax():
    rng = np.random.default_rng(2)
    bank = {"wq": (rng.standard_normal((3, 16, 4)).astype(np.float32),
                   rng.standard_normal((3, 4, 8)).astype(np.float32))}
    aidx = np.array([0, 2, 2, 1])
    want, ws = jl.gather_slot_adapters(
        {t: tuple(map(jnp.asarray, ab)) for t, ab in bank.items()},
        jnp.asarray(aidx), 0.5, True)
    got, gs = pl.gather_slot_adapters(
        {t: tuple(map(torch.from_numpy, ab)) for t, ab in bank.items()},
        torch.from_numpy(aidx), 0.5, True)
    assert gs == ws
    for i in range(2):
        np.testing.assert_array_equal(got["wq"][i].numpy(), np.asarray(want["wq"][i]))
    assert pl.gather_slot_adapters({}, torch.from_numpy(aidx), 0.5, None) is None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engine(base, bank, make=GenerationEngine, slots=4, **kw):
    jp, pp = base
    lcfg, ad_a, ad_b = bank
    if make is JaxEngine:
        eng = JaxEngine(jp, _jcfg(), slots=slots, max_len=64,
                        prefill_buckets=(8,), **kw)
        ida = eng.register_adapter(ad_a, lcfg)
        idb = eng.register_adapter(ad_b, lcfg)
    else:
        eng = GenerationEngine(pp, _pcfg(), slots=slots, max_len=64,
                               prefill_buckets=(8,), device="cpu", **kw)
        ida = eng.register_adapter(_pt(ad_a), _plcfg(lcfg))
        idb = eng.register_adapter(_pt(ad_b), _plcfg(lcfg))
    return eng, ida, idb


def _finish(eng, handles):
    while eng.step():
        pass
    return [h.result(timeout=0) for h in handles]


def _mixed(eng, ida, idb):
    """Base, adapter A and adapter B side by side, one more admitted while
    the others decode."""
    hs = [eng.submit([7, 8, 9], max_new_tokens=6),
          eng.submit([5, 17, 42], max_new_tokens=6, adapter_id=ida),
          eng.submit([9, 9, 2, 30], max_new_tokens=8, adapter_id=idb)]
    eng.step()
    hs.append(eng.submit([3, 1, 4, 1, 5], max_new_tokens=5, adapter_id=ida))
    return _finish(eng, hs)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_engine_tokens_equal_jax_engine(base, bank, kv):
    """The same adapters carried across: base, A and B side by side give
    the JAX engine's tokens, over the model-dtype grid and the int8 one."""
    kw = {"quantize_kv": kv == "int8"}
    want = _mixed(*_engine(base, bank, JaxEngine, **kw))
    got = _mixed(*_engine(base, bank, **kw))
    assert got == want
    # the adapters do something: A's request differs from the same base one
    plain = GenerationEngine(base[1], _pcfg(), slots=4, max_len=64,
                             prefill_buckets=(8,), device="cpu", **kw)
    assert _finish(plain, [plain.submit([5, 17, 42], max_new_tokens=6)])[0] != got[1]


def test_engine_lora_over_int4_base_equals_jax_engine():
    """LoRA over packed-int4 projections (through ``q4_matmul``) with an
    int8 grid, on the narrow Llama whose projections all tile."""
    tree = np_params(_jcfg(**NARROW), seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    lcfg = jl.LoraConfig(rank=4)
    ad_a, ad_b = _rand_adapters(7, jp, lcfg), _rand_adapters(8, jp, lcfg)
    jq4 = jq.quantize_params_int4(jp)
    pq4 = params_from_numpy(_np(jq4), device="cpu")
    jeng = JaxEngine(jq4, _jcfg(**NARROW), slots=4, max_len=64,
                     prefill_buckets=(8,), quantize_kv=True)
    peng = GenerationEngine(pq4, _pcfg(**NARROW), slots=4, max_len=64,
                            prefill_buckets=(8,), quantize_kv=True,
                            device="cpu")
    want = _mixed(jeng, jeng.register_adapter(ad_a, lcfg),
                  jeng.register_adapter(ad_b, lcfg))
    got = _mixed(peng, peng.register_adapter(_pt(ad_a), _plcfg(lcfg)),
                 peng.register_adapter(_pt(ad_b), _plcfg(lcfg)))
    assert got == want


def test_adapter_beside_base_is_bit_identical(base, bank):
    """A base request on an engine with banks (index 0, the zero adapter)
    gives the same tokens and logprobs, bit for bit, as on an engine
    without banks, and as ``generate``."""
    _, pp = base
    prompt, n = [7, 8, 9], 6
    plain = GenerationEngine(pp, _pcfg(), slots=4, max_len=64,
                             prefill_buckets=(8,), device="cpu")
    h0 = plain.submit(prompt, max_new_tokens=n)
    _finish(plain, [h0])
    assert plain._banks is None
    eng, ida, _ = _engine(base, bank)
    h_base = eng.submit(prompt, max_new_tokens=n)
    h_lora = eng.submit([4, 4], max_new_tokens=5, adapter_id=ida)
    _finish(eng, [h_base, h_lora])
    assert h_base.result(timeout=0) == h0.result(timeout=0)
    assert h_base.logprobs == h0.logprobs
    solo = pt_gen.generate(pp, torch.tensor([prompt]), _pcfg(), max_new_tokens=n)
    assert solo[0, len(prompt):].tolist() == h0.result(timeout=0)
    assert len(h_lora.result(timeout=0)) == 5


def test_activation_path_matches_merged(base, bank):
    """x·W + s·(x·A)·B through the engine == serving merge_lora weights."""
    _, pp = base
    lcfg, ad_a, _ = bank
    prompt, n = [5, 17, 42, 99], 8
    merged = pl.merge_lora(pp, _pt(ad_a), _plcfg(lcfg))
    want = pt_gen.generate(merged, torch.tensor([prompt]), _pcfg(),
                           max_new_tokens=n)[0, len(prompt):].tolist()
    eng, ida, _ = _engine(base, bank)
    assert _finish(eng, [eng.submit(prompt, max_new_tokens=n,
                                    adapter_id=ida)]) == [want]


def test_prefix_and_chunks_with_adapter(base, bank):
    """A prefix computed through adapter A with the suffix and decode
    through A, and the same prompt admitted in chunks through A, both
    equal the full prompt through A."""
    prefix, suffix, n = [11, 12, 13, 14], [60, 61], 5
    eng, ida, _ = _engine(base, bank)
    want = _finish(eng, [eng.submit(prefix + suffix, max_new_tokens=n,
                                    adapter_id=ida)])
    eng2, ida2, _ = _engine(base, bank)
    pid = eng2.register_prefix(prefix, adapter_id=ida2)
    assert _finish(eng2, [eng2.submit(suffix, max_new_tokens=n, prefix_id=pid,
                                      adapter_id=ida2)]) == want
    eng3, ida3, _ = _engine(base, bank, prefill_chunk=4)
    assert _finish(eng3, [eng3.submit(prefix + suffix, max_new_tokens=n,
                                      adapter_id=ida3)]) == want


def test_unregister_reuses_slot_and_fails_queued(base, bank):
    lcfg, _, ad_b = bank
    eng, ida, idb = _engine(base, bank)
    n_bank = eng._banks["wq"][0].shape[1]
    assert eng.unregister_adapter(idb) is True
    assert eng.unregister_adapter(idb) is False
    idc = eng.register_adapter(_pt(ad_b), _plcfg(lcfg))
    assert eng._banks["wq"][0].shape[1] == n_bank          # no growth
    with pytest.raises(KeyError):
        eng.submit([1, 2], max_new_tokens=2, adapter_id=idb)
    h = eng.submit([1, 2], max_new_tokens=2, adapter_id=idc)
    eng.unregister_adapter(idc)
    eng.step()
    with pytest.raises(KeyError):
        h.result(timeout=0)
    assert _finish(eng, [eng.submit([3], max_new_tokens=2, adapter_id=ida)])[0]


def test_unregister_repoints_inflight_to_base(base, bank):
    """Evicting an adapter mid-decode points its slot at index 0 and
    zeroes its factors in a new bank (the old one stays as it was), so the
    request finishes on the base model, never on the next tenant of the
    index: its tokens are those of the same eviction with no new tenant."""
    lcfg, _, ad_b = bank
    runs = []
    for retenant in (False, True):
        eng, ida, _ = _engine(base, bank)
        h = eng.submit([5, 17, 42], max_new_tokens=6, adapter_id=ida)
        eng.step()                                   # admit + first decode
        slot = next(i for i, r in enumerate(eng._slot_req) if r is not None)
        idx = eng._adapter_slots[ida]
        assert eng._aidx[slot] == idx
        old = eng._banks["wq"][0]
        eng.unregister_adapter(ida)
        assert eng._aidx[slot] == 0
        assert not eng._banks["wq"][0][:, idx].any() and old[:, idx].any()
        if retenant:
            eng.register_adapter(_pt(ad_b), _plcfg(lcfg))   # reuses idx
            assert eng._banks["wq"][0][:, idx].any()
        runs.append(_finish(eng, [h])[0])
    assert len(runs[0]) == 6 and runs[0] == runs[1]


def test_eviction_during_prefill_falls_back_to_base(base, bank, monkeypatch):
    lcfg, _, ad_b = bank
    eng, ida, _ = _engine(base, bank)
    orig = engine_mod._prefill
    hit = {}

    def racy_prefill(*a, **kw):
        out = orig(*a, **kw)
        if "adapter" in kw and not hit:
            hit["idx"] = eng._adapter_slots[ida]
            eng.unregister_adapter(ida)
            hit["reused"] = eng.register_adapter(_pt(ad_b), _plcfg(lcfg))
        return out

    monkeypatch.setattr(engine_mod, "_prefill", racy_prefill)
    h = eng.submit([5, 17, 42], max_new_tokens=4, adapter_id=ida)
    eng.step()
    slot = next(i for i, r in enumerate(eng._slot_req) if r is not None)
    assert hit and eng._adapter_slots[hit["reused"]] == hit["idx"]
    assert eng._aidx[slot] == 0
    assert len(_finish(eng, [h])[0]) == 4


def test_adapter_mismatch_not_matched_by_auto_prefix(base):
    """A prefix cached through adapter A serves A's requests only; the
    JAX engine gives the same tokens for both."""
    jp, pp = base
    lcfg = jl.LoraConfig(rank=2, targets=("wq",))
    ad = _rand_adapters(7, jp, lcfg)
    runs = []
    for make in (JaxEngine, GenerationEngine):
        if make is JaxEngine:
            eng = JaxEngine(jp, _jcfg(), slots=2, max_len=64,
                            prefill_buckets=(4, 8), auto_prefix=True)
            aid = eng.register_adapter(ad, lcfg)
        else:
            eng = GenerationEngine(pp, _pcfg(), slots=2, max_len=64,
                                   prefill_buckets=(4, 8), auto_prefix=True,
                                   device="cpu")
            aid = eng.register_adapter(_pt(ad), _plcfg(lcfg))
        eng.register_prefix([5, 17, 42], adapter_id=aid)
        base_out = _finish(eng, [eng.submit([5, 17, 42, 9], max_new_tokens=4)])
        assert eng._prefix_hits == 0
        ad_out = _finish(eng, [eng.submit([5, 17, 42, 9], max_new_tokens=4,
                                          adapter_id=aid)])
        assert eng._prefix_hits == 1
        runs.append(base_out + ad_out)
    assert runs[0] == runs[1]
    solo = pt_gen.generate(pp, torch.tensor([[5, 17, 42, 9]]), _pcfg(),
                           max_new_tokens=4)
    assert runs[1][0] == solo[0, 4:].tolist()


def test_late_registration_grows_bank(base, bank):
    lcfg, ad_a, ad_b = bank
    _, pp = base
    eng = GenerationEngine(pp, _pcfg(), slots=2, max_len=64,
                           prefill_buckets=(8,), device="cpu")
    ida = eng.register_adapter(_pt(ad_a), _plcfg(lcfg))
    first = _finish(eng, [eng.submit([5, 17, 42], max_new_tokens=4,
                                     adapter_id=ida)])
    eng.register_adapter(_pt(ad_b), _plcfg(lcfg))
    assert eng._banks["wq"][0].shape[1] == 3
    assert _finish(eng, [eng.submit([5, 17, 42], max_new_tokens=4,
                                    adapter_id=ida)]) == first


def test_config_mismatch_and_bad_targets_rejected(base, bank):
    jp, pp = base
    eng, _, _ = _engine(base, bank)
    bad = _pt(_rand_adapters(9, jp, jl.LoraConfig(rank=2)))
    with pytest.raises(ValueError, match="rank|config"):
        eng.register_adapter(bad, pl.LoraConfig(rank=2))
    lcfg = jl.LoraConfig(rank=4, targets=("wq", "w_gate"))
    bad = _pt(_rand_adapters(11, jp, lcfg))
    plain = GenerationEngine(pp, _pcfg(), slots=2, max_len=64,
                             prefill_buckets=(8,), device="cpu")
    with pytest.raises(ValueError, match="merge_lora"):
        plain.register_adapter(bad, _plcfg(lcfg))
    with pytest.raises(KeyError, match="missing factors"):
        plain.register_adapter({"layers": {}}, pl.LoraConfig())
    assert plain._banks is None and plain._lora_cfg is None


def test_random_base_lora_init_round_trip():
    """``lora_init`` draws on the params' device from its seed alone."""
    pp = llama_init(_pcfg(), seed=0, device="cpu")
    a = pl.lora_init(pp, pl.LoraConfig(rank=2), seed=5)
    b = pl.lora_init(pp, pl.LoraConfig(rank=2), seed=5)
    assert all(torch.equal(a["layers"][k], b["layers"][k]) for k in a["layers"])
