"""The port's LoRA fine-tuning (``models/lora.py:lora_loss`` through
``make_train_step``) against the JAX package, fp32, on the CPU: Llama
``tiny`` with the chunked loss, and ``MoeConfig.tiny`` with ``moe_loss``
(the default branch for an MoE base). Base weights and adapters come from
the JAX side (``llama_init``/``moe_init``, ``lora_init``) carried across
with ``params_from_numpy``; tokens from JAX's PRNG as the JAX tests draw
them, or numpy with a seed.

Tolerances, and why:
- adapter gradients per leaf, max |diff| <= 1e-5 of the leaf's largest
  entry: fp32 sums in another order, through the merge, two layers and the
  loss;
- losses of the training runs 1e-5 relative, step for step (optax.adam
  against the port's ``adam``, the same fp32 math);
- the base: equal bit for bit before and after training; a zero-B merge:
  equal bit for bit to the base;
- the engines: identical greedy tokens.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import lora as jl
from kubetorch_tpu.models import moe as jm
from kubetorch_tpu.models import quant as jq
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.models.llama import llama_init as jax_llama_init
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.train import init_train_state as jax_init_state
from kubetorch_tpu.train import make_train_step as jax_make_step
from kubetorch_tpu_torch.models import lora as pl
from kubetorch_tpu_torch.models import moe as pm
from kubetorch_tpu_torch.models import quant as pq
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.llama import LlamaConfig
from kubetorch_tpu_torch.serve import GenerationEngine
from kubetorch_tpu_torch.train import (adam, init_train_state,
                                       make_train_step)
from kubetorch_tpu_torch.train.optim import tree_leaves

pytestmark = pytest.mark.level("unit")

TOL_GRAD = 1e-5
TOL_LOSS = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(**kw):
    return JaxConfig.tiny(attn_impl="xla", dtype=jnp.float32, remat=False, **kw)


def _pcfg(**kw):
    kw.setdefault("attn_impl", "flash")
    return LlamaConfig.tiny(dtype=torch.float32, **kw)


def _plcfg(lcfg):
    return pl.LoraConfig(rank=lcfg.rank, alpha=lcfg.alpha,
                         targets=tuple(lcfg.targets))


def _pt(tree):
    return params_from_numpy(_np(tree), device="cpu")


@pytest.fixture(scope="module")
def base():
    """``tests/test_lora.py``'s base: JAX ``llama_init`` at PRNGKey(0)."""
    jp = jax_llama_init(jax.random.PRNGKey(0), _jcfg())
    return jp, _pt(jp)


def _flat(tree):
    out = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}/{k}")
        else:
            out[path] = np.asarray(node.detach() if torch.is_tensor(node)
                                   else node)
    rec(tree, "")
    return out


def _digest(tree):
    """Each leaf's bytes, for a bitwise comparison."""
    return {k: v.tobytes() for k, v in _flat(tree).items()}


def _batch(toks):
    t = torch.from_numpy(np.array(toks)).long()
    return {"tokens": t, "targets": t.roll(-1, 1)}


def _jbatch(toks):
    return {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"), ("wq", "wv")])
def test_lora_loss_adapter_grads_match_jax(base, targets):
    """Adapters from JAX's ``lora_init`` with B pushed off zero (so A's
    gradient is not zero too): the port's loss and adapter gradients equal
    JAX's ``jax.value_and_grad(lora_loss(...))``."""
    jp, pp = base
    lcfg = jl.LoraConfig(rank=4, targets=targets)
    adap = jl.lora_init(jax.random.PRNGKey(1), jp, lcfg)
    rng = np.random.default_rng(2)
    adap["layers"] = {k: v if k.endswith("__a") else jnp.asarray(
        rng.standard_normal(v.shape).astype(np.float32) * 0.1)
        for k, v in adap["layers"].items()}
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 16), 0, 512)
    b = _jbatch(toks)
    want_loss, want = jax.value_and_grad(jl.lora_loss(jp, _jcfg(), lcfg))(
        adap, b["tokens"], b["targets"])
    step = make_train_step(pl.lora_loss(pp, _pcfg(), _plcfg(lcfg)))
    loss, got = step.loss_and_grads(_pt(adap), _batch(toks))
    assert abs(float(loss) - float(want_loss)) <= TOL_LOSS * abs(float(want_loss))
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for key in w:
        assert float(np.abs(w[key]).max()) > 0, key
        err = float(np.abs(g[key] - w[key]).max())
        assert err <= TOL_GRAD * float(np.abs(w[key]).max()), (key, err)
    assert not any(t.requires_grad for t in tree_leaves(pp))


def test_zero_b_merge_is_identity(base):
    _, pp = base
    lcfg = pl.LoraConfig(rank=4)
    merged = pl.merge_lora(pp, pl.lora_init(pp, lcfg, seed=1), lcfg)
    for t in lcfg.targets:
        assert torch.equal(merged["layers"][t], pp["layers"][t])
    assert merged["layers"]["w_gate"] is pp["layers"]["w_gate"]
    assert merged["embed"] is pp["embed"]


def test_quantized_target_refused_as_in_jax(base):
    jp, pp = base
    lcfg = jl.LoraConfig(rank=4)
    with pytest.raises(ValueError) as want:
        jl.lora_init(jax.random.PRNGKey(1), jq.quantize_params(jp), lcfg)
    with pytest.raises(ValueError) as got:
        pl.lora_init(pq.quantize_params(pp), _plcfg(lcfg), seed=1)
    assert str(got.value) == str(want.value)


def _run_jax(jp, cfg, lcfg, adap, toks, steps):
    opt = optax.adam(1e-2)
    step = jax_make_step(jl.lora_loss(jp, cfg, lcfg), optimizer=opt)
    state = jax_init_state(adap, opt)
    losses = []
    for _ in range(steps):
        state, m = step(state, _jbatch(toks))
        losses.append(float(m["loss"]))
    return state, losses


def _run_port(pp, cfg, lcfg, adap, toks, steps):
    opt = adam(1e-2)
    step = make_train_step(pl.lora_loss(pp, cfg, _plcfg(lcfg)), optimizer=opt)
    state = init_train_state(_pt(adap), opt)
    losses = []
    for _ in range(steps):
        state, m = step(state, _batch(toks))
        losses.append(float(m["loss"]))
    return state, losses


def _assert_losses_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL_LOSS * abs(w), (got, want)


def test_training_moves_only_adapters(base):
    """``tests/test_lora.py::TestLora::test_training_moves_only_adapters``
    on the port, beside the JAX run: the losses fall as JAX's do, step for
    step; the base is bitwise untouched; the optimizer state is
    adapter-sized."""
    jp, pp = base
    lcfg = jl.LoraConfig(rank=4, targets=("wq", "wv"))
    adap = jl.lora_init(jax.random.PRNGKey(1), jp, lcfg)
    n_base = sum(t.numel() for t in tree_leaves(pp))
    assert pl.adapter_count(_pt(adap)) < n_base // 10
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 16), 0, 512)
    before = _digest(pp)
    _, want = _run_jax(jp, _jcfg(), lcfg, _np(adap), toks, 8)
    state, got = _run_port(pp, _pcfg(), lcfg, _np(adap), toks, 8)
    assert got[-1] < got[0] - 0.05, got
    _assert_losses_close(got, want)
    assert _digest(pp) == before
    opt_leaves = sum(t.numel() for t in tree_leaves(state.opt_state))
    assert opt_leaves <= 2 * pl.adapter_count(_pt(adap)) + 16


def test_moe_base_trains_with_default_loss():
    """``tests/test_lora.py::test_moe_base_trains_with_default_loss`` on
    the port, beside the JAX run: an MoE base takes ``moe_loss`` (router
    aux included) by default, and the losses equal JAX's step for step."""
    jcfg = jm.MoeConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla")
    jp = jm.moe_init(jax.random.PRNGKey(0), jcfg)
    pcfg = pm.MoeConfig.tiny(dtype=torch.float32, remat=False,
                             attn_impl="flash")
    pp = _pt(jp)
    lcfg = jl.LoraConfig(rank=2, targets=("wq", "wv"))
    adap = _np(jl.lora_init(jax.random.PRNGKey(1), jp, lcfg))
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 8), 0,
                              jcfg.vocab_size)
    _, want = _run_jax(jp, jcfg, lcfg, adap, toks, 6)
    _, got = _run_port(pp, pcfg, lcfg, adap, toks, 6)
    assert got[-1] < got[0] - 0.02, got
    _assert_losses_close(got, want)
    # the default is moe_loss itself, aux term included
    b = _batch(toks)
    merged = pl.merge_lora(pp, _pt(adap), _plcfg(lcfg))
    with torch.no_grad():
        assert float(pl.lora_loss(pp, pcfg, _plcfg(lcfg))(
            _pt(adap), b["tokens"], b["targets"])) == float(
            pm.moe_loss(merged, b["tokens"], b["targets"], pcfg))


def _serve(eng, adapter_id=None):
    hs = [eng.submit([5, 6, 7], max_new_tokens=8, adapter_id=adapter_id),
          eng.submit([9, 2, 30, 4], max_new_tokens=6, adapter_id=adapter_id)]
    eng.step()
    hs.append(eng.submit([3, 1, 4, 1, 5], max_new_tokens=7,
                         adapter_id=adapter_id))
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def test_trained_adapters_serve_as_in_jax(base):
    """``examples/lora_finetune.py``'s workflow on both packages: fine-tune,
    then serve the trained adapters merged (``merge_lora`` → engine) and
    banked (``register_adapter`` on the base engine); the port's greedy
    tokens equal the JAX engine's both ways, and the adapters move them off
    the base model's."""
    jp, pp = base
    lcfg = jl.LoraConfig(rank=4, targets=("wq", "wv"))
    adap = _np(jl.lora_init(jax.random.PRNGKey(1), jp, lcfg))
    toks = jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0, 512)
    j_state, _ = _run_jax(jp, _jcfg(), lcfg, adap, toks, 8)
    p_state, _ = _run_port(pp, _pcfg(), lcfg, adap, toks, 8)
    grid = dict(slots=2, max_len=64, prefill_buckets=(16,))

    want_merged = _serve(JaxEngine(jl.merge_lora(jp, j_state.params, lcfg),
                                   _jcfg(), **grid))
    got_merged = _serve(GenerationEngine(
        pl.merge_lora(pp, p_state.params, _plcfg(lcfg)), _pcfg(), **grid,
        device="cpu"))
    assert got_merged == want_merged

    j_eng = JaxEngine(jp, _jcfg(), **grid)
    want_banked = _serve(j_eng, j_eng.register_adapter(j_state.params, lcfg))
    p_eng = GenerationEngine(pp, _pcfg(), **grid, device="cpu")
    got_banked = _serve(p_eng, p_eng.register_adapter(p_state.params,
                                                      _plcfg(lcfg)))
    assert got_banked == want_banked == want_merged
    assert _serve(GenerationEngine(pp, _pcfg(), **grid, device="cpu")) != got_merged
