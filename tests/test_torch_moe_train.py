"""The port's MoE training path (``moe_forward`` under autograd, ``moe_loss``
with the router's aux term, remat, the train step over an MoE tree)
against the JAX package on ``MoeConfig.tiny``, fp32, on the CPU. Params
come from the JAX ``moe_init`` carried across with ``params_from_numpy``;
tokens from numpy with a seed.

The port runs attention through ``flash_attention`` (its CPU path: the
plain forward and the A2/A3 backward behind the autograd Function); the
JAX side runs its einsum attention (the same fp32 math).

Tolerances, and why:
- losses and the aux value 1e-5 relative: fp32 sums in another order;
- gradients per leaf, max |diff| <= 1e-5 of the leaf's largest entry:
  the same rounding carried back through two layers, the router and the
  expert banks. A dropped pair given its expert's gradient, or a router
  gradient through top-1, would move whole entries;
- three train steps: losses and grad norms 1e-5 relative, as
  ``test_torch_train.py`` holds Llama; params by each leaf's change from
  its initial value, 1e-3 relative in L2. Adam's step m / (sqrt(v) + eps)
  is about lr in size whatever the grad's, so an entry whose grad sits at
  the fp32 noise floor (1e-6 of its leaf's largest) steps by a different
  amount on each side: with capacity drops one ``wv`` entry of 4,096 ends
  6e-6 apart after default_optimizer's three steps (1.3% of its move),
  past the 5e-6 absolute that Llama's params meet. Such an entry weighs
  ~2e-4 of its leaf's change in L2; a wrong update rule weighs all of it.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import moe as jm
from kubetorch_tpu.train import train_step as jax_ts
from kubetorch_tpu_torch.models import moe as pm
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.llama import layer_weights
from kubetorch_tpu_torch.train import optim as pt_optim
from kubetorch_tpu_torch.train import train_step as pt_ts

pytestmark = pytest.mark.level("unit")

TOL_LOSS = 1e-5
TOL_GRAD = 1e-5
TOL_STEP_METRIC = 1e-5
TOL_STEP_CHANGE = 1e-3
# capacity 0.5 * S * K / E = 4 slots per expert at S = 16: pairs drop;
# 4.0 gives 32 >= S, so none can
DROPS = {"drops": 0.5, "no_drops": 4.0}


def _jcfg(**kw):
    return jm.MoeConfig.tiny(dtype=jnp.float32, attn_impl="xla", **kw)


def _pcfg(**kw):
    kw.setdefault("attn_impl", "flash")
    return pm.MoeConfig.tiny(dtype=torch.float32, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    jp = jm.moe_init(jax.random.PRNGKey(0), _jcfg())
    return jp, params_from_numpy(_np(jp), device="cpu")


def _batch(b=2, s=16, seed=3):
    toks = np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


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


def assert_leaves_close(got, want, rel):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for key in w:
        scale = float(np.abs(w[key]).max())
        err = float(np.abs(g[key] - w[key]).max())
        assert err <= rel * scale, (key, err, scale)


def _port_loss_and_grads(pp, cfg, toks, tgts):
    step = pt_ts.make_train_step(lambda p, t, y: pm.moe_loss(p, t, y, cfg))
    batch = {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(tgts).long()}
    return step.loss_and_grads(pp, batch)


class _KeptSpy:
    """Records the kept-pair mask of every ``_dispatch`` call."""

    def __init__(self, monkeypatch):
        self.kept = []
        real = pm._dispatch

        def spy(*a, **kw):
            out = real(*a, **kw)
            self.kept.append(out[2].clone())
            return out
        monkeypatch.setattr(pm, "_dispatch", spy)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("drops", list(DROPS))
def test_moe_loss_and_grads_match_jax(trees, monkeypatch, drops, remat):
    jp, pp = trees
    kw = dict(capacity_factor=DROPS[drops], remat=remat)
    toks, tgts = _batch()
    jcfg = _jcfg(**kw)
    want_loss, want_grads = jax.value_and_grad(jm.moe_loss)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    spy = _KeptSpy(monkeypatch)
    loss, grads = _port_loss_and_grads(pp, _pcfg(**kw), toks, tgts)
    # under remat the backward re-runs each layer's dispatch
    assert len(spy.kept) == 2 * (2 if remat else 1)
    dropped = sum(int((~k).sum()) for k in spy.kept)
    assert (dropped > 0) == (drops == "drops"), dropped
    assert abs(float(loss) - float(want_loss)) <= TOL_LOSS * abs(float(want_loss))
    assert_leaves_close(grads, want_grads, TOL_GRAD)


def test_aux_matches_jax_with_drops(trees):
    jp, pp = trees
    toks, _ = _batch(seed=4)
    kw = dict(capacity_factor=DROPS["drops"])
    _, want = jm.moe_forward(jp, jnp.asarray(toks), _jcfg(**kw))
    with torch.no_grad():
        _, got = pm.moe_forward(pp, torch.from_numpy(toks).long(), _pcfg(**kw))
    assert float(got) > 0
    assert abs(float(got) - float(want)) <= TOL_LOSS * abs(float(want))


def test_moe_ffn_vjp_matches_jax_and_drops_get_no_expert_gradient(trees):
    """One layer's FFN under a random cotangent on its output (the aux term
    left out): the port's gradients for x, the router and the expert banks
    equal JAX's one-hot einsums', and a token whose pairs were all dropped
    gets exactly zero gradient."""
    jp, pp = trees
    cfg_kw = dict(capacity_factor=0.25)   # 2 slots per expert at S = 16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ct = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jlw = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])

    def jf(x, router, experts):
        out, _ = jm.moe_ffn(_jcfg(**cfg_kw), x, dict(jlw, router=router,
                                                     experts=experts))
        return jnp.sum(out * ct)

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jlw["router"],
                                           jlw["experts"])
    plw = layer_weights(pp, 0)
    xt = torch.from_numpy(x).requires_grad_()
    router = plw["router"].clone().requires_grad_()
    experts = {k: v.clone().requires_grad_() for k, v in plw["experts"].items()}
    out, _, kept = pm._dispatch(_pcfg(**cfg_kw), xt,
                                dict(plw, router=router, experts=experts))
    (out * torch.from_numpy(ct)).sum().backward()
    assert_leaves_close({"x": xt.grad, "router": router.grad,
                         "experts": {k: v.grad for k, v in experts.items()}},
                        {"x": want[0], "router": want[1], "experts": want[2]},
                        TOL_GRAD)
    all_dropped = ~kept.any(-1)
    assert int(all_dropped.sum()) > 0
    assert float(xt.grad[all_dropped].abs().max()) == 0.0


def _optimizers(which):
    if which == "adamw":
        return optax.adamw(1e-4), pt_optim.adamw(1e-4)
    return (jax_ts.default_optimizer(warmup_steps=2),
            pt_ts.default_optimizer(warmup_steps=2))


@pytest.mark.parametrize("which", ["default", "adamw"])
def test_three_train_steps_match_optax(trees, which):
    jp, pp = trees
    kw = dict(capacity_factor=DROPS["drops"])
    toks, tgts = _batch(seed=6)
    j_opt, p_opt = _optimizers(which)
    jcfg, pcfg = _jcfg(**kw), _pcfg(**kw)
    j_step = jax_ts.make_train_step(lambda p, t, y: jm.moe_loss(p, t, y, jcfg),
                                    optimizer=j_opt)
    p_step = pt_ts.make_train_step(lambda p, t, y: pm.moe_loss(p, t, y, pcfg),
                                   optimizer=p_opt)
    # the JAX step donates its state: give it its own copy of the params
    js = jax_ts.init_train_state(jax.tree_util.tree_map(jnp.asarray, _np(jp)),
                                 j_opt)
    ps = pt_ts.init_train_state(params_from_numpy(_np(jp), device="cpu"), p_opt)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    pb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(tgts).long()}
    for _ in range(3):
        js, jm_ = j_step(js, jb)
        ps, pm_ = p_step(ps, pb)
        for key in ("loss", "grad_norm"):
            assert abs(float(pm_[key]) - float(jm_[key])) <= \
                TOL_STEP_METRIC * abs(float(jm_[key])), key
    g, w, w0 = _flat(ps.params), _flat(js.params), _flat(jp)
    for key in w:
        moved = np.linalg.norm(w[key] - w0[key])
        assert moved > 0, key
        assert np.linalg.norm(g[key] - w[key]) <= TOL_STEP_CHANGE * moved, key


def test_loss_decreases():
    """``tests/test_models.py::TestMoe::test_loss_decreases`` on the port,
    with the JAX test's params carried across: one plain gradient step of
    0.3 lowers the loss, and both losses equal JAX's."""
    jcfg = jm.MoeConfig.tiny(attn_impl="xla", dtype=jnp.float32, remat=False)
    params = jm.moe_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (4, 16), 0,
                                jcfg.vocab_size)
    targets = jnp.roll(tokens, -1, 1)
    l0 = jm.moe_loss(params, tokens, targets, jcfg)
    g = jax.grad(jm.moe_loss)(params, tokens, targets, jcfg)
    p2 = jax.tree_util.tree_map(lambda p, gr: p - 0.3 * gr.astype(p.dtype),
                                params, g)
    l1 = jm.moe_loss(p2, tokens, targets, jcfg)

    pcfg = pm.MoeConfig.tiny(attn_impl="xla", dtype=torch.float32, remat=False)
    pp = params_from_numpy(_np(params), device="cpu")
    pt, py = (torch.from_numpy(np.array(a)).long() for a in (tokens, targets))
    step = pt_ts.make_train_step(lambda p, t, y: pm.moe_loss(p, t, y, pcfg))
    p_l0, p_g = step.loss_and_grads(pp, {"tokens": pt, "targets": py})
    p2_port = pt_optim.tree_map(lambda p, gr: p - 0.3 * gr.to(p.dtype), pp, p_g)
    with torch.no_grad():
        p_l1 = pm.moe_loss(p2_port, pt, py, pcfg)
    assert float(p_l1) < float(p_l0)
    for got, want in ((p_l0, l0), (p_l1, l1)):
        assert abs(float(got) - float(want)) <= TOL_LOSS * abs(float(want))


def test_config_keeps_training_fields():
    cfg = pm.config_from_dict({"n_layers": 3, "remat": False,
                               "router_aux_weight": 0.05, "unknown": 1})
    assert (cfg.n_layers, cfg.remat, cfg.router_aux_weight) == (3, False, 0.05)
    assert pm.MoeConfig().remat and pm.MoeConfig().router_aux_weight == 0.01
    assert cfg._llama_view().remat is False
    assert dataclasses.replace(cfg, remat=True)._llama_view().remat is True
