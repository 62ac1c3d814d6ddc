"""The port's training path (kubetorch_tpu_torch/train, the losses in
models/llama.py, remat in models/common.py) against the JAX package on the
same inputs, made with numpy from a seed: ``tiny`` in fp32.

The port runs attention through ``flash_attention``, whose CPU path is the
plain forward and A2/A3 backward behind the autograd Function; the JAX side
runs its Pallas kernels in interpret mode where a test says "flash" and its
einsum attention elsewhere (same fp32 math, faster to trace).

Tolerances, and why:
- losses 1e-5 absolute (values ~6): fp32 sums in a different order;
- gradients per leaf, max |diff| <= 1e-5 of the leaf's largest entry: the
  same rounding carried back through two layers and the LM head;
- optimizer alone on the same grads (no model): 1e-6 relative, 1e-8
  absolute: elementwise fp32 math, differing only in the last bits of
  pow/sqrt/cos;
- three train steps: losses and grad norms 1e-5 relative; params 5e-6
  absolute. Params move ~5e-4 in three steps, and Adam's
  m / (sqrt(v) + eps) turns the grads' 1e-6 relative rounding into update
  differences of up to ~1% of a step on entries whose grad is near zero;
- the three remat policies: equal gradients to 1e-6 relative (recompute
  repeats the same fp32 ops; only the order of gradient sums may differ).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import llama as jax_llama
from kubetorch_tpu.train import train_step as jax_ts
from kubetorch_tpu_torch.models import common as pt_common
from kubetorch_tpu_torch.models import llama as pt_llama
from kubetorch_tpu_torch.models.convert import (params_from_numpy,
                                                train_state_from_numpy)
from kubetorch_tpu_torch.ops import attention as pt_attn
from kubetorch_tpu_torch.train import optim as pt_optim
from kubetorch_tpu_torch.train import train_step as pt_ts

pytestmark = pytest.mark.level("unit")

TOL_LOSS = 1e-5
TOL_GRAD = 1e-5
TOL_OPT_RTOL, TOL_OPT_ATOL = 1e-6, 1e-8
TOL_STEP_METRIC = 1e-5
TOL_STEP_PARAM = 5e-6
TOL_REMAT = 1e-6
CHUNK = 16


def np_params(seed=0):
    """tiny's param tree in the stacked layout, from numpy; norm weights
    perturbed away from 1 so they take part."""
    cfg = jax_llama.LlamaConfig.tiny()
    rng = np.random.default_rng(seed)
    d, L, hd = cfg.dim, cfg.n_layers, cfg.dim // cfg.n_heads
    nh, nkv, f, v = cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.vocab_size

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def norm(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": w((v, d), d),
        "layers": {
            "attn_norm": norm(L, d), "wq": w((L, d, nh * hd), d),
            "wk": w((L, d, nkv * hd), d), "wv": w((L, d, nkv * hd), d),
            "wo": w((L, nh * hd, d), nh * hd), "ffn_norm": norm(L, d),
            "w_gate": w((L, d, f), d), "w_up": w((L, d, f), d),
            "w_down": w((L, f, d), f),
        },
        "final_norm": norm(d),
        "lm_head": w((d, v), d),
    }


def batch(b=4, s=24, seed=1):
    tokens = np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def jcfg(attn="xla"):
    return jax_llama.LlamaConfig.tiny(dtype=jnp.float32, remat=False,
                                      attn_impl=attn)


def pcfg(**kw):
    kw.setdefault("attn_impl", "flash")
    return pt_llama.LlamaConfig.tiny(dtype=torch.float32, **kw)


def pt_tree(tree):
    return params_from_numpy(tree, device="cpu")


def flat(tree):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    out = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}/{k}")
        else:
            out[path] = np.asarray(node.detach() if torch.is_tensor(node) else node)
    rec(tree, "")
    return out


def assert_leaves_close(got, want, rel):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for key in w:
        scale = float(np.abs(w[key]).max())
        err = float(np.abs(g[key] - w[key]).max())
        assert err <= rel * scale, (key, err, scale)


def assert_leaves_abs(got, want, atol):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for key in w:
        np.testing.assert_allclose(g[key], w[key], atol=atol, rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# losses and their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,s", [("plain", 24), ("chunked", 24),
                                    ("chunked", 32)])
def test_losses_match_jax(kind, s):
    """llama_loss and llama_loss_chunked; s=24 does not divide the chunk of
    16, so the chunked loss pads and masks its last chunk."""
    tree = np_params()
    tokens, targets = batch(s=s)
    if kind == "plain":
        want = jax_llama.llama_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jnp.asarray(tokens), jnp.asarray(targets),
                                    jcfg())
        got = pt_llama.llama_loss(pt_tree(tree), torch.from_numpy(tokens),
                                  torch.from_numpy(targets), pcfg())
    else:
        want = jax_llama.llama_loss_chunked(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
            jnp.asarray(targets), jcfg(), chunk=CHUNK)
        got = pt_llama.llama_loss_chunked(pt_tree(tree), torch.from_numpy(tokens),
                                          torch.from_numpy(targets), pcfg(),
                                          chunk=CHUNK)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= TOL_LOSS


def test_chunked_loss_equals_plain_loss():
    tree = pt_tree(np_params(2))
    tokens, targets = map(torch.from_numpy, batch(s=40, seed=2))
    a = pt_llama.llama_loss(tree, tokens, targets, pcfg())
    b = pt_llama.llama_loss_chunked(tree, tokens, targets, pcfg(), chunk=CHUNK)
    assert abs(float(a) - float(b)) <= TOL_LOSS


def _pt_value_and_grad(tree, tokens, targets, cfg, loss=None):
    params = pt_optim.tree_map(lambda t: t.clone().requires_grad_(), pt_tree(tree))
    loss = loss or (lambda p, t, y: pt_llama.llama_loss_chunked(p, t, y, cfg,
                                                                chunk=CHUNK))
    value = loss(params, torch.from_numpy(tokens), torch.from_numpy(targets))
    leaves = pt_optim.tree_leaves(params)
    grads = torch.autograd.grad(value, leaves)
    it = iter(grads)
    return float(value.detach()), pt_optim.tree_map(lambda _: next(it), params)


def test_loss_grads_match_jax_through_flash():
    """Every leaf's gradient of the chunked loss, with flash attention on
    both sides: the Pallas VJP in interpret mode against the port's autograd
    Function (plain A1 forward with LSE, plain A2/A3 backward)."""
    tree = np_params(3)
    tokens, targets = batch(b=2, s=24, seed=3)
    want_v, want_g = jax.value_and_grad(
        lambda p: jax_llama.llama_loss_chunked(p, jnp.asarray(tokens),
                                               jnp.asarray(targets),
                                               jcfg("flash"), chunk=CHUNK)
    )(jax.tree_util.tree_map(jnp.asarray, tree))
    got_v, got_g = _pt_value_and_grad(tree, tokens, targets, pcfg())
    assert abs(got_v - float(want_v)) <= TOL_LOSS
    assert_leaves_close(got_g, want_g, TOL_GRAD)


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------


def _count_flash_forwards(monkeypatch):
    calls = []
    real = pt_attn.flash_attention_fwd_ref

    def counted(*a, **kw):
        if kw.get("need_lse", True):
            calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(pt_attn, "flash_attention_fwd_ref", counted)
    return calls


@pytest.mark.parametrize("where", ["model", "step"])
def test_remat_policies_give_equal_grads(monkeypatch, where):
    """none / dots / nothing_saveable, on the layer stack
    (cfg.remat_policy) or around the loss (make_train_step's
    remat_policy): equal gradients, and the flash forward re-runs in the
    backward exactly when the policy recomputes."""
    tree = np_params(4)
    tokens, targets = batch(b=2, s=24, seed=4)
    calls = _count_flash_forwards(monkeypatch)
    grads, counts = {}, {}
    for name in pt_common.REMAT_POLICY_NAMES:
        calls.clear()
        if where == "model":
            cfg = pcfg(remat_policy=name)
            _, grads[name] = _pt_value_and_grad(tree, tokens, targets, cfg)
        else:
            cfg = pcfg(remat=False)
            step = pt_ts.make_train_step(
                lambda p, t, y: pt_llama.llama_loss_chunked(p, t, y, cfg,
                                                            chunk=CHUNK),
                remat_policy=name)
            _, grads[name] = step.loss_and_grads(
                pt_tree(tree), {"tokens": torch.from_numpy(tokens),
                                "targets": torch.from_numpy(targets)})
        counts[name] = len(calls)
    n = pcfg().n_layers
    assert counts == {"none": n, "dots": 2 * n, "nothing_saveable": 2 * n}
    for name in ("dots", "nothing_saveable"):
        assert_leaves_close(grads[name], grads["none"], TOL_REMAT)


def test_remat_policy_names_and_errors():
    assert pt_common.resolve_remat_policy(None) is None
    assert pt_common.resolve_remat_policy("none") is None
    assert pt_common.resolve_remat_policy("dots") is pt_common.dots_saveable
    custom = pt_common.dots_saveable
    assert pt_common.resolve_remat_policy(custom) is custom
    with pytest.raises(ValueError, match="unknown remat policy"):
        pt_common.resolve_remat_policy("dot")
    assert pt_llama.LlamaConfig().remat and pt_llama.LlamaConfig().remat_policy is None


# ---------------------------------------------------------------------------
# the optimizer alone
# ---------------------------------------------------------------------------


def _grad_trees(seed, n=3):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}

    def make(sh):
        if isinstance(sh, dict):
            return {k: make(v) for k, v in sh.items()}
        return rng.standard_normal(sh).astype(np.float32)
    return make(shapes), [make(shapes) for _ in range(n)]


@pytest.mark.parametrize("which", ["default", "adamw", "adamw_mu_fp32"])
def test_optimizer_matches_optax(which):
    """Three updates on the same params and grads: updates and state."""
    params_np, grads_np = _grad_trees(5)
    if which == "default":
        j_opt = jax_ts.default_optimizer(warmup_steps=2, total_steps=5)
        p_opt = pt_ts.default_optimizer(warmup_steps=2, total_steps=5)
    elif which == "adamw":
        j_opt, p_opt = optax.adamw(1e-2), pt_optim.adamw(1e-2)
    else:
        j_opt = optax.adamw(1e-2, mu_dtype=jnp.float32, weight_decay=0.3)
        p_opt = pt_optim.adamw(1e-2, mu_dtype=torch.float32, weight_decay=0.3)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    pp = pt_tree(params_np)
    js, ps = j_opt.init(jp), p_opt.init(pp)
    for g in grads_np:
        ju, js = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        pu, ps = p_opt.update(pt_tree(g), ps, pp)
        for key, want in flat(ju).items():
            np.testing.assert_allclose(flat(pu)[key], want, rtol=TOL_OPT_RTOL,
                                       atol=TOL_OPT_ATOL, err_msg=key)
    j_leaves = jax.tree_util.tree_leaves(js)
    p_leaves = [np.asarray(t) for t in pt_optim.tree_leaves(ps)]
    assert len(j_leaves) == len(p_leaves)
    for a, b in zip(p_leaves, j_leaves):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL_OPT_RTOL,
                                   atol=TOL_OPT_ATOL)


def test_schedule_matches_optax_and_pins_lr0_on_step_one():
    j = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 20, end_value=1e-5)
    p = pt_optim.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 20, end_value=1e-5)
    counts = np.arange(0, 26, dtype=np.int32)
    want = np.asarray(jax.vmap(j)(jnp.asarray(counts)))
    got = p(torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_OPT_RTOL, atol=TOL_OPT_ATOL)
    assert got[0] == 0.0
    with pytest.raises(ValueError):
        pt_optim.warmup_cosine_decay_schedule(0.0, 1.0, 5, 5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _optimizers(which):
    if which == "adamw":
        return optax.adamw(1e-4), pt_optim.adamw(1e-4)
    return (jax_ts.default_optimizer(warmup_steps=2),
            pt_ts.default_optimizer(warmup_steps=2))


def _run_jax(tree, opt, steps, tokens, targets, state=None, **kw):
    cfg = jcfg()
    step = jax_ts.make_train_step(
        lambda p, t, y: jax_llama.llama_loss_chunked(p, t, y, cfg, chunk=CHUNK),
        optimizer=opt, **kw)
    if state is None:
        state = jax_ts.init_train_state(
            jax.tree_util.tree_map(jnp.asarray, tree), opt)
    b = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    ms = []
    for _ in range(steps):
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def _run_port(params, opt, steps, tokens, targets, state=None, **kw):
    cfg = pcfg()
    step = pt_ts.make_train_step(
        lambda p, t, y: pt_llama.llama_loss_chunked(p, t, y, cfg, chunk=CHUNK),
        optimizer=opt, **kw)
    if state is None:
        state = pt_ts.init_train_state(params, opt)
    b = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    ms = []
    for _ in range(steps):
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def _assert_metrics_close(got, want):
    assert [m.keys() for m in got] == [m.keys() for m in want]
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        for key in set(w) - {"step"}:
            assert abs(g[key] - w[key]) <= TOL_STEP_METRIC * abs(w[key]), (key, g, w)


@pytest.mark.parametrize("which,kw", [
    ("default", {}),
    ("adamw", {}),
    ("default", {"accum_steps": 2}),
    ("default", {"metrics": ("loss",)}),
])
def test_three_train_steps_match_jax(which, kw):
    tree = np_params(6)
    tokens, targets = batch(seed=6)
    j_opt, p_opt = _optimizers(which)
    j_state, j_ms = _run_jax(tree, j_opt, 3, tokens, targets, **kw)
    p_state, p_ms = _run_port(pt_tree(tree), p_opt, 3, tokens, targets, **kw)
    _assert_metrics_close(p_ms, j_ms)
    if "metrics" in kw:
        assert set(p_ms[0]) == {"step", "loss"}
    assert int(p_state.step) == 3
    assert_leaves_abs(p_state.params, j_state.params, TOL_STEP_PARAM)


def test_default_optimizer_first_step_has_lr_zero():
    """The schedule is read before its count increments: step 1 moves no
    param, step 2 moves them."""
    tree = np_params(7)
    tokens, targets = batch(seed=7)
    p_opt = pt_ts.default_optimizer(warmup_steps=2)
    params = pt_tree(tree)
    state = pt_ts.init_train_state(params, p_opt)
    step = pt_ts.make_train_step(
        lambda p, t, y: pt_llama.llama_loss_chunked(p, t, y, pcfg(), chunk=CHUNK),
        optimizer=p_opt, donate=False)
    b = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    s1, _ = step(state, b)
    assert_leaves_abs(s1.params, tree, 0.0)
    s2, _ = step(s1, b)
    assert float(np.abs(flat(s2.params)["/layers/wq"] - tree["layers"]["wq"]).max()) > 0


def test_donate_updates_in_place_and_no_donate_keeps_the_state():
    tree = np_params(8)
    tokens, targets = map(torch.from_numpy, batch(seed=8))
    b = {"tokens": tokens, "targets": targets}
    for donate in (True, False):
        opt = pt_optim.adamw(1e-3)
        state = pt_ts.init_train_state(pt_tree(tree), opt)
        wq, mu = state.params["layers"]["wq"], state.opt_state[0].mu["embed"]
        before = wq.clone()
        step = pt_ts.make_train_step(
            lambda p, t, y: pt_llama.llama_loss(p, t, y, pcfg()),
            optimizer=opt, donate=donate)
        new, m = step(state, b)
        assert int(m["step"]) == 0 and int(new.step) == 1
        assert (new.params["layers"]["wq"] is wq) == donate
        assert (new.opt_state[0].mu["embed"] is mu) == donate
        assert torch.equal(wq, before) != donate
        assert int(state.step) == (1 if donate else 0)


def test_train_state_from_numpy_resumes_mid_run():
    """Two JAX steps, the state carried across, then one more step on each
    side: the third step matches, moments and counts included."""
    tree = np_params(9)
    tokens, targets = batch(seed=9)
    j_opt, p_opt = _optimizers("default")
    j_state, _ = _run_jax(tree, j_opt, 2, tokens, targets)
    carried = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_state), device="cpu")
    assert isinstance(carried.opt_state[1][0], pt_optim.ScaleByAdamState)
    assert int(carried.step) == 2 and int(carried.opt_state[1][0].count) == 2
    assert carried.opt_state[1][0].mu["embed"].dtype == torch.float32
    j_state, j_ms = _run_jax(None, j_opt, 1, tokens, targets, state=j_state)
    p_state, p_ms = _run_port(None, p_opt, 1, tokens, targets, state=carried)
    _assert_metrics_close(p_ms, j_ms)
    assert_leaves_abs(p_state.params, j_state.params, TOL_STEP_PARAM)
    for name in ("mu", "nu"):
        assert_leaves_abs(getattr(p_state.opt_state[1][0], name),
                          getattr(j_state.opt_state[1][0], name), TOL_STEP_PARAM)


def test_train_state_from_numpy_rejects_unknown_state():
    from collections import namedtuple
    Odd = namedtuple("ScaleByLionState", ["count", "mu"])
    state = pt_ts.TrainState(params={"a": np.zeros(2, np.float32)},
                             opt_state=(Odd(np.zeros((), np.int32),
                                            {"a": np.zeros(2, np.float32)}),),
                             step=np.zeros((), np.int32))
    with pytest.raises(ValueError, match="ScaleByLionState"):
        train_state_from_numpy(state, device="cpu")


def test_make_train_step_argument_checks():
    loss = lambda p, t, y: None  # noqa: E731
    with pytest.raises(ValueError, match="rules"):
        pt_ts.make_train_step(loss, mesh=object())
    with pytest.raises(ValueError, match="accum_steps"):
        pt_ts.make_train_step(loss, accum_steps=0)
    with pytest.raises(ValueError, match="overlap_grads"):
        pt_ts.make_train_step(loss, overlap_grads=True)
    with pytest.raises(ValueError, match="unknown step metrics"):
        pt_ts.make_train_step(loss, metrics=("loss", "mfu"))
    with pytest.raises(NotImplementedError, match="parallelism"):
        pt_ts.make_train_step(loss, mesh=object(), rules=object())
    step = pt_ts.make_train_step(
        lambda p, t, y: pt_llama.llama_loss(p, t, y, pcfg()), accum_steps=3)
    tokens = torch.zeros((4, 8), dtype=torch.long)
    state = pt_ts.init_train_state(pt_tree(np_params()))
    with pytest.raises(ValueError, match="not divisible"):
        step(state, {"tokens": tokens, "targets": tokens})


def test_config_keeps_remat_fields():
    cfg = dataclasses.replace(pcfg(), remat_policy="nothing_saveable")
    assert cfg.remat_policy == "nothing_saveable"
    d = pt_llama.config_from_dict({"remat": False, "remat_policy": "dots"})
    assert d.remat is False and d.remat_policy == "dots"
