"""The port's ResNet (kubetorch_tpu_torch/models/resnet.py), its converter
(models/convert.py:resnet_from_flax) and ``train/optim.py``'s ``sgd``
against the JAX package (flax ResNet, optax) on the CPU, fp32, 32×32
images.

The flax variables are ``model.init``'s with every leaf moved by 0.1·N(0, 1)
noise (seeded), so the zero scale of each block's last norm does not cut
the blocks out of the comparison; the running variances are made
|·| + 0.5 and the running means keep their noise around 0, so in the eval
mode no block's branch is cut off by its ReLUs (every gradient leaf is
non-zero in both modes).

Tolerances, each relative to the largest magnitude of the quantity
compared:

- logits, each new ``batch_stats`` leaf, sgd updates and the steps'
  params: 1e-5.
- gradients, leaf by leaf: 1e-5 of the leaf's own largest value, plus on
  that leaf JAX's own distance from a float64 evaluation of the same flax
  model (``_jax_f64_grads``). The train mode's BatchNorm gradients are
  small differences of large terms: measured, JAX's fp32 gradients lie
  up to 3.5e-5 (ResNet18) and 1.7e-5 (ResNet50) of a leaf's own size
  from float64, the port's at most 7.2e-6 and 9.0e-6, and the port's
  from JAX's 3.2e-5 and 2.1e-5; every leaf keeps at least 4.6e-6 of its
  size in hand. In the eval mode every leaf is within 1.9e-6 of JAX's,
  so there the added term is slack never used. The train mode runs 16 images: at 4, the BatchNorm
  over the last stage's 1×1 maps is worse conditioned still (JAX ~1e-4
  from float64).
- The data mesh: gloo worlds of 2 and 4 ranks on ``{"data": n}`` run
  three steps of ``examples/resnet_dp.py``'s step (train mode, global
  BatchNorm moments, ``sgd(0.1, momentum=0.9)``) against JAX's on n of
  the conftest's virtual devices with ``batch_sharding``: 1e-5 of JAX's
  one-device step over the same global batch, and 1e-5 plus JAX's own
  departure from that step of JAX's n-device step (its 4-device run lies
  2.4e-5 from its one-device run after three steps, the order of its
  fp32 reductions across devices; the port's 4-rank run lies 4e-7).

Three planted faults, each the straight PyTorch translation of one of
the model's subtleties, must fail these comparisons: symmetric SAME
padding, ``F.batch_norm``'s unbiased running variance, and BatchNorm
moments taken on each rank's rows only.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kubetorch_tpu.models import resnet as jr
from kubetorch_tpu_torch.models import resnet as pr
from kubetorch_tpu_torch.models.convert import params_to_numpy, resnet_from_flax
from kubetorch_tpu_torch.train import optim as po

from .test_torch_mesh_train import _flat
from .test_torch_parallel import run_world

pytestmark = pytest.mark.level("unit")

TOL = 1e-5
HW = 32
CLASSES = 10
MODELS = {"ResNet18": 8, "ResNet50": 4}


def resnet_to_flax(tree):
    """A port ResNet param tree (or its gradients) as numpy in flax's
    layout: conv kernels (O, I, kh, kw) → HWIO."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        a = params_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    return walk(tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want, rel=TOL, what=""):
    """Every leaf of ``got`` within rel × the largest magnitude of ``want``
    (over the whole tree)."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want) or 1.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=what)


def _close_leaves(got, want, exact, rel=TOL, what=""):
    """Each leaf of ``got`` within rel × that leaf's own largest magnitude
    in ``want``, plus the largest distance of ``want``'s leaf from
    ``exact``'s (a float64 evaluation of what ``want`` computes in fp32)."""
    got, want, exact = _leaves(got), _leaves(want), _leaves(exact)
    assert len(got) == len(want) == len(exact)
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        atol = rel * float(np.abs(w).max()) + float(np.abs(w - e).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what} leaf {i}")


def _far(got, want, rel=TOL) -> float:
    got, want = _leaves(got), _leaves(want)
    scale = max(float(np.abs(w).max()) for w in want) or 1.0
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / scale


def _jmodel(name):
    return getattr(jr, name)(num_classes=CLASSES, num_filters=MODELS[name],
                             dtype=jnp.float32)


def _pcfg(name):
    return getattr(pr, name)(num_classes=CLASSES, num_filters=MODELS[name],
                             dtype=torch.float32)


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, HW, HW, 3).astype(np.float32),
            (np.arange(n) * 3 % CLASSES).astype(np.int32))


def _variables(name, seed=0):
    """flax init, every leaf moved by seeded noise, positive running
    statistics (numpy)."""
    x, _ = _batch(2)
    v = jax.tree_util.tree_map(np.asarray, _jmodel(name).init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=True))
    rng = np.random.RandomState(seed + 1)
    v = jax.tree_util.tree_map(
        lambda t: t + 0.1 * rng.randn(*t.shape).astype(t.dtype), v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda s: {"mean": s["mean"], "var": np.abs(s["var"]) + 0.5},
        v["batch_stats"], is_leaf=lambda s: "mean" in s)
    return v


def _jax_value_and_grad(name, v, x, y, train):
    model = _jmodel(name)

    def loss_fn(p):
        return jr.resnet_loss(model.apply, {"params": p,
                                            "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), jnp.asarray(y), train=train)

    (loss, new), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    logits = jax.jit(lambda p: model.apply(
        {"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
        train=train, mutable=["batch_stats"] if train else False))(v["params"])
    logits = logits[0] if train else logits
    return loss, new.get("batch_stats", {}), grads, logits


def _jax_f64_grads(monkeypatch, name, v, x, y, train):
    """JAX's gradients of the same flax model in float64 throughout: the
    convs through ``dtype``, the BatchNorms (fp32 in the model) through a
    stand-in for the module's ``nn`` whose ``BatchNorm`` takes float64."""
    import flax.linen as nn

    class Float64Norms:
        def __getattr__(self, attr):
            return getattr(nn, attr)

        @staticmethod
        def BatchNorm(*args, dtype=None, **kw):
            return nn.BatchNorm(*args, dtype=jnp.float64,
                                param_dtype=jnp.float64, **kw)

    monkeypatch.setattr(jr, "nn", Float64Norms())
    try:
        with jax.enable_x64(True):
            model = getattr(jr, name)(num_classes=CLASSES,
                                      num_filters=MODELS[name],
                                      dtype=jnp.float64)
            v64 = jax.tree_util.tree_map(
                lambda t: jnp.asarray(np.asarray(t, np.float64)), v)

            def loss_fn(p):
                return jr.resnet_loss(
                    model.apply, {"params": p, "batch_stats": v64["batch_stats"]},
                    jnp.asarray(x, jnp.float64), jnp.asarray(y), train=train)

            grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(v64["params"])
            return jax.tree_util.tree_map(np.asarray, grads)
    finally:
        monkeypatch.undo()


def _value_and_grad(params, stats, x, y, cfg, train):
    """The port's loss, new stats and gradients (a tree like params)."""
    leaves = []

    def req(t):
        t = t.detach().requires_grad_()
        leaves.append(t)
        return t

    ps = po.tree_map(req, params)
    loss, new = pr.resnet_loss(ps, stats, torch.as_tensor(x),
                               torch.as_tensor(y), cfg, train=train)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), new, po.tree_map(lambda _: next(grads), ps)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_stats_and_grads_match_flax(name, train, monkeypatch):
    v = _variables(name)
    x, y = _batch(16 if train else 8)
    jloss, jnew, jgrads, jlogits = _jax_value_and_grad(name, v, x, y, train)
    params, stats = resnet_from_flax(v, device="cpu")
    cfg = _pcfg(name)
    logits, _ = pr.resnet_forward(params, stats, torch.from_numpy(x), cfg, train)
    _close(logits.detach().numpy(), jlogits, what="logits")
    loss, new, grads = _value_and_grad(params, stats, x, y, cfg, train)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    if train:
        got, want = params_to_numpy(new), jax.tree_util.tree_map(np.asarray, jnew)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for g, w in zip(_leaves(got), _leaves(want)):
            _close(g, w, what="batch_stats")
    else:
        assert new == {}
    assert all(np.abs(g).max() > 0 for g in _leaves(jgrads))
    _close_leaves(resnet_to_flax(grads), jgrads,
                  _jax_f64_grads(monkeypatch, name, v, x, y, train), what="grads")


@pytest.mark.parametrize("size,kernel,stride", [
    (32, 3, 2), (31, 3, 2), (16, 3, 1), (32, 1, 2), (112, 3, 2), (7, 7, 2),
    (1, 3, 2), (2, 1, 2)])
def test_same_pads_is_xla_rule(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert pr.same_pads(size, kernel, stride) == tuple(want)


def test_symmetric_same_padding_is_another_model(monkeypatch):
    """Planted: (k-1)//2 on both sides, PyTorch's ``padding="same"``
    habit, moves every downsampling conv and the stem's pool by a row."""
    name = "ResNet18"
    v = _variables(name)
    x, y = _batch(8)
    *_, jlogits = _jax_value_and_grad(name, v, x, y, False)
    params, stats = resnet_from_flax(v, device="cpu")
    monkeypatch.setattr(pr, "same_pads", lambda s, k, st: ((k - 1) // 2,) * 2)
    logits, _ = pr.resnet_forward(params, stats, torch.from_numpy(x),
                                  _pcfg(name), False)
    assert _far(logits.detach().numpy(), jlogits) > 100 * TOL


def test_torch_batch_norm_is_another_model(monkeypatch):
    """Planted: ``F.batch_norm`` in train mode normalizes as flax does but
    updates ``running_var`` with the unbiased variance: the logits agree
    and the new statistics do not."""
    name = "ResNet18"
    v = _variables(name)
    x, y = _batch(16)
    _, jnew, _, jlogits = _jax_value_and_grad(name, v, x, y, True)

    def torch_norm(self, x, p, stats, path):
        mean, var = stats["mean"].clone(), stats["var"].clone()
        out = torch.nn.functional.batch_norm(
            x.float(), mean, var, p["scale"], p["bias"], training=True,
            momentum=1 - pr.MOMENTUM, eps=pr.EPSILON)
        node = self.new_stats
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"mean": mean, "var": var}
        return out

    params, stats = resnet_from_flax(v, device="cpu")
    monkeypatch.setattr(pr._Norm, "__call__", torch_norm)
    logits, new = pr.resnet_forward(params, stats, torch.from_numpy(x),
                                    _pcfg(name), True)
    _close(logits.detach().numpy(), jlogits, rel=1e-4)
    want = jax.tree_util.tree_map(np.asarray, jnew)
    got = params_to_numpy(new)
    means = [_far(g["mean"], w["mean"]) for g, w in _stat_pairs(got, want)]
    variances = [_far(g["var"], w["var"]) for g, w in _stat_pairs(got, want)]
    assert max(means) <= TOL
    assert max(variances) > 100 * TOL


def _stat_pairs(got, want):
    out = []

    def walk(g, w):
        if "mean" in w:
            out.append((g, w))
            return
        for k in w:
            walk(g[k], w[k])

    walk(got, want)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_matches_flax_tree(name):
    """``resnet_init`` gives flax's names and shapes (conv kernels in
    PyTorch's layout), zero scale on each block's last norm, zero biases,
    running means 0 and variances 1, and lecun-normal kernels."""
    x, _ = _batch(2)
    want = jax.tree_util.tree_map(np.asarray, _jmodel(name).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=True))
    params, stats = pr.resnet_init(3, _pcfg(name), device="cpu")
    got = resnet_to_flax(params)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want["params"]))
    for g, w in zip(_leaves(got), _leaves(want["params"])):
        assert g.shape == w.shape and g.dtype == np.float32
    last = "BatchNorm_2" if name == "ResNet50" else "BatchNorm_1"
    for block, p in params.items():
        if last in p:
            assert not p[last]["scale"].any()
            assert p["BatchNorm_0"]["scale"].eq(1).all()
        for mod in p.values():
            if isinstance(mod, dict) and "bias" in mod:
                assert not mod["bias"].any()
    for s, w in zip(_leaves(params_to_numpy(stats)), _leaves(want["batch_stats"])):
        np.testing.assert_array_equal(s, w)
    k = params["Dense_0"]["kernel"]
    fan_in = k.shape[0]
    assert float(k.abs().max()) <= 2 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
    big = params["conv_init"]["kernel"]
    assert abs(float(big.std()) * (3 * 49) ** 0.5 - 1.0) < 0.15


def test_convert_round_trip_is_bitwise():
    v = _variables("ResNet50")
    params, stats = resnet_from_flax(v, device="cpu")
    assert params["conv_init"]["kernel"].shape == (4, 3, 7, 7)
    back = resnet_to_flax(params)
    for g, w in zip(_leaves(back), _leaves(v["params"])):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_leaves(params_to_numpy(stats)), _leaves(v["batch_stats"])):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# sgd and the training steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inplace", [False, True], ids=["functional", "inplace"])
@pytest.mark.parametrize("kw", [dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
                                {}], ids=["momentum", "nesterov", "plain"])
def test_sgd_matches_optax(kw, inplace):
    """Three updates of ``sgd(0.1, ...)`` over a two-leaf tree: updates and
    the trace == optax's, the state nests as optax's, and the in-place
    update is bitwise the functional one."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": {"c": rng.randn(5).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda t: rng.randn(*t.shape).astype(np.float32), params) for _ in range(3)]
    jopt = optax.sgd(0.1, **kw)
    jstate = jopt.init(params)
    popt = po.sgd(0.1, **kw)
    pparams = po.tree_map(torch.from_numpy, params)
    pstate = popt.init(pparams)
    ref = po.sgd(0.1, **kw)
    rstate = ref.init(pparams)
    assert [type(s).__name__ for s in pstate] == [type(s).__name__ for s in jstate]
    for g in grads:
        jup, jstate = jopt.update(g, jstate, params)
        pg = po.tree_map(lambda t: torch.from_numpy(t.copy()), g)
        pup, pstate = popt.update(pg, pstate, pparams, inplace=inplace)
        _close(po.tree_map(lambda t: t.numpy(), pup), jup)
        if kw:
            _close(po.tree_map(lambda t: t.numpy(), pstate[0].trace),
                   jstate[0].trace)
        rup, rstate = ref.update(po.tree_map(lambda t: torch.from_numpy(t.copy()), g),
                                 rstate, pparams)
        for a, b in zip(po.tree_leaves(pup), po.tree_leaves(rup)):
            assert torch.equal(a, b)


def _jax_step(model, opt, train):
    """``examples/resnet_dp.py``'s step (train mode) or the bench's
    (``scripts/bench_configs.py:config2_resnet_dp``, ``train=False``)."""
    @jax.jit
    def step(variables, opt_state, images, labels):
        def loss_fn(params):
            return jr.resnet_loss(model.apply, {**variables, "params": params},
                                  images, labels, train=train)
        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        updates, opt_state = opt.update(grads, opt_state, variables["params"])
        params = optax.apply_updates(variables["params"], updates)
        return {**variables, "params": params, **new_state}, opt_state, loss

    return step


def _port_step(cfg, opt, train):
    """The same step in the port, from ``resnet_loss`` and ``sgd``."""
    def step(params, stats, opt_state, images, labels):
        loss, new, grads = _value_and_grad(params, stats, images, labels, cfg,
                                           train)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = po.tree_map(lambda p, u: p + u, params, updates)
        return params, (new or stats), opt_state, loss

    return step


@pytest.mark.parametrize("train", [True, False], ids=["example", "bench"])
def test_three_steps_match_jax(train):
    name = "ResNet18"
    v = _variables(name)
    x, y = _batch(16)
    jstep = _jax_step(_jmodel(name), optax.sgd(0.1, momentum=0.9), train)
    jv, jopt_state = v, optax.sgd(0.1, momentum=0.9).init(v["params"])
    popt = po.sgd(0.1, momentum=0.9)
    step = _port_step(_pcfg(name), popt, train)
    params, stats = resnet_from_flax(v, device="cpu")
    opt_state = popt.init(params)
    for i in range(3):
        jv, jopt_state, jloss = jstep(jv, jopt_state, jnp.asarray(x), jnp.asarray(y))
        params, stats, opt_state, loss = step(params, stats, opt_state, x, y)
        assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss)), i
    _close(resnet_to_flax(params), jv["params"], what="params")
    for g, w in zip(_leaves(params_to_numpy(stats)), _leaves(jv["batch_stats"])):
        _close(g, w, what="batch_stats")


# ---------------------------------------------------------------------------
# the data mesh
# ---------------------------------------------------------------------------

BODIES = r'''
import json

import numpy as np
import torch

from kubetorch_tpu_torch.models import resnet as R
from kubetorch_tpu_torch.models.convert import params_to_numpy, resnet_from_flax
from kubetorch_tpu_torch.parallel import build_mesh
from kubetorch_tpu_torch.parallel.mesh import is_dtensor
from kubetorch_tpu_torch.parallel.mesh_context import use_mesh
from kubetorch_tpu_torch.parallel.sharding import (ShardingRules, batch_sharding,
                                                   shard_pytree, to_dtensor)
from kubetorch_tpu_torch.train import optim as O

REPLICATED = ShardingRules(rules=[])


def unflat(z):
    tree = {}
    for key in z.files:
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = z[key]
    return tree


def step(params, stats, opt_state, images, labels, cfg, opt):
    """examples/resnet_dp.py's step on a mesh: images and labels sharded
    on the batch, params and stats replicated."""
    mesh = images.device_mesh
    leaves = []

    def req(t):
        t = t.detach().requires_grad_()
        leaves.append(t)
        return t

    ps = O.tree_map(req, params)
    with use_mesh(mesh):
        loss, new = R.resnet_loss(ps, stats, images, labels, cfg, train=True)
        loss = loss.full_tensor()
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = O.tree_map(lambda p: next(grads).redistribute(mesh, p.placements), ps)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = O.tree_map(lambda p, u: p + u, params, updates)
    return params, new, opt_state, loss


def run(out, rank, n, tag, per_rank_moments=False):
    cfg = R.ResNet18(num_classes=10, num_filters=8, dtype=torch.float32)
    if per_rank_moments:
        real = R.batch_moments
        R.batch_moments = lambda x, count, groups=(): real(x, x.shape[0] * x.shape[2] * x.shape[3])
    mesh = build_mesh({"data": n}, device="cpu")
    params, stats = resnet_from_flax(unflat(np.load(out / "variables.npz")), device="cpu")
    params = shard_pytree(params, REPLICATED, mesh)
    stats = shard_pytree(stats, REPLICATED, mesh)
    batch = np.load(out / "batch.npz")
    placements = batch_sharding(mesh).placements
    images = to_dtensor(torch.from_numpy(batch["x"]), mesh, placements)
    # labels stay whole on every rank, as the example passes them
    labels = torch.from_numpy(batch["y"])
    opt = O.sgd(0.1, momentum=0.9)
    opt_state = opt.init(params)
    losses = []
    for _ in range(3):
        params, stats, opt_state, loss = step(params, stats, opt_state, images,
                                              labels, cfg, opt)
        losses.append(float(loss))
    facts = {"losses": losses,
             "local_rows": images.to_local().shape[0],
             "params_replicated": all(
                 all(p.is_replicate() for p in t.placements)
                 for t in O.tree_leaves(params)),
             "image_placements": [repr(p) for p in images.placements]}
    if rank == 0:
        host = lambda t: t.full_tensor() if is_dtensor(t) else t
        np.savez(out / f"{tag}_params.npz", **flat(params_to_numpy(O.tree_map(host, params))))
        np.savez(out / f"{tag}_stats.npz", **flat(params_to_numpy(O.tree_map(host, stats))))
    (out / f"{tag}.rank{rank}.json").write_text(json.dumps(facts))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def w2(out, rank):
    run(out, rank, 2, "w2")
    run(out, rank, 2, "w2_per_rank", per_rank_moments=True)


def w4(out, rank):
    run(out, rank, 4, "w4")
'''


def _unflat(z):
    tree = {}
    for key in z.files:
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = z[key]
    return tree


def _jax_sharded(cpu_mesh_devices, v, x, y, n):
    """Three of JAX's steps with the batch over ``{"data": n}`` of the
    virtual devices (``batch_sharding``, params replicated, GSPMD's
    reductions)."""
    from kubetorch_tpu.parallel.mesh import build_mesh
    from kubetorch_tpu.parallel.sharding import batch_sharding

    mesh = build_mesh({"data": n}, devices=cpu_mesh_devices[:n])
    opt = optax.sgd(0.1, momentum=0.9)
    step = _jax_step(_jmodel("ResNet18"), opt, True)
    sh = batch_sharding(mesh)
    images, labels = jax.device_put(jnp.asarray(x), sh), jnp.asarray(y)
    variables, opt_state = v, opt.init(v["params"])
    losses = []
    for _ in range(3):
        variables, opt_state, loss = step(variables, opt_state, images, labels)
        losses.append(float(loss))
    return jax.tree_util.tree_map(np.asarray, variables), losses


@pytest.fixture(scope="module")
def data_mesh(tmp_path_factory, cpu_mesh_devices):
    out = tmp_path_factory.mktemp("resnet_mesh")
    v = _variables("ResNet18")
    x, y = _batch(16, seed=5)
    np.savez(out / "variables.npz", **_flat(v))
    np.savez(out / "batch.npz", x=x, y=y)
    errors = []

    def spawn():
        try:
            for n, name in ((2, "w2"), (4, "w4")):
                run_world(out, n, BODIES, name, timeout=300)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_out = {n: _jax_sharded(cpu_mesh_devices, v, x, y, n) for n in (2, 4)}
        jax_out[1] = _jax_sharded(cpu_mesh_devices, v, x, y, 1)
    finally:
        thread.join()
    if errors:
        raise errors[0]

    def ranks(tag, n):
        return [json.loads((out / f"{tag}.rank{r}.json").read_text())
                for r in range(n)]

    return {"dir": out, "jax": jax_out,
            "facts": {"w2": ranks("w2", 2), "w4": ranks("w4", 4),
                      "w2_per_rank": ranks("w2_per_rank", 2)}}


@pytest.mark.parametrize("n", [2, 4])
def test_data_mesh_step_matches_jax_sharded(data_mesh, n):
    tag = f"w{n}"
    jv, jlosses = data_mesh["jax"][n]
    facts = data_mesh["facts"][tag]
    for r in facts:
        assert r["losses"] == facts[0]["losses"]
        assert r["local_rows"] == 16 // n
        assert r["params_replicated"]
        assert r["image_placements"] == ["Shard(dim=0)"]
    np.testing.assert_allclose(facts[0]["losses"], jlosses, rtol=TOL, atol=0)
    params = _unflat(np.load(data_mesh["dir"] / f"{tag}_params.npz"))
    stats = _unflat(np.load(data_mesh["dir"] / f"{tag}_stats.npz"))
    j1, _ = data_mesh["jax"][1]
    for want, slack in ((j1, 0.0),
                        (jv, _far(jv["params"], j1["params"]))):
        _close(resnet_to_flax(params), want["params"], rel=TOL + slack,
               what="params")
        for g, w in zip(_leaves(stats), _leaves(want["batch_stats"])):
            _close(g, w, what="batch_stats")


def test_per_rank_moments_are_another_model(data_mesh):
    """Planted: BatchNorm moments over each rank's 8 rows only. JAX's
    sharded step is the whole batch's model (its 2-device run equals its
    1-device run), and the per-rank one departs from it."""
    jv2, _ = data_mesh["jax"][2]
    jv1, _ = data_mesh["jax"][1]
    _close(jv2["params"], jv1["params"])
    params = _unflat(np.load(data_mesh["dir"] / "w2_per_rank_params.npz"))
    stats = _unflat(np.load(data_mesh["dir"] / "w2_per_rank_stats.npz"))
    assert _far(stats, jv2["batch_stats"]) > 100 * TOL
    assert _far(resnet_to_flax(params), jv2["params"]) > 100 * TOL
