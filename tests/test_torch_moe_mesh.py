"""MoE on a device mesh in the port (kubetorch_tpu_torch/models/moe.py on
DTensors: the expert FFN run on each rank's shards of an ``expert`` and
``tensor`` sharded bank, the aux term's global means, capacity over a
``context``-sharded sequence; ``moe_ffn(ep_axis=, tp_axis=)`` inside
``shard_map_fn``; ``make_train_step(mesh=, rules=MOE_RULES)`` over
``moe_loss`` and over ``lora_loss`` with an MoE base) against the JAX
package on the conftest's 8 virtual CPU devices.

The port runs in gloo worlds (``run_world``) of 8, 4 and 1 ranks, each
spawned once for the module; the params are JAX's tiny fp32 MoE
(``moe_init``), crossing as .npz through ``models.convert``. The cases:

- the twin of ``tests/test_models.py::TestMoe::test_expert_parallel_
  sharded_step``: expert 4 × fsdp 2, two ``adam(1e-2)`` steps, the losses
  within 1e-5 of JAX's sharded step, the loss falling, and ``w_gate``
  laid out as the spec ``(None, expert, fsdp, None)``; the first step's
  gradients against JAX's sharded ``grads_fn``;
- expert 2 × tensor 2 (F split over ``tensor``), the same checks;
- expert 2 × context 2 with ``capacity_factor`` 0.5, so pairs drop: the
  loss and gradients against JAX's sharded step, and the kept pairs of
  every layer counted on both sides (JAX's from its own routing and
  position formula, run eagerly) and equal;
- the aux term on a batch sharded 8 ways over fsdp against JAX's global
  aux, and the mean of the per-shard aux terms shown to be another number;
- ``lora_loss`` over an MoE base on expert 2 × fsdp 2: two steps against
  JAX's unsharded LoRA steps from the same adapters;
- ``moe_ffn(ep_axis="expert", tp_axis="tensor")`` inside the port's
  ``shard_map_fn`` against JAX's ``moe_ffn`` inside ``shard_map`` with the
  same specs, with a plain bank and with an int8 bank;
- a world of 1: the mesh step (bf16, remat ``dots``, ``default_optimizer``)
  bit for bit the plain step.

Tolerances: fp32, losses within 1e-5 of their size, each leaf's gradient
within 1e-5 of its largest entry (the tolerances of
``tests/test_torch_mesh_train.py``).
"""

import json

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from kubetorch_tpu.models import lora as jax_lora
from kubetorch_tpu.models import moe as jm
from kubetorch_tpu.models.quant import quantize_params as jax_quantize
from kubetorch_tpu.parallel.mesh import build_mesh, shard_map_fn
from kubetorch_tpu.parallel.sharding import MOE_RULES
from kubetorch_tpu.train import init_train_state as jax_init_state
from kubetorch_tpu.train import make_train_step as jax_make_step

from .test_torch_mesh_train import _assert_leaves, _flat
from .test_torch_parallel import run_world

pytestmark = pytest.mark.level("unit")

TOL = 1e-5
DROP_CAPACITY = 0.5
LORA_TARGETS = ("wq", "wv")

BODIES = r'''
import json
import numpy as np
import torch
from torch.distributed.tensor import DTensor

from kubetorch_tpu_torch.models import moe as M
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.lora import LoraConfig, lora_loss
from kubetorch_tpu_torch.parallel import MOE_RULES, build_mesh
from kubetorch_tpu_torch.parallel.mesh import PartitionSpec as P
from kubetorch_tpu_torch.parallel.mesh import shard_map_fn
from kubetorch_tpu_torch.parallel.mesh_context import use_mesh
from kubetorch_tpu_torch.parallel.sharding import (batch_sharding, shard_pytree,
                                                   to_dtensor)
from kubetorch_tpu_torch.train import (adam, default_optimizer,
                                       init_train_state, make_train_step)


def load_tree(path):
    z = np.load(path)
    tree = {}
    for key in z.files:
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = z[key]
    return params_from_numpy(tree, device="cpu")


def save_flat(path, tree, write=True):
    flat = {}

    def rec(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{prefix}/{k}" if prefix else k)
        else:
            if isinstance(t, DTensor):
                t = t.full_tensor()
            flat[prefix] = t.detach().float().cpu().numpy()

    rec(tree, "")
    if write:
        np.savez(path, **flat)


def cfg(**kw):
    kw.setdefault("attn_impl", "xla")
    return M.MoeConfig.tiny(dtype=torch.float32, remat=False, **kw)


def batch(out, name="tokens"):
    tokens = torch.from_numpy(np.load(out / f"{name}.npy")).long()
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}


def pls(t):
    return [repr(p) for p in t.placements]


def sharded_run(out, rank, name, mesh, c, steps=2):
    """The first step's gradients, then ``steps`` adam(1e-2) steps."""
    opt = adam(1e-2)
    step = make_train_step(lambda p, t, y: M.moe_loss(p, t, y, c), optimizer=opt,
                           mesh=mesh, rules=MOE_RULES)
    state = step.shard_state(init_train_state(load_tree(out / "moe.npz"), opt))
    b = batch(out)
    _, grads = step.grads_fn(state.params, b)
    save_flat(out / f"{name}_grads.npz", grads, write=rank == 0)
    losses = []
    for _ in range(steps):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "w_gate": pls(state.params["layers"]["experts"]["w_gate"]),
            "w_down": pls(state.params["layers"]["experts"]["w_down"]),
            "mesh": list(mesh.mesh_dim_names)}


def kept_counts(params, tokens, c, mesh):
    """The kept pairs of each layer's dispatch in one forward on the mesh."""
    counts = []
    real = M._dispatch

    def spy(*a, **k):
        got = real(*a, **k)
        counts.append(int(got[2].to(torch.int64).full_tensor().sum()))
        return got

    M._dispatch = spy
    try:
        with torch.no_grad(), use_mesh(mesh):
            M.moe_forward(params, tokens, c)
    finally:
        M._dispatch = real
    return counts


def eight(out, rank):
    report = {}
    # the twin of tests/test_models.py's expert-parallel step
    report["ep_fsdp"] = sharded_run(out, rank, "ep_fsdp",
                                    build_mesh({"expert": 4, "fsdp": 2}, device="cpu"),
                                    cfg())
    # the aux term on a batch sharded 8 ways
    mesh = build_mesh({"fsdp": 8}, device="cpu")
    c = cfg()
    params = load_tree(out / "moe.npz")
    tokens = torch.from_numpy(np.load(out / "tokens8.npy")).long()
    sharded = shard_pytree(params, MOE_RULES, mesh)
    tb = to_dtensor(tokens, mesh, batch_sharding(mesh).placements)
    with torch.no_grad(), use_mesh(mesh):
        _, aux = M.moe_forward(sharded, tb, c)
        # this rank's shard alone: a product of per-shard means
        _, local = M.moe_forward(params, tb.to_local(), c)
    shard_aux = torch.tensor([float(local)])
    torch.distributed.all_reduce(shard_aux)
    report["aux"] = {"mesh": float(aux.full_tensor()),
                     "mean_of_shards": float(shard_aux) / 8,
                     "tokens": pls(tb)}
    if rank == 0:
        (out / "eight.json").write_text(json.dumps(report))


def four(out, rank):
    report = {}
    report["ep_tp"] = sharded_run(out, rank, "ep_tp",
                                  build_mesh({"expert": 2, "tensor": 2}, device="cpu"),
                                  cfg())
    # capacity over a context-sharded sequence, with drops
    cmesh = build_mesh({"expert": 2, "context": 2}, device="cpu")
    dc = cfg(attn_impl="auto", capacity_factor=0.5)
    report["ep_ctx"] = sharded_run(out, rank, "ep_ctx", cmesh, dc, steps=1)
    tokens = batch(out)["tokens"]
    report["ep_ctx"]["kept"] = kept_counts(
        shard_pytree(load_tree(out / "moe.npz"), MOE_RULES, cmesh),
        to_dtensor(tokens, cmesh, batch_sharding(cmesh).placements), dc, cmesh)
    report["ep_ctx"]["tokens"] = pls(to_dtensor(tokens, cmesh,
                                                batch_sharding(cmesh).placements))

    # lora_loss over an MoE base on expert x fsdp
    lmesh = build_mesh({"fsdp": 2, "expert": 2}, device="cpu")
    c = cfg()
    lcfg = LoraConfig(rank=2, targets=("wq", "wv"))
    base = shard_pytree(load_tree(out / "moe.npz"), MOE_RULES, lmesh)
    opt = adam(1e-2)
    step = make_train_step(lora_loss(base, c, lcfg), optimizer=opt, mesh=lmesh,
                           rules=MOE_RULES)
    state = step.shard_state(init_train_state(load_tree(out / "adapters.npz"), opt))
    losses = []
    for _ in range(2):
        state, m = step(state, batch(out))
        losses.append(float(m["loss"]))
    save_flat(out / "lora_adapters.npz", state.params, write=rank == 0)
    report["lora"] = {"losses": losses,
                      "base_w_gate": pls(base["layers"]["experts"]["w_gate"])}

    # moe_ffn(ep_axis=, tp_axis=) inside shard_map_fn, plain and int8 banks
    smesh = build_mesh({"expert": 2, "tensor": 2}, device="cpu")
    x = torch.from_numpy(np.load(out / "ffn_x.npy"))
    for bank in ("plain", "int8"):
        tree = load_tree(out / f"ffn_{bank}.npz")
        names = sorted(tree)
        specs = [P(*json.loads((out / "ffn_specs.json").read_text())[bank][n])
                 for n in names]

        def body(x, *leaves):
            flat = dict(zip(names, leaves))
            lw = {"router": flat.pop("router"), "experts": {}}
            for key, v in flat.items():
                name, *sub = key.split("|")
                if sub:
                    lw["experts"].setdefault(name, {})[sub[0]] = v
                else:
                    lw["experts"][name] = v
            return M.moe_ffn(cfg(), x, lw, ep_axis="expert", tp_axis="tensor")

        got, aux = shard_map_fn()(body, mesh=smesh, in_specs=(P(), *specs),
                                  out_specs=(P(), P()))(x, *(tree[n] for n in names))
        if rank == 0:
            np.save(out / f"ffn_got_{bank}.npy", got.numpy())
        report[f"ffn_aux_{bank}"] = float(aux)
    if rank == 0:
        (out / "four.json").write_text(json.dumps(report))


def one(out, rank):
    """A world of 1: the MoE mesh step equals the plain step bit for bit."""
    c = M.MoeConfig.tiny(dtype=torch.bfloat16, remat=True)
    mesh = build_mesh({"expert": -1}, device="cpu")
    opt = default_optimizer(warmup_steps=2)
    b = batch(out)
    runs = {}
    for name, kw in (("plain", {}), ("mesh", dict(mesh=mesh, rules=MOE_RULES))):
        step = make_train_step(lambda p, t, y: M.moe_loss(p, t, y, c), opt, **kw)
        st = init_train_state(M.moe_init(c, device="cpu"), opt)
        if kw:
            st = step.shard_state(st)
        ms = []
        for _ in range(3):
            st, m = step(st, b)
            ms.append((m["loss"].item(), m["grad_norm"].item()))
        flat = {}

        def rec(t, prefix):
            if isinstance(t, dict):
                for k, v in t.items():
                    rec(v, f"{prefix}/{k}" if prefix else k)
            else:
                flat[prefix] = t.full_tensor() if isinstance(t, DTensor) else t

        rec(st.params, "")
        runs[name] = (ms, flat)
    (m0, p0), (m1, p1) = runs["plain"], runs["mesh"]
    (out / "one.json").write_text(json.dumps(
        {"metrics": [m0, m1], "params": {k: bool(torch.equal(p0[k], p1[k])) for k in p0},
         "mesh": [list(mesh.mesh_dim_names), list(mesh.shape)]}))
'''


def _cfg(**kw):
    kw.setdefault("attn_impl", "xla")
    return jm.MoeConfig.tiny(dtype=jnp.float32, remat=False, **kw)


def _tokens(shape=(4, 16), seed=1):
    return jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                              _cfg().vocab_size)


def _batch(tokens, sharding=None):
    targets = jnp.roll(tokens, -1, 1)
    if sharding is None:
        return {"tokens": tokens, "targets": targets}
    return {"tokens": jax.device_put(tokens, sharding),
            "targets": jax.device_put(targets, sharding)}


def _ffn_inputs():
    """Layer 0 of the params, an (2, 16, D) input, and the shard_map specs
    of each bank tensor (plain and int8): E over expert, F over tensor."""
    params = jm.moe_init(jax.random.PRNGKey(0), _cfg())
    lw = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 16, _cfg().dim), jnp.float32)
    banks = {"plain": lw["experts"],
             "int8": jax_quantize({"experts": lw["experts"]})["experts"]}
    ef = {"w_gate": ("expert", None, "tensor"), "w_up": ("expert", None, "tensor"),
          "w_down": ("expert", "tensor", None)}
    # an int8 scale is (E, 1, out): F over tensor where out is F
    scale = {"w_gate": ("expert", None, "tensor"), "w_up": ("expert", None, "tensor"),
             "w_down": ("expert", None, None)}
    specs = {}
    for bank, tree in banks.items():
        specs[bank] = {"router": [None, None]}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                for key in leaf:
                    specs[bank][f"{name}|{key}"] = list(
                        scale[name] if key == "scale" else ef[name])
            else:
                specs[bank][name] = list(ef[name])
    return lw, x, banks, specs


def _jax_kept_counts(params, tokens, cfg, monkeypatch):
    """The kept pairs of each layer in JAX's forward, from JAX's own routing
    and position formula (``kubetorch_tpu/models/moe.py:192-200``), run
    eagerly so the layer inputs are concrete."""
    counts = []
    real = jm.moe_ffn

    def spy(cfg, x, lw, **kw):
        b, s, _ = x.shape
        E, K = cfg.n_experts, cfg.experts_per_token
        capacity = max(1, int(cfg.capacity_factor * s * K / E))
        _, _, gate_idx = jm._route(cfg, x, lw)
        onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
        flat = onehot.reshape(b, s * K, E)
        pos = (jnp.cumsum(flat, axis=1) - flat).reshape(b, s, K, E)
        pos = jnp.sum(pos * onehot, axis=-1)
        counts.append(int(jnp.sum(pos < capacity)))
        return real(cfg, x, lw, **kw)

    monkeypatch.setattr(jm, "moe_ffn", spy)
    with jax.disable_jit():
        jm.moe_forward(params, tokens, cfg)
    monkeypatch.setattr(jm, "moe_ffn", real)
    return counts


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_mesh")
    params = jm.moe_init(jax.random.PRNGKey(0), _cfg())
    np.savez(out / "moe.npz", **_flat(jax.device_get(params)))
    np.save(out / "tokens.npy", np.asarray(_tokens()))
    np.save(out / "tokens8.npy", np.asarray(_tokens((8, 16), seed=2)))
    lcfg = jax_lora.LoraConfig(rank=2, targets=LORA_TARGETS)
    adapters = jax_lora.lora_init(jax.random.PRNGKey(3), params, lcfg)
    # B starts at 0: a random B makes the first step's loss see the adapters
    adapters["layers"] = {k: (v if k.endswith("__a") else 0.1 * jax.random.normal(
        jax.random.PRNGKey(4), v.shape, v.dtype)) for k, v in adapters["layers"].items()}
    np.savez(out / "adapters.npz", **_flat(jax.device_get(adapters)))
    _, x, banks, specs = _ffn_inputs()
    np.save(out / "ffn_x.npy", np.asarray(x))
    lw = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    for bank, tree in banks.items():
        flat = {"router": np.asarray(lw["router"])}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                flat.update({f"{name}|{k}": np.asarray(v) for k, v in leaf.items()})
            else:
                flat[name] = np.asarray(leaf)
        np.savez(out / f"ffn_{bank}.npz", **flat)
    (out / "ffn_specs.json").write_text(json.dumps(specs))
    run_world(out, 8, BODIES, "eight")
    run_world(out, 4, BODIES, "four")
    run_world(out, 1, BODIES, "one")
    return out


def _report(out, world, name):
    return json.loads((out / f"{world}.json").read_text())[name]


def _jax_sharded(mesh, cfg, steps=2):
    """JAX's sharded step on ``mesh``: the losses of ``steps`` adam(1e-2)
    steps, the first step's gradients and w_gate's spec as laid out."""
    opt = optax.adam(1e-2)
    step = jax_make_step(lambda p, t, y: jm.moe_loss(p, t, y, cfg),
                         optimizer=opt, mesh=mesh, rules=MOE_RULES)
    state = step.shard_state(jax_init_state(
        jm.moe_init(jax.random.PRNGKey(0), _cfg()), opt))
    spec = state.params["layers"]["experts"]["w_gate"].sharding.spec
    batch = _batch(_tokens(), step.batch_sharding)
    _, grads = step.grads_fn(state.params, batch)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, _flat(jax.device_get(grads)), spec


def _assert_run(worlds, world, name, mesh, cfg, steps=2):
    got = _report(worlds, world, name)
    losses, grads, spec = _jax_sharded(mesh, cfg, steps)
    np.testing.assert_allclose(got["losses"], losses, rtol=0,
                               atol=TOL * max(losses))
    z = np.load(worlds / f"{name}_grads.npz")
    _assert_leaves({k: z[k] for k in z.files}, grads, TOL)
    return got, spec


def test_expert_parallel_sharded_step(worlds, cpu_mesh_devices):
    """The twin of tests/test_models.py:86: expert 4 x fsdp 2."""
    mesh = build_mesh({"expert": 4, "fsdp": 2}, devices=cpu_mesh_devices[:8])
    got, spec = _assert_run(worlds, "eight", "ep_fsdp", mesh, _cfg())
    assert got["losses"][1] < got["losses"][0]
    assert spec == P(None, "expert", "fsdp", None)
    # the same spec as placements: mesh dims in canonical order (fsdp,
    # expert), fsdp shards dim 2 and expert dim 1
    assert got["mesh"] == ["fsdp", "expert"]
    assert got["w_gate"] == ["Shard(dim=2)", "Shard(dim=1)"]
    assert got["w_down"] == ["Shard(dim=3)", "Shard(dim=1)"]


def test_expert_tensor_sharded_step(worlds, cpu_mesh_devices):
    mesh = build_mesh({"expert": 2, "tensor": 2}, devices=cpu_mesh_devices[:4])
    got, _ = _assert_run(worlds, "four", "ep_tp", mesh, _cfg())
    assert got["losses"][1] < got["losses"][0]
    assert got["w_gate"] == ["Shard(dim=1)", "Shard(dim=3)"]
    assert got["w_down"] == ["Shard(dim=1)", "Shard(dim=2)"]


def test_expert_context_sharded_step_with_drops(worlds, cpu_mesh_devices,
                                                monkeypatch):
    """Capacity from the whole sequence, with pairs dropped: the step
    against JAX's, and the kept pairs of every layer equal to JAX's."""
    cfg = _cfg(attn_impl="auto", capacity_factor=DROP_CAPACITY)
    mesh = build_mesh({"expert": 2, "context": 2}, devices=cpu_mesh_devices[:4])
    got, _ = _assert_run(worlds, "four", "ep_ctx", mesh, cfg, steps=1)
    # the sequence is sharded over context
    assert got["tokens"] == ["Replicate()", "Shard(dim=1)"]
    want = _jax_kept_counts(jm.moe_init(jax.random.PRNGKey(0), _cfg()),
                            _tokens(), cfg, monkeypatch)
    pairs = 4 * 16 * cfg.experts_per_token
    assert got["kept"] == want
    assert all(k < pairs for k in want), (want, pairs)


def test_aux_on_an_fsdp_sharded_batch(worlds):
    """The aux term is a product of global means: on a batch sharded 8
    ways it equals JAX's unsharded aux, which the mean of the shards' own
    aux terms does not."""
    got = _report(worlds, "eight", "aux")
    assert got["tokens"] == ["Shard(dim=0)"]
    _, want = jm.moe_forward(jm.moe_init(jax.random.PRNGKey(0), _cfg()),
                             _tokens((8, 16), seed=2), _cfg())
    want = float(want)
    assert abs(got["mesh"] - want) <= 1e-6 * want
    assert abs(got["mean_of_shards"] - want) > 1e-3 * want


def test_lora_over_an_moe_base_on_a_mesh(worlds):
    """Two adam(1e-2) steps of lora_loss over the MoE base laid out on
    expert x fsdp, against JAX's unsharded LoRA steps."""
    cfg = _cfg()
    lcfg = jax_lora.LoraConfig(rank=2, targets=LORA_TARGETS)
    params = jm.moe_init(jax.random.PRNGKey(0), cfg)
    z = np.load(worlds / "adapters.npz")
    adapters = {"layers": {k.split("/", 1)[1]: jnp.asarray(z[k]) for k in z.files}}
    opt = optax.adam(1e-2)
    step = jax_make_step(jax_lora.lora_loss(params, cfg, lcfg), optimizer=opt)
    state = jax_init_state(adapters, opt)
    losses = []
    for _ in range(2):
        state, m = step(state, _batch(_tokens()))
        losses.append(float(m["loss"]))
    got = _report(worlds, "four", "lora")
    assert got["base_w_gate"] == ["Shard(dim=2)", "Shard(dim=1)"]
    np.testing.assert_allclose(got["losses"], losses, rtol=0,
                               atol=TOL * max(losses))
    a = np.load(worlds / "lora_adapters.npz")
    want = _flat(jax.device_get(state.params))
    # adam(1e-2) amplifies reduction-order bits of near-zero gradients
    # (tests/test_torch_mesh_train.py's docstring): 1e-4 of each leaf
    _assert_leaves({k: a[k] for k in a.files}, want, 1e-4)


@pytest.mark.parametrize("bank", ["plain", "int8"])
def test_moe_ffn_axes_match_jax_shard_map(worlds, cpu_mesh_devices, bank):
    lw, x, banks, specs = _ffn_inputs()
    mesh = build_mesh({"expert": 2, "tensor": 2}, devices=cpu_mesh_devices[:4])
    layer = {"router": lw["router"], "experts": banks[bank]}

    def spec_tree(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: spec_tree(v, f"{prefix}|{k}" if prefix else k)
                    for k, v in tree.items()}
        return P(*specs[bank][prefix])

    fn = shard_map_fn()(
        lambda x, lw: jm.moe_ffn(_cfg(), x, lw, ep_axis="expert", tp_axis="tensor"),
        mesh=mesh, in_specs=(P(), {"router": P(), "experts": spec_tree(banks[bank])}),
        out_specs=(P(), P()), check_vma=False)
    want, aux = jax.jit(fn)(x, layer)
    got = np.load(worlds / f"ffn_got_{bank}.npy")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    assert abs(_report(worlds, "four", f"ffn_aux_{bank}") - float(aux)) <= 1e-6
    # and both equal the unsharded FFN
    whole, _ = jm.moe_ffn(_cfg(), x, layer)
    np.testing.assert_allclose(got, np.asarray(whole), rtol=0, atol=TOL)


def test_world_of_one_moe_mesh_step_is_the_plain_step_bitwise(worlds):
    got = json.loads((worlds / "one.json").read_text())
    assert got["mesh"] == [["data"], [1]]
    assert got["metrics"][0] == got["metrics"][1]
    assert all(got["params"].values()), got["params"]
