"""The port's MoE serving path (kubetorch_tpu_torch/models/moe.py, the MoE
branch of models/generate.py and the engine over it) against the JAX
package on ``MoeConfig.tiny``, fp32, on the CPU. Inputs come from numpy
with a seed, or from ``moe_init`` on the JAX side carried across with
``params_from_numpy``.

Tolerances:

- Routing: the same expert indices, in the same order, ties included;
  gates within 1e-6 (both renormalize the same fp32 softmax).
- ``moe_ffn``/``moe_ffn_decode`` outputs: 1e-5 absolute (fp32, outputs of
  order 1; the two sides differ only in the order of fp32 sums). A
  different kept set would move a token's output by O(1).
- Quantizers and the tree conversion: equal, bit for bit.
- Logits of ``moe_forward``: 1e-4 absolute, as the JAX package's own
  prefill-vs-forward test holds them.
- ``generate`` and the engines: identical greedy tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import generate as jax_gen
from kubetorch_tpu.models import moe as jm
from kubetorch_tpu.models import quant as jq
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu_torch.models import generate as pt_gen
from kubetorch_tpu_torch.models import moe as pm
from kubetorch_tpu_torch.models import quant as pq
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.llama import layer_weights
from kubetorch_tpu_torch.serve import GenerationEngine

pytestmark = pytest.mark.level("unit")

TOL_FFN = 1e-5
TOL_LOGITS = 1e-4
PROMPTS = ([5, 17, 42], list(range(1, 41)), [9, 8], [200, 2, 7, 7, 1, 3])
NEW = (6, 5, 7, 4)


def _jcfg(**kw):
    return jm.MoeConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla",
                             **kw)


def _pcfg(**kw):
    kw.setdefault("attn_impl", "xla")
    return pm.MoeConfig.tiny(dtype=torch.float32, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(seed=1, **kw):
    """The same MoE params on both sides: (JAX tree, the port's tree)."""
    jp = jm.moe_init(jax.random.PRNGKey(seed), _jcfg(**kw))
    return jp, params_from_numpy(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def trees():
    return _both()


def _layer0(jp, pp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            layer_weights(pp, 0))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# routing and the FFN forms
# ---------------------------------------------------------------------------


def test_route_keeps_lax_top_k_order_on_ties(trees):
    """Experts 1 and 2 get the same router column, so every token ties
    them; ``lax.top_k`` puts the lower index first, and so must the port."""
    jp, pp = trees
    jlw, plw = _layer0(jp, pp)
    router = np.asarray(jlw["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 1] *= 3.0
    router[:, 2] = router[:, 1]
    x = _x((2, 16, 64))
    jlw = dict(jlw, router=jnp.asarray(router))
    plw = dict(plw, router=torch.from_numpy(router))
    _, jv, ji = jm._route(_jcfg(), jnp.asarray(x), jlw)
    probs, pv, pi = pm._route(_pcfg(), torch.from_numpy(x), plw)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
    assert torch.equal(probs[..., 1], probs[..., 2])
    # the tie decides: some tokens chose both, lower index first, and some
    # chose one of the two, which must be expert 1
    both = (pi == 1).any(-1) & (pi == 2).any(-1)
    one = (pi == 1).any(-1) ^ (pi == 2).any(-1)
    assert both.any() and one.any()
    assert not (pi[one] == 2).any()
    first = pi[both]
    assert (first[:, 0] == 1).all() and (first[:, 1] == 2).all()


def _skewed(jp, pp, bias=2.0):
    """Layer 0 with a router that sends tokens of positive mean (``_x(...)
    + 0.5``) to expert 0, so a prefill-sized batch overflows its
    capacity."""
    jlw, plw = _layer0(jp, pp)
    router = np.asarray(jlw["router"]).copy()
    router[:, 0] += bias / np.sqrt(router.shape[0])
    return (dict(jlw, router=jnp.asarray(router)),
            dict(plw, router=torch.from_numpy(router)))


def _jax_kept(cfg, x, lw, mask, limit):
    """The kept (token, k) pairs by the JAX package's formula, in numpy
    from JAX's routing: the running count per expert over (S·K) order,
    padding excluded."""
    _, _, idx = jm._route(cfg, jnp.asarray(x), lw)
    idx = np.asarray(idx)
    b, s, k = idx.shape
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[idx] * mask[:, :, None, None]
    flat = onehot.reshape(b, s * k, -1)
    pos = (np.cumsum(flat, 1) - flat).reshape(onehot.shape)
    pos = (pos * onehot).sum(-1)
    return (pos < limit) & mask[:, :, None]


def test_moe_ffn_drops_the_same_pairs_as_jax(trees):
    """A padded prefill (token_mask) at the real length's threshold
    (keep_capacity) with an overflowing expert: the port keeps the same
    pairs as JAX, drops some, and gives the same outputs."""
    jp, pp = trees
    jlw, plw = _skewed(jp, pp)
    cfg, pcfg = _jcfg(), _pcfg()
    x = _x((2, 32, 64), seed=3) + 0.5
    mask = np.ones((2, 32), bool)
    mask[0, 20:] = False
    mask[1, 27:] = False
    keep = pm.moe_prefill_keep_capacity(pcfg, 20)
    assert keep == int(np.asarray(jm.moe_prefill_keep_capacity(cfg, 20)))
    want, jaux = jm.moe_ffn(cfg, jnp.asarray(x), jlw,
                            token_mask=jnp.asarray(mask), keep_capacity=keep)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got, aux = pm.moe_ffn(pcfg, xt, plw, token_mask=mt, keep_capacity=keep)
    _, _, kept = pm._dispatch(pcfg, xt, plw, mt, keep)
    want_kept = _jax_kept(cfg, x, jlw, mask, keep)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    dropped = int((mask[:, :, None] & ~want_kept).sum())
    assert dropped > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FFN)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    # padding routes nowhere: its output rows are zero on both sides
    assert not got[0, 20:].any() and not got[1, 27:].any()


def test_moe_ffn_unmasked_and_no_drop_equal_jax(trees):
    jp, pp = trees
    jlw, plw = _skewed(jp, pp)
    x = _x((2, 24, 64), seed=4) + 0.5
    for kw in ({}, {"no_drop": True}):
        want, jaux = jm.moe_ffn(_jcfg(), jnp.asarray(x), jlw, **kw)
        got, aux = pm.moe_ffn(_pcfg(), torch.from_numpy(x), plw, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FFN)
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    _, _, kept = pm._dispatch(_pcfg(), torch.from_numpy(x), plw)
    assert not kept.all()                 # the default capacity drops here
    _, _, kept = pm._dispatch(_pcfg(), torch.from_numpy(x), plw, no_drop=True)
    assert kept.all()


@pytest.mark.parametrize("bank", ["plain", "int8"])
def test_moe_ffn_decode_equals_jax_and_the_dispatch(trees, bank):
    """At T = 1 the gather form equals JAX's and the port's own dispatch,
    over a plain and an int8 expert bank."""
    jp, pp = trees
    if bank == "int8":
        jp = jq.quantize_params(jp)
        pp = params_from_numpy(_np(jp), device="cpu")
    jlw, plw = _layer0(jp, pp)
    x = _x((3, 1, 64), seed=5)
    want = jm.moe_ffn_decode(_jcfg(), jnp.asarray(x), jlw)
    got = pm.moe_ffn_decode(_pcfg(), torch.from_numpy(x), plw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FFN)
    dense, _ = pm.moe_ffn(_pcfg(), torch.from_numpy(x), plw)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=TOL_FFN)


def test_moe_ffn_decode_rejects_int4_banks_and_axes_raise(trees,
                                                          cpu_mesh_devices):
    """The decode gather refuses an int4 bank, as JAX's does. The axes no
    longer raise: ``moe_ffn(ep_axis=, tp_axis=)`` inside the port's
    ``shard_map_fn`` over a world of 1 (both axes of size 1) equals JAX's
    inside ``shard_map`` over one device; the multi-rank cases are in
    ``tests/test_torch_moe_mesh.py``."""
    import torch.distributed as dist
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from kubetorch_tpu.parallel.mesh import shard_map_fn as jax_shard_map
    from kubetorch_tpu_torch.parallel import build_mesh
    from kubetorch_tpu_torch.parallel.mesh import PartitionSpec, shard_map_fn

    jp, pp = trees
    jlw, plw = _layer0(jp, pp)
    experts = {k: pq._quantize_leaf_int4(v) for k, v in plw["experts"].items()}
    x = _x((2, 8, 64), seed=7)
    with pytest.raises(ValueError, match="int4 expert banks"):
        pm.moe_ffn_decode(_pcfg(), torch.from_numpy(x[:, :1]),
                          dict(plw, experts=experts))
    jmesh = Mesh(np.array(cpu_mesh_devices[:1]).reshape(1, 1), ("expert", "tensor"))
    want, jaux = jax_shard_map()(
        lambda x, lw: jm.moe_ffn(_jcfg(), x, lw, ep_axis="expert", tp_axis="tensor"),
        mesh=jmesh, in_specs=(JP(), JP()), out_specs=(JP(), JP()),
        check_vma=False)(jnp.asarray(x), jlw)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = build_mesh({"expert": 1, "tensor": 1}, device="cpu")
        names = ("w_gate", "w_up", "w_down")

        def body(x, router, *bank):
            lw = {"router": router, "experts": dict(zip(names, bank))}
            return pm.moe_ffn(_pcfg(), x, lw, ep_axis="expert", tp_axis="tensor")

        e_spec = PartitionSpec("expert", None, "tensor")
        got, aux = shard_map_fn()(
            body, mesh=mesh, in_specs=(PartitionSpec(), PartitionSpec(), e_spec,
                                       e_spec, PartitionSpec("expert", "tensor", None)),
            out_specs=(PartitionSpec(), PartitionSpec()))(
            torch.from_numpy(x), plw["router"], *(plw["experts"][n] for n in names))
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FFN)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


def test_int8_gather_dequant_is_exact(trees):
    """The engine's decode gather (int8 gathered first, then dequantized)
    gives the same tokens as the same experts dequantized offline."""
    jp, _ = trees
    q = params_from_numpy(_np(jq.quantize_params(jp)), device="cpu")
    dq = pq.dequantize_params(q, torch.float32)

    def run(p):
        eng = GenerationEngine(p, _pcfg(), slots=1, max_len=32,
                               prefill_buckets=(4,), device="cpu")
        h = eng.submit([5, 6, 7], max_new_tokens=6)
        while eng.step():
            pass
        return h.result(timeout=0)

    assert run(q) == run(dq)


# ---------------------------------------------------------------------------
# quantization and conversion of MoE trees
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_moe_tree_equals_jax_bitwise(trees, kind):
    """Experts int8 under both quantizers, router and norms untouched, the
    attention and head int8 or int4: every leaf equal to JAX's."""
    jp, pp = trees
    if kind == "int8":
        want, got = jq.quantize_params(jp), pq.quantize_params(pp)
    else:
        want, got = jq.quantize_params_int4(jp), pq.quantize_params_int4(pp)
    want = _np(want)
    got_leaves = dict(_leaves(got))
    want_leaves = dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, t in got_leaves.items():
        w = want_leaves[path]
        assert t.numpy().dtype == w.dtype, path
        np.testing.assert_array_equal(t.numpy(), w, err_msg=str(path))
    experts = got["layers"]["experts"]
    assert all(pq.QKEY in v for v in experts.values())
    assert not pq.is_quantized(got["layers"]["router"])
    assert (pq.Q4KEY if kind == "int4" else pq.QKEY) in got["layers"]["wq"]


def test_params_from_numpy_carries_a_moe_tree_exactly(trees):
    """A JAX MoE tree in bf16, with an int8 expert bank beside int4
    attention, crosses as the same bits."""
    jp, _ = trees
    tree = _np(jq.quantize_params_int4(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16)
                               if a.dtype == jnp.float32 and a.ndim >= 2
                               and a.shape[-1] != 4 else a, jp)))
    got = params_from_numpy(tree, device="cpu")
    for path, leaf in _leaves(tree):
        t = _at(got, path)
        if leaf.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), leaf)
    assert got["layers"]["experts"]["w_down"][pq.QKEY].dtype == torch.int8
    assert got["embed"].dtype == torch.bfloat16


def test_config_from_dict_and_param_count():
    d = dataclasses.asdict(jm.MoeConfig.mixtral_8x7b())
    d.pop("dtype")
    cfg = pm.config_from_dict(dict(d, unknown=1))
    assert cfg == pm.MoeConfig.mixtral_8x7b()
    assert cfg.param_count() == jm.MoeConfig.mixtral_8x7b().param_count()
    assert abs(cfg.param_count() - 46.7e9) < 0.1e9


def test_moe_init_layout_matches_jax():
    cfg = _pcfg()
    got = pm.moe_init(cfg, seed=0, device="cpu")
    want = _np(jm.moe_init(jax.random.PRNGKey(0), _jcfg()))
    for path, leaf in _leaves(want):
        t = _at(got, path)
        assert tuple(t.shape) == leaf.shape and t.numpy().dtype == leaf.dtype


# ---------------------------------------------------------------------------
# forward, generate and the engine
# ---------------------------------------------------------------------------


def test_moe_forward_equals_jax(trees):
    jp, pp = trees
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    want, jaux = jm.moe_forward(jp, jnp.asarray(toks), _jcfg())
    got, aux = pm.moe_forward(pp, torch.from_numpy(toks).long(), _pcfg())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_LOGITS)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


def test_prefill_and_decode_match_full_forward():
    """With a capacity no expert overflows, the cached prefill and a
    token-by-token decode give the full forward's last logits."""
    cfg = _pcfg(capacity_factor=4.0)
    params = pm.moe_init(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    full = pm.moe_forward(params, tokens, cfg)[0][:, -1]
    cached, _ = pt_gen.forward_with_cache(params, tokens,
                                          pt_gen.init_cache(cfg, 2, 12,
                                                            device="cpu"),
                                          0, cfg)
    torch.testing.assert_close(cached, full, rtol=1e-4, atol=1e-4)
    cache = pt_gen.init_cache(cfg, 2, 12, device="cpu")
    for i in range(tokens.shape[1]):
        logits, cache = pt_gen.forward_with_cache(params, tokens[:, i:i + 1],
                                                  cache, i, cfg)
    torch.testing.assert_close(logits, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [1, 3])
def test_generate_greedy_equals_jax(trees, batch):
    """batch 1 takes the decode gather (2·1·2 <= 4), batch 3 the dispatch
    at T = 1."""
    jp, pp = trees
    prompt = np.random.default_rng(2).integers(0, 256, (batch, 5)).astype(np.int32)
    want = np.asarray(jax_gen.generate(jp, jnp.asarray(prompt), _jcfg(),
                                       max_new_tokens=6))
    got = pt_gen.generate(pp, torch.from_numpy(prompt), _pcfg(),
                          max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def drive(eng, prompts=PROMPTS, new=NEW):
    """Two requests up front, then one more per step while the grid
    decodes."""
    hs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts[:2], new[:2])]
    rest = list(zip(prompts[2:], new[2:]))
    while True:
        if rest:
            p, n = rest.pop(0)
            hs.append(eng.submit(p, max_new_tokens=n))
        if not eng.step() and not rest:
            break
    return [h.result(timeout=0) for h in hs]


ENGINE_CASES = {
    # (tree kind, slots, quantize_kv): slots 1 decodes through the gather,
    # slots 2 through the dispatch at T = 1
    "fp-gather": ("plain", 1, False),
    "fp-dispatch": ("plain", 2, False),
    "int8-kv8": ("int8", 2, True),
    "int4-mixed-kv8": ("int4", 2, True),
}


@pytest.fixture(scope="module")
def engine_trees(trees):
    jp, _ = trees
    out = {"plain": jp, "int8": jq.quantize_params(jp),
           "int4": jq.quantize_params_int4(jp)}
    return {k: (v, params_from_numpy(_np(v), device="cpu"))
            for k, v in out.items()}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_greedy_tokens_equal_jax_engine(engine_trees, case):
    kind, slots, qkv = ENGINE_CASES[case]
    jp, pp = engine_trees[kind]
    grid = dict(slots=slots, max_len=64, prefill_buckets=(8, 64),
                quantize_kv=qkv)
    want = drive(JaxEngine(jp, _jcfg(), **grid))
    got = drive(GenerationEngine(pp, _pcfg(attn_impl="flash"), **grid,
                                 device="cpu"))
    assert got == want


def test_engine_prompt_routes_alike_at_two_buckets(trees):
    """A prompt padded to a 4-row or a 32-row bucket keeps the same
    tokens: padding claims no capacity and the threshold is the real
    length's. Both equal the JAX engine's and ``generate``."""
    jp, pp = trees
    prompt, n = [5, 6, 7], 6
    want = np.asarray(jax_gen.generate(jp, jnp.asarray([prompt], jnp.int32),
                                       _jcfg(), max_new_tokens=n))[0, 3:].tolist()
    outs = []
    for buckets in ((4,), (32,)):
        for make, p, c in ((JaxEngine, jp, _jcfg()),
                           (GenerationEngine, pp, _pcfg())):
            kw = {} if make is JaxEngine else {"device": "cpu"}
            eng = make(p, c, slots=2, max_len=64, prefill_buckets=buckets, **kw)
            h = eng.submit(prompt, max_new_tokens=n)
            while eng.step():
                pass
            outs.append(h.result(timeout=0))
    assert outs == [want] * 4


def test_engine_prefix_hit_equals_jax_engine(trees):
    """A registered prefix and a prefix hit behind it, on both engines:
    the suffix routes on its own (capacity per segment) alike."""
    jp, pp = trees
    prefix, suffixes = list(range(10, 30)), ([60, 61], [7, 8, 9, 10, 11])
    runs = []
    for make, p, c in ((JaxEngine, jp, _jcfg()),
                       (GenerationEngine, pp, _pcfg())):
        kw = {} if make is JaxEngine else {"device": "cpu"}
        eng = make(p, c, slots=2, max_len=64, prefill_buckets=(8, 32),
                   auto_prefix=True, **kw)
        pid = eng.register_prefix(prefix)
        hs = [eng.submit(suffixes[0], max_new_tokens=5, prefix_id=pid),
              eng.submit(prefix + suffixes[1], max_new_tokens=5)]
        while eng.step():
            pass
        assert eng._prefix_hits == 2
        runs.append([h.result(timeout=0) for h in hs])
    assert runs[0] == runs[1]
