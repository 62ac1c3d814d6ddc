"""Serving on a device mesh in the port (kubetorch_tpu_torch/serve/engine.py
on DTensor params, spec_engine.py, parallel/ring_attention.py's
context-parallel decode, the partial mode of ops/decode_attention.py, the
ring-prefill gate and the expert gate of models/generate.py) against the
JAX package on the conftest's 8 virtual CPU devices.

The port runs in gloo worlds (``run_world``): one of 8 ranks (data2 ×
context4), one of 4 (data2 × tensor2) and one of 1, each spawned once for
the module and running all of its scenarios. The params are JAX's tiny
fp32 Llama (``llama_init``), crossing as .npz through ``models.convert``
and laid out by ``shard_pytree(..., LLAMA_RULES, mesh)``. The JAX cases,
one for one, each comparing the port's greedy tokens with JAX's engine on
the same mesh and with the single-device run:

- ``tests/test_serve_engine.py`` ``TestShardedServing`` (data2 × tensor2)
  and the six cases of ``TestContextShardedServing``: the op against the
  masked einsum at 2e-5 at the same frontiers (and its int8 variant), the
  engine, the background loop, a non-dividing ``max_len`` that keeps the
  sequence whole, the int8 cache with context sharding, and a 512-token
  prompt prefilled through ring attention;
- ``tests/test_spec_engine.py`` ``TestShardedSpec`` (tensor mesh);
- ``tests/test_kv_quant.py`` ``TestQuantSharded`` (int8 grid, tensor mesh);
- ``tests/test_generate.py`` ``test_expert_mesh_disables_gather_decode``;
- MoE and quantized trees: the MoE tree (``MOE_RULES``) on data × expert
  and on expert × tensor, Mixtral's mixed layout (int8 experts, their bank
  replicated over the live expert axis, beside int4 attention and head) on
  data × expert, one slot of the MoE tree on data × tensor (the decode
  gather on each rank's shards), and the int8 and int4 Llama trees on data
  × tensor and on data × context, each against JAX's engine on the same
  mesh and on one device (the quantized trees are JAX's, converted by
  ``models.convert`` and then laid out); and every leaf of those
  quantized trees laid out where JAX's rules put it (each quantized leaf
  replicated).

The grid cases assert that each rank holds 1/(batch × context × tensor)
of the grid's bytes and the layout's placements. Beyond JAX's cases: the
partial refs against JAX's per-shard body (its ``lax`` collectives
replaced by identities, so the body returns its shard's own m, l and acc)
at 2e-5; the step agreement (loop threads that see the submissions at
different times give the same tokens on every rank, a cancel asked on
one rank retires the request on all at the same step, a rank holding a
different request raises on every rank); the request features (prefix,
auto_prefix, chunked prefill, penalties, logit_bias, seeded sampling) on
the context mesh against the plain engine; and a world of 1, whose mesh engine's tokens, logprobs
and first-token logits are bitwise the plain engine's, on a plain tree, on
an int8 tree and with LoRA banks, where only plain params raise.
"""

import json
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kubetorch_tpu.models.generate import generate
from kubetorch_tpu.models.llama import LlamaConfig, llama_init
from kubetorch_tpu.parallel.mesh import build_mesh
from kubetorch_tpu.parallel.mesh_context import use_mesh
from kubetorch_tpu.models import quant as jq
from kubetorch_tpu.parallel.sharding import LLAMA_RULES, MOE_RULES, shard_pytree
from kubetorch_tpu.serve import GenerationEngine, SpeculativeEngine

from .test_torch_mesh_train import _flat
from .test_torch_parallel import run_world

pytestmark = pytest.mark.level("unit")

PROMPTS = [[5, 17, 42], [9, 9, 9, 9]]
N = 6

BODIES = r'''
import json
import time

import numpy as np
import torch

from kubetorch_tpu_torch.models import generate as G
from kubetorch_tpu_torch.models import llama as L
from kubetorch_tpu_torch.models import moe as M
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.parallel import LLAMA_RULES, MOE_RULES, build_mesh
from kubetorch_tpu_torch.parallel import ring_attention as R
from kubetorch_tpu_torch.parallel.mesh_context import use_mesh
from kubetorch_tpu_torch.parallel.sharding import shard_pytree, tree_paths
from kubetorch_tpu_torch.train.optim import tree_leaves
from kubetorch_tpu_torch.serve import GenerationEngine, SpeculativeEngine
from kubetorch_tpu_torch.serve import engine as E
from kubetorch_tpu_torch.serve.kv_quant import quantize_rows

PROMPTS = [[5, 17, 42], [9, 9, 9, 9]]
N = 6


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


def cfg(**kw):
    kw.setdefault("attn_impl", "xla")
    return L.LlamaConfig.tiny(dtype=torch.float32, remat=False, **kw)


def drain(eng, prompts=PROMPTS, n=N, **kw):
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def grid_facts(eng):
    leaf = eng._cache[0]
    return {"placements": [repr(p) for p in leaf.placements],
            "local_bytes": leaf.to_local().nbytes,
            "bytes": leaf.numel() * leaf.element_size()}


def features(params, c, logprobs=False, **ekw):
    """The engine's request features, one scenario each; returns the
    tokens of each (and the sampled requests' logprobs)."""
    out = {}
    def eng(**kw):
        return GenerationEngine(params, c, slots=2, max_len=64, device="cpu",
                                prefill_buckets=(4, 8, 16), **ekw, **kw)
    e = eng()
    pid = e.register_prefix([11, 12, 13, 14, 15])
    hs = [e.submit(s, max_new_tokens=5, prefix_id=pid) for s in ([21, 22], [31, 32, 33])]
    while e.step():
        pass
    out["prefix"] = [h.result(timeout=0) for h in hs]
    e = eng(auto_prefix=True)
    e.register_prefix([50, 51, 52])
    out["auto_prefix"] = drain(e, [[50, 51, 52, 60, 61], [1, 2, 3]], 5)
    out["auto_prefix_hits"] = e._prefix_hits
    e = eng(prefill_chunk=4)
    out["chunked"] = drain(e, [list(range(1, 12)), [7, 8]], 5)
    e = eng()
    out["penalties"] = drain(e, [[5, 5, 5, 6]], 8, frequency_penalty=0.7,
                             presence_penalty=0.4)
    e = eng()
    out["bias"] = drain(e, [[3, 4, 5]], 5, logit_bias={7: 5.0, 9: -3.0})
    e = eng(temperature=0.8)
    hs = [e.submit(p, max_new_tokens=6, seed=s) for p, s in zip(PROMPTS, (3, 4))]
    while e.step():
        pass
    out["sampled"] = [h.result(timeout=0) for h in hs]
    if logprobs:
        out["sampled_lp"] = [h.logprobs for h in hs]
    return out


def moe_cfg():
    return M.MoeConfig.tiny(attn_impl="xla", dtype=torch.float32, remat=False,
                            n_layers=2, n_experts=4, capacity_factor=4.0)


def quantized(out, name):
    """JAX's quantized trees of ``name``, converted: int8, and int4 (for an
    MoE tree Mixtral's mixed layout of quantize_params_int4, int8 experts)."""
    return {bits: load_tree(out / f"{name}_{bits}.npz") for bits in ("int8", "int4")}


def served(params, c, mesh, rules, **kw):
    """Greedy tokens of the PROMPTS through the mesh engine on ``params``
    laid out by ``rules``."""
    with use_mesh(mesh):
        eng = GenerationEngine(shard_pytree(params, rules, mesh), c, slots=4,
                               max_len=32, prefill_buckets=(4,), device="cpu", **kw)
        return drain(eng)


def placements(tree, rules, mesh):
    """Every leaf's placements after shard_pytree, by path."""
    sharded = shard_pytree(tree, rules, mesh)
    return {p: [repr(x) for x in t.placements] for p, t in
            zip(tree_leaves(tree_paths(sharded)), tree_leaves(sharded))}


def write(out, name, rank, data):
    (out / f"{name}.rank{rank}.json").write_text(json.dumps(data))


def load(out, name):
    return torch.from_numpy(np.load(out / f"{name}.npy"))


def w8(out, rank):
    res = {}
    params = load_tree(out / "llama.npz")
    mesh = build_mesh({"data": 2, "context": 4}, device="cpu")
    sharded = shard_pytree(params, LLAMA_RULES, mesh)

    # the op against the masked einsum (and the int8 variant)
    q, ck, cv, pos = (load(out, f"op_{t}") for t in ("q", "ck", "cv", "pos"))
    hd = q.shape[-1]
    pos = pos.to(torch.int32)
    with torch.no_grad():
        got = R.sp_decode_attention_sharded(q, ck, cv, pos, mesh, scale=hd ** -0.5)
        kq, ks = quantize_rows(ck)
        vq, vs = quantize_rows(cv)
        got_q = R.sp_decode_attention_quant_sharded(q, kq, ks, vq, vs, pos, mesh,
                                                    scale=hd ** -0.5)
    if rank == 0:
        np.save(out / "got_op.npy", got.numpy())
        np.save(out / "got_op_quant.npy", got_q.numpy())

    c = cfg()
    with use_mesh(mesh):
        eng = GenerationEngine(sharded, c, slots=4, max_len=32,
                               prefill_buckets=(4,), device="cpu")
        res["engine"] = drain(eng)
    res["engine_grid"] = grid_facts(eng)

    # the background loop: built under the mesh, driven from its thread
    with use_mesh(mesh):
        eng = GenerationEngine(sharded, c, slots=2, max_len=32,
                               prefill_buckets=(4,), device="cpu")
    eng.start()
    try:
        res["loop"] = eng.generate(PROMPTS[0], N)
    finally:
        eng.stop()
    res["loop_grid"] = grid_facts(eng)
    res["loop_thread_alive"] = eng._thread is not None and eng._thread.is_alive()

    with use_mesh(mesh):
        eng = GenerationEngine(sharded, c, slots=2, max_len=30,
                               prefill_buckets=(4,), device="cpu")
        res["dense"] = drain(eng, PROMPTS[:1])
    res["dense_grid"] = grid_facts(eng)

    with use_mesh(mesh):
        eng = GenerationEngine(sharded, c, slots=2, max_len=32,
                               prefill_buckets=(4,), quantize_kv=True,
                               device="cpu")
        res["quant"] = drain(eng, PROMPTS[:1])
    res["quant_grid"] = grid_facts(eng)

    # a long prompt: ring prefill, engaged (spied) on the mesh
    ca = cfg(attn_impl="auto")
    prompt = json.loads((out / "long_prompt.json").read_text())
    calls = []
    real = R.ring_attention_sharded
    R.ring_attention_sharded = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with use_mesh(mesh):
            eng = GenerationEngine(sharded, ca, slots=1, max_len=520,
                                   prefill_buckets=(512,), device="cpu")
            res["ring"] = drain(eng, [prompt])
    finally:
        R.ring_attention_sharded = real
    res["ring_calls"] = len(calls)
    res["ring_gate_xla"] = G._sp_prefill_impl(cfg(), 1, 512)
    with use_mesh(mesh):
        res["ring_gate_auto"] = G._sp_prefill_impl(ca, 1, 512)
        res["ring_gate_short"] = G._sp_prefill_impl(ca, 1, 256)

    # quantized trees on the context mesh
    for name, tree in quantized(out, "llama").items():
        res[f"quant_{name}"] = served(tree, c, mesh, LLAMA_RULES)

    # the request features on the mesh against the plain engine
    res["features"] = features(sharded, c, mesh=mesh)
    res["features_plain"] = features(params, c)
    write(out, "w8", rank, res)


def w4(out, rank):
    res = {}
    params = load_tree(out / "llama.npz")
    draft = load_tree(out / "draft.npz")
    mesh = build_mesh({"data": 2, "tensor": 2}, device="cpu")
    sharded = shard_pytree(params, LLAMA_RULES, mesh)
    c = cfg()
    with use_mesh(mesh):
        eng = GenerationEngine(sharded, c, slots=4, max_len=32,
                               prefill_buckets=(4,), device="cpu")
        res["engine"] = drain(eng)
    res["engine_grid"] = grid_facts(eng)
    with use_mesh(mesh):
        eng = GenerationEngine(sharded, c, slots=4, max_len=32,
                               prefill_buckets=(4,), quantize_kv=True,
                               device="cpu")
        res["quant"] = drain(eng)
    res["quant_grid"] = grid_facts(eng)
    dc = L.LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                            ffn_dim=64, attn_impl="xla", dtype=torch.float32,
                            remat=False)
    with use_mesh(mesh):
        eng = SpeculativeEngine(sharded, c, shard_pytree(draft, LLAMA_RULES, mesh),
                                dc, spec_k=2, slots=4, max_len=64,
                                prefill_buckets=(8,), device="cpu")
        hs = [eng.submit(p, max_new_tokens=N) for p in PROMPTS]
        while eng.step():
            pass
    res["spec"] = [h.result(timeout=0) for h in hs]
    res["spec_rounds"] = eng.spec_stats.rounds

    # quantized trees on data x tensor
    for name, tree in quantized(out, "llama").items():
        res[f"quant_{name}"] = served(tree, c, mesh, LLAMA_RULES)

    # the MoE tree on data x expert and expert x tensor; Mixtral's mixed
    # layout (its int8 bank replicated) on data x expert
    moe = moe_cfg()
    mparams = load_tree(out / "moe.npz")
    meshes = {"data_expert": build_mesh({"data": 2, "expert": 2}, device="cpu"),
              "expert_tensor": build_mesh({"expert": 2, "tensor": 2}, device="cpu")}
    for name, m in meshes.items():
        res[f"moe_{name}"] = served(mparams, moe, m, MOE_RULES)
    res["moe_mixed_data_expert"] = served(quantized(out, "moe")["int4"], moe,
                                          meshes["data_expert"], MOE_RULES)
    # one slot: the decode takes the K-expert gather on the expert-free mesh
    gathered = []
    real = G.moe_ffn_decode
    G.moe_ffn_decode = lambda *a, **k: gathered.append(1) or real(*a, **k)
    try:
        with use_mesh(mesh):
            eng = GenerationEngine(shard_pytree(mparams, MOE_RULES, mesh), moe,
                                   slots=1, max_len=32, prefill_buckets=(4,),
                                   device="cpu")
            res["moe_gather_data_tensor"] = drain(eng, PROMPTS[:1])
    finally:
        G.moe_ffn_decode = real
    res["moe_gather_calls"] = len(gathered)
    # where shard_pytree puts each quantized leaf
    res["placements"] = {
        "mesh": {k: list(m.mesh_dim_names) for k, m in
                 dict(meshes, data_tensor=mesh).items()},
        "llama_data_tensor": {k: placements(t, LLAMA_RULES, mesh)
                              for k, t in quantized(out, "llama").items()},
        "moe_data_expert": {k: placements(t, MOE_RULES, meshes["data_expert"])
                            for k, t in quantized(out, "moe").items()},
        "moe_expert_tensor": {k: placements(t, MOE_RULES, meshes["expert_tensor"])
                              for k, t in quantized(out, "moe").items()}}

    # the expert axis disables the gather decode (plain params)
    gathers = []
    real = G.moe_ffn_decode
    G.moe_ffn_decode = lambda *a, **k: gathers.append(1) or real(*a, **k)
    emesh = build_mesh({"data": 2, "expert": 2}, device="cpu")

    def decode_once():
        cache = G.init_cache(moe, 1, 4, device="cpu")
        return G.forward_with_cache(mparams, torch.zeros((1, 1), dtype=torch.long),
                                    cache, 0, moe)[0]

    try:
        with use_mesh(emesh):
            under = decode_once()
        res["gathers_under_expert_mesh"] = len(gathers)
        plain = decode_once()
        res["gathers_plain"] = len(gathers)
    finally:
        G.moe_ffn_decode = real
    if rank == 0:
        np.save(out / "got_moe_under.npy", under.numpy())
        np.save(out / "got_moe_plain.npy", plain.numpy())

    # the step agreement: loop threads that see the submissions apart
    eng = GenerationEngine(sharded, c, slots=2, max_len=32,
                           prefill_buckets=(4,), device="cpu", mesh=mesh)
    eng.start()
    try:
        time.sleep(0.15 * rank)
        hs = [eng.submit(p, max_new_tokens=N) for p in PROMPTS]
        time.sleep(0.1 * (3 - rank))
        hs.append(eng.submit([1, 2, 3], max_new_tokens=N))
        res["agree_loop"] = [h.result(timeout=120) for h in hs]
    finally:
        eng.stop()
    # a cancel asked on one rank retires the request on every rank
    eng = GenerationEngine(sharded, c, slots=2, max_len=32,
                           prefill_buckets=(4,), device="cpu", mesh=mesh)
    hs = [eng.submit(p, max_new_tokens=20) for p in PROMPTS]
    for _ in range(3):
        eng.step()
    if rank == 1:
        assert hs[1].cancel()
    while eng.step():
        pass
    res["agree_cancel"] = [h.result(timeout=0) for h in hs]
    # a rank holding a different request raises, on every rank
    eng = GenerationEngine(sharded, c, slots=2, max_len=32,
                           prefill_buckets=(4,), device="cpu", mesh=mesh)
    eng.submit(PROMPTS[0] if rank != 2 else [6, 6, 6], max_new_tokens=N)
    try:
        eng.step()
        res["agree_mismatch"] = None
    except RuntimeError as e:
        res["agree_mismatch"] = str(e)
    write(out, "w4", rank, res)


def w1(out, rank):
    """A world of 1: the mesh engine against the plain engine, bitwise."""
    res = {}
    params = load_tree(out / "llama.npz")
    mesh = build_mesh(None, device="cpu")
    sharded = shard_pytree(params, LLAMA_RULES, mesh)
    c = cfg()
    first = {}
    real = E._prefill_logits

    def record(*a, **k):
        got = real(*a, **k)
        first.setdefault(key, []).append(got[0].clone())
        return got

    E._prefill_logits = record
    try:
        runs = {}
        for key, p, kw in (("plain", params, {}), ("mesh", sharded, {"mesh": mesh})):
            eng = GenerationEngine(p, c, slots=2, max_len=32,
                                   prefill_buckets=(4,), device="cpu", **kw)
            hs = [eng.submit(q, max_new_tokens=N) for q in PROMPTS]
            while eng.step():
                pass
            runs[key] = ([h.result(timeout=0) for h in hs], [h.logprobs for h in hs])
    finally:
        E._prefill_logits = real
    res["tokens_equal"] = runs["plain"][0] == runs["mesh"][0]
    res["logprobs_equal"] = runs["plain"][1] == runs["mesh"][1]
    res["first_logits_equal"] = all(
        torch.equal(a, b) for a, b in zip(first["plain"], first["mesh"]))
    res["n_first"] = len(first["mesh"])
    res["mesh_agreement"] = eng._agree is not None
    res["features"] = features(sharded, c, logprobs=True, mesh=mesh)
    res["features_plain"] = features(params, c, logprobs=True)
    # a quantized tree on a mesh: the plain engine's tokens and logprobs
    qruns = {}
    q8 = quantized(out, "llama")["int8"]
    for key, p, kw in (("plain", q8, {}),
                       ("mesh", shard_pytree(q8, LLAMA_RULES, mesh), {"mesh": mesh})):
        eng = GenerationEngine(p, c, slots=2, max_len=32, prefill_buckets=(4,),
                               device="cpu", **kw)
        hs = [eng.submit(q, max_new_tokens=N) for q in PROMPTS]
        while eng.step():
            pass
        qruns[key] = ([h.result(timeout=0) for h in hs], [h.logprobs for h in hs])
    res["quantized_equal"] = qruns["plain"] == qruns["mesh"]
    # LoRA banks on a mesh: base beside two adapters, bitwise the plain
    # engine with the same banks
    from kubetorch_tpu_torch.models.lora import LoraConfig, lora_init
    lcfg = LoraConfig(rank=2)
    adapters = []
    for seed in (1, 2):
        ad = lora_init(params, lcfg, seed=seed)
        gen = torch.Generator().manual_seed(seed + 10)
        ad["layers"] = {k: v if k.endswith("__a") else
                        0.05 * torch.randn(v.shape, generator=gen)
                        for k, v in ad["layers"].items()}
        adapters.append(ad)
    lruns = {}
    for key, p, kw in (("plain", params, {}), ("mesh", sharded, {"mesh": mesh})):
        eng = GenerationEngine(p, c, slots=4, max_len=32, prefill_buckets=(4,),
                               device="cpu", **kw)
        ida, idb = (eng.register_adapter(ad, lcfg) for ad in adapters)
        hs = [eng.submit(PROMPTS[0], max_new_tokens=N),
              eng.submit(PROMPTS[1], max_new_tokens=N, adapter_id=ida),
              eng.submit(PROMPTS[0], max_new_tokens=N, adapter_id=idb)]
        while eng.step():
            pass
        lruns[key] = ([h.result(timeout=0) for h in hs], [h.logprobs for h in hs])
    res["lora_equal"] = lruns["plain"] == lruns["mesh"]
    res["lora_base_equal"] = lruns["mesh"][0][0] == runs["plain"][0][0]
    res["lora_adapted"] = lruns["mesh"][0][2] != lruns["mesh"][0][0]
    # what raises on a mesh
    raised = {}
    for name, fn in (
            ("plain_params", lambda: GenerationEngine(params, c, device="cpu", mesh=mesh)),):
        try:
            fn()
            raised[name] = None
        except Exception as e:
            raised[name] = [type(e).__name__, str(e)]
    res["raised"] = raised
    write(out, "w1", rank, res)
'''


def _cfg(**kw):
    kw.setdefault("attn_impl", "xla")
    return LlamaConfig.tiny(dtype=jnp.float32, remat=False, **kw)


def _dcfg():
    return LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                            ffn_dim=64, attn_impl="xla", dtype=jnp.float32,
                            remat=False)


def _moe_cfg():
    from kubetorch_tpu.models.moe import MoeConfig
    return MoeConfig.tiny(attn_impl="xla", dtype=jnp.float32, remat=False,
                          n_layers=2, n_experts=4, capacity_factor=4.0)


def _reference_tokens(params, cfg, prompt, n):
    out = generate(params, jnp.asarray([prompt], jnp.int32), cfg,
                   max_new_tokens=n)
    return np.asarray(out)[0, len(prompt):].tolist()


def _drain(eng, prompts, n=N, **kw):
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def _op_inputs():
    b, nh, nkv, hd, s = 4, 4, 2, 32, 64
    q = jax.random.normal(jax.random.PRNGKey(0), (b, nh, hd), jnp.float32)
    ck = jax.random.normal(jax.random.PRNGKey(1), (b, s, nkv, hd), jnp.float32)
    cv = jax.random.normal(jax.random.PRNGKey(2), (b, s, nkv, hd), jnp.float32)
    # frontiers: inside shard 0, exactly at a shard boundary, deep in the
    # last shard, and row 0
    pos = jnp.array([5, 15, 63, 0], jnp.int32)
    return q, ck, cv, pos


def _quantized(params):
    return {"int8": jq.quantize_params(params),
            "int4": jq.quantize_params_int4(params)}


def _served(params, cfg, mesh=None, rules=None, prompts=PROMPTS, slots=4):
    """JAX's engine on ``params`` (laid out by ``rules`` on ``mesh``, or on
    one device): the greedy tokens of ``prompts``."""
    if mesh is None:
        return _drain(GenerationEngine(params, cfg, slots=slots, max_len=32,
                                       prefill_buckets=(4,)), prompts)
    with use_mesh(mesh):
        return _drain(GenerationEngine(shard_pytree(params, rules, mesh), cfg,
                                       slots=slots, max_len=32,
                                       prefill_buckets=(4,)), prompts)


def _specs(tree, rules, mesh):
    """JAX's spec of every leaf after its shard_pytree, by path."""
    leaves = jax.tree_util.tree_leaves_with_path(shard_pytree(tree, rules, mesh))
    return {"/".join(k.key for k in path): tuple(v.sharding.spec)
            for path, v in leaves}


def _jax_moe_results(cpu_mesh_devices, params, moe, out):
    """JAX's engine over the quantized Llama trees on data x tensor and on
    data x context, over the MoE tree on data x expert and expert x tensor,
    over Mixtral's mixed layout on data x expert, and with one slot (the
    decode gather) on data x tensor; each also on one device; and JAX's
    specs of the quantized trees' leaves."""
    cfg, mcfg = _cfg(), _moe_cfg()
    meshes = {
        "data_tensor": build_mesh({"data": 2, "tensor": 2}, devices=cpu_mesh_devices[:4]),
        "data_context": build_mesh({"data": 2, "context": 4}, devices=cpu_mesh_devices[:8]),
        "data_expert": build_mesh({"data": 2, "expert": 2}, devices=cpu_mesh_devices[:4]),
        "expert_tensor": build_mesh({"expert": 2, "tensor": 2}, devices=cpu_mesh_devices[:4])}
    for name, tree in _quantized(params).items():
        out[f"solo_{name}"] = _served(tree, cfg)
        for m in ("data_tensor", "data_context"):
            out[f"{m}_{name}"] = _served(tree, cfg, meshes[m], LLAMA_RULES)
    out["moe_solo"] = _served(moe, mcfg)
    for m in ("data_expert", "expert_tensor"):
        out[f"moe_{m}"] = _served(moe, mcfg, meshes[m], MOE_RULES)
    mixed = jq.quantize_params_int4(moe)
    out["moe_mixed_solo"] = _served(mixed, mcfg)
    out["moe_mixed_data_expert"] = _served(mixed, mcfg, meshes["data_expert"],
                                           MOE_RULES)
    out["moe_gather_solo"] = _served(moe, mcfg, prompts=PROMPTS[:1], slots=1)
    out["moe_gather_data_tensor"] = _served(moe, mcfg, meshes["data_tensor"],
                                            MOE_RULES, PROMPTS[:1], slots=1)
    out["specs"] = {
        "llama_data_tensor": {k: _specs(t, LLAMA_RULES, meshes["data_tensor"])
                              for k, t in _quantized(params).items()},
        "moe_data_expert": {k: _specs(t, MOE_RULES, meshes["data_expert"])
                            for k, t in _quantized(moe).items()},
        "moe_expert_tensor": {k: _specs(t, MOE_RULES, meshes["expert_tensor"])
                              for k, t in _quantized(moe).items()}}


def _jax_results(cpu_mesh_devices, params, draft, long_prompt, moe):
    """Every JAX engine run the port is held to: the single-device
    references and JAX's engine on the same meshes."""
    cfg = _cfg()
    out = {"ref": [_reference_tokens(params, cfg, p, N) for p in PROMPTS]}
    _jax_moe_results(cpu_mesh_devices, params, moe, out)
    tmesh = build_mesh({"data": 2, "tensor": 2}, devices=cpu_mesh_devices[:4])
    cmesh = build_mesh({"data": 2, "context": 4}, devices=cpu_mesh_devices[:8])
    ts, cs = (shard_pytree(params, LLAMA_RULES, m) for m in (tmesh, cmesh))
    with use_mesh(tmesh):
        out["tensor"] = _drain(GenerationEngine(ts, cfg, slots=4, max_len=32,
                                                prefill_buckets=(4,)), PROMPTS)
        out["tensor_quant"] = _drain(GenerationEngine(
            ts, cfg, slots=4, max_len=32, prefill_buckets=(4,),
            quantize_kv=True), PROMPTS)
        spec = SpeculativeEngine(ts, cfg, shard_pytree(draft, LLAMA_RULES, tmesh),
                                 _dcfg(), spec_k=2, slots=4, max_len=64,
                                 prefill_buckets=(8,))
        out["spec"] = _drain(spec, PROMPTS)
    with use_mesh(cmesh):
        out["context"] = _drain(GenerationEngine(cs, cfg, slots=4, max_len=32,
                                                 prefill_buckets=(4,)), PROMPTS)
        out["dense"] = _drain(GenerationEngine(cs, cfg, slots=2, max_len=30,
                                               prefill_buckets=(4,)), PROMPTS[:1])
        out["context_quant"] = _drain(GenerationEngine(
            cs, cfg, slots=2, max_len=32, prefill_buckets=(4,),
            quantize_kv=True), PROMPTS[:1])
    solo = GenerationEngine(params, cfg, slots=4, max_len=32,
                            prefill_buckets=(4,), quantize_kv=True)
    out["solo_quant"] = [_drain(solo, [p])[0] for p in PROMPTS]
    acfg = _cfg(attn_impl="auto")
    out["ring_solo"] = _drain(GenerationEngine(params, acfg, slots=1, max_len=520,
                                               prefill_buckets=(512,)),
                              [long_prompt])
    with use_mesh(cmesh):
        out["ring"] = _drain(GenerationEngine(cs, acfg, slots=1, max_len=520,
                                              prefill_buckets=(512,)),
                             [long_prompt])
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, cpu_mesh_devices):
    from kubetorch_tpu.models.moe import moe_init

    out = tmp_path_factory.mktemp("mesh_serve")
    cfg = _cfg()
    params = llama_init(jax.random.PRNGKey(0), cfg)
    draft = llama_init(jax.random.PRNGKey(7), _dcfg())
    moe = moe_init(jax.random.PRNGKey(0), _moe_cfg())
    for name, tree in (("llama", params), ("draft", draft), ("moe", moe)):
        np.savez(out / f"{name}.npz", **_flat(jax.device_get(tree)))
        if name != "draft":
            for bits, q in _quantized(tree).items():
                np.savez(out / f"{name}_{bits}.npz", **_flat(jax.device_get(q)))
    for name, x in zip(("q", "ck", "cv", "pos"), _op_inputs()):
        np.save(out / f"op_{name}.npy", np.asarray(x))
    long_prompt = [int(x) for x in np.random.RandomState(3).randint(
        1, cfg.vocab_size, 512)]
    (out / "long_prompt.json").write_text(json.dumps(long_prompt))

    # the worlds run as subprocesses while this process runs JAX
    errors = []

    def spawn():
        try:
            for n, name in ((8, "w8"), (4, "w4"), (1, "w1")):
                run_world(out, n, BODIES, name, timeout=300)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jax_out = _jax_results(cpu_mesh_devices, params, draft, long_prompt, moe)
    finally:
        thread.join()
    if errors:
        raise errors[0]

    def ranks(name, n):
        return [json.loads((out / f"{name}.rank{r}.json").read_text())
                for r in range(n)]

    return {"dir": out, "jax": jax_out, "params": params,
            "w8": ranks("w8", 8), "w4": ranks("w4", 4), "w1": ranks("w1", 1)}


def _same_on_every_rank(results, key):
    got = results[0][key]
    assert all(r[key] == got for r in results), key
    return got


def _assert_grid(facts, shards, placements):
    assert facts["placements"] == placements
    assert facts["local_bytes"] * shards == facts["bytes"]


# -- the JAX cases, one for one ---------------------------------------------


def test_engine_matches_under_tensor_sharded_mesh(worlds):
    got = _same_on_every_rank(worlds["w4"], "engine")
    assert got == worlds["jax"]["tensor"] == worlds["jax"]["ref"]
    # slots over data, KV heads over tensor: 1/4 of the grid per rank
    _assert_grid(worlds["w4"][0]["engine_grid"], 4,
                 ["Shard(dim=1)", "Shard(dim=3)"])


def test_sp_decode_op_matches_einsum(worlds, cpu_mesh_devices):
    from kubetorch_tpu.parallel.ring_attention import (
        sp_decode_attention_sharded)

    q, ck, cv, pos = _op_inputs()
    b, nh, hd = q.shape
    s, nkv = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd)
    logits = jnp.einsum("bkgh,bskh->bkgs", qg, ck) * (hd ** -0.5)
    mask = jnp.arange(s)[None, :] <= pos[:, None]
    logits = jnp.where(mask[:, None, None], logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    want = np.asarray(jnp.einsum("bkgs,bskh->bkgh", probs, cv).reshape(b, nh, hd))
    got = np.load(worlds["dir"] / "got_op.npy")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    mesh = build_mesh({"data": 2, "context": 4}, devices=cpu_mesh_devices[:8])
    jax_got = jax.jit(lambda *a: sp_decode_attention_sharded(
        *a, mesh, scale=hd ** -0.5))(q, ck, cv, pos)
    np.testing.assert_allclose(got, np.asarray(jax_got), rtol=2e-5, atol=2e-5)


def test_sp_decode_quant_op_matches_fold_in_einsum(worlds):
    """The int8 variant against the plain fold-in einsum over the whole
    cache (the engine's int8 reference)."""
    import torch

    from kubetorch_tpu_torch.ops.decode_attention import (
        decode_attention_quant_ref)
    from kubetorch_tpu_torch.serve.kv_quant import quantize_rows

    q, ck, cv, pos = (torch.from_numpy(np.asarray(x)) for x in _op_inputs())
    kq, ks = quantize_rows(ck)
    vq, vs = quantize_rows(cv)
    want = decode_attention_quant_ref(q, kq, ks, vq, vs, pos)
    got = np.load(worlds["dir"] / "got_op_quant.npy")
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)


def test_engine_matches_under_context_sharded_mesh(worlds):
    got = _same_on_every_rank(worlds["w8"], "engine")
    assert got == worlds["jax"]["context"] == worlds["jax"]["ref"]
    # slots over data, the sequence over context: 1/8 of the grid per rank
    _assert_grid(worlds["w8"][0]["engine_grid"], 8,
                 ["Shard(dim=1)", "Shard(dim=2)"])


def test_background_loop_keeps_context_sharding(worlds):
    got = _same_on_every_rank(worlds["w8"], "loop")
    assert got == worlds["jax"]["context"][0] == worlds["jax"]["ref"][0]
    _assert_grid(worlds["w8"][0]["loop_grid"], 8,
                 ["Shard(dim=1)", "Shard(dim=2)"])
    assert not any(r["loop_thread_alive"] for r in worlds["w8"])


def test_non_dividing_shapes_fall_back_densely(worlds):
    got = _same_on_every_rank(worlds["w8"], "dense")
    assert got == worlds["jax"]["dense"] == worlds["jax"]["ref"][:1]
    # max_len 30 does not divide over context 4: the sequence stays whole
    _assert_grid(worlds["w8"][0]["dense_grid"], 2,
                 ["Shard(dim=1)", "Replicate()"])


def test_quantized_context_sharded(worlds):
    got = _same_on_every_rank(worlds["w8"], "quant")
    assert got == worlds["jax"]["context_quant"] == worlds["jax"]["solo_quant"][:1]
    _assert_grid(worlds["w8"][0]["quant_grid"], 8,
                 ["Shard(dim=1)", "Shard(dim=2)"])


def test_long_prompt_ring_prefill(worlds):
    w8 = worlds["w8"]
    got = _same_on_every_rank(w8, "ring")
    assert got == worlds["jax"]["ring"] == worlds["jax"]["ring_solo"]
    # the ring ran in every layer of the prefill, on every rank
    assert all(r["ring_calls"] == _cfg().n_layers for r in w8)
    assert w8[0]["ring_gate_auto"] == "ring"
    assert w8[0]["ring_gate_xla"] is None and w8[0]["ring_gate_short"] is None


def test_spec_engine_matches_under_tensor_sharded_mesh(worlds):
    got = _same_on_every_rank(worlds["w4"], "spec")
    assert got == worlds["jax"]["spec"] == worlds["jax"]["ref"]
    assert worlds["w4"][0]["spec_rounds"] > 0


def test_quantized_engine_under_tensor_sharded_mesh(worlds):
    got = _same_on_every_rank(worlds["w4"], "quant")
    assert got == worlds["jax"]["tensor_quant"] == worlds["jax"]["solo_quant"]
    _assert_grid(worlds["w4"][0]["quant_grid"], 4,
                 ["Shard(dim=1)", "Shard(dim=3)"])


def test_expert_mesh_disables_gather_decode(worlds):
    from kubetorch_tpu.models.generate import forward_with_cache, init_cache
    from kubetorch_tpu.models.moe import moe_init

    w4 = worlds["w4"]
    assert all(r["gathers_under_expert_mesh"] == 0 for r in w4)
    assert all(r["gathers_plain"] > 0 for r in w4)
    cfg = _moe_cfg()
    params = moe_init(jax.random.PRNGKey(0), cfg)
    want = forward_with_cache(params, jnp.zeros((1, 1), jnp.int32),
                              init_cache(cfg, 1, 4), 0, cfg)[0]
    for name in ("under", "plain"):
        np.testing.assert_allclose(np.load(worlds["dir"] / f"got_moe_{name}.npy"),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


# -- beyond JAX's cases -----------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_partial_refs_match_jax_per_shard_body(monkeypatch, quant):
    """Each shard's (m, l, acc) of the port's partial refs against JAX's
    ``sp_decode_attention[_quant]`` body with its ``lax`` collectives
    replaced: ``axis_index`` gives the shard, ``pmax`` and ``psum`` are
    identities that record their inputs (with pmax the identity, corr is
    1, so psum sees the shard's own l and acc). fp32, 2e-5."""
    import torch

    import kubetorch_tpu.parallel.ring_attention as jra
    from kubetorch_tpu.serve.kv_quant import quantize_rows as jquant
    from kubetorch_tpu_torch.ops import decode_attention as D

    q, ck, cv, pos = _op_inputs()
    b, nh, hd = q.shape
    c = 4
    s_local = ck.shape[1] // c
    for shard in range(c):
        seen = []

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def axis_index(_):
                return shard

            @staticmethod
            def pmax(x, _):
                seen.append(x)
                return x

            @staticmethod
            def psum(x, _):
                seen.append(x)
                return x

        monkeypatch.setattr(jra, "lax", Lax())
        rows = slice(shard * s_local, (shard + 1) * s_local)
        t = lambda x: torch.from_numpy(np.asarray(x))   # noqa: E731
        if quant:
            kq, ks = jquant(ck)
            vq, vs = jquant(cv)
            jra.sp_decode_attention_quant(q, kq[:, rows], ks[:, rows],
                                          vq[:, rows], vs[:, rows], pos,
                                          axis_name="context")
            got = D.decode_attention_quant_partial_ref(
                t(q), t(kq[:, rows]), t(ks[:, rows]), t(vq[:, rows]),
                t(vs[:, rows]), t(pos), shard * s_local)
        else:
            jra.sp_decode_attention(q, ck[:, rows], cv[:, rows], pos,
                                    axis_name="context")
            got = D.decode_attention_partial_ref(
                t(q), t(ck[:, rows]), t(cv[:, rows]), t(pos), shard * s_local)
        m, l, acc = (np.asarray(x) for x in seen)
        for name, g, w in (("m", got[0], m.reshape(b, nh)),
                           ("l", got[1], l.reshape(b, nh)),
                           ("acc", got[2], acc.reshape(b, nh, hd))):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5,
                                       err_msg=f"shard {shard} {name}")
        # slot 3 (pos 0) has no live row past shard 0: exactly nothing
        if shard > 0:
            assert float(got[1][3].abs().max()) == 0.0
            assert float(got[2][3].abs().max()) == 0.0


def test_step_agreement(worlds):
    w4 = worlds["w4"]
    ref = worlds["jax"]["ref"]
    # loop threads that saw the submissions at different times
    got = _same_on_every_rank(w4, "agree_loop")
    assert got[:2] == ref
    # the cancel asked on rank 1 retired the request on every rank at the
    # same step; its neighbour decoded on as alone
    cancel = _same_on_every_rank(w4, "agree_cancel")
    assert cancel[0][:N] == ref[0] and len(cancel[0]) == 20
    assert 0 < len(cancel[1]) < 20
    # rank 2 held a different request: every rank raised
    msgs = [r["agree_mismatch"] for r in w4]
    assert all(m is not None and "different requests" in m for m in msgs), msgs


def test_request_features_on_a_context_mesh(worlds):
    for r in worlds["w8"]:
        assert r["features"] == r["features_plain"]
    assert worlds["w8"][0]["features"]["auto_prefix_hits"] == 1


def test_world_of_one_is_the_plain_engine_bitwise(worlds):
    r = worlds["w1"][0]
    assert r["tokens_equal"] and r["logprobs_equal"]
    assert r["first_logits_equal"] and r["n_first"] == len(PROMPTS)
    assert not r["mesh_agreement"]
    # the request features, tokens and logprobs alike
    assert r["features"] == r["features_plain"]


def test_what_raises_on_a_mesh(worlds):
    """Only plain params raise on a mesh. A quantized tree serves, its
    tokens and logprobs those of the plain engine on the same tree, and
    so do LoRA banks: base beside two adapters, tokens and logprobs
    bitwise the plain engine with the same banks, the base request the
    bank-less engine's (the adapters' parity with JAX on larger meshes is
    in ``tests/test_torch_mesh_lora_spec.py``)."""
    r = worlds["w1"][0]
    raised = r["raised"]
    assert list(raised) == ["plain_params"]
    assert raised["plain_params"][0] == "ValueError"
    assert r["quantized_equal"] is True
    assert r["lora_equal"] is True
    assert r["lora_base_equal"] is True and r["lora_adapted"] is True


# -- MoE and quantized trees on a mesh -------------------------------------


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_quantized_tree_on_tensor_and_context_meshes(worlds, bits):
    want = worlds["jax"][f"solo_{bits}"]
    got = _same_on_every_rank(worlds["w4"], f"quant_{bits}")
    assert got == worlds["jax"][f"data_tensor_{bits}"] == want
    got = _same_on_every_rank(worlds["w8"], f"quant_{bits}")
    assert got == worlds["jax"][f"data_context_{bits}"] == want


@pytest.mark.parametrize("mesh", ["data_expert", "expert_tensor"])
def test_moe_tree_on_expert_meshes(worlds, mesh):
    got = _same_on_every_rank(worlds["w4"], f"moe_{mesh}")
    assert got == worlds["jax"][f"moe_{mesh}"] == worlds["jax"]["moe_solo"]


def test_mixtral_mixed_layout_on_an_expert_mesh(worlds):
    """int8 experts beside int4 attention and head: the int8 bank is
    replicated over the live expert axis, so each rank runs every expert
    and the FFN's output is not summed over that axis."""
    got = _same_on_every_rank(worlds["w4"], "moe_mixed_data_expert")
    assert got == worlds["jax"]["moe_mixed_data_expert"] == \
        worlds["jax"]["moe_mixed_solo"]


def test_moe_decode_gather_on_a_data_tensor_mesh(worlds):
    """One slot on a mesh with no expert axis: the K-expert gather runs on
    each rank's shards of the bank (F split over tensor)."""
    got = _same_on_every_rank(worlds["w4"], "moe_gather_data_tensor")
    assert got == worlds["jax"]["moe_gather_data_tensor"] == \
        worlds["jax"]["moe_gather_solo"]
    assert all(r["moe_gather_calls"] > 0 for r in worlds["w4"])


def _jax_placements(spec, mesh_names, ndim):
    """A JAX spec as the DTensor placements it means on a mesh of the
    port's live axes."""
    out = []
    for name in mesh_names:
        dims = [d for d, e in enumerate(tuple(spec) + (None,) * ndim)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(f"Shard(dim={dims[0]})" if dims else "Replicate()")
    return out


@pytest.mark.parametrize("case,mesh", [
    ("llama_data_tensor", "data_tensor"), ("moe_data_expert", "data_expert"),
    ("moe_expert_tensor", "expert_tensor")])
def test_shard_pytree_places_quantized_leaves_as_jax(worlds, case, mesh):
    """Every leaf of the int8 and int4 trees (for MoE the int4 tree is
    Mixtral's mixed layout) where JAX's rules put it: no rule matches a
    path that ends in __kt_q8__, __kt_q4__ or scale, so each of those is
    replicated, an int8 expert bank included."""
    got = worlds["w4"][0]["placements"]
    names = got["mesh"][mesh]
    for bits, by_path in got[case].items():
        want = worlds["jax"]["specs"][case][bits]
        assert by_path.keys() == want.keys()
        quant = [p for p in by_path
                 if p.rsplit("/", 1)[-1] in ("__kt_q8__", "__kt_q4__", "scale")]
        assert quant, bits
        for p in quant:
            assert want[p] == () and set(by_path[p]) == {"Replicate()"}, (bits, p)
        for p, pl in by_path.items():
            assert pl == _jax_placements(want[p], names, 8), (bits, p)
