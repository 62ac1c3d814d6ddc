"""The serving mesh's LoRA adapter banks and speculative decoding on a
``context`` axis in the port (kubetorch_tpu_torch/models/lora.py on
DTensor activations, serve/engine.py's register/unregister on a mesh,
serve/spec_engine.py's ``_grid_ingest`` on a context-sharded grid,
parallel/ring_attention.py's windowed partial and combine) against the
JAX package on the conftest's 8 virtual CPU devices.

The port runs in one gloo world of 4 ranks (``run_world``), which builds
each 4-rank mesh in turn while this process runs JAX's engines under
``use_mesh`` on the same meshes. Params are JAX's fp32 ``llama_init``
trees and adapters JAX's ``lora_init`` factors with B drawn at random,
crossing as .npz. Everything is compared by greedy tokens, equal, not
close:

- LoRA: base requests beside two adapters, one admitted mid-decode
  (``tests/test_torch_lora.py``'s scenario), on data 2 × tensor 2,
  tensor 4 (a config whose 4 KV heads split over it), context 4, and an
  int4 tree with the int8 grid on data 2 × tensor 2; and an unregister
  and a re-register into the freed bank index mid-run. Each against
  JAX's engine on the same mesh and on one device.
- Speculation on context 4 and on data 2 × context 2, model-dtype (fp32
  here) and int8 target grids: prompts beside each other (one whose first
  window straddles a shard boundary), a prefix hit, and a chunked
  admission; against JAX's ``SpeculativeEngine`` on the same mesh and
  JAX's ``generate``. Each rank's grids hold S/c rows after the rounds.

In-process: the windowed partial and combine over 4 emulated shards
against one whole-cache ``_window_attend`` at 2e-5 (fp32 and int8
grids; bf16 at 2e-2; ``s_eff`` short of the grid, a shard with no live
row), and a planted fault (one shard's l dropped) that must fail it.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import lora as jl
from kubetorch_tpu.models import quant as jq
from kubetorch_tpu.models.generate import generate
from kubetorch_tpu.models.llama import LlamaConfig, llama_init
from kubetorch_tpu.parallel.mesh import build_mesh
from kubetorch_tpu.parallel.mesh_context import use_mesh
from kubetorch_tpu.parallel.sharding import LLAMA_RULES, shard_pytree
from kubetorch_tpu.serve import GenerationEngine, SpeculativeEngine

from .test_torch_mesh_train import _flat
from .test_torch_parallel import run_world

pytestmark = pytest.mark.level("unit")

RANK = 4
NARROW = dict(dim=256, ffn_dim=512, n_heads=4, n_kv_heads=2)
MESHES = {"data_tensor": {"data": 2, "tensor": 2}, "tensor": {"tensor": 4},
          "context": {"context": 4}, "data_context": {"data": 2, "context": 2}}
# (prompt, max_new_tokens): the last prompt's first verify window, rows
# 14..18, straddles the boundary at row 16 of a 4-way split of 64 rows
SPEC_PROMPTS = [([5, 17, 42], 8), ([9, 9, 9, 9], 6),
                (list(range(30, 44)), 8)]
SPEC_PREFIX = [11, 12, 13, 14, 15]
SPEC_LONG = list(range(60, 71))

BODIES = r'''
import json

import numpy as np
import torch

from kubetorch_tpu_torch.models import llama as L
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.lora import LoraConfig
from kubetorch_tpu_torch.parallel import LLAMA_RULES, build_mesh
from kubetorch_tpu_torch.parallel.mesh_context import use_mesh
from kubetorch_tpu_torch.parallel.sharding import shard_pytree
from kubetorch_tpu_torch.serve import GenerationEngine, SpeculativeEngine
from kubetorch_tpu_torch.serve import spec_engine as S


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
    return L.LlamaConfig.tiny(dtype=torch.float32, remat=False,
                              attn_impl="xla", **kw)


def mixed(eng, ida, idb):
    hs = [eng.submit([7, 8, 9], max_new_tokens=6),
          eng.submit([5, 17, 42], max_new_tokens=6, adapter_id=ida),
          eng.submit([9, 9, 2, 30], max_new_tokens=8, adapter_id=idb)]
    eng.step()
    hs.append(eng.submit([3, 1, 4, 1, 5], max_new_tokens=5, adapter_id=ida))
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def churn(eng, ida, idb, adapters, lcfg):
    """A and B decoding, A unregistered mid-run (its slot falls back to the
    base model), C registered into A's freed index and served."""
    hs = [eng.submit([5, 17, 42], max_new_tokens=8, adapter_id=ida),
          eng.submit([9, 9, 2, 30], max_new_tokens=8, adapter_id=idb)]
    eng.step()
    eng.step()
    assert eng.unregister_adapter(ida)
    idc = eng.register_adapter(adapters["c"], lcfg)
    hs.append(eng.submit([3, 1, 4, 1, 5], max_new_tokens=6, adapter_id=idc))
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs] + [eng._adapter_slots[idc]]


def lora(out, name, mesh_shape, c, tree, quant_kv=False):
    mesh = build_mesh(mesh_shape, device="cpu")
    adapters = {k: load_tree(out / f"adapter_{name}_{k}.npz") for k in "abc"}
    lcfg = LoraConfig(rank=4)
    with use_mesh(mesh):
        eng = GenerationEngine(shard_pytree(tree, LLAMA_RULES, mesh), c,
                               slots=4, max_len=64, prefill_buckets=(8,),
                               quantize_kv=quant_kv, device="cpu")
        ida = eng.register_adapter(adapters["a"], lcfg)
        idb = eng.register_adapter(adapters["b"], lcfg)
        res = {"mixed": mixed(eng, ida, idb)}
        eng = GenerationEngine(shard_pytree(tree, LLAMA_RULES, mesh), c,
                               slots=4, max_len=64, prefill_buckets=(8,),
                               quantize_kv=quant_kv, device="cpu")
        ida = eng.register_adapter(adapters["a"], lcfg)
        idb = eng.register_adapter(adapters["b"], lcfg)
        res["churn"] = churn(eng, ida, idb, adapters, lcfg)
        res["bank_placements"] = sorted({type(t).__name__ for ab in eng._banks.values()
                                         for t in ab})
    return res


def spec(out, mesh_shape, quant_kv):
    mesh = build_mesh(mesh_shape, device="cpu")
    params = load_tree(out / "llama.npz")
    draft = load_tree(out / "draft.npz")
    dc = L.LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                            ffn_dim=64, attn_impl="xla", dtype=torch.float32,
                            remat=False)
    prompts = json.loads((out / "spec.json").read_text())
    windows = []
    real = S._grid_ingest

    def spy(params, cache, blocks, start, *a, **k):
        windows.append([start.tolist(), blocks.shape[1]])
        return real(params, cache, blocks, start, *a, **k)

    S._grid_ingest = spy
    res = {}
    try:
        with use_mesh(mesh):
            def engine(**kw):
                return SpeculativeEngine(
                    shard_pytree(params, LLAMA_RULES, mesh), cfg(),
                    shard_pytree(draft, LLAMA_RULES, mesh), dc, spec_k=2,
                    slots=4, max_len=64, prefill_buckets=(8, 16),
                    quantize_kv=quant_kv, device="cpu", **kw)

            eng = engine()
            hs = [eng.submit(p, max_new_tokens=n) for p, n in prompts["plain"]]
            while eng.step():
                pass
            res["plain"] = [h.result(timeout=0) for h in hs]
            res["rounds"] = eng.spec_stats.rounds
            res["local_rows"] = [eng._cache[0].to_local().shape[2],
                                 eng._draft_cache[0].to_local().shape[2]]
            res["placements"] = [repr(p) for p in eng._cache[0].placements]
            pid = eng.register_prefix(prompts["prefix"])
            h = eng.submit(prompts["suffix"], max_new_tokens=6, prefix_id=pid)
            while eng.step():
                pass
            res["prefix"] = h.result(timeout=0)
            res["prefix_hits"] = eng._prefix_hits
            eng = engine(prefill_chunk=4)
            hs = [eng.submit(prompts["long"], max_new_tokens=6),
                  eng.submit([7, 8], max_new_tokens=6)]
            while eng.step():
                pass
            res["chunked"] = [h.result(timeout=0) for h in hs]
    finally:
        S._grid_ingest = real
    res["windows"] = windows
    return res


def w4(out, rank):
    params = load_tree(out / "llama.npz")
    res = {}
    res["lora_data_tensor"] = lora(out, "tiny", {"data": 2, "tensor": 2}, cfg(), params)
    res["lora_tensor"] = lora(out, "kv4", {"tensor": 4}, cfg(n_kv_heads=4),
                              load_tree(out / "llama_kv4.npz"))
    res["lora_context"] = lora(out, "tiny", {"context": 4}, cfg(), params)
    res["lora_int4"] = lora(out, "narrow", {"data": 2, "tensor": 2},
                            cfg(dim=256, ffn_dim=512, n_heads=4, n_kv_heads=2),
                            load_tree(out / "narrow_int4.npz"), quant_kv=True)
    for name, shape in (("context", {"context": 4}),
                        ("data_context", {"data": 2, "context": 2})):
        for kv in (False, True):
            res[f"spec_{name}_{'int8' if kv else 'fp'}"] = spec(out, shape, kv)
    (out / f"w4.rank{rank}.json").write_text(json.dumps(res))
'''


def _cfg(**kw):
    return LlamaConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla",
                            **kw)


def _dcfg():
    return LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                            ffn_dim=64, attn_impl="xla", dtype=jnp.float32,
                            remat=False)


def _adapter(seed, params, lcfg):
    """JAX ``lora_init`` factors with B drawn at random (numpy)."""
    ad = jax.tree_util.tree_map(np.asarray, jl.lora_init(
        jax.random.PRNGKey(seed), params, lcfg))
    rng = np.random.default_rng(seed + 1000)
    ad["layers"] = {k: (v if k.endswith("__a") else
                        (rng.standard_normal(v.shape) * 0.05).astype(v.dtype))
                    for k, v in ad["layers"].items()}
    return ad


def _mixed(eng, ida, idb):
    hs = [eng.submit([7, 8, 9], max_new_tokens=6),
          eng.submit([5, 17, 42], max_new_tokens=6, adapter_id=ida),
          eng.submit([9, 9, 2, 30], max_new_tokens=8, adapter_id=idb)]
    eng.step()
    hs.append(eng.submit([3, 1, 4, 1, 5], max_new_tokens=5, adapter_id=ida))
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs]


def _churn(eng, ida, idb, adapters, lcfg):
    hs = [eng.submit([5, 17, 42], max_new_tokens=8, adapter_id=ida),
          eng.submit([9, 9, 2, 30], max_new_tokens=8, adapter_id=idb)]
    eng.step()
    eng.step()
    assert eng.unregister_adapter(ida)
    idc = eng.register_adapter(adapters["c"], lcfg)
    hs.append(eng.submit([3, 1, 4, 1, 5], max_new_tokens=6, adapter_id=idc))
    while eng.step():
        pass
    return [h.result(timeout=0) for h in hs] + [eng._adapter_slots[idc]]


def _jax_lora(tree, cfg, adapters, mesh=None, quant_kv=False):
    lcfg = jl.LoraConfig(rank=4)

    def engine():
        t = tree if mesh is None else shard_pytree(tree, LLAMA_RULES, mesh)
        eng = GenerationEngine(t, cfg, slots=4, max_len=64,
                               prefill_buckets=(8,), quantize_kv=quant_kv)
        return (eng, eng.register_adapter(adapters["a"], lcfg),
                eng.register_adapter(adapters["b"], lcfg))

    def run():
        out = {"mixed": _mixed(*engine())}
        out["churn"] = _churn(*engine(), adapters, lcfg)
        return out

    if mesh is None:
        return run()
    with use_mesh(mesh):
        return run()


def _jax_spec(params, draft, cfg, mesh, quant_kv, prompts):
    def engine(**kw):
        return SpeculativeEngine(
            shard_pytree(params, LLAMA_RULES, mesh), cfg,
            shard_pytree(draft, LLAMA_RULES, mesh), _dcfg(), spec_k=2,
            slots=4, max_len=64, prefill_buckets=(8, 16),
            quantize_kv=quant_kv, **kw)

    out = {}
    with use_mesh(mesh):
        eng = engine()
        hs = [eng.submit(p, max_new_tokens=n) for p, n in prompts["plain"]]
        while eng.step():
            pass
        out["plain"] = [h.result(timeout=0) for h in hs]
        pid = eng.register_prefix(prompts["prefix"])
        h = eng.submit(prompts["suffix"], max_new_tokens=6, prefix_id=pid)
        while eng.step():
            pass
        out["prefix"] = h.result(timeout=0)
        eng = engine(prefill_chunk=4)
        hs = [eng.submit(prompts["long"], max_new_tokens=6),
              eng.submit([7, 8], max_new_tokens=6)]
        while eng.step():
            pass
        out["chunked"] = [h.result(timeout=0) for h in hs]
    return out


def _generate(params, cfg, prompt, n):
    got = generate(params, jnp.asarray([prompt], jnp.int32), cfg,
                   max_new_tokens=n)
    return np.asarray(got)[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def world(tmp_path_factory, cpu_mesh_devices):
    out = tmp_path_factory.mktemp("mesh_lora_spec")
    cfg, kv4, narrow = _cfg(), _cfg(n_kv_heads=4), _cfg(**NARROW)
    params = llama_init(jax.random.PRNGKey(0), cfg)
    params_kv4 = llama_init(jax.random.PRNGKey(1), kv4)
    params_narrow = llama_init(jax.random.PRNGKey(3), narrow)
    draft = llama_init(jax.random.PRNGKey(7), _dcfg())
    narrow_int4 = jq.quantize_params_int4(params_narrow)
    lcfg = jl.LoraConfig(rank=4)
    adapters = {name: {k: _adapter(seed, base, lcfg)
                       for k, seed in zip("abc", (7, 8, 9))}
                for name, base in (("tiny", params), ("kv4", params_kv4),
                                   ("narrow", params_narrow))}
    for name, tree in (("llama", params), ("llama_kv4", params_kv4),
                       ("draft", draft), ("narrow_int4", narrow_int4)):
        np.savez(out / f"{name}.npz", **_flat(jax.device_get(tree)))
    for name, ads in adapters.items():
        for k, ad in ads.items():
            np.savez(out / f"adapter_{name}_{k}.npz", **_flat(ad))
    prompts = {"plain": SPEC_PROMPTS, "prefix": SPEC_PREFIX,
               "suffix": [21, 22, 23], "long": SPEC_LONG}
    (out / "spec.json").write_text(json.dumps(prompts))

    errors = []

    def spawn():
        try:
            run_world(out, RANK, BODIES, "w4", timeout=400)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        meshes = {k: build_mesh(v, devices=cpu_mesh_devices[:RANK])
                  for k, v in MESHES.items()}
        jax_out = {
            "lora_data_tensor": _jax_lora(params, cfg, adapters["tiny"],
                                          meshes["data_tensor"]),
            "lora_tensor": _jax_lora(params_kv4, kv4, adapters["kv4"],
                                     meshes["tensor"]),
            "lora_context": _jax_lora(params, cfg, adapters["tiny"],
                                      meshes["context"]),
            "lora_int4": _jax_lora(narrow_int4, narrow, adapters["narrow"],
                                   meshes["data_tensor"], quant_kv=True),
            "solo_tiny": _jax_lora(params, cfg, adapters["tiny"]),
            "solo_kv4": _jax_lora(params_kv4, kv4, adapters["kv4"]),
            "solo_int4": _jax_lora(narrow_int4, narrow, adapters["narrow"],
                                   quant_kv=True)}
        for name in ("context", "data_context"):
            for kv in (False, True):
                jax_out[f"spec_{name}_{'int8' if kv else 'fp'}"] = _jax_spec(
                    params, draft, cfg, meshes[name], kv, prompts)
        jax_out["base_5_17_42"] = _generate(params, cfg, [5, 17, 42], 6)
        jax_out["generate"] = {
            "plain": [_generate(params, cfg, p, n) for p, n in SPEC_PROMPTS],
            "prefix": _generate(params, cfg, SPEC_PREFIX + [21, 22, 23], 6),
            "chunked": [_generate(params, cfg, SPEC_LONG, 6),
                        _generate(params, cfg, [7, 8], 6)]}
    finally:
        thread.join()
    if errors:
        raise errors[0]
    ranks = [json.loads((out / f"w4.rank{r}.json").read_text())
             for r in range(RANK)]
    return {"jax": jax_out, "ranks": ranks}


def _same_on_every_rank(world, key):
    got = world["ranks"][0][key]
    assert all(r[key] == got for r in world["ranks"]), key
    return got


# -- LoRA banks on a mesh ----------------------------------------------------


@pytest.mark.parametrize("mesh,solo", [
    ("data_tensor", "solo_tiny"), ("tensor", "solo_kv4"),
    ("context", "solo_tiny"), ("int4", "solo_int4")])
def test_lora_banks_match_jax_under_mesh(world, mesh, solo):
    got = _same_on_every_rank(world, f"lora_{mesh}")
    want = world["jax"][f"lora_{mesh}"]
    assert got["mixed"] == want["mixed"] == world["jax"][solo]["mixed"]
    # the banks stay plain tensors, whole on every rank
    assert got["bank_placements"] == ["Tensor"]
    # the adapters do something: A's request is not the base model's
    if solo == "solo_tiny":
        assert got["mixed"][1] != world["jax"]["base_5_17_42"]


@pytest.mark.parametrize("mesh", ["data_tensor", "tensor", "context", "int4"])
def test_unregister_and_reregister_mid_run_match_jax(world, mesh):
    got = _same_on_every_rank(world, f"lora_{mesh}")["churn"]
    want = world["jax"][f"lora_{mesh}"]["churn"]
    assert got == want
    # C took A's freed bank index
    assert got[-1] == 1


# -- speculative decoding on a context axis ---------------------------------


SPEC_CASES = [f"spec_{m}_{kv}" for m in ("context", "data_context")
              for kv in ("fp", "int8")]


@pytest.mark.parametrize("case", SPEC_CASES)
def test_spec_engine_on_a_context_axis_matches_jax(world, case):
    got = _same_on_every_rank(world, case)
    want = world["jax"][case]
    ref = world["jax"]["generate"]
    for key in ("plain", "prefix", "chunked"):
        assert got[key] == want[key], key
    # the fp grid is exact against generate (the int8 grid is JAX's int8
    # engine's, compared above)
    if case.endswith("fp"):
        assert got["plain"] == ref["plain"]
        assert got["prefix"] == ref["prefix"]
        assert got["chunked"] == ref["chunked"]
    assert got["rounds"] > 0 and got["prefix_hits"] == 1


@pytest.mark.parametrize("case", SPEC_CASES)
def test_spec_grids_stay_split_over_context(world, case):
    """Each rank holds S/c rows of the target's and the draft's grid after
    the rounds: nothing gathered the sequence."""
    c = 2 if "data_context" in case else 4
    for r in world["ranks"]:
        assert r[case]["local_rows"] == [64 // c, 64 // c]
        assert "Shard(dim=2)" in r[case]["placements"]


def test_a_window_straddles_a_shard_boundary(world):
    """Some verify window of the context-4 run spans row 16, the boundary
    between shards 0 and 1."""
    windows = world["ranks"][0]["spec_context_fp"]["windows"]
    assert any(s < 16 < s + w for starts, w in windows for s in starts if s)


# -- the windowed partial and combine, in one process ----------------------


def _window_inputs(quant, seed=0, dtype=torch.float32):
    from kubetorch_tpu_torch.serve.kv_quant import quantize_rows

    g = torch.Generator().manual_seed(seed)
    b, w, nh, nkv, hd, s = 3, 5, 4, 2, 16, 64
    q = torch.randn(b, w, nh, hd, generator=g).to(dtype)
    ck = torch.randn(b, s, nkv, hd, generator=g).to(dtype)
    cv = torch.randn(b, s, nkv, hd, generator=g).to(dtype)
    # slot 0 inside shard 0, slot 1 straddling rows 16, slot 2 deep
    start = torch.tensor([3, 14, 40])
    posm = start[:, None] + torch.arange(w)[None, :]
    layer = (ck, cv)
    if quant:
        kq, ks = quantize_rows(ck)
        vq, vs = quantize_rows(cv)
        layer = (kq, ks, vq, vs)
    return q, layer, posm


def _whole(q, layer, posm, s_eff):
    """One whole-cache ``_window_attend`` (fp grid). Its writes put each
    row at posm back with its own value: the attention is what is held."""
    from kubetorch_tpu_torch.serve.spec_engine import _window_attend

    ck, cv = (t.clone() for t in layer)
    b = posm.shape[0]
    mask = (torch.arange(s_eff)[None, None, :] <= posm[:, :, None])[:, None, None]
    bi = torch.arange(b)[:, None]
    return _window_attend(q, ck[bi, posm], cv[bi, posm], (ck, cv), bi, posm,
                          mask, s_eff, q.shape[-1] ** -0.5, q.dtype)


def _partials(q, layer, posm, s_eff, shards=4):
    from kubetorch_tpu_torch.parallel.ring_attention import (
        window_attention_partial)

    n = layer[0].shape[1] // shards
    parts = [window_attention_partial(
        q, tuple(t[:, i * n:(i + 1) * n] for t in layer), posm, i * n, s_eff,
        q.shape[-1] ** -0.5) for i in range(shards)]
    return [torch.stack(x) for x in zip(*parts)]


def _whole_quant(q, layer, posm, s_eff):
    """``_window_attend``'s int8 branch without its writes: the same
    einsums over the first s_eff rows."""
    from kubetorch_tpu_torch.models.generate import NEG_INF

    kq, ks, vq, vs = layer
    b, w, nh, hd = q.shape
    nkv = kq.shape[2]
    qg = q.reshape(b, w, nkv, nh // nkv, hd)
    mask = (torch.arange(s_eff)[None, None, :] <= posm[:, :, None])[:, None, None]
    logits = torch.einsum("bwkgh,bskh->bkgws", qg.float(),
                          kq[:, :s_eff].float()) * hd ** -0.5
    logits = logits * ks[:, :s_eff].transpose(1, 2)[:, :, None, None, :]
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    probs = probs * vs[:, :s_eff].transpose(1, 2)[:, :, None, None, :]
    return torch.einsum("bkgws,bskh->bwkgh", probs,
                        vq[:, :s_eff].float()).reshape(b, w, nh, hd)


@pytest.mark.parametrize("s_eff", [64, 32])
@pytest.mark.parametrize("grid", ["fp32", "int8", "bf16"])
def test_windowed_partial_and_combine_match_whole_cache(grid, s_eff):
    """fp32 and int8 grids at 2e-5; the bf16 grid at 2e-2 (the whole-cache
    einsum takes P·V in bf16, the partials in fp32 over P rounded to
    bf16: the bf16 rounding of the output apart)."""
    from kubetorch_tpu_torch.ops.decode_attention import combine_partials

    quant = grid == "int8"
    q, layer, posm = _window_inputs(
        quant, dtype=torch.bfloat16 if grid == "bf16" else torch.float32)
    want = (_whole_quant(q, layer, posm, s_eff) if quant
            else _whole(q, layer, posm, s_eff))
    m, l, acc = _partials(q, layer, posm, s_eff)
    got = combine_partials(m, l, acc, dtype=want.dtype)
    tol = 2e-2 if grid == "bf16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # shard 3 (rows 48..63) holds no live row for slots 0 and 1, and past
    # s_eff = 32 none at all: exactly nothing
    assert float(l[3, 0].abs().max()) == 0.0 and float(acc[3, 0].abs().max()) == 0.0
    assert float(m[3, 0].max()) == float(torch.tensor(-1e29))
    if s_eff == 32:
        assert float(l[2:].abs().max()) == 0.0
    # planted: one shard's l dropped
    bad = l.clone()
    bad[1] = 0.0
    assert (combine_partials(m, bad, acc) - want.float()).abs().max() > 10 * tol
