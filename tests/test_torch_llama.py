"""The port's Llama model (kubetorch_tpu_torch/models) against the JAX
model on the same inputs, made with numpy from a seed.

Tolerances (fp32 on both sides): single ops (rmsnorm, the RoPE table and
rotation) agree to 1e-5 — they differ only in the rounding of sums and of
cos/sin; logits after a 2-layer model agree to 1e-4, the same rounding
carried through the matmuls of every layer.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import generate as jax_gen
from kubetorch_tpu.models import llama as jax_llama
from kubetorch_tpu_torch.models import generate as pt_gen
from kubetorch_tpu_torch.models import llama as pt_llama
from kubetorch_tpu_torch.models.common import resolve_device
from kubetorch_tpu_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.level("unit")

TOL_OP = 1e-5
TOL_LOGITS = 1e-4
REPO = pathlib.Path(__file__).resolve().parent.parent


def np_params(cfg, seed=0):
    """A param tree in the JAX model's stacked layout, from numpy. Norm
    weights are perturbed away from 1 so they take part in the check."""
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


def jax_tiny(**kw):
    return jax_llama.LlamaConfig.tiny(dtype=jnp.float32, remat=False,
                                      attn_impl="xla", **kw)


def pt_tiny(**kw):
    kw.setdefault("attn_impl", "xla")
    return pt_llama.LlamaConfig.tiny(dtype=torch.float32, **kw)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jax_llama.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = pt_llama.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_OP, rtol=TOL_OP)


@pytest.mark.parametrize("rope_scaling", [None, (8.0, 1.0, 4.0, 64)])
def test_rope_matches_jax(rope_scaling):
    """Table and rotation, with and without the Llama-3.1 scaling band
    (orig context 64 puts frequencies on both sides of the band at
    head_dim 16). Rotation is of interleaved pairs, as in the JAX model."""
    kw = dict(rope_scaling=rope_scaling, rope_theta=10000.0)
    jcfg, pcfg = jax_tiny(**kw), pt_tiny(**kw)
    want_f = np.asarray(jax_llama.rope_freqs(jcfg, 48))
    got_f = pt_llama.rope_freqs(pcfg, 48)
    np.testing.assert_allclose(got_f.numpy(), want_f, atol=TOL_OP, rtol=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
    want = np.asarray(jax_llama.apply_rope(jnp.asarray(x), jnp.asarray(want_f)))
    got = pt_llama.apply_rope(torch.from_numpy(x), got_f)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_OP, rtol=0)


def test_rope_scaling_changes_the_table():
    a = pt_llama.rope_freqs(pt_tiny(), 32)
    b = pt_llama.rope_freqs(pt_tiny(rope_scaling=(8.0, 1.0, 4.0, 64)), 32)
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_llama_forward_logits_match_jax(attn_impl):
    """tiny in fp32, weights carried across by params_from_numpy. "flash"
    runs the flash wrapper's plain version (fp32 P) on the CPU."""
    tree = np_params(jax_tiny())
    tokens = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    want = np.asarray(jax_llama.llama_forward(to_jax(tree), jnp.asarray(tokens),
                                              jax_tiny()))
    params = params_from_numpy(tree, device="cpu")
    got = pt_llama.llama_forward(params, torch.from_numpy(tokens).long(),
                                 pt_tiny(attn_impl=attn_impl))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LOGITS, rtol=0)


def test_generate_greedy_matches_jax():
    tree = np_params(jax_tiny(), seed=3)
    prompt = np.asarray([[5, 17, 42, 7], [9, 8, 100, 3]], np.int32)
    want = np.asarray(jax_gen.generate(to_jax(tree), jnp.asarray(prompt),
                                       jax_tiny(), max_new_tokens=8))
    got = pt_gen.generate(params_from_numpy(tree, device="cpu"),
                          torch.from_numpy(prompt), pt_tiny(),
                          max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_flash_prefill_branch_matches_jax():
    """A 128-token prompt takes the flash-prefill branch (plain version on
    the CPU under attn_impl="flash"); tokens equal the JAX einsum path's."""
    tree = np_params(jax_tiny(), seed=4)
    prompt = np.random.default_rng(4).integers(0, 512, (1, 128)).astype(np.int32)
    assert pt_gen._flash_prefill_wanted(pt_tiny(attn_impl="flash"), 128,
                                        torch.device("cpu"))
    want = np.asarray(jax_gen.generate(to_jax(tree), jnp.asarray(prompt),
                                       jax_tiny(max_seq_len=256),
                                       max_new_tokens=6))
    got = pt_gen.generate(params_from_numpy(tree, device="cpu"),
                          torch.from_numpy(prompt), pt_tiny(attn_impl="flash"),
                          max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_prefill_gate():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    auto, xla = pt_tiny(attn_impl="auto"), pt_tiny(attn_impl="xla")
    assert pt_gen._flash_prefill_wanted(auto, 256, cuda)
    assert not pt_gen._flash_prefill_wanted(auto, 256, cpu)
    assert not pt_gen._flash_prefill_wanted(auto, 200, cuda)
    assert not pt_gen._flash_prefill_wanted(auto, 64, cuda)
    assert not pt_gen._flash_prefill_wanted(xla, 256, cuda)


def test_params_from_numpy_bf16_is_exact():
    """A JAX bf16 leaf arrives as ml_dtypes.bfloat16; the uint16 view keeps
    every bit."""
    rng = np.random.default_rng(5)
    arr = jnp.asarray(rng.standard_normal((3, 7)) * 100, jnp.bfloat16)
    arr = arr.at[0, 0].set(jnp.inf).at[0, 1].set(-0.0)
    leaf = np.asarray(arr)
    assert leaf.dtype.name == "bfloat16"
    got = params_from_numpy({"a": [leaf]}, device="cpu")["a"][0]
    assert got.dtype == torch.bfloat16 and got.shape == (3, 7)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  leaf.view(np.int16))


def test_llama_init_layout_and_seed():
    cfg = pt_llama.LlamaConfig.tiny()
    a = pt_llama.llama_init(cfg, seed=7, device="cpu")
    b = pt_llama.llama_init(cfg, seed=7, device="cpu")
    c = pt_llama.llama_init(cfg, seed=8, device="cpu")
    ref = jax.eval_shape(lambda: jax_llama.llama_init(jax.random.PRNGKey(0),
                                                      jax_llama.LlamaConfig.tiny()))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    for path, leaf in flat_ref:
        node = a
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert pt_llama.LlamaConfig.llama3_8b().param_count() == \
        jax_llama.LlamaConfig.llama3_8b().param_count()


def test_config_from_dict_ignores_unknown_keys():
    cfg = pt_llama.config_from_dict({"dim": 128, "n_heads": 4, "remat": False,
                                     "wire_only": 1})
    assert cfg.dim == 128 and cfg.head_dim == 32


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        pt_llama.llama_init(pt_llama.LlamaConfig.tiny())
    with pytest.raises(RuntimeError):
        pt_gen.generate({}, [[1, 2]], pt_tiny())


def test_unported_attention_impls_raise():
    """The context-parallel impls are ported (tests/test_torch_context_
    parallel.py); with no mesh installed they name the unbound axis, as
    JAX's per-shard bodies do outside shard_map. An unknown impl raises."""
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 4, 2, 16)
    for impl in ("ring", "ulysses", "ring_local", "ulysses_local"):
        with pytest.raises(NameError, match="unbound axis name: context"):
            pt_llama.attention(q, k, k, pt_tiny(attn_impl=impl))
    with pytest.raises(ValueError):
        pt_llama.attention(q, k, k, pt_tiny(attn_impl="nope"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Static scan: a sys.modules check cannot work here, because the test
    process has jax loaded already."""
    pkg = REPO / "kubetorch_tpu_torch"
    # _build/ holds built kernels and whatever else a run unpacked there
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    # every module of the package, the newest included
    for module in ("models/resnet.py", "parallel/ring_attention.py",
                   "flywheel/ledger.py", "flywheel/harvester.py",
                   "flywheel/promoter.py", "serving/elastic.py",
                   "serve/spec_engine.py", "serve/aot_cache.py",
                   "serving/warm_template.py", "serving/shm_ring.py",
                   "chaos.py", "data_store/durability.py"):
        assert pkg / module in files, module
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "kubetorch_tpu", "flax",
                                     "optax")]
    assert not bad, bad


def test_sample_logits_filters():
    """top-k 1 and a tiny top-p both leave only the argmax; temperature 0 is
    greedy; a seeded generator repeats its draw."""
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 50)).astype(np.float32))
    greedy = logits.argmax(-1)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(pt_gen.sample_logits(logits, 0.0, None), greedy)
    assert torch.equal(pt_gen.sample_logits(logits, 1.5, 1, generator=gen),
                       greedy)
    assert torch.equal(pt_gen.sample_logits(logits, 1.5, None, 1e-6,
                                            generator=gen), greedy)
    draws = [pt_gen.sample_logits(logits, 1.0, 10, 0.9,
                                  torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    want = np.asarray(jax_gen.nucleus_mask(jnp.asarray(logits.numpy()),
                                           jnp.full((3,), 0.7)))
    got = pt_gen.nucleus_mask(logits, torch.full((3,), 0.7))
    np.testing.assert_array_equal(got.numpy() > -1e29, want > -1e29)
