"""The port's HF checkpoint import/export (kubetorch_tpu_torch/models/
convert_hf.py) against the JAX package's and against HF's own forward.

Every converted leaf must be bit-equal to the JAX package's conversion
(the same fp32 widening and round-to-nearest-even), from bf16, fp16 and
fp32 sources, for Llama (tied and untied head), Mixtral and Llama-3.1's
rope scaling; the port's fp32 logits are within 1e-5 relative L2 of HF's
forward (fp32 on both sides, summed in another order). Directories cross
between the packages bitwise both ways. Tiny randomly-initialized HF
models, nothing downloaded.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import convert_hf as J
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.models.moe import MoeConfig as JaxMoeConfig
from kubetorch_tpu_torch import models as pt_models
from kubetorch_tpu_torch.models import convert_hf as P
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.generate import generate
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_forward
from kubetorch_tpu_torch.models.moe import MoeConfig, moe_forward
from kubetorch_tpu_torch.models.quant import quantize_params

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

TOL_LOGITS = 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent
TOKENS = torch.tensor([[3, 17, 99, 4, 250, 8, 1, 42],
                       [5, 5, 200, 31, 7, 77, 13, 2]])
SOURCES = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "fp16": torch.float16}


def _transformers():
    return pytest.importorskip("transformers")


def _llama_hf_config(tie=False, **kw):
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=128, rms_norm_eps=1e-5,
             rope_theta=10000.0, tie_word_embeddings=tie)
    d.update(kw)
    return _transformers().LlamaConfig(**d)


def _hf_llama(tie=False, seed=0, **kw):
    cfg = _llama_hf_config(tie, **kw)
    torch.manual_seed(seed)
    return _transformers().LlamaForCausalLM(cfg).eval(), cfg


def _hf_mixtral(seed=1, **kw):
    tf = _transformers()
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             num_local_experts=4, num_experts_per_tok=2,
             max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=1e6,
             sliding_window=None, output_router_logits=False)
    d.update(kw)
    cfg = tf.MixtralConfig(**d)
    torch.manual_seed(seed)
    return tf.MixtralForCausalLM(cfg).eval(), cfg


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(tokens).logits.float()


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _bits(x) -> np.ndarray:
    """A leaf's bits as numpy: bf16 (numpy's ml_dtypes, or torch) as
    uint16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_tree_bitwise(want, got, path="params"):
    """Same nesting, shapes, dtypes and bits; ``want`` is a JAX (or port)
    tree, ``got`` the port's."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), path
        for k in want:
            assert_tree_bitwise(want[k], got[k], f"{path}.{k}")
        return
    a, b = _bits(want), _bits(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b), path


def _pt_tree_as_jax(params):
    """A port fp32 tree as the JAX package's arrays."""
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("tie", [False, True])
def test_llama_params_bitwise_jax_and_logits_parity(tie, src):
    model, hf_cfg = _hf_llama(tie=tie)
    model = model.to(SOURCES[src])
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        want = J.llama_params_from_hf(model, J.llama_config_from_hf(
            hf_cfg, dtype=jdtype))
        cfg = P.llama_config_from_hf(hf_cfg, dtype=dtype)
        assert cfg.n_kv_heads == 2 and cfg.dim == 64
        got = P.llama_params_from_hf(model, cfg, device="cpu")
        assert_tree_bitwise(want, got)
    if src == "fp32":
        rel = _rel(llama_forward(got, TOKENS, cfg), _hf_logits(model, TOKENS))
        assert rel <= TOL_LOGITS, rel


def test_converted_tree_owns_its_storage():
    """The fp32 conversion of an fp32 model shares no storage with it."""
    model, hf_cfg = _hf_llama()
    params = P.llama_params_from_hf(
        model, P.llama_config_from_hf(hf_cfg, dtype=torch.float32),
        device="cpu")
    before = model.model.embed_tokens.weight.detach().clone()
    params["embed"].add_(1.0)
    params["final_norm"].add_(1.0)
    assert torch.equal(model.model.embed_tokens.weight, before)
    assert torch.equal(model.model.norm.weight, torch.ones(64))


def test_llama_state_dict_input_requires_config():
    model, hf_cfg = _hf_llama()
    cfg = P.llama_config_from_hf(hf_cfg, dtype=torch.float32)
    want = P.llama_params_from_hf(model, cfg, device="cpu")
    sd = model.state_dict()
    # the config as an object or as its config.json dict
    for conf in (hf_cfg, hf_cfg.to_dict()):
        assert_tree_bitwise(want, P.llama_params_from_hf(
            sd, cfg, hf_config=conf, device="cpu"))
    # a LlamaModel's keys (no "model." prefix, no head) convert too
    inner = {k[len("model."):]: v for k, v in sd.items()
             if k.startswith("model.")}
    got = P.llama_params_from_hf(inner, cfg, hf_config=hf_cfg, device="cpu")
    assert_tree_bitwise(want["embed"].t(), got["lm_head"])
    with pytest.raises(ValueError) as ours:
        P.llama_params_from_hf(sd, cfg, device="cpu")
    with pytest.raises(ValueError) as theirs:
        J.llama_params_from_hf(sd, J.llama_config_from_hf(hf_cfg))
    assert str(ours.value) == str(theirs.value)
    assert "hf_config" in str(ours.value)


@pytest.mark.parametrize("src", ["fp32", "bf16"])
def test_mixtral_params_bitwise_jax_and_logits_parity(src):
    model, hf_cfg = _hf_mixtral()
    model = model.to(SOURCES[src])
    want = J.moe_params_from_hf(model, J.moe_config_from_hf(
        hf_cfg, dtype=jnp.float32 if src == "fp32" else jnp.bfloat16))
    # capacity high enough that no expert overflows: dispatch is exact
    cfg = P.moe_config_from_hf(
        hf_cfg, dtype=torch.float32 if src == "fp32" else torch.bfloat16,
        capacity_factor=8.0)
    assert cfg.n_experts == 4 and cfg.experts_per_token == 2
    got = P.moe_params_from_hf(model, cfg, device="cpu")
    assert_tree_bitwise(want, got)
    assert got["layers"]["router"].dtype == torch.float32
    assert got["layers"]["experts"]["w_gate"].shape == (2, 4, 64, 96)
    if src == "fp32":
        ours, _aux = moe_forward(got, TOKENS[:1], cfg)
        rel = _rel(ours, _hf_logits(model, TOKENS[:1]))
        assert rel <= TOL_LOGITS, rel


def test_arch_sniffing():
    tf = _transformers()
    _, llama_cfg = _hf_llama()
    mix = tf.MixtralConfig(
        vocab_size=64, hidden_size=32, intermediate_size=48,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        num_local_experts=2, num_experts_per_tok=1)
    for conf in (llama_cfg, llama_cfg.to_dict()):
        assert isinstance(P.config_from_hf(conf), LlamaConfig)
    for conf in (mix, mix.to_dict()):
        cfg = P.config_from_hf(conf, dtype=torch.float32)
        assert isinstance(cfg, MoeConfig)
        assert cfg == P.moe_config_from_hf(mix, dtype=torch.float32)
    # no architectures: the MoE key decides, as in JAX
    bare = {k: v for k, v in mix.to_dict().items() if k != "architectures"}
    assert isinstance(P.config_from_hf(bare), MoeConfig)
    torch.manual_seed(2)
    model = tf.MixtralForCausalLM(mix).eval()
    params = P.params_from_hf(model, cfg, device="cpu")
    assert "experts" in params["layers"] and "router" in params["layers"]
    assert_tree_bitwise(J.params_from_hf(model, J.config_from_hf(
        mix, dtype=jnp.float32)), params)


def test_llama31_rope_scaling_parity():
    """Llama-3.1's rope_scaling={'rope_type': 'llama3'}: the NTK rescale
    must apply at positions past the 'original' context."""
    rs = {"rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
    model, hf_cfg = _hf_llama(seed=3, max_position_embeddings=64,
                              rope_scaling=rs)
    cfg = P.llama_config_from_hf(hf_cfg, dtype=torch.float32)
    assert cfg.rope_scaling == (4.0, 1.0, 4.0, 16)
    assert P.llama_config_from_hf(hf_cfg.to_dict(),
                                  dtype=torch.float32) == cfg
    params = P.llama_params_from_hf(model, cfg, device="cpu")
    assert_tree_bitwise(J.llama_params_from_hf(model, J.llama_config_from_hf(
        hf_cfg, dtype=jnp.float32)), params)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 256, size=(1, 48)))
    rel = _rel(llama_forward(params, tokens, cfg), _hf_logits(model, tokens))
    assert rel <= TOL_LOGITS, rel


def _refusal(fn, *args, **kw):
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return type(e.value), str(e.value)


@pytest.mark.parametrize("as_dict", [False, True])
def test_unsupported_checkpoints_refuse_as_jax(as_dict):
    """Wrong-but-plausible conversions raise JAX's types and messages."""
    cases = [
        ("architectures", ["Qwen2ForCausalLM"], "config_from_hf",
         "unsupported architecture"),
        ("rope_scaling", {"rope_type": "yarn", "factor": 2.0},
         "llama_config_from_hf", "rope_scaling"),
        ("head_dim", 32, "llama_config_from_hf", "head_dim"),
    ]
    for key, value, fn, match in cases:
        _, hf_cfg = _hf_llama()
        setattr(hf_cfg, key, value)
        conf = hf_cfg.to_dict() if as_dict else hf_cfg
        ours = _refusal(getattr(P, fn), conf)
        assert ours == _refusal(getattr(J, fn), hf_cfg)
        assert ours[0] is NotImplementedError and match in ours[1]
    # rope scaling on a MoE checkpoint
    _, mix = _hf_mixtral()
    mix.rope_scaling = {"rope_type": "llama3", "factor": 8.0,
                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 16}
    conf = mix.to_dict() if as_dict else mix
    assert _refusal(P.moe_config_from_hf, conf) == _refusal(
        J.moe_config_from_hf, mix)


def test_quantized_params_refuse_export_as_jax(tmp_path):
    tree = np_params(JaxConfig.tiny(), seed=6)
    ours = _refusal(P.save_hf, quantize_params(params_from_numpy(
        tree, device="cpu")), LlamaConfig.tiny(), str(tmp_path / "p"))
    from kubetorch_tpu.serve import quantize_params as jax_quantize
    theirs = _refusal(J.save_hf, jax_quantize(jax.tree_util.tree_map(
        jnp.asarray, tree)), JaxConfig.tiny(), str(tmp_path / "j"))
    assert ours == theirs
    assert ours[0] is ValueError and "dequantize" in ours[1]
    assert not os.path.exists(tmp_path / "p" / "config.json")


def _llama_tree(seed=3, **cfg_kw):
    jcfg = JaxConfig.tiny(dtype=jnp.float32, attn_impl="xla", remat=False,
                          **cfg_kw)
    pcfg = LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    return params_from_numpy(np_params(jcfg, seed=seed), device="cpu"), \
        pcfg, jcfg


def _moe_tree(seed=4):
    rng = np.random.default_rng(seed)
    pcfg = MoeConfig.tiny(dtype=torch.float32)
    from kubetorch_tpu_torch.models.moe import moe_init
    params = moe_init(pcfg, seed=seed, device="cpu")
    # norms away from 1 so they take part in the round trip
    for name in ("attn_norm", "ffn_norm"):
        params["layers"][name] += torch.from_numpy(
            rng.standard_normal(params["layers"][name].shape,
                                dtype=np.float32))
    jcfg = JaxMoeConfig.tiny(dtype=jnp.float32, attn_impl="xla", remat=False)
    return params, pcfg, jcfg


class TestExport:
    def test_llama_export_loads_in_transformers_with_our_logits(
            self, tmp_path):
        tf = _transformers()
        params, cfg, jcfg = _llama_tree()
        out = str(tmp_path / "port")
        P.save_hf(params, cfg, out)
        assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
        model = tf.AutoModelForCausalLM.from_pretrained(out).eval()
        tokens = TOKENS % cfg.vocab_size
        rel = _rel(llama_forward(params, tokens, cfg),
                   _hf_logits(model, tokens))
        assert rel <= TOL_LOGITS, rel
        # transformers reads our config.json as JAX's export's config
        J.save_hf(_pt_tree_as_jax(params), jcfg, str(tmp_path / "jax"))
        ours = tf.AutoConfig.from_pretrained(out).to_dict()
        theirs = tf.AutoConfig.from_pretrained(str(tmp_path / "jax")).to_dict()
        for key in ("architectures", "model_type", "vocab_size",
                    "hidden_size", "num_hidden_layers", "num_attention_heads",
                    "num_key_value_heads", "intermediate_size",
                    "max_position_embeddings", "rope_theta", "rms_norm_eps",
                    "tie_word_embeddings", "rope_scaling", "head_dim",
                    "hidden_act"):
            assert ours[key] == theirs[key], key

    @pytest.mark.parametrize("family", ["llama", "llama31", "moe"])
    def test_roundtrip_bitwise_both_ways(self, tmp_path, family):
        if family == "moe":
            params, cfg, jcfg = _moe_tree()
        else:
            params, cfg, jcfg = _llama_tree(
                rope_scaling=(4.0, 1.0, 4.0, 16) if family == "llama31"
                else None)
        kw = dict(dtype=torch.float32)
        port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
        P.save_hf(params, cfg, port_dir)
        back, cfg2 = P.load_hf(port_dir, device="cpu", **kw)
        assert_tree_bitwise(params, back)
        assert cfg2.dim == cfg.dim and cfg2.n_kv_heads == cfg.n_kv_heads
        assert getattr(cfg2, "rope_scaling", None) == getattr(
            cfg, "rope_scaling", None)
        if family == "moe":
            assert cfg2.n_experts == cfg.n_experts
        # the JAX package reads the port's export...
        jax_back, _ = J.load_hf(port_dir, dtype=jnp.float32)
        assert_tree_bitwise(jax_back, params)
        # ...and the port reads the JAX package's
        J.save_hf(_pt_tree_as_jax(params), jcfg, jax_dir)
        back, _ = P.load_hf(jax_dir, device="cpu", **kw)
        assert_tree_bitwise(params, back)

    def test_sharded_export(self, tmp_path, monkeypatch):
        """Shards filled in order with an index whose weight map spans the
        files, read back by the port, the JAX package and transformers."""
        tf = _transformers()
        params, cfg, _ = _llama_tree()
        monkeypatch.setattr(P, "SHARD_BYTES", 100_000)
        out = str(tmp_path / "sharded")
        P.save_hf(params, cfg, out)
        with open(os.path.join(out, P.INDEX)) as f:
            index = json.load(f)
        files = sorted(set(index["weight_map"].values()))
        assert len(files) > 2 and files[0].endswith(
            f"-of-{len(files):05d}.safetensors")
        assert index["metadata"]["total_size"] == sum(
            t.numel() * 4 for t in jax.tree_util.tree_leaves(params))
        back, _ = P.load_hf(out, device="cpu", dtype=torch.float32)
        assert_tree_bitwise(params, back)
        assert_tree_bitwise(J.load_hf(out, dtype=jnp.float32)[0], params)
        model = tf.AutoModelForCausalLM.from_pretrained(out).eval()
        tokens = TOKENS % cfg.vocab_size
        assert _rel(llama_forward(params, tokens, cfg),
                    _hf_logits(model, tokens)) <= TOL_LOGITS


@pytest.mark.parametrize("src", ["fp32", "bf16"])
@pytest.mark.parametrize("shard", [None, "100KB"])
def test_load_hf_of_save_pretrained_equals_jax(tmp_path, src, shard):
    model, _ = _hf_llama(tie=False, seed=5)
    model = model.to(SOURCES[src])
    out = str(tmp_path / "hf")
    kw = {} if shard is None else {"max_shard_size": shard}
    model.save_pretrained(out, safe_serialization=True, **kw)
    if shard is not None:
        assert os.path.exists(os.path.join(out, P.INDEX))
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        want, jcfg = J.load_hf(out, dtype=jdtype)
        got, cfg = P.load_hf(out, device="cpu", dtype=dtype,
                             max_seq_len=64)
        assert cfg.max_seq_len == 64 and cfg.vocab_size == jcfg.vocab_size
        assert_tree_bitwise(want, got)


def test_mixtral_load_hf_of_save_pretrained_equals_jax(tmp_path):
    model, _ = _hf_mixtral(seed=7)
    out = str(tmp_path / "mix")
    model.save_pretrained(out, safe_serialization=True,
                          max_shard_size="200KB")
    want, _ = J.load_hf(out, dtype=jnp.float32)
    got, cfg = P.load_hf(out, device="cpu", dtype=torch.float32)
    assert isinstance(cfg, MoeConfig)
    assert_tree_bitwise(want, got)


def test_lazy_model_wrappers(tmp_path):
    params, cfg, _ = _llama_tree(seed=8)
    pt_models.save_hf(params, cfg, str(tmp_path / "m"))
    back, _ = pt_models.load_hf(str(tmp_path / "m"), device="cpu",
                                dtype=torch.float32)
    assert_tree_bitwise(params, back)


def test_load_hf_runs_on_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is cuda")
    params, cfg, _ = _llama_tree(seed=9)
    P.save_hf(params, cfg, str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.load_hf(str(tmp_path / "m"))


def test_bad_directories_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="safetensors"):
        P._SafetensorsReader(str(tmp_path))
    params, cfg, _ = _llama_tree(seed=10)
    d = str(tmp_path / "m")
    P.save_hf(params, cfg, d)
    os.rename(os.path.join(d, P.SINGLE),
              os.path.join(d, "other.safetensors"))
    with open(os.path.join(d, P.INDEX), "w") as f:
        json.dump({"weight_map": {"model.norm.weight": "other.safetensors",
                                  "lm_head.weight": "missing.safetensors"}},
                  f)
    with pytest.raises((ValueError, FileNotFoundError)):
        P._SafetensorsReader(d)


def test_converted_params_drive_generation():
    """Converted weights run the KV-cache generate path, and greedy tokens
    agree with HF's own greedy decode."""
    model, hf_cfg = _hf_llama()
    cfg = P.llama_config_from_hf(hf_cfg, dtype=torch.float32, max_seq_len=32)
    params = P.llama_params_from_hf(model, cfg, device="cpu")
    prompt = torch.tensor([[3, 17, 99, 4]])
    ours = generate(params, prompt, cfg, max_new_tokens=6)
    with torch.no_grad():
        hf_out = model.generate(prompt, max_new_tokens=6, do_sample=False,
                                use_cache=True, pad_token_id=0)
    assert ours[0, 4:].tolist() == hf_out[0, 4:].tolist()


def _every_dtype():
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, dtype in P._ST_DTYPES.items():
        if dtype.is_floating_point:
            t = torch.randn(3, 5, generator=g).to(dtype)
        elif dtype == torch.bool:
            t = torch.rand(3, 5, generator=g) > 0.5
        else:
            info = torch.iinfo(dtype)
            t = torch.randint(max(info.min, -1000), min(info.max, 1000),
                              (3, 5), generator=g, dtype=torch.int64).to(dtype)
        out[f"t.{name}"] = t
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4, dtype=torch.bfloat16)
    out["odd"] = torch.arange(7, dtype=torch.int8)     # unaligned length
    out["after_odd"] = torch.arange(3, dtype=torch.float64)
    return out


def _write(path, tensors):
    P._write_safetensors(path, [(k, t.dtype, tuple(t.shape), lambda t=t: t)
                                for k, t in tensors.items()])


def test_safetensors_reader_and_writer_round_trip_every_dtype(tmp_path):
    """Without transformers: every dtype the format names, a 0-d and an
    empty tensor, read back bitwise; the data section starts 8-aligned."""
    tensors = _every_dtype()
    path = str(tmp_path / P.SINGLE)
    _write(path, tensors)
    header, start = P._read_header(path)
    assert start % 8 == 0 and header["__metadata__"] == {"format": "pt"}
    with P._SafetensorsReader(str(tmp_path)) as reader:
        assert set(reader.refs) == set(tensors)
        for k, t in tensors.items():
            got = reader.refs[k].read(torch.device("cpu"))
            assert got.dtype == t.dtype and got.shape == t.shape, k
            assert torch.equal(got, t), k


def test_checkpoints_need_neither_transformers_nor_safetensors(tmp_path):
    """save_hf and load_hf with both packages unimportable."""
    code = f"""
import sys
sys.modules["transformers"] = None
sys.modules["safetensors"] = None
import torch
from kubetorch_tpu_torch.models import convert_hf as P
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
cfg = LlamaConfig.tiny(dtype=torch.float32)
params = llama_init(cfg, seed=1, device="cpu")
P.SHARD_BYTES = 100_000
P.save_hf(params, cfg, {str(tmp_path)!r})
back, cfg2 = P.load_hf({str(tmp_path)!r}, device="cpu", dtype=torch.float32)
assert cfg2 == cfg, (cfg2, cfg)
for k in ("embed", "lm_head", "final_norm"):
    assert torch.equal(back[k], params[k]), k
for k, v in params["layers"].items():
    assert torch.equal(back["layers"][k], v), k
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


def test_safetensors_files_match_the_reference_library(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = _every_dtype()
    ours = str(tmp_path / "ours" / P.SINGLE)
    os.makedirs(os.path.dirname(ours))
    _write(ours, tensors)
    loaded = st.load_file(ours)
    assert set(loaded) == set(tensors)
    for k, t in tensors.items():
        assert loaded[k].dtype == t.dtype and torch.equal(loaded[k], t), k
    theirs_dir = tmp_path / "theirs"
    os.makedirs(theirs_dir)
    st.save_file(tensors, str(theirs_dir / P.SINGLE),
                 metadata={"format": "pt"})
    with P._SafetensorsReader(str(theirs_dir)) as reader:
        for k, t in tensors.items():
            got = reader.refs[k].read(torch.device("cpu"))
            assert got.dtype == t.dtype and torch.equal(got, t), k
