"""Hugging Face checkpoints in and out: Llama/Mixtral weights → the port's
stacked param trees, and back. The counterpart of
``kubetorch_tpu/models/convert_hf.py``, under its names.

A user brings a trained checkpoint as a ``LlamaForCausalLM`` /
``MixtralForCausalLM`` module, a ``state_dict``, or a ``save_pretrained``
directory; this module turns it into the stacked-layer trees
``models.llama`` / ``models.moe`` run, so a real checkpoint drives the
serving engines, quantization, LoRA and training unchanged.

Two representation gaps are bridged here, both silently wrong if skipped:

- **Layer stacking**: HF keeps per-layer tensors (``layers.{i}.*``); the
  port keeps one ``(L, ...)`` leaf per weight, as the JAX model does.
  Conversion lands each layer's tensor into its row of a preallocated
  stacked leaf, transposing torch's ``(out, in)`` to ``(in, out)``.
- **RoPE layout**: HF rotates in half-split layout (dim ``i`` pairs with
  ``i + head_dim/2``, ``rotate_half``); the port rotates interleaved pairs
  ``(2i, 2i+1)`` (``apply_rope``). The two are equal up to a fixed
  permutation of the q/k projections' output dims, per head, applied at
  conversion time (``_deinterleave_rope``; its inverse on export).

Weights land in ``cfg.dtype``; norms and the router stay fp32, as
``llama_init``/``moe_init`` make them. A source tensor already in
``cfg.dtype`` lands as it is; any other is widened to fp32 and rounded to
nearest even, so every leaf is bit-equal to the JAX package's conversion
(which goes through fp32 numpy and ``jnp.asarray(dtype=)``).

A directory is read without ``transformers`` or ``safetensors``:
``config.json`` as a dict, the weights through the small safetensors reader
below (an 8-byte little-endian header length, a JSON header of
``dtype``/``shape``/``data_offsets``, then the raw bytes), one tensor at a
time through a staging buffer (pinned for a card), with
``model.safetensors.index.json`` for sharded checkpoints. Host memory
stays near the largest tensor; the model is never held in fp32 on the
host. ``save_hf`` writes the same layout (fp32, sharded at 5 GB with an
index, as ``save_pretrained`` does by default) and a ``config.json`` that
``transformers.AutoConfig`` reads as the model's config.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .common import resolve_device
from .llama import LlamaConfig
from .moe import MoeConfig
from .quant import is_quantized

__all__ = [
    "llama_config_from_hf",
    "moe_config_from_hf",
    "llama_params_from_hf",
    "moe_params_from_hf",
    "config_from_hf",
    "params_from_hf",
    "load_hf",
    "save_hf",
]


# ---------------------------------------------------------------------------
# safetensors files
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
SHARD_BYTES = 5 * 10 ** 9          # save_pretrained's default "5GB"
INDEX = "model.safetensors.index.json"
SINGLE = "model.safetensors"


def _read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(header dict, offset of the data section) of one safetensors file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    return header, 8 + n


class _TensorRef:
    """One tensor of a safetensors file, read on demand."""

    def __init__(self, reader: "_SafetensorsReader", path: str, offset: int,
                 nbytes: int, dtype: torch.dtype, shape: Tuple[int, ...]):
        self.reader, self.path, self.offset = reader, path, offset
        self.nbytes, self.dtype, self.shape = nbytes, dtype, shape

    def read(self, device: torch.device) -> torch.Tensor:
        return self.reader.read(self, device)


class _SafetensorsReader:
    """The safetensors files of one checkpoint directory: ``refs`` maps
    every tensor name to a :class:`_TensorRef`. A read lands the tensor's
    bytes in a staging buffer (pinned, the size of the largest tensor, when
    the target is a card) and copies them to the device; the buffer is
    reused once the copy has finished. Use as a context manager."""

    def __init__(self, path: str):
        index = os.path.join(path, INDEX)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        elif os.path.exists(os.path.join(path, SINGLE)):
            weight_map, files = None, [SINGLE]
        else:
            raise FileNotFoundError(
                f"no {SINGLE} or {INDEX} in {path}: the port reads "
                "safetensors checkpoints only")
        self.refs: Dict[str, _TensorRef] = {}
        for name in files:
            full = os.path.join(path, name)
            header, start = _read_header(full)
            for key, meta in header.items():
                if key == "__metadata__":
                    continue
                begin, end = meta["data_offsets"]
                self.refs[key] = _TensorRef(
                    self, full, start + begin, end - begin,
                    _ST_DTYPES[meta["dtype"]], tuple(meta["shape"]))
        if weight_map is not None:
            for key, name in weight_map.items():
                ref = self.refs.get(key)
                if ref is None or os.path.basename(ref.path) != name:
                    raise ValueError(f"{INDEX} maps {key!r} to {name}, "
                                     "which does not hold it")
        self._files: Dict[str, Any] = {}
        self._staging: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None

    def __enter__(self) -> "_SafetensorsReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._staging = None

    def _fill(self, ref: _TensorRef, out: np.ndarray) -> None:
        f = self._files.get(ref.path)
        if f is None:
            f = self._files[ref.path] = open(ref.path, "rb", buffering=0)
        f.seek(ref.offset)
        view, done = memoryview(out), 0
        while done < ref.nbytes:       # one read() returns at most ~2 GB
            n = f.readinto(view[done:])
            if not n:
                raise ValueError(f"{ref.path} ends inside a tensor")
            done += n

    def read(self, ref: _TensorRef, device: torch.device) -> torch.Tensor:
        if ref.nbytes == 0:
            return torch.empty(ref.shape, dtype=ref.dtype, device=device)
        if device.type != "cuda":
            raw = np.empty(ref.nbytes, np.uint8)
            self._fill(ref, raw)
            return torch.from_numpy(raw).view(ref.dtype).reshape(ref.shape)
        if self._staging is None:
            largest = max(r.nbytes for r in self.refs.values())
            self._staging = torch.empty(largest, dtype=torch.uint8,
                                        pin_memory=True)
        if self._copied is not None:
            self._copied.synchronize()   # the last copy out has finished
        self._fill(ref, self._staging.numpy()[:ref.nbytes])
        out = self._staging[:ref.nbytes].to(device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return out.view(ref.dtype).reshape(ref.shape)


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    """A CPU tensor's bytes in C order, as the file stores them."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy())


def _write_safetensors(path: str,
                       items: List[Tuple[str, torch.dtype, Tuple[int, ...],
                                         Callable[[], torch.Tensor]]],
                       ) -> None:
    """Write one safetensors file. Each item is (name, dtype, shape,
    make): the header is laid out from dtypes and shapes, then each tensor
    is made and written in turn, so the host holds one at a time."""
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, dtype, shape, _ in items:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        header[name] = {"dtype": _ST_NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)      # the data section starts 8-aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name, dtype, shape, make in items:
            t = make()
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: made {t.dtype}{tuple(t.shape)}, "
                                 f"declared {dtype}{tuple(shape)}")
            f.write(_tensor_bytes(t))


def _write_checkpoint(path: str, items) -> None:
    """``save_pretrained``'s layout: ``model.safetensors`` when everything
    fits one shard, else ``model-0000i-of-0000n.safetensors`` filled in
    order up to ``SHARD_BYTES`` each, and the index."""
    shard_bytes = SHARD_BYTES
    shards: List[list] = [[]]
    size = 0
    total = 0
    for item in items:
        _, dtype, shape, _ = item
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        if shards[-1] and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(item)
        size += n
        total += n
    os.makedirs(path, exist_ok=True)
    if len(shards) == 1:
        _write_safetensors(os.path.join(path, SINGLE), shards[0])
        return
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        _write_safetensors(os.path.join(path, name), shard)
        weight_map.update({item[0]: name for item in shard})
    with open(os.path.join(path, INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)


# ---------------------------------------------------------------------------
# state-dict plumbing
# ---------------------------------------------------------------------------


def _attrs(hf):
    """A config as attributes: a ``config.json`` dict or a ``transformers``
    config object."""
    return SimpleNamespace(**hf) if isinstance(hf, Mapping) else hf


def _fetch(x, device: torch.device) -> torch.Tensor:
    """A state-dict value (tensor of any dtype and device, numpy array, or
    a file reference) on ``device``, in its own dtype, as a tensor of its
    own: the converted tree never shares storage with the source model."""
    if isinstance(x, _TensorRef):
        return x.read(device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(device)
    return x.detach().to(device, copy=True)


def _cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype`` as the JAX conversion rounds it: through fp32,
    round to nearest even (the identity where the dtypes agree)."""
    return w if w.dtype == dtype else w.float().to(dtype)


def _state_dict(model_or_sd) -> Mapping[str, Any]:
    sd = (model_or_sd if isinstance(model_or_sd, Mapping)
          else model_or_sd.state_dict())
    # strip an outer "model." so LlamaModel and LlamaForCausalLM both work
    if not any(k.startswith("model.") for k in sd):
        return {f"model.{k}" if not k.startswith("lm_head") else k: v
                for k, v in sd.items()}
    return sd


def _hf_config(model_or_sd, hf_config):
    if hf_config is not None:
        return _attrs(hf_config)
    cfg = getattr(model_or_sd, "config", None)
    if cfg is None:
        raise ValueError(
            "pass hf_config= when converting a bare state_dict")
    return _attrs(cfg)


def _deinterleave_rope(w: torch.Tensor, n_heads: int,
                       head_dim: int) -> torch.Tensor:
    """Permute q/k projection columns from HF half-split RoPE layout to the
    interleaved layout ``apply_rope`` expects.

    ``w`` is ``(in_dim, n_heads*head_dim)`` (already transposed). HF orders
    each head's output dims ``[r_0..r_{hd/2-1}, s_0..s_{hd/2-1}]`` where
    ``(r_i, s_i)`` is the pair rotated by angle ``theta_i``; interleaved
    wants ``[r_0, s_0, r_1, s_1, ...]``.
    """
    d_in = w.shape[0]
    w = w.reshape(d_in, n_heads, 2, head_dim // 2)
    return w.transpose(2, 3).reshape(d_in, n_heads * head_dim)


def _interleave_to_half(w: torch.Tensor, n_heads: int,
                        head_dim: int) -> torch.Tensor:
    """Inverse of ``_deinterleave_rope``: interleaved RoPE pair columns
    back to HF half-split order."""
    d_in = w.shape[0]
    w = w.reshape(d_in, n_heads, head_dim // 2, 2)
    return w.transpose(2, 3).reshape(d_in, n_heads * head_dim)


def _common_decoder(sd, hf, cfg, *, n_layers: int, device: torch.device):
    """Leaves shared by the dense and MoE decoders: embeddings, attention
    projections (RoPE-permuted), norms, lm_head (tied or not). Returns the
    tree and the ``stack`` helper the families use for their FFN leaves."""
    nh, nkv, hd, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype

    def stack(fmt: str, transform=None, dtype=dt):
        """(L, in, out) leaf, one layer's (out, in) tensor at a time."""
        out = None
        for i in range(n_layers):
            w = _fetch(sd[fmt.format(i=i)], device).t()          # (in, out)
            if transform is not None:
                w = transform(w)
            if out is None:
                out = torch.empty((n_layers,) + tuple(w.shape), dtype=dtype,
                                  device=device)
            out[i].copy_(_cast(w, dtype))
        return out

    def stack_norm(fmt: str):
        return torch.stack([_fetch(sd[fmt.format(i=i)], device).float()
                            for i in range(n_layers)])

    embed = _cast(_fetch(sd["model.embed_tokens.weight"], device), dt)
    if getattr(hf, "tie_word_embeddings", False) or "lm_head.weight" not in sd:
        lm_head = embed.t().contiguous()
    else:
        lm_head = _cast(_fetch(sd["lm_head.weight"], device), dt).t().contiguous()

    layers = {
        "attn_norm": stack_norm("model.layers.{i}.input_layernorm.weight"),
        "wq": stack("model.layers.{i}.self_attn.q_proj.weight",
                    lambda w: _deinterleave_rope(w, nh, hd)),
        "wk": stack("model.layers.{i}.self_attn.k_proj.weight",
                    lambda w: _deinterleave_rope(w, nkv, hd)),
        "wv": stack("model.layers.{i}.self_attn.v_proj.weight"),
        "wo": stack("model.layers.{i}.self_attn.o_proj.weight"),
        "ffn_norm": stack_norm(
            "model.layers.{i}.post_attention_layernorm.weight"),
    }
    return {
        "embed": embed.contiguous(),
        "layers": layers,
        "final_norm": _fetch(sd["model.norm.weight"], device).float(),
        "lm_head": lm_head,
    }, stack


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------


def _check_head_dim(hf) -> None:
    """Models with a decoupled head_dim (e.g. Mistral-Nemo: 5120 hidden, 32
    heads, head_dim 128) can't convert — the configs derive
    ``head_dim = dim // n_heads`` — and must fail HERE with a clear message,
    not as a bare reshape error deep in weight stacking."""
    explicit = getattr(hf, "head_dim", None)
    derived = hf.hidden_size // hf.num_attention_heads
    if explicit is not None and explicit != derived:
        raise NotImplementedError(
            f"checkpoint has head_dim={explicit} decoupled from "
            f"hidden_size/num_heads={derived}; this stack derives head_dim "
            "from dim//n_heads and cannot represent it")


def _rope_scaling_tuple(hf):
    """HF ``rope_scaling`` dict → the hashable tuple ``rope_freqs`` applies
    (Llama-3.1 NTK scaling), or None. Anything this stack can't reproduce
    raises — converting anyway would yield silently wrong logits at every
    position."""
    rs = getattr(hf, "rope_scaling", None)
    if rs is None:
        return None
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind == "default":
        return None
    if kind == "llama3":
        return (float(rs["factor"]), float(rs["low_freq_factor"]),
                float(rs["high_freq_factor"]),
                int(rs["original_max_position_embeddings"]))
    raise NotImplementedError(
        f"rope_scaling type {kind!r} is not implemented (supported: llama3 "
        "NTK scaling); refusing to convert with wrong position embeddings")


def llama_config_from_hf(hf, **overrides) -> LlamaConfig:
    """HF Llama config (object or ``config.json`` dict) → ours.
    ``overrides`` win (e.g. dtype, attn_impl, a smaller ``max_seq_len`` to
    bound cache/freq tables)."""
    hf = _attrs(hf)
    _check_head_dim(hf)
    kw = dict(
        vocab_size=hf.vocab_size,
        dim=hf.hidden_size,
        n_layers=hf.num_hidden_layers,
        n_heads=hf.num_attention_heads,
        n_kv_heads=getattr(hf, "num_key_value_heads", hf.num_attention_heads),
        ffn_dim=hf.intermediate_size,
        max_seq_len=hf.max_position_embeddings,
        rope_theta=float(getattr(hf, "rope_theta", 10000.0)),
        norm_eps=hf.rms_norm_eps,
        rope_scaling=_rope_scaling_tuple(hf),
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def llama_params_from_hf(model_or_sd, cfg: LlamaConfig, hf_config=None, *,
                         device=None) -> Dict[str, Any]:
    """HF Llama weights → the ``llama_init`` tree on ``device``."""
    device = resolve_device(device)
    hf = _hf_config(model_or_sd, hf_config)
    sd = _state_dict(model_or_sd)
    params, stack = _common_decoder(sd, hf, cfg, n_layers=cfg.n_layers,
                                    device=device)
    params["layers"].update({
        "w_gate": stack("model.layers.{i}.mlp.gate_proj.weight"),
        "w_up": stack("model.layers.{i}.mlp.up_proj.weight"),
        "w_down": stack("model.layers.{i}.mlp.down_proj.weight"),
    })
    return params


# ---------------------------------------------------------------------------
# Mixtral
# ---------------------------------------------------------------------------


def moe_config_from_hf(hf, **overrides) -> MoeConfig:
    """HF Mixtral config (object or dict) → ``MoeConfig``.

    HF Mixtral routes drop-free; the training dispatch bounds each expert
    at ``capacity_factor * S * K / E`` slots. Converted checkpoints are
    exact whenever no expert overflows — raise ``capacity_factor`` (or
    serve through the engine's decode gather) where that matters.
    """
    hf = _attrs(hf)
    _check_head_dim(hf)
    if _rope_scaling_tuple(hf) is not None:
        raise NotImplementedError(
            "rope_scaling on a MoE checkpoint is not supported (MoeConfig "
            "has no rope_scaling field)")
    kw = dict(
        vocab_size=hf.vocab_size,
        dim=hf.hidden_size,
        n_layers=hf.num_hidden_layers,
        n_heads=hf.num_attention_heads,
        n_kv_heads=getattr(hf, "num_key_value_heads", hf.num_attention_heads),
        ffn_dim=hf.intermediate_size,
        n_experts=hf.num_local_experts,
        experts_per_token=hf.num_experts_per_tok,
        max_seq_len=hf.max_position_embeddings,
        rope_theta=float(getattr(hf, "rope_theta", 1e6)),
        norm_eps=hf.rms_norm_eps,
    )
    kw.update(overrides)
    return MoeConfig(**kw)


def moe_params_from_hf(model_or_sd, cfg: MoeConfig, hf_config=None, *,
                       device=None) -> Dict[str, Any]:
    """HF Mixtral weights → the ``moe_init`` tree on ``device``.

    Expert FFNs stack to ``(L, E, in, out)``; HF's ``w1/w3/w2`` are our
    ``w_gate/w_up/w_down``. The router stays fp32 (routing decisions are
    taken in fp32).
    """
    device = resolve_device(device)
    hf = _hf_config(model_or_sd, hf_config)
    sd = _state_dict(model_or_sd)
    params, stack = _common_decoder(sd, hf, cfg, n_layers=cfg.n_layers,
                                    device=device)

    def stack_experts(which: str):
        out = None
        for i in range(cfg.n_layers):
            for e in range(cfg.n_experts):
                w = _fetch(sd[f"model.layers.{i}.block_sparse_moe.experts."
                              f"{e}.{which}.weight"], device).t()
                if out is None:
                    out = torch.empty((cfg.n_layers, cfg.n_experts)
                                      + tuple(w.shape), dtype=cfg.dtype,
                                      device=device)
                out[i, e].copy_(_cast(w, cfg.dtype))
        return out

    params["layers"].update({
        "router": stack("model.layers.{i}.block_sparse_moe.gate.weight",
                        dtype=torch.float32),
        "experts": {
            "w_gate": stack_experts("w1"),
            "w_up": stack_experts("w3"),
            "w_down": stack_experts("w2"),
        },
    })
    return params


# ---------------------------------------------------------------------------
# one-call front door
# ---------------------------------------------------------------------------

_ARCH_DENSE = {"LlamaForCausalLM", "LlamaModel", "MistralForCausalLM",
               "MistralModel"}
_ARCH_MOE = {"MixtralForCausalLM", "MixtralModel"}


def _is_moe(hf) -> bool:
    hf = _attrs(hf)
    archs = set(getattr(hf, "architectures", None) or [])
    if archs & _ARCH_MOE:
        return True
    if archs & _ARCH_DENSE:
        return False
    if archs:
        # Unknown architectures must NOT fall through to the dense mapping:
        # several (Qwen2, Gemma) reuse the Llama key names, so every lookup
        # would succeed while their extra weights (qkv biases, logit caps)
        # are silently dropped — wrong logits with no error.
        raise NotImplementedError(
            f"unsupported architecture(s) {sorted(archs)}; supported: "
            f"{sorted(_ARCH_DENSE | _ARCH_MOE)}")
    return hasattr(hf, "num_local_experts")


def config_from_hf(hf, **overrides):
    return (moe_config_from_hf(hf, **overrides) if _is_moe(hf)
            else llama_config_from_hf(hf, **overrides))


def params_from_hf(model_or_sd, cfg, hf_config=None, *, device=None):
    return (moe_params_from_hf(model_or_sd, cfg, hf_config=hf_config,
                               device=device)
            if isinstance(cfg, MoeConfig)
            else llama_params_from_hf(model_or_sd, cfg, hf_config=hf_config,
                                      device=device))


def load_hf(path: str, device=None, **config_overrides):
    """``save_pretrained`` directory (safetensors, one file or sharded) →
    ``(params, cfg)`` on ``device`` (``cuda`` unless the caller names
    one), ready for ``llama_forward``/``moe_forward``, the serving engines,
    ``quantize_params`` and LoRA. The architecture is sniffed from
    ``config.json`` (Llama/Mistral → dense; Mixtral → MoE)."""
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = config_from_hf(hf, **config_overrides)
    with _SafetensorsReader(path) as reader:
        params = params_from_hf(reader.refs, cfg, hf_config=hf, device=device)
    return params, cfg


# ---------------------------------------------------------------------------
# export: our tree → a save_pretrained directory
# ---------------------------------------------------------------------------


def _hf_config_dict(cfg) -> Dict[str, Any]:
    """The ``config.json`` of an exported model."""
    conf = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
                num_hidden_layers=cfg.n_layers,
                num_attention_heads=cfg.n_heads,
                num_key_value_heads=cfg.n_kv_heads,
                intermediate_size=cfg.ffn_dim,
                max_position_embeddings=cfg.max_seq_len,
                rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
                tie_word_embeddings=False, hidden_act="silu",
                torch_dtype="float32")
    if isinstance(cfg, MoeConfig):
        conf.update(architectures=["MixtralForCausalLM"], model_type="mixtral",
                    num_local_experts=cfg.n_experts,
                    num_experts_per_tok=cfg.experts_per_token,
                    sliding_window=None)
        return conf
    conf.update(architectures=["LlamaForCausalLM"], model_type="llama")
    rs = getattr(cfg, "rope_scaling", None)
    if rs is not None:
        conf["rope_scaling"] = {
            "rope_type": "llama3", "factor": rs[0], "low_freq_factor": rs[1],
            "high_freq_factor": rs[2], "original_max_position_embeddings": rs[3]}
    return conf


def _refuse_quantized(tree) -> None:
    if is_quantized(tree):
        raise ValueError(
            "cannot export quantized params (int8 or int4) — "
            "dequantize first (serve.dequantize_params)")
    if isinstance(tree, dict):
        for v in tree.values():
            _refuse_quantized(v)


def save_hf(params: Dict[str, Any], cfg, path: str) -> None:
    """The reverse trip: our tree → a ``save_pretrained`` directory (Llama
    dense or Mixtral MoE), so a model fine-tuned or LoRA-merged here goes
    straight back into the torch ecosystem. Weights export fp32 (norms and
    router already are; bf16 leaves widen losslessly), one tensor on the
    host at a time; load_hf → save_hf → load_hf round-trips bit-exactly in
    fp32. Quantized trees refuse — dequantize first; merge LoRA adapters
    first (``models.lora.merge_lora``)."""
    _refuse_quantized(params)
    moe = isinstance(cfg, MoeConfig)
    lay = params["layers"]
    nh, nkv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    items = []

    def add(name: str, make: Callable[[], torch.Tensor], shape) -> None:
        items.append((name, torch.float32, tuple(shape),
                      lambda: make().float().contiguous().to("cpu")))

    def add_proj(name: str, w, transform=None) -> None:
        """An (in, out) leaf slice as HF's (out, in) weight."""
        def make():
            x = w.float()
            return (transform(x) if transform else x).t()
        add(name, make, (w.shape[1], w.shape[0]))

    add("model.embed_tokens.weight", lambda: params["embed"],
        params["embed"].shape)
    add("model.norm.weight", lambda: params["final_norm"],
        params["final_norm"].shape)
    add_proj("lm_head.weight", params["lm_head"])
    for i in range(L):
        pre = f"model.layers.{i}"
        add(f"{pre}.input_layernorm.weight",
            lambda i=i: lay["attn_norm"][i], lay["attn_norm"].shape[1:])
        add_proj(f"{pre}.self_attn.q_proj.weight", lay["wq"][i],
                 lambda w: _interleave_to_half(w, nh, hd))
        add_proj(f"{pre}.self_attn.k_proj.weight", lay["wk"][i],
                 lambda w: _interleave_to_half(w, nkv, hd))
        add_proj(f"{pre}.self_attn.v_proj.weight", lay["wv"][i])
        add_proj(f"{pre}.self_attn.o_proj.weight", lay["wo"][i])
        add(f"{pre}.post_attention_layernorm.weight",
            lambda i=i: lay["ffn_norm"][i], lay["ffn_norm"].shape[1:])
        if moe:
            add_proj(f"{pre}.block_sparse_moe.gate.weight", lay["router"][i])
            ex = lay["experts"]
            for e in range(cfg.n_experts):
                pe = f"{pre}.block_sparse_moe.experts.{e}"
                add_proj(f"{pe}.w1.weight", ex["w_gate"][i, e])
                add_proj(f"{pe}.w3.weight", ex["w_up"][i, e])
                add_proj(f"{pe}.w2.weight", ex["w_down"][i, e])
        else:
            add_proj(f"{pre}.mlp.gate_proj.weight", lay["w_gate"][i])
            add_proj(f"{pre}.mlp.up_proj.weight", lay["w_up"][i])
            add_proj(f"{pre}.mlp.down_proj.weight", lay["w_down"][i])

    _write_checkpoint(path, items)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config_dict(cfg), f, indent=2, sort_keys=True)
