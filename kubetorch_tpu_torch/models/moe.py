"""Mixtral-style sparse MoE decoder, ``kubetorch_tpu/models/moe.py`` in
PyTorch: serving (the dispatch, the decode gather) and training
(``moe_forward`` under autograd, ``moe_loss`` with the router's aux term).

Routing is the JAX package's: softmax over the router's expert logits,
top-k, gates renormalized over the chosen experts, and each (token, k)
pair placed in its expert's capacity buffer by a cumulative count over
the flattened (S·K) axis. Pairs past the buffer's threshold are dropped.
Top-k keeps ``lax.top_k``'s order, descending with the lower expert index
first on a tie (a stable sort, never ``torch.topk``, whose order of ties
is unspecified), so the same pairs claim the same slots and the same
tokens drop.

Where the JAX package dispatches and combines through dense one-hot
einsums, this port moves the same rows by index: each kept pair's token
is copied into its slot of an (E, B, C + 1, D) buffer (the extra row
takes every dropped or padding pair and is never read), the expert
SwiGLU runs expert by expert, and each token sums its kept pairs' outputs
weighted by the gates in fp32. The copies are exact, so the buffer holds
what the einsum builds. An int8 expert bank (``models.quant``) is
dequantized one expert's matrices at a time, never the whole bank.

The dispatch's gradient is the JAX one-hot einsums': a kept pair's token
gets its expert's gradient through the copy into its slot, a dropped or
padding pair's token none (its row of the buffer, ``capacity``, is read
back with weight 0, so its gradient is exactly 0; which of the pairs that
share the row is left there, also on a remat recompute, is read by no
one). The router gets its gradient through the gates of the kept pairs and
through ``probs`` in the aux term, none through top-1 or the positions.

``moe_ffn_decode`` is the decode gather: the K chosen experts' int8
values and scales are gathered first and only those slices dequantized.

Training: ``moe_forward`` under grad mode runs each layer inside a
checkpoint when ``cfg.remat`` is on, with the port's ``"dots"`` policy
(``models/common.py``), which saves every matrix product's output. JAX's
``dots_with_no_batch_dims_saveable`` does not save the expert einsums
(their batch dim ``e``) and recomputes them; the port's per-expert 2-D
products are saved. The values and gradients are the same; the port keeps
three (B, C + 1, F or D) products per expert and layer more.

Not ported here: the shard_map axes (``ep_axis``/``tp_axis``) of the
parallelism queue, which raise, and ``context_chunked_routing`` (pipeline
stages), which ``config_from_dict`` ignores.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .common import checkpointed
from .common import config_from_dict as _config_from_dict
from .common import resolve_device, resolve_remat_policy
from .llama import LlamaConfig, apply_rope, attention, rmsnorm, rope_freqs
from .quant import Q4KEY, QKEY, dequant, is_quantized


@dataclass(frozen=True)
class MoeConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_impl: str = "auto"
    router_aux_weight: float = 0.01
    # Decode-time fast path: gather only the K selected experts' weights
    # per token instead of streaming all E experts (``moe_ffn_decode``).
    decode_gather_ffn: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MoeConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "MoeConfig":
        d = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 ffn_dim=128, n_experts=4, experts_per_token=2, max_seq_len=128)
        d.update(kw)
        return cls(**d)

    def _llama_view(self) -> LlamaConfig:
        return LlamaConfig(vocab_size=self.vocab_size, dim=self.dim,
                           n_layers=self.n_layers, n_heads=self.n_heads,
                           n_kv_heads=self.n_kv_heads, ffn_dim=self.ffn_dim,
                           max_seq_len=self.max_seq_len,
                           rope_theta=self.rope_theta, norm_eps=self.norm_eps,
                           dtype=self.dtype, remat=self.remat,
                           attn_impl=self.attn_impl)

    def param_count(self) -> int:
        d, f, L, E = self.dim, self.ffn_dim, self.n_layers, self.n_experts
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * f * E
        router = d * E
        return self.vocab_size * d * 2 + L * (attn + ffn + router + 2 * d) + d


def config_from_dict(d: Dict) -> MoeConfig:
    return _config_from_dict(MoeConfig, d)


def moe_init(cfg: MoeConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random params in the JAX model's stacked layout, drawn in fp32 from
    a ``torch.Generator`` seeded with ``seed`` and cast leaf by leaf (the
    router is drawn, cast to ``cfg.dtype`` and kept in fp32, as in JAX)."""
    device = resolve_device(device)
    d, L, E, f = cfg.dim, cfg.n_layers, cfg.n_experts, cfg.ffn_dim
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def init(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    return {
        "embed": init((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": init((L, d, nh * hd), d),
            "wk": init((L, d, nkv * hd), d),
            "wv": init((L, d, nkv * hd), d),
            "wo": init((L, nh * hd, d), nh * hd),
            "ffn_norm": ones(L, d),
            "router": init((L, d, E), d).float(),
            "experts": {
                "w_gate": init((L, E, d, f), d),
                "w_up": init((L, E, d, f), d),
                "w_down": init((L, E, f, d), f),
            },
        },
        "final_norm": ones(d),
        "lm_head": init((d, cfg.vocab_size), d),
    }


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, the lower index first
    among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: MoeConfig, x: torch.Tensor, lw: Dict[str, Any]):
    """Shared router: softmax over the expert logits in fp32, top-k, gates
    renormalized over the selected experts. Returns (probs (B, S, E),
    gate_vals (B, S, K) fp32, gate_idx (B, S, K) int64)."""
    logits = x.float() @ lw["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, cfg.experts_per_token)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def _expert(leaf: Any, e: int, dtype) -> torch.Tensor:
    """Expert ``e``'s matrix of a bank leaf in ``dtype``: a plain bank's
    slice, or a quantized bank's slice dequantized on its own."""
    if isinstance(leaf, dict):
        return dequant({k: v[e] for k, v in leaf.items()}, dtype)
    return leaf[e]


def _dispatch(cfg: MoeConfig, x: torch.Tensor, lw: Dict[str, Any],
              token_mask=None, keep_capacity=None, no_drop: bool = False):
    """The capacity-buffer MoE body: (output (B, S, D), probs, kept pairs
    (B, S, K) bool)."""
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    if no_drop:
        capacity, keep_capacity = s, None
    else:
        capacity = max(1, int(cfg.capacity_factor * s * K / E))
    probs, gate_vals, gate_idx = _route(cfg, x, lw)

    # position of each (token, k) inside its expert's buffer: the pairs
    # before it in (S·K) order that chose the same expert, padding excluded
    onehot = F.one_hot(gate_idx, E)                              # (B,S,K,E)
    if token_mask is not None:
        onehot = onehot * token_mask[:, :, None, None].to(onehot.dtype)
    flat = onehot.reshape(b, s * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, K, E)
    pos = (pos * onehot).sum(-1)                                 # (B,S,K)
    limit = capacity if keep_capacity is None else min(int(keep_capacity),
                                                       capacity)
    kept = pos < limit
    if token_mask is not None:
        kept = kept & token_mask[:, :, None]

    # every pair that is not kept lands in row ``capacity``, read by no one
    slot = torch.where(kept, pos, torch.full_like(pos, capacity))
    bi = torch.arange(b, device=x.device)[:, None, None].expand(b, s, K)
    si = torch.arange(s, device=x.device)[None, :, None].expand(b, s, K)
    buf = x.new_zeros((E, b, capacity + 1, d))
    buf[gate_idx, bi, slot] = x[bi, si]

    experts = lw["experts"]
    out_buf = torch.empty_like(buf)
    for e in range(E):
        xe = buf[e].reshape(-1, d)
        h = (F.silu(xe @ _expert(experts["w_gate"], e, x.dtype))
             * (xe @ _expert(experts["w_up"], e, x.dtype)))
        out_buf[e] = (h @ _expert(experts["w_down"], e, x.dtype)).reshape(
            b, capacity + 1, d)

    # combine: each token's kept pairs, weighted by their gates (rounded to
    # the activation type, as the JAX combine tensor is), summed in fp32
    w = gate_vals.to(x.dtype).float() * kept
    picked = out_buf[gate_idx, bi, slot].float()                 # (B,S,K,D)
    out = (w[..., None] * picked).sum(2).to(x.dtype)
    return out, probs, kept


def moe_ffn(cfg: MoeConfig, x: torch.Tensor, lw: Dict[str, Any],
            ep_axis=None, tp_axis=None, token_mask=None,
            keep_capacity=None, no_drop: bool = False):
    """Top-k MoE with capacity-bounded dispatch. x: (B, S, D) → ((B, S,
    D), scalar aux load-balancing loss).

    ``token_mask`` (B, S) bool marks real tokens: padding never claims a
    capacity slot and stays out of the aux statistics. ``keep_capacity``
    (an int) lowers the overflow-drop threshold to the real length's
    capacity while the buffer stays sized by the padded S, so a
    right-padded prompt routes its real tokens as the unpadded one would.
    ``no_drop`` sizes the buffer to S slots per expert, so no token can
    overflow (overrides ``keep_capacity``)."""
    if ep_axis is not None or tp_axis is not None:
        raise NotImplementedError(
            "expert/tensor-parallel MoE (ep_axis, tp_axis) is not ported")
    E = cfg.n_experts
    out, probs, _ = _dispatch(cfg, x, lw, token_mask, keep_capacity, no_drop)
    # aux load-balancing loss (Switch-style) on top-1 assignments
    top1 = F.one_hot(probs.argmax(-1), E).float()
    if token_mask is None:
        frac = top1.mean(dim=(0, 1))
        aux = E * (frac * probs.mean(dim=(0, 1))).sum()
    else:
        m = token_mask.float()
        denom = m.sum() + 1e-9
        frac = torch.einsum("bse,bs->e", top1, m) / denom
        aux = E * (frac * (torch.einsum("bse,bs->e", probs, m) / denom)).sum()
    return out, aux


def moe_prefill_keep_capacity(cfg, true_len: int):
    """Overflow-drop threshold for a prefill of ``true_len`` real tokens on
    a longer padded bucket (None for dense configs): the capacity
    ``moe_ffn`` would take at the unpadded length, computed in fp32 as the
    JAX package computes it."""
    kc = getattr(cfg, "capacity_factor", None)
    if kc is None:
        return None
    v = (np.float32(kc) * np.float32(true_len)
         * np.float32(cfg.experts_per_token) / np.float32(cfg.n_experts))
    return max(1, int(np.floor(v)))


def moe_ffn_decode(cfg: MoeConfig, x: torch.Tensor, lw: Dict[str, Any]):
    """Decode-specialized top-k MoE: gather the K chosen experts' weights
    per token and run only those FFNs. Exact only at T == 1, where no
    pair can overflow (callers gate on it). x: (B, T, D) → (B, T, D)."""
    _, gate_vals, gate_idx = _route(cfg, x, lw)                  # (B, T, K)

    def gather_expert(leaf):
        """The K chosen experts' matrices; an int8 bank gathers values and
        scales first and dequantizes only the gathered slices."""
        if isinstance(leaf, dict) and Q4KEY in leaf:
            raise ValueError(
                "int4 expert banks are not supported on the decode gather "
                "path — quantize experts to int8 (quantize_params_int4 "
                "does this automatically)")
        if is_quantized(leaf):
            return dequant({QKEY: leaf[QKEY][gate_idx],
                            "scale": leaf["scale"][gate_idx]}, x.dtype)
        return leaf[gate_idx]

    experts = lw["experts"]
    xr = x[:, :, None, None, :]                                  # (B,T,1,1,D)
    wg = gather_expert(experts["w_gate"])                        # (B,T,K,D,F)
    h = F.silu(xr @ wg)
    del wg
    h = h * (xr @ gather_expert(experts["w_up"]))                # (B,T,K,1,F)
    out = (h @ gather_expert(experts["w_down"]))[..., 0, :]      # (B,T,K,D)
    return (gate_vals.to(x.dtype)[..., None, :] @ out)[..., 0, :]


def _moe_layer(cfg: MoeConfig, x: torch.Tensor, lw: Dict[str, Any],
               freqs: torch.Tensor):
    """One MoE decoder layer over (B, S, D): (new x, aux)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, lw["attn_norm"], cfg.norm_eps)
    q = (h @ lw["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ lw["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ lw["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q, k = apply_rope(q, freqs), apply_rope(k, freqs)
    x = x + attention(q, k, v, cfg._llama_view()).reshape(b, s, -1) @ lw["wo"]
    h = rmsnorm(x, lw["ffn_norm"], cfg.norm_eps)
    ffn_out, aux = moe_ffn(cfg, h, lw)
    return x + ffn_out, aux


def _unbind_layers(tree: Any) -> Any:
    """Each stacked leaf of ``params["layers"]`` unbound once into its
    per-layer views (``experts`` is a nested dict)."""
    if isinstance(tree, dict):
        return {k: _unbind_layers(v) for k, v in tree.items()}
    return tree.unbind(0)


def _layer_of(per_layer: Any, i: int) -> Any:
    if isinstance(per_layer, dict):
        return {k: _layer_of(v, i) for k, v in per_layer.items()}
    return per_layer[i]


def moe_forward(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: MoeConfig):
    """tokens (B, S) → (logits (B, S, V) fp32, aux loss scalar: the mean
    over layers).

    Under grad mode each layer runs inside a checkpoint (``"dots"``) when
    ``cfg.remat`` is on. Each stacked leaf is unbound once before the
    loop, as ``llama_hidden`` does: indexing it per layer would give each
    layer's backward a zero-filled gradient of the whole leaf."""
    x = params["embed"][tokens].to(cfg.dtype)
    freqs = rope_freqs(cfg, tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    layer = checkpointed(lambda x, lw: _moe_layer(cfg, x, lw, freqs),
                         resolve_remat_policy("dots" if remat else None))
    per_layer = _unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        x, a = layer(x, _layer_of(per_layer, i))
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    return logits, aux / cfg.n_layers


def moe_loss(params: Dict[str, Any], tokens: torch.Tensor,
             targets: torch.Tensor, cfg: MoeConfig) -> torch.Tensor:
    """Next-token cross-entropy over the full vocabulary (fp32
    log-softmax, mean over all positions) plus ``router_aux_weight`` times
    the layers' mean aux load-balancing loss, as the JAX package's
    ``moe_loss``."""
    logits, aux = moe_forward(params, tokens, cfg)
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean() + cfg.router_aux_weight * aux
