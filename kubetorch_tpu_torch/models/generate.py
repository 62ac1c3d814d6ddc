"""Autoregressive generation with a static KV cache, the counterpart of
``kubetorch_tpu/models/generate.py`` for the dense Llama and the MoE
family (``models.moe``).

The cache is one preallocated (L, B, S_max, NKV, Hd) buffer per K and V,
updated in place (where the JAX version returns a new cache, this one
writes into the given one and returns it). A from-zero prefill whose
length is a multiple of 128 runs through the flash attention kernel; every
other step attends to the cache with the plain masked einsum. Params may
be quantized (``models.quant``): each layer is dequantized at the top of
its body (int8 materializes, int4 stays packed for ``wdot``; an MoE
layer's expert bank stays as stored and ``models.moe`` dequantizes the
experts it runs). ``_layer_step`` and ``ffn_block`` are shared with the
engine (``serve.engine``), which also threads LoRA adapters
(``models.lora``) and the MoE routing mask through them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from .common import resolve_device
from .llama import apply_rope, layer_weights, rmsnorm, rope_freqs
from .lora import lora_proj
from .moe import moe_ffn_decode
from .moe import _dispatch as _moe_dispatch
from .quant import dequant_layer, lm_head_dot, wdot

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor   # (L, B, S_max, NKV, Hd)
    v: torch.Tensor


def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device=None) -> KVCache:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _cached_attention(q, cache_k, cache_v, q_pos, scale):
    """q: (B, T, N, Hd) at absolute positions q_pos (T,); cache: (B, S, NKV,
    Hd). Causal mask over absolute positions; unwritten rows masked out."""
    b, t, nh, hd = q.shape
    s, nkv = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, t, nkv, nh // nkv, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, cache_k).float() * scale
    kv_pos = torch.arange(s, device=q.device)
    mask = kv_pos[None, :] <= q_pos[:, None]                  # (T, S)
    logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, cache_v)
    return out.reshape(b, t, nh, hd)


def _flash_prefill_wanted(cfg, t: int, device: torch.device) -> bool:
    """Route a from-zero prefill through the flash attention kernel?

    A prefill from position 0 attends only within its own T tokens, so it
    is plain causal self-attention and the kernel applies. Gated to T a
    multiple of 128 (serving pads prompts to buckets) and to ``auto`` on
    CUDA; ``attn_impl="flash"`` takes the branch on any device (on the CPU
    the wrapper runs its plain version), ``"xla"`` opts out."""
    shape_ok = t >= 128 and t % 128 == 0
    if cfg.attn_impl == "flash":
        return shape_ok
    if cfg.attn_impl == "auto":
        return shape_ok and device.type == "cuda"
    return False


def _layer_step(cfg, x, lw, layer_cache_k, layer_cache_v, start: int,
                freqs_full, flash_prefill: bool = False, token_mask=None,
                keep_capacity=None, lora=None,
                moe_no_drop: bool = False) -> torch.Tensor:
    """One layer over T new tokens at absolute positions
    ``start .. start+T-1``; writes their K/V rows into this layer's cache
    (B, S_max, NKV, Hd) in place and returns the new hidden states. ``lw``
    may hold quantized leaves, dequantized here, one layer at a time.
    ``lora``: None, or (adapters_by_target, scale) with this layer's
    factors (``models.lora.lora_proj``), applied to wq/wk/wv/wo as the
    engine's decode layers apply them. ``token_mask``, ``keep_capacity``
    and ``moe_no_drop`` reach an MoE layer's routing (``ffn_block``)."""
    lw = dequant_layer(lw, cfg.dtype)
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, lw["attn_norm"], cfg.norm_eps)
    q = lora_proj(h, lw["wq"], lora, "wq").reshape(b, t, cfg.n_heads, hd)
    k = lora_proj(h, lw["wk"], lora, "wk").reshape(b, t, cfg.n_kv_heads, hd)
    v = lora_proj(h, lw["wv"], lora, "wv").reshape(b, t, cfg.n_kv_heads, hd)
    freqs = freqs_full[start:start + t]
    q, k = apply_rope(q, freqs), apply_rope(k, freqs)
    layer_cache_k[:, start:start + t] = k.to(layer_cache_k.dtype)
    layer_cache_v[:, start:start + t] = v.to(layer_cache_v.dtype)
    if flash_prefill:
        from ..ops.attention import flash_attention
        attn = flash_attention(q, k, v, causal=True, scale=hd ** -0.5)
    else:
        q_pos = torch.arange(start, start + t, device=x.device)
        attn = _cached_attention(q, layer_cache_k, layer_cache_v, q_pos,
                                 hd ** -0.5)
    x = x + lora_proj(attn.reshape(b, t, -1), lw["wo"], lora, "wo")
    h = rmsnorm(x, lw["ffn_norm"], cfg.norm_eps)
    return x + ffn_block(cfg, h, lw, token_mask=token_mask,
                         keep_capacity=keep_capacity, moe_no_drop=moe_no_drop)


def ffn_block(cfg, h: torch.Tensor, lw: Dict[str, Any], token_mask=None,
              keep_capacity=None, moe_no_drop: bool = False) -> torch.Tensor:
    """Post-norm FFN, shared by ``generate`` and the engine: the dense
    SwiGLU, or the MoE layer when ``lw`` carries a ``router`` leaf.

    MoE: a true decode step (T == 1, where no pair can overflow, so both
    forms are equal) gathers just the K chosen experts' weights per token
    when that moves less weight than streaming all E experts, 2·B·K <= E
    (the gather writes its copies and reads them again); everything else
    takes the capacity-buffer dispatch, whose drops match training. With
    no mesh in the port, the expert axis always has size 1."""
    if "router" in lw:
        b, t = h.shape[0], h.shape[1]
        if (t == 1 and cfg.decode_gather_ffn
                and 2 * b * cfg.experts_per_token <= cfg.n_experts):
            return moe_ffn_decode(cfg, h, lw)
        return _moe_dispatch(cfg, h, lw, token_mask, keep_capacity,
                             moe_no_drop)[0]
    return wdot(torch.nn.functional.silu(wdot(h, lw["w_gate"]))
                * wdot(h, lw["w_up"]), lw["w_down"])


@torch.no_grad()
def forward_with_cache(params, tokens: torch.Tensor, cache: KVCache,
                       start_pos: int, cfg):
    """Run T new tokens at absolute position ``start_pos``; returns fp32
    logits for the LAST position and the cache (updated in place)."""
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    freqs_full = rope_freqs(cfg, cache.k.shape[2], device=tokens.device)
    flash = start_pos == 0 and _flash_prefill_wanted(cfg, t, tokens.device)
    for i in range(cfg.n_layers):
        x = _layer_step(cfg, x, layer_weights(params, i), cache.k[i],
                        cache.v[i], start_pos, freqs_full, flash_prefill=flash)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_head_dot(x[:, -1], params, cfg.dtype), cache


def nucleus_mask(scaled: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Top-p filter over the last axis: keep the smallest prefix of the
    probability-sorted vocab whose mass reaches ``top_ps`` (per row; 1.0
    disables). The top-1 token always survives."""
    probs = torch.softmax(scaled, dim=-1)
    sp, si = torch.sort(probs, dim=-1, descending=True)
    before = torch.cumsum(sp, dim=-1) - sp
    keep_sorted = before < top_ps[..., None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, si, keep_sorted)
    return scaled.masked_fill(~keep, NEG_INF)


def filter_logits(logits: torch.Tensor, temps: torch.Tensor,
                  top_k: Optional[int],
                  top_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, V) logits → per-row temperature ``temps`` (B,), then top-k, then
    top-p with per-row mass ``top_ps`` (B,; None skips the sort). Shared by
    ``sample_logits`` and the engine so their semantics cannot diverge."""
    scaled = logits / temps[:, None]
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, NEG_INF)
    if top_ps is not None:
        scaled = nucleus_mask(scaled, top_ps)
    return scaled


def sample_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int], top_p: Optional[float] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k/top-p sampling over the
    last axis of (B, V) logits → (B,) int64."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    rows = logits.shape[0]
    temps = torch.full((rows,), temperature, device=logits.device)
    top_ps = (torch.full((rows,), top_p, device=logits.device)
              if top_p is not None and top_p < 1.0 else None)
    probs = torch.softmax(filter_logits(logits, temps, top_k, top_ps), -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(params, prompt, cfg, max_new_tokens: int = 64,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             top_p: Optional[float] = None, device=None) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation over a ``LlamaConfig``
    or ``MoeConfig`` tree. prompt: (B, T) ints → (B, T + max_new_tokens). A tensor prompt runs on its own device; any
    other prompt goes to ``device`` (``cuda`` unless named)."""
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.as_tensor(prompt, device=resolve_device(device))
    prompt = prompt.long()
    b, t_prompt = prompt.shape
    max_len = t_prompt + max_new_tokens
    cache = init_cache(cfg, b, max_len, device=prompt.device)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=prompt.device)
        generator.manual_seed(0)

    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg)
    tok = sample_logits(logits, temperature, top_k, top_p, generator)
    out = [prompt, tok[:, None]]
    for i in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, tok[:, None], cache,
                                           t_prompt + i, cfg)
        tok = sample_logits(logits, temperature, top_k, top_p, generator)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
