"""Continuous-batching generation engine: the serving subset of
``kubetorch_tpu/serve/engine.py`` in PyTorch.

- **Slot grid.** The KV cache is one preallocated ``(L, SLOTS, S_max, NKV,
  Hd)`` tensor per K and V. A request holds a slot for its lifetime;
  admission and retirement are host-side bookkeeping. Where the JAX engine
  donates the cache into each jitted call, this one updates the same
  buffers in place (the decode step's row writes, the prefill splice), so
  the device holds exactly one grid.
- **One decode step for the whole grid.** Every step decodes all slots;
  per-slot positions drive RoPE and the mask. Attention is the
  flash-decode kernel (``ops.decode_attention``), which reads each layer's
  cache slice in place and only the rows each slot has written.
- **Quantized serving.** Params may be int8 or int4 (``models.quant``):
  each layer is dequantized at the top of its body, and int4 projections
  go through the fused int4 matmul kernel (``ops.quant_matmul``) where
  its tiling applies. ``quantize_kv=True`` keeps the grid in int8 with a
  scale per row and head (``serve.kv_quant``): a prefill's rows quantize
  when they are spliced into the slot, each decode step quantizes its new
  row, and attention is the int8 flash-decode kernel, which folds the
  scales in.
- **Bucketed prefill.** Prompts are right-padded to a bucket length and
  run through the flash attention kernel (``ops.attention``) when the
  bucket is a multiple of 128; the rows are then copied into the slot.
- **Prefix caching.** ``register_prefix`` prefills a shared prefix once and
  keeps its K/V rows, padded to a bucket, in the model dtype. A request
  with its ``prefix_id`` (or, under ``auto_prefix``, the longest registered
  prefix its prompt starts with) prefills only its suffix, at absolute
  positions behind the prefix, over a new buffer that copies the prefix's
  rows: the stored rows are never written. A suffix attends to the cache
  with the plain masked einsum, as in the JAX engine.
- **Chunked prefill.** With ``prefill_chunk=C`` a prompt longer than C
  admits over several engine steps, one C-token chunk per step between
  decode blocks, through the same suffix pass over an accumulator of
  ``max_len`` rows (``max_len + C`` while a chunk runs). The first chunk
  of a prompt without a prefix is a from-zero prefill.
- **Decode blocks.** ``decode_block`` steps run per engine step. A slot
  that retires mid-block keeps computing garbage for the rest of the block
  and the host drops its tokens. Its positions may pass ``S_max``: the JAX
  engine relies on XLA dropping out-of-bounds scatters there, while in
  PyTorch an out-of-bounds index is a device-side assert, so positions are
  clamped to ``S_max - 1``. The clamped writes land only in the retired
  slot's own last row, which its next occupant writes before it reads.
- **Sampling.** Each sampled request owns a ``torch.Generator`` on the
  device, seeded from its ``seed`` (or, unseeded, from the engine's seed
  sequence), drawn once per token it samples: a seeded request decodes the
  same tokens whatever slot it lands in and whoever its neighbours are. A
  prefill chunk that samples nothing draws nothing.
- **Penalties and logit_bias.** Frequency and presence penalties (from a
  ``(SLOTS, V)`` grid of seen-token counts, prompt included) and an
  additive ``logit_bias`` row per slot steer the choice before sampling;
  reported logprobs stay the raw model's. The grids are allocated on the
  first request that asks for them, the counts grow on the device inside
  the step, and stale rows of past occupants are neutralized by a zero
  penalty or a zero bias mask, so an unpenalized neighbour's tokens are
  bit-identical to a run without penalized ones.

- **MoE.** An MoE tree (``models.moe``, e.g. Mixtral-8x7B with int8
  expert banks beside int4 attention) serves through the same passes.
  Padding never routes: a prefill passes a mask of its real tokens and
  the real length's capacity as the overflow threshold, so a prompt
  routes alike at any bucket. A prefix hit and each prefill chunk route
  their own segment (capacity per segment), as in the JAX engine. Decode
  steps take the K-expert gather when 2·SLOTS·K <= E, else the dispatch.
- **Multi-LoRA.** ``register_adapter`` stacks adapters into one bank per
  target, (L, N, D, R) and (L, N, R, O), index 0 the zero adapter. A
  request's ``adapter_id`` runs its prefill through its factors and
  points its slot at its bank index; each decode step gathers every
  slot's factors once and adds ``s·(x·A)·B`` (fp32) to wq/wk/wv/wo, so
  base traffic (index 0) stays bit-identical to an engine without banks.
  An engine without banks skips the gather. Registration and
  ``unregister_adapter`` build new bank tensors under the engine's lock
  and never write one a step may be reading; an unregistered adapter's
  decoding slots fall back to the base model. Prefixes are keyed by the
  adapter they were computed through.

- **Service hooks.** ``at_batch_boundary(fn)`` runs ``fn`` on the
  stepping thread between decode batches (the one safe point for a live
  weight swap, ``serve/rollout.py``); ``feedback_sink`` receives one
  summary per retired request; ``__kt_metrics__`` is the pod scrape's
  gauges and ``aot_stats`` the compile cache's counts, as in the JAX
  engine.
- **Compile cache.** With ``aot_cache=`` (``serve/aot_cache.py``) the
  engine resolves the kernel libraries its passes launch through the
  cache at construction (a hit loads with no ``nvcc``) and runs one
  prefill per bucket and one decode block (``warm_engine``); on a mesh
  the cache is ignored, as in JAX.

- **On a device mesh.** With ``mesh=`` (or the ambient mesh of
  ``parallel.mesh_context.use_mesh`` at construction) the params are
  DTensors laid out by the rule table and the dense math runs under
  DTensor's propagation; the grid is split as JAX's ``_cache_shardings``
  splits it (slots over the batch axes, the sequence over ``context``, KV
  heads over ``tensor``, each where it divides) and everything that
  touches it runs on each rank's shards (``_MeshGrid``): the row writes by
  the rank that holds the row, decode attention through B1/B2 on the local
  slots and heads or, on a context mesh, their partial mode over the
  rank's rows and one online-softmax combine
  (``parallel.ring_attention.sp_decode_attention``). A long from-zero
  prefill on a context mesh takes ring attention (``models.generate``).
  Each rank runs an engine, every rank submits the same requests in the
  same order, and the ranks agree on each step over a gloo group
  (``_StepAgreement``). An MoE tree (``MOE_RULES``) runs its experts on
  each rank's shards of the bank (``models.moe``: an expert-sharded bank
  runs each rank's own experts and one reduction rebuilds the FFN's
  output); the grid is replicated over ``expert``. A quantized tree
  (int8, int4, or Mixtral's int8 experts beside int4 attention) is
  replicated by the rules, as in JAX, and its matmuls run on each rank's
  rows (``models.quant``: B3 against the whole packed matrix, int8 leaves
  dequantized in place). LoRA banks serve on a mesh: the banks are plain
  tensors, whole on every rank; a registration or an unregistration runs
  at a step the ranks agree on (``at_batch_boundary``); each decode step
  gathers the rank's own slots' factors, and each delta is added in the
  layout of the sharded product it joins (``models.lora.lora_proj``).
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.common import resolve_device
from ..models.common import embed_lookup, replicate_like, settle
from ..models.generate import (KVCache, _flash_prefill_wanted, _layer_step,
                               ffn_block, filter_logits, init_cache)
from ..models.llama import _rotate, layer_weights, rmsnorm, rope_freqs
from ..models.lora import gather_slot_adapters, lora_proj
from ..models.moe import moe_prefill_keep_capacity
from ..models.quant import dequant_layer, is_quantized, lm_head_dot
from ..ops.decode_attention import (decode_attention, decode_attention_quant,
                                    decode_attention_quant_ref,
                                    decode_attention_ref)
from ..serving.metrics import device_gauges
from .kv_quant import QuantKVCache, init_quant_cache, quantize_rows


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def _rope_slot(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """RoPE with a per-slot rotation: x (B, N, Hd), freqs (B, Hd/2)."""
    return _rotate(x, freqs[:, None, :])


def _decode_qkv(cfg, x, lw, freqs, lora=None):
    """The projections of one new token per slot, RoPE applied: q (B, NH,
    Hd), k and v (B, NKV, Hd). ``lora``: None, or each slot's adapter
    factors, (B, D, R)/(B, R, O) per target. Shared by both cache
    layouts."""
    b = x.shape[0]
    hd = cfg.head_dim
    h = rmsnorm(x, lw["attn_norm"], cfg.norm_eps)
    q = lora_proj(h, lw["wq"], lora, "wq").reshape(b, cfg.n_heads, hd)
    k = lora_proj(h, lw["wk"], lora, "wk").reshape(b, cfg.n_kv_heads, hd)
    v = lora_proj(h, lw["wv"], lora, "wv").reshape(b, cfg.n_kv_heads, hd)
    return _rope_slot(q, freqs), _rope_slot(k, freqs), v


def _decode_out(cfg, x, lw, attn, lora=None) -> torch.Tensor:
    """Output projection of attention (B, NH, Hd) and the FFN (dense, or
    the MoE layer at T == 1), residuals included. Shared by both cache
    layouts."""
    x = x + settle(lora_proj(attn.reshape(x.shape[0], 1, -1).to(x.dtype),
                             lw["wo"], lora, "wo"))
    h = rmsnorm(x, lw["ffn_norm"], cfg.norm_eps)
    return x + settle(ffn_block(cfg, h, lw))


def _decode_layer(cfg, x, lw, ck, cv, pos, pos_idx, freqs,
                  lora=None, grid=None) -> torch.Tensor:
    """One layer over one new token per slot. x: (B, 1, D); ck/cv: this
    layer's (B, S, NKV, Hd) cache, written in place at each slot's row;
    pos: (B,) int32 row of each slot's new token (``pos_idx`` the same as
    int64 for indexing); freqs: (B, Hd/2). ``lw`` is dequantized already
    (:func:`_decode_step_impl`). On a mesh (``grid``, a ``_MeshGrid``) x
    and the weights are DTensors and ck/cv this rank's shards."""
    q, k, v = _decode_qkv(cfg, x, lw, freqs, lora)
    if grid is not None:
        return _decode_out(cfg, x, lw, grid.decode_attend(
            cfg, q, k, v, (ck, cv), pos, quant=False), lora)
    bi = torch.arange(x.shape[0], device=x.device)
    ck[bi, pos_idx] = k.to(ck.dtype)
    cv[bi, pos_idx] = v.to(cv.dtype)
    # "xla" keeps the plain masked einsum; otherwise the flash-decode
    # wrapper (the kernel on CUDA, the same einsum on the CPU)
    attend = decode_attention_ref if cfg.attn_impl == "xla" else decode_attention
    return _decode_out(cfg, x, lw, attend(q, ck, cv, pos,
                                          scale=cfg.head_dim ** -0.5), lora)


def _decode_layer_quant(cfg, x, lw, kq, ks, vq, vs, pos, pos_idx,
                        freqs, lora=None, grid=None) -> torch.Tensor:
    """:func:`_decode_layer` against an int8 cache (``serve.kv_quant``):
    the new row is quantized before it is written (kq/vq (B, S, NKV, Hd)
    int8, ks/vs (B, S, NKV) fp32, this layer's slices, in place), and
    attention folds the row scales in instead of materializing fp rows."""
    q, k, v = _decode_qkv(cfg, x, lw, freqs, lora)
    if grid is not None:
        return _decode_out(cfg, x, lw, grid.decode_attend(
            cfg, q, k, v, (kq, ks, vq, vs), pos, quant=True), lora)
    bi = torch.arange(x.shape[0], device=x.device)
    kq[bi, pos_idx], ks[bi, pos_idx] = quantize_rows(k)
    vq[bi, pos_idx], vs[bi, pos_idx] = quantize_rows(v)
    # "xla" keeps the plain fold-in einsum; otherwise the int8 flash-decode
    # wrapper (the kernel on CUDA, the same einsum on the CPU)
    attend = (decode_attention_quant_ref if cfg.attn_impl == "xla"
              else decode_attention_quant)
    return _decode_out(cfg, x, lw, attend(q, kq, ks, vq, vs, pos,
                                          scale=cfg.head_dim ** -0.5), lora)


def _sample_slots(logits, temps: np.ndarray, top_k: Optional[int],
                  top_ps: np.ndarray, gens: Sequence[Optional[torch.Generator]],
                  lp_logits=None):
    """Per-slot sampling over (B, V) fp32 logits. ``temps`` (B,): 0 means
    greedy for that row; ``top_ps`` (B,): nucleus mass, 1.0 disables;
    ``gens``: each sampled row draws from its own generator, so its token
    depends on nothing but its own logits and stream. ``lp_logits`` lets a
    caller that steered ``logits`` (penalties, bias) pass the raw ones for
    the reported score. Returns (tokens (B,) int64, raw-model logprob of
    each token (B,) fp32)."""
    tok = torch.argmax(logits, dim=-1)
    rows = [i for i in range(logits.shape[0]) if temps[i] > 0]
    if rows:
        dev = logits.device
        tp = top_ps[rows]
        scaled = filter_logits(
            logits[torch.tensor(rows, device=dev)],
            torch.as_tensor(temps[rows], device=dev), top_k,
            torch.as_tensor(tp, device=dev) if (tp < 1.0).any() else None)
        probs = torch.softmax(scaled, dim=-1)
        for j, i in enumerate(rows):
            tok[i] = torch.multinomial(probs[j], 1, generator=gens[i])[0]
    logp = torch.log_softmax(logits if lp_logits is None else lp_logits,
                             dim=-1)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


def _decode_step_impl(params, cache, pos, toks, cfg, freqs_table,
                      banks=None, aidx=None, lora_scale: float = 1.0,
                      grid=None):
    """Single-step decode math for every slot: returns (B, V) fp32 logits
    and writes each slot's new K/V row. ``cache`` is a ``KVCache`` or an
    int8 ``QuantKVCache``. ``pos`` (B,) int32 on the device; positions past
    the grid clamp to its last row (module docstring), in every tensor of
    either cache. ``banks`` (target → (A (L, N, D, R), B (L, N, R, O)))
    with ``aidx`` (B,) int64 on the device select each slot's adapter
    (index 0 = the zero adapter = base); they are gathered once for every
    layer. On a mesh (``grid``) the params are DTensors, the cache's leaves
    are read as this rank's shards, and the logits come back whole on
    every rank."""
    quant = isinstance(cache, QuantKVCache)
    s_max = (cache.kq if quant else cache.k).shape[2]
    pos = pos.clamp(max=s_max - 1)
    pos_idx = pos.long()
    x = embed_lookup(params["embed"], toks)[:, None].to(cfg.dtype)  # (B, 1, D)
    freqs = freqs_table[pos_idx]                               # (B, Hd/2)
    if grid is not None:
        x = grid.pin(x)
        freqs = replicate_like(freqs, x)
        cache = type(cache)(*(t.to_local() for t in cache))
    # decided once per tree: a plain tree skips the per-layer dequant walk
    quant_w = any(is_quantized(w) for w in params["layers"].values())
    # each slot's factors of every layer, (B, L, D, R) and (B, L, R, O);
    # on a mesh the rank's own slots
    if grid is not None and aidx is not None:
        aidx = aidx[grid.b0:grid.b0 + grid.nb]
    slot_lora = gather_slot_adapters(
        {t: (a.transpose(0, 1), b.transpose(0, 1))
         for t, (a, b) in (banks or {}).items()}, aidx, lora_scale, banks)
    for i in range(cfg.n_layers):
        lw = layer_weights(params, i)
        if quant_w:
            lw = dequant_layer(lw, cfg.dtype)
        lora = None
        if slot_lora is not None:
            lora = ({t: (a[:, i], b[:, i])
                     for t, (a, b) in slot_lora[0].items()}, lora_scale)
        if quant:
            x = _decode_layer_quant(cfg, x, lw, cache.kq[i], cache.ks[i],
                                    cache.vq[i], cache.vs[i], pos, pos_idx,
                                    freqs, lora, grid)
        else:
            x = _decode_layer(cfg, x, lw, cache.k[i], cache.v[i], pos,
                              pos_idx, freqs, lora, grid)
        if grid is not None:
            x = grid.pin(x)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _plain(lm_head_dot(x[:, 0], params, cfg.dtype))


def _decode_block(params, cache, pos, toks, cfg, freqs_table,
                  n_steps: int, temps, top_k, top_ps, gens, counts=None,
                  fpen=None, ppen=None, bias=None, bmask=None, banks=None,
                  aidx=None, lora_scale: float = 1.0, grid=None):
    """Advance every slot ``n_steps`` tokens. pos (B,) int32 and toks (B,)
    int64 on the device. ``counts`` (B, V) int32 with ``fpen``/``ppen``
    (B,) fp32: OpenAI repetition penalties, ``fpen·counts + ppen·(counts >
    0)`` subtracted before sampling; ``bias`` (B, V) fp32 with ``bmask``
    (B,): each slot's logit_bias, added where its mask is 1. A zero
    penalty or mask multiplies a stale row by 0, so unpenalized slots see
    their logits unchanged. After each inner step ``counts`` gains the
    sampled tokens, in place on the device. ``banks``/``aidx``/
    ``lora_scale``: the slots' adapters (:func:`_decode_step_impl`);
    ``grid``: the cache's layout on a mesh. Returns (tokens (K, B),
    logprobs (K, B))."""
    toks_k, lps_k = [], []
    slot_idx = torch.arange(toks.shape[0], device=toks.device)
    for _ in range(n_steps):
        raw = _decode_step_impl(params, cache, pos, toks, cfg, freqs_table,
                                banks, aidx, lora_scale, grid)
        logits = raw
        if counts is not None:
            logits = logits - (fpen[:, None] * counts.float()
                               + ppen[:, None] * (counts > 0))
        if bias is not None:
            logits = logits + bias * bmask[:, None]
        toks, lps = _sample_slots(logits, temps, top_k, top_ps, gens,
                                  lp_logits=raw)
        if counts is not None:
            counts[slot_idx, toks] += 1
        pos = pos + 1
        toks_k.append(toks)
        lps_k.append(lps)
    return torch.stack(toks_k), torch.stack(lps_k)


def _routing(cfg, t: int, true_len: int, device):
    """An MoE prefill's routing arguments for ``true_len`` real tokens in a
    T-row pass: the mask of real rows (1, T) and the real length's
    capacity; empty for a dense config."""
    keep = moe_prefill_keep_capacity(cfg, true_len)
    if keep is None:
        return {}
    mask = (torch.arange(t, device=device) < true_len)[None, :]
    return dict(token_mask=mask, keep_capacity=keep)


def _layer_lora(adapter, i: int, lora_scale: float):
    """Layer ``i``'s slice of a request's adapter (target → (A (L, D, R),
    B (L, R, O))) in ``lora_proj``'s form, or None."""
    if not adapter:
        return None
    return {t: (a[i], b[i]) for t, (a, b) in adapter.items()}, lora_scale


def _prefill_logits(params, tokens, true_len: int, cfg, freqs_table,
                    adapter=None, lora_scale: float = 1.0, grid=None):
    """Prompt pass at one bucket length. tokens (1, T_bucket) right-padded;
    logits (1, V) fp32 are taken at the real last position ``true_len - 1``
    (padding rows only pollute their own cache rows, which decode
    overwrites before attending to them, and never claim an MoE capacity
    slot). ``adapter`` (target → (A (L, D, R), B (L, R, O))) runs the pass
    through one LoRA adapter. Returns (logits, k, v) with k/v (L, 1,
    T_bucket, NKV, Hd). On a mesh (``grid``) the pass runs replicated over
    the batch axes (B = 1) on DTensors, k/v are DTensors in the grid's
    buffer layout, and the logits come back whole; a long prompt on a
    context mesh takes ring attention (``models.generate``)."""
    b, t = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    flash = _flash_prefill_wanted(cfg, t, tokens.device)
    if grid is None:
        cache = init_cache(cfg, b, t, device=tokens.device)
    else:
        cache = grid.buffers(cfg, b, t, tokens.device)
        x = grid.pin(x)
    route = _routing(cfg, t, true_len, tokens.device)
    for i in range(cfg.n_layers):
        x = _layer_step(cfg, x, layer_weights(params, i), cache.k[i],
                        cache.v[i], 0, freqs_table, flash_prefill=flash,
                        lora=_layer_lora(adapter, i, lora_scale),
                        causal_prefill=True, **route)
        if grid is not None:
            x = grid.pin(x)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (_plain(lm_head_dot(x[:, true_len - 1], params, cfg.dtype)),
            cache.k, cache.v)


def _zero_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """A new tensor: ``x`` (L, B, S, ...) followed by ``n`` zero rows along
    S. Never a view of ``x``, so writing into it leaves ``x`` as it was. A
    DTensor (whole along S) grows on each rank's shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        local = _zero_rows(x.to_local(), n)
        shape = x.shape[:2] + (x.shape[2] + n,) + x.shape[3:]
        return DTensor.from_local(local, x.device_mesh, x.placements,
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())
    pad = x.new_zeros(x.shape[:2] + (n,) + x.shape[3:])
    return torch.cat([x, pad], dim=2)


def _prefill_suffix_logits(params, tokens, true_len: int, prefix_k,
                           prefix_v, prefix_len: int, cfg, freqs_table,
                           adapter=None, lora_scale: float = 1.0, grid=None):
    """Suffix prompt pass behind cached rows: tokens (1, T_bucket)
    right-padded run at absolute positions ``prefix_len + i`` and attend
    the first ``prefix_len`` rows of ``prefix_k``/``prefix_v`` (L, 1,
    P_bucket, NKV, Hd) plus themselves, with the plain masked attention.
    The pass runs over a new buffer of P_bucket + T_bucket rows (the
    prefix's, then zeros); suffix rows are written from ``prefix_len`` on,
    over the prefix's padding, and the causal mask never admits a row not
    yet written. ``freqs_table`` must hold P_bucket + T_bucket rows.
    Returns (logits (1, V) at the suffix's real last token, k, v) with k/v
    (L, 1, P_bucket + T_bucket, NKV, Hd), ready to splice into a slot.
    Exact for dense models: the same math as a from-zero prefill of prefix
    and suffix together. An MoE suffix routes on its own (capacity per
    segment): equal to the whole prompt's pass whenever no expert
    overflows. On a mesh (``grid``) as :func:`_prefill_logits`."""
    t = tokens.shape[1]
    ck, cv = _zero_rows(prefix_k, t), _zero_rows(prefix_v, t)
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    if grid is not None:
        x = grid.pin(x)
    route = _routing(cfg, t, true_len, tokens.device)
    for i in range(cfg.n_layers):
        x = _layer_step(cfg, x, layer_weights(params, i), ck[i], cv[i],
                        prefix_len, freqs_table,
                        lora=_layer_lora(adapter, i, lora_scale), **route)
        if grid is not None:
            x = grid.pin(x)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _plain(lm_head_dot(x[:, true_len - 1], params, cfg.dtype)), ck, cv


def _prefill(params, tokens, true_len: int, cfg, freqs_table,
             samp: "_Sampling", **lkw):
    """:func:`_prefill_logits` (``lkw``: its adapter arguments), then the
    first token sampled (:func:`_sample_first`). Returns (first (1,), k,
    v, logprob (1,))."""
    logits, k, v = _prefill_logits(params, tokens, true_len, cfg, freqs_table,
                                   **lkw)
    first, lp = _sample_first(logits, samp)
    return first, k, v, lp


def _prefill_suffix(params, tokens, true_len: int, prefix_k, prefix_v,
                    prefix_len: int, cfg, freqs_table, samp: "_Sampling",
                    **lkw):
    """:func:`_prefill_suffix_logits` (``lkw``: its adapter arguments),
    then the first token sampled (:func:`_sample_first`). Returns (first
    (1,), k, v, logprob (1,)), k/v over P_bucket + T_bucket rows."""
    logits, k, v = _prefill_suffix_logits(params, tokens, true_len, prefix_k,
                                          prefix_v, prefix_len, cfg,
                                          freqs_table, **lkw)
    first, lp = _sample_first(logits, samp)
    return first, k, v, lp


def _sample_first(logits, samp: "_Sampling"):
    """The first token of a request from its prefill logits (1, V):
    ``samp.pen_row`` (penalties of the prompt, less the bias) is
    subtracted before sampling, the reported logprob stays raw. Returns
    (first (1,), logprob (1,))."""
    steered = logits if samp.pen_row is None else logits - samp.pen_row[None]
    return _sample_slots(steered, np.array([samp.temp], np.float32), samp.top_k,
                         np.array([samp.top_p], np.float32), [samp.gen],
                         lp_logits=logits)


def _splice_slot(cache, slot: int, k_new, v_new, grid=None) -> None:
    """Copy a prefill's K/V rows (L, 1, T_b, NKV, Hd) into one slot of the
    grid, in place. An int8 ``QuantKVCache`` grid quantizes the rows here,
    all T_b of the padded bucket (padding rows get their own scales and
    are overwritten before they are read); prefill itself always runs
    full-precision math. On a mesh (``grid``) each rank that holds the slot
    writes its own rows and heads (``_MeshGrid.splice``)."""
    if grid is not None:
        grid.splice(cache, slot, k_new, v_new)
        return
    t = k_new.shape[2]
    if isinstance(cache, QuantKVCache):
        kq, ks = quantize_rows(k_new[:, 0])
        vq, vs = quantize_rows(v_new[:, 0])
        cache.kq[:, slot, :t] = kq
        cache.ks[:, slot, :t] = ks
        cache.vq[:, slot, :t] = vq
        cache.vs[:, slot, :t] = vs
        return
    cache.k[:, slot, :t] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot, :t] = v_new[:, 0].to(cache.v.dtype)


# ---------------------------------------------------------------------------
# on a device mesh
# ---------------------------------------------------------------------------

_BATCH_AXES = ("dcn", "data", "fsdp")


def _cache_shardings(mesh, cache):
    """A ``NamedSharding`` per leaf of a grid cache on ``mesh`` (None off a
    mesh), JAX's layout: slots over the batch axes (the largest prefix of
    them whose size divides the slot count), the sequence over
    ``context`` and the KV heads over ``tensor``, each only where it
    divides; values (L, B, S, NKV, Hd), int8 scales (L, B, S, NKV)."""
    if mesh is None:
        return None
    from ..parallel.sharding import NamedSharding
    from ..parallel.mesh import PartitionSpec as P
    from ..parallel.mesh import live_axes, normalize_batch_axes

    live = live_axes(mesh)

    def fit(axes, dim):
        while axes and dim % math.prod(live[a] for a in axes):
            axes = axes[:-1]
        return axes

    def leaf(x):
        ba = normalize_batch_axes(
            live, fit(tuple(a for a in _BATCH_AXES if a in live), x.shape[1]))
        ctx = ("context" if "context" in live
               and x.shape[2] % live["context"] == 0 else None)
        tp = ("tensor" if "tensor" in live
              and x.shape[3] % live["tensor"] == 0 else None)
        spec = (P(None, ba, ctx, tp, None) if len(x.shape) == 5
                else P(None, ba, ctx, tp))
        return NamedSharding(mesh, spec)

    return type(cache)(*(leaf(x) for x in cache))


class _MeshGrid:
    """One model's grid cache on a mesh (``_cache_shardings``) and the
    local work of every pass over it. The dense math runs on DTensors
    under DTensor's propagation; what touches the cache runs on this
    rank's shards (the counterpart of the JAX engine's ``shard_map``
    bodies and its donated in-place updates):

    - a decode step's row writes: only the rank that holds row ``pos`` of
      a slot writes it (the others rewrite a row with its own value);
    - decode attention: with the sequence over ``context``, the partial
      mode of B1/B2 over the shard and one online-softmax combine
      (``parallel.ring_attention.sp_decode_attention``); else B1/B2 (or,
      for ``attn_impl="xla"``, the plain einsum) on the local slots and
      heads;
    - the splice of a prefill's rows into a slot, by the ranks that hold
      that slot, each its own rows and heads.

    A prefill runs with B = 1, replicated over the batch axes, its K/V
    buffers whole along the sequence and split over the heads as the grid
    is (``buffer``)."""

    def __init__(self, mesh, cfg, slots: int, max_len: int):
        from ..parallel.mesh import PartitionSpec as P
        from ..parallel.mesh import spec_placements
        from ..parallel.sharding import local_slice

        self.mesh = mesh
        self.shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads,
                      cfg.head_dim)
        _, self.ba, ctx, tp, _ = _cache_shardings(mesh, KVCache(*[torch.empty(
            self.shape, device="meta")] * 2)).k.spec
        self.ctx = ctx is not None
        # q (B, NH, Hd) and a step's new rows (B, NKV, Hd)
        self.rows = spec_placements(P(self.ba, tp, None), mesh)
        self.buffer = spec_placements(P(None, None, None, tp, None), mesh)
        ids = local_slice(torch.arange(slots), mesh,
                          spec_placements(P(self.ba), mesh))
        self.b0, self.nb = int(ids[0]), len(ids)
        self.batch_ways = slots // self.nb      # shards of the slot dim
        rows = local_slice(torch.arange(max_len), mesh,
                           spec_placements(P(ctx), mesh))
        self.r0, self.nr = int(rows[0]), len(rows)
        self.window = spec_placements(P(self.ba, None, tp, None), mesh)

    def zeros(self, cfg, quant: bool):
        """The grid, zeros, as DTensors laid out by ``_cache_shardings``
        (each rank allocates only its shard): a ``KVCache``, or the int8
        ``QuantKVCache``."""
        from torch.distributed import tensor as dt

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if quant:
            vals, scales = meta(self.shape, torch.int8), meta(
                self.shape[:-1], torch.float32)
            cache = QuantKVCache(vals, scales, vals, scales)
        else:
            cache = KVCache(*[meta(self.shape, cfg.dtype)] * 2)
        return type(cache)(*(
            dt.zeros(m.shape, device_mesh=self.mesh, placements=sh.placements,
                     dtype=m.dtype)
            for m, sh in zip(cache, _cache_shardings(self.mesh, cache))))

    def pin(self, x: torch.Tensor) -> torch.Tensor:
        """Activations (B, ...) laid out over the grid's batch axes where B
        divides them, whole on every other axis."""
        from ..parallel.mesh import PartitionSpec as P
        from ..parallel.mesh import spec_placements

        ba = self.ba if x.shape[0] % self.batch_ways == 0 else None
        return x.redistribute(self.mesh, spec_placements(
            P(ba, *([None] * (x.ndim - 1))), self.mesh))

    def local(self, t: torch.Tensor, placements) -> torch.Tensor:
        return t.redistribute(self.mesh, placements).to_local()

    def wrap(self, local: torch.Tensor, like: torch.Tensor,
             placements) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    def buffers(self, cfg, b: int, t: int, device) -> KVCache:
        """Prefill K/V buffers (L, b, t, NKV, Hd), zeros, whole along the
        sequence, heads split as the grid's."""
        from torch.distributed import tensor as dt

        shape = (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(*(dt.zeros(shape, device_mesh=self.mesh,
                                  placements=self.buffer, dtype=cfg.dtype)
                         for _ in range(2)))

    def decode_attend(self, cfg, q, k, v, layer, pos, quant: bool):
        """One decode layer's cache writes and attention on this rank's
        shards. q (B, NH, Hd), k/v (B, NKV, Hd) DTensors; ``layer`` this
        layer's local cache tensors ((ck, cv), or (kq, ks, vq, vs)); pos
        (B,) int32, global. Returns the attention (B, NH, Hd) as a
        DTensor."""
        from ..parallel.ring_attention import (sp_decode_attention,
                                               sp_decode_attention_quant)

        q_l, k_l, v_l = (self.local(t, self.rows) for t in (q, k, v))
        pos_l = pos[self.b0:self.b0 + self.nb]
        bi = torch.arange(self.nb, device=pos.device)
        rows = pos_l.long() - self.r0
        if self.ctx:
            held = (rows >= 0) & (rows < self.nr)
            rows = rows.clamp(0, self.nr - 1)

        def put(buf, new):
            new = new.to(buf.dtype)
            if self.ctx:
                # the owner writes; every other rank rewrites its own row
                keep = held.reshape(-1, *([1] * (new.ndim - 1)))
                new = torch.where(keep, new, buf[bi, rows])
            buf[bi, rows] = new

        scale = cfg.head_dim ** -0.5
        if quant:
            kq, ks, vq, vs = layer
            k8, k_sc = quantize_rows(k_l)
            v8, v_sc = quantize_rows(v_l)
            for buf, new in ((kq, k8), (ks, k_sc), (vq, v8), (vs, v_sc)):
                put(buf, new)
            if self.ctx:
                out = sp_decode_attention_quant(q_l, kq, ks, vq, vs, pos_l,
                                                axis_name="context",
                                                scale=scale)
            else:
                attend = (decode_attention_quant_ref if cfg.attn_impl == "xla"
                          else decode_attention_quant)
                out = attend(q_l, kq, ks, vq, vs, pos_l, scale=scale)
        else:
            ck, cv = layer
            put(ck, k_l)
            put(cv, v_l)
            if self.ctx:
                out = sp_decode_attention(q_l, ck, cv, pos_l,
                                          axis_name="context", scale=scale)
            else:
                attend = (decode_attention_ref if cfg.attn_impl == "xla"
                          else decode_attention)
                out = attend(q_l, ck, cv, pos_l, scale=scale)
        return self.wrap(out, q, self.rows)

    def splice(self, cache, slot: int, k_new, v_new) -> None:
        """A prefill's rows (L, 1, T, NKV, Hd) into ``slot``, on the ranks
        that hold it: each writes its own rows of the slot and its own
        heads."""
        if not self.b0 <= slot < self.b0 + self.nb:
            return
        k_l, v_l = (self.local(t, self.buffer)[:, 0] for t in (k_new, v_new))
        lo, hi = self.r0, min(self.r0 + self.nr, k_l.shape[1])
        if hi <= lo:
            return
        k_l, v_l = k_l[:, lo:hi], v_l[:, lo:hi]
        i, n = slot - self.b0, hi - lo
        local = [t.to_local() for t in cache]
        if isinstance(cache, QuantKVCache):
            (kq, ks), (vq, vs) = quantize_rows(k_l), quantize_rows(v_l)
            for buf, new in zip(local, (kq, ks, vq, vs)):
                buf[:, i, :n] = new
            return
        for buf, new in zip(local, (k_l, v_l)):
            buf[:, i, :n] = new.to(buf.dtype)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (logits for sampling), or
    ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def _normalize_stop(stop) -> tuple:
    """One token-id sequence or a list of them → tuple of non-empty int
    tuples. An int-leading sequence is ONE stop sequence, not a list."""
    if stop is None or len(stop) == 0:
        return ()
    seqs = [stop] if not hasattr(stop[0], "__len__") else list(stop)
    if any(len(q) == 0 for q in seqs):
        raise ValueError("empty stop sequence")
    return tuple(tuple(int(t) for t in q) for q in seqs)


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: Optional[float] = None      # None → engine default
    top_p: Optional[float] = None            # None → engine default
    frequency_penalty: float = 0.0           # OpenAI-style repetition ctl
    presence_penalty: float = 0.0
    logit_bias: Optional[Dict[int, float]] = None  # token id → additive bias
    seed: Optional[int] = None               # reproducible sampling stream
    stop: tuple = ()                         # stop token-id sequences
    prefix_id: Optional[int] = None          # cached shared-prefix K/V
    adapter_id: Optional[int] = None         # registered LoRA adapter
    full_prompt: Optional[List[int]] = None  # pre-strip prompt (auto match)
    cancelled: bool = False                  # reaped at the next step
    cancel_asked: bool = False               # on a mesh: until the ranks agree
    error: Optional[BaseException] = None    # admission failure, surfaced
    out: "queue.Queue[Optional[int]]" = field(default_factory=queue.Queue)
    tail: list = field(default_factory=list)  # last max(len(stop)) tokens
    logprobs: list = field(default_factory=list)  # raw-model lp per token
    generated: int = 0
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None


class _Prefix(NamedTuple):
    """A registered prefix: K/V rows (L, 1, P_store, NKV, Hd) in the model
    dtype, padded to a bucket (or trimmed to the exact length where no
    bucket leaves room under max_len), its true length, its tokens and the
    adapter it was computed through (None for the base model)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int
    tokens: tuple
    adapter_id: Optional[int]


@dataclass
class _Chunking:
    """The one chunked admission in flight: its reserved slot, the K/V
    accumulator (L, 1, max_len, NKV, Hd), the prompt tokens consumed so far,
    the next absolute position, the cached prefix's tokens if any, and the
    request's adapter arguments and bank index, resolved once at the first
    chunk."""
    req: "_Request"
    slot: int
    k: torch.Tensor
    v: torch.Tensor
    consumed: int
    frontier: int
    prefix_tokens: Optional[tuple]
    lkw: dict
    aidx: int


@dataclass
class _Sampling:
    """A request's sampling state at admission: temperature and top-p, the
    engine's top-k, its generator (None when greedy), ``pen_row`` (V,)
    subtracted from the first token's logits (the prompt's penalties less
    the bias; None without either), the seen-token counts that seed the
    slot's row of the counts grid, and its bias row."""
    temp: float
    top_p: float
    top_k: Optional[int]
    gen: Optional[torch.Generator]
    pen_row: Optional[torch.Tensor]
    counts_row: Optional[np.ndarray]
    bias_row: Optional[np.ndarray]


class RequestHandle:
    """Streaming view of one request: iterate tokens as they decode, or
    block for the full completion. Tokens drained from the queue are kept on
    the handle, so a ``result()`` that times out loses nothing. Single
    consumer."""

    def __init__(self, req: _Request, engine: "GenerationEngine" = None):
        self._req = req
        self._engine = engine
        self._collected: List[int] = []
        self._done = False

    @property
    def request_id(self) -> int:
        return self._req.rid

    @property
    def logprobs(self):
        """Raw-model logprob per drained token."""
        return list(self._req.logprobs[:len(self._collected)])

    def cancel(self) -> bool:
        return (self._engine.cancel(self._req.rid)
                if self._engine is not None else False)

    def _pull(self, timeout: Optional[float]) -> bool:
        """Move one queue item into ``_collected``; False once finished.
        ``timeout=0`` means the item must already be queued."""
        if self._done:
            return False
        try:
            tok = (self._req.out.get_nowait() if timeout is not None
                   and timeout <= 0 else self._req.out.get(timeout=timeout))
        except queue.Empty:
            raise TimeoutError(
                f"request {self._req.rid} still decoding") from None
        if tok is None:
            self._done = True
            if self._req.error is not None:
                raise self._req.error
            return False
        self._collected.append(tok)
        return True

    def __iter__(self):
        i = 0
        while True:
            while i < len(self._collected):
                yield self._collected[i]
                i += 1
            if not self._pull(None):
                return

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """All generated tokens (prompt excluded), blocking to completion.
        ``timeout=0`` requires the request to already be complete."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._done:
            left = (None if deadline is None
                    else deadline - time.monotonic())
            self._pull(left)
        if self._req.error is not None:
            raise self._req.error
        return list(self._collected)

    def time_to_first_token(self) -> Optional[float]:
        if self._req.first_token_at is None:
            return None
        return self._req.first_token_at - self._req.submitted_at


@dataclass
class EngineStats:
    slots: int
    active: int
    queued: int
    admitted_total: int
    finished_total: int
    tokens_generated: int
    decode_steps: int
    tokens_per_sec: float
    # rolling mean time-to-first-token over the last admissions (secs)
    ttft_avg: float = 0.0


def _with_index(bank: torch.Tensor, idx: int, value) -> torch.Tensor:
    """A new bank tensor (L, N, ...) equal to ``bank`` with index ``idx``
    of its second axis set to ``value``."""
    out = bank.clone()
    out[:, idx] = value
    return out


def _request_key(req: _Request) -> int:
    """A 62-bit digest of what a request asks for: ranks holding different
    requests under one sequence number part here."""
    import hashlib

    what = (req.prompt, req.max_new_tokens, req.temperature, req.top_p,
            req.frequency_penalty, req.presence_penalty,
            sorted((req.logit_bias or {}).items()), req.seed, req.stop,
            req.prefix_id, req.adapter_id)
    digest = hashlib.blake2b(repr(what).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 2


class _StepAgreement:
    """The ranks of a mesh engine agree, before each step, on what it does:
    the JAX engine is one controller with one queue, the port one engine
    per rank, and ranks that took different steps would run different
    collectives. The rule: every rank submits the same requests in the
    same order (the fabric's SPMD call does). Each step the ranks
    all-reduce, over a gloo group of their own (host decisions never wait
    on the card):

    - MIN of each rank's submitted count, queued boundary hooks and
      ``-stop``: admission takes only requests every rank has (their
      sequence numbers below the minimum), each rank runs that many hooks,
      and one rank's ``stop`` ends every loop;
    - MAX of the cancel requests of every request in flight, in one order
      (slots, the chunked admission, then the queue), and of each newly
      agreed request's digest and its negation: a request is cancelled
      once any rank asks, and a rank whose request under a sequence number
      differs (prompt, budget, sampling, seed...) raises on every rank.

    A world of 1 needs none of it (the engine holds no agreement)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
        self.group = dist.new_group(ranks=ranks, backend="gloo")
        self.limit = 0        # sequence numbers below it may admit
        self.hooks = 0
        self.stopped = False

    def _reduce(self, values, op) -> List[int]:
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.int64)
        if t.numel():
            dist.all_reduce(t, op=op, group=self.group)
        return t.tolist()

    def agree(self, engine: "GenerationEngine") -> None:
        import torch.distributed as dist

        with engine._lock:
            submitted = engine._submitted
            hooks = len(engine._boundary_hooks)
        limit, self.hooks, stop = self._reduce(
            [submitted, hooks, -int(engine._stop.is_set())],
            dist.ReduceOp.MIN)
        self.stopped = stop < 0
        ck = engine._chunking
        with engine._lock:
            queued = [r for r in engine._pending if r.rid < limit]
        flight = (list(engine._slot_req) + [ck.req if ck is not None else None]
                  + queued)
        new = [r for r in queued if r.rid >= self.limit]
        keys = [_request_key(r) for r in new]
        got = self._reduce([int(r is not None and (r.cancel_asked or r.cancelled))
                            for r in flight] + keys + [-k for k in keys],
                           dist.ReduceOp.MAX)
        n = len(flight)
        for req, key, hi, neg in zip(new, keys, got[n:n + len(keys)],
                                     got[n + len(keys):]):
            if hi != -neg:
                raise RuntimeError(
                    f"mesh engine ranks hold different requests under "
                    f"sequence number {req.rid}: every rank must submit the "
                    "same requests in the same order")
        self.limit = limit
        for req, flag in zip(flight, got[:n]):
            if flag and req is not None and not req.cancelled:
                req.cancelled = True
                with engine._lock:
                    if req in engine._pending:
                        engine._pending.remove(req)
                        req.out.put(None)


class GenerationEngine:
    """Continuous-batching decode over a fixed slot grid (module docstring
    has the design). Drive it with :meth:`step` (deterministic) or start
    the background loop with :meth:`start`.

    ``params`` is the stacked param dict of a Llama (``models.llama``) or
    an MoE (``models.moe``) config, plain or quantized (``models.quant``),
    on ``device`` — ``cuda`` unless the caller names another. ``eos_id`` retires a slot early; ``max_len``
    caps prompt + completion; ``quantize_kv=True`` keeps the KV grid in
    int8 (``serve.kv_quant``); ``auto_prefix=True`` reuses registered
    prefixes without an id; ``prefill_chunk=C`` admits prompts longer than
    C one chunk per step.

    On a device mesh (``mesh=``, or the ambient mesh of
    ``parallel.mesh_context.use_mesh`` at construction) the params are
    DTensors (``parallel.sharding.shard_pytree(params, LLAMA_RULES,
    mesh)``) and the grid is split across ranks as the JAX engine splits
    it (``_cache_shardings``): slots over the batch axes, the sequence over
    ``context``, KV heads over ``tensor``. Every rank runs its own engine
    and submits the same requests in the same order; the ranks agree on
    each step (``_StepAgreement``). The mesh is installed around every
    step, admission, chunk and boundary hook, on whichever thread runs
    them. MoE trees (``MOE_RULES``), quantized trees and LoRA adapter
    banks serve on a mesh.
    """

    def __init__(self, params: Dict[str, Any], cfg, *, slots: int = 8,
                 max_len: int = 1024, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 prefill_buckets: Sequence[int] = (128, 256, 512, 1024),
                 quantize_kv: bool = False, seed: int = 0,
                 decode_block: int = 1, auto_prefix: bool = False,
                 prefill_chunk: Optional[int] = None, aot_cache=None,
                 mesh=None, device=None):
        # the ambient mesh is thread-local: captured here and installed
        # again around every pass, on whichever thread runs it
        from ..parallel.mesh_context import current_mesh
        self._mesh = mesh if mesh is not None else current_mesh()
        if self._mesh is not None:
            self._check_mesh_params(params, self._mesh)
        device = resolve_device(device)
        param_device = params["embed"].device
        if param_device.type != device.type:
            raise ValueError(f"params are on {param_device}, engine device "
                             f"is {device}")
        self.device = param_device
        self.params = params
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = top_k
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.top_p = None if top_p is None else float(top_p)
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        self.decode_block = int(decode_block)
        # chunked prefill: a prompt longer than this admits one chunk per
        # engine step (module docstring); None = one-shot admission
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        self._chunking: Optional[_Chunking] = None
        self._buckets = sorted({min(b, self.max_len)
                                for b in prefill_buckets} | {self.max_len})
        # the int8 grid (serve.kv_quant): rows quantize at the splice and
        # at each decode step's write
        self.quantize_kv = bool(quantize_kv)
        self._grid: Optional[_MeshGrid] = None
        self._agree: Optional[_StepAgreement] = None
        if self._mesh is not None:
            self._grid = _MeshGrid(self._mesh, cfg, self.slots, self.max_len)
            self._cache = self._grid.zeros(cfg, quantize_kv)
            if self._mesh.size() > 1:
                self._agree = _StepAgreement(self._mesh)
        else:
            make_cache = init_quant_cache if quantize_kv else init_cache
            self._cache = make_cache(cfg, self.slots, self.max_len,
                                     device=self.device)
        # RoPE rows for the widest buffer a pass runs over: decode reads
        # rows < max_len, a suffix pass ends at max_len, a chunk's padding
        # rows at max_len + prefill_chunk (the table's rows do not depend
        # on its length)
        self._freqs = rope_freqs(cfg, self.max_len + (self.prefill_chunk or 0),
                                 device=self.device)
        self._pos = np.zeros(self.slots, np.int32)     # next write position
        self._tok = np.zeros(self.slots, np.int64)     # next decode input
        self._temps = np.zeros(self.slots, np.float32)
        self._top_ps = np.ones(self.slots, np.float32)
        self._fpen = np.zeros(self.slots, np.float32)
        self._ppen = np.zeros(self.slots, np.float32)
        # (SLOTS, V) int32 seen-token counts and (SLOTS, V) fp32 bias rows,
        # each allocated on the first request that asks for it and kept:
        # engines that never see a penalty or a bias pay for neither
        self._counts: Optional[torch.Tensor] = None
        self._bias: Optional[torch.Tensor] = None
        self._bmask = np.zeros(self.slots, np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * self.slots
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._pending: "deque[_Request]" = deque()
        self._admitting: Optional[_Request] = None   # cancel() window
        self._prefixes: Dict[int, _Prefix] = {}
        self._prefix_ids = itertools.count()
        # auto_prefix: submit() reuses the longest registered prefix the
        # prompt starts with, no prefix_id needed
        self.auto_prefix = bool(auto_prefix)
        self._prefix_hits = 0
        # multi-LoRA: stacked adapter banks, target → (A (L, N, D, R),
        # B (L, N, R, O)); bank index 0 is the all-zero adapter (= base
        # model), which idle and base-traffic slots point at
        self._lora_cfg = None
        self._banks: Optional[Dict[str, tuple]] = None
        self._adapter_slots: Dict[int, int] = {}   # public id → bank index
        self._free_bank: List[int] = []
        self._adapter_ids = itertools.count(1)
        self._aidx = np.zeros(self.slots, np.int64)
        # seeds for requests that bring none (drawn under _lock)
        self._seed_rng = np.random.default_rng(seed)
        self._rid = itertools.count()
        self._submitted = 0        # sequence numbers handed out
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # exactly one loop thread may ever exist: two would interleave
        # decode steps on the same cache
        self._lifecycle = threading.Lock()
        # callables queued for the next batch boundary (the live weight
        # swap: serve/rollout.py; see at_batch_boundary)
        self._boundary_hooks: "deque[tuple]" = deque()
        # continuous-learning tap: when set, every retired request's
        # summary passes through it once, on the stepping thread. The sink
        # must swallow its own errors; the retire path guards all the same,
        # since a raising sink would wedge the loop for every live slot
        self.feedback_sink = None
        self._admitted = self._finished = 0
        self._tokens = self._steps = 0
        self._ttfts = deque(maxlen=256)
        self._t0 = time.monotonic()
        # the compile cache: every library the passes launch resolved
        # (built on a miss) and the passes warmed, the table naming them.
        # A mesh engine keeps the lazy builds, as JAX keeps its traced jits
        self._aot_cache = aot_cache
        self._aot_exec: Dict[tuple, tuple] = {}
        if aot_cache is not None and self._mesh is None:
            from .aot_cache import warm_engine
            self._aot_exec = warm_engine(self, aot_cache)

    @staticmethod
    def _check_mesh_params(params, mesh) -> None:
        from torch.distributed.tensor import DTensor

        from ..parallel.sharding import tree_paths
        from ..train.optim import tree_map

        plain = []
        tree_map(lambda x, p: None if isinstance(x, DTensor)
                 and x.device_mesh == mesh else plain.append(p),
                 params, tree_paths(params))
        if plain:
            raise ValueError(
                f"on a mesh every param is a DTensor on that mesh "
                f"(parallel.sharding.shard_pytree(params, LLAMA_RULES or "
                f"MOE_RULES, mesh)); not {plain[:4]}")

    def _mesh_scope(self):
        """``use_mesh(self._mesh)`` on the current thread, and no grad."""
        import contextlib

        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self._mesh is not None:
            from ..parallel.mesh_context import use_mesh
            stack.enter_context(use_mesh(self._mesh))
        return stack

    # -- adapters -----------------------------------------------------------

    def register_adapter(self, adapters: Dict[str, Any], lora_cfg) -> int:
        """Install a LoRA adapter (``models.lora.lora_init`` layout: a
        ``layers`` dict of per-target stacked ``{t}__a`` (L, D, R) and
        ``{t}__b`` (L, R, O) factors) for unmerged activation-path serving:
        requests submitted with the returned id run ``x·W + s·(x·A)·B``
        through the decode step every other adapter and the base model
        share. All adapters on one engine share the first registration's
        rank, targets and scale; a freed bank index is reused."""
        layers = adapters.get("layers", adapters)
        served = {"wq", "wk", "wv", "wo"}
        extra = set(lora_cfg.targets) - served
        if extra:
            # merge_lora adapts any layer leaf, but the serving path applies
            # lora_proj only at the attention projections
            raise ValueError(
                f"activation-path serving supports targets {sorted(served)}; "
                f"got {sorted(extra)} — serve those via merge_lora instead")
        pairs = {}
        for t in lora_cfg.targets:
            try:
                pairs[t] = (torch.as_tensor(layers[f"{t}__a"], device=self.device),
                            torch.as_tensor(layers[f"{t}__b"], device=self.device))
            except KeyError:
                raise KeyError(
                    f"adapter missing factors for target {t!r} "
                    f"(have {sorted(layers)})") from None
        if self._mesh is not None:
            # every rank's next step reads the bank: install it at a step
            # the ranks agree on
            pairs = {t: tuple(_plain(x) for x in ab) for t, ab in pairs.items()}
            return self.at_batch_boundary(
                lambda: self._install_adapter(pairs, lora_cfg))
        return self._install_adapter(pairs, lora_cfg)

    def _install_adapter(self, pairs: Dict[str, tuple], lora_cfg) -> int:
        with self._lock:
            # the config check under the lock: two racing first
            # registrations must not both pass the None check
            if self._lora_cfg is not None and (
                    lora_cfg.rank != self._lora_cfg.rank
                    or tuple(lora_cfg.targets) != tuple(self._lora_cfg.targets)
                    or lora_cfg.scale != self._lora_cfg.scale):
                raise ValueError(
                    f"adapter config {lora_cfg} does not match the engine's "
                    f"existing bank config {self._lora_cfg} (one bank per "
                    "engine: rank/targets/scale must agree)")
            self._lora_cfg = self._lora_cfg or lora_cfg
            # new bank tensors every time: a step that took the old ones
            # under the lock keeps reading them unchanged
            if self._banks is None:
                self._banks = {
                    t: (torch.stack([torch.zeros_like(a), a], dim=1),
                        torch.stack([torch.zeros_like(b), b], dim=1))
                    for t, (a, b) in pairs.items()}
                idx = 1
            elif self._free_bank:
                idx = self._free_bank.pop()
                self._banks = {
                    t: (_with_index(A, idx, pairs[t][0]),
                        _with_index(B, idx, pairs[t][1]))
                    for t, (A, B) in self._banks.items()}
            else:
                idx = next(iter(self._banks.values()))[0].shape[1]
                self._banks = {
                    t: (torch.cat([A, pairs[t][0][:, None].to(A.dtype)], dim=1),
                        torch.cat([B, pairs[t][1][:, None].to(B.dtype)], dim=1))
                    for t, (A, B) in self._banks.items()}
            aid = next(self._adapter_ids)
            self._adapter_slots[aid] = idx
        return aid

    def unregister_adapter(self, adapter_id: int) -> bool:
        """Free an adapter's bank index (reused by the next registration).
        Its factors are zeroed and any request still decoding on it is
        repointed at index 0, so it falls back to the base model
        mid-stream, never onto the next tenant of the index. Queued
        requests against the id fail at admission through their handle.
        On a mesh it runs at a step the ranks agree on, as
        :meth:`register_adapter` does."""
        if self._mesh is not None:
            return self.at_batch_boundary(
                lambda: self._uninstall_adapter(adapter_id))
        return self._uninstall_adapter(adapter_id)

    def _uninstall_adapter(self, adapter_id: int) -> bool:
        with self._lock:
            idx = self._adapter_slots.pop(adapter_id, None)
            if idx is None:
                return False
            self._banks = {t: (_with_index(A, idx, 0.0),
                               _with_index(B, idx, 0.0))
                           for t, (A, B) in self._banks.items()}
            self._aidx[self._aidx == idx] = 0
            self._free_bank.append(idx)
        return True

    def _resolve_adapter(self, adapter_id: Optional[int]):
        """(the prefill's adapter arguments, bank index) for a request or
        a prefix: ``{}`` and 0 for the base model. Under the lock, so a
        concurrent unregister cannot hand back a half-freed index."""
        if adapter_id is None:
            return {}, 0
        with self._lock:
            if adapter_id not in self._adapter_slots:
                raise KeyError(f"unknown adapter_id {adapter_id}")
            idx = self._adapter_slots[adapter_id]
            banks = self._banks
        adapter = {t: (A[:, idx], B[:, idx]) for t, (A, B) in banks.items()}
        return dict(adapter=adapter, lora_scale=self._lora_cfg.scale), idx

    # -- submission ---------------------------------------------------------

    def _check_vocab(self, tokens: List[int]) -> None:
        # an out-of-range id would be a device-side assert in the embedding
        bad = [t for t in tokens if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids out of vocab range "
                             f"[0, {self.cfg.vocab_size}): {bad[:8]}")

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               prefix_id: Optional[int] = None,
               adapter_id: Optional[int] = None,
               top_p: Optional[float] = None,
               frequency_penalty: float = 0.0,
               presence_penalty: float = 0.0,
               stop: Optional[Sequence] = None,
               logit_bias: Optional[Dict[int, float]] = None,
               seed: Optional[int] = None) -> RequestHandle:
        """Queue one request. ``temperature``/``top_p`` override the engine
        defaults for this request (0 = greedy). ``prefix_id`` (from
        :meth:`register_prefix`) reuses a cached prefix's K/V: only
        ``prompt`` is prefilled, and generation continues as if prefix and
        prompt had been submitted together; with ``auto_prefix=True`` and no
        ``prefix_id``, pass the full prompt and the longest registered
        prefix it starts with is reused. ``frequency_penalty`` and
        ``presence_penalty`` subtract ``f·count + p·(count > 0)`` of every
        token seen (prompt and prefix included) before each sample;
        ``logit_bias`` adds a bias per token id. Reported logprobs stay the
        raw model's. ``stop`` is one token-id sequence or a list of them:
        the request retires once its generated tokens end with one (the
        matching tokens are emitted). ``seed`` fixes the request's sampling
        stream. ``adapter_id`` (from :meth:`register_adapter`) runs this
        request's prefill and every decode step through its LoRA adapter;
        ``auto_prefix`` then matches only prefixes computed through the
        same adapter."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "always samples the first token)")
        self._check_vocab(prompt)
        full_prompt = None
        if prefix_id is None and self.auto_prefix:
            prefix_id, stripped = self._match_prefix(prompt, adapter_id,
                                                     int(max_new_tokens))
            if prefix_id is not None:
                full_prompt, prompt = prompt, stripped
        prefix_bucket = 0
        if prefix_id is not None:
            # fetch once: an unregister racing this check must not blow up
            # a later read
            pref = self._prefixes.get(prefix_id)
            if pref is None:
                if full_prompt is not None:
                    # matched here (auto_prefix) and evicted since: the
                    # caller never asked for it, so serve the full prompt
                    prompt, full_prompt, prefix_id = full_prompt, None, None
                else:
                    raise KeyError(f"unknown prefix_id {prefix_id}")
            else:
                # the spliced rows span the prefix's bucket, so that is
                # what must fit under max_len
                prefix_bucket = pref.k.shape[2]
        if prefix_bucket + len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix bucket ({prefix_bucket}) + prompt ({len(prompt)}) "
                f"+ max_new_tokens ({max_new_tokens}) exceeds the engine's "
                f"max_len ({self.max_len})")
        if adapter_id is not None and adapter_id not in self._adapter_slots:
            raise KeyError(f"unknown adapter_id {adapter_id}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if logit_bias:
            logit_bias = {int(t): float(b) for t, b in logit_bias.items()}
            bad = [t for t in logit_bias
                   if not 0 <= t < self.cfg.vocab_size]
            if bad:
                raise ValueError(f"logit_bias token ids out of vocab "
                                 f"range [0, {self.cfg.vocab_size}): {bad}")
            nonfin = [t for t, b in logit_bias.items()
                      if not math.isfinite(b)]
            if nonfin:
                # a single NaN/inf bias poisons the whole logits row
                raise ValueError(
                    f"logit_bias values must be finite; got "
                    f"{ {t: logit_bias[t] for t in nonfin} }")
        req = _Request(-1, prompt, int(max_new_tokens),
                       temperature=temperature, top_p=top_p,
                       frequency_penalty=float(frequency_penalty),
                       presence_penalty=float(presence_penalty),
                       logit_bias=logit_bias or None,
                       stop=_normalize_stop(stop), prefix_id=prefix_id,
                       adapter_id=adapter_id, full_prompt=full_prompt,
                       seed=None if seed is None else int(seed))
        with self._lock:
            # sequence numbers in queue order: the ranks of a mesh engine
            # agree on them
            req.rid = next(self._rid)
            self._submitted += 1
            self._pending.append(req)
        self._work.set()
        return RequestHandle(req, engine=self)

    # -- prefix cache -------------------------------------------------------

    def register_prefix(self, tokens: Sequence[int],
                        adapter_id: Optional[int] = None) -> int:
        """Prefill a shared prefix (system prompt, few-shot header) once and
        cache its K/V; later :meth:`submit` calls with the returned id skip
        recomputing it. Exact for dense models; for MoE, expert capacity is
        per segment (``_prefill_suffix_logits``). ``adapter_id`` computes
        the prefix through that adapter: pair it with requests on the same
        adapter."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("empty prefix")
        if len(tokens) >= self.max_len:
            raise ValueError(f"prefix ({len(tokens)}) must leave room under "
                             f"max_len ({self.max_len})")
        self._check_vocab(tokens)
        if self._mesh is not None:
            # a pass of collectives: on the stepping thread, at a step the
            # ranks agree on
            return self.at_batch_boundary(
                lambda: self._register_prefix(tokens, adapter_id))
        return self._register_prefix(tokens, adapter_id)

    def _register_prefix(self, tokens: List[int],
                         adapter_id: Optional[int]) -> int:
        lkw, _ = self._resolve_adapter(adapter_id)
        t = len(tokens)
        bucket = next(b for b in self._buckets if b >= t)
        with self._mesh_scope():
            _, k, v = _prefill_logits(self.params, self._padded(tokens, bucket),
                                      t, self.cfg, self._freqs, grid=self._grid,
                                      **lkw)
        # keep the bucketed rows (the suffix pass takes the true length as
        # an argument); where the bucket leaves no room for a one-token
        # suffix and one generated token under max_len, trim to the exact
        # length instead
        store = next((b for b in self._buckets
                      if b >= t and b + 2 <= self.max_len), t)
        if store != bucket:
            k, v = k[:, :, :store].contiguous(), v[:, :, :store].contiguous()
        pid = next(self._prefix_ids)
        self._prefixes[pid] = _Prefix(k, v, t, tuple(tokens), adapter_id)
        return pid

    def _match_prefix(self, prompt: List[int], adapter_id: Optional[int],
                      max_new_tokens: int):
        """Longest registered prefix this prompt starts with (auto_prefix):
        (prefix_id, suffix) or (None, prompt). A candidate must have been
        computed through the same adapter (its rows are that adapter's),
        leave a non-empty suffix and fit its bucket, the suffix and the
        budget under max_len."""
        with self._lock:
            items = list(self._prefixes.items())
        best = None
        for pid, pref in items:
            n = len(pref.tokens)
            if (pref.adapter_id == adapter_id and n < len(prompt)
                    and (best is None or n > best[1])
                    and pref.k.shape[2] + (len(prompt) - n)
                    + max_new_tokens <= self.max_len
                    and list(pref.tokens) == prompt[:n]):
                best = (pid, n)
        if best is None:
            return None, prompt
        return best[0], prompt[best[1]:]

    def unregister_prefix(self, prefix_id: int) -> bool:
        """Free a cached prefix's K/V. The caller owns prefix lifetime; each
        live prefix pins 2·L·P·NKV·Hd values on the device. Requests
        already queued against the id fail with a KeyError through their
        handle."""
        return self._prefixes.pop(prefix_id, None) is not None

    def cancel(self, request_id: int) -> bool:
        """Abandon a request: a queued one never admits, an active one
        frees its slot at the next step boundary, one caught mid-admission
        (or mid-chunking) is reaped right after. False if the id is
        unknown, finished or already cancelled."""
        with self._lock:
            for i, req in enumerate(self._pending):
                if req.rid == request_id:
                    if self._agree is not None:
                        # leaves the queue once the ranks agree
                        if req.cancel_asked:
                            return False
                        req.cancel_asked = True
                        return True
                    del self._pending[i]
                    req.out.put(None)
                    return True
        # read each once: the stepping thread may clear them meanwhile
        adm, ck = self._admitting, self._chunking
        in_flight = [r for r in self._slot_req if r is not None]
        in_flight += [adm, ck.req if ck is not None else None]
        for req in in_flight:
            if req is not None and req.rid == request_id:
                if req.cancelled or req.cancel_asked:
                    return False
                if self._agree is not None:
                    req.cancel_asked = True
                else:
                    req.cancelled = True
                self._work.set()
                return True
        return False

    def _retire_slot(self, slot: int) -> None:
        """The one slot-retirement path (finish, eos, stop, cancel): end the
        handle's stream, free the slot, clear its state. The slot's rows of
        the counts and bias grids stay: a zero penalty and a zero mask
        neutralize them."""
        req = self._slot_req[slot]
        if req is None:
            return
        if self.feedback_sink is not None:
            # built before any state clears: after this method the slot's
            # state is gone
            try:
                self.feedback_sink({
                    "request_id": req.rid,
                    "prompt": list(req.full_prompt or req.prompt),
                    "generated": int(req.generated),
                    "cancelled": bool(req.cancelled),
                    "ttft_s": (req.first_token_at - req.submitted_at
                               if req.first_token_at is not None else None),
                    "latency_s": time.monotonic() - req.submitted_at,
                })
            except Exception:  # noqa: BLE001 — never wedge the step thread
                pass
        req.out.put(None)
        self._slot_req[slot] = None
        self._gens[slot] = None
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._temps[slot] = 0.0
        self._top_ps[slot] = 1.0
        self._fpen[slot] = 0.0
        self._ppen[slot] = 0.0
        self._bmask[slot] = 0.0
        self._aidx[slot] = 0
        self._finished += 1
        self._free_slot_ledgers(slot)

    def _free_slot_ledgers(self, slot: int) -> None:
        """Subclass hook: extra per-slot state to clear on retirement
        (``serve.spec_engine`` clears its position ledgers here)."""

    def _reap_cancelled(self) -> None:
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.cancelled:
                self._retire_slot(slot)

    # -- admission ----------------------------------------------------------

    def _free_slots(self) -> List[int]:
        busy = self._chunking.slot if self._chunking is not None else None
        return [i for i, r in enumerate(self._slot_req)
                if r is None and i != busy]

    def _padded(self, tokens: List[int], width: int) -> torch.Tensor:
        """(1, width) right-padded token ids on the engine's device."""
        padded = torch.zeros((1, width), dtype=torch.long)
        padded[0, :len(tokens)] = torch.tensor(tokens)
        return padded.to(self.device)

    def _admit(self) -> None:
        if self._chunking is not None:
            # one chunk of the long admission in flight per engine step
            self._chunk_step()
        free = self._free_slots()
        while free:
            with self._lock:
                if not self._pending or (
                        self._agree is not None
                        and self._pending[0].rid >= self._agree.limit):
                    return
                req = self._pending.popleft()
            long = (self.prefill_chunk is not None
                    and len(req.prompt) > self.prefill_chunk)
            if long and self._chunking is not None:
                # a second long prompt while the chunker is busy waits for
                # it, first in line (never a one-shot prefill at a wide
                # bucket: the stall chunking exists to avoid)
                with self._lock:
                    self._pending.appendleft(req)
                return
            slot = free.pop(0)
            self._admitting = req
            try:
                if long:
                    # reserve the slot; one chunk per step from here on
                    self._start_chunking(req, slot)
                else:
                    self._admit_one(req, slot)
            except Exception as e:   # noqa: BLE001 — fail THAT request only
                req.error = e
                req.out.put(None)
                free.insert(0, slot)
            finally:
                self._admitting = None

    def _resolve_prefix(self, req: _Request) -> Optional[_Prefix]:
        """The request's prefix, fetched once. An evicted auto-matched
        prefix falls back to the full prompt; an evicted explicit one is
        the caller's error."""
        if req.prefix_id is None:
            return None
        pref = self._prefixes.get(req.prefix_id)
        if pref is None:
            if req.full_prompt is None:
                raise KeyError(f"unknown prefix_id {req.prefix_id}")
            req.prompt, req.full_prompt = req.full_prompt, None
            req.prefix_id = None
        return pref

    def _request_generator(self, req: _Request) -> torch.Generator:
        if req.seed is not None:
            seed = req.seed
        else:
            with self._lock:
                seed = int(self._seed_rng.integers(2 ** 63))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _sampling_setup(self, req: _Request,
                        prefix_tokens: Optional[tuple]) -> _Sampling:
        """Sampling state for the pass that samples the request's first
        token. Allocates the counts grid on the first penalized request."""
        temp = (self.temperature if req.temperature is None
                else float(req.temperature))
        tp = self.top_p if req.top_p is None else float(req.top_p)
        tp = 1.0 if tp is None else tp
        fp, pp = req.frequency_penalty, req.presence_penalty
        vocab = self.cfg.vocab_size
        pen_row = counts_row = bias_row = None
        if fp or pp:
            if self._counts is None:
                self._counts = torch.zeros((self.slots, vocab),
                                           dtype=torch.int32,
                                           device=self.device)
            # the prompt (and prefix) is the text so far: it counts, and
            # its penalties apply to the first sampled token too
            seen = list(req.prompt) + list(prefix_tokens or ())
            counts_row = np.zeros(vocab, np.int32)
            np.add.at(counts_row, np.asarray(seen, np.int64), 1)
            pen_row = (fp * counts_row.astype(np.float32)
                       + pp * (counts_row > 0).astype(np.float32))
        if req.logit_bias:
            bias_row = np.zeros(vocab, np.float32)
            for tid, b in req.logit_bias.items():
                bias_row[tid] = b
            # pen_row is subtracted from the first token's logits, so the
            # bias folds in negated
            pen_row = (0.0 if pen_row is None else pen_row) - bias_row
        if pen_row is not None:
            pen_row = torch.from_numpy(pen_row).to(self.device)
        gen = self._request_generator(req) if temp > 0 else None
        return _Sampling(temp, tp, self.top_k, gen, pen_row, counts_row,
                         bias_row)

    def _admit_one(self, req: _Request, slot: int) -> None:
        pref = self._resolve_prefix(req)
        t = len(req.prompt)
        samp = self._sampling_setup(req, pref.tokens if pref else None)
        lkw, aidx = self._resolve_adapter(req.adapter_id)
        if pref is not None:
            p_bucket = pref.k.shape[2]
            # no bucket leaves room behind the prefix: pad the suffix to
            # exactly what fits
            bucket = next((b for b in self._buckets
                           if b >= t and p_bucket + b <= self.max_len),
                          self.max_len - p_bucket)
            start = pref.length + t
            first, k_new, v_new, flp = _prefill_suffix(
                self.params, self._padded(req.prompt, bucket), t, pref.k,
                pref.v, pref.length, self.cfg, self._freqs, samp,
                grid=self._grid, **lkw)
            self._prefix_hits += 1
        else:
            bucket = next(b for b in self._buckets if b >= t)
            start = t
            first, k_new, v_new, flp = _prefill(
                self.params, self._padded(req.prompt, bucket), t, self.cfg,
                self._freqs, samp, grid=self._grid, **lkw)
        self._finish_admission(req, slot, first, flp, k_new, v_new, start,
                               samp, aidx)

    def _start_chunking(self, req: _Request, slot: int) -> None:
        """First chunk of a long admission: seed the accumulator, max_len
        rows wide (the final splice is exactly the grid's width), with the
        request's cached prefix when it has one, else with a from-zero
        prefill of the first chunk. It costs one slot's worth of K/V while
        the admission is in flight."""
        pref = self._resolve_prefix(req)
        lkw, aidx = self._resolve_adapter(req.adapter_id)
        c = self.prefill_chunk
        if pref is not None:
            k, v = pref.k, pref.v
            consumed, frontier = 0, pref.length
            self._prefix_hits += 1
        else:
            # samples nothing, so it draws nothing from any generator
            _, k, v = _prefill_logits(self.params,
                                      self._padded(req.prompt[:c], c), c,
                                      self.cfg, self._freqs, grid=self._grid,
                                      **lkw)
            consumed = frontier = c
        widen = self.max_len - k.shape[2]
        self._chunking = _Chunking(req, slot, _zero_rows(k, widen),
                                   _zero_rows(v, widen), consumed, frontier,
                                   pref.tokens if pref else None, lkw, aidx)

    def _chunk_step(self) -> None:
        """Advance the chunked admission by one chunk; the last chunk
        samples the first token and seats the request. Each pass runs over
        the accumulator plus C zero rows (max_len + C: a short last chunk's
        padding rows may pass max_len) and the rows past max_len are
        sliced off again."""
        ck = self._chunking
        req = ck.req
        if req.cancelled:
            self._chunking = None
            req.out.put(None)
            return
        c = self.prefill_chunk
        take = min(c, len(req.prompt) - ck.consumed)
        padded = self._padded(req.prompt[ck.consumed:ck.consumed + take], c)
        try:
            if ck.consumed + take < len(req.prompt):
                _, k, v = _prefill_suffix_logits(
                    self.params, padded, take, ck.k, ck.v, ck.frontier,
                    self.cfg, self._freqs, grid=self._grid, **ck.lkw)
                ck.k, ck.v = k[:, :, :self.max_len], v[:, :, :self.max_len]
                ck.consumed += take
                ck.frontier += take
                return
            samp = self._sampling_setup(req, ck.prefix_tokens)
            first, k, v, flp = _prefill_suffix(
                self.params, padded, take, ck.k, ck.v, ck.frontier, self.cfg,
                self._freqs, samp, grid=self._grid, **ck.lkw)
            self._chunking = None
            self._finish_admission(req, ck.slot, first, flp,
                                   k[:, :, :self.max_len],
                                   v[:, :, :self.max_len],
                                   ck.frontier + take, samp, ck.aidx)
        except Exception as e:   # noqa: BLE001 — fail THIS request only
            self._chunking = None
            req.error = e
            req.out.put(None)

    def _finish_admission(self, req: _Request, slot: int, first, flp, k_new,
                          v_new, start: int, samp: _Sampling,
                          aidx: int = 0) -> None:
        """Splice the K/V rows, seat the request, seed its rows of the
        counts and bias grids, point its slot at its adapter's bank index,
        emit its first token."""
        _splice_slot(self._cache, slot, k_new, v_new, self._grid)
        first_tok = int(first[0])
        self._slot_req[slot] = req
        self._gens[slot] = samp.gen
        self._pos[slot] = start
        self._tok[slot] = first_tok
        self._temps[slot] = samp.temp
        self._top_ps[slot] = samp.top_p
        self._fpen[slot] = req.frequency_penalty
        self._ppen[slot] = req.presence_penalty
        if samp.counts_row is not None:
            samp.counts_row[first_tok] += 1
            self._counts[slot] = torch.from_numpy(samp.counts_row).to(
                self.device)
        if samp.bias_row is not None:
            if self._bias is None:
                self._bias = torch.zeros((self.slots, self.cfg.vocab_size),
                                         dtype=torch.float32,
                                         device=self.device)
            self._bias[slot] = torch.from_numpy(samp.bias_row).to(self.device)
            self._bmask[slot] = 1.0
        with self._lock:
            # the prefill ran outside the lock: if the adapter was evicted
            # meanwhile (its index perhaps reused by a new tenant), the slot
            # falls back to the base model
            if (req.adapter_id is not None
                    and self._adapter_slots.get(req.adapter_id) != aidx):
                aidx = 0
            self._aidx[slot] = aidx
        self._admitted += 1
        self._emit(slot, first_tok, float(flp[0]))
        if req.first_token_at is not None:
            self._ttfts.append(req.first_token_at - req.submitted_at)

    def _emit(self, slot: int, tok: int,
              logprob: Optional[float] = None) -> None:
        req = self._slot_req[slot]
        if req is None:
            return
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        req.logprobs.append(logprob)
        req.out.put(tok)
        req.generated += 1
        self._tokens += 1
        done = (req.generated >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id))
        if req.stop and not done:
            req.tail.append(tok)
            maxlen = max(len(q) for q in req.stop)
            del req.tail[:-maxlen]
            done = any(len(q) <= len(req.tail)
                       and req.tail[len(req.tail) - len(q):] == list(q)
                       for q in req.stop)
        if done:
            self._retire_slot(slot)

    # -- batch-boundary scheduling ------------------------------------------

    def at_batch_boundary(self, fn, timeout: Optional[float] = None):
        """Run ``fn()`` between decode batches, on the stepping thread, and
        return its result. The safe point for anything that changes
        engine-wide device state, above all the live weight swap
        (``serve/rollout.py``): no decode step is in flight while the hook
        runs. Blocks the caller, never the loop, until the hook has run;
        with no loop thread, or called from the loop thread, runs inline.
        The hook's exception reaches the caller, never the loop."""
        with self._lifecycle:
            thread = self._thread
        running = thread is not None and thread.is_alive()
        if not running or threading.current_thread() is thread:
            with self._mesh_scope():
                return fn()
        box: Dict[str, Any] = {"done": threading.Event()}
        self._boundary_hooks.append((fn, box))
        self._work.set()
        if not box["done"].wait(timeout):
            raise TimeoutError(
                "engine did not reach a batch boundary in time")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _run_boundary_hooks(self, count: Optional[int] = None) -> None:
        """Drain queued boundary hooks (stepping thread, between batches):
        all of them, or the first ``count`` (the number the ranks of a mesh
        engine agreed on)."""
        while self._boundary_hooks and count != 0:
            count = None if count is None else count - 1
            fn, box = self._boundary_hooks.popleft()
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — hand to the waiter
                box["error"] = e
            finally:
                box["done"].set()

    # -- engine loop --------------------------------------------------------

    def step(self) -> int:
        """Admit pending requests (or advance the chunked admission by one
        chunk), then decode one block of tokens (``decode_block`` steps)
        for every active slot. Returns the remaining work — active slots,
        queued requests and a chunked admission in flight."""
        with self._mesh_scope():
            return self._step_once()

    def _begin_step(self) -> None:
        """What every step does before its admission: on a mesh of more
        than one rank the step agreement, then the boundary hooks (the
        previous step's decode has been read back, so a weight swap never
        overlaps a step on the old params), then the cancelled slots'
        retirement."""
        if self._agree is not None:
            self._agree.agree(self)
            self._run_boundary_hooks(self._agree.hooks)
        else:
            self._run_boundary_hooks()
        self._reap_cancelled()

    def _step_once(self) -> int:
        self._begin_step()
        self._admit()
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if active:
            k = self.decode_block
            dev = self.device
            # the penalty and bias grids join the step only once a request
            # has asked for them
            steer = {}
            if self._counts is not None:
                steer.update(counts=self._counts,
                             fpen=torch.from_numpy(self._fpen).to(dev),
                             ppen=torch.from_numpy(self._ppen).to(dev))
            if self._bias is not None:
                steer.update(bias=self._bias,
                             bmask=torch.from_numpy(self._bmask).to(dev))
            with self._lock:
                banks, aidx = self._banks, self._aidx.copy()
            # once a bank exists every step gathers each slot's factors,
            # base traffic included (index 0, the zero adapter)
            if banks:
                steer.update(banks=banks, lora_scale=self._lora_cfg.scale,
                             aidx=torch.from_numpy(aidx).to(dev))
            toks_k, lps_k = _decode_block(
                self.params, self._cache,
                torch.from_numpy(self._pos).to(dev),
                torch.from_numpy(self._tok).to(dev), self.cfg,
                self._freqs, k, self._temps.copy(), self.top_k,
                self._top_ps.copy(), list(self._gens), grid=self._grid,
                **steer)
            toks_k, lps_k = toks_k.cpu().numpy(), lps_k.cpu().numpy()
            self._steps += k
            for i in range(k):
                for slot in active:
                    # a slot retired at emit i' < i skips the rest of its
                    # block; each emitted token consumed position _pos[slot]
                    if self._slot_req[slot] is None:
                        continue
                    self._pos[slot] += 1
                    self._tok[slot] = int(toks_k[i, slot])
                    self._emit(slot, int(toks_k[i, slot]),
                               float(lps_k[i, slot]))
        with self._lock:
            queued = len(self._pending)
        return (sum(r is not None for r in self._slot_req) + queued
                + (self._chunking is not None))

    def _run(self) -> None:
        # on a mesh the loop ends where the ranks agree to stop, and an idle
        # rank wakes often: the others wait on it at every step
        idle = 0.5 if self._agree is None else 0.02
        while self._agree is not None or not self._stop.is_set():
            n = self.step()
            if self._agree is not None and self._agree.stopped:
                return
            if n == 0 and not self._pending and not self._boundary_hooks:
                self._work.clear()
                self._work.wait(timeout=idle)

    def start(self) -> "GenerationEngine":
        with self._lifecycle:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="kt-gen-engine")
                self._thread.start()
        return self

    def stop(self) -> None:
        with self._lifecycle:
            self._stop.set()
            self._work.set()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
        with self._lifecycle:
            # only forget a thread that actually exited
            if self._thread is thread and (thread is None
                                           or not thread.is_alive()):
                self._thread = None
        # hooks queued in the stop race would strand their waiters: with
        # the loop gone, this thread is the stepping thread
        with self._mesh_scope():
            self._run_boundary_hooks()

    # -- introspection ------------------------------------------------------

    def aot_stats(self) -> Dict[str, int]:
        """Compile-cache lookup counts for this engine's warm-up
        (``hit``/``miss``/``incompatible``/``corrupt``/``publish``…, the
        local mirror of ``kt_aot_cache_total``, one per library), plus the
        number of signatures in the warm table, as the JAX engine reports
        them. Empty counts when the engine was built without a cache."""
        out = dict(self._aot_cache.counts) if self._aot_cache else {}
        out["executables"] = len(self._aot_exec)
        return out

    def stats(self) -> EngineStats:
        dt = max(time.monotonic() - self._t0, 1e-9)
        return EngineStats(
            slots=self.slots,
            active=sum(r is not None for r in self._slot_req),
            # a request mid-chunked-admission is neither seated nor
            # pending: it counts as queued
            queued=len(self._pending) + (self._chunking is not None),
            admitted_total=self._admitted,
            finished_total=self._finished,
            tokens_generated=self._tokens,
            decode_steps=self._steps,
            tokens_per_sec=self._tokens / dt,
            ttft_avg=(sum(self._ttfts) / len(self._ttfts)
                      if self._ttfts else 0.0))

    def __kt_metrics__(self) -> Dict[str, float]:
        """Pod-scrape hook: the engine's live gauges, under the JAX
        engine's keys (host counters only; cheap enough for every
        scrape). On a card, also its memory (``gpu_hbm_bytes_in_use``,
        ``gpu_hbm_bytes_limit``): the fabric's scrape runs in another
        process, which cannot read this one's card."""
        s = self.stats()
        out = {"engine_slots": float(s.slots),
               "engine_active": float(s.active),
               "engine_slots_free": float(s.slots - s.active),
               "engine_queued": float(s.queued),
               "engine_admitted_total": float(s.admitted_total),
               "engine_finished_total": float(s.finished_total),
               "engine_tokens_generated": float(s.tokens_generated),
               "engine_decode_steps": float(s.decode_steps),
               "engine_tokens_per_sec": float(s.tokens_per_sec),
               "engine_ttft_avg_seconds": float(s.ttft_avg),
               "engine_prefix_hits": float(self._prefix_hits)}
        spec = getattr(self, "spec_stats", None)
        if spec is not None:
            out["engine_spec_rounds"] = float(spec.rounds)
            out["engine_spec_acceptance_rate"] = float(spec.acceptance_rate)
            out["engine_spec_draft_len"] = float(getattr(self, "k", 0))
        out.update(device_gauges(self.device))
        return out

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 64,
                 timeout: Optional[float] = 300.0, *,
                 temperature: Optional[float] = None,
                 prefix_id: Optional[int] = None,
                 adapter_id: Optional[int] = None,
                 top_p: Optional[float] = None,
                 frequency_penalty: float = 0.0,
                 presence_penalty: float = 0.0,
                 stop: Optional[Sequence] = None,
                 logit_bias: Optional[Dict[int, float]] = None,
                 seed: Optional[int] = None) -> List[int]:
        """Blocking submit-and-wait on the background loop."""
        self.start()
        return self.submit(prompt, max_new_tokens, temperature=temperature,
                           prefix_id=prefix_id, adapter_id=adapter_id,
                           top_p=top_p,
                           frequency_penalty=frequency_penalty,
                           presence_penalty=presence_penalty, stop=stop,
                           logit_bias=logit_bias, seed=seed
                           ).result(timeout=timeout)
