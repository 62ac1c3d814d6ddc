"""Speculative continuous batching, the counterpart of
``kubetorch_tpu/serve/spec_engine.py``: the slot-grid engine with a draft.

``speculative_generate`` (``serve.speculative``) speculates one request;
``GenerationEngine`` batches many but decodes one token per slot per step.
This engine does both: every round a draft model proposes ``k`` tokens for
every active slot, and one target forward scores all slots' pending +
proposal windows together, so each pass over the target's weights yields
1..k+1 tokens per slot, across the grid.

A round is three device passes: the draft ingests a (SLOTS, k+1) block of
each slot's pending tokens (``_grid_ingest``), proposes the other k-1
tokens in one decode block (``serve.engine._decode_block``, flash-decode
on the card), and the target verifies a (SLOTS, 2k+1) window
(``_grid_ingest``). Per-slot lengths ride as tensors, so mixed progress (a
slot that accepted everything beside one that accepted nothing, idle
slots at length 0) shares one pass. Rows past a slot's frontier hold stale
values by design: every round writes its rows before attending, and the
per-slot causal mask never admits a row not yet written. The window's
attention is the plain masked einsum over the first ``s_eff`` rows, as in
JAX; on a grid split over a ``context`` mesh axis, the same math per
shard and one online-softmax combine
(``parallel.ring_attention.sp_window_attention``).

Greedy verification is exact per slot: each request's tokens are the
target's greedy decode of its prompt, whatever the draft proposes and
whatever the neighbours do, for dense and MoE targets (windows route
``no_drop`` with the real tokens' mask). The caches are written in place;
``submit`` reserves the widest verify window of headroom under
``max_len``, which is what keeps every window row inside the grid
(PyTorch raises on an out-of-range index where XLA drops the write).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..models.common import embed_lookup, replicate_like, settle
from ..models.generate import NEG_INF, ffn_block, init_cache
from ..models.llama import _rotate, layer_weights, rmsnorm, rope_freqs
from ..models.lora import gather_slot_adapters, lora_proj
from ..models.quant import dequant_layer, lm_head_dot
from ..parallel.ring_attention import sp_window_attention
from .engine import (GenerationEngine, _Chunking, _decode_block, _MeshGrid,
                     _plain, _prefill, _prefill_logits,
                     _prefill_suffix, _prefill_suffix_logits, _Sampling,
                     _splice_slot, _zero_rows)
from .kv_quant import QuantKVCache, quantize_rows
from .speculative import SpecStats, check_vocab


def _rope_grid(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """RoPE with a rotation per (slot, offset): x (B, W, N, Hd), freqs
    (B, W, Hd/2) complex."""
    return _rotate(x, freqs[:, :, None, :])


def _window_attend(q, k, v, layer, bi, posm, mask, s_eff: int, scale: float,
                   dtype):
    """One layer's window writes and attention on plain tensors: q (B, W,
    NH, Hd), k/v (B, W, NKV, Hd) at absolute rows ``posm`` (B, W) of the
    layer's cache (``(ck, cv)`` or ``(kq, ks, vq, vs)``), written in place;
    attention over its first ``s_eff`` rows under ``mask``. Returns (B, W,
    NH, Hd) in ``dtype``."""
    b, w, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, w, nkv, nh // nkv, hd)
    if len(layer) == 4:
        kq, ks, vq, vs = layer
        kq[bi, posm], ks[bi, posm] = quantize_rows(k)
        vq[bi, posm], vs[bi, posm] = quantize_rows(v)
        logits = torch.einsum("bwkgh,bskh->bkgws", qg.float(),
                              kq[:, :s_eff].float()) * scale
        # the K row scales over the S axis: ks (B, S, NKV)
        logits = logits * ks[:, :s_eff].transpose(1, 2)[:, :, None, None, :]
        logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        probs = probs * vs[:, :s_eff].transpose(1, 2)[:, :, None, None, :]
        return torch.einsum("bkgws,bskh->bwkgh", probs,
                            vq[:, :s_eff].float()).reshape(
                                b, w, nh, hd).to(dtype)
    ck, cv = layer
    ck[bi, posm] = k.to(ck.dtype)
    cv[bi, posm] = v.to(cv.dtype)
    logits = torch.einsum("bwkgh,bskh->bkgws", qg,
                          ck[:, :s_eff]).float() * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype)
    return torch.einsum("bkgws,bskh->bwkgh", probs,
                        cv[:, :s_eff]).reshape(b, w, nh, hd)


def _write_held(layer, held, k, v) -> None:
    """A window's K/V rows into a context shard of one layer's cache, in
    place: only the rows the shard holds, ``held`` = (slot, window index,
    local row) index tensors; k/v (B, W, NKV, Hd). An int8 layer
    quantizes each row as the whole-cache write does."""
    bsel, wsel, rsel = held
    k, v = k[bsel, wsel], v[bsel, wsel]
    if len(layer) == 4:
        kq, ks, vq, vs = layer
        kq[bsel, rsel], ks[bsel, rsel] = quantize_rows(k)
        vq[bsel, rsel], vs[bsel, rsel] = quantize_rows(v)
        return
    ck, cv = layer
    ck[bsel, rsel] = k.to(ck.dtype)
    cv[bsel, rsel] = v.to(cv.dtype)


@torch.no_grad()
def _grid_ingest(params, cache, blocks, start, true_len, cfg,
                 s_eff: Optional[int] = None, banks=None, aidx=None,
                 lora_scale: float = 1.0, freqs_full=None, grid=None):
    """Run a (B, W) token window through the model, each slot at its own
    absolute positions ``start[b] + i``, writing its cache rows in place
    and returning fp32 logits for every window position, (B, W, V).

    ``start`` and ``true_len`` are (B,) int64 tensors on the device.
    ``true_len`` marks each slot's real tokens: padding (and idle slots at
    length 0) writes rows past the frontier that a later round overwrites
    before the mask can admit them, and never claims an MoE capacity slot
    (``token_mask`` with ``no_drop`` routing: each real token routes as it
    would alone). ``s_eff`` bounds the attended rows: the mask never admits
    a row past ``max(start) + W``, so the caller passes that frontier
    rounded up to a power of two. ``banks``/``aidx``/``lora_scale``: the
    slots' LoRA adapters, as the decode step gathers them.

    ``cache`` is a ``KVCache`` or an int8 ``QuantKVCache``: the int8 branch
    quantizes the new rows before writing and folds the row scales into
    fp32 einsums (logit columns times ``ks``, probabilities times ``vs``),
    the reference math of the int8 decode step. ``freqs_full``: the RoPE
    table, at least as long as the grid (built here when None). On a mesh
    (``grid``, the cache's ``serve.engine._MeshGrid``) the params are
    DTensors, the writes and the attention run on this rank's slots and
    heads, and the logits come back whole. With the sequence over
    ``context`` each rank writes only the window rows its shard holds (a
    window may cross a shard boundary) and attends its own rows from its
    offset, and one online-softmax combine across the axis gives the
    whole-cache attention (``parallel.ring_attention.
    sp_window_attention``): no rank gathers the grid."""
    quant = isinstance(cache, QuantKVCache)
    b, w = blocks.shape
    dev = blocks.device
    s_max = (cache.kq if quant else cache.k).shape[2]
    if s_eff is None:
        s_eff = s_max
    if freqs_full is None:
        freqs_full = rope_freqs(cfg, s_max, device=dev)
    x = embed_lookup(params["embed"], blocks).to(cfg.dtype)
    posm = start[:, None] + torch.arange(w, device=dev)[None, :]    # (B, W)
    freqs = freqs_full[posm]                                        # (B, W, Hd/2)
    if grid is not None:
        x = grid.pin(x)
        freqs = replicate_like(freqs, x)
        local = type(cache)(*(t.to_local() for t in cache))
        mine = slice(grid.b0, grid.b0 + grid.nb)
        if aidx is not None:
            aidx = aidx[mine]
        if grid.ctx:
            # the window rows this rank's shard holds: (slot, window
            # index, local row) of each, found once for every layer
            rows = posm[mine] - grid.r0
            bsel, wsel = ((rows >= 0) & (rows < grid.nr)).nonzero(as_tuple=True)
            held = (bsel, wsel, rows[bsel, wsel])
    token_mask = torch.arange(w, device=dev)[None, :] < true_len[:, None]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bi = torch.arange(b, device=dev)[:, None]
    # (B, 1, 1, W, S_eff): broadcast over the logits' kv-head and group axes
    mask = (torch.arange(s_eff, device=dev)[None, None, :]
            <= posm[:, :, None])[:, None, None]
    scale = hd ** -0.5

    def proj_qkv(lw, h, lora):
        hn = rmsnorm(h, lw["attn_norm"], cfg.norm_eps)
        q = lora_proj(hn, lw["wq"], lora, "wq").reshape(b, w, nh, hd)
        k = lora_proj(hn, lw["wk"], lora, "wk").reshape(b, w, nkv, hd)
        v = lora_proj(hn, lw["wv"], lora, "wv").reshape(b, w, nkv, hd)
        return _rope_grid(q, freqs), _rope_grid(k, freqs), v

    def finish(lw, h, attn, lora):
        h = h + settle(lora_proj(attn, lw["wo"], lora, "wo"))
        hn = rmsnorm(h, lw["ffn_norm"], cfg.norm_eps)
        return h + settle(ffn_block(cfg, hn, lw, token_mask=token_mask,
                                    moe_no_drop=True))

    for i in range(cfg.n_layers):
        lw = dequant_layer(layer_weights(params, i), cfg.dtype)
        # the decode step's gather (shared helper: the bank layout and the
        # zero-adapter convention cannot drift)
        lora = gather_slot_adapters(
            {t: (a[i], b_[i]) for t, (a, b_) in (banks or {}).items()},
            aidx, lora_scale, banks)
        q, k, v = proj_qkv(lw, x, lora)
        if grid is None:
            attn = _window_attend(q, k, v, tuple(t[i] for t in cache), bi,
                                  posm, mask, s_eff, scale, x.dtype)
        elif grid.ctx:
            pl = grid.window
            q_l, k_l, v_l = (grid.local(t, pl) for t in (q, k, v))
            layer = tuple(t[i] for t in local)
            _write_held(layer, held, k_l, v_l)
            attn = grid.wrap(sp_window_attention(
                q_l, layer, posm[mine], axis_name="context", s_eff=s_eff,
                scale=scale, dtype=x.dtype), q, pl)
        else:
            pl = grid.window
            attn = grid.wrap(_window_attend(
                *(grid.local(t, pl) for t in (q, k, v)),
                tuple(t[i] for t in local), bi[:grid.nb], posm[mine],
                mask[mine], s_eff, scale, x.dtype), q, pl)
        x = finish(lw, x, attn.reshape(b, w, nh * hd), lora)
        if grid is not None:
            x = grid.pin(x)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _plain(lm_head_dot(x, params, cfg.dtype))


@dataclass
class _SpecChunking(_Chunking):
    """The base engine's chunked admission, with the draft's accumulator
    (L, 1, max_len, NKV_d, Hd_d) beside the target's."""
    dk: Optional[torch.Tensor] = None
    dv: Optional[torch.Tensor] = None


def _greedy() -> _Sampling:
    return _Sampling(0.0, 1.0, None, None, None, None, None)


class SpeculativeEngine(GenerationEngine):
    """Continuous batching with per-slot speculative decoding (module
    docstring has the design). Greedy only: exactness rests on the argmax
    acceptance rule. int8 KV composes (``quantize_kv=True``: the target's
    grid is int8, the draft's stays in its dtype), and so do multi-LoRA
    (the target's windows gather each slot's adapter; the draft proposes
    from its base weights, which moves only the acceptance rate), prefix
    caching (``register_prefix`` prefills both models' prefixes) and
    chunked prefill (``prefill_chunk``: both accumulators advance one chunk
    per step). ``draft_params`` must be on the engine's device and
    ``draft_cfg`` share the target's vocabulary. On a mesh both trees are
    DTensors laid out by the same rules and both grids are split as the
    plain engine's; with a live ``context`` axis each rank keeps S/c rows
    of each grid between rounds: the windows attend through a per-shard
    partial and one combine (``_grid_ingest``) and the draft's decode
    block through the partial mode of B1/B2. (JAX lets GSPMD gather the
    grid for the window forwards.)"""

    def __init__(self, params: Dict[str, Any], cfg,
                 draft_params: Dict[str, Any], draft_cfg, *, spec_k: int = 4,
                 spec_k_min: Optional[int] = None,
                 spec_k_max: Optional[int] = None,
                 spec_adapt_every: int = 4, **kwargs):
        if kwargs.get("temperature", 0.0) != 0.0:
            raise ValueError("SpeculativeEngine is greedy-only "
                             "(temperature=0); use GenerationEngine for "
                             "sampled serving")
        if kwargs.get("top_p") is not None:
            raise ValueError("top_p requires sampling — SpeculativeEngine "
                             "is greedy-only; use GenerationEngine")
        if kwargs.get("decode_block", 1) != 1:
            raise ValueError("decode_block tunes GenerationEngine's plain "
                             "decode loop; a speculation round already "
                             "batches its device work — use spec_k")
        if kwargs.get("auto_prefix"):
            # the headroom check in submit() runs before the base engine
            # would match a prefix: a matched bucket could push the window
            # past max_len
            raise ValueError("auto_prefix is not supported with "
                             "speculation — pass prefix_id explicitly")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        check_vocab(cfg, draft_cfg)
        super().__init__(params, cfg, **kwargs)
        if self._grid is not None:
            self._check_mesh_params(draft_params, self._mesh)
        if draft_params["embed"].device != self.device:
            raise ValueError(f"draft params are on "
                             f"{draft_params['embed'].device}, the engine's "
                             f"params on {self.device}")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.k = int(spec_k)
        # adaptive draft length: an acceptance-rate EWMA moves k within
        # [k_min, k_max] (kwargs, else KT_SPEC_K_MIN/KT_SPEC_K_MAX, else
        # spec_k: adaptation off unless the bounds are widened)
        env_min = os.environ.get("KT_SPEC_K_MIN")
        env_max = os.environ.get("KT_SPEC_K_MAX")
        self.k_min = int(spec_k_min if spec_k_min is not None
                         else (env_min or self.k))
        self.k_max = int(spec_k_max if spec_k_max is not None
                         else (env_max or self.k))
        if not (1 <= self.k_min <= self.k <= self.k_max):
            raise ValueError(
                f"need 1 <= k_min ({self.k_min}) <= spec_k ({self.k}) <= "
                f"k_max ({self.k_max})")
        self._adapt_every = max(1, int(spec_adapt_every))
        self._rounds_since_adapt = 0
        self._accept_ewma: Optional[float] = None
        self._draft_grid = None
        if self._grid is not None:
            self._draft_grid = _MeshGrid(self._mesh, draft_cfg, self.slots,
                                         self.max_len)
            self._draft_cache = self._draft_grid.zeros(draft_cfg, False)
        else:
            self._draft_cache = init_cache(draft_cfg, self.slots, self.max_len,
                                           device=self.device)
        self._draft_freqs = rope_freqs(
            draft_cfg, self.max_len + (self.prefill_chunk or 0),
            device=self.device)
        # per-slot ledgers: rows both caches validly cover, and the tokens
        # emitted but not yet ingested (1..k+1 long while active). The
        # base class's _pending is its request queue: the token ledger has
        # its own name
        self._spec_valid = np.zeros(self.slots, np.int64)
        self._slot_pending: List[List[int]] = [[] for _ in range(self.slots)]
        # prefix id → the draft's prefix (K, V), at the target's stored width
        self._draft_prefixes: Dict[int, tuple] = {}
        self.spec_stats = SpecStats()

    # -- prefixes -----------------------------------------------------------

    def register_prefix(self, tokens: Sequence[int],
                        adapter_id: Optional[int] = None) -> int:
        """The target's prefix through the base engine; the draft prefills
        the same tokens through its own weights, padded to the target's
        stored width, so both caches splice their prefix at the same
        widths and the position ledgers stay aligned."""
        pid = super().register_prefix(tokens, adapter_id)   # validates
        width = self._prefixes[pid].k.shape[2]
        tokens = [int(t) for t in tokens]

        def draft():
            with self._mesh_scope():
                self._draft_prefixes[pid] = _prefill_logits(
                    self.draft_params, self._padded(tokens, width),
                    len(tokens), self.draft_cfg, self._draft_freqs,
                    grid=self._draft_grid)[1:]

        if self._mesh is not None:
            self.at_batch_boundary(draft)
        else:
            draft()
        return pid

    def unregister_prefix(self, prefix_id: int) -> bool:
        self._draft_prefixes.pop(prefix_id, None)
        return super().unregister_prefix(prefix_id)

    # -- submission ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               prefix_id: Optional[int] = None,
               adapter_id: Optional[int] = None,
               top_p: Optional[float] = None,
               frequency_penalty: float = 0.0,
               presence_penalty: float = 0.0,
               stop: Optional[Sequence] = None,
               logit_bias=None, seed=None):
        if temperature not in (None, 0.0):
            raise ValueError("SpeculativeEngine is greedy-only")
        if top_p is not None:
            raise ValueError("top_p requires sampling — SpeculativeEngine "
                             "is greedy-only; use GenerationEngine")
        if frequency_penalty or presence_penalty:
            # penalties move even the greedy argmax, which the verify
            # window computes penalty-free
            raise ValueError("repetition penalties are not supported with "
                             "speculation — use GenerationEngine")
        if logit_bias:
            raise ValueError("logit_bias is not supported with "
                             "speculation — use GenerationEngine")
        if seed is not None:
            raise ValueError("seed is meaningless for greedy speculation "
                             "(deterministic already) — use "
                             "GenerationEngine for sampled serving")
        prompt = [int(t) for t in prompt]
        p_bucket = 0
        if prefix_id is not None:
            pref = self._prefixes.get(prefix_id)
            if pref is None:
                raise KeyError(f"unknown prefix_id {prefix_id}")
            p_bucket = pref.k.shape[2]
        # the verify window writes up to 2k+1 rows past the last emitted
        # token: reserve it for the largest k adaptation may pick
        if (prompt and max_new_tokens >= 1
                and p_bucket + len(prompt) + max_new_tokens
                + 2 * self.k_max + 1 > self.max_len):
            raise ValueError(
                f"prefix bucket ({p_bucket}) + prompt ({len(prompt)}) + "
                f"max_new_tokens ({max_new_tokens}) + verify window "
                f"({2 * self.k_max + 1}) exceeds max_len ({self.max_len})")
        # stop sequences work unchanged: emission goes through the shared
        # _emit, and stopping early never changes tokens already emitted
        return super().submit(prompt, max_new_tokens, stop=stop,
                              adapter_id=adapter_id, prefix_id=prefix_id)

    # -- admission ----------------------------------------------------------

    def _draft_prefix(self, req):
        """The draft's half of a request's prefix, fetched once: an
        unregister racing admission fails the request cleanly."""
        dpref = self._draft_prefixes.get(req.prefix_id)
        if dpref is None:
            raise KeyError(f"unknown prefix_id {req.prefix_id}")
        return dpref

    def _admit_one(self, req, slot: int) -> None:
        pref = self._resolve_prefix(req)
        t = len(req.prompt)
        lkw, aidx = self._resolve_adapter(req.adapter_id)
        if pref is not None:
            # both models continue behind their own cached prefix, at the
            # same widths
            dk_p, dv_p = self._draft_prefix(req)
            p_bucket = pref.k.shape[2]
            bucket = next((b for b in self._buckets
                           if b >= t and p_bucket + b <= self.max_len),
                          self.max_len - p_bucket)
            tokens = self._padded(req.prompt, bucket)
            first, k_new, v_new, _ = _prefill_suffix(
                self.params, tokens, t, pref.k, pref.v, pref.length,
                self.cfg, self._freqs, _greedy(), grid=self._grid, **lkw)
            _, dk, dv = _prefill_suffix_logits(
                self.draft_params, tokens, t, dk_p, dv_p, pref.length,
                self.draft_cfg, self._draft_freqs, grid=self._draft_grid)
            start = pref.length + t
            self._prefix_hits += 1
        else:
            bucket = next(b for b in self._buckets if b >= t)
            tokens = self._padded(req.prompt, bucket)
            first, k_new, v_new, _ = _prefill(
                self.params, tokens, t, self.cfg, self._freqs, _greedy(),
                grid=self._grid, **lkw)
            # the draft prefills the same prompt into its grid; the target
            # owns every emitted token, so the draft's head is skipped
            _, dk, dv = _prefill_logits(self.draft_params, tokens, t,
                                        self.draft_cfg, self._draft_freqs,
                                        grid=self._draft_grid)
            start = t
        self._seat(req, slot, first, k_new, v_new, dk, dv, start, aidx)

    def _seat(self, req, slot, first, k_new, v_new, dk, dv, start,
              aidx) -> None:
        """Seating shared by one-shot and chunked admission: splice both
        caches, set the ledgers, re-check the adapter mapping, emit the
        first (target-chosen) token."""
        _splice_slot(self._cache, slot, k_new, v_new, self._grid)
        _splice_slot(self._draft_cache, slot, dk, dv, self._draft_grid)
        first_tok = int(first[0])
        self._slot_req[slot] = req
        with self._lock:
            # an adapter evicted during the prefill falls back to the base
            # model, never to a reused bank index
            if (req.adapter_id is not None
                    and self._adapter_slots.get(req.adapter_id) != aidx):
                aidx = 0
            self._aidx[slot] = aidx
        self._spec_valid[slot] = start
        self._slot_pending[slot] = [first_tok]
        self._admitted += 1
        # a retirement on this first token clears the ledgers through
        # _retire_slot → _free_slot_ledgers
        self._emit(slot, first_tok)
        if req.first_token_at is not None:
            self._ttfts.append(req.first_token_at - req.submitted_at)

    # -- chunked prefill (both models) --------------------------------------

    def _start_chunking(self, req, slot: int) -> None:
        """First chunk of a long admission for both models: two max_len-row
        accumulators advance in lockstep."""
        pref = self._resolve_prefix(req)
        lkw, aidx = self._resolve_adapter(req.adapter_id)
        c = self.prefill_chunk
        if pref is not None:
            tk, tv = pref.k, pref.v
            dk, dv = self._draft_prefix(req)
            self._prefix_hits += 1
            consumed, frontier = 0, pref.length
        else:
            tokens = self._padded(req.prompt[:c], c)
            _, tk, tv = _prefill_logits(self.params, tokens, c, self.cfg,
                                        self._freqs, grid=self._grid, **lkw)
            _, dk, dv = _prefill_logits(self.draft_params, tokens, c,
                                        self.draft_cfg, self._draft_freqs,
                                        grid=self._draft_grid)
            consumed = frontier = c

        def widen(x):
            return _zero_rows(x, self.max_len - x.shape[2])

        self._chunking = _SpecChunking(
            req, slot, widen(tk), widen(tv), consumed, frontier,
            pref.tokens if pref else None, lkw, aidx, widen(dk), widen(dv))

    def _chunk_step(self) -> None:
        ck = self._chunking
        req = ck.req
        if req.cancelled:
            self._chunking = None
            req.out.put(None)
            return
        c = self.prefill_chunk
        take = min(c, len(req.prompt) - ck.consumed)
        padded = self._padded(req.prompt[ck.consumed:ck.consumed + take], c)
        last = ck.consumed + take == len(req.prompt)
        n = self.max_len
        try:
            if last:
                first, tk, tv, _ = _prefill_suffix(
                    self.params, padded, take, ck.k, ck.v, ck.frontier,
                    self.cfg, self._freqs, _greedy(), grid=self._grid,
                    **ck.lkw)
            else:
                _, tk, tv = _prefill_suffix_logits(
                    self.params, padded, take, ck.k, ck.v, ck.frontier,
                    self.cfg, self._freqs, grid=self._grid, **ck.lkw)
            _, dk, dv = _prefill_suffix_logits(
                self.draft_params, padded, take, ck.dk, ck.dv, ck.frontier,
                self.draft_cfg, self._draft_freqs, grid=self._draft_grid)
            tk, tv, dk, dv = (x[:, :, :n] for x in (tk, tv, dk, dv))
            if not last:
                ck.k, ck.v, ck.dk, ck.dv = tk, tv, dk, dv
                ck.consumed += take
                ck.frontier += take
                return
            self._chunking = None
            self._seat(req, ck.slot, first, tk, tv, dk, dv,
                       ck.frontier + take, ck.aidx)
        except Exception as e:   # noqa: BLE001 — fail THIS request only
            self._chunking = None
            req.error = e
            req.out.put(None)

    # -- the speculative round ----------------------------------------------

    def _free_slot_ledgers(self, slot: int) -> None:
        self._slot_pending[slot] = []
        self._spec_valid[slot] = 0

    def step(self) -> int:
        """Run the batch-boundary hooks, admit pending requests (or advance
        the chunked admission), then run one speculation round over every
        active slot. Returns the remaining work, as the base engine's
        ``step``. (The JAX engine's ``step`` runs no boundary hooks, so a
        hook queued beside its loop thread waits for ``stop``.) On a mesh,
        under the mesh and after the ranks' step agreement."""
        with self._mesh_scope():
            self._begin_step()
            self._admit()
            active = [i for i, r in enumerate(self._slot_req)
                      if r is not None]
            if active:
                self._round(active)
        with self._lock:
            queued = len(self._pending)
        return (sum(r is not None for r in self._slot_req) + queued
                + (self._chunking is not None))

    def _round(self, active: List[int]) -> None:
        b, k = self.slots, self.k
        dev = self.device
        c = np.zeros(b, np.int64)
        for i in active:
            c[i] = len(self._slot_pending[i])
        # a slot that accepted all of the last round's proposals holds
        # k_old + 1 pending tokens, which exceeds k + 1 if _note_round has
        # since shrunk k: size the windows from the ledgers (wt stays
        # within the 2 * k_max + 1 rows submit reserves)
        wd = max(k + 1, int(c.max()))
        wt = wd + k
        start = self._spec_valid.copy()
        # no slot attends a row past its own start + W, so both window
        # passes read s_eff rows, a power-of-two bucket, not all max_len
        need = int(start[active].max()) + wt
        s_eff = self.max_len
        while s_eff // 2 >= need and s_eff > 1:
            s_eff //= 2
        start_d = torch.from_numpy(start).to(dev)

        # draft: ingest each slot's pending block; the first proposal from
        # its logits at the last real position, the other k-1 from one
        # greedy decode block (temperatures 0: argmax)
        dblock = np.zeros((b, wd), np.int64)
        for i in active:
            dblock[i, :c[i]] = self._slot_pending[i]
        dlog = _grid_ingest(self.draft_params, self._draft_cache,
                            torch.from_numpy(dblock).to(dev), start_d,
                            torch.from_numpy(c).to(dev), self.draft_cfg,
                            s_eff=s_eff, freqs_full=self._draft_freqs,
                            grid=self._draft_grid)
        last = torch.from_numpy(np.clip(c - 1, 0, wd - 1)).to(dev)
        tok = torch.argmax(dlog[torch.arange(b, device=dev), last], dim=-1)
        if k > 1:
            toks_k, _ = _decode_block(
                self.draft_params, self._draft_cache,
                torch.from_numpy((start + c).astype(np.int32)).to(dev), tok,
                self.draft_cfg, self._draft_freqs, k - 1,
                np.zeros(b, np.float32), None, np.ones(b, np.float32),
                [None] * b, grid=self._draft_grid)
            # (B, k): the first proposal, then the block's (k-1, B) transposed
            proposals = torch.cat([tok[:, None], toks_k.T], dim=1)
        else:
            proposals = tok[:, None]
        proposals = proposals.cpu().numpy()

        # target: one forward over pending + proposals for every slot
        tblock = np.zeros((b, wt), np.int64)
        tl = np.zeros(b, np.int64)
        for i in active:
            tblock[i, :c[i]] = self._slot_pending[i]
            tblock[i, c[i]:c[i] + k] = proposals[i]
            tl[i] = c[i] + k
        with self._lock:
            banks, aidx = self._banks, self._aidx.copy()
        lkw = (dict(banks=banks, aidx=torch.from_numpy(aidx).to(dev),
                    lora_scale=self._lora_cfg.scale) if banks else {})
        tlog = _grid_ingest(self.params, self._cache,
                            torch.from_numpy(tblock).to(dev), start_d,
                            torch.from_numpy(tl).to(dev), self.cfg,
                            s_eff=s_eff, freqs_full=self._freqs,
                            grid=self._grid, **lkw)
        greedy = torch.argmax(tlog, dim=-1).cpu().numpy()       # (B, WT)
        self._steps += 1

        round_accepted = 0
        for i in active:
            ci = int(c[i])
            accepted = 0
            while (accepted < k
                   and proposals[i, accepted] == greedy[i, ci - 1 + accepted]):
                accepted += 1
            correction = int(greedy[i, ci - 1 + accepted])
            emitted = [int(t) for t in proposals[i, :accepted]] + [correction]
            sent = 0
            for t in emitted:
                self._emit(i, t)
                sent += 1
                if self._slot_req[i] is None:
                    break
            self.spec_stats.rounds += 1
            self.spec_stats.proposed += k
            # count only acceptances that were emitted: matches past a
            # retirement (budget, eos, stop) would flatter the rate
            self.spec_stats.accepted += min(accepted, sent)
            round_accepted += min(accepted, sent)
            # a slot retired during emission had its ledgers cleared by
            # _retire_slot → _free_slot_ledgers; only live slots advance
            if self._slot_req[i] is not None:
                self._spec_valid[i] = start[i] + ci
                self._slot_pending[i] = emitted
        self._note_round(round_accepted, len(active) * k)

    def _note_round(self, accepted: int, proposed: int) -> None:
        """Acceptance-rate EWMA → draft length. Grows ``k`` while the EWMA
        is ≥ 0.8, shrinks it at ≤ 0.5 (0.5–0.8 is hysteresis), at most one
        ±1 move per ``spec_adapt_every`` rounds, within [k_min, k_max]."""
        if not proposed:
            return
        rate = accepted / proposed
        self._accept_ewma = (rate if self._accept_ewma is None
                             else 0.8 * self._accept_ewma + 0.2 * rate)
        gauges = telemetry.spec_metrics()
        gauges["accept_rate"].set(self._accept_ewma)
        gauges["draft_len"].set(self.k)
        if self.k_min == self.k_max:
            return
        self._rounds_since_adapt += 1
        if self._rounds_since_adapt < self._adapt_every:
            return
        self._rounds_since_adapt = 0
        if self._accept_ewma >= 0.8 and self.k < self.k_max:
            self.k += 1
        elif self._accept_ewma <= 0.5 and self.k > self.k_min:
            self.k -= 1
        gauges["draft_len"].set(self.k)
