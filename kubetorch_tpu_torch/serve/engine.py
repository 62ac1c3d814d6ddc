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
  same tokens whatever slot it lands in and whoever its neighbours are.

Not ported yet, and raising ``NotImplementedError`` rather than being
ignored: ``auto_prefix``, ``prefill_chunk``, ``aot_cache``, a device mesh
(so neither the sharded int8 decode), LoRA adapters, cached prefixes,
frequency and presence penalties, and ``logit_bias``; MoE layers raise in
the model code.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.common import resolve_device
from ..models.generate import (_flash_prefill_wanted, _layer_step, ffn_block,
                               filter_logits, init_cache)
from ..models.llama import _rotate, layer_weights, rmsnorm, rope_freqs
from ..models.quant import dequant_layer, is_quantized, lm_head_dot, wdot
from ..ops.decode_attention import (decode_attention, decode_attention_quant,
                                    decode_attention_quant_ref,
                                    decode_attention_ref)
from .kv_quant import QuantKVCache, init_quant_cache, quantize_rows


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def _rope_slot(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """RoPE with a per-slot rotation: x (B, N, Hd), freqs (B, Hd/2)."""
    return _rotate(x, freqs[:, None, :])


def _decode_qkv(cfg, x, lw, freqs):
    """The projections of one new token per slot, RoPE applied: q (B, NH,
    Hd), k and v (B, NKV, Hd). Shared by both cache layouts."""
    b = x.shape[0]
    hd = cfg.head_dim
    h = rmsnorm(x, lw["attn_norm"], cfg.norm_eps)
    q = wdot(h, lw["wq"]).reshape(b, cfg.n_heads, hd)
    k = wdot(h, lw["wk"]).reshape(b, cfg.n_kv_heads, hd)
    v = wdot(h, lw["wv"]).reshape(b, cfg.n_kv_heads, hd)
    return _rope_slot(q, freqs), _rope_slot(k, freqs), v


def _decode_out(cfg, x, lw, attn) -> torch.Tensor:
    """Output projection of attention (B, NH, Hd) and the FFN, residuals
    included. Shared by both cache layouts."""
    x = x + wdot(attn.reshape(x.shape[0], 1, -1).to(x.dtype), lw["wo"])
    h = rmsnorm(x, lw["ffn_norm"], cfg.norm_eps)
    return x + ffn_block(cfg, h, lw)


def _decode_layer(cfg, x, lw, ck, cv, pos, pos_idx, freqs) -> torch.Tensor:
    """One layer over one new token per slot. x: (B, 1, D); ck/cv: this
    layer's (B, S, NKV, Hd) cache, written in place at each slot's row;
    pos: (B,) int32 row of each slot's new token (``pos_idx`` the same as
    int64 for indexing); freqs: (B, Hd/2). ``lw`` is dequantized already
    (:func:`_decode_step_impl`)."""
    q, k, v = _decode_qkv(cfg, x, lw, freqs)
    bi = torch.arange(x.shape[0], device=x.device)
    ck[bi, pos_idx] = k.to(ck.dtype)
    cv[bi, pos_idx] = v.to(cv.dtype)
    # "xla" keeps the plain masked einsum; otherwise the flash-decode
    # wrapper (the kernel on CUDA, the same einsum on the CPU)
    attend = decode_attention_ref if cfg.attn_impl == "xla" else decode_attention
    return _decode_out(cfg, x, lw, attend(q, ck, cv, pos,
                                          scale=cfg.head_dim ** -0.5))


def _decode_layer_quant(cfg, x, lw, kq, ks, vq, vs, pos, pos_idx,
                        freqs) -> torch.Tensor:
    """:func:`_decode_layer` against an int8 cache (``serve.kv_quant``):
    the new row is quantized before it is written (kq/vq (B, S, NKV, Hd)
    int8, ks/vs (B, S, NKV) fp32, this layer's slices, in place), and
    attention folds the row scales in instead of materializing fp rows."""
    q, k, v = _decode_qkv(cfg, x, lw, freqs)
    bi = torch.arange(x.shape[0], device=x.device)
    kq[bi, pos_idx], ks[bi, pos_idx] = quantize_rows(k)
    vq[bi, pos_idx], vs[bi, pos_idx] = quantize_rows(v)
    # "xla" keeps the plain fold-in einsum; otherwise the int8 flash-decode
    # wrapper (the kernel on CUDA, the same einsum on the CPU)
    attend = (decode_attention_quant_ref if cfg.attn_impl == "xla"
              else decode_attention_quant)
    return _decode_out(cfg, x, lw, attend(q, kq, ks, vq, vs, pos,
                                          scale=cfg.head_dim ** -0.5))


def _sample_slots(logits, temps: np.ndarray, top_k: Optional[int],
                  top_ps: np.ndarray, gens: Sequence[Optional[torch.Generator]]):
    """Per-slot sampling over (B, V) fp32 logits. ``temps`` (B,): 0 means
    greedy for that row; ``top_ps`` (B,): nucleus mass, 1.0 disables;
    ``gens``: each sampled row draws from its own generator, so its token
    depends on nothing but its own logits and stream. Returns (tokens (B,)
    int64, raw-model logprob of each token (B,) fp32)."""
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
    logp = torch.log_softmax(logits, dim=-1)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


def _decode_step_impl(params, cache, pos, toks, cfg, freqs_table):
    """Single-step decode math for every slot: returns (B, V) fp32 logits
    and writes each slot's new K/V row. ``cache`` is a ``KVCache`` or an
    int8 ``QuantKVCache``. ``pos`` (B,) int32 on the device; positions past
    the grid clamp to its last row (module docstring), in every tensor of
    either cache."""
    quant = isinstance(cache, QuantKVCache)
    s_max = (cache.kq if quant else cache.k).shape[2]
    pos = pos.clamp(max=s_max - 1)
    pos_idx = pos.long()
    x = params["embed"][toks][:, None].to(cfg.dtype)          # (B, 1, D)
    freqs = freqs_table[pos_idx]                               # (B, Hd/2)
    # decided once per tree: a plain tree skips the per-layer dequant walk
    quant_w = any(is_quantized(w) for w in params["layers"].values())
    for i in range(cfg.n_layers):
        lw = layer_weights(params, i)
        if quant_w:
            lw = dequant_layer(lw, cfg.dtype)
        if quant:
            x = _decode_layer_quant(cfg, x, lw, cache.kq[i], cache.ks[i],
                                    cache.vq[i], cache.vs[i], pos, pos_idx,
                                    freqs)
        else:
            x = _decode_layer(cfg, x, lw, cache.k[i], cache.v[i], pos,
                              pos_idx, freqs)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_head_dot(x[:, 0], params, cfg.dtype)


def _decode_block(params, cache, pos, toks, cfg, freqs_table,
                  n_steps: int, temps, top_k, top_ps, gens):
    """Advance every slot ``n_steps`` tokens. pos (B,) int32 and toks (B,)
    int64 on the device. Returns (tokens (K, B), logprobs (K, B))."""
    toks_k, lps_k = [], []
    for _ in range(n_steps):
        logits = _decode_step_impl(params, cache, pos, toks, cfg, freqs_table)
        toks, lps = _sample_slots(logits, temps, top_k, top_ps, gens)
        pos = pos + 1
        toks_k.append(toks)
        lps_k.append(lps)
    return torch.stack(toks_k), torch.stack(lps_k)


def _prefill_logits(params, tokens, true_len: int, cfg, freqs_table):
    """Prompt pass at one bucket length. tokens (1, T_bucket) right-padded;
    logits (1, V) fp32 are taken at the real last position ``true_len - 1``
    (padding rows only pollute their own cache rows, which decode
    overwrites before attending to them). Returns (logits, k, v) with k/v
    (L, 1, T_bucket, NKV, Hd)."""
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    flash = _flash_prefill_wanted(cfg, t, tokens.device)
    cache = init_cache(cfg, b, t, device=tokens.device)
    for i in range(cfg.n_layers):
        x = _layer_step(cfg, x, layer_weights(params, i), cache.k[i],
                        cache.v[i], 0, freqs_table, flash_prefill=flash)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_head_dot(x[:, true_len - 1], params, cfg.dtype), cache.k, cache.v


def _prefill(params, tokens, true_len: int, cfg, freqs_table, temps, top_k,
             top_ps, gens):
    """:func:`_prefill_logits`, then the first token sampled. Returns
    (first (1,), k, v, logprob (1,))."""
    logits, k, v = _prefill_logits(params, tokens, true_len, cfg, freqs_table)
    first, lps = _sample_slots(logits, temps, top_k, top_ps, gens)
    return first, k, v, lps


def _splice_slot(cache, slot: int, k_new, v_new) -> None:
    """Copy a prefill's K/V rows (L, 1, T_b, NKV, Hd) into one slot of the
    grid, in place. An int8 ``QuantKVCache`` grid quantizes the rows here,
    all T_b of the padded bucket (padding rows get their own scales and
    are overwritten before they are read); prefill itself always runs
    full-precision math."""
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
    seed: Optional[int] = None               # reproducible sampling stream
    stop: tuple = ()                         # stop token-id sequences
    cancelled: bool = False                  # reaped at the next step
    error: Optional[BaseException] = None    # admission failure, surfaced
    out: "queue.Queue[Optional[int]]" = field(default_factory=queue.Queue)
    tail: list = field(default_factory=list)  # last max(len(stop)) tokens
    logprobs: list = field(default_factory=list)  # raw-model lp per token
    generated: int = 0
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None


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


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch engine")


class GenerationEngine:
    """Continuous-batching decode over a fixed slot grid (module docstring
    has the design). Drive it with :meth:`step` (deterministic) or start
    the background loop with :meth:`start`.

    ``params`` is the stacked Llama param dict (``models.llama``), plain
    or quantized (``models.quant``), on ``device`` — ``cuda`` unless the
    caller names another. ``eos_id`` retires a slot early; ``max_len``
    caps prompt + completion; ``quantize_kv=True`` keeps the KV grid in
    int8 (``serve.kv_quant``).
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
        for flag, what in ((auto_prefix, "auto_prefix"),
                           (prefill_chunk is not None, "prefill_chunk"),
                           (aot_cache is not None, "aot_cache"),
                           (mesh is not None, "a device mesh")):
            if flag:
                raise _not_ported(what)
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
        self._buckets = sorted({min(b, self.max_len)
                                for b in prefill_buckets} | {self.max_len})
        # the int8 grid (serve.kv_quant): rows quantize at the splice and
        # at each decode step's write
        make_cache = init_quant_cache if quantize_kv else init_cache
        self._cache = make_cache(cfg, self.slots, self.max_len,
                                 device=self.device)
        self._freqs = rope_freqs(cfg, self.max_len, device=self.device)
        self._pos = np.zeros(self.slots, np.int32)     # next write position
        self._tok = np.zeros(self.slots, np.int64)     # next decode input
        self._temps = np.zeros(self.slots, np.float32)
        self._top_ps = np.ones(self.slots, np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * self.slots
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._pending: "deque[_Request]" = deque()
        self._admitting: Optional[_Request] = None   # cancel() window
        # seeds for requests that bring none (drawn under _lock)
        self._seed_rng = np.random.default_rng(seed)
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # exactly one loop thread may ever exist: two would interleave
        # decode steps on the same cache
        self._lifecycle = threading.Lock()
        self._admitted = self._finished = 0
        self._tokens = self._steps = 0
        self._ttfts = deque(maxlen=256)
        self._t0 = time.monotonic()

    # -- not ported ---------------------------------------------------------

    def register_adapter(self, adapters, lora_cfg) -> int:
        raise _not_ported("LoRA adapter serving")

    def register_prefix(self, tokens, adapter_id=None) -> int:
        raise _not_ported("prefix caching")

    # -- submission ---------------------------------------------------------

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
        defaults for this request (0 = greedy). ``stop`` is one token-id
        sequence or a list of them: the request retires once its generated
        tokens end with one (the matching tokens are emitted). ``seed``
        fixes the request's sampling stream."""
        if prefix_id is not None:
            raise _not_ported("prefix caching (prefix_id)")
        if adapter_id is not None:
            raise _not_ported("LoRA adapter serving (adapter_id)")
        if frequency_penalty or presence_penalty:
            raise _not_ported("frequency/presence penalties")
        if logit_bias:
            raise _not_ported("logit_bias")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "always samples the first token)")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine's max_len ({self.max_len})")
        # an out-of-range id would be a device-side assert in the embedding
        bad = [t for t in prompt if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids out of vocab range "
                             f"[0, {self.cfg.vocab_size}): {bad[:8]}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        req = _Request(next(self._rid), prompt, int(max_new_tokens),
                       temperature=temperature, top_p=top_p,
                       stop=_normalize_stop(stop),
                       seed=None if seed is None else int(seed))
        with self._lock:
            self._pending.append(req)
        self._work.set()
        return RequestHandle(req, engine=self)

    def cancel(self, request_id: int) -> bool:
        """Abandon a request: a queued one never admits, an active one
        frees its slot at the next step boundary, one caught mid-admission
        is reaped right after its admission. False if the id is unknown,
        finished or already cancelled."""
        with self._lock:
            for i, req in enumerate(self._pending):
                if req.rid == request_id:
                    del self._pending[i]
                    req.out.put(None)
                    return True
        for req in self._slot_req:
            if req is not None and req.rid == request_id:
                if req.cancelled:
                    return False
                req.cancelled = True
                self._work.set()
                return True
        adm = self._admitting
        if adm is not None and adm.rid == request_id and not adm.cancelled:
            adm.cancelled = True
            self._work.set()
            return True
        return False

    def _retire_slot(self, slot: int) -> None:
        """The one slot-retirement path (finish, eos, stop, cancel): end the
        handle's stream, free the slot, clear its state."""
        req = self._slot_req[slot]
        if req is None:
            return
        req.out.put(None)
        self._slot_req[slot] = None
        self._gens[slot] = None
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._temps[slot] = 0.0
        self._top_ps[slot] = 1.0
        self._finished += 1

    def _reap_cancelled(self) -> None:
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.cancelled:
                self._retire_slot(slot)

    # -- admission ----------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admit(self) -> None:
        free = self._free_slots()
        while free:
            with self._lock:
                if not self._pending:
                    return
                req = self._pending.popleft()
            slot = free.pop(0)
            self._admitting = req
            try:
                self._admit_one(req, slot)
            except Exception as e:   # noqa: BLE001 — fail THAT request only
                req.error = e
                req.out.put(None)
                free.insert(0, slot)
            finally:
                self._admitting = None

    def _request_generator(self, req: _Request) -> torch.Generator:
        if req.seed is not None:
            seed = req.seed
        else:
            with self._lock:
                seed = int(self._seed_rng.integers(2 ** 63))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _admit_one(self, req: _Request, slot: int) -> None:
        t = len(req.prompt)
        bucket = next(b for b in self._buckets if b >= t)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :t] = torch.tensor(req.prompt)
        temp = (self.temperature if req.temperature is None
                else float(req.temperature))
        tp = self.top_p if req.top_p is None else float(req.top_p)
        tp = 1.0 if tp is None else tp
        gen = self._request_generator(req) if temp > 0 else None
        first, k_new, v_new, flp = _prefill(
            self.params, padded.to(self.device), t, self.cfg, self._freqs,
            np.array([temp], np.float32), self.top_k,
            np.array([tp], np.float32), [gen])
        self._finish_admission(req, slot, first, flp, k_new, v_new, t, temp,
                               tp, gen)

    def _finish_admission(self, req: _Request, slot: int, first, flp, k_new,
                          v_new, start: int, temp: float, tp: float,
                          gen: Optional[torch.Generator]) -> None:
        """Splice the K/V rows, seat the request, emit its first token."""
        _splice_slot(self._cache, slot, k_new, v_new)
        first_tok = int(first[0])
        self._slot_req[slot] = req
        self._gens[slot] = gen
        self._pos[slot] = start
        self._tok[slot] = first_tok
        self._temps[slot] = temp
        self._top_ps[slot] = tp
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

    # -- engine loop --------------------------------------------------------

    def step(self) -> int:
        """Admit pending requests, then decode one block of tokens
        (``decode_block`` steps) for every active slot. Returns the
        remaining work — active slots plus queued requests."""
        with torch.no_grad():
            return self._step_once()

    def _step_once(self) -> int:
        self._reap_cancelled()
        self._admit()
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if active:
            k = self.decode_block
            toks_k, lps_k = _decode_block(
                self.params, self._cache,
                torch.from_numpy(self._pos).to(self.device),
                torch.from_numpy(self._tok).to(self.device), self.cfg,
                self._freqs, k, self._temps.copy(), self.top_k,
                self._top_ps.copy(), list(self._gens))
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
        return sum(r is not None for r in self._slot_req) + queued

    def _run(self) -> None:
        while not self._stop.is_set():
            n = self.step()
            if n == 0 and not self._pending:
                self._work.clear()
                self._work.wait(timeout=0.5)

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

    # -- introspection ------------------------------------------------------

    def stats(self) -> EngineStats:
        dt = max(time.monotonic() - self._t0, 1e-9)
        return EngineStats(
            slots=self.slots,
            active=sum(r is not None for r in self._slot_req),
            queued=len(self._pending),
            admitted_total=self._admitted,
            finished_total=self._finished,
            tokens_generated=self._tokens,
            decode_steps=self._steps,
            tokens_per_sec=self._tokens / dt,
            ttft_avg=(sum(self._ttfts) / len(self._ttfts)
                      if self._ttfts else 0.0))

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 64,
                 timeout: Optional[float] = 300.0, *,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None,
                 stop: Optional[Sequence] = None,
                 seed: Optional[int] = None) -> List[int]:
        """Blocking submit-and-wait on the background loop."""
        self.start()
        return self.submit(prompt, max_new_tokens, temperature=temperature,
                           top_p=top_p, stop=stop, seed=seed
                           ).result(timeout=timeout)
