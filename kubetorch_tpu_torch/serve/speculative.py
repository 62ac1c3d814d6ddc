"""Speculative decoding, the counterpart of
``kubetorch_tpu/serve/speculative.py``: a small draft model proposes, the
target verifies.

Decode streams every weight once per token; a draft model proposes ``k``
tokens one at a time and the target scores all of them in ONE forward, so
each pass over the target's weights yields 1..k+1 tokens. Greedy
verification is exact: a proposal is accepted only while it equals the
target's own argmax, so the emitted stream is the target's greedy decode
whatever the draft proposes.

Both models keep fixed ``max_len`` caches, written in place (where the JAX
version donates the cache into each jitted call). Every round the draft
ingests the previous round's accepted block (padded to ``k+1``) and
proposes ``k`` tokens, the last ``k-1`` in single steps of a Python loop
(the JAX version's ``lax.scan``); the target ingests block + proposals
(padded to ``2k+1``) and returns every position's logits. Rows past the
valid frontier hold stale values by design: every forward writes its rows
before attending, and the causal mask never admits a row at a position not
yet written. ``speculative_generate`` reserves room for the padded windows
up front, so no write can leave the cache (PyTorch raises on an
out-of-range index where XLA would clamp or drop it).

Every pass is the plain cached attention of ``models.generate._layer_step``
(no flash prefill, as in JAX). MoE targets stay exact: draft and verify
windows route ``no_drop`` (each token as if decoded alone), and the prompt
prefill uses the real length's capacity over the padded bucket.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..models.common import resolve_device
from ..models.generate import KVCache, _layer_step, init_cache
from ..models.llama import layer_weights, rmsnorm, rope_freqs
from ..models.moe import moe_prefill_keep_capacity
from ..models.quant import lm_head_dot


@torch.no_grad()
def _ingest(params, cache: KVCache, block, start: int, true_len: int, cfg,
            logits: str = "all", keep_capacity=None, no_drop: bool = False,
            freqs_full=None):
    """Run ``block`` (1, W) of tokens at absolute positions ``start + i``
    through the model, writing their K/V rows into ``cache`` in place.
    ``logits`` picks what the head computes: "all" → fp32 (1, W, V) for
    every position (the verify round), "last" → (1, V) at ``true_len - 1``
    only (the prompt prefill), "none" → None (the draft's prompt ingest
    needs only the cache). Positions at and past ``true_len`` are padding:
    their logits are to be ignored, their rows are overwritten before they
    can be attended, and they never claim an MoE capacity slot.

    MoE routing per window kind: mid-stream windows pass ``no_drop=True``
    (each token routes as if decoded alone); the prompt window passes the
    real length's overflow threshold as ``keep_capacity``. Both are no-ops
    for dense configs. ``freqs_full``: the RoPE table, at least as long as
    the cache (built here when None)."""
    b, w = block.shape
    x = params["embed"][block].to(cfg.dtype)
    if freqs_full is None:
        freqs_full = rope_freqs(cfg, cache.k.shape[2], device=block.device)
    token_mask = (torch.arange(w, device=block.device) < true_len)[None, :]
    for i in range(cfg.n_layers):
        x = _layer_step(cfg, x, layer_weights(params, i), cache.k[i],
                        cache.v[i], start, freqs_full, token_mask=token_mask,
                        keep_capacity=keep_capacity, moe_no_drop=no_drop)
    if logits == "none":
        return None
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if logits == "last":
        return lm_head_dot(x[:, true_len - 1], params, cfg.dtype)
    return lm_head_dot(x, params, cfg.dtype)


@torch.no_grad()
def _draft_propose(params, cache: KVCache, block, start: int, true_len: int,
                   cfg, k: int, freqs_full=None) -> List[int]:
    """Draft round: ingest the accepted block, then greedily propose ``k``
    tokens with single-step ingests. Returns the ``k`` proposals. The
    proposal steps write rows ``start+true_len … start+true_len+k-2`` (the
    k-th proposal is never ingested: the next round's block carries
    whatever survives verification). The tokens stay on the device until
    the last step."""
    logits = _ingest(params, cache, block, start, true_len, cfg,
                     no_drop=True, freqs_full=freqs_full)
    tok = torch.argmax(logits[0, true_len - 1])
    toks = [tok]
    for i in range(k - 1):
        lg = _ingest(params, cache, tok.reshape(1, 1), start + true_len + i,
                     1, cfg, no_drop=True, freqs_full=freqs_full)
        tok = torch.argmax(lg[0, 0])
        toks.append(tok)
    return torch.stack(toks).tolist()


def check_vocab(target_cfg, draft_cfg) -> None:
    """Draft and target must share the vocabulary: each model embeds the
    other's tokens, and an id past an embedding's rows raises in PyTorch
    (XLA clamps it to the last row)."""
    if draft_cfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(f"draft vocab_size {draft_cfg.vocab_size} != "
                         f"target vocab_size {target_cfg.vocab_size}")


@dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


@torch.no_grad()
def speculative_generate(target_params, target_cfg, draft_params, draft_cfg,
                         prompt, max_new_tokens: int = 64, k: int = 4,
                         max_len: Optional[int] = None,
                         prompt_buckets: Sequence[int] = (64, 256, 1024,
                                                         4096),
                         stats: Optional[SpecStats] = None,
                         device=None) -> List[int]:
    """Greedy speculative decoding; returns the generated tokens (prompt
    excluded), equal to the target's greedy ``generate``.

    ``draft_cfg``/``target_cfg`` must share the vocabulary
    (:func:`check_vocab`); ``k`` proposals per round. Pass a ``SpecStats``
    to read the acceptance rate.
    ``max_len`` sizes both caches (default: just what the request needs);
    prompts pad to ``prompt_buckets``. Both param trees must be on
    ``device`` (``cuda`` unless the caller names another)."""
    device = resolve_device(device)
    check_vocab(target_cfg, draft_cfg)
    for params in (target_params, draft_params):
        if params["embed"].device.type != device.type:
            raise ValueError(f"params are on {params['embed'].device}, "
                             f"device is {device}")
    prompt = [int(t) for t in prompt]
    if not prompt:
        raise ValueError("empty prompt")
    p = len(prompt)
    p_bucket = next((b for b in sorted(prompt_buckets) if b >= p), p)
    # the cache must hold the full padded windows past the last valid row:
    # the padded prompt, and prompt + new + (2k+1) verify rows
    total_cap = max(p_bucket, p + max_new_tokens + 2 * k + 1)
    if max_len is None:
        max_len = total_cap
    if max_len < total_cap:
        raise ValueError(
            f"max_len {max_len} < max(prompt bucket, prompt + "
            f"max_new_tokens + 2k+1) ({total_cap}) — the padded windows "
            "must fit")

    dev = target_params["embed"].device
    t_cache = init_cache(target_cfg, 1, max_len, device=dev)
    d_cache = init_cache(draft_cfg, 1, max_len, device=dev)
    t_freqs = rope_freqs(target_cfg, max_len, device=dev)
    d_freqs = rope_freqs(draft_cfg, max_len, device=dev)

    # bucketed prompt prefill on both models; the draft skips the head and
    # the target computes logits at the last position only
    block = torch.zeros((1, p_bucket), dtype=torch.long)
    block[0, :p] = torch.tensor(prompt)
    block = block.to(dev)
    t_last = _ingest(target_params, t_cache, block, 0, p, target_cfg,
                     logits="last",
                     keep_capacity=moe_prefill_keep_capacity(target_cfg, p),
                     freqs_full=t_freqs)
    _ingest(draft_params, d_cache, block, 0, p, draft_cfg, logits="none",
            keep_capacity=moe_prefill_keep_capacity(draft_cfg, p),
            freqs_full=d_freqs)
    first = int(torch.argmax(t_last[0]))

    out: List[int] = [first]
    # pending = emitted tokens neither model has validly ingested yet;
    # always 1..k+1 long, so the draft's ingest width is k+1
    pending: List[int] = [first]
    n_valid = p                      # tokens both caches validly cover
    w_d, w_t = k + 1, 2 * k + 1

    while len(out) < max_new_tokens:
        c = len(pending)
        dblock = torch.zeros((1, w_d), dtype=torch.long)
        dblock[0, :c] = torch.tensor(pending)
        proposals = _draft_propose(draft_params, d_cache, dblock.to(dev),
                                   n_valid, c, draft_cfg, k,
                                   freqs_full=d_freqs)

        tblock = torch.zeros((1, w_t), dtype=torch.long)
        tblock[0, :c] = torch.tensor(pending)
        tblock[0, c:c + k] = torch.tensor(proposals)
        t_logits = _ingest(target_params, t_cache, tblock.to(dev), n_valid,
                           c + k, target_cfg, no_drop=True,
                           freqs_full=t_freqs)
        greedy = torch.argmax(t_logits[0], dim=-1).tolist()

        # greedy[c-1+i] is the target's own choice after pending +
        # proposals[:i]; accept while the draft matched it
        accepted = 0
        while accepted < k and proposals[accepted] == greedy[c - 1 + accepted]:
            accepted += 1
        correction = greedy[c - 1 + accepted]

        emitted = proposals[:accepted] + [correction]
        out.extend(emitted)
        n_valid += c                 # the old pending is now verified rows
        pending = emitted
        if stats is not None:
            stats.rounds += 1
            stats.proposed += k
            stats.accepted += accepted

    return out[:max_new_tokens]
