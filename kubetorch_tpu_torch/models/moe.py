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

On a device mesh (DTensor params laid out by ``parallel.MOE_RULES``, the
batch by ``ACT_RULES``) the attention half is Llama's (``common.linear``,
attention per local batch and head shard) and the FFN runs the plan of
JAX's shard_map form on each rank's shards (:func:`_dispatch_on_mesh`):
``expert`` is no batch axis, so every rank of it holds the same tokens,
routes all of them, keeps the pairs of its own experts and runs only
those; one reduction over the axes that split the bank (``expert``, and
``tensor`` over F) rebuilds the output, with no all-to-all. The FFN's
input is gathered over ``context`` first, so capacity counts the whole
sequence as in JAX, and the aux term's means are reduced over the batch
before they multiply. ``moe_ffn(ep_axis=, tp_axis=)`` is the same plan
inside ``parallel.mesh.shard_map_fn`` (pipeline stages).

Not ported here: ``context_chunked_routing`` (pipeline stages), which
``config_from_dict`` ignores.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import is_dtensor
from .common import checkpointed, constrain_hidden
from .common import config_from_dict as _config_from_dict
from .common import linear, replicate_like, resolve_device, resolve_remat_policy
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


def _bank_experts(leaf: Any) -> int:
    """How many experts a bank leaf holds: its leading dim, read through
    any array of a quantized leaf (each keeps the expert dim)."""
    return (next(iter(leaf.values())) if isinstance(leaf, dict) else leaf).shape[0]


def _positions(cfg: MoeConfig, gate_idx: torch.Tensor, s: int, token_mask=None,
               keep_capacity=None, no_drop: bool = False):
    """Each (token, k) pair's row in its expert's capacity buffer: the
    pairs before it in (S·K) order that chose the same expert, padding
    excluded. Returns (capacity, pos (B, S, K), kept (B, S, K) bool)."""
    b = gate_idx.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    if no_drop:
        capacity, keep_capacity = s, None
    else:
        capacity = max(1, int(cfg.capacity_factor * s * K / E))
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
    return capacity, pos, kept


def _run_experts(x: torch.Tensor, gate_vals: torch.Tensor,
                 gate_idx: torch.Tensor, pos: torch.Tensor, kept: torch.Tensor,
                 capacity: int, experts: Dict[str, Any],
                 start: int = 0) -> torch.Tensor:
    """The buffer, the SwiGLU and the combine of experts ``[start, start +
    n)``, n the bank's leading dim (all E off a mesh; a rank's own range
    on one): the kept pairs that chose one of them are copied into its
    buffer, the rest weigh 0 in the combine. (B, S, D) in x's type."""
    b, s, d = x.shape
    K = gate_idx.shape[-1]
    n = _bank_experts(experts["w_gate"])
    local = gate_idx - start
    mine = kept & (local >= 0) & (local < n)
    local = local.clamp(0, n - 1)
    # every pair that is not this call's lands in row ``capacity``, read
    # by no one
    slot = torch.where(mine, pos, torch.full_like(pos, capacity))
    bi = torch.arange(b, device=x.device)[:, None, None].expand(b, s, K)
    si = torch.arange(s, device=x.device)[None, :, None].expand(b, s, K)
    buf = x.new_zeros((n, b, capacity + 1, d))
    buf[local, bi, slot] = x[bi, si]

    out_buf = torch.empty_like(buf)
    for e in range(n):
        xe = buf[e].reshape(-1, d)
        h = (F.silu(xe @ _expert(experts["w_gate"], e, x.dtype))
             * (xe @ _expert(experts["w_up"], e, x.dtype)))
        out_buf[e] = (h @ _expert(experts["w_down"], e, x.dtype)).reshape(
            b, capacity + 1, d)

    # combine: each token's pairs, weighted by their gates (rounded to the
    # activation type, as the JAX combine tensor is), summed in fp32
    w = gate_vals.to(x.dtype).float() * mine
    picked = out_buf[local, bi, slot].float()                    # (B,S,K,D)
    return (w[..., None] * picked).sum(2).to(x.dtype)


def _dispatch(cfg: MoeConfig, x: torch.Tensor, lw: Dict[str, Any],
              token_mask=None, keep_capacity=None, no_drop: bool = False):
    """The capacity-buffer MoE body: (output (B, S, D), probs, kept pairs
    (B, S, K) bool). DTensors run it on each rank's shards
    (:func:`_dispatch_on_mesh`)."""
    if is_dtensor(x):
        return _dispatch_on_mesh(cfg, x, lw, token_mask, keep_capacity, no_drop)
    probs, gate_vals, gate_idx = _route(cfg, x, lw)
    capacity, pos, kept = _positions(cfg, gate_idx, x.shape[1], token_mask,
                                     keep_capacity, no_drop)
    out = _run_experts(x, gate_vals, gate_idx, pos, kept, capacity,
                       lw["experts"])
    return out, probs, kept


# ---------------------------------------------------------------------------
# on a device mesh
# ---------------------------------------------------------------------------

# the F dim of each bank leaf: (E, D, F) for w_gate/w_up, (E, F, D) for w_down
_F_DIM = {"w_gate": 2, "w_up": 2, "w_down": 1}


def _bank_leaves(experts: Dict[str, Any]):
    """The bank's tensors in a fixed order, as (name, key, tensor); key is
    None for a plain leaf and the dict key of a quantized one."""
    out = []
    for name in ("w_gate", "w_up", "w_down"):
        leaf = experts[name]
        if isinstance(leaf, dict):
            out += [(name, k, v) for k, v in sorted(leaf.items())]
        else:
            out.append((name, None, leaf))
    return out


def _rebuild_bank(leaves, tensors) -> Dict[str, Any]:
    bank: Dict[str, Any] = {}
    for (name, key, _), t in zip(leaves, tensors):
        if key is None:
            bank[name] = t
        else:
            bank.setdefault(name, {})[key] = t
    return bank


class _MeshPlan:
    """How the expert FFN runs on each rank's shards, per mesh dim, from the
    placements of the activations (x: ``Shard(0)``, a batch axis, or
    ``Replicate()``) and of the bank's tensors:

    - x sharded on the batch: the bank is whole on that dim (gathered, as
      ``common.linear`` gathers fsdp), the output keeps x's shard, and the
      bank's gradient comes back as a pending sum;
    - the bank sharded on E (``expert``): each rank runs its own range of
      experts over every token of the dim (``expert`` is no batch axis, so
      all its ranks hold the same tokens), and the output is a pending sum;
    - the bank sharded on F (``tensor``): each rank runs its slice of every
      expert's F, and the output is a pending sum;
    - the bank sharded on D (fsdp over a batch too small to shard): it is
      gathered;
    - otherwise everything is whole.

    The expert range is read from the bank's placements, never from the
    mesh: a bank replicated over a live ``expert`` axis (an int8 bank,
    which the rules replicate) runs every expert on every rank, and its
    output is whole there."""

    def __init__(self, x, leaves):
        from torch.distributed.tensor import Partial, Replicate, Shard

        mesh = self.mesh = x.device_mesh
        self.x, self.x_grad, self.route_grad, self.out = [], [], [], []
        self.bank = [[] for _ in leaves]
        self.bank_grad = [[] for _ in leaves]
        e_dims = []
        for i, px in enumerate(x.placements):
            batch = px.is_shard(0)
            kinds = set()
            for j, (name, _, t) in enumerate(leaves):
                p = t.placements[i]
                if batch or not p.is_shard():
                    kind, keep = None, False
                elif p.dim == 0:
                    kind, keep = "E", True
                elif p.dim == _F_DIM[name]:
                    kind, keep = "F", True
                else:
                    kind, keep = None, False
                kinds.add(kind)
                self.bank[j].append(p if keep else Replicate())
                self.bank_grad[j].append(p if keep else
                                         (Partial() if batch else Replicate()))
            if len(kinds) > 1:
                raise ValueError(
                    f"the expert bank is sharded unevenly over mesh axis "
                    f"{mesh.mesh_dim_names[i]!r}: "
                    f"{[t.placements[i] for _, _, t in leaves]}")
            kind = kinds.pop()
            if batch:
                pl, grad, out = Shard(0), Shard(0), Shard(0)
            elif kind is not None:
                pl, grad, out = Replicate(), Partial(), Partial()
                if kind == "E":
                    e_dims.append(i)
            else:
                pl, grad, out = Replicate(), Replicate(), Replicate()
            self.x.append(pl)
            self.x_grad.append(grad)
            self.route_grad.append(Partial() if batch else Replicate())
            self.out.append(out)
        # this rank's block of E, in mesh-dim order (as DTensor cuts a dim
        # that several mesh dims shard)
        coord = mesh.get_coordinate()
        block, ways = 0, 1
        for i in e_dims:
            block = block * mesh.size(i) + coord[i]
            ways *= mesh.size(i)
        self.e_local = _bank_experts(leaves[0][2]) // ways
        self.start = block * self.e_local


def _whole_rows(x: torch.Tensor):
    """x on a mesh with its pending sums reduced, and every dim but the
    batch gathered (the sequence, over ``context``: capacity counts the
    whole sequence, as in JAX). Returns (that x, x's own placements with
    the sums reduced)."""
    from torch.distributed.tensor import Replicate

    own = [Replicate() if p.is_partial() else p for p in x.placements]
    whole = [p if p.is_shard(0) else Replicate() for p in own]
    return x.redistribute(x.device_mesh, whole), own


def _dispatch_on_mesh(cfg: MoeConfig, x, lw, token_mask, keep_capacity,
                      no_drop):
    """:func:`_dispatch` over DTensors: the plan of JAX's shard_map form
    (``kubetorch_tpu/models/moe.py:212-239``) through ``local_map``. Each
    rank routes all of its tokens (the router's softmax and top-k are
    cheap and the same on every rank of a non-batch axis), places every
    pair in the capacity buffers as off a mesh, runs only the experts (and
    the slice of F) its bank shard holds, and one reduction over the axes
    that split the bank rebuilds the output, which then takes x's layout
    again. Two ``local_map`` calls, so each gradient comes back as what it
    is: the router's is whole on every rank of a non-batch axis, the
    gates' and x's through the experts are pending sums there."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    x, own = _whole_rows(x)
    mesh = x.device_mesh
    leaves = _bank_leaves(lw["experts"])
    plan = _MeshPlan(x, leaves)
    masked = token_mask is not None
    if masked:
        if not isinstance(token_mask, DTensor):
            token_mask = replicate_like(token_mask, x)
        token_mask = token_mask.redistribute(mesh, plan.x)
    extra = (token_mask,) if masked else ()
    extra_pl = (plan.x,) if masked else ()

    def route(x, router):
        return _route(cfg, x, {"router": router})

    probs, gate_vals, gate_idx = local_map(
        route, out_placements=(plan.x, plan.x, plan.x),
        in_placements=(plan.x, [Replicate()] * mesh.ndim),
        in_grad_placements=(plan.x, plan.route_grad), device_mesh=mesh,
        redistribute_inputs=True)(x, lw["router"])

    def experts(x, gate_vals, gate_idx, *rest):
        mask = rest[0] if masked else None
        bank = _rebuild_bank(leaves, rest[len(extra):])
        capacity, pos, kept = _positions(cfg, gate_idx, x.shape[1], mask,
                                         keep_capacity, no_drop)
        out = _run_experts(x, gate_vals, gate_idx, pos, kept, capacity, bank,
                           plan.start)
        return out, kept

    tensors = [t for _, _, t in leaves]
    out, kept = local_map(
        experts, out_placements=(plan.out, plan.x),
        in_placements=(plan.x, plan.x, plan.x, *extra_pl, *plan.bank),
        in_grad_placements=(plan.x_grad, plan.x_grad, plan.x, *extra_pl,
                            *plan.bank_grad),
        device_mesh=mesh, redistribute_inputs=True)(
            x, gate_vals, gate_idx, *extra, *tensors)
    # the reduction over the axes that split the bank, then x's own layout
    return out.redistribute(mesh, own), probs, kept


def _aux_sums(probs: torch.Tensor, token_mask=None):
    """The Switch-style aux loss's statistics over (B, S): per expert the
    count of top-1 assignments and the sum of probs, and the count of
    tokens, each with padding left out."""
    top1 = F.one_hot(probs.argmax(-1), probs.shape[-1]).float()
    if token_mask is None:
        count = torch.full((), probs.shape[0] * probs.shape[1],
                           dtype=torch.float32, device=probs.device)
        return top1.sum(dim=(0, 1)), probs.sum(dim=(0, 1)), count
    m = token_mask.float()
    return (torch.einsum("bse,bs->e", top1, m),
            torch.einsum("bse,bs->e", probs, m), m.sum() + 1e-9)


def _aux(cfg: MoeConfig, probs: torch.Tensor, token_mask=None) -> torch.Tensor:
    """E · Σ_e frac_e · mean_prob_e on top-1 assignments. Both means are
    over the whole (B, S) before they multiply (a product of per-shard
    means is another number): on a mesh each rank sums its shard and the
    sums are reduced first."""
    if is_dtensor(probs):
        from torch.distributed.tensor import Partial, Replicate
        from torch.distributed.tensor.experimental import local_map

        mesh = probs.device_mesh
        pl = list(probs.placements)
        args, in_pl = [probs], [pl]
        if token_mask is not None:
            if not is_dtensor(token_mask):
                token_mask = replicate_like(token_mask, probs)
            args.append(token_mask.redistribute(mesh, pl))
            in_pl.append(pl)
        part = [Partial() if p.is_shard(0) else Replicate() for p in pl]
        whole = [Replicate()] * mesh.ndim
        sums = local_map(_aux_sums, out_placements=(part, part, part),
                         in_placements=tuple(in_pl), device_mesh=mesh)(*args)
        top1, prob, count = (t.redistribute(mesh, whole) for t in sums)
    else:
        top1, prob, count = _aux_sums(probs, token_mask)
    return cfg.n_experts * ((top1 / count) * (prob / count)).sum()


class _PSum(torch.autograd.Function):
    """``lax.psum`` inside a shard_map body: the sum over a process group;
    its transpose hands the (replicated) cotangent back unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


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
    overflow (overrides ``keep_capacity``).

    DTensors (a mesh laid out by ``MOE_RULES``) run on each rank's shards
    (:func:`_dispatch_on_mesh`). Inside ``parallel.mesh.shard_map_fn``
    (pipeline stages) pass ``ep_axis``/``tp_axis``, as in JAX: x is the
    local block, the same on every rank of those axes; each rank routes
    all its tokens, runs the experts of its local bank (the range from
    ``axis_index(ep_axis)`` and the local leaf's leading dim, an int8 dict
    leaf's too) and one sum over the two axes rebuilds the output; the aux
    term is the local block's."""
    if ep_axis is not None or tp_axis is not None:
        return _moe_ffn_shard_map(cfg, x, lw, ep_axis, tp_axis, token_mask,
                                  keep_capacity, no_drop)
    out, probs, _ = _dispatch(cfg, x, lw, token_mask, keep_capacity, no_drop)
    return out, _aux(cfg, probs, token_mask)


def _moe_ffn_shard_map(cfg, x, lw, ep_axis, tp_axis, token_mask,
                       keep_capacity, no_drop):
    from ..parallel.mesh import axis_group, axis_index

    probs, gate_vals, gate_idx = _route(cfg, x, lw)
    capacity, pos, kept = _positions(cfg, gate_idx, x.shape[1], token_mask,
                                     keep_capacity, no_drop)
    experts = lw["experts"]
    start = 0
    if ep_axis is not None:
        start = axis_index(ep_axis) * _bank_experts(experts["w_gate"])
    out = _run_experts(x, gate_vals, gate_idx, pos, kept, capacity, experts,
                       start)
    for axis in (ep_axis, tp_axis):
        group = None if axis is None else axis_group(axis)
        if group is not None:
            out = _PSum.apply(out, group)
    return out, _aux(cfg, probs, token_mask)


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
    if is_dtensor(x):
        return _decode_on_mesh(cfg, x, lw)
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


def _decode_on_mesh(cfg: MoeConfig, x, lw):
    """:func:`moe_ffn_decode` over DTensors, on each rank's shards (the
    serving engine's decode; no gradient). The plan is the dispatch's
    (:class:`_MeshPlan`) with every expert on every rank: the engine takes
    the gather only where no live axis splits the bank's E."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    x, own = _whole_rows(x)
    mesh = x.device_mesh
    leaves = _bank_leaves(lw["experts"])
    plan = _MeshPlan(x, leaves)
    if plan.e_local != cfg.n_experts:
        raise ValueError("the decode gather needs every expert on every "
                         "rank; an expert-sharded bank takes the dispatch")

    def body(x, router, *bank):
        return moe_ffn_decode(cfg, x, {"router": router,
                                       "experts": _rebuild_bank(leaves, bank)})

    out = local_map(body, out_placements=plan.out,
                    in_placements=(plan.x, [Replicate()] * mesh.ndim, *plan.bank),
                    device_mesh=mesh, redistribute_inputs=True)(
        x, lw["router"], *(t for _, _, t in leaves))
    return out.redistribute(mesh, own)


def _moe_layer(cfg: MoeConfig, x: torch.Tensor, lw: Dict[str, Any],
               freqs: torch.Tensor):
    """One MoE decoder layer over (B, S, D): (new x, aux). On a mesh the
    projections run through ``common.linear`` and attention on each rank's
    batch and head shard, as Llama's layer."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, lw["attn_norm"], cfg.norm_eps)
    q = linear(h, lw["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = linear(h, lw["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(h, lw["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q, k = apply_rope(q, freqs), apply_rope(k, freqs)
    x = x + linear(attention(q, k, v, cfg._llama_view()).reshape(b, s, -1),
                   lw["wo"])
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
    layer's backward a zero-filled gradient of the whole leaf. On a mesh
    (DTensor params and tokens) the hidden state is pinned to the batch's
    layout after the embedding and after each layer
    (``common.constrain_hidden``)."""
    x = constrain_hidden(params["embed"][tokens].to(cfg.dtype))
    freqs = replicate_like(rope_freqs(cfg, tokens.shape[1], device=tokens.device), x)
    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=tokens.device), x)
    remat = cfg.remat and torch.is_grad_enabled()
    layer = checkpointed(lambda x, lw: _moe_layer(cfg, x, lw, freqs),
                         resolve_remat_policy("dots" if remat else None))
    per_layer = _unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        x, a = layer(x, _layer_of(per_layer, i))
        x = constrain_hidden(x)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(x, params["lm_head"].to(cfg.dtype)).float()
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
