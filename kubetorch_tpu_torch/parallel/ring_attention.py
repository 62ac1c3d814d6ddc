"""Ring attention: context-parallel causal attention, the counterpart of
``kubetorch_tpu/parallel/ring_attention.py``.

The sequence is sharded over the ``context`` mesh axis. Each rank holds a
local q/k/v chunk; the K/V chunks rotate around the ring (rank i sends to
i + 1) by point-to-point transfers on the context axis's process group,
and each rank merges every incoming chunk into its local output with the
online-softmax recurrence, so no rank ever holds more than 1/C of K and V.

The rotation is a ``torch.autograd.Function`` (:class:`_RingShift`) whose
backward rotates the gradients the other way, so autograd through the
per-chunk math gives the full attention's gradients, as JAX's transpose of
``ppermute`` does. The per-chunk math is the JAX package's fp32 block
attention (:func:`_chunk_attention`), not a kernel.

Two entry points, as in JAX:

- :func:`ring_attention`: the per-shard function, for a body already run
  over the mesh (``mesh.shard_map_fn``, or ``attn_impl="ring_local"``);
- :func:`ring_attention_sharded`: takes global tensors (DTensors, or plain
  tensors equal on every rank) and runs the ring over the context axis.
  With no live context axis it falls back as JAX does: the flash kernels
  on CUDA, the plain attention on the CPU.

Context-parallel decode (``sp_decode_attention*``), as in JAX: each rank
attends to its shard of the cache through the partial mode of the
flash-decode kernels (B1/B2, ``ops.decode_attention``; their plain versions
on the CPU) and the shards combine in one online-softmax reduction (an
all-reduce MAX, then one all-reduce SUM). The serving engine takes it on a
mesh with a live context axis (``serve.engine``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

NEG_INF = -1e30


def _chunk_attention(q, k, v, scale, q_offset, kv_offset, causal):
    """fp32 blockwise attention of a local q chunk vs one roving kv chunk:
    (m, l, unnormalized acc) for online-softmax merging. q: (B, Sq, N, Hd);
    k, v: (B, Sk, NKV, Hd); offsets are global positions."""
    b, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    qg = q.reshape(b, sq, nkv, group, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = kv_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                          # (b,k,g,s,1)
    # fully masked rows (future-only chunks): clamp m so p underflows to 0
    m_safe = torch.clamp(m, min=-1e29)
    p = torch.exp(s - m_safe)
    p = torch.where(s <= NEG_INF, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)                           # (b,k,g,s,1)
    acc = torch.einsum("bkgst,btkh->bkgsh", p.to(v.dtype), v).float()
    return m_safe, l, acc


def _shift(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to group rank ``to``, receive the same shape from ``frm``."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One step of the ring: rank i's (k, v) go to rank i + 1. The backward
    sends each gradient back to where its chunk came from (rank i - 1)."""

    @staticmethod
    def forward(ctx, k, v, group, me: int, ring: int):
        ctx.group, ctx.me, ctx.ring = group, me, ring
        nxt, prv = (me + 1) % ring, (me - 1) % ring
        return _shift(k, group, nxt, prv), _shift(v, group, nxt, prv)

    @staticmethod
    def backward(ctx, dk, dv):
        nxt, prv = (ctx.me + 1) % ctx.ring, (ctx.me - 1) % ctx.ring
        return (_shift(dk, ctx.group, prv, nxt), _shift(dv, ctx.group, prv, nxt),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "context", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Per-shard ring attention. Shapes are LOCAL: (B, S/C, N, Hd). Runs
    with a mesh installed (``use_mesh``, or a ``shard_map_fn`` body) that
    binds ``axis_name``; a dead axis is a ring of one."""
    from .mesh import axis_group, axis_index, lax_axis_size

    b, sq, nh, hd = q.shape
    nkv = k.shape[2]
    group_size = nh // nkv
    if scale is None:
        scale = hd ** -0.5
    ring = lax_axis_size(axis_name)
    my = axis_index(axis_name)
    group = axis_group(axis_name)
    q_offset = my * sq

    shape = (b, nkv, group_size, sq, 1)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nkv, group_size, sq, hd), dtype=torch.float32,
                      device=q.device)
    k_cur, v_cur = k, v
    for step in range(ring):
        src = (my - step) % ring                 # origin rank of k_cur
        m_c, l_c, acc_c = _chunk_attention(q, k_cur, v_cur, scale, q_offset,
                                           src * k_cur.shape[1], causal)
        m_new = torch.maximum(m, m_c)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_c - m_new)
        l = l * alpha + l_c * beta
        acc = acc * alpha + acc_c * beta
        m = m_new
        if step + 1 < ring:   # JAX's last rotation is discarded; skip it
            k_cur, v_cur = _RingShift.apply(k_cur, v_cur, group, my, ring)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).to(q.dtype)                  # (b, nkv, group, sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, nh, hd)


def dense_attention(q, k, v, causal: bool, scale: Optional[float]):
    """Attention with no context axis: the flash kernels on CUDA (DTensors
    through ``local_map``), the plain attention on the CPU."""
    scale = scale or q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        from ..ops.attention import flash_attention
        return flash_attention(q, k, v, causal=causal, scale=scale)
    from ..models.llama import _xla_attention
    return _xla_attention(q, k, v, scale, causal=causal)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh, *, causal: bool = True,
                           scale: Optional[float] = None,
                           batch_axes=("dcn", "data", "fsdp"),
                           context_axis: str = "context",
                           head_axis: str = "tensor") -> torch.Tensor:
    """q/k/v are global (B, S, N, Hd) tensors: DTensors on ``mesh`` (any
    placements; they are redistributed to batch × context × heads) or plain
    tensors equal on every rank (cut to the local shard; the output is
    gathered back to a plain tensor). Runs the ring per context shard."""
    from .mesh import (PartitionSpec, live_axes, normalize_batch_axes,
                       shard_map_fn)

    live = live_axes(mesh)
    if context_axis not in live:
        return dense_attention(q, k, v, causal, scale)
    ba = normalize_batch_axes(live, batch_axes)
    ha = head_axis if head_axis in live else None
    spec = PartitionSpec(ba, context_axis, ha, None)
    fn = functools.partial(ring_attention, axis_name=context_axis,
                           causal=causal, scale=scale)
    return shard_map_fn()(fn, mesh=mesh, in_specs=(spec, spec, spec),
                          out_specs=spec)(q, k, v)


# ---------------------------------------------------------------------------
# context-parallel decode: one new token per slot against a cache whose
# sequence axis is sharded over the context mesh axis (long-context serving)
# ---------------------------------------------------------------------------


def _combine(m, l, acc, axis_name: str, dtype) -> torch.Tensor:
    """One online-softmax reduction of the shards' partials over the
    ``axis_name`` group: all-reduce MAX of m, corr = exp(m - m_g), one
    all-reduce SUM of l·corr and acc·corr together, then the division
    (l_g == 0 → 1). m, l (B, NH), acc (B, NH, Hd) fp32; the result is in
    ``dtype``. Every rank of the group gets the same bits."""
    import torch.distributed as dist

    from .mesh import axis_group

    group = axis_group(axis_name)
    m_g = m.clone()
    if group is not None:
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    la = torch.cat([(l * corr)[..., None], acc * corr[..., None]], dim=-1)
    if group is not None:
        dist.all_reduce(la, op=dist.ReduceOp.SUM, group=group)
    l_g, acc_g = la[..., 0], la[..., 1:]
    return (acc_g / torch.where(l_g == 0.0, 1.0, l_g)[..., None]).to(dtype)


def sp_decode_attention(q, ck, cv, pos, *, axis_name: str,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Per-shard body: decode attention over this rank's cache rows, then
    one online-softmax combine across the context axis: the full-sequence
    result with no rank holding more than 1/C of the cache.

    q (B, NH, Hd) replicated over ``axis_name``; ck/cv (B, S_local, NKV,
    Hd) this shard's rows; pos (B,) int32, the global frontier per slot.
    The shard's partials come from the partial mode of the flash-decode
    kernel (B1, ``ops.decode_attention.decode_attention_partial``) on
    CUDA and from its plain version on the CPU. Runs with a mesh installed
    that binds ``axis_name``."""
    from ..ops.decode_attention import decode_attention_partial
    from .mesh import axis_index

    offset = axis_index(axis_name) * ck.shape[1]
    m, l, acc = decode_attention_partial(q, ck, cv, pos, offset, scale=scale)
    return _combine(m, l, acc, axis_name, q.dtype)


def sp_decode_attention_quant(q, kq, ks, vq, vs, pos, *, axis_name: str,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Per-shard body over an int8 cache shard (``serve.kv_quant``): the
    partial mode of B2 (``decode_attention_quant_partial``), row scales
    folded in, then the same combine as :func:`sp_decode_attention`: the
    int8 cache and context sharding compose."""
    from ..ops.decode_attention import decode_attention_quant_partial
    from .mesh import axis_index

    offset = axis_index(axis_name) * kq.shape[1]
    m, l, acc = decode_attention_quant_partial(q, kq, ks, vq, vs, pos, offset,
                                               scale=scale)
    return _combine(m, l, acc, axis_name, q.dtype)


def window_attention_partial(q, layer, posm, offset: int, s_eff: int,
                             scale: float):
    """The speculative engine's window attention (``serve.spec_engine.
    _window_attend``'s math) over one shard of cache rows, un-normalised:
    q (B, W, NH, Hd) at global positions ``posm`` (B, W); ``layer`` the
    shard's rows of one layer, ``(ck, cv)`` (B, S_local, NKV, Hd) or the
    int8 ``(kq, ks, vq, vs)`` with row scales (B, S_local, NKV), whose
    first row is the global row ``offset``. Rows at or past ``s_eff`` and
    rows past each query's position are masked (-1e30). Returns m, l (B,
    W, NH) and acc (B, W, NH, Hd), fp32, with m the row max clamped at
    -1e29: a query with no live row in the shard gets m = -1e29, l = 0,
    acc = 0, as the partial mode of B1/B2 does. The int8 rows fold ``ks``
    into the logits and ``vs`` into P (l is summed before ``vs``); bf16
    rows take the logits in the cache type, as the whole-cache version
    does, and P rounded to it before an fp32 P·V."""
    b, w, nh, hd = q.shape
    nkv = layer[0].shape[2]
    n = max(0, min(layer[0].shape[1], s_eff - offset))
    if n == 0:
        return (q.new_full((b, w, nh), -1e29, dtype=torch.float32),
                q.new_zeros((b, w, nh), dtype=torch.float32),
                q.new_zeros((b, w, nh, hd), dtype=torch.float32))
    qg = q.reshape(b, w, nkv, nh // nkv, hd)
    if len(layer) == 4:
        kq, ks, vq, vs = (t[:, :n] for t in layer)
        s = torch.einsum("bwkgh,bskh->bwkgs", qg.float(), kq.float()) * scale
        s = s * ks.transpose(1, 2)[:, None, :, None, :]
        vsc = vs.transpose(1, 2)[:, None, :, None, :]

        def pv(p):
            return torch.einsum("bwkgs,bskh->bwkgh", p * vsc, vq.float())
    else:
        ck, cv = (t[:, :n] for t in layer)
        s = torch.einsum("bwkgh,bskh->bwkgs", qg, ck).float() * scale

        def pv(p):
            return torch.einsum("bwkgs,bskh->bwkgh", p.to(cv.dtype).float(),
                                cv.float())
    cols = offset + torch.arange(n, device=q.device)
    live = cols[None, None, :] <= posm[:, :, None]                # (B, W, n)
    s = s.masked_fill(~live[:, :, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e29)
    p = torch.exp(s - m).masked_fill(s <= NEG_INF, 0.0)
    return (m.reshape(b, w, nh), p.sum(dim=-1).reshape(b, w, nh),
            pv(p).reshape(b, w, nh, hd))


def sp_window_attention(q, layer, posm, *, axis_name: str, s_eff: int,
                        scale: float, dtype) -> torch.Tensor:
    """Per-shard body of the window attention on a context-sharded grid:
    :func:`window_attention_partial` over this rank's rows, from its
    offset along ``axis_name``, then the one online-softmax combine of
    the decode path (:func:`_combine`: one all-reduce MAX, one SUM).
    Returns (B, W, NH, Hd) in ``dtype``, the same bits on every rank of
    the axis. Runs with a mesh installed that binds ``axis_name``."""
    from .mesh import axis_index

    offset = axis_index(axis_name) * layer[0].shape[1]
    m, l, acc = window_attention_partial(q, layer, posm, offset, s_eff, scale)
    return _combine(m, l, acc, axis_name, dtype)


def _sp_decode_specs(mesh, batch_axes, context_axis, head_axis):
    """(q_spec, kv_spec, scale_spec, pos_spec) of the decode bodies, JAX's
    layouts: one function so the fp and quant wrappers cannot drift."""
    from .mesh import PartitionSpec as P
    from .mesh import live_axes, normalize_batch_axes

    live = live_axes(mesh)
    if context_axis not in live:
        raise ValueError("sp decode requires a live "
                         f"{context_axis!r} mesh axis (callers gate on it "
                         "via sp_decode_supported)")
    ba = normalize_batch_axes(live, batch_axes)
    ha = head_axis if head_axis in live else None
    return (P(ba, ha, None), P(ba, context_axis, ha, None),
            P(ba, context_axis, ha), P(ba))


def sp_decode_supported(mesh, b: int, s: int, nkv: int, nh: int, *,
                        batch_axes=("dcn", "data", "fsdp"),
                        context_axis: str = "context",
                        head_axis: str = "tensor") -> bool:
    """Can the sp decode path partition these shapes evenly? Every named
    dim must divide by its axis, as for JAX's ``shard_map``; when this says
    no, callers take the dense path (correct, without the memory split)."""
    import math

    from .mesh import live_axes

    live = live_axes(mesh)
    if live.get(context_axis, 1) <= 1:
        return False
    if s % live[context_axis]:
        return False
    if b % math.prod(live.get(a, 1) for a in batch_axes):
        return False
    hsz = live.get(head_axis, 1)
    return nkv % hsz == 0 and nh % hsz == 0


def sp_decode_attention_sharded(q, ck, cv, pos, mesh, *,
                                scale: Optional[float] = None,
                                batch_axes=("dcn", "data", "fsdp"),
                                context_axis: str = "context",
                                head_axis: str = "tensor") -> torch.Tensor:
    """The engine's decode attention over global tensors: cache (B, S, NKV,
    Hd) sharded batch × context × heads, q (B, NH, Hd) batch × heads, pos
    (B,) batch, as DTensors (redistributed to those layouts, a no-op when
    they hold them) or plain tensors equal on every rank. Callers gate on
    :func:`sp_decode_supported`."""
    from .mesh import shard_map_fn

    q_spec, kv_spec, _, pos_spec = _sp_decode_specs(
        mesh, batch_axes, context_axis, head_axis)
    fn = functools.partial(sp_decode_attention, axis_name=context_axis,
                           scale=scale)
    return shard_map_fn()(fn, mesh=mesh,
                          in_specs=(q_spec, kv_spec, kv_spec, pos_spec),
                          out_specs=q_spec)(q, ck, cv, pos)


def sp_decode_attention_quant_sharded(q, kq, ks, vq, vs, pos, mesh, *,
                                      scale: Optional[float] = None,
                                      batch_axes=("dcn", "data", "fsdp"),
                                      context_axis: str = "context",
                                      head_axis: str = "tensor") -> torch.Tensor:
    """int8-cache variant of :func:`sp_decode_attention_sharded`: values
    int8 (B, S, NKV, Hd) and row scales (B, S, NKV), both sharded over
    batch × context × heads."""
    from .mesh import shard_map_fn

    q_spec, kv_spec, sc_spec, pos_spec = _sp_decode_specs(
        mesh, batch_axes, context_axis, head_axis)
    fn = functools.partial(sp_decode_attention_quant, axis_name=context_axis,
                           scale=scale)
    return shard_map_fn()(
        fn, mesh=mesh,
        in_specs=(q_spec, kv_spec, sc_spec, kv_spec, sc_spec, pos_spec),
        out_specs=q_spec)(q, kq, ks, vq, vs, pos)
