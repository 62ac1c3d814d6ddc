"""FlashAttention-2 with its gradient: hand-written CUDA kernels and their
plain versions.

- A1, ``csrc/flash_fwd.cu``: the forward, replacing the Pallas kernel
  ``kubetorch_tpu/ops/attention.py:_fwd_kernel``; it also writes the
  per-row log-sum-exp (LSE) when the backward will need it.
- A2, ``csrc/flash_bwd.cu:kt_flash_bwd_dq``: dQ, replacing
  ``_bwd_dq_kernel``.
- A3, ``csrc/flash_bwd.cu:kt_flash_bwd_dkv``: dK and dV, replacing
  ``_bwd_dkv_kernel``.

A1, A2 and A3 in bf16 at head dim 64 and 128 run on Hopper's tensor
cores (wgmma fed by TMA, ``csrc/sm90.cuh``), with the fp32 P and dS of
the Pallas bodies split into two bf16 halves; every other (dtype, head dim)
runs the fp32-FMA bodies. :func:`tensor_core_body` says which, from the
same predicate the C dispatch reads. TMA needs each operand's base address
and leading strides in multiples of 16 bytes; the wrappers raise, naming
the tensor, on one that is not.

The public layout is the JAX package's, q (B, S, N, Hd) and k/v
(B, S, NKV, Hd) with NKV | N; the kernels read them in place through their
strides, with no head-major copy. LSE and delta are fp32 (B, N, S).

``flash_attention`` is differentiable: when grad mode is on and an input
requires grad it runs a ``torch.autograd.Function`` whose forward writes
the LSE and keeps (q, k, v, out, LSE) as residuals, as the JAX VJP does,
and whose backward computes delta = rowsum(dO * O) with a plain tensor op
and launches A2 and A3. Otherwise the forward writes no LSE. CUDA tensors
go through the kernels; only CPU tensors take the plain versions.
Launches are counted on ``flash_attention.launches`` (A1),
``flash_attention.bwd_dq_launches`` (A2) and
``flash_attention.bwd_dkv_launches`` (A3).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ._kernel_args import (DTYPE_CODES, check_cuda_operand,
                           check_dtype_and_head_dim, raise_on_error,
                           strides_arg)

NEG_INF = -1e30


def _grouped_logits(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 logits (B, NKV, G, S, T), masked entries -1e30."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.float().reshape(b, s, nkv, nh // nkv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of A1: the Pallas body's math in one pass. q, k and
    v widen to fp32, both products run in fp32 (P is not rounded), masked
    logits are -1e30. Returns q's dtype."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale,
                                   need_lse=False)[0]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True,
                            scale: Optional[float] = None,
                            need_lse: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of A1 with its LSE: (out, lse), lse = m + log(l)
    per row in fp32 (B, N, S), or None without ``need_lse``."""
    b, s, nh, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    logits = _grouped_logits(q, k, causal, scale)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    out = out.reshape(b, s, nh, hd).to(q.dtype)
    lse = torch.logsumexp(logits, dim=-1).reshape(b, nh, s) if need_lse else None
    return out, lse


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, N, S): the softmax-gradient term
    the backward kernels take as input (JAX ``_bwd``, ``attention.py:239``)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_terms(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """P, dS (B, NKV, G, S, T) and the grouped fp32 dO, as the Pallas bodies
    recompute them: P = exp(s * scale - LSE), dS = P * (dP - delta) * scale."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    logits = _grouped_logits(q, k, causal, scale)
    p = torch.exp(logits - lse.reshape(b, nkv, g, s, 1))
    dog = dout.float().reshape(b, s, nkv, g, hd)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v.float())
    ds = p * (dp - delta.reshape(b, nkv, g, s, 1)) * scale
    return p, ds, dog


def flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta, *, causal: bool = True,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of A2: dQ = dS.K in fp32, returned in q's dtype."""
    b, s, nh, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    _, ds, _ = _bwd_terms(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float())
    return dq.reshape(b, s, nh, hd).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta, *, causal: bool = True,
                                scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of A3: dK = dS^T.Q and dV = P^T.dO in fp32, summed
    over each kv-head's GQA group, returned in k's and v's dtypes."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    p, ds, dog = _bwd_terms(q, k, v, dout, lse, delta, causal, scale)
    qg = q.float().reshape(b, s, nkv, nh // nkv, hd)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            scale: Optional[float] = None):
    """The plain backward in one pass: delta from the stored ``out`` in fp32,
    then A2's and A3's math. Returns (dq, dk, dv)."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    delta = attention_delta(out, dout)
    p, ds, dog = _bwd_terms(q, k, v, dout, lse, delta, causal, scale)
    qg = q.float().reshape(b, s, nkv, nh // nkv, hd)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float()).reshape(b, s, nh, hd)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _fn(lib_name: str, sym: str, n_ptrs: int):
    fn = getattr(_build.load(lib_name), sym)
    if fn.argtypes is None:
        # pointers, then dtype B S N NKV HD, strides, scale, causal, stream
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def tensor_core_body(kernel: str, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether A1 (``kernel="fwd"``), A2 (``"dq"``) or A3 (``"dkv"``) runs
    its tensor-core body at this dtype and head dim (else its fp32-FMA
    body). Loads the library."""
    lib_name, sym = {"fwd": ("flash_fwd", "kt_flash_fwd_body"),
                     "dq": ("flash_bwd", "kt_flash_bwd_dq_body"),
                     "dkv": ("flash_bwd", "kt_flash_bwd_dkv_body")}[kernel]
    fn = getattr(_build.load(lib_name), sym)
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return bool(fn(DTYPE_CODES[dtype], head_dim))


def _check_operands(q, k, v, **more) -> None:
    check_dtype_and_head_dim(q.dtype, q.shape[3])
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        check_cuda_operand(name, t, q.dtype, q.device)


def _check_stats(q, **stats) -> None:
    b, s, nh, _ = q.shape
    for name, t in stats.items():
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (b, nh, s) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 ({b}, {nh}, {s}) "
                             f"tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _bhs_strides(*ts):
    return strides_arg([st for t in ts for st in t.stride()[:3]])


def _call(fn, kernel: str, q, k, ptrs, strides, causal: bool, scale: float):
    b, s, nh, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, DTYPE_CODES[q.dtype], b, s, nh, k.shape[2], hd, strides,
                 float(scale), int(causal), stream)
    raise_on_error(kernel, err)


def _launch(q, k, v, causal: bool, scale: float, need_lse: bool = False):
    """A1 on the card: (out, lse or None)."""
    b, s, nh, hd = q.shape
    _check_operands(q, k, v)
    out = torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
           if need_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if need_lse else None)
    _call(_fn("flash_fwd", "kt_flash_fwd", 5), "flash_fwd", q, k, ptrs,
          _bhs_strides(q, k, v, out), causal, scale)
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """A2: dQ (q's shape and dtype). CUDA tensors launch the kernel, CPU
    tensors take :func:`flash_attention_bwd_dq_ref`."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta,
                                          causal=causal, scale=scale)
    _check_operands(q, k, v, dout=dout)
    _check_stats(q, lse=lse, delta=delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    _call(_fn("flash_bwd", "kt_flash_bwd_dq", 7), "flash_bwd_dq", q, k, ptrs,
          _bhs_strides(q, k, v, dout, dq), causal, scale)
    flash_attention.bwd_dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A3: (dK, dV) in k's and v's shape and dtype. CUDA tensors launch the
    kernel, CPU tensors take :func:`flash_attention_bwd_dkv_ref`."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta,
                                           causal=causal, scale=scale)
    _check_operands(q, k, v, dout=dout)
    _check_stats(q, lse=lse, delta=delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    _call(_fn("flash_bwd", "kt_flash_bwd_dkv", 8), "flash_bwd_dkv", q, k, ptrs,
          _bhs_strides(q, k, v, dout, dk, dv), causal, scale)
    flash_attention.bwd_dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: the forward keeps
    (q, k, v, out, LSE), the backward is A2 and A3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale)
        else:
            out, lse = _launch(q, k, v, causal, scale, need_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                 causal=ctx.causal, scale=ctx.scale)
            return dq, dk, dv, None, None
        dout = dout.contiguous()   # autograd may hand over an expanded grad
        delta = attention_delta(out, dout)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise attention. q: (B, S, N, Hd); k, v: (B, S, NKV, Hd), NKV | N.
    Returns (B, S, N, Hd) in q's dtype, differentiable in q, k and v. CUDA
    tensors go through the kernels (bf16 or fp32, Hd 16, 32, 64 or 128;
    anything else raises), CPU tensors through the plain versions."""
    b, s, nh, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if nh % k.shape[2]:
        raise ValueError(f"GQA requires n_kv | n_heads, got {k.shape[2]}, {nh}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if scale is None:
        scale = hd ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, scale)[0]


flash_attention.launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0
