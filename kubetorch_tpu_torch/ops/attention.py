"""FlashAttention-2 forward: the hand-written CUDA kernel
(``csrc/flash_fwd.cu``) that replaces the Pallas kernel
``kubetorch_tpu/ops/attention.py:_fwd_kernel``, and its plain version.

Inference only: the backward kernels (dQ, dK/dV) and the autograd wrapper
come with training. The public layout is the JAX package's, q (B, S, N, Hd)
and k/v (B, S, NKV, Hd) with NKV | N; the kernel reads them in place
through their strides, with no head-major copy.

``flash_attention`` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors. ``flash_attention.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._kernel_args import (DTYPE_CODES, check_cuda_operand,
                           check_dtype_and_head_dim, raise_on_error,
                           strides_arg)

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: the Pallas body's math in one pass. q, k and v
    widen to fp32, both products run in fp32 (P is not rounded), masked
    logits are -1e30. Returns q's dtype."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if scale is None:
        scale = hd ** -0.5
    qg = q.float().reshape(b, s, nkv, nh // nkv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, nh, hd).to(q.dtype)


def _lib():
    lib = _build.load("flash_fwd")
    fn = lib.kt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    check_dtype_and_head_dim(q.dtype, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q.dtype, q.device)
    out = torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device)
    strides = strides_arg([q.stride(0), q.stride(1), q.stride(2),
                           k.stride(0), k.stride(1), k.stride(2),
                           v.stride(0), v.stride(1), v.stride(2),
                           out.stride(0), out.stride(1), out.stride(2)])
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPE_CODES[q.dtype], b, s, nh, nkv, hd, strides,
                 float(scale), int(causal), stream)
    raise_on_error("flash_fwd", err)
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise attention. q: (B, S, N, Hd); k, v: (B, S, NKV, Hd), NKV | N.
    Returns (B, S, N, Hd) in q's dtype. CUDA tensors go through the kernel
    (bf16 or fp32, Hd 16, 32, 64 or 128; anything else raises), CPU
    tensors through :func:`flash_attention_ref`."""
    b, s, nh, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if nh % k.shape[2]:
        raise ValueError(f"GQA requires n_kv | n_heads, got {k.shape[2]}, {nh}")
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, causal, scale)


flash_attention.launches = 0
