"""Flash-decode: the hand-written CUDA kernel (``csrc/decode_attention.cu``)
that replaces the Pallas kernel
``kubetorch_tpu/ops/decode_attention.py:_make_decode_kernel(quant=False)``,
and its plain version.

One new token per slot attends to that slot's cache rows ``<= pos``. The
kernel reads the engine's (B, S, NKV, Hd) cache slice in place through its
strides and touches only live rows; P rounds to the cache type before the
P.V product, as in the Pallas body. The int8-cache form is not ported yet.

``decode_attention`` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors. ``decode_attention.launches`` counts
kernel launches. It has no gradient (the Pallas kernel has no VJP either):
an input that requires grad under grad mode raises rather than return an
output cut from the graph.
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


def decode_attention_ref(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                         pos: torch.Tensor, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, which is also the engine's einsum decode. As in
    the Pallas body: q and k widen to fp32 for the logits, rows past
    ``pos`` are masked with -1e30, softmax in fp32, P rounds to the cache
    type, and the P.V product accumulates in fp32."""
    b, nh, hd = q.shape
    s, nkv = ck.shape[1], ck.shape[2]
    if scale is None:
        scale = hd ** -0.5
    qg = q.float().reshape(b, nkv, nh // nkv, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * scale
    mask = torch.arange(s, device=q.device)[None, :] <= pos[:, None]   # (B, S)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype).float()
    out = torch.einsum("bkgs,bskh->bkgh", probs, cv.float())
    return out.reshape(b, nh, hd).to(q.dtype)


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.kt_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, ck, cv, pos, scale: float) -> torch.Tensor:
    b, nh, hd = q.shape
    s, nkv = ck.shape[1], ck.shape[2]
    check_dtype_and_head_dim(q.dtype, hd)
    for name, t in (("q", q), ("ck", ck), ("cv", cv)):
        check_cuda_operand(name, t, q.dtype, q.device)
    if pos.device != q.device or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError(f"pos must be a contiguous int32 tensor on {q.device}, "
                         f"got {pos.dtype} on {pos.device}")
    if (nh // nkv) * hd > 2048:
        raise ValueError(f"GQA group {nh // nkv} x head dim {hd} exceeds 2048")
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=q.device)
    strides = strides_arg([q.stride(0), q.stride(1),
                           ck.stride(0), ck.stride(1), ck.stride(2),
                           cv.stride(0), cv.stride(1), cv.stride(2),
                           out.stride(0), out.stride(1)])
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), DTYPE_CODES[q.dtype], b, s, nh, nkv, hd,
                 strides, float(scale), stream)
    raise_on_error("decode_attention", err)
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, NH, Hd); ck/cv: (B, S, NKV, Hd); pos: (B,) int32, the row each
    slot's new token occupies (already written). Returns (B, NH, Hd). CUDA
    tensors go through the kernel (bf16 or fp32, Hd 16, 32, 64 or 128;
    anything else raises), CPU tensors through :func:`decode_attention_ref`."""
    b, nh, hd = q.shape
    if ck.shape != cv.shape or ck.shape[0] != b or ck.shape[3] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} ck {tuple(ck.shape)} "
                         f"cv {tuple(cv.shape)}")
    if nh % ck.shape[2]:
        raise ValueError(f"GQA requires n_kv | n_heads, got {ck.shape[2]}, {nh}")
    if pos.shape != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or ck.requires_grad
                                    or cv.requires_grad):
        raise RuntimeError("decode_attention has no gradient; call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return decode_attention_ref(q, ck, cv, pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, ck, cv, pos, scale)


decode_attention.launches = 0
