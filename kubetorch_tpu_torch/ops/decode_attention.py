"""Flash-decode: the hand-written CUDA kernel (``csrc/decode_attention.cu``)
that replaces the Pallas kernel
``kubetorch_tpu/ops/decode_attention.py:_make_decode_kernel``, in both of
its cache layouts, and their plain versions.

One new token per slot attends to that slot's cache rows ``<= pos``. The
kernel reads the engine's (B, S, NKV, Hd) cache slice in place through its
strides and touches only live rows.

- ``decode_attention`` (B1): a bf16/fp32 cache; P rounds to the cache type
  before the P.V product, as in the Pallas body.
- ``decode_attention_quant`` (B2): an int8 cache with one fp32 scale per
  row and head (``serve.kv_quant``); the scales fold into the math (logit
  columns times ``ks``, probabilities times ``vs``), all in fp32, and the
  output is in q's type.

Both are one kernel body in the CUDA source, as in the Pallas file. bf16 q
at head dim 64 or 128 (GQA group <= 16) takes the split tensor-core body:
the cache is cut into runs of whole 64-row tiles, one block each, and a
log-sum-exp pass combines them. ``decode_split_plan`` picks the run length
from (B, NKV, S) alone, so the grid never depends on ``pos``, and
``decode_attention_body`` says which body a call takes. Each wrapper launches the kernel for CUDA tensors
and uses its plain version only for CPU tensors;
``decode_attention.launches`` and ``decode_attention_quant.launches`` count
wrapper calls that launched it (one each, also where the combine pass
follows). Neither has a gradient (the Pallas kernel has no VJP either): an
input that requires grad under grad mode raises rather than return an
output cut from the graph.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._kernel_args import (DTYPE_CODES, check_cuda_operand,
                           check_dtype_and_head_dim, raise_on_error,
                           strides_arg)

NEG_INF = -1e30
# the split body: cache rows per tile, the blocks a full cache should give
# (four per SM of an H100's 132, so a ragged batch's long slots spread over
# the card), and the fewest tiles a run holds: four, so that a block's
# 2-stage ring overlaps loads with products and the combine reads few
# partials (on an H100, 4-tile runs beat 2- and 8-tile runs on a ragged
# 8 x 2048 grid and on one 8192-row request: PERF.md)
DECODE_TILE = 64
DECODE_TARGET_BLOCKS = 4 * 132
DECODE_MIN_SPLIT_TILES = 4


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


def decode_attention_quant_ref(q: torch.Tensor, kq: torch.Tensor,
                               ks: torch.Tensor, vq: torch.Tensor,
                               vs: torch.Tensor, pos: torch.Tensor, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, which is also the engine's ``xla`` branch: the
    fold-in einsum of the JAX engine's ``_decode_layer_quant``. Logits are
    fp32 q against int8 K widened to fp32, times ``scale`` and then the K
    row scale; rows past ``pos`` masked with -1e30; softmax in fp32;
    probabilities times the V row scale meet int8 V widened to fp32. The
    output is in q's type."""
    b, nh, hd = q.shape
    s, nkv = kq.shape[1], kq.shape[2]
    if scale is None:
        scale = hd ** -0.5
    qg = q.float().reshape(b, nkv, nh // nkv, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, kq.float()) * scale
    logits = logits * ks.transpose(1, 2)[:, :, None, :]
    mask = torch.arange(s, device=q.device)[None, :] <= pos[:, None]   # (B, S)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1) * vs.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgs,bskh->bkgh", probs, vq.float())
    return out.reshape(b, nh, hd).to(q.dtype)


def decode_split_plan(b: int, nkv: int, s: int) -> int:
    """Rows per split of the split body at (B, NKV, S): a whole number of
    64-row tiles, at least ``DECODE_MIN_SPLIT_TILES`` and otherwise short
    enough that a full cache gives about ``DECODE_TARGET_BLOCKS`` blocks of
    (split, kv-head, slot), never longer than the cache. Pure host
    arithmetic on the shapes: the positions never enter, so the grid is the
    same on every decode step (a CUDA graph of the step replays it)."""
    tiles = -(-s // DECODE_TILE)
    per_pair = -(-DECODE_TARGET_BLOCKS // max(1, b * nkv))
    per_split = max(DECODE_MIN_SPLIT_TILES, -(-tiles // per_pair))
    return min(per_split, tiles) * DECODE_TILE


@functools.lru_cache(maxsize=None)
def decode_attention_body(dtype: torch.dtype, hd: int, nh: int,
                          nkv: int) -> str:
    """Which body of the kernel a call takes: "split" (the cache split
    across blocks, mma.sync, a combine pass) or "fma" (one block per
    kv-head and slot, fp32 FMA loops). The same for B1 and B2. Loads the
    library and asks it, so the answer is the dispatch's own; kept per
    (dtype, hd, nh, nkv), since each decode step asks once a layer."""
    fn = _build.load("decode_attention").kt_decode_attention_body
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return ("fma", "split")[fn(DTYPE_CODES[dtype], hd, nh, nkv)]


def _work(q: torch.Tensor, s: int, nkv: int):
    """(split_rows, partial buffer or None) for a launch: the buffer holds
    each split's acc (Hd values) and (m, l) for every query row, fp32, from
    the caching allocator, as B3's split buffer is."""
    b, nh, hd = q.shape
    split_rows = decode_split_plan(b, nkv, s)
    splits = -(-s // split_rows)
    if splits == 1 or decode_attention_body(q.dtype, hd, nh, nkv) != "split":
        return split_rows, None
    return split_rows, torch.empty(splits * b * nh * (hd + 2),
                                   dtype=torch.float32, device=q.device)


def _fn(name: str, argtypes):
    fn = getattr(_build.load("decode_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return _fn("kt_decode_attention",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
               + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p])


def _lib_quant():
    return _fn("kt_decode_attention_quant",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
               + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p])


def _check_pos(pos: torch.Tensor, device: torch.device) -> None:
    if pos.device != device or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError(f"pos must be a contiguous int32 tensor on {device}, "
                         f"got {pos.dtype} on {pos.device}")


def _check_group(nh: int, nkv: int, hd: int) -> None:
    if (nh // nkv) * hd > 2048:
        raise ValueError(f"GQA group {nh // nkv} x head dim {hd} exceeds 2048")


def _launch(q, ck, cv, pos, scale: float) -> torch.Tensor:
    b, nh, hd = q.shape
    s, nkv = ck.shape[1], ck.shape[2]
    check_dtype_and_head_dim(q.dtype, hd)
    for name, t in (("q", q), ("ck", ck), ("cv", cv)):
        check_cuda_operand(name, t, q.dtype, q.device)
    _check_pos(pos, q.device)
    _check_group(nh, nkv, hd)
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=q.device)
    strides = strides_arg([q.stride(0), q.stride(1),
                           ck.stride(0), ck.stride(1), ck.stride(2),
                           cv.stride(0), cv.stride(1), cv.stride(2),
                           out.stride(0), out.stride(1)])
    fn = _lib()
    split_rows, work = _work(q, s, nkv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), DTYPE_CODES[q.dtype], b, s, nh, nkv, hd,
                 strides, float(scale), split_rows,
                 None if work is None else work.data_ptr(), stream)
    raise_on_error("decode_attention", err)
    decode_attention.launches += 1
    return out


def _check_call(name: str, q, ck, cv, pos, *tensors) -> None:
    """Shapes, GQA and the no-gradient rule, for both wrappers."""
    b, nh, hd = q.shape
    if ck.shape != cv.shape or ck.shape[0] != b or ck.shape[3] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} cache "
                         f"{tuple(ck.shape)} / {tuple(cv.shape)}")
    if nh % ck.shape[2]:
        raise ValueError(f"GQA requires n_kv | n_heads, got {ck.shape[2]}, {nh}")
    if pos.shape != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, ck, cv, *tensors)):
        raise RuntimeError(f"{name} has no gradient; call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, NH, Hd); ck/cv: (B, S, NKV, Hd); pos: (B,) int32, the row each
    slot's new token occupies (already written). Returns (B, NH, Hd). CUDA
    tensors go through the kernel (bf16 or fp32, Hd 16, 32, 64 or 128;
    anything else raises), CPU tensors through :func:`decode_attention_ref`."""
    _check_call("decode_attention", q, ck, cv, pos)
    if scale is None:
        scale = q.shape[2] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_ref(q, ck, cv, pos, scale=scale)
    return _launch(q, ck, cv, pos, scale)


decode_attention.launches = 0


def _launch_quant(q, kq, ks, vq, vs, pos, scale: float) -> torch.Tensor:
    b, nh, hd = q.shape
    s, nkv = kq.shape[1], kq.shape[2]
    check_dtype_and_head_dim(q.dtype, hd)
    check_cuda_operand("q", q, q.dtype, q.device)
    for name, t in (("kq", kq), ("vq", vq)):
        check_cuda_operand(name, t, torch.int8, q.device)
    for name, t in (("ks", ks), ("vs", vs)):
        if t.device != q.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {q.device}, got "
                            f"{t.dtype} on {t.device}")
    _check_pos(pos, q.device)
    _check_group(nh, nkv, hd)
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=q.device)
    strides = strides_arg([q.stride(0), q.stride(1),
                           kq.stride(0), kq.stride(1), kq.stride(2),
                           vq.stride(0), vq.stride(1), vq.stride(2),
                           out.stride(0), out.stride(1),
                           ks.stride(0), ks.stride(1), ks.stride(2),
                           vs.stride(0), vs.stride(1), vs.stride(2)])
    fn = _lib_quant()
    split_rows, work = _work(q, s, nkv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
                 vs.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 DTYPE_CODES[q.dtype], b, s, nh, nkv, hd, strides,
                 float(scale), split_rows,
                 None if work is None else work.data_ptr(), stream)
    raise_on_error("decode_attention_quant", err)
    decode_attention_quant.launches += 1
    return out


def decode_attention_quant(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                           vq: torch.Tensor, vs: torch.Tensor,
                           pos: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Flash-decode over an int8 cache. q: (B, NH, Hd) bf16 or fp32;
    kq/vq: (B, S, NKV, Hd) int8; ks/vs: (B, S, NKV) fp32 row scales; pos:
    (B,) int32. Returns (B, NH, Hd) in q's type. CUDA tensors go through
    the kernel (Hd 16, 32, 64 or 128; anything else raises), CPU tensors
    through :func:`decode_attention_quant_ref`."""
    _check_call("decode_attention_quant", q, kq, vq, pos, ks, vs)
    if ks.shape != kq.shape[:3] or vs.shape != vq.shape[:3]:
        raise ValueError(f"scales must be {tuple(kq.shape[:3])}, got "
                         f"{tuple(ks.shape)} / {tuple(vs.shape)}")
    if scale is None:
        scale = q.shape[2] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_quant_ref(q, kq, ks, vq, vs, pos, scale=scale)
    return _launch_quant(q, kq, ks, vq, vs, pos, scale)


decode_attention_quant.launches = 0
