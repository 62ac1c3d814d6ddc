"""Fused int4 matmul: the hand-written CUDA kernel (``csrc/quant_matmul.cu``)
that replaces the Pallas kernel ``kubetorch_tpu/ops/quant_matmul.py:_kernel``,
and its plain version.

``x @ W`` where W is int4 in the half-split nibble pack of
``models.quant._quantize_leaf_int4``: byte row r of ``packed`` (K/2, N)
holds weight row r in its low nibble and row r + K/2 in its high nibble,
and ``scale`` (G, N) holds one fp32 scale per group of g = K/G rows and
output column. The lo plane meets ``x[:, :K/2]`` with scale rows
[0, G/2), the hi plane meets ``x[:, K/2:]`` with scale rows [G/2, G).
x is rounded to bf16 first, even when it is fp32 (as the Pallas wrapper
does), each group's product of each plane accumulates in fp32, is
multiplied by its scale row, and the groups are summed in order. The
output is fp32; callers cast.

``q4_matmul`` launches the kernel for CUDA tensors and uses the plain
version only for CPU tensors. ``q4_matmul.launches`` counts wrapper calls
that launched the kernel: one per call, also where split-K adds a second
pass that sums the splits. ``q4_matmul_body`` says which of the kernel's
two bodies a shape takes ("splitk" at M <= 16, "wgmma" above), and
``q4_split_plan`` how many runs of whole groups split K at decode. ``q4_supported`` is the JAX package's tiling predicate
verbatim, so the same shapes take the kernel here as there; the rest go
to the dequantize-then-matmul fallback in ``models.quant.wdot``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._kernel_args import check_cuda_operand, raise_on_error

# what the kernel takes: the group (its K chunk) a multiple of 64 packed
# rows, N a multiple of 16 (16-byte loads of packed rows)
KERNEL_GROUP_MULTIPLE = 64
KERNEL_N_MULTIPLE = 16
# the Pallas kernel's output tile width; routes the same shapes as
# kubetorch_tpu/ops/quant_matmul.py:96 (this kernel's own tiles are narrower)
_JAX_BLOCK_J = 512
# the split-K body (M <= 16): output columns per block, and the blocks the
# split plan aims at, about three per SM of an H100 (132 SMs)
SPLITK_MAX_M = 16
SPLITK_BLOCK_N = 128
SPLITK_TARGET_BLOCKS = 3 * 132


def q4_supported(x_shape, packed_shape, scale_shape) -> bool:
    """Static tiling check, the JAX package's predicate verbatim: the group
    size must be a multiple of 128 and N a multiple of ``min(512, N)``."""
    b, din = x_shape
    half, dout = packed_shape
    groups = scale_shape[0]
    if din != 2 * half or groups % 2 or scale_shape[1] != dout:
        return False
    if half % (groups // 2):
        return False
    block_k = half // (groups // 2)
    if block_k % 128 or dout % min(_JAX_BLOCK_J, dout):
        return False
    return True


def q4_split_plan(m: int, k: int, n: int, groups: int) -> int:
    """How many runs of whole groups split K at (M, K, N, G): 1 above
    ``SPLITK_MAX_M`` rows (the wgmma body does not split), else enough for
    about ``SPLITK_TARGET_BLOCKS`` blocks of ``SPLITK_BLOCK_N`` columns,
    never more than the G/2 groups of a plane. Pure host arithmetic."""
    if m > SPLITK_MAX_M:
        return 1
    per_plane = groups // 2
    n_tiles = -(-n // SPLITK_BLOCK_N)
    want = -(-SPLITK_TARGET_BLOCKS // n_tiles)
    return max(1, min(per_plane, want))


def q4_split_ranges(per_plane: int, splits: int):
    """The groups [t0, t1) of each split, as ``csrc/quant_matmul.cu``
    computes them: split s covers ``s * G2 // splits`` to
    ``(s + 1) * G2 // splits`` of the G2 = G/2 groups of a plane."""
    if not 1 <= splits <= per_plane:
        raise ValueError(f"{splits} splits of {per_plane} groups")
    return [(s * per_plane // splits, (s + 1) * per_plane // splits)
            for s in range(splits)]


def unpack_int4(packed: torch.Tensor):
    """(lo, hi) int32 planes of a nibble-packed int8 tensor, each value
    sign-extended from its nibble: ``(p << 28) >> 28`` and
    ``(p << 24) >> 28`` on ``p = int32(packed)``, as in the Pallas body."""
    p = packed.to(torch.int32)
    return (p << 28) >> 28, (p << 24) >> 28


def q4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The plain version: the Pallas body's arithmetic, one group at a
    time. x (M, K) is rounded to bf16; per group t, the fp32 product of
    the lo plane with x's lo half times scale row t plus that of the hi
    plane with x's hi half times scale row G/2 + t is added to the output
    in group order. Never dequantizes the whole weight."""
    xb = x.to(torch.bfloat16).float()
    half = packed.shape[0]
    hg = scale.shape[0] // 2
    g = half // hg
    lo, hi = unpack_int4(packed)
    out = None
    for t in range(hg):
        rows = slice(t * g, (t + 1) * g)
        part = (xb[:, rows] @ lo[rows].float()) * scale[t]
        part = part + (xb[:, half + t * g: half + (t + 1) * g]
                       @ hi[rows].float()) * scale[hg + t]
        out = part if out is None else out + part
    return out


def _lib():
    lib = _build.load("quant_matmul")
    fn = lib.kt_q4_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def q4_matmul_body(m: int, k: int, n: int, groups: int) -> str:
    """Which body of the kernel (M, K, N, G) takes: "splitk" (mma.sync,
    K split across blocks) or "wgmma" (wgmma + TMA). Loads the library
    and asks it, so the answer is the dispatch's own."""
    fn = _build.load("quant_matmul").kt_q4_matmul_body
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return ("splitk", "wgmma")[fn(m, k, n, groups)]


def _launch(x: torch.Tensor, packed: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    m, k = x.shape
    half, n = packed.shape
    groups = scale.shape[0]
    g = half // (groups // 2)
    if g % KERNEL_GROUP_MULTIPLE or n % KERNEL_N_MULTIPLE:
        raise ValueError(f"q4_matmul kernel takes a group size that is a "
                         f"multiple of {KERNEL_GROUP_MULTIPLE} and N a "
                         f"multiple of {KERNEL_N_MULTIPLE}, got group {g}, "
                         f"N {n}")
    xb = x.to(torch.bfloat16).contiguous()
    for name, t, dtype in (("x", xb, torch.bfloat16),
                           ("packed", packed, torch.int8),
                           ("scale", scale, torch.float32)):
        # the kernel reads rows at a stride of their width
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{t.stride()}")
        check_cuda_operand(name, t, dtype, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = q4_split_plan(m, k, n, groups)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xb.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), None if work is None else work.data_ptr(),
                 m, n, k, groups, splits, stream)
    raise_on_error("q4_matmul", err)
    q4_matmul.launches += 1
    return out


def q4_matmul(x: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``x @ W`` for half-split nibble-packed int4 W: x (M, K) float,
    packed (K/2, N) int8, scale (G, N) fp32 with the group K/G dividing
    K/2. Returns (M, N) fp32. CUDA tensors go through the kernel (group a
    multiple of 64, N a multiple of 16; anything else raises), CPU tensors
    through :func:`q4_matmul_ref`."""
    m, k = x.shape
    half, n = packed.shape
    groups = scale.shape[0]
    if (k != 2 * half or groups < 2 or groups % 2 or scale.shape[1] != n
            or half % (groups // 2)):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} packed "
                         f"{tuple(packed.shape)} scale {tuple(scale.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("q4_matmul has no gradient; call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    if x.device.type == "cpu":
        return q4_matmul_ref(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul runs on cuda or cpu, not {x.device}")
    return _launch(x, packed, scale)


q4_matmul.launches = 0
