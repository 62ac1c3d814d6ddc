#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (kubetorch_tpu_torch) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit; fails without CUDA.
2. Builds the CUDA kernels from csrc/ through ``_build.load`` (one nvcc per
   source, all started together) and prints the total build time. Fails
   unless the SASS of each tensor-core kernel function (A1, A2 and A3's
   bf16 bodies, B3's prefill body) holds wgmma (HGMMA) and TMA loads
   (UTMALDG), and the split flash-decode body (B1, B2) mma.sync (HMMA) and
   cp.async loads (LDGSTS), counted per function (B2 with half again B1's
   HMMA: the lo half of P.vs), and prints the kernels'
   registers and local memory (spills), failing on a spill.
3. Holds each kernel against its plain PyTorch version, row by row
   (kubetorch_tpu_torch/ops/tolerance.py), in bf16 and fp32, and times
   kernel, plain version and the nearest PyTorch call (SDPA or a cuBLAS
   matmul, a yardstick the port never calls) in CUDA graphs beside the
   card's least time for the same work: the flash forward (A1, bf16 at
   every prefill bucket of the engine and a ragged T); flash-decode over
   a bf16 cache (B1) and over an int8 cache (B2) at four shapes of
   Llama-3-8B's grid (DECODE_SHAPES: a ragged 8 x 2048, the engine's fill
   at 40-token prompts, one request of 8192 rows, the full 8 x 2048
   grid), each through the body
   kt_decode_attention_body reports (split for bf16 q, FMA for fp32) and
   bitwise equal over two calls, B2 also cold in L2; the int4 matmul (B3) at Llama-3-8B's projections, 1, 8 and 17
   rows (both bodies' edges), a ragged 300 and 2048-row prefills, each
   through the body kt_q4_matmul_body reports; A1 with its LSE, dQ (A2)
   and dK/dV (A3) at the training shape and at head dim 128. For the
   tensor-core A1, A2 and A3 and for B3 also TFLOP/s of the counted work,
   the share of the bound and, on the printed line only, the previous
   design's bf16 time (quoted from PERF.md, not measured here); for B1 and
   B2 the share of the bound also in the kernels line; for A1-A3
   the fp32-FMA body's time on fp32 inputs of the same shape (measured).
4. Serves Llama-3-8B at full width (random weights from a seed) through
   GenerationEngine: 8 slots, max_len 2048, greedy, 12 requests with
   prompts over every prefill bucket, admitted while others decode. Checks
   that every request completes, that the flash-prefill and flash-decode
   kernels carried the run, and that the first-token logits of the kernel
   path agree with the plain path (attn_impl="xla").
5. Serves Llama-3-8B again, full width and depth, quantized: int4 weights
   (group 128, llama_init_quantized) and an int8 KV cache
   (quantize_kv=True), the same warm-up and 12 requests. Checks that every
   request completes, that A1, B3 and B2 carried the run with exact launch
   counts (B1 none), that the first-token logits agree with the same
   weights dequantized to bf16 on the plain path, and that one decode
   step's logits agree between B2 and the plain int8 einsum from the same
   grid state, with B2's output in every layer of that step held per row
   to the plain einsum on the engine's own arguments; prints decode
   tokens/s, TTFT, weight and cache GB and a decode profile.
6. Trains Llama-3.2-1B's shape (LlamaConfig.llama3_1b, full width and
   depth, bf16, random weights from a seed) with make_train_step and
   default_optimizer on one batch of 4 x 2048 tokens: warm-up steps, then
   timed steps. Checks finite, falling losses and that A1, A2 and A3
   carried every layer of every step; prints tokens/s, ms/step, MFU, peak
   memory and a 2-step profile. Then holds the kernel path's gradients to
   the plain path's (fp32, 2 layers) and its loss (bf16, full depth).
7. Prints one JSON line of per-kernel numbers, the card line, and as the
   last line {"ok": true, "device": {...}}.

Any failed phase exits non-zero and prints no result.
"""

import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
L2_BYTES = 50e6                # H100 L2 cache, same source
ENGINE_PROMPT_LENS = (40, 128, 200, 256, 300, 480, 512, 700, 1000, 1024,
                      1500, 1990)
MAX_NEW = 32
SOURCES = ("flash_fwd", "flash_bwd", "decode_attention", "quant_matmul")
# the engine's prefill buckets (the last is max_len) and a ragged length
A1_BUCKETS, A1_RAGGED = (128, 256, 512, 1024, 2048), 1000
# the bf16 times of A1, A2 and A3 before the tensor-core redesign, when
# they ran the fp32-FMA bodies: PERF.md section 6, the earlier design's
# times in the kernel table (H100 80GB HBM3, 700 W, this script); A1 at
# Hd 128 is the serving T=1024 time, the same shape without the LSE
PREV_DESIGN_MS = {"fwd Hd=64": 3.395, "fwd Hd=128": 0.627, "dkv Hd=64": 6.52,
                  "dkv Hd=128": 1.372, "dq Hd=64": 4.54, "dq Hd=128": 0.842}
# B3's warm times per (M, K, N) before the split-K / wgmma redesign, with
# one mma.sync body for every M: PERF.md section 6, the earlier design's
# times in the kernel table (H100 80GB HBM3, 700 W, this script); shapes
# it did not time: None
PREV_Q4_MS = {(8, 4096, 4096): 0.0368, (8, 4096, 1024): 0.0370,
              (8, 4096, 14336): 0.0491, (8, 14336, 4096): 0.1189,
              (300, 4096, 4096): 0.122, (2048, 4096, 1024): 0.136,
              (2048, 4096, 14336): 1.921, (2048, 14336, 4096): 1.887}
# flash-decode's shapes (B, S, pos) at Llama-3-8B's NH=32, NKV=8, Hd=128:
# (a) a ragged grid (0, tile edges 63/64, mid values and S-1), (b) the
# engine's fill at 40-token prompts, (c) one request at the 8B's context,
# (d) the engine's grid full
DECODE_SHAPES = {"a": (8, 2048, [0, 63, 64, 700, 1024, 1500, 2000, 2047]),
                 "b": (8, 2048, [40, 45, 50, 55, 60, 64, 68, 71]),
                 "c": (1, 8192, [8191]),
                 "d": (8, 2048, [2047] * 8)}
# B1's and B2's bf16 times (B2 warm / cold L2) before the split body, with
# one block per (kv-head, slot) and fp32 FMA loops: at (a) PERF.md section
# 6, the earlier design's times in the kernel table (this script); at (b),
# (c) and (d) kubetorch_tpu_torch/tools/decode_ab.py on the
# parent tree beside the split body, the mean of six runs in three calls
# ((b), (c)) and of two runs in one call ((d)) (H100 80GB HBM3, 700 W)
PREV_DECODE_MS = {"a": dict(b1=0.164, b2=0.151, b2_cold=0.188),
                  "b": dict(b1=0.01084, b2=0.01155, b2_cold=0.01207),
                  "c": dict(b1=0.76612, b2=0.59794, b2_cold=0.74962),
                  "d": dict(b1=0.22052, b2=0.15839, b2_cold=0.19181)}
# the same source, the training phase with A1 and A3 on the tensor cores
# and A2 still the fp32-FMA body
PREV_TRAIN_TOKENS_PER_S = 20582
# training: batch x sequence, warm-up and timed steps, the CE chunk
TRAIN_B, TRAIN_S, TRAIN_WARM, TRAIN_STEPS, TRAIN_CHUNK = 4, 2048, 2, 5, 256
# kernel-path vs plain-path checks of the training phase:
# - gradients, fp32 at 1B width, 2 layers, B=1, S=512: per-leaf relative
#   L2. Both paths compute the same fp32 math (TF32 off); they differ in
#   the order of the attention sums (1e-6 relative per op), carried back
#   through two layers;
# - loss, bf16 at full depth, B=1, S=2048: absolute. The kernel keeps ~16
#   bits of P (two bf16 halves) where the plain attention rounds it to
#   bf16; the per-token CE moves by a few 1e-3 and the mean over 2,048
#   tokens averages that down.
GRAD_REL_L2 = 1e-4
LOSS_ABS = 2e-2
# kernel path vs plain path of the bf16 engines, first-token logits,
# relative L2: the two differ in attention numerics (~16 bits of P in the
# flash kernel, P rounded to bf16 in the plain cached attention) and then
# run the same bf16 layers; 32 layers of bf16 rounding keep the logits within
# a few percent of each other. The int4 engine's plain path also reads the
# weights rounded to bf16 (q * s in bf16, 2^-9 relative per weight) where
# B3 scales in fp32: a further ~1e-3 of the norm.
LOGITS_REL_L2 = 5e-2
# one int4 + int8-KV decode step, B2 vs the plain int8 einsum from the same
# grid state, relative L2 of the logits: both compute the same fp32
# attention and differ only in the order of its sums (~1e-6 relative),
# but where an activation sits near a bf16 rounding edge that becomes one
# 2^-8 step of one element, and 32 random-weight bf16 layers amplify such
# steps towards the few-percent floor of the first-token check (seeded
# inputs and deterministic kernels: an H100 reads 1.31e-2 in every run).
# At that floor the logits cannot tell a fault in how the engine hands
# its grid to B2 from rounding, so the same step also holds B2's output in
# every layer to the plain einsum on the very views the engine passed
# (layer slices of the grid, their strides, positions, scales), per row
# at ops/tolerance.py's ROW_RTOL, with q in bf16 as served and in fp32
DECODE_STEP_REL_L2 = 2e-2
# B3 at Llama-3-8B's shapes: (M, K, N), the four projection shapes at 8
# decode rows and at a 2048-row prefill bucket, a ragged 300, and 1 and 17
# rows of (4096, 4096): the split-K body's single-tile case and the first
# M the wgmma body takes
Q4_SHAPES = ((8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
             (8, 14336, 4096), (1, 4096, 4096), (17, 4096, 4096),
             (300, 4096, 4096), (2048, 4096, 4096), (2048, 4096, 1024),
             (2048, 4096, 14336), (2048, 14336, 4096))
Q4_GROUP = 128


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events. The replay
    issues every kernel with no host in between, so small shapes time the
    card and not the rate at which Python issues calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):      # warm-up: library plans, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def time_cold_ms(torch, fn, inputs) -> float:
    """:func:`time_ms` of ``fn(*inputs)`` with the inputs cold in L2, as a
    caller that streams other data between calls finds them (the engine's
    decode step reads 3.7 GB of weights): the captured calls cycle through
    copies of the inputs that together hold 4x the L2's bytes, so each call
    reads what the calls before it evicted."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    n = max(2, math.ceil(4 * L2_BYTES / nbytes))
    copies = itertools.cycle([tuple(t.clone() for t in inputs)
                              for _ in range(n)])
    ms = time_ms(torch, lambda: fn(*next(copies)), iters=n)
    del copies
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the bf16 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate_line(flops: float, ms: float, bound_ms: float) -> dict:
    """TFLOP/s of the counted work and the share of the bound reached."""
    return dict(tflops=flops / ms / 1e9, bound_share=bound_ms / ms)


# the tensor-core kernel functions, by library, and the instructions each
# must hold in its own SASS (a count over a library would let one kernel's
# tensor-core products stand for another that still runs FMAs): wgmma and
# TMA loads for A1, A2, A3 and B3's prefill body; mma.sync and cp.async
# loads for the split flash-decode body (B1, B2)
WGMMA_TMA = ("HGMMA", "UTMALDG")
TENSOR_CORE_KERNELS = {"flash_fwd": {"flash_fwd_sm90": WGMMA_TMA},
                       "flash_bwd": {"bwd_dq_sm90": WGMMA_TMA,
                                     "bwd_dkv_sm90": WGMMA_TMA},
                       "quant_matmul": {"q4_wgmma": WGMMA_TMA},
                       "decode_attention": {"decode_split": ("HMMA", "LDGSTS")}}


def check_decode_lo_half(funcs: dict) -> None:
    """B2's P.vs goes through the tensor cores as two bf16 halves (hi and
    lo), B1's P once. In each split body S = q.K^T and P.V take the same
    number of mma.sync (Hd / 8 per warp and tile), so B1 holds 2 of them per
    step and B2 3: fails unless each decode_split<HD, true> holds at least
    1.5x the HMMA of decode_split<HD, false>, which a B2 that rounds P.vs
    once to bf16 (a different result, within bf16's output tolerance) would
    not."""
    for hd in (64, 128):
        count = {}
        for quant in (0, 1):
            tag = f"decode_splitILi{hd}ELb{quant}E"
            bodies = [b for f, b in funcs.items() if tag in f]
            if len(bodies) != 1:
                fail(f"decode_attention: {len(bodies)} functions {tag}")
            count[quant] = bodies[0].count("HMMA")
        print(f"sass decode_attention Hd={hd} HMMA B1={count[0]} "
              f"B2={count[1]} (B2 >= 1.5 x B1: hi and lo P.vs)", flush=True)
        if 2 * count[1] < 3 * count[0]:
            fail(f"decode_attention Hd={hd}: B2 holds {count[1]} HMMA, "
                 f"B1 {count[0]}: no lo half of P.vs")


def check_tensor_core_sass(_build) -> None:
    """Per kernel function: the bf16 bodies of A1, A2 and A3 and B3's
    prefill body must each hold wgmma (HGMMA) and TMA loads (UTMALDG), the
    split flash-decode body mma.sync (HMMA) and cp.async loads (LDGSTS), in
    every instantiation, B2's with the lo half of P.vs. Prints every kernel's registers and local memory
    and fails on a spill (local memory) in a tensor-core kernel."""
    import re
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name, kernels in TENSOR_CORE_KERNELS.items():
        lib = str(_build.library_path(name))
        sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
        funcs = dict(zip(parts[1::2], parts[2::2]))
        for kernel, ops in kernels.items():
            found = {f: b for f, b in funcs.items() if kernel in f}
            if not found:
                fail(f"{name}: no kernel function named {kernel} in the SASS")
            for func, body in found.items():
                counts = {op: body.count(op) for op in ops}
                print(f"sass {name} {kernel} ({func}): {counts}", flush=True)
                if not all(counts.values()):
                    fail(f"{name} {func}: SASS lacks {ops}: {counts}")
        if name == "decode_attention":
            check_decode_lo_half(funcs)
        usage = subprocess.run([tool, "--dump-resource-usage", lib],
                               capture_output=True, text=True, check=True).stdout
        lines = usage.splitlines()
        for i, line in enumerate(lines):     # "Function <name>:" then usage
            if not line.strip().startswith("Function"):
                continue
            res = lines[i + 1].strip() if i + 1 < len(lines) else ""
            print(f"resources {name}: {line.strip()} {res}", flush=True)
            local = re.search(r"LOCAL:(\d+)", res)
            if (any(k in line for k in kernels) and local
                    and int(local.group(1)) > 0):
                fail(f"{name}: {line.strip()} uses local memory (spills): {res}")


def compare(name, got, want) -> tuple:
    """Kernel against plain version, per row (ops/tolerance.py): fails the
    run past the row tolerance. Returns (max_abs_err, max row rel err)."""
    from kubetorch_tpu_torch.ops.tolerance import (ROW_RTOL, max_abs_err,
                                                   row_rel_err)
    err, rel = max_abs_err(got, want), row_rel_err(got, want)
    tol = ROW_RTOL[got.dtype]
    print(f"check {name} {got.dtype}: max_abs_err={err} "
          f"max_row_rel_err={rel} row_rtol={tol}", flush=True)
    if not rel <= tol:
        fail(f"{name} {got.dtype}: kernel differs from plain version, row "
             f"relative error {rel} > {tol} (max |diff| {err})")
    return err, rel


def compare_grad(name, got, want) -> tuple:
    """A gradient against its plain version, per row with the RMS floor
    (ops/tolerance.py:grad_row_rel_err). Returns (max_abs_err, row err)."""
    from kubetorch_tpu_torch.ops.tolerance import (ROW_RTOL, grad_row_rel_err,
                                                   max_abs_err)
    err, rel = max_abs_err(got, want), grad_row_rel_err(got, want)
    tol = ROW_RTOL[got.dtype]
    print(f"check {name} {got.dtype}: max_abs_err={err} "
          f"max_row_rel_err={rel} row_rtol={tol} (floor: RMS row norm)",
          flush=True)
    if not rel <= tol:
        fail(f"{name} {got.dtype}: kernel differs from plain version, row "
             f"relative error {rel} > {tol} (max |diff| {err})")
    return err, rel


def check_flash(torch, F, ops_attn):
    """A1 at B=1, N=32, NKV=8, Hd=128, causal: bf16 (the engine's type,
    the tensor-core body) at every prefill bucket and a ragged T, fp32 (the
    FMA body) at 128, 512 and 1024, each against the plain version; bf16
    times at every length. Returns the record of T=1024."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = None
    for t in (*A1_BUCKETS, A1_RAGGED):
        q = torch.randn(1, t, 32, 128, generator=gen, device="cuda")
        k = torch.randn(1, t, 8, 128, generator=gen, device="cuda")
        v = torch.randn(1, t, 8, 128, generator=gen, device="cuda")
        dtypes = (torch.float32, torch.bfloat16) if t in (128, 512, 1024) \
            else (torch.bfloat16,)
        for dtype in dtypes:
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            got = ops_attn.flash_attention(qd, kd, vd, causal=True)
            want = ops_attn.flash_attention_ref(qd, kd, vd, causal=True)
            err, rel = compare(f"flash_fwd T={t}", got, want)
            del got, want
        ms = time_ms(torch, lambda: ops_attn.flash_attention(qd, kd, vd))
        plain = time_ms(torch, lambda: ops_attn.flash_attention_ref(qd, kd, vd))
        qt, kt, vt = (x.transpose(1, 2) for x in (qd, kd, vd))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = (2 * 32 + 2 * 8) * t * 128 * 2
        flops = 4 * 32 * 128 * t * (t + 1) / 2
        b_ms, b_by = bound(nbytes, flops)
        rate = rate_line(flops, ms, b_ms)
        extra = ""
        if t == 1024:
            fp32_ms = time_ms(torch, lambda: ops_attn.flash_attention(q, k, v))
            prev = PREV_DESIGN_MS["fwd Hd=128"]
            extra = (f" fp32_fma_body_ms={fp32_ms} (fp32 inputs, measured) "
                     f"prev_design_bf16_ms={prev} (fp32-FMA body in bf16, "
                     f"PERF.md, not this run) speedup_vs_prev={prev / ms}")
        print(f"kernel flash_fwd T={t} bf16: ms={ms} plain_ms={plain} "
              f"sdpa_ms={lib} bound_ms={b_ms} ({b_by}) "
              f"tflops={rate['tflops']} bound_share={rate['bound_share']}"
              f"{extra}", flush=True)
        if t == 1024:
            rec = dict(max_abs_err=err, max_row_rel_err=rel, ms=ms,
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib, **rate, fp32_fma_body_ms=fp32_ms,
                       shape=f"B=1 T={t} N=32 NKV=8 Hd=128 bf16 causal")
        del q, k, v, qd, kd, vd, qt, kt, vt
        torch.cuda.empty_cache()
    return rec


def decode_bound(b, s, pos_list, quant: bool):
    """(bound_ms, bound_by, bytes) of one flash-decode call at NH=32,
    NKV=8, Hd=128: q read and out written once in bf16, the live K and V
    rows (bf16, or int8 with a 4-byte scale each) and pos; 4 flops per live
    row, query head and head dim."""
    nh, nkv, hd = 32, 8, 128
    live = sum(min(p + 1, s) for p in pos_list)
    row = hd + 4 if quant else 2 * hd
    nbytes = 2 * b * nh * hd * 2 + 2 * live * nkv * row + 4 * b
    return (*bound(nbytes, 4 * nh * hd * live), nbytes)


def check_decode_shape(torch, F, ops_dec, shape, quant: bool, gen):
    """B1 (``quant`` False) or B2 at one of DECODE_SHAPES: bf16 q (and fp32
    q at shape a) against the plain version per row, the route of each
    (split body for bf16, FMA body for fp32), bitwise equal over two calls,
    then bf16 times of the kernel, the plain version and SDPA (for B2 over
    K/V dequantized to bf16, outside the timing), B2 also cold in L2."""
    from kubetorch_tpu_torch.serve import dequantize_rows, quantize_rows
    b, s, pos_list = DECODE_SHAPES[shape]
    nh, nkv, hd = 32, 8, 128
    name = "decode_attention_quant" if quant else "decode_attention"
    q = torch.randn(b, nh, hd, generator=gen, device="cuda")
    kf = torch.randn(b, s, nkv, hd, generator=gen, device="cuda")
    vf = torch.randn(b, s, nkv, hd, generator=gen, device="cuda")
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    if quant:
        (kq, ks), (vq, vs) = quantize_rows(kf), quantize_rows(vf)
        cache = (kq, ks, vq, vs)
        kern, plain = ops_dec.decode_attention_quant, ops_dec.decode_attention_quant_ref
    else:
        cache = (kf, vf)
        kern, plain = ops_dec.decode_attention, ops_dec.decode_attention_ref
    splits = -(-s // ops_dec.decode_split_plan(b, nkv, s))
    for dtype in ((torch.float32, torch.bfloat16) if shape == "a"
                  else (torch.bfloat16,)):
        qd = q.to(dtype)
        args = cache if quant else tuple(t.to(dtype) for t in cache)
        body = ops_dec.decode_attention_body(dtype, hd, nh, nkv)
        if body != ("split" if dtype == torch.bfloat16 else "fma"):
            fail(f"{name} {dtype}: body {body}")
        got = kern(qd, *args, pos)
        err, rel = compare(f"{name} ({shape}) {body} body", got,
                           plain(qd, *args, pos))
        if not torch.equal(got, kern(qd, *args, pos)):
            fail(f"{name} ({shape}) {dtype}: two calls differ")
    q = qd
    del got, kf, vf
    ms = time_ms(torch, lambda: kern(q, *args, pos))
    plain_ms = time_ms(torch, lambda: plain(q, *args, pos))
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None]
    if quant:
        kt = dequantize_rows(kq, ks).bfloat16().transpose(1, 2)
        vt = dequantize_rows(vq, vs).bfloat16().transpose(1, 2)
    else:
        kt, vt = args[0].transpose(1, 2), args[1].transpose(1, 2)

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_[:, :, None], k_, v_,
                                              attn_mask=mask, enable_gqa=True)

    lib = time_ms(torch, lambda: sdpa(q, kt, vt))
    b_ms, b_by, nbytes = decode_bound(b, s, pos_list, quant)
    prev = PREV_DECODE_MS[shape]
    rec = dict(shape=f"({shape}) B={b} S={s} NH={nh} NKV={nkv} Hd={hd} "
               f"pos={pos_list} bf16 q" + (", int8 K/V" if quant else ""),
               body="split", splits=splits, max_abs_err=err,
               max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib, bound_share=b_ms / ms)
    line = (f"kernel {name} ({shape}) B={b} S={s} pos={pos_list} body=split "
            f"splits={splits}: ms={ms} plain_ms={plain_ms} sdpa_ms={lib} "
            f"bound_ms={b_ms} ({b_by}; {nbytes} bytes) "
            f"bound_share={b_ms / ms} prev_design_bf16_ms="
            f"{prev['b2' if quant else 'b1']}")
    if quant:
        rec["ms_cold_l2"] = time_cold_ms(torch, kern, (q, *args, pos))
        rec["library_ms_cold_l2"] = time_cold_ms(torch, sdpa, (q, kt, vt))
        line += (f" ms_cold_l2={rec['ms_cold_l2']} sdpa_ms_cold_l2="
                 f"{rec['library_ms_cold_l2']} prev_design_bf16_ms_cold_l2="
                 f"{prev['b2_cold']}")
    print(line + " (prev: one block per kv-head and slot, PERF.md and "
          "tools/decode_ab.py, not this run)", flush=True)
    del q, args, cache, kt, vt
    torch.cuda.empty_cache()
    return rec


def check_decode(torch, F, ops_dec, quant: bool = False):
    """B1 (or, with ``quant``, B2) at each shape of DECODE_SHAPES. Returns
    the kernels-line record of shape (a) with every shape's beside it."""
    gen = torch.Generator(device="cuda").manual_seed(5 if quant else 2)
    per_shape = [check_decode_shape(torch, F, ops_dec, shape, quant, gen)
                 for shape in DECODE_SHAPES]
    rec = dict(per_shape[0])
    rec["per_shape"] = per_shape
    return rec


def check_q4(torch, ops_q4):
    """B3 at Q4_SHAPES, each through the body kt_q4_matmul_body reports
    (split-K at M <= 16, wgmma above): fp32 output against the plain
    version per row (x in fp32 and in bf16: the kernel rounds it to bf16
    either way) and bitwise equal over two calls, then times with bf16 x.
    Library: cuBLAS x_bf16 @ W_bf16 over the weight dequantized once,
    outside the timing. Returns the record of the widest decode shape
    (8 x 4096 x 14336, w_gate and w_up) with every shape's numbers beside
    it."""
    from kubetorch_tpu_torch.models.quant import (_dequant_int4,
                                                  _quantize_leaf_int4)
    gen = torch.Generator(device="cuda").manual_seed(6)
    per_shape = []
    for m, k, n in Q4_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        leaf = _quantize_leaf_int4(w, group=Q4_GROUP)
        del w
        packed, scale = leaf["__kt_q4__"], leaf["scale"]
        x = torch.randn(m, k, generator=gen, device="cuda")
        groups = scale.shape[0]
        route = ops_q4.q4_matmul_body(m, k, n, groups)
        if route != ("splitk" if m <= ops_q4.SPLITK_MAX_M else "wgmma"):
            fail(f"q4_matmul M={m} K={k} N={n}: route {route}")
        splits = ops_q4.q4_split_plan(m, k, n, groups)
        for xin in (x, x.bfloat16()):
            got = ops_q4.q4_matmul(xin, packed, scale)
            want = ops_q4.q4_matmul_ref(xin, packed, scale)
            err, rel = compare(f"q4_matmul M={m} K={k} N={n} x {xin.dtype} "
                               f"({route}, {splits} splits)", got, want)
        if not torch.equal(got, ops_q4.q4_matmul(xin, packed, scale)):
            fail(f"q4_matmul M={m} K={k} N={n} ({route}): two calls differ")
        del got, want
        xb = x.bfloat16()
        ms = time_ms(torch, lambda: ops_q4.q4_matmul(xb, packed, scale))
        plain = time_ms(torch, lambda: ops_q4.q4_matmul_ref(xb, packed, scale),
                        iters=5)
        wb = _dequant_int4(leaf, torch.bfloat16)
        lib = time_ms(torch, lambda: xb @ wb)
        ms_cold = time_cold_ms(torch, ops_q4.q4_matmul, (xb, packed, scale))
        lib_cold = time_cold_ms(torch, torch.matmul, (xb, wb))
        del wb
        nbytes = k // 2 * n + 4 * (k // Q4_GROUP) * n + 2 * m * k + 4 * m * n
        flops = 2 * m * k * n
        b_ms, b_by = bound(nbytes, flops)
        rate = rate_line(flops, ms, b_ms)
        prev = PREV_Q4_MS.get((m, k, n))
        print(f"kernel q4_matmul M={m} K={k} N={n} g={Q4_GROUP} route={route} "
              f"splits={splits}: ms={ms} "
              f"ms_cold_l2={ms_cold} plain_ms={plain} library_ms={lib} "
              f"library_ms_cold_l2={lib_cold} (cuBLAS bf16 over W "
              f"dequantized) bound_ms={b_ms} ({b_by}; {nbytes} bytes, "
              f"{flops} flops) tflops={rate['tflops']} "
              f"bound_share={rate['bound_share']} prev_design_bf16_ms={prev} "
              f"(one mma.sync body, PERF.md, not this run)", flush=True)
        per_shape.append(dict(shape=f"M={m} K={k} N={n} g={Q4_GROUP}",
                              route=route, splits=splits,
                              max_abs_err=err, max_row_rel_err=rel, ms=ms,
                              plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib, ms_cold_l2=ms_cold,
                              library_ms_cold_l2=lib_cold, **rate))
        torch.cuda.empty_cache()
    widest = next(r for r in per_shape
                  if r["shape"].startswith("M=8 K=4096 N=14336"))
    # the kernels line's "route" is the language; B3's body is "body" here
    # and "route" in each per_shape entry
    rec = {k: v for k, v in widest.items() if k != "route"}
    rec["body"] = widest["route"]
    rec["per_shape"] = per_shape
    return rec


def check_train_kernels(torch, F, ops_attn):
    """A1 with its LSE, A2 and A3, causal, at the training shape (B=4,
    S=2048, N=32, NKV=8, Hd=64) and at Hd=128 (B=1, S=1024): bf16 and fp32
    against the plain versions, then bf16 times. Returns the kernels-line
    records of the training shape."""
    from kubetorch_tpu_torch.ops.tolerance import LSE_ATOL
    gen = torch.Generator(device="cuda").manual_seed(4)
    recs = {}
    for b, s, nh, nkv, hd in ((TRAIN_B, TRAIN_S, 32, 8, 64), (1, 1024, 32, 8, 128)):
        shape = f"B={b} S={s} N={nh} NKV={nkv} Hd={hd}"
        scale = hd ** -0.5
        base = [torch.randn(b, s, n, hd, generator=gen, device="cuda")
                for n in (nh, nkv, nkv, nh)]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (x.to(dtype) for x in base)
            out, lse = ops_attn._launch(q, k, v, True, scale, need_lse=True)
            want_out, want_lse = ops_attn.flash_attention_fwd_ref(q, k, v)
            fwd_err = compare(f"flash_fwd+lse {shape}", out, want_out)[0]
            lse_err = float((lse - want_lse).abs().max())
            print(f"check flash_fwd lse {shape} {dtype}: max_abs_err={lse_err} "
                  f"atol={LSE_ATOL}", flush=True)
            if not lse_err <= LSE_ATOL:
                fail(f"flash_fwd lse {shape} {dtype}: {lse_err} > {LSE_ATOL}")
            del want_out, want_lse
            delta = ops_attn.attention_delta(out, do)
            dq = ops_attn.flash_attention_bwd_dq(q, k, v, do, lse, delta)
            errs["dq"] = compare_grad(f"flash_bwd_dq {shape}", dq,
                                      ops_attn.flash_attention_bwd_dq_ref(
                                          q, k, v, do, lse, delta))
            dk, dv = ops_attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
            want_dk, want_dv = ops_attn.flash_attention_bwd_dkv_ref(
                q, k, v, do, lse, delta)
            ek = compare_grad(f"flash_bwd_dk {shape}", dk, want_dk)
            ev = compare_grad(f"flash_bwd_dv {shape}", dv, want_dv)
            errs["dkv"] = (max(ek[0], ev[0]), max(ek[1], ev[1]))
            errs["fwd"] = (fwd_err, lse_err)
            del dq, dk, dv, want_dk, want_dv
            torch.cuda.empty_cache()
        # bf16 times (q, k, v, do, lse, delta are the bf16 ones)
        t_fwd = time_ms(torch, lambda: ops_attn._launch(q, k, v, True, scale))
        t_lse = time_ms(torch, lambda: ops_attn._launch(q, k, v, True, scale,
                                                        need_lse=True))
        t_dq = time_ms(torch, lambda: ops_attn.flash_attention_bwd_dq(
            q, k, v, do, lse, delta))
        t_dkv = time_ms(torch, lambda: ops_attn.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta))
        p_fwd = time_ms(torch, lambda: ops_attn.flash_attention_fwd_ref(q, k, v))
        p_dq = time_ms(torch, lambda: ops_attn.flash_attention_bwd_dq_ref(
            q, k, v, do, lse, delta))
        p_dkv = time_ms(torch, lambda: ops_attn.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta))
        lib_fwd, lib_bwd = sdpa_times(torch, F, q, k, v, do)
        pairs = b * nh * s * (s + 1) / 2
        e = 2   # bf16 bytes
        qb, kb = b * s * nh * hd * e, b * s * nkv * hd * e
        stat = b * nh * s * 4
        work = {"fwd": (2 * qb + 2 * kb + stat, 4 * hd * pairs),
                "dq": (3 * qb + 2 * kb + 2 * stat, 6 * hd * pairs),
                "dkv": (2 * qb + 4 * kb + 2 * stat, 8 * hd * pairs)}
        times = {"fwd": (t_lse, p_fwd, lib_fwd), "dq": (t_dq, p_dq, lib_bwd),
                 "dkv": (t_dkv, p_dkv, lib_bwd)}
        lib_name = {"fwd": "SDPA forward", "dq": "SDPA backward, dQ dK dV",
                    "dkv": "SDPA backward, dQ dK dV"}
        fma = fma_body_times(torch, ops_attn, base, scale)
        for name, (nbytes, flops) in work.items():
            b_ms, b_by = bound(nbytes, flops)
            ms, plain, lib = times[name]
            rate = rate_line(flops, ms, b_ms)
            redesign = {}
            if name in fma:      # A1, A2 and A3: the tensor-core bodies
                redesign = dict(fp32_fma_body_ms=fma[name])
            print(f"kernel flash_{name} {shape} bf16 causal: ms={ms} "
                  f"plain_ms={plain} library_ms={lib} ({lib_name[name]}) "
                  f"bound_ms={b_ms} "
                  f"({b_by}; {nbytes} bytes, {flops} flops) "
                  f"tflops={rate['tflops']} bound_share={rate['bound_share']}"
                  + (f" fp32_fma_body_ms={fma[name]} (fp32 inputs, measured)"
                     f" prev_design_bf16_ms={PREV_DESIGN_MS[f'{name} Hd={hd}']}"
                     f" (fp32-FMA body in bf16, PERF.md, not this run)"
                     if redesign else ""),
                  flush=True)
            if hd == 64:
                recs[name] = dict(max_abs_err=errs[name][0], ms=ms,
                                  plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib, bytes=nbytes, flops=flops,
                                  **rate, **redesign,
                                  shape=f"{shape} bf16 causal")
        print(f"kernel flash_fwd {shape} bf16 causal: ms_without_lse={t_fwd} "
              f"ms_with_lse={t_lse}", flush=True)
        if hd == 64:
            recs["fwd"]["ms_without_lse"] = t_fwd
            recs["fwd"]["max_abs_err_lse"] = errs["fwd"][1]
        del q, k, v, do, lse, delta, base
        torch.cuda.empty_cache()
    return recs


def fma_body_times(torch, ops_attn, base, scale) -> dict:
    """A1 with its LSE, A2 and A3 on fp32 inputs of the same shape: their
    fp32-FMA bodies, the design the bf16 kernels had before the tensor-core
    redesign (fp32 loads, so not that design's bf16 time)."""
    q, k, v, do = base
    out, lse = ops_attn._launch(q, k, v, True, scale, need_lse=True)
    delta = ops_attn.attention_delta(out, do)
    times = {"fwd": time_ms(torch, lambda: ops_attn._launch(
                 q, k, v, True, scale, need_lse=True), iters=5),
             "dq": time_ms(torch, lambda: ops_attn.flash_attention_bwd_dq(
                 q, k, v, do, lse, delta), iters=5),
             "dkv": time_ms(torch, lambda: ops_attn.flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta), iters=5)}
    del out, lse, delta
    return times


def sdpa_times(torch, F, q, k, v, do):
    """SDPA's forward, and its backward as autograd of SDPA less its
    forward (dQ, dK and dV together): the library yardsticks for A1 and for
    A2/A3, on the same inputs (head-major views)."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        t_fwd = time_ms(torch, fwd)
    return t_fwd, time_ms(torch, fwd_bwd) - t_fwd


def drive_engine(torch, ops_attn, ops_dec, card):
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.serve import GenerationEngine

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"engine: Llama-3-8B params {cfg.param_count()} initialised in "
          f"{time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card",
          flush=True)
    eng = GenerationEngine(params, cfg, slots=8, max_len=2048,
                           prefill_buckets=(128, 256, 512, 1024),
                           device="cuda")
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    # warm-up: one prompt per bucket (cuBLAS handles, allocator), not counted
    warm = [eng.submit(prompt(n), max_new_tokens=2)
            for n in (100, 200, 400, 800, 1500)]
    while eng.step():
        pass
    for h in warm:
        h.result(timeout=0)

    prompts = [prompt(n) for n in ENGINE_PROMPT_LENS]
    ops_attn.flash_attention.launches = 0
    ops_dec.decode_attention.launches = 0
    handles, tok_s, steps = serve_requests(torch, eng, cfg, prompts)
    flash_n = ops_attn.flash_attention.launches
    decode_n = ops_dec.decode_attention.launches
    outs = check_outputs("engine", handles, cfg, prompts)
    if flash_n != cfg.n_layers * len(prompts):
        fail(f"engine: flash_fwd launched {flash_n} times, expected "
             f"{cfg.n_layers} per prefill x {len(prompts)}")
    if decode_n != cfg.n_layers * steps or decode_n == 0:
        fail(f"engine: decode_attention launched {decode_n} times over "
             f"{steps} decode steps of {cfg.n_layers} layers")
    ttft = [h.time_to_first_token() for h in handles]
    print(f"engine: {len(outs)} requests completed, {MAX_NEW} tokens each; "
          f"flash_fwd launches {flash_n}, decode_attention launches "
          f"{decode_n} over {steps} decode steps", flush=True)
    print(f"engine: decode_tok_per_s={tok_s} "
          f"(tokens of steps without admission / their wall time) "
          f"mean_ttft_s={sum(ttft) / len(ttft)} (submit to first token, "
          f"queueing included) card={card}", flush=True)

    check_first_token_logits(torch, "engine", params, params, cfg, eng, prompts)
    profile_decode(torch, eng, prompts)
    return flash_n, decode_n


def serve_requests(torch, eng, cfg, prompts):
    """The engine phases' traffic: 6 requests up front, then one more per
    step while the grid decodes. Returns (handles, decode tokens/s over the
    steps that admitted nothing, decode steps)."""
    steps0 = eng.stats().decode_steps
    handles, todo = [], list(prompts)
    handles += [eng.submit(p, max_new_tokens=MAX_NEW) for p in todo[:6]]
    todo = todo[6:]
    decode_time = decode_tokens = 0.0
    while True:
        if todo:   # one new request per step while the grid decodes
            handles.append(eng.submit(todo.pop(0), max_new_tokens=MAX_NEW))
        before = eng.stats()
        t = time.perf_counter()
        left = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = eng.stats()
        if after.admitted_total == before.admitted_total:
            decode_time += dt
            decode_tokens += after.tokens_generated - before.tokens_generated
        if not left and not todo:
            break
    return handles, decode_tokens / decode_time, eng.stats().decode_steps - steps0


def check_outputs(label, handles, cfg, prompts):
    outs = [h.result(timeout=0) for h in handles]
    if len(outs) != len(prompts):
        fail(f"{label}: {len(outs)} of {len(prompts)} requests came back")
    for n, o in zip(ENGINE_PROMPT_LENS, outs):
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"{label}: prompt of {n} tokens gave {len(o)} tokens {o[:8]}")
    return outs


def check_first_token_logits(torch, label, params, plain_params, cfg, eng,
                             prompts):
    """First-token logits of a 300-token prompt in the 512 bucket: the
    kernel path (``params``, attn_impl auto) against the plain path
    (``plain_params``, attn_impl "xla"), within LOGITS_REL_L2."""
    from kubetorch_tpu_torch.serve import engine as engine_mod
    n = 300
    toks = torch.zeros((1, 512), dtype=torch.long)
    toks[0, :n] = torch.tensor(prompts[4])
    toks = toks.cuda()
    with torch.no_grad():
        lk, _, _ = engine_mod._prefill_logits(params, toks, n, cfg, eng._freqs)
        cfg_x = dataclasses.replace(cfg, attn_impl="xla")
        lx, _, _ = engine_mod._prefill_logits(plain_params, toks, n, cfg_x,
                                              eng._freqs)
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        fail(f"{label}: first-token logits not finite or of the wrong shape")
    rel = float((lk - lx).norm() / lx.norm())
    max_abs = float((lk - lx).abs().max())
    print(f"{label}: first-token logits kernel vs plain: rel_l2={rel} "
          f"max_abs={max_abs} tol_rel_l2={LOGITS_REL_L2} argmax "
          f"{int(lk.argmax())}/{int(lx.argmax())}", flush=True)
    if not rel <= LOGITS_REL_L2:
        fail(f"{label}: first-token logits differ, rel L2 {rel} > {LOGITS_REL_L2}")


def drive_engine_quant(torch, ops_attn, ops_dec, ops_q4, card):
    """Llama-3-8B, full width and depth, int4 weights (group 128) and an
    int8 KV cache, through GenerationEngine: the engine phase's warm-up and
    requests, with the launch counts set to 0 just before the requests and
    read just after."""
    from kubetorch_tpu_torch.models.llama import LlamaConfig
    from kubetorch_tpu_torch.models.quant import (dequantize_params,
                                                  llama_init_quantized,
                                                  quantized_bytes)
    from kubetorch_tpu_torch.serve import GenerationEngine, QuantKVCache
    from kubetorch_tpu_torch.serve import engine as engine_mod

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama_init_quantized(cfg, bits=4, seed=0, device="cuda")
    torch.cuda.synchronize()
    sizes = quantized_bytes(params)
    weight_gb = (sizes["quantized"] + sizes["full"]) / 1e9
    eng = GenerationEngine(params, cfg, slots=8, max_len=2048,
                           prefill_buckets=(128, 256, 512, 1024),
                           quantize_kv=True, device="cuda")
    if not isinstance(eng._cache, QuantKVCache):
        fail("engine_q4: quantize_kv=True did not give an int8 grid")
    cache_gb = sum(t.numel() * t.element_size() for t in eng._cache) / 1e9
    print(f"engine_q4: Llama-3-8B int4 (group {Q4_GROUP}) initialised in "
          f"{time.perf_counter() - t0:.2f}s; weight_gb={weight_gb} "
          f"(packed + scales {sizes['quantized'] / 1e9}, full precision "
          f"{sizes['full'] / 1e9}) cache_gb={cache_gb} (int8 grid, 8 slots x "
          f"2048) allocated_gb={torch.cuda.memory_allocated() / 1e9} "
          f"card={card}", flush=True)
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    warm = [eng.submit(prompt(n), max_new_tokens=2)
            for n in (100, 200, 400, 800, 1500)]
    while eng.step():
        pass
    for h in warm:
        h.result(timeout=0)

    prompts = [prompt(n) for n in ENGINE_PROMPT_LENS]
    ops_attn.flash_attention.launches = 0
    ops_dec.decode_attention.launches = 0
    ops_dec.decode_attention_quant.launches = 0
    ops_q4.q4_matmul.launches = 0
    handles, tok_s, steps = serve_requests(torch, eng, cfg, prompts)
    counts = dict(flash_fwd=ops_attn.flash_attention.launches,
                  q4_matmul=ops_q4.q4_matmul.launches,
                  decode_attention_quant=ops_dec.decode_attention_quant.launches,
                  decode_attention=ops_dec.decode_attention.launches)
    outs = check_outputs("engine_q4", handles, cfg, prompts)
    L, n_req = cfg.n_layers, len(prompts)
    # the head takes B3 only where it tiles; Llama-3-8B's 128256 columns do
    # not (no multiple of 512), so its head is the fp32 dequant fallback
    head = params["lm_head"]
    head_q4 = int(ops_q4.q4_supported((1, cfg.dim), head["__kt_q4__"].shape,
                                      head["scale"].shape))
    want = dict(flash_fwd=L * n_req,
                q4_matmul=(7 * L + head_q4) * (n_req + steps),
                decode_attention_quant=L * steps, decode_attention=0)
    if counts != want or steps == 0:
        fail(f"engine_q4: launches {counts} over {n_req} prefills and "
             f"{steps} decode steps, expected {want}")
    ttft = [h.time_to_first_token() for h in handles]
    print(f"engine_q4: {len(outs)} requests completed, {MAX_NEW} tokens each; "
          f"launches {counts} over {n_req} prefills and {steps} decode steps "
          f"(A1 = {L} x prefills, B3 = (7 x {L} + {head_q4} for the head) x "
          f"(prefills + steps), B2 = {L} x steps, B1 = 0)", flush=True)
    print(f"engine_q4: decode_tok_per_s={tok_s} (tokens of steps without "
          f"admission / their wall time) mean_ttft_s={sum(ttft) / len(ttft)} "
          f"(submit to first token, queueing included) weight_gb={weight_gb} "
          f"cache_gb={cache_gb} card={card}", flush=True)

    plain = dequantize_params(params, torch.bfloat16)
    check_first_token_logits(torch, "engine_q4", params, plain, cfg, eng,
                             prompts)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    check_decode_step_quant(torch, engine_mod, ops_dec, eng, params, cfg,
                            prompts)
    profile_decode(torch, eng, prompts)
    return counts, dict(decode_tok_per_s=tok_s, mean_ttft_s=sum(ttft) / len(ttft),
                        weight_gb=weight_gb, cache_gb=cache_gb)


def check_decode_step_quant(torch, engine_mod, ops_dec, eng, params, cfg,
                            prompts):
    """One decode step of a full grid (8 slots of 40-token prompts, one
    step in), from the same int8 grid state twice: through B2 (attn_impl
    auto) and through the plain fold-in einsum (xla). Each runs on its own
    copy of the grid, since a step writes its new row in place. In the B2
    run every layer's call is held to the plain einsum on the same
    arguments, per row (DECODE_STEP_REL_L2 has the reason)."""
    from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
    hs = [eng.submit(p[:40], max_new_tokens=4) for p in prompts[:eng.slots]]
    eng.step()                            # admissions + one decode step
    torch.cuda.synchronize()
    pos = torch.from_numpy(eng._pos).cuda()
    toks = torch.from_numpy(eng._tok).cuda()
    kernel = engine_mod.decode_attention_quant
    layer_rel = {torch.bfloat16: [], torch.float32: []}

    def held(q, kq, ks, vq, vs, pos, scale):
        out = kernel(q, kq, ks, vq, vs, pos, scale=scale)
        for qd in (q, q.float()):
            got = out if qd is q else kernel(qd, kq, ks, vq, vs, pos,
                                             scale=scale)
            want = ops_dec.decode_attention_quant_ref(qd, kq, ks, vq, vs, pos,
                                                      scale=scale)
            layer_rel[got.dtype].append(row_rel_err(got, want))
        return out

    logits = {}
    with torch.no_grad():
        for impl in ("auto", "xla"):
            grid = type(eng._cache)(*(t.clone() for t in eng._cache))
            engine_mod.decode_attention_quant = held if impl == "auto" else kernel
            try:
                logits[impl] = engine_mod._decode_step_impl(
                    params, grid, pos, toks,
                    dataclasses.replace(cfg, attn_impl=impl), eng._freqs)
            finally:
                engine_mod.decode_attention_quant = kernel
            del grid
    for dtype, rels in layer_rel.items():
        tol = ROW_RTOL[dtype]
        print(f"engine_q4: decode step, B2 vs plain int8 einsum on the "
              f"engine's arguments in each of {len(rels)} layers, q "
              f"{dtype}: max_row_rel_err={max(rels)} row_rtol={tol}",
              flush=True)
        if len(rels) != cfg.n_layers or not max(rels) <= tol:
            fail(f"engine_q4: B2 in the engine's step differs from the plain "
                 f"einsum on its arguments: {rels} (tol {tol})")
    lk, lx = logits["auto"], logits["xla"]
    if not (torch.isfinite(lk).all() and lk.shape == (eng.slots, cfg.vocab_size)):
        fail("engine_q4: decode-step logits not finite or of the wrong shape")
    rel = float((lk - lx).norm() / lx.norm())
    same = int((lk.argmax(-1) == lx.argmax(-1)).sum())
    print(f"engine_q4: decode-step logits B2 vs plain int8 einsum, "
          f"{eng.slots} slots at pos {eng._pos.tolist()}: rel_l2={rel} tol_rel_l2="
          f"{DECODE_STEP_REL_L2} argmax agree {same}/{eng.slots}", flush=True)
    if not rel <= DECODE_STEP_REL_L2:
        fail(f"engine_q4: decode-step logits differ, rel L2 {rel} > "
             f"{DECODE_STEP_REL_L2}")
    while eng.step():
        pass
    for h in hs:
        h.result(timeout=0)


def profile_decode(torch, eng, prompts) -> None:
    """Where a decode step's time goes: torch.profiler over 4 steps of a
    full grid (8 slots), after every count above was read."""
    hs = [eng.submit(p[:40], max_new_tokens=8) for p in prompts[:eng.slots]]
    eng.step()                          # admissions + one decode step
    torch.cuda.synchronize()
    profile_steps(torch, "4 decode steps, 8 slots", eng.step, 4)
    while eng.step():
        pass
    for h in hs:
        h.result(timeout=0)


def profile_steps(torch, label, run, n) -> None:
    """torch.profiler over ``n`` calls of ``run``: wall and device-busy ms
    per step, the busy share, and the top device kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernel events only: a CPU op's device time repeats theirs
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    if not events:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    print(f"profile: {label}: wall_ms_per_step="
          f"{wall_us / n / 1e3} device_busy_ms_per_step={busy_us / n / 1e3} "
          f"device_busy_share={busy_us / wall_us}", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"profile: {dev_us(e) / n / 1e3:.4f} ms/step "
              f"({dev_us(e) / busy_us:.3f} of busy) x{e.count // n}/step "
              f"{e.key[:90]}", flush=True)


def drive_training(torch, ops_attn, card):
    """Llama-3.2-1B's shape, full width and depth, bf16, through
    make_train_step: warm-up steps, then timed steps with the launch
    counts set to 0 just before and read just after."""
    from kubetorch_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                                  llama_loss_chunked)
    from kubetorch_tpu_torch.train import (default_optimizer,
                                           init_train_state, make_train_step)

    cfg = LlamaConfig.llama3_1b(max_seq_len=TRAIN_S)
    t0 = time.perf_counter()
    params = llama_init(cfg, seed=0, device="cuda")
    opt = default_optimizer(warmup_steps=2)
    state = init_train_state(params, opt)
    del params
    torch.cuda.synchronize()
    print(f"train: Llama-3.2-1B shape, params {cfg.param_count()}, state "
          f"initialised in {time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; remat "
          f"{'dots' if cfg.remat else 'none'}", flush=True)
    step = make_train_step(
        lambda p, t, y: llama_loss_chunked(p, t, y, cfg, chunk=TRAIN_CHUNK), opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    losses, norms = [], []
    for _ in range(TRAIN_WARM):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()

    ops_attn.flash_attention.launches = 0
    ops_attn.flash_attention.bwd_dq_launches = 0
    ops_attn.flash_attention.bwd_dkv_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = (ops_attn.flash_attention.launches,
              ops_attn.flash_attention.bwd_dq_launches,
              ops_attn.flash_attention.bwd_dkv_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    print(f"train: losses {losses} grad_norms {norms}", flush=True)
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"train: a loss or grad norm is not finite: {losses} {norms}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall: first {losses[0]}, last {losses[-1]}")
    L = cfg.n_layers
    want = (2 * L * TRAIN_STEPS, L * TRAIN_STEPS, L * TRAIN_STEPS)
    if counts != want:
        fail(f"train: launches (A1, A2, A3) {counts} over {TRAIN_STEPS} steps, "
             f"expected {want}: {L} layers, the forward twice under 'dots' remat")
    tps = TRAIN_B * TRAIN_S * TRAIN_STEPS / dt
    model_flops = 6 * cfg.param_count() + 12 * L * cfg.dim * TRAIN_S
    mfu = tps * model_flops / BF16_FLOPS_PER_S
    print(f"train: launches A1 {counts[0]} A2 {counts[1]} A3 {counts[2]} over "
          f"{TRAIN_STEPS} steps of {L} layers", flush=True)
    print(f"train: tokens_per_s={tps} ms_per_step={dt / TRAIN_STEPS * 1e3} "
          f"mfu={mfu} (6P + 12*L*D*S flops per token over 989 TFLOP/s) "
          f"peak_memory_gb={peak_gb} batch={TRAIN_B}x{TRAIN_S} card={card} "
          f"(before the tensor-core A2, PERF.md: {PREV_TRAIN_TOKENS_PER_S} "
          f"tokens/s; no claim)", flush=True)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    profile_steps(torch, f"2 train steps, batch {TRAIN_B}x{TRAIN_S}", one_step, 2)
    check_train_paths(torch, cfg, state.params, tokens)
    return counts, dict(tokens_per_s=tps, mfu=mfu, peak_memory_gb=peak_gb,
                        ms_per_step=dt / TRAIN_STEPS * 1e3)


def check_train_paths(torch, cfg, params, tokens):
    """Kernel path (attn_impl auto) against the plain path (xla): gradients
    in fp32 at 1B width with 2 layers, and the loss in bf16 at full depth."""
    from kubetorch_tpu_torch.models.llama import llama_init, llama_loss_chunked
    from kubetorch_tpu_torch.train import make_train_step
    from kubetorch_tpu_torch.train.optim import tree_leaves

    tok = tokens[:1]
    batch = {"tokens": tok[:, :512], "targets": tok.roll(-1, 1)[:, :512]}
    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                                max_seq_len=512)
    small_params = llama_init(small, seed=3, device="cuda")
    grads = {}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(small, attn_impl=impl)
        step = make_train_step(
            lambda p, t, y: llama_loss_chunked(p, t, y, c, chunk=TRAIN_CHUNK))
        _, grads[impl] = step.loss_and_grads(small_params, batch)
    worst = max(float((a - b).norm() / b.norm())
                for a, b in zip(tree_leaves(grads["auto"]),
                                tree_leaves(grads["xla"])))
    print(f"train: grads kernel vs plain path, fp32, 2 layers, S=512: max "
          f"per-leaf rel_l2={worst} tol={GRAD_REL_L2}", flush=True)
    if not worst <= GRAD_REL_L2:
        fail(f"train: kernel-path grads differ from the plain path: {worst}")
    del grads, small_params
    torch.cuda.empty_cache()

    with torch.no_grad():
        loss = {impl: float(llama_loss_chunked(
            params, tok, tok.roll(-1, 1), dataclasses.replace(cfg, attn_impl=impl),
            chunk=TRAIN_CHUNK)) for impl in ("auto", "xla")}
    diff = abs(loss["auto"] - loss["xla"])
    print(f"train: loss kernel vs plain path, bf16, {cfg.n_layers} layers, "
          f"B=1 S={tok.shape[1]}: {loss['auto']} vs {loss['xla']}, |diff|="
          f"{diff} tol={LOSS_ABS}", flush=True)
    if not (math.isfinite(diff) and diff <= LOSS_ABS):
        fail(f"train: kernel-path loss differs from the plain path by {diff}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import torch.nn.functional as F

        from kubetorch_tpu_torch.ops import _build
        from kubetorch_tpu_torch.ops import attention as ops_attn
        from kubetorch_tpu_torch.ops import decode_attention as ops_dec
        from kubetorch_tpu_torch.ops import quant_matmul as ops_q4
    except ImportError as e:
        fail(f"cannot import the port from {here}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        list(ex.map(_build.load, SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f}s for {len(SOURCES)} sources",
          flush=True)
    check_tensor_core_sass(_build)

    flash = check_flash(torch, F, ops_attn)
    dec = check_decode(torch, F, ops_dec)
    dec_q = check_decode(torch, F, ops_dec, quant=True)
    q4 = check_q4(torch, ops_q4)
    train_k = check_train_kernels(torch, F, ops_attn)
    flash_n, decode_n = drive_engine(torch, ops_attn, ops_dec, card)
    gc.collect()
    torch.cuda.empty_cache()
    quant_n, _ = drive_engine_quant(torch, ops_attn, ops_dec, ops_q4, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_n, train = drive_training(torch, ops_attn, card)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="kubetorch_tpu_torch/csrc/flash_fwd.cu",
             replaces="kubetorch_tpu/ops/attention.py:44",
             launches=train_n[0], path="training (forward with LSE, and "
             "again under remat)", **train_k["fwd"],
             serving=dict(launches=flash_n, **flash),
             serving_quant=dict(launches=quant_n["flash_fwd"])),
        dict(name="decode_attention", route="cuda",
             source="kubetorch_tpu_torch/csrc/decode_attention.cu",
             replaces="kubetorch_tpu/ops/decode_attention.py:46",
             launches=decode_n, path="serving", **dec),
        dict(name="flash_bwd_dq", route="cuda",
             source="kubetorch_tpu_torch/csrc/flash_bwd.cu",
             replaces="kubetorch_tpu/ops/attention.py:140",
             launches=train_n[1], path="training", **train_k["dq"]),
        dict(name="flash_bwd_dkv", route="cuda",
             source="kubetorch_tpu_torch/csrc/flash_bwd.cu",
             replaces="kubetorch_tpu/ops/attention.py:180",
             launches=train_n[2], path="training", **train_k["dkv"]),
        dict(name="decode_attention_quant", route="cuda",
             source="kubetorch_tpu_torch/csrc/decode_attention.cu",
             replaces="kubetorch_tpu/ops/decode_attention.py:46",
             launches=quant_n["decode_attention_quant"],
             path="quantized serving (int8 KV cache)", **dec_q),
        dict(name="q4_matmul", route="cuda",
             source="kubetorch_tpu_torch/csrc/quant_matmul.cu",
             replaces="kubetorch_tpu/ops/quant_matmul.py:31",
             launches=quant_n["q4_matmul"],
             path="quantized serving (int4 weights)", **q4),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
