#!/usr/bin/env python3
"""What splitting P and dS into two bf16 halves costs the tensor-core A1,
A2 and A3, on one card.

    python3 kubetorch_tpu_torch/tools/split_cost.py [--pairs N]

Builds ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` twice: as the
checkout has them, and from a copy of ``csrc/`` in a temporary directory
in which the register-A wgmma of P.V (A1), of dS.K (A2) and of P^T.dO
and dS^T.Q (A3) takes the hi half only, so that P and dS are rounded to
bf16 as SDPA and FlashAttention round them. The rounded build is a
measurement and nothing else: the port never loads it. Times A1 with its
LSE, A2 and A3 at the training shape (B=4, S=2048, N=32, NKV=8, Hd=64, bf16, causal) on each
build, in the order split, rounded, rounded, split (``--pairs`` times),
each time as 20 calls captured in a CUDA graph and replayed 5 times
between CUDA events, and holds each build's outputs to the plain versions
per row (``ops/tolerance.py``). Prints one JSON line with the times, the
row errors, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

B, S, NH, NKV, HD = 4, 2048, 32, 8, 64
# the lo-half issues of the register-A products:
# wgmma_rs(o | dq | dv | dk, pl | sl ...)
LO_ISSUE = re.compile(r"\n\s*wgmma_rs\((o|dq|dv|dk), (pl|sl)\[[^;]*;")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device ms of one call: ``iters`` calls in one CUDA graph, replayed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def build_rounded(_build, work: str) -> dict:
    """flash_fwd and flash_bwd from a copy of csrc/ without the lo issues."""
    csrc = os.path.join(work, "csrc")
    shutil.copytree(_build.CSRC, csrc)
    libs = {}
    for name, want in (("flash_fwd", 1), ("flash_bwd", 3)):
        path = os.path.join(csrc, f"{name}.cu")
        with open(path) as f:
            src, n = LO_ISSUE.subn("\n", f.read())
        if n != want:
            raise RuntimeError(f"{name}.cu: found {n} lo-half issues, expected {want}")
        with open(path, "w") as f:
            f.write(src)
        out = os.path.join(work, f"{name}.so")
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
                               out, path], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the rounded {name}.cu:\n{proc.stderr}")
        libs[name] = ctypes.CDLL(out)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("split_cost: needs a card")
    from kubetorch_tpu_torch.ops import _build
    from kubetorch_tpu_torch.ops import attention as A
    from kubetorch_tpu_torch.ops.tolerance import grad_row_rel_err, row_rel_err

    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"split": {n: _build.load(n) for n in ("flash_fwd", "flash_bwd")}}
    work = tempfile.mkdtemp(prefix="split_cost_")
    try:
        builds["rounded"] = build_rounded(_build, work)
        gen = torch.Generator(device="cuda").manual_seed(4)
        q, k, v, do = (torch.randn(B, S, n, HD, generator=gen, device="cuda").bfloat16()
                       for n in (NH, NKV, NKV, NH))
        scale = HD ** -0.5
        out_ref, lse_ref = A.flash_attention_fwd_ref(q, k, v)
        delta = A.attention_delta(out_ref, do)
        dq_ref = A.flash_attention_bwd_dq_ref(q, k, v, do, lse_ref, delta)
        dk_ref, dv_ref = A.flash_attention_bwd_dkv_ref(q, k, v, do, lse_ref, delta)
        runs = {"split": [], "rounded": []}
        errs = {}
        for which in ["split", "rounded", "rounded", "split"] * args.pairs:
            _build._libs.update(builds[which])
            out, _ = A._launch(q, k, v, True, scale, need_lse=True)
            dq = A.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta)
            dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta)
            errs[which] = dict(out=row_rel_err(out, out_ref),
                               dq=grad_row_rel_err(dq, dq_ref),
                               dk=grad_row_rel_err(dk, dk_ref),
                               dv=grad_row_rel_err(dv, dv_ref))
            runs[which].append(dict(
                fwd_lse_ms=time_ms(torch, lambda: A._launch(q, k, v, True, scale,
                                                             need_lse=True)),
                dq_ms=time_ms(torch, lambda: A.flash_attention_bwd_dq(
                    q, k, v, do, lse_ref, delta)),
                dkv_ms=time_ms(torch, lambda: A.flash_attention_bwd_dkv(
                    q, k, v, do, lse_ref, delta))))
        _build._libs.update(builds["split"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"shape": f"B={B} S={S} N={NH} NKV={NKV} Hd={HD} bf16 causal",
                      "runs": runs, "row_errors": errs, "card": card_line()}))


if __name__ == "__main__":
    main()
