#!/usr/bin/env python3
"""Where the int4 matmul's prefill body (``csrc/quant_matmul.cu:q4_wgmma``)
spends its time, on one card.

    python3 kubetorch_tpu_torch/tools/q4_probe.py

Builds ``csrc/quant_matmul.cu`` as the checkout has it and three scratch
variants from a copy in a temporary directory: without the unpack of the
packed tile into the register-A fragments (the products then read
whatever the registers hold), without the wgmma products, and without
both (what is left: the TMA ring, its barriers and the epilogue). The variants
compute nothing right and the port never loads them: they are a
measurement. Times each at 2048 rows of Llama-3-8B's widest projections
and at 300 rows of (4096, 4096), group 128, as 20 calls between CUDA
events after a warm-up, in the order of the list, and holds the unchanged
build to the plain version per row (``ops/tolerance.py``). Prints one JSON
line with the times, the row errors, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

SHAPES = ((2048, 4096, 14336), (2048, 14336, 4096), (300, 4096, 4096))
GROUP = 128
UNPACK = re.compile(r"\n\s*a_fragments<(true|false)>\([^;]*;")
WGMMA = re.compile(r"\n\s*wgmma_rs_kb\(part,[^;]*;")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cut(src: str, pattern, want: int) -> str:
    """``src`` with each of the ``want`` statements ``pattern`` matches
    replaced by an empty statement."""
    out, n = pattern.subn("\n;", src)
    if n != want:
        raise RuntimeError(f"found {n} matches of {pattern.pattern}, expected {want}")
    return out


def build(_build, work: str, name: str, src: str):
    path = os.path.join(work, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(work, f"{name}.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", work, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {name} variant:\n{proc.stderr}")
    fn = ctypes.CDLL(out).kt_q4_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("q4_probe: needs a card")
    from kubetorch_tpu_torch.models.quant import _quantize_leaf_int4
    from kubetorch_tpu_torch.ops import _build
    from kubetorch_tpu_torch.ops.quant_matmul import q4_matmul_ref
    from kubetorch_tpu_torch.ops.tolerance import row_rel_err

    src = (_build.CSRC / "quant_matmul.cu").read_text()
    variants = {"body": src, "no_unpack": cut(src, UNPACK, 2),
                "no_wgmma": cut(src, WGMMA, 1),
                "no_unpack_no_wgmma": cut(cut(src, UNPACK, 2), WGMMA, 1)}
    work = tempfile.mkdtemp(prefix="q4_probe_")
    try:
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, work)
        fns = {name: build(_build, work, name, text) for name, text in variants.items()}
        gen = torch.Generator(device="cuda").manual_seed(6)
        times, errs = {}, {}
        stream = torch.cuda.current_stream().cuda_stream
        for m, k, n in SHAPES:
            w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
            leaf = _quantize_leaf_int4(w, group=GROUP)
            packed, scale = leaf["__kt_q4__"], leaf["scale"]
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            out = torch.empty(m, n, device="cuda")
            shape = f"M={m} K={k} N={n}"
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                             out.data_ptr(), None, m, n, k, scale.shape[0], 1, stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                call()
                if name == "body":
                    torch.cuda.synchronize()
                    errs[shape] = row_rel_err(out, q4_matmul_ref(x, packed, scale))
                times[f"{shape} {name}"] = time_ms(torch, call)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"group": GROUP, "ms": times, "row_errors": errs,
                      "card": card_line()}))


if __name__ == "__main__":
    main()
