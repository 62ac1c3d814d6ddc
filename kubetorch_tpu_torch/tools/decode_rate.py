#!/usr/bin/env python3
"""Steady decode rate of the port's GenerationEngine on one card, for
comparing two checkouts of the port on the same card.

    python3 kubetorch_tpu_torch/tools/decode_rate.py [--root DIR]
        [--steps N] [--quant]

Imports ``kubetorch_tpu_torch`` from ``--root`` (default: the checkout
that holds this file) and serves Llama-3-8B at full width and depth,
random weights from seed 0 (bf16, or with ``--quant`` int4 weights in
groups of 128 and an int8 KV cache), with 8 slots of 128-token prompts
and max_len 2048. After a warm-up round it admits a full grid, then times
``--steps`` engine steps that decode all 8 slots and admit nothing, each
ended by a device sync. It also times, on the host, the per-step walk
that slices every layer's weights out of the stacked tree
(``layer_weights``), and that walk with ``dequant_layer`` applied to each
layer where the checkout has it.

Prints one JSON line: ms per step (median, mean, min, max), tokens/s at
the median, the host walks in microseconds per step, and the card's name
and power limit. Compare two checkouts by running each in its own process
on the same card, alternating: A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SLOTS, PROMPT, MAX_LEN = 8, 128, 2048


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def host_walk_us(params, n_layers: int, dequant=None, reps: int = 200) -> float:
    """Host microseconds of one step's per-layer weight walk."""
    from kubetorch_tpu_torch.models.llama import layer_weights
    t = time.perf_counter()
    for _ in range(reps):
        for i in range(n_layers):
            lw = layer_weights(params, i)
            if dequant is not None:
                dequant(lw)
    return (time.perf_counter() - t) / reps * 1e6


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--quant", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_rate: needs a CUDA card")
    from kubetorch_tpu_torch.models import quant as quant_mod
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.serve import GenerationEngine

    cfg = LlamaConfig.llama3_8b()
    if args.quant:
        params = quant_mod.llama_init_quantized(cfg, bits=4, seed=0,
                                                device="cuda")
    else:
        params = llama_init(cfg, seed=0, device="cuda")
    eng = GenerationEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                           prefill_buckets=(128, 256, 512, 1024),
                           quantize_kv=args.quant, device="cuda")
    rng = np.random.default_rng(0)

    def fill(max_new: int):
        return [eng.submit(rng.integers(0, cfg.vocab_size, PROMPT).tolist(),
                           max_new_tokens=max_new) for _ in range(SLOTS)]

    with torch.no_grad():
        warm = fill(8)
        while eng.step():
            pass
        for h in warm:
            h.result(timeout=0)

        handles = fill(args.steps + 2)
        eng.step()                        # admissions + one decode step
        torch.cuda.synchronize()
        times = []
        for _ in range(args.steps):
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        while eng.step():
            pass
    for h in handles:
        if len(h.result(timeout=0)) != args.steps + 2:
            sys.exit("decode_rate: a request came back short")

    walk = host_walk_us(params, cfg.n_layers)
    deq = getattr(quant_mod, "dequant_layer", None)
    walk_deq = (host_walk_us(params, cfg.n_layers,
                             lambda lw: deq(lw, cfg.dtype))
                if deq is not None else None)
    med = statistics.median(times)
    print(json.dumps(dict(
        root=root, model="llama3_8b", weights="int4" if args.quant else "bf16",
        kv_cache="int8" if args.quant else "bf16", slots=SLOTS,
        steps=args.steps, ms_per_step_median=med,
        ms_per_step_mean=statistics.fmean(times), ms_per_step_min=min(times),
        ms_per_step_max=max(times), tok_per_s_at_median=SLOTS / med * 1e3,
        host_layer_walk_us_per_step=walk,
        host_layer_walk_with_dequant_layer_us_per_step=walk_deq,
        card=card_line())), flush=True)


if __name__ == "__main__":
    main()
