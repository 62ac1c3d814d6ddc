#!/usr/bin/env python3
"""Flash-decode (B1 and B2) of one checkout of the port, at the decode
shapes of Llama-3-8B's grid, for comparing two checkouts on one card.

    python3 kubetorch_tpu_torch/tools/decode_ab.py [--root DIR] [--profile]

Imports ``kubetorch_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), builds its flash-decode source, and at each shape
holds ``decode_attention`` (bf16 cache) and ``decode_attention_quant``
(int8 cache, bf16 q) to their plain versions per row, then times them
(CUDA-graph replays between CUDA events; B2 also with its inputs cold in
L2). The shapes (``DECODE_SHAPES``: a ragged 8 x 2048 grid, the engine's
fill at 40-token prompts, one request of 8192 rows, the full grid; NH=32,
NKV=8, Hd=128, inputs from seed 0) and the timing (``time_ms``,
``time_cold_ms``) are ``chip_smoke.py``'s, from the checkout that holds
this file.

Prints one JSON line: per shape and kernel ``ms`` (and ``ms_cold_l2`` for
B2) and the row error, with the card's name and power limit. Compare two
checkouts by running each in its own process on the same card,
alternating: A, B, B, A.

``--profile`` (a checkout with the split body) adds, per shape and kernel,
the device time of each CUDA kernel over 20 calls from torch.profiler (the
split pass and the combine pass apart), in microseconds per call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
NH, NKV, HD = 32, 8, 128


def profile_us(torch, fn, calls: int = 20) -> dict:
    """Device microseconds per call of each CUDA kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from chip_smoke import DECODE_SHAPES, card_line, time_cold_ms, time_ms
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from kubetorch_tpu_torch.ops import decode_attention as ops_dec
    from kubetorch_tpu_torch.ops.tolerance import row_rel_err
    from kubetorch_tpu_torch.serve import quantize_rows
    if not torch.cuda.is_available():
        sys.exit("decode_ab: needs a card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": os.path.abspath(args.root), "card": card_line()}
    for name, (b, s, pos_list) in DECODE_SHAPES.items():
        q = torch.randn(b, NH, HD, generator=gen, device="cuda").bfloat16()
        kf = torch.randn(b, s, NKV, HD, generator=gen, device="cuda")
        vf = torch.randn(b, s, NKV, HD, generator=gen, device="cuda")
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        ck, cv = kf.bfloat16(), vf.bfloat16()
        kq, ks = quantize_rows(kf)
        vq, vs = quantize_rows(vf)
        del kf, vf
        b1 = row_rel_err(ops_dec.decode_attention(q, ck, cv, pos),
                         ops_dec.decode_attention_ref(q, ck, cv, pos))
        b2 = row_rel_err(ops_dec.decode_attention_quant(q, kq, ks, vq, vs, pos),
                         ops_dec.decode_attention_quant_ref(q, kq, ks, vq, vs, pos))
        out[name] = dict(
            b1_ms=time_ms(torch, lambda: ops_dec.decode_attention(q, ck, cv, pos)),
            b2_ms=time_ms(torch, lambda: ops_dec.decode_attention_quant(
                q, kq, ks, vq, vs, pos)),
            b2_ms_cold_l2=time_cold_ms(torch, ops_dec.decode_attention_quant,
                                       (q, kq, ks, vq, vs, pos)),
            b1_row_err=b1, b2_row_err=b2)
        if args.profile:
            out[name]["b1_kernels_us"] = profile_us(
                torch, lambda: ops_dec.decode_attention(q, ck, cv, pos))
            out[name]["b2_kernels_us"] = profile_us(
                torch, lambda: ops_dec.decode_attention_quant(q, kq, ks, vq, vs, pos))
        del q, ck, cv, kq, ks, vq, vs
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
