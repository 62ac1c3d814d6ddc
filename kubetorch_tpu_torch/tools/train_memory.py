#!/usr/bin/env python3
"""Peak device memory of one training step with the in-place update
(``make_train_step(donate=True)``) and with the functional one
(``donate=False``), on one card.

    python3 kubetorch_tpu_torch/tools/train_memory.py [--layers N]

Mixtral-8x7B's width at ``--layers`` of its 32 layers (default 2, the
``moe_train`` phase of ``chip_smoke.py``), bf16, ``default_optimizer``,
``moe_loss`` on one 4 x 2048 batch from a seed, the flash kernels. Each
variant takes one warm step and one measured step on its own fresh train
state: peak allocated memory over the measured step, or the size of the
allocation that failed and what was allocated then, when the card runs
out. Prints one JSON line with both, the params and optimizer state's GB,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "..", ".."))
    import numpy as np
    import torch

    from kubetorch_tpu_torch.models.moe import MoeConfig, moe_init, moe_loss
    from kubetorch_tpu_torch.train import (default_optimizer, init_train_state,
                                           make_train_step)

    if not torch.cuda.is_available():
        sys.exit("train_memory: needs a card")
    cfg = MoeConfig.mixtral_8x7b(n_layers=args.layers, max_seq_len=2048)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 2048))).cuda()
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    out = {"card": card_line(), "layers": args.layers,
           "params": cfg.param_count()}
    for donate in (True, False):
        opt = default_optimizer(warmup_steps=2)
        state = init_train_state(moe_init(cfg, seed=0, device="cuda"), opt)
        step = make_train_step(lambda p, t, y: moe_loss(p, t, y, cfg), opt,
                               donate=donate)
        torch.cuda.synchronize()
        out["state_gb"] = torch.cuda.memory_allocated() / 1e9
        key = "in_place" if donate else "functional"
        try:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            out[key] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        except torch.cuda.OutOfMemoryError as e:
            out[key] = {"out_of_memory": str(e).splitlines()[0][:200],
                        "allocated_gb": torch.cuda.memory_allocated() / 1e9}
        del state, step, opt
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
