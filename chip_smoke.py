#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (kubetorch_tpu_torch) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit; fails without CUDA.
2. Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel).
3. Holds each kernel against its plain PyTorch version at the engine's
   shapes, in bf16 and fp32, row by row (kubetorch_tpu_torch/ops/
   tolerance.py), and times kernel, plain version and the nearest single
   PyTorch call (scaled_dot_product_attention, a yardstick the port never
   calls) in CUDA graphs beside the card's least time for the same work.
4. Serves Llama-3-8B at full width (random weights from a seed) through
   GenerationEngine: 8 slots, max_len 2048, greedy, 12 requests with
   prompts over every prefill bucket, admitted while others decode. Checks
   that every request completes, that the flash-prefill and flash-decode
   kernels carried the run, and that the first-token logits of the kernel
   path agree with the plain path (attn_impl="xla").
5. Prints one JSON line of per-kernel numbers, the card line, and as the
   last line {"ok": true, "device": {...}}.

Any failed phase exits non-zero and prints no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
ENGINE_PROMPT_LENS = (40, 128, 200, 256, 300, 480, 512, 700, 1000, 1024,
                      1500, 1990)
MAX_NEW = 32


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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the bf16 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_flash(torch, F, ops_attn):
    """A1 at B=1, N=32, NKV=8, Hd=128, causal, at each prefill T: bf16 (the
    engine's type) and fp32 against the plain version, then bf16 times."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = None
    for t in (128, 512, 1024):
        q = torch.randn(1, t, 32, 128, generator=gen, device="cuda")
        k = torch.randn(1, t, 8, 128, generator=gen, device="cuda")
        v = torch.randn(1, t, 8, 128, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            got = ops_attn.flash_attention(q, k, v, causal=True)
            want = ops_attn.flash_attention_ref(q, k, v, causal=True)
            err, rel = compare(f"flash_fwd T={t}", got, want)
        ms = time_ms(torch, lambda: ops_attn.flash_attention(q, k, v))
        plain = time_ms(torch, lambda: ops_attn.flash_attention_ref(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = (2 * 32 + 2 * 8) * t * 128 * 2
        flops = 4 * 32 * 128 * t * (t + 1) / 2
        b_ms, b_by = bound(nbytes, flops)
        print(f"kernel flash_fwd T={t} bf16: ms={ms} plain_ms={plain} "
              f"sdpa_ms={lib} bound_ms={b_ms} ({b_by})", flush=True)
        rec = dict(max_abs_err=err, max_row_rel_err=rel, ms=ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib,
                   shape=f"B=1 T={t} N=32 NKV=8 Hd=128 bf16 causal")
    return rec


def check_decode(torch, F, ops_dec):
    """B1 at the engine's grid: B=8, S=2048, NKV=8, NH=32, Hd=128; bf16 and
    fp32 against the plain version, then bf16 times."""
    b, s, nh, nkv, hd = 8, 2048, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(b, nh, hd, generator=gen, device="cuda")
    ck = torch.randn(b, s, nkv, hd, generator=gen, device="cuda")
    cv = torch.randn(b, s, nkv, hd, generator=gen, device="cuda")
    # 0, tile edges (63/64), mid values and the last row S-1
    pos_list = [0, 63, 64, 700, 1024, 1500, 2000, s - 1]
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, ck, cv = q.to(dtype), ck.to(dtype), cv.to(dtype)
        got = ops_dec.decode_attention(q, ck, cv, pos)
        want = ops_dec.decode_attention_ref(q, ck, cv, pos)
        err, rel = compare("decode_attention", got, want)
    ms = time_ms(torch, lambda: ops_dec.decode_attention(q, ck, cv, pos))
    plain = time_ms(torch, lambda: ops_dec.decode_attention_ref(q, ck, cv, pos))
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None]
    q4, kt, vt = q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, kt, vt, attn_mask=mask, enable_gqa=True))
    live = sum(min(p + 1, s) for p in pos_list)
    nbytes = 2 * b * nh * hd * 2 + 2 * live * nkv * hd * 2 + 4 * b
    flops = 4 * nh * hd * live
    b_ms, b_by = bound(nbytes, flops)
    print(f"kernel decode_attention B={b} S={s} pos={pos_list} bf16: "
          f"ms={ms} plain_ms={plain} sdpa_ms={lib} bound_ms={b_ms} "
          f"({b_by})", flush=True)
    return dict(max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                shape=f"B={b} S={s} NH={nh} NKV={nkv} Hd={hd} bf16")


def drive_engine(torch, ops_attn, ops_dec, card):
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod

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
    flash_n = ops_attn.flash_attention.launches
    decode_n = ops_dec.decode_attention.launches
    steps = eng.stats().decode_steps - steps0

    outs = [h.result(timeout=0) for h in handles]
    if len(outs) != len(prompts):
        fail(f"engine: {len(outs)} of {len(prompts)} requests came back")
    for n, o in zip(ENGINE_PROMPT_LENS, outs):
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"engine: prompt of {n} tokens gave {len(o)} tokens {o[:8]}")
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
    print(f"engine: decode_tok_per_s={decode_tokens / decode_time} "
          f"(tokens of steps without admission / their wall time) "
          f"mean_ttft_s={sum(ttft) / len(ttft)} (submit to first token, "
          f"queueing included) card={card}", flush=True)

    # first-token logits: kernel path vs plain path (attn_impl="xla")
    n = 300
    toks = torch.zeros((1, 512), dtype=torch.long)
    toks[0, :n] = torch.tensor(prompts[4])
    toks = toks.cuda()
    with torch.no_grad():
        lk, _, _ = engine_mod._prefill_logits(params, toks, n, cfg, eng._freqs)
        cfg_x = dataclasses.replace(cfg, attn_impl="xla")
        lx, _, _ = engine_mod._prefill_logits(params, toks, n, cfg_x,
                                              eng._freqs)
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        fail("engine: first-token logits not finite or of the wrong shape")
    rel = float((lk - lx).norm() / lx.norm())
    max_abs = float((lk - lx).abs().max())
    # the two paths differ only in attention numerics (fp32 P in the flash
    # kernel, P rounded to bf16 in the plain cached attention) and then run
    # the same bf16 layers; 32 layers of bf16 rounding keep the logits
    # within a few percent of each other, relative in the L2 norm
    tol = 5e-2
    print(f"engine: first-token logits kernel vs plain: rel_l2={rel} "
          f"max_abs={max_abs} tol_rel_l2={tol} argmax "
          f"{int(lk.argmax())}/{int(lx.argmax())}", flush=True)
    if not rel <= tol:
        fail(f"engine: first-token logits differ, rel L2 {rel} > {tol}")
    profile_decode(torch, eng, prompts)
    return flash_n, decode_n


def profile_decode(torch, eng, prompts) -> None:
    """Where a decode step's time goes: torch.profiler over 4 steps of a
    full grid (8 slots), after every count above was read."""
    from torch.profiler import ProfilerActivity, profile

    hs = [eng.submit(p[:40], max_new_tokens=8) for p in prompts[:eng.slots]]
    eng.step()                          # admissions + one decode step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    while eng.step():
        pass
    for h in hs:
        h.result(timeout=0)

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
    print(f"profile: 4 decode steps, 8 slots: wall_ms_per_step="
          f"{wall_us / 4e3} device_busy_ms_per_step={busy_us / 4e3} "
          f"device_busy_share={busy_us / wall_us}", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"profile: {dev_us(e) / 4e3:.4f} ms/step "
              f"({dev_us(e) / busy_us:.3f} of busy) x{e.count // 4}/step "
              f"{e.key[:90]}", flush=True)


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
    except ImportError as e:
        fail(f"cannot import the port from {here}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _build.build_all(["flash_fwd", "decode_attention"])
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    flash = check_flash(torch, F, ops_attn)
    dec = check_decode(torch, F, ops_dec)
    flash_n, decode_n = drive_engine(torch, ops_attn, ops_dec, card)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="kubetorch_tpu_torch/csrc/flash_fwd.cu",
             replaces="kubetorch_tpu/ops/attention.py:44",
             launches=flash_n, **flash),
        dict(name="decode_attention", route="cuda",
             source="kubetorch_tpu_torch/csrc/decode_attention.cu",
             replaces="kubetorch_tpu/ops/decode_attention.py:46",
             launches=decode_n, **dec),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
