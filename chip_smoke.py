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
   bitwise equal over two calls, B2 also cold in L2, and B1 again at the
   Llama-3.2-1B draft's head dim 64 at shapes (a) and (d); the int4 matmul
   (B3) at Llama-3-8B's projections, 1, 8 and 17 rows (both bodies'
   edges), a ragged 300, the speculative verify window's 72 rows and
   2048-row prefills, each through the body kt_q4_matmul_body reports; A1 with its LSE, dQ (A2)
   and dK/dV (A3) at the 1B training shape (head dim 64), at the 8B and
   Mixtral training shape (4 x 2048, head dim 128) and at head dim 128,
   B=1, S=1024; and non-causal at ViT-B/16's attention (B=256, S=196,
   N=12, Hd 64: the 196 rows a ragged tile in q and k), warm and cold in
   L2 beside SDPA non-causal and the bound counted non-causally. For the
   tensor-core A1, A2 and A3 and for B3 also TFLOP/s of the counted work,
   the share of the bound and, on the printed line only, the previous
   design's bf16 time (quoted from PERF.md, not measured here); for B1 and
   B2 the share of the bound also in the kernels line; for A1-A3
   the fp32-FMA body's time on fp32 inputs of the same shape (measured).
4. Serves Llama-3-8B at full width and CUT_LAYERS (8) of its 32 layers
   (random weights from a seed) through
   GenerationEngine: 8 slots, max_len 2048, greedy, 12 requests with
   prompts over every prefill bucket, admitted while others decode. Checks
   that every request completes, that the flash-prefill and flash-decode
   kernels carried the run, and that the first-token logits of the kernel
   path agree with the plain path (attn_impl="xla"). Then the engine's
   request features on the same params and grid, each run with exact
   launch counts (A1 once per layer for every from-zero prefill at a
   128-multiple bucket, registrations and first chunks included, none for
   a suffix pass; B1 once per layer and decode step): a registered
   1000-token prefix with four prefix_id requests and four full prompts
   matched by auto_prefix (first-token logits of two of them against the
   full prompt one-shot, their slot rows against the one-shot rows, the
   stored prefix rows bitwise unchanged, mean TTFT of the hits beside the
   same prompts one-shot); an 1800-token prompt admitted in chunks of 512
   beside 7 decoding slots (first-token logits against one-shot, the wall
   of each step that carried a chunk beside the one-shot admission's);
   and a logit_bias request and a presence-penalty request beside 6 plain
   ones (the bias forces its token every time, the penalty repeats
   nothing, the plain requests' tokens and logprobs are bit-identical to
   a run without the two; decode tokens/s with and without them). Then
   multi-LoRA on the same params: three adapters (rank 16, alpha 32,
   wq/wk/wv/wo, B factors drawn from a seed), eight requests, two on the
   base model and two on each adapter, with exact A1/B1 counts; the base
   requests' tokens and logprobs bit-identical to the same run on the
   engine without banks; each adapter request's first-token logits
   against its prompt one-shot on merge_lora weights; one adapter
   unregistered mid-decode (its slots repointed to the base model and
   finished); a prefix registered through an adapter matched by
   auto_prefix for that adapter's request and not for a base one; decode
   ms/step with the three adapters active beside the grid with none.
   Then a LoRA fine-tune of these params at full width, CUT_LAYERS layers
   ("lora_train"; the plain engine freed first, the base never copied):
   rank 16 on wq/wk/wv/wo, lora_loss through make_train_step with
   adamw(1e-3), remat "dots", chunked CE, 5 steps on one seeded 4 x 2048
   batch fed through prefetch_to_device: the loss falls, the step-0 loss
   is within LOSS_ABS of the plain attention path, every base leaf hashes
   the same after training, exact A1/A2/A3 counts (2L/L/L a step), 5
   kt_train_step_seconds{phase="compute"} observations, adapter gradients
   of the kernel path within TRAIN_GRAD_REL of the plain path in fp32 at 2
   layers, a profiled step; then the trained adapter served merged
   (merge_lora -> a new engine) and banked (registered into the LoRA
   phase's engine), first-token logits of the banked requests against the
   merged engine's within LOGITS_REL_L2, exact A1/B1 counts both ways.
   Then the trained tree goes live ("rollout"): a plain bf16 engine on the
   base params, running its loop thread, serves LORA_SERVE_PROMPTS; the
   trainer side hands the merged tree to the host and publish_rollout()s
   it into an in-memory store (MemStore); a WeightRollout replica builds
   its ledger (every leaf pulled and hashed, timed alone), then from a
   second thread polls and swaps while 8 requests decode. Gates: 4 leaves
   changed (wq/wk/wv/wo) and exactly their bytes fetched, the swap on the
   engine's loop thread, the replica's fingerprint the trainer's, every
   in-flight request still in flight at the swap's end and finished with
   all its tokens, the device-memory rise across the swap at most one
   leaf, the prompts then giving the merged engine's tokens exactly; a
   rollback manifest restores the base leaves (on-card hashes equal), the
   base fingerprint and the base tokens; exact A1/B1 counts, one feedback
   payload per request. Prints kt_rollout_seconds per phase, the longest
   token gap of a stream across the swap, the ledger, publish and
   rollback times, __kt_metrics__ and aot_stats.
   Then the continuous-learning loop closed on the same params
   ("flywheel", kubetorch_tpu_torch/flywheel/): (a) a bf16 engine (its own
   copies of wq/wk/wv/wo, which its swaps write) serves the 12 requests
   with its feedback_sink on engine_feedback_hook(FeedbackLedger) over the
   stand-in HTTP store, the hook timed on the step thread; the ledger's
   hashes must be the payloads', one for one; (b) a Harvester over an
   acquired LedgerCursor takes one rank-16 lora_loss step per 4 harvested
   prompts (A1, A2, A3), commits the cursor state before each
   Checkpointer save onto MemStore, and a drain asked for after its
   second step must vacate inside the grace; a clean second cycle drains
   the ledger: consumed == the 12 acked records, a re-appended payload
   deduplicated, every hash folded once; (c) the Promoter, the engine as
   the canary replica under WeightRollout and a scripted router: the
   trained adapter merged is promoted (tokens == a fresh engine's over the
   merged tree, at the canary and after the fleet manifest), a poisoned
   delta (the same steps ascending the loss) is gate_rejected on the
   replayed rows (no manifest, tokens unchanged), and again with the eval
   gate blinded and a regressed canary is rolled_back
   (manifest at the promoted fingerprint, baseline unmoved, tokens as
   before); kt_flywheel_gate_total 1/1/1, exact A1/A2/A3/B1 counts, the
   phase's parts and a feedback-to-weights-live time printed.
   Then speculative decoding (SpeculativeEngine, spec_k 4, the same grid
   with prefill_chunk 512) with a draft of Llama-3.2-1B's shape (bf16,
   its own seed), and again with the target as its own draft: the 12
   prompts, a 100-token suffix behind a registered 1000-token prefix and
   an 1800-token prompt, with exact launch counts (A1 per layer of both
   models in every from-zero pass, B1 per draft layer in each of a
   round's k-1 draft decode steps, B2 none); the verify window's logits
   at each slot's first window position against the plain engine's
   decode step over the same grid, within 5e-2; self-draft acceptance at
   least 0.5; tokens/s, tokens per target pass, acceptance and TTFT
   beside the plain engine's rate on the same prompts, the wall of a
   round's three passes and a 2-round profile. Then speculative_generate
   on one 300-token prompt (plain attention only: no launches), and fp32
   exactness at Llama-3-8B's width with 2 layers: SpeculativeEngine's
   greedy tokens, with an independent draft and with self-draft, equal to
   the plain engine's on 4 requests.
   Then a published checkpoint through the OpenAI surface ("hf_openai"):
   the seed tree (norms drawn from a seed and rounded to bf16) written by
   the script's own safetensors writer and inverse RoPE permutation (an
   index map) in the layout of Meta's meta-llama/Meta-Llama-3-8B
   repository at CUT_LAYERS of its 32 layers (its config.json with that
   depth, bf16 shards of at most 5 GB, two at this depth, the index),
   after a check of the free disk; load_hf onto the card: every
   leaf bitwise the seed tree's (load seconds, GB/s, host RSS rise, device
   bytes). A second directory at the same width, 2 layers, fp32, with
   Llama-3.1-8B's rope_scaling: llama_forward on its load_hf within 1e-4
   relative L2 of the script's HF-convention forward (rotate_half, the
   llama3 frequency scaling) over 4 prompts of up to 512 tokens; save_hf
   of that tree and load_hf of the export bitwise equal. Then
   GenerationEngine (the engine phases' grid, auto_prefix) on the loaded
   tree with an OpenAIApp over it, driven through its plain methods: the
   12 prompts one at a time (4 also through engine.generate: equal
   tokens), a stream equal to the blocking call, logprobs equal to the
   handle's, a token-id stop's finish_reason, a chat completion through a
   byte-level stand-in tokenizer, seeded n = 2 reproducible and distinct,
   the 12 prompts from 12 threads (first tokens equal, first logprobs
   within 2e-2), a registered 1000-token prefix hit by auto_prefix with
   the one-shot prompt's first token and JAX's unregister payloads,
   embeddings of 128, 1000 and 2048 tokens within 5e-2 of pooled
   plain-attention hidden states; exact A1/B1 counts in every run; prints
   the first SSE chunk's latency beside a direct submit's first token and
   8 streams' decode tokens/s through the surface beside the engine alone.
5. Serves Llama-3-8B again, full width at CUT_LAYERS (8) of its 32 layers,
   quantized: int4 weights
   (group 128, llama_init_quantized) and an int8 KV cache
   (quantize_kv=True), the same warm-up and 12 requests. Checks that every
   request completes, that A1, B3 and B2 carried the run with exact launch
   counts (B1 none), that the first-token logits agree with the same
   weights dequantized to bf16 on the plain path, and that one decode
   step's logits agree between B2 and the plain int8 einsum from the same
   grid state, with B2's output in every layer of that step held per row
   to the plain einsum on the engine's own arguments; prints decode
   tokens/s, TTFT, weight and cache GB and a decode profile. Then one
   prefix hit behind a registered 1000-token prefix and one 1800-token
   prompt in chunks of 512 on the same weights and an int8 grid: exact
   launch counts (A1 for the registration and the first chunk, B3 for 7
   projections per layer in every prefill pass and decode step, B2 per
   layer and step) and first-token logits against one-shot prefills.
   Then one LoRA adapter request beside four base ones on these weights:
   exact A1/B3/B2 counts, the adapter's first-token logits against the
   weights dequantized to bf16 and merged, on the plain path. Then the
   speculative phase on these weights with the bf16 1B draft: B3 also in
   every verify window (72 rows), the window's logits against the plain
   int8 decode step (B2).
6. Serves Mixtral-8x7B at full width and CUT_LAYERS (8) of its 32
   layers (random weights from a seed, built on the card one matrix at a time in quantize_params_int4's
   layout: int8 experts, int4 attention and head) with an int8 KV cache:
   the engine phases' warm-up and 12 requests on 8 slots (decode through
   the expert dispatch), exact launch counts (A1 per prefill, B3 on the
   four attention projections per pass and step, B2 per step, B1 none),
   first-token logits against the plain path (int4 leaves dequantized to
   bf16, experts int8), layer 0's FFN of a decode step through the gather
   and the dispatch held per row on the engine's own hidden state, a
   decode profile; then 4 requests on a 2-slot engine, whose decode takes
   the gather, with the same exact counts. Prints decode tokens/s, TTFT,
   weight, cache and peak GB, and each new phase its wall time. Then
   trains Mixtral-8x7B's width at 2 of its 32 layers ("moe_train", bf16,
   default_optimizer, moe_loss, 5 steps through prefetch_to_device): the
   loss falls, the router aux term is finite and positive, exact A1/A2/A3
   counts (4/2/2 a step), a profiled step; one lora_loss step over the
   trained MoE base (wq/wv; moe_loss by default); and, in fp32 on the
   same 2 layers, the loss and every leaf's gradient of the kernel path
   within TRAIN_GRAD_REL of the plain path, after asserting that both
   paths chose the same experts and kept the same pairs (pinned to the
   kernel path's choices where a near-tie router flips, and said so).
7. Trains Llama-3.2-1B's shape (LlamaConfig.llama3_1b, full width and
   depth, bf16, random weights from a seed) with make_train_step and
   default_optimizer on one batch of 4 x 2048 tokens: warm-up steps, then
   timed steps. Checks finite, falling losses and that A1, A2 and A3
   carried every layer of every step; prints tokens/s, ms/step, MFU, peak
   memory and a 2-step profile. Then the run is checkpointed
   ("checkpoint"): a blocking snapshot and its fingerprint after step k,
   Checkpointer.maybe_save (async) and step k + 1 at once (donate=True,
   in place), flush; the commit must fingerprint as the snapshot, and
   restored onto the card its next step must give step k + 1's loss
   exactly; a save torn at its commit marker leaves the commit on step k,
   and the same state saved again moves no bytes; exact A1/A2/A3 counts.
   Prints the state's bytes, the snapshot stall, commit and restore
   seconds. Then holds the kernel path's gradients to
   the plain path's (fp32, 2 layers) and its loss (bf16, full depth).
   Then ViT-B/16 at full width and depth ("vit", bf16, remat, weights from
   a seed, 256 seeded 224² images with 1000-class labels): the forward's
   logits within LOGITS_REL_L2 of the plain attention path with exactly
   12 A1 launches a forward, images/s; 5 adamw steps of vit_loss through
   make_train_step on the one batch fed through prefetch_to_device (the
   loss falls, the step-0 loss within LOSS_ABS of the plain path's, A1/A2/
   A3 exactly 24/12/12 a step), images/s, peak memory, a 2-step profile;
   fp32 gradients at 2 layers within GRAD_REL_L2 of the plain path. Then
   the same model as a fabric rank ("fabric"): this script started again
   as a process of its own (--fabric-rank), as the fabric starts a torch
   rank, with the env keys the fabric's PyTorchEnv injects (rank 0 of 1,
   a free MASTER_PORT); serving.distributed.init_process_group() on nccl
   and cuda:0, a warm step, then 2 steps
   with the loss all_reduced (bitwise the loss at world 1) inside
   serving.profile.capture, whose Chrome trace must hold as many A1/A2/A3
   kernel events as the launch counters; host_view of the trained params
   back through from_host bitwise; gpu_gauges() equal to memory_stats and
   mem_get_info read in the same place, and empty in a fresh process that
   never used CUDA; the group destroyed in a finally.
   Then the training step on a mesh ("mesh", drive_mesh) and the serving
   engine on a mesh ("mesh_serve"): the partial mode of B1 and B2
   (context-parallel decode) at Llama-3-8B's decode heads over 4 emulated
   cache shards of PARTIAL_SHAPES (a ragged 8 x 8192 grid and one request
   of 32768 rows), each shard held to the plain partials, the shards'
   combine to the plain combine and to one whole-cache call, timed beside
   the whole-cache call, SDPA and the bound (this runs with the other
   kernel checks); then the script as a torch rank (--mesh-serve-rank, a
   world of 1 over nccl) serving Llama-3-8B's width at CUT_LAYERS of its
   32 layers, the 12 requests, through
   GenerationEngine(mesh=) on params laid out by LLAMA_RULES and through
   the plain engine (run first, its large allocations named from the
   allocator's history): tokens, logprobs and first-token logits bitwise
   equal, exact A1/B1 counts, the two peaks within GRID_SIZED_GB, decode
   ms/step, busy share and peak memory of both; then 3 rank-16 LoRA
   adapters beside base requests through both engines, bitwise, exact
   A1/B1; then 4 ranks of the script (--context-serve-rank) sharing the
   card in a gloo group over a {"context": 4} mesh, serving the 8B width
   at 2 layers on an 8 x 8192 grid split 4 ways with bf16 and int8 grids:
   decode through B1's / B2's partial mode and the combine (the kernels
   line's launches for them), exact counts, first tokens and the first
   decode step's logits against the plain engine; then 4 ranks
   (--spec-lora-rank) over {"context": 2, "tensor": 2}: a
   SpeculativeEngine (the 8B width and the 1B-shape draft at 2 layers,
   windows through the per-shard partial and combine, the draft's decode
   through B1's partial mode) and a LoRA engine with 3 adapters, exact
   counts, first tokens and first-step logits against the plain engines
   on rank 0. Then Mixtral on a mesh
   ("moe_mesh"): the script as a torch rank (--moe-mesh-rank, a world of
   1 over nccl, KT_MESH {"expert": -1}) trains Mixtral's width at 2 layers
   through make_train_step(mesh=, rules=MOE_RULES) and the plain step
   (losses and every param hash bitwise, A1/A2/A3 4/2/2 a step), then
   serves the int4/int8 Mixtral tree at full width and CUT_LAYERS of its
   32 layers through GenerationEngine(mesh=) and the plain engine
   (tokens, logprobs, first-token logits bitwise,
   exact A1/B2/B3), each with ms per step, busy share and peak memory;
   then 4 ranks of the script (--expert-rank) share the card in a gloo
   group over {"expert": 2, "tensor": 2}, each holding 4 of the 8 experts
   and half of F: one train step (the loss within LOSS_ABS of the plain
   step's, the gradients' relative L2 printed) and 8 requests through the
   mesh engine with a bf16 grid (B1; first tokens equal, the first decode
   step's logits within LOGITS_REL_L2 of the plain engine's). Last,
   ResNet-50 at ImageNet's shape ("resnet"): the script as a torch rank
   (--resnet-rank, a world of 1 over nccl, KT_MESH {"data": -1}) trains
   5 steps of examples/resnet_dp.py's step (128 x 224², bf16 convs,
   sgd(0.1, momentum=0.9)) through the data mesh and plain: losses, every
   param and batch_stats hash bitwise; images/s, busy share, the
   convolutions' share of busy, peak memory; and the bench's fp32
   stages-[1, 1, 1, 1] model on the card against the CPU within
   RESNET_FP32_REL. Then pipeline parallelism ("pipe", drive_pipe): the
   script as a torch rank (--pipe-rank, a world of 1 over nccl, KT_MESH
   {"pipe": -1}) trains Llama-3.2-1B's shape at full width and CUT_LAYERS
   of its 16 layers (bf16,
   attn_impl "flash", TRAIN_B x TRAIN_S, default_optimizer) through
   make_train_step(mesh=, rules=PIPE_LLAMA_RULES) over
   llama_loss_pipelined: 1 microbatch, 3 steps, losses and every param hash
   bitwise the plain step's; 4 microbatches, 3 steps, each loss within
   LOSS_ABS of the plain step's; A1/A2/A3 exactly 2·L·M/L·M/L·M a step;
   ms/step, busy share and peak memory of each; then PIPE_RANKS ranks of
   the script (--pipe-ranks) share the card in a gloo group over {"pipe":
   4}, 2 layers a stage: a GPipe step (4 microbatches) and an interleaved
   step (2 chunks of 1 layer a rank), each rank's A1/A2/A3 exact, rank
   0's loss within LOSS_ABS of the plain step's and the gathered
   gradients' relative L2 within PIPE_GRAD_REL_L2, the hop's path (host
   staged on gloo) and its share of the wall time printed. Then the data
   plane ("data_plane", drive_data_plane): Llama-3-8B's leaves at full
   width and 2 layers (2.97 GB, bf16, seeded on the card) put through the
   port's store client (kubetorch_tpu_torch/data_store/) into the
   script's store stand-in (_StandInStore) as slot 0 of a checkpoint;
   pod A (the script again, --data-plane-rank, its own pod cache and the
   fabric's ktblobd, built with g++ from kubetorch_tpu/native/ktblobd.cpp,
   over it) gets it onto the card; pod B, started beside A, loads the tree
   staged into the port's shared-memory arena onto the card and as
   DTensors on a world-of-1 mesh, then is routed to A twice: (a) with A's
   pod route down, every byte from A's ktblobd, and, the daemon stopped
   and a cache server over A's directory standing in for A's pod server,
   over the pod route (peer bytes the tree's and the index's, no store
   bytes, each time); (b) ktsync: Llama-3.2-1B in Meta's published HF
   layout (~2.5 GB, seeded, the head tied) put as a directory, put again
   (0 uploaded), pulled in pod B with get(key, dest=) and loaded with
   load_hf onto the card bitwise the seed tree, pulled again (0 fetched),
   one added file moving one blob each way; (c) the port's
   XRegionReplicator sweeps the tree and its commit marker into a second
   stand-in, "west", twice (the second pushes nothing, lag 0), east
   stops, and in west fallback_commit finds the marker and get onto the
   card gives every leaf. Every landed leaf holds the sent tree's
   checksums; GB/s of each move, the seconds of (a)-(c) and /dev/shm's
   free bytes printed. The memory audit ("hbm_audit") runs in the mesh rank,
   before its process group: the mesh step's 1B shape (a world of 1) and
   Llama-3-8B on an 8-way fsdp mesh (HBM_AUDIT_8B), on fake tensors under
   fake process groups, no kernel launched; the 1B report's params +
   opt_state bytes equal the live mesh state's exactly, and its predicted
   peak is within HBM_AUDIT_RATIO of one warm mesh step's
   torch.cuda.max_memory_allocated. Last, a serving replica's cold start
   ("cold_start", drive_cold_start): Llama-3.2-1B at full width and depth
   (bf16, ~3 GB from COLD_START_SEED) saved once, then two fresh pods,
   each a process on its own copy of kubetorch_tpu_torch/ with no _build/
   and its own empty compile-cache root over the store stand-in, booting
   through warm_template.cold_boot_main: pod A misses, builds flash_fwd
   and decode_attention with nvcc and publishes locally and to the store;
   pod B hits from the store with no nvcc run. Then the warm template (a
   third copy) forks two replicas, one after the other, over pod B's warm
   root: import 0.0, hits, no nvcc. Every boot's greedy tokens equal an
   in-process engine's on the same weights, its A1/B1 launches equal what
   its warm passes, prefill and decode steps imply, and no segment the
   template staged is left in /dev/shm; each boot's phases printed.
8. Prints the speculative and training phases' numbers and the script's
   wall time, one
   JSON line of per-kernel numbers, the card line, and as the last line
   {"ok": true, "device": {...}}.

Any failed phase exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
L2_BYTES = 50e6                # H100 L2 cache, same source
ENGINE_PROMPT_LENS = (40, 128, 200, 256, 300, 480, 512, 700, 1000, 1024,
                      1500, 1990)
MAX_NEW = 32
# the depth of the paths cut to keep the whole script within its time, width
# kept: the int4 Llama-3-8B engine with its features, LoRA and speculation,
# the mesh engines of Llama-3-8B ("mesh_serve") and of Mixtral ("moe_mesh"),
# the pipelines (Llama-3.2-1B's shape, of its 16 layers), since the
# "cold_start" phase Mixtral's engine ("moe"), and since the data plane's
# ktsync, ktblobd and cross-region steps the bf16 Llama-3-8B engine with
# its features, LoRA, fine-tune, rollout and speculation, and "hf_openai"
# (Meta's layout and sharding at this depth)
CUT_LAYERS = 8
SOURCES = ("flash_fwd", "flash_bwd", "decode_attention", "quant_matmul")
# the engine's prefill buckets (the last is max_len) and a ragged length
A1_BUCKETS, A1_RAGGED = (128, 256, 512, 1024, 2048), 1000
# the bf16 times of A1, A2 and A3 before the tensor-core redesign, when
# they ran the fp32-FMA bodies: PERF.md section 6, the earlier design's
# times in the kernel table (H100 80GB HBM3, 700 W, this script); A1 at
# Hd 128 is the serving T=1024 time, the same shape without the LSE
PREV_DESIGN_MS = {"fwd Hd=64": 3.395, "fwd Hd=128": 0.627, "dkv Hd=64": 6.52,
                  "dkv Hd=128": 1.372, "dq Hd=64": 4.54, "dq Hd=128": 0.842}
# the (B, S) at which each head dim's earlier-design time was taken
PREV_DESIGN_SHAPE = {64: (4, 2048), 128: (1, 1024)}
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
# ViT-B/16 (VitConfig.vit_b16: 224² images, patch 16, so S = 196 with no
# class token, 12 heads of 64, non-causal): the batch of the kernel checks
# and of the "vit" phase, its training steps (adamw, one seeded batch fed
# through prefetch_to_device), the timed forwards, and the fp32 gradient
# check's layers and batch. The forward's logits are held to the plain
# path at LOGITS_REL_L2, the step-0 loss at LOSS_ABS, the fp32 gradients
# at GRAD_REL_L2 (per leaf, relative L2), as for the Llama phases.
VIT_B, VIT_S, VIT_STEPS, VIT_FWD_REPS, VIT_LR = 256, 196, 5, 3, 1e-3
VIT_GRAD_LAYERS, VIT_GRAD_B = 2, 8
# the keys the fabric's PyTorchEnv.env injects into a torch rank (this
# script's own copy of the names), at rank 0 of a world of 1; MASTER_PORT
# is a free port chosen at run time
TORCH_RANK_ENV = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                  "MASTER_ADDR": "127.0.0.1"}
# the argument that runs this script as that rank (fabric_rank)
FABRIC_RANK_FLAG = "--fabric-rank"
# the "mesh" phase: the script again as a torch rank (mesh_rank), with the
# mesh the fabric injects as KT_MESH: every rank on fsdp, here a world of 1
MESH_RANK_FLAG = "--mesh-rank"
MESH_ENV = {"KT_MESH": '{"fsdp": -1}'}
# its steps per run (mesh step, then the plain step), the profiled steps
# after them, and the bf16 loss tolerance that applies only if the two
# runs part (the step's own LOSS_ABS)
MESH_STEPS, MESH_PROFILED = 3, 2
# the "mesh_serve" phase: context-parallel decode's kernels, the partial
# mode of B1 and B2, at Llama-3-8B's decode heads over CONTEXT_SHARDS
# emulated cache shards (B, S, pos): (a') a ragged 8 x 8192 grid whose
# frontiers fall inside a shard (1000, 5000), on a shard's last row and
# the next shard's first (2047, 2048), in the last shard (6143 and 8191 of
# rows 6144..8191 hold 0 and all of it) and at row 0; (c') one request of
# 32768 rows
PARTIAL_SHAPES = {"a'": (8, 8192, [0, 1000, 2047, 2048, 4095, 5000, 6143, 8191]),
                  "c'": (1, 32768, [32767])}
CONTEXT_SHARDS = 4
# then the serving engine on a mesh, the script again as a torch rank
# (mesh_serve_rank) over the same KT_MESH (a one-dim mesh of size 1): the
# rank holds ~20 GB, so the parent must hold less than this then
MESH_SERVE_RANK_FLAG = "--mesh-serve-rank"
MESH_SERVE_PARENT_GB = 55.0
# its Llama-3-8B at full width and CUT_LAYERS of 32 layers
# then context-parallel decode on the main path: CONTEXT_SHARDS ranks of
# the script (context_serve_rank) on the one card, a gloo group (nccl
# refuses two ranks on one GPU; gloo all-reduces CUDA tensors through the
# host) over KT_MESH {"context": 4}, serving Llama-3-8B's width at
# CONTEXT_LAYERS layers (each rank holds the replicated weights) on an 8 x
# 8192 grid, 2048 rows a rank, with (a')'s frontiers: prompts ending
# inside a shard, on a shard's last row and the next's first, in the last
# shard, then CONTEXT_NEW tokens each; attn_impl "flash" keeps the prefill
# on the card's A1 (the ring's point-to-point transfers need nccl)
CONTEXT_RANK_FLAG = "--context-serve-rank"
CONTEXT_ENV = {"KT_MESH": '{"context": 4}'}
CONTEXT_LAYERS, CONTEXT_NEW = 2, 16
CONTEXT_PROMPTS = (40, 1000, 2047, 2048, 3000, 5000, 6143, 7000)
# Mixtral on a mesh ("moe_mesh"): the script again as a torch rank
# (moe_mesh_rank), a world of 1 over nccl with every axis dead: the MoE
# train step at Mixtral's width and MOE_TRAIN_LAYERS layers, MESH_STEPS
# steps through make_train_step(mesh=, rules=MOE_RULES) then the plain
# step, and the quantized Mixtral tree (CUT_LAYERS layers) served
# through GenerationEngine(mesh=) then the plain engine. The rank's training peak
# is ~52 GB, so the parent must hold less than this then
MOE_MESH_RANK_FLAG = "--moe-mesh-rank"
MOE_MESH_ENV = {"KT_MESH": '{"expert": -1}'}
MOE_MESH_PARENT_GB = 20.0
# then EXPERT_RANKS ranks of the script (expert_rank) sharing the card in a
# gloo group over EXPERT_ENV's mesh: each holds 4 of the 8 experts and half
# of each expert's F. Mixtral's width at EXPERT_LAYERS layers, bf16: one
# train step at EXPERT_B x EXPERT_S (the loss within LOSS_ABS of the plain
# step's on rank 0), then the EXPERT_PROMPTS, EXPERT_NEW new tokens each,
# through the mesh engine with a bf16 grid (B1) against the plain engine:
# first tokens equal, the first decode step's logits within LOGITS_REL_L2
EXPERT_RANK_FLAG = "--expert-rank"
EXPERT_ENV = {"KT_MESH": '{"expert": 2, "tensor": 2}'}
EXPERT_RANKS, EXPERT_LAYERS, EXPERT_B, EXPERT_S = 4, 2, 1, 1024
EXPERT_PROMPTS = (40, 128, 200, 300, 512, 700, 1000, 1500)
EXPERT_NEW = 16
# the serving mesh's last refusals on the main path: SPEC_LORA_RANKS ranks
# of the script (spec_lora_rank) sharing the card in a gloo group over
# SPEC_LORA_ENV's mesh, Llama-3-8B's width at SPEC_LORA_LAYERS layers
# (bf16, attn_impl "flash"): a SpeculativeEngine with the Llama-3.2-1B-shape
# draft at SPEC_LORA_LAYERS layers, both grids split 2 ways over context
# and KV heads over tensor (windows through the per-shard partial and the
# combine, the draft's decode through B1's partial mode), and a LoRA engine
# with 3 rank-LORA_RANK adapters beside base requests; rank 0 runs the
# plain engines on the same params: first tokens equal, first-step logits
# within LOGITS_REL_L2
SPEC_LORA_RANK_FLAG = "--spec-lora-rank"
SPEC_LORA_ENV = {"KT_MESH": '{"context": 2, "tensor": 2}'}
SPEC_LORA_RANKS, SPEC_LORA_LAYERS, SPEC_LORA_NEW = 4, 2, 16
SPEC_LORA_PROMPTS = (40, 128, 200, 300, 700, 1000, 1500, 90)
# ResNet-50 at ImageNet's shape ("resnet"): the script again as a torch
# rank (resnet_rank), a world of 1 over nccl on RESNET_ENV's one-dim data
# mesh: RESNET_STEPS steps of examples/resnet_dp.py's step (train mode,
# sgd(0.1, momentum=0.9)) at RESNET_B images of RESNET_HW², bf16 convs,
# through the mesh (images a Shard(0) DTensor, params replicated, global
# BatchNorm moments) and then plain, bitwise; then the stages-[1, 1, 1, 1]
# fp32 model of the bench's config 2 on the card against the same code on
# the CPU, within RESNET_FP32_REL of each quantity's largest magnitude
RESNET_RANK_FLAG = "--resnet-rank"
# the plain serving engine's allocations of at least this size are named
# (the mesh engine's peak sat one grid, 2.14 GB, below the plain engine's)
GRID_SIZED_GB = 0.5
RESNET_ENV = {"KT_MESH": '{"data": -1}'}
RESNET_B, RESNET_HW, RESNET_CLASSES, RESNET_STEPS = 128, 224, 1000, 5
RESNET_PROFILED = 2
RESNET_FP32 = dict(b=16, hw=64, filters=16, classes=100)
RESNET_FP32_REL = 1e-4
# cuDNN's convolution kernels (and its layout transposes) as the profiler
# names them
CONV_KERNEL_KEYS = ("conv", "cudnn", "xmma", "implicit_gemm", "fprop",
                    "dgrad", "wgrad", "nchwToNhwc", "nhwcToNchw")
# pipeline parallelism ("pipe"): the script again as a torch rank
# (pipe_rank), a world of 1 over nccl on PIPE_ENV's mesh (every axis dead):
# the 1B shape's step through llama_loss_pipelined at PIPE_MICROBATCHES
# (1: bitwise the plain step; 4: each loss within LOSS_ABS), MESH_STEPS
# steps each; then PIPE_RANKS ranks of the script (pipe_ranks) sharing the
# card in a gloo group over PIPE_RANKS_ENV's mesh, CUT_LAYERS layers: a
# GPipe step and an interleaved step of PIPE_VIRTUAL chunks, each at 4
# microbatches. The gradients of a pipelined bf16 step are sums over the
# microbatches in bf16 where the plain step's GEMMs sum the batch in fp32
# and round once, so the gathered gradients' relative L2 against the plain
# step's is held to the few-percent bf16 floor of the logits checks
PIPE_RANK_FLAG, PIPE_RANKS_FLAG = "--pipe-rank", "--pipe-ranks"
PIPE_ENV = {"KT_MESH": '{"pipe": -1}'}
PIPE_RANKS_ENV = {"KT_MESH": '{"pipe": 4}'}
PIPE_MICROBATCHES, PIPE_RANKS, PIPE_VIRTUAL = (1, 4), 4, 2
PIPE_GRAD_REL_L2 = 5e-2
# the data plane ("data_plane"): Llama-3-8B's full-width leaves at
# DATA_PLANE_LAYERS layers (~2.97 GB, bf16, seeded) through the port's store
# client into the script's store stand-in, then onto the card in two pods
# (this script again, DATA_PLANE_FLAG, its spec in DATA_PLANE_SPEC_ENV), the
# second fed by the first over the broadcast tree; pod caches under the
# gitignored DATA_PLANE_DIR of the checkout, removed after
DATA_PLANE_FLAG, DATA_PLANE_SPEC_ENV = "--data-plane-rank", "KT_SMOKE_DATA_PLANE"
DATA_PLANE_LAYERS, DATA_PLANE_SEED = 2, 5
# the tree sits in slot 0 of a checkpoint at DATA_PLANE_BASE, whose commit
# marker (step DATA_PLANE_STEP) the cross-region sweep carries
DATA_PLANE_BASE, DATA_PLANE_DIR = "smoke/llama3-8b", "data_plane"
DATA_PLANE_KEY, DATA_PLANE_STEP = DATA_PLANE_BASE + "/slot-0", 1
# ktsync in the data plane: Llama-3.2-1B in the layout of Meta's published
# meta-llama/Llama-3.2-1B repository (its config.json; the bf16 weights in
# one model.safetensors, the head tied to the embedding), written from a
# seeded tree (norms drawn from SYNC_NORM_SEED, rounded to bf16), pushed
# under SYNC_KEY and pulled into a pod; then SYNC_ADDED is added and pushed
META_LLAMA32_1B = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000, "eos_token_id": 128001,
    "head_dim": 64, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 8192,
    "max_position_embeddings": 131072, "mlp_bias": False,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 16,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "transformers_version": "4.45.0.dev0",
    "use_cache": True, "vocab_size": 128256}
SYNC_KEY, SYNC_SEED, SYNC_NORM_SEED = "smoke/hf/Llama-3.2-1B", 6, 7
SYNC_ADDED = ("generation_config.json",
              {"bos_token_id": 128000, "eos_token_id": 128001,
               "temperature": 0.6, "top_p": 0.9})
# the "cold_start" phase: Llama-3.2-1B, bf16, full width and depth; the
# engine every boot builds, the probe each serves
COLD_START_SEED, COLD_START_DIR = 20, "cold_start"
COLD_START_ENGINE = dict(slots=4, max_len=512, prefill_buckets=(128, 256, 512))
COLD_START_PROBE, COLD_START_NEW = 40, 8
COLD_START_LIBS = ("decode_attention", "flash_fwd")
# the memory audit ("hbm_audit", run in the mesh rank): Llama-3-8B's step
# audited on an 8-way fsdp mesh at this batch x sequence, and the bounds of
# a measured step's peak over the 1B audit's predicted peak: narrow enough
# that an audit missing its activations term fails (the 1B state alone is
# ~0.53 of the step's peak)
HBM_AUDIT_8B = (8, 2048)
HBM_AUDIT_RATIO = (0.9, 1.1)
# the tensor-core kernel functions of A1, A2 and A3, as the profiler's
# kernel events name them
FLASH_KERNEL_NAMES = ("flash_fwd_sm90", "bwd_dq_sm90", "bwd_dkv_sm90")
# a process that imports the port and torch and never touches CUDA: its
# gauges must read nothing, and CUDA must still be down after they ran
GAUGE_PROBE = (
    "import json, torch\n"
    "from kubetorch_tpu_torch.serving import gpu_gauges\n"
    "print(json.dumps({'gauges': gpu_gauges(), "
    "'cuda_initialized': torch.cuda.is_initialized()}))\n")
# B3 at Llama-3-8B's shapes: (M, K, N), the four projection shapes at 8
# decode rows and at a 2048-row prefill bucket, a ragged 300, and 1 and 17
# rows of (4096, 4096): the split-K body's single-tile case and the first
# M the wgmma body takes
Q4_SHAPES = ((8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
             (8, 14336, 4096), (1, 4096, 4096), (17, 4096, 4096),
             (300, 4096, 4096), (2048, 4096, 4096), (2048, 4096, 1024),
             (2048, 4096, 14336), (2048, 14336, 4096))
Q4_GROUP = 128
# the engine-features phases: the engine phases' grid, a 1000-token
# registered prefix with suffixes of 40 to 200 tokens (the first four
# submitted with its prefix_id, the others as full prompts matched by
# auto_prefix), an 1800-token prompt admitted in chunks of 512 (three full
# chunks and one of 264), a logit_bias that forces one token and a presence
# penalty no logit of a random-weight model outweighs
FEATURE_GRID = dict(slots=8, max_len=2048, prefill_buckets=(128, 256, 512, 1024))
PREFIX_LEN = 1000
PREFIX_SUFFIXES = (40, 64, 100, 200, 50, 90, 150, 180)
CHUNK, CHUNK_PROMPT = 512, 1800
BIAS_TOKEN, HUGE_PRESENCE = 12345, 1e4
# the LoRA phases: rank 16, alpha 32 on the four attention projections, B
# factors drawn N(0, LORA_B_STD^2) from a seed (lora_init's zero B would
# make every check vacuous): the delta is ~0.4 of a base projection's
# entries, so adapter tokens part from the base model's. Eight requests on
# the bf16 engine, two on the base model and two on each of three
# adapters, decode LORA_TIMED_STEPS timed steps with all three active
# before one is unregistered; a 300-token prefix registered through one
# adapter is then offered to a base request and an adapter request
LORA_RANK, LORA_ALPHA, LORA_B_STD = 16, 32.0, 0.05
LORA_PROMPTS = (40, 100, 200, 300, 64, 128, 500, 90)
LORA_TIMED_STEPS = 6
LORA_PREFIX = 300
# the MoE phase: Mixtral-8x7B at full width and CUT_LAYERS of 32 layers in
# the int4/int8 serving layout, the engine phases' grid with an int8 KV
# cache, then a 2-slot engine on the same weights, whose decode takes the
# K-expert gather (2 x 2 x 2 <= 8 experts) where 8 slots take the dispatch
MOE_GATHER_PROMPTS = (40, 300, 700, 1500)
# the training phases of the LoRA and MoE families, each on one seeded
# batch of TRAIN_B x TRAIN_S fed through prefetch_to_device, TRAIN_STEPS
# counted steps (tokens/s over all but the first, which holds the first
# call's set-up), then one profiled step:
# - "lora_train": a LoRA fine-tune of the bf16 Llama-3-8B engine phases'
#   params at full width, CUT_LAYERS (lora_config(): rank 16, alpha 32,
#   wq/wk/wv/wo; lora_init's zero B), adamw(LORA_TRAIN_LR), chunked CE
#   TRAIN_CHUNK, remat "dots"; then the trained adapter served merged
#   (merge_lora -> a new engine) and banked (registered into the LoRA
#   phase's engine) on LORA_SERVE_PROMPTS;
# - "moe_train": Mixtral-8x7B's width at MOE_TRAIN_LAYERS of its 32 layers
#   (full-Adam state for 32 layers is ~560 GB), bf16, default_optimizer
#   with the 1B phase's 2 warm-up steps, moe_loss; then one lora_loss step
#   over the trained MoE base (rank 16, wq/wv: moe_loss by default).
# Kernel path vs plain path: the LoRA step-0 loss in bf16 within LOSS_ABS;
# adapter gradients (LoRA, 2 layers at full width) and every leaf's
# gradient and the loss (MoE, the same 2 layers), fp32, B=1, S=512, each
# leaf's largest |diff| within TRAIN_GRAD_REL of its largest entry: both
# paths compute the same fp32 math and differ in the order of the
# attention sums (1e-6 relative per op), carried back through 2 layers;
# the MoE check first asserts that both paths routed alike
LORA_TRAIN_LR, LORA_TRAIN_SEED = 1e-3, 21
LORA_SERVE_PROMPTS = (40, 300, 700, 1000)
MOE_TRAIN_LAYERS = 2
MOE_LORA_TARGETS = ("wq", "wv")
TRAIN_GRAD_REL, TRAIN_CHECK_S = 1e-4, 512
# the speculative phases (serve/spec_engine.py): spec_k 4 on the engine
# phases' grid with chunked prefill, a Llama-3.2-1B-shape draft (bf16, its
# own seed) or the target as its own draft; the engine phases' 12 prompts,
# a 100-token suffix behind a 1000-token prefix and the 1800-token prompt
# (the self-draft phase: the 12 prompts alone).
# After the counted run, 8 slots of 40-token prompts decode SPEC_POST_NEW
# tokens through the logits check, SPEC_TIMED_ROUNDS timed rounds and a
# 2-round profile, then are cancelled. Self-draft must accept at least SPEC_SELF_ACCEPT of its
# proposals: draft and target are one model and differ only where the
# draft's B1 decode and the target's window einsum round a near-tie apart.
# Exactness in fp32 at Llama-3-8B's width, 2 layers, beside a draft of
# Llama-3.2-1B's width at the same depth
SPEC_K, SPEC_DRAFT_SEED, SPEC_SUFFIX = 4, 1, 100
SPEC_POST_NEW, SPEC_TIMED_ROUNDS, SPEC_SELF_ACCEPT = 64, 4, 0.5
SPEC_EXACT = dict(layers=2, slots=4, prompts=(40, 200, 300, 1000), new=24, k=3)
# B1 at the draft's head dim 64 (shapes (a) and (d) of DECODE_SHAPES), and
# B3 at the verify window's 72 rows (8 slots x 2 SPEC_K + 1) at Llama-3-8B's
# four projection shapes
B1_DRAFT_SHAPES = ("a", "d")
# the rollout phase: 8 requests of 40-token prompts decode this many
# tokens each across the live swap (~12 s of steps, the swap ~1 s)
ROLLOUT_FLIGHT_NEW = 256
# the "flywheel" phase (after "rollout", on the bf16 chain's params): the
# continuous-learning loop closed around a serving engine, a LoRA trainer
# (lora_config(), lora_init's zero B, adamw(FLY_LR)) and the canary
# rollout. The engine serves the 12 ENGINE_PROMPT_LENS requests of MAX_NEW
# tokens with its feedback sink on a FeedbackLedger over the stand-in HTTP
# store (sample rate 1); a Harvester folds FLY_BATCH records a step, each
# prompt tiled to FLY_SEQ + 1 tokens, one row each, and a drain is asked
# for after FLY_DRAIN_AT steps. The Promoter's eval (lower is better)
# replays the 12 harvested rows: on random weights a batch the trainer
# never saw gives every candidate the same loss within noise, so a gate
# on it could tell nothing apart; FLY_LR makes the 3 steps move the
# replayed loss past the gate tolerance FLY_GATE_TOL (JAX's default).
# The bad candidate is a poisoned delta: the same steps on the same rows
# ascending the loss (on random weights a wrecked or scaled-up adapter
# lands near the base model's loss, inside the gate's tolerance); the
# harvest policy's SLO FLY_SLO_MS on the engine's queue wait, a cycle
# bounded by FLY_CYCLE_S; the probe prompts LORA_SERVE_PROMPTS
FLY_SEED, FLY_SEQ, FLY_BATCH, FLY_DRAIN_AT = 22, 512, 4, 2
FLY_LR, FLY_GATE_TOL = 1e-2, 0.02
FLY_SLO_MS, FLY_GRACE_S, FLY_CYCLE_S = 5000.0, 20.0, 300.0
Q4_WINDOW_SHAPES = tuple((8 * (2 * SPEC_K + 1), k, n) for _, k, n in Q4_SHAPES[:4])
# the "hf_openai" phase: a checkpoint in the layout of Meta's published
# meta-llama/Meta-Llama-3-8B repository (its config.json, bf16 weights in
# safetensors shards of at most 5 GB and model.safetensors.index.json) at
# CUT_LAYERS layers, written from a seed tree, its norms drawn from a seed;
# a second one at the same width, 2 layers, fp32, with Llama-3.1-8B's
# rope_scaling, for the forward against the script's own HF-convention
# forward (fp32 on both sides, TF32 off: only the order of the sums
# differs, ~1e-6 relative per op); then the OpenAI surface's traffic on
# the engine phases' grid with auto_prefix on
META_LLAMA3_8B = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000, "eos_token_id": 128001,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 8192,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.40.0.dev0", "use_cache": True,
    "vocab_size": 128256}
LLAMA31_ROPE_SCALING = {"factor": 8.0, "low_freq_factor": 1.0,
                        "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 8192,
                        "rope_type": "llama3"}
HF_SHARD_BYTES = 5 * 10 ** 9
HF_NORM_SEED, HF_FWD_SEED, HF_FWD_LAYERS = 3, 5, 2
HF_FWD_PROMPTS, HF_FWD_REL_L2 = (512, 300, 128, 37), 1e-4
# the surface's traffic: the engine phases' 12 prompts one at a time
# (4 of them also through engine.generate), then from 12 threads at once;
# where batch composition may change bf16 bits, each concurrent request's
# first token must be the sequential one and its logprob within
# API_FIRST_LP_ABS; embeddings of 128, 1000 and 2048 tokens against the
# pooled plain-attention hidden states within LOGITS_REL_L2 (the same
# attention numerics gap as the first-token check); 8 streams of 40-token
# prompts decode API_STREAM_NEW tokens through the surface and through the
# engine alone
API_PARITY = (0, 4, 8, 11)
API_FIRST_LP_ABS = 2e-2
API_PREFIX_SUFFIX = 100
API_EMBED_LENS = (128, 1000, 2048)
API_STREAM_NEW = 64
API_TTFC_REPS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def installed_versions(names=("transformers", "safetensors", "aiohttp")):
    """{package: version or None} without importing them."""
    from importlib import metadata
    out = {}
    for name in names:
        try:
            out[name] = metadata.version(name)
        except metadata.PackageNotFoundError:
            out[name] = None
    return out


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
    """A1 at B=1, N=32, NKV=8, causal, against the plain version: at Hd=128
    (the target's prefill) bf16 (the engine's type, the tensor-core body)
    at every prefill bucket and a ragged T, fp32 (the FMA body) at 128,
    512 and 1024; at Hd=64 (the Llama-3.2-1B draft's prefill) bf16 at the
    same lengths. bf16 times at every length and head dim. Returns the
    record of Hd=128 T=1024 and the records of Hd=64."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rec, draft = None, []
    for hd, t in [(128, t) for t in (*A1_BUCKETS, A1_RAGGED)] + \
            [(64, t) for t in (*A1_BUCKETS, A1_RAGGED)]:
        q = torch.randn(1, t, 32, hd, generator=gen, device="cuda")
        k = torch.randn(1, t, 8, hd, generator=gen, device="cuda")
        v = torch.randn(1, t, 8, hd, generator=gen, device="cuda")
        dtypes = (torch.float32, torch.bfloat16) \
            if hd == 128 and t in (128, 512, 1024) else (torch.bfloat16,)
        for dtype in dtypes:
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            got = ops_attn.flash_attention(qd, kd, vd, causal=True)
            want = ops_attn.flash_attention_ref(qd, kd, vd, causal=True)
            err, rel = compare(f"flash_fwd T={t} Hd={hd}", got, want)
            del got, want
        ms = time_ms(torch, lambda: ops_attn.flash_attention(qd, kd, vd))
        plain = time_ms(torch, lambda: ops_attn.flash_attention_ref(qd, kd, vd))
        qt, kt, vt = (x.transpose(1, 2) for x in (qd, kd, vd))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = (2 * 32 + 2 * 8) * t * hd * 2
        flops = 4 * 32 * hd * t * (t + 1) / 2
        b_ms, b_by = bound(nbytes, flops)
        rate = rate_line(flops, ms, b_ms)
        extra = ""
        if t == 1024 and hd == 128:
            fp32_ms = time_ms(torch, lambda: ops_attn.flash_attention(q, k, v))
            prev = PREV_DESIGN_MS["fwd Hd=128"]
            extra = (f" fp32_fma_body_ms={fp32_ms} (fp32 inputs, measured) "
                     f"prev_design_bf16_ms={prev} (fp32-FMA body in bf16, "
                     f"PERF.md, not this run) speedup_vs_prev={prev / ms}")
        print(f"kernel flash_fwd T={t} Hd={hd} bf16: ms={ms} plain_ms={plain} "
              f"sdpa_ms={lib} bound_ms={b_ms} ({b_by}) "
              f"tflops={rate['tflops']} bound_share={rate['bound_share']}"
              f"{extra}", flush=True)
        shape = f"B=1 T={t} N=32 NKV=8 Hd={hd} bf16 causal"
        if t == 1024 and hd == 128:
            rec = dict(max_abs_err=err, max_row_rel_err=rel, ms=ms,
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib, **rate, fp32_fma_body_ms=fp32_ms,
                       shape=shape)
        elif hd == 64:
            draft.append(dict(max_abs_err=err, max_row_rel_err=rel, ms=ms,
                              plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib, **rate, shape=shape))
        del q, k, v, qd, kd, vd, qt, kt, vt
        torch.cuda.empty_cache()
    return rec, draft


def decode_bound(b, s, pos_list, quant: bool, hd: int = 128):
    """(bound_ms, bound_by, bytes) of one flash-decode call at NH=32,
    NKV=8 and head dim ``hd``: q read and out written once in bf16, the
    live K and V rows (bf16, or int8 with a 4-byte scale each) and pos; 4
    flops per live row, query head and head dim."""
    nh, nkv = 32, 8
    live = sum(min(p + 1, s) for p in pos_list)
    row = hd + 4 if quant else 2 * hd
    nbytes = 2 * b * nh * hd * 2 + 2 * live * nkv * row + 4 * b
    return (*bound(nbytes, 4 * nh * hd * live), nbytes)


def check_decode_shape(torch, F, ops_dec, shape, quant: bool, gen,
                       hd: int = 128):
    """B1 (``quant`` False) or B2 at one of DECODE_SHAPES with head dim
    ``hd`` (Llama-3-8B's 128, or the Llama-3.2-1B draft's 64): bf16 q (and
    fp32 q at shape a) against the plain version per row, the route of
    each (split body for bf16, FMA body for fp32), bitwise equal over two
    calls, then bf16 times of the kernel, the plain version and SDPA (for
    B2 over K/V dequantized to bf16, outside the timing), B2 also cold in
    L2."""
    from kubetorch_tpu_torch.serve import dequantize_rows, quantize_rows
    b, s, pos_list = DECODE_SHAPES[shape]
    nh, nkv = 32, 8
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
    b_ms, b_by, nbytes = decode_bound(b, s, pos_list, quant, hd)
    # the earlier design was timed at Hd 128 only
    prev = PREV_DECODE_MS[shape] if hd == 128 else {}
    rec = dict(shape=f"({shape}) B={b} S={s} NH={nh} NKV={nkv} Hd={hd} "
               f"pos={pos_list} bf16 q" + (", int8 K/V" if quant else ""),
               body="split", splits=splits, max_abs_err=err,
               max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib, bound_share=b_ms / ms)
    line = (f"kernel {name} ({shape}) B={b} S={s} Hd={hd} pos={pos_list} body=split "
            f"splits={splits}: ms={ms} plain_ms={plain_ms} sdpa_ms={lib} "
            f"bound_ms={b_ms} ({b_by}; {nbytes} bytes) "
            f"bound_share={b_ms / ms} prev_design_bf16_ms="
            f"{prev.get('b2' if quant else 'b1')}")
    if quant:
        rec["ms_cold_l2"] = time_cold_ms(torch, kern, (q, *args, pos))
        rec["library_ms_cold_l2"] = time_cold_ms(torch, sdpa, (q, kt, vt))
        line += (f" ms_cold_l2={rec['ms_cold_l2']} sdpa_ms_cold_l2="
                 f"{rec['library_ms_cold_l2']} prev_design_bf16_ms_cold_l2="
                 f"{prev.get('b2_cold')}")
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
    """B3 at Q4_SHAPES (:func:`check_q4_shapes`). Returns the record of the
    widest decode shape (8 x 4096 x 14336, w_gate and w_up) with every
    shape's numbers beside it."""
    per_shape = check_q4_shapes(torch, ops_q4, Q4_SHAPES, seed=6)
    widest = next(r for r in per_shape
                  if r["shape"].startswith("M=8 K=4096 N=14336"))
    # the kernels line's "route" is the language; B3's body is "body" here
    # and "route" in each per_shape entry
    rec = {k: v for k, v in widest.items() if k != "route"}
    rec["body"] = widest["route"]
    rec["per_shape"] = per_shape
    return rec


def check_q4_shapes(torch, ops_q4, shapes, seed):
    """B3 at each (M, K, N) of ``shapes``, through the body
    kt_q4_matmul_body reports (split-K at M <= 16, wgmma above): fp32
    output against the plain version per row (x in fp32 and in bf16: the
    kernel rounds it to bf16 either way) and bitwise equal over two calls,
    then times with bf16 x. Library: cuBLAS x_bf16 @ W_bf16 over the weight
    dequantized once, outside the timing. Returns one record per shape."""
    from kubetorch_tpu_torch.models.quant import (_dequant_int4,
                                                  _quantize_leaf_int4)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    per_shape = []
    for m, k, n in shapes:
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
    return per_shape


def check_train_kernels(torch, F, ops_attn):
    """A1 with its LSE, A2 and A3, causal, at the 1B training shape (B=4,
    S=2048, N=32, NKV=8, Hd=64), at the Hd=128 training shape of the LoRA
    and MoE phases (B=4, S=2048) and at Hd=128, B=1, S=1024: bf16 and fp32
    against the plain versions, then bf16 times. Returns the kernels-line
    records of the 1B training shape, each with the Hd=128 training
    shape's under ``train_hd128``."""
    from kubetorch_tpu_torch.ops.tolerance import LSE_ATOL
    gen = torch.Generator(device="cuda").manual_seed(4)
    recs = {}
    for b, s, nh, nkv, hd in ((TRAIN_B, TRAIN_S, 32, 8, 64),
                              (TRAIN_B, TRAIN_S, 32, 8, 128),
                              (1, 1024, 32, 8, 128)):
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
            prev = ""
            if redesign and PREV_DESIGN_SHAPE[hd] == (b, s):
                prev = (f" prev_design_bf16_ms={PREV_DESIGN_MS[f'{name} Hd={hd}']}"
                        f" (fp32-FMA body in bf16, PERF.md, not this run)")
            print(f"kernel flash_{name} {shape} bf16 causal: ms={ms} "
                  f"plain_ms={plain} library_ms={lib} ({lib_name[name]}) "
                  f"bound_ms={b_ms} "
                  f"({b_by}; {nbytes} bytes, {flops} flops) "
                  f"tflops={rate['tflops']} bound_share={rate['bound_share']}"
                  + (f" fp32_fma_body_ms={fma[name]} (fp32 inputs, measured)"
                     if redesign else "") + prev,
                  flush=True)
            rec = dict(max_abs_err=errs[name][0], ms=ms, plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                       bytes=nbytes, flops=flops, **rate, **redesign,
                       shape=f"{shape} bf16 causal")
            if hd == 64:
                recs[name] = rec
            elif b == TRAIN_B:
                recs[name]["train_hd128"] = rec
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


def sdpa_times(torch, F, q, k, v, do, causal=True):
    """SDPA's forward, and its backward as autograd of SDPA less its
    forward (dQ, dK and dV together): the library yardsticks for A1 and for
    A2/A3, on the same inputs (head-major views)."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        t_fwd = time_ms(torch, fwd)
    return t_fwd, time_ms(torch, fwd_bwd) - t_fwd


def drive_engine(torch, ops_attn, ops_dec, card):
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.serve import GenerationEngine

    cfg = LlamaConfig.llama3_8b(n_layers=CUT_LAYERS)
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
    launches = Launches(ops_attn, ops_dec)
    launches.zero()
    handles, tok_s, steps = serve_requests(torch, eng, cfg, prompts)
    got = launches.read()
    flash_n, decode_n = got["flash_fwd"], got["decode_attention"]
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
    features = drive_engine_features(torch, ops_attn, ops_dec, params, cfg, eng,
                                     card)
    lora, lora_eng = drive_lora(torch, ops_attn, ops_dec, params, cfg, eng, card)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    lora_train = drive_lora_train(torch, ops_attn, ops_dec, params, cfg,
                                  lora_eng, card)
    del lora_eng
    gc.collect()
    torch.cuda.empty_cache()
    lora_train["flywheel"] = drive_flywheel(torch, ops_attn, ops_dec, params,
                                            cfg, card)

    draft, dcfg = spec_draft(torch)
    spec_n, spec = {}, {}
    # the self-draft phase adds only the full-accept path: the 12 prompts
    # alone (the prefix and the 1800-token prompt run in the other phases)
    for label, d, dc in (("spec", draft, dcfg), ("spec_self", params, cfg)):
        spec_n[label], spec[label] = drive_spec(
            torch, ops_attn, ops_dec, None, label, params, cfg, d, dc, prompts,
            tok_s, card, extras=label == "spec")
    if not spec["spec_self"]["acceptance_rate"] >= SPEC_SELF_ACCEPT:
        fail(f"spec_self: acceptance rate {spec['spec_self']['acceptance_rate']}"
             f" < {SPEC_SELF_ACCEPT}")
    spec["spec_generate"] = drive_spec_generate(
        torch, ops_attn, ops_dec, params, cfg, draft, dcfg, prompts[4], outs[4],
        card)
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    spec["spec_exact"] = drive_spec_exact(torch, ops_attn, ops_dec, card)
    return flash_n, decode_n, features, lora, lora_train, spec_n, spec


class Launches:
    """The kernel wrappers' launch counts: ``zero()`` just before a run of
    the main path, ``read()`` just after."""

    def __init__(self, ops_attn, ops_dec, ops_q4=None):
        self.fns = dict(flash_fwd=ops_attn.flash_attention,
                        decode_attention=ops_dec.decode_attention,
                        decode_attention_quant=ops_dec.decode_attention_quant)
        if ops_q4 is not None:
            self.fns["q4_matmul"] = ops_q4.q4_matmul

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}


def check_launches(label, got, want):
    print(f"{label}: launches {got}, expected {want}", flush=True)
    if got != want:
        fail(f"{label}: launches {got}, expected {want}")


def drain(torch, eng):
    """Step ``eng`` until it has no work. Returns one (wall s, admitted,
    tokens emitted) per step, each step ending in a synchronize."""
    steps = []
    while True:
        before = eng.stats()
        t = time.perf_counter()
        left = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = eng.stats()
        steps.append((dt, after.admitted_total - before.admitted_total,
                      after.tokens_generated - before.tokens_generated))
        if not left:
            return steps


def decode_rate(steps):
    """(tokens/s, ms/step) over the steps that admitted nothing."""
    plain = [(dt, n) for dt, adm, n in steps if adm == 0]
    wall = sum(dt for dt, _ in plain)
    return sum(n for _, n in plain) / wall, wall / len(plain) * 1e3


@contextlib.contextmanager
def recorded_logits(engine_mod, name="_prefill_suffix_logits",
                    pick=lambda out: out[0], keep=None):
    """The logits ``pick`` takes from the output of every call of ``name``
    the module makes, in order (with ``keep``, of its first ``keep``
    calls): by default the first-token logits of the suffix passes (a
    prefix hit's, and each prefill chunk's after the first);
    ``_prefill_logits`` for the from-zero prefills."""
    calls = []
    real = getattr(engine_mod, name)

    def record(*args, **kw):
        out = real(*args, **kw)
        if keep is None or len(calls) < keep:
            calls.append(pick(out).clone())
        return out

    setattr(engine_mod, name, record)
    try:
        yield calls
    finally:
        setattr(engine_mod, name, real)


def one_shot(torch, engine_mod, params, cfg, eng, prompt):
    """A from-zero prefill of ``prompt`` at its bucket, as a one-shot
    admission runs it: (logits (1, V), k, v)."""
    bucket = next(b for b in eng._buckets if b >= len(prompt))
    toks = torch.zeros((1, bucket), dtype=torch.long)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    with torch.no_grad():
        return engine_mod._prefill_logits(params, toks.cuda(), len(prompt),
                                          cfg, eng._freqs)


def check_feature_logits(torch, label, got, want, first_tok):
    """A feature path's first-token logits against the one-shot ones,
    within LOGITS_REL_L2, and the emitted first token their argmax."""
    if not (torch.isfinite(got).all() and got.shape == want.shape):
        fail(f"{label}: first-token logits not finite or of the wrong shape")
    rel = float((got - want).norm() / want.norm())
    print(f"{label}: first-token logits vs one-shot: rel_l2={rel} "
          f"tol_rel_l2={LOGITS_REL_L2} argmax {int(got.argmax())}/"
          f"{int(want.argmax())} emitted {first_tok}", flush=True)
    if not rel <= LOGITS_REL_L2:
        fail(f"{label}: first-token logits differ from one-shot, rel L2 "
             f"{rel} > {LOGITS_REL_L2}")
    if int(got.argmax()) != first_tok:
        fail(f"{label}: emitted {first_tok}, not the argmax of the logits")


def check_prefix_rows(torch, label, eng, slot, ref_k, ref_v, p, n):
    """A prefix hit's slot rows [0, n) against the one-shot prefill's, per
    row. The prefix rows [0, p) come from A1 on both sides and take the
    bf16 row tolerance; so do the suffix rows of layer 0, which depend on
    their tokens and positions only. The suffix rows of layers 1-31 carry
    the suffix pass's plain attention (P rounded to bf16) where the
    one-shot rows carry A1's (~16 bits of P), carried through the layers
    below: they take LOGITS_REL_L2, the first-token check's tolerance for
    the same difference."""
    from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
    tol = ROW_RTOL[torch.bfloat16]
    for name, grid, ref in (("K", eng._cache.k, ref_k), ("V", eng._cache.v, ref_v)):
        got, want = grid[:, slot, :n], ref[:, 0, :n]
        prefix = row_rel_err(got[:, :p], want[:, :p])
        first = row_rel_err(got[0, p:], want[0, p:])
        deep = [row_rel_err(got[i, p:], want[i, p:]) for i in range(1, got.shape[0])]
        print(f"{label}: slot rows {name} vs one-shot, max row rel err: prefix "
              f"rows {prefix} (tol {tol}), suffix rows layer 0 {first} (tol "
              f"{tol}), layers 1-{got.shape[0] - 1} max {max(deep)} (tol "
              f"{LOGITS_REL_L2}) per layer {[round(x, 5) for x in deep]}",
              flush=True)
        if not (prefix <= tol and first <= tol and max(deep) <= LOGITS_REL_L2):
            fail(f"{label}: slot rows {name} differ from the one-shot rows")


def drive_engine_features(torch, ops_attn, ops_dec, params, cfg, plain, card):
    """The bf16 engine's request features at Llama-3-8B's full width and
    depth, on the engine phase's params and grid; ``plain`` (that phase's
    engine) runs the one-shot comparisons. Returns the launches of the
    three runs of the main path together."""
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod

    rng = np.random.default_rng(7)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    launches = Launches(ops_attn, ops_dec)
    L = cfg.n_layers
    total = {}

    # -- prefix cache: register, four prefix_id requests, four auto-matched
    eng = GenerationEngine(params, cfg, **FEATURE_GRID, auto_prefix=True,
                           device="cuda")
    # warm-up, not counted: a hit in each suffix bucket (allocator, GEMM
    # plans), as the engine phase warms every prefill bucket
    warm = eng.register_prefix(prompt(PREFIX_LEN))
    for n in (40, 200):
        eng.submit(prompt(n), max_new_tokens=2, prefix_id=warm)
    drain(torch, eng)
    eng.unregister_prefix(warm)
    steps0, hits0 = eng.stats().decode_steps, eng._prefix_hits
    prefix = prompt(PREFIX_LEN)
    suffixes = [prompt(n) for n in PREFIX_SUFFIXES]
    launches.zero()
    with recorded_logits(engine_mod) as suffix_logits:
        pid = eng.register_prefix(prefix)
        stored = eng._prefixes[pid]
        kept = (stored.k.clone(), stored.v.clone())
        handles = [eng.submit(s, max_new_tokens=MAX_NEW, prefix_id=pid)
                   for s in suffixes[:4]]
        handles += [eng.submit(prefix + s, max_new_tokens=MAX_NEW)
                    for s in suffixes[4:]]
        eng.step()                     # admits all eight
        slot_of = {r.rid: i for i, r in enumerate(eng._slot_req) if r}
        drain(torch, eng)
    got = launches.read()
    n_steps = eng.stats().decode_steps - steps0
    check_launches("engine_features prefix", got,
                   dict(flash_fwd=L, decode_attention=L * n_steps,
                        decode_attention_quant=0))
    total = {k: total.get(k, 0) + v for k, v in got.items()}
    outs = [h.result(timeout=0) for h in handles]
    if eng._prefix_hits - hits0 != 8 or any(len(o) != MAX_NEW for o in outs):
        fail(f"engine_features prefix: {eng._prefix_hits - hits0} prefix hits, "
             f"tokens {[len(o) for o in outs]}")
    if not (torch.equal(stored.k, kept[0]) and torch.equal(stored.v, kept[1])):
        fail("engine_features prefix: the stored prefix rows changed")
    print("engine_features prefix: 8 prefix hits (4 prefix_id, 4 auto_prefix), "
          f"{MAX_NEW} tokens each; stored prefix rows bitwise unchanged; A1 "
          f"once per layer (the registration), none in the 8 suffix passes",
          flush=True)
    for i in (0, 4):               # one prefix_id hit, one auto_prefix hit
        full = prefix + suffixes[i]
        lk, rk, rv = one_shot(torch, engine_mod, params, cfg, plain, full)
        check_feature_logits(torch, f"engine_features prefix hit {i} "
                             f"(suffix {len(suffixes[i])})", suffix_logits[i],
                             lk, outs[i][0])
        check_prefix_rows(torch, f"engine_features prefix hit {i}", eng,
                          slot_of[handles[i].request_id], rk, rv,
                          PREFIX_LEN, len(full))
        del lk, rk, rv
    ttft_hit = [h.time_to_first_token() for h in handles]

    def admit_one(e, toks, **kw):
        """One step that only admits: a one-token request retires at its
        first token, so no decode step follows."""
        e.submit(toks, max_new_tokens=1, **kw)
        e.step()

    profile_steps(torch, "1 prefix-hit admission (suffix 200, bucket 256)",
                  lambda: admit_one(eng, suffixes[3], prefix_id=pid), 1)
    del eng, stored, kept
    gc.collect()
    torch.cuda.empty_cache()
    ref = [plain.submit(prefix + s, max_new_tokens=MAX_NEW) for s in suffixes]
    drain(torch, plain)
    ttft_one = [h.time_to_first_token() for h in ref]
    print(f"engine_features prefix: mean_ttft_s prefix hits "
          f"{sum(ttft_hit) / 8} vs the same 8 prompts one-shot "
          f"{sum(ttft_one) / 8} (submit to first token, 8 admitted in one "
          f"step, queueing included); mean admission wall (gap between "
          f"consecutive first tokens) {float(np.diff(sorted(ttft_hit)).mean())} "
          f"vs {float(np.diff(sorted(ttft_one)).mean())} s card={card}",
          flush=True)

    # -- chunked prefill: 7 slots decoding, then an 1800-token prompt
    eng = GenerationEngine(params, cfg, **FEATURE_GRID, prefill_chunk=CHUNK,
                           device="cuda")
    eng.submit(prompt(CHUNK_PROMPT), max_new_tokens=2)     # warm-up
    drain(torch, eng)
    steps0 = eng.stats().decode_steps
    shorts = [prompt(40) for _ in range(7)]
    long = prompt(CHUNK_PROMPT)
    launches.zero()
    with recorded_logits(engine_mod) as chunk_logits:
        handles = [eng.submit(p, max_new_tokens=MAX_NEW) for p in shorts]
        eng.step()
        handles.append(eng.submit(long, max_new_tokens=MAX_NEW))
        chunk_walls = []
        while eng._pending or eng._chunking is not None:
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            chunk_walls.append(time.perf_counter() - t)
        drain(torch, eng)
    got = launches.read()
    n_steps = eng.stats().decode_steps - steps0
    check_launches("engine_features chunked", got,
                   dict(flash_fwd=L * 8, decode_attention=L * n_steps,
                        decode_attention_quant=0))
    total = {k: total.get(k, 0) + v for k, v in got.items()}
    outs = [h.result(timeout=0) for h in handles]
    n_chunks = -(-CHUNK_PROMPT // CHUNK)
    if any(len(o) != MAX_NEW for o in outs) or len(chunk_walls) != n_chunks \
            or len(chunk_logits) != n_chunks - 1:
        fail(f"engine_features chunked: tokens {[len(o) for o in outs]}, "
             f"{len(chunk_walls)} chunk steps, {len(chunk_logits)} suffix "
             f"passes")
    lk, _, _ = one_shot(torch, engine_mod, params, cfg, plain, long)
    check_feature_logits(torch, "engine_features chunked "
                         f"({CHUNK_PROMPT} tokens, chunks of {CHUNK})",
                         chunk_logits[-1], lk, outs[-1][0])
    eng.submit(long, max_new_tokens=1)
    profile_steps(torch, f"{n_chunks} chunk steps of {CHUNK} ({CHUNK_PROMPT}-token "
                  f"prompt, no decoding slot)", eng.step, n_chunks)
    profile_steps(torch, f"1 one-shot admission ({CHUNK_PROMPT}-token prompt, "
                  f"bucket 2048)", lambda: admit_one(plain, long), 1)
    del eng, lk
    gc.collect()
    torch.cuda.empty_cache()
    ref = [plain.submit(p, max_new_tokens=MAX_NEW) for p in shorts]
    plain.step()
    ref.append(plain.submit(long, max_new_tokens=MAX_NEW))
    t = time.perf_counter()
    plain.step()
    torch.cuda.synchronize()
    stall = time.perf_counter() - t
    drain(torch, plain)
    print(f"engine_features chunked: {len(outs)} requests, {MAX_NEW} tokens "
          f"each; A1 for the 7 short prefills and the first chunk only; wall "
          f"of each step that carried a chunk (7 slots decoding) "
          f"{[round(w * 1e3, 3) for w in chunk_walls]} ms vs the step that "
          f"admits the same prompt one-shot {stall * 1e3} ms card={card}",
          flush=True)

    # -- penalties and logit_bias beside 6 plain requests, against the same
    # 6 requests alone (the plain engine has no penalty or bias grid yet)
    nbrs = [prompt(40) for _ in range(6)]
    biased, penalized = prompt(40), prompt(40)
    steps0 = plain.stats().decode_steps
    launches.zero()
    alone = [plain.submit(p, max_new_tokens=MAX_NEW) for p in nbrs]
    rate_alone = decode_rate(drain(torch, plain))
    if plain._counts is not None or plain._bias is not None:
        fail("engine_features penalties: grids allocated without a request")
    beside = [plain.submit(p, max_new_tokens=MAX_NEW) for p in nbrs]
    hb = plain.submit(biased, max_new_tokens=MAX_NEW,
                      logit_bias={BIAS_TOKEN: 100.0})
    hp = plain.submit(penalized, max_new_tokens=MAX_NEW,
                      presence_penalty=HUGE_PRESENCE)
    rate_beside = decode_rate(drain(torch, plain))
    got = launches.read()
    n_steps = plain.stats().decode_steps - steps0
    check_launches("engine_features penalties", got,
                   dict(flash_fwd=L * 14, decode_attention=L * n_steps,
                        decode_attention_quant=0))
    total = {k: total.get(k, 0) + v for k, v in got.items()}
    forced, rep = hb.result(timeout=0), hp.result(timeout=0)
    same = all(a.result(timeout=0) == b.result(timeout=0)
               and a.logprobs == b.logprobs for a, b in zip(alone, beside))
    print(f"engine_features penalties: logit_bias {{{BIAS_TOKEN}: 100}} "
          f"emitted it {forced.count(BIAS_TOKEN)}/{len(forced)}; presence "
          f"penalty {HUGE_PRESENCE}: {len(set(rep))} distinct of {len(rep)}, "
          f"{len(set(rep) & set(penalized))} from the prompt; neighbours' "
          f"tokens and logprobs bit-identical to the run without them: {same}",
          flush=True)
    if forced != [BIAS_TOKEN] * MAX_NEW:
        fail(f"engine_features penalties: logit_bias gave {forced}")
    if len(rep) != MAX_NEW or len(set(rep)) != len(rep) or set(rep) & set(penalized):
        fail(f"engine_features penalties: presence penalty repeated: {rep}")
    if not same:
        fail("engine_features penalties: a neighbour's tokens or logprobs "
             "changed beside penalized and biased requests")
    print(f"engine_features penalties: decode_tok_per_s with penalties and "
          f"bias active {rate_beside[0]} ({rate_beside[1]} ms/step, 8 slots) "
          f"vs the 6 neighbours alone {rate_alone[0]} ({rate_alone[1]} "
          f"ms/step, 6 slots) card={card}", flush=True)
    return total


def drive_engine_q4_features(torch, ops_attn, ops_dec, ops_q4, params, cfg,
                             prompt, card):
    """The int4 + int8-KV engine's prefix cache and chunked prefill: a
    registered 1000-token prefix with one prefix hit, and an 1800-token
    prompt in chunks of 512, with exact launch counts and first-token
    logits against one-shot prefills. Returns the launches."""
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod

    eng = GenerationEngine(params, cfg, **FEATURE_GRID, quantize_kv=True,
                           prefill_chunk=CHUNK, device="cuda")
    prefix, suffix, long = prompt(PREFIX_LEN), prompt(100), prompt(CHUNK_PROMPT)
    launches = Launches(ops_attn, ops_dec, ops_q4)
    launches.zero()
    with recorded_logits(engine_mod) as suffix_logits:
        pid = eng.register_prefix(prefix)
        hp = eng.submit(suffix, max_new_tokens=MAX_NEW, prefix_id=pid)
        hc = eng.submit(long, max_new_tokens=MAX_NEW)
        drain(torch, eng)
    got = launches.read()
    steps = eng.stats().decode_steps
    L = cfg.n_layers
    head = params["lm_head"]
    head_q4 = int(ops_q4.q4_supported((1, cfg.dim), head["__kt_q4__"].shape,
                                      head["scale"].shape))
    n_chunks = -(-CHUNK_PROMPT // CHUNK)
    passes = 2 + n_chunks          # the registration, the suffix, the chunks
    check_launches("engine_q4_features", got,
                   dict(flash_fwd=2 * L, decode_attention=0,
                        decode_attention_quant=L * steps,
                        q4_matmul=(7 * L + head_q4) * (passes + steps)))
    outs = [hp.result(timeout=0), hc.result(timeout=0)]
    if [len(o) for o in outs] != [MAX_NEW] * 2 or eng._prefix_hits != 1 \
            or len(suffix_logits) != 1 + (n_chunks - 1):
        fail(f"engine_q4_features: tokens {[len(o) for o in outs]}, "
             f"{eng._prefix_hits} prefix hits, {len(suffix_logits)} passes")
    print(f"engine_q4_features: a prefix hit and a chunked admission "
          f"({n_chunks} chunks), {MAX_NEW} tokens each, over {steps} decode "
          f"steps: A1 = {L} x 2 from-zero prefills (registration, first chunk), "
          f"B3 = {7 * L + head_q4} x ({passes} prefill passes + steps), B2 = "
          f"{L} x steps card={card}", flush=True)
    for label, logits, full, tok in (
            ("prefix hit", suffix_logits[0], prefix + suffix, outs[0][0]),
            ("chunked", suffix_logits[-1], long, outs[1][0])):
        lk, _, _ = one_shot(torch, engine_mod, params, cfg, eng, full)
        check_feature_logits(torch, f"engine_q4_features {label}", logits,
                             lk, tok)
        del lk
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return got


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
    """Llama-3-8B, full width at CUT_LAYERS, int4 weights (group 128) and an
    int8 KV cache, through GenerationEngine: the engine phase's warm-up and
    requests, with the launch counts set to 0 just before the requests and
    read just after."""
    from kubetorch_tpu_torch.models.llama import LlamaConfig
    from kubetorch_tpu_torch.models.quant import (dequantize_params,
                                                  llama_init_quantized,
                                                  quantized_bytes)
    from kubetorch_tpu_torch.serve import GenerationEngine, QuantKVCache
    from kubetorch_tpu_torch.serve import engine as engine_mod

    cfg = LlamaConfig.llama3_8b(n_layers=CUT_LAYERS)
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
    launches = Launches(ops_attn, ops_dec, ops_q4)
    launches.zero()
    handles, tok_s, steps = serve_requests(torch, eng, cfg, prompts)
    counts = launches.read()
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
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    features = drive_engine_q4_features(torch, ops_attn, ops_dec, ops_q4,
                                        params, cfg, prompt, card)
    lora = drive_lora_q4(torch, ops_attn, ops_dec, ops_q4, params, cfg, card)
    draft, dcfg = spec_draft(torch)
    spec_n, spec = drive_spec(torch, ops_attn, ops_dec, ops_q4, "spec_q4",
                              params, cfg, draft, dcfg, prompts, tok_s, card,
                              quant=True)
    del draft
    return counts, features, lora, spec_n, spec


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


def kernel_counts(trace_file: str, names) -> dict:
    """How many device-kernel events of a Chrome trace have each of
    ``names`` in their kernel name."""
    with open(trace_file) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}


def lost_kernel_records(trace_file: str) -> list:
    """The kernel launches of a Chrome trace whose kernel event is missing:
    a runtime or driver launch call whose correlation id no kernel event
    carries. Each as (correlation, innermost enclosing CPU op, us after
    the first launch)."""
    with open(trace_file) as f:
        events = json.load(f).get("traceEvents", [])
    ran = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") == "kernel"}
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "LaunchKernel" in e.get("name", "")]
    t0 = min((e["ts"] for e in calls), default=0)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    lost = []
    for e in calls:
        corr = e.get("args", {}).get("correlation")
        if corr in ran:
            continue
        around = [o for o in ops if o["ts"] <= e["ts"] <= o["ts"] + o.get("dur", 0)]
        op = min(around, key=lambda o: o.get("dur", 0))["name"] if around else None
        lost.append((corr, op, e["ts"] - t0))
    return lost


def profile_steps(torch, label, run, n, groups=None):
    """torch.profiler over ``n`` calls of ``run``: wall and device-busy ms
    per step, the busy share, and the top device kernels; with ``groups``
    (name -> substrings of kernel names), each group's share of busy.
    Returns the first three as a dict (None when no device time was
    recorded)."""
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
        return None
    print(f"profile: {label}: wall_ms_per_step="
          f"{wall_us / n / 1e3} device_busy_ms_per_step={busy_us / n / 1e3} "
          f"device_busy_share={busy_us / wall_us}", flush=True)
    rec = dict(wall_ms_per_step=wall_us / n / 1e3,
               device_busy_ms_per_step=busy_us / n / 1e3,
               device_busy_share=busy_us / wall_us)
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"profile: {dev_us(e) / n / 1e3:.4f} ms/step "
              f"({dev_us(e) / busy_us:.3f} of busy) x{e.count // n}/step "
              f"{e.key[:90]}", flush=True)
    for name, keys in (groups or {}).items():
        members = [e for e in events if any(k in e.key for k in keys)]
        us = sum(dev_us(e) for e in members)
        print(f"profile: {label}: {name}: {us / n / 1e3} ms/step, "
              f"{us / busy_us} of busy over {len(members)} kernels named "
              f"{keys}, the largest: "
              f"{[e.key[:70] for e in sorted(members, key=dev_us)[-3:]]}",
              flush=True)
        rec[f"{name}_share_of_busy"] = us / busy_us
    return rec


def seeded_adapter(torch, params, lcfg, seed):
    """A LoRA adapter for ``params``: lora_init's A factors, and B factors
    drawn N(0, LORA_B_STD^2) on the card from ``seed``."""
    from kubetorch_tpu_torch.models.lora import lora_init
    ad = lora_init(params, lcfg, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    for k, v in ad["layers"].items():
        if k.endswith("__b"):
            ad["layers"][k] = (torch.randn(v.shape, generator=gen, device="cuda")
                               * LORA_B_STD).to(v.dtype)
    return ad


def lora_config():
    from kubetorch_tpu_torch.models.lora import LoraConfig
    return LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA,
                      targets=("wq", "wk", "wv", "wo"))


def timed_steps(torch, eng, n):
    """ms per step over ``n`` engine steps that admit nothing."""
    t = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def check_merged_logits(torch, label, got, merged, cfg, eng, prompt, first_tok,
                        impl=None):
    """An adapter request's first-token logits (the engine's activation
    path) against the same prompt one-shot on merge_lora weights, within
    LOGITS_REL_L2; ``impl`` runs the merged side with that attn_impl."""
    from kubetorch_tpu_torch.serve import engine as engine_mod
    c = cfg if impl is None else dataclasses.replace(cfg, attn_impl=impl)
    lk, _, _ = one_shot(torch, engine_mod, merged, c, eng, prompt)
    check_feature_logits(torch, label, got, lk, first_tok)


def drive_lora(torch, ops_attn, ops_dec, params, cfg, plain, card):
    """Multi-LoRA on the bf16 Llama-3-8B engine at full width, CUT_LAYERS,
    on the engine phase's params; ``plain`` (that phase's engine, no
    banks) runs the same traffic on the base model. Returns the launches
    of the adapter runs together, and the engine with its banks (the
    trained adapter of the lora_train phase is served on it)."""
    from kubetorch_tpu_torch.models.lora import merge_lora
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod

    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    lcfg = lora_config()
    adapters = [seeded_adapter(torch, params, lcfg, seed) for seed in (1, 2, 3)]
    eng = GenerationEngine(params, cfg, **FEATURE_GRID, auto_prefix=True,
                           device="cuda")
    ids = [eng.register_adapter(a, lcfg) for a in adapters]
    # warm-up, not counted: one request per adapter (allocator, GEMM plans)
    warm = [eng.submit(prompt(100), max_new_tokens=2, adapter_id=i) for i in ids]
    drain(torch, eng)
    for h in warm:
        h.result(timeout=0)
    prompts = [prompt(n) for n in LORA_PROMPTS]
    owners = [None, None, ids[0], ids[0], ids[1], ids[1], ids[2], ids[2]]
    launches = Launches(ops_attn, ops_dec)
    L = cfg.n_layers
    steps0 = eng.stats().decode_steps
    launches.zero()
    with recorded_logits(engine_mod, "_prefill_logits") as first_logits:
        handles = [eng.submit(p, max_new_tokens=MAX_NEW, adapter_id=a)
                   for p, a in zip(prompts, owners)]
        eng.step()                        # admits all eight, one decode step
        torch.cuda.synchronize()
        ms_adapters = timed_steps(torch, eng, LORA_TIMED_STEPS)
        evicted = [i for i, r in enumerate(eng._slot_req)
                   if r is not None and r.adapter_id == ids[2]]
        eng.unregister_adapter(ids[2])
        repointed = [int(eng._aidx[i]) for i in evicted]
        drain(torch, eng)
    got = launches.read()
    n_steps = eng.stats().decode_steps - steps0
    check_launches("lora", got, dict(flash_fwd=L * len(prompts),
                                     decode_attention=L * n_steps,
                                     decode_attention_quant=0))
    outs = [h.result(timeout=0) for h in handles]
    if any(len(o) != MAX_NEW for o in outs) or len(first_logits) != len(prompts):
        fail(f"lora: tokens {[len(o) for o in outs]}, {len(first_logits)} "
             f"prefills recorded")
    if len(evicted) != 2 or repointed != [0, 0]:
        fail(f"lora: unregistering adapter {ids[2]} left slots {evicted} at "
             f"bank indices {repointed}, not the base model's 0")
    print(f"lora: 8 requests (2 base, 2 on each of 3 adapters, rank "
          f"{LORA_RANK}, alpha {LORA_ALPHA}) completed, {MAX_NEW} tokens each; "
          f"adapter {ids[2]} unregistered after {1 + LORA_TIMED_STEPS} decode "
          f"steps, its 2 slots repointed to the base model and finished; "
          f"A1 = {L} x 8 prefills, B1 = {L} x {n_steps} steps", flush=True)

    # the same eight prompts on the engine without banks: the base
    # requests' tokens and logprobs must be the same bits
    ref = [plain.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    plain.step()
    torch.cuda.synchronize()
    ms_none = timed_steps(torch, plain, LORA_TIMED_STEPS)
    drain(torch, plain)
    same = all(handles[i].result(timeout=0) == ref[i].result(timeout=0)
               and handles[i].logprobs == ref[i].logprobs for i in (0, 1))
    differ = sum(outs[i] != ref[i].result(timeout=0) for i in range(2, 8))
    print(f"lora: base requests beside 3 adapters vs the engine without "
          f"banks: tokens and logprobs bit-identical: {same}; adapter "
          f"requests whose tokens differ from the base model's: {differ} of 6",
          flush=True)
    if not same:
        fail("lora: a base request's tokens or logprobs changed beside adapters")
    if differ == 0:
        fail("lora: every adapter request gave the base model's tokens")
    print(f"lora: decode ms/step with 3 adapters active {ms_adapters} vs the "
          f"same grid with none {ms_none} (8 slots, {LORA_TIMED_STEPS} steps "
          f"each, after one step past admission) card={card}", flush=True)

    for j, aid in enumerate(ids):
        merged = merge_lora(params, adapters[j], lcfg)
        for i in (2 + 2 * j, 3 + 2 * j):
            check_merged_logits(torch, f"lora adapter {aid} request {i} "
                                f"({len(prompts[i])} tokens) vs merge_lora",
                                first_logits[i], merged, cfg, plain,
                                prompts[i], outs[i][0])
        del merged
    gc.collect()
    torch.cuda.empty_cache()

    # a prefix registered through adapter ids[0] serves its requests only
    prefix, suffix = prompt(LORA_PREFIX), prompt(60)
    hits0 = eng._prefix_hits
    launches.zero()
    eng.register_prefix(prefix, adapter_id=ids[0])
    hb = eng.submit(prefix + suffix, max_new_tokens=4)
    drain(torch, eng)
    base_hits = eng._prefix_hits - hits0
    ha = eng.submit(prefix + suffix, max_new_tokens=4, adapter_id=ids[0])
    drain(torch, eng)
    adapter_hits = eng._prefix_hits - hits0 - base_hits
    prefix_n = launches.read()
    print(f"lora: a {LORA_PREFIX}-token prefix registered through adapter "
          f"{ids[0]}: auto_prefix hits for a base request {base_hits}, for a "
          f"request on the adapter {adapter_hits}; A1 {prefix_n['flash_fwd']} "
          f"(the registration and the base request's prefill)", flush=True)
    if (base_hits, adapter_hits) != (0, 1) or prefix_n["flash_fwd"] != 2 * L \
            or len(hb.result(timeout=0)) != 4 or len(ha.result(timeout=0)) != 4:
        fail("lora: the adapter-keyed prefix was not matched as expected")
    total = {k: got[k] + prefix_n[k] for k in got}
    del adapters
    gc.collect()
    torch.cuda.empty_cache()
    print(f"lora: phase wall {time.perf_counter() - t_phase:.1f}s", flush=True)
    return total, eng


def leaf_hashes(torch, tree):
    """One int64 per leaf of ``tree``, from the leaf's bits: the sum of
    its 2- or 4-byte words weighted by position mod 65521, wrapping, so
    any changed word (or two swapped) moves it. Computed on the card in
    chunks."""
    from kubetorch_tpu_torch.train.optim import tree_leaves
    out = []
    for t in tree_leaves(tree):
        words = t.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[t.element_size()])
        h = torch.zeros((), dtype=torch.int64, device=t.device)
        for i, c in enumerate(words.split(1 << 26)):
            w = (torch.arange(c.numel(), device=c.device, dtype=torch.int64)
                 + i * (1 << 26)) % 65521 + 1
            h += (c.to(torch.int64) * w).sum()
        out.append(int(h))
    return out


def host_batch(torch, vocab, seed):
    """One TRAIN_B x TRAIN_S batch in host memory, tokens from a seed."""
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (TRAIN_B, TRAIN_S)))
    return {"tokens": toks, "targets": toks.roll(-1, 1)}


def run_train_steps(torch, ops_attn, label, step, state, batch, n_layers):
    """TRAIN_STEPS steps of ``step`` on ``batch`` fed through
    prefetch_to_device, with the launch counts set to 0 just before and
    read just after, the peak memory and the step histogram's compute
    observations. Gates: finite losses, a lower last loss than the first,
    A1 twice per layer and step (remat), A2 and A3 once, one compute
    observation per step. Returns (state, losses, record)."""
    from kubetorch_tpu_torch import telemetry
    from kubetorch_tpu_torch.train import prefetch_to_device

    hist = telemetry.train_metrics()["step_seconds"]
    seen0 = hist.count(phase="compute")
    fa = ops_attn.flash_attention
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, t1 = [], None
    batches = prefetch_to_device(itertools.repeat(batch, TRAIN_STEPS), size=2)
    for i, b in enumerate(batches):
        if i == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seen = hist.count(phase="compute") - seen0
    losses = [float(x) for x in losses]
    print(f"{label}: losses {losses}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: first {losses[0]}, last {losses[-1]}")
    want = (2 * n_layers * TRAIN_STEPS, n_layers * TRAIN_STEPS,
            n_layers * TRAIN_STEPS)
    check_launches(f"{label} (A1, A2, A3) over {TRAIN_STEPS} steps", counts, want)
    print(f"{label}: kt_train_step_seconds{{phase=\"compute\"}} observations "
          f"{seen} over {TRAIN_STEPS} steps", flush=True)
    if seen != TRAIN_STEPS:
        fail(f"{label}: {seen} compute observations over {TRAIN_STEPS} steps")
    tps = TRAIN_B * TRAIN_S * (TRAIN_STEPS - 1) / dt
    rec = dict(launches=counts, tokens_per_s=tps,
               ms_per_step=dt / (TRAIN_STEPS - 1) * 1e3, peak_memory_gb=peak_gb,
               losses=losses)
    print(f"{label}: tokens_per_s={tps} ms_per_step={rec['ms_per_step']} "
          f"(steps 2-{TRAIN_STEPS}) peak_memory_gb={peak_gb} "
          f"batch={TRAIN_B}x{TRAIN_S}", flush=True)
    return state, losses, rec


def max_leaf_rel(torch, got, want) -> float:
    """Largest over leaves of max |got - want| / max |want|."""
    from kubetorch_tpu_torch.train.optim import tree_leaves
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def drive_lora_train(torch, ops_attn, ops_dec, params, cfg, lora_eng, card):
    """A LoRA fine-tune of the bf16 Llama-3-8B params at full width and
    depth, then the trained adapter served merged and banked (on the LoRA
    phase's engine ``lora_eng``). Returns the kernels-line records."""
    from kubetorch_tpu_torch.models.llama import llama_init
    from kubetorch_tpu_torch.models.lora import lora_init, lora_loss, merge_lora
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod
    from kubetorch_tpu_torch.train import adamw, init_train_state, make_train_step

    t_phase = time.perf_counter()
    L = cfg.n_layers
    lcfg = lora_config()
    base_hash = leaf_hashes(torch, params)
    opt = adamw(LORA_TRAIN_LR)
    state = init_train_state(lora_init(params, lcfg, seed=LORA_TRAIN_SEED), opt)
    step = make_train_step(lora_loss(params, cfg, lcfg), opt)
    batch = host_batch(torch, cfg.vocab_size, seed=LORA_TRAIN_SEED)
    tok, tgt = batch["tokens"].cuda(), batch["targets"].cuda()
    with torch.no_grad():
        plain0 = float(lora_loss(params, dataclasses.replace(cfg, attn_impl="xla"),
                                 lcfg)(state.params, tok, tgt))
    print(f"lora_train: Llama-3-8B base ({cfg.param_count()} params, bf16, "
          f"frozen), adapters rank {lcfg.rank} on {lcfg.targets} "
          f"({sum(t.numel() for t in state.params['layers'].values())} "
          f"params), adamw({LORA_TRAIN_LR}), remat dots, chunked CE "
          f"{TRAIN_CHUNK} card={card}", flush=True)
    state, losses, rec = run_train_steps(torch, ops_attn, "lora_train", step,
                                         state, batch, L)
    diff = abs(losses[0] - plain0)
    print(f"lora_train: step-0 loss kernel vs plain path, bf16: {losses[0]} "
          f"vs {plain0}, |diff|={diff} tol={LOSS_ABS}", flush=True)
    if not diff <= LOSS_ABS:
        fail(f"lora_train: step-0 loss differs from the plain path by {diff}")

    def one_step():
        nonlocal state
        state, _ = step(state, {"tokens": tok, "targets": tgt})

    profile_steps(torch, f"lora_train: 1 step, batch {TRAIN_B}x{TRAIN_S}",
                  one_step, 1, groups={
                      "attention (A1, A2, A3)": ("_sm90",),
                      "cuBLAS GEMMs": ("nvjet", "gemm", "sm90_xmma")})
    same = leaf_hashes(torch, params) == base_hash
    print(f"lora_train: base leaves bit-identical after "
          f"{TRAIN_STEPS + 1} steps (leaf hashes): {same}", flush=True)
    if not same:
        fail("lora_train: a base leaf changed")
    trained = state.params
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # adapter gradients, kernel path vs plain path, fp32 at 2 layers
    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                                max_seq_len=TRAIN_CHECK_S)
    base32 = llama_init(small, seed=3, device="cuda")
    ad32 = seeded_adapter(torch, base32, lcfg, seed=5)
    check = {"tokens": tok[:1, :TRAIN_CHECK_S], "targets": tgt[:1, :TRAIN_CHECK_S]}
    grads = {}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(small, attn_impl=impl)
        _, grads[impl] = make_train_step(lora_loss(base32, c, lcfg)) \
            .loss_and_grads(ad32, check)
    worst = max_leaf_rel(torch, grads["auto"], grads["xla"])
    print(f"lora_train: adapter grads kernel vs plain path, fp32, 2 layers, "
          f"B=1 S={TRAIN_CHECK_S}: max per-leaf |diff| / max |plain| = {worst} "
          f"tol={TRAIN_GRAD_REL}", flush=True)
    if not worst <= TRAIN_GRAD_REL:
        fail(f"lora_train: kernel-path adapter grads differ: {worst}")
    del base32, ad32, grads
    gc.collect()
    torch.cuda.empty_cache()

    # serve the trained adapter merged, then banked
    rng = np.random.default_rng(LORA_TRAIN_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LORA_SERVE_PROMPTS]
    merged = merge_lora(params, trained, lcfg)
    eng = GenerationEngine(merged, cfg, **FEATURE_GRID, device="cuda")
    launches = Launches(ops_attn, ops_dec)
    serve_n = {}
    outs, logits = {}, {}
    for way, e in (("merged", eng), ("banked", lora_eng)):
        aid = None if way == "merged" else e.register_adapter(trained, lcfg)
        steps0 = e.stats().decode_steps
        launches.zero()
        with recorded_logits(engine_mod, "_prefill_logits") as first:
            hs = [e.submit(p, max_new_tokens=MAX_NEW, adapter_id=aid)
                  for p in prompts]
            drain(torch, e)
        got = launches.read()
        n_steps = e.stats().decode_steps - steps0
        check_launches(f"lora_serve {way}", got, dict(
            flash_fwd=L * len(prompts), decode_attention=L * n_steps,
            decode_attention_quant=0))
        outs[way] = [h.result(timeout=0) for h in hs]
        if any(len(o) != MAX_NEW for o in outs[way]):
            fail(f"lora_serve {way}: tokens {[len(o) for o in outs[way]]}")
        logits[way], serve_n[way] = first, got
    for i, p in enumerate(prompts):
        check_feature_logits(torch, f"lora_serve banked request {i} "
                             f"({len(p)} tokens) vs the merged tree",
                             logits["banked"][i], logits["merged"][i],
                             outs["banked"][i][0])
    agree = sum(a == b for a, b in zip(outs["merged"], outs["banked"]))
    print(f"lora_serve: the trained adapter served merged (merge_lora -> "
          f"engine) and banked (registered beside the LoRA phase's "
          f"adapters): {len(prompts)} requests of {MAX_NEW} greedy tokens "
          f"each way, {agree}/{len(prompts)} with equal tokens card={card}",
          flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rollout = drive_rollout(torch, ops_attn, ops_dec, params, merged, cfg,
                            prompts, outs["merged"], card)
    del merged, trained
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"lora_train: phase wall {wall:.1f}s", flush=True)
    return dict(**rec, step0_loss_plain=plain0, grad_rel=worst,
                serve=serve_n, phase_wall_s=wall, rollout=rollout)


class MemStore:
    """The port's store protocol (kubetorch_tpu_torch/data_store/
    commands.py) in this process's memory. It keeps the arrays it is given,
    with no serialisation copy; its index is the JAX store's (dtype, shape
    and blake2b per leaf, the structure), and a put skips every leaf whose
    key already holds the same blake2b, or the very array it is given
    (unhashed: the script never writes into a host array it has put).
    ``fail_json`` makes the next ``put_json`` raise: a commit marker lost
    mid-commit."""

    def __init__(self):
        self.kv = {}          # key/path -> (array, blake2b)
        self.index = {}       # key -> the index's JSON bytes
        self.json = {}
        self.fail_json = False

    def put(self, key, tree):
        import hashlib

        from kubetorch_tpu_torch.data_store import commands as ds
        leaves = {}
        ds._flatten(tree, "", leaves)
        prev = {p: self.kv.get(f"{key}/{p}") for p in leaves}
        same = {p: h[1] for p, h in prev.items()
                if h is not None and h[0] is leaves[p]}
        hashes = {**ds.hash_leaves({p: a for p, a in leaves.items()
                                    if p not in same}), **same}
        index = {"leaves": {p: {"dtype": str(a.dtype), "shape": list(a.shape),
                                "kind": "array", "blake2b": hashes[p]}
                            for p, a in leaves.items()},
                 "structure": ds._structure_of(tree)}
        moved = skipped = 0
        for p, a in leaves.items():
            held = self.kv.get(f"{key}/{p}")
            if held is not None and held[1] == hashes[p]:
                skipped += 1
                continue
            self.kv[f"{key}/{p}"] = (a, hashes[p])
            moved += a.nbytes
        data = json.dumps(index).encode()
        self.index[key] = data      # the index last
        return {"leaves": len(leaves), "bytes": moved, "skipped": skipped,
                "index_blake2b": hashlib.blake2b(data,
                                                 digest_size=20).hexdigest()}

    def get(self, key):
        from kubetorch_tpu_torch.data_store import commands as ds
        index = json.loads(self.index[key])
        return ds._unflatten(index["structure"], "", {
            p: self.kv[f"{key}/{p}"][0] for p in index["leaves"]})

    def put_json(self, key, obj):
        if self.fail_json:
            self.fail_json = False
            raise OSError(f"put_json {key!r}: the store went away")
        self.json[key] = json.dumps(obj)
        return {"key": key}

    def get_json(self, key, quorum=False, default=None):
        v = self.json.get(key)
        return default if v is None else json.loads(v)

    def get_index(self, key, expect_hash=None):
        import hashlib
        data = self.index.get(key)
        if data is None:
            return None
        if expect_hash and hashlib.blake2b(
                data, digest_size=20).hexdigest() != expect_hash:
            raise ValueError(f"index of {key!r} does not hash to {expect_hash}")
        return json.loads(data)

    def get_leaf(self, key, path, meta):
        held = self.kv.get(f"{key}/{path}")
        if held is None:
            return None
        if held[1] != meta["blake2b"]:
            raise ValueError(f"{key}/{path} holds other bytes than the index")
        return held[0]


def hist_sums(hist, label: str) -> dict:
    """{label value: sum of observations} of a port histogram."""
    with hist._lock:
        return {dict(zip(hist.labelnames, k))[label]: v["sum"]
                for k, v in hist._values.items()}


def stream_times(handles):
    """One thread per handle, each recording the host clock at every token
    it drains; returns (threads, per-handle lists of times)."""
    import threading
    times = [[] for _ in handles]

    def drain_one(h, ts):
        for _ in h:
            ts.append(time.perf_counter())

    threads = [threading.Thread(target=drain_one, args=(h, ts), daemon=True)
               for h, ts in zip(handles, times)]
    for t in threads:
        t.start()
    return threads, times


def drive_rollout(torch, ops_attn, ops_dec, params, merged, cfg, prompts,
                  merged_outs, card):
    """The online-learning loop's serving half at Llama-3-8B width: a plain
    bf16 engine on the base params, running its loop thread, takes the
    LoRA-trained tree (merged) from a trainer's publish_rollout into an
    in-memory store, swapped in place between decode batches while 8
    requests decode, then rolled back. The swap writes into ``params``'
    own tensors; the rollback restores them, and a gate checks that it
    did. Returns the phase's record."""
    import threading

    from kubetorch_tpu_torch import telemetry
    from kubetorch_tpu_torch.models.convert import params_to_numpy
    from kubetorch_tpu_torch.serve import GenerationEngine, WeightRollout
    from kubetorch_tpu_torch.serve.rollout import publish_manifest, weights_key
    from kubetorch_tpu_torch.train import publish_rollout

    t_phase = time.perf_counter()
    L = cfg.n_layers
    base_hash = leaf_hashes(torch, params)
    seconds = telemetry.histogram("kt_rollout_seconds", labels=("phase",))
    eng = GenerationEngine(params, cfg, **FEATURE_GRID, device="cuda")
    payloads = []
    eng.feedback_sink = payloads.append
    launches = Launches(ops_attn, ops_dec)
    launches.zero()
    eng.start()
    prefills = 0

    def serve(label):
        nonlocal prefills
        hs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        prefills += len(prompts)
        outs = [h.result(timeout=600) for h in hs]
        if any(len(o) != MAX_NEW for o in outs):
            fail(f"rollout {label}: tokens {[len(o) for o in outs]}")
        return outs

    try:
        base_outs = serve("base")
        # trainer side: the port's host hand-off, then publish
        t = time.perf_counter()
        merged_host = params_to_numpy(merged)
        handoff_s = time.perf_counter() - t
        mem = MemStore()
        t = time.perf_counter()
        pub = publish_rollout("llm", merged_host, step=TRAIN_STEPS,
                              store=mem)
        publish_s = time.perf_counter() - t
        state_bytes = sum(a.nbytes for a, _ in mem.kv.values())
        print(f"rollout: trainer side: {len(mem.kv)} leaves, {state_bytes} "
              f"bytes; hand-off to the host {handoff_s:.3f}s, publish "
              f"(fingerprint, put, manifest) {publish_s:.3f}s card={card}",
              flush=True)

        wr = WeightRollout(eng, "llm", store=mem, replica_id="replica-0")
        t = time.perf_counter()
        wr._ensure_ledger()            # the first apply's ledger, alone
        ledger_s = time.perf_counter() - t
        base_fp = wr.fingerprint
        print(f"rollout: replica ledger (host pull + blake2b of every leaf, "
              f"once per replica): {ledger_s:.3f}s card={card}", flush=True)

        # the swap, from a second thread, while 8 requests decode
        rng = np.random.default_rng(LORA_TRAIN_SEED + 1)
        flight = [eng.submit(rng.integers(0, cfg.vocab_size, 40).tolist(),
                             max_new_tokens=ROLLOUT_FLIGHT_NEW)
                  for _ in range(FEATURE_GRID["slots"])]
        prefills += len(flight)
        threads, times = stream_times(flight)
        while eng.stats().active < len(flight):
            time.sleep(0.01)
        time.sleep(0.5)
        finished0 = eng.stats().finished_total
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sums0 = hist_sums(seconds, "phase")
        box = {}

        def poll():
            t0 = time.perf_counter()
            try:
                box["res"] = wr.poll_once()
            except BaseException as e:   # noqa: BLE001 — reported below
                box["error"] = e
            box["window"] = (t0, time.perf_counter())

        poller = threading.Thread(target=poll, name="rollout-poll")
        poller.start()
        poller.join()
        if "error" in box:
            fail(f"rollout: poll_once raised {box['error']!r}")
        rise = torch.cuda.max_memory_allocated() - mem_before
        in_flight = eng.stats().finished_total == finished0
        for t in threads:
            t.join(timeout=600)
        res = box["res"]
        sums1 = hist_sums(seconds, "phase")
        phases = {p: sums1.get(p, 0.0) - sums0.get(p, 0.0)
                  for p in ("fetch", "stage", "swap", "verify")}
        changed = ("wq", "wk", "wv", "wo")
        want_bytes = sum(params["layers"][k].numel()
                         * params["layers"][k].element_size() for k in changed)
        one_leaf = max(params["layers"][k].numel()
                       * params["layers"][k].element_size() for k in changed)
        lo, hi = box["window"]
        gaps = []
        for ts in times:
            gaps += [b - a for a, b in zip(ts, ts[1:]) if b > lo and a < hi]
        all_gaps = sorted(b - a for ts in times for a, b in zip(ts, ts[1:]))
        print(f"rollout: swap while {len(flight)} requests decode: "
              f"{res['leaves_changed']} leaves changed, bytes fetched "
              f"{res['bytes']} (the 4 leaves: {want_bytes}), swap on thread "
              f"{wr.last_swap_thread!r}, replica fingerprint == trainer's: "
              f"{wr.fingerprint == pub['fingerprint']}, every request still in "
              f"flight at the swap's end: {in_flight}", flush=True)
        print(f"rollout: kt_rollout_seconds fetch={phases['fetch']} "
              f"stage={phases['stage']} swap={phases['swap']} "
              f"verify={phases['verify']}; poll_once wall {hi - lo:.4f}s; "
              f"longest gap between two tokens of a stream across the swap "
              f"{max(gaps) if gaps else 0.0:.4f}s (median gap of the streams "
              f"{all_gaps[len(all_gaps) // 2]:.4f}s); device memory rise "
              f"across the swap {rise} bytes (one leaf: {one_leaf}) "
              f"card={card}", flush=True)
        if res["leaves_changed"] != len(changed):
            fail(f"rollout: {res['leaves_changed']} leaves changed, expected 4")
        if res["bytes"] != {"store": want_bytes}:
            fail(f"rollout: fetched {res['bytes']}, expected {want_bytes}")
        if wr.last_swap_thread != "kt-gen-engine":
            fail(f"rollout: the swap ran on {wr.last_swap_thread!r}")
        if wr.fingerprint != pub["fingerprint"]:
            fail("rollout: the replica's fingerprint is not the trainer's")
        if not in_flight:
            fail("rollout: a request finished before the swap ended")
        lens = [len(ts) for ts in times]
        if lens != [ROLLOUT_FLIGHT_NEW] * len(flight):
            fail(f"rollout: in-flight streams gave {lens} tokens")
        if rise > one_leaf:
            fail(f"rollout: device memory rose {rise} bytes across the swap")

        after = serve("after the swap")
        if after != merged_outs:
            from kubetorch_tpu_torch.serve import engine as engine_mod
            for i, p in enumerate(prompts):
                got, _, _ = one_shot(torch, engine_mod, eng.params, cfg, eng, p)
                want, _, _ = one_shot(torch, engine_mod, merged, cfg, eng, p)
                print(f"rollout: request {i}: first-token logits rel_l2 "
                      f"{float((got - want).norm() / want.norm())}", flush=True)
            fail("rollout: tokens after the swap differ from the merged "
                 "engine's")

        t = time.perf_counter()
        publish_manifest("llm", key=weights_key("llm"), step=0,
                         fingerprint=base_fp, phase="rollback",
                         reason="smoke", store=mem)
        back = wr.poll_once()
        rollback_s = time.perf_counter() - t
        restored = leaf_hashes(torch, params) == base_hash
        again = serve("after the rollback")
        print(f"rollout: rollback {rollback_s:.3f}s: rolled back "
              f"{back['rolled_back']}, base leaf hashes restored {restored}, "
              f"fingerprint == base {wr.fingerprint == base_fp}, tokens == "
              f"the base engine's {again == base_outs}; after the swap == "
              f"the merged engine's {after == merged_outs}", flush=True)
        if not (back["rolled_back"] and restored and wr.fingerprint == base_fp
                and again == base_outs):
            fail("rollout: the rollback did not restore the base weights")
    finally:
        eng.stop()
    got = launches.read()
    steps = eng.stats().decode_steps
    check_launches("rollout", got, dict(
        flash_fwd=L * prefills, decode_attention=L * steps,
        decode_attention_quant=0))
    ttfts = [p["ttft_s"] for p in payloads]
    if len(payloads) != prefills or any(t is None for t in ttfts):
        fail(f"rollout: {len(payloads)} feedback payloads for {prefills} "
             f"requests")
    print(f"rollout: feedback_sink payloads {len(payloads)} (one per retired "
          f"request, each with its TTFT; mean {sum(ttfts) / len(ttfts):.4f}s)",
          flush=True)
    print(f"rollout: __kt_metrics__ {json.dumps(eng.__kt_metrics__())} "
          f"aot_stats {eng.aot_stats()}", flush=True)
    del eng, wr, mem, merged_host
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"rollout: phase wall {wall:.1f}s card={card}", flush=True)
    return dict(launches=got, ledger_s=ledger_s, publish_s=publish_s,
                handoff_s=handoff_s, seconds=phases, rollback_s=rollback_s,
                max_gap_s=max(gaps) if gaps else 0.0, memory_rise=rise,
                phase_wall_s=wall)


class CanaryRouter:
    """A scripted router for the canary bake: ``canary_verdict`` answers
    ``verdict``; pinning a replica makes that replica's rollout coordinator
    poll at once (it converges on the canary manifest), and ``probe`` then
    records the replica's tokens."""

    def __init__(self, rollout, probe, verdict="ok"):
        self.rollout, self.probe, self.verdict = rollout, probe, verdict
        self.pinned = self.canary_tokens = None

    def set_canary(self, replica, fraction=0.1):
        self.pinned = (replica, fraction)
        if self.rollout.poll_once() is None:
            fail(f"flywheel: the canary {replica!r} took no manifest")
        self.canary_tokens = self.probe()

    def clear_canary(self):
        self.pinned = None

    def canary_verdict(self, **kw):
        return self.verdict


def queue_wait_ms(eng) -> float:
    """The serving queue's wait now: the oldest queued request's age in
    ms, 0 with none queued (the harvest policy's scrape; a mean TTFT of
    finished requests would keep a quiet engine looking busy)."""
    pending = list(eng._pending)
    if not pending:
        return 0.0
    return (time.monotonic() - min(r.submitted_at for r in pending)) * 1e3


def fly_rows(torch, records):
    """One row per harvested record: its prompt tiled to FLY_SEQ + 1 tokens.
    Returns the (tokens, targets) batch on the card."""
    rows = np.stack([np.resize(np.asarray(r["payload"]["prompt"], np.int64),
                               FLY_SEQ + 1) for r in records])
    t = torch.from_numpy(rows).cuda()
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


def drive_flywheel(torch, ops_attn, ops_dec, params, cfg, card):
    """The continuous-learning loop at Llama-3-8B width on the bf16 chain's
    params (frozen; the serving engine holds copies of the four adapted
    projections, which its swaps write): (a) collect, the engine's feedback
    sink on the port's FeedbackLedger over the stand-in HTTP store; (b)
    train, a Harvester over an acquired LedgerCursor, one lora_loss step
    per FLY_BATCH records, the cursor state committed before each
    Checkpointer save, a drain asked for mid-cycle; (c) promote, the
    Promoter over MemStore with the engine as the canary replica: the
    trained adapter merged (promoted), a poisoned delta (rejected by the
    eval gate), and again with the gate blinded and the router reporting a
    regression (rolled back). No failure is caught. Returns the phase's
    record."""
    from kubetorch_tpu_torch.data_store.commands import HttpStore
    from kubetorch_tpu_torch.flywheel import (BREAK_ENV, BREAK_PROMOTE_BAD,
                                              GATE_REJECTED, PROMOTED,
                                              ROLLED_BACK, FeedbackLedger,
                                              Harvester, HarvestPolicy,
                                              LedgerCursor, Promoter,
                                              engine_feedback_hook,
                                              flywheel_status,
                                              read_all_hashes, record_hash)
    from kubetorch_tpu_torch.flywheel.promoter import eval_baseline_key
    from kubetorch_tpu_torch.models.convert import params_to_numpy
    from kubetorch_tpu_torch.models.llama import llama_loss_chunked
    from kubetorch_tpu_torch.models.lora import lora_init, lora_loss, merge_lora
    from kubetorch_tpu_torch.serve import GenerationEngine, WeightRollout
    from kubetorch_tpu_torch.serve.rollout import read_manifest
    from kubetorch_tpu_torch.serving import elastic
    from kubetorch_tpu_torch.serving.host_view import from_host
    from kubetorch_tpu_torch.telemetry import flywheel_metrics
    from kubetorch_tpu_torch.train import (Checkpointer, adamw,
                                           init_train_state, make_train_step,
                                           publish_rollout, train_state_tree)

    t_phase = time.perf_counter()
    L, V = cfg.n_layers, cfg.vocab_size
    lcfg = lora_config()
    m = flywheel_metrics()

    def counts():
        return {k: m[k].value(service="fly")
                for k in ("appended", "consumed", "deduped")}

    def verdicts():
        return {v: m["gate"].value(verdict=v)
                for v in (PROMOTED, GATE_REJECTED, ROLLED_BACK)}

    counts0, verdicts0 = counts(), verdicts()
    base_hash = leaf_hashes(torch, params)
    serving = {**params, "layers": {**params["layers"], **{
        t: params["layers"][t].clone() for t in lcfg.targets}}}
    eng = GenerationEngine(serving, cfg, **FEATURE_GRID, device="cuda")
    http = _StandInStore()
    wire = HttpStore(http.url, peer=False)
    mem = MemStore()
    hook = engine_feedback_hook(FeedbackLedger("fly", "replica-0", store=wire,
                                               sample_rate=1.0))
    sent, acked_at, stalls = [], {}, []

    def sink(payload):
        t = time.perf_counter()
        hook(payload)
        done = time.perf_counter()
        stalls.append(done - t)
        sent.append(payload)
        acked_at[record_hash(payload)] = done

    eng.feedback_sink = sink
    rng = np.random.default_rng(FLY_SEED)
    prompts = [rng.integers(0, V, n).tolist() for n in ENGINE_PROMPT_LENS]
    probes = [rng.integers(0, V, n).tolist() for n in LORA_SERVE_PROMPTS]
    fa = ops_attn.flash_attention
    launches = Launches(ops_attn, ops_dec)
    launches.zero()
    fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    prefills = evals = 0
    eng.start()

    def probe():
        nonlocal prefills
        hs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in probes]
        prefills += len(probes)
        return [h.result(timeout=600) for h in hs]

    try:
        # (a) collect
        t = time.perf_counter()
        hs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        prefills += len(prompts)
        outs = [h.result(timeout=600) for h in hs]
        collect_s = time.perf_counter() - t
        if any(len(o) != MAX_NEW for o in outs):
            fail(f"flywheel collect: tokens {[len(o) for o in outs]}")
        eng.feedback_sink = None       # the probes below are not feedback
        hashes = read_all_hashes("fly", ["replica-0"], store=wire)
        want = [record_hash(p) for p in sent]
        typed = all(type(x) is int for p in sent for x in p["prompt"])
        print(f"flywheel collect: {len(prompts)} requests x {MAX_NEW} tokens "
              f"in {collect_s:.3f}s, {len(sent)} payloads, ledger hashes == "
              f"the payloads' one for one: {hashes == want}, prompts of "
              f"Python ints: {typed}; the hook on the step thread over HTTP "
              f"(2 PUTs a request): mean {sum(stalls) / len(stalls) * 1e3:.3f} "
              f"ms, max {max(stalls) * 1e3:.3f} ms, total "
              f"{sum(stalls) * 1e3:.3f} ms card={card}", flush=True)
        if len(sent) != len(prompts) or hashes != want or not typed:
            fail("flywheel collect: the ledger does not hold the engine's "
                 "payloads one for one")
        # a restarted replica re-samples one payload into a new segment
        FeedbackLedger("fly", "replica-0", store=wire).append([sent[0]])

        # (b) train on harvested capacity
        t = time.perf_counter()
        cursor = LedgerCursor("fly", ["replica-0"], store=wire)
        epoch = cursor.acquire()
        opt = adamw(FLY_LR)
        state = init_train_state(lora_init(params, lcfg, seed=FLY_SEED), opt)
        step = make_train_step(lora_loss(params, cfg, lcfg), opt)
        ckpt = Checkpointer("fly/trainer", store=mem)
        folded, losses, batches = {}, [], []

        def train_step():
            nonlocal state
            batch = cursor.poll(max_records=FLY_BATCH)
            if not batch:
                return None
            n = len(folded) + 1
            batches.append(fly_rows(torch, batch))
            state, mets = step(state, batches[-1])
            losses.append(float(mets["loss"]))
            cursor.commit_state(n)          # the cursor state first,
            ckpt.flush()
            ckpt.maybe_save(train_state_tree(state), n)   # then the commit
            folded[n] = [r["hash"] for r in batch]
            if n == FLY_DRAIN_AT:
                elastic.request_drain("preempted")
            return n

        harv = Harvester(HarvestPolicy(slo_ms=FLY_SLO_MS, headroom=0.25),
                         scrape=lambda: queue_wait_ms(eng),
                         train_step=train_step,
                         flush=lambda: ckpt.flush(timeout=FLY_GRACE_S),
                         drain_grace_s=FLY_GRACE_S)
        elastic.clear_drain()
        try:
            cycles = [harv.run_cycle(deadline_s=FLY_CYCLE_S)]
            drained_flag = elastic.drain_requested()
            drain_vacate_s = harv.last_vacate_s
        finally:
            elastic.clear_drain()
        cycles.append(harv.run_cycle(deadline_s=FLY_CYCLE_S))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        got = {k: v - counts0[k] for k, v in counts().items()}
        hs_folded = [h for n in sorted(folded) for h in folded[n]]
        committed = ckpt.flush()
        back = LedgerCursor("fly", ["replica-0"], store=wire)
        back.restore(committed)
        print(f"flywheel train: cycles {cycles}; steps {sorted(folded)}, "
              f"losses {losses}, cursor epoch {epoch}; appended "
              f"{got['appended']}, consumed {got['consumed']}, deduped "
              f"{got['deduped']}; committed step {committed}, a resumed "
              f"cursor has nothing to re-poll: {back.poll() == []}; "
              f"{train_s:.3f}s card={card}", flush=True)
        n_steps = len(folded)
        if not (drained_flag and cycles[0]["reason"] == "drain"
                and cycles[0]["steps"] == FLY_DRAIN_AT
                and cycles[0]["within_grace"] and harv.vacates == 2):
            fail(f"flywheel train: the drain did not vacate in grace: "
                 f"{cycles[0]}")
        if (cycles[1]["reason"] != "drained" or committed != n_steps
                or sum(c["steps"] for c in cycles) != n_steps):
            fail(f"flywheel train: the second cycle {cycles[1]}, committed "
                 f"step {committed} of {n_steps}")
        if not (got["consumed"] == len(prompts) == len(set(hs_folded))
                == len(hs_folded) and set(hs_folded) == set(want)
                and got["appended"] == len(prompts) + 1
                and got["deduped"] == 1):
            fail(f"flywheel train: consumed/appended/deduped {got}, "
                 f"{len(hs_folded)} folded ({len(set(hs_folded))} distinct)")
        if not all(math.isfinite(x) for x in losses):
            fail(f"flywheel train: a loss is not finite: {losses}")
        if back.positions != cursor.positions:
            fail("flywheel train: the restored cursor is not the committed one")
        trained = state.params
        del state, step, cursor, back

        # (c) promote through the eval gate and the canary
        replay = fly_rows(torch, [{"payload": p} for p in sent])
        base_host = params_to_numpy(serving)

        def candidate(adapter):
            dev = merge_lora(params, adapter, lcfg)
            host = {**base_host, "layers": {**base_host["layers"], **{
                t: params_to_numpy(dev["layers"][t]) for t in lcfg.targets}}}
            return dev, host

        def replayed_loss(host):
            nonlocal evals
            layers = {t: host["layers"][t] for t in lcfg.targets}
            dev = {**params, "layers": {**params["layers"], **from_host(
                layers, {t: params["layers"][t] for t in lcfg.targets})}}
            evals += 1
            with torch.no_grad():
                loss = float(llama_loss_chunked(dev, replay["tokens"],
                                                replay["targets"], cfg))
            eval_losses.append(loss)
            if not math.isfinite(loss):
                fail(f"flywheel promote: a candidate's loss is {loss}")
            return loss

        eval_losses = []
        good, good_host = candidate(trained)
        # the poisoned delta: the same steps on the same rows, ascending
        opt = adamw(FLY_LR)
        state = init_train_state(lora_init(params, lcfg, seed=FLY_SEED), opt)
        ascend = make_train_step(
            lambda ad, x, y: -lora_loss(params, cfg, lcfg)(ad, x, y), opt)
        for rows in batches:
            state, _ = ascend(state, rows)
        bad, bad_host = candidate(state.params)
        del bad, state, ascend
        t = time.perf_counter()
        publish_rollout("fly", base_host, 0, store=mem)   # the fleet's start
        wr = WeightRollout(eng, "fly", store=mem, replica_id="canary")
        if wr.poll_once()["leaves_changed"] != 0:
            fail("flywheel promote: the base manifest changed the replica")
        setup_s = time.perf_counter() - t
        router = CanaryRouter(wr, probe)
        prom = Promoter("fly", router, store=mem, eval_fn=replayed_loss,
                        gate_tolerance=FLY_GATE_TOL, bake_s=0.05,
                        min_requests=1, poll_s=0.01)
        base_tokens = probe()
        times = {}

        t = time.perf_counter()
        v1 = prom.promote(good_host, step=n_steps)
        t_live = time.perf_counter()
        applied = wr.poll_once()
        times["promoted"] = time.perf_counter() - t
        live = sorted(t_live - acked_at[h] for h in hs_folded)
        promoted_m = read_manifest("fly", store=mem)
        baseline = mem.get_json(eval_baseline_key("fly"))
        after_good = probe()
        fresh = GenerationEngine(good, cfg, **FEATURE_GRID, device="cuda")
        fh = [fresh.submit(p, max_new_tokens=MAX_NEW) for p in probes]
        drain(torch, fresh)
        fresh_tokens = [h.result(timeout=0) for h in fh]
        fresh_prefills, fresh_steps = len(probes), fresh.stats().decode_steps
        del fresh, good
        gc.collect()
        torch.cuda.empty_cache()
        print(f"flywheel promote (trained adapter): {v1}, canary tokens == a "
              f"fresh engine's over the merged tree: "
              f"{router.canary_tokens == fresh_tokens}, after the fleet "
              f"manifest: {after_good == fresh_tokens} (differ from the base "
              f"model's: {after_good != base_tokens}); fingerprint == the "
              f"manifest's: {wr.fingerprint == promoted_m['fingerprint']}; "
              f"baseline {baseline} (eval losses {eval_losses}); "
              f"{times['promoted']:.3f}s "
              f"card={card}", flush=True)
        if not (v1 == PROMOTED and applied is not None
                and promoted_m["phase"] == "fleet"
                and wr.fingerprint == promoted_m["fingerprint"]
                and router.canary_tokens == fresh_tokens == after_good
                and baseline and baseline["step"] == n_steps):
            fail("flywheel promote: the trained adapter did not go live as "
                 "the merged tree")

        t = time.perf_counter()
        router.canary_tokens = None
        v2 = prom.promote(bad_host, step=n_steps + 1)
        times["gate_rejected"] = time.perf_counter() - t
        rejected = prom.history[-1]
        same_version = (read_manifest("fly", store=mem)["version"]
                        == promoted_m["version"])
        after_reject = probe()
        print(f"flywheel promote (poisoned delta): {v2}, replayed loss "
              f"{rejected.get('loss')} against baseline "
              f"{rejected.get('baseline')} (limit {rejected.get('limit')}); "
              f"manifest version unchanged {same_version}, tokens unchanged "
              f"{after_reject == fresh_tokens}; {times['gate_rejected']:.3f}s",
              flush=True)
        if not (v2 == GATE_REJECTED and same_version
                and router.canary_tokens is None and wr.poll_once() is None
                and after_reject == fresh_tokens):
            fail("flywheel promote: the bad candidate was not gate_rejected")

        t = time.perf_counter()
        os.environ[BREAK_ENV] = BREAK_PROMOTE_BAD
        router.verdict = "regressed"
        try:
            v3 = prom.promote(bad_host, step=n_steps + 2)
        finally:
            del os.environ[BREAK_ENV]
        rolled = wr.poll_once()
        times["rolled_back"] = time.perf_counter() - t
        back_m = read_manifest("fly", store=mem)
        after_back = probe()
        same_base = mem.get_json(eval_baseline_key("fly")) == baseline
        print(f"flywheel promote (poisoned delta, gate blinded, canary "
              f"regressed): {v3}; the canary served other tokens "
              f"{router.canary_tokens != fresh_tokens}; rolled back "
              f"{rolled and rolled['rolled_back']}, manifest {back_m['phase']} "
              f"at the promoted fingerprint "
              f"{back_m['fingerprint'] == promoted_m['fingerprint']}, "
              f"baseline unmoved {same_base}, tokens == before the drill "
              f"{after_back == after_good}; {times['rolled_back']:.3f}s",
              flush=True)
        if not (v3 == ROLLED_BACK and rolled and rolled["rolled_back"]
                and back_m["phase"] == "rollback"
                and back_m["fingerprint"] == promoted_m["fingerprint"]
                == wr.fingerprint and same_base and after_back == after_good):
            fail("flywheel promote: the bad canary was not rolled back")
        # the ledger and cursor live on the HTTP store, the trees on MemStore
        lags = {**flywheel_status("fly", ["replica-0"], store=mem)[
            "lag_seconds"], **{k: v for k, v in flywheel_status(
                "fly", ["replica-0"], store=wire)["lag_seconds"].items()
                if k in ("collect", "train")}}
    finally:
        eng.stop()
        http.close()
    got = launches.read()
    got_bwd = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    steps = eng.stats().decode_steps + fresh_steps
    lora_steps = 2 * n_steps         # the trained and the poisoned delta
    want_n = dict(flash_fwd=L * (prefills + fresh_prefills + evals)
                  + 2 * L * lora_steps,
                  decode_attention=L * steps, decode_attention_quant=0)
    check_launches("flywheel (A1, B1, B2)", got, want_n)
    check_launches("flywheel (A2, A3)", got_bwd,
                   (L * lora_steps, L * lora_steps))
    gate = {k: v - verdicts0[k] for k, v in verdicts().items()}
    print(f"flywheel: kt_flywheel_gate_total {gate}", flush=True)
    if gate != {PROMOTED: 1, GATE_REJECTED: 1, ROLLED_BACK: 1}:
        fail(f"flywheel: gate verdicts {gate}")
    if leaf_hashes(torch, params) != base_hash:
        fail("flywheel: a leaf of the frozen base changed")
    wall = time.perf_counter() - t_phase
    rec = dict(launches=dict(got, flash_bwd_dq=got_bwd[0],
                             flash_bwd_dkv=got_bwd[1]),
               collect_s=collect_s, train_s=train_s, setup_s=setup_s,
               promote_s=times, hook_ms=dict(
                   mean=sum(stalls) / len(stalls) * 1e3,
                   max=max(stalls) * 1e3, total=sum(stalls) * 1e3),
               feedback_to_live_s=dict(p50=live[len(live) // 2],
                                       max=live[-1], records=len(live)),
               vacate_s=drain_vacate_s, losses=losses,
               eval_losses=eval_losses, lag_s=lags,
               phase_wall_s=wall)
    print(f"flywheel: feedback-to-weights-live (a record's ack to the "
          f"promoted fleet manifest holding its fold) p50 "
          f"{rec['feedback_to_live_s']['p50']:.3f}s max "
          f"{rec['feedback_to_live_s']['max']:.3f}s over {len(live)} records;"
          f" the drain's vacate {rec['vacate_s']:.6f}s (grace {FLY_GRACE_S}s);"
          f" stage lags {lags}", flush=True)
    print(f"flywheel: phase wall {wall:.1f}s (collect {collect_s:.1f}, train "
          f"{train_s:.1f}, promotion set-up {setup_s:.1f}, promotions "
          f"{json.dumps({k: round(v, 3) for k, v in times.items()})}) "
          f"card={card}", flush=True)
    del eng, wr, mem, base_host, good_host, bad_host, trained, serving
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def drive_flywheel_alone():
    """The "flywheel" phase by itself: builds A1-A3 and B1, draws the bf16
    chain's params (CUT_LAYERS, seed 0) and runs the phase."""
    import torch

    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.ops import _build
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.ops import decode_attention as ops_dec
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this phase needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(max_workers=3) as ex:
        list(ex.map(_build.load, ("flash_fwd", "flash_bwd", "decode_attention")))
    cfg = LlamaConfig.llama3_8b(n_layers=CUT_LAYERS)
    params = llama_init(cfg, seed=0, device="cuda")
    return drive_flywheel(torch, ops_attn, ops_dec, params, cfg, card_line())


def drive_lora_q4(torch, ops_attn, ops_dec, ops_q4, params, cfg, card):
    """One LoRA adapter request beside four base ones on the int4 + int8-KV
    Llama-3-8B engine, on the quantized phase's weights: exact launch
    counts, and the adapter's first-token logits against the weights
    dequantized to bf16 and merged, on the plain path."""
    from kubetorch_tpu_torch.models.lora import merge_lora
    from kubetorch_tpu_torch.models.quant import dequantize_params
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod

    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    plain = dequantize_params(params, torch.bfloat16)
    lcfg = lora_config()
    adapter = seeded_adapter(torch, plain, lcfg, 4)
    eng = GenerationEngine(params, cfg, **FEATURE_GRID, quantize_kv=True,
                           device="cuda")
    aid = eng.register_adapter(adapter, lcfg)
    warm = eng.submit(prompt(100), max_new_tokens=2, adapter_id=aid)
    drain(torch, eng)
    warm.result(timeout=0)
    prompts = [prompt(n) for n in (40, 200, 300, 500, 128)]
    owners = [None, None, None, None, aid]
    launches = Launches(ops_attn, ops_dec, ops_q4)
    steps0 = eng.stats().decode_steps
    launches.zero()
    with recorded_logits(engine_mod, "_prefill_logits") as first_logits:
        handles = [eng.submit(p, max_new_tokens=MAX_NEW, adapter_id=a)
                   for p, a in zip(prompts, owners)]
        drain(torch, eng)
    got = launches.read()
    steps = eng.stats().decode_steps - steps0
    L = cfg.n_layers
    head = params["lm_head"]
    head_q4 = int(ops_q4.q4_supported((1, cfg.dim), head["__kt_q4__"].shape,
                                      head["scale"].shape))
    n = len(prompts)
    check_launches("lora_q4", got, dict(
        flash_fwd=L * n, decode_attention=0, decode_attention_quant=L * steps,
        q4_matmul=(7 * L + head_q4) * (n + steps)))
    outs = [h.result(timeout=0) for h in handles]
    if any(len(o) != MAX_NEW for o in outs):
        fail(f"lora_q4: tokens {[len(o) for o in outs]}")
    print(f"lora_q4: 1 adapter request beside 4 base ones on the int4 + "
          f"int8-KV engine, {MAX_NEW} tokens each over {steps} decode steps: "
          f"A1 = {L} x {n}, B3 = {7 * L + head_q4} x ({n} prefills + steps), "
          f"B2 = {L} x steps card={card}", flush=True)
    merged = merge_lora(plain, adapter, lcfg)
    check_merged_logits(torch, "lora_q4 adapter request vs merge_lora on the "
                        "bf16-dequantized weights, plain path", first_logits[4],
                        merged, cfg, eng, prompts[4], outs[4][0], impl="xla")
    del eng, plain, merged, adapter
    gc.collect()
    torch.cuda.empty_cache()
    print(f"lora_q4: phase wall {time.perf_counter() - t_phase:.1f}s", flush=True)
    return got


def spec_draft(torch):
    """The draft of the speculative phases: Llama-3.2-1B's shape at full
    width and depth, bf16, random weights from its own seed."""
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    dcfg = LlamaConfig.llama3_1b()
    return llama_init(dcfg, seed=SPEC_DRAFT_SEED, device="cuda"), dcfg


def spec_want(cfg, dcfg, prompts, rounds, head_q4=None, prefix=True):
    """Exact launch counts of a speculative run over ``prompts`` (the
    from-zero admissions: one-shot, or chunked from a from-zero first
    chunk), with ``prefix`` one prefix registration and one prefix hit, in
    ``rounds`` rounds. A1 once per layer of each model in every from-zero pass (every
    bucket and the chunk are 128-multiples; none in a suffix pass); B1 once
    per draft layer in each of a round's k-1 draft decode steps (the
    target's verify window is the plain einsum); B2 never (the draft's grid
    stays bf16). An int4 target (``head_q4`` not None) adds B3 on its 7
    projections (and the head where it tiles) in every target pass: each
    from-zero pass, the registration, the hit's suffix pass, each chunk
    after the first, and each round's verify window."""
    zero = len(prompts) + prefix
    want = dict(flash_fwd=(cfg.n_layers + dcfg.n_layers) * zero,
                decode_attention=dcfg.n_layers * (SPEC_K - 1) * rounds,
                decode_attention_quant=0)
    if head_q4 is not None:
        suffix = prefix + sum(-(-len(p) // CHUNK) - 1 for p in prompts
                         if len(p) > CHUNK)
        want["q4_matmul"] = ((7 * cfg.n_layers + head_q4)
                             * (zero + suffix + rounds))
    return want


def check_window_logits(torch, label, eng, params, cfg, prompts):
    """One round of a full grid (8 slots of 40-token prompts, one round
    past admission): the target's verify-window logits at each slot's
    first window position against the plain engine's decode step at the
    same position and token over a copy of the same grid (B1 over a bf16
    grid, B2 over an int8 one), within LOGITS_REL_L2 per slot. Returns the
    requests, still decoding."""
    from kubetorch_tpu_torch.serve import engine as engine_mod
    from kubetorch_tpu_torch.serve import spec_engine as spec_mod
    hs = [eng.submit(p[:40], max_new_tokens=SPEC_POST_NEW)
          for p in prompts[:eng.slots]]
    eng.step()                          # admissions + one round
    real = spec_mod._grid_ingest
    seen = []

    def hooked(p, cache, blocks, start, true_len, c, **kw):
        if cache is not eng._cache or seen:
            return real(p, cache, blocks, start, true_len, c, **kw)
        grid = type(cache)(*(t.clone() for t in cache))
        plain = engine_mod._decode_step_impl(p, grid, start.to(torch.int32),
                                             blocks[:, 0], c, eng._freqs)
        del grid
        out = real(p, cache, blocks, start, true_len, c, **kw)
        seen.append((out[:, 0].clone(), plain, true_len.cpu()))
        return out

    spec_mod._grid_ingest = hooked
    try:
        eng.step()
    finally:
        spec_mod._grid_ingest = real
    win, plain, tl = seen[0]
    active = [i for i in range(eng.slots) if tl[i] > 0]
    if not (torch.isfinite(win).all() and win.shape == (eng.slots, cfg.vocab_size)):
        fail(f"{label}: verify-window logits not finite or of the wrong shape")
    rels = [float((win[i] - plain[i]).norm() / plain[i].norm()) for i in active]
    agree = sum(int(win[i].argmax()) == int(plain[i].argmax()) for i in active)
    print(f"{label}: verify-window logits at the first window position vs "
          f"the plain engine's decode step, {len(active)} slots at rows "
          f"{eng._spec_valid.tolist()}: max rel_l2={max(rels)} per slot "
          f"{[round(r, 5) for r in rels]} tol_rel_l2={LOGITS_REL_L2} argmax "
          f"agree {agree}/{len(active)}", flush=True)
    if len(active) != eng.slots or not max(rels) <= LOGITS_REL_L2:
        fail(f"{label}: verify-window logits differ from the plain decode "
             f"step: {rels} (tol {LOGITS_REL_L2})")
    return hs


def time_round_parts(torch, label, eng, n):
    """Wall ms of a round's three passes (draft ingest, draft decode block,
    target verify window), each between synchronizes, over ``n`` rounds of
    the grid as it stands, and of the whole round."""
    from kubetorch_tpu_torch.serve import spec_engine as spec_mod
    real_ingest, real_block = spec_mod._grid_ingest, spec_mod._decode_block
    parts = {"draft ingest": 0.0, "draft block": 0.0, "target window": 0.0}

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        parts[name] += time.perf_counter() - t
        return out

    def ingest(p, cache, *args, **kw):
        name = "target window" if cache is eng._cache else "draft ingest"
        return timed(name, real_ingest, p, cache, *args, **kw)

    spec_mod._grid_ingest = ingest
    spec_mod._decode_block = lambda *a, **kw: timed("draft block",
                                                    real_block, *a, **kw)
    try:
        ms = timed_steps(torch, eng, n)
    finally:
        spec_mod._grid_ingest, spec_mod._decode_block = real_ingest, real_block
    split = {k: v / n * 1e3 for k, v in parts.items()}
    print(f"{label}: wall ms per round {ms} (synchronized passes, {n} rounds, "
          f"{eng.slots} slots): " + ", ".join(f"{k} {v}" for k, v in split.items()),
          flush=True)
    return ms, split


def drive_spec(torch, ops_attn, ops_dec, ops_q4, label, params, cfg, draft,
               dcfg, prompts, plain_rate, card, quant=False, extras=True):
    """One speculative phase at Llama-3-8B's width and depth through
    SpeculativeEngine (spec_k SPEC_K, the engine phases' grid with chunked
    prefill, ``quantize_kv=quant``): the engine phases' 12 prompts (6 up
    front, then one per step; those over CHUNK tokens admit in chunks)
    and, with ``extras``, a 100-token suffix behind a registered
    1000-token prefix and an 1800-token prompt, with exact launch counts; then the verify window's
    logits against the plain decode step, the wall of a round's passes and
    a 2-round profile on a full grid. ``plain_rate``: the plain engine's
    decode tokens/s on the same prompts in this process."""
    from kubetorch_tpu_torch.models.quant import Q4KEY
    from kubetorch_tpu_torch.serve import SpeculativeEngine

    t_phase = time.perf_counter()
    eng = SpeculativeEngine(params, cfg, draft, dcfg, spec_k=SPEC_K,
                            **FEATURE_GRID, prefill_chunk=CHUNK,
                            quantize_kv=quant, device="cuda")
    rng = np.random.default_rng(13)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    # warm-up, not counted: a one-shot admission, a prefix hit and a
    # chunked admission (allocator, GEMM plans)
    warm = eng.register_prefix(prompt(PREFIX_LEN)) if extras else None
    eng.submit(prompt(100), max_new_tokens=2)
    if extras:
        eng.submit(prompt(40), max_new_tokens=2, prefix_id=warm)
    eng.submit(prompt(CHUNK + 100), max_new_tokens=2)
    drain(torch, eng)
    if extras:
        eng.unregister_prefix(warm)
    prefix, suffix, long = prompt(PREFIX_LEN), prompt(SPEC_SUFFIX), prompt(CHUNK_PROMPT)
    launches = Launches(ops_attn, ops_dec, ops_q4 if quant else None)
    rounds0, st0 = eng._steps, dataclasses.replace(eng.spec_stats)
    base = eng.stats()
    launches.zero()
    pid = eng.register_prefix(prefix) if extras else None
    handles = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts[:6]]
    if extras:
        handles.append(eng.submit(suffix, max_new_tokens=MAX_NEW,
                                  prefix_id=pid))
        handles.append(eng.submit(long, max_new_tokens=MAX_NEW))
    todo, steps = list(prompts[6:]), []
    while True:
        if todo:   # one new request per step while the grid decodes
            handles.append(eng.submit(todo.pop(0), max_new_tokens=MAX_NEW))
        before = eng.stats()
        t = time.perf_counter()
        left = eng.step()
        torch.cuda.synchronize()
        after = eng.stats()
        steps.append((time.perf_counter() - t,
                      after.admitted_total - before.admitted_total,
                      after.tokens_generated - before.tokens_generated))
        if not left and not todo:
            break
    got = launches.read()
    rounds = eng._steps - rounds0
    head_q4 = None
    if quant:
        head = params["lm_head"]
        head_q4 = int(ops_q4.q4_supported((1, cfg.dim), head[Q4KEY].shape,
                                          head["scale"].shape))
    want = spec_want(cfg, dcfg, list(prompts) + [long] * extras, rounds,
                     head_q4, prefix=extras)
    if not all(v > 0 for k, v in want.items() if k != "decode_attention_quant"):
        fail(f"{label}: a kernel of the path has no launch to count: {want}")
    check_launches(label, got, want)
    outs = [h.result(timeout=0) for h in handles]
    if len(outs) != len(prompts) + 2 * extras or any(
            len(o) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in o)
            for o in outs) or eng._prefix_hits != 2 * extras:
        fail(f"{label}: tokens {[len(o) for o in outs]}, prefix hits "
             f"{eng._prefix_hits} (warm-up included)")
    st = eng.spec_stats
    proposed, accepted = st.proposed - st0.proposed, st.accepted - st0.accepted
    accept = accepted / proposed
    admitted = eng.stats().admitted_total - base.admitted_total
    emitted = eng.stats().tokens_generated - base.tokens_generated
    rate, ms_round = decode_rate(steps)
    ttft = [h.time_to_first_token() for h in handles]
    grid = (f", a {SPEC_SUFFIX}-token suffix behind a {PREFIX_LEN}-token "
            f"prefix, an {CHUNK_PROMPT}-token prompt" if extras else "")
    print(f"{label}: {len(outs)} requests ({len(prompts)} prompts{grid}; "
          f"over {CHUNK} tokens in chunks of {CHUNK}) completed, "
          f"{MAX_NEW} tokens each, in {rounds} rounds: acceptance_rate="
          f"{accept} ({accepted}/{proposed}), tokens_per_target_pass="
          f"{(emitted - admitted) / rounds} (tokens of rounds / rounds, "
          f"{len(outs)} first tokens from prefills excluded); "
          f"decode_tok_per_s={rate} ({ms_round} ms per round without "
          f"admission) vs the plain engine {plain_rate} on the same 12 "
          f"prompts; mean_ttft_s={sum(ttft) / len(ttft)} card={card}",
          flush=True)
    hs = check_window_logits(torch, label, eng, params, cfg, prompts)
    ms, split = time_round_parts(torch, label, eng, SPEC_TIMED_ROUNDS)
    profile_steps(torch, f"{label}: 2 rounds, {eng.slots} slots", eng.step, 2)
    # 2 + SPEC_TIMED_ROUNDS + 2 rounds ran, each emitting at least one token
    # per slot after the first token; the rest of the budget is not needed
    for h in hs:
        h.cancel()
    drain(torch, eng)
    least = 1 + 2 + SPEC_TIMED_ROUNDS + 2
    if any(len(h.result(timeout=0)) < least for h in hs):
        fail(f"{label}: a request of the full-grid rounds emitted fewer than "
             f"{least} tokens")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: phase wall {time.perf_counter() - t_phase:.1f}s", flush=True)
    return got, dict(acceptance_rate=accept, rounds=rounds,
                     tokens_per_target_pass=(emitted - admitted) / rounds,
                     decode_tok_per_s=rate, plain_decode_tok_per_s=plain_rate,
                     mean_ttft_s=sum(ttft) / len(ttft), ms_per_round=ms,
                     round_split_ms=split)


def drive_spec_exact(torch, ops_attn, ops_dec, card):
    """fp32 exactness at Llama-3-8B's width with SPEC_EXACT["layers"]
    layers (TF32 off), beside a draft of Llama-3.2-1B's width at the same
    depth: every request's greedy tokens through SpeculativeEngine, with
    that draft and with the target as its own draft, equal the plain
    GenerationEngine's, with exact launch counts."""
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.serve import GenerationEngine, SpeculativeEngine

    t_phase = time.perf_counter()
    n_layers, k = SPEC_EXACT["layers"], SPEC_EXACT["k"]
    cfg = LlamaConfig.llama3_8b(n_layers=n_layers, dtype=torch.float32)
    dcfg = LlamaConfig.llama3_1b(n_layers=n_layers, dtype=torch.float32)
    params = llama_init(cfg, seed=5, device="cuda")
    draft = llama_init(dcfg, seed=6, device="cuda")
    grid = dict(FEATURE_GRID, slots=SPEC_EXACT["slots"], device="cuda")
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SPEC_EXACT["prompts"]]
    new = SPEC_EXACT["new"]

    def run(eng):
        hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        while eng.step():
            pass
        return [h.result(timeout=0) for h in hs]

    want = run(GenerationEngine(params, cfg, **grid))
    launches = Launches(ops_attn, ops_dec)
    rates = {}
    for name, d, dc in (("independent draft", draft, dcfg),
                        ("self-draft", params, cfg)):
        eng = SpeculativeEngine(params, cfg, d, dc, spec_k=k, **grid)
        launches.zero()
        got = run(eng)
        counts = launches.read()
        rates[name] = eng.spec_stats.acceptance_rate
        check_launches(f"spec_exact {name}", counts, dict(
            flash_fwd=(cfg.n_layers + dc.n_layers) * len(prompts),
            decode_attention=dc.n_layers * (k - 1) * eng._steps,
            decode_attention_quant=0))
        same = [g == w for g, w in zip(got, want)]
        print(f"spec_exact {name}: fp32, {cfg.n_layers} layers at "
              f"Llama-3-8B's width, {len(prompts)} requests x {new} tokens, "
              f"k={k}, {eng._steps} rounds: tokens equal to the plain "
              f"engine's {sum(same)}/{len(same)}, acceptance_rate="
              f"{rates[name]}", flush=True)
        if not all(same):
            first = next(i for i, s_ in enumerate(same) if not s_)
            fail(f"spec_exact {name}: request {first} gave {got[first]}, the "
                 f"plain engine {want[first]}")
        del eng
    del params, draft
    gc.collect()
    torch.cuda.empty_cache()
    print(f"spec_exact: phase wall {time.perf_counter() - t_phase:.1f}s "
          f"card={card}", flush=True)
    return rates


def drive_spec_generate(torch, ops_attn, ops_dec, params, cfg, draft, dcfg,
                        prompt, plain_tokens, card):
    """speculative_generate: one request on the bf16 target with the 1B
    draft, k = SPEC_K, MAX_NEW tokens. Every pass is the plain cached
    attention (the JAX package's path: no flash prefill, single-step draft
    ingests), so no kernel launches; the tokens' agreement with the plain
    engine's for the same prompt is printed, not held (bf16 near-ties)."""
    from kubetorch_tpu_torch.serve import SpecStats, speculative_generate
    launches = Launches(ops_attn, ops_dec)
    stats = SpecStats()
    launches.zero()
    t = time.perf_counter()
    toks = speculative_generate(params, cfg, draft, dcfg, prompt,
                                max_new_tokens=MAX_NEW, k=SPEC_K, stats=stats,
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launches.read()
    check_launches("spec_generate", counts, dict(
        flash_fwd=0, decode_attention=0, decode_attention_quant=0))
    if len(toks) != MAX_NEW or not all(0 <= x < cfg.vocab_size for x in toks) \
            or stats.rounds < 1:
        fail(f"spec_generate: {len(toks)} tokens {toks[:8]}, {stats}")
    lead = next((i for i, (a, b) in enumerate(zip(toks, plain_tokens))
                 if a != b), len(toks))
    print(f"spec_generate: a {len(prompt)}-token prompt, {MAX_NEW} tokens, "
          f"k={SPEC_K}: {stats.rounds} rounds, acceptance_rate="
          f"{stats.acceptance_rate}, wall {wall}s ({MAX_NEW / wall} tokens/s, "
          f"prefill included); leading tokens equal to the plain engine's "
          f"{lead}/{MAX_NEW} card={card}", flush=True)
    return dict(rounds=stats.rounds, acceptance_rate=stats.acceptance_rate,
                wall_s=wall)


def mixtral_init_quantized(torch, cfg, seed):
    """Random Mixtral params in the quantize_params_int4 layout, built on
    the card one matrix at a time (each drawn in fp32 and quantized):
    int8 expert banks, int4 (group 128) attention and head, fp32 router
    (drawn, rounded to bf16, kept in fp32 as moe_init does) and norms, a
    bf16 embedding."""
    from kubetorch_tpu_torch.models.quant import (_quantize_leaf,
                                                  _quantize_leaf_int4)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, L, E, f = cfg.dim, cfg.n_layers, cfg.n_experts, cfg.ffn_dim
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def stacked(lead, in_dim, out_dim, quantizer):
        acc = None
        for idx in itertools.product(*(range(n) for n in lead)):
            leaf = quantizer(draw((in_dim, out_dim), in_dim))
            if acc is None:
                acc = {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype,
                                      device="cuda") for k, v in leaf.items()}
            for k, v in leaf.items():
                acc[k][idx] = v
        return acc

    layers = {"attn_norm": torch.ones((L, d), device="cuda")}
    for name, (i, o) in (("wq", (d, nh * hd)), ("wk", (d, nkv * hd)),
                         ("wv", (d, nkv * hd)), ("wo", (nh * hd, d))):
        layers[name] = stacked((L,), i, o, _quantize_leaf_int4)
    layers["ffn_norm"] = torch.ones((L, d), device="cuda")
    layers["router"] = draw((L, d, E), d).to(cfg.dtype).float()
    layers["experts"] = {
        name: stacked((L, E), i, o, _quantize_leaf)
        for name, (i, o) in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d)))}
    return {"embed": draw((cfg.vocab_size, d), d).to(cfg.dtype),
            "layers": layers,
            "final_norm": torch.ones((d,), device="cuda"),
            "lm_head": _quantize_leaf_int4(draw((d, cfg.vocab_size), d))}


@contextlib.contextmanager
def pinned_routing(moe_mod):
    """Record every top-k choice ``moe._route`` makes; after ``replay()``,
    make the same choices again in the same order, with gates renormalized
    from the new run's own probabilities."""
    real = moe_mod._route
    chosen, state = [], {"replay": None}

    def route(cfg, x, lw):
        probs, vals, idx = real(cfg, x, lw)
        if state["replay"] is None:
            chosen.append(idx)
            return probs, vals, idx
        idx = next(state["replay"])
        vals = probs.gather(-1, idx)
        return probs, vals / (vals.sum(-1, keepdim=True) + 1e-9), idx

    def replay():
        state["replay"] = iter(chosen)

    moe_mod._route = route
    try:
        yield replay
    finally:
        moe_mod._route = real


def check_moe_first_token_logits(torch, params, plain_params, cfg, eng,
                                 prompts):
    """First-token logits of a 300-token prompt in the 512 bucket, the
    kernel path against the plain path, with the plain path's expert
    choices pinned to the kernel path's (``pinned_routing``): within
    LOGITS_REL_L2, as the Llama engines. Unpinned, a router whose top-2
    and top-3 logits sit within the two paths' rounding difference picks
    another expert for that token in that layer, which moves its hidden
    state by a whole expert's output; the unpinned distance is printed
    beside the gated one."""
    from kubetorch_tpu_torch.models import moe as moe_mod
    from kubetorch_tpu_torch.serve import engine as engine_mod
    n = 300
    toks = torch.zeros((1, 512), dtype=torch.long)
    toks[0, :n] = torch.tensor(prompts[4])
    toks = toks.cuda()
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    with torch.no_grad():
        with pinned_routing(moe_mod) as replay:
            lk, _, _ = engine_mod._prefill_logits(params, toks, n, cfg, eng._freqs)
            replay()
            lp, _, _ = engine_mod._prefill_logits(plain_params, toks, n, cfg_x,
                                                  eng._freqs)
        lx, _, _ = engine_mod._prefill_logits(plain_params, toks, n, cfg_x,
                                              eng._freqs)
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        fail("moe: first-token logits not finite or of the wrong shape")
    rel = float((lk - lp).norm() / lp.norm())
    free = float((lk - lx).norm() / lx.norm())
    print(f"moe: first-token logits kernel vs plain path, expert choices "
          f"pinned: rel_l2={rel} max_abs={float((lk - lp).abs().max())} "
          f"tol_rel_l2={LOGITS_REL_L2} argmax {int(lk.argmax())}/"
          f"{int(lp.argmax())}; each path routing on its own: rel_l2={free} "
          f"argmax {int(lk.argmax())}/{int(lx.argmax())}", flush=True)
    if not rel <= LOGITS_REL_L2:
        fail(f"moe: first-token logits differ, rel L2 {rel} > {LOGITS_REL_L2}")


def check_moe_ffn_forms(torch, engine_mod, eng, cfg, prompts):
    """Layer 0's FFN input in one decode step of the full 8-slot grid,
    taken from the engine's own call: moe_ffn_decode (the gather) and
    moe_ffn at T = 1 (the dispatch the 8-slot step runs) agree per row."""
    from kubetorch_tpu_torch.models.moe import moe_ffn, moe_ffn_decode
    from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
    hs = [eng.submit(p[:40], max_new_tokens=4) for p in prompts[:eng.slots]]
    eng.step()                                  # admissions + one decode step
    seen = []
    real = engine_mod.ffn_block

    def spy(c, h, lw, **kw):
        if not seen and h.shape[1] == 1:
            seen.append((h.clone(), lw))
        return real(c, h, lw, **kw)

    engine_mod.ffn_block = spy
    try:
        eng.step()
    finally:
        engine_mod.ffn_block = real
    h, lw = seen[0]
    with torch.no_grad():
        gathered = moe_ffn_decode(cfg, h, lw)
        dispatched, _ = moe_ffn(cfg, h, lw)
    err = row_rel_err(gathered, dispatched)
    tol = ROW_RTOL[torch.bfloat16]
    print(f"moe: layer 0 FFN of a decode step, {h.shape[0]} slots: "
          f"moe_ffn_decode (gather) vs moe_ffn (dispatch) max_row_rel_err="
          f"{err} row_rtol={tol}", flush=True)
    if not (torch.isfinite(gathered).all() and err <= tol):
        fail(f"moe: the gather and the dispatch disagree: {err} > {tol}")
    while eng.step():
        pass
    for h in hs:
        h.result(timeout=0)


def drive_moe(torch, ops_attn, ops_dec, ops_q4, card):
    """Mixtral-8x7B at full width and CUT_LAYERS layers through
    GenerationEngine, int8
    expert banks beside int4 attention and head and an int8 KV cache: the
    engine phases' warm-up and 12 requests on 8 slots (decode through the
    dispatch), then 4 requests on 2 slots (decode through the gather)."""
    from kubetorch_tpu_torch.models.moe import MoeConfig
    from kubetorch_tpu_torch.models.quant import Q4KEY, dequant, quantized_bytes
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod

    t_phase = time.perf_counter()
    cfg = MoeConfig.mixtral_8x7b(n_layers=CUT_LAYERS)
    params = mixtral_init_quantized(torch, cfg, seed=0)
    torch.cuda.synchronize()
    sizes = quantized_bytes(params)
    weight_gb = (sizes["quantized"] + sizes["full"]) / 1e9
    grid = dict(max_len=2048, prefill_buckets=(128, 256, 512, 1024),
                quantize_kv=True, device="cuda")
    eng = GenerationEngine(params, cfg, slots=8, **grid)
    cache_gb = sum(t.numel() * t.element_size() for t in eng._cache) / 1e9
    print(f"moe: Mixtral-8x7B, {cfg.n_layers} of 32 layers "
          f"({cfg.param_count()} params; experts int8, "
          f"attention and head int4 group {Q4_GROUP}) initialised in "
          f"{time.perf_counter() - t_phase:.2f}s; weight_gb={weight_gb} "
          f"cache_gb={cache_gb} (int8 grid, 8 slots x 2048) allocated_gb="
          f"{torch.cuda.memory_allocated() / 1e9} card={card}", flush=True)
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    warm = [eng.submit(prompt(n), max_new_tokens=2)
            for n in (100, 200, 400, 800, 1500)]
    drain(torch, eng)
    for h in warm:
        h.result(timeout=0)
    prompts = [prompt(n) for n in ENGINE_PROMPT_LENS]
    launches = Launches(ops_attn, ops_dec, ops_q4)
    L, n_req = cfg.n_layers, len(prompts)
    head = params["lm_head"]
    head_q4 = int(ops_q4.q4_supported((1, cfg.dim), head[Q4KEY].shape,
                                      head["scale"].shape))

    def want(prefills, steps):
        # A1 per from-zero prefill, B3 on wq/wk/wv/wo (and the head where
        # it tiles) per pass and step, B2 per step, B1 none
        return dict(flash_fwd=L * prefills, decode_attention=0,
                    decode_attention_quant=L * steps,
                    q4_matmul=(4 * L + head_q4) * (prefills + steps))

    torch.cuda.reset_peak_memory_stats()
    launches.zero()
    handles, tok_s, steps = serve_requests(torch, eng, cfg, prompts)
    counts = launches.read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outs = check_outputs("moe", handles, cfg, prompts)
    check_launches("moe", counts, want(n_req, steps))
    ttft = [h.time_to_first_token() for h in handles]
    print(f"moe: {len(outs)} requests completed, {MAX_NEW} tokens each, over "
          f"{steps} decode steps (8 slots: the dispatch, 2 x 8 x "
          f"{cfg.experts_per_token} > {cfg.n_experts} experts)", flush=True)
    print(f"moe: decode_tok_per_s={tok_s} (tokens of steps without admission "
          f"/ their wall time) mean_ttft_s={sum(ttft) / len(ttft)} (submit to "
          f"first token, queueing included) weight_gb={weight_gb} cache_gb="
          f"{cache_gb} peak_gb={peak_gb} card={card}", flush=True)

    # the plain path: int4 leaves dequantized to bf16, experts kept int8
    plain = {**params, "lm_head": dequant(head, torch.bfloat16),
             "layers": {k: dequant(v, torch.bfloat16)
                        if isinstance(v, dict) and Q4KEY in v else v
                        for k, v in params["layers"].items()}}
    check_moe_first_token_logits(torch, params, plain, cfg, eng, prompts)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    check_moe_ffn_forms(torch, engine_mod, eng, cfg, prompts)
    profile_decode(torch, eng, prompts)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # two slots: 2 x 2 x 2 <= 8, the decode gather
    eng = GenerationEngine(params, cfg, slots=2, **grid)
    steps0 = eng.stats().decode_steps
    launches.zero()
    small = [eng.submit(prompt(n), max_new_tokens=MAX_NEW)
             for n in MOE_GATHER_PROMPTS]
    rate = decode_rate(drain(torch, eng))
    gather_counts = launches.read()
    g_steps = eng.stats().decode_steps - steps0
    check_launches("moe_gather", gather_counts,
                   want(len(MOE_GATHER_PROMPTS), g_steps))
    if any(len(h.result(timeout=0)) != MAX_NEW for h in small):
        fail("moe_gather: a request did not complete")
    print(f"moe_gather: 2 slots, {len(small)} requests of {MAX_NEW} tokens "
          f"over {g_steps} decode steps through moe_ffn_decode: "
          f"decode_tok_per_s={rate[0]} ({rate[1]} ms/step) card={card}",
          flush=True)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe: phase wall {time.perf_counter() - t_phase:.1f}s", flush=True)
    return counts, gather_counts, dict(decode_tok_per_s=tok_s,
                                       mean_ttft_s=sum(ttft) / len(ttft),
                                       weight_gb=weight_gb, cache_gb=cache_gb,
                                       peak_gb=peak_gb)


@contextlib.contextmanager
def recorded_routing(moe_mod):
    """Every expert choice (``_route``'s top-k indices) and kept-pair mask
    (``_dispatch``'s) the MoE layers make, in call order."""
    real_route, real_dispatch = moe_mod._route, moe_mod._dispatch
    rec = {"idx": [], "kept": []}

    def route(*a, **kw):
        out = real_route(*a, **kw)
        rec["idx"].append(out[2].detach().clone())
        return out

    def dispatch(*a, **kw):
        out = real_dispatch(*a, **kw)
        rec["kept"].append(out[2].clone())
        return out

    moe_mod._route, moe_mod._dispatch = route, dispatch
    try:
        yield rec
    finally:
        moe_mod._route, moe_mod._dispatch = real_route, real_dispatch


def same_routing(torch, a, b) -> bool:
    return all(len(a[k]) == len(b[k]) and all(torch.equal(x, y)
                                              for x, y in zip(a[k], b[k]))
               for k in ("idx", "kept"))


def check_moe_train_paths(torch, cfg):
    """moe_loss and every leaf's gradient, kernel path vs plain path, fp32
    at the phase's width and depth, B=1, S=TRAIN_CHECK_S, after asserting
    that both paths made the same expert choices and kept the same pairs
    in every layer (forward and remat recompute). Where a near-tie router
    flips between the paths, the plain path's choices are pinned to the
    kernel path's (``pinned_routing``) and the check says so."""
    from kubetorch_tpu_torch.models import moe as moe_mod
    from kubetorch_tpu_torch.train import make_train_step

    c32 = dataclasses.replace(cfg, dtype=torch.float32,
                              max_seq_len=TRAIN_CHECK_S)
    params = moe_mod.moe_init(c32, seed=3, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, TRAIN_CHECK_S))).cuda()
    batch = {"tokens": tok, "targets": tok.roll(-1, 1)}

    def run(impl):
        c = dataclasses.replace(c32, attn_impl=impl)
        return make_train_step(lambda p, t, y: moe_mod.moe_loss(p, t, y, c)) \
            .loss_and_grads(params, batch)

    with pinned_routing(moe_mod) as replay:
        with recorded_routing(moe_mod) as r_kernel:
            lk, gk = run("auto")
        with recorded_routing(moe_mod) as r_plain:
            lp, gp = run("xla")
        pinned = not same_routing(torch, r_kernel, r_plain)
        if pinned:
            del gp
            replay()
            with recorded_routing(moe_mod) as r_plain:
                lp, gp = run("xla")
    routed = same_routing(torch, r_kernel, r_plain)
    n_pairs = sum(int(k.numel()) for k in r_kernel["kept"])
    dropped = sum(int((~k).sum()) for k in r_kernel["kept"])
    print(f"moe_train: routing kernel vs plain path, fp32, "
          f"{len(r_kernel['idx'])} router calls (forward and recompute): "
          f"identical {not pinned} (expert choices pinned to the kernel "
          f"path's: {pinned}); kept pairs identical {routed}; "
          f"{dropped}/{n_pairs} pairs dropped", flush=True)
    if not routed:
        fail("moe_train: the two paths kept different pairs")
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    worst = max_leaf_rel(torch, gk, gp)
    print(f"moe_train: loss kernel vs plain path, fp32, {cfg.n_layers} layers, "
          f"B=1 S={TRAIN_CHECK_S}: {float(lk)} vs {float(lp)} rel={loss_rel}; "
          f"every leaf's grad (router, expert banks, attention, embed, head, "
          f"norms): max per-leaf |diff| / max |plain| = {worst} "
          f"tol={TRAIN_GRAD_REL}", flush=True)
    if not (loss_rel <= TRAIN_GRAD_REL and worst <= TRAIN_GRAD_REL):
        fail(f"moe_train: kernel path differs: loss {loss_rel}, grads {worst}")
    return dict(grad_rel=worst, loss_rel=loss_rel, routing_pinned=pinned)


def drive_moe_train(torch, ops_attn, card):
    """Mixtral-8x7B's width at MOE_TRAIN_LAYERS layers, bf16, through
    make_train_step and moe_loss; then one lora_loss step over the trained
    MoE base; then the fp32 kernel-vs-plain check. Returns the
    kernels-line records."""
    from kubetorch_tpu_torch.models import moe as moe_mod
    from kubetorch_tpu_torch.models.lora import LoraConfig, lora_init, lora_loss
    from kubetorch_tpu_torch.train import (adamw, default_optimizer,
                                           init_train_state, make_train_step)

    t_phase = time.perf_counter()
    cfg = moe_mod.MoeConfig.mixtral_8x7b(n_layers=MOE_TRAIN_LAYERS,
                                         max_seq_len=TRAIN_S)
    opt = default_optimizer(warmup_steps=2)
    state = init_train_state(moe_mod.moe_init(cfg, seed=0, device="cuda"), opt)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"moe_train: Mixtral-8x7B width, {cfg.n_layers} of 32 layers "
          f"({cfg.param_count()} params, bf16, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token}, capacity {cfg.capacity_factor}), "
          f"default_optimizer, remat dots; params + optimizer state "
          f"{state_gb} GB card={card}", flush=True)
    batch = host_batch(torch, cfg.vocab_size, seed=7)
    tok, tgt = batch["tokens"].cuda(), batch["targets"].cuda()
    with torch.no_grad():
        _, aux0 = moe_mod.moe_forward(state.params, tok, cfg)
    aux0 = float(aux0)
    print(f"moe_train: router aux (mean over layers) at step 0: {aux0}; "
          f"weighted {cfg.router_aux_weight * aux0} in the loss", flush=True)
    if not (math.isfinite(aux0) and aux0 > 0):
        fail(f"moe_train: router aux {aux0} is not finite and positive")
    step = make_train_step(lambda p, t, y: moe_mod.moe_loss(p, t, y, cfg), opt)
    state, _, rec = run_train_steps(torch, ops_attn, "moe_train", step, state,
                                    batch, cfg.n_layers)

    def one_step():
        nonlocal state
        state, _ = step(state, {"tokens": tok, "targets": tgt})

    # the capacity dispatch and combine move rows by index, the positions
    # come from a cumsum (the embedding lookup and the CE gather share the
    # index kernels); a flash kernel's name holds "_sm90"
    profile_steps(torch, f"moe_train: 1 step, batch {TRAIN_B}x{TRAIN_S}",
                  one_step, 1, groups={
                      "dispatch (index/scatter/gather/scan kernels)":
                          ("index", "scatter", "gather", "scan", "Scan"),
                      "attention (A1, A2, A3)": ("_sm90",),
                      "cuBLAS GEMMs": ("nvjet", "gemm", "sm90_xmma")})
    params = state.params
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # one LoRA step over the trained MoE base: lora_loss takes moe_loss
    lcfg = LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA, targets=MOE_LORA_TARGETS)
    lopt = adamw(LORA_TRAIN_LR)
    lstate = init_train_state(lora_init(params, lcfg, seed=1), lopt)
    lstep = make_train_step(lora_loss(params, cfg, lcfg), lopt)
    fa = ops_attn.flash_attention
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    lstate, m = lstep(lstate, {"tokens": tok, "targets": tgt})
    torch.cuda.synchronize()
    lora_counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    # lora_init's B is 0: it moved only if the step gave it a gradient
    b_norm = float(sum(v.float().norm() for k, v in lstate.params["layers"].items()
                       if k.endswith("__b")))
    print(f"moe_train: lora_loss over the MoE base (rank {lcfg.rank}, "
          f"{lcfg.targets}, moe_loss by default): loss {float(m['loss'])}, "
          f"|B| after one step {b_norm}", flush=True)
    L = cfg.n_layers
    check_launches("moe_lora (A1, A2, A3), one step", lora_counts,
                   (2 * L, L, L))
    if not (math.isfinite(float(m["loss"])) and b_norm > 0):
        fail("moe_train: the LoRA step over the MoE base moved no adapter")
    del params, lstate, lstep
    gc.collect()
    torch.cuda.empty_cache()

    rec.update(check_moe_train_paths(torch, cfg), aux=aux0,
               lora_launches=lora_counts, state_gb=state_gb)
    gc.collect()
    torch.cuda.empty_cache()
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"moe_train: phase wall {rec['phase_wall_s']:.1f}s", flush=True)
    return rec


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
    state, checkpoint = drive_checkpoint(torch, ops_attn, step, state, batch,
                                         card)
    check_train_paths(torch, cfg, state.params, tokens)
    return counts, dict(tokens_per_s=tps, mfu=mfu, peak_memory_gb=peak_gb,
                        ms_per_step=dt / TRAIN_STEPS * 1e3,
                        checkpoint=checkpoint)


def drive_checkpoint(torch, ops_attn, step, state, batch, card):
    """The 1B training run saved and resumed: after step k, a blocking
    snapshot and its fingerprint; Checkpointer.maybe_save (async) and at
    once step k + 1, whose in-place update races the copies; flush. The
    committed checkpoint must fingerprint as the blocking snapshot, and
    restored onto the card its next step must give step k + 1's loss
    exactly. Then a save torn at its commit marker, and the same state
    saved again (every leaf already there). Returns (state, record)."""
    from kubetorch_tpu_torch import telemetry
    from kubetorch_tpu_torch.train import (Checkpointer, commit_info,
                                           train_state_from_tree,
                                           train_state_tree, tree_fingerprint)
    from kubetorch_tpu_torch.train.checkpoint import _host_tree

    t_phase = time.perf_counter()
    fa = ops_attn.flash_attention
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    stall = telemetry.train_metrics()["step_seconds"]
    ckpt_s = telemetry.histogram("kt_checkpoint_seconds", labels=("op",))
    mem = MemStore()
    ckpt = Checkpointer("train/llama-1b", store=mem)
    torch.cuda.synchronize()
    k = int(state.step)
    t = time.perf_counter()
    snap = _host_tree(train_state_tree(state))
    snapshot_s = time.perf_counter() - t
    t = time.perf_counter()
    want_fp = tree_fingerprint(snap)
    fingerprint_s = time.perf_counter() - t
    state_bytes = sum(a.nbytes for a in _np_leaves(snap))
    del snap
    stall0 = hist_sums(stall, "phase").get("snapshot_stall", 0.0)
    fut = ckpt.maybe_save(train_state_tree(state), k)
    state, m = step(state, batch)         # step k + 1, at once, in place
    live_loss = float(m["loss"])
    t = time.perf_counter()
    ckpt.flush()
    flush_s = time.perf_counter() - t
    stall_s = hist_sums(stall, "phase")["snapshot_stall"] - stall0
    saved = fut.result()
    t = time.perf_counter()
    restored, at = ckpt.restore()
    restore_s = time.perf_counter() - t
    got_fp = tree_fingerprint(restored)
    resumed = train_state_from_tree(restored, state, device="cuda")
    resumed, m2 = step(resumed, batch)
    resumed_loss = float(m2["loss"])
    del resumed, restored
    gc.collect()
    torch.cuda.empty_cache()
    print(f"checkpoint: Llama-3.2-1B train state {state_bytes} bytes at step "
          f"{k}: blocking snapshot {snapshot_s:.3f}s, its fingerprint "
          f"{fingerprint_s:.3f}s; maybe_save held the step "
          f"{stall_s:.4f}s (kt_train_step_seconds{{phase=\"snapshot_stall\"}})"
          f", the commit (put, marker) {saved['seconds']}s on the IO "
          f"thread, flush waited {flush_s:.3f}s after step {k + 1}; restore "
          f"{restore_s:.4f}s card={card}", flush=True)
    print(f"checkpoint: committed step {at}, fingerprint == the blocking "
          f"snapshot's {got_fp == want_fp}; restored and stepped: loss "
          f"{resumed_loss} vs the live step {k + 1}'s {live_loss}", flush=True)
    if at != k or got_fp != want_fp:
        fail("checkpoint: the committed bytes are not step k's (the in-place "
             "step overtook the snapshot?)")
    if resumed_loss != live_loss:
        fail(f"checkpoint: restored step loss {resumed_loss} != {live_loss}")

    # a save torn at its commit marker, then the same state saved again
    mem.fail_json = True
    try:
        ckpt.save(train_state_tree(state), k + 1)
        fail("checkpoint: the torn save did not raise")
    except OSError:
        pass
    torn_info = commit_info("train/llama-1b", store=mem)
    again = ckpt.save(train_state_tree(state), k + 1)
    print(f"checkpoint: a save torn at its marker leaves commit {torn_info}; "
          f"the same state saved again: {again['skipped']} of "
          f"{again['leaves']} leaves skipped, {again['bytes']} bytes moved, "
          f"{again['seconds']}s; kt_checkpoint_seconds "
          f"{hist_sums(ckpt_s, 'op')}", flush=True)
    if torn_info != {"step": k, "slot": 0}:
        fail(f"checkpoint: a torn save moved the commit to {torn_info}")
    if again["skipped"] != again["leaves"] or again["bytes"] != 0:
        fail(f"checkpoint: the second save moved bytes: {again}")
    counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    L = int(state.params["layers"]["wq"].shape[0])
    check_launches("checkpoint (A1, A2, A3) over 2 steps", counts,
                   (4 * L, 2 * L, 2 * L))
    del mem, ckpt
    gc.collect()
    wall = time.perf_counter() - t_phase
    print(f"checkpoint: phase wall {wall:.1f}s card={card}", flush=True)
    return state, dict(launches=counts, state_bytes=state_bytes,
                       snapshot_s=snapshot_s, stall_s=stall_s,
                       commit_s=saved["seconds"], flush_s=flush_s,
                       restore_s=restore_s, phase_wall_s=wall)


def _np_leaves(tree):
    return list(named_leaves(tree).values())


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


# the safetensors names of the dtypes the script's own writer takes, by
# str(dtype): torch is imported only in main
ST_NAMES = {"torch.float32": "F32", "torch.bfloat16": "BF16"}


def half_split_rows(torch, n_heads, head_dim):
    """Row r of HF's q/k projection (half-split RoPE: head h, half j,
    pair i at r = h*hd + j*hd/2 + i) is column h*hd + 2i + j of the
    port's (in, out) leaf, whose pairs are interleaved: an index map, not
    the reshape the port's converter uses."""
    idx = [h * head_dim + 2 * i + j for h in range(n_heads) for j in (0, 1)
           for i in range(head_dim // 2)]
    return torch.tensor(idx, dtype=torch.long, device="cuda")


def write_hf_checkpoint(torch, path, conf, items, shard_bytes=HF_SHARD_BYTES):
    """The script's own safetensors writer: ``items`` are (name, dtype,
    shape, make) in the checkpoint's order, each made on the card one at a
    time; shards of at most ``shard_bytes`` filled in order, the index
    when there is more than one, and ``conf`` as config.json. Returns
    (bytes of tensor data, number of shards)."""
    shards, size, total = [[]], 0, 0
    for item in items:
        n = math.prod(item[2]) * torch.empty((), dtype=item[1]).element_size()
        if shards[-1] and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((item, n))
        size += n
        total += n
    os.makedirs(path, exist_ok=True)
    weight_map = {}
    for s, shard in enumerate(shards):
        name = (f"model-{s + 1:05d}-of-{len(shards):05d}.safetensors"
                if len(shards) > 1 else "model.safetensors")
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for (key, dtype, shape, _), n in shard:
            header[key] = {"dtype": ST_NAMES[str(dtype)], "shape": list(shape),
                           "data_offsets": [offset, offset + n]}
            offset += n
            weight_map[key] = name
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(path, name), "wb") as f:
            f.write(len(raw).to_bytes(8, "little"))
            f.write(raw)
            for (key, dtype, shape, make), n in shard:
                t = make().contiguous()
                if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                    fail(f"hf_openai: {key} made {t.dtype}{tuple(t.shape)}")
                f.write(t.view(torch.uint8).cpu().numpy())
            f.flush()
            os.fsync(f.fileno())
    if len(shards) > 1:
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f, indent=2)
    return total, len(shards)


def hf_items_from_tree(torch, params, cfg, dtype):
    """The port's stacked tree as HF's per-layer (out, in) tensors in
    ``dtype``, in Meta's order: q/k rows put back in half-split order."""
    hd = cfg.head_dim
    perm_q = half_split_rows(torch, cfg.n_heads, hd)
    perm_k = half_split_rows(torch, cfg.n_kv_heads, hd)
    lay = params["layers"]

    def item(name, make, shape):
        return (name, dtype, shape, lambda: make().to(dtype))

    d, f = cfg.dim, cfg.ffn_dim
    nq, nk = cfg.n_heads * hd, cfg.n_kv_heads * hd
    items = [item("model.embed_tokens.weight", lambda: params["embed"],
                  (cfg.vocab_size, d))]
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        items += [
            item(p + "self_attn.q_proj.weight",
                 lambda i=i: lay["wq"][i].t().index_select(0, perm_q), (nq, d)),
            item(p + "self_attn.k_proj.weight",
                 lambda i=i: lay["wk"][i].t().index_select(0, perm_k), (nk, d)),
            item(p + "self_attn.v_proj.weight", lambda i=i: lay["wv"][i].t(),
                 (nk, d)),
            item(p + "self_attn.o_proj.weight", lambda i=i: lay["wo"][i].t(),
                 (d, nq)),
            item(p + "mlp.gate_proj.weight", lambda i=i: lay["w_gate"][i].t(),
                 (f, d)),
            item(p + "mlp.up_proj.weight", lambda i=i: lay["w_up"][i].t(),
                 (f, d)),
            item(p + "mlp.down_proj.weight", lambda i=i: lay["w_down"][i].t(),
                 (d, f)),
            item(p + "input_layernorm.weight", lambda i=i: lay["attn_norm"][i],
                 (d,)),
            item(p + "post_attention_layernorm.weight",
                 lambda i=i: lay["ffn_norm"][i], (d,))]
    items += [item("model.norm.weight", lambda: params["final_norm"], (d,)),
              item("lm_head.weight", lambda: params["lm_head"].t(),
                   (cfg.vocab_size, d))]
    return items


def hf_random_weights(torch, conf, seed):
    """HF-layout fp32 weights of ``conf`` drawn on the card from a seed:
    (out, in) projections scaled by 1/sqrt(in), norms 1 + 0.1 N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, f, v = conf["hidden_size"], conf["intermediate_size"], conf["vocab_size"]
    hd = d // conf["num_attention_heads"]
    nq, nk = conf["num_attention_heads"] * hd, conf["num_key_value_heads"] * hd

    def w(out, fan_in):
        return torch.randn((out, fan_in), generator=g, device="cuda") / math.sqrt(fan_in)

    def norm():
        return 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")

    out = {"model.embed_tokens.weight": w(v, d)}
    for i in range(conf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({p + "self_attn.q_proj.weight": w(nq, d),
                    p + "self_attn.k_proj.weight": w(nk, d),
                    p + "self_attn.v_proj.weight": w(nk, d),
                    p + "self_attn.o_proj.weight": w(d, nq),
                    p + "mlp.gate_proj.weight": w(f, d),
                    p + "mlp.up_proj.weight": w(f, d),
                    p + "mlp.down_proj.weight": w(d, f),
                    p + "input_layernorm.weight": norm(),
                    p + "post_attention_layernorm.weight": norm()})
    out.update({"model.norm.weight": norm(), "lm_head.weight": w(v, d)})
    return out


def hf_convention_forward(torch, w, conf, tokens):
    """Logits (1, S, V) of HF's Llama forward, written out on the script's
    HF-layout tensors: rotate_half RoPE with the llama3 frequency scaling,
    RMSNorm, GQA causal attention, SwiGLU, fp32 throughout."""
    d, nh, nkv = (conf["hidden_size"], conf["num_attention_heads"],
                  conf["num_key_value_heads"])
    hd, eps, s = d // nh, conf["rms_norm_eps"], tokens.shape[1]
    inv = 1.0 / (conf["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.int64, device="cuda").float() / hd))
    rs = conf.get("rope_scaling")
    if rs:
        factor, lo, hi = rs["factor"], rs["low_freq_factor"], rs["high_freq_factor"]
        old = rs["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv
        scaled = torch.where(wavelen > old / lo, inv / factor, inv)
        smooth = (old / wavelen - lo) / (hi - lo)
        smoothed = (1 - smooth) * scaled / factor + smooth * scaled
        medium = ~(wavelen < old / hi) & ~(wavelen > old / lo)
        inv = torch.where(medium, smoothed, scaled)
    ang = torch.outer(torch.arange(s, device="cuda").float(), inv)
    emb = torch.cat((ang, ang), dim=-1)
    cos, sin = emb.cos()[None, None], emb.sin()[None, None]

    def rotate_half(x):
        return torch.cat((-x[..., hd // 2:], x[..., :hd // 2]), dim=-1)

    def rms(x, weight):
        return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))

    mask = torch.full((s, s), float("-inf"), device="cuda").triu(1)
    x = w["model.embed_tokens.weight"][tokens]
    for i in range(conf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = rms(x, w[p + "input_layernorm.weight"])
        q = (h @ w[p + "self_attn.q_proj.weight"].t()).view(1, s, nh, hd).transpose(1, 2)
        k = (h @ w[p + "self_attn.k_proj.weight"].t()).view(1, s, nkv, hd).transpose(1, 2)
        v = (h @ w[p + "self_attn.v_proj.weight"].t()).view(1, s, nkv, hd).transpose(1, 2)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        k, v = (t.repeat_interleave(nh // nkv, dim=1) for t in (k, v))
        att = torch.softmax(q @ k.transpose(2, 3) / math.sqrt(hd) + mask, dim=-1)
        o = (att @ v).transpose(1, 2).reshape(1, s, d)
        x = x + o @ w[p + "self_attn.o_proj.weight"].t()
        h = rms(x, w[p + "post_attention_layernorm.weight"])
        ffn = (torch.nn.functional.silu(h @ w[p + "mlp.gate_proj.weight"].t())
               * (h @ w[p + "mlp.up_proj.weight"].t()))
        x = x + ffn @ w[p + "mlp.down_proj.weight"].t()
    return rms(x, w["model.norm.weight"]) @ w["lm_head.weight"].t()


class RssPeak:
    """The process's resident set sampled every 5 ms on a thread (from
    /proc/self/statm): ``rise`` is the peak over the window less its start."""

    def __enter__(self):
        import threading
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self.now()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()
        return self

    def now(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def run(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self.now())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.now())
        self.rise = self.peak - self.start


def named_leaves(tree) -> dict:
    """{"layers/wq": leaf, ...} of a param tree."""
    from kubetorch_tpu_torch.data_store import commands as ds
    leaves = {}
    ds._flatten(tree, "", leaves)
    return leaves


def check_tree_bitwise(torch, label, got, want):
    """Same leaves, dtypes, shapes and bits."""
    g, w = named_leaves(got), named_leaves(want)
    if set(g) != set(w):
        fail(f"{label}: leaves {sorted(g)} != {sorted(w)}")
    bad = [k for k in w if g[k].dtype != w[k].dtype or g[k].shape != w[k].shape
           or not torch.equal(g[k], w[k])]
    print(f"{label}: {len(w)} leaves, bitwise equal: {not bad} {bad}",
          flush=True)
    if bad:
        fail(f"{label}: leaves differ from the source tree: {bad}")


class ByteTokenizer:
    """A stand-in tokenizer for chat: UTF-8 bytes as ids 0-255."""

    def encode(self, text):
        return list(text.encode())

    def decode(self, ids):
        return bytes(i % 256 for i in ids).decode("utf-8", errors="replace")


def counted(torch, label, launches, eng, prefills, layers, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read
    just after; A1 must have launched ``layers`` times per from-zero
    prefill and B1 ``layers`` times per decode step. Returns (fn's
    result, the counts)."""
    steps0 = eng.stats().decode_steps if eng is not None else 0
    launches.zero()
    out = fn()
    torch.cuda.synchronize()
    got = launches.read()
    steps = (eng.stats().decode_steps - steps0) if eng is not None else 0
    check_launches(label, got, dict(flash_fwd=layers * prefills,
                                    decode_attention=layers * steps,
                                    decode_attention_quant=0))
    return out, got


def api_ok(label, status, payload):
    if status != 200:
        fail(f"{label}: status {status}: {payload}")
    return payload


def stream_window_rate(times):
    """Tokens/s over the window in which every stream is decoding: from the
    last stream's first token to the first stream's last."""
    t0 = max(ts[0] for ts in times)
    t1 = min(ts[-1] for ts in times)
    n = sum(1 for ts in times for t in ts if t0 < t <= t1)
    return n / (t1 - t0)


def drive_hf_openai(torch, ops_attn, ops_dec, card):
    """Meta-Llama-3-8B's published checkpoint layout in and out, and the
    OpenAI surface over an engine on the loaded weights. Returns
    (launch totals of the counted runs, the phase's numbers)."""
    import resource
    import shutil
    import tempfile
    import threading

    from kubetorch_tpu_torch.models import load_hf, save_hf
    from kubetorch_tpu_torch.models.llama import (LlamaConfig, llama_forward,
                                                  llama_hidden, llama_init)
    from kubetorch_tpu_torch.serve import GenerationEngine, OpenAIApp

    t_phase = time.perf_counter()
    launches = Launches(ops_attn, ops_dec)
    totals = dict(flash_fwd=0, decode_attention=0)
    rec = {}

    def add(got):
        for k in totals:
            totals[k] += got[k]

    cfg = LlamaConfig.llama3_8b(n_layers=CUT_LAYERS)
    L = cfg.n_layers
    conf1 = dict(META_LLAMA3_8B, num_hidden_layers=L)
    bytes_8b = cfg.param_count() * 2
    conf2 = dict(META_LLAMA3_8B, num_hidden_layers=HF_FWD_LAYERS,
                 torch_dtype="float32", rope_scaling=LLAMA31_ROPE_SCALING,
                 max_position_embeddings=131072)
    bytes_2l = dataclasses.replace(cfg, n_layers=HF_FWD_LAYERS).param_count() * 4
    need = max(bytes_8b, 2 * bytes_2l) + 10 ** 9
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "hf_checkpoints")
    os.makedirs(base, exist_ok=True)
    free = shutil.disk_usage(base).free
    print(f"hf_openai: disk needed {need} bytes, free {free} bytes in {base}",
          flush=True)
    if free < need:
        fail(f"hf_openai: {need} bytes of disk needed for the checkpoints, "
             f"{free} free in {base}")
    root = tempfile.mkdtemp(prefix="hf_openai-", dir=base)
    try:
        # 1. the seed tree, norms from a seed rounded to bf16, written out
        src = llama_init(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(HF_NORM_SEED)
        for tree, key, shape in ((src["layers"], "attn_norm", (L, cfg.dim)),
                                 (src["layers"], "ffn_norm", (L, cfg.dim)),
                                 (src, "final_norm", (cfg.dim,))):
            tree[key] = (1.0 + 0.1 * torch.randn(shape, generator=g, device="cuda")
                         ).to(torch.bfloat16).float()
        dir1 = os.path.join(root, "Meta-Llama-3-8B")
        t = time.perf_counter()
        nbytes, shards = write_hf_checkpoint(
            torch, dir1, conf1,
            hf_items_from_tree(torch, src, cfg, torch.bfloat16))
        write_s = time.perf_counter() - t
        with open(os.path.join(dir1, "model.safetensors.index.json")) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        print(f"hf_openai: wrote {dir1}: {nbytes} bytes in {shards} shards "
              f"{files} in {write_s:.2f}s ({nbytes / write_s / 1e9:.2f} GB/s, "
              f"fsync'd)", flush=True)
        want_shards = -(-bytes_8b // HF_SHARD_BYTES)
        if shards != want_shards or shards < 2 or nbytes != bytes_8b:
            fail(f"hf_openai: {shards} shards of {nbytes} bytes, expected "
                 f"{want_shards} (at least 2) of {bytes_8b}")

        # 2. load_hf onto the card: every leaf the seed tree's bits
        maxrss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        torch.cuda.synchronize()
        with RssPeak() as rss:
            t = time.perf_counter()
            loaded, lcfg = load_hf(dir1, max_seq_len=2048)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
        maxrss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        dev_bytes = sum(v.numel() * v.element_size()
                        for v in named_leaves(loaded).values())
        rec["load"] = dict(seconds=load_s, gb_per_s=nbytes / load_s / 1e9,
                           host_rss_rise_bytes=rss.rise,
                           ru_maxrss_rise_bytes=(maxrss1 - maxrss0) * 1024,
                           device_bytes=dev_bytes, write_seconds=write_s,
                           write_gb_per_s=nbytes / write_s / 1e9)
        print(f"hf_openai: load_hf {load_s:.2f}s ({nbytes / load_s / 1e9:.2f} "
              f"GB/s from the page cache), host RSS rise {rss.rise} bytes "
              f"(sampled; ru_maxrss rise {(maxrss1 - maxrss0) * 1024}), device "
              f"{dev_bytes} bytes, cfg {lcfg} card={card}", flush=True)
        if lcfg != dataclasses.replace(cfg, max_seq_len=2048):
            fail(f"hf_openai: loaded config {lcfg}")
        if loaded["embed"].device.type != "cuda":
            fail(f"hf_openai: load_hf landed on {loaded['embed'].device}")
        check_tree_bitwise(torch, "hf_openai load_hf vs the seed tree", loaded,
                           src)
        del src
        shutil.rmtree(dir1)
        gc.collect()
        torch.cuda.empty_cache()

        # 3. 2 layers, fp32, Llama-3.1 scaling: the port's forward against
        # the HF-convention one; then save_hf and back
        w = hf_random_weights(torch, conf2, HF_FWD_SEED)
        dir2, dir3 = os.path.join(root, "fp32-2l"), os.path.join(root, "export")
        write_hf_checkpoint(torch, dir2, conf2,
                            [(k, torch.float32, tuple(v.shape), lambda v=v: v)
                             for k, v in w.items()])
        p2, cfg2 = load_hf(dir2, dtype=torch.float32, max_seq_len=2048)
        if cfg2.rope_scaling != (8.0, 1.0, 4.0, 8192):
            fail(f"hf_openai: rope_scaling {cfg2.rope_scaling}")
        gen = torch.Generator(device="cuda").manual_seed(HF_FWD_SEED)
        rels = []

        def forwards():
            for n in HF_FWD_PROMPTS:
                toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                                     device="cuda")
                got = llama_forward(p2, toks, cfg2)
                with torch.no_grad():
                    want = hf_convention_forward(torch, w, conf2, toks)
                if not (torch.isfinite(got).all() and got.shape == want.shape):
                    fail("hf_openai: fp32 logits not finite or misshapen")
                rels.append(float((got - want).norm() / want.norm()))

        _, got = counted(torch, "hf_openai fp32 forward", launches, None,
                         len(HF_FWD_PROMPTS), HF_FWD_LAYERS, forwards)
        add(got)
        print(f"hf_openai: 2-layer fp32 logits vs the HF-convention forward "
              f"(rotate_half, llama3 scaling), rel L2 per prompt "
              f"{dict(zip(HF_FWD_PROMPTS, rels))} tol {HF_FWD_REL_L2}",
              flush=True)
        if not max(rels) <= HF_FWD_REL_L2:
            fail(f"hf_openai: fp32 logits differ from HF's forward: {rels}")
        del w
        t = time.perf_counter()
        save_hf(p2, cfg2, dir3)
        save_s = time.perf_counter() - t
        saved = sum(os.path.getsize(os.path.join(dir3, f))
                    for f in os.listdir(dir3) if f.endswith(".safetensors"))
        back, _ = load_hf(dir3, dtype=torch.float32, max_seq_len=2048)
        check_tree_bitwise(torch, "hf_openai save_hf round trip", back, p2)
        rec["save"] = dict(seconds=save_s, gb_per_s=saved / save_s / 1e9,
                           bytes=saved, fwd_rel_l2=rels)
        print(f"hf_openai: save_hf {saved} bytes in {save_s:.2f}s "
              f"({saved / save_s / 1e9:.2f} GB/s) card={card}", flush=True)
        del p2, back
        shutil.rmtree(dir2)
        shutil.rmtree(dir3)
        gc.collect()
        torch.cuda.empty_cache()

        # 4. the OpenAI surface over an engine on the loaded tree
        eng = GenerationEngine(loaded, lcfg, auto_prefix=True, device="cuda",
                               **FEATURE_GRID).start()
        app, chat_app = OpenAIApp(eng), OpenAIApp(eng, ByteTokenizer())
        rng = np.random.default_rng(HF_FWD_SEED)

        def prompt(n):
            return rng.integers(0, cfg.vocab_size, n).tolist()

        for n in (100, 200, 400, 800, 1500):     # warm-up, not counted
            eng.generate(prompt(n), 2)

        def complete(p, **kw):
            body = dict(prompt=p, max_tokens=MAX_NEW, temperature=0)
            body.update(kw)
            return api_ok("hf_openai", *app._serve(body, chat=False))

        prompts = [prompt(n) for n in ENGINE_PROMPT_LENS]
        seq, got = counted(torch, "hf_openai sequential", launches, eng,
                           len(prompts), L,
                           lambda: [complete(p, logprobs=1) for p in prompts])
        add(got)
        seq_ids = [r["choices"][0]["token_ids"] for r in seq]
        seq_lps = [r["choices"][0]["logprobs"]["token_logprobs"] for r in seq]
        for r in seq:
            c = r["choices"][0]
            if (len(c["token_ids"]) != MAX_NEW or c["finish_reason"] != "length"
                    or r["usage"]["completion_tokens"] != MAX_NEW):
                fail(f"hf_openai: sequential response {r}")
        direct, got = counted(
            torch, "hf_openai engine.generate", launches, eng, len(API_PARITY),
            L, lambda: [eng.generate(prompts[i], MAX_NEW, temperature=0)
                        for i in API_PARITY])
        add(got)
        same = [seq_ids[i] == d for i, d in zip(API_PARITY, direct)]
        print(f"hf_openai: sequential completions == engine.generate: {same}",
              flush=True)
        if not all(same):
            fail("hf_openai: the API's greedy tokens differ from engine.generate")

        # streaming, logprobs, a token-id stop
        def streamed():
            status, stream = app._serve(dict(prompt=prompts[0],
                                             max_tokens=MAX_NEW, temperature=0,
                                             stream=True), chat=False)
            api_ok("hf_openai stream", status, stream)
            return list(stream)

        def handle_logprobs():
            h = eng.submit(prompts[0], MAX_NEW, temperature=0)
            return h.result(), h.logprobs

        (chunks, (h_ids, h_lps), stopped), got = counted(
            torch, "hf_openai stream/logprobs/stop", launches, eng, 3, L,
            lambda: (streamed(), handle_logprobs(),
                     complete(prompts[0], stop=[seq_ids[0][2:4]])))
        add(got)
        s_ids = [t for c in chunks for t in c["choices"][0]["token_ids"]]
        finish = chunks[-1]["choices"][0]["finish_reason"]
        c = stopped["choices"][0]
        print(f"hf_openai: stream of {len(chunks)} chunks == blocking: "
              f"{s_ids == seq_ids[0]} (finish {finish}); logprobs == the "
              f"handle's: {seq_lps[0] == h_lps} (ids {h_ids == seq_ids[0]}); "
              f"token-id stop {seq_ids[0][2:4]} -> {c['token_ids']} "
              f"{c['finish_reason']}", flush=True)
        if s_ids != seq_ids[0] or finish != "length":
            fail("hf_openai: streamed chunks differ from the blocking call")
        if seq_lps[0] != h_lps or h_ids != seq_ids[0]:
            fail("hf_openai: logprobs differ from the handle's")
        if (c["finish_reason"] != "stop" or c["token_ids"][-2:] != seq_ids[0][2:4]
                or c["token_ids"] != seq_ids[0][:len(c["token_ids"])]):
            fail(f"hf_openai: token-id stop gave {c}")

        # chat through the stand-in tokenizer; seeded n = 2
        messages = [{"role": "user", "content": "Name three prime numbers."}]
        chat_prompt = chat_app._chat_prompt(messages)

        def chat_and_seeds():
            chat = api_ok("hf_openai chat", *chat_app._serve(
                dict(messages=messages, max_tokens=16, temperature=0),
                chat=True))
            seeded = [api_ok("hf_openai seeded", *app._serve(
                dict(prompt=prompts[1], max_tokens=16, temperature=1.0, n=2,
                     seed=11), chat=False)) for _ in range(2)]
            return chat, seeded

        (chat, seeded), got = counted(torch, "hf_openai chat/seeds", launches,
                                      eng, 5, L, chat_and_seeds)
        add(got)
        msg = chat["choices"][0]["message"]
        runs = [[tuple(c["token_ids"]) for c in r["choices"]] for r in seeded]
        print(f"hf_openai: chat ({len(chat_prompt)}-token prompt) -> "
              f"{len(msg['token_ids'])} token_ids, object {chat['object']}; "
              f"seeded n=2 reproducible {runs[0] == runs[1]}, distinct "
              f"{runs[0][0] != runs[0][1]}", flush=True)
        if (chat["object"] != "chat.completion" or len(msg["token_ids"]) != 16
                or msg["content"] != chat_app._decode(msg["token_ids"])):
            fail(f"hf_openai: chat response {chat}")
        if runs[0] != runs[1] or runs[0][0] == runs[0][1]:
            fail(f"hf_openai: seeded n=2 choices {runs}")

        # concurrent load: the 12 prompts from 12 threads across 8 slots
        def concurrent():
            out = [None] * len(prompts)

            def one(i):
                out[i] = app._serve(dict(prompt=prompts[i], max_tokens=MAX_NEW,
                                         temperature=0, logprobs=1),
                                    chat=False)
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return out

        t = time.perf_counter()
        conc, got = counted(torch, "hf_openai concurrent", launches, eng,
                            len(prompts), L, concurrent)
        conc_s = time.perf_counter() - t
        add(got)
        equal, lp_diff = 0, 0.0
        for i, (status, r) in enumerate(conc):
            c = api_ok("hf_openai concurrent", status, r)["choices"][0]
            ids, lps = c["token_ids"], c["logprobs"]["token_logprobs"]
            if (len(ids) != MAX_NEW or c["finish_reason"] != "length"
                    or not all(0 <= x < cfg.vocab_size for x in ids)):
                fail(f"hf_openai: concurrent response {i}: {c}")
            if ids[0] != seq_ids[i][0]:
                fail(f"hf_openai: concurrent request {i}'s first token "
                     f"{ids[0]} != sequential {seq_ids[i][0]}")
            lp_diff = max(lp_diff, abs(lps[0] - seq_lps[i][0]))
            equal += ids == seq_ids[i]
        print(f"hf_openai: 12 concurrent requests in {conc_s:.2f}s: first "
              f"tokens == sequential, first logprobs max |diff| {lp_diff} "
              f"(tol {API_FIRST_LP_ABS}); {equal} of 12 continuations equal",
              flush=True)
        if not lp_diff <= API_FIRST_LP_ABS:
            fail(f"hf_openai: first logprobs differ by {lp_diff}")
        rec["concurrent"] = dict(seconds=conc_s, equal_continuations=equal,
                                 first_lp_max_abs=lp_diff)

        # a registered 1000-token prefix, matched by auto_prefix
        prefix, suffix = prompt(PREFIX_LEN), prompt(API_PREFIX_SUFFIX)

        def prefixed():
            one = complete(prefix + suffix, max_tokens=4)
            reg = api_ok("hf_openai prefix", *app.add_prefix({"tokens": prefix}))
            hits = eng._prefix_hits
            hit = complete(prefix + suffix, max_tokens=4)
            return one, reg, eng._prefix_hits - hits, hit

        (one, reg, hits, hit), got = counted(torch, "hf_openai prefix",
                                             launches, eng, 2, L, prefixed)
        add(got)
        pid = reg["prefix_id"]
        gone, again = app.remove_prefix(pid), app.remove_prefix(pid)
        first = (one["choices"][0]["token_ids"][0],
                 hit["choices"][0]["token_ids"][0])
        print(f"hf_openai: prefix {reg} hits {hits}; first token one-shot / "
              f"through the prefix {first}; unregister {gone}, again {again}",
              flush=True)
        if reg["n_tokens"] != PREFIX_LEN or hits != 1 or first[0] != first[1]:
            fail("hf_openai: the prefix path's first token differs")
        if gone != (200, {"deleted": pid}) or again != (404, {"error": {
                "message": f"unknown prefix_id {pid}", "type": "not_found",
                "param": None, "code": None}}):
            fail(f"hf_openai: unregister gave {gone}, {again}")

        # embeddings against the pooled plain-attention hidden states
        inputs = [prompt(n) for n in API_EMBED_LENS]

        def embed_each():
            out = []
            for ids in inputs:
                t = time.perf_counter()
                r = api_ok("hf_openai embeddings", *app.embed({"input": ids}))
                out.append((r, (time.perf_counter() - t) * 1e3))
            return out

        embs, got = counted(torch, "hf_openai embeddings", launches, eng,
                            len(inputs), L, embed_each)
        add(got)
        both = api_ok("hf_openai embeddings", *app.embed({"input": inputs}))
        cfg_x = dataclasses.replace(lcfg, attn_impl="xla")
        rels, ms = [], [m for _, m in embs]
        for i, (ids, (r, _)) in enumerate(zip(inputs, embs)):
            e = torch.tensor(r["data"][0]["embedding"], device="cuda")
            with torch.no_grad():
                want = llama_hidden(loaded, torch.tensor([ids], device="cuda"),
                                    cfg_x).float().mean(dim=1)[0]
            if not (torch.isfinite(e).all() and e.shape == (cfg.dim,)):
                fail("hf_openai: an embedding is not finite or misshapen")
            if r["usage"]["prompt_tokens"] != len(ids):
                fail(f"hf_openai: embeddings usage {r['usage']}")
            if both["data"][i]["embedding"] != r["data"][0]["embedding"]:
                fail("hf_openai: a 3-input body's embedding differs from "
                     "the same input alone")
            rels.append(float((e - want).norm() / want.norm()))
        print(f"hf_openai: embeddings of {API_EMBED_LENS} tokens vs pooled "
              f"plain-attention hidden states rel L2 {rels} tol "
              f"{LOGITS_REL_L2}; ms per input {ms}", flush=True)
        if not max(rels) <= LOGITS_REL_L2:
            fail(f"hf_openai: embeddings differ from the plain path: {rels}")
        rec["embeddings"] = dict(rel_l2=rels, ms=ms, tokens=API_EMBED_LENS)

        # the JSON layer's cost: time to the first SSE chunk against a
        # direct submit's first token, alternating
        p200 = prompt(200)

        def first_times():
            direct, api = [], []
            for _ in range(API_TTFC_REPS):
                t = time.perf_counter()
                h = eng.submit(p200, 8, temperature=0)
                it = iter(h)
                next(it)
                direct.append(time.perf_counter() - t)
                list(it)
                t = time.perf_counter()
                _, stream = app._serve(dict(prompt=p200, max_tokens=8,
                                            temperature=0, stream=True),
                                       chat=False)
                it = iter(stream)
                next(it)
                api.append(time.perf_counter() - t)
                list(it)
            return direct, api

        (direct_s, api_s), got = counted(torch, "hf_openai first chunk",
                                         launches, eng, 2 * API_TTFC_REPS, L,
                                         first_times)
        add(got)

        # 8 streams of 40-token prompts, through the surface and alone
        short = [prompt(40) for _ in range(8)]

        def engine_streams():
            hs = [eng.submit(p, API_STREAM_NEW, temperature=0) for p in short]
            threads, times = stream_times(hs)
            for th in threads:
                th.join()
            return times, [h.result() for h in hs]

        def api_streams():
            times = [[] for _ in short]
            ids = [[] for _ in short]
            streams = [app._serve(dict(prompt=p, max_tokens=API_STREAM_NEW,
                                       temperature=0, stream=True),
                                  chat=False)[1] for p in short]

            def drain(s, ts, out):
                for c in s:
                    if c["choices"][0]["token_ids"]:
                        ts.append(time.perf_counter())
                        out += c["choices"][0]["token_ids"]
            threads = [threading.Thread(target=drain, args=a)
                       for a in zip(streams, times, ids)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return times, ids

        (e_times, e_ids), got = counted(torch, "hf_openai engine streams",
                                        launches, eng, 8, L, engine_streams)
        add(got)
        (a_times, a_ids), got = counted(torch, "hf_openai API streams",
                                        launches, eng, 8, L, api_streams)
        add(got)
        e_rate, a_rate = stream_window_rate(e_times), stream_window_rate(a_times)
        print(f"hf_openai: first SSE chunk {sorted(api_s)} s vs direct submit "
              f"{sorted(direct_s)} s (200-token prompt, idle grid); 8 streams "
              f"x {API_STREAM_NEW} tokens: through the surface {a_rate:.1f} "
              f"tok/s, the engine alone {e_rate:.1f} tok/s, equal tokens "
              f"{a_ids == e_ids} card={card}", flush=True)
        if any(len(x) != API_STREAM_NEW for x in a_ids + e_ids):
            fail("hf_openai: a stream came back short")
        rec["json_layer"] = dict(
            first_chunk_s=sorted(api_s), direct_first_token_s=sorted(direct_s),
            api_tok_per_s=a_rate, engine_tok_per_s=e_rate)
        eng.stop()
        del eng, app, chat_app, loaded
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rec["launches"] = totals
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"hf_openai: phase wall {rec['wall_s']:.1f}s, launches {totals}",
          flush=True)
    return totals, rec


def check_vit_kernels(torch, F, ops_attn, card):
    """A1 with its LSE, A2 and A3, non-causal, at ViT-B/16's attention shape
    (B=VIT_B, S=196, N=NKV=12, Hd=64, bf16): every row of out, LSE, dQ, dK
    and dV against the plain versions (S = 196 is a ragged tile in both q
    and k: the kernels must load zeros past S, store nothing there, and
    keep the LSE and delta of rows past S out of A2 and A3). Then times in
    a CUDA graph, warm and with the inputs cold in L2, beside the plain
    versions, SDPA non-causal (forward; backward as dQ dK dV together) and
    the bound, with the operations counted non-causally (4 B N S² Hd for
    A1). Returns the kernels-line records."""
    from kubetorch_tpu_torch.ops.tolerance import LSE_ATOL
    b, s, nh, hd = VIT_B, VIT_S, 12, 64
    shape = f"B={b} S={s} N={nh} NKV={nh} Hd={hd}"
    scale = hd ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (torch.randn(b, s, nh, hd, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = ops_attn._launch(q, k, v, False, scale, need_lse=True)
    want_out, want_lse = ops_attn.flash_attention_fwd_ref(q, k, v, causal=False)
    errs = {"fwd": compare(f"flash_fwd+lse {shape} non-causal", out, want_out)}
    lse_err = float((lse - want_lse).abs().max())
    print(f"check flash_fwd lse {shape} non-causal: max_abs_err={lse_err} "
          f"atol={LSE_ATOL}", flush=True)
    if not lse_err <= LSE_ATOL:
        fail(f"flash_fwd lse {shape} non-causal: {lse_err} > {LSE_ATOL}")
    del want_out, want_lse
    delta = ops_attn.attention_delta(out, do)
    kw = dict(causal=False, scale=scale)
    dq = ops_attn.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    errs["dq"] = compare_grad(f"flash_bwd_dq {shape} non-causal", dq,
                              ops_attn.flash_attention_bwd_dq_ref(
                                  q, k, v, do, lse, delta, **kw))
    dk, dv = ops_attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = ops_attn.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                            delta, **kw)
    ek = compare_grad(f"flash_bwd_dk {shape} non-causal", dk, want_dk)
    ev = compare_grad(f"flash_bwd_dv {shape} non-causal", dv, want_dv)
    errs["dkv"] = (max(ek[0], ev[0]), max(ek[1], ev[1]))
    del dq, dk, dv, want_dk, want_dv
    torch.cuda.empty_cache()

    def fwd(q, k, v):
        return ops_attn._launch(q, k, v, False, scale, need_lse=True)

    def bwd_dq(q, k, v, do, lse, delta):
        return ops_attn.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)

    def bwd_dkv(q, k, v, do, lse, delta):
        return ops_attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

    bwd_in = (q, k, v, do, lse, delta)
    kernels = {"fwd": (fwd, (q, k, v), lambda: ops_attn.flash_attention_fwd_ref(
                   q, k, v, causal=False)),
               "dq": (bwd_dq, bwd_in, lambda: ops_attn.flash_attention_bwd_dq_ref(
                   *bwd_in, **kw)),
               "dkv": (bwd_dkv, bwd_in, lambda: ops_attn.flash_attention_bwd_dkv_ref(
                   *bwd_in, **kw))}
    lib_fwd, lib_bwd = sdpa_times(torch, F, q, k, v, do, causal=False)
    lib = {"fwd": (lib_fwd, "SDPA forward, non-causal"),
           "dq": (lib_bwd, "SDPA backward, dQ dK dV, non-causal"),
           "dkv": (lib_bwd, "SDPA backward, dQ dK dV, non-causal")}
    pairs = b * nh * s * s
    qb, stat = b * s * nh * hd * 2, b * nh * s * 4
    work = {"fwd": (4 * qb + stat, 4 * hd * pairs),
            "dq": (5 * qb + 2 * stat, 6 * hd * pairs),
            "dkv": (6 * qb + 2 * stat, 8 * hd * pairs)}
    recs = {}
    for name, (fn, inputs, plain_fn) in kernels.items():
        ms = time_ms(torch, lambda: fn(*inputs))
        cold = time_cold_ms(torch, fn, inputs)
        plain = time_ms(torch, plain_fn, iters=5)
        nbytes, flops = work[name]
        b_ms, b_by = bound(nbytes, flops)
        rate = rate_line(flops, ms, b_ms)
        lib_ms, lib_name = lib[name]
        print(f"kernel flash_{name} {shape} bf16 non-causal (ViT-B/16): "
              f"ms={ms} cold_ms={cold} plain_ms={plain} library_ms={lib_ms} "
              f"({lib_name}) bound_ms={b_ms} ({b_by}; {nbytes} bytes, {flops} "
              f"flops) tflops={rate['tflops']} bound_share={rate['bound_share']}"
              f" cold_bound_share={b_ms / cold} card={card}", flush=True)
        recs[name] = dict(max_abs_err=errs[name][0],
                          max_row_rel_err=errs[name][1], ms=ms, cold_ms=cold,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms, bytes=nbytes, flops=flops, **rate,
                          shape=f"{shape} bf16 non-causal")
    recs["fwd"]["max_abs_err_lse"] = lse_err
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return recs


def drive_vit(torch, ops_attn, card):
    """ViT-B/16 at full width and depth ("vit"): bf16, remat (the port's
    "dots"), weights from a seed, VIT_B seeded 224² images with 1000-class
    labels. The forward: logits finite and within LOGITS_REL_L2 of the
    plain attention path, exactly 12 A1 launches a forward, images/s.
    Training: vit_loss through make_train_step with adamw, VIT_STEPS steps
    on the one batch fed through prefetch_to_device: the loss falls, the
    step-0 loss is within LOSS_ABS of the plain path's on the same params,
    exactly 2L A1, L A2 and L A3 launches a step; images/s (steps 2 on)
    and peak memory; a 2-step profile. Then fp32 gradients at
    VIT_GRAD_LAYERS layers, kernel path against plain path, within
    GRAD_REL_L2 per leaf. Returns the phase's record."""
    from kubetorch_tpu_torch.models.vit import (VitConfig, vit_forward,
                                                vit_init, vit_loss)
    from kubetorch_tpu_torch.train import (adamw, init_train_state,
                                           make_train_step, prefetch_to_device)
    from kubetorch_tpu_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    cfg = VitConfig.vit_b16()
    L = cfg.n_layers
    params = vit_init(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"vit: ViT-B/16, params {n_params} (param_count "
          f"{cfg.param_count()}), {cfg.dtype}, remat "
          f"{'dots' if cfg.remat else 'none'}, batch {VIT_B} x "
          f"{cfg.image_size}² ({cfg.n_patches} patches, head dim "
          f"{cfg.head_dim}, non-causal)", flush=True)
    if n_params != cfg.param_count():
        fail(f"vit: {n_params} params, param_count says {cfg.param_count()}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    images = torch.randn(VIT_B, cfg.image_size, cfg.image_size, cfg.channels,
                         generator=gen, device="cuda")
    labels = torch.randint(0, cfg.n_classes, (VIT_B,), generator=gen,
                           device="cuda")
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    fa = ops_attn.flash_attention

    vit_forward(params, images, cfg)                   # warm-up
    torch.cuda.synchronize()
    fa.launches = 0
    t = time.perf_counter()
    for _ in range(VIT_FWD_REPS):
        logits = vit_forward(params, images, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    fwd_n = fa.launches
    check_launches(f"vit forward (A1) over {VIT_FWD_REPS} forwards", fwd_n,
                   L * VIT_FWD_REPS)
    plain = vit_forward(params, images, plain_cfg)
    if tuple(logits.shape) != (VIT_B, cfg.n_classes) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"vit: logits {tuple(logits.shape)} not finite or misshapen")
    rel = float((logits - plain).norm() / plain.norm())
    fwd_ips = VIT_B * VIT_FWD_REPS / dt
    print(f"vit: forward logits kernel vs plain path rel_l2={rel} tol="
          f"{LOGITS_REL_L2}; images_per_s={fwd_ips} (batch {VIT_B}, "
          f"{VIT_FWD_REPS} forwards) card={card}", flush=True)
    if not rel <= LOGITS_REL_L2:
        fail(f"vit: kernel-path logits differ from the plain path: {rel}")
    with torch.no_grad():
        loss_plain0 = float(vit_loss(params, images, labels, plain_cfg))
    del logits, plain

    opt = adamw(VIT_LR)
    state = init_train_state(params, opt)
    del params
    step = make_train_step(lambda p, x, y: vit_loss(p, x, y, cfg), opt)
    host = {"tokens": images.cpu(), "targets": labels.cpu()}
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, t1 = [], None
    for i, b in enumerate(prefetch_to_device(itertools.repeat(host, VIT_STEPS),
                                             size=2)):
        if i == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    print(f"vit: losses {losses}; plain-path step-0 loss {loss_plain0}",
          flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"vit: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"vit: loss did not fall: first {losses[0]}, last {losses[-1]}")
    diff = abs(losses[0] - loss_plain0)
    print(f"vit: step-0 loss kernel vs plain path |diff|={diff} tol={LOSS_ABS}",
          flush=True)
    if not diff <= LOSS_ABS:
        fail(f"vit: step-0 loss differs from the plain path by {diff}")
    check_launches(f"vit train (A1, A2, A3) over {VIT_STEPS} steps", counts,
                   (2 * L * VIT_STEPS, L * VIT_STEPS, L * VIT_STEPS))
    train_ips = VIT_B * (VIT_STEPS - 1) / dt
    print(f"vit: train images_per_s={train_ips} ms_per_step="
          f"{dt / (VIT_STEPS - 1) * 1e3} (steps 2-{VIT_STEPS}) peak_memory_gb="
          f"{peak_gb} batch={VIT_B} card={card}", flush=True)
    batch = {"tokens": images, "targets": labels}

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    profile_steps(torch, f"2 ViT-B/16 train steps, batch {VIT_B}", one_step, 2,
                  groups={"flash A1-A3": FLASH_KERNEL_NAMES,
                          "GEMMs": ("gemm", "nvjet", "xmma")})

    small = dataclasses.replace(cfg, n_layers=VIT_GRAD_LAYERS,
                                dtype=torch.float32)
    small_params = vit_init(3, small, device="cuda")
    sb = {"tokens": images[:VIT_GRAD_B], "targets": labels[:VIT_GRAD_B]}
    grads = {}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(small, attn_impl=impl)
        _, grads[impl] = make_train_step(
            lambda p, x, y: vit_loss(p, x, y, c)).loss_and_grads(small_params, sb)
    worst = max(float((a - b).norm() / b.norm())
                for a, b in zip(tree_leaves(grads["auto"]),
                                tree_leaves(grads["xla"])))
    print(f"vit: grads kernel vs plain path, fp32, {VIT_GRAD_LAYERS} layers, "
          f"batch {VIT_GRAD_B}: max per-leaf rel_l2={worst} tol={GRAD_REL_L2}",
          flush=True)
    if not worst <= GRAD_REL_L2:
        fail(f"vit: kernel-path grads differ from the plain path: {worst}")
    del grads, small_params
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"vit: phase wall {wall:.1f}s", flush=True)
    rec = dict(launches=counts, launches_forward=fwd_n,
               per_forward=fwd_n // VIT_FWD_REPS,
               per_train_step=tuple(n // VIT_STEPS for n in counts),
               forward_images_per_s=fwd_ips, train_images_per_s=train_ips,
               ms_per_step=dt / (VIT_STEPS - 1) * 1e3, peak_memory_gb=peak_gb,
               losses=losses, logits_rel_l2=rel, grad_rel_l2=worst,
               wall_s=wall)
    return rec


def free_tcp_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def drive_fabric(card):
    """The port as a fabric workload on the card ("fabric"). A process that
    imports the port and never touches CUDA reads no gauges. Then one torch
    rank, started as the fabric starts one (a process of its own, with the
    keys its PyTorchEnv injects: TORCH_RANK_ENV and a free MASTER_PORT),
    runs fabric_rank. Its output is echoed; it fails the phase by exiting
    non-zero. Returns the rank's launch counts and the phase's record."""
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    probe = subprocess.run([sys.executable, "-c", GAUGE_PROBE],
                           env=dict(os.environ, PYTHONPATH=here),
                           capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        fail(f"fabric: the gauge probe failed: {probe.stderr[-1500:]}")
    seen = json.loads(probe.stdout.strip().splitlines()[-1])
    print(f"fabric: a process that never used CUDA: {seen}", flush=True)
    if seen != {"gauges": {}, "cuda_initialized": False}:
        fail(f"fabric: gpu_gauges() in a fresh process read {seen}")

    env = dict(TORCH_RANK_ENV, MASTER_PORT=str(free_tcp_port()))
    print(f"fabric: starting a torch rank with {env}", flush=True)
    rank = subprocess.run([sys.executable, os.path.abspath(__file__),
                           FABRIC_RANK_FLAG],
                          env=dict(os.environ, PYTHONPATH=here, **env),
                          capture_output=True, text=True, timeout=600)
    out = rank.stdout.strip().splitlines()
    for line in out[:-1]:
        print(line, flush=True)
    if rank.returncode != 0:
        fail(f"fabric: the torch rank exited {rank.returncode}: "
             f"{rank.stderr[-3000:]}")
    rec = json.loads(out[-1])
    counts = tuple(rec["launches"])
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"fabric: phase wall {rec['wall_s']:.1f}s card={card}", flush=True)
    return counts, rec


def fabric_rank() -> None:
    """One torch rank of the "fabric" phase, in a process of its own:
    distributed.init_process_group() from the injected env (nccl on
    cuda:0); ViT-B/16 from a seed, one warm step, then 2 steps with the
    loss all_reduced over NCCL (bitwise the unreduced loss at world 1),
    captured by serving.profile.capture: the trace's A1/A2/A3 kernel events
    equal the launch counters; host_view of the trained bf16 params back
    through from_host bitwise; gpu_gauges() against torch.cuda.memory_stats
    and mem_get_info read in the same place. The group is destroyed in a
    finally. Prints the rank's record as its last line."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("fabric rank: torch.cuda.is_available() is false")
    from kubetorch_tpu_torch.models.vit import VitConfig, vit_init, vit_loss
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.serving import (capture, distributed, from_host,
                                             gpu_gauges, host_view)
    from kubetorch_tpu_torch.train import (adamw, init_train_state,
                                           make_train_step)
    from kubetorch_tpu_torch.train.optim import tree_leaves

    env = {k: os.environ.get(k) for k in (*TORCH_RANK_ENV, "MASTER_PORT")}
    trace_dir = tempfile.mkdtemp(prefix="kt-fabric-profile-")
    try:
        distributed.init_process_group()
        try:
            backend = dist.get_backend()
            print(f"fabric: init_process_group from {env}: backend {backend}, "
                  f"world {dist.get_world_size()}, rank {dist.get_rank()}, "
                  f"device cuda:{torch.cuda.current_device()}", flush=True)
            if backend != "nccl" or torch.cuda.current_device() != 0:
                fail(f"fabric: backend {backend} on cuda:"
                     f"{torch.cuda.current_device()}, expected nccl on cuda:0")
            cfg = VitConfig.vit_b16()
            opt = adamw(VIT_LR)
            state = init_train_state(vit_init(0, cfg, device="cuda"), opt)
            step = make_train_step(lambda p, x, y: vit_loss(p, x, y, cfg), opt)
            gen = torch.Generator(device="cuda").manual_seed(13)
            batch = {"tokens": torch.randn(VIT_B, cfg.image_size,
                                           cfg.image_size, cfg.channels,
                                           generator=gen, device="cuda"),
                     "targets": torch.randint(0, cfg.n_classes, (VIT_B,),
                                              generator=gen, device="cuda")}
            state, _ = step(state, batch)                  # warm-up
            torch.cuda.synchronize()
            losses, reduced = [], []

            def two_steps():
                nonlocal state
                for _ in range(2):
                    state, m = step(state, batch)
                    r = m["loss"].clone()
                    dist.all_reduce(r)
                    losses.append(m["loss"])
                    reduced.append(r)
            fa = ops_attn.flash_attention
            fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            prof = capture(two_steps, outdir=trace_dir)
            counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
            L = len(state.params["layers"]["wqkv"])
            check_launches("fabric: 2 ViT steps (A1, A2, A3)", counts,
                           (4 * L, 2 * L, 2 * L))
            sizes = {os.path.basename(f): os.path.getsize(f)
                     for f in prof["files"]}
            in_trace = kernel_counts(prof["files"][0], FLASH_KERNEL_NAMES)
            lost = lost_kernel_records(prof["files"][0])
            print(f"fabric: profile.capture wrote {sizes} in "
                  f"{prof['trace_dir']}; kernel events {in_trace}; launches "
                  f"without a kernel event {len(lost)} {lost[:8]}", flush=True)
            if tuple(in_trace[n] for n in FLASH_KERNEL_NAMES) != counts:
                fail(f"fabric: the trace's kernel events {in_trace} differ "
                     f"from the launch counters {counts}")
            same = [bool(torch.equal(a, b)) for a, b in zip(reduced, losses)]
            print(f"fabric: losses {[float(x) for x in losses]}; all_reduce "
                  f"over NCCL at world 1 bitwise equal: {same}", flush=True)
            if not all(same):
                fail("fabric: the all_reduced loss differs from the loss")

            host = host_view(state.params)
            kinds = sorted({str(a.dtype) for a in tree_leaves(host)})
            print(f"fabric: host_view of the trained params: "
                  f"{sum(a.nbytes for a in tree_leaves(host))} bytes on the "
                  f"host as {kinds}", flush=True)
            back = from_host(host, state.params)
            check_tree_bitwise(torch, "fabric: host_view -> from_host", back,
                               state.params)
            del back, host

            torch.cuda.synchronize()
            gauges = gpu_gauges()
            in_use = torch.cuda.memory_stats(0)["allocated_bytes.all.current"]
            total = torch.cuda.mem_get_info(0)[1]
            want = {'kt_gpu_hbm_bytes_in_use{device="0"}': float(in_use),
                    'kt_gpu_hbm_bytes_limit{device="0"}': float(total)}
            print(f"fabric: gpu_gauges {gauges}; memory_stats "
                  f"allocated_bytes.all.current {in_use}, mem_get_info total "
                  f"{total}", flush=True)
            if gauges != want:
                fail(f"fabric: gpu_gauges {gauges} != {want}")
        finally:
            distributed.destroy()
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    if dist.is_initialized():
        fail("fabric: the process group outlived its phase")
    print(json.dumps(dict(launches=counts, trace_kernel_events=in_trace,
                          trace_lost_kernel_records=len(lost),
                          trace_bytes=sum(sizes.values()))), flush=True)


def run_rank(label, flag, env, timeout=600):
    """This script again as rank 0 of a world of 1 (``flag``), with
    TORCH_RANK_ENV, a free MASTER_PORT and ``env``: its output but the last
    line printed, its last line (the record) returned. A rank that exits
    non-zero fails the phase."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(TORCH_RANK_ENV, MASTER_PORT=str(free_tcp_port()), **env)
    print(f"{label}: starting a torch rank with {env}", flush=True)
    rank = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          env=dict(os.environ, PYTHONPATH=here, **env),
                          capture_output=True, text=True, timeout=timeout)
    out = rank.stdout.strip().splitlines()
    for line in out[:-1]:
        print(line, flush=True)
    if rank.returncode != 0:
        fail(f"{label}: the torch rank exited {rank.returncode}: "
             f"{rank.stderr[-3000:]}")
    return json.loads(out[-1])


def drive_mesh(card):
    """The training step on a device mesh ("mesh"): the script started
    again as a torch rank (MESH_RANK_FLAG), as drive_fabric starts one,
    with TORCH_RANK_ENV, a free MASTER_PORT and MESH_ENV; mesh_rank does
    the work and fails the phase by exiting non-zero. Returns the mesh
    run's A1/A2/A3 launches and the phase's record."""
    t_phase = time.perf_counter()
    rec = run_rank("mesh", MESH_RANK_FLAG, MESH_ENV)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"mesh: phase wall {rec['wall_s']:.1f}s card={card}", flush=True)
    return tuple(rec["launches"]["mesh"]), rec


def first_parting_op(torch, run_a, run_b):
    """The first aten op whose output differs between two runs of the same
    computation (each a no-argument callable), as (index, name a, name b),
    or None when every output agrees bit for bit. DTensor outputs are read
    through their local shard (at a world of 1, the whole tensor)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            t = out[0] if isinstance(out, (tuple, list)) and out else out
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                local = t.to_local() if hasattr(t, "to_local") else t
                self.seen.append((str(func), local.detach().float().clone()))
            return out

    recs = []
    for run in (run_a, run_b):
        with Record() as rec:
            run()
        recs.append(rec.seen)
    for i, ((na, ta), (nb, tb)) in enumerate(zip(*recs)):
        if na != nb or ta.shape != tb.shape or not torch.equal(ta, tb):
            return i, na, nb
    return None


def mesh_rank() -> None:
    """One torch rank of the "mesh" phase: distributed.init_process_group()
    (nccl) and distributed.mesh() from KT_MESH; Llama-3.2-1B's shape at
    full width and depth (the "train" phase's config: bf16, remat "dots",
    TRAIN_B x TRAIN_S, chunked CE of TRAIN_CHUNK, default_optimizer).
    MESH_STEPS steps through make_train_step(mesh=, rules=LLAMA_RULES),
    the state freed, then MESH_STEPS plain steps from the same seed and
    batch. Gates: every param and optimizer leaf a DTensor on the mesh in
    the rules' placements; losses, grad norms and the last params of the
    two runs bitwise equal (else the first parting op is named and the
    losses must agree within LOSS_ABS); A1/A2/A3 exactly 2L/L/L a step in
    both runs; "ring" and "ulysses" forwards (context dead at a world of 1:
    the flash fallback) bitwise the "flash" forward, L A1 launches each.
    Prints ms/step, the busy share of a profiled step and peak memory for
    each run; the group is destroyed in a finally. The record is the last
    line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("mesh rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.distributed.tensor import DTensor

    from kubetorch_tpu_torch.models.llama import (LlamaConfig, llama_forward,
                                                  llama_init,
                                                  llama_loss_chunked)
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.parallel import LLAMA_RULES
    from kubetorch_tpu_torch.parallel.mesh_context import use_mesh
    from kubetorch_tpu_torch.parallel.sharding import (to_dtensor, tree_paths)
    from kubetorch_tpu_torch.serving import distributed
    from kubetorch_tpu_torch.train import (default_optimizer,
                                           init_train_state, make_train_step)
    from kubetorch_tpu_torch.train.optim import tree_leaves, tree_map

    fa = ops_attn.flash_attention
    cfg = LlamaConfig.llama3_1b(max_seq_len=TRAIN_S)
    L = cfg.n_layers
    opt = default_optimizer(warmup_steps=2)

    def loss_fn(p, t, y):
        return llama_loss_chunked(p, t, y, cfg, chunk=TRAIN_CHUNK)

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    audit = hbm_audit_phase(fa)      # fake process groups: before the real one
    distributed.init_process_group()
    try:
        mesh = distributed.mesh()
        print(f"mesh: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
              f"{dist.get_backend()}, world {dist.get_world_size()}", flush=True)
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            fail(f"mesh: backend {dist.get_backend()} on {mesh.device_type}")
        runs = {}
        for name, kw in (("mesh", dict(mesh=mesh, rules=LLAMA_RULES)),
                         ("plain", {})):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state = init_train_state(llama_init(cfg, seed=0, device="cuda"), opt)
            step = make_train_step(loss_fn, opt, **kw)
            if kw:
                state = step.shard_state(state)
                check_mesh_layout(state, mesh, tree_paths, DTensor)
                live_state = sum(
                    x.to_local().numel() * x.to_local().element_size()
                    for x in tree_leaves((state.params, state.opt_state)))
            fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            metrics, times = [], []
            for i in range(MESH_STEPS):
                torch.cuda.synchronize()
                if kw and i == 1:
                    # the audit's step: one warm step's peak
                    before_peak = torch.cuda.max_memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                if kw and i == 1:
                    step_peak = torch.cuda.max_memory_allocated()
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
            counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
            check_launches(f"mesh: {name} run, {MESH_STEPS} steps (A1, A2, A3)",
                           counts, (2 * L * MESH_STEPS, L * MESH_STEPS,
                                    L * MESH_STEPS))
            last = tree_map(lambda x: (x.full_tensor() if isinstance(x, DTensor)
                                       else x).cpu(), state.params)

            def one_step():
                nonlocal state
                state, _ = step(state, batch)

            prof = profile_steps(torch, f"mesh: {name} step, {MESH_PROFILED} "
                                 f"steps of {TRAIN_B}x{TRAIN_S}", one_step,
                                 MESH_PROFILED)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            if kw:
                peak = max(peak, before_peak / 1e9)
                check_hbm_audit(audit, live_state, step_peak)
            runs[name] = dict(metrics=metrics, launches=counts, last=last,
                              ms_per_step=[t * 1e3 for t in times],
                              ms_per_warm_step=sum(times[1:]) / (len(times) - 1) * 1e3,
                              profile=prof, peak_memory_gb=peak)
            print(f"mesh: {name} run: losses/grad norms {metrics}; ms/step "
                  f"{runs[name]['ms_per_step']}; peak_memory_gb={peak}",
                  flush=True)
            if kw:
                runs["impls"] = check_mesh_attention_impls(
                    torch, cfg, state.params, tokens[:1], mesh, fa,
                    llama_forward, to_dtensor, use_mesh)
            del state, step, m
            gc.collect()
            torch.cuda.empty_cache()

        a, b = runs["mesh"], runs["plain"]
        same_params = all(torch.equal(x, y) for x, y in
                          zip(tree_leaves(a["last"]), tree_leaves(b["last"])))
        bitwise = a["metrics"] == b["metrics"] and same_params
        print(f"mesh: mesh step vs plain step over {MESH_STEPS} steps: losses "
              f"and grad norms equal {a['metrics'] == b['metrics']}, last "
              f"params bitwise equal {same_params}", flush=True)
        parting = None
        if not bitwise:
            small = dataclasses.replace(cfg, n_layers=2)
            p0 = llama_init(small, seed=0, device="cuda")
            pm = make_train_step(loss_fn, opt, mesh=mesh,
                                 rules=LLAMA_RULES).shard_state(
                init_train_state(llama_init(small, seed=0, device="cuda"),
                                 opt)).params
            tb = to_dtensor(tokens, mesh, mesh_batch_placements(mesh))
            with use_mesh(mesh):
                parting = first_parting_op(
                    torch, lambda: llama_loss_chunked(p0, tokens, tokens.roll(-1, 1), small,
                                                      chunk=TRAIN_CHUNK),
                    lambda: llama_loss_chunked(pm, tb, tb.roll(-1, 1), small,
                                               chunk=TRAIN_CHUNK))
            diff = max(abs(x[0] - y[0]) for x, y in zip(a["metrics"], b["metrics"]))
            print(f"mesh: the runs part; first parting op (2 layers): {parting}; "
                  f"max loss |diff| {diff} tol {LOSS_ABS}", flush=True)
            if parting is None or not diff <= LOSS_ABS:
                fail(f"mesh: the mesh step differs from the plain step "
                     f"(parting op {parting}, loss diff {diff})")
        share = {k: (r["profile"] or {}).get("device_busy_share")
                 for k, r in (("mesh", a), ("plain", b))}
        print(f"mesh: ms_per_step (steps 2-{MESH_STEPS}) mesh "
              f"{a['ms_per_warm_step']} plain {b['ms_per_warm_step']}; first "
              f"step mesh {a['ms_per_step'][0]} plain {b['ms_per_step'][0]}; "
              f"device busy share mesh {share['mesh']} plain {share['plain']}; "
              f"peak_memory_gb mesh {a['peak_memory_gb']} plain "
              f"{b['peak_memory_gb']}", flush=True)
    finally:
        distributed.destroy()
    if dist.is_initialized():
        fail("mesh: the process group outlived its phase")
    rec = dict(launches={k: runs[k]["launches"] for k in ("mesh", "plain")},
               bitwise=bitwise, parting_op=parting,
               losses={k: [x[0] for x in runs[k]["metrics"]]
                       for k in ("mesh", "plain")},
               ms_per_step={k: runs[k]["ms_per_step"] for k in ("mesh", "plain")},
               ms_per_warm_step={k: runs[k]["ms_per_warm_step"]
                                 for k in ("mesh", "plain")},
               profile={k: runs[k]["profile"] for k in ("mesh", "plain")},
               peak_memory_gb={k: runs[k]["peak_memory_gb"]
                               for k in ("mesh", "plain")},
               impls=runs["impls"], hbm_audit=audit)
    print(json.dumps(rec), flush=True)


def hbm_audit_phase(fa) -> dict:
    """The "hbm_audit" phase, in the mesh rank before its process group:
    kubetorch_tpu_torch/train/hbm_audit.py on fake tensors, under fake
    process groups, with no weights built: the mesh phase's step (the 1B
    shape, TRAIN_B x TRAIN_S, a world of 1), then Llama-3-8B on an 8-way
    fsdp mesh (HBM_AUDIT_8B). No kernel may launch (the wrappers' fake
    path). Returns the reports and seconds; check_hbm_audit holds the 1B
    report to the live run."""
    from kubetorch_tpu_torch.train.hbm_audit import audit_llama, format_audit

    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    t = time.perf_counter()
    one = audit_llama("1b", batch=TRAIN_B, seq=TRAIN_S,
                      mesh_axes={"fsdp": 1}, device="cuda")
    one_s = time.perf_counter() - t
    t = time.perf_counter()
    b, s = HBM_AUDIT_8B
    eight = audit_llama("8b", batch=b, seq=s, mesh_axes={"fsdp": 8},
                        device="cuda")
    eight_s = time.perf_counter() - t
    launches = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    check_launches("hbm_audit: fake-tensor steps (A1, A2, A3)", launches,
                   (0, 0, 0))
    print(format_audit(one), flush=True)
    print(format_audit(eight), flush=True)
    print(f"hbm_audit: 1B on a world of 1 {one_s:.1f}s, 8B on fsdp 8 "
          f"({b}x{s}) {eight_s:.1f}s", flush=True)
    return dict(llama_1b=one, llama_8b_fsdp8=eight, seconds=dict(
        llama_1b=one_s, llama_8b_fsdp8=eight_s), launches=launches)


def check_hbm_audit(audit, live_state, step_peak) -> None:
    """The 1B audit against the mesh run: its params + opt_state bytes equal
    the live state's exactly, and its predicted peak (live_total) is within
    HBM_AUDIT_RATIO of torch.cuda.max_memory_allocated over one warm step."""
    b = audit["llama_1b"]["per_device_bytes"]
    state = b["params"] + b["opt_state"]
    ratio = step_peak / b["live_total"]
    audit.update(live_state_bytes=live_state, step_peak_bytes=step_peak,
                 peak_over_predicted=ratio)
    print(f"hbm_audit: 1B state {state} bytes predicted, {live_state} live; "
          f"peak {b['live_total']} predicted, {step_peak} over one warm step "
          f"(ratio {ratio:.3f}, allowed {HBM_AUDIT_RATIO})", flush=True)
    if state != live_state:
        fail(f"hbm_audit: predicted state {state} bytes, live {live_state}")
    if not HBM_AUDIT_RATIO[0] <= ratio <= HBM_AUDIT_RATIO[1]:
        fail(f"hbm_audit: a step's peak is {ratio:.3f}x the predicted peak")


def mesh_batch_placements(mesh):
    from kubetorch_tpu_torch.parallel.sharding import batch_sharding
    return batch_sharding(mesh).placements


def check_mesh_layout(state, mesh, tree_paths, DTensor):
    """Every param and optimizer leaf a DTensor on ``mesh`` in the rules'
    placements: params by LLAMA_RULES, the optimizer subtrees that mirror
    the params in each param's own, every other leaf replicated."""
    from kubetorch_tpu_torch.parallel import LLAMA_RULES
    from kubetorch_tpu_torch.parallel.sharding import named_sharding
    from kubetorch_tpu_torch.train.optim import tree_leaves, tree_map

    want_p = tree_map(lambda path: LLAMA_RULES.placements_for(path, mesh),
                      tree_paths(state.params))
    replicated = named_sharding(mesh).placements
    bad = []

    def check(x, want, where):
        if not isinstance(x, DTensor) or x.device_mesh != mesh or \
                list(x.placements) != list(want):
            bad.append(where)

    tree_map(lambda x, w, p: check(x, w, f"params/{p}"), state.params, want_p,
             tree_paths(state.params))
    n_opt = 0
    for path, leaf in zip(tree_leaves(tree_paths(state.opt_state)),
                          tree_leaves(state.opt_state)):
        n_opt += 1
        # adam's mu and nu mirror the params: "1/0/mu/layers/wq"
        moment = re.search(r"(?:^|/)(?:mu|nu)/(.+)$", path)
        want = (LLAMA_RULES.placements_for(moment.group(1), mesh) if moment
                else replicated)
        check(leaf, want, f"opt_state/{path}")
    check(state.step, replicated, "step")
    n = len(tree_leaves(state.params)) + n_opt + 1
    print(f"mesh: {n} state leaves (params, optimizer, step) DTensors on the "
          f"mesh in the rules' placements: {not bad} {bad[:6]}", flush=True)
    if bad:
        fail(f"mesh: leaves not laid out by the rules: {bad}")


def check_mesh_attention_impls(torch, cfg, params, tokens, mesh, fa,
                               llama_forward, to_dtensor, use_mesh):
    """At a world of 1 the context axis is dead: "ring" and "ulysses" fall
    back to the flash kernels (JAX's fallback), so their forwards over the
    mesh-sharded params are bitwise the "flash" forward, with L A1
    launches each."""
    tb = to_dtensor(tokens, mesh, mesh_batch_placements(mesh))
    out, counts = {}, {}
    with use_mesh(mesh):
        for impl in ("flash", "ring", "ulysses"):
            fa.launches = 0
            logits = llama_forward(params, tb,
                                   dataclasses.replace(cfg, attn_impl=impl))
            torch.cuda.synchronize()
            counts[impl] = fa.launches
            out[impl] = logits.to_local() if hasattr(logits, "to_local") else logits
    same = {impl: bool(torch.equal(out[impl], out["flash"]))
            for impl in ("ring", "ulysses")}
    finite = bool(torch.isfinite(out["flash"]).all())
    print(f"mesh: forwards of {tuple(tokens.shape)} tokens by attn_impl: A1 "
          f"launches {counts}; ring/ulysses bitwise the flash forward {same}; "
          f"finite {finite}", flush=True)
    if counts != {k: cfg.n_layers for k in counts} or not all(same.values()) \
            or not finite:
        fail(f"mesh: ring/ulysses at a world of 1: launches {counts}, "
             f"bitwise {same}, finite {finite}")
    return dict(launches=counts, bitwise=same)


def check_decode_partial(torch, F, ops_dec, quant: bool) -> dict:
    """The partial mode of B1 (``quant`` False) or B2 at PARTIAL_SHAPES:
    one context-parallel decode attention over CONTEXT_SHARDS emulated
    cache shards in one process (a partial launch per shard, then the
    shards' combine, ``ops_dec.combine_partials``: the reduction
    ``sp_decode_attention`` runs across ranks), its partial launches
    counted (``emulated_launches``; the kernels line's ``launches`` come
    from the context-parallel engine, drive_context_serve). Each shard's partials held
    to the plain partial ref (the normalised rows acc / l per row at
    ROW_RTOL, l rescaled to the ref's max, m to fp32 rounding, and a slot
    with no live row in the shard exactly m = -1e29, l = 0, acc = 0); the
    combine held per row to the refs' combine and to one whole-cache B1/B2
    call. Then times of the emulated step (4 launches + combine), its
    plain version, one whole-cache call and SDPA over the same rows,
    beside the bound counted on the bytes read (decode_bound)."""
    from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
    from kubetorch_tpu_torch.serve import dequantize_rows, quantize_rows
    nh, nkv, hd, c = 32, 8, 128, CONTEXT_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(11 if quant else 10)
    if quant:
        kern, plain = ops_dec.decode_attention_quant_partial, \
            ops_dec.decode_attention_quant_partial_ref
        whole, name = ops_dec.decode_attention_quant, "decode_attention_quant_partial"
    else:
        kern, plain = ops_dec.decode_attention_partial, \
            ops_dec.decode_attention_partial_ref
        whole, name = ops_dec.decode_attention, "decode_attention_partial"
    tol = ROW_RTOL[torch.bfloat16]
    per_shape, launches = [], 0
    for shape, (b, s, pos_list) in PARTIAL_SHAPES.items():
        q = torch.randn(b, nh, hd, generator=gen, device="cuda").bfloat16()
        kf = torch.randn(b, s, nkv, hd, generator=gen, device="cuda")
        vf = torch.randn(b, s, nkv, hd, generator=gen, device="cuda")
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        cache = (*quantize_rows(kf), *quantize_rows(vf)) if quant else \
            (kf.bfloat16(), vf.bfloat16())
        del kf, vf
        rows = s // c
        shards = [tuple(t[:, i * rows:(i + 1) * rows] for t in cache)
                  for i in range(c)]

        def step(fn):
            parts = [fn(q, *sh, pos, i * rows) for i, sh in enumerate(shards)]
            return ops_dec.combine_partials(
                *[torch.stack(x) for x in zip(*parts)], dtype=q.dtype)

        kern.launches = 0
        out = step(kern)
        torch.cuda.synchronize()
        n = kern.launches
        launches += n
        if n != c:
            fail(f"{name} ({shape}): {n} partial launches, expected {c}")
        empty_ok, shard_err = True, 0.0
        for i, sh in enumerate(shards):
            m, l, acc = kern(q, *sh, pos, i * rows)
            mr, lr, accr = plain(q, *sh, pos, i * rows)
            empty = (pos < i * rows)[:, None].expand(b, nh)
            live = ~empty
            empty_ok &= bool((l[empty] == 0).all() and (acc[empty] == 0).all()
                             and (m[empty] == -1e29).all())
            if live.any():
                shard_err = max(shard_err, row_rel_err(
                    (acc / l[..., None])[live], (accr / lr[..., None])[live]),
                    float(((l * torch.exp(m - mr) - lr).abs() / lr)[live].max()))
                m_err = float((m - mr)[live].abs().max())
                if not m_err <= 1e-3 * max(1.0, float(mr[live].abs().max())):
                    fail(f"{name} ({shape}) shard {i}: m off by {m_err}")
        want = step(plain)
        direct = whole(q, *cache, pos)
        err_ref, err_whole = row_rel_err(out, want), row_rel_err(out, direct)
        max_abs = float((out.float() - want.float()).abs().max())
        print(f"kernel {name} ({shape}) B={b} S={s} in {c} shards of {rows} "
              f"pos={pos_list}: per-shard partials max row err {shard_err}, "
              f"empty shards l = acc = 0 exactly {empty_ok}; combine vs the "
              f"refs' combine {err_ref}, vs one whole-cache call {err_whole} "
              f"(tol {tol}); launches {n}", flush=True)
        if not (empty_ok and shard_err <= tol and err_ref <= tol
                and err_whole <= tol and torch.isfinite(out).all()):
            fail(f"{name} ({shape}): partial mode differs from its plain "
                 f"version (shards {shard_err}, empty {empty_ok}, combine "
                 f"{err_ref}, whole {err_whole})")
        ms = time_ms(torch, lambda: step(kern))
        plain_ms = time_ms(torch, lambda: step(plain))
        whole_ms = time_ms(torch, lambda: whole(q, *cache, pos))
        mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None]
        if quant:
            kt = dequantize_rows(cache[0], cache[1]).bfloat16().transpose(1, 2)
            vt = dequantize_rows(cache[2], cache[3]).bfloat16().transpose(1, 2)
        else:
            kt, vt = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True))
        b_ms, b_by, nbytes = decode_bound(b, s, pos_list, quant, hd)
        rec = dict(shape=f"({shape}) B={b} S={s} in {c} shards NH={nh} "
                   f"NKV={nkv} Hd={hd} pos={pos_list} bf16 q"
                   + (", int8 K/V" if quant else ""),
                   emulated_launches=n, max_abs_err=max_abs, max_row_rel_err=err_ref,
                   row_rel_err_vs_whole=err_whole, shard_row_rel_err=shard_err,
                   ms=ms, plain_ms=plain_ms, whole_cache_ms=whole_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                   bound_share=b_ms / ms)
        print(f"kernel {name} ({shape}): ms={ms} ({c} partial launches + "
              f"combine) whole_cache_ms={whole_ms} plain_ms={plain_ms} "
              f"sdpa_ms={lib} bound_ms={b_ms} ({b_by}; {nbytes} bytes read "
              f"and written) bound_share={b_ms / ms}", flush=True)
        per_shape.append(rec)
        del q, cache, shards, out, want, direct, kt, vt
        torch.cuda.empty_cache()
    return dict(per_shape[0], emulated_launches=launches, per_shape=per_shape)


def drive_mesh_serve(card):
    """The serving engine on a mesh ("mesh_serve"): the script started
    again as a torch rank (MESH_SERVE_RANK_FLAG), as drive_mesh starts
    one; mesh_serve_rank does the work and fails the phase by exiting
    non-zero. The parent must hold less than MESH_SERVE_PARENT_GB of the
    card then. Returns the mesh engine's A1/B1 launches and the phase's
    record."""
    import torch
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"mesh_serve: the parent holds {held} GB of the card", flush=True)
    if not held < MESH_SERVE_PARENT_GB:
        fail(f"mesh_serve: the parent holds {held} GB (limit "
             f"{MESH_SERVE_PARENT_GB})")
    rec = run_rank("mesh_serve", MESH_SERVE_RANK_FLAG, MESH_ENV)
    rec["context"] = drive_context_serve(card)
    rec["spec_lora"] = spawn_ranks("spec_lora", SPEC_LORA_RANK_FLAG,
                                   SPEC_LORA_RANKS, SPEC_LORA_ENV)
    print(f"spec_lora: {SPEC_LORA_RANKS} ranks, wall "
          f"{rec['spec_lora']['wall_s']:.1f}s card={card}", flush=True)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"mesh_serve: phase wall {rec['wall_s']:.1f}s card={card}", flush=True)
    return rec["launches"]["mesh"], rec


def spawn_ranks(label, flag, n, env, timeout=600):
    """``n`` ranks of this script (``flag``), each a process with RANK/
    WORLD_SIZE/MASTER_PORT and ``env``, all started together, sharing the
    one card (LOCAL_RANK 0). A rank that fails stops the others; each
    rank's output is kept in a temporary file. Returns rank 0's record
    (its last line) with the wall seconds."""
    import tempfile
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    port = str(free_tcp_port())
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag],
        env=dict(os.environ, PYTHONPATH=here, RANK=str(r), WORLD_SIZE=str(n),
                 LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 **env),
        stdout=log, stderr=subprocess.STDOUT, text=True)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    out = texts[0].strip().splitlines()
    for line in out[:-1]:
        print(line, flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        fail(f"{label}: ranks {bad} exited "
             f"{[procs[r].returncode for r in bad]}: "
             + " | ".join(texts[r][-1500:] for r in bad))
    rec = json.loads(out[-1])
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def drive_context_serve(card):
    """Context-parallel serving on the one card: CONTEXT_SHARDS ranks of
    this script (CONTEXT_RANK_FLAG) over CONTEXT_ENV (``spawn_ranks``);
    context_serve_rank does the work. Returns rank 0's record."""
    rec = spawn_ranks("mesh_serve context", CONTEXT_RANK_FLAG, CONTEXT_SHARDS,
                      CONTEXT_ENV)
    print(f"mesh_serve context: {CONTEXT_SHARDS} ranks, wall {rec['wall_s']:.1f}s "
          f"card={card}", flush=True)
    return rec


def context_serve_rank() -> None:
    """One of the CONTEXT_SHARDS ranks of drive_context_serve: gloo from
    the env (serving.distributed, device="cpu"), the card as cuda:0, the
    mesh of KT_MESH on cuda. Llama-3-8B's width at CONTEXT_LAYERS layers
    (bf16, random weights from a seed, attn_impl "flash") laid out by
    LLAMA_RULES (replicated: a context mesh splits the grid, not the
    weights), served through GenerationEngine(mesh=) on 8 slots, max_len
    8192, the CONTEXT_PROMPTS, CONTEXT_NEW new tokens, once with the bf16
    grid and once with the int8 grid. Gates per run: the grid sharded over
    context, this rank holding 1/CONTEXT_SHARDS of its bytes; exact
    launches, A1 = L x 8 prefills and B1's (B2's) partial mode = L x
    decode steps, whole-cache B1/B2 none; every request CONTEXT_NEW tokens
    in the vocab. Rank 0 then runs the plain engine on the same params and
    prompts: the first tokens (from the same prefill) equal, the first
    decode step's logits within LOGITS_REL_L2 of the plain engine's (the
    partial mode and the combine against one whole-cache call); the share
    of equal tokens is printed. The record is rank 0's last line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("context rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.ops import decode_attention as ops_dec
    from kubetorch_tpu_torch.parallel import LLAMA_RULES
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod
    from kubetorch_tpu_torch.serving import distributed

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=CONTEXT_LAYERS,
                              attn_impl="flash")
    L = cfg.n_layers
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in CONTEXT_PROMPTS]
    counters = dict(flash_fwd=ops_attn.flash_attention,
                    decode_attention=ops_dec.decode_attention,
                    decode_attention_quant=ops_dec.decode_attention_quant,
                    decode_attention_partial=ops_dec.decode_attention_partial,
                    decode_attention_quant_partial=ops_dec.decode_attention_quant_partial)
    distributed.init_process_group(device="cpu")
    torch.cuda.set_device(0)
    rank = dist.get_rank()
    try:
        mesh = distributed.mesh(device="cuda")
        if rank == 0:
            print(f"mesh_serve context: KT_MESH {os.environ.get('KT_MESH')} -> "
                  f"{mesh} over {dist.get_backend()}, world "
                  f"{dist.get_world_size()}", flush=True)
        params = llama_init(cfg, seed=0, device="cuda")
        sharded = shard_pytree(params, LLAMA_RULES, mesh)
        runs = {}
        for quant in (False, True):
            name = "int8" if quant else "bf16"
            kern = "decode_attention_quant" if quant else "decode_attention"
            runs[name] = run = {}
            for label, p, kw in (("mesh", sharded, dict(mesh=mesh)),
                                 ("plain", params, {})):
                if label == "plain" and rank != 0:
                    continue
                eng = GenerationEngine(p, cfg, slots=8, max_len=8192,
                                       prefill_buckets=(128, 512, 2048),
                                       quantize_kv=quant, device="cuda", **kw)
                if kw:
                    leaf = eng._cache[0]
                    local = leaf.to_local()
                    split = (local.numel() * CONTEXT_SHARDS == leaf.numel()
                             and "Shard(dim=2)" in map(repr, leaf.placements))
                    if not split:
                        fail(f"mesh_serve context: the grid is not split over "
                             f"context: {leaf.placements} {tuple(local.shape)}")
                with recorded_logits(engine_mod, "_decode_step_impl",
                                     pick=lambda o: o.float(), keep=1) as first_step:
                    for fn in counters.values():
                        fn.launches = 0
                    hs = [eng.submit(q, max_new_tokens=CONTEXT_NEW) for q in prompts]
                    steps0, dt = eng.stats().decode_steps, []
                    while True:
                        before = eng.stats().admitted_total
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        left = eng.step()
                        torch.cuda.synchronize()
                        if eng.stats().admitted_total == before:
                            dt.append(time.perf_counter() - t)
                        if not left:
                            break
                    got = {k: fn.launches for k, fn in counters.items()}
                steps = eng.stats().decode_steps - steps0
                outs = [h.result(timeout=0) for h in hs]
                if any(len(o) != CONTEXT_NEW or not all(0 <= t < cfg.vocab_size
                                                          for t in o) for o in outs):
                    fail(f"mesh_serve context {name} {label}: outputs {outs}")
                want = {k: 0 for k in counters}
                want["flash_fwd"] = L * len(prompts)
                want[kern + ("_partial" if kw else "")] = L * steps
                if got != want:
                    fail(f"mesh_serve context {name} {label}: launches {got}, "
                         f"expected {want}")
                run[label] = dict(tokens=outs, launches=got, steps=steps,
                                  first_step=first_step[0],
                                  ms_per_decode_step=sum(dt) / len(dt) * 1e3)
                del eng
                torch.cuda.empty_cache()
            if rank == 0:
                a, b = run["mesh"], run["plain"]
                rel = float((a["first_step"] - b["first_step"]).norm()
                            / b["first_step"].norm())
                firsts = [x[0] for x in a["tokens"]] == [x[0] for x in b["tokens"]]
                same = sum(x == y for u, v in zip(a["tokens"], b["tokens"])
                           for x, y in zip(u, v)) / (len(prompts) * CONTEXT_NEW)
                print(f"mesh_serve context {name}: {CONTEXT_SHARDS} ranks, "
                      f"launches {a['launches']} over {a['steps']} decode steps; "
                      f"first tokens equal to the plain engine's {firsts}; first "
                      f"decode step's logits rel_l2 {rel} (tol {LOGITS_REL_L2}); "
                      f"equal tokens {same}; decode ms/step mesh "
                      f"{a['ms_per_decode_step']} plain {b['ms_per_decode_step']}",
                      flush=True)
                if not (firsts and rel <= LOGITS_REL_L2):
                    fail(f"mesh_serve context {name}: first tokens equal {firsts}, "
                         f"first decode step rel_l2 {rel}")
                for r in (a, b):
                    del r["first_step"], r["tokens"]
                run.update(logits_rel_l2=rel, equal_tokens=same)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        distributed.destroy()
    if rank == 0:
        launches = {k: runs[k]["mesh"]["launches"] for k in runs}
        print(json.dumps(dict(ranks=CONTEXT_SHARDS, layers=L, runs=runs,
                              launches=launches, peak_memory_gb_rank0=peak)),
              flush=True)


def spec_lora_rank() -> None:
    """One of the SPEC_LORA_RANKS ranks of "spec_lora": gloo from the env
    (serving.distributed, device="cpu"), the card as cuda:0, the mesh of
    KT_MESH (context 2 x tensor 2) on cuda, DTensor's collectives routed
    through c10d. Llama-3-8B's width at SPEC_LORA_LAYERS layers (bf16,
    attn_impl "flash", random weights from a seed) and the
    Llama-3.2-1B-shape draft at as many layers, both laid out by
    LLAMA_RULES. (1) A SpeculativeEngine (spec_k SPEC_K, 8 slots, max_len
    2048) over the SPEC_LORA_PROMPTS, SPEC_LORA_NEW tokens each: both grids
    split over context (each rank 1024 rows of them after the rounds) and
    KV heads over tensor; exact launches: A1 = (L + L_d) x 8 from-zero
    prefills, B1's partial mode = L_d x (k - 1) x rounds, whole-cache B1
    none. (2) A LoRA engine with 3 rank-LORA_RANK adapters beside 2 base
    requests over the same prompts: A1 = L x 8, B1's partial mode = L x
    decode steps. Rank 0 then runs the plain engines on the same params,
    adapters and prompts: first tokens equal; the first verify window's
    logits (spec) and the first decode step's (LoRA) within
    LOGITS_REL_L2; the share of equal tokens printed. The record is rank
    0's last line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("spec_lora rank: torch.cuda.is_available() is false")
    import faulthandler
    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.ops import decode_attention as ops_dec
    from kubetorch_tpu_torch.parallel import LLAMA_RULES
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree
    from kubetorch_tpu_torch.serve import GenerationEngine, SpeculativeEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod
    from kubetorch_tpu_torch.serve import spec_engine as spec_mod
    from kubetorch_tpu_torch.serving import distributed

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=SPEC_LORA_LAYERS,
                              attn_impl="flash")
    dcfg = dataclasses.replace(LlamaConfig.llama3_1b(), n_layers=SPEC_LORA_LAYERS,
                               attn_impl="flash")
    L, Ld = cfg.n_layers, dcfg.n_layers
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SPEC_LORA_PROMPTS]
    counters = dict(flash_fwd=ops_attn.flash_attention,
                    decode_attention=ops_dec.decode_attention,
                    decode_attention_quant=ops_dec.decode_attention_quant,
                    decode_attention_partial=ops_dec.decode_attention_partial,
                    decode_attention_quant_partial=ops_dec.decode_attention_quant_partial)
    distributed.init_process_group(device="cpu")
    torch.cuda.set_device(0)
    route_dtensor_collectives_through_c10d()
    rank = dist.get_rank()
    say = (lambda msg: print(msg, flush=True)) if rank == 0 else (lambda msg: None)
    grid = dict(slots=8, max_len=2048, prefill_buckets=(128, 256, 512, 1024, 2048),
                device="cuda")

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    try:
        mesh = distributed.mesh(device="cuda")
        say(f"spec_lora: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
            f"{dist.get_backend()}, world {dist.get_world_size()}")
        params = llama_init(cfg, seed=0, device="cuda")
        draft = llama_init(dcfg, seed=SPEC_DRAFT_SEED, device="cuda")
        sharded = shard_pytree(params, LLAMA_RULES, mesh)
        dsharded = shard_pytree(draft, LLAMA_RULES, mesh)
        lcfg = lora_config()
        adapters = [seeded_adapter(torch, params, lcfg, seed) for seed in (1, 2, 3)]
        runs = {"spec": {}, "lora": {}}
        for label, p, d, kw in (("mesh", sharded, dsharded, dict(mesh=mesh)),
                                ("plain", params, draft, {})):
            if label == "plain" and rank != 0:
                continue
            # (1) speculative decoding
            eng = SpeculativeEngine(p, cfg, d, dcfg, spec_k=SPEC_K, **grid, **kw)
            # a round ingests the draft's block, then the target's window:
            # the second call is the first verify window
            with recorded_logits(spec_mod, "_grid_ingest",
                                 pick=lambda o: o[:, 0].float(), keep=2) as kept:
                zero()
                hs = [eng.submit(q, max_new_tokens=SPEC_LORA_NEW) for q in prompts]
                rounds0 = eng._steps
                t = time.perf_counter()
                while eng.step():
                    pass
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                got = read()
            rounds = eng._steps - rounds0
            want = {k: 0 for k in counters}
            want["flash_fwd"] = (L + Ld) * len(prompts)
            want["decode_attention_partial" if kw else "decode_attention"] = (
                Ld * (SPEC_K - 1) * rounds)
            if got != want:
                fail(f"spec_lora spec {label}: launches {got}, expected {want}")
            if kw:
                rows = [eng._cache[0].to_local().shape[2],
                        eng._draft_cache[0].to_local().shape[2]]
                if rows != [grid["max_len"] // 2] * 2:
                    fail(f"spec_lora spec: rank {rank} holds {rows} rows of the "
                         f"grids, not {grid['max_len'] // 2} each")
            runs["spec"][label] = dict(
                tokens=[h.result(timeout=0) for h in hs], first=kept[1],
                launches=got, rounds=rounds, wall_s=wall,
                accepted=eng.spec_stats.accepted, proposed=eng.spec_stats.proposed)
            del eng, hs
            torch.cuda.empty_cache()
            # (2) LoRA banks
            eng = GenerationEngine(p, cfg, **grid, **kw)
            ids = [eng.register_adapter(a, lcfg) for a in adapters]
            owners = [None, None, ids[0], ids[0], ids[1], ids[1], ids[2], ids[2]]
            with recorded_logits(engine_mod, "_decode_step_impl",
                                 pick=lambda o: o.float(), keep=1) as kept:
                zero()
                hs = [eng.submit(q, max_new_tokens=SPEC_LORA_NEW, adapter_id=a)
                      for q, a in zip(prompts, owners)]
                steps0 = eng.stats().decode_steps
                t = time.perf_counter()
                while eng.step():
                    pass
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                got = read()
            steps = eng.stats().decode_steps - steps0
            want = {k: 0 for k in counters}
            want["flash_fwd"] = L * len(prompts)
            want["decode_attention_partial" if kw else "decode_attention"] = L * steps
            if got != want:
                fail(f"spec_lora lora {label}: launches {got}, expected {want}")
            runs["lora"][label] = dict(
                tokens=[h.result(timeout=0) for h in hs], first=kept[0],
                launches=got, steps=steps, wall_s=wall)
            del eng, hs
            torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated() / 1e9
        say(f"spec_lora: rank 0 peak_memory_gb={peak}")
        if rank == 0:
            for name, run in runs.items():
                a, b = run["mesh"], run["plain"]
                rel = float((a["first"] - b["first"]).norm() / b["first"].norm())
                firsts = [x[0] for x in a["tokens"]] == [x[0] for x in b["tokens"]]
                same = sum(x == y for u, v in zip(a["tokens"], b["tokens"])
                           for x, y in zip(u, v)) / (len(prompts) * SPEC_LORA_NEW)
                say(f"spec_lora {name}: {SPEC_LORA_RANKS} ranks, launches "
                    f"{a['launches']}; first tokens equal to the plain engine's "
                    f"{firsts}; first-step logits rel_l2 {rel} (tol "
                    f"{LOGITS_REL_L2}); equal tokens {same}; wall mesh "
                    f"{a['wall_s']} s plain {b['wall_s']} s")
                if not (firsts and rel <= LOGITS_REL_L2):
                    fail(f"spec_lora {name}: first tokens equal {firsts}, "
                         f"first-step rel_l2 {rel}")
                for r in (a, b):
                    del r["first"], r["tokens"]
                run.update(logits_rel_l2=rel, equal_tokens=same)
    finally:
        distributed.destroy()
    if rank == 0:
        print(json.dumps(dict(ranks=SPEC_LORA_RANKS, layers=L, runs=runs,
                              peak_memory_gb_rank0=peak)), flush=True)


def serve_timed(torch, eng, prompts):
    """The engine phases' traffic on ``eng``: 6 requests up front, then one
    more per step while the grid decodes, each step ending in a
    synchronize. Returns (handles, wall seconds of each step that admitted
    nothing)."""
    handles, todo, decode_dt = [], list(prompts), []
    handles += [eng.submit(q, max_new_tokens=MAX_NEW) for q in todo[:6]]
    todo = todo[6:]
    while True:
        if todo:
            handles.append(eng.submit(todo.pop(0), max_new_tokens=MAX_NEW))
        before = eng.stats().admitted_total
        t = time.perf_counter()
        left = eng.step()
        torch.cuda.synchronize()
        if eng.stats().admitted_total == before:
            decode_dt.append(time.perf_counter() - t)
        if not left and not todo:
            return handles, decode_dt


def mesh_serve_rank() -> None:
    """One torch rank of "mesh_serve": distributed.init_process_group()
    (nccl) and distributed.mesh() from KT_MESH, a world of 1. Llama-3-8B at
    full width and CUT_LAYERS layers (random weights from a seed,
    bf16) laid out by
    shard_pytree(..., LLAMA_RULES, mesh) (every leaf a DTensor, all
    Replicate() at a world of 1, the same storage as the plain tree), then
    the engine phases' traffic (8 slots, max_len 2048, greedy, the 12
    ENGINE_PROMPT_LENS prompts over every prefill bucket, 6 up front and
    one a step while others decode) through the plain engine and then
    GenerationEngine(mesh=) on the same params. Gates: tokens, logprobs
    and the first-token logits of every prefill bitwise equal between the
    two (else the first parting op of a 2-layer prefill is named), A1 =
    L x 12 prefills and B1 = L x decode steps in both, the two peaks
    within GRID_SIZED_GB. Prints decode ms/step (steps that admitted
    nothing), the busy share of 4 profiled decode steps of a full grid and
    peak memory, for both, and the plain engine's allocations of at least
    GRID_SIZED_GB through its warm-up admissions (AllocHistory). Then
    mesh_serve_lora. The record is the last line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("mesh_serve rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.ops import decode_attention as ops_dec
    from kubetorch_tpu_torch.parallel import LLAMA_RULES
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod
    from kubetorch_tpu_torch.serving import distributed

    cfg = LlamaConfig.llama3_8b(n_layers=CUT_LAYERS)
    L = cfg.n_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in ENGINE_PROMPT_LENS]
    warm = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (100, 200, 400, 800, 1500)]
    launches = Launches(ops_attn, ops_dec)
    distributed.init_process_group()
    try:
        mesh = distributed.mesh()
        print(f"mesh_serve: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
              f"{dist.get_backend()}, world {dist.get_world_size()}", flush=True)
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            fail(f"mesh_serve: backend {dist.get_backend()} on {mesh.device_type}")
        params = llama_init(cfg, seed=0, device="cuda")
        sharded = shard_pytree(params, LLAMA_RULES, mesh)
        check_rules_layout(sharded, LLAMA_RULES, "LLAMA_RULES", mesh, "mesh_serve")
        runs = {}
        large = None
        # the plain engine first: its admission and decode under the
        # allocator's history, the allocations of a grid's size named
        for name, p, kw in (("plain", params, {}),
                            ("mesh", sharded, dict(mesh=mesh))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if name == "plain":
                history = AllocHistory(torch)
            eng = GenerationEngine(p, cfg, slots=8, max_len=2048,
                                   prefill_buckets=(128, 256, 512, 1024),
                                   device="cuda", **kw)
            hs = [eng.submit(w, max_new_tokens=2) for w in warm]
            while eng.step():
                pass
            # no loop variable: a handle left bound holds its engine, and
            # with it a grid, into the next engine's run
            [h.result(timeout=0) for h in hs]
            if name == "plain":
                large = history.large(GRID_SIZED_GB * 1e9)
                print(f"mesh_serve: plain engine, allocations of at least "
                      f"{GRID_SIZED_GB} GB from its construction through 5 "
                      f"admissions (100-1500 tokens) and their decode steps: "
                      f"{json.dumps(large)}; peak "
                      f"{torch.cuda.max_memory_allocated() / 1e9} GB",
                      flush=True)
            with recorded_logits(engine_mod, "_prefill_logits") as first:
                launches.zero()
                steps0 = eng.stats().decode_steps
                handles, decode_dt = serve_timed(torch, eng, prompts)
                got = launches.read()
            steps = eng.stats().decode_steps - steps0
            check_launches(f"mesh_serve: {name} engine, {len(prompts)} "
                           f"prefills and {steps} decode steps (A1, B1)",
                           (got["flash_fwd"], got["decode_attention"]),
                           (L * len(prompts), L * steps))
            outs = check_outputs(f"mesh_serve {name}", handles, cfg, prompts)
            lps = [h.logprobs for h in handles]
            hs = [eng.submit(q[:40], max_new_tokens=8) for q in prompts[:eng.slots]]
            eng.step()
            torch.cuda.synchronize()
            prof = profile_steps(torch, f"mesh_serve {name}: 4 decode steps, "
                                 "8 slots", eng.step, 4)
            while eng.step():
                pass
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            ms_step = sum(decode_dt) / len(decode_dt) * 1e3
            runs[name] = dict(tokens=outs, logprobs=lps, first=list(first),
                              launches=(got["flash_fwd"], got["decode_attention"]),
                              ms_per_decode_step=ms_step,
                              decode_steps_timed=len(decode_dt),
                              profile=prof, peak_memory_gb=peak)
            print(f"mesh_serve: {name} engine: decode ms/step {ms_step} over "
                  f"{len(decode_dt)} steps that admitted nothing; peak_memory_gb="
                  f"{peak}", flush=True)
            del eng, hs, handles
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs["mesh"], runs["plain"]
        same = dict(tokens=a["tokens"] == b["tokens"],
                    logprobs=a["logprobs"] == b["logprobs"],
                    first_token_logits=len(a["first"]) == len(b["first"]) and all(
                        torch.equal(x, y) for x, y in zip(a["first"], b["first"])))
        print(f"mesh_serve: mesh engine vs plain engine, bitwise: {same} "
              f"({len(a['first'])} first-token logits)", flush=True)
        parting = None
        if not all(same.values()):
            small = dataclasses.replace(cfg, n_layers=2)
            p0 = llama_init(small, seed=0, device="cuda")
            pm = shard_pytree(p0, LLAMA_RULES, mesh)
            grid = engine_mod._MeshGrid(mesh, small, 1, 256)
            toks = torch.tensor([prompts[0][:40] + [0] * 88], device="cuda")
            freqs = engine_mod.rope_freqs(small, 256, device="cuda")
            parting = first_parting_op(
                torch, lambda: engine_mod._prefill_logits(p0, toks, 40, small, freqs),
                lambda: engine_mod._prefill_logits(pm, toks, 40, small, freqs,
                                                   grid=grid))
            fail(f"mesh_serve: the mesh engine differs from the plain engine "
                 f"({same}); first parting op of a 2-layer prefill: {parting}")
        gap = abs(a["peak_memory_gb"] - b["peak_memory_gb"])
        if not gap < GRID_SIZED_GB:
            fail(f"mesh_serve: the engines' peaks differ by {gap} GB (mesh "
                 f"{a['peak_memory_gb']}, plain {b['peak_memory_gb']})")
        share = {k: (r["profile"] or {}).get("device_busy_share")
                 for k, r in runs.items()}
        print(f"mesh_serve: decode ms/step mesh {a['ms_per_decode_step']} plain "
              f"{b['ms_per_decode_step']}; device busy share mesh {share['mesh']} "
              f"plain {share['plain']}; peak_memory_gb mesh "
              f"{a['peak_memory_gb']} plain {b['peak_memory_gb']}", flush=True)
        for r in runs.values():
            del r["first"], r["tokens"], r["logprobs"]
        lora = mesh_serve_lora(torch, cfg, params, sharded, mesh, launches)
    finally:
        distributed.destroy()
    if dist.is_initialized():
        fail("mesh_serve: the process group outlived its phase")
    rec = dict(launches={k: list(runs[k]["launches"]) for k in runs},
               bitwise=same, parting_op=parting,
               ms_per_decode_step={k: runs[k]["ms_per_decode_step"] for k in runs},
               profile={k: runs[k]["profile"] for k in runs},
               peak_memory_gb={k: runs[k]["peak_memory_gb"] for k in runs},
               plain_large_allocations=large, lora=lora)
    print(json.dumps(rec), flush=True)


class AllocHistory:
    """The caching allocator's history (``torch.cuda.memory.
    _record_memory_history``, Python stacks) from construction to
    ``large()``, which stops it and returns every allocation of at least
    ``floor`` bytes made meanwhile: its GB, whether it was still live, and
    the frames of the port and of this script that made it."""

    def __init__(self, torch):
        self.torch = torch
        torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                                 stacks="python")

    def large(self, floor: float) -> list:
        mem = self.torch.cuda.memory
        try:
            snap = mem._snapshot()
        finally:
            mem._record_memory_history(enabled=None)
        freed = set()
        out = []
        for trace in snap.get("device_traces", []):
            for ev in trace:
                if ev["action"] in ("free_requested", "free_completed"):
                    freed.add(ev["addr"])
            for ev in trace:
                if ev["action"] != "alloc" or ev["size"] < floor:
                    continue
                frames = [f"{os.path.basename(f['filename'])}:{f['line']} "
                          f"{f['name']}" for f in ev.get("frames", [])
                          if "kubetorch_tpu_torch" in f["filename"]
                          or "chip_smoke" in f["filename"]]
                out.append(dict(gb=ev["size"] / 1e9, live=ev["addr"] not in freed,
                                frames=frames[:6]))
        return out


def mesh_serve_lora(torch, cfg, params, sharded, mesh, launches):
    """LoRA banks on the mesh engine at a world of 1 ("mesh_serve lora"):
    drive_lora's traffic (3 rank-LORA_RANK adapters, 2 base and 2 adapter
    requests each, the third adapter unregistered mid-decode) through the
    plain engine and GenerationEngine(mesh=) on the same params and
    adapters. Gates: tokens, logprobs and first-token logits bitwise equal;
    A1 = L x 8 prefills and B1 = L x decode steps in both. Returns decode
    ms/step and the launches."""
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod

    t_phase = time.perf_counter()
    L = cfg.n_layers
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LORA_PROMPTS]
    lcfg = lora_config()
    adapters = [seeded_adapter(torch, params, lcfg, seed) for seed in (1, 2, 3)]
    runs = {}
    for name, p, kw in (("plain", params, {}), ("mesh", sharded, dict(mesh=mesh))):
        eng = GenerationEngine(p, cfg, **FEATURE_GRID, device="cuda", **kw)
        ids = [eng.register_adapter(a, lcfg) for a in adapters]
        warm = [eng.submit(prompts[0][:30], max_new_tokens=2, adapter_id=i)
                for i in ids]
        drain(torch, eng)
        [h.result(timeout=0) for h in warm]
        owners = [None, None, ids[0], ids[0], ids[1], ids[1], ids[2], ids[2]]
        steps0 = eng.stats().decode_steps
        with recorded_logits(engine_mod, "_prefill_logits") as first:
            launches.zero()
            handles = [eng.submit(q, max_new_tokens=MAX_NEW, adapter_id=a)
                       for q, a in zip(prompts, owners)]
            eng.step()
            torch.cuda.synchronize()
            ms = timed_steps(torch, eng, LORA_TIMED_STEPS)
            eng.unregister_adapter(ids[2])
            drain(torch, eng)
            got = launches.read()
        steps = eng.stats().decode_steps - steps0
        check_launches(f"mesh_serve lora: {name} engine, 8 prefills and {steps} "
                       "decode steps (A1, B1)",
                       (got["flash_fwd"], got["decode_attention"]),
                       (L * len(prompts), L * steps))
        runs[name] = dict(tokens=[h.result(timeout=0) for h in handles],
                          logprobs=[h.logprobs for h in handles],
                          first=list(first), ms=ms,
                          launches=(got["flash_fwd"], got["decode_attention"]))
        del eng, handles
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["plain"]
    same = dict(tokens=a["tokens"] == b["tokens"],
                logprobs=a["logprobs"] == b["logprobs"],
                first_token_logits=len(a["first"]) == len(b["first"]) == 8 and all(
                    torch.equal(x, y) for x, y in zip(a["first"], b["first"])))
    print(f"mesh_serve lora: 3 adapters (rank {LORA_RANK}) beside 2 base "
          f"requests, the third unregistered mid-decode: mesh engine vs plain "
          f"engine, bitwise: {same}; decode ms/step with 3 adapters mesh "
          f"{a['ms']} plain {b['ms']} ({LORA_TIMED_STEPS} steps, 8 slots)",
          flush=True)
    if not all(same.values()):
        fail(f"mesh_serve lora: the mesh engine's LoRA serving differs from "
             f"the plain engine's: {same}")
    del adapters
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"mesh_serve lora: wall {wall:.1f}s", flush=True)
    return dict(bitwise=same, ms_per_decode_step={k: runs[k]["ms"] for k in runs},
                launches={k: list(runs[k]["launches"]) for k in runs},
                wall_s=wall)


def drive_resnet(card):
    """ResNet-50 at ImageNet's shape ("resnet"): the script started again
    as a torch rank (RESNET_RANK_FLAG, a world of 1 over nccl) that does
    the work and fails the phase by exiting non-zero. Returns its
    record."""
    t_phase = time.perf_counter()
    rec = run_rank("resnet", RESNET_RANK_FLAG, RESNET_ENV)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"resnet: phase wall {rec['wall_s']:.1f}s card={card}", flush=True)
    return rec


def resnet_step(torch, cfg, opt, params, stats, opt_state, images, labels,
                train=True):
    """examples/resnet_dp.py's step in the port: resnet_loss's value and
    gradients (on a mesh the loss and each gradient reduced to the params'
    placements), the optimizer's update and ``p + u``, both in place.
    Returns (params, new stats, opt_state, loss)."""
    from kubetorch_tpu_torch.models.resnet import resnet_loss
    from kubetorch_tpu_torch.parallel.mesh import is_dtensor
    from kubetorch_tpu_torch.train.optim import tree_map

    leaves = []

    def req(t):
        t = t.detach().requires_grad_()
        leaves.append(t)
        return t

    ps = tree_map(req, params)
    loss, new = resnet_loss(ps, stats, images, labels, cfg, train=train)
    if is_dtensor(loss):
        loss = loss.full_tensor()
    grads = iter(torch.autograd.grad(loss, leaves))

    def placed(p):
        g = next(grads)
        return g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g

    grads = tree_map(placed, ps)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params, inplace=True)
        params = tree_map(lambda p, u: p.add_(u), params, updates)
    return params, (new or stats), opt_state, loss.detach()


def resnet_rank() -> None:
    """The torch rank of "resnet": distributed.init_process_group() (nccl)
    and distributed.mesh() from KT_MESH, a one-dim data mesh of size 1.
    ResNet-50 (bf16 convs, RESNET_CLASSES classes, random weights from a
    seed), RESNET_B random images of RESNET_HW² from a seed,
    sgd(0.1, momentum=0.9): RESNET_STEPS train-mode steps with the images
    a DTensor laid out by batch_sharding and the params and statistics
    replicated, then the same steps plain from the same start. Gates: each
    step's loss, every param's and batch_stats leaf's hash bitwise equal,
    the losses finite. Prints images/s and ms/step (steps 2 on), the busy
    share and the convolutions' share of busy over RESNET_PROFILED
    profiled plain steps, and the peak memory. Then the fp32 model of the
    bench's config 2 (stages [1, 1, 1, 1]) on the card against the same
    code on the CPU: loss, new statistics and gradients within
    RESNET_FP32_REL. The record is the last line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("resnet rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubetorch_tpu_torch.models import resnet as R
    from kubetorch_tpu_torch.parallel.sharding import (ShardingRules,
                                                       batch_sharding,
                                                       shard_pytree, to_dtensor)
    from kubetorch_tpu_torch.serving import distributed
    from kubetorch_tpu_torch.train.optim import sgd, tree_leaves, tree_map

    cfg = R.ResNet50(num_classes=RESNET_CLASSES)
    gen = torch.Generator(device="cuda").manual_seed(4)
    images = torch.randn((RESNET_B, RESNET_HW, RESNET_HW, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, RESNET_CLASSES, (RESNET_B,), generator=gen,
                           device="cuda")
    params0, stats0 = R.resnet_init(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params0))
    opt = sgd(0.1, momentum=0.9)
    distributed.init_process_group()
    try:
        mesh = distributed.mesh()
        print(f"resnet: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
              f"{dist.get_backend()}, world {dist.get_world_size()}; ResNet-50 "
              f"{n_params} params, {RESNET_B} x {RESNET_HW}² images", flush=True)
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            fail(f"resnet: backend {dist.get_backend()} on {mesh.device_type}")
        replicated = ShardingRules(rules=[])
        runs = {}
        for name in ("mesh", "plain"):
            params = tree_map(torch.clone, params0)
            stats = tree_map(torch.clone, stats0)
            x, y = images, labels
            if name == "mesh":
                params = shard_pytree(params, replicated, mesh)
                stats = shard_pytree(stats, replicated, mesh)
                x = to_dtensor(images, mesh, batch_sharding(mesh).placements)
            opt_state = opt.init(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, dt = [], []
            for _ in range(RESNET_STEPS):
                t = time.perf_counter()
                params, stats, opt_state, loss = resnet_step(
                    torch, cfg, opt, params, stats, opt_state, x, y)
                torch.cuda.synchronize()
                dt.append(time.perf_counter() - t)
                losses.append(float(loss))
            local = tree_map(lambda t: t.to_local() if hasattr(t, "to_local")
                             else t, (params, stats))
            ms = sum(dt[1:]) / len(dt[1:]) * 1e3
            runs[name] = dict(losses=losses, ms_per_step=ms,
                              images_per_s=RESNET_B / ms * 1e3,
                              first_step_ms=dt[0] * 1e3,
                              params=leaf_hashes(torch, local[0]),
                              stats=leaf_hashes(torch, local[1]),
                              peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            if name == "plain":
                state = [params, stats, opt_state]

                def one():
                    state[:3] = resnet_step(torch, cfg, opt, *state, x, y)[:3]

                runs[name]["profile"] = profile_steps(
                    torch, f"resnet: ResNet-50 train step, {RESNET_B} x "
                    f"{RESNET_HW}² bf16", one, RESNET_PROFILED,
                    groups={"conv": CONV_KERNEL_KEYS})
                del state
            print(f"resnet: {name} step: losses {losses}; ms/step {ms} (steps 2 "
                  f"to {RESNET_STEPS}), first step {dt[0] * 1e3} ms; images/s "
                  f"{RESNET_B / ms * 1e3}; peak_memory_gb "
                  f"{runs[name]['peak_memory_gb']}", flush=True)
            del params, stats, opt_state, x
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs["mesh"], runs["plain"]
        same = dict(losses=a["losses"] == b["losses"], params=a["params"] == b["params"],
                    batch_stats=a["stats"] == b["stats"])
        print(f"resnet: the data-mesh step vs the plain step over {RESNET_STEPS} "
              f"steps, bitwise: {same}", flush=True)
        if not all(same.values()) or not all(math.isfinite(v) for v in a["losses"]):
            fail(f"resnet: the mesh step differs from the plain step: {same}, "
                 f"losses {a['losses']} / {b['losses']}")
        fp32 = resnet_fp32_card_vs_cpu(torch, R)
    finally:
        distributed.destroy()
    for r in runs.values():
        del r["params"], r["stats"]
    print(json.dumps(dict(bitwise=same, runs=runs, fp32=fp32, batch=RESNET_B,
                          hw=RESNET_HW, params=n_params)), flush=True)


def resnet_fp32_card_vs_cpu(torch, R) -> dict:
    """The bench's config-2 model (stages [1, 1, 1, 1], ResNetBlock) in
    fp32, train mode, RESNET_FP32's batch: loss, new batch_stats and every
    gradient on the card (cuDNN, TF32 off) against the same code on the
    CPU, each within RESNET_FP32_REL of the CPU quantity's largest
    magnitude."""
    from kubetorch_tpu_torch.train.optim import tree_leaves, tree_map

    c = RESNET_FP32
    cfg = R.ResNet(stage_sizes=(1, 1, 1, 1), block_cls=R.ResNetBlock,
                   num_filters=c["filters"], num_classes=c["classes"],
                   dtype=torch.float32)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((c["b"], c["hw"], c["hw"], 3),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, c["classes"], c["b"]))
    params, stats = R.resnet_init(2, cfg, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss, new = R.resnet_loss(p, tree_map(lambda t: t.to(dev), stats),
                                  x.to(dev), y.to(dev), cfg)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        out[dev] = ([loss.detach().cpu()], [t.cpu() for t in tree_leaves(new)],
                    [g.cpu() for g in grads])
    rel = {}
    for i, what in enumerate(("loss", "batch_stats", "grads")):
        got, want = out["cuda"][i], out["cpu"][i]
        scale = max(float(w.abs().max()) for w in want) or 1.0
        rel[what] = max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale
    print(f"resnet: fp32 stages [1, 1, 1, 1] on the card vs the CPU, largest "
          f"difference over the largest magnitude: {rel} (tol {RESNET_FP32_REL})",
          flush=True)
    if not all(v <= RESNET_FP32_REL for v in rel.values()):
        fail(f"resnet: the card's fp32 ResNet differs from the CPU's: {rel}")
    return rel


def drive_moe_mesh(card):
    """Mixtral on a mesh ("moe_mesh"): moe_mesh_rank as a world of 1 over
    nccl, then the EXPERT_RANKS gloo ranks of expert_rank on the one card
    (``spawn_ranks``). The parent must hold less than MOE_MESH_PARENT_GB
    of the card. Returns the phase's record: the rank's "train" and
    "serve", and "expert_ranks"."""
    import torch
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"moe_mesh: the parent holds {held} GB of the card", flush=True)
    if not held < MOE_MESH_PARENT_GB:
        fail(f"moe_mesh: the parent holds {held} GB (limit {MOE_MESH_PARENT_GB})")
    rec = run_rank("moe_mesh", MOE_MESH_RANK_FLAG, MOE_MESH_ENV)
    rec["expert_ranks"] = spawn_ranks("expert_ranks", EXPERT_RANK_FLAG,
                                      EXPERT_RANKS, EXPERT_ENV)
    print(f"expert_ranks: {EXPERT_RANKS} ranks, wall "
          f"{rec['expert_ranks']['wall_s']:.1f}s card={card}", flush=True)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"moe_mesh: phase wall {rec['wall_s']:.1f}s card={card}", flush=True)
    return rec


def local_leaves(tree):
    """Each DTensor leaf's local block (at a world of 1, the whole leaf)."""
    from torch.distributed.tensor import DTensor

    from kubetorch_tpu_torch.train.optim import tree_map
    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


def check_rules_layout(tree, rules, name, mesh, label):
    """Every leaf a DTensor on ``mesh`` in the placements of ``rules``
    (the table called ``name``)."""
    from torch.distributed.tensor import DTensor

    from kubetorch_tpu_torch.parallel.sharding import tree_paths
    from kubetorch_tpu_torch.train.optim import tree_leaves, tree_map
    bad = []
    tree_map(lambda x, p: None if isinstance(x, DTensor) and x.device_mesh == mesh
             and list(x.placements) == rules.placements_for(p, mesh)
             else bad.append(p), tree, tree_paths(tree))
    print(f"{label}: {len(tree_leaves(tree))} param leaves DTensors in "
          f"{name}' placements: {not bad} {bad[:4]}", flush=True)
    if bad:
        fail(f"{label}: leaves not laid out by {name}: {bad}")


def moe_mesh_train(torch, mesh, ops_attn):
    """Mixtral's width at MOE_TRAIN_LAYERS layers, bf16, remat "dots",
    default_optimizer, drive_moe_train's batch: MESH_STEPS steps through
    make_train_step(mesh=, rules=MOE_RULES), the state freed, then
    MESH_STEPS plain steps from the same seed. Gates: every param leaf a
    DTensor in MOE_RULES' placements; the losses and every param leaf's
    hash equal; A1/A2/A3 exactly 2L/L/L a step in both. Prints ms/step,
    the busy share of MESH_PROFILED profiled steps and peak memory."""
    from kubetorch_tpu_torch.models import moe as moe_mod
    from kubetorch_tpu_torch.parallel import MOE_RULES
    from kubetorch_tpu_torch.train import (default_optimizer,
                                           init_train_state, make_train_step)

    fa = ops_attn.flash_attention
    cfg = moe_mod.MoeConfig.mixtral_8x7b(n_layers=MOE_TRAIN_LAYERS,
                                         max_seq_len=TRAIN_S)
    L = cfg.n_layers
    opt = default_optimizer(warmup_steps=2)
    batch = {k: v.cuda() for k, v in host_batch(torch, cfg.vocab_size, 7).items()}
    runs = {}
    for name, kw in (("mesh", dict(mesh=mesh, rules=MOE_RULES)), ("plain", {})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(moe_mod.moe_init(cfg, seed=0, device="cuda"), opt)
        step = make_train_step(lambda p, t, y: moe_mod.moe_loss(p, t, y, cfg),
                               opt, **kw)
        if kw:
            state = step.shard_state(state)
            check_rules_layout(state.params, MOE_RULES, "MOE_RULES", mesh,
                               "moe_mesh train")
        fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        losses, times = [], []
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(m["loss"].item())
        counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        check_launches(f"moe_mesh: {name} train run, {MESH_STEPS} steps (A1, A2, A3)",
                       counts, (2 * L * MESH_STEPS, L * MESH_STEPS, L * MESH_STEPS))
        hashes = leaf_hashes(torch, local_leaves(state.params))

        def one_step():
            nonlocal state
            state, _ = step(state, batch)

        prof = profile_steps(torch, f"moe_mesh: {name} train step, {MESH_PROFILED} "
                             f"steps of {TRAIN_B}x{TRAIN_S}", one_step, MESH_PROFILED)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        runs[name] = dict(losses=losses, launches=counts, hashes=hashes,
                          ms_per_step=[t * 1e3 for t in times],
                          ms_per_warm_step=sum(times[1:]) / (len(times) - 1) * 1e3,
                          profile=prof, peak_memory_gb=peak)
        print(f"moe_mesh: {name} train run: losses {losses}; ms/step "
              f"{runs[name]['ms_per_step']}; peak_memory_gb={peak}", flush=True)
        del state, step, m
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["plain"]
    same = dict(losses=a["losses"] == b["losses"],
                leaf_hashes=a["hashes"] == b["hashes"],
                launches=a["launches"] == b["launches"])
    share = {k: (r["profile"] or {}).get("device_busy_share")
             for k, r in (("mesh", a), ("plain", b))}
    print(f"moe_mesh: train, mesh step vs plain step over {MESH_STEPS} steps, "
          f"bitwise: {same}; ms_per_step (steps 2-{MESH_STEPS}) mesh "
          f"{a['ms_per_warm_step']} plain {b['ms_per_warm_step']}; device busy "
          f"share mesh {share['mesh']} plain {share['plain']}; peak_memory_gb "
          f"mesh {a['peak_memory_gb']} plain {b['peak_memory_gb']}", flush=True)
    if not all(same.values()):
        fail(f"moe_mesh: the MoE mesh step differs from the plain step: {same} "
             f"(losses {a['losses']} vs {b['losses']})")
    return dict(launches={k: r["launches"] for k, r in runs.items()},
                bitwise=same, losses=a["losses"],
                ms_per_warm_step={k: r["ms_per_warm_step"] for k, r in runs.items()},
                profile={k: r["profile"] for k, r in runs.items()},
                peak_memory_gb={k: r["peak_memory_gb"] for k, r in runs.items()})


def moe_mesh_serve(torch, mesh, ops_attn, ops_dec, ops_q4):
    """drive_moe's Mixtral-8x7B tree (int8 experts, int4 attention and
    head) at full width and CUT_LAYERS layers, laid out by
    shard_pytree(..., MOE_RULES, mesh)
    (every quantized leaf replicated, as the rules leave it; at a world
    of 1 the same storage), served through GenerationEngine(mesh=) with an
    int8 grid of 8 slots x 2048 and then through the plain engine: the
    engine phases' warm-up and 12 requests, 6 up front and one a step.
    Gates: tokens, logprobs and every prefill's first-token logits bitwise
    equal; A1, B2 and B3 exactly drive_moe's counts in both. Prints decode
    ms/step (steps that admitted nothing), the busy share of 4 profiled
    decode steps of a full grid and peak memory, for both."""
    from kubetorch_tpu_torch.models.moe import MoeConfig
    from kubetorch_tpu_torch.models.quant import Q4KEY
    from kubetorch_tpu_torch.parallel import MOE_RULES
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod
    from kubetorch_tpu_torch.train.optim import tree_leaves

    cfg = MoeConfig.mixtral_8x7b(n_layers=CUT_LAYERS)
    L = cfg.n_layers
    params = mixtral_init_quantized(torch, cfg, seed=0)
    sharded = shard_pytree(params, MOE_RULES, mesh)
    check_rules_layout(sharded, MOE_RULES, "MOE_RULES", mesh, "moe_mesh serve")
    shared = all(a.data_ptr() == b.data_ptr() for a, b in
                 zip(tree_leaves(local_leaves(sharded)), tree_leaves(params)))
    print(f"moe_mesh serve: at a world of 1 every laid-out leaf is the plain "
          f"leaf's storage: {shared}", flush=True)
    rng = np.random.default_rng(0)
    warm = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (100, 200, 400, 800, 1500)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in ENGINE_PROMPT_LENS]
    head = params["lm_head"]
    head_q4 = int(ops_q4.q4_supported((1, cfg.dim), head[Q4KEY].shape,
                                      head["scale"].shape))
    launches = Launches(ops_attn, ops_dec, ops_q4)
    runs = {}
    for name, p, kw in (("mesh", sharded, dict(mesh=mesh)), ("plain", params, {})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = GenerationEngine(p, cfg, slots=8, max_len=2048,
                               prefill_buckets=(128, 256, 512, 1024),
                               quantize_kv=True, device="cuda", **kw)
        hs = [eng.submit(w, max_new_tokens=2) for w in warm]
        while eng.step():
            pass
        [h.result(timeout=0) for h in hs]
        with recorded_logits(engine_mod, "_prefill_logits") as first:
            launches.zero()
            steps0 = eng.stats().decode_steps
            handles, decode_dt = serve_timed(torch, eng, prompts)
            got = launches.read()
        steps = eng.stats().decode_steps - steps0
        check_launches(f"moe_mesh: {name} engine, {len(prompts)} prefills and "
                       f"{steps} decode steps", got,
                       dict(flash_fwd=L * len(prompts), decode_attention=0,
                            decode_attention_quant=L * steps,
                            q4_matmul=(4 * L + head_q4) * (len(prompts) + steps)))
        outs = check_outputs(f"moe_mesh {name}", handles, cfg, prompts)
        lps = [h.logprobs for h in handles]
        hs = [eng.submit(q[:40], max_new_tokens=8) for q in prompts[:eng.slots]]
        eng.step()
        torch.cuda.synchronize()
        prof = profile_steps(torch, f"moe_mesh: {name} engine: 4 decode steps, "
                             "8 slots", eng.step, 4)
        while eng.step():
            pass
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms_step = sum(decode_dt) / len(decode_dt) * 1e3
        runs[name] = dict(tokens=outs, logprobs=lps, first=list(first),
                          launches=got, ms_per_decode_step=ms_step,
                          profile=prof, peak_memory_gb=peak)
        print(f"moe_mesh: {name} engine: decode ms/step {ms_step} over "
              f"{len(decode_dt)} steps that admitted nothing; peak_memory_gb="
              f"{peak}", flush=True)
        del eng, hs, handles
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["plain"]
    same = dict(tokens=a["tokens"] == b["tokens"],
                logprobs=a["logprobs"] == b["logprobs"],
                first_token_logits=len(a["first"]) == len(b["first"]) and all(
                    torch.equal(x, y) for x, y in zip(a["first"], b["first"])),
                launches=a["launches"] == b["launches"])
    share = {k: (r["profile"] or {}).get("device_busy_share")
             for k, r in runs.items()}
    print(f"moe_mesh: serve, mesh engine vs plain engine, bitwise: {same} "
          f"({len(a['first'])} first-token logits); decode ms/step mesh "
          f"{a['ms_per_decode_step']} plain {b['ms_per_decode_step']}; device "
          f"busy share mesh {share['mesh']} plain {share['plain']}; "
          f"peak_memory_gb mesh {a['peak_memory_gb']} plain "
          f"{b['peak_memory_gb']}", flush=True)
    if not all(same.values()):
        fail(f"moe_mesh: the mesh engine differs from the plain engine: {same}")
    del params, sharded
    return dict(launches={k: r["launches"] for k, r in runs.items()},
                bitwise=same, shared_storage=shared,
                ms_per_decode_step={k: r["ms_per_decode_step"] for k, r in runs.items()},
                profile={k: r["profile"] for k, r in runs.items()},
                peak_memory_gb={k: r["peak_memory_gb"] for k, r in runs.items()})


def moe_mesh_rank() -> None:
    """The torch rank of "moe_mesh": distributed.init_process_group()
    (nccl) and distributed.mesh() from KT_MESH (every axis dead at a
    world of 1), then moe_mesh_train and moe_mesh_serve; the group is
    destroyed in a finally. The record is the last line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("moe_mesh rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.ops import decode_attention as ops_dec
    from kubetorch_tpu_torch.ops import quant_matmul as ops_q4
    from kubetorch_tpu_torch.serving import distributed

    distributed.init_process_group()
    try:
        mesh = distributed.mesh()
        print(f"moe_mesh: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
              f"{dist.get_backend()}, world {dist.get_world_size()}", flush=True)
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            fail(f"moe_mesh: backend {dist.get_backend()} on {mesh.device_type}")
        train = moe_mesh_train(torch, mesh, ops_attn)
        gc.collect()
        torch.cuda.empty_cache()
        serve = moe_mesh_serve(torch, mesh, ops_attn, ops_dec, ops_q4)
    finally:
        distributed.destroy()
    if dist.is_initialized():
        fail("moe_mesh: the process group outlived its phase")
    print(json.dumps(dict(train=train, serve=serve)), flush=True)


# ---------------------------------------------------------------------------
# the data plane ("data_plane"): the port's own store client, broadcast tree
# and staging arena moving Llama-3-8B's full-width leaves onto the card
# ---------------------------------------------------------------------------


class _StandInStore:
    """The store's wire, the subset the port's client speaks (read off
    kubetorch_tpu/data_store/store_server.py, imported from nowhere): PUT,
    GET and HEAD of /kv/<key> with X-KT-Meta (size stamped, and stored_at
    unless the PUT carries one, as the store keeps a replicated write's;
    the client's blake2b kept, where the store server re-hashes the body:
    the getters verify every byte against the index anyway), POST /kv/diff
    (zlib bodies), GET /keys (kv keys and trees, by prefix), /route,
    /route/complete and /route/failed (a breadth-first tree of fan-out 2,
    each member's ktblobd address kept and handed to its children), and
    ktsync's POST /tree/<key>/diff and /commit (409 while a blob is
    missing), GET /tree/<key>/manifest and PUT/GET /blob/<hash> (kept
    unverified: the puller checks each blob against its hash). Kept in
    this process's memory; ThreadingHTTPServer on a free port of
    localhost."""

    FANOUT = 2

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.kv = {}            # key -> (bytes, meta)
        self.blobs = {}         # blake2b -> bytes
        self.trees = {}         # key -> manifest
        self.routes = {}        # key -> {url: {"parent", "children", "depth",
        #                                       "blob_url"}}
        self.lock = threading.Lock()
        store = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and body leave in two writes: with Nagle on, each
            # small reply waits out the client's delayed ACK (~40 ms)
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def reply(self, status, body=b"", headers=(), head=False):
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if not head:
                    self.wfile.write(body)

            def json_reply(self, status, obj):
                self.reply(status, json.dumps(obj).encode(),
                           [("Content-Type", "application/json")])

            def body(self):
                import zlib
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.headers.get("Content-Encoding") == "zlib":
                    raw = zlib.decompress(raw)
                return raw

            def key(self, prefix, suffix=""):
                from urllib.parse import unquote
                path = self.path.split("?", 1)[0]
                return unquote(path[len(prefix):len(path) - len(suffix)])

            def do_PUT(self):
                import hashlib
                if self.path.startswith("/blob/"):
                    data = self.body()
                    with store.lock:
                        store.blobs[self.key("/blob/")] = data
                    return self.json_reply(200, {"ok": True, "size": len(data)})
                key, data = self.key("/kv/"), self.body()
                meta = json.loads(self.headers.get("X-KT-Meta") or "{}")
                if "blake2b" not in meta:       # the client's hash is kept
                    meta["blake2b"] = hashlib.blake2b(
                        data, digest_size=20).hexdigest()
                meta["size"] = len(data)
                meta.setdefault("stored_at", round(time.time(), 6))
                with store.lock:
                    store.kv[key] = (data, meta)
                self.json_reply(200, {"ok": True, "size": len(data)})

            def do_GET(self, head=False):
                from urllib.parse import parse_qs, urlsplit
                if self.path.startswith("/keys"):
                    prefix = parse_qs(urlsplit(self.path).query).get(
                        "prefix", [""])[0]
                    with store.lock:
                        keys = ([{"key": k, "size": len(v[0]), "kind": "kv"}
                                 for k, v in store.kv.items()]
                                + [{"key": k, "kind": "tree"}
                                   for k in store.trees])
                    return self.json_reply(200, {"keys": sorted(
                        (k for k in keys if k["key"].startswith(prefix)),
                        key=lambda k: k["key"])})
                if self.path.startswith("/tree/"):
                    manifest = store.trees.get(self.key("/tree/", "/manifest"))
                    if manifest is None:
                        return self.json_reply(404, {"error": "no such tree"})
                    return self.json_reply(200, manifest)
                if self.path.startswith("/blob/"):
                    data = store.blobs.get(self.key("/blob/"))
                    if data is None:
                        return self.json_reply(404, {"error": "no such blob"})
                    return self.reply(200, data, head=head)
                if not self.path.startswith("/kv/"):
                    return self.json_reply(404, {"error": "not here"})
                held = store.kv.get(self.key("/kv/"))
                if held is None:
                    return self.json_reply(404, {"error": "no such key"})
                self.reply(200, held[0], [("X-KT-Meta", json.dumps(held[1]))],
                           head=head)

            def do_HEAD(self):
                self.do_GET(head=True)

            def do_POST(self):
                body = json.loads(self.body() or b"{}")
                if self.path == "/kv/diff":
                    missing = [k for k, h in body["keys"].items()
                               if store.kv.get(k, (0, {}))[1].get("blake2b") != h]
                    return self.json_reply(200, {"missing": sorted(missing)})
                if self.path.startswith("/tree/"):
                    files = body.get("files", {})
                    missing = sorted({f["hash"] for f in files.values()}
                                     - set(store.blobs))
                    if self.path.endswith("/diff"):
                        return self.json_reply(200, {"missing": missing})
                    if missing:
                        return self.json_reply(409, {"error": "missing blobs",
                                                     "missing": missing})
                    with store.lock:
                        store.trees[self.key("/tree/", "/commit")] = {
                            "files": files, "committed_at": time.time()}
                    return self.json_reply(200, {"ok": True,
                                                 "files": len(files)})
                with store.lock:
                    group = store.routes.setdefault(body["key"], {})
                    if self.path == "/route":
                        out = store.route(group, body.get("self_url"),
                                          body.get("self_blob_url"))
                    elif self.path == "/route/complete":
                        member = group.setdefault(body["url"], {
                            "parent": None, "children": 0, "depth": 1,
                            "blob_url": None})
                        if body.get("blob_url"):
                            member["blob_url"] = body["blob_url"]
                        out = {"ok": True, "members": len(group)}
                    elif self.path == "/route/failed":
                        out = {"evicted": group.pop(body["url"], None) is not None}
                    else:
                        return self.json_reply(404, {"error": "no route"})
                self.json_reply(200, out)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def route(self, group, self_url, self_blob_url=None):
        """The shallowest member with a free child slot parents the caller
        (the store roots the first); the caller joins the tree at once,
        with its ktblobd address when it runs one."""
        cands = sorted((m["depth"], m["children"], u) for u, m in group.items()
                       if m["children"] < self.FANOUT and u != self_url)
        parent = cands[0][2] if cands else None
        depth = group[parent]["depth"] + 1 if parent else 1
        if self_url:
            group[self_url] = {"parent": parent, "children": 0, "depth": depth,
                               "blob_url": self_blob_url}
        if parent is None:
            return {"source": "store", "depth": depth}
        group[parent]["children"] += 1
        return {"source": "peer", "url": parent,
                "blob_url": group[parent]["blob_url"], "depth": depth}

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class _CacheServer:
    """The fabric pod server's /_kt/data/<key> over one pod-cache
    directory: the entry the port's peer_cache wrote there (its
    blake2b-16 name, .bin and .json), with its meta in X-KT-Meta."""

    def __init__(self, cache_dir, port):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import unquote

        from kubetorch_tpu_torch.data_store.peer_cache import entry_hash

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
                key = unquote(self.path[len("/_kt/data/"):])
                base = os.path.join(cache_dir, entry_hash(key))
                try:
                    with open(base + ".json") as f:
                        entry = json.load(f)
                    with open(base + ".bin", "rb") as f:
                        data = f.read()
                except OSError:
                    entry, data = None, b""
                if entry is None or entry.get("key") != key:
                    body = b'{"error": "not cached"}'
                    self.send_response(404)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("X-KT-Meta", json.dumps(entry.get("meta", {})))
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def data_plane_tree(torch):
    """Llama-3-8B's leaves at full width and DATA_PLANE_LAYERS layers, bf16
    weights and fp32 norms, drawn on the card from DATA_PLANE_SEED."""
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    cfg = LlamaConfig.llama3_8b(n_layers=DATA_PLANE_LAYERS)
    return llama_init(cfg, seed=DATA_PLANE_SEED, device="cuda")


def check_landed(torch, label, tree, want):
    """Every landed leaf (a tensor, or a DTensor's local block: here the
    whole leaf) is on the card and has the sent tree's checksum
    (leaf_hashes, on the card), path by path; the bytes were checked
    against the index's blake2b on the way in."""
    from kubetorch_tpu_torch.data_store import commands as ds
    leaves = {}
    ds._flatten(tree, "", leaves)
    leaves = {p: (x.to_local() if hasattr(x, "to_local") else x)
              for p, x in sorted(leaves.items())}
    if set(leaves) != set(want):
        fail(f"data_plane: {label}: leaves {sorted(set(leaves) ^ set(want))} "
             "missing or extra")
    if any(not x.is_cuda for x in leaves.values()):
        fail(f"data_plane: {label}: a leaf did not land on the card")
    got = dict(zip(leaves, leaf_hashes(torch, list(leaves.values()))))
    bad = [p for p in want if got[p] != want[p]]
    if bad:
        fail(f"data_plane: {label}: leaves {bad} differ from the tree sent")


def wait_for_go(label, path, timeout=300):
    """Block until the phase creates ``path`` (a pod's cue)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            fail(f"data_plane: {label}: no go from the phase")
        time.sleep(0.02)


def touch(path):
    with open(path, "w"):
        pass


def data_plane_rank() -> None:
    """One pod of the "data_plane" phase (DATA_PLANE_FLAG), spec in
    DATA_PLANE_SPEC_ENV; every landed leaf is held to the sent tree's
    checksums, and the record (seconds, bytes by source) is the last line.
    mode "peer" first loads the tree staged by the parent: load_staged
    onto the card and then as DTensors on a world-of-1 mesh (nccl,
    LLAMA_RULES). Then each of the spec's `gets`, once its `go` file
    exists: get(key, device="cuda", peer=True) through the broadcast tree
    as a pod with that step's cache directory and server port (a new
    member of the tree), the bytes each source served read off
    kt_store_fetch_bytes_total{source} around the call (the pod's cache
    fills and /route/complete makes it a parent); its `done` file
    follows. Then, with a `sync` in the spec, ktsync: get(key, dest=) of
    the HF directory, load_hf(dest, device="cuda") held to the seed tree
    leaf by leaf (dtype, shape, checksum), a second pull that must fetch
    nothing, and after the phase's `go2` a third that must fetch the one
    file added."""
    import torch

    from kubetorch_tpu_torch import telemetry
    from kubetorch_tpu_torch.data_store import commands as ds
    from kubetorch_tpu_torch.data_store import staging

    spec = json.loads(os.environ[DATA_PLANE_SPEC_ENV])
    url, key, want = spec["url"], spec["key"], spec["sums"]
    rec = {"mode": spec["mode"]}
    torch.cuda.init()
    if spec["mode"] == "peer":
        from torch.distributed.tensor import DTensor, Replicate

        from kubetorch_tpu_torch.parallel import LLAMA_RULES
        from kubetorch_tpu_torch.serving import distributed
        staged_want = {p: want[p] for p in json.loads(spec["handle"])["leaves"]}
        t = time.perf_counter()
        staged = staging.load_staged(spec["handle"], device="cuda")
        torch.cuda.synchronize()
        rec["load_staged_s"] = time.perf_counter() - t
        check_landed(torch, "load_staged(device='cuda')", staged, staged_want)
        del staged
        distributed.init_process_group()
        try:
            mesh = distributed.mesh()
            # DTensor's first use costs seconds in a process: paid here,
            # outside the timed load
            DTensor.from_local(torch.ones(1, device="cuda"), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
            t = time.perf_counter()
            tree = staging.load_staged(spec["handle"], mesh=mesh,
                                       rules=LLAMA_RULES)
            torch.cuda.synchronize()
            rec["load_staged_mesh_s"] = time.perf_counter() - t
            leaves = {}
            ds._flatten(tree, "", leaves)
            if not all(isinstance(x, DTensor) for x in leaves.values()):
                fail("data_plane: load_staged(mesh=) gave a leaf that is not "
                     "a DTensor")
            rec["mesh"] = str(mesh)
            check_landed(torch, "load_staged(mesh=, rules=LLAMA_RULES)", tree,
                         staged_want)
            del tree, leaves
        finally:
            distributed.destroy()
    fetch_bytes = telemetry.counter("kt_store_fetch_bytes_total",
                                    labels=("source",))
    sources = ("store", "peer", "pod-cache")
    for step in spec["gets"]:
        label = f"{spec['mode']} {step['label']}"
        wait_for_go(label, step["go"])
        os.environ.update(KT_DATA_CACHE_DIR=step["cache"],
                          KT_SERVER_PORT=str(step["port"]))
        before = {src: fetch_bytes.value(source=src) for src in sources}
        t = time.perf_counter()
        tree = ds.get(key, store_url=url, device="cuda", peer=True)
        torch.cuda.synchronize()
        moved = {src: int(fetch_bytes.value(source=src) - before[src])
                 for src in sources}
        rec[step["label"]] = dict(
            get_s=time.perf_counter() - t,
            bytes_by_source={src: n for src, n in moved.items() if n})
        check_landed(torch, f"{label}: get(device='cuda')", tree, want)
        del tree
        touch(step["done"])
    if spec.get("sync"):
        rec["sync"] = sync_pod_steps(torch, url, spec["sync"])
    print(json.dumps(rec), flush=True)


def sync_pod_steps(torch, url, sync):
    """Pod B's part of (b): pull the HF directory with ktsync, load it onto
    the card, hold it to the seed tree; pull again (nothing), and after
    `go2` once more (the added file only)."""
    from kubetorch_tpu_torch.data_store import commands as ds
    from kubetorch_tpu_torch.models import load_hf

    wait_for_go("sync", sync["go"])
    out = {}
    t = time.perf_counter()
    out["pull"] = ds.get(sync["key"], dest=sync["dest"], store_url=url)
    out["pull_s"] = time.perf_counter() - t
    if out["pull"] != {"files": sync["files"], "fetched": sync["files"],
                       "deleted": 0}:
        fail(f"data_plane: sync: the first pull gave {out['pull']}")
    t = time.perf_counter()
    params, _ = load_hf(sync["dest"], device="cuda")
    torch.cuda.synchronize()
    out["load_hf_s"] = time.perf_counter() - t
    leaves = named_leaves(params)
    got = {p: [str(x.dtype), list(x.shape), h] for (p, x), h in zip(
        sorted(leaves.items()),
        leaf_hashes(torch, [leaves[p] for p in sorted(leaves)]))}
    bad = sorted(p for p in set(got) | set(sync["want"])
                 if got.get(p) != sync["want"].get(p))
    if bad:
        fail(f"data_plane: sync: load_hf of the pulled directory differs "
             f"from the seed tree at {bad[:4]}")
    if not all(x.is_cuda for x in leaves.values()):
        fail("data_plane: sync: load_hf did not land on the card")
    del params, leaves
    out["pull_again"] = ds.get(sync["key"], dest=sync["dest"], store_url=url)
    if out["pull_again"]["fetched"] != 0:
        fail(f"data_plane: sync: a second pull fetched {out['pull_again']}")
    touch(sync["done"])
    wait_for_go("sync added file", sync["go2"])
    out["pull_added"] = ds.get(sync["key"], dest=sync["dest"], store_url=url)
    if out["pull_added"] != {"files": sync["files"] + 1, "fetched": 1,
                             "deleted": 0}:
        fail(f"data_plane: sync: after one added file the pull gave "
             f"{out['pull_added']}")
    return out


def start_data_plane_pod(label, spec, env):
    """This script as a pod of the data plane (data_plane_rank), started
    and left running: (process, its output file)."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(TORCH_RANK_ENV, MASTER_PORT=str(free_tcp_port()),
               KT_MESH='{"fsdp": -1}', **env)
    env[DATA_PLANE_SPEC_ENV] = json.dumps(spec)
    print(f"{label}: starting a pod, spec {spec['mode']}", flush=True)
    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             DATA_PLANE_FLAG],
                            env=dict(os.environ, PYTHONPATH=here, **env),
                            stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, log


def finish_data_plane_pod(label, pod, timeout=300):
    """Wait for a pod; its output but the last line printed, its last
    line (the record) returned. A pod that exits non-zero fails."""
    proc, log = pod
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.seek(0)
    out = log.read().strip().splitlines()
    log.close()
    for line in out[:-1]:
        print(line, flush=True)
    if proc.returncode != 0:
        fail(f"{label}: the pod exited {proc.returncode}: "
             + "\n".join(out[-30:]))
    return json.loads(out[-1])


def wait_for_pod_step(label, pod, path, timeout=300):
    """Block until a running pod creates ``path``; a pod that exits first
    fails the phase with its output."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if pod[0].poll() is not None:
            finish_data_plane_pod(label, pod)
            fail(f"{label}: the pod exited before {os.path.basename(path)}")
        if time.monotonic() > deadline:
            fail(f"{label}: no {os.path.basename(path)} in {timeout}s")
        time.sleep(0.02)


def build_blobd(here):
    """The fabric's native peer daemon (kubetorch_tpu/native/ktblobd.cpp,
    which the fabric's pod server runs beside each pod) built with g++
    into the gitignored kubetorch_tpu_torch/_build/; the compile is left
    running: (process, binary)."""
    out_dir = os.path.join(here, "kubetorch_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    binary = os.path.join(out_dir, "ktblobd")
    proc = subprocess.Popen(
        ["g++", "-O3", "-std=c++17", "-o", binary,
         os.path.join(here, "kubetorch_tpu", "native", "ktblobd.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, binary


def spawn_blobd(build, root):
    """ktblobd over the pod cache ``root`` on a free port of localhost, once
    its build is done: (process, port)."""
    out = build[0].communicate()[0]
    if build[0].returncode != 0:
        fail(f"data_plane: building ktblobd failed: {out[-2000:]}")
    proc = subprocess.Popen([build[1], "--root", root, "--host", "127.0.0.1",
                             "--port", "0"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline().strip()
    if not line.startswith("PORT "):
        proc.kill()
        proc.wait()
        fail(f"data_plane: ktblobd did not start: {line!r}")
    return proc, int(line.split()[1])


def sync_seed_dir(torch, path):
    """(b)'s source: Llama-3.2-1B from SYNC_SEED on the card, bf16, its
    norms from SYNC_NORM_SEED rounded to bf16 (kept fp32, as load_hf gives
    them), the head tied to the embedding, written in Meta's published
    layout by the script's own writer. Returns (bytes of tensor data,
    {path: [dtype, shape, checksum]} of the tree load_hf must give)."""
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    cfg = LlamaConfig.llama3_1b()
    src = llama_init(cfg, seed=SYNC_SEED, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SYNC_NORM_SEED)
    L = cfg.n_layers
    for tree, key, shape in ((src["layers"], "attn_norm", (L, cfg.dim)),
                             (src["layers"], "ffn_norm", (L, cfg.dim)),
                             (src, "final_norm", (cfg.dim,))):
        tree[key] = (1.0 + 0.1 * torch.randn(shape, generator=g, device="cuda")
                     ).to(torch.bfloat16).float()
    src["lm_head"] = src["embed"].t().contiguous()
    items = [it for it in hf_items_from_tree(torch, src, cfg, torch.bfloat16)
             if it[0] != "lm_head.weight"]
    nbytes, shards = write_hf_checkpoint(torch, path, META_LLAMA32_1B, items)
    if shards != 1:
        fail(f"data_plane: sync: {shards} shards, Meta's layout has one")
    leaves = named_leaves(src)
    want = {p: [str(x.dtype), list(x.shape), h] for (p, x), h in zip(
        sorted(leaves.items()),
        leaf_hashes(torch, [leaves[p] for p in sorted(leaves)]))}
    return nbytes, want


def drive_xregion(torch, east, sums, nbytes, card):
    """(c): the tree's commit marker put beside it in "east" (the phase's
    store) as train/checkpoint.py writes it; the port's XRegionReplicator
    sweeps east into a second stand-in, "west", twice (the second must push
    nothing, lag 0); east stops; in west fallback_commit finds the marker
    (KT_FED_STORES naming both regions) and get onto the card gives every
    leaf the sent checksums."""
    from kubetorch_tpu_torch.data_store import commands as ds
    from kubetorch_tpu_torch.federation import (XRegionReplicator,
                                                fallback_commit)
    from kubetorch_tpu_torch.train import checkpoint as ck

    marker = {"step": DATA_PLANE_STEP, "slot": 0}
    ds.put_json(ck._marker_key(DATA_PLANE_BASE), marker, store_url=east.url)
    moved = sum(len(v[0]) for v in east.kv.values())
    west = _StandInStore()
    env = {k: os.environ.get(k) for k in ("KT_FED_STORES", "KT_FED_SELF_REGION")}
    try:
        rep = XRegionReplicator(east.url, {"west": west.url})
        t = time.perf_counter()
        first = rep.sweep()
        sweep_s = time.perf_counter() - t
        second = rep.sweep()
        want_keys = len(east.kv)
        if first["targets"]["west"] != {"pushed": want_keys, "skipped": 0,
                                        "failed": 0, "lag_s": 0.0}:
            fail(f"data_plane: xregion: the first sweep gave {first}, want "
                 f"{want_keys} keys pushed")
        if second["targets"]["west"] != {"pushed": 0, "skipped": want_keys,
                                         "failed": 0, "lag_s": 0.0}:
            fail(f"data_plane: xregion: the second sweep gave {second}")
        stamps = {k: (east.kv[k][1]["stored_at"], west.kv[k][1]["stored_at"])
                  for k in east.kv}
        if any(a != b for a, b in stamps.values()):
            fail("data_plane: xregion: a stored_at changed on its way west")
        east.close()
        os.environ["KT_FED_STORES"] = f"east={east.url},west={west.url}"
        os.environ.pop("KT_FED_SELF_REGION", None)
        found = fallback_commit(DATA_PLANE_BASE, exclude=east.url)
        if found != (marker, west.url):
            fail(f"data_plane: xregion: fallback_commit in west found {found}")
        t = time.perf_counter()
        got = ds.get(ck._slot_key(DATA_PLANE_BASE, found[0]["slot"]),
                     store_url=found[1], device="cuda")
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t
        check_landed(torch, "xregion: get in west", got, sums)
        del got
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        west.close()
    rec = dict(keys=want_keys, bytes=moved, sweep_s=sweep_s,
               sweep_gb_per_s=moved / sweep_s / 1e9, sweeps=[first, second],
               west_get_s=get_s, west_get_gb_per_s=nbytes / get_s / 1e9)
    print(f"data_plane: (c) xregion: one sweep of {want_keys} keys, {moved} "
          f"bytes east -> west in {sweep_s:.2f}s ({rec['sweep_gb_per_s']:.3f} "
          f"GB/s); second sweep {second['targets']['west']}; east stopped, "
          f"fallback_commit {found[0]} in west, get onto the card "
          f"{get_s:.2f}s ({rec['west_get_gb_per_s']:.3f} GB/s) card={card}",
          flush=True)
    return rec


def drive_data_plane(card):
    """The port's data plane on the card ("data_plane"): the seeded tree of
    data_plane_tree (~2.97 GB) put from the card into the script's store
    stand-in (_StandInStore) as slot 0 of a checkpoint; pod A (a process
    with its own pod cache, its ktblobd over it) gets it onto the card;
    pod B, started beside A, loads the tree staged here into the port's
    shared-memory arena onto the card and as DTensors on a world-of-1 mesh.
    (a) With A's pod route down, B is routed to A and takes every byte from
    A's ktblobd (peer bytes: the tree and its index, store bytes at most the
    index); then, the daemon stopped and a cache server over A's directory
    standing in for A's pod server, B as a new member takes them over the
    pod route. (b) ktsync: Llama-3.2-1B's HF directory (~2.5 GB) put, put
    again (0 uploaded), pulled in B and loaded onto the card bitwise the
    seed tree, pulled again (0 fetched); one file added moves one blob each
    way. (c) drive_xregion. /dev/shm's free bytes size the staging: the
    largest set of whole leaves that fits, printed as a reduction when it
    is not all of them. GB/s of each move, beside the card."""
    import shutil

    import torch

    from kubetorch_tpu_torch.data_store import commands as ds
    from kubetorch_tpu_torch.data_store import staging
    from kubetorch_tpu_torch.models.llama import LlamaConfig

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, DATA_PLANE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    build = build_blobd(here)
    tree = data_plane_tree(torch)
    leaves = {}
    ds._flatten(tree, "", leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves.values())
    sums = dict(zip(sorted(leaves), leaf_hashes(
        torch, [leaves[p] for p in sorted(leaves)])))
    c1b = LlamaConfig.llama3_1b()
    sync_est = (c1b.param_count() - c1b.vocab_size * c1b.dim) * 2
    need = 3 * nbytes + 2 * sync_est + 10 ** 9
    free_disk = shutil.disk_usage(root).free
    if free_disk < need:
        fail(f"data_plane: {free_disk} bytes free on disk, the three pod "
             f"caches and the two HF directories need {need}")
    store = _StandInStore()
    cache_srv = daemon = handle = None
    # the segments' names are this run's alone: another checkout may run
    # the phase at the same time
    shm_prefix = f"ktp-smoke-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    pod_a = pod_b = None
    cue = {n: os.path.join(root, n) for n in (
        "go-a", "done-a", "go-blobd", "done-blobd", "go-route", "done-route",
        "go-sync", "done-sync", "go-sync2")}
    try:
        # A starts before the put (its start-up overlaps it) and fetches
        # once told; B starts beside A, its start-up and its staged loads
        # overlapping A's fetch and the HF directory's push
        cache_a = os.path.join(root, "cache-a")
        os.makedirs(cache_a)
        daemon, blobd_port = spawn_blobd(build, cache_a)
        port_a = free_tcp_port()
        base = dict(POD_IP="127.0.0.1", KT_DATA_CACHE_MAX_BYTES=str(4 * nbytes))
        pod_a = start_data_plane_pod("data_plane pod A", {
            "mode": "get", "url": store.url, "key": DATA_PLANE_KEY,
            "sums": sums, "gets": [dict(label="store", go=cue["go-a"],
                                        done=cue["done-a"], cache=cache_a,
                                        port=port_a)]},
            dict(base, KT_BLOBD_PORT=str(blobd_port)))
        t = time.perf_counter()
        put = ds.put(DATA_PLANE_KEY, tree, store_url=store.url)
        put_s = time.perf_counter() - t
        if put["bytes"] != nbytes:
            fail(f"data_plane: put moved {put['bytes']} of {nbytes} bytes")
        index_bytes = len(store.kv[DATA_PLANE_KEY + ds._INDEX_SUFFIX][0])
        touch(cue["go-a"])
        hf_dir = os.path.join(root, "Llama-3.2-1B")
        t = time.perf_counter()
        sync_bytes, sync_want = sync_seed_dir(torch, hf_dir)
        sync_write_s = time.perf_counter() - t
        shm = os.statvfs("/dev/shm")
        shm_free = shm.f_bavail * shm.f_frsize
        staged_paths, room = [], shm_free - (64 << 20)
        for p, x in sorted(leaves.items(),
                           key=lambda kv: -kv[1].numel() * kv[1].element_size()):
            size = x.numel() * x.element_size()
            if size <= room:
                staged_paths.append(p)
                room -= size
        staged_bytes = sum(leaves[p].numel() * leaves[p].element_size()
                           for p in staged_paths)
        if staged_bytes < nbytes:
            print(f"data_plane: reduction: /dev/shm has {shm_free} bytes free; "
                  f"staging {len(staged_paths)} of {len(leaves)} whole leaves, "
                  f"{staged_bytes} of {nbytes} bytes", flush=True)
        t = time.perf_counter()
        handle = staging.stage_pytree(
            shm_prefix, {p.replace("/", "."): leaves[p] for p in staged_paths})
        stage_s = time.perf_counter() - t
        # the handle's leaves under their tree paths, so B checks them
        wire = json.loads(staging.handle_to_json(handle))
        wire["leaves"] = {p.replace(".", "/"): h for p, h in wire["leaves"].items()}
        wire["structure"] = {p: "leaf" for p in wire["leaves"]}
        files = len(os.listdir(hf_dir))
        dir_bytes = sum(os.path.getsize(os.path.join(hf_dir, f))
                        for f in os.listdir(hf_dir))
        pod_b = start_data_plane_pod("data_plane pod B", {
            "mode": "peer", "url": store.url, "key": DATA_PLANE_KEY,
            "sums": sums, "handle": json.dumps(wire),
            "gets": [dict(label="blobd", go=cue["go-blobd"],
                          done=cue["done-blobd"],
                          cache=os.path.join(root, "cache-b"),
                          port=free_tcp_port()),
                     dict(label="pod_route", go=cue["go-route"],
                          done=cue["done-route"],
                          cache=os.path.join(root, "cache-b2"),
                          port=free_tcp_port())],
            "sync": dict(key=SYNC_KEY, dest=os.path.join(root, "sync-b"),
                         files=files, want=sync_want, go=cue["go-sync"],
                         done=cue["done-sync"], go2=cue["go-sync2"])},
            dict(base, KT_PEER_WAIT_S="30"))
        # (b) the HF directory pushed while A fetches and B loads
        t = time.perf_counter()
        push = ds.put(SYNC_KEY, hf_dir, store_url=store.url)
        push_s = time.perf_counter() - t
        t = time.perf_counter()
        push_again = ds.put(SYNC_KEY, hf_dir, store_url=store.url)
        push_again_s = time.perf_counter() - t
        if push != {"files": files, "uploaded": files,
                    "uploaded_bytes": dir_bytes}:
            fail(f"data_plane: sync: the first push gave {push}")
        if push_again["uploaded"] != 0:
            fail(f"data_plane: sync: a second push gave {push_again}")
        a = finish_data_plane_pod("data_plane pod A", pod_a)
        # (a) A's pod route is down (nothing listens on its port): B's
        # bytes can come from A's ktblobd or, failing it, the store only
        t_a = time.perf_counter()
        touch(cue["go-blobd"])
        wait_for_pod_step("data_plane pod B", pod_b, cue["done-blobd"])
        blobd_s = time.perf_counter() - t_a
        daemon.terminate()
        daemon.wait(timeout=10)
        daemon = None
        # the daemon is gone: a new member routed to A falls back to A's
        # pod route, which a cache server over A's directory stands in for
        cache_srv = _CacheServer(cache_a, port_a)
        touch(cue["go-route"])
        wait_for_pod_step("data_plane pod B", pod_b, cue["done-route"])
        t_b = time.perf_counter()
        touch(cue["go-sync"])
        wait_for_pod_step("data_plane pod B", pod_b, cue["done-sync"])
        name, body = SYNC_ADDED
        with open(os.path.join(hf_dir, name), "w") as f:
            json.dump(body, f, indent=2)
        added = ds.put(SYNC_KEY, hf_dir, store_url=store.url)
        if added != {"files": files + 1, "uploaded": 1, "uploaded_bytes":
                     os.path.getsize(os.path.join(hf_dir, name))}:
            fail(f"data_plane: sync: after one added file the push gave {added}")
        touch(cue["go-sync2"])
        b = finish_data_plane_pod("data_plane pod B", pod_b)
        sync_s = push_s + push_again_s + time.perf_counter() - t_b
        t_c = time.perf_counter()
        xregion = drive_xregion(torch, store, sums, nbytes, card)
        xregion["seconds"] = time.perf_counter() - t_c
    finally:
        for pod in (pod_a, pod_b):
            if pod is not None and pod[0].poll() is None:
                pod[0].kill()
                pod[0].wait()
        if daemon is not None:
            daemon.kill()
            daemon.wait()
        if build[0].poll() is None:
            build[0].kill()
            build[0].wait()
        if handle is not None:
            staging.release_handle(handle)
        if cache_srv is not None:
            cache_srv.close()
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    if any(os.path.exists(f"/dev/shm/{shm_prefix}-{i}")
           for i in range(len(staged_paths))):
        fail("data_plane: a staged segment outlived its last release")
    src_a = a["store"]["bytes_by_source"]
    if src_a.get("store", 0) != nbytes + index_bytes:
        fail(f"data_plane: pod A fetched {src_a}, want the tree and its index "
             f"({nbytes} + {index_bytes}) from the store")
    for step in ("blobd", "pod_route"):
        src_b = b[step]["bytes_by_source"]
        if src_b.get("peer", 0) != nbytes + index_bytes or \
                src_b.get("store", 0) > index_bytes:
            fail(f"data_plane: pod B's {step} get fetched {src_b}, want "
                 f"{nbytes} + {index_bytes} from its peer and at most "
                 f"{index_bytes} from the store")
    sb = b["sync"]
    gb = nbytes / 1e9
    rates = dict(put=gb / put_s, get_cuda=gb / a["store"]["get_s"],
                 peer_get_blobd=gb / b["blobd"]["get_s"],
                 peer_get_pod_route=gb / b["pod_route"]["get_s"],
                 stage=staged_bytes / 1e9 / stage_s,
                 load_staged_cuda=staged_bytes / 1e9 / b["load_staged_s"],
                 load_staged_mesh=staged_bytes / 1e9 / b["load_staged_mesh_s"],
                 sync_push=dir_bytes / 1e9 / push_s,
                 sync_pull=dir_bytes / 1e9 / sb["pull_s"],
                 load_hf=sync_bytes / 1e9 / sb["load_hf_s"],
                 xregion_sweep=xregion["sweep_gb_per_s"],
                 xregion_west_get=xregion["west_get_gb_per_s"])
    rec = dict(tree_bytes=nbytes, index_bytes=index_bytes, leaves=len(leaves),
               staged_bytes=staged_bytes, shm_free_bytes=shm_free,
               gb_per_s=rates,
               bytes_by_source=dict(a=src_a,
                                    b_blobd=b["blobd"]["bytes_by_source"],
                                    b_pod_route=b["pod_route"]["bytes_by_source"]),
               seconds=dict(put=put_s, get=a["store"]["get_s"],
                            peer_get_blobd=b["blobd"]["get_s"],
                            peer_get_pod_route=b["pod_route"]["get_s"],
                            stage=stage_s, load_staged=b["load_staged_s"],
                            load_staged_mesh=b["load_staged_mesh_s"],
                            a_blobd=blobd_s, b_sync=sync_s,
                            c_xregion=xregion["seconds"]),
               sync=dict(dir_bytes=dir_bytes, tensor_bytes=sync_bytes,
                         write_s=sync_write_s, push=push, push_s=push_s,
                         push_again=push_again, push_again_s=push_again_s,
                         added=added, pod=sb),
               xregion=xregion, wall_s=time.perf_counter() - t_phase)
    print(f"data_plane: (a) blobd: pod B's peer get {b['blobd']['get_s']:.2f}s "
          f"({rates['peer_get_blobd']:.3f} GB/s) from A's ktblobd, beside "
          f"{b['pod_route']['get_s']:.2f}s ({rates['peer_get_pod_route']:.3f} "
          f"GB/s) over A's pod route; step {blobd_s:.2f}s card={card}",
          flush=True)
    print(f"data_plane: (b) ktsync: {dir_bytes} bytes in {files} files, push "
          f"{push_s:.2f}s ({rates['sync_push']:.3f} GB/s), again "
          f"{push_again_s:.2f}s (0 uploaded), pull in pod B {sb['pull_s']:.2f}s "
          f"({rates['sync_pull']:.3f} GB/s), load_hf {sb['load_hf_s']:.2f}s "
          f"bitwise the seed tree, pull again {sb['pull_again']}, one added "
          f"file {added} / {sb['pull_added']}; {sync_s:.2f}s card={card}",
          flush=True)
    print(f"data_plane: {nbytes} bytes in {len(leaves)} leaves (Llama-3-8B at "
          f"{DATA_PLANE_LAYERS} layers), /dev/shm free {shm_free}; GB/s "
          f"{json.dumps(rates)}; bytes by source {json.dumps(rec['bytes_by_source'])}; "
          f"seconds (a) {blobd_s:.1f} (b) {sync_s:.1f} (c) "
          f"{xregion['seconds']:.1f}; phase wall {rec['wall_s']:.1f}s "
          f"card={card}", flush=True)
    return rec


def cold_start_copy(root, name):
    """A copy of kubetorch_tpu_torch/ under root/name without _build/ (a
    fresh pod's checkout); returns root/name, the directory to run from."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    dest = os.path.join(root, name)
    shutil.copytree(os.path.join(here, "kubetorch_tpu_torch"),
                    os.path.join(dest, "kubetorch_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dest


def cold_boot_pod(label, cwd, spec, idx, timeout=600):
    """One fresh pod: ``python -m kubetorch_tpu_torch.serving.warm_template
    --cold`` run from ``cwd`` (its own copy of the package). Fails unless it
    exits 0; returns its record (cold_<idx>.json)."""
    spec_path = os.path.join(cwd, f"spec_{idx}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(cwd, "pod.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubetorch_tpu_torch.serving.warm_template",
             "--cold", spec_path, str(idx), repr(time.time())],
            cwd=cwd, env=dict(os.environ, PYTHONPATH=cwd), stdout=log,
            stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        with open(log_path) as f:
            fail(f"cold_start: {label} exited {proc.returncode}: "
                 f"{f.read()[-3000:]}")
    with open(os.path.join(spec["result_dir"], f"cold_{idx}.json")) as f:
        return json.load(f)


def wait_replica(sup, result_dir, idx, timeout=300):
    """A forked replica's record (replica_<idx>.json); fails if it is not
    ok or does not come within ``timeout``."""
    path = os.path.join(result_dir, f"replica_{idx}.json")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            fail(f"cold_start: replica {idx} wrote nothing in {timeout}s; "
                 f"template log: {sup.log_tail()}")
        time.sleep(0.05)
    with open(path) as f:
        rec = json.load(f)
    if not rec["ok"]:
        fail(f"cold_start: replica {idx}: {rec['error']}; template log: "
             f"{sup.log_tail()}")
    return rec


def check_boot(label, rec, want_tokens, cfg, flash_buckets):
    """A boot's probe tokens against the in-process engine's, and its A1
    and B1 launches against its warm passes (one prefill per bucket through
    A1 where it flashes, one decode block), its probe's prefill (its bucket
    flashes) and its decode steps, L each."""
    if rec["tokens"] != want_tokens:
        fail(f"cold_start: {label} tokens {rec['tokens']} != the in-process "
             f"engine's {want_tokens}")
    L, c = cfg.n_layers, rec["counts"]
    want = dict(flash_fwd=L * (flash_buckets + 1), decode_attention=L * (
        COLD_START_ENGINE.get("decode_block", 1) + rec["decode_steps"]))
    got = {k: c[k] for k in want}
    if got != want or c["decode_attention_quant"] or c["q4_matmul"]:
        fail(f"cold_start: {label} launches {c}, expected {want}")


def drive_cold_start(card):
    """A serving replica's cold start on the card ("cold_start"): the
    module docstring's item 7. Returns the phase's record: each boot's
    phases, cache counts, nvcc runs and launches."""
    import shutil

    import torch

    from kubetorch_tpu_torch.models.generate import _flash_prefill_wanted
    from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serving import warm_template as wt

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, COLD_START_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = LlamaConfig.llama3_1b()
    params = llama_init(cfg, seed=COLD_START_SEED, device="cuda")
    probe = np.random.default_rng(COLD_START_SEED).integers(
        0, cfg.vocab_size, COLD_START_PROBE).tolist()
    eng = GenerationEngine(params, cfg, device="cuda", **COLD_START_ENGINE)
    want = eng.generate(probe, max_new_tokens=COLD_START_NEW)
    eng.stop()
    flash_buckets = sum(_flash_prefill_wanted(cfg, b, torch.device("cuda"))
                        for b in eng._buckets)
    if not _flash_prefill_wanted(cfg, eng._buckets[0], torch.device("cuda")):
        fail("cold_start: the probe's bucket does not take the flash branch")
    del eng
    t = time.perf_counter()
    weights = os.path.join(root, "weights.npy")
    wt.save_weights(weights, params)
    save_s = time.perf_counter() - t
    nbytes = sum(x.numel() * x.element_size() for x in
                 [params["embed"], params["lm_head"], params["final_norm"],
                  *params["layers"].values()])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(root, "out")
    spec = dict(weights=weights, model={"kind": "llama3-1b"}, device="cuda",
                engine=COLD_START_ENGINE, probe_prompt=probe,
                probe_tokens=COLD_START_NEW, result_dir=out)
    store = _StandInStore()
    sup = None
    seen = []
    # the template stages its segment while the pods boot (it runs no torch
    # op); it forks only once pod B has filled the root the forks read
    spawner = ThreadPoolExecutor(max_workers=1)
    template = spawner.submit(
        wt.TemplateSupervisor,
        dict(spec, aot_root=os.path.join(root, "aot-pod_b"), chaos=""),
        timeout=300.0, cwd=cold_start_copy(root, "template"))
    try:
        pods = {}
        for idx, label in enumerate(("pod_a", "pod_b")):
            cwd = cold_start_copy(root, label)
            pods[label] = cold_boot_pod(label, cwd, dict(
                spec, aot_root=os.path.join(root, f"aot-{label}"),
                aot_store_url=store.url), idx)
        sup = template.result()
        seen.append(sup.segment_name)
        forks = {}
        for idx in range(2):
            if not sup.fork(idx).get("ok"):
                fail(f"cold_start: fork {idx} refused")
            forks[f"fork_{idx}"] = wait_replica(sup, out, idx)
        template_respawns = sup.respawns
    finally:
        if sup is None:
            try:
                sup = template.result(timeout=330)
            except Exception:  # noqa: BLE001 — the phase is failing anyway
                pass
        if sup is not None:
            sup.shutdown()
            seen.append(sup.segment_name)
        spawner.shutdown()
        store.close()
    # the template's segment names carry its pid and a random suffix: this
    # run's alone, whatever else shares /dev/shm
    left = [n for n in seen if n and os.path.exists(f"/dev/shm/{n}")]
    shutil.rmtree(root, ignore_errors=True)
    if left:
        fail(f"cold_start: segments left in /dev/shm: {left}")
    if template_respawns:
        fail(f"cold_start: the template was respawned {template_respawns} "
             "times")
    boots = dict(pods, **forks)
    for label, rec in boots.items():
        check_boot(label, rec, want, cfg, flash_buckets)
    # pod A misses, builds and publishes each library; pod B hits from the
    # store, the forks from pod B's root; only pod A runs nvcc
    n = len(COLD_START_LIBS)
    signatures = len(COLD_START_ENGINE["prefill_buckets"]) + 1
    for label, want_aot, want_runs in (
            ("pod_a", dict(miss=n, publish=n, store_publish=n), n),
            ("pod_b", dict(store_hit=n, hit=n), 0),
            ("fork_0", dict(hit=n), 0), ("fork_1", dict(hit=n), 0)):
        rec = boots[label]
        want_aot = dict(want_aot, executables=signatures)
        if rec["aot"] != want_aot or rec["counts"]["nvcc_runs"] != want_runs:
            fail(f"cold_start: {label} counts {rec['aot']}, nvcc runs "
                 f"{rec['counts']['nvcc_runs']}: want {want_aot} and "
                 f"{want_runs}")
    a, b = pods["pod_a"], pods["pod_b"]
    for label in forks:
        if boots[label]["phases"]["import"] != 0.0:
            fail(f"cold_start: {label} paid import "
                 f"{boots[label]['phases']['import']}s")
    for label, rec in boots.items():
        print(f"cold_start: {label} phases {json.dumps(rec['phases'])} total "
              f"{rec['total_s']:.3f}s aot {rec['aot']} nvcc runs "
              f"{rec['counts']['nvcc_runs']} card={card}", flush=True)
    print(f"cold_start: compile_or_cache pod A (miss, nvcc) "
          f"{a['phases']['compile_or_cache']:.3f}s vs pod B (store hit) "
          f"{b['phases']['compile_or_cache']:.3f}s; weights {nbytes} bytes "
          f"saved in {save_s:.2f}s card={card}", flush=True)
    return dict(weights_bytes=nbytes, save_s=save_s,
                boots={k: dict(phases=r["phases"], total_s=r["total_s"],
                               aot=r["aot"], nvcc_runs=r["counts"]["nvcc_runs"],
                               decode_steps=r["decode_steps"],
                               launches={n: r["counts"][n]
                                         for n in COLD_START_LIBS})
                       for k, r in boots.items()},
                wall_s=time.perf_counter() - t_phase)


def drive_pipe(card):
    """Pipeline parallelism ("pipe"): pipe_rank as a world of 1 (run_rank),
    then PIPE_RANKS ranks of pipe_ranks on the card (spawn_ranks). Returns
    the phase's record with each run's A1/A2/A3 launches."""
    t0 = time.perf_counter()
    one = run_rank("pipe", PIPE_RANK_FLAG, PIPE_ENV)
    one["wall_s"] = time.perf_counter() - t0
    ranks = spawn_ranks("pipe ranks", PIPE_RANKS_FLAG, PIPE_RANKS, PIPE_RANKS_ENV)
    wall = time.perf_counter() - t0
    hop_s = sum(sum(r["hop_s"].values()) for r in ranks["runs"].values())
    print(f"pipe: phase wall {wall:.1f}s (world of 1 {one['wall_s']:.1f}s, "
          f"{PIPE_RANKS} ranks {ranks['wall_s']:.1f}s); rank 0's hops "
          f"{hop_s:.3f}s, {hop_s / wall:.4f} of the phase, "
          f"{hop_s / ranks['wall_s']:.4f} of the ranks' wall card={card}",
          flush=True)
    return dict(world_of_one=one, ranks=ranks, wall_s=wall, hop_s=hop_s,
                hop_share_of_phase=hop_s / wall)


def pipe_step_launches(L, M, passes=1):
    """A1/A2/A3 of ``passes`` forward-backward passes over L layers in M
    microbatches: each layer's forward and its rematerialization launch
    A1, its backward A2 and A3, once a microbatch."""
    return (2 * L * M * passes, L * M * passes, L * M * passes)


def pipe_rank() -> None:
    """The "pipe" phase's world of 1: distributed.init_process_group()
    (nccl), distributed.mesh() from KT_MESH (every axis dead, a one-dim
    mesh of size 1). Llama-3.2-1B's shape at full width and depth, bf16,
    attn_impl "flash", TRAIN_B x TRAIN_S, chunked CE of TRAIN_CHUNK,
    default_optimizer; the plain step (llama_loss_chunked, remat "dots"),
    then the pipelined step through make_train_step(mesh=,
    rules=PIPE_LLAMA_RULES) at each of PIPE_MICROBATCHES, MESH_STEPS steps
    each from the same seed and batch, the state freed between. Gates:
    A1/A2/A3 exact (pipe_step_launches); with one microbatch the losses,
    grad norms and every param hash bitwise the plain run's; with four each
    loss within LOSS_ABS. Prints ms/step, the busy share of MESH_PROFILED
    profiled steps and the peak memory of each run. The record is the last
    line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("pipe rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubetorch_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                                  llama_loss_chunked)
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.parallel import PIPE_LLAMA_RULES, llama_loss_pipelined
    from kubetorch_tpu_torch.serving import distributed
    from kubetorch_tpu_torch.train import (default_optimizer,
                                           init_train_state, make_train_step)

    fa = ops_attn.flash_attention
    cfg = LlamaConfig.llama3_1b(max_seq_len=TRAIN_S, attn_impl="flash",
                                n_layers=CUT_LAYERS)
    L = cfg.n_layers
    opt = default_optimizer(warmup_steps=2)
    batch = {k: v.cuda() for k, v in host_batch(torch, cfg.vocab_size, 1).items()}
    distributed.init_process_group()
    try:
        mesh = distributed.mesh()
        print(f"pipe: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
              f"{dist.get_backend()}, world {dist.get_world_size()}", flush=True)
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            fail(f"pipe: backend {dist.get_backend()} on {mesh.device_type}")
        runs = {}
        plans = [("plain", 1, lambda p, t, y: llama_loss_chunked(
            p, t, y, cfg, chunk=TRAIN_CHUNK), {})]
        for m in PIPE_MICROBATCHES:
            plans.append((f"pipe_m{m}", m, lambda p, t, y, m=m: llama_loss_pipelined(
                p, t, y, cfg, mesh, n_microbatches=m, chunk=TRAIN_CHUNK),
                dict(mesh=mesh, rules=PIPE_LLAMA_RULES)))
        for name, m, loss_fn, kw in plans:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state = init_train_state(llama_init(cfg, seed=0, device="cuda"), opt)
            step = make_train_step(loss_fn, opt, **kw)
            if kw:
                state = step.shard_state(state)
            fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            metrics, times = [], []
            for _ in range(MESH_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, met = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                metrics.append((met["loss"].item(), met["grad_norm"].item()))
            counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
            check_launches(f"pipe: {name} run, {MESH_STEPS} steps (A1, A2, A3)",
                           counts, pipe_step_launches(L, m, MESH_STEPS))
            hashes = leaf_hashes(torch, local_leaves(state.params))

            def one_step():
                nonlocal state
                state, _ = step(state, batch)

            prof = profile_steps(torch, f"pipe: {name} step, {MESH_PROFILED} "
                                 f"steps of {TRAIN_B}x{TRAIN_S}", one_step,
                                 MESH_PROFILED)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            runs[name] = dict(metrics=metrics, launches=counts, hashes=hashes,
                              ms_per_step=[t * 1e3 for t in times],
                              ms_per_warm_step=sum(times[1:]) / (len(times) - 1) * 1e3,
                              profile=prof, peak_memory_gb=peak)
            print(f"pipe: {name} run: losses/grad norms {metrics}; ms/step "
                  f"{runs[name]['ms_per_step']}; busy share "
                  f"{(prof or {}).get('device_busy_share')}; peak_memory_gb={peak}",
                  flush=True)
            del state, step, met
            gc.collect()
            torch.cuda.empty_cache()
        plain = runs["plain"]
        one = runs["pipe_m1"]
        bitwise = one["metrics"] == plain["metrics"] and one["hashes"] == plain["hashes"]
        print(f"pipe: 1 microbatch vs the plain step over {MESH_STEPS} steps: "
              f"losses and grad norms equal {one['metrics'] == plain['metrics']}, "
              f"param hashes equal {one['hashes'] == plain['hashes']}", flush=True)
        if not bitwise:
            fail("pipe: the pipelined step with 1 microbatch is not the plain step "
                 "bit for bit")
        four = runs["pipe_m4"]
        diffs = [abs(a[0] - b[0]) for a, b in zip(four["metrics"], plain["metrics"])]
        print(f"pipe: 4 microbatches vs the plain step: loss |diff| by step "
              f"{diffs} tol {LOSS_ABS}", flush=True)
        if not all(d <= LOSS_ABS for d in diffs):
            fail(f"pipe: 4 microbatches' losses part from the plain step's: {diffs}")
    finally:
        distributed.destroy()
    if dist.is_initialized():
        fail("pipe: the process group outlived its phase")
    keep = ("metrics", "launches", "ms_per_step", "ms_per_warm_step", "profile",
            "peak_memory_gb")
    print(json.dumps(dict(runs={k: {f: r[f] for f in keep} for k, r in runs.items()},
                          bitwise_m1=bitwise, loss_diff_m4=diffs,
                          launches={k: r["launches"] for k, r in runs.items()})),
          flush=True)


def pipe_ranks() -> None:
    """One of the PIPE_RANKS ranks of the "pipe" phase: gloo from the env
    (serving.distributed, device="cpu"), the card as cuda:0, the mesh of
    KT_MESH ({"pipe": 4}) on cuda, DTensor's collectives routed through
    c10d's eager ops. Llama-3.2-1B's shape at full width and CUT_LAYERS layers,
    bf16, attn_impl "flash", random weights from a seed. A GPipe step
    (make_train_step over llama_loss_pipelined, 4 microbatches, params by
    PIPE_LLAMA_RULES: CUT_LAYERS / 4 layers a rank) and an interleaved step
    (PIPE_VIRTUAL chunks a rank, laid out by llama_pipeline_place): each the
    gradients (grads_fn) and one default_optimizer step, each rank's
    A1/A2/A3 exact. Rank 0 then runs the plain step on the whole model:
    each pipelined loss within LOSS_ABS of its loss, the gathered
    gradients' relative L2 within PIPE_GRAD_REL_L2. Every hop's path
    (HOP_PATHS: host-staged on gloo) and wall time are counted, and their
    share of each step's wall time printed. The record is rank 0's last
    line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("pipe rank: torch.cuda.is_available() is false")
    import faulthandler
    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    from kubetorch_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                                  llama_loss_chunked)
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.parallel import pipeline as pl
    from kubetorch_tpu_torch.parallel.sharding import ShardingRules
    from kubetorch_tpu_torch.serving import distributed
    from kubetorch_tpu_torch.train import (default_optimizer,
                                           init_train_state, make_train_step)
    from kubetorch_tpu_torch.train.optim import tree_leaves

    fa = ops_attn.flash_attention
    cfg = LlamaConfig.llama3_1b(max_seq_len=TRAIN_S, attn_impl="flash",
                                n_layers=CUT_LAYERS)
    L, M = cfg.n_layers, 4
    opt = default_optimizer(warmup_steps=2)
    batch = {k: v.cuda() for k, v in host_batch(torch, cfg.vocab_size, 1).items()}
    distributed.init_process_group(device="cpu")
    torch.cuda.set_device(0)
    route_dtensor_collectives_through_c10d()
    rank = dist.get_rank()
    say = (lambda msg: print(msg, flush=True)) if rank == 0 else (lambda msg: None)
    hop = {"s": 0.0}
    real_p2p = pl._p2p

    def timed_p2p(*a):
        t = time.perf_counter()
        try:
            return real_p2p(*a)
        finally:
            hop["s"] += time.perf_counter() - t

    pl._p2p = timed_p2p
    # the interleaved (V, P, L/(P·V), ...) leaves: pipe on dim 1
    rules_v = ShardingRules([(r"layers/", (None, "pipe"))] + pl.PIPE_LLAMA_RULES.rules)
    runs = {}
    try:
        mesh = distributed.mesh(device="cuda")
        say(f"pipe ranks: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
            f"{dist.get_backend()}, world {dist.get_world_size()}")
        for name, nv, rules in (("gpipe", 1, pl.PIPE_LLAMA_RULES),
                                ("interleaved", PIPE_VIRTUAL, rules_v)):
            torch.cuda.reset_peak_memory_stats()
            params = pl.llama_pipeline_place(llama_init(cfg, seed=0, device="cuda"),
                                             mesh, n_virtual=nv)
            gc.collect()
            torch.cuda.empty_cache()
            local = tuple(params["layers"]["wq"].to_local().shape)
            want = ((L // PIPE_RANKS, cfg.dim, cfg.dim) if nv == 1 else
                    (nv, 1, L // (PIPE_RANKS * nv), cfg.dim, cfg.dim))
            if local != want:
                fail(f"pipe ranks: rank {rank} {name} holds a wq block of {local}")
            step = make_train_step(
                lambda p, t, y: pl.llama_loss_pipelined(
                    p, t, y, cfg, mesh, n_microbatches=M, n_virtual=nv,
                    chunk=TRAIN_CHUNK), opt, mesh=mesh, rules=rules)
            state = step.shard_state(init_train_state(params, opt))
            del params
            fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            hops0, hop["s"] = dict(pl.HOP_PATHS), 0.0
            dist.barrier()
            t = time.perf_counter()
            loss_g, grads = step.grads_fn(state.params, batch)
            torch.cuda.synchronize()
            grads_s, grads_hop_s = time.perf_counter() - t, hop["s"]
            host = []
            for g in tree_leaves(grads):
                whole = g.full_tensor()         # a collective: every rank
                if rank == 0:
                    if nv > 1 and whole.dim() > 3 and whole.shape[0] == nv:
                        whole = whole.reshape(-1, *whole.shape[3:])
                    host.append(whole.cpu())
                del whole
            del grads
            dist.barrier()
            hop["s"] = 0.0
            t = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            step_s, step_hop_s = time.perf_counter() - t, hop["s"]
            counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
            check_launches(f"pipe ranks rank {rank} {name}: grads_fn and one step "
                           f"(A1, A2, A3)", counts,
                           pipe_step_launches(L // PIPE_RANKS, M, passes=2))
            hops = {k: pl.HOP_PATHS[k] - hops0[k] for k in hops0}
            if hops["direct"] or not hops["host"]:
                fail(f"pipe ranks: rank {rank} hops by path {hops}: gloo carries "
                     "CUDA tensors only through the host")
            peak = torch.cuda.max_memory_allocated() / 1e9
            runs[name] = dict(loss=met["loss"].item(), grads_fn_loss=float(
                loss_g.full_tensor()), launches=counts, hops=hops,
                grads_s=grads_s, step_s=step_s,
                hop_s=dict(grads=grads_hop_s, step=step_hop_s),
                hop_share=dict(grads=grads_hop_s / grads_s,
                               step=step_hop_s / step_s),
                peak_memory_gb=peak, host=host)
            print(f"pipe ranks: rank {rank} {name}: grads_fn {grads_s:.3f}s "
                  f"(hops {grads_hop_s:.3f}s), step {step_s:.3f}s (hops "
                  f"{step_hop_s:.3f}s); hops by path {hops}; A1/A2/A3 {counts}; "
                  f"peak_memory_gb={peak}", flush=True)
            del state, step, met
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        if rank == 0:
            params = llama_init(cfg, seed=0, device="cuda")
            plain_loss, plain_grads = make_train_step(
                lambda p, t, y: llama_loss_chunked(p, t, y, cfg, chunk=TRAIN_CHUNK),
                opt).loss_and_grads(params, batch)
            plain_loss = float(plain_loss)
            for name, r in runs.items():
                num = den = worst = 0.0
                for g, w in zip(r.pop("host"), tree_leaves(plain_grads)):
                    w = w.float()
                    d = (g.cuda().float() - w).norm() ** 2
                    num, den = num + float(d), den + float(w.norm() ** 2)
                    worst = max(worst, float(d.sqrt() / w.norm().clamp_min(1e-30)))
                r.update(plain_loss=plain_loss, grad_rel_l2=math.sqrt(num / den),
                         grad_worst_leaf=worst)
                say(f"pipe ranks: {name}, {PIPE_RANKS} ranks x {L // PIPE_RANKS} "
                    f"layers, {M} microbatches: loss {r['grads_fn_loss']} vs the "
                    f"plain step's {plain_loss} (tol {LOSS_ABS}); gradients' "
                    f"relative L2 {r['grad_rel_l2']} (tol {PIPE_GRAD_REL_L2}), "
                    f"worst leaf {worst}; hop share of grads_fn "
                    f"{r['hop_share']['grads']}, of the step {r['hop_share']['step']}")
                if not (abs(r["grads_fn_loss"] - plain_loss) <= LOSS_ABS
                        and r["grad_rel_l2"] <= PIPE_GRAD_REL_L2):
                    fail(f"pipe ranks: {name} loss {r['grads_fn_loss']} vs plain "
                         f"{plain_loss}, gradients' relative L2 {r['grad_rel_l2']}")
            del params, plain_grads
        else:
            for r in runs.values():
                r.pop("host")
        dist.barrier()
    finally:
        pl._p2p = real_p2p
        distributed.destroy()
    if rank == 0:
        print(json.dumps(dict(ranks=PIPE_RANKS, layers=L, microbatches=M,
                              runs=runs, launches={k: r["launches"]
                                                   for k, r in runs.items()})),
              flush=True)


def route_dtensor_collectives_through_c10d() -> None:
    """On gloo, DTensor's functional collectives crash (SIGSEGV) on CUDA
    tensors, where c10d's eager all_reduce, all_gather_into_tensor and
    reduce_scatter_tensor run (a 4-rank probe on the card, torch 2.11+cu128;
    PERF.md "PR 16"). The gloo ranks that share the card ("expert_ranks")
    route DTensor's collectives through those eager ops: the same sums and
    concatenations, with plain tensors out. nccl ranks, one to a card,
    need none of it."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh

    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}

    def group_of(group):
        if isinstance(group, tuple):
            mesh, dim = group
            return mesh.get_group(dim)
        if isinstance(group, DeviceMesh):
            return group.get_group()
        if isinstance(group, str):
            from torch.distributed.distributed_c10d import _resolve_process_group
            return _resolve_process_group(group)
        return group

    def all_reduce(self, reduceOp, group, tag=""):
        g = group_of(group)
        out = self.clone()
        dist.all_reduce(out, op=ops[reduceOp.lower()], group=g)
        return out / dist.get_world_size(g) if reduceOp.lower() == "avg" else out

    def all_gather(self, gather_dim, group, tag=""):
        g = group_of(group)
        n = dist.get_world_size(g)
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=g)
        return out if gather_dim == 0 else torch.cat(out.chunk(n), dim=gather_dim)

    def reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
        g = group_of(group)
        n = dist.get_world_size(g)
        x = self if scatter_dim == 0 else torch.cat(self.chunk(n, dim=scatter_dim))
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=ops[reduceOp.lower()], group=g)
        # rank i's block along scatter_dim, in its own layout
        return out / n if reduceOp.lower() == "avg" else out

    for name, fn in (("all_reduce", all_reduce), ("all_gather_tensor", all_gather),
                     ("all_gather_single", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("reduce_scatter_single", reduce_scatter)):
        if hasattr(funcol, name):
            setattr(funcol, name, fn)


def expert_rank() -> None:
    """One of the EXPERT_RANKS ranks of "expert_ranks": gloo from the env
    (serving.distributed, device="cpu"), the card as cuda:0, the mesh of
    KT_MESH (expert 2 x tensor 2) on cuda. Mixtral's width at
    EXPERT_LAYERS layers, bf16, random weights from a seed, laid out by
    MOE_RULES: each rank holds 4 of the 8 experts and half of each
    expert's F. Training: the first step's gradients (grads_fn) and one
    default_optimizer step at EXPERT_B x EXPERT_S; exact A1/A2/A3; rank 0
    then holds the loss to the plain step's on the card within LOSS_ABS
    and prints the gradients' relative L2 against it. Serving: the
    EXPERT_PROMPTS through GenerationEngine(mesh=) with a bf16 grid (8
    slots, max_len 2048; B1 on the local slots and heads), EXPERT_NEW
    tokens each, exact A1/B1 counts; rank 0 then runs the plain engine on
    the same prompts: first tokens equal, the first decode step's logits
    within LOGITS_REL_L2; the share of equal tokens is printed. Each
    rank's peak memory is printed. The record is rank 0's last line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("expert rank: torch.cuda.is_available() is false")
    import faulthandler
    faulthandler.enable()          # a crash in a collective names its frame
    torch.backends.cuda.matmul.allow_tf32 = False
    from kubetorch_tpu_torch.models import moe as moe_mod
    from kubetorch_tpu_torch.ops import attention as ops_attn
    from kubetorch_tpu_torch.ops import decode_attention as ops_dec
    from kubetorch_tpu_torch.parallel import MOE_RULES
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as engine_mod
    from kubetorch_tpu_torch.serving import distributed
    from kubetorch_tpu_torch.train import (default_optimizer,
                                           init_train_state, make_train_step)
    from kubetorch_tpu_torch.train.optim import tree_leaves

    cfg = moe_mod.MoeConfig.mixtral_8x7b(n_layers=EXPERT_LAYERS, max_seq_len=2048)
    L = cfg.n_layers
    fa, dec = ops_attn.flash_attention, ops_dec.decode_attention
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (EXPERT_B, EXPERT_S))).cuda()
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in EXPERT_PROMPTS]
    distributed.init_process_group(device="cpu")
    torch.cuda.set_device(0)
    route_dtensor_collectives_through_c10d()
    rank = dist.get_rank()
    say = (lambda msg: print(msg, flush=True)) if rank == 0 else (lambda msg: None)

    def laid_out():
        params = moe_mod.moe_init(cfg, seed=0, device="cuda")
        sharded = shard_pytree(params, MOE_RULES, mesh)
        del params
        torch.cuda.empty_cache()
        return sharded

    try:
        mesh = distributed.mesh(device="cuda")
        say(f"expert_ranks: KT_MESH {os.environ.get('KT_MESH')} -> {mesh} over "
            f"{dist.get_backend()}, world {dist.get_world_size()}")
        sharded = laid_out()
        check_rules_layout(sharded, MOE_RULES, "MOE_RULES", mesh,
                           f"expert_ranks rank {rank}")
        bank = tuple(sharded["layers"]["experts"]["w_gate"].to_local().shape)
        if bank != (L, cfg.n_experts // 2, cfg.dim, cfg.ffn_dim // 2):
            fail(f"expert_ranks: rank {rank} holds a w_gate block of {bank}")
        say(f"expert_ranks: each rank's w_gate block {bank}: "
            f"{cfg.n_experts // 2} of {cfg.n_experts} experts, half of F")

        # training: the first step's gradients, then one step
        torch.cuda.reset_peak_memory_stats()
        opt = default_optimizer(warmup_steps=2)
        step = make_train_step(lambda p, t, y: moe_mod.moe_loss(p, t, y, cfg),
                               opt, mesh=mesh, rules=MOE_RULES)
        state = step.shard_state(init_train_state(sharded, opt))
        fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        loss_g, grads = step.grads_fn(state.params, batch)
        # every gradient whole on rank 0's host, leaf by leaf
        host = []
        for g in tree_leaves(grads):
            whole = g.full_tensor()             # a collective: every rank
            if rank == 0:
                host.append(whole.cpu())
            del whole
        del grads
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        check_launches(f"expert_ranks rank {rank}: grads_fn and one step (A1, A2, A3)",
                       counts, (4 * L, 2 * L, 2 * L))
        loss = m["loss"].item()
        # each rank's training peak, gathered on the host
        peaks = torch.zeros(dist.get_world_size(), dtype=torch.float64)
        peaks[rank] = torch.cuda.max_memory_allocated() / 1e9
        dist.all_reduce(peaks)
        train_peak = peaks.tolist()
        say(f"expert_ranks: training peak_memory_gb by rank {train_peak}, "
            f"sum {sum(train_peak)} of the one card")
        del state, step, m, sharded
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        loss_g = float(loss_g.full_tensor())
        train = dict(loss=loss, grads_fn_loss=loss_g, ms_per_step=step_ms,
                     launches=counts, peak_memory_gb=train_peak)
        if rank == 0:
            params = moe_mod.moe_init(cfg, seed=0, device="cuda")
            plain_loss, plain_grads = make_train_step(
                lambda p, t, y: moe_mod.moe_loss(p, t, y, cfg), opt) \
                .loss_and_grads(params, batch)
            num = den = 0.0
            worst = 0.0
            for g, w in zip(host, tree_leaves(plain_grads)):
                w = w.float()
                d = (g.cuda().float() - w).norm() ** 2
                num, den = num + float(d), den + float(w.norm() ** 2)
                worst = max(worst, float(d.sqrt() / w.norm().clamp_min(1e-30)))
            rel = math.sqrt(num / den)
            plain_loss = float(plain_loss)
            say(f"expert_ranks: train, {EXPERT_RANKS} ranks (expert 2 x tensor 2), "
                f"batch {EXPERT_B}x{EXPERT_S}: loss {loss} (grads_fn {loss_g}) "
                f"vs the plain step's {plain_loss} (tol {LOSS_ABS}); gradients' "
                f"relative L2 {rel}, worst leaf {worst}; mesh step ms {step_ms}")
            train.update(plain_loss=plain_loss, grad_rel_l2=rel, grad_worst_leaf=worst)
            del params, plain_grads, host
            gc.collect()
            torch.cuda.empty_cache()
            if not abs(loss - plain_loss) <= LOSS_ABS:
                fail(f"expert_ranks: loss {loss} vs plain {plain_loss}")
        dist.barrier()

        # serving: the mesh engine with a bf16 grid, then the plain engine
        sharded = laid_out()
        runs = {}
        for label, p, kw in (("mesh", sharded, dict(mesh=mesh)), ("plain", None, {})):
            if label == "plain":
                if rank != 0:
                    continue
                p = moe_mod.moe_init(cfg, seed=0, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            eng = GenerationEngine(p, cfg, slots=8, max_len=2048,
                                   prefill_buckets=(128, 256, 512, 1024),
                                   device="cuda", **kw)
            with recorded_logits(engine_mod, "_decode_step_impl",
                                 pick=lambda o: o.float(), keep=1) as first_step:
                fa.launches = dec.launches = 0
                hs = [eng.submit(q, max_new_tokens=EXPERT_NEW) for q in prompts]
                steps0, dt = eng.stats().decode_steps, []
                while True:
                    before = eng.stats().admitted_total
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    left = eng.step()
                    torch.cuda.synchronize()
                    if eng.stats().admitted_total == before:
                        dt.append(time.perf_counter() - t)
                    if not left:
                        break
                got = (fa.launches, dec.launches)
            steps = eng.stats().decode_steps - steps0
            outs = [h.result(timeout=0) for h in hs]
            if any(len(o) != EXPERT_NEW or not all(0 <= x < cfg.vocab_size for x in o)
                   for o in outs):
                fail(f"expert_ranks {label}: outputs {outs}")
            check_launches(f"expert_ranks rank {rank} {label} engine (A1, B1)", got,
                           (L * len(prompts), L * steps))
            peak = torch.cuda.max_memory_allocated() / 1e9
            print(f"expert_ranks: rank {rank} {label} engine peak_memory_gb={peak}",
                  flush=True)
            runs[label] = dict(tokens=outs, launches=got, steps=steps,
                               first_step=first_step[0], peak_memory_gb=peak,
                               ms_per_decode_step=sum(dt) / len(dt) * 1e3)
            del eng, p
            gc.collect()
            torch.cuda.empty_cache()
        serve = dict(launches=dict(flash_fwd=runs["mesh"]["launches"][0],
                                   decode_attention=runs["mesh"]["launches"][1]))
        if rank == 0:
            a, b = runs["mesh"], runs["plain"]
            rel = float((a["first_step"] - b["first_step"]).norm()
                        / b["first_step"].norm())
            firsts = [x[0] for x in a["tokens"]] == [x[0] for x in b["tokens"]]
            same = sum(x == y for u, v in zip(a["tokens"], b["tokens"])
                       for x, y in zip(u, v)) / (len(prompts) * EXPERT_NEW)
            say(f"expert_ranks: serve, {EXPERT_RANKS} ranks, A1/B1 launches "
                f"{a['launches']} over {a['steps']} decode steps; first tokens "
                f"equal to the plain engine's {firsts}; first decode step's "
                f"logits rel_l2 {rel} (tol {LOGITS_REL_L2}); equal tokens {same}; "
                f"decode ms/step mesh {a['ms_per_decode_step']} plain "
                f"{b['ms_per_decode_step']}")
            if not (firsts and rel <= LOGITS_REL_L2):
                fail(f"expert_ranks: first tokens equal {firsts}, first decode "
                     f"step rel_l2 {rel}")
            serve.update(logits_rel_l2=rel, equal_tokens=same,
                         ms_per_decode_step={k: r["ms_per_decode_step"]
                                             for k, r in runs.items()})
        serve["peak_memory_gb"] = runs["mesh"]["peak_memory_gb"]
    finally:
        distributed.destroy()
    if rank == 0:
        print(json.dumps(dict(ranks=EXPERT_RANKS, layers=L, train=train,
                              serve=serve, launches=dict(train=train["launches"],
                                                         serve=serve["launches"]))),
              flush=True)


def main() -> None:
    t_start = time.perf_counter()
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
    print(f"packages the port does without: {installed_versions()}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        list(ex.map(_build.load, SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f}s for {len(SOURCES)} sources",
          flush=True)
    check_tensor_core_sass(_build)

    flash, flash_draft = check_flash(torch, F, ops_attn)
    dec = check_decode(torch, F, ops_dec)
    dec_q = check_decode(torch, F, ops_dec, quant=True)
    dec_part = check_decode_partial(torch, F, ops_dec, quant=False)
    dec_part_q = check_decode_partial(torch, F, ops_dec, quant=True)
    q4 = check_q4(torch, ops_q4)
    gen64 = torch.Generator(device="cuda").manual_seed(8)
    dec_draft = [check_decode_shape(torch, F, ops_dec, shape, False, gen64, hd=64)
                 for shape in B1_DRAFT_SHAPES]
    q4_window = check_q4_shapes(torch, ops_q4, Q4_WINDOW_SHAPES, seed=9)
    train_k = check_train_kernels(torch, F, ops_attn)
    vit_k = check_vit_kernels(torch, F, ops_attn, card)
    t = time.perf_counter()
    flash_n, decode_n, feat_n, lora_n, lora_train, spec_n, spec = drive_engine(
        torch, ops_attn, ops_dec, card)
    gc.collect()
    torch.cuda.empty_cache()
    hf_n, hf = drive_hf_openai(torch, ops_attn, ops_dec, card)
    gc.collect()
    torch.cuda.empty_cache()
    quant_n, qfeat_n, qlora_n, qspec_n, spec["spec_q4"] = drive_engine_quant(
        torch, ops_attn, ops_dec, ops_q4, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"engines: Llama-3-8B phases wall {time.perf_counter() - t:.1f}s",
          flush=True)
    moe_n, moe_gather_n, _ = drive_moe(torch, ops_attn, ops_dec, ops_q4, card)
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = drive_moe_train(torch, ops_attn, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_n, train = drive_training(torch, ops_attn, card)
    gc.collect()
    torch.cuda.empty_cache()
    vit = drive_vit(torch, ops_attn, card)
    gc.collect()
    torch.cuda.empty_cache()
    fabric_n, vit["fabric"] = drive_fabric(card)
    mesh_n, mesh = drive_mesh(card)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_serve_n, mesh_serve = drive_mesh_serve(card)
    ctx_n = mesh_serve["context"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    moe_mesh = drive_moe_mesh(card)
    mm_train, mm_serve = (moe_mesh["train"]["launches"]["mesh"],
                          moe_mesh["serve"]["launches"]["mesh"])
    ep_n = moe_mesh["expert_ranks"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    resnet = drive_resnet(card)
    pipe = drive_pipe(card)
    gc.collect()
    torch.cuda.empty_cache()
    data_plane = drive_data_plane(card)
    gc.collect()
    torch.cuda.empty_cache()
    cold_start = drive_cold_start(card)
    cold_n = {k: r["launches"] for k, r in cold_start["boots"].items()}
    pipe_n = {"world_of_one": pipe["world_of_one"]["launches"],
              "ranks": pipe["ranks"]["launches"]}
    sl = mesh_serve["spec_lora"]["runs"]
    trains = {"lora_train": lora_train, "moe_train": moe_train}

    def train_launches(i):
        return {k: dict(launches=r["launches"][i]) for k, r in trains.items()}

    rollout_n = lora_train["rollout"]["launches"]
    fly_n = lora_train["flywheel"]["launches"]
    audit_n = mesh["hbm_audit"]["launches"]
    checkpoint_n = train["checkpoint"]["launches"]

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="kubetorch_tpu_torch/csrc/flash_fwd.cu",
             replaces="kubetorch_tpu/ops/attention.py:44",
             launches=train_n[0], path="training (forward with LSE, and "
             "again under remat)", **train_k["fwd"], **train_launches(0),
             lora_serve=dict(launches={w: n["flash_fwd"] for w, n in
                                       lora_train["serve"].items()}),
             rollout=dict(launches=rollout_n["flash_fwd"]),
             flywheel=dict(launches=fly_n["flash_fwd"]),
             checkpoint=dict(launches=checkpoint_n[0]),
             hf_openai=dict(launches=hf_n["flash_fwd"]),
             cold_start=dict(launches={k: n["flash_fwd"]
                                       for k, n in cold_n.items()}),
             vit=dict(launches=vit["launches"][0],
                      launches_forward=vit["launches_forward"],
                      per_forward=vit["per_forward"],
                      per_train_step=vit["per_train_step"][0], **vit_k["fwd"]),
             fabric=dict(launches=fabric_n[0]),
             mesh=dict(launches=mesh_n[0]),
             hbm_audit=dict(launches=audit_n[0]),
             pipe=dict(launches={r: {k: n[0] for k, n in runs.items()}
                                 for r, runs in pipe_n.items()}),
             mesh_serve=dict(launches=mesh_serve_n[0]),
             mesh_serve_lora=dict(launches=mesh_serve["lora"]["launches"]["mesh"][0]),
             spec_lora=dict(launches={k: r["mesh"]["launches"]["flash_fwd"]
                                      for k, r in sl.items()}),
             mesh_serve_context=dict(launches={k: n["flash_fwd"]
                                               for k, n in ctx_n.items()}),
             moe_mesh=dict(launches=dict(train=mm_train[0],
                                         serve=mm_serve["flash_fwd"])),
             expert_ranks=dict(launches=dict(train=ep_n["train"][0],
                                             serve=ep_n["serve"]["flash_fwd"])),
             serving=dict(launches=flash_n, **flash),
             serving_quant=dict(launches=quant_n["flash_fwd"]),
             engine_features=dict(launches=feat_n["flash_fwd"]),
             engine_q4_features=dict(launches=qfeat_n["flash_fwd"]),
             lora=dict(launches=lora_n["flash_fwd"]),
             lora_q4=dict(launches=qlora_n["flash_fwd"]),
             moe=dict(launches=moe_n["flash_fwd"]),
             moe_gather=dict(launches=moe_gather_n["flash_fwd"]),
             spec=dict(launches=spec_n["spec"]["flash_fwd"]),
             spec_self=dict(launches=spec_n["spec_self"]["flash_fwd"]),
             spec_q4=dict(launches=qspec_n["flash_fwd"]),
             draft_hd64=flash_draft),
        dict(name="decode_attention", route="cuda",
             source="kubetorch_tpu_torch/csrc/decode_attention.cu",
             replaces="kubetorch_tpu/ops/decode_attention.py:46",
             launches=decode_n, path="serving", **dec,
             lora_serve=dict(launches={w: n["decode_attention"] for w, n in
                                       lora_train["serve"].items()}),
             rollout=dict(launches=rollout_n["decode_attention"]),
             flywheel=dict(launches=fly_n["decode_attention"]),
             hf_openai=dict(launches=hf_n["decode_attention"]),
             cold_start=dict(launches={k: n["decode_attention"]
                                       for k, n in cold_n.items()}),
             engine_features=dict(launches=feat_n["decode_attention"]),
             lora=dict(launches=lora_n["decode_attention"]),
             spec=dict(launches=spec_n["spec"]["decode_attention"]),
             spec_self=dict(launches=spec_n["spec_self"]["decode_attention"]),
             spec_q4=dict(launches=qspec_n["decode_attention"]),
             mesh_serve=dict(launches=mesh_serve_n[1]),
             mesh_serve_lora=dict(launches=mesh_serve["lora"]["launches"]["mesh"][1]),
             expert_ranks=dict(launches=ep_n["serve"]["decode_attention"]),
             draft_hd64=dec_draft),
        dict(name="decode_attention_partial", route="cuda",
             source="kubetorch_tpu_torch/csrc/decode_attention.cu",
             replaces="kubetorch_tpu/ops/decode_attention.py:46",
             launches=ctx_n["bf16"]["decode_attention_partial"],
             path=f"context-parallel decode (mesh_serve context): "
             f"{CONTEXT_SHARDS} gloo ranks on the card, each B1's partial "
             "mode over its cache shard, then sp_decode_attention's combine; "
             "times: the same over emulated shards in one process",
             spec_lora=dict(launches={
                 k: r["mesh"]["launches"]["decode_attention_partial"]
                 for k, r in sl.items()}),
             **dec_part),
        dict(name="decode_attention_quant_partial", route="cuda",
             source="kubetorch_tpu_torch/csrc/decode_attention.cu",
             replaces="kubetorch_tpu/ops/decode_attention.py:46",
             launches=ctx_n["int8"]["decode_attention_quant_partial"],
             path=f"context-parallel decode over an int8 cache (mesh_serve "
             f"context): {CONTEXT_SHARDS} gloo ranks, B2's partial mode over "
             "each cache shard; times: emulated shards in one process",
             **dec_part_q),
        dict(name="flash_bwd_dq", route="cuda",
             source="kubetorch_tpu_torch/csrc/flash_bwd.cu",
             replaces="kubetorch_tpu/ops/attention.py:140",
             launches=train_n[1], path="training", **train_k["dq"],
             **train_launches(1), checkpoint=dict(launches=checkpoint_n[1]),
             flywheel=dict(launches=fly_n["flash_bwd_dq"]),
             vit=dict(launches=vit["launches"][1],
                      per_train_step=vit["per_train_step"][1],
                      **vit_k["dq"]),
             fabric=dict(launches=fabric_n[1]), mesh=dict(launches=mesh_n[1]),
             hbm_audit=dict(launches=audit_n[1]),
             pipe=dict(launches={r: {k: n[1] for k, n in runs.items()}
                                 for r, runs in pipe_n.items()}),
             moe_mesh=dict(launches=mm_train[1]),
             expert_ranks=dict(launches=ep_n["train"][1])),
        dict(name="flash_bwd_dkv", route="cuda",
             source="kubetorch_tpu_torch/csrc/flash_bwd.cu",
             replaces="kubetorch_tpu/ops/attention.py:180",
             launches=train_n[2], path="training", **train_k["dkv"],
             **train_launches(2), checkpoint=dict(launches=checkpoint_n[2]),
             flywheel=dict(launches=fly_n["flash_bwd_dkv"]),
             vit=dict(launches=vit["launches"][2],
                      per_train_step=vit["per_train_step"][2],
                      **vit_k["dkv"]),
             fabric=dict(launches=fabric_n[2]), mesh=dict(launches=mesh_n[2]),
             hbm_audit=dict(launches=audit_n[2]),
             pipe=dict(launches={r: {k: n[2] for k, n in runs.items()}
                                 for r, runs in pipe_n.items()}),
             moe_mesh=dict(launches=mm_train[2]),
             expert_ranks=dict(launches=ep_n["train"][2])),
        dict(name="decode_attention_quant", route="cuda",
             source="kubetorch_tpu_torch/csrc/decode_attention.cu",
             replaces="kubetorch_tpu/ops/decode_attention.py:46",
             launches=quant_n["decode_attention_quant"],
             path="quantized serving (int8 KV cache)", **dec_q,
             engine_q4_features=dict(
                 launches=qfeat_n["decode_attention_quant"]),
             lora_q4=dict(launches=qlora_n["decode_attention_quant"]),
             moe=dict(launches=moe_n["decode_attention_quant"]),
             moe_gather=dict(launches=moe_gather_n["decode_attention_quant"]),
             spec_q4=dict(launches=qspec_n["decode_attention_quant"]),
             moe_mesh=dict(launches=mm_serve["decode_attention_quant"])),
        dict(name="q4_matmul", route="cuda",
             source="kubetorch_tpu_torch/csrc/quant_matmul.cu",
             replaces="kubetorch_tpu/ops/quant_matmul.py:31",
             launches=quant_n["q4_matmul"],
             path="quantized serving (int4 weights)", **q4,
             engine_q4_features=dict(launches=qfeat_n["q4_matmul"]),
             lora_q4=dict(launches=qlora_n["q4_matmul"]),
             moe=dict(launches=moe_n["q4_matmul"]),
             moe_gather=dict(launches=moe_gather_n["q4_matmul"]),
             spec_q4=dict(launches=qspec_n["q4_matmul"]),
             moe_mesh=dict(launches=mm_serve["q4_matmul"]),
             verify_window=q4_window),
    ]
    print(f"spec: {json.dumps(spec)}", flush=True)
    print(f"flywheel: {json.dumps(lora_train['flywheel'])} card={card}",
          flush=True)
    print(f"hf_openai: {json.dumps(hf)} card={card}", flush=True)
    print(f"train: {json.dumps(dict(llama_1b=train, **trains))} card={card}",
          flush=True)
    print(f"vit: {json.dumps(vit)} card={card}", flush=True)
    print(f"mesh: {json.dumps(mesh)} card={card}", flush=True)
    print(f"mesh_serve: {json.dumps(mesh_serve)} card={card}", flush=True)
    print(f"moe_mesh: {json.dumps(moe_mesh)} card={card}", flush=True)
    print(f"resnet: {json.dumps(resnet)} card={card}", flush=True)
    print(f"pipe: {json.dumps(pipe)} card={card}", flush=True)
    print(f"data_plane: {json.dumps(data_plane)} card={card}", flush=True)
    print(f"cold_start: {json.dumps(cold_start)} card={card}", flush=True)
    print(f"hbm_audit: {json.dumps(mesh['hbm_audit'])} card={card}",
          flush=True)
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == [MOE_MESH_RANK_FLAG]:
        moe_mesh_rank()
    elif sys.argv[1:] == [EXPERT_RANK_FLAG]:
        expert_rank()
    elif sys.argv[1:] == [FABRIC_RANK_FLAG]:
        fabric_rank()
    elif sys.argv[1:] == [MESH_RANK_FLAG]:
        mesh_rank()
    elif sys.argv[1:] == [MESH_SERVE_RANK_FLAG]:
        mesh_serve_rank()
    elif sys.argv[1:] == [CONTEXT_RANK_FLAG]:
        context_serve_rank()
    elif sys.argv[1:] == [SPEC_LORA_RANK_FLAG]:
        spec_lora_rank()
    elif sys.argv[1:] == [RESNET_RANK_FLAG]:
        resnet_rank()
    elif sys.argv[1:] == [PIPE_RANK_FLAG]:
        pipe_rank()
    elif sys.argv[1:] == [PIPE_RANKS_FLAG]:
        pipe_ranks()
    elif sys.argv[1:] == [DATA_PLANE_FLAG]:
        data_plane_rank()
    else:
        main()
