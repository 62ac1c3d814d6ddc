"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one (a CUDA kernel has no
CPU mode). This file imports neither jax nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are per row, relative to the row's own norm
(``kubetorch_tpu_torch/ops/tolerance.py`` gives the reasons): 1e-4 for
fp32, 1e-2 for bf16; gradient rows floored at the RMS row norm; LSE 1e-4
absolute. The train step on the card against the same step on the CPU
(fp32, TF32 off), three steps: losses 1e-5 relative; each leaf's change
from its initial value 1e-2 relative in L2. Adam's step m / (sqrt(v) + eps)
is about lr in size whatever the grad's, so an entry whose grad is
rounding noise can step either way on the two devices (on an H100, one of
16,384 wq entries ended 3.1e-5 apart, against steps of ~1.5e-4); such
outliers weigh ~1e-3 of a leaf's change, a wrong update rule all of it.
Flash-decode in bf16 at head dim 64 and 128 runs the split body (the cache
cut into runs of whole 64-row tiles across blocks, mma.sync, a combine
pass in split order): it takes the bf16 tolerance at Llama-3-8B's decode
shapes and at split edges, and must repeat its output bit for bit, eagerly
and under CUDA-graph replay; fp32 q and head dim 32 keep the FMA body.
The int4 matmul (fp32 output) and the int8 flash-decode take the same
per-row tolerances as the other kernels; its two bodies (split-K
mma.sync at M <= 16, wgmma + TMA above) are each held to the plain version
and must repeat their output bit for bit. A1, A2 and A3 in bf16 at head
dim 64 and 128 run their tensor-core bodies (wgmma + TMA, P and dS split
into two bf16 halves) and take the bf16 tolerances; fp32 runs the FMA
bodies and takes fp32's. A checkpoint's async snapshot under a
``donate=True`` step must fingerprint as the state it saved and repeat the
live step's loss exactly; a live weight swap must allocate nothing on the
card. The partial mode of B1/B2 (one context shard of the cache, its
un-normalised (m, l, acc)) is held per shard to the plain partials: the
normalised rows acc / l and l rescaled to the plain max take the row
tolerances, m its fp32 rounding, and a slot with no live row in a shard
gives exactly l = 0 and acc = 0; the shards' local combine takes the row
tolerances against the plain partials' combine and against one
whole-cache call.
"""

import dataclasses
import os
import uuid

import pytest
import torch

from chip_smoke import DECODE_SHAPES
from kubetorch_tpu_torch.models import common
from kubetorch_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                              llama_loss_chunked)
from kubetorch_tpu_torch.ops.attention import (_launch, attention_delta,
                                               flash_attention,
                                               flash_attention_bwd_dkv,
                                               flash_attention_bwd_dkv_ref,
                                               flash_attention_bwd_dq,
                                               flash_attention_bwd_dq_ref,
                                               flash_attention_bwd_ref,
                                               flash_attention_fwd_ref,
                                               flash_attention_ref,
                                               tensor_core_body)
from kubetorch_tpu_torch.models.quant import (_quantize_leaf_int4,
                                              quantize_params_int4)
from kubetorch_tpu_torch.ops.decode_attention import (
    combine_partials, decode_attention, decode_attention_body,
    decode_attention_partial, decode_attention_partial_ref,
    decode_attention_quant, decode_attention_quant_partial,
    decode_attention_quant_partial_ref, decode_attention_quant_ref,
    decode_attention_ref, decode_split_plan)
from kubetorch_tpu_torch.ops.quant_matmul import (q4_matmul, q4_matmul_body,
                                                  q4_matmul_ref, q4_split_plan)
from kubetorch_tpu_torch.ops.tolerance import (LSE_ATOL, ROW_RTOL,
                                               grad_row_rel_err, row_rel_err)
from kubetorch_tpu_torch.serve import GenerationEngine, quantize_rows
from kubetorch_tpu_torch.train import (default_optimizer, init_train_state,
                                       make_train_step)
from kubetorch_tpu_torch.train.optim import tree_leaves, tree_map

TOL_STEP_LOSS = 1e-5
TOL_STEP_UPDATE = 1e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return (flash_attention.launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,nh,nkv,hd,causal", [
    (128, 32, 8, 128, True), (200, 4, 2, 64, True), (256, 8, 1, 128, False),
    (130, 8, 2, 64, False), (200, 8, 2, 128, True), (1024, 8, 2, 128, True),
    (2048, 8, 2, 64, True), (1024, 4, 4, 64, False)])
def test_flash_kernel_matches_plain(cuda, dtype, s, nh, nkv, hd, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, s, nh, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, s, nkv, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, s, nkv, hd, generator=g, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert row_rel_err(got, want) <= ROW_RTOL[dtype]


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as views into one fused (B, S, N+2NKV, Hd) projection."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(1, 128, 8, 64, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:8]
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    assert row_rel_err(got, want) <= ROW_RTOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,nkv,hd", [(8, 2048, 32, 8, 128),
                                           (3, 128, 6, 2, 128),
                                           (2, 512, 4, 1, 64)])
def test_decode_kernel_matches_plain(cuda, dtype, b, s, nh, nkv, hd):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, nh, hd, generator=g, device=cuda).to(dtype)
    ck = torch.randn(b, s, nkv, hd, generator=g, device=cuda).to(dtype)
    cv = torch.randn(b, s, nkv, hd, generator=g, device=cuda).to(dtype)
    pos = torch.tensor([0, s - 1, 63, 64, s // 2, 1, s - 2, 5][:b],
                       dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, ck, cv, pos)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_ref(q, ck, cv, pos)
    assert row_rel_err(got, want) <= ROW_RTOL[dtype]


def test_decode_kernel_reads_a_cache_slice_in_place(cuda):
    """Layer 1 of an (L, B, S, NKV, Hd) grid, as the engine passes it."""
    g = torch.Generator(device=cuda).manual_seed(2)
    grid = torch.randn(2, 4, 256, 2, 128, generator=g, device=cuda).bfloat16()
    q = torch.randn(4, 8, 128, generator=g, device=cuda).bfloat16()
    pos = torch.tensor([0, 100, 200, 255], dtype=torch.int32, device=cuda)
    got = decode_attention(q, grid[1], grid[1], pos)
    want = decode_attention_ref(q, grid[1], grid[1], pos)
    assert row_rel_err(got, want) <= ROW_RTOL[torch.bfloat16]


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 128, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q32 = torch.zeros(1, 128, 4, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q32, q32[:, :, :2], q32[:, :, :2])
    qd = torch.zeros(2, 4, 64, device=cuda)
    ck = torch.zeros(2, 64, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="pos"):
        decode_attention(qd, ck, ck, torch.zeros(2, dtype=torch.int64,
                                                 device=cuda))


def test_engine_kernel_path_matches_plain_path(cuda):
    """tiny in fp32 on the card: flash prefill + flash decode give the
    greedy tokens of the plain path (attn_impl="xla")."""
    outs = []
    for impl in ("auto", "xla"):
        cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl=impl)
        params = llama_init(cfg, seed=3, device=cuda)
        eng = GenerationEngine(params, cfg, slots=2, max_len=160,
                               prefill_buckets=(8, 128), device=cuda)
        hs = [eng.submit(p, max_new_tokens=6)
              for p in ([5, 17, 42], list(range(1, 101)), [9, 8])]
        while eng.step():
            pass
        outs.append([h.result(timeout=0) for h in hs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# training: A1 with LSE, A2 (dQ), A3 (dK/dV), the autograd Function
# ---------------------------------------------------------------------------

BWD_SHAPES = [(2, 128, 32, 8, 64, True), (1, 200, 8, 2, 128, True),
              (2, 256, 4, 4, 64, False), (1, 130, 8, 1, 128, False),
              (1, 1024, 32, 8, 128, True), (1, 130, 4, 2, 64, True),
              (2, 200, 8, 1, 64, False), (2, 1024, 8, 4, 64, True),
              (1, 2048, 8, 2, 128, True), (1, 2048, 4, 2, 64, False),
              # ViT-B/16's attention: S = 196 a ragged tile in q and k
              (16, 196, 12, 12, 64, False)]


def _bwd_inputs(cuda, dtype, b, s, nh, nkv, hd, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, s, nh, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, s, nkv, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, s, nkv, hd, generator=g, device=cuda).to(dtype)
    do = torch.randn(b, s, nh, hd, generator=g, device=cuda).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,nkv,hd,causal", BWD_SHAPES)
def test_flash_lse_matches_plain(cuda, dtype, b, s, nh, nkv, hd, causal):
    q, k, v, _ = _bwd_inputs(cuda, dtype, b, s, nh, nkv, hd)
    out, lse = _launch(q, k, v, causal, hd ** -0.5, need_lse=True)
    want_out, want_lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    assert lse.shape == (b, nh, s) and lse.dtype == torch.float32
    assert float((lse - want_lse).abs().max()) <= LSE_ATOL
    assert row_rel_err(out, want_out) <= ROW_RTOL[dtype]
    # the no-LSE launch writes the same output
    assert torch.equal(_launch(q, k, v, causal, hd ** -0.5)[0], out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,nkv,hd,causal", BWD_SHAPES)
def test_bwd_kernels_match_plain(cuda, dtype, b, s, nh, nkv, hd, causal):
    q, k, v, do = _bwd_inputs(cuda, dtype, b, s, nh, nkv, hd, seed=1)
    out, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    delta = attention_delta(out, do)
    before = _counts()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2] + 1)
    want_dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal)
    want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   causal=causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert grad_row_rel_err(got, want) <= ROW_RTOL[dtype]


def test_bwd_kernels_read_strided_inputs(cuda):
    """q/k/v as views into one fused (B, S, N+2NKV, Hd) projection and dO a
    slice of a wider tensor."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 192, 12, 64, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:12]
    do = torch.randn(2, 192, 16, 64, generator=g, device=cuda).bfloat16()[:, :, 4:12]
    out, lse = flash_attention_fwd_ref(q, k, v)
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do)
    for got, w in zip((dq, dk, dv), want):
        assert grad_row_rel_err(got, w) <= ROW_RTOL[torch.bfloat16]


@pytest.mark.parametrize("hd,s", [(64, 200), (128, 200), (128, 1024)])
def test_tensor_core_kernels_read_strided_views(cuda, hd, s):
    """A1 and A3 through TMA maps built from the views' strides: q/k/v
    slices of one fused (B, S, N+2NKV, Hd) projection, dO a slice of a
    wider tensor, and a head dim cut at a 16-byte offset from a wider row."""
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(2, s, 12, hd, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:12]
    do = torch.randn(2, s, 16, hd, generator=g, device=cuda).bfloat16()[:, :, 4:12]
    out, lse = _launch(q, k, v, True, hd ** -0.5, need_lse=True)
    want_out, want_lse = flash_attention_fwd_ref(q, k, v)
    assert row_rel_err(out, want_out) <= ROW_RTOL[torch.bfloat16]
    assert float((lse - want_lse).abs().max()) <= LSE_ATOL
    delta = attention_delta(want_out, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, want_lse, delta)
    want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, want_lse, delta)
    assert grad_row_rel_err(dk, want_dk) <= ROW_RTOL[torch.bfloat16]
    assert grad_row_rel_err(dv, want_dv) <= ROW_RTOL[torch.bfloat16]
    wide = torch.randn(1, s, 4, hd + 16, generator=g, device=cuda).bfloat16()
    qw = wide[..., 8:8 + hd]                 # base 16 bytes in, rows 2*(hd+16)
    got = flash_attention(qw, qw[:, :, :2], qw[:, :, 2:])
    want = flash_attention_ref(qw, qw[:, :, :2], qw[:, :, 2:])
    assert row_rel_err(got, want) <= ROW_RTOL[torch.bfloat16]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_dq_tensor_core_body_matches_plain(cuda, hd, group, causal):
    """A2's tensor-core body (bwd_dq_sm90) at a ragged S = 1000, GQA groups
    1, 2 and 4 (kv-head h * NKV / N), q/k/v strided views of one fused
    projection and dO a slice of a wider tensor, per row."""
    assert tensor_core_body("dq", torch.bfloat16, hd)
    s, nkv = 1000, 2
    nh = nkv * group
    g = torch.Generator(device=cuda).manual_seed(11 + group)
    qkv = torch.randn(1, s, nh + 2 * nkv, hd, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :nh], qkv[:, :, nh:nh + nkv], qkv[:, :, nh + nkv:]
    do = torch.randn(1, s, nh + 4, hd, generator=g,
                     device=cuda).bfloat16()[:, :, 2:2 + nh]
    out, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    delta = attention_delta(out, do)
    before = flash_attention.bwd_dq_launches
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.bwd_dq_launches == before + 1
    want = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    assert grad_row_rel_err(dq, want) <= ROW_RTOL[torch.bfloat16]


@pytest.mark.parametrize("hd", [64, 128])
def test_tensor_core_kernels_capture_in_a_cuda_graph(cuda, hd):
    """A1 (with and without LSE), A2 and A3 record into a CUDA graph (the
    TMA maps are kernel parameters encoded on the host); the replay equals
    the eager call bit for bit."""
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, 320, 8, 2, hd, seed=8)
    out, lse = _launch(q, k, v, True, hd ** -0.5, need_lse=True)
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    plain = flash_attention(q, k, v)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_lse = _launch(q, k, v, True, hd ** -0.5, need_lse=True)
        g_plain = flash_attention(q, k, v)
        g_dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
        g_dk, g_dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in ((g_out, out), (g_lse, lse), (g_plain, plain), (g_dq, dq),
                      (g_dk, dk), (g_dv, dv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("hd", [64, 128])
def test_dkv_kernel_is_deterministic(cuda, hd):
    """A3 sums the GQA group and the q tiles in registers, no atomics: two
    runs on the same inputs agree bit for bit."""
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, 1024, 8, 2, hd, seed=9)
    out, lse = flash_attention_fwd_ref(q, k, v)
    delta = attention_delta(out, do)
    first = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    second = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_wrappers_raise_on_misaligned_views(cuda):
    """TMA takes 16-byte-aligned bases and strides only; the wrappers raise,
    naming the tensor, and never take another body."""
    base = torch.zeros(1, 128, 4, 72, device=cuda, dtype=torch.bfloat16)
    good = torch.zeros(1, 128, 4, 64, device=cuda, dtype=torch.bfloat16)
    shifted = base[..., 1:65]                # base 2 bytes off 16
    narrowed = torch.zeros(1, 128, 4, 68, device=cuda,
                           dtype=torch.bfloat16)[..., :64]   # rows of 136 bytes
    before = (flash_attention.launches, flash_attention.bwd_dq_launches,
              flash_attention.bwd_dkv_launches)
    with pytest.raises(ValueError, match="^q rows must be 16-byte aligned"):
        flash_attention(shifted, good[:, :, :2], good[:, :, :2])
    with pytest.raises(ValueError, match="^k rows must be 16-byte aligned"):
        flash_attention(good, narrowed[:, :, :2], good[:, :, :2])
    lse = torch.zeros(1, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="^dout rows must be 16-byte aligned"):
        flash_attention_bwd_dkv(good, good[:, :, :2], good[:, :, :2], shifted,
                                lse, lse)
    with pytest.raises(ValueError, match="^v rows must be 16-byte aligned"):
        flash_attention_bwd_dq(good, good[:, :, :2], narrowed[:, :, :2], good,
                               lse, lse)
    assert (flash_attention.launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == before


def test_fp32_and_small_head_dims_take_the_fma_body(cuda):
    """The tensor-core bodies serve bf16 at head dim 64 and 128 only; fp32
    (which wgmma cannot take) and bf16 at 16 and 32 keep the FMA bodies,
    and the fp32 ones still meet fp32's tolerance."""
    for kernel in ("fwd", "dq", "dkv"):
        for hd in (16, 32, 64, 128):
            assert tensor_core_body(kernel, torch.bfloat16, hd) == (hd >= 64)
            assert not tensor_core_body(kernel, torch.float32, hd)
    q, k, v, do = _bwd_inputs(cuda, torch.float32, 1, 200, 8, 2, 64, seed=10)
    out, lse = _launch(q, k, v, True, 64 ** -0.5, need_lse=True)
    want_out, want_lse = flash_attention_fwd_ref(q, k, v)
    assert row_rel_err(out, want_out) <= ROW_RTOL[torch.float32]
    delta = attention_delta(want_out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, want_lse, delta)
    want_dq = flash_attention_bwd_dq_ref(q, k, v, do, want_lse, delta)
    assert grad_row_rel_err(dq, want_dq) <= ROW_RTOL[torch.float32]
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, want_lse, delta)
    want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, want_lse, delta)
    assert grad_row_rel_err(dk, want_dk) <= ROW_RTOL[torch.float32]
    assert grad_row_rel_err(dv, want_dv) <= ROW_RTOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_has_a_gradient(cuda, dtype):
    """A CUDA output of inputs that require grad keeps its grad_fn, and its
    gradient comes from A2/A3 and matches the plain backward."""
    q, k, v, do = _bwd_inputs(cuda, dtype, 2, 160, 8, 2, 64, seed=4)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = _counts()
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    want_out, lse = flash_attention_fwd_ref(q.detach(), k.detach(), v.detach())
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), want_out,
                                   lse, do)
    assert row_rel_err(out.detach(), want_out) <= ROW_RTOL[dtype]
    for t, w in zip((q, k, v), want):
        assert grad_row_rel_err(t.grad, w) <= ROW_RTOL[dtype]


def test_decode_attention_raises_on_inputs_that_require_grad(cuda):
    q = torch.zeros(2, 4, 64, device=cuda, requires_grad=True)
    ck = torch.zeros(2, 64, 2, 64, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_attention(q, ck, ck, pos)
    with torch.no_grad():
        assert decode_attention(q, ck, ck, pos).shape == (2, 4, 64)


def _tiny_batch(device):
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 512, (4, 96), generator=g)
    return {"tokens": tokens.to(device), "targets": tokens.roll(-1, 1).to(device)}


@pytest.mark.parametrize("policy", common.REMAT_POLICY_NAMES)
def test_remat_policies_on_the_card(cuda, policy):
    """Launch counts per policy (the forward kernel re-runs when the layer
    is recomputed) and gradients equal to no remat."""
    cfg = LlamaConfig.tiny(dtype=torch.float32, remat_policy="none")
    params = llama_init(cfg, seed=2, device=cuda)
    batch = _tiny_batch(cuda)
    grads = {}
    for name in ("none", policy):
        c = dataclasses.replace(cfg, remat_policy=name)
        step = make_train_step(lambda p, t, y: llama_loss_chunked(p, t, y, c, 32))
        before = _counts()
        _, grads[name] = step.loss_and_grads(params, batch)
        torch.cuda.synchronize()
        n = cfg.n_layers
        fwd = n if name == "none" else 2 * n
        assert _counts() == (before[0] + fwd, before[1] + n, before[2] + n)
    for a, b in zip(tree_leaves(grads[policy]), tree_leaves(grads["none"])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """tiny in fp32: three steps of make_train_step through the kernels
    against the same steps through the plain versions on the CPU."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    init = llama_init(cfg, seed=6, device="cpu")
    results = []
    for device in ("cpu", cuda):
        # a copy on each device: the step donates (updates in place)
        params = tree_map(lambda t: t.to(device, copy=True), init)
        opt = default_optimizer(warmup_steps=2)
        state = init_train_state(params, opt)
        step = make_train_step(lambda p, t, y: llama_loss_chunked(p, t, y, cfg, 32),
                               opt)
        batch = _tiny_batch(device)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        results.append((losses, tree_map(lambda t: t.cpu(), state.params)))
    (cpu_l, cpu_p), (gpu_l, gpu_p) = results
    for a, b in zip(gpu_l, cpu_l):
        assert abs(a - b) <= TOL_STEP_LOSS * abs(b)
    for a, b, p0 in zip(tree_leaves(gpu_p), tree_leaves(cpu_p), tree_leaves(init)):
        assert float((a - b).norm() / (b - p0).norm()) <= TOL_STEP_UPDATE


# ---------------------------------------------------------------------------
# quantized serving: B3 (int4 matmul), B2 (int8 flash-decode)
# ---------------------------------------------------------------------------


def _q4_operands(cuda, m, k, n, group=128, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda)
    w = torch.randn(k, n, generator=g, device=cuda) / k ** 0.5
    leaf = _quantize_leaf_int4(w, group=group)
    return x, leaf["__kt_q4__"], leaf["scale"]


@pytest.mark.parametrize("m", [1, 8, 300, 2048])
@pytest.mark.parametrize("k,n", [(4096, 1040), (512, 4096), (1024, 48)])
def test_q4_kernel_matches_plain(cuda, m, k, n):
    """Both tile shapes (M <= 16 and above), ragged M, and N that is no
    multiple of either N tile (1040, 48)."""
    x, packed, scale = _q4_operands(cuda, m, k, n)
    before = q4_matmul.launches
    got = q4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert q4_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = q4_matmul_ref(x, packed, scale)
    assert row_rel_err(got, want) <= ROW_RTOL[torch.float32]
    # bf16 activations take the same path (x is rounded to bf16 either way)
    assert torch.equal(q4_matmul(x.bfloat16(), packed, scale), got)


def test_q4_kernel_reads_a_layer_slice_and_group_64(cuda):
    """Layer 1 of a stacked (L, K/2, N) leaf, as the engine passes it, and
    a group of 64 rows (two groups per 128-row chunk pair)."""
    w = torch.randn(2, 512, 256, device=cuda) / 512 ** 0.5
    leaf = _quantize_leaf_int4(w, group=64)
    x = torch.randn(8, 512, device=cuda)
    p, s = leaf["__kt_q4__"][1], leaf["scale"][1]
    assert row_rel_err(q4_matmul(x, p, s), q4_matmul_ref(x, p, s)) \
        <= ROW_RTOL[torch.float32]


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 300, 2048])
def test_q4_bodies_match_plain_and_repeat_bitwise(cuda, m, group):
    """Both bodies at the tile edges of each (M <= 16: split-K mma.sync;
    above: wgmma + TMA, 128-row tiles), the route kt_q4_matmul_body
    reports, and the same bits from two calls (split-K sums its partials
    in split order, no atomics)."""
    k, n = 4096, 1024
    x, packed, scale = _q4_operands(cuda, m, k, n, group=group, seed=m)
    groups = scale.shape[0]
    body = q4_matmul_body(m, k, n, groups)
    assert body == ("splitk" if m <= 16 else "wgmma")
    if body == "splitk":
        assert q4_split_plan(m, k, n, groups) > 1
    first = q4_matmul(x, packed, scale)
    second = q4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert row_rel_err(first, q4_matmul_ref(x, packed, scale)) \
        <= ROW_RTOL[torch.float32]


@pytest.mark.parametrize("m", [8, 300])
def test_q4_bodies_read_a_layer_slice(cuda, m):
    """Layer 2 of a stacked (L, K/2, N) leaf: a base offset of two layers'
    bytes, through the TMA maps (wgmma) and the plain loads (split-K)."""
    w = torch.randn(3, 1024, 512, device=cuda) / 32
    leaf = _quantize_leaf_int4(w, group=128)
    x = torch.randn(m, 1024, device=cuda)
    p, s = leaf["__kt_q4__"][2], leaf["scale"][2]
    assert p.data_ptr() != leaf["__kt_q4__"].data_ptr()
    assert row_rel_err(q4_matmul(x, p, s), q4_matmul_ref(x, p, s)) \
        <= ROW_RTOL[torch.float32]


def test_q4_bodies_capture_in_a_cuda_graph(cuda):
    """Split-K (its partial buffer allocated and summed inside the capture)
    and the wgmma body record into one graph; a replay on new inputs
    equals the eager calls on them bit for bit."""
    ops = [_q4_operands(cuda, m, 4096, 1024, seed=20 + m) for m in (8, 300)]
    for x, p, s in ops:
        q4_matmul(x, p, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = [q4_matmul(x, p, s) for x, p, s in ops]
    for x, _, _ in ops:
        x.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    for y, (x, p, s) in zip(ys, ops):
        assert torch.equal(y, q4_matmul(x, p, s))


def test_q4_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, packed, scale = _q4_operands(cuda, 8, 512, 256, group=32)
    with pytest.raises(ValueError, match="group"):
        q4_matmul(x, packed, scale)                     # group 32 < 64
    x, packed, scale = _q4_operands(cuda, 8, 512, 256)
    with pytest.raises(ValueError, match="N"):
        q4_matmul(x, packed[:, :200], scale[:, :200])   # N % 16 != 0
    with pytest.raises(TypeError):
        q4_matmul(x, packed.to(torch.int16), scale)
    with pytest.raises(ValueError, match="contiguous"):
        q4_matmul(x, packed[:, ::2], scale[:, ::2])
    with pytest.raises(ValueError, match="is on"):
        q4_matmul(x, packed.cpu(), scale)


def _quant_cache(cuda, b, s, nkv, hd, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    kq, ks = quantize_rows(torch.randn(b, s, nkv, hd, generator=g, device=cuda))
    vq, vs = quantize_rows(torch.randn(b, s, nkv, hd, generator=g, device=cuda))
    return kq, ks, vq, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,nkv,hd", [(8, 2048, 32, 8, 128),
                                           (3, 128, 6, 2, 128),
                                           (2, 512, 4, 1, 64)])
def test_decode_quant_kernel_matches_plain(cuda, dtype, b, s, nh, nkv, hd):
    kq, ks, vq, vs = _quant_cache(cuda, b, s, nkv, hd)
    q = torch.randn(b, nh, hd, device=cuda).to(dtype)
    pos = torch.tensor([0, s - 1, 63, 64, s // 2, 1, s - 2, 5][:b],
                       dtype=torch.int32, device=cuda)
    before = decode_attention_quant.launches
    got = decode_attention_quant(q, kq, ks, vq, vs, pos)
    torch.cuda.synchronize()
    assert decode_attention_quant.launches == before + 1
    assert got.dtype == dtype
    want = decode_attention_quant_ref(q, kq, ks, vq, vs, pos)
    assert row_rel_err(got, want) <= ROW_RTOL[dtype]


def test_decode_quant_kernel_reads_a_grid_slice_in_place(cuda):
    """Layer 1 of an (L, B, S, NKV, Hd) int8 grid and its (L, B, S, NKV)
    scales, as the engine passes them."""
    kq, ks = quantize_rows(torch.randn(2, 4, 256, 2, 128, device=cuda))
    q = torch.randn(4, 8, 128, device=cuda).bfloat16()
    pos = torch.tensor([0, 100, 200, 255], dtype=torch.int32, device=cuda)
    got = decode_attention_quant(q, kq[1], ks[1], kq[0], ks[0], pos)
    want = decode_attention_quant_ref(q, kq[1], ks[1], kq[0], ks[0], pos)
    assert row_rel_err(got, want) <= ROW_RTOL[torch.bfloat16]


def test_decode_quant_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    kq, ks, vq, vs = _quant_cache(cuda, 2, 64, 2, 64)
    q = torch.zeros(2, 4, 64, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        decode_attention_quant(q.half(), kq, ks, vq, vs, pos)
    with pytest.raises(TypeError):
        decode_attention_quant(q, kq.float(), ks, vq, vs, pos)
    with pytest.raises(TypeError):
        decode_attention_quant(q, kq, ks.double(), vq, vs, pos)
    with pytest.raises(ValueError, match="pos"):
        decode_attention_quant(q, kq, ks, vq, vs, pos.long())
    q96 = torch.zeros(2, 4, 96, device=cuda)
    kq96 = torch.zeros(2, 64, 2, 96, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_quant(q96, kq96, ks, kq96, vs, pos)


def test_quant_wrappers_capture_in_a_cuda_graph(cuda):
    """No host sync inside either wrapper: both record into a graph, and a
    replay recomputes from the inputs' new values."""
    x, packed, scale = _q4_operands(cuda, 8, 512, 256)
    kq, ks, vq, vs = _quant_cache(cuda, 2, 128, 2, 64)
    q = torch.randn(2, 4, 64, device=cuda)
    pos = torch.tensor([5, 127], dtype=torch.int32, device=cuda)
    q4_matmul(x, packed, scale)                       # build and load first
    decode_attention_quant(q, kq, ks, vq, vs, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n4, n2 = q4_matmul.launches, decode_attention_quant.launches
    with torch.cuda.graph(graph):
        y = q4_matmul(x, packed, scale)
        o = decode_attention_quant(q, kq, ks, vq, vs, pos)
    assert (q4_matmul.launches, decode_attention_quant.launches) == (n4 + 1, n2 + 1)
    x.mul_(2.0)
    q.mul_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert row_rel_err(y, q4_matmul_ref(x, packed, scale)) <= ROW_RTOL[torch.float32]
    assert row_rel_err(o, decode_attention_quant_ref(q, kq, ks, vq, vs, pos)) \
        <= ROW_RTOL[torch.float32]


def test_quant_engine_kernel_path_matches_plain_path(cuda):
    """A narrow Llama in fp32 on the card, int4 weights (every projection
    through B3) and an int8 KV cache: the kernel path (auto: A1, B3, B2)
    gives the greedy tokens of the plain path (xla: B3 still, then the
    einsum decode), and the launch counts are exact."""
    outs, counts = [], []
    for impl in ("auto", "xla"):
        cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl=impl, dim=256,
                               ffn_dim=512, n_heads=4, n_kv_heads=2)
        params = quantize_params_int4(llama_init(cfg, seed=3, device=cuda))
        eng = GenerationEngine(params, cfg, slots=2, max_len=160,
                               prefill_buckets=(8, 128), quantize_kv=True,
                               device=cuda)
        before = (flash_attention.launches, q4_matmul.launches,
                  decode_attention_quant.launches, decode_attention.launches)
        hs = [eng.submit(p, max_new_tokens=6)
              for p in ([5, 17, 42], list(range(1, 101)), [9, 8])]
        while eng.step():
            pass
        torch.cuda.synchronize()
        outs.append([h.result(timeout=0) for h in hs])
        after = (flash_attention.launches, q4_matmul.launches,
                 decode_attention_quant.launches, decode_attention.launches)
        counts.append((tuple(a - b for a, b in zip(after, before)),
                       eng.stats().decode_steps))
    assert outs[0] == outs[1]
    (auto, steps), _ = counts
    # 3 prefills (one in the 128 bucket through A1); 2 layers; 7 B3 per
    # layer plus the 512-wide head, per prefill and per decode step
    assert auto == (2, (2 * 7 + 1) * (3 + steps), 2 * steps, 0)


# ---------------------------------------------------------------------------
# flash-decode's split body (B1 and B2 in bf16 at head dim 64 and 128)
# ---------------------------------------------------------------------------

# (B, S, NH, NKV, Hd, pos): Llama-3-8B's decode shapes a-c of
# chip_smoke.py (a ragged grid, the engine's fill at 40-token prompts, one
# request of 8192 rows), then the rows on both sides of split edges
# (128-row splits: 127/128, 255/256) with GQA groups 1, 2 and 4 at head
# dim 64
DECODE_SPLIT_SHAPES = [
    *((b, s, 32, 8, 128, pos) for b, s, pos in
      (DECODE_SHAPES[k] for k in "abc")),
    (6, 512, 8, 8, 64, [127, 128, 255, 256, 0, 511]),
    (6, 512, 8, 4, 64, [127, 128, 255, 256, 1, 510]),
    (6, 300, 8, 2, 128, [127, 128, 255, 256, 299, 64]),
]


def _decode_inputs(cuda, b, s, nh, nkv, hd, pos, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, nh, hd, generator=g, device=cuda).bfloat16()
    kf = torch.randn(b, s, nkv, hd, generator=g, device=cuda)
    vf = torch.randn(b, s, nkv, hd, generator=g, device=cuda)
    return (q, kf, vf, torch.tensor(pos, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("b,s,nh,nkv,hd,pos", DECODE_SPLIT_SHAPES)
def test_decode_split_body_matches_plain(cuda, b, s, nh, nkv, hd, pos):
    """B1 and B2 through the split body, one launch per call, bitwise equal
    over two calls."""
    q, kf, vf, pos = _decode_inputs(cuda, b, s, nh, nkv, hd, pos)
    assert decode_attention_body(torch.bfloat16, hd, nh, nkv) == "split"
    ck, cv = kf.bfloat16(), vf.bfloat16()
    (kq, ks), (vq, vs) = quantize_rows(kf), quantize_rows(vf)
    n1, n2 = decode_attention.launches, decode_attention_quant.launches
    o1 = decode_attention(q, ck, cv, pos)
    o2 = decode_attention_quant(q, kq, ks, vq, vs, pos)
    torch.cuda.synchronize()
    assert (decode_attention.launches, decode_attention_quant.launches) == (n1 + 1, n2 + 1)
    assert row_rel_err(o1, decode_attention_ref(q, ck, cv, pos)) <= ROW_RTOL[torch.bfloat16]
    assert row_rel_err(o2, decode_attention_quant_ref(q, kq, ks, vq, vs, pos)) \
        <= ROW_RTOL[torch.bfloat16]
    assert torch.equal(o1, decode_attention(q, ck, cv, pos))
    assert torch.equal(o2, decode_attention_quant(q, kq, ks, vq, vs, pos))


def test_decode_split_body_reads_engine_slices_in_place(cuda):
    """Layer 1 of the engine's (L, B, S, NKV, Hd) bf16 grid, and of its int8
    grid with (L, B, S, NKV) scales, at a shape that splits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    grid = torch.randn(2, 4, 1024, 8, 128, generator=g, device=cuda)
    kq, ks = quantize_rows(grid)
    gb = grid.bfloat16()
    q = torch.randn(4, 32, 128, generator=g, device=cuda).bfloat16()
    pos = torch.tensor([0, 300, 700, 1023], dtype=torch.int32, device=cuda)
    assert decode_split_plan(4, 8, 1024) < 1024
    got = decode_attention(q, gb[1], gb[0], pos)
    assert row_rel_err(got, decode_attention_ref(q, gb[1], gb[0], pos)) \
        <= ROW_RTOL[torch.bfloat16]
    got = decode_attention_quant(q, kq[1], ks[1], kq[0], ks[0], pos)
    want = decode_attention_quant_ref(q, kq[1], ks[1], kq[0], ks[0], pos)
    assert row_rel_err(got, want) <= ROW_RTOL[torch.bfloat16]


def test_decode_split_body_replays_bitwise_in_a_cuda_graph(cuda):
    """Both wrappers record into one graph (one launch count each); a replay
    equals the eager call bit for bit, also after the inputs change."""
    q, kf, vf, pos = _decode_inputs(cuda, 8, 2048, 32, 8, 128,
                                    [0, 63, 64, 700, 1024, 1500, 2000, 2047])
    ck, cv = kf.bfloat16(), vf.bfloat16()
    (kq, ks), (vq, vs) = quantize_rows(kf), quantize_rows(vf)
    decode_attention(q, ck, cv, pos)            # build and load first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n1, n2 = decode_attention.launches, decode_attention_quant.launches
    with torch.cuda.graph(graph):
        o1 = decode_attention(q, ck, cv, pos)
        o2 = decode_attention_quant(q, kq, ks, vq, vs, pos)
    assert (decode_attention.launches, decode_attention_quant.launches) == (n1 + 1, n2 + 1)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(o1, decode_attention(q, ck, cv, pos))
        assert torch.equal(o2, decode_attention_quant(q, kq, ks, vq, vs, pos))
        q.mul_(-1.0)
        pos.sub_(1).clamp_(min=0)


def test_decode_fp32_and_head_dim_32_take_the_fma_body(cuda):
    """fp32 q (which mma.sync in bf16 cannot take unrounded) and bf16 at
    head dim 16 and 32 keep the FMA body; fp32 meets fp32's tolerance."""
    for hd in (16, 32, 64, 128):
        assert decode_attention_body(torch.bfloat16, hd, 32, 8) == \
            ("split" if hd >= 64 else "fma")
        assert decode_attention_body(torch.float32, hd, 32, 8) == "fma"
    assert decode_attention_body(torch.bfloat16, 64, 32, 1) == "fma"   # G = 32
    q, kf, vf, pos = _decode_inputs(cuda, 4, 512, 8, 2, 32, [0, 127, 128, 511])
    for dtype in (torch.float32, torch.bfloat16):
        qd, ck, cv = q.to(dtype), kf.to(dtype), vf.to(dtype)
        got = decode_attention(qd, ck, cv, pos)
        assert row_rel_err(got, decode_attention_ref(qd, ck, cv, pos)) <= ROW_RTOL[dtype]
    q, kf, vf, pos = _decode_inputs(cuda, 3, 700, 32, 8, 128, [0, 300, 699])
    (kq, ks), (vq, vs) = quantize_rows(kf), quantize_rows(vf)
    got = decode_attention_quant(q.float(), kq, ks, vq, vs, pos)
    want = decode_attention_quant_ref(q.float(), kq, ks, vq, vs, pos)
    assert row_rel_err(got, want) <= ROW_RTOL[torch.float32]


def test_decode_wrappers_raise_on_misaligned_views(cuda):
    """16-byte loads take 16-byte-aligned rows only: both wrappers raise,
    naming the tensor, and launch nothing."""
    q = torch.zeros(2, 8, 64, device=cuda, dtype=torch.bfloat16)
    base = torch.zeros(2, 256, 2, 72, device=cuda, dtype=torch.bfloat16)
    pos = torch.tensor([10, 200], dtype=torch.int32, device=cuda)
    shifted = base[..., 1:65]                                    # 2 bytes off
    narrowed = torch.zeros(2, 256, 2, 68, device=cuda,
                           dtype=torch.bfloat16)[..., :64]       # rows of 136 B
    kq = torch.zeros(2, 256, 2, 80, device=cuda, dtype=torch.int8)[..., 4:68]
    ks = torch.zeros(2, 256, 2, device=cuda)
    good = torch.zeros(2, 256, 2, 64, device=cuda, dtype=torch.int8)
    before = (decode_attention.launches, decode_attention_quant.launches)
    with pytest.raises(ValueError, match="^ck rows must be 16-byte aligned"):
        decode_attention(q, shifted, base[..., :64], pos)
    with pytest.raises(ValueError, match="^cv rows must be 16-byte aligned"):
        decode_attention(q, base[..., :64], narrowed, pos)
    with pytest.raises(ValueError, match="^q rows must be 16-byte aligned"):
        decode_attention(torch.zeros(2, 8, 72, device=cuda,
                                     dtype=torch.bfloat16)[..., 1:65],
                         base[..., :64], base[..., :64], pos)
    with pytest.raises(ValueError, match="^kq rows must be 16-byte aligned"):
        decode_attention_quant(q, kq, ks, good, ks, pos)
    assert (decode_attention.launches, decode_attention_quant.launches) == before


# ---------------------------------------------------------------------------
# the engine's request features (prefix cache, chunked prefill, penalties)
# ---------------------------------------------------------------------------


def _features_engine(params, cfg, cuda, **kw):
    # 200-row prefill buckets take the plain attention, as every suffix
    # pass does, so chunked, prefixed and one-shot admissions compute the
    # same attention and differ only in the order of its sums; the 128
    # bucket would take A1 in a from-zero prefill
    return GenerationEngine(params, cfg, slots=4, max_len=512,
                            prefill_buckets=(128, 200), device=cuda, **kw)


def _slot_rows(eng, slot, n):
    return eng._cache.k[:, slot, :n].clone(), eng._cache.v[:, slot, :n].clone()


def _admit(eng, prompt):
    """One request of one token, run to its end: its rows stay in slot 0."""
    h = eng.submit(prompt, max_new_tokens=1)
    while eng.step():
        pass
    h.result(timeout=0)


def _tiny_prompt(cfg, n, seed):
    return torch.randint(0, cfg.vocab_size, (n,),
                         generator=torch.Generator().manual_seed(seed)).tolist()


def test_engine_chunked_admission_matches_one_shot(cuda):
    """tiny in bf16: a 200-token prompt in 64-token chunks (a from-zero
    prefill, then suffix passes) leaves the slot's rows of every layer, and
    gives first-token logits, within the bf16 row tolerance of a one-shot
    admission in the 200 bucket."""
    from kubetorch_tpu_torch.serve import engine as engine_mod
    cfg = LlamaConfig.tiny(attn_impl="auto")
    params = llama_init(cfg, seed=3, device=cuda)
    prompt = _tiny_prompt(cfg, 200, 0)
    rows, logits = [], []
    real = engine_mod._sample_first

    def spy(lg, samp):
        logits.append(lg.clone())
        return real(lg, samp)

    engine_mod._sample_first = spy
    try:
        for chunk in (None, 64):
            eng = _features_engine(params, cfg, cuda, prefill_chunk=chunk)
            _admit(eng, prompt)
            rows.append(_slot_rows(eng, 0, 200))
    finally:
        engine_mod._sample_first = real
    for got, want in zip(rows[1], rows[0]):
        assert row_rel_err(got, want) <= ROW_RTOL[torch.bfloat16]
    assert row_rel_err(logits[1], logits[0]) <= ROW_RTOL[torch.bfloat16]


def test_engine_prefix_admission_matches_full_prompt(cuda):
    """tiny in bf16: a 150-token registered prefix and a 50-token suffix
    (padded to the 128 bucket, where a from-zero prefill would launch A1;
    the suffix pass launches none) leave the slot's rows within the bf16
    row tolerance of the full prompt admitted one-shot, and the stored
    prefix rows unchanged."""
    cfg = LlamaConfig.tiny(attn_impl="auto")
    params = llama_init(cfg, seed=3, device=cuda)
    prompt = _tiny_prompt(cfg, 200, 1)
    eng = _features_engine(params, cfg, cuda)
    _admit(eng, prompt)
    want = _slot_rows(eng, 0, 200)
    eng = _features_engine(params, cfg, cuda, auto_prefix=True)
    pid = eng.register_prefix(prompt[:150])
    keep = eng._prefixes[pid].k.clone(), eng._prefixes[pid].v.clone()
    a1 = flash_attention.launches
    _admit(eng, prompt)
    torch.cuda.synchronize()
    assert flash_attention.launches == a1
    assert eng._prefix_hits == 1
    for got, ref in zip(_slot_rows(eng, 0, 200), want):
        assert row_rel_err(got, ref) <= ROW_RTOL[torch.bfloat16]
    assert torch.equal(eng._prefixes[pid].k, keep[0])
    assert torch.equal(eng._prefixes[pid].v, keep[1])
    a1 = flash_attention.launches
    eng.register_prefix(prompt[:100])              # the 128 bucket: A1
    torch.cuda.synchronize()
    assert flash_attention.launches == a1 + cfg.n_layers


def test_engine_zero_penalty_neighbours_are_bit_identical(cuda):
    """tiny in bf16 on the card: the tokens and logprobs of unpenalized,
    unbiased neighbours equal those of a run without the penalized and
    biased requests, bit for bit; the biased request emits its token every
    time and the penalized one repeats nothing."""
    cfg = LlamaConfig.tiny(attn_impl="auto")
    params = llama_init(cfg, seed=3, device=cuda)
    prompts = [[5, 17, 42], [9, 8, 7, 6], [300, 2]]

    def run(with_others):
        eng = _features_engine(params, cfg, cuda, decode_block=2)
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        extra = []
        if with_others:
            extra = [eng.submit([1, 2, 3], max_new_tokens=12,
                                logit_bias={77: 100.0}),
                     eng.submit([4, 5, 6], max_new_tokens=12,
                                presence_penalty=1e4)]
        while eng.step():
            pass
        return ([(h.result(timeout=0), h.logprobs) for h in hs],
                [h.result(timeout=0) for h in extra])

    alone, _ = run(False)
    beside, (forced, penalized) = run(True)
    assert beside == alone
    assert forced == [77] * 12
    assert len(set(penalized) | {4, 5, 6}) == len(penalized) + 3


# ---------------------------------------------------------------------------
# MoE serving (int8 expert banks beside int4 attention)
# ---------------------------------------------------------------------------


def test_moe_engine_kernel_counts_and_plain_path(cuda):
    """A narrow MoE in fp32 on the card, int4 attention and head (through
    B3), int8 experts and an int8 KV cache, on 2 slots (decode through the
    dispatch, 2 x 2 x 2 > 4 experts) and 1 slot (the gather): the kernel
    path gives the plain path's greedy tokens and exact launch counts."""
    from kubetorch_tpu_torch.models.moe import MoeConfig, moe_init
    for slots in (2, 1):
        outs, counts = [], []
        for impl in ("auto", "xla"):
            cfg = MoeConfig.tiny(dtype=torch.float32, attn_impl=impl, dim=256,
                                 ffn_dim=512, n_heads=4, n_kv_heads=2,
                                 vocab_size=512)
            params = quantize_params_int4(moe_init(cfg, seed=3, device=cuda))
            eng = GenerationEngine(params, cfg, slots=slots, max_len=160,
                                   prefill_buckets=(8, 128), quantize_kv=True,
                                   device=cuda)
            before = (flash_attention.launches, q4_matmul.launches,
                      decode_attention_quant.launches, decode_attention.launches)
            hs = [eng.submit(p, max_new_tokens=6)
                  for p in ([5, 17, 42], list(range(1, 101)), [9, 8])]
            while eng.step():
                pass
            torch.cuda.synchronize()
            outs.append([h.result(timeout=0) for h in hs])
            after = (flash_attention.launches, q4_matmul.launches,
                     decode_attention_quant.launches, decode_attention.launches)
            counts.append((tuple(a - b for a, b in zip(after, before)),
                           eng.stats().decode_steps))
        assert outs[0] == outs[1]
        (auto, steps), _ = counts
        # 3 prefills (one in the 128 bucket through A1); 2 layers; B3 on the
        # 4 attention projections per layer and the 512-wide head, per
        # prefill and per decode step; B2 per layer and step
        assert auto == (2, (2 * 4 + 1) * (3 + steps), 2 * steps, 0)


def test_moe_int8_bank_per_expert_equals_whole_bank_dequant(cuda):
    """bf16 on the card: the dispatch's per-expert dequantization of an int8
    bank, and the gather's dequantization of the gathered slices, give the
    same bits as running on the bank dequantized whole."""
    from kubetorch_tpu_torch.models.llama import layer_weights
    from kubetorch_tpu_torch.models.moe import (MoeConfig, moe_ffn,
                                                moe_ffn_decode, moe_init)
    from kubetorch_tpu_torch.models.quant import dequant, quantize_params
    cfg = MoeConfig.tiny(dim=512, ffn_dim=1024, n_heads=8, n_kv_heads=2,
                         n_experts=8)
    lw = layer_weights(quantize_params(moe_init(cfg, seed=1, device=cuda)), 0)
    whole = dict(lw, experts={k: dequant(v, torch.bfloat16)
                              for k, v in lw["experts"].items()})
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 256, cfg.dim, generator=g, device=cuda).bfloat16()
    got, _ = moe_ffn(cfg, x, lw)
    want, _ = moe_ffn(cfg, x, whole)
    assert torch.equal(got, want) and got.abs().sum() > 0
    x1 = x[:, :1].contiguous()
    assert torch.equal(moe_ffn_decode(cfg, x1, lw), moe_ffn_decode(cfg, x1, whole))


# ---------------------------------------------------------------------------
# speculative decoding: B1 at the draft's head dim, B3 at the verify window
# ---------------------------------------------------------------------------


def test_spec_engine_on_the_card_matches_plain_engine(cuda):
    """tiny in fp32 on the card: SpeculativeEngine, with an independent
    draft and with the target as its own draft, gives the plain engine's
    greedy tokens; the run went through A1 (the 128-bucket prefills of
    both models) and B1 (the draft's decode blocks), and self-draft
    accepts every proposal (13 tokens: the first, then three rounds of
    k + 1 = 4, so no budget cuts a round short)."""
    from kubetorch_tpu_torch.serve import SpeculativeEngine
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    dcfg = LlamaConfig.tiny(dtype=torch.float32, dim=32, n_layers=1,
                            n_heads=2, n_kv_heads=1, ffn_dim=64)
    params = llama_init(cfg, seed=3, device=cuda)
    draft = llama_init(dcfg, seed=4, device=cuda)
    prompts = ([5, 17, 42], list(range(1, 101)), [9, 8])
    grid = dict(slots=2, max_len=160, prefill_buckets=(8, 128), device=cuda)

    def run(eng):
        hs = [eng.submit(p, max_new_tokens=13) for p in prompts]
        while eng.step():
            pass
        return [h.result(timeout=0) for h in hs]

    want = run(GenerationEngine(params, cfg, **grid))
    for d, dc in ((draft, dcfg), (params, cfg)):
        eng = SpeculativeEngine(params, cfg, d, dc, spec_k=3, **grid)
        a1, b1 = flash_attention.launches, decode_attention.launches
        assert run(eng) == want
        torch.cuda.synchronize()
        assert flash_attention.launches - a1 == cfg.n_layers + dc.n_layers
        # B1 once per draft layer in each of a round's k-1 decode steps;
        # the target's verify window attends with the plain einsum
        assert decode_attention.launches - b1 == \
            dc.n_layers * (eng.k - 1) * eng._steps
    assert eng.spec_stats.acceptance_rate == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [[0, 63, 64, 700, 1024, 1500, 2000, 2047],
                                 [2047] * 8])
def test_decode_kernel_at_the_draft_head_dim(cuda, dtype, pos):
    """B1 at the Llama-3.2-1B draft's heads (NH 32, NKV 8, Hd 64) on 8
    slots of 2048 rows, ragged and full: the split body for bf16 (the FMA
    body for fp32), per row within the tolerance, the same bits twice."""
    b, s, nh, nkv, hd = 8, 2048, 32, 8, 64
    q, kf, vf, p = _decode_inputs(cuda, b, s, nh, nkv, hd, pos)
    q, ck, cv = q.to(dtype), kf.to(dtype), vf.to(dtype)
    assert decode_attention_body(dtype, hd, nh, nkv) == (
        "split" if dtype == torch.bfloat16 else "fma")
    got = decode_attention(q, ck, cv, p)
    assert row_rel_err(got, decode_attention_ref(q, ck, cv, p)) <= ROW_RTOL[dtype]
    assert torch.equal(got, decode_attention(q, ck, cv, p))


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096)])
def test_q4_kernel_at_the_verify_window(cuda, k, n):
    """B3 at 72 rows (8 slots x a 9-token verify window, spec_k 4) at
    Llama-3-8B's projections: the wgmma body, per row within the fp32
    tolerance, the same bits twice."""
    x, packed, scale = _q4_operands(cuda, 72, k, n, seed=k + n)
    assert q4_matmul_body(72, k, n, scale.shape[0]) == "wgmma"
    got = q4_matmul(x.bfloat16(), packed, scale)
    assert row_rel_err(got, q4_matmul_ref(x, packed, scale)) \
        <= ROW_RTOL[torch.float32]
    assert torch.equal(got, q4_matmul(x.bfloat16(), packed, scale))


def test_prefetch_copies_on_a_side_stream(cuda, monkeypatch):
    """``prefetch_to_device`` queues its copies on a stream of its own:
    with the consumer's stream held busy, the side stream finishes the
    copies while the consumer's is still running, and what the consumer
    then reads (its stream waits on each batch's event) is the source."""
    from kubetorch_tpu_torch.train import data as pt_data
    made = []
    real = torch.cuda.Stream

    def stream(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Stream", stream)
    gen = torch.Generator().manual_seed(0)
    src = [{"tokens": torch.randint(0, 1000, (4, 2048), generator=gen),
            "targets": torch.randint(0, 1000, (4, 2048), generator=gen)}
           for _ in range(4)]
    torch.cuda._sleep(2_000_000_000)          # about a second of spinning
    it = pt_data.prefetch_to_device(iter(src), size=2, device=cuda)
    first = next(it)
    side = made[0]              # the generator's own, made before any copy
    assert side != torch.cuda.current_stream()
    side.synchronize()
    assert not torch.cuda.current_stream().query()
    got = [first] + list(it)
    for g, w in zip(got, src):
        assert g["tokens"].device.type == "cuda"
        assert torch.equal(g["tokens"].cpu(), w["tokens"])
        assert torch.equal(g["targets"].cpu(), w["targets"])
    assert len(got) == len(src)


def test_moe_loss_kernel_path_matches_plain(cuda):
    """``moe_loss`` and its gradients at ``MoeConfig.tiny`` in fp32 with
    capacity drops: the flash kernels (A1 with LSE, A2, A3; FMA bodies at
    head dim 16) against the plain attention, with remat; exact launch
    counts (A1 twice per layer, A2 and A3 once)."""
    from kubetorch_tpu_torch.models import moe as pm
    cfg = pm.MoeConfig.tiny(dtype=torch.float32, capacity_factor=0.5)
    params = pm.moe_init(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    out = {}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        step = make_train_step(lambda p, t, y: pm.moe_loss(p, t, y, c))
        before = _counts()
        out[impl] = step.loss_and_grads(params, batch)
        n = tuple(a - b for a, b in zip(_counts(), before))
        assert n == ((2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
                     if impl == "auto" else (0, 0, 0))
    (lk, gk), (lp, gp) = out["auto"], out["xla"]
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# ---------------------------------------------------------------------------
# checkpoints and the live weight rollout (MemStore: chip_smoke's in-memory
# store protocol)
# ---------------------------------------------------------------------------


def test_async_snapshot_holds_its_step_under_donate(cuda):
    """maybe_save's copies into pinned memory ride the step's stream, so a
    donate=True step issued at once (in place) cannot reach the saved
    bytes: the commit fingerprints as the state before that step, and
    restored it repeats the live step's loss exactly."""
    from chip_smoke import MemStore
    from kubetorch_tpu_torch.train import (Checkpointer, train_state_from_tree,
                                           train_state_tree, tree_fingerprint)
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    opt = default_optimizer(warmup_steps=2)
    state = init_train_state(llama_init(cfg, seed=7, device=cuda), opt)
    step = make_train_step(lambda p, t, y: llama_loss_chunked(p, t, y, cfg, 32),
                           opt)
    batch = _tiny_batch(cuda)
    for _ in range(2):
        state, _ = step(state, batch)
    want = tree_fingerprint(train_state_tree(state))
    ckpt = Checkpointer("t/snap", store=MemStore())
    ckpt.maybe_save(train_state_tree(state), 2)
    state, m = step(state, batch)          # in place, right behind the copies
    live = float(m["loss"])
    assert ckpt.flush() == 2
    tree, at = ckpt.restore()
    assert at == 2 and tree_fingerprint(tree) == want
    assert tree["params"]["embed"].dtype.itemsize == 2
    resumed = train_state_from_tree(tree, state, device=cuda)
    _, m2 = step(resumed, batch)
    assert float(m2["loss"]) == live


def test_rollout_swaps_in_place_without_device_memory(cuda):
    """The swap writes the new bytes into the engine's own tensors from
    host memory: no allocation on the card, the same tensor objects, and
    the engine's tokens afterwards equal a fresh engine's on the new
    tree."""
    from chip_smoke import MemStore
    from kubetorch_tpu_torch.models.convert import params_to_numpy
    from kubetorch_tpu_torch.serve import WeightRollout
    from kubetorch_tpu_torch.train import publish_rollout
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    params = llama_init(cfg, seed=8, device=cuda)
    new = tree_map(lambda t: t.clone(), params)
    new["layers"]["wq"].mul_(1.5)
    new["layers"]["wo"].mul_(0.5)

    def engine(p):
        return GenerationEngine(p, cfg, slots=2, max_len=160,
                                prefill_buckets=(8, 128), device=cuda)

    def tokens(eng):
        hs = [eng.submit(p, max_new_tokens=6) for p in ([5, 17, 42], [9, 8])]
        while eng.step():
            pass
        return [h.result(timeout=0) for h in hs]

    eng = engine(params)
    held = params["layers"]["wq"]
    store = MemStore()
    publish_rollout("llm", params_to_numpy(new), 1, store=store)
    wr = WeightRollout(eng, "llm", store=store)
    wr._ensure_ledger()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = wr.poll_once()
    torch.cuda.synchronize()
    assert res["leaves_changed"] == 2
    assert torch.cuda.max_memory_allocated() == before
    assert eng.params["layers"]["wq"] is held
    assert torch.equal(held, new["layers"]["wq"])
    assert tokens(eng) == tokens(engine(new))


# ---------------------------------------------------------------------------
# HF checkpoints and the OpenAI surface
# ---------------------------------------------------------------------------


def _bf16_hf_dir(path, monkeypatch):
    """A tiny Llama as a bf16 safetensors directory in three or more
    shards: save_hf's fp32 export, each tensor rewritten in bf16."""
    from kubetorch_tpu_torch.models import convert_hf
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = llama_init(cfg, seed=12, device="cpu")
    params["layers"]["attn_norm"].add_(torch.linspace(-0.5, 0.5, 64))
    fp32 = str(path / "fp32")
    convert_hf.save_hf(params, cfg, fp32)
    monkeypatch.setattr(convert_hf, "SHARD_BYTES", 60_000)
    out = str(path / "bf16")
    with convert_hf._SafetensorsReader(fp32) as reader:
        items = [(name, torch.bfloat16, ref.shape,
                  lambda ref=ref: ref.read(torch.device("cpu")).bfloat16())
                 for name, ref in reader.refs.items()]
        convert_hf._write_checkpoint(out, items)
    with open(f"{fp32}/config.json") as f, open(f"{out}/config.json", "w") as g:
        g.write(f.read())
    return out


def test_bf16_checkpoint_lands_on_the_card_bitwise(cuda, tmp_path, monkeypatch):
    """Read through the pinned staging buffer, across shards, the card's
    tree is the CPU's bit for bit, in bf16 and widened to fp32."""
    from kubetorch_tpu_torch.models import load_hf
    d = _bf16_hf_dir(tmp_path, monkeypatch)
    for dtype in (torch.bfloat16, torch.float32):
        on_card, cfg = load_hf(d, device=cuda, dtype=dtype)
        on_cpu, _ = load_hf(d, device="cpu", dtype=dtype)
        cpu_leaves = _named(on_cpu)
        for name, a in _named(on_card).items():
            assert a.is_cuda and a.dtype == cpu_leaves[name].dtype, name
            assert torch.equal(a.cpu(), cpu_leaves[name]), name
        assert on_card["layers"]["wq"].dtype == dtype


def test_load_hf_defaults_to_the_card(cuda, tmp_path, monkeypatch):
    from kubetorch_tpu_torch.models import load_hf
    params, _ = load_hf(_bf16_hf_dir(tmp_path, monkeypatch))
    assert all(t.is_cuda for t in _named(params).values())


def _named(tree):
    from kubetorch_tpu_torch.data_store.commands import _flatten
    out = {}
    _flatten(tree, "", out)
    return out


def test_plain_method_embeddings_on_the_card(cuda):
    """/v1/embeddings through the plain method: A1 once per layer per
    input (right-padded to the engine's bucket), within 5e-2 of the pooled
    plain-attention hidden states over the real tokens."""
    from kubetorch_tpu_torch.models.llama import llama_hidden
    from kubetorch_tpu_torch.serve import OpenAIApp
    cfg = LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1, ffn_dim=512,
                           max_seq_len=256, dtype=torch.bfloat16)
    params = llama_init(cfg, seed=13, device=cuda)
    eng = GenerationEngine(params, cfg, slots=2, max_len=256,
                           prefill_buckets=(128,), device=cuda)
    g = torch.Generator().manual_seed(13)
    inputs = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
              for n in (100, 256, 7)]
    flash_attention.launches = 0
    status, data = OpenAIApp(eng).embed({"input": inputs})
    assert status == 200 and flash_attention.launches == 3 * cfg.n_layers
    plain = dataclasses.replace(cfg, attn_impl="xla")
    for ids, item in zip(inputs, data["data"]):
        got = torch.tensor(item["embedding"], device=cuda)
        with torch.no_grad():
            want = llama_hidden(params, torch.tensor([ids], device=cuda),
                                plain).float().mean(dim=1)[0]
        assert torch.isfinite(got).all() and got.shape == (cfg.dim,)
        assert float((got - want).norm() / want.norm()) <= 5e-2


# ---------------------------------------------------------------------------
# the port as a fabric workload: ViT, NCCL, the card's gauges
# ---------------------------------------------------------------------------


def test_vit_kernel_path_matches_plain_on_the_card(cuda):
    """ViT-B/16's sequence (224² images, patch 16: S = 196, head dim 64,
    non-causal) at width 128 in bf16: 2 A1 launches per forward, logits
    within 5e-2 of the plain path; a remat train step launches A1 twice
    per layer and A2, A3 once, its loss within 2e-2 of the plain path's."""
    from kubetorch_tpu_torch.models import vit as pv
    cfg = pv.VitConfig(dim=128, n_heads=2, mlp_dim=256, n_layers=2,
                       n_classes=10)
    params = pv.vit_init(0, cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    images = torch.randn(4, 224, 224, 3, generator=g, device=cuda)
    labels = torch.randint(0, 10, (4,), generator=g, device=cuda)
    plain = dataclasses.replace(cfg, attn_impl="xla")
    before = _counts()
    logits = pv.vit_forward(params, images, cfg)
    assert _counts() == (before[0] + 2, before[1], before[2])
    want = pv.vit_forward(params, images, plain)
    assert float((logits - want).norm() / want.norm()) <= 5e-2
    step = make_train_step(lambda p, x, y: pv.vit_loss(p, x, y, cfg))
    before = _counts()
    loss, _ = step.loss_and_grads(params, {"tokens": images, "targets": labels})
    assert tuple(a - b for a, b in zip(_counts(), before)) == (4, 2, 2)
    with torch.no_grad():
        ref = float(pv.vit_loss(params, images, labels, plain))
    assert abs(float(loss) - ref) <= 2e-2


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_nccl_world_of_one_from_the_injected_env(cuda, monkeypatch):
    import torch.distributed as dist

    from kubetorch_tpu_torch.serving import distributed
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(key, value)
    distributed.init_process_group()
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        assert torch.cuda.current_device() == 0
        t = torch.arange(8.0, device=cuda)
        want = t.clone()
        dist.all_reduce(t)
        assert torch.equal(t, want)
    finally:
        distributed.destroy()
    assert not dist.is_initialized()


def test_gpu_gauges_after_an_allocation(cuda):
    """The card's series once CUDA is up, equal to the allocator's live
    bytes and the card's total; the engine's hook carries the flat keys."""
    from kubetorch_tpu_torch.serving import gpu_gauges
    x = torch.empty(1 << 22, device=cuda)
    torch.cuda.synchronize()
    g = gpu_gauges()
    in_use = torch.cuda.memory_stats(0)["allocated_bytes.all.current"]
    total = torch.cuda.mem_get_info(0)[1]
    assert g['kt_gpu_hbm_bytes_in_use{device="0"}'] == float(in_use)
    assert g['kt_gpu_hbm_bytes_limit{device="0"}'] == float(total)
    assert in_use >= x.nbytes
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    eng = GenerationEngine(llama_init(cfg, seed=1, device=cuda), cfg, slots=2,
                           max_len=128, prefill_buckets=(128,), device=cuda)
    m = eng.__kt_metrics__()
    assert m["gpu_hbm_bytes_limit"] == float(total)
    assert 0 < m["gpu_hbm_bytes_in_use"] <= total


# ---------------------------------------------------------------------------
# the mesh path on the card: a world of 1 over nccl (parallel/, the mesh
# train step); multi-rank meshes are held on the CPU by gloo worlds
# (tests/test_torch_mesh_train.py, tests/test_torch_context_parallel.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(cuda, monkeypatch):
    from kubetorch_tpu_torch.serving import distributed
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(_free_port()),
                       "KT_MESH": '{"fsdp": -1}'}.items():
        monkeypatch.setenv(key, value)
    distributed.init_process_group()
    try:
        yield distributed.mesh()
    finally:
        distributed.destroy()


def test_world_of_one_mesh_step_equals_the_plain_step(nccl_mesh):
    """tiny Llama, bf16, remat "dots", chunked CE, default_optimizer: 3
    steps through make_train_step(mesh=, rules=LLAMA_RULES) give the plain
    step's losses, grad norms and params bit for bit, with the same A1/A2/A3
    counts."""
    from torch.distributed.tensor import DTensor

    from kubetorch_tpu_torch.models.llama import llama_loss_chunked
    from kubetorch_tpu_torch.parallel import LLAMA_RULES

    mesh = nccl_mesh
    assert (mesh.device_type, mesh.mesh_dim_names, tuple(mesh.shape)) == \
        ("cuda", ("data",), (1,))
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, remat_policy="dots")
    opt = default_optimizer(warmup_steps=2)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                           device="cuda")
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    runs = {}
    for name, kw in (("plain", {}), ("mesh", dict(mesh=mesh, rules=LLAMA_RULES))):
        step = make_train_step(
            lambda p, t, y: llama_loss_chunked(p, t, y, cfg, chunk=32), opt, **kw)
        state = init_train_state(llama_init(cfg, seed=0, device="cuda"), opt)
        if kw:
            state = step.shard_state(state)
            assert all(isinstance(x, DTensor) for x in
                       tree_leaves(state.params) + tree_leaves(state.opt_state))
        flash_attention.launches = flash_attention.bwd_dq_launches = 0
        flash_attention.bwd_dkv_launches = 0
        metrics = []
        for _ in range(3):
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        params = tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                          else x, state.params)
        runs[name] = (metrics, tree_leaves(params), _counts())
    (m0, p0, c0), (m1, p1, c1) = runs["plain"], runs["mesh"]
    assert m1 == m0
    assert all(torch.equal(a, b) for a, b in zip(p1, p0))
    assert c1 == c0 == (3 * 2 * cfg.n_layers, 3 * cfg.n_layers, 3 * cfg.n_layers)


def test_pipeline_hop_and_output_on_cuda_at_a_world_of_one(nccl_mesh):
    """The pipeline's hop (a send to the next stage and a receive from the
    previous one, here the rank itself) and its output reduction on CUDA
    tensors over nccl: the values come back bit for bit on the direct path,
    the hop's backward sends the gradient back, the reduction's backward is
    the identity."""
    import torch.distributed as dist

    from kubetorch_tpu_torch.parallel import pipeline as pl

    group = nccl_mesh.get_group()
    x = torch.randn(2, 64, 32, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    before = dict(pl.HOP_PATHS)
    recv, token = pl._Hop.apply(x * 1, group, 0, 1, x)
    assert torch.equal(recv, x) and recv.is_cuda and float(token.detach()) == 0.0
    y = pl._PipeOut.apply(recv, group, token)
    assert torch.equal(y, x)
    g = torch.randn_like(x)
    (gx,) = torch.autograd.grad(y, [x], g)
    assert torch.equal(gx, g)
    assert pl.HOP_PATHS["direct"] - before["direct"] == 2
    assert pl.HOP_PATHS["host"] == before["host"]
    assert dist.get_backend(group) == "nccl"


@pytest.mark.parametrize("microbatches", [1, 2])
def test_pipelined_step_launches_the_kernels_in_checkpointed_stages(
        nccl_mesh, microbatches):
    """llama_loss_pipelined at a world of 1 (bf16, attn "flash"): each
    layer of the stage body runs under its checkpoint, so A1 launches twice
    per layer and microbatch (forward, recompute), A2 and A3 once; with one
    microbatch the loss and every gradient are the plain step's bit for
    bit, with two the loss within 2e-2."""
    from torch.distributed.tensor import DTensor

    from kubetorch_tpu_torch.parallel import (PIPE_LLAMA_RULES,
                                              llama_loss_pipelined)

    mesh = nccl_mesh
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, attn_impl="flash")
    opt = default_optimizer(warmup_steps=2)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                           device="cuda")
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    runs = {}
    for name, loss_fn, kw in (
            ("plain", lambda p, t, y: llama_loss_chunked(p, t, y, cfg, chunk=32), {}),
            ("pipe", lambda p, t, y: llama_loss_pipelined(
                p, t, y, cfg, mesh, n_microbatches=microbatches, chunk=32),
             dict(mesh=mesh, rules=PIPE_LLAMA_RULES))):
        step = make_train_step(loss_fn, opt, **kw)
        params = llama_init(cfg, seed=0, device="cuda")
        if kw:
            params = step.shard_state(init_train_state(params, opt)).params
        flash_attention.launches = flash_attention.bwd_dq_launches = 0
        flash_attention.bwd_dkv_launches = 0
        loss, grads = (step.grads_fn if kw else step.loss_and_grads)(params, batch)
        grads = tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                         else x, grads)
        loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
        runs[name] = (float(loss), tree_leaves(grads), _counts())
    (l0, g0, c0), (l1, g1, c1) = runs["plain"], runs["pipe"]
    L = cfg.n_layers
    assert c1 == (2 * L * microbatches, L * microbatches, L * microbatches)
    assert c0 == (2 * L, L, L)
    if microbatches == 1:
        assert l1 == l0
        assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    else:
        assert abs(l1 - l0) <= 2e-2


def test_flash_attention_on_dtensors_launches_once(nccl_mesh):
    from torch.distributed.tensor import DTensor, Replicate

    mesh = nccl_mesh
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(2, 256, nh, 64, generator=g, device="cuda")
               .bfloat16().requires_grad_() for nh in (8, 2, 2))
    dq, dk, dv = (DTensor.from_local(t, mesh, [Replicate()]) for t in (q, k, v))
    before = _counts()
    out = flash_attention(dq, dk, dv, causal=True)
    out.to_local().float().square().sum().backward()
    torch.cuda.synchronize()
    assert isinstance(out, DTensor) and out.placements == (Replicate(),)
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    q2, k2, v2 = (t.detach().requires_grad_() for t in (q, k, v))
    want = flash_attention(q2, k2, v2, causal=True)
    want.float().square().sum().backward()
    assert torch.equal(out.to_local(), want)
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a.grad, b.grad)


# ---------------------------------------------------------------------------
# the partial mode of B1/B2: context-parallel decode over cache shards
# ---------------------------------------------------------------------------

PARTIAL_SHAPES = [
    # frontiers inside a shard, on a shard boundary (255, 256), in the last
    # shard, and slots whose later shards are empty (0, 100)
    (torch.bfloat16, 8, 1024, 32, 8, 128, [0, 100, 255, 256, 511, 700, 1023, 900]),
    (torch.bfloat16, 4, 2048, 8, 2, 64, [63, 512, 1500, 2047]),
    (torch.float32, 4, 512, 4, 2, 32, [0, 127, 128, 400]),
]


def _partials_hold(got, want, empty, dtype):
    (m, l, acc), (mr, lr, accr) = got, want
    live = ~empty
    assert float((m - mr).abs().max()) <= 1e-3 * max(1.0, float(mr.abs()[live].max()))
    assert torch.all(l[empty] == 0) and torch.all(acc[empty] == 0)
    assert torch.all(m[empty] == -1e29)
    if live.any():
        assert row_rel_err((acc / l[..., None])[live], (accr / lr[..., None])[live]) \
            <= ROW_RTOL[dtype]
        scaled = l * torch.exp(m - mr)
        assert float(((scaled - lr).abs() / lr.clamp_min(1e-30))[live].max()) \
            <= ROW_RTOL[dtype]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,b,s,nh,nkv,hd,pos", PARTIAL_SHAPES)
def test_decode_partial_mode_matches_plain(cuda, quant, dtype, b, s, nh, nkv, hd, pos):
    """Four emulated context shards: each launch against the plain partial
    ref, the local combine against the refs' combine and one whole-cache
    call; one partial launch counted per shard."""
    q, kf, vf, pos = _decode_inputs(cuda, b, s, nh, nkv, hd, pos)
    q = q.to(dtype)
    c, rows = 4, s // 4
    if quant:
        (kq, ks), (vq, vs) = quantize_rows(kf), quantize_rows(vf)
        cut = lambda i: [t[:, i * rows:(i + 1) * rows] for t in (kq, ks, vq, vs)]  # noqa: E731
        launch, plain = decode_attention_quant_partial, decode_attention_quant_partial_ref
        whole = decode_attention_quant(q, kq, ks, vq, vs, pos)
        counter = decode_attention_quant_partial
    else:
        ck, cv = kf.to(dtype), vf.to(dtype)
        cut = lambda i: [t[:, i * rows:(i + 1) * rows] for t in (ck, cv)]  # noqa: E731
        launch, plain = decode_attention_partial, decode_attention_partial_ref
        whole = decode_attention(q, ck, cv, pos)
        counter = decode_attention_partial
    n0 = counter.launches
    got, want = [], []
    for i in range(c):
        got.append(launch(q, *cut(i), pos, i * rows))
        want.append(plain(q, *cut(i), pos, i * rows))
        empty = (pos < i * rows)[:, None].expand(b, nh)
        _partials_hold(got[-1], want[-1], empty, dtype)
    torch.cuda.synchronize()
    assert counter.launches == n0 + c
    stack = [torch.stack(x) for x in zip(*got)]
    out = combine_partials(*stack, dtype=dtype)
    ref = combine_partials(*[torch.stack(x) for x in zip(*want)], dtype=dtype)
    assert row_rel_err(out, ref) <= ROW_RTOL[dtype]
    assert row_rel_err(out, whole) <= ROW_RTOL[dtype]


def test_world_of_one_mesh_engine_equals_the_plain_engine(nccl_mesh):
    """tiny bf16 Llama served through the mesh engine at a world of 1 (every
    placement Replicate()): the plain engine's tokens, logprobs and
    first-token logits bit for bit, with the same A1 and B1 counts."""
    from kubetorch_tpu_torch.parallel import LLAMA_RULES
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree
    from kubetorch_tpu_torch.serve import engine as engine_mod

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    params = llama_init(cfg, seed=0, device="cuda")
    prompts = [[5, 17, 42], list(range(1, 140)), [9] * 20]
    runs = {}
    real = engine_mod._prefill_logits
    for name, p, kw in (("plain", params, {}),
                        ("mesh", shard_pytree(params, LLAMA_RULES, nccl_mesh),
                         {"mesh": nccl_mesh})):
        first = []

        def record(*a, **k):
            got = real(*a, **k)
            first.append(got[0].clone())
            return got

        engine_mod._prefill_logits = record
        try:
            eng = GenerationEngine(p, cfg, slots=2, max_len=256,
                                   prefill_buckets=(128, 256), device="cuda", **kw)
            flash_attention.launches = decode_attention.launches = 0
            hs = [eng.submit(q, max_new_tokens=8) for q in prompts]
            while eng.step():
                pass
        finally:
            engine_mod._prefill_logits = real
        runs[name] = ([h.result(timeout=0) for h in hs], [h.logprobs for h in hs],
                      first, (flash_attention.launches, decode_attention.launches))
    (t0, l0, f0, c0), (t1, l1, f1, c1) = runs["plain"], runs["mesh"]
    assert t1 == t0 and l1 == l0 and c1 == c0
    assert all(torch.equal(a, b) for a, b in zip(f0, f1))


# ---------------------------------------------------------------------------
# MoE and quantized trees on a mesh: the expert-local plan of
# models/moe.py (each rank's experts, or its slice of F) and B3 through
# wdot on a replicated DTensor leaf; the multi-rank plan is held to JAX on
# the CPU (tests/test_torch_moe_mesh.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", ["expert", "tensor"])
def test_expert_local_plan_on_the_card_equals_the_plain_dispatch(cuda, dtype,
                                                                 split):
    """Two emulated ranks of an expert-sharded bank (each its own half of
    the experts) or of a tensor-sharded one (each its half of every
    expert's F), each running the plan's local body on the card; their
    outputs' sum (the reduction the mesh does) against the plain dispatch
    per row, at capacity 1.0 so pairs drop."""
    from kubetorch_tpu_torch.models.llama import layer_weights
    from kubetorch_tpu_torch.models.moe import (MoeConfig, _dispatch, _positions,
                                                _route, _run_experts, moe_init)
    cfg = MoeConfig.tiny(dim=512, ffn_dim=1024, n_heads=8, n_kv_heads=2,
                         n_experts=8, capacity_factor=1.0, dtype=dtype)
    lw = layer_weights(moe_init(cfg, seed=1, device=cuda), 0)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 256, cfg.dim, generator=g, device=cuda).to(dtype)
    want, _, kept = _dispatch(cfg, x, lw)
    assert not bool(kept.all())
    _, gate_vals, gate_idx = _route(cfg, x, lw)
    capacity, pos, kept = _positions(cfg, gate_idx, x.shape[1])
    bank = lw["experts"]
    if split == "expert":
        half = cfg.n_experts // 2
        parts = [({k: v[r * half:(r + 1) * half] for k, v in bank.items()},
                  r * half) for r in range(2)]
    else:
        f = cfg.ffn_dim // 2
        parts = [({"w_gate": bank["w_gate"][..., r * f:(r + 1) * f],
                   "w_up": bank["w_up"][..., r * f:(r + 1) * f],
                   "w_down": bank["w_down"][:, r * f:(r + 1) * f]}, 0)
                 for r in range(2)]
    got = sum(_run_experts(x, gate_vals, gate_idx, pos, kept, capacity, b, start)
              .float() for b, start in parts)
    assert torch.isfinite(got).all()
    assert row_rel_err(got, want.float()) <= ROW_RTOL[dtype]


def test_q4_wdot_on_a_replicated_dtensor_leaf(nccl_mesh):
    """B3 through wdot at a world of 1: x a DTensor, the packed int4 leaf
    laid out by shard_pytree (replicated, as the rules leave every
    quantized leaf): one launch on x's local rows against the whole
    matrix, x's placements kept, the plain int4 matmul's values per row."""
    from torch.distributed.tensor import DTensor

    from kubetorch_tpu_torch.models.quant import wdot
    from kubetorch_tpu_torch.parallel import LLAMA_RULES
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree

    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(1024, 512, generator=g, device="cuda")
    leaf = shard_pytree({"layers": {"wq": _quantize_leaf_int4(w)}}, LLAMA_RULES,
                        nccl_mesh)["layers"]["wq"]
    assert all(p.is_replicate() for t in leaf.values() for p in t.placements)
    for rows in (8, 300):
        x = torch.randn(1, rows, 1024, generator=g, device="cuda").bfloat16()
        xd = DTensor.from_local(x, nccl_mesh, list(leaf["scale"].placements),
                                run_check=False)
        q4_matmul.launches = 0
        got = wdot(xd, leaf, dtype=torch.float32)
        assert isinstance(got, DTensor) and got.placements == xd.placements
        assert q4_matmul.launches == 1
        want = q4_matmul_ref(x.reshape(rows, 1024), leaf["__kt_q4__"].to_local(),
                             leaf["scale"].to_local())
        assert row_rel_err(got.to_local().reshape(rows, -1), want) <= \
            ROW_RTOL[torch.float32]


# ---------------------------------------------------------------------------
# the data plane: a staged tree and a store get land on the card bitwise
# ---------------------------------------------------------------------------


def _data_plane_tree(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    return {"embed": torch.randn(512, 64, generator=g, device=cuda).bfloat16(),
            "layers": {"wq": torch.randn(2, 64, 64, generator=g, device=cuda),
                       "q": torch.randint(-128, 127, (3, 7), generator=g,
                                          device=cuda, dtype=torch.int8)}}


def _fetch_bytes():
    """The client's ``kt_store_fetch_bytes_total{source}``."""
    from kubetorch_tpu_torch import telemetry
    return telemetry.counter("kt_store_fetch_bytes_total", labels=("source",))


def _same_bits(got, want):
    from kubetorch_tpu_torch.data_store import commands as ds
    a, b = {}, {}
    ds._flatten(got, "", a)
    ds._flatten(want, "", b)
    assert a.keys() == b.keys()
    for p in a:
        assert a[p].is_cuda and a[p].dtype == b[p].dtype, p
        assert torch.equal(a[p].view(torch.uint8), b[p].view(torch.uint8)), p


def test_staged_tree_lands_on_the_card_bitwise(cuda):
    from kubetorch_tpu_torch.data_store import staging
    tree = _data_plane_tree(cuda)
    handle = staging.stage_pytree(
        f"ktp-cuda-t-{os.getpid()}-{uuid.uuid4().hex[:8]}", tree)
    try:
        got = staging.load_staged(staging.handle_to_json(handle), device=cuda)
    finally:
        staging.release_handle(handle)
    _same_bits(got, tree)


def test_store_get_lands_on_the_card_bitwise(cuda, tmp_path, monkeypatch):
    """A pod's get over the broadcast tree: routed to the store first, then
    again from its pod cache, each landing on the card bitwise."""
    from chip_smoke import _StandInStore
    from kubetorch_tpu_torch.data_store import commands as ds
    monkeypatch.setenv("POD_IP", "127.0.0.1")
    monkeypatch.setenv("KT_DATA_CACHE_DIR", str(tmp_path / "cache"))
    tree = _data_plane_tree(cuda)
    store = _StandInStore()
    try:
        assert ds.put("t/dp", tree, store_url=store.url)["skipped"] == 0
        by_source = []
        for _ in range(2):
            before = {s: _fetch_bytes().value(source=s)
                      for s in ("store", "pod-cache")}
            got = ds.get("t/dp", store_url=store.url, device=cuda, peer=True)
            by_source.append({s: _fetch_bytes().value(source=s) - before[s]
                              for s in before})
            _same_bits(got, tree)
    finally:
        store.close()
    assert by_source[0]["store"] > 0 and by_source[0]["pod-cache"] == 0
    assert by_source[1]["pod-cache"] == by_source[0]["store"]


def test_aot_cache_hit_loads_flash_fwd_without_nvcc(cuda, tmp_path,
                                                     monkeypatch):
    """A1's library through the compile cache: published from this
    process's build, then, on a fresh pod (an empty build directory,
    nothing loaded), a hit that loads with no nvcc run and gives A1's
    outputs bitwise equal to the built library's."""
    import functools

    from kubetorch_tpu_torch.ops import _build
    from kubetorch_tpu_torch.serve.aot_cache import (AOTCompileCache, AOTKey,
                                                     kernels_digest)
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = (torch.randn(1, 256, n, 128, generator=g, device=cuda)
               .to(torch.bfloat16) for n in (32, 8, 8))
    want = flash_attention(q, k, v)
    key = AOTKey(model="a1", mesh_shape=None, buckets=(256,), slots=1,
                 max_len=256, quantize_kv=False, decode_block=1,
                 torch_version=torch.__version__,
                 device=torch.cuda.get_device_name(cuda),
                 kernels=kernels_digest())
    build = functools.partial(_build.build, "flash_fwd")
    _, tag = AOTCompileCache(tmp_path / "aot").get_or_compile(
        key, "flash_fwd", build)
    assert tag == "miss"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    runs = _build.build.nvcc_runs
    cache = AOTCompileCache(tmp_path / "aot")
    _, tag = cache.get_or_compile(key, "flash_fwd", build)
    assert tag == "hit" and cache.counts == {"hit": 1}
    assert _build.build.nvcc_runs == runs
    assert _build.library_path("flash_fwd").parent == tmp_path / "_build"
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
