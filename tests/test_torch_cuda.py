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
bodies and takes fp32's.
"""

import dataclasses

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
from kubetorch_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_body,
                                                      decode_attention_quant,
                                                      decode_attention_quant_ref,
                                                      decode_attention_ref,
                                                      decode_split_plan)
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
              (1, 2048, 8, 2, 128, True), (1, 2048, 4, 2, 64, False)]


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
