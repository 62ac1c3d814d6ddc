"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one (a CUDA kernel has no
CPU mode). This file imports neither jax nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are per row, relative to the row's own norm
(``kubetorch_tpu_torch/ops/tolerance.py`` gives the reasons): 1e-4 for
fp32, 1e-2 for bf16.
"""

import pytest
import torch

from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
from kubetorch_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_ref)
from kubetorch_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_ref)
from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
from kubetorch_tpu_torch.serve import GenerationEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,nh,nkv,hd,causal", [
    (128, 32, 8, 128, True), (200, 4, 2, 64, True), (256, 8, 1, 128, False)])
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
