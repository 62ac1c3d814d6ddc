"""The port's attention ops (kubetorch_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
that plain version to the Pallas kernel's math. The CUDA kernels themselves
are held to the plain versions by tests/test_torch_cuda.py (marked
``cuda``; it skips without a card) and by chip_smoke.py.

Tolerances: inputs and math are fp32 on both sides and differ only in the
order of the softmax sums (one pass here, tiles there), so 2e-5 absolute
on outputs of order 1 — the bound the JAX package's own decode-kernel
test holds its kernel to against its einsum.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubetorch_tpu.ops.attention import flash_attention as jax_flash
from kubetorch_tpu.ops.decode_attention import decode_attention as jax_decode
from kubetorch_tpu_torch.ops import _build
from kubetorch_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_ref)
from kubetorch_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_ref)
from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, max_abs_err, row_rel_err

pytestmark = pytest.mark.level("unit")

TOL_FP32 = 2e-5


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# A1: flash attention forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("nh,nkv", [(4, 2), (8, 1)])
def test_flash_plain_matches_pallas(s, nh, nkv):
    rng = np.random.default_rng(s * 100 + nh * 10 + nkv)
    b, hd = 2, 64
    q = _normal(rng, (b, s, nh, hd))
    k = _normal(rng, (b, s, nkv, hd))
    v = _normal(rng, (b, s, nkv, hd))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, block_q=128, block_k=128,
                                interpret=True))
    before = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    assert flash_attention.launches == before   # CPU: no kernel launch
    assert got.shape == (b, s, nh, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_FP32, rtol=0)


def test_flash_plain_non_causal_matches_pallas():
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, (1, 128, 4, 64)), _normal(rng, (1, 128, 2, 64)),
               _normal(rng, (1, 128, 2, 64)))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=False, interpret=True))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_FP32, rtol=0)


def test_flash_plain_keeps_p_in_fp32():
    """bf16 inputs: the plain version widens to fp32 and never rounds P,
    like the Pallas body, so it equals the fp32 computation on the same
    (bf16-representable) values up to the output's own bf16 rounding."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 128, 4, 64))).bfloat16(),
               torch.from_numpy(_normal(rng, (1, 128, 2, 64))).bfloat16(),
               torch.from_numpy(_normal(rng, (1, 128, 2, 64))).bfloat16())
    got = flash_attention_ref(q, k, v)
    want = flash_attention_ref(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_flash_rejects_bad_shapes():
    q = torch.zeros(1, 128, 6, 64)
    k = torch.zeros(1, 128, 4, 64)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k[:, :64], k)


# ---------------------------------------------------------------------------
# B1: flash-decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    (4, 256, 8, 4, 128),     # multi-tile, GQA group 2
    (2, 512, 4, 1, 64),      # MQA, group 4
    (3, 128, 6, 2, 128),     # odd batch, group 3 (< 8: padded rows there)
    (1, 64, 8, 8, 64),       # group 1 (pure MHA)
])
def test_decode_plain_matches_pallas(shape):
    b, s, nh, nkv, hd = shape
    rng = np.random.default_rng(sum(shape))
    q = _normal(rng, (b, nh, hd))
    ck = _normal(rng, (b, s, nkv, hd))
    cv = _normal(rng, (b, s, nkv, hd))
    pos = rng.integers(0, s, b).astype(np.int32)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.asarray(pos),
                                 block_k=128, interpret=True))
    before = decode_attention.launches
    got = decode_attention(*map(torch.from_numpy, (q, ck, cv, pos)))
    assert decode_attention.launches == before
    assert got.shape == (b, nh, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_FP32, rtol=0)


@pytest.mark.parametrize("pos", [[0, 0], [127, 127], [0, 127], [63, 64]])
def test_decode_plain_edge_positions(pos):
    """Only the fresh row visible, the whole cache visible, and the rows on
    both sides of a tile edge."""
    b, s, nh, nkv, hd = 2, 128, 4, 2, 64
    rng = np.random.default_rng(7)
    q = _normal(rng, (b, nh, hd))
    ck = _normal(rng, (b, s, nkv, hd))
    cv = _normal(rng, (b, s, nkv, hd))
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.asarray(pos),
                                 block_k=64, interpret=True))
    got = decode_attention(*map(torch.from_numpy, (q, ck, cv, pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_FP32, rtol=0)


def test_decode_plain_rounds_p_to_cache_type():
    """bf16 cache: logits in fp32, P rounded to bf16 before an fp32 P.V
    product, as in the Pallas body."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, (2, 8, 64))).bfloat16()
    ck = torch.from_numpy(_normal(rng, (2, 128, 4, 64))).bfloat16()
    cv = torch.from_numpy(_normal(rng, (2, 128, 4, 64))).bfloat16()
    pos = torch.tensor([100, 127], dtype=torch.int32)
    got = decode_attention_ref(q, ck, cv, pos)
    qg = q.float().reshape(2, 4, 2, 64)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * 64 ** -0.5
    mask = torch.arange(128)[None, :] <= pos[:, None]
    probs = torch.softmax(logits.masked_fill(~mask[:, None, None], -1e30), -1)
    rounded = torch.einsum("bkgs,bskh->bkgh", probs.bfloat16().float(),
                           cv.float()).reshape(2, 8, 64)
    unrounded = torch.einsum("bkgs,bskh->bkgh", probs,
                             cv.float()).reshape(2, 8, 64)
    assert torch.equal(got, rounded.bfloat16())
    assert not torch.equal(rounded, unrounded)
    # and the same within bf16 rounding as the Pallas kernel on these values
    want = np.asarray(jax_decode(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(ck.float().numpy(), jnp.bfloat16),
        jnp.asarray(cv.float().numpy(), jnp.bfloat16),
        jnp.asarray(pos.numpy()), block_k=64, interpret=True).astype(jnp.float32))
    assert row_rel_err(got, torch.from_numpy(want)) <= ROW_RTOL[torch.bfloat16]


def test_decode_rejects_bad_pos_shape():
    q = torch.zeros(2, 4, 64)
    ck = torch.zeros(2, 16, 2, 64)
    with pytest.raises(ValueError, match="pos"):
        decode_attention(q, ck, ck, torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the kernel-vs-plain check (ops/tolerance.py), as chip_smoke.py applies it
# ---------------------------------------------------------------------------


def _bf16_case(kind):
    """bf16 inputs and the plain version's output at the engine's head dim."""
    rng = np.random.default_rng(21)
    if kind == "flash":
        shapes = [(1, 256, 4, 128), (1, 256, 2, 128), (1, 256, 2, 128)]
        args = [torch.from_numpy(_normal(rng, sh)).bfloat16() for sh in shapes]
        return args, flash_attention_ref
    q = torch.from_numpy(_normal(rng, (4, 8, 128))).bfloat16()
    ck, cv = (torch.from_numpy(_normal(rng, (4, 1024, 2, 128))).bfloat16()
              for _ in range(2))
    pos = torch.tensor([0, 300, 700, 1023], dtype=torch.int32)
    return [q, ck, cv, pos], decode_attention_ref


@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_row_check_accepts_bf16_rounding(kind):
    """The plain version on bf16 inputs against the same math in fp32 on
    the same values: only bf16 rounding separates them."""
    args, ref = _bf16_case(kind)
    want = ref(*[a.float() if a.is_floating_point() else a for a in args])
    assert row_rel_err(ref(*args), want) <= ROW_RTOL[torch.bfloat16]


def _flash_without_diagonal_tile(q, k, v, block=64):
    """Causal attention in which every query tile past the first skips its
    diagonal key tile: what a flash kernel that drops its last live tile
    computes."""
    s, nh, hd = q.shape[1:]
    nkv = k.shape[2]
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    keep = (j <= i) & ~((i >= block) & (j // block == i // block))
    qg = q.float().reshape(1, s, nkv, nh // nkv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * hd ** -0.5
    probs = torch.softmax(logits.masked_fill(~keep, -1e30), dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(1, s, nh, hd).to(q.dtype)


@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_row_check_rejects_a_dropped_tile(kind):
    """A kernel that skips the last live 64-row key tile of each long row
    fails the per-row check, also on a row that a tolerance scaled by the
    tensor's largest output (that of a row with one key) lets through."""
    args, ref = _bf16_case(kind)
    want = ref(*args)
    if kind == "flash":
        faulty = _flash_without_diagonal_tile(*args)
    else:
        q, ck, cv, pos = args
        n = pos + 1
        cut = torch.where(n > 64, (n - 1) // 64 * 64 - 1, pos).to(torch.int32)
        faulty = ref(q, ck, cv, cut)
    assert row_rel_err(faulty, want) > ROW_RTOL[torch.bfloat16]
    if kind == "decode":
        # the slot with the whole cache live (pos 1023) alone: its rows move
        # by less than 2^-6 of the tensor's largest output, the old bound
        long_slot = max_abs_err(faulty[3], want[3])
        assert long_slot <= 2 ** -6 * float(want.float().abs().max())
        assert row_rel_err(faulty[3], want[3]) > ROW_RTOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# build helper
# ---------------------------------------------------------------------------


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has nvcc under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_fwd")


def test_library_path_keyed_by_source_hash():
    a = _build.library_path("flash_fwd")
    b = _build.library_path("decode_attention")
    assert a.parent == _build.BUILD_DIR and a != b
    assert a.name.startswith("flash_fwd-") and a.suffix == ".so"
