"""The port's quantized serving path (kubetorch_tpu_torch: models/quant.py,
serve/kv_quant.py, ops/quant_matmul.py, the int8 form of
ops/decode_attention.py, and the engine over them) against the JAX
package on the same inputs, made with numpy from a seed. The Pallas
kernels run in interpret mode, as the JAX package's own tests run them on
the CPU.

Tolerances:

- Quantizers and dequantizers: equal, bit for bit. Both sides round half
  to even and do the same fp32 divisions and products, so the packed
  bytes, int8 values and scales must match exactly.
- The plain int4 matmul against the Pallas kernel: per output row, L2
  relative 1e-4 (``ops/tolerance.py`` fp32). Both compute exact products
  of bf16 activations and small integers and differ only in the order of
  the fp32 sums; a scale applied to the running sum, or the nibble planes
  swapped, moves rows by far more (planted below).
- The plain int8 flash-decode against the Pallas kernel: 2e-5 absolute,
  the bound the JAX package's own test holds its kernel to against its
  einsum (fp32 on both sides, outputs of order 1).
- Engines and ``generate``: identical greedy tokens. Both sides quantize
  the same way (bitwise, above) and run the same fp32 math; a one-token
  difference would show a wrong plane, scale, row or position.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.models import generate as jax_gen
from kubetorch_tpu.models import quant as jq
from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.ops.decode_attention import \
    decode_attention_quant as jax_decode_quant
from kubetorch_tpu.ops.quant_matmul import q4_matmul as jax_q4_matmul
from kubetorch_tpu.ops.quant_matmul import q4_supported as jax_q4_supported
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.serve import kv_quant as jkv
from kubetorch_tpu_torch.models import generate as pt_gen
from kubetorch_tpu_torch.models import quant as pq
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.generate import init_cache
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
from kubetorch_tpu_torch.ops import quant_matmul as ops_q4
from kubetorch_tpu_torch.ops.decode_attention import (
    decode_attention_quant, decode_attention_quant_ref)
from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
from kubetorch_tpu_torch.serve import GenerationEngine
from kubetorch_tpu_torch.serve import kv_quant as pkv

from .test_torch_engine import drive
from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

TOL_DECODE = 2e-5
# the narrow Llama on which the JAX engine routes every projection through
# its int4 kernel (group 128 divides each K/2; every N tiles by 512)
NARROW = dict(dim=256, ffn_dim=512, n_heads=4, n_kv_heads=2)
PROMPTS = ([5, 17, 42], list(range(1, 101)), [9, 8, 300, 2])
NEW = (6, 5, 7)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    """(path, tensor) of every leaf of a nested dict of tensors, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _jax_path(path):
    return tuple(k.key for k in path)


def _assert_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _weights(rng):
    """A stack of random weights, one all-zero column (scale 1 by the
    ``amax > 0`` rule) and one column of exact halves of its step, where
    round-half-to-even decides."""
    w = (rng.standard_normal((2, 256, 96)) * 0.05).astype(np.float32)
    w[0, :, 3] = 0.0
    w[1, :, 5] = 0.0
    w[1, 0, 5] = 7.0          # int4 group scale 1 (int8 scale 7/127)
    w[1, 1:8, 5] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    return w


# ---------------------------------------------------------------------------
# quantizers: bitwise
# ---------------------------------------------------------------------------


def test_int8_leaf_quantizer_and_dequant_equal_jax_bitwise():
    w = _weights(np.random.default_rng(0))
    want = jq._quantize_leaf(jnp.asarray(w))
    got = pq._quantize_leaf(torch.from_numpy(w))
    _assert_equal(got[pq.QKEY], want[jq.QKEY])
    _assert_equal(got["scale"], want["scale"])
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        d = pq.dequant(got, dtype)
        dw = np.asarray(jq.dequant(want, jdtype).astype(jnp.float32))
        np.testing.assert_array_equal(d.float().numpy(), dw)


@pytest.mark.parametrize("group", [128, 64, 48])
def test_int4_leaf_quantizer_and_dequant_equal_jax_bitwise(group):
    """48 does not divide 256: both sides halve the group to 16."""
    w = _weights(np.random.default_rng(group))
    want = jq._quantize_leaf_int4(jnp.asarray(w), group=group)
    got = pq._quantize_leaf_int4(torch.from_numpy(w), group=group)
    _assert_equal(got[pq.Q4KEY], want[jq.Q4KEY])
    _assert_equal(got["scale"], want["scale"])
    assert got[pq.Q4KEY].shape == (2, 128, 96)
    d = pq._dequant_int4(got, torch.float32)
    _assert_equal(d, jq._dequant_int4(want, jnp.float32))
    _assert_equal(pq.dequant(got, torch.float32),
                  jq.dequant(want, jnp.float32))


def test_int4_rounds_half_to_even():
    w = _weights(np.random.default_rng(1))
    leaf = pq._quantize_leaf_int4(torch.from_numpy(w), group=128)
    q = torch.cat(ops_q4.unpack_int4(leaf[pq.Q4KEY][1]), dim=0)[:, 5]
    assert q[:8].tolist() == [7, 0, 2, 2, 0, -2, -2, 4]


def test_kv_row_quantizer_and_dequant_equal_jax_bitwise():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 7, 2, 64)) * 3).astype(np.float32)
    x[0, 0] = 0.0                               # unwritten rows: scale 0
    x[1, 2, 1, :4] = [127.0, 0.5, 1.5, -2.5]    # halves of a unit step
    want_q, want_s = jkv.quantize_rows(jnp.asarray(x))
    got_q, got_s = pkv.quantize_rows(torch.from_numpy(x))
    _assert_equal(got_q, want_q)
    _assert_equal(got_s, want_s)
    assert (got_s[0, 0] == 0).all() and (got_q[0, 0] == 0).all()
    _assert_equal(pkv.dequantize_rows(got_q, got_s),
                  jkv.dequantize_rows(want_q, want_s))
    # bf16 rows (the engine's cache type) quantize the same on both sides
    xb = jnp.asarray(x, jnp.bfloat16)
    wq, ws = jkv.quantize_rows(xb)
    gq, gs = pkv.quantize_rows(
        torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16())
    _assert_equal(gq, wq)
    _assert_equal(gs, ws)


def test_quantize_params_trees_equal_jax_bitwise():
    tree = np_params(JaxConfig.tiny(), seed=4)
    for jfn, pfn in ((jq.quantize_params, pq.quantize_params),
                     (jq.quantize_params_int4, pq.quantize_params_int4)):
        want = _tree_np(jfn(jax.tree_util.tree_map(jnp.asarray, tree)))
        got = pfn(params_from_numpy(tree, device="cpu"))
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat_w) == len(list(_leaves(got)))
        for path, leaf in flat_w:
            _assert_equal(_at(got, _jax_path(path)), leaf)
        assert pq.quantized_bytes(got) == jq.quantized_bytes(
            jax.tree_util.tree_map(jnp.asarray, want))


def test_params_from_numpy_carries_a_quantized_tree_exactly():
    """int8 values, fp32 scales and the nested leaf dicts cross unchanged,
    and the port's dequantized view equals JAX's."""
    tree = np_params(JaxConfig.tiny(), seed=5)
    p4 = jq.quantize_params_int4(jax.tree_util.tree_map(jnp.asarray, tree))
    got = params_from_numpy(_tree_np(p4), device="cpu")
    leaf = got["layers"]["wq"]
    assert set(leaf) == {pq.Q4KEY, "scale"} and pq.is_quantized(leaf)
    _assert_equal(leaf[pq.Q4KEY], p4["layers"]["wq"][jq.Q4KEY])
    _assert_equal(leaf["scale"], p4["layers"]["wq"]["scale"])
    want = _tree_np(jq.dequantize_params(p4, jnp.float32))
    view = pq.dequantize_params(got, torch.float32)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        _assert_equal(_at(view, _jax_path(path)), w)


def test_layer_weights_slices_quantized_leaves_per_key():
    from kubetorch_tpu_torch.models.llama import layer_weights
    p = pq.quantize_params_int4(llama_init(LlamaConfig.tiny(), device="cpu"))
    lw = layer_weights(p, 1)
    assert torch.equal(lw["wq"][pq.Q4KEY], p["layers"]["wq"][pq.Q4KEY][1])
    assert torch.equal(lw["wq"]["scale"], p["layers"]["wq"]["scale"][1])
    assert lw["attn_norm"].shape == (64,)
    d = pq.dequant_layer(lw, torch.float32)
    assert d["wq"] is lw["wq"]                # int4 stays packed
    p8 = pq.quantize_params(llama_init(LlamaConfig.tiny(), device="cpu"))
    d8 = pq.dequant_layer(layer_weights(p8, 0), torch.bfloat16)
    assert d8["wq"].dtype == torch.bfloat16 and d8["wq"].shape == (64, 64)


# ---------------------------------------------------------------------------
# B3: the int4 matmul
# ---------------------------------------------------------------------------

Q4_SHAPES = [(8, 256, 512, 128), (300, 512, 1024, 128), (1, 256, 128, 128)]


def _q4_case(m, k, n, g, seed=0):
    rng = np.random.default_rng(seed + m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    leaf = jq._quantize_leaf_int4(jnp.asarray(w), group=g)
    packed, scale = np.asarray(leaf[jq.Q4KEY]), np.asarray(leaf["scale"])
    want = np.asarray(jax_q4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                    jnp.asarray(scale), interpret=True))
    return x, packed, scale, torch.from_numpy(want)


def test_q4_supported_agrees_with_jax():
    """Every Llama-3-8B projection at decode (8 rows) and prefill (2048
    rows), its head (128256 columns: no multiple of 512, so false), and
    shapes that break each clause of the predicate."""
    d, f, kv, vocab = 4096, 14336, 1024, 128256
    shapes = []
    for m in (8, 2048):
        for k, n in ((d, d), (d, kv), (d, f), (f, d), (d, vocab)):
            shapes.append(((m, k), (k // 2, n), (k // 128, n)))
    shapes += [((8, 256), (128, 512), (2, 512)), ((8, 256), (128, 128), (2, 128)),
               ((8, 256), (128, 768), (2, 768)), ((8, 256), (128, 512), (4, 512)),
               ((8, 256), (128, 512), (3, 512)), ((8, 258), (128, 512), (2, 512)),
               ((8, 256), (128, 512), (2, 256)), ((8, 512), (256, 96), (2, 96)),
               ((8, 192), (96, 512), (2, 512))]
    got = [ops_q4.q4_supported(*s) for s in shapes]
    assert got == [jax_q4_supported(*s) for s in shapes]
    assert got[:5] == [True, True, True, True, False]   # the 8B at decode


@pytest.mark.parametrize("m,k,n,g", Q4_SHAPES)
def test_q4_plain_matches_pallas(m, k, n, g):
    x, packed, scale, want = _q4_case(m, k, n, g)
    before = ops_q4.q4_matmul.launches
    got = ops_q4.q4_matmul(*map(torch.from_numpy, (x, packed, scale)))
    assert ops_q4.q4_matmul.launches == before      # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert row_rel_err(got, want) <= ROW_RTOL[torch.float32]


def test_q4_plain_rounds_activations_to_bf16():
    """fp32 activations meet the weights as bf16, as in the Pallas
    wrapper: the fp32 x and its bf16 rounding give the same output."""
    x, packed, scale, _ = _q4_case(8, 256, 512, 128)
    x, packed, scale = map(torch.from_numpy, (x, packed, scale))
    got = ops_q4.q4_matmul_ref(x, packed, scale)
    assert torch.equal(got, ops_q4.q4_matmul_ref(x.bfloat16(), packed, scale))
    assert not torch.equal(
        got, x @ pq._dequant_int4({pq.Q4KEY: packed, "scale": scale},
                                  torch.float32))


def _q4_scale_on_running_sum(x, packed, scale):
    """Planted fault: the group scale multiplies the running sum instead of
    the group's own product."""
    xb = x.to(torch.bfloat16).float()
    half, hg = packed.shape[0], scale.shape[0] // 2
    g = half // hg
    lo, hi = ops_q4.unpack_int4(packed)
    out = torch.zeros(x.shape[0], packed.shape[1])
    for t in range(hg):
        r = slice(t * g, (t + 1) * g)
        out = (out + xb[:, r] @ lo[r].float()) * scale[t]
        out = out + (xb[:, half + t * g: half + (t + 1) * g]
                     @ hi[r].float()) * scale[hg + t]
    return out


def _q4_planes_swapped(x, packed, scale):
    """Planted fault: the hi nibble plane read as the lo one and back."""
    p = packed.to(torch.int32)
    swapped = (p & 0x0F) << 4 | (p >> 4) & 0x0F
    return ops_q4.q4_matmul_ref(x, swapped.to(torch.uint8).view(torch.int8), scale)


@pytest.mark.parametrize("fault", [_q4_scale_on_running_sum, _q4_planes_swapped])
def test_q4_row_check_rejects_planted_faults(fault):
    x, packed, scale, want = _q4_case(300, 512, 1024, 128)
    args = tuple(map(torch.from_numpy, (x, packed, scale)))
    assert row_rel_err(fault(*args), want) > 100 * ROW_RTOL[torch.float32]
    if fault is _q4_scale_on_running_sum:
        # one group: the fault is invisible, which is why real shapes matter
        x1, p1, s1, want1 = _q4_case(1, 256, 128, 128)
        one = fault(*map(torch.from_numpy, (x1, p1, s1)))
        assert row_rel_err(one, want1) <= ROW_RTOL[torch.float32]


LLAMA_8B_PROJECTIONS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_q4_split_plan_covers_every_group_once(m, group):
    """At decode (M <= 16) the splits of every Llama-3-8B projection are
    non-empty runs of whole groups that together take each group of a
    plane exactly once, at most one split per group; uneven runs included
    (e.g. 56 groups of K = 14336 at group 128 in 13 splits)."""
    uneven = 0
    for k, n in LLAMA_8B_PROJECTIONS:
        groups = k // group
        per_plane = groups // 2
        splits = ops_q4.q4_split_plan(m, k, n, groups)
        assert 1 <= splits <= per_plane
        ranges = ops_q4.q4_split_ranges(per_plane, splits)
        assert len(ranges) == splits and all(t0 < t1 for t0, t1 in ranges)
        taken = [t for t0, t1 in ranges for t in range(t0, t1)]
        assert taken == list(range(per_plane))
        uneven += len({t1 - t0 for t0, t1 in ranges}) > 1
        # the grid covers the card's SMs unless every group is its own split
        blocks = -(-n // ops_q4.SPLITK_BLOCK_N) * splits
        assert blocks >= 132 or splits == per_plane
    assert uneven


def test_q4_split_plan_never_asks_for_more_splits_than_groups():
    """A shape whose grid would want more splits than a plane has groups
    gets one split per group; prefill rows are never split; ranges of more
    splits than groups are refused."""
    assert ops_q4.q4_split_plan(8, 256, 128, 2) == 1        # one group
    assert ops_q4.q4_split_plan(8, 1024, 128, 8) == 4       # 4 groups, wants 396
    assert ops_q4.q4_split_plan(17, 4096, 1024, 32) == 1
    assert ops_q4.q4_split_plan(2048, 4096, 1024, 32) == 1
    with pytest.raises(ValueError, match="splits"):
        ops_q4.q4_split_ranges(3, 5)
    with pytest.raises(ValueError, match="splits"):
        ops_q4.q4_split_ranges(3, 0)


def _q4_splitk(x, packed, scale, ranges):
    """The split-K body's arithmetic in plain torch: per split, the groups
    of its run in order, each group's lo and hi products scaled by their
    own rows and added; then the splits' partials summed in split order."""
    xb = x.to(torch.bfloat16).float()
    half, hg = packed.shape[0], scale.shape[0] // 2
    g = half // hg
    lo, hi = ops_q4.unpack_int4(packed)
    parts = []
    for t0, t1 in ranges:
        part = torch.zeros(x.shape[0], packed.shape[1])
        for t in range(t0, t1):
            r = slice(t * g, (t + 1) * g)
            part = part + ((xb[:, r] @ lo[r].float()) * scale[t]
                           + (xb[:, half + t * g: half + (t + 1) * g]
                              @ hi[r].float()) * scale[hg + t])
        parts.append(part)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


# (M, K, N, group, splits): the plan's choice, and uneven runs
SPLITK_CASES = [(8, 1024, 512, 64, None), (16, 1024, 256, 64, 3),
                (1, 768, 128, 64, 5), (8, 2048, 128, 128, None)]


@pytest.mark.parametrize("m,k,n,g,splits", SPLITK_CASES)
def test_q4_splitk_emulation_matches_pallas(m, k, n, g, splits):
    x, packed, scale, want = _q4_case(m, k, n, g)
    args = tuple(map(torch.from_numpy, (x, packed, scale)))
    per_plane = scale.shape[0] // 2
    splits = splits or ops_q4.q4_split_plan(m, k, n, scale.shape[0])
    assert splits > 1
    got = _q4_splitk(*args, ops_q4.q4_split_ranges(per_plane, splits))
    assert row_rel_err(got, want) <= ROW_RTOL[torch.float32]


@pytest.mark.parametrize("fault", ["dropped split", "group twice"])
def test_q4_splitk_row_check_rejects_planted_faults(fault):
    """A split whose partial never reaches the output, or a group that two
    splits both count, moves rows far past the fp32 row tolerance."""
    x, packed, scale, want = _q4_case(8, 1024, 512, 64)
    args = tuple(map(torch.from_numpy, (x, packed, scale)))
    ranges = ops_q4.q4_split_ranges(scale.shape[0] // 2, 3)
    if fault == "dropped split":
        ranges = ranges[:1] + ranges[2:]
    else:
        (a0, a1), (b0, b1) = ranges[0], ranges[1]
        ranges = [(a0, a1 + 1), (b0, b1)] + ranges[2:]   # group a1 in both
    assert row_rel_err(_q4_splitk(*args, ranges), want) \
        > 100 * ROW_RTOL[torch.float32]


def test_q4_wrapper_rejects_bad_shapes():
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="shape"):
        ops_q4.q4_matmul(x, torch.zeros(64, 128, dtype=torch.int8),
                         torch.zeros(2, 128))
    with pytest.raises(ValueError, match="shape"):
        ops_q4.q4_matmul(x, torch.zeros(128, 128, dtype=torch.int8),
                         torch.zeros(3, 128))


@pytest.mark.parametrize("vocab", [512, 768])
def test_wdot_routes_like_jax(monkeypatch, vocab):
    """wdot takes the kernel wrapper exactly where the JAX predicate
    holds (a 768-wide head falls back to the fp32 dequant) and equals the
    JAX wdot on both branches."""
    calls = []
    real = ops_q4.q4_matmul

    def spy(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(ops_q4, "q4_matmul", spy)
    rng = np.random.default_rng(vocab)
    x = rng.standard_normal((3, 2, 256)).astype(np.float32)
    w = (rng.standard_normal((256, vocab)) / 16).astype(np.float32)
    leaf = jq._quantize_leaf_int4(jnp.asarray(w))
    want = np.asarray(jq.wdot(jnp.asarray(x), leaf))
    got = pq.wdot(torch.from_numpy(x), params_from_numpy(_tree_np(leaf), "cpu"))
    assert calls == ([(128, 512)] if vocab == 512 else [])
    assert got.shape == (3, 2, vocab)
    assert row_rel_err(got, torch.from_numpy(want)) <= ROW_RTOL[torch.float32]


# ---------------------------------------------------------------------------
# B2: int8 flash-decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,pos", [
    ((2, 8, 2, 64, 256, 512), [0, 255]),            # b, nh, nkv, hd, s, block_k
    ((3, 4, 4, 32, 1024, 256), [0, 255, 256]),      # the rows around a tile edge
])
def test_decode_quant_plain_matches_pallas(shape, pos):
    b, nh, nkv, hd, s, bk = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    kq, ks = pkv.quantize_rows(torch.from_numpy(
        rng.standard_normal((b, s, nkv, hd)).astype(np.float32)))
    vq, vs = pkv.quantize_rows(torch.from_numpy(
        rng.standard_normal((b, s, nkv, hd)).astype(np.float32)))
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jax_decode_quant(
        *(jnp.asarray(a) for a in (q, kq.numpy(), ks.numpy(), vq.numpy(),
                                   vs.numpy(), pos)),
        scale=hd ** -0.5, block_k=bk, interpret=True))
    before = decode_attention_quant.launches
    got = decode_attention_quant(torch.from_numpy(q), kq, ks, vq, vs,
                                 torch.from_numpy(pos))
    assert decode_attention_quant.launches == before
    assert got.shape == (b, nh, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_DECODE, rtol=0)


def test_decode_quant_output_in_q_type():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    kq, ks = pkv.quantize_rows(torch.from_numpy(
        rng.standard_normal((2, 32, 2, 64)).astype(np.float32)))
    pos = torch.tensor([3, 31], dtype=torch.int32)
    got = decode_attention_quant_ref(q.bfloat16(), kq, ks, kq, ks, pos)
    want = decode_attention_quant_ref(q.bfloat16().float(), kq, ks, kq, ks, pos)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())
    with pytest.raises(ValueError, match="scales"):
        decode_attention_quant(q, kq, ks[:, :4], kq, ks, pos)


def test_quant_cache_bytes():
    cfg = LlamaConfig.tiny()
    fp = init_cache(cfg, 4, 256, dtype=torch.bfloat16, device="cpu")
    qc = pkv.init_quant_cache(cfg, 4, 256, device="cpu")
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c)   # noqa: E731
    hd = cfg.head_dim
    assert nbytes(qc) * 2 * hd == nbytes(fp) * (hd + 4)
    assert (qc.kq.dtype, qc.ks.dtype) == (torch.int8, torch.float32)
    assert qc.ks.shape == qc.kq.shape[:-1]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def test_llama_init_quantized_structure_and_bytes():
    cfg = LlamaConfig.tiny()
    sizes = {}
    for bits, quantize in ((8, pq.quantize_params), (4, pq.quantize_params_int4)):
        got = pq.llama_init_quantized(cfg, bits=bits, seed=0, device="cpu")
        ref = quantize(llama_init(cfg, seed=0, device="cpu"))
        assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(ref)]
        for path, leaf in _leaves(ref):
            node = _at(got, path)
            assert (node.shape, node.dtype) == (leaf.shape, leaf.dtype), path
        again = pq.llama_init_quantized(cfg, bits=bits, seed=0, device="cpu")
        key = pq.QKEY if bits == 8 else pq.Q4KEY
        assert torch.equal(got["layers"]["w_up"][key], again["layers"]["w_up"][key])
        sizes[bits] = pq.quantized_bytes(got)["quantized"]
    assert sizes[4] < 0.75 * sizes[8]
    with pytest.raises(ValueError, match="bits"):
        pq.llama_init_quantized(cfg, bits=2, device="cpu")


# ---------------------------------------------------------------------------
# the engine and generate against JAX
# ---------------------------------------------------------------------------


def _jax_cfg(**kw):
    return JaxConfig.tiny(dtype=jnp.float32, remat=False, attn_impl="xla", **kw)


def _quantized(kind, cfg_kw, seed=11):
    """The same quantized tree for both sides: JAX quantizes, the port
    receives its arrays through params_from_numpy."""
    tree = np_params(_jax_cfg(**cfg_kw), seed=seed)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jp = (jq.quantize_params(jtree) if kind == "int8"
          else jq.quantize_params_int4(jtree, group=128))
    return jp, params_from_numpy(_tree_np(jp), device="cpu")


ENGINE_CASES = {
    "int4-narrow": ("int4", NARROW),
    "int8-tiny": ("int8", {}),
    "int4-head-fallback": ("int4", dict(NARROW, vocab_size=768)),
}


@pytest.fixture(scope="module")
def engine_runs():
    """Each case's quantized params and the JAX engine's greedy tokens
    (int8 KV cache, 3 interleaved requests), computed once."""
    out = {}
    for name, (kind, kw) in ENGINE_CASES.items():
        jp, pp = _quantized(kind, kw)
        jeng = JaxEngine(jp, _jax_cfg(**kw), slots=2, max_len=160,
                         prefill_buckets=(8, 128), quantize_kv=True)
        out[name] = (pp, drive(jeng, PROMPTS, NEW))
    return out


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_quant_engine_greedy_tokens_equal_jax_engine(monkeypatch, engine_runs,
                                                     case, attn_impl):
    """``xla`` takes the plain fold-in einsum on decode, ``flash`` the
    int8 flash-decode wrapper (its plain version on the CPU) and the flash
    prefill; every int4 projection goes through ``q4_matmul``."""
    kind, kw = ENGINE_CASES[case]
    params, want = engine_runs[case]
    shapes = set()
    real = ops_q4.q4_matmul

    def spy(*a):
        shapes.add(tuple(a[1].shape))
        return real(*a)

    monkeypatch.setattr(ops_q4, "q4_matmul", spy)
    cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl=attn_impl, **kw)
    eng = GenerationEngine(params, cfg, slots=2, max_len=160,
                           prefill_buckets=(8, 128), quantize_kv=True,
                           device="cpu")
    assert isinstance(eng._cache, pkv.QuantKVCache)
    assert drive(eng, PROMPTS, NEW) == want
    if kind == "int4":
        # wq, wk/wv, wo, w_gate/w_up, w_down, and the head where it tiles
        want_shapes = {(128, 256), (128, 128), (256, 256), (128, 512)}
        if cfg.vocab_size % 512 == 0:
            want_shapes.add((128, cfg.vocab_size))
        assert shapes == want_shapes
    else:
        assert not shapes


def test_generate_int4_equals_jax_generate():
    jp, pp = _quantized("int4", NARROW, seed=3)
    prompt = np.asarray([[5, 17, 42, 7], [9, 8, 100, 3]], np.int32)
    want = np.asarray(jax_gen.generate(jp, jnp.asarray(prompt),
                                       _jax_cfg(**NARROW), max_new_tokens=6))
    got = pt_gen.generate(pp, torch.from_numpy(prompt),
                          LlamaConfig.tiny(dtype=torch.float32,
                                           attn_impl="xla", **NARROW),
                          max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_quant_cache_rows_equal_requantized_prefill():
    """After admission the int8 grid holds the prefill's rows quantized,
    all T_b rows of the padded bucket, and a decode step clamps a retired
    slot's position past the grid in every int8 tensor."""
    from kubetorch_tpu_torch.serve.engine import (_decode_step_impl,
                                                  _prefill_logits)
    cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="xla")
    params = pq.quantize_params_int4(llama_init(cfg, seed=1, device="cpu"),
                                     group=32)
    eng = GenerationEngine(params, cfg, slots=2, max_len=16,
                           prefill_buckets=(8,), quantize_kv=True, device="cpu")
    eng.submit([4, 5, 6], max_new_tokens=1)
    eng.step()
    toks = torch.zeros((1, 8), dtype=torch.long)
    toks[0, :3] = torch.tensor([4, 5, 6])
    with torch.no_grad():
        _, k, _ = _prefill_logits(params, toks, 3, cfg, eng._freqs)
    kq, ks = pkv.quantize_rows(k[:, 0])
    assert torch.equal(eng._cache.kq[:, 0, :8], kq)
    assert torch.equal(eng._cache.ks[:, 0, :8], ks)
    with torch.no_grad():
        logits = _decode_step_impl(params, eng._cache,
                                   torch.tensor([40, 3], dtype=torch.int32),
                                   torch.tensor([1, 2]), cfg, eng._freqs)
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()
    assert (eng._cache.ks[:, 0, 15] > 0).all()    # slot 0 wrote its last row
