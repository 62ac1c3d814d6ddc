"""The numerics of the split flash-decode body, emulated on the CPU and held
to the JAX package's Pallas kernel (run in interpret mode).

The split tensor-core body of ``csrc/decode_attention.cu`` (bf16 q at head
dim 64 and 128, B1 over a bf16 cache and B2 over an int8 cache) cannot run
here, so :func:`emulate_decode` repeats its schedule in plain PyTorch:

- splits that are runs of whole 64-row tiles (two and four tiles here;
  ``decode_split_plan`` picks the run from (B, NKV, S) alone, and its own
  test below); a split whose first row lies past the slot's frontier is
  never computed nor read;
- within a split, an online softmax over 64-row tiles, rows past the
  frontier masked with -1e30; B1 rounds P to bf16 under the split's running
  max, B2 multiplies the unrounded P by the V row scale and runs P.V over
  its two bf16 halves, hi = bf16(x) and lo = bf16(x - hi);
- the combine, in split order: m_g = max m, corr = exp(m - m_g),
  l_g = sum l * corr, acc_g = sum acc * corr, out = acc_g / (l_g or 1).

The kernel's four warps share each tile's max, so they compute the same
function as one online softmax over the tile; only the order of the fp32
sums differs, ~1e-6 of a row. Products of bf16 q with bf16 or int8 K and V
are exact in fp32, as on the tensor cores.

Tolerances (``kubetorch_tpu_torch/ops/tolerance.py``), per row: 1e-4 for
fp32 inputs and for B2 (the hi + lo halves keep ~16 bits of P * vs, ~1e-5
of a row); ROW_RTOL[bf16] = 1e-2 for B1 on bf16 inputs, whose P rounds to
bf16 under another running max than the Pallas kernel's (2^-9 of each term).

Planted variants, each of which must exceed the same tolerance, and each
test prints both errors:

- an unguarded dead split: computed over its masked rows, where its max is
  -1e30 and exp(s - m) is 1 on every column, and read by the combine. Where
  any split of the slot is live, corr = exp(-1e30 - m_g) is exactly 0 in
  fp32 and wipes it out (the test prints that it is harmless there); it
  carries the whole weight in a slot with no live row (pos = -1, an empty
  slot, for which the Pallas kernel returns zeros), so every case holds one;
- a dropped split: the last live split of each slot left out of the combine;
- a combine that skips corr;
- B2's P * vs rounded once to bf16 instead of split into two halves.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubetorch_tpu.ops.decode_attention import decode_attention as jax_decode
from kubetorch_tpu.ops.decode_attention import \
    decode_attention_quant as jax_decode_quant
from kubetorch_tpu_torch.ops.decode_attention import (DECODE_MIN_SPLIT_TILES,
                                                      DECODE_TARGET_BLOCKS,
                                                      DECODE_TILE,
                                                      decode_split_plan)
from kubetorch_tpu_torch.ops.tolerance import ROW_RTOL, row_rel_err
from kubetorch_tpu_torch.serve import kv_quant as pkv

pytestmark = pytest.mark.level("unit")

TOL = ROW_RTOL[torch.float32]
NEG_INF = -1e30
S = 512
# the kernel takes any whole number of tiles per split; the plan picks one
# per shape. Two-tile and four-tile splits, so each case has split edges
SPLIT_ROWS = (128, 256)
# an empty slot, 0, both sides of a tile edge and of both split edges, a
# mid value and the last row S - 1
POS = [-1, 0, 63, 64, 127, 128, 255, 256, 300, S - 1]
# (NH, NKV, Hd): GQA groups 1, 2 and 4 at head dims 64 and 128
CASES = [(4, 4, 64), (4, 2, 128), (8, 2, 64), (8, 2, 128), (4, 1, 128)]
VARIANTS = ("unguarded", "dropped", "no_corr")


def decode_split_ranges(s: int, split_rows: int):
    """The rows [r0, r1) of each split, as ``csrc/decode_attention.cu``
    cuts them: split i covers ``i * split_rows`` up to the next split or S."""
    if split_rows <= 0 or split_rows % DECODE_TILE:
        raise ValueError(f"{split_rows} rows per split is not a whole "
                         f"number of {DECODE_TILE}-row tiles")
    return [(r0, min(r0 + split_rows, s)) for r0 in range(0, s, split_rows)]


def _halves(x):
    """x as hi = bf16(x) and lo = bf16(x - hi), both as fp32 values."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _split_state(qg, kt, vt, kst, vst, r0, n, scale, m, l, acc, *, quant,
                 round_p, rounded_pv):
    """One 64-row tile of a split's online softmax for one slot: qg (NKV,
    G, Hd), kt/vt (T, NKV, Hd), kst/vst (T, NKV) or None; rows >= n masked."""
    s = torch.einsum("kgh,tkh->kgt", qg, kt) * scale
    if quant:
        s = s * kst.t()[:, None, :]
    rows = torch.arange(r0, r0 + kt.shape[0])
    s = s.masked_fill((rows >= n)[None, None, :], NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    if quant:
        pv = p * vst.t()[:, None, :]
        if rounded_pv:
            prod = torch.einsum("kgt,tkh->kgh", pv.bfloat16().float(), vt)
        else:
            hi, lo = _halves(pv)
            prod = (torch.einsum("kgt,tkh->kgh", hi, vt)
                    + torch.einsum("kgt,tkh->kgh", lo, vt))
    else:
        pr = p.bfloat16().float() if round_p else p
        prod = torch.einsum("kgt,tkh->kgh", pr, vt)
    return m_new, l, acc * alpha + prod


def emulate_decode(q, ck, cv, pos, ks=None, vs=None, *, split_rows,
                   round_p=True, variant=None):
    """The split body's schedule. q (B, NH, Hd) and ck/cv (B, S, NKV, Hd)
    fp32 tensors holding the kernel's input values (bf16 values, or int8
    values with ks/vs (B, S, NKV) for B2); pos (B,). Returns fp32 (B, NH,
    Hd), before the kernel's rounding to q's type. ``variant`` plants one
    of ``VARIANTS``, or ``"rounded_pv"`` (B2 only)."""
    b, nh, hd = q.shape
    s, nkv = ck.shape[1], ck.shape[2]
    g = nh // nkv
    quant = ks is not None
    scale = hd ** -0.5
    ranges = decode_split_ranges(s, split_rows)
    out = torch.zeros(b, nkv, g, hd)
    for bi in range(b):
        n = max(0, min(int(pos[bi]) + 1, s))
        n_live = -(-n // split_rows)
        qg = q[bi].reshape(nkv, g, hd)
        parts = []
        for i, (r0, r1) in enumerate(ranges):
            dead = i >= n_live
            if dead and variant != "unguarded":
                continue        # returns at once; the combine never reads it
            m = torch.full((nkv, g, 1), NEG_INF)
            l = torch.zeros((nkv, g, 1))
            acc = torch.zeros((nkv, g, hd))
            end = r1 if dead else min(r1, n)
            for t0 in range(r0, end, DECODE_TILE):
                t1 = min(t0 + DECODE_TILE, s)
                m, l, acc = _split_state(
                    qg, ck[bi, t0:t1], cv[bi, t0:t1],
                    ks[bi, t0:t1] if quant else None,
                    vs[bi, t0:t1] if quant else None, t0, n, scale, m, l, acc,
                    quant=quant, round_p=round_p,
                    rounded_pv=variant == "rounded_pv")
            parts.append((m, l, acc))
        if variant == "dropped" and n_live > 1:
            parts = parts[:-1]
        if not parts:
            continue            # no live row: zeros, as the Pallas kernel gives
        m_g = torch.stack([m for m, _, _ in parts]).amax(0)
        l_g = torch.zeros((nkv, g, 1))
        acc_g = torch.zeros((nkv, g, hd))
        for m, l, acc in parts:
            corr = torch.ones_like(m) if variant == "no_corr" else torch.exp(m - m_g)
            l_g = l_g + l * corr
            acc_g = acc_g + acc * corr
        out[bi] = acc_g / torch.where(l_g == 0, torch.ones_like(l_g), l_g)
    return out.reshape(b, nh, hd)


def _inputs(nh, nkv, hd, seed, bf16):
    rng = np.random.default_rng(seed)
    b = len(POS)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, nh, hd), (b, S, nkv, hd), (b, S, nkv, hd))]
    if bf16:
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs + [np.asarray(POS, np.int32)]


@pytest.fixture(scope="module")
def b1_data():
    """B1: the Pallas kernel (64-row tiles, interpret mode) on fp32 and on
    bf16 inputs, once per case."""
    cache = {}

    def get(nh, nkv, hd, bf16):
        key = (nh, nkv, hd, bf16)
        if key not in cache:
            q, ck, cv, pos = _inputs(nh, nkv, hd, seed=nh + 10 * nkv + hd, bf16=bf16)
            dt = jnp.bfloat16 if bf16 else jnp.float32
            want = jax_decode(*(jnp.asarray(a, dt) for a in (q, ck, cv)),
                              jnp.asarray(pos), block_k=DECODE_TILE,
                              interpret=True)
            want = torch.from_numpy(np.array(want.astype(jnp.float32)))
            cache[key] = ([torch.from_numpy(a) for a in (q, ck, cv, pos)], want)
        return cache[key]
    return get


@pytest.fixture(scope="module")
def b2_data():
    """B2: bf16-valued q, an int8 cache with row scales, and the Pallas
    kernel's output, once per case."""
    cache = {}

    def get(nh, nkv, hd):
        key = (nh, nkv, hd)
        if key not in cache:
            q, ck, cv, pos = _inputs(nh, nkv, hd, seed=7 + nh + nkv + hd, bf16=True)
            kq, ks = pkv.quantize_rows(torch.from_numpy(ck))
            vq, vs = pkv.quantize_rows(torch.from_numpy(cv))
            want = jax_decode_quant(
                *(jnp.asarray(a) for a in (q, kq.numpy(), ks.numpy(),
                                           vq.numpy(), vs.numpy(), pos)),
                scale=hd ** -0.5, block_k=DECODE_TILE, interpret=True)
            args = (torch.from_numpy(q), kq.float(), vq.float(),
                    torch.from_numpy(pos), ks, vs)
            cache[key] = (args, torch.from_numpy(np.array(want)))
        return cache[key]
    return get


def _b1(args, split_rows=SPLIT_ROWS[0], **kw):
    q, ck, cv, pos = args
    return emulate_decode(q, ck, cv, pos, split_rows=split_rows, **kw)


def _b2(args, split_rows=SPLIT_ROWS[0], **kw):
    q, kq, vq, pos, ks, vs = args
    return emulate_decode(q, kq, vq, pos, ks, vs, split_rows=split_rows, **kw)


@pytest.mark.parametrize("nh,nkv,hd", CASES)
def test_split_b1_matches_pallas_fp32(b1_data, nh, nkv, hd):
    args, want = b1_data(nh, nkv, hd, False)
    for rows in SPLIT_ROWS:
        err = row_rel_err(_b1(args, rows, round_p=False), want)
        print(f"B1 {rows}-row splits, fp32 inputs: row err {err:.3e} (tol {TOL})")
        assert err <= TOL


@pytest.mark.parametrize("nh,nkv,hd", CASES)
def test_split_b1_matches_pallas_bf16(b1_data, nh, nkv, hd):
    """P rounded to bf16 under each split's running max, the output rounded
    to bf16 as the kernel writes it."""
    args, want = b1_data(nh, nkv, hd, True)
    tol = ROW_RTOL[torch.bfloat16]
    for rows in SPLIT_ROWS:
        err = row_rel_err(_b1(args, rows).bfloat16(), want)
        print(f"B1 {rows}-row splits, bf16 inputs: row err {err:.3e} (tol {tol})")
        assert err <= tol


@pytest.mark.parametrize("nh,nkv,hd", CASES)
def test_split_b2_matches_pallas(b2_data, nh, nkv, hd):
    args, want = b2_data(nh, nkv, hd)
    for rows in SPLIT_ROWS:
        err = row_rel_err(_b2(args, rows), want)
        print(f"B2 {rows}-row splits, P * vs as hi + lo: row err {err:.3e} "
              f"(tol {TOL})")
        assert err <= TOL


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("nh,nkv,hd", CASES)
def test_planted_combine_faults_exceed_the_tolerance(b1_data, b2_data, variant,
                                                     nh, nkv, hd):
    """Each planted fault of the split or the combine, in B1 (fp32 inputs)
    and in B2, against the emulation as built."""
    for name, run, (args, want) in (
            ("B1", lambda a, **kw: _b1(a, round_p=False, **kw),
             b1_data(nh, nkv, hd, False)),
            ("B2", _b2, b2_data(nh, nkv, hd))):
        good = row_rel_err(run(args), want)
        bad_out = run(args, variant=variant)
        bad = row_rel_err(bad_out, want)
        print(f"{name} {variant}: as built {good:.3e} vs planted {bad:.3e} "
              f"(tol {TOL})")
        assert good <= TOL < bad
        if variant == "unguarded":
            live = [i for i, p in enumerate(POS) if p >= 0]
            harmless = row_rel_err(bad_out[live], want[live])
            print(f"{name} unguarded, slots with a live split only: "
                  f"{harmless:.3e} (corr = exp(-1e30 - m_g) = 0 there)")


@pytest.mark.parametrize("nh,nkv,hd", CASES)
def test_b2_rounded_pv_exceeds_the_tolerance(b2_data, nh, nkv, hd):
    """B2's P * vs rounded once to bf16, no lo half: a different result."""
    args, want = b2_data(nh, nkv, hd)
    split = row_rel_err(_b2(args), want)
    rounded = row_rel_err(_b2(args, variant="rounded_pv"), want)
    print(f"B2: P * vs hi + lo {split:.3e} vs rounded once {rounded:.3e} "
          f"(tol {TOL})")
    assert split <= TOL < rounded


@pytest.mark.parametrize("b,nkv,s", [(8, 8, 2048), (1, 8, 8192), (8, 8, 8192),
                                     (1, 8, 128), (3, 2, 512), (2, 1, 100),
                                     (64, 8, 2048), (16, 8, 4096)])
def test_split_plan_covers_every_row_once_in_whole_tiles(b, nkv, s):
    split_rows = decode_split_plan(b, nkv, s)
    ranges = decode_split_ranges(s, split_rows)
    assert split_rows % DECODE_TILE == 0 and split_rows >= DECODE_TILE
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and (a1 - a0) == split_rows   # whole tiles, no gap
    for pos in (-1, 0, 63, 64, split_rows - 1, split_rows, s // 2, s - 1):
        n = max(0, min(pos + 1, s))
        owners = [sum(r0 <= row < r1 for r0, r1 in ranges) for row in range(n)]
        assert owners == [1] * n
        n_live = -(-n // split_rows)
        assert n_live == sum(r0 < n for r0, _ in ranges)
    # a full cache spreads over the card: about two blocks per SM where the
    # cache holds enough runs of the shortest split for them
    blocks = len(ranges) * b * nkv
    tiles = -(-s // DECODE_TILE)
    assert blocks >= min(DECODE_TARGET_BLOCKS // 2,
                         b * nkv * -(-tiles // DECODE_MIN_SPLIT_TILES))


def test_split_plan_never_sees_pos():
    """The plan is a function of (B, NKV, S) only, so a decode step's grid
    does not depend on the device-side positions; the shapes of the
    kernel's design note."""
    assert list(inspect.signature(decode_split_plan).parameters) == ["b", "nkv", "s"]
    assert decode_split_plan(8, 8, 2048) == 256      # 8 splits, 512 blocks
    assert decode_split_plan(1, 8, 8192) == 256      # 32 splits, 256 blocks
    assert decode_split_plan(8, 8, 8192) == 960      # 9 splits, 576 blocks
    assert DECODE_TARGET_BLOCKS >= 2 * 132
    with pytest.raises(ValueError):
        decode_split_ranges(2048, 100)
