"""The numerics of the tensor-core flash kernels, emulated on the CPU and held
to the JAX package's Pallas kernels (run in interpret mode).

A1's, A2's and A3's bf16 bodies on Hopper
(``csrc/flash_fwd.cu:flash_fwd_sm90``, ``csrc/flash_bwd.cu:bwd_dq_sm90``
and ``bwd_dkv_sm90``) cannot run here, so this file repeats their
arithmetic in plain PyTorch on bf16 inputs:

- products of two bf16 operands (Q.K^T in all three, dO.V^T in A2 and A3)
  as exact products summed in fp32;
- products with an fp32 operand (P.V in A1, dS.K in A2, P^T.dO and dS^T.Q
  in A3) as two bf16 products, hi = bf16(x) and lo = bf16(x - hi), summed
  in fp32;
- A1's online softmax over 64-key tiles, P split tile by tile.

The emulation's fp32 results, before the kernels' final rounding to bf16,
are held to the Pallas kernels given the same (bf16-valued) inputs in
fp32, which widen everything to fp32 and keep P and dS unrounded.

Tolerances (``kubetorch_tpu_torch/ops/tolerance.py``): 1e-4 per row, the
fp32 row tolerance (dQ, dK and dV rows floored at the RMS row norm, for the
rows that cancel to zero); LSE 1e-4 absolute. The split keeps about 16
significant bits of P and dS, an error near 2^-17 of each element, which
sums to ~1e-5 of a row at most; beyond it the two sides differ only in the
order of their fp32 sums (~1e-6). The planted variant rounds P and dS to
bf16 with no lo half, as SDPA and FlashAttention do: each element moves by
up to 2^-9, about 1e-3 of a row, which the same tolerance refuses. Each
test prints both errors, so the choice is shown, not only asserted.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubetorch_tpu.ops import attention as jax_attn
from kubetorch_tpu_torch.ops.tolerance import (LSE_ATOL, ROW_RTOL,
                                               grad_row_rel_err, row_rel_err)

pytestmark = pytest.mark.level("unit")

TOL = ROW_RTOL[torch.float32]
NEG_INF = -1e30
BLOCK = 64        # the kernels' key tile, and the Pallas tiles

# (S, N, NKV, Hd, causal): GQA groups 1, 2 and 4, causal and full
CASES = [(256, nh, nkv, 64, causal)
         for nh, nkv in ((4, 4), (4, 2), (8, 2))
         for causal in (True, False)] + [(192, 4, 2, 128, True)]


def _bf16_inputs(s, nh, nkv, hd, seed):
    """q, k, v, dO as fp32 tensors holding bf16 values (B=1)."""
    rng = np.random.default_rng(seed)
    shapes = ((1, s, nh, hd), (1, s, nkv, hd), (1, s, nkv, hd), (1, s, nh, hd))
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                 .bfloat16().float() for sh in shapes)


def _halves(x):
    """x as hi = bf16(x) and lo = bf16(x - hi), both as fp32 values."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _times(x, y, split: bool, eq: str):
    """einsum(eq, x, y) with x the fp32 operand: hi.y + lo.y, or bf16(x).y."""
    if not split:
        return torch.einsum(eq, x.bfloat16().float(), y)
    hi, lo = _halves(x)
    return torch.einsum(eq, hi, y) + torch.einsum(eq, lo, y)


def _grouped(q, k):
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    return q.reshape(b, s, nkv, nh // nkv, hd)


def emulate_fwd(q, k, v, causal, split=True):
    """A1's tensor-core arithmetic: (out fp32 (B, S, N, Hd), lse (B, N, S))."""
    b, s, nh, hd = q.shape
    scale = hd ** -0.5
    qg = _grouped(q, k)
    m = torch.full((b, k.shape[2], nh // k.shape[2], s, 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape[:-1], hd))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, BLOCK):
        kt, vt = k[:, k0:k0 + BLOCK], v[:, k0:k0 + BLOCK]
        sc = torch.einsum("bskgh,btkh->bkgst", qg, kt) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
            sc = sc.masked_fill(cols > rows, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _times(p, vt, split, "bkgst,btkh->bkgsh")
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, s, nh, hd)
    return out, (m + torch.log(l_safe)).reshape(b, nh, s)


def emulate_dkv(q, k, v, do, lse, delta, causal, split=True):
    """A3's tensor-core arithmetic: (dK, dV) fp32, summed over each GQA group."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    scale = hd ** -0.5
    qg, dog = _grouped(q, k), _grouped(do, k)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.exp(logits - lse.reshape(b, nkv, nh // nkv, s, 1))
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v)
    ds = p * (dp - delta.reshape(b, nkv, nh // nkv, s, 1)) * scale
    dv = _times(p, dog, split, "bkgst,bskgh->btkh")
    dk = _times(ds, qg, split, "bkgst,bskgh->btkh")
    return dk, dv


def emulate_dq(q, k, v, do, lse, delta, causal, split=True):
    """A2's tensor-core arithmetic: dQ fp32 (B, S, N, Hd). S and dP are
    exact bf16 products summed in fp32; dS.K runs over dS's hi and lo
    halves (or, unsplit, over dS rounded to bf16)."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    scale = hd ** -0.5
    qg, dog = _grouped(q, k), _grouped(do, k)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.exp(logits - lse.reshape(b, nkv, nh // nkv, s, 1))
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v)
    ds = p * (dp - delta.reshape(b, nkv, nh // nkv, s, 1)) * scale
    return _times(ds, k, split, "bkgst,btkh->bskgh").reshape(b, s, nh, hd)


def _pallas(q, k, v, do, causal):
    """The Pallas forward (out, LSE), A3 (dK, dV) and A2 (dQ), fp32,
    interpret mode. The backward gets the Pallas forward's out and LSE as
    its residuals."""
    scale = q.shape[3] ** -0.5
    qh, kh, vh, doh = (jnp.asarray(x.numpy()).transpose(0, 2, 1, 3)
                       for x in (q, k, v, do))
    out, lse = jax_attn._fwd(qh, kh, vh, scale, causal, BLOCK, BLOCK, True,
                             need_lse=True)
    lse = lse[..., 0]
    dq, dk, dv = jax_attn._bwd(scale, causal, BLOCK, BLOCK, True,
                               (qh, kh, vh, out, lse), doh)
    back = [torch.from_numpy(np.array(x)) for x in (out, lse, dk, dv, dq)]
    return (back[0].transpose(1, 2), back[1], back[2].transpose(1, 2),
            back[3].transpose(1, 2), back[4].transpose(1, 2))


@pytest.fixture(scope="module")
def case_data():
    """Inputs, the Pallas results and both emulations, once per case."""
    cache = {}

    def get(s, nh, nkv, hd, causal):
        key = (s, nh, nkv, hd, causal)
        if key not in cache:
            q, k, v, do = _bf16_inputs(s, nh, nkv, hd, seed=s + 10 * nh + nkv + hd)
            out_j, lse_j, dk_j, dv_j, dq_j = _pallas(q, k, v, do, causal)
            delta = (do * out_j).sum(-1).transpose(1, 2).contiguous()
            emu = {split: (*emulate_fwd(q, k, v, causal, split),
                           *emulate_dkv(q, k, v, do, lse_j, delta, causal, split))
                   for split in (True, False)}
            dq = {split: grad_row_rel_err(
                      emulate_dq(q, k, v, do, lse_j, delta, causal, split), dq_j)
                  for split in (True, False)}
            cache[key] = ((out_j, lse_j, dk_j, dv_j), emu, dq)
        return cache[key]
    return get


def _errors(got, want):
    out, lse, dk, dv = got
    out_j, lse_j, dk_j, dv_j = want
    return {"out": row_rel_err(out, out_j),
            "lse": float((lse - lse_j).abs().max()),
            "dk": grad_row_rel_err(dk, dk_j),
            "dv": grad_row_rel_err(dv, dv_j)}


@pytest.mark.parametrize("s,nh,nkv,hd,causal", CASES)
def test_split_forward_matches_pallas(case_data, s, nh, nkv, hd, causal):
    want, emu, _ = case_data(s, nh, nkv, hd, causal)
    err = _errors(emu[True], want)
    print(f"A1 split hi+lo: out row err {err['out']:.3e}, lse {err['lse']:.3e}")
    assert err["out"] <= TOL
    assert err["lse"] <= LSE_ATOL


@pytest.mark.parametrize("s,nh,nkv,hd,causal", CASES)
def test_split_dkv_matches_pallas(case_data, s, nh, nkv, hd, causal):
    want, emu, _ = case_data(s, nh, nkv, hd, causal)
    err = _errors(emu[True], want)
    print(f"A3 split hi+lo: dK row err {err['dk']:.3e}, dV {err['dv']:.3e}")
    assert err["dk"] <= TOL and err["dv"] <= TOL


@pytest.mark.parametrize("s,nh,nkv,hd,causal", CASES)
def test_bf16_rounded_p_and_ds_exceed_the_tolerance(case_data, s, nh, nkv, hd,
                                                    causal):
    """The planted variant: P and dS rounded to bf16, no lo half."""
    want, emu, _ = case_data(s, nh, nkv, hd, causal)
    split, rounded = _errors(emu[True], want), _errors(emu[False], want)
    for name in ("out", "dk", "dv"):
        print(f"{name}: split {split[name]:.3e} vs bf16-rounded "
              f"{rounded[name]:.3e} (tol {TOL})")
        assert split[name] <= TOL < rounded[name]


@pytest.mark.parametrize("s,nh,nkv,hd,causal", CASES)
def test_split_dq_matches_pallas(case_data, s, nh, nkv, hd, causal):
    """A2: dS.K over dS's hi and lo halves, against the Pallas dQ."""
    _, _, dq = case_data(s, nh, nkv, hd, causal)
    print(f"A2 split hi+lo: dQ row err {dq[True]:.3e}")
    assert dq[True] <= TOL


@pytest.mark.parametrize("s,nh,nkv,hd,causal", CASES)
def test_bf16_rounded_ds_in_dq_exceeds_the_tolerance(case_data, s, nh, nkv,
                                                     hd, causal):
    """The planted variant of A2: dS rounded to bf16, no lo half."""
    _, _, dq = case_data(s, nh, nkv, hd, causal)
    print(f"dq: split {dq[True]:.3e} vs bf16-rounded {dq[False]:.3e} "
          f"(tol {TOL})")
    assert dq[True] <= TOL < dq[False]


def test_split_halves_keep_sixteen_bits():
    """hi + lo reproduces each fp32 value to ~2^-17 relative; hi alone to
    2^-9. The products the kernels form from the halves are exact."""
    x = torch.from_numpy(np.random.default_rng(0).random(4096).astype(np.float32))
    hi, lo = _halves(x)
    assert float(((hi + lo - x).abs() / x).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x).max()) > 2.0 ** -12
    assert torch.equal(hi.bfloat16().float(), hi)
    assert torch.equal(lo.bfloat16().float(), lo)
