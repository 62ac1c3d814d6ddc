"""The port's flash-attention gradient (kubetorch_tpu_torch/ops/attention.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the wrappers run their plain versions, so these tests hold the
plain forward-with-LSE, the plain A2 (dQ) and A3 (dK/dV), and the autograd
Function that wires them, to ``jax.vjp`` of the Pallas flash attention and
to its ``_fwd(..., need_lse=True)``. The CUDA kernels are held to the same
plain versions by tests/test_torch_cuda.py (marked ``cuda``) and
chip_smoke.py.

Tolerances (fp32 on both sides; the two differ only in the order of their
sums): outputs and gradients per row, 1e-4 relative to the row's norm,
floored at the tensor's RMS row norm for gradients
(``ops/tolerance.py:grad_row_rel_err`` gives the reason: the first causal
query's gradient is zero by cancellation). LSE 1e-5 absolute, tighter than
the card's 1e-4: here both sides take the same fp32 logits in one pass.
Against torch's own autograd through the plain einsum attention, 1e-5 per
row: the same math in the same framework.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubetorch_tpu.ops import attention as jax_attn
from kubetorch_tpu_torch.models.llama import _xla_attention
from kubetorch_tpu_torch.ops.attention import (attention_delta,
                                               flash_attention,
                                               flash_attention_bwd_dkv,
                                               flash_attention_bwd_dkv_ref,
                                               flash_attention_bwd_dq,
                                               flash_attention_bwd_dq_ref,
                                               flash_attention_bwd_ref,
                                               flash_attention_fwd_ref)
from kubetorch_tpu_torch.ops.tolerance import (ROW_RTOL, grad_row_rel_err,
                                               row_rel_err)

pytestmark = pytest.mark.level("unit")

TOL = ROW_RTOL[torch.float32]
TOL_LSE = 1e-5
TOL_SAME_FRAMEWORK = 1e-5
BLOCK = 64        # Pallas tiles: several q and k blocks at S >= 128
HD = 64

CASES = [(s, nh, nkv, causal)
         for s in (64, 128, 256)
         for nh, nkv in ((4, 4), (4, 2), (8, 2))
         for causal in (True, False)]


def _inputs(s, nh, nkv, seed, b=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, nh, HD)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, HD)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, HD)).astype(np.float32)
    do = rng.standard_normal((b, s, nh, HD)).astype(np.float32)
    return q, k, v, do


def _jax_reference(q, k, v, do, causal):
    """(out, lse (B, N, S), dq, dk, dv) from the Pallas kernels."""
    def f(q, k, v):
        return jax_attn.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                        block_k=BLOCK, interpret=True)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(do))
    head_major = [jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)]
    _, lse = jax_attn._fwd(*head_major, q.shape[3] ** -0.5, causal,
                           BLOCK, BLOCK, True, need_lse=True)
    return tuple(torch.from_numpy(np.array(x))
                 for x in (out, lse[..., 0], dq, dk, dv))


@pytest.fixture(scope="module")
def reference():
    """Seeded inputs and the JAX results, one entry per case, computed once."""
    cache = {}

    def get(s, nh, nkv, causal):
        key = (s, nh, nkv, causal)
        if key not in cache:
            arrays = _inputs(s, nh, nkv, seed=s + 10 * nh + nkv + int(causal))
            cache[key] = (tuple(map(torch.from_numpy, arrays)),
                          _jax_reference(*arrays, causal))
        return cache[key]
    return get


@pytest.mark.parametrize("s,nh,nkv,causal", CASES)
def test_plain_forward_with_lse_matches_pallas(reference, s, nh, nkv, causal):
    (q, k, v, _), (out_j, lse_j, *_) = reference(s, nh, nkv, causal)
    out, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    assert lse.shape == (1, nh, s) and lse.dtype == torch.float32
    assert row_rel_err(out, out_j) <= TOL
    assert float((lse - lse_j).abs().max()) <= TOL_LSE


@pytest.mark.parametrize("s,nh,nkv,causal", CASES)
def test_plain_backward_matches_pallas(reference, s, nh, nkv, causal):
    """A2 and A3's plain versions, separately (as the kernels are called,
    with delta) and in the one-pass backward."""
    (q, k, v, do), (_, _, dq_j, dk_j, dv_j) = reference(s, nh, nkv, causal)
    out, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
    delta = attention_delta(out, do)
    assert delta.shape == (1, nh, s)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.shape == want.shape
        assert grad_row_rel_err(got, want) <= TOL
    one_pass = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    for got, want in zip(one_pass, (dq_j, dk_j, dv_j)):
        assert grad_row_rel_err(got, want) <= TOL


@pytest.mark.parametrize("s,nh,nkv,causal", [(128, 8, 2, True), (64, 4, 4, False)])
def test_autograd_function_matches_pallas(reference, s, nh, nkv, causal):
    (q, k, v, do), (out_j, _, dq_j, dk_j, dv_j) = reference(s, nh, nkv, causal)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    before = (flash_attention.launches, flash_attention.bwd_dq_launches,
              flash_attention.bwd_dkv_launches)
    out = flash_attention(q, k, v, causal=causal)
    assert out.grad_fn is not None
    out.backward(do)
    assert (flash_attention.launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == before   # CPU: no kernels
    assert row_rel_err(out.detach(), out_j) <= TOL
    for t, want in ((q, dq_j), (k, dk_j), (v, dv_j)):
        assert grad_row_rel_err(t.grad, want) <= TOL


@pytest.mark.parametrize("nh,nkv", [(4, 2), (8, 8)])
def test_autograd_function_matches_torch_autograd_of_plain_attention(nh, nkv):
    """The Function's gradient against torch's own autograd through
    ``_xla_attention`` (the model's plain attention), fp32, causal."""
    q, k, v, do = map(torch.from_numpy, _inputs(96, nh, nkv, seed=nh + nkv, b=2))
    grads = []
    for fn in (lambda q, k, v: flash_attention(q, k, v),
               lambda q, k, v: _xla_attention(q, k, v, HD ** -0.5)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves).backward(do)
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        assert grad_row_rel_err(got, want) <= TOL_SAME_FRAMEWORK


def test_no_grad_path_writes_no_lse_and_keeps_no_graph():
    q, k, v, _ = map(torch.from_numpy, _inputs(64, 4, 2, seed=3))
    q.requires_grad_()
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None
    out2 = flash_attention(q.detach(), k, v)
    assert out2.grad_fn is None and torch.equal(out, out2)


def test_bwd_wrappers_take_plain_versions_on_cpu():
    q, k, v, do = map(torch.from_numpy, _inputs(64, 4, 2, seed=4))
    out, lse = flash_attention_fwd_ref(q, k, v)
    delta = attention_delta(out, do)
    before = (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert (flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == before
    assert torch.equal(dq, flash_attention_bwd_dq_ref(q, k, v, do, lse, delta))
    for got, want in zip((dk, dv), flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# planted faults: what a kernel that gets the folded index or delta wrong
# computes fails the per-row check
# ---------------------------------------------------------------------------


def _dkv_with_folded_index_as_qblock(q, k, v, do, lse, delta, block=BLOCK):
    """dK/dV as a kernel computes them that takes the folded
    (group member x q-block) index i for the q block itself instead of
    i % nq_blocks: member g's q tiles sit g * S rows further down, so its
    causal mask and tile skip let every key through."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    group = nh // nkv
    scale = hd ** -0.5
    dk = torch.zeros(b, s, nkv, hd)
    dv = torch.zeros(b, s, nkv, hd)
    for h in range(nh):
        kvh, g = divmod(h, group)
        logits = torch.einsum("bsh,bth->bst", q[:, :, h], k[:, :, kvh]) * scale
        rows = torch.arange(s)[:, None] + g * s   # the mis-decoded q rows
        logits = logits.masked_fill(torch.arange(s)[None, :] > rows, -1e30)
        p = torch.exp(logits - lse[:, h, :, None])
        dp = torch.einsum("bsh,bth->bst", do[:, :, h], v[:, :, kvh])
        ds = p * (dp - delta[:, h, :, None]) * scale
        dk[:, :, kvh] += torch.einsum("bst,bsh->bth", ds, q[:, :, h])
        dv[:, :, kvh] += torch.einsum("bst,bsh->bth", p, do[:, :, h])
    return dk, dv


def test_planted_folded_index_fault_fails_the_row_check(reference):
    (q, k, v, do), (_, _, _, dk_j, dv_j) = reference(256, 8, 2, True)
    out, lse = flash_attention_fwd_ref(q, k, v)
    delta = attention_delta(out, do)
    dk, dv = _dkv_with_folded_index_as_qblock(q, k, v, do, lse, delta)
    assert grad_row_rel_err(dk, dk_j) > TOL
    assert grad_row_rel_err(dv, dv_j) > TOL
    # the same helper with the index decoded right is A3
    ok_dk, ok_dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta)
    assert grad_row_rel_err(ok_dk, dk_j) <= TOL


def test_planted_missing_delta_fault_fails_the_row_check(reference):
    (q, k, v, do), (_, _, dq_j, _, _) = reference(256, 8, 2, True)
    _, lse = flash_attention_fwd_ref(q, k, v)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, torch.zeros_like(lse))
    assert grad_row_rel_err(dq, dq_j) > TOL


def test_grad_row_check_floor_only_covers_cancellation():
    """The first causal query's dQ row is rounding noise on both sides; the
    floor lets it pass while a 1% error on any row still fails."""
    q, k, v, do = map(torch.from_numpy, _inputs(128, 4, 2, seed=9))
    out, lse = flash_attention_fwd_ref(q, k, v)
    dq, _, _ = flash_attention_bwd_ref(q, k, v, out, lse, do)
    norms = dq.norm(dim=-1)
    assert float(norms[0, 0].max()) < 1e-4 * float(norms.square().mean().sqrt())
    bumped = dq.clone()
    bumped[0, 100, 1] *= 1.01
    assert grad_row_rel_err(bumped, dq) > TOL


def test_decode_attention_refuses_inputs_that_require_grad():
    """The decode kernel has no gradient: rather than hand back an output
    cut from the graph, the wrapper raises under grad mode."""
    from kubetorch_tpu_torch.ops.decode_attention import decode_attention
    q = torch.zeros(2, 4, 64, requires_grad=True)
    ck = torch.zeros(2, 16, 2, 64)
    pos = torch.tensor([3, 15], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_attention(q, ck, ck, pos)
    with torch.no_grad():
        assert decode_attention(q, ck, ck, pos).shape == (2, 4, 64)
