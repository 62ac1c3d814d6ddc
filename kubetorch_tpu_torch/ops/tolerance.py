"""How a kernel's output is held to its plain version's.

An attention output's size differs by orders of magnitude from row to row:
a query that sees one key returns that key's value (about 1 for random
inputs), one that sees n random keys returns their weighted mean (about
n^-1/2). A single tolerance scaled by the tensor's largest value is as wide
as a long row's whole output, so a dropped tile or a wrong rescale on long
rows passes it. The comparison is therefore per row: the L2 norm of the
difference over the head dim, relative to that row's own norm.

Tolerances, per row:

- fp32: 1e-4. Kernel and plain version compute the same fp32 math and
  differ in the order of the sums and in their ``exp``.
- bf16: 1e-2. Both accumulate in fp32 and round the output to bf16 once;
  one rounding moves an element by at most 2^-8 of itself, and where the
  two fp32 values straddle a rounding edge they part by one bf16 step
  (2^-7 of the element at most). Flash-decode also rounds P to bf16 under
  the running maximum of its tile, where the plain version uses the row's
  maximum: each term moves by up to 2^-9 of itself, independently. Those
  errors sit near 2^-9 of the row's norm; 1e-2 leaves room above them and
  stays far below what a skipped 64-row tile moves a row of 2,048 keys
  (about (64/2048)^1/2 = 0.18 of its norm).

Gradients (dQ per query row and head, dK/dV per key row and kv-head) take
the same tolerances, with one change: a row's error is relative to the
larger of its own norm and the RMS of the tensor's row norms. A gradient
row can be zero by exact cancellation — the first query of a causal mask
sees one key, so P = 1 and dS = dP - delta = dO.v - dO.o with o = v — and
there both sides hold only rounding noise (~1e-6 of a typical row), which
no relative tolerance holds. Every row still answers to the tolerance
times a typical row's norm; a dropped tile or a missing delta moves rows by
a large part of that (tests/test_torch_flash_bwd.py plants both).

LSE (fp32 per row, both input types, computed in fp32 from the same
inputs): 1e-4 absolute. Its values are log-sums of order 1-10 where fp32
rounding is ~1e-6; a dropped 64-key tile moves a row of n keys by about
64/n, at least 3e-2 at n = 2048.
"""

from __future__ import annotations

import torch

ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-4


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over rows of |got - want| / |want|, L2 over the last dim.
    A row of zeros in ``want`` (a fully masked query) must be zero in
    ``got``."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    return float((diff / ref.clamp_min(1e-30)).max())


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def grad_row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over rows of |got - want| / max(|want|, RMS row norm of
    ``want``), L2 over the last dim (see the module docstring)."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    floor = ref.square().mean().sqrt()
    return float((diff / torch.maximum(ref, floor).clamp_min(1e-30)).max())
