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
"""

from __future__ import annotations

import torch

ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over rows of |got - want| / |want|, L2 over the last dim.
    A row of zeros in ``want`` (a fully masked query) must be zero in
    ``got``."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    return float((diff / ref.clamp_min(1e-30)).max())


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())
