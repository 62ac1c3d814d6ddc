"""The head and weight products of ``kubetorch_tpu/models/quant.py`` as the
serving path uses them on plain (unquantized) weights.

Quantized leaves (int8 dicts, the int4 nibble pack behind the fused matmul
kernel) are not ported yet: a dict leaf raises rather than being read as
something else.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def _plain(w: Any, name: str) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError(
            f"quantized weight leaf {name!r} (int8/int4) is not ported")
    return w


def head_weight(params: Dict[str, Any], dtype=torch.bfloat16) -> torch.Tensor:
    """The lm_head in compute dtype."""
    return _plain(params["lm_head"], "lm_head").to(dtype)


def wdot(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ W`` for a plain weight tensor."""
    return x @ _plain(w, "weight")


def lm_head_dot(x: torch.Tensor, params: Dict[str, Any], dtype) -> torch.Tensor:
    """fp32 logits ``x @ lm_head`` — one definition for ``generate`` and the
    engine's prefill and decode."""
    return (x @ head_weight(params, dtype)).float()
