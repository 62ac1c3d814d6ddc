"""int8 KV cache for the serving engine, the counterpart of
``kubetorch_tpu/serve/kv_quant.py``.

Each cache row (one token's K or V for one kv-head, Hd values) is stored
as ``round(x / s)`` in int8 with one fp32 scale ``s = max|x| / 127`` per
(slot, position, head): a bf16 row of Hd values (2·Hd bytes) becomes Hd
int8 values plus 4 scale bytes. Attention folds the scales into its math
(logit columns times ``ks``, probabilities times ``vs``) and never
materializes fp rows: ``ops.decode_attention.decode_attention_quant``.

Opt in per engine: ``GenerationEngine(params, cfg, quantize_kv=True)``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..models.common import resolve_device


class QuantKVCache(NamedTuple):
    """Slot-grid cache in int8: values (L, B, S, NKV, Hd) int8, scales
    (L, B, S, NKV) fp32, one scale per written row per head."""
    kq: torch.Tensor
    ks: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor


def init_quant_cache(cfg, batch: int, max_len: int,
                     device=None) -> QuantKVCache:
    device = resolve_device(device)
    vshape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    sshape = vshape[:-1]
    return QuantKVCache(
        kq=torch.zeros(vshape, dtype=torch.int8, device=device),
        ks=torch.zeros(sshape, dtype=torch.float32, device=device),
        vq=torch.zeros(vshape, dtype=torch.int8, device=device),
        vs=torch.zeros(sshape, dtype=torch.float32, device=device))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Hd) → (int8 (..., Hd), fp32 scale (...,)). All-zero rows
    (unwritten cache, padding) keep scale 0 and dequantize to exact
    zeros. Rounds half to even, as ``jnp.round`` does, so the int8 rows
    and scales equal the JAX package's bitwise."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 rows back, for callers that need plain rows (tests, debugging)."""
    return q.float() * scale[..., None]
