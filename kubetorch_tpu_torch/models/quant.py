"""Weight-only quantization for serving, the counterpart of
``kubetorch_tpu/models/quant.py``.

Two formats, both leaves of the ordinary param dict:

- **int8**: ``{"__kt_q8__": int8 (..., in, out), "scale": fp32 (..., 1,
  out)}``, one symmetric scale per output column. ``dequant_layer``
  materializes a layer in the compute dtype with plain tensor ops (the JAX
  package leaves the same work to XLA); no kernel is involved.
- **int4**: ``{"__kt_q4__": int8 (..., in/2, out), "scale": fp32 (...,
  in/group, out)}``, values in [-7, 7] with one scale per group of
  ``group`` contraction rows and output column, packed two per byte in the
  half-split layout (byte row r = weight rows r and r + in/2). It stays
  packed: ``wdot`` sends it to the fused int4 matmul kernel
  (``ops.quant_matmul``) when the JAX package's tiling predicate
  ``q4_supported`` holds, and to a dequantize-then-fp32-matmul fallback
  otherwise (Llama-3's head, whose 128256 columns are no multiple of 512).

Quantizers round half to even, as ``jnp.round`` does, so packed bytes,
int8 values and scales equal the JAX package's bitwise. Norms, routers and
the embedding stay full precision (``_SKIP``).

Usage::

    from kubetorch_tpu_torch.models.quant import quantize_params_int4
    engine = GenerationEngine(quantize_params_int4(params), cfg, ...)
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..ops import quant_matmul as _q4
from .common import resolve_device

QKEY = "__kt_q8__"
Q4KEY = "__kt_q4__"   # nibble-packed int4 (two values per int8 byte)

# leaves kept full precision: norms are fp32 by design, the router's logits
# are precision-sensitive, and the embedding is gather-indexed
_SKIP = ("attn_norm", "ffn_norm", "final_norm", "router", "embed")


def _quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: the scale runs over the
    contraction axis (second-to-last), so each output column keeps its own
    range."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {QKEY: q, "scale": scale}


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and (QKEY in leaf or Q4KEY in leaf)


def dequant(leaf: Any, dtype=torch.bfloat16) -> Any:
    """Dequantize an int8 or int4 leaf; identity for ordinary tensors."""
    if isinstance(leaf, dict) and Q4KEY in leaf:
        return _dequant_int4(leaf, dtype)
    if is_quantized(leaf):
        return (leaf[QKEY].float() * leaf["scale"]).to(dtype)
    return leaf


def head_weight(params: Dict[str, Any], dtype=torch.bfloat16) -> torch.Tensor:
    """The lm_head in compute dtype, whether stored quantized or not: the
    one definition of head handling for ``generate`` and the engine."""
    leaf = params["lm_head"]
    if is_quantized(leaf):
        return dequant(leaf, dtype)
    return leaf.to(dtype)


def dequant_layer(lw: Dict[str, Any], dtype=torch.bfloat16) -> Dict[str, Any]:
    """Dequantize one layer's weight dict, at the top of the layer body, so
    only the current layer materializes in the compute dtype. int4 leaves
    stay packed (``wdot`` takes them to the fused kernel); the ``experts``
    subtree passes through as it is (the MoE paths own its dequant)."""
    out = {}
    for k, v in lw.items():
        if k == "experts" or (isinstance(v, dict) and Q4KEY in v):
            out[k] = v
        elif isinstance(v, dict) and not is_quantized(v):
            out[k] = dequant_layer(v, dtype)
        else:
            out[k] = dequant(v, dtype)
    return out


def _walk(tree: Any, fn, path=()) -> Any:
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize every matmul weight (wq/wk/wv/wo, FFN, experts,
    lm_head); precision-sensitive leaves stay as they are."""

    def visit(path, leaf):
        name = path[-1] if path else ""
        if name in _SKIP or getattr(leaf, "ndim", 0) < 2:
            return leaf
        return _quantize_leaf(leaf)

    return _walk(params, visit)


def dequantize_params(params: Dict[str, Any],
                      dtype=torch.bfloat16) -> Dict[str, Any]:
    """The full-precision view of a quantized tree (tests, migration)."""
    return _walk(params, lambda _, leaf: dequant(leaf, dtype))


def quantized_bytes(params: Dict[str, Any]) -> Dict[str, int]:
    """{'quantized': n, 'full': m}: bytes of the quantized leaves (values
    and fp32 scales) and of the full-precision ones."""
    sizes = {"quantized": 0, "full": 0}

    def visit(path, leaf):
        if is_quantized(leaf):
            q = leaf.get(QKEY, leaf.get(Q4KEY))
            sizes["quantized"] += q.numel() + 4 * leaf["scale"].numel()
        else:
            sizes["full"] += leaf.numel() * leaf.element_size()
        return leaf

    _walk(params, visit)
    return sizes


def llama_init_quantized(cfg, bits: int = 8, seed: int = 0,
                         device=None) -> Dict[str, Any]:
    """Random Llama params built directly in the quantized serving layout
    (``bits`` 8 or 4), one layer slice at a time: the peak beyond the
    quantized stacks is one (in, out) fp32 slice, never the full-precision
    parameter set (Llama-3-8B in int4 is ~5 GB on the card).

    Structure-identical to ``quantize_params(llama_init(cfg))`` /
    ``quantize_params_int4(...)``. Values are drawn in fp32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, slice by slice,
    so they differ from the two-step path and from the JAX package's (whose
    draws come from ``jax.random``); parity with JAX is held through
    converted weights (``models.convert.params_from_numpy``)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    device = resolve_device(device)
    d, L = cfg.dim, cfg.n_layers
    hd, nh, nkv, f = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    quantizer = _quantize_leaf if bits == 8 else _quantize_leaf_int4
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def stacked(in_dim, out_dim):
        acc = None
        for layer in range(L):
            leaf = quantizer(draw((in_dim, out_dim), in_dim))
            if acc is None:
                acc = {k: torch.empty((L,) + tuple(v.shape), dtype=v.dtype,
                                      device=device)
                       for k, v in leaf.items()}
            for k, v in leaf.items():
                acc[k][layer] = v
        return acc

    embed = draw((cfg.vocab_size, d), d).to(cfg.dtype)
    layers = {"attn_norm": torch.ones((L, d), device=device)}
    for name, (i, o) in (("wq", (d, nh * hd)), ("wk", (d, nkv * hd)),
                         ("wv", (d, nkv * hd)), ("wo", (nh * hd, d))):
        layers[name] = stacked(i, o)
    layers["ffn_norm"] = torch.ones((L, d), device=device)
    for name, (i, o) in (("w_gate", (d, f)), ("w_up", (d, f)),
                         ("w_down", (f, d))):
        layers[name] = stacked(i, o)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((d,), device=device),
        "lm_head": quantizer(draw((d, cfg.vocab_size), d)),
    }


# ---------------------------------------------------------------------------
# int4 (nibble-packed): half of int8's bytes again on the decode stream
# ---------------------------------------------------------------------------


def _quantize_leaf_int4(w: torch.Tensor,
                        group: int = 128) -> Dict[str, torch.Tensor]:
    """Symmetric group-wise int4: groups of ``group`` contraction rows
    share a scale per output column, values in [-7, 7], packed two per
    byte in the half-split layout. Leaf: ``{Q4KEY: int8 (..., in/2, out),
    "scale": fp32 (..., in/group, out)}``."""
    wf = w.float()
    *lead, din, dout = wf.shape
    if din % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, "
                         f"got {din}")
    g = min(group, din)
    while din % g:
        g //= 2
    wg = wf.reshape(*lead, din // g, g, dout)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, 1.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    q = q.reshape(*lead, din, dout)
    # half-split: byte row r = weight row r (low nibble) and r + in/2 (high)
    lo = q[..., : din // 2, :] & 0x0F
    hi = q[..., din // 2:, :] << 4
    return {Q4KEY: lo | hi, "scale": scale.squeeze(-2)}


def _dequant_int4(leaf: Dict[str, torch.Tensor],
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack and dequantize: shifts on int8 sign-extend each nibble
    (``(p << 4) >> 4`` for the low one, ``p >> 4`` for the high one), and
    the group scale multiplies in fp32."""
    p = leaf[Q4KEY]
    scale = leaf["scale"]
    *lead, half, dout = p.shape
    din = half * 2
    lo = (p << 4) >> 4
    hi = p >> 4
    q = torch.cat([lo, hi], dim=-2)
    ng = scale.shape[-2]
    wf = (q.float().reshape(*lead, ng, din // ng, dout)
          * scale[..., :, None, :])
    return wf.reshape(*lead, din, dout).to(dtype)


def quantize_params_int4(params: Dict[str, Any],
                         group: int = 128) -> Dict[str, Any]:
    """int4-quantize every matmul weight except MoE expert banks, which
    stay int8 (a mixed layout ``dequant``/``dequant_layer`` serve as it
    is)."""

    def visit(path, leaf):
        name = path[-1] if path else ""
        if name in _SKIP or getattr(leaf, "ndim", 0) < 2:
            return leaf
        if "experts" in path:
            return _quantize_leaf(leaf)
        return _quantize_leaf_int4(leaf, group=group)

    return _walk(params, visit)


def wdot(x: torch.Tensor, w: Any, dtype=None) -> torch.Tensor:
    """``x @ W`` for a plain weight tensor or a packed-int4 leaf. Packed
    int4 goes through ``ops.quant_matmul.q4_matmul`` (the kernel on CUDA)
    when ``q4_supported`` holds, else through the fp32 dequant fallback,
    ``x.float() @ W_fp32`` (the JAX package's ``x @ W_f32`` promotes x the
    same way). ``x`` may carry any leading dims; the result is in
    ``dtype`` (default ``x.dtype``)."""
    out_dtype = dtype or x.dtype
    if isinstance(w, dict) and Q4KEY in w:
        p, s = w[Q4KEY], w["scale"]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if _q4.q4_supported(x2.shape, p.shape, s.shape):
            y = _q4.q4_matmul(x2, p, s)
        else:
            y = x2.float() @ _dequant_int4(w, torch.float32)
        return y.reshape(*lead, p.shape[-1]).to(out_dtype)
    return x @ w


def lm_head_dot(x: torch.Tensor, params: Dict[str, Any], dtype) -> torch.Tensor:
    """fp32 logits ``x @ lm_head``: one definition for ``generate`` and the
    engine's prefill and decode."""
    leaf = params["lm_head"]
    if isinstance(leaf, dict) and Q4KEY in leaf:
        return wdot(x, leaf, dtype=torch.float32)
    return (x @ head_weight(params, dtype)).float()
