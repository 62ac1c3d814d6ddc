"""LoRA adapters, the counterpart of ``kubetorch_tpu/models/lora.py``:
fine-tuning against a frozen base and serving.

An adapter holds per-target low-rank factors ``W' = W + (α/r)·A·B``: for a
target ``t`` of shape (L, d_in, d_out), ``t__a`` (L, d_in, r) and ``t__b``
(L, r, d_out), stacked over layers like the base params. ``merge_lora``
folds them into the weights (fp32 delta, cast back); the engine instead
applies them on the activation path, ``x·W + s·(x·A)·B`` with the product
in fp32 (``lora_delta``), so different slots run different adapters
through one decode step (``serve.engine``). On a mesh the banks stay
plain tensors, whole on every rank, and each delta is added in the layout
of the sharded base product it joins (``lora_proj``). Zero factors add
exactly 0.0, which keeps base traffic beside adapters bit-identical.

Training (``lora_loss``) merges in the graph each step, so gradients and
optimizer state exist only for the adapters; the base is closed over and
never requires grad:

    lcfg  = LoraConfig(rank=8, targets=("wq", "wv"))
    adap  = lora_init(params, lcfg, seed=1)
    loss  = lora_loss(params, cfg, lcfg)
    state = init_train_state(adap, opt)
    step  = make_train_step(loss, optimizer=opt)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..parallel.mesh import is_dtensor
from .quant import is_quantized, wdot


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # layer-dict leaves to adapt; attention projections by default, present
    # in both the dense and the MoE family (expert banks stay frozen)
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def lora_init(params: Dict[str, Any], lora_cfg: LoraConfig,
              seed: int = 0) -> Dict[str, Any]:
    """Adapter tree shaped off the base params, on their device: per target
    ``t`` of shape (L, d_in, d_out), ``t__a`` ~ N(0, 1/d_in) drawn in fp32
    from a ``torch.Generator`` seeded with ``seed``, and ``t__b`` = 0, so
    the merged model starts exactly at the base."""
    layers = params["layers"]
    out: Dict[str, torch.Tensor] = {}
    gen = None
    for t in lora_cfg.targets:
        if t not in layers:
            raise KeyError(f"LoRA target {t!r} not in params['layers'] "
                           f"(have {sorted(layers)})")
        w = layers[t]
        if is_quantized(w):
            raise ValueError(
                f"LoRA target {t!r} is int8-quantized — train on the "
                "full-precision base and quantize AFTER merging")
        if gen is None:
            gen = torch.Generator(device=w.device)
            gen.manual_seed(int(seed))
        l, d_in, d_out = w.shape
        a = torch.randn((l, d_in, lora_cfg.rank), generator=gen,
                        device=w.device, dtype=torch.float32)
        out[f"{t}__a"] = a.mul_(1.0 / math.sqrt(d_in)).to(w.dtype)
        out[f"{t}__b"] = torch.zeros((l, lora_cfg.rank, d_out), dtype=w.dtype,
                                     device=w.device)
    return {"layers": out}


def merge_lora(params: Dict[str, Any], adapters: Dict[str, Any],
               lora_cfg: LoraConfig) -> Dict[str, Any]:
    """``W + (α/r)·A·B`` per target, in fp32 and cast back to W's type;
    every other leaf is shared with the base tree (no copy)."""
    merged_layers = dict(params["layers"])
    for t in lora_cfg.targets:
        a = adapters["layers"][f"{t}__a"]
        b = adapters["layers"][f"{t}__b"]
        w = params["layers"][t]
        delta = torch.bmm(a.float(), b.float()) * lora_cfg.scale
        merged_layers[t] = (w.float() + delta).to(w.dtype)
    return {**params, "layers": merged_layers}


def lora_loss(base_params: Dict[str, Any], cfg, lora_cfg: LoraConfig,
              loss_fn: Optional[Callable] = None) -> Callable:
    """``fn(adapters, tokens, targets) -> scalar`` for
    ``train.make_train_step``: merges in the graph (``merge_lora``) and
    differentiates through the merge, so only the adapters get gradients;
    ``base_params`` is closed over as it is. ``loss_fn(params, tokens,
    targets)`` defaults to ``moe_loss`` for an MoE config (the router's aux
    term included) and to ``llama_loss_chunked`` otherwise."""
    if loss_fn is None:
        if hasattr(cfg, "n_experts"):
            from .moe import moe_loss
            loss_fn = lambda p, t, y: moe_loss(p, t, y, cfg)  # noqa: E731
        else:
            from .llama import llama_loss_chunked
            loss_fn = lambda p, t, y: llama_loss_chunked(p, t, y, cfg)  # noqa: E731

    def fn(adapters, tokens, targets):
        return loss_fn(merge_lora(base_params, adapters, lora_cfg), tokens,
                       targets)

    return fn


def adapter_count(adapters: Dict[str, Any]) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return tree.numel()
    return count(adapters)


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scale: float) -> torch.Tensor:
    """The activation-path contribution ``((x·A)·B)·scale`` in fp32, cast
    to x's type. x: (B, T, D); a/b shared across the batch (2-D: (D, R)/
    (R, O), one request's prefill) or per slot (3-D: (B, D, R)/(B, R, O),
    the decode grid)."""
    xf = x.float()
    if a.dim() == 2:
        out = (xf @ a.float()) @ b.float()
    else:
        out = torch.bmm(torch.bmm(xf, a.float()), b.float())
    return (out * scale).to(x.dtype)


def lora_proj(x: torch.Tensor, w: Any, lora, target: str) -> torch.Tensor:
    """``x @ W`` plus the adapter delta when ``lora`` carries this target.
    ``lora``: None, or (adapters_by_target, scale), adapters_by_target
    mapping target → (a, b) in either ``lora_delta`` layout. ``w`` may be
    a packed-int4 leaf (``quant.wdot`` takes it to the int4 kernel). On a
    mesh (x a DTensor) the delta lands in the base product's layout
    (:func:`_add_on_mesh`)."""
    y = wdot(x, w)
    if lora is not None:
        by_target, scale = lora
        ab = by_target.get(target)
        if ab is not None:
            if is_dtensor(x):
                return _add_on_mesh(y, x, ab[0], ab[1], scale)
            y = y + lora_delta(x, ab[0], ab[1], scale)
    return y


def _add_on_mesh(y, x, a, b, scale: float):
    """``y + s·(x·A)·B`` for DTensors x (B, T, D) and y = x·W, with the
    factors plain tensors equal on every rank (the banks are replicated,
    as JAX's plain arrays are under a mesh). Per mesh dim, from the layout
    ``common.linear`` gave y: a batch or sequence shard of y is kept; a
    pending sum in y (wo's product, D split over ``tensor``) means x and
    A's rows are cut alike, and the partial delta joins y's pending sum,
    so the reduction that settles y adds the delta once; a column shard of
    y (wq/wk/wv over ``tensor``) takes the rank's columns of the delta, a
    local slice. 3-D factors hold one slot each for x's local rows (the
    engine gathers each rank's own slots)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    xs, ds, cut = [], [], []
    for p in y.placements:
        if p.is_partial():
            xs.append(Shard(last)), ds.append(Partial()), cut.append(Shard(a.dim() - 2))
        elif isinstance(p, Shard) and p.dim < last:
            xs.append(p), ds.append(p), cut.append(Replicate())
        else:
            xs.append(Replicate()), ds.append(Replicate()), cut.append(Replicate())
    x_l = x.redistribute(mesh, xs).to_local()
    a, b = (t.full_tensor() if is_dtensor(t) else t for t in (a, b))
    if a.dim() == 3 and a.shape[0] != x_l.shape[0]:
        raise ValueError(f"per-slot factors for {a.shape[0]} slots beside "
                         f"{x_l.shape[0]} local rows of x")
    if Partial() in ds:
        a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False).redistribute(mesh, cut).to_local()
    shape = x.shape[:-1] + (b.shape[-1],)
    delta = DTensor.from_local(
        lora_delta(x_l, a, b, scale), mesh, ds, run_check=False,
        shape=shape, stride=torch.empty(shape, device="meta").stride())
    return y + delta.redistribute(mesh, y.placements)


def gather_slot_adapters(bank_l, aidx, lora_scale, banks):
    """The per-slot multi-LoRA gather: ``bank_l`` maps target → (A (N,
    ..., D, R), B (N, ..., R, O)) stacked factors, ``aidx`` the bank index
    of each slot gathered (0 = the zero adapter = base): every slot, or on
    a mesh the rank's own slots. Returns a ``lora_proj``-shaped
    (adapters_by_target, scale), or None when no bank exists."""
    if banks:
        return ({t: (a[aidx], b_[aidx])
                 for t, (a, b_) in bank_l.items()}, lora_scale)
    return None
