"""Training step builder, the counterpart of
``kubetorch_tpu/train/train_step.py`` on one device.

``make_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, metrics)``: forward and backward through the loss (the flash
kernels on CUDA), the optimizer's update (``train/optim.py``, optax's
numerics) and the param update ``p + u.to(p.dtype)``. The knobs are the
JAX package's:

- ``accum_steps``: the batch's leading dim splits into that many
  microbatches; each runs forward and backward in turn, grads sum in fp32
  and are averaged once, then ONE optimizer update applies.
- ``remat_policy``: a named policy (``models/common.py``) wrapped around
  the loss per microbatch; the model's own layers take the same names
  through ``LlamaConfig.remat_policy``.
- ``metrics``: what the step reports beyond ``step``; ``grad_norm`` is the
  global norm of the raw (averaged, unclipped) grads.
- ``donate=True`` updates params and optimizer state in place, the
  counterpart of the JAX step's buffer donation: the caller's
  ``TrainState`` tensors are the returned state's. ``donate=False`` leaves
  them as they were.

Not ported yet: a ``mesh`` (and so ``rules`` and ``overlap_grads``), which
raise ``NotImplementedError`` (parallelism, ROADMAP Queue A item 12), and
the ``kt_train_step_seconds{phase="compute"}`` observation, which waits
for the port's copy of ``telemetry`` (ROADMAP Queue A item 7).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence

import torch

from ..models.common import checkpointed, resolve_remat_policy
from .optim import (GradientTransformation, adamw, chain, clip_by_global_norm,
                    global_norm, tree_leaves, tree_map,
                    warmup_cosine_decay_schedule)

# metric names the step can compute; "step" always rides along
STEP_METRICS = ("loss", "grad_norm")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10000) -> GradientTransformation:
    sched = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1))
    return chain(
        clip_by_global_norm(1.0),
        adamw(sched, b1=0.9, b2=0.95, weight_decay=weight_decay,
              mu_dtype=torch.float32),
    )


def init_train_state(params: Any, optimizer=None) -> TrainState:
    optimizer = optimizer or default_optimizer()
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _assign(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write ``new`` into ``old`` where they agree in dtype and shape (and
    keep ``old``); otherwise the new tensor stands, as it would in JAX."""
    if old.dtype == new.dtype and old.shape == new.shape:
        return old.copy_(new)
    return new


def make_train_step(loss_fn: Callable, optimizer=None, mesh=None, rules=None,
                    donate: bool = True, accum_steps: int = 1,
                    overlap_grads: bool = False, remat_policy: Any = None,
                    metrics: Sequence[str] = STEP_METRICS) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, tokens, targets) -> scalar``; ``batch`` is a dict with
    ``tokens`` and ``targets`` on the params' device. See the module
    docstring for the knobs."""
    optimizer = optimizer or default_optimizer()
    if mesh is not None and rules is None:
        raise ValueError("make_train_step: a mesh requires sharding `rules`")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if overlap_grads and mesh is None:
        raise ValueError("make_train_step: overlap_grads steers collectives "
                         "onto a mesh — pass mesh= and rules=")
    unknown = set(metrics) - set(STEP_METRICS)
    if unknown:
        raise ValueError(f"unknown step metrics {sorted(unknown)}; "
                         f"expected a subset of {STEP_METRICS}")
    if mesh is not None:
        raise NotImplementedError("make_train_step(mesh=...): parallelism is "
                                  "not ported yet; the step runs on one device")
    metrics = tuple(metrics)
    loss_fn = checkpointed(loss_fn, resolve_remat_policy(remat_policy))

    def value_and_grad(params, tokens, targets):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            loss = loss_fn(tree_map(lambda _: next(it), params), tokens, targets)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def loss_and_grads(params, batch):
        tokens, targets = batch["tokens"], batch["targets"]
        if accum_steps == 1:
            return value_and_grad(params, tokens, targets)
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch={b} not divisible by "
                             f"accum_steps={accum_steps}")
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grad_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        for mt, my in zip(tokens.chunk(accum_steps), targets.chunk(accum_steps)):
            loss, grads = value_and_grad(params, mt, my)
            loss_sum += loss
            tree_map(lambda a, g: a.add_(g), grad_sum, grads)
            del grads
        inv = 1.0 / accum_steps
        return loss_sum * inv, tree_map(lambda g: g.mul_(inv), grad_sum)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(state.params, batch)
        m = {"step": state.step.clone()}
        if "loss" in metrics:
            m["loss"] = loss
        if "grad_norm" in metrics:
            # an extra full-tree reduction — opt out via metrics=("loss",)
            m["grad_norm"] = global_norm(grads)
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
            del grads
            new_params = tree_map(lambda p, u: p + u.to(p.dtype), state.params,
                                  updates)
            del updates
            if donate:
                new_params = tree_map(_assign, state.params, new_params)
                new_opt = tree_map(_assign, state.opt_state, new_opt)
                new_step = state.step.add_(1)
            else:
                new_step = state.step + 1
        return TrainState(new_params, new_opt, new_step), m

    step.loss_and_grads = loss_and_grads  # type: ignore[attr-defined]
    return step
