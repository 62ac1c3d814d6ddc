"""The port's own copy of the optax pieces the JAX train step uses:
``chain``, ``clip_by_global_norm``, ``adamw`` and
``warmup_cosine_decay_schedule``, as plain functions on dicts of tensors.

A transformation is an ``init(params) -> state`` /
``update(updates, state, params) -> (updates, state)`` pair, and states
nest as optax's do (a chain's state is the tuple of its members'), so a
JAX optimizer state carries across leaf for leaf
(``models/convert.py:train_state_from_numpy``). The numerics are optax's:

- ``clip_by_global_norm``: every update scaled by max_norm / norm when the
  global norm reaches max_norm, chosen on the device (no host sync);
- ``scale_by_adam``: mu in ``mu_dtype`` (or the update's type), nu in the
  param type, bias correction with an int32 count, eps outside the root;
- ``add_decayed_weights``: decoupled decay, scaled by the learning rate
  with the rest of the update;
- schedules evaluated at the count *before* it increments, so a warmup
  from 0 gives the first step a learning rate of 0.

``torch.optim.AdamW`` differs on each of these (defaults, state types,
schedule timing, the chained clip), so it is not used. One deliberate
difference: the global norm of bf16 leaves accumulates in fp32 here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32, on the leaves' device."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, saturating at the int32 maximum (optax's safe_increment)."""
    top = torch.iinfo(torch.int32).max
    return torch.where(count < top, count + 1, count)


def _scalar_zero(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm

        def clip(t):
            return torch.where(keep, t, (t / norm.to(t.dtype)) * max_norm)

        return tree_map(clip, updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0,
                  mu_dtype: Optional[torch.dtype] = None) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(
            count=_scalar_zero(params),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params),
            nu=tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state.mu)
        nu = tree_map(lambda g, n: (1 - b2) * (g * g) + b2 * n, updates, state.nu)
        count = _safe_increment(state.count)
        # 1 - decay**count in fp32, then divided in each moment's own type
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()

        def direction(m, n):
            return (m / bc1.to(m.dtype)) / (torch.sqrt(n / bc2.to(n.dtype) + eps_root) + eps)

        updates = tree_map(direction, mu, nu)
        if mu_dtype is not None:
            mu = tree_map(lambda m: m.to(mu_dtype), mu)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return tree_map(lambda g, p: g + weight_decay * p, updates, params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]
                           ) -> GradientTransformation:
    """Multiply by -lr; a schedule is read at its count before the count
    increments."""
    if callable(learning_rate):
        def init(params):
            return ScaleByScheduleState(count=_scalar_zero(params))

        def update(updates, state, params=None):
            step_size = -learning_rate(state.count)
            updates = tree_map(lambda g: step_size.to(g.dtype) * g, updates)
            return updates, ScaleByScheduleState(count=_safe_increment(state.count))

        return GradientTransformation(init, update)

    def update_const(updates, state, params=None):
        return tree_map(lambda g: g * -learning_rate, updates), state

    return GradientTransformation(lambda params: EmptyState(), update_const)


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw with its defaults: Adam, then decoupled weight decay, then
    the learning rate."""
    return chain(scale_by_adam(b1, b2, eps, eps_root, mu_dtype),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (which counts the warmup). Evaluated in fp32 on the count's device."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("warmup_cosine_decay_schedule needs decay_steps > "
                         f"warmup_steps, got {decay_steps=} {warmup_steps=}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        if warmup_steps > 0:
            frac = 1 - c.clamp(0, warmup_steps) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
        else:
            warm = torch.full_like(c, init_value)
        t = torch.clamp(c - warmup_steps, max=cos_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / cos_steps))
        decayed = peak_value * ((1 - alpha) * cosine ** exponent + alpha)
        return torch.where(c < warmup_steps, warm, decayed)

    return schedule
