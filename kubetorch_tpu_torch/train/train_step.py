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
  ``TrainState`` tensors are the returned state's, and each new leaf is
  written over its old one as soon as it is computed (the optimizer's
  ``inplace``), so the update never holds two copies of the params or of
  the optimizer state. ``donate=False`` leaves them as they were.

Each call is observed into ``kt_train_step_seconds{phase="compute"}``
(``telemetry.train_metrics``) from call to return, as the JAX wrapper
observes its jitted step; nothing in the window waits for the device.

**On a mesh** (``mesh=`` a ``DeviceMesh`` from ``parallel.build_mesh``,
``rules=`` a rule table such as ``parallel.LLAMA_RULES``), as the JAX
step under GSPMD:

- ``wrapper.shard_state(state)`` lays the params out as DTensors by the
  rules; optimizer subtrees that mirror the param tree (adam's mu and nu)
  take each param's own placements, other optimizer leaves and the step
  are replicated (``_opt_shardings``: wq and wo share a shape but not a
  layout). ``wrapper.batch_sharding`` is the batch's sharding
  (``parallel.sharding.batch_sharding``); a plain batch (equal on every
  rank) is cut to it on the way in.
- The step runs under ``use_mesh(mesh)``. The loss comes back replicated;
  the gradients come back as DTensor's propagation leaves them
  (``Partial`` over the data-like axes) and are redistributed to the
  param placements (the reduce-scatter over fsdp) before the optimizer,
  whose global norm is replicated before it scales anything.
- ``overlap_grads=True`` with ``accum_steps > 1``: each microbatch's
  gradients are reduce-scattered to the param placements inside the loop,
  and the fp32 accumulator is itself laid out as the params (one fsdp
  shard per rank). Without it the accumulator is a replicated fp32 copy
  of every gradient, into which each microbatch's pending sums are
  all-reduced (DTensor's add of a ``Partial``), and the layout is cut
  after the loop. Both sum over the ranks first, then over the
  microbatches, so the two give the same bits.
- Metrics come back as plain (replicated) tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence

import torch

from .. import telemetry
from ..models.common import checkpointed, resolve_remat_policy
from .optim import (GradientTransformation, _assign, adamw, chain,
                    clip_by_global_norm, global_norm, tree_leaves, tree_map,
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
    metrics = tuple(metrics)
    loss_fn = checkpointed(loss_fn, resolve_remat_policy(remat_policy))
    on_mesh = mesh is not None
    if on_mesh:
        from torch.distributed.device_mesh import DeviceMesh

        from ..parallel.mesh_context import use_mesh
        from ..parallel.sharding import batch_sharding

        if not isinstance(mesh, DeviceMesh):
            raise TypeError("make_train_step: mesh must be a torch.distributed "
                            "DeviceMesh (parallel.build_mesh), got "
                            f"{type(mesh).__name__}")
        batch_sh = batch_sharding(mesh)

    def to_param_layout(grads):
        # the reduce-scatter: Partial gradients → the rules' placements
        return rules.constrain_tree(grads, mesh)

    def value_and_grad(params, tokens, targets):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            loss = loss_fn(tree_map(lambda _: next(it), params), tokens, targets)
            if on_mesh:
                loss = loss.redistribute(mesh, _replicated(mesh))
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def loss_and_grads(params, batch):
        tokens, targets = batch["tokens"], batch["targets"]
        if accum_steps == 1:
            loss, grads = value_and_grad(params, tokens, targets)
            return loss, (to_param_layout(grads) if on_mesh else grads)
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch={b} not divisible by "
                             f"accum_steps={accum_steps}")
        loss_sum = grad_sum = None
        for mt, my in zip(_microbatches(tokens, accum_steps, mesh),
                          _microbatches(targets, accum_steps, mesh)):
            loss, grads = value_and_grad(params, mt, my)
            if overlap_grads:
                # each microbatch's reduce-scatter here, inside the loop;
                # the accumulator is then one fsdp shard per rank
                grads = to_param_layout(grads)
            if grad_sum is None:
                # zeros in the first microbatch's layout: the params' with
                # overlap_grads; else replicated (zeros_like of a Partial)
                loss_sum = torch.zeros_like(loss, dtype=torch.float32)
                grad_sum = tree_map(
                    lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
            loss_sum += loss
            tree_map(lambda a, g: a.add_(g), grad_sum, grads)
            del grads
        inv = 1.0 / accum_steps
        grads = tree_map(lambda g: g.mul_(inv), grad_sum)
        if on_mesh and not overlap_grads:
            grads = to_param_layout(grads)
        return loss_sum * inv, grads

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(state.params, batch)
        m = {"step": _plain(state.step).clone()}
        if "loss" in metrics:
            m["loss"] = _plain(loss)
        if "grad_norm" in metrics:
            # an extra full-tree reduction — opt out via metrics=("loss",)
            m["grad_norm"] = _plain(global_norm(grads))
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                state.params, inplace=donate)
            del grads
            if donate:
                new_params = tree_map(lambda p, u: _assign(p, p + u.to(p.dtype)),
                                      state.params, updates)
                new_opt = tree_map(_assign, state.opt_state, new_opt)
                new_step = state.step.add_(1)
            else:
                new_params = tree_map(lambda p, u: p + u.to(p.dtype),
                                      state.params, updates)
                new_step = state.step + 1
            del updates
        return TrainState(new_params, new_opt, new_step), m

    step_hist = telemetry.train_metrics()["step_seconds"]

    if not on_mesh:
        def wrapper(state: TrainState, batch: Dict[str, torch.Tensor]):
            with telemetry.timed(step_hist, phase="compute"):
                return step(state, batch)

        wrapper.loss_and_grads = loss_and_grads  # type: ignore[attr-defined]
        return wrapper

    def place_batch(batch):
        from ..parallel.sharding import to_dtensor
        from torch.distributed.tensor import DTensor

        return {k: v if isinstance(v, DTensor) else
                to_dtensor(torch.as_tensor(v), mesh, batch_sh.placements)
                for k, v in batch.items()}

    def wrapper(state: TrainState, batch: Dict[str, torch.Tensor]):
        with telemetry.timed(step_hist, phase="compute"), use_mesh(mesh):
            return step(state, place_batch(batch))

    def grads_fn(params, batch):
        """The bare accumulation path, no optimizer: (loss, grads) in the
        layout the optimizer receives them."""
        with use_mesh(mesh):
            return loss_and_grads(params, place_batch(batch))

    def shard_state(state: TrainState) -> TrainState:
        """Lay a TrainState out on the mesh per the rules. Each rank cuts
        its block on the leaf's own device and moves only that block to
        the mesh's device; a leaf laid out otherwise is gathered first,
        and one already in its placements on this mesh is kept (a state
        built over params laid out by ``shard_pytree`` never holds a whole
        leaf). A block that is the whole leaf on the mesh's device (a
        world of 1) is the leaf itself, so the caller's state is then
        updated in place by a ``donate=True`` step, as JAX's donation
        consumes it."""
        from ..parallel.mesh import is_dtensor
        from ..parallel.sharding import to_dtensor

        param_sh = rules.tree_shardings(state.params, mesh)
        opt_sh = _opt_shardings(state.opt_state, state.params, param_sh, mesh)

        def place(x, placements):
            if is_dtensor(x):
                if x.device_mesh == mesh and list(x.placements) == list(placements):
                    return x
                x = x.full_tensor()
            return to_dtensor(x, mesh, placements)

        return TrainState(
            params=tree_map(lambda x, sh: place(x, sh.placements),
                            state.params, param_sh),
            opt_state=tree_map(lambda x, sh: place(x, sh.placements),
                               state.opt_state, opt_sh),
            step=place(state.step, _replicated(mesh)))

    wrapper.loss_and_grads = loss_and_grads  # type: ignore[attr-defined]
    wrapper.grads_fn = grads_fn  # type: ignore[attr-defined]
    wrapper.shard_state = shard_state  # type: ignore[attr-defined]
    wrapper.batch_sharding = batch_sh  # type: ignore[attr-defined]
    return wrapper


def _replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor's local value (the global one); a plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, _replicated(t.device_mesh)).to_local()
    return t


def _microbatches(x: torch.Tensor, n: int, mesh) -> list:
    """``x`` split into ``n`` microbatches along the batch dim. On a mesh,
    when every rank's local batch divides by ``n``, each microbatch is
    ``n``-th of every local batch (a DTensor with ``x``'s placements), so
    the split moves no data; JAX's reshape to (n, B/n, ...) takes
    contiguous global blocks instead, which hold other examples but give
    the same mean. When a local batch does not divide, the microbatches
    are JAX's contiguous blocks of a replicated copy (an all-gather of the
    batch), and the model then runs each one replicated over the batch
    axes (``models.common.constrain_hidden``)."""
    if mesh is None:
        return list(x.chunk(n))
    from torch.distributed.tensor import DTensor

    local, pl = x.to_local(), x.placements
    if local.shape[0] % n:
        full = x.redistribute(mesh, _replicated(mesh))
        m = x.shape[0] // n
        return [full[i * m:(i + 1) * m] for i in range(n)]
    shape = (x.shape[0] // n, *x.shape[1:])
    return [DTensor.from_local(c, mesh, pl, run_check=False, shape=shape,
                               stride=c.contiguous().stride())
            for c in local.chunk(n)]


def _same_structure(a: Any, b: Any) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return not isinstance(b, (dict, list, tuple))


def _opt_shardings(opt_state: Any, params: Any, param_shardings: Any, mesh):
    """Optimizer-state subtrees that mirror the param tree *structurally*
    (adam mu/nu) take the param shardings wholesale; other leaves (counts,
    schedule state) are replicated. Matching is by tree structure, not leaf
    shape: Llama's wq and wo can share a shape with transposed layouts."""
    from ..parallel.sharding import named_sharding

    replicated = named_sharding(mesh)

    def rec(node):
        if _same_structure(node, params):
            return param_shardings
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            children = [rec(c) for c in node]
            if hasattr(node, "_fields"):
                return type(node)(*children)
            return type(node)(children)
        return replicated

    return rec(opt_state)
