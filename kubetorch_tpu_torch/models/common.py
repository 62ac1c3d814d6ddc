"""Shared model-family helpers."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Type, Union

import torch


def config_from_dict(cls: Type, d: Dict[str, Any]):
    """Build a config dataclass from a dict, ignoring unknown keys (wire
    metadata can carry extra fields; each family's config takes what it
    knows). One definition for every model family."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one. Never falls back quietly — no card and no explicit request raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


# Named remat policies, the JAX package's names (``kubetorch_tpu/models/
# common.py``), shared by the model's layer stack (``cfg.remat_policy``)
# and ``make_train_step(remat_policy=)``:
#
#   "none"              no rematerialization (autograd saves everything)
#   "dots"              save the outputs of the matrix products without
#                       batch dims (aten mm/addmm: every x @ W), recompute
#                       the rest: selective checkpointing, the counterpart
#                       of jax.checkpoint_policies.dots_with_no_batch_dims_saveable
#   "nothing_saveable"  recompute the whole region in the backward:
#                       torch.utils.checkpoint(use_reentrant=False)
#
# A callable passes through as a selective-checkpoint policy,
# ``policy(ctx, op, *args, **kwargs) -> CheckpointPolicy``.
REMAT_POLICY_NAMES = ("none", "dots", "nothing_saveable")


def dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep matrix products, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def nothing_saveable(ctx, op, *args, **kwargs):
    """Recompute everything. ``checkpointed`` runs it as a plain
    ``torch.utils.checkpoint``, which saves only the region's inputs."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(policy: Any) -> Optional[Callable]:
    """Name → selective-checkpoint policy; ``None`` means "don't remat"
    (callers skip the checkpoint wrap entirely). Raises on unknown names so
    a typo'd policy fails at build time, not as a silent save-everything."""
    if policy is None or policy == "none":
        return None
    if callable(policy):
        return policy
    table = {"dots": dots_saveable, "nothing_saveable": nothing_saveable}
    try:
        return table[policy]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown remat policy {policy!r}; expected one of "
            f"{REMAT_POLICY_NAMES} or a selective-checkpoint policy callable"
        ) from None


def checkpointed(fn: Callable, policy: Optional[Callable]) -> Callable:
    """``fn`` under a resolved remat policy: unchanged for None, a plain
    non-reentrant ``torch.utils.checkpoint`` for ``nothing_saveable``, a
    selective one otherwise. The backward re-runs ``fn``'s forward, kernels
    included (a kernel launched through ctypes is invisible to the
    dispatcher, so it always recomputes into fresh outputs)."""
    if policy is None:
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if policy is nothing_saveable:
        def run(*args):
            return checkpoint(fn, *args, use_reentrant=False)
    else:
        def context():
            return create_selective_checkpoint_contexts(policy)

        def run(*args):
            return checkpoint(fn, *args, use_reentrant=False, context_fn=context)
    return run
