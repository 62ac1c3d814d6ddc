"""Input pipeline: host→device prefetch, the counterpart of
``kubetorch_tpu/train/data.py``.

A step that waits on its batch's host→device copy leaves the card idle.
``prefetch_to_device`` keeps a small ring of batches in flight: on CUDA
each batch is copied from pinned host memory with ``non_blocking=True``
on a side stream, and the stream that consumes the batch waits on that
copy's event before the batch is handed over, so batch N+1's transfer
overlaps batch N's step.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional

import torch

from ..models.common import resolve_device
from .optim import tree_map


def prefetch_to_device(iterator: Iterable[Any], size: int = 2,
                       sharding: Optional[Any] = None,
                       device=None) -> Iterator[Any]:
    """Yield the batches of ``iterator`` (trees of host tensors or numpy
    arrays) on ``device`` (``cuda`` unless the caller names one), in
    order, with ``size`` copies in flight beyond the batch being consumed.

    The copies are queued on a side stream; each yielded batch has made
    the current stream at the time it is yielded wait on its copy, and
    its tensors are recorded as used by that stream, so they stay valid
    however the consumer's step is scheduled. ``sharding`` (a mesh
    placement in the JAX package) raises: parallelism is not ported."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=...): parallelism is not ported "
            "(ROADMAP Queue A item 7); batches go to one device")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def to_device(batch):
        def leaf(x):
            t = torch.as_tensor(x)
            if not cuda:
                return t.to(device)
            if t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        if not cuda:
            return tree_map(leaf, batch), None
        with torch.cuda.stream(stream):
            out = tree_map(leaf, batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def hand_over(item):
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            tree_map(lambda t: t.record_stream(consumer), batch)
        return batch

    queue: collections.deque = collections.deque()
    for batch in iterator:
        queue.append(to_device(batch))
        if len(queue) > size:
            yield hand_over(queue.popleft())
    while queue:
        yield hand_over(queue.popleft())
