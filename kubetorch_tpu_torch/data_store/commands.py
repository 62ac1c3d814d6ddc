"""The store protocol of the port, and its copies of the content hashing
in ``kubetorch_tpu/data_store/commands.py``.

**The store protocol.** The port reaches no store by URL. Its checkpoint
(``train/checkpoint.py``) and weight rollout (``serve/rollout.py``) take a
``store`` argument: an object with the four calls of the JAX package's
``commands.py`` in their signatures there, less ``store_url``, and two
narrow fetches in place of its private ``_RoutedFetcher`` and
``_decode_array``:

- ``put(key, tree) -> dict``: store a pytree of numpy arrays (nested
  dicts and lists) as one key per leaf, ``key/<path>``, and its index,
  ``key + _INDEX_SUFFIX``, written last: ``{"leaves": {path: {"dtype",
  "shape", "kind": "array", "blake2b"}}, "structure": ...}``. A leaf whose
  key already holds the same bytes (the same blake2b) moves nothing.
  Returns ``{"leaves", "bytes" (moved), "skipped", "index_blake2b"}``,
  the last the blake2b-20 of the index's JSON bytes.
- ``get(key) -> tree``: the pytree of numpy arrays; raises when ``key``
  holds none.
- ``put_json(key, obj) -> dict``: one small JSON value, re-put in place
  (commit markers, rollout manifests).
- ``get_json(key, quorum=False, default=None)``: that value, ``default``
  when the key is absent; ``quorum=True`` reads every replica and takes
  the newest.
- ``get_index(key, expect_hash=None) -> dict | None``: the pytree index
  of ``key``, None when absent; given ``expect_hash``, the index's bytes
  must hash to it or the call raises.
- ``get_leaf(key, path, meta) -> np.ndarray | None``: one leaf, decoded
  to ``meta``'s dtype and shape, its bytes checked against
  ``meta["blake2b"]`` (raises on a mismatch); None when absent.

Every caller goes through :func:`require_store`: ``store=None`` raises
``TypeError``. There is no default store, where the JAX package's calls
fall back to the environment's store URL.

Leaf dtypes in an index are numpy's names. numpy has no bf16, so the port
hands a bf16 tensor to the host as its bits (``models.convert.
params_to_numpy``: ``uint16``), and a tree the port publishes records
``uint16`` where the JAX package's host trees, which carry ml_dtypes'
``bfloat16``, record ``bfloat16``. The bytes, and with them every leaf
hash and fingerprint, are the same.

**Copied** from ``kubetorch_tpu/data_store/commands.py``, under its names:
``_INDEX_SUFFIX``, ``_is_arraylike`` (which here also takes a torch
tensor), ``_flatten``, ``_structure_of``, ``_unflatten``, ``_leaf_buffer``,
``_leaf_hash`` and ``tree_fingerprint_of_hashes``. :func:`hash_leaves` is
the port's own: ``_leaf_hash`` over many leaves at once.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

from ..models.convert import leaf_to_numpy

_INDEX_SUFFIX = ".__kt_index__"


def require_store(store: Any) -> Any:
    """``store``, or ``TypeError`` when it is None (no default store)."""
    if store is None:
        raise TypeError(
            "store is required: an object with put/get/put_json/get_json/"
            "get_index/get_leaf (kubetorch_tpu_torch/data_store/commands.py); "
            "the port has no default store")
    return store


def _is_arraylike(obj: Any) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    return (type(obj).__module__.startswith("numpy")
            and hasattr(obj, "dtype") and hasattr(obj, "shape"))


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if _is_arraylike(tree):
        out[prefix or "value"] = tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}" if prefix else str(i), out)
        return
    raise TypeError(f"Unsupported leaf {type(tree).__name__} in pytree")


def _structure_of(tree: Any) -> Any:
    if _is_arraylike(tree):
        return "leaf"
    if isinstance(tree, dict):
        return {k: _structure_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure_of(v) for v in tree]
    raise TypeError(f"Unsupported node {type(tree).__name__}")


def _unflatten(structure: Any, prefix: str, leaves: Dict[str, Any]) -> Any:
    if structure == "leaf":
        return leaves[prefix or "value"]
    if isinstance(structure, dict):
        return {k: _unflatten(v, f"{prefix}/{k}" if prefix else str(k), leaves)
                for k, v in structure.items()}
    if isinstance(structure, list):
        return [_unflatten(v, f"{prefix}/{i}" if prefix else str(i), leaves)
                for i, v in enumerate(structure)]
    raise ValueError("corrupt pytree index")


def _leaf_buffer(host):
    """Zero-copy bytes-like view of a leaf's raw bytes. Reinterprets the
    buffer as uint8 first: numpy refuses to export buffers for extension
    dtypes (ml_dtypes bfloat16 raises ``ValueError: cannot include dtype
    in a buffer``), but a uint8 view of the same memory always exports.
    Falls back to a tobytes copy for non-contiguous or otherwise
    unviewable arrays."""
    if host.flags["C_CONTIGUOUS"]:
        try:
            return host.reshape(-1).view(np.uint8).data
        except (ValueError, TypeError):
            pass
    return host.tobytes()


def _leaf_hash(host) -> str:
    """blake2b-20 of the leaf's raw bytes — the content address the delta
    protocol diffs on."""
    return hashlib.blake2b(_leaf_buffer(host), digest_size=20).hexdigest()


def tree_fingerprint_of_hashes(leaf_hashes: Dict[str, str]) -> str:
    """Compose per-leaf content hashes into ONE pytree fingerprint:
    blake2b over the sorted (path, leaf-blake2b) pairs. The single
    definition every fingerprint comparer shares — a trainer's
    ``train.checkpoint.tree_fingerprint`` of its live state, a rollout
    manifest's claimed fingerprint, and a serving replica's ledger of
    already-verified leaf hashes (``serve/rollout.py``) are bit-comparable
    *because* they all compose through here."""
    h = hashlib.blake2b(digest_size=20)
    for path in sorted(leaf_hashes):
        h.update(path.encode())
        h.update(leaf_hashes[path].encode())
    return h.hexdigest()


def host_leaf(x: Any) -> np.ndarray:
    """A leaf as a C-contiguous host array: a tensor through
    ``leaf_to_numpy`` (a copy; bf16 as ``uint16`` bits), numpy as it is."""
    if isinstance(x, torch.Tensor):
        return leaf_to_numpy(x)
    return np.asarray(x, order="C")


def hash_leaves(leaves: Dict[str, Any]) -> Dict[str, str]:
    """``_leaf_hash`` of every leaf of a ``_flatten``ed tree, several at a
    time: hashlib drops the GIL on large buffers, so the threads add up.
    Device tensors reach the host inside the workers, on a side stream
    that first waits for the work queued so far, so a decode loop on the
    default stream runs on beside the copies; at most one leaf per worker
    is on the host at once."""
    side = None
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves.values()):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())

    def one(item):
        path, x = item
        if side is not None and isinstance(x, torch.Tensor) and x.is_cuda:
            with torch.cuda.stream(side):
                host = host_leaf(x)
        else:
            host = host_leaf(x)
        return path, _leaf_hash(host)

    workers = max(1, min(8, os.cpu_count() or 1, len(leaves)))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return dict(ex.map(one, leaves.items()))
