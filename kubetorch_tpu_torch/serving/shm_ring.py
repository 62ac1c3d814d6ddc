"""Weight segments in shared memory for the warm template: the weight-segment
part of ``kubetorch_tpu/serving/shm_ring.py``.

The template (``serving/warm_template.py``) stages a model's weights into
ONE shared segment; every forked replica attaches it and materializes its
params with one memcpy per leaf and no pickle. Names (``kt-shm-<pid>-<tag>-
<uid>``), the manifest (segment name, the tree's skeleton, each leaf's
dtype, shape, offset and size, the whole segment's blake2b) and the hash
are the JAX package's, so a segment of fp32 or integer leaves that either
package staged attaches in the other. numpy has no bf16: a bf16 tensor is
staged as its bits in ``uint16``, as ``serving/host_view.py`` hands it
over, and a JAX segment's ``bfloat16`` leaf attaches as ``uint16`` bits.

The envelope rings of the JAX module (the server-to-worker hop) belong to
the fabric's worker, which the port does not carry.
"""

from __future__ import annotations

import hashlib
import os
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from ..exceptions import DataCorruptionError

_TUPLE_KEY = "__kt_tuple__"


def make_name(tag: str) -> str:
    """Unique, identifiable segment name: ``kt-shm-<pid>-<tag>-<uid>``.
    The pid and the fixed prefix make leak audits greppable in
    ``/dev/shm``."""
    return f"kt-shm-{os.getpid()}-{tag}-{uuid.uuid4().hex[:8]}"


def _host_dtype(name: str) -> np.dtype:
    """numpy's dtype for a manifest's dtype name; ``bfloat16`` (a JAX
    segment's) as its ``uint16`` bits."""
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def _u8_buffer(arr: np.ndarray) -> np.ndarray:
    """A uint8 view of an array's bytes (a copy when it is not
    contiguous, or when its dtype refuses a view)."""
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    try:
        return arr.reshape(-1).view(np.uint8)
    except (ValueError, TypeError):
        return np.frombuffer(arr.tobytes(), dtype=np.uint8)


def _flatten_weights(obj: Any, path: str, leaves: List) -> Any:
    """JSON-able skeleton of the params tree with leaves replaced by their
    index into ``leaves`` (appended in walk order). Tuples are tagged so
    the attach side rebuilds them exactly. A tensor leaf is staged as
    ``models.convert.leaf_to_numpy`` gives it (bf16 as ``uint16`` bits)."""
    if isinstance(obj, np.ndarray):
        leaves.append((path, obj))
        return len(leaves) - 1
    if type(obj).__module__.startswith("torch"):
        from ..models.convert import leaf_to_numpy
        leaves.append((path, leaf_to_numpy(obj)))
        return len(leaves) - 1
    if isinstance(obj, dict):
        return {str(k): _flatten_weights(v, f"{path}/{k}", leaves)
                for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [_flatten_weights(v, f"{path}/{i}", leaves)
                             for i, v in enumerate(obj)]}
    if isinstance(obj, list):
        return [_flatten_weights(v, f"{path}/{i}", leaves)
                for i, v in enumerate(obj)]
    raise TypeError(
        f"weight segment: unsupported leaf {type(obj).__name__} at {path!r}")


def _unflatten_weights(skel: Any, arrays: List) -> Any:
    if isinstance(skel, int):
        return arrays[skel]
    if isinstance(skel, dict):
        if _TUPLE_KEY in skel and len(skel) == 1:
            return tuple(_unflatten_weights(v, arrays)
                         for v in skel[_TUPLE_KEY])
        return {k: _unflatten_weights(v, arrays) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten_weights(v, arrays) for v in skel]
    raise TypeError(f"weight manifest: bad skeleton node {type(skel)}")


class WeightSegment:
    """A created weight segment. The CREATOR (the template) owns its
    lifetime: it holds the mapping for its whole life and unlinks on
    close. :func:`unlink_weight_segment` covers the crash path: a
    supervisor that outlives a SIGKILLed template removes the segment by
    its manifest's name, so kills leak nothing."""

    def __init__(self, shm, manifest: Dict, owner: bool):
        self.shm = shm
        self.manifest = manifest
        self.name = manifest["name"]
        self._owner = owner

    def close(self, unlink: Optional[bool] = None) -> None:
        do_unlink = self._owner if unlink is None else unlink
        try:
            self.shm.close()
        except Exception:  # noqa: BLE001 — idempotent teardown
            pass
        if do_unlink:
            try:
                self.shm.unlink()
            except Exception:  # noqa: BLE001 — already gone is fine
                pass

    def __del__(self):
        try:
            self.shm.close()
        except Exception:  # noqa: BLE001
            pass


def create_weight_segment(params: Any, tag: str = "weights") -> WeightSegment:
    """Stage a params tree (numpy or tensor leaves under dict/list/tuple
    containers) into one shared segment. Returns the owning
    :class:`WeightSegment`; its ``manifest`` (JSON-able) is all a forked
    replica needs to attach. numpy only: no torch op runs on a numpy
    tree."""
    from multiprocessing import shared_memory

    leaves: List = []
    skel = _flatten_weights(params, "", leaves)
    metas, offset = [], 0
    for path, arr in leaves:
        nbytes = int(arr.nbytes)
        metas.append({"path": path.lstrip("/"), "dtype": str(arr.dtype),
                      "shape": list(arr.shape), "offset": offset,
                      "nbytes": nbytes})
        offset += nbytes
    name = make_name(tag)
    shm = shared_memory.SharedMemory(name=name, create=True,
                                     size=max(offset, 1))
    buf = np.frombuffer(shm.buf, dtype=np.uint8)
    h = hashlib.blake2b(digest_size=16)
    for meta, (_, arr) in zip(metas, leaves):
        u8 = _u8_buffer(arr)
        buf[meta["offset"]:meta["offset"] + meta["nbytes"]] = u8
        h.update(u8)
    del buf                       # release the export before any close()
    manifest = {"name": name, "total_bytes": offset, "tree": skel,
                "leaves": metas, "blake2b": h.hexdigest()}
    return WeightSegment(shm, manifest, owner=True)


def attach_weight_segment(manifest: Dict, *, verify: bool = True) -> Any:
    """Materialize a params tree of numpy arrays from a weight segment:
    attach by name, verify the whole segment's blake2b (a corrupt segment
    raises :class:`DataCorruptionError` with ``source="shm"``, never wrong
    weights), then one memcpy per leaf into new arrays. The mapping is
    closed before returning: the tree owns its memory, so the template can
    die without invalidating it."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=manifest["name"])
    src = None
    try:
        src = np.frombuffer(shm.buf, dtype=np.uint8)
        total = int(manifest["total_bytes"])
        if verify:
            actual = hashlib.blake2b(src[:total], digest_size=16).hexdigest()
            if actual != manifest["blake2b"]:
                raise DataCorruptionError(
                    f"weight segment {manifest['name']} hash mismatch",
                    key=manifest["name"], expected=manifest["blake2b"],
                    actual=actual, source="shm")
        arrays = []
        for meta in manifest["leaves"]:
            arr = np.empty(meta["shape"], dtype=_host_dtype(meta["dtype"]))
            dst = arr.reshape(-1).view(np.uint8)
            dst[:] = src[meta["offset"]:meta["offset"] + meta["nbytes"]]
            arrays.append(arr)
        return _unflatten_weights(manifest["tree"], arrays)
    finally:
        src = None                # release the export before close()
        try:
            shm.close()
        except Exception:  # noqa: BLE001
            pass


def unlink_weight_segment(name: str) -> bool:
    """Best-effort unlink by name: the supervisor's cleanup for a
    SIGKILLed template (no destructor ran). Returns whether a segment was
    removed."""
    from multiprocessing import shared_memory

    try:
        shm = shared_memory.SharedMemory(name=name)
    except Exception:  # noqa: BLE001 — absent or unreadable: nothing to free
        return False
    try:
        shm.close()
    except Exception:  # noqa: BLE001
        pass
    try:
        shm.unlink()
        return True
    except Exception:  # noqa: BLE001
        return False
