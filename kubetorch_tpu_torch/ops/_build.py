"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``kubetorch_tpu_torch/_build/`` under a name keyed by
a hash of the source, every header in ``csrc/`` (``*.cuh``, included with
``-I csrc``) and the flags, so an edited source or header rebuilds and an
unchanged one loads at once. The build runs at first use, never at import;
``load`` is the one entry, and callers that need several libraries at once
(``chip_smoke.py``) call it from several threads, one ``nvcc`` each. No
``nvcc`` or a failed build raises: there is no fallback. ``build`` is the
one path that compiles, and counts its ``nvcc`` runs on
``build.nvcc_runs``. ``install`` puts a library that the compile cache
(``serve/aot_cache.py``) handed over, its bytes already checked, where
``load`` finds it, so a pod that hits the cache loads with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def sources() -> list:
    """The names of every ``csrc/*.cu``, sorted: the libraries ``load``
    builds."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent builder of the
    # same source never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        with _lock:
            build.nvcc_runs += 1
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


build.nvcc_runs = 0


def install(name: str, data: bytes) -> Path:
    """Put ``data``, a library built from ``csrc/<name>.cu`` as it stands,
    at ``library_path(name)``, unless the file there holds those bytes
    already. Written to a private name, then renamed: a process that
    loaded the old file keeps its mapping, and no reader sees half a
    library."""
    out = library_path(name)
    if out.exists() and out.read_bytes() == data:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Callers declare ``argtypes``/``restype`` on what they use.
    Builds of different sources run concurrently; ``build`` renames a
    finished library into place, so a race on one source is harmless."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build(name)
    with _lock:
        lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib
