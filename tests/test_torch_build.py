"""How the port's CUDA libraries are keyed and built (``ops/_build.py``),
checked without ``nvcc``: a library's path is a hash of its source, every
header in ``csrc/`` and the flags, so an edited header rebuilds every
library instead of loading a stale one, and ``nvcc`` is given ``-I csrc``.
"""

import re
import shutil
import subprocess

import pytest

from kubetorch_tpu_torch.ops import _build

pytestmark = pytest.mark.level("unit")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return copy


def test_touching_a_header_changes_every_library_path(csrc_copy):
    names = ("flash_fwd", "flash_bwd", "decode_attention", "quant_matmul")
    before = {n: _build.library_path(n) for n in names}
    assert before == {n: _build.library_path(n) for n in names}   # stable
    header = csrc_copy / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)


def test_a_new_header_changes_the_path_and_a_source_only_its_own(csrc_copy):
    fwd, bwd = _build.library_path("flash_fwd"), _build.library_path("flash_bwd")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("flash_fwd") != fwd
    fwd, bwd = _build.library_path("flash_fwd"), _build.library_path("flash_bwd")
    src = csrc_copy / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("flash_fwd") != fwd
    assert _build.library_path("flash_bwd") == bwd


def test_build_passes_the_header_directory(csrc_copy, monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    path = _build.build("flash_fwd")
    assert path == _build.library_path("flash_fwd") and path.exists()
    (cmd,) = calls
    assert cmd[cmd.index("-I") + 1] == str(csrc_copy)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert _build.build("flash_fwd") == path and len(calls) == 1  # cached


def test_every_included_header_is_in_csrc():
    for src in _build.CSRC.glob("*.cu"):
        for header in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (_build.CSRC / header).is_file(), (src.name, header)
