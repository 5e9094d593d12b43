"""The port's kernel build cache (`ops/_build.py`), on the CPU: the
library's path is a hash of the source, of every header beside it and
of the nvcc flags, so an edit to any of them builds a new library and
nothing stale is loaded. No nvcc is needed: only paths are computed."""

from pathlib import Path

import pytest

from ggrmcp_tpu_torch.ops import _build
from tests import torch_threads  # noqa: F401


@pytest.fixture
def csrc(tmp_path: Path) -> Path:
    (tmp_path / "kern.cu").write_text('#include "util.cuh"\nint k;\n')
    (tmp_path / "util.cuh").write_text("#pragma once\nint u;\n")
    return tmp_path


def test_path_stays_put_when_nothing_changes(csrc):
    first = _build.library_path("kern", csrc)
    assert _build.library_path("kern", csrc) == first
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libkern-") and first.suffix == ".so"
    # Files that are no source or header of a library do not count.
    (csrc / "notes.txt").write_text("scratch")
    assert _build.library_path("kern", csrc) == first


def test_path_changes_when_a_header_changes(csrc):
    first = _build.library_path("kern", csrc)
    (csrc / "util.cuh").write_text("#pragma once\nint u2;\n")
    second = _build.library_path("kern", csrc)
    assert second != first
    (csrc / "util.cuh").write_text("#pragma once\nint u;\n")
    assert _build.library_path("kern", csrc) == first


def test_path_changes_when_a_header_is_added(csrc):
    first = _build.library_path("kern", csrc)
    (csrc / "extra.h").write_text("int e;\n")
    assert _build.library_path("kern", csrc) != first


def test_path_changes_when_the_source_changes(csrc):
    first = _build.library_path("kern", csrc)
    (csrc / "kern.cu").write_text('#include "util.cuh"\nint k2;\n')
    assert _build.library_path("kern", csrc) != first


@pytest.mark.parametrize(
    "extra", [("-lcuda",), ("-I/usr/local/cutlass/include",), ("-G",)]
)
def test_path_changes_when_the_flags_change(csrc, extra):
    first = _build.library_path("kern", csrc)
    flags = _build.NVCC_FLAGS + extra
    assert _build.library_path("kern", csrc, flags) != first
    assert _build.library_path("kern", csrc, _build.NVCC_FLAGS) == first


def test_the_real_kernel_sources_hash():
    """The package's own csrc: the FlashAttention library's path covers
    its header (hopper.cuh)."""
    headers = [p.name for p in _build.CSRC.iterdir()
               if p.suffix in _build.HEADER_SUFFIXES]
    assert "hopper.cuh" in headers
    assert _build.library_path("flash_attention").name.startswith(
        "libflash_attention-")
