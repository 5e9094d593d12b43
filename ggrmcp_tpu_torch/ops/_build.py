"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source has a plain C interface and is compiled by
`nvcc` into a shared library under `build/kernels/` at the root of the
checkout (git-ignored), then loaded with ctypes. The library's file
name carries a hash of the source, of every header under `csrc/` (what
a source may include) and of the flags (include and link flags among
them), so an edited source or header is rebuilt and a stale library is
never loaded. Nothing here runs at import time: the first wrapper call
on a CUDA tensor builds. Every library loaded is reported to
`listeners` (the serving compile watcher): built by nvcc (a cache
miss) or found under its hash (a hit), with the seconds it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HEADER_SUFFIXES = (".cuh", ".h")  # what a csrc source may include
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# What nvcc printed for each library loaded in this process (ptxas
# resource usage), kept beside the library as `<library>.log`.
build_log: dict[str, str] = {}
# Called as listener(name, seconds, hit) once per library loaded in this
# process: `hit` when it was found under its hash, not built.
listeners: list[Callable[[str, float, bool], None]] = []


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels are "
        "built from ggrmcp_tpu_torch/ops/csrc at first use"
    )


def library_path(
    name: str, csrc: Path = CSRC, flags: tuple[str, ...] = NVCC_FLAGS
) -> Path:
    """Where `<csrc>/<name>.cu` builds to for the current source, headers
    and flags."""
    digest = hashlib.sha256()
    headers = sorted(p for p in csrc.iterdir() if p.suffix in HEADER_SUFFIXES)
    for path in (csrc / f"{name}.cu", *headers):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update("\0".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless the matching library exists.
    The output is written under a temporary name and renamed, so a
    concurrent or interrupted build never leaves a torn library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    build_log[name] = proc.stdout + proc.stderr
    _log_path(out).write_text(build_log[name])  # before the library shows
    os.replace(tmp, out)
    return out


def _log_path(library: Path) -> Path:
    return library.with_name(f"{library.name}.log")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            t0 = time.perf_counter()
            hit = library_path(name).exists()
            path = build(name)
            if name not in build_log and _log_path(path).exists():
                build_log[name] = _log_path(path).read_text()
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
            secs = time.perf_counter() - t0
            for listener in list(listeners):
                listener(name, secs, hit)
        return lib
