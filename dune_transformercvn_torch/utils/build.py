"""Build the port's native sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone into ``build/torch_kernels/lib<name>.so`` (no PyTorch headers,
so a build takes seconds), then loaded with :mod:`ctypes`.  A library is
rebuilt when its source is newer.  Each ``csrc/<name>.cpp`` is host code
(the COO engine of :mod:`.native`), compiled by the host's C++ compiler
(``$CXX``, else ``g++``) into ``build/torch_kernels/lib<name>-<key>.so``,
where the key hashes the source, the flags and the machine, so a library
built on another host is never loaded.  A failed build raises with the
compiler's output.  Nothing is built when this module is imported:
:func:`load_library` builds on its first call, and ``chip_smoke.py`` builds
each of :func:`sources` up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills per kernel
)

HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def host_sources():
    """Host library names: one per ``csrc/*.cpp``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cpp"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source on the GPU host"
        )
    return nvcc


def _compile(command, src: Path, lib: Path) -> str:
    """Run ``command + [-o tmp, src]`` and move the result to ``lib``;
    raise with the compiler's output if it fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*command, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{command[0]} could not run on {src}: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(command[0]).name} failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)   # atomic: a reader never sees a half-written .so
    return proc.stdout + proc.stderr


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is up to date; return
    what the compiler printed (``ptxas`` resource usage), or "" if skipped."""
    src = CSRC_DIR / f"{name}.cu"
    lib = library_path(name)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return ""
    return _compile([_nvcc(), *NVCC_FLAGS], src, lib)


def build_host(name: str, src_dir: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``<src_dir>/<name>.cpp`` with the host's C++ compiler unless
    a library of the same source, flags and machine exists; return its path."""
    src = Path(src_dir) / f"{name}.cpp"
    compiler = os.environ.get("CXX", "g++")
    key = hashlib.sha256(b"\0".join(
        [src.read_bytes(), " ".join((compiler, *HOST_FLAGS)).encode(),
         " ".join(platform.uname()).encode()])).hexdigest()[:16]
    lib = Path(build_dir) / f"lib{name}-{key}.so"
    if not lib.exists():
        _compile([compiler, *HOST_FLAGS], src, lib)
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (``csrc/<name>.cu``) or host
    library ``name`` (``csrc/<name>.cpp``), built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if (CSRC_DIR / f"{name}.cpp").exists():
            path = build_host(name)
        else:
            build(name)
            path = library_path(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
