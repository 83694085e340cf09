"""Build the port's native sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone into ``build/torch_kernels/lib<name>.so`` (no PyTorch headers,
so a build takes seconds), then loaded with :mod:`ctypes`.  A library is
rebuilt when its source is newer.  Each ``csrc/<name>.cpp`` is host code
(the COO engine of :mod:`.native`), compiled by the host's C++ compiler
(``$CXX``, else ``g++``) into ``build/torch_kernels/lib<name>-<key>.so``,
where the key hashes the source, the flags and the machine, so a library
built on another host is never loaded.  ``csrc/aoti_loader.cpp`` is the one
program among them: :func:`build_loader` links it against the installed
torch's libraries into ``build/torch_kernels/aoti_loader-<key>``.  A failed
build raises with the compiler's output.  Nothing is built when this module
is imported: :func:`load_library` builds on its first call, and
``chip_smoke.py`` builds each of :func:`sources`, :func:`host_sources` and
the loader up front.
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

# the AOTInductor package loader: a program, linked against libtorch
LOADER = "aoti_loader"

_loaded: Dict[str, ctypes.CDLL] = {}


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def host_sources():
    """Host library names: one per ``csrc/*.cpp`` but the loader."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cpp") if p.stem != LOADER)


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


def _compile(command, src: Path, lib: Path, link=()) -> str:
    """Run ``command + [-o tmp, src] + link`` and move the result to
    ``lib``; raise with the compiler's output if it fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*command, "-o", str(tmp), str(src), *link],
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


def _loader_flags():
    """Compile and link flags of the loader against the installed torch:
    its headers and libraries, its C++ ABI, an rpath to its libraries, and
    with a CUDA build of torch its CUDA libraries, kept with
    ``--no-as-needed`` (without them libtorch has no CUDA backend to run a
    ``cuda`` package on), the CUDA toolkit's headers and
    ``TCVN_LOADER_CUDA``, which compiles ``--graph`` in (its CUDA graph
    and streams are torch's: it calls no CUDA runtime function itself)."""
    import torch
    from torch.utils import cpp_extension

    compile_flags = ["-O2", "-std=c++17",
                     f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
                     *(f"-I{p}" for p in cpp_extension.include_paths())]
    lib_dirs = cpp_extension.library_paths()
    link = [*(f"-L{p}" for p in lib_dirs), *(f"-Wl,-rpath,{p}" for p in lib_dirs),
            "-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda:
        compile_flags += ["-DTCVN_LOADER_CUDA",
                          f"-I{os.path.join(cpp_extension.CUDA_HOME or '/usr/local/cuda', 'include')}"]
        link += ["-Wl,--no-as-needed", "-ltorch_cuda", "-lc10_cuda", "-Wl,--as-needed"]
    return compile_flags, link, torch.__version__


def build_loader(src_dir: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``<src_dir>/aoti_loader.cpp`` into a program with the host's
    C++ compiler (``$CXX``, else ``g++``) unless one of the same source,
    flags, torch and machine exists; return its path.  Raises with the
    compiler's output when the build fails."""
    src = Path(src_dir) / f"{LOADER}.cpp"
    compiler = os.environ.get("CXX", "g++")
    compile_flags, link, version = _loader_flags()
    key = hashlib.sha256(b"\0".join(
        [src.read_bytes(), " ".join((compiler, *compile_flags, *link, version)).encode(),
         " ".join(platform.uname()).encode()])).hexdigest()[:16]
    program = Path(build_dir) / f"{LOADER}-{key}"
    if not program.exists():
        _compile([compiler, *compile_flags], src, program, link)
    return program


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
