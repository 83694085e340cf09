"""The compiled serving package: AOTInductor over the exported graphs.

The JAX package's C++ loader (``native/pjrt_loader.cc``) hands each
exported StableHLO graph to PJRT, which compiles it for its backend before
the first call.  AOTInductor is PyTorch's counterpart of that compile step,
done ahead of time: :func:`package_program` compiles one ``torch.export``
program of :mod:`.export` (``export.export_program``) into a package
(``.aoti.pt2``) of generated kernels and a C++ wrapper for one device type,
which Python (:func:`load_package`) and the port's C++ loader
(``csrc/aoti_loader.cpp``, built by ``utils.build.build_loader``) run with no
Python and one call an event.  Inductor's generated kernels inside a package
are Inductor's, not ports of a TPU kernel.

* Inductor runs without autotuning (``max_autotune`` off), and with a C++
  compiler that links OpenMP (:func:`inductor_compiler`).
* A package runs only on the device type it was compiled for: one for
  ``cuda`` does not load on the CPU, one for ``cpu`` does not run on the
  card.  The programs are packaged where they were exported.
* Each package carries the prong capacity it was traced at in its metadata
  (``prong_capacity``), which the C++ loader reads for an explicit package.

:func:`package_run_dir` packages the programs that ``export.export_run_dir``
wrote into ``<run_dir>/export`` (or another directory), one per variant and
rung, as ``{prefix}_{variant}[_pP].aoti.pt2`` beside the ``.pt2`` programs
(the full capacity unsuffixed, as :mod:`.export` names its programs), and
adds to ``{prefix}_export_meta.json``: ``aoti_prong_buckets``,
``aoti_variants``, ``aoti_platform`` and ``aoti_files``, and with ``bench``
``aoti_bucket_ms``, each packaged rung's per-event cost of its ``pid``
package on the same device (``export._time_bucket_ms``), and on the card
``aoti_graph_bucket_ms``, the same package captured as one CUDA graph
(``load_package(..., graph=True)``, the C++ loader's ``--graph``).
``bucket_ms`` stays what the eager programs measured.  The programs are
read back from their ``.pt2`` files (``torch.export.load``), which the
tests hold to give packages whose outputs equal those of the in-memory
programs' packages.

A package runs its generated kernels on the stream current at its call
(``run`` with no stream handle takes the current one), so a capture
records them.  Loaded for a graph it runs single-threaded
(``run_single_threaded``): the container's default run waits on and
records CUDA events around each call to share its model instances
between threads, which a capture cannot hold.

CLI: ``python -m dune_transformercvn_torch.export <run_dir> --aoti`` exports
and then packages.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

import torch

from .export import VARIANTS, _time_bucket_ms
from .train.loop import resolve_device
from .utils.graphs import EventGraph

AOTI_SUFFIX = ".aoti.pt2"
# no autotuning: every package builds within a smoke run's time
INDUCTOR_CONFIGS = {"max_autotune": False}


def _program_device(exported) -> torch.device:
    """The one device the program's weights and constants live on."""
    tensors = [t for t in (*exported.state_dict.values(), *exported.constants.values())
               if torch.is_tensor(t)]
    devices = {t.device.type for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"the program's tensors lie on {sorted(devices)}, not on one device")
    return tensors[0].device


def _example_inputs(exported, device: torch.device):
    """Zeros of the program's input shapes and dtypes (Inductor compiles for
    the shapes; ``export_program`` keeps no example inputs)."""
    user_inputs = set(exported.graph_signature.user_inputs)
    values = [n.meta["val"] for n in exported.graph.nodes
              if n.op == "placeholder" and n.name in user_inputs]
    return tuple(torch.zeros(v.shape, dtype=v.dtype, device=device) for v in values), {}


def inductor_compiler() -> str:
    """The C++ compiler Inductor builds a package's wrapper with, which it
    links with OpenMP: the first of ``$CXX`` and ``g++`` whose driver finds
    OpenMP's link spec (``-print-file-name=libgomp.spec`` names a file).
    The H100 host's ``$CXX`` has none, its ``g++`` has.  Raises when neither
    has."""
    for name in dict.fromkeys(filter(None, (os.environ.get("CXX"), "g++"))):
        path = shutil.which(name)
        if path is None:
            continue
        spec = subprocess.run([path, "-print-file-name=libgomp.spec"], capture_output=True,
                              text=True).stdout.strip()
        if os.path.isabs(spec) and os.path.exists(spec):
            return path
    raise RuntimeError("no C++ compiler that links OpenMP: neither $CXX nor g++ finds "
                       "libgomp.spec, which Inductor's package build needs")


def package_program(exported, path: str, device, prong_capacity: int | None = None) -> str:
    """Compile one ``ExportedProgram`` with AOTInductor for ``device`` into
    the package ``path`` (ending in ``.pt2``); returns the path.  The program
    must have been exported on a device of that type.  ``prong_capacity``
    goes into the package's metadata."""
    device = torch.device(device)
    on = _program_device(exported)
    if on.type != device.type:
        raise ValueError(f"the program was exported on {on}; it packages for {on.type}, "
                         f"not for {device.type}")
    if exported.example_inputs is None:
        exported.example_inputs = _example_inputs(exported, on)
    configs = {**INDUCTOR_CONFIGS, "cpp.cxx": (inductor_compiler(),)}
    if prong_capacity is not None:
        configs["aot_inductor.metadata"] = {"prong_capacity": str(int(prong_capacity))}
    with torch.no_grad():
        return torch._inductor.aoti_compile_and_package(
            exported, package_path=path, inductor_configs=configs)


def load_package(path: str, graph: bool = False):
    """A callable ``(pixels, num_prongs) -> list of outputs`` over the
    package at ``path`` (on the device type it was compiled for).
    ``graph``: on the card the package's run is captured at the first call
    as one CUDA graph and each call replays it (``utils.graphs.EventGraph``;
    the outputs returned are copies); on the CPU it runs uncaptured."""
    if not graph:
        return torch._inductor.aoti_load_package(path)
    package = torch._inductor.aoti_load_package(path, run_single_threaded=True)
    return EventGraph(package, f"{os.path.basename(path)} graph")


def package_run_dir(run_dir: str, output_dir: str | None = None, *,
                    variants: Sequence[str] = VARIANTS,
                    prong_buckets: Sequence[int] | None = None,
                    device=None, bench: bool = False,
                    prefix: str = "transformercvn") -> Dict[str, str]:
    """Package the exported programs of ``variants`` at the rungs
    ``prong_buckets`` (``None``: every rung of the export meta) for
    ``device`` (``None``: the card); returns ``{variant[_pP]: path}``.
    The programs are read from ``output_dir`` (default
    ``<run_dir>/export``), where the packages and the meta's new keys go.
    Prints each package's compile seconds."""
    device = resolve_device(device)
    out = output_dir or os.path.join(run_dir, "export")
    meta_path = os.path.join(out, f"{prefix}_export_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta["platforms"] != [device.type]:
        raise ValueError(f"the programs in {out} were exported for {meta['platforms']}; "
                         f"export them with --device {device.type} to package for it")
    ladder = [int(p) for p in meta["prong_buckets"]]
    buckets = ladder if prong_buckets is None else sorted({int(p) for p in prong_buckets})
    missing = [p for p in buckets if p not in ladder]
    if missing:
        raise ValueError(f"rungs {missing} were not exported (the ladder is {ladder})")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; from {VARIANTS}")
    max_prongs = int(meta["max_prongs"])

    paths: Dict[str, str] = {}
    files: Dict[str, Dict[str, str]] = {v: {} for v in variants}
    compile_s: Dict[str, float] = {}
    aoti_ms: Dict[str, float] = {}
    graph_ms: Dict[str, float] = {}
    for bucket in buckets:
        suffix = "" if bucket == max_prongs else f"_p{bucket}"
        for variant in variants:
            program = torch.export.load(
                os.path.join(out, meta["bucket_files"][variant][str(bucket)]))
            name = f"{prefix}_{variant}{suffix}{AOTI_SUFFIX}"
            t0 = time.perf_counter()
            path = package_program(program, os.path.join(out, name), device, bucket)
            compile_s[variant + suffix] = time.perf_counter() - t0
            print(f"packaged {name} for {device.type} in {compile_s[variant + suffix]:.2f} s")
            paths[variant + suffix] = path
            files[variant][str(bucket)] = name
            if bench and variant == "pid":
                pixels = torch.zeros([1 + bucket, *meta["input_shape"][1:]], device=device)
                n = torch.tensor(min(3, bucket), dtype=torch.int32, device=device)
                aoti_ms[str(bucket)] = _time_bucket_ms(load_package(path), pixels, n)
                if device.type == "cuda":
                    graph_ms[str(bucket)] = _time_bucket_ms(load_package(path, graph=True),
                                                            pixels, n)

    meta.update({"aoti_prong_buckets": buckets, "aoti_variants": list(variants),
                 "aoti_platform": device.type, "aoti_files": files,
                 "aoti_compile_s": compile_s})
    if aoti_ms:
        meta["aoti_bucket_ms"] = aoti_ms
    if graph_ms:
        meta["aoti_graph_bucket_ms"] = graph_ms
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    return paths
