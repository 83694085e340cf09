"""ctypes bindings of the port's host-side COO engine (``csrc/coo_engine.cpp``).

The library is built with the host's C++ compiler at first use
(:func:`.build.build_host`) into the gitignored ``build/``.  Its two entry
points keep the contracts of the JAX package's ``utils/native.py``:

* :func:`native_build_conv_maps`: the kernel maps of a COO convolution,
  the same arrays as :func:`..ops.coo_conv.build_conv_maps_numpy` (output
  sites in ascending ``(owner, x, y)`` order);
* :func:`native_gather_ranges`: the batched CSR gather of
  :meth:`..data.dataset.EventDataset.gather_events` for banks held in RAM.

There is no quiet fallback: a failed build raises with the compiler's
output.  The numpy paths stay as the plain versions, taken when a caller
asks for them or when the banks are not in RAM.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .build import load_library

_i64 = ctypes.POINTER(ctypes.c_int64)
_i32 = ctypes.POINTER(ctypes.c_int32)
_f32 = ctypes.POINTER(ctypes.c_float)
_lib = None


def library() -> ctypes.CDLL:
    """The engine, built and loaded on the first call."""
    global _lib
    if _lib is None:
        lib = load_library("coo_engine")
        lib.tcvn_build_conv_maps.restype = ctypes.c_int64
        lib.tcvn_build_conv_maps.argtypes = [
            _i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _i64, _i32, _i32, _i64]
        lib.tcvn_gather_ranges.restype = ctypes.c_int64
        lib.tcvn_gather_ranges.argtypes = [
            _i64, ctypes.c_int64, _i64, _f32, ctypes.c_int64, _i64, _f32, _i64]
        _lib = lib
    return _lib


def _ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def native_build_conv_maps(
    coords: np.ndarray, kernel: int, stride: int, height: int, width: int,
    pad_to: int = 0,
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """``(out_coords [M, 3], num_out, in_maps [k*k, L], out_maps [k*k, L])``
    of the unique sites ``coords`` ``[N, 3]`` (owner, x, y).  ``L`` is the
    largest pair count of an offset (at least 1, and at least ``pad_to``);
    padding pairs read input row ``N`` and write output row
    ``max(num_out, pad_to)``, both out of range."""
    coords = np.ascontiguousarray(coords, np.int64).reshape(-1, 3)
    n = len(coords)
    volume = kernel * kernel
    room = max(n * volume, 1)
    out_coords = np.empty((room, 3), np.int64)
    pair_in = np.empty(room, np.int32)
    pair_out = np.empty(room, np.int32)
    pair_counts = np.zeros(volume, np.int64)
    num_out = library().tcvn_build_conv_maps(
        _ptr(coords, ctypes.c_int64), n, kernel, stride, height, width,
        _ptr(out_coords, ctypes.c_int64), _ptr(pair_in, ctypes.c_int32),
        _ptr(pair_out, ctypes.c_int32), _ptr(pair_counts, ctypes.c_int64))
    if num_out < 0:
        raise ValueError(f"bad conv map arguments: kernel {kernel}, stride {stride}")

    length = max(int(pair_counts.max()), 1) if n else 1
    length = max(length, pad_to)
    in_maps = np.full((volume, length), n, np.int32)
    out_maps = np.full((volume, length), max(int(num_out), pad_to), np.int32)
    ends = np.cumsum(pair_counts)
    for j in range(volume):
        first, count = int(ends[j] - pair_counts[j]), int(pair_counts[j])
        in_maps[j, :count] = pair_in[first:first + count]
        out_maps[j, :count] = pair_out[first:first + count]
    return out_coords[:num_out].copy(), int(num_out), in_maps, out_maps


def native_gather_ranges(
    ranges: np.ndarray, coords: np.ndarray, values: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched CSR slicing of a COO bank held in RAM: ``(coords [R, 3] int64,
    values [R, C] float32, owner [R] int64)`` of the hits in ``ranges``
    ``[m, 2]`` (first, last), owner the row of the range."""
    ranges = np.ascontiguousarray(ranges, np.int64).reshape(-1, 2)
    coords = np.ascontiguousarray(coords, np.int64)
    values = np.ascontiguousarray(values, np.float32)
    if len(ranges) and (ranges.min() < 0 or (ranges[:, 1] < ranges[:, 0]).any()
                        or ranges.max() > min(len(coords), len(values))):
        raise ValueError(f"CSR ranges outside a bank of {len(coords)} hits")
    total = int((ranges[:, 1] - ranges[:, 0]).sum())
    c = values.shape[1]
    coords_out = np.empty((total, 3), np.int64)
    values_out = np.empty((total, c), np.float32)
    owner_out = np.empty(total, np.int64)
    copied = library().tcvn_gather_ranges(
        _ptr(ranges, ctypes.c_int64), len(ranges),
        _ptr(coords, ctypes.c_int64), _ptr(values, ctypes.c_float), c,
        _ptr(coords_out, ctypes.c_int64), _ptr(values_out, ctypes.c_float),
        _ptr(owner_out, ctypes.c_int64))
    if copied != total:
        raise RuntimeError(f"gather copied {copied} hits of {total}")
    return coords_out, values_out, owner_out
