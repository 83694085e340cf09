"""COO→dense image build: kernel K1 (CUDA) and its plain PyTorch version.

:func:`densify_images_cuda` launches ``csrc/densify.cu``, the port of the
Pallas TPU kernel ``dune_transformercvn_tpu/ops/pallas_densify.py``: it reads
the owner-sorted hit bank through its CSR ``starts``.  The source's header
says what bounds it on the card and how its tiles are laid out.

:func:`densify_images_plain` is the accumulating ``index_put_`` form of the
XLA scatter in ``dune_transformercvn_tpu/ops/scatter.py``: it reads the
per-hit ``owner`` column and needs no ordering.  It serves CPU tensors, the
tests, and the on-card comparison in ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

# fp32 accumulators in one block's shared-memory tile (48 KB); the kernel
# refuses larger tiles.
TILE_FLOATS = 12288

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def tile_shape(out_h: int, out_w: int, out_c: int) -> Tuple[int, int]:
    """(rows, columns) of output one block owns: whole rows where a row
    fits in the tile, else a band of columns of a single row."""
    if out_c > TILE_FLOATS:
        raise ValueError(
            f"densify kernel: {out_c} output channels exceed one tile "
            f"({TILE_FLOATS} fp32 values)"
        )
    row = out_w * out_c
    if row <= TILE_FLOATS:
        return min(out_h, TILE_FLOATS // row), out_w
    return 1, TILE_FLOATS // out_c


def densify_images_plain(
    xy: torch.Tensor,       # [R, 2] integer pixel coordinates
    values: torch.Tensor,   # [R, C]
    owner: torch.Tensor,    # [R] image index; out of range = padding
    num_images: int,
    height: int,
    width: int,
    space_to_depth: bool = False,
) -> torch.Tensor:
    """Scatter-add hits into NHWC ``[N, H, W, C]`` (or the s2d layout).

    Drop mode as in the JAX package: a hit whose owner, x or y is out of
    range, negative included, is dropped (torch indexing would wrap a
    negative index, so dropped hits go to a spare row that is cut off).
    """
    n, h, w, c = num_images, height, width, values.shape[-1]
    x, y, owner = xy[:, 0].long(), xy[:, 1].long(), owner.long()
    keep = ((owner >= 0) & (owner < n) & (x >= 0) & (x < h)
            & (y >= 0) & (y < w))
    flat = torch.where(keep, (owner * h + x) * w + y, n * h * w)
    images = values.new_zeros((n * h * w + 1, c))
    images.index_put_((flat,), values, accumulate=True)
    images = images[:-1].reshape(n, h, w, c)
    if space_to_depth:
        images = (
            images.reshape(n, h // 2, 2, w // 2, 2, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4 * c)
        )
    return images


@functools.lru_cache(maxsize=None)
def _kernel():
    from ..utils.build import load_library

    lib = load_library("densify")
    fn = lib.tcvn_densify
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tcvn_error_string.argtypes = [ctypes.c_int]
    lib.tcvn_error_string.restype = ctypes.c_char_p
    return lib


def densify_images_cuda(
    xy: torch.Tensor,       # [R, 2] int32, owner-sorted
    values: torch.Tensor,   # [R, C] float32 / bfloat16
    starts: torch.Tensor,   # [N + 1] int32 CSR offsets into the bank
    num_images: int,
    height: int,
    width: int,
    space_to_depth: bool = False,
) -> torch.Tensor:
    """K1 on the card: dense images in ``values.dtype`` from a sorted bank.

    Image ``i`` reads bank rows ``[starts[i], starts[i+1])`` only; duplicate
    pixels accumulate in bank order in the output dtype; out-of-range
    coordinates are dropped.  Launches on the current stream and does not
    synchronise.
    """
    device = values.device
    if device.type != "cuda":
        raise ValueError(f"densify kernel needs CUDA tensors, got {device}")
    for name, t in (("xy", xy), ("starts", starts)):
        if t.device != device:
            raise ValueError(f"densify kernel: {name} on {t.device}, values on {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"densify kernel: {name} must be int32, got {t.dtype}")
    if values.dtype not in _DTYPE_CODES:
        raise ValueError(f"densify kernel: unsupported values dtype {values.dtype}")
    if xy.ndim != 2 or xy.shape[1] != 2 or values.ndim != 2:
        raise ValueError(
            f"densify kernel: want xy [R, 2] and values [R, C], got "
            f"{tuple(xy.shape)} and {tuple(values.shape)}")
    if xy.shape[0] != values.shape[0]:
        raise ValueError("densify kernel: xy and values differ in hit count")
    if starts.shape != (num_images + 1,):
        raise ValueError(
            f"densify kernel: starts must be [{num_images + 1}], got "
            f"{tuple(starts.shape)}")
    if not (xy.is_contiguous() and values.is_contiguous() and starts.is_contiguous()):
        raise ValueError("densify kernel: inputs must be contiguous")
    if space_to_depth and (height % 2 or width % 2):
        raise ValueError(f"space_to_depth needs even H, W; got {height}x{width}")
    if num_images > 65535:
        raise ValueError(f"densify kernel: {num_images} images exceed the grid")

    c = values.shape[1]
    shape = ((num_images, height // 2, width // 2, 4 * c) if space_to_depth
             else (num_images, height, width, c))
    out = torch.empty(shape, dtype=values.dtype, device=device)
    if out.numel() == 0:
        return out
    tile_rows, tile_cols = tile_shape(*shape[1:])
    lib = _kernel()
    with torch.cuda.device(device):
        err = lib.tcvn_densify(
            xy.data_ptr(), values.data_ptr(), starts.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[values.dtype], xy.shape[0], num_images, height, width,
            c, int(space_to_depth), tile_rows, tile_cols,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"densify kernel launch failed: {lib.tcvn_error_string(err).decode()}")
    densify_images_cuda.launches += 1
    return out


# Launches of the kernel in this process; chip_smoke.py resets and reads it.
densify_images_cuda.launches = 0
