"""Sparse stem conv7/2 on hit banks: kernel K2 (CUDA) and its plain version.

Port of ``dune_transformercvn_tpu/ops/pallas_coo_stem.py``.  With kernel 7,
stride 2 and padding 3 every hit ``(x, y)`` reaches a fixed 4x4 window of
output pixels, rows ``ox0 + a`` and columns ``oy0 + b`` (``a, b`` in 0..3)
with ``ox0 = floor((x - 2) / 2)``; the kernel tap that links them depends
only on the parity of the coordinate.  So the stem is

* :func:`stem_patches`: four parity-specific ``[C_in, 16 * C_out]`` products
  (plain ``torch.matmul``, as the JAX package leaves them to XLA) give every
  hit its ``[4, 4, C_out]`` float32 output patch, with taps that fall off the
  output and hits off the input grid zeroed;
* the scatter of the patches into the ``[N, out_h, out_w, C_out]`` grid, with
  the bias added and the cast to the compute dtype fused: kernel K2
  (:func:`scatter_patches_cuda`, ``csrc/coo_stem.cu``) on the card, or
  :func:`scatter_patches_plain` (``index_add_``) on the CPU;
* :class:`ScatterPatches`, the ``autograd.Function`` around the scatter.  Its
  backward is the per-(hit, tap) row gather of the output cotangent that the
  JAX package's ``_scatter_patches_bwd`` computes in XLA, in plain torch.

Image ``i`` owns bank rows ``[starts[i], starts[i+1])`` (the batcher's CSR
offsets, clamped to the bank); rows outside every range are never read and
get a zero cotangent.  Accumulation is float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

KERNEL, STRIDE, PADDING = 7, 2, 3
# K2's threads and shared memory: a block owns `band_rows` output rows of one
# image; see csrc/coo_stem.cu.
MAX_THREADS = 1024
MAX_BAND_ROWS = 4
SMEM_BYTES = 232448          # a block's shared-memory limit on sm_90
HIT_CHUNK = 1024             # hits staged in shared memory at a time

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def out_shape(height: int, width: int) -> Tuple[int, int]:
    """Output rows and columns of the 7x7/2 stem with padding 3."""
    return ((height + 2 * PADDING - KERNEL) // STRIDE + 1,
            (width + 2 * PADDING - KERNEL) // STRIDE + 1)


def _window_origin(coord: torch.Tensor) -> torch.Tensor:
    """``floor((coord - 2) / 2)``: the first output row/column a hit reaches."""
    return torch.div(coord.long() - 2, 2, rounding_mode="floor")


def stem_patches(
    xy: torch.Tensor,              # [R, 2] int hit coordinates
    values: torch.Tensor,          # [R, C_in] preprocessed hit features
    kernel_weights: torch.Tensor,  # [7, 7, C_in, C_out] HWIO
    height: int,
    width: int,
) -> torch.Tensor:
    """Each hit's float32 ``[4, 4, C_out]`` output patch, ``[R, 4, 4, C_out]``.

    Output row ``ox0 + a`` receives hit ``x`` through kernel row
    ``(5 + x % 2) - 2a`` (negative: no tap); the same holds for columns.
    The weights are rounded to ``values.dtype`` first and the products
    accumulate in float32, as the JAX package's stem does.
    """
    k, _, c_in, c_out = kernel_weights.shape
    if k != KERNEL:
        raise ValueError(f"stem_patches: want a 7x7 kernel, got {k}x{k}")
    out_h, out_w = out_shape(height, width)
    n = xy.shape[0]
    x, y = xy[:, 0].long(), xy[:, 1].long()
    ox0, oy0 = _window_origin(x), _window_origin(y)

    w32 = kernel_weights.to(values.dtype).float()
    zero = w32.new_zeros(c_in, c_out)
    offs = {p: [(5 + p) - 2 * a for a in range(4)] for p in (0, 1)}
    vals32 = values.float()
    patch = vals32.new_zeros(n, 16 * c_out)
    for px in (0, 1):
        for py in (0, 1):
            taps = torch.stack([
                torch.stack([w32[ax, by] if ax >= 0 and by >= 0 else zero
                             for by in offs[py]])
                for ax in offs[px]])                              # [4, 4, C_in, C_out]
            w_par = taps.permute(2, 0, 1, 3).reshape(c_in, 16 * c_out)
            sel = ((x % 2 == px) & (y % 2 == py)).float()
            patch = patch + (sel[:, None] * vals32) @ w_par
    patch = patch.reshape(n, 4, 4, c_out)

    a4 = torch.arange(4, device=xy.device)
    in_grid = (x >= 0) & (x < height) & (y >= 0) & (y < width)
    rows = ox0[:, None] + a4
    cols = oy0[:, None] + a4
    mask_a = (rows >= 0) & (rows < out_h)
    mask_b = (cols >= 0) & (cols < out_w)
    mask = mask_a[:, :, None] & mask_b[:, None, :] & in_grid[:, None, None]
    return patch * mask[..., None]


def tap_index(xy, starts, num_images, height, width):
    """Flat output row ``(image * out_h + ox) * out_w + oy`` of every
    (hit, tap), ``[R, 4, 4]``, and whether the forward adds it: the row lies
    in some image's CSR range, the hit on the input grid, the tap on the
    output."""
    out_h, out_w = out_shape(height, width)
    r = xy.shape[0]
    x, y = xy[:, 0].long(), xy[:, 1].long()
    bounds = starts.long().clamp(0, r)
    row = torch.arange(r, device=xy.device)
    image = torch.searchsorted(bounds, row, right=True) - 1
    covered = (image >= 0) & (image < num_images)
    in_grid = (x >= 0) & (x < height) & (y >= 0) & (y < width)
    a4 = torch.arange(4, device=xy.device)
    rows = _window_origin(x)[:, None] + a4
    cols = _window_origin(y)[:, None] + a4
    valid = (((rows >= 0) & (rows < out_h))[:, :, None]
             & ((cols >= 0) & (cols < out_w))[:, None, :]
             & (covered & in_grid)[:, None, None])
    flat = (image[:, None, None] * out_h + rows[:, :, None]) * out_w + cols[:, None, :]
    return torch.where(valid, flat, num_images * out_h * out_w), valid


def scatter_patches_plain(
    patches: torch.Tensor,   # [R, 4, 4, C] float32
    xy: torch.Tensor,        # [R, 2] int
    starts: torch.Tensor,    # [N + 1] int CSR offsets
    bias: torch.Tensor,      # [C]
    num_images: int,
    height: int,
    width: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """K2's function in plain torch: ``index_add_`` of every kept (hit, tap)
    patch row into a zeroed float32 grid, then the bias, then the cast."""
    out_h, out_w = out_shape(height, width)
    c = patches.shape[-1]
    flat, _ = tap_index(xy, starts, num_images, height, width)
    grid = patches.new_zeros((num_images * out_h * out_w + 1, c), dtype=torch.float32)
    grid.index_add_(0, flat.reshape(-1), patches.reshape(-1, c).float())
    grid = grid[:-1].reshape(num_images, out_h, out_w, c) + bias.float()
    return grid.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    from ..utils.build import load_library

    lib = load_library("coo_stem")
    fn = lib.tcvn_coo_stem_scatter
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tcvn_error_string.argtypes = [ctypes.c_int]
    lib.tcvn_error_string.restype = ctypes.c_char_p
    return lib


def band_rows(out_h: int, out_w: int, channels: int) -> int:
    """Output rows one K2 block owns: up to 4, as many as its threads (4 per
    row and channel) and its shared-memory tile allow."""
    rows = min(MAX_BAND_ROWS, out_h, MAX_THREADS // (4 * channels))
    while rows > 0 and rows * out_w * channels * 4 + 2 * HIT_CHUNK * 4 > SMEM_BYTES:
        rows -= 1
    if rows == 0:
        raise ValueError(
            f"coo stem kernel: one output row of {out_w} x {channels} float32 "
            "values does not fit a block")
    return rows


def scatter_patches_cuda(
    patches: torch.Tensor,   # [R, 4, 4, C] float32, contiguous
    xy: torch.Tensor,        # [R, 2] int32, owner-sorted
    starts: torch.Tensor,    # [N + 1] int32 CSR offsets
    bias: torch.Tensor,      # [C] float32
    num_images: int,
    height: int,
    width: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """K2 on the card: the stem output ``[N, out_h, out_w, C]`` in
    ``out_dtype``, summed in float32 in bank order, bias added, cast once.
    Launches on the current stream and does not synchronise."""
    device = patches.device
    if device.type != "cuda":
        raise ValueError(f"coo stem kernel needs CUDA tensors, got {device}")
    for name, t, dtype in (("xy", xy, torch.int32), ("starts", starts, torch.int32),
                           ("patches", patches, torch.float32),
                           ("bias", bias, torch.float32)):
        if t.device != device:
            raise ValueError(f"coo stem kernel: {name} on {t.device}, patches on {device}")
        if t.dtype != dtype:
            raise ValueError(f"coo stem kernel: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"coo stem kernel: {name} must be contiguous")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"coo stem kernel: unsupported output dtype {out_dtype}")
    r = patches.shape[0]
    c = patches.shape[-1]
    if patches.shape[1:3] != (4, 4) or xy.shape != (r, 2) or bias.shape != (c,):
        raise ValueError(
            f"coo stem kernel: want patches [R, 4, 4, C], xy [R, 2], bias [C]; got "
            f"{tuple(patches.shape)}, {tuple(xy.shape)}, {tuple(bias.shape)}")
    if starts.shape != (num_images + 1,):
        raise ValueError(
            f"coo stem kernel: starts must be [{num_images + 1}], got {tuple(starts.shape)}")
    if num_images > 65535:
        raise ValueError(f"coo stem kernel: {num_images} images exceed the grid")

    out_h, out_w = out_shape(height, width)
    out = torch.empty((num_images, out_h, out_w, c), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    rows = band_rows(out_h, out_w, c)
    lib = _kernel()
    with torch.cuda.device(device):
        err = lib.tcvn_coo_stem_scatter(
            patches.data_ptr(), xy.data_ptr(), starts.data_ptr(), bias.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[out_dtype], r, num_images, height, width,
            c, rows, HIT_CHUNK, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"coo stem kernel launch failed: {lib.tcvn_error_string(err).decode()}")
    scatter_patches_cuda.launches += 1
    return out


# Launches of the kernel in this process; chip_smoke.py resets and reads it.
scatter_patches_cuda.launches = 0


class ScatterPatches(torch.autograd.Function):
    """The stem scatter with the JAX package's hand-written VJP.

    Forward: K2 for CUDA tensors, :func:`scatter_patches_plain` for CPU
    tensors.  Backward: patch ``(g, a, b)`` went to exactly one output
    element row, so its cotangent is that row of the output cotangent
    (float32), zero for taps the forward dropped; the bias gets the
    cotangent summed over images and pixels.
    """

    @staticmethod
    def forward(ctx, patches, bias, xy, starts, num_images, height, width, out_dtype):
        scatter = (scatter_patches_plain if patches.device.type == "cpu"
                   else scatter_patches_cuda)
        out = scatter(patches, xy, starts, bias, num_images, height, width, out_dtype)
        ctx.save_for_backward(xy, starts)
        ctx.geometry = (num_images, height, width)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        xy, starts = ctx.saved_tensors
        num_images, height, width = ctx.geometry
        c = grad_out.shape[-1]
        d_patches = d_bias = None
        if ctx.needs_input_grad[0]:
            flat, valid = tap_index(xy, starts, num_images, height, width)
            rows = grad_out.reshape(-1, c)
            d_patches = rows[flat.clamp(max=rows.shape[0] - 1)].float()
            d_patches = d_patches * valid[..., None]
        if ctx.needs_input_grad[1]:
            d_bias = grad_out.sum((0, 1, 2), dtype=torch.float32)
        return d_patches, d_bias, None, None, None, None, None, None


def coo_stem_conv_cuda(
    xy: torch.Tensor,              # [R, 2] int (owner-sorted bank)
    values: torch.Tensor,          # [R, C_in]
    starts: torch.Tensor,          # [N + 1] CSR offsets
    kernel_weights: torch.Tensor,  # [7, 7, C_in, C_out] HWIO
    bias: torch.Tensor,            # [C_out]
    num_images: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """The kernel route of the sparse stem: patches, then K2 with the bias
    and the cast to ``values.dtype``.  ``[N, out_h, out_w, C_out]``.

    On CPU tensors :class:`ScatterPatches` takes the plain scatter, so the
    tests reach this route's backward without a card.
    """
    patches = stem_patches(xy, values, kernel_weights, height, width)
    return ScatterPatches.apply(patches, bias, xy, starts, num_images, height,
                                width, values.dtype)
