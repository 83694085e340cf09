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
  (:func:`scatter_patches_cuda`, ``csrc/coo_stem.cu``: a binning pass,
  :func:`bin_hits_cuda`, whose plain version is :func:`bin_hits_plain`, then
  the scatter over the output tiles of :func:`tile_plan`) on the card, or
  :func:`scatter_patches_plain` (``index_add_``) on the CPU;
* :func:`scatter_patches`, the custom op ``tcvn::coo_stem_scatter`` over
  the two scatters (the plain one for CPU tensors, K2 for CUDA tensors, a
  fake for ``torch.compile``), with its gradient registered: the per-(hit,
  tap) row gather of the output cotangent that the JAX package's
  ``_scatter_patches_bwd`` computes in XLA, in plain torch.  The binning
  pass alone is the op ``tcvn::coo_stem_bin`` (:func:`bin_hits`), for
  checking it.

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
# K2's tiles (csrc/coo_stem.cu): a thread keeps TILE_ROWS x CHANNEL_GROUP
# float32 sums in registers; a scatter block has at most THREADS threads.
TILE_ROWS = 4
CHANNEL_GROUP = 8
THREADS = 256
MAX_TILES_PER_IMAGE = 8192   # the binning's per-tile counts in shared memory

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
    lib.tcvn_coo_stem_bin.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    lib.tcvn_coo_stem_bin.restype = ctypes.c_int
    lib.tcvn_coo_stem_scatter.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
    lib.tcvn_coo_stem_scatter.restype = ctypes.c_int
    lib.tcvn_error_string.argtypes = [ctypes.c_int]
    lib.tcvn_error_string.restype = ctypes.c_char_p
    return lib


def tile_plan(out_h: int, out_w: int, channels: int) -> Tuple[int, int]:
    """K2's output tile: ``(tile_rows, tile_cols)``.

    Thread (column, group of 8 channels) keeps ``TILE_ROWS`` x 8 float32
    sums in registers, so a tile is ``TILE_ROWS`` rows by as many columns as
    ``THREADS`` threads cover with all channels (32 at C 64, 16 at C 128),
    at least 4 (a hit's 4 x 4 window then reaches at most 2 x 2 tiles)
    unless the tile spans the image's width.  The binning keeps a count per
    tile of an image in shared memory, so an image has at most
    ``MAX_TILES_PER_IMAGE``.
    """
    groups = -(-channels // CHANNEL_GROUP)
    cols = min(THREADS // groups, out_w)
    if cols < min(4, out_w):
        raise ValueError(
            f"coo stem kernel: {channels} channels exceed a block of {THREADS} "
            f"threads ({CHANNEL_GROUP} channels a thread, 4 columns)")
    tiles = -(-out_h // TILE_ROWS) * -(-out_w // cols)
    if tiles > MAX_TILES_PER_IMAGE:
        raise ValueError(
            f"coo stem kernel: {out_h}x{out_w} outputs make {tiles} tiles an image, "
            f"more than the binning holds ({MAX_TILES_PER_IMAGE})")
    return TILE_ROWS, cols


def _tiles(height, width, channels):
    """``(out_h, out_w, tile_cols, tiles per image)`` of :func:`tile_plan`."""
    out_h, out_w = out_shape(height, width)
    _, cols = tile_plan(out_h, out_w, channels)
    return out_h, out_w, cols, -(-out_h // TILE_ROWS) * -(-out_w // cols)


def _window_tiles(xy, out_h, out_w, height, width, tile_cols):
    """Tile (within the image) of each (hit, slot) pair, ``[R, 4]``, -1 where
    the hit is off the grid or its window reaches fewer tiles (slot ``s``:
    tile row ``+ s // 2``, tile column ``+ s % 2`` of the window's first)."""
    x, y = xy[:, 0].long(), xy[:, 1].long()
    ox0, oy0 = _window_origin(x), _window_origin(y)
    tiles_w = -(-out_w // tile_cols)
    tr_lo, tc_lo = ox0.clamp(min=0) // TILE_ROWS, oy0.clamp(min=0) // tile_cols
    tr_hi = (ox0 + 3).clamp(max=out_h - 1) // TILE_ROWS
    tc_hi = (oy0 + 3).clamp(max=out_w - 1) // tile_cols
    slot = torch.arange(4, device=xy.device)
    tr = tr_lo[:, None] + slot // 2
    tc = tc_lo[:, None] + slot % 2
    in_grid = (x >= 0) & (x < height) & (y >= 0) & (y < width)
    keep = (tr <= tr_hi[:, None]) & (tc <= tc_hi[:, None]) & in_grid[:, None]
    return torch.where(keep, tr * tiles_w + tc, -1)


def bin_hits_plain(
    xy: torch.Tensor,        # [R, 2] int
    starts: torch.Tensor,    # [N + 1] int CSR offsets, non-decreasing
    num_images: int,
    height: int,
    width: int,
    channels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's binning pass in plain torch: ``bins [N * tiles, 2]`` int32 (first
    entry, count) for each output tile of :func:`tile_plan`, and ``entries
    [4 R, 2]`` int32, each tile's list of (hit, window origin packed as
    ``(ox0 + 1) << 16 | (oy0 + 1)``) in bank order.  Image ``i``'s lists
    fill entries from ``4 * starts[i]`` on, in tile order; entries no list
    uses hold -1."""
    out_h, out_w, tile_cols, tiles = _tiles(height, width, channels)
    r = xy.shape[0]
    bounds = starts.long().clamp(0, r)
    row = torch.arange(r, device=xy.device)
    image = torch.searchsorted(bounds, row, right=True) - 1
    key = _window_tiles(xy, out_h, out_w, height, width, tile_cols)        # [R, 4]
    keep = (key >= 0) & ((image >= 0) & (image < num_images))[:, None]
    tile = (image[:, None] * tiles + key)[keep]                              # pairs in bank order
    hit = row[:, None].expand(r, 4)[keep]
    counts = torch.bincount(tile, minlength=num_images * tiles)
    first = (counts.reshape(num_images, tiles).cumsum(1) - counts.reshape(num_images, tiles)
             + 4 * bounds[:num_images, None]).reshape(-1)
    order = torch.sort(tile, stable=True).indices
    rank = torch.arange(tile.numel(), device=xy.device) - (counts.cumsum(0) - counts)[tile[order]]
    origin = ((_window_origin(xy[:, 0]) + 1) * 65536 + _window_origin(xy[:, 1]) + 1)
    entries = torch.full((4 * r, 2), -1, dtype=torch.int32, device=xy.device)
    hit = hit[order]
    entries[first[tile[order]] + rank] = torch.stack([hit, origin[hit]], 1).int()
    return torch.stack([first, counts], 1).int(), entries


def bin_hits_cuda(xy, starts, num_images, height, width, channels):
    """K2's binning pass alone on the card (:func:`bin_hits_plain`'s
    function; entries no list uses hold -1, as there), for checking it.
    Takes the wrapper's checked inputs."""
    if xy.device.type != "cuda":
        raise ValueError(f"coo stem binning needs CUDA tensors, got {xy.device}")
    _, _, tile_cols, tiles = _tiles(height, width, channels)
    bins = torch.empty((num_images * tiles, 2), dtype=torch.int32, device=xy.device)
    entries = torch.full((4 * xy.shape[0], 2), -1, dtype=torch.int32, device=xy.device)
    lib = _kernel()
    with torch.cuda.device(xy.device):
        err = lib.tcvn_coo_stem_bin(
            xy.data_ptr(), starts.data_ptr(), bins.data_ptr(), entries.data_ptr(),
            xy.shape[0], num_images, height, width, channels, tile_cols,
            torch.cuda.current_stream(xy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"coo stem binning launch failed: {lib.tcvn_error_string(err).decode()}")
    return bins, entries


def scatter_patches_cuda(
    patches: torch.Tensor,   # [R, 4, 4, C] float32, contiguous
    xy: torch.Tensor,        # [R, 2] int32, owner-sorted
    starts: torch.Tensor,    # [N + 1] int32 CSR offsets, non-decreasing
    bias: torch.Tensor,      # [C] float32
    num_images: int,
    height: int,
    width: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """K2 on the card: the stem output ``[N, out_h, out_w, C]`` in
    ``out_dtype``, summed in float32 in bank order, bias added, cast once.
    Two launches (binning, scatter) on the current stream; no synchronise."""
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
    if c % CHANNEL_GROUP == 0:        # the kernel's 16-byte loads
        for name, t in (("patches", patches), ("bias", bias)):
            if t.data_ptr() % 16:
                raise ValueError(f"coo stem kernel: {name} must be 16-byte aligned")

    out_h, out_w = out_shape(height, width)
    out = torch.empty((num_images, out_h, out_w, c), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    _, _, tile_cols, tiles = _tiles(height, width, c)
    # the binning's output: bins [N * tiles] and entries [4 R], pairs of int32
    scratch = torch.empty(2 * (num_images * tiles + 4 * r), dtype=torch.int32,
                          device=device)
    lib = _kernel()
    with torch.cuda.device(device):
        err = lib.tcvn_coo_stem_scatter(
            patches.data_ptr(), xy.data_ptr(), starts.data_ptr(), bias.data_ptr(),
            out.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 8 * num_images * tiles, _DTYPE_CODES[out_dtype], r,
            num_images, height, width, c, tile_cols,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"coo stem kernel launch failed: {lib.tcvn_error_string(err).decode()}")
    scatter_patches_cuda.launches += 1
    return out


# Launches of the kernel in this process; chip_smoke.py resets and reads it.
scatter_patches_cuda.launches = 0


def _bin_shapes(xy, num_images, height, width, channels):
    _, _, _, tiles = _tiles(height, width, channels)
    return (num_images * tiles, 2), (4 * xy.shape[0], 2)


@torch.library.custom_op(
    "tcvn::coo_stem_bin", mutates_args=(), device_types="cpu",
    schema="(Tensor xy, Tensor starts, int num_images, int height, int width, "
           "int channels) -> (Tensor, Tensor)")
def bin_hits(xy, starts, num_images, height, width, channels):
    """K2's binning pass as an op: :func:`bin_hits_plain` on the CPU,
    :func:`bin_hits_cuda` on the card."""
    return bin_hits_plain(xy, starts, num_images, height, width, channels)


@bin_hits.register_kernel("cuda")
def _bin_hits_kernel(xy, starts, num_images, height, width, channels):
    return bin_hits_cuda(xy, starts, num_images, height, width, channels)


@bin_hits.register_fake
def _bin_hits_fake(xy, starts, num_images, height, width, channels):
    bins, entries = _bin_shapes(xy, num_images, height, width, channels)
    return xy.new_empty(bins, dtype=torch.int32), xy.new_empty(entries, dtype=torch.int32)


@torch.library.custom_op(
    "tcvn::coo_stem_scatter", mutates_args=(), device_types="cpu",
    schema="(Tensor patches, Tensor bias, Tensor xy, Tensor starts, int num_images, "
           "int height, int width, ScalarType out_dtype) -> Tensor")
def scatter_patches(patches, bias, xy, starts, num_images, height, width, out_dtype):
    """The stem scatter ``[N, out_h, out_w, C]`` in ``out_dtype``:
    :func:`scatter_patches_plain` on the CPU, K2 (:func:`scatter_patches_cuda`)
    on the card.  Differentiable in ``patches`` and ``bias``."""
    return scatter_patches_plain(patches, xy, starts, bias, num_images, height, width,
                                 out_dtype)


@scatter_patches.register_kernel("cuda")
def _scatter_patches_kernel(patches, bias, xy, starts, num_images, height, width,
                            out_dtype):
    return scatter_patches_cuda(patches, xy, starts, bias, num_images, height, width,
                                out_dtype)


@scatter_patches.register_fake
def _scatter_patches_fake(patches, bias, xy, starts, num_images, height, width,
                          out_dtype):
    out_h, out_w = out_shape(height, width)
    return patches.new_empty((num_images, out_h, out_w, patches.shape[-1]),
                             dtype=out_dtype)


def _scatter_patches_setup(ctx, inputs, output):
    _, _, xy, starts, num_images, height, width, _ = inputs
    ctx.save_for_backward(xy, starts)
    ctx.geometry = (num_images, height, width)


def _scatter_patches_backward(ctx, grad_out):
    """Patch ``(g, a, b)`` went to exactly one output element row, so its
    cotangent is that row of the output cotangent (float32), zero for taps
    the forward dropped; the bias gets the cotangent summed over images and
    pixels."""
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


scatter_patches.register_autograd(_scatter_patches_backward,
                                  setup_context=_scatter_patches_setup)


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

    On CPU tensors :func:`scatter_patches` takes the plain scatter, so the
    tests reach this route's backward without a card.
    """
    patches = stem_patches(xy, values, kernel_weights, height, width)
    return scatter_patches(patches, bias, xy, starts, num_images, height, width,
                           values.dtype)
