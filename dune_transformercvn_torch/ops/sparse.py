"""Sparse-grid engine: MinkowskiEngine semantics on a fixed grid by occupancy
masking.

Port of ``dune_transformercvn_tpu/ops/sparse.py``.  On the fixed 400x280
pixel grid every MinkowskiEngine op the reference's sparse families use is a
dense op plus an occupancy mask:

* a bias-free convolution with ``expand_coordinates``: unoccupied sites hold
  zeros, so a dense conv computes the sparse result; the output occupancy is
  the kernel's dilation of the input occupancy;
* BatchNorm over occupied sites: :class:`.masked.MaskedBatchNorm` with the
  occupancy as a per-site mask;
* average pooling: window sums of the features over window counts of the
  occupancy, on ME's stride map of the coordinates;
* global average pooling: a per-image mean over occupied sites.

Kernels follow ME: odd kernels are centred, even kernels anchor at the site
(pad ``(0, k - 1)``); the output site ``o`` of a stride-``s`` op sits at
input coordinate ``o * s``, and the stride map pads ``(0, -h % s)`` (ceil
mode).  Features are NHWC; convolutions and pools see an NCHW view of the
same memory.  Window counts are float32 sums, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from .densify import densify_images_plain


@dataclass
class SparseGrid:
    """Dense NHWC features and a bool occupancy over the same grid."""

    features: torch.Tensor   # [N, H, W, C]
    occupancy: torch.Tensor  # [N, H, W] bool

    @property
    def shape(self):
        return self.features.shape


def from_coo(xy, values, owner, num_images: int, height: int, width: int) -> SparseGrid:
    """A grid from a padded COO bank: duplicates add, out-of-range hits
    (padding) are dropped, and every kept hit occupies its site."""
    features = densify_images_plain(xy, values, owner, num_images, height, width)
    ones = values.new_ones((values.shape[0], 1))
    hits = densify_images_plain(xy, ones, owner, num_images, height, width)
    return SparseGrid(features, hits[..., 0] > 0)


def _padding(kernel: int) -> Tuple[int, int]:
    if kernel % 2 == 1:
        return (kernel // 2, kernel // 2)
    return (0, kernel - 1)  # even kernels anchor at the output site


def _window_sums(x, kernel: int, stride: int, pad: Tuple[int, int]):
    """Sums over ``kernel`` x ``kernel`` windows of NCHW ``x`` padded by
    ``pad`` (low, high) on both spatial axes with zeros."""
    lo, hi = pad
    return F.avg_pool2d(F.pad(x, (lo, hi, lo, hi)), kernel, stride, divisor_override=1)


def _window_counts(occupancy, kernel: int, stride: int):
    """Occupied inputs in each window, float32 ``[N, H', W']``."""
    counts = _window_sums(occupancy[:, None].float(), kernel, stride, _padding(kernel))
    return counts[:, 0]


def _dilate_occupancy(occupancy, kernel: int, stride: int):
    """Output occupancy = sites reachable from any occupied input."""
    return _window_counts(occupancy, kernel, stride) > 0


def _stride_map_occupancy(occupancy, stride: int):
    """ME's floor-division coordinate map: an output site is occupied iff any
    input of its ``stride`` x ``stride`` cell is; identity at stride 1."""
    if stride == 1:
        return occupancy
    _, h, w = occupancy.shape
    x = F.pad(occupancy[:, None].float(), (0, -w % stride, 0, -h % stride))
    return F.avg_pool2d(x, stride, stride, divisor_override=1)[:, 0] > 0


def sparse_conv(grid: SparseGrid, weight: torch.Tensor, stride: int = 1,
                expand_coordinates: bool = True, groups: int = 1) -> SparseGrid:
    """ME's bias-free generalized sparse convolution.  ``weight`` is torch's
    ``[C_out, C_in / groups, k, k]``; ``groups = C_in`` is ME's channelwise
    convolution."""
    k = weight.shape[-1]
    lo, hi = _padding(k)
    x = grid.features.permute(0, 3, 1, 2)
    if lo != hi:
        x, pad = F.pad(x, (lo, hi, lo, hi)), 0
    else:
        pad = lo
    out = F.conv2d(x, weight.to(x.dtype), None, stride, pad, 1, groups).permute(0, 2, 3, 1)
    if expand_coordinates:
        occupancy = _dilate_occupancy(grid.occupancy, k, stride)
    else:
        occupancy = _stride_map_occupancy(grid.occupancy, stride)
    return SparseGrid(out * occupancy[..., None].to(out.dtype), occupancy)


def sparse_avg_pool(grid: SparseGrid, kernel: int, stride: int) -> SparseGrid:
    """ME's average pooling: the mean over the occupied inputs of each window,
    on the stride map of the input coordinates (pooling never expands them,
    so for ``kernel != stride`` the output set is not the set of windows
    that touch an input)."""
    x = grid.features.permute(0, 3, 1, 2)
    sums = _window_sums(x, kernel, stride, _padding(kernel)).permute(0, 2, 3, 1)
    counts = _window_counts(grid.occupancy, kernel, stride)
    occupancy = _stride_map_occupancy(grid.occupancy, stride)
    out = sums / counts.clamp(min=1.0).to(sums.dtype)[..., None]
    return SparseGrid(out * occupancy[..., None].to(out.dtype), occupancy)


def sparse_global_avg_pool(grid: SparseGrid) -> torch.Tensor:
    """ME's global average pooling and condense: each image's mean over its
    occupied sites, ``[N, C]``."""
    w = grid.occupancy[..., None].to(grid.features.dtype)
    total = (grid.features * w).sum((1, 2))
    count = w.sum((1, 2)).clamp(min=1.0)
    return total / count
