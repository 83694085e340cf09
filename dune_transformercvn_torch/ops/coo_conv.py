"""COO convolutions: the general gather-matmul-scatter with host-built kernel
maps, and the sparse stem straight from hit banks into a dense grid.

Port of ``dune_transformercvn_tpu/ops/coo_conv.py``.

**General convolution** (MinkowskiEngine's execution strategy, for the
low-occupancy regime and as a cross-check of the occupancy-masked engine of
``ops.sparse``; the two agree on the same weights).  On the host,
:func:`build_conv_maps` enumerates the kernel-dilated output sites and, for
each of the k*k offsets, the (input row, output row) pairs it connects, with
the native engine (:func:`..utils.native.native_build_conv_maps`);
:func:`build_conv_maps_numpy` is its plain version and gives the same
arrays (output sites in ``np.unique`` order).  On the device,
:func:`coo_conv_apply` gathers every offset's input rows, multiplies them by
the offset's weights in one batched product and adds the products into the
output rows with one ``index_add``.  The JAX package runs this as an XLA
loop, not a Pallas kernel, so the port uses PyTorch's ops on any device.

**Sparse stem.**  Because convolution is linear in its input,
``conv(densify(hits))`` is the sum over hits of each hit's contribution, so
the work scales with hits instead of pixels.  CUDA tensors that come with
the batcher's CSR ``starts`` and the 7x7/2/3 geometry go to kernel K2
(:func:`.coo_stem.coo_stem_conv_cuda`), the same static choice the JAX
package makes; any other CUDA call raises.  CPU tensors take the plain
path, :func:`coo_stem_conv_plain`: one ``[R, C_in] x [C_in, k*k*C_out]``
product and one ``index_add_`` of the contributions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.native import native_build_conv_maps
from .coo_stem import KERNEL, PADDING, STRIDE, coo_stem_conv_cuda


class ConvMaps(NamedTuple):
    out_coords: np.ndarray   # [M, 3] (owner, x, y) of the output sites
    num_out: int             # real output sites
    in_maps: np.ndarray      # [k*k, L] input row per pair (padding: N_in)
    out_maps: np.ndarray     # [k*k, L] output row per pair (padding: max(M, pad_to))


def _pack_key(owner: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    # grids are 400x280; 2^20 per axis is comfortably collision-free
    return (owner.astype(np.int64) << 40) | (x.astype(np.int64) << 20) | y.astype(np.int64)


def build_conv_maps_numpy(
    coords: np.ndarray,   # [N, 3] int (owner, x, y), unique sites
    kernel: int,
    stride: int,
    height: int,
    width: int,
    pad_to: int = 0,
) -> ConvMaps:
    """The plain kernel-map builder.  Input ``i`` feeds output
    ``i + lo - j`` through weight index ``j`` (``lo = k // 2`` for odd
    kernels, 0 for even ones); at stride ``s`` only outputs on multiples of
    ``s`` exist and are numbered ``o // s``.  Each offset's pairs run in
    input order; the maps are padded to the largest pair count (at least 1,
    at least ``pad_to``), padding pairs pointing past both ends."""
    owner, x, y = coords[:, 0], coords[:, 1], coords[:, 2]
    lo = kernel // 2 if kernel % 2 == 1 else 0
    volume = kernel * kernel
    in_rows = np.arange(len(coords))
    keys, rows, offsets = [], [], []
    for j in range(volume):
        ox, oy = x + lo - j // kernel, y + lo - j % kernel
        valid = (ox >= 0) & (ox < height) & (oy >= 0) & (oy < width)
        if stride > 1:
            valid &= (ox % stride == 0) & (oy % stride == 0)
        keys.append(_pack_key(owner[valid], ox[valid], oy[valid]))
        rows.append(in_rows[valid])
        offsets.append(np.full(int(valid.sum()), j, np.int64))
    keys, all_in, all_off = (np.concatenate(a) for a in (keys, rows, offsets))

    unique_keys, inverse = np.unique(keys, return_inverse=True)
    num_out = len(unique_keys)
    out_coords = np.stack(
        [unique_keys >> 40, (unique_keys >> 20) & 0xFFFFF, unique_keys & 0xFFFFF],
        axis=1).astype(np.int64)
    out_coords[:, 1:] //= stride

    counts = np.bincount(all_off, minlength=volume)
    length = max(int(counts.max()) if len(all_off) else 1, pad_to)
    in_maps = np.full((volume, length), len(coords), np.int32)
    out_maps = np.full((volume, length), max(num_out, pad_to), np.int32)
    for j in range(volume):
        sel = all_off == j
        in_maps[j, :counts[j]] = all_in[sel]
        out_maps[j, :counts[j]] = inverse[sel]
    return ConvMaps(out_coords, num_out, in_maps, out_maps)


def build_conv_maps(coords, kernel: int, stride: int, height: int, width: int,
                    pad_to: int = 0) -> ConvMaps:
    """The kernel maps from the native engine: the arrays of
    :func:`build_conv_maps_numpy`."""
    return ConvMaps(*native_build_conv_maps(coords, kernel, stride, height, width, pad_to))


def coo_conv_apply(
    features: torch.Tensor,        # [N, C_in]
    kernel_weights: torch.Tensor,  # [k, k, C_in, C_out] HWIO
    in_maps: torch.Tensor,         # [k*k, L] int
    out_maps: torch.Tensor,        # [k*k, L] int
    num_out: int,
) -> torch.Tensor:
    """``out[out_maps[j]] += features[in_maps[j]] @ W[j]`` over the k*k
    offsets, ``[num_out, C_out]`` in ``features.dtype``.  Padding pairs
    gather a zero row (``in_maps >= N``) and add into a sink row that is
    dropped (``out_maps >= num_out``).  Differentiable in ``features`` and
    ``kernel_weights``."""
    k, c_in, c_out = kernel_weights.shape[0], kernel_weights.shape[2], kernel_weights.shape[3]
    n = features.shape[0]
    w = kernel_weights.reshape(k * k, c_in, c_out).to(features.dtype)
    padded = torch.cat([features, features.new_zeros((1, c_in))])
    rows = in_maps.long().clamp(0, n)
    contrib = torch.bmm(padded[rows], w)                       # [k*k, L, C_out]
    sink = out_maps.long().clamp(max=num_out).reshape(-1)
    out = features.new_zeros((num_out + 1, c_out))
    out = out.index_add(0, sink, contrib.reshape(-1, c_out))
    return out[:num_out]


def coo_stem_conv(
    xy: torch.Tensor,              # [R, 2] int hit coordinates (pad rows: any)
    values: torch.Tensor,          # [R, C_in] preprocessed hit features
    owner: torch.Tensor,           # [R] owning image row (pad rows: >= batch)
    kernel_weights: torch.Tensor,  # [k, k, C_in, C_out] HWIO
    bias: torch.Tensor,            # [C_out]
    batch: int,
    height: int,
    width: int,
    stride: int = 2,
    padding: int = 3,
    starts: Optional[torch.Tensor] = None,   # [batch + 1] CSR offsets
) -> torch.Tensor:
    """Sparse-input strided convolution into ``[batch, out_h, out_w, C_out]``
    in ``values.dtype``, accumulated in float32, bias added before the cast.

    Drop mode as in the JAX package: a hit off the input grid, a tap that
    lands outside the output, and an owner ``< 0`` or ``>= batch`` add
    nothing.
    """
    k = kernel_weights.shape[0]
    if values.device.type != "cpu":
        if starts is None or (k, stride, padding) != (KERNEL, STRIDE, PADDING):
            raise ValueError(
                "coo_stem_conv on the GPU runs kernel K2, which needs the bank's "
                "CSR `starts` and the 7x7 stride-2 padding-3 stem; got "
                f"starts={'set' if starts is not None else None}, k={k}, "
                f"stride={stride}, padding={padding}")
        return coo_stem_conv_cuda(xy, values, starts, kernel_weights, bias,
                                  batch, height, width)
    return coo_stem_conv_plain(xy, values, owner, kernel_weights, bias, batch,
                               height, width, stride, padding)


def coo_stem_conv_plain(xy, values, owner, kernel_weights, bias, batch: int,
                        height: int, width: int, stride: int = 2, padding: int = 3):
    """The plain path of :func:`coo_stem_conv`, on any device: the CPU's
    path, and the reference ``chip_smoke.py`` holds the kernel route to."""
    k = kernel_weights.shape[0]
    c_in, c_out = kernel_weights.shape[2], kernel_weights.shape[3]
    n = xy.shape[0]
    out_h = (height + 2 * padding - k) // stride + 1
    out_w = (width + 2 * padding - k) // stride + 1

    # [C_in, k*k*C_out]: one product gives every offset's contribution
    w = kernel_weights.to(values.dtype).permute(2, 0, 1, 3).reshape(c_in, k * k * c_out)
    contrib = (values.float() @ w.float()).reshape(n * k * k, c_out)

    # output pixel of (hit, offset): (coord + padding - offset) / stride
    offs = torch.arange(k, device=xy.device)
    num_x = xy[:, 0:1].long() + padding - offs            # [R, k]
    num_y = xy[:, 1:2].long() + padding - offs
    ox = torch.div(num_x, stride, rounding_mode="floor")
    oy = torch.div(num_y, stride, rounding_mode="floor")
    valid_x = (num_x % stride == 0) & (ox >= 0) & (ox < out_h)
    valid_y = (num_y % stride == 0) & (oy >= 0) & (oy < out_w)

    owner = owner.long()
    idx = ((owner * (out_h * out_w))[:, None, None]
           + ox[:, :, None] * out_w + oy[:, None, :])     # [R, k, k]
    in_grid = ((xy[:, 0] >= 0) & (xy[:, 0] < height)
               & (xy[:, 1] >= 0) & (xy[:, 1] < width))
    valid = (valid_x[:, :, None] & valid_y[:, None, :]
             & ((owner >= 0) & (owner < batch) & in_grid)[:, None, None])
    oob = batch * out_h * out_w
    idx = torch.where(valid, idx, oob).reshape(n * k * k)

    grid = contrib.new_zeros((oob + 1, c_out))
    grid = grid.index_add(0, idx, contrib)
    grid = grid[:-1].reshape(batch, out_h, out_w, c_out) + bias.float()
    return grid.to(values.dtype)
