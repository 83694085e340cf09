"""The sparse stem convolution straight from hit banks into a dense grid.

Port of ``coo_stem_conv`` (``dune_transformercvn_tpu/ops/coo_conv.py``), the
stem case of MinkowskiEngine's gather-matmul-scatter: because convolution is
linear in its input, ``conv(densify(hits))`` is the sum over hits of each
hit's contribution, so the work scales with hits instead of pixels.

CUDA tensors that come with the batcher's CSR ``starts`` and the 7x7/2/3
geometry go to kernel K2 (:func:`.coo_stem.coo_stem_conv_cuda`), the same
static choice the JAX package makes; any other CUDA call raises.  CPU
tensors take the plain path, :func:`coo_stem_conv_plain`: one
``[R, C_in] x [C_in, k*k*C_out]`` product and one ``index_add_`` of the
contributions.  The kernels of the
JAX package's general sparse convolution (``build_conv_maps``,
``coo_conv_apply``) lie on no model path and are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from .coo_stem import KERNEL, PADDING, STRIDE, coo_stem_conv_cuda


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
