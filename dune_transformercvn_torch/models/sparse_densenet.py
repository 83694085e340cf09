"""Sparse DenseNet embedder: the ``sparse`` family on the sparse-grid engine.

Port of ``dune_transformercvn_tpu/models/sparse_densenet.py``, the
reference's MinkowskiEngine DenseNet on :mod:`..ops.sparse`: a 7x7/2 stem
conv and a 3x3/2 average pool, bottleneck dense blocks (BN-PReLU-conv1x1,
BN-PReLU-conv3x3, channel concat), BN-PReLU-conv1x1 and 2x2/2 average-pool
transitions, a final BN-PReLU, the per-image mean over occupied sites, and
the Linear, BN, PReLU output block.

* Every convolution is bias-free and dilates the occupancy (ME's
  ``expand_coordinates``).  ME's identity-kernel skip convolution before the
  concat is a no-op here: the input features are already zero at newly
  expanded sites.
* BatchNorm statistics run over occupied sites (per-site mask); the result
  is re-masked so unoccupied sites stay exactly zero.
* The occupancy is ``images != 0`` folded with the slot mask: padded slots
  do not exist in ME's sparse tensor.  Pixel noise multiplies, so hits stay
  nonzero.
* ``remat`` (the options' ``remat_cnn``) recomputes each dense layer in the
  backward.

Module names follow the dense family's (``features.conv0``,
``features.dense{i}.layers.{j}.bottleneck_block.norm1``, ...).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.masked import Dropout, MaskedBatchNorm, PReLU, remat
from ..ops.sparse import SparseGrid, sparse_avg_pool, sparse_conv, sparse_global_avg_pool
from ..parallel.mesh import whole
from .blocks import OutputBlock


def occupancy_of(images: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Occupied sites of NHWC ``images``: any channel nonzero, and the slot
    real where ``mask`` ([N] bool) is given."""
    occupancy = (images != 0).any(-1)
    if mask is not None:
        occupancy = occupancy & mask[:, None, None]
    return occupancy


def norm_prelu(norm: MaskedBatchNorm, relu: PReLU, grid: SparseGrid) -> SparseGrid:
    """BN over the occupied sites, PReLU, then zeros at unoccupied sites."""
    x = relu(norm(grid.features, grid.occupancy))
    return SparseGrid(x * grid.occupancy[..., None].to(x.dtype), grid.occupancy)


def conv(layer: nn.Conv2d, grid: SparseGrid) -> SparseGrid:
    """``layer``'s bias-free weight as a sparse convolution."""
    return sparse_conv(grid, whole(layer.weight), layer.stride[0], groups=layer.groups)


class SparseBottleneck(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, batch_norm_size: int,
                 dropout: float = 0.0):
        super().__init__()
        expand = batch_norm_size * growth_rate
        self.bottleneck_block = nn.ModuleDict(dict(
            norm1=MaskedBatchNorm(in_channels),
            relu1=PReLU(in_channels),
            conv1=nn.Conv2d(in_channels, expand, 1, bias=False),
        ))
        self.output_block = nn.ModuleDict(dict(
            norm2=MaskedBatchNorm(expand),
            relu2=PReLU(expand),
            conv2=nn.Conv2d(expand, growth_rate, 3, bias=False),
        ))
        self.dropout = Dropout(dropout) if dropout > 0.0 else None

    def forward(self, grid: SparseGrid) -> SparseGrid:
        b, o = self.bottleneck_block, self.output_block
        h = conv(b.conv1, norm_prelu(b.norm1, b.relu1, grid))
        h = conv(o.conv2, norm_prelu(o.norm2, o.relu2, h))
        features = h.features if self.dropout is None else self.dropout(h.features)
        return SparseGrid(torch.cat([grid.features, features], -1), h.occupancy)


class SparseTransition(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.norm = MaskedBatchNorm(in_channels)
        self.relu = PReLU(in_channels)
        self.conv = nn.Conv2d(in_channels, features, 1, bias=False)

    def forward(self, grid: SparseGrid) -> SparseGrid:
        grid = conv(self.conv, norm_prelu(self.norm, self.relu, grid))
        return sparse_avg_pool(grid, 2, 2)


class SparseDenseNet(nn.Module):
    """Embedder: NHWC images ``[N, H, W, C]`` -> ``[N, output_dim]``."""

    def __init__(
        self,
        in_channels: int,
        output_dim: int,
        initial_features: int = 64,
        growth_rate: int = 32,
        batch_norm_size: int = 4,
        block_config: Sequence[int] = (6, 12, 24, 16),
        dropout: float = 0.0,
        remat: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        features = nn.ModuleDict(dict(
            conv0=nn.Conv2d(in_channels, initial_features, 7, stride=2, bias=False),
            norm0=MaskedBatchNorm(initial_features),
            relu0=PReLU(initial_features),
        ))
        channels = initial_features
        for i, num_layers in enumerate(block_config):
            layers = []
            for _ in range(num_layers):
                layers.append(SparseBottleneck(channels, growth_rate, batch_norm_size,
                                               dropout))
                channels += growth_rate
            features[f"dense{i + 1}"] = nn.ModuleDict(dict(layers=nn.ModuleList(layers)))
            if i != len(block_config) - 1:
                features[f"transition{i + 1}"] = SparseTransition(channels, channels // 2)
                channels //= 2
        features["final_norm"] = MaskedBatchNorm(channels)
        features["final_relu"] = PReLU(channels)
        self.features = features
        self.output_block = OutputBlock(channels, output_dim, dropout)

    def forward(self, images, mask: Optional[torch.Tensor] = None):
        f = self.features
        grid = SparseGrid(images.to(self.compute_dtype), occupancy_of(images, mask))
        grid = norm_prelu(f.norm0, f.relu0, conv(f.conv0, grid))
        grid = sparse_avg_pool(grid, 3, 2)
        i = 1
        while f"dense{i}" in f:
            for layer in f[f"dense{i}"].layers:
                grid = remat(layer, grid) if self.remat else layer(grid)
            if f"transition{i}" in f:
                grid = f[f"transition{i}"](grid)
            i += 1
        grid = norm_prelu(f.final_norm, f.final_relu, grid)
        return self.output_block(sparse_global_avg_pool(grid), mask, self.compute_dtype)
