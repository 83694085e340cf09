"""Sparse ConvNeXt pixel embedder (the ``convnext`` family).

Port of ``dune_transformercvn_tpu/models/sparse_convnext.py``: a bias-free
4x4/4 patchify conv and LayerNorm, then stages of ConvNeXt blocks (a
depthwise 5x5 sparse conv, LayerNorm, a 4x expand / contract MLP with exact
GELU, a layer scale that starts at 1e-6, drop-path, the residual), with
LayerNorm and a 2x2/2 conv between stages; the per-image mean over occupied
sites, LayerNorm, and the Linear, BN, PReLU output block.  LayerNorm
(epsilon 1e-6) and the MLP's biases break the zeros at unoccupied sites, so
each block re-masks.

Drop-path rates rise linearly from 0 at the first block to the rate at the
last (denominator ``total_blocks - 1``); the per-sample keep mask is drawn
from the default generator, which the train step seeds from the state's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse import SparseGrid, sparse_global_avg_pool
from .blocks import OutputBlock, dense, layer_norm
from .sparse_densenet import conv, occupancy_of

LAYER_NORM_EPS = 1e-6
# the JAX package's stage widths and depths (the family's only configuration)
HIDDEN_FEATURES = (32, 64, 128, 256)
HIDDEN_DEPTHS = (1, 1, 1, 1)


def _remask(features: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    return features * occupancy[..., None].to(features.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in training, each sample's branch is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``.
    The mask is drawn out of place, so that :func:`..ops.masked.remat`
    keeps it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, device=x.device).bernoulli(keep)
        return x * mask.to(x.dtype) / keep


class ConvNeXtBlock(nn.Module):
    def __init__(self, channels: int, kernel: int = 5, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dwconv = nn.Conv2d(channels, channels, kernel, groups=channels, bias=False)
        self.norm = nn.LayerNorm(channels, eps=LAYER_NORM_EPS)
        self.pwconv1 = nn.Linear(channels, 4 * channels)
        self.pwconv2 = nn.Linear(4 * channels, channels)
        self.gamma = nn.Parameter(torch.full((channels,), layer_scale_init))
        self.drop_path = DropPath(drop_path)

    def forward(self, grid: SparseGrid) -> SparseGrid:
        dt = self.compute_dtype
        h = conv(self.dwconv, grid)
        x = layer_norm(self.norm, h.features, dt)
        x = dense(self.pwconv2, F.gelu(dense(self.pwconv1, x, dt)), dt)
        x = _remask(x * self.gamma.to(dt), h.occupancy)
        # the input is zero at newly expanded sites (ME's identity skip)
        return SparseGrid(grid.features + self.drop_path(x), h.occupancy)


class Downsample(nn.Module):
    """LayerNorm, re-mask, then a bias-free 2x2/2 sparse conv."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.norm = nn.LayerNorm(in_channels, eps=LAYER_NORM_EPS)
        self.conv = nn.Conv2d(in_channels, features, 2, stride=2, bias=False)

    def forward(self, grid: SparseGrid, dtype) -> SparseGrid:
        x = _remask(layer_norm(self.norm, grid.features, dtype), grid.occupancy)
        return conv(self.conv, SparseGrid(x, grid.occupancy))


class Stage(nn.Module):
    def __init__(self, downsample: Optional[Downsample], blocks):
        super().__init__()
        self.downsample = downsample
        self.blocks = nn.ModuleList(blocks)


class SparseConvNeXt(nn.Module):
    """Embedder: NHWC images ``[N, H, W, C]`` -> ``[N, output_dim]``."""

    def __init__(
        self,
        in_channels: int,
        output_dim: int,
        kernel: int = 5,
        hidden_features: Sequence[int] = HIDDEN_FEATURES,
        hidden_depths: Sequence[int] = HIDDEN_DEPTHS,
        drop_path_rate: float = 0.0,
        layer_scale_init: float = 1e-6,
        dropout: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = nn.ModuleDict(dict(
            conv=nn.Conv2d(in_channels, hidden_features[0], 4, stride=4, bias=False),
            norm=nn.LayerNorm(hidden_features[0], eps=LAYER_NORM_EPS),
        ))
        # torch.linspace(0, rate, total): the last block drops at the rate
        total_blocks = max(sum(hidden_depths) - 1, 1)
        stages, index, previous = [], 0, hidden_features[0]
        for s, (width, depth) in enumerate(zip(hidden_features, hidden_depths)):
            blocks = []
            for _ in range(depth):
                blocks.append(ConvNeXtBlock(
                    width, kernel, drop_path_rate * index / total_blocks,
                    layer_scale_init, compute_dtype))
                index += 1
            stages.append(Stage(Downsample(previous, width) if s > 0 else None, blocks))
            previous = width
        self.stages = nn.ModuleList(stages)
        self.head_norm = nn.LayerNorm(previous, eps=LAYER_NORM_EPS)
        self.output_block = OutputBlock(previous, output_dim, dropout)

    def forward(self, images, mask: Optional[torch.Tensor] = None):
        dt = self.compute_dtype
        grid = SparseGrid(images.to(dt), occupancy_of(images, mask))
        grid = conv(self.stem.conv, grid)
        grid = SparseGrid(_remask(layer_norm(self.stem.norm, grid.features, dt),
                                  grid.occupancy), grid.occupancy)
        for stage in self.stages:
            if stage.downsample is not None:
                grid = stage.downsample(grid, dt)
            for block in stage.blocks:
                grid = block(grid)
        condensed = layer_norm(self.head_norm, sparse_global_avg_pool(grid), dt)
        return self.output_block(condensed, mask, dt)
