"""Multi-scale sparse FCNN embedder (the ``fcnn`` family).

Port of ``dune_transformercvn_tpu/models/sparse_fcnn.py``: a bias-free 5x5
stem conv with BN and PReLU, then stride-2 conv stages (BN, PReLU, a 2x2/1
average pool); the stem and every stage each give a per-image mean over
occupied sites, and their concatenation goes through the Linear, BN, PReLU
output block.  Built on :mod:`..ops.sparse`, so statistics and pools see
only occupied sites.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.masked import MaskedBatchNorm, PReLU
from ..ops.sparse import SparseGrid, sparse_avg_pool, sparse_global_avg_pool
from .blocks import OutputBlock
from .sparse_densenet import conv, norm_prelu, occupancy_of


class ConvNormPReLU(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride=stride, bias=False)
        self.norm = MaskedBatchNorm(features)
        self.relu = PReLU(features)

    def forward(self, grid: SparseGrid) -> SparseGrid:
        return norm_prelu(self.norm, self.relu, conv(self.conv, grid))


class SparseFCNN(nn.Module):
    """Embedder: NHWC images ``[N, H, W, C]`` -> ``[N, output_dim]``."""

    def __init__(
        self,
        in_channels: int,
        output_dim: int,
        initial_features: int = 32,
        stage_features: Sequence[int] = (32, 64, 128, 256),
        kernel: int = 3,
        dropout: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = ConvNormPReLU(in_channels, initial_features, 5)
        widths = [initial_features, *stage_features]
        self.stages = nn.ModuleList(
            ConvNormPReLU(c_in, c_out, kernel, stride=2)
            for c_in, c_out in zip(widths, widths[1:]))
        self.output_block = OutputBlock(sum(widths), output_dim, dropout)

    def forward(self, images, mask: Optional[torch.Tensor] = None):
        grid = SparseGrid(images.to(self.compute_dtype), occupancy_of(images, mask))
        grid = self.stem(grid)
        summaries = [sparse_global_avg_pool(grid)]
        for stage in self.stages:
            grid = sparse_avg_pool(stage(grid), 2, 1)
            summaries.append(sparse_global_avg_pool(grid))
        return self.output_block(torch.cat(summaries, -1), mask, self.compute_dtype)
