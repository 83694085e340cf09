"""ResNet-stack pixel embedder (the ``resnet`` family).

Port of ``dune_transformercvn_tpu/models/resnet.py``.  The body is the
reference's ``ResNetStack``: basic blocks of conv3x3-BN, PReLU, conv3x3-BN,
with a conv1x1-BN projection shortcut on a width change and no activation
after the residual add; a stage's first block downsamples by 2 when the
width changes.  Around it, the JAX package's stem and head: a 7x7/2 conv
(no bias), BN, PReLU and a 3x3/2 max pool padded with -inf; the global mean,
then Linear (no bias), BN, PReLU, dropout.  Every BatchNorm is weighted by
the slot mask.

Module names of the body are the reference's
(``blocks.{l}.blocks.{b}.blocks.0.conv``, ``.blocks.0.bn``, ``.blocks.1``
the PReLU, ``.shortcut.conv``, ``.shortcut.bn``); the stem is ``stem.*``
and the head ``output_block.*``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import MaskedBatchNorm, PReLU
from .blocks import OutputBlock
from .densenet import conv_nhwc

# stage depths (the family's only configuration)
BLOCK_CONFIG = (2, 2, 2, 2)


class ConvBN(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride=stride,
                              padding=kernel // 2, bias=False)
        self.bn = MaskedBatchNorm(features)

    def forward(self, x, mask, dtype):
        c = self.conv
        return self.bn(conv_nhwc(x, c.weight, None, dtype, c.stride, c.padding), mask)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.blocks = nn.ModuleList([ConvBN(in_channels, features, 3, stride),
                                     PReLU(features),
                                     ConvBN(features, features, 3)])
        self.shortcut = (ConvBN(in_channels, features, 1, stride)
                         if in_channels != features else None)

    def forward(self, x, mask, dtype):
        first, relu, second = self.blocks
        h = second(relu(first(x, mask, dtype)), mask, dtype)
        return h + (x if self.shortcut is None else self.shortcut(x, mask, dtype))


class ResNetLayer(nn.Module):
    def __init__(self, in_channels: int, features: int, depth: int):
        super().__init__()
        stride = 2 if in_channels != features else 1
        self.blocks = nn.ModuleList(
            BasicBlock(in_channels if i == 0 else features, features, stride if i == 0 else 1)
            for i in range(depth))


class ResNetStack(nn.Module):
    """Embedder: NHWC images ``[N, H, W, C]`` -> ``[N, output_dim]``."""

    def __init__(
        self,
        in_channels: int,
        output_dim: int,
        initial_features: int = 64,
        block_config: Sequence[int] = BLOCK_CONFIG,
        dropout: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = nn.ModuleDict(dict(
            conv=nn.Conv2d(in_channels, initial_features, 7, stride=2, padding=3,
                           bias=False),
            norm=MaskedBatchNorm(initial_features),
            relu=PReLU(initial_features),
        ))
        layers, channels = [], initial_features
        for i, depth in enumerate(block_config):
            width = initial_features * 2 ** i
            layers.append(ResNetLayer(channels, width, depth))
            channels = width
        self.blocks = nn.ModuleList(layers)
        self.output_block = OutputBlock(channels, output_dim, dropout)

    def forward(self, images, mask: Optional[torch.Tensor] = None):
        dt = self.compute_dtype
        s = self.stem
        x = conv_nhwc(images, s.conv.weight, None, dt, s.conv.stride, s.conv.padding)
        x = s.relu(s.norm(x, mask))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for layer in self.blocks:
            for block in layer.blocks:
                x = block(x, mask, dt)
        return self.output_block(x.mean((1, 2)), mask, dt)
