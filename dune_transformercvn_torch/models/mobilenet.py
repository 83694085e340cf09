"""MobileNetV2 + squeeze-excitation pixel embedder (the ``mobilenet`` family).

Port of ``dune_transformercvn_tpu/models/mobilenet.py``, the reference's
masked MobileNet embedder layer for layer:

* a convolution block is conv (no bias), masked BN, SiLU, dropout;
* an inverted residual is a 1x1 expand block (unless the ratio is 1), a
  depthwise 3x3 block, squeeze-excitation (mean, Linear to C/2, SiLU,
  Linear, sigmoid gate), a 1x1 projection conv and BN with no activation,
  and the residual when the stride is 1 and the width is kept;
* the stem kernel is stretched along the longer image axis, ``(3 + delta,
  3)`` with ``delta = 400 - 280`` (padding ``(61, 1)``), stride 2;
* a last 1x1 block to the embedding width, then the global mean.

BatchNorm statistics are weighted by the slot mask, which equals the
reference's packing of real prong images.  Module names are the
reference's: ``resnet.{i}`` (``resnet.0.conv``, ``resnet.0.norm``), an
inverted residual's ``resnet.{i}.convolutions.{k}`` in the order above.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import Dropout, MaskedBatchNorm
from .blocks import dense, make_divisible
from .densenet import conv_nhwc

# the reference's ladder (expand_ratio, channels, repeats, stride)
DEFAULT_STRUCTURE = (
    (1, 8, 1, 1),
    (6, 16, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 128, 3, 1),
)


def initial_kernel(input_shape: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """The stem kernel, stretched along the longer image axis."""
    if input_shape is None:
        return (3, 3)
    delta = max(input_shape) - min(input_shape)
    if input_shape[1] > input_shape[0]:
        return (3, 3 + delta)
    return (3 + delta, 3)


class ConvBlock(nn.Module):
    """conv (no bias) -> masked BN -> SiLU -> dropout."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3), stride: int = 1,
                 depthwise: bool = False, dropout: float = 0.0):
        super().__init__()
        kh, kw = kernel
        self.conv = nn.Conv2d(in_channels, features, (kh, kw), stride=stride,
                              padding=((kh - 1) // 2, (kw - 1) // 2),
                              groups=in_channels if depthwise else 1, bias=False)
        self.norm = MaskedBatchNorm(features)
        self.dropout = Dropout(dropout) if dropout > 0.0 else None

    def forward(self, x, mask, dtype):
        c = self.conv
        x = conv_nhwc(x, c.weight, None, dtype, c.stride, c.padding, c.groups)
        x = F.silu(self.norm(x, mask))
        return x if self.dropout is None else self.dropout(x)


class SqueezeExcite(nn.Module):
    """Per-image channel gate: reduction 2, biased linears, SiLU between."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x, dtype):
        h = F.silu(dense(self.fc1, x.mean((1, 2)), dtype))
        gate = torch.sigmoid(dense(self.fc2, h, dtype))
        return x * gate[:, None, None, :]


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 expand_ratio: int = 6, dropout: float = 0.0):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBlock(in_channels, hidden, (1, 1), dropout=dropout))
        layers += [
            ConvBlock(hidden, hidden, (3, 3), stride, depthwise=True, dropout=dropout),
            SqueezeExcite(hidden),
            nn.Conv2d(hidden, features, 1, bias=False),
            MaskedBatchNorm(features),
        ]
        self.convolutions = nn.ModuleList(layers)
        self.dropout = Dropout(dropout) if dropout > 0.0 else None
        self.residual = stride == 1 and in_channels == features

    def forward(self, x, mask, dtype):
        *blocks, se, project, norm = self.convolutions
        h = x
        for block in blocks:
            h = block(h, mask, dtype)
        h = se(h, dtype)
        h = norm(conv_nhwc(h, project.weight, None, dtype), mask)
        if self.dropout is not None:
            h = self.dropout(h)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """Embedder: NHWC images ``[N, H, W, C]`` -> ``[N, output_dim]``."""

    def __init__(
        self,
        in_channels: int,
        output_dim: int,
        initial_features: int = 32,
        structure: Sequence[Sequence[int]] = DEFAULT_STRUCTURE,
        input_shape: Optional[Tuple[int, int]] = None,
        dropout: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        channels = make_divisible(initial_features, 8)
        blocks = [ConvBlock(in_channels, channels, initial_kernel(input_shape), 2,
                            dropout=dropout)]
        for expansion, width, repeats, stride in structure:
            width = make_divisible(width, 8)
            for i in range(repeats):
                blocks.append(InvertedResidual(channels, width, stride if i == 0 else 1,
                                               expansion, dropout))
                channels = width
        blocks.append(ConvBlock(channels, output_dim, (1, 1), dropout=dropout))
        self.resnet = nn.ModuleList(blocks)

    def forward(self, images, mask: Optional[torch.Tensor] = None):
        x = images.to(self.compute_dtype)
        for block in self.resnet:
            x = block(x, mask, self.compute_dtype)
        return x.mean((1, 2))
