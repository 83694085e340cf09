"""SDXL-style pixel embedder: diffusers' VAE encoder, then Flatten + Linear.

Port of ``dune_transformercvn_tpu/models/sdxl.py``, the production LArSoft
architecture (the reference's ``SDXLNet``: repeat_block_dim 2, num_blocks 4,
norm_num_groups 1):

* ``conv_in`` 3x3 to the first width;
* nine down blocks of two resnet blocks (GroupNorm, SiLU, conv 3x3, twice,
  with a 1x1 ``conv_shortcut`` on a width change), each but the last
  followed by a downsample that pads (0, 1) on both spatial axes and runs a
  stride-2 3x3 VALID conv (so H -> H // 2: 400x280 collapses to 1x1 after
  the eight downsamples);
* a mid block: resnet, single-head spatial self-attention (GroupNorm,
  q/k/v/out linears, float32 softmax, residual), resnet;
* GroupNorm, SiLU, ``conv_out`` 3x3, then Flatten (NHWC order, as JAX) and
  ``output_layer``.

Module names are diffusers' own, as ``tests/_diffusers_ref.py::SDXLNet``
has them (``encoder.down_blocks.{i}.resnets.{j}.norm1``, ...), so its
``state_dict`` loads strictly.  GroupNorm has epsilon 1e-6 and is taken per
sample, so padded prong slots need no mask and a bank may run in chunks.
The encoder runs NCHW, diffusers' own layout, so ``F.group_norm`` takes its
input with no layout copy; the NHWC images are transposed once on entry.
Parameters are float32 and are cast to the compute dtype where they are used.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant
from ..parallel.mesh import whole
from .blocks import dense

GROUP_NORM_EPS = 1e-6


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)`` with the affine cast to ``x``'s dtype (statistics are
    taken in float32 either way)."""
    return F.group_norm(x, norm.num_groups, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` with weight and bias cast to ``x``'s dtype (int8 inside a
    :func:`..ops.quant.quantized_convs` context that quantizes ``layer``)."""
    weight, bias = whole(layer.weight), whole(layer.bias)
    if quant.active():
        y = quant.intercept(x.permute(0, 2, 3, 1), weight, bias,
                            layer.stride, layer.padding, layer.groups, x.dtype)
        if y is not None:
            return y.permute(0, 3, 1, 2)
    return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), layer.stride, layer.padding)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 1):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=GROUP_NORM_EPS)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=GROUP_NORM_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = conv(self.conv1, F.silu(group_norm(self.norm1, x)))
        h = conv(self.conv2, F.silu(group_norm(self.norm2, h)))
        if self.conv_shortcut is not None:
            x = conv(self.conv_shortcut, x)
        return x + h


class Downsample2D(nn.Module):
    """Pad (0, 1) on each spatial axis, then a stride-2 3x3 VALID conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return conv(self.conv, F.pad(x, (0, 1, 0, 1)))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 2,
                 groups: int = 1, add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, groups)
            for i in range(num_layers))
        self.downsampler = Downsample2D(out_channels) if add_downsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsampler is not None:
            x = self.downsampler(x)
        return x


class AttnBlock(nn.Module):
    """Single-head attention over the spatial positions, with a residual."""

    def __init__(self, channels: int, groups: int = 1):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=GROUP_NORM_EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        n, c, h, w = x.shape
        dt = x.dtype
        tokens = group_norm(self.group_norm, x).reshape(n, c, h * w).transpose(1, 2)
        q, k, v = (dense(layer, tokens, dt) for layer in (self.to_q, self.to_k, self.to_v))
        logits = q @ k.transpose(1, 2) / math.sqrt(c)
        weights = torch.softmax(logits.float(), dim=-1).to(dt)
        out = dense(self.to_out, weights @ v, dt)
        return x + out.transpose(1, 2).reshape(n, c, h, w)


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels: int, groups: int = 1):
        super().__init__()
        self.resnet1 = ResnetBlock2D(channels, channels, groups)
        self.attn = AttnBlock(channels, groups)
        self.resnet2 = ResnetBlock2D(channels, channels, groups)

    def forward(self, x):
        return self.resnet2(self.attn(self.resnet1(x)))


class Encoder(nn.Module):
    """diffusers' ``Encoder`` with ``double_z=False``."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int], layers_per_block: int = 2,
                 groups: int = 1):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, block_out_channels[0], 3, padding=1)
        widths = list(block_out_channels)
        self.down_blocks = nn.ModuleList(
            DownEncoderBlock2D(widths[max(i - 1, 0)], width, layers_per_block, groups,
                               add_downsample=i != len(widths) - 1)
            for i, width in enumerate(widths))
        self.mid_block = UNetMidBlock2D(widths[-1], groups)
        self.conv_norm_out = nn.GroupNorm(groups, widths[-1], eps=GROUP_NORM_EPS)
        self.conv_out = nn.Conv2d(widths[-1], out_channels, 3, padding=1)

    def forward(self, x):
        x = conv(self.conv_in, x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return conv(self.conv_out, F.silu(group_norm(self.conv_norm_out, x)))


def block_widths(init_block_dim: int, output_dim: int, repeat_block_dim: int = 2,
                 num_blocks: int = 4):
    """The width ladder ``init * {1,1,2,2,4,4,8,8}`` then ``output_dim``."""
    widths = [init_block_dim * 2 ** b for b in range(num_blocks)
              for _ in range(repeat_block_dim)]
    return widths + [output_dim]


class SDXLEncoder(nn.Module):
    """Embedder: NHWC images ``[N, H, W, C]`` -> ``[N, output_dim]``.

    ``image_shape`` fixes the width of ``output_layer``'s input: the final
    map is ``H >> 8`` by ``W >> 8`` (1x1 from 400x280, the only shape at
    which diffusers' Flatten + Linear is defined).  ``mask`` is accepted and
    unused: GroupNorm is per sample.
    """

    def __init__(self, in_channels: int, output_dim: int, init_block_dim: int,
                 image_shape: Tuple[int, int] = (400, 280), repeat_block_dim: int = 2,
                 num_blocks: int = 4, norm_num_groups: int = 1, layers_per_block: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        widths = block_widths(init_block_dim, output_dim, repeat_block_dim, num_blocks)
        self.encoder = Encoder(in_channels, output_dim, widths, layers_per_block,
                               norm_num_groups)
        h, w = image_shape
        for _ in range(len(widths) - 1):
            h, w = h // 2, w // 2
        if h < 1 or w < 1:
            raise ValueError(f"images of {image_shape} vanish after {len(widths) - 1} "
                             "downsamples; the sdxl embedder needs H, W >= 256")
        self.output_layer = nn.Linear(output_dim * h * w, output_dim)

    def forward(self, images, mask: Optional[torch.Tensor] = None):
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        x = self.encoder(x)
        x = x.permute(0, 2, 3, 1).flatten(1)
        return dense(self.output_layer, x, self.compute_dtype)
