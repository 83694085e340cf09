"""DenseNet-BC pixel embedder over NHWC images, with PReLU and masked BN.

Port of ``dune_transformercvn_tpu/models/densenet.py``: 7x7/2 stem conv with
bias, BN, PReLU, 3x3/2 average pool; bottleneck dense blocks (1x1 expand to
``batch_norm_size * growth``, 3x3 to ``growth``, channel concat); 1x1 conv +
2x2/2 average-pool transitions; final BN and PReLU; global mean; and a
bias-free Linear, BN, PReLU output block.  With ``remat`` (the options'
``remat_cnn``) each bottleneck keeps only its input for the backward and
recomputes the rest (:func:`..ops.masked.remat`).  Under tensor parallelism
each bottleneck computes 1/mp of its expanded channels on each rank of the
row (:meth:`Bottleneck.tensor_parallel_pieces`, ``parallel/mesh.py``); the
other layers compute whole, their sharded weights gathered in the forward.

Activations stay NHWC (channels last), as in JAX: BN, PReLU and the concat
work on the last axis, and convolutions and pools see an NCHW view of the
same memory (``permute``), which is ``torch.channels_last`` and lets cuDNN
run without layout copies.  Module names follow the reference ``state_dict``
(``features.conv0``, ``features.dense{i}.layers.{j}.bottleneck_block.norm1``,
``features.transition{i}.conv``, ``output_block.linear``, ...).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant
from ..ops.masked import Dropout, MaskedBatchNorm, PReLU, remat
from ..parallel.mesh import copy_to_row, piece, reduce_from_row, whole
from .blocks import OutputBlock


def conv_nhwc(x, weight, bias, dtype, stride=1, padding=0, groups=1):
    """2-D convolution of NHWC ``x`` with an OIHW ``weight``, in ``dtype``
    (int8 inside a :func:`..ops.quant.quantized_convs` context that
    quantizes this conv).  A sharded weight is gathered whole first."""
    weight, bias = whole(weight), None if bias is None else whole(bias)
    y = quant.intercept(x, weight, bias, stride, padding, groups, dtype)
    if y is not None:
        return y
    y = F.conv2d(
        x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
        None if bias is None else bias.to(dtype), stride, padding, 1, groups,
    )
    return y.permute(0, 2, 3, 1)


def avg_pool_nhwc(x, size: int, stride: int):
    """VALID average pool of NHWC ``x``."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), size, stride).permute(0, 2, 3, 1)


def space_to_depth(x):
    """[N, H, W, C] -> [N, H/2, W/2, 4C], channel (a, b, c) = x[2p+a, 2q+b, c]."""
    n, h, w, c = x.shape
    return (x.reshape(n, h // 2, 2, w // 2, 2, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4 * c))


class SpaceToDepthStem(nn.Module):
    """The 7x7/2 stem conv computed as a 4x4/1 conv over the 2x2
    space-to-depth input: the same map, with the same ``weight`` [F, C, 7, 7]
    and ``bias`` [F] as the direct conv.  With the weight zero-padded by one
    leading tap, ``W'[f, (a,b,c), dh, dw] = Wpad[f, c, 2dh+a, 2dw+b]`` and the
    output is a stride-1 VALID conv over the s2d input padded (2, 1) on both
    spatial axes.  Input that already has ``4 * in_channels`` channels is
    taken as s2d (kernel K1 emits that layout); odd extents of plain input
    use the direct conv.
    """

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 7, 7))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        n, h, w, c = x.shape
        dt = self.compute_dtype
        pre_s2d = c == 4 * self.in_channels
        if not pre_s2d and (h % 2 or w % 2):
            return conv_nhwc(x, self.weight, self.bias, dt, stride=2, padding=3)
        x2 = x if pre_s2d else space_to_depth(x)
        weight = whole(self.weight)
        f, cin = weight.shape[:2]
        wpad = F.pad(weight, (1, 0, 1, 0))                  # [F, C, 8, 8]
        w2 = (wpad.reshape(f, cin, 4, 2, 4, 2)                   # f c dh a dw b
              .permute(0, 3, 5, 1, 2, 4)                         # f a b c dh dw
              .reshape(f, 4 * cin, 4, 4))
        x2 = F.pad(x2.to(dt), (0, 0, 2, 1, 2, 1))
        return conv_nhwc(x2, w2, self.bias, dt)


class Bottleneck(nn.Module):
    """BN, PReLU, 1x1 conv to ``batch_norm_size * growth``; BN, PReLU, 3x3
    conv to ``growth``; concatenated to the input's channels.

    With a TP row (``tp``, set by ``parallel.shard_parameters``) conv1 is
    column-parallel, norm2 and relu2 run on its ``expand / mp`` channels,
    conv2 is row-parallel over them and its partial outputs are summed over
    the row, before its bias and the dropout."""

    def __init__(self, in_channels: int, growth_rate: int, batch_norm_size: int,
                 dropout: float = 0.0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        expand = batch_norm_size * growth_rate
        self.compute_dtype = compute_dtype
        self.bottleneck_block = nn.ModuleDict(dict(
            norm1=MaskedBatchNorm(in_channels),
            relu1=PReLU(in_channels),
            conv1=nn.Conv2d(in_channels, expand, 1),
        ))
        self.output_block = nn.ModuleDict(dict(
            norm2=MaskedBatchNorm(expand),
            relu2=PReLU(expand),
            conv2=nn.Conv2d(expand, growth_rate, 3, padding=1),
        ))
        self.dropout = Dropout(dropout) if dropout > 0.0 else None
        self.tp = None

    def tensor_parallel_pieces(self, model_parallel: int):
        """The tensors this layer reads in pieces over a row of
        ``model_parallel`` ranks, ``name -> (dim, blocks)``; ``None`` when
        its expanded channels do not split."""
        if self.output_block.norm2.weight.shape[0] % model_parallel:
            return None
        norm2 = {f"output_block.norm2.{n}": (0, 1)
                 for n in ("weight", "bias", "running_mean", "running_var")}
        return {"bottleneck_block.conv1.weight": (0, 1), "bottleneck_block.conv1.bias": (0, 1),
                **norm2, "output_block.relu2.weight": (0, 1),
                "output_block.conv2.weight": (1, 1)}

    def forward(self, x, mask=None):
        dt, row = self.compute_dtype, self.tp
        b, o = self.bottleneck_block, self.output_block
        h = b.relu1(b.norm1(x, mask))
        if row is None:
            h = conv_nhwc(h, b.conv1.weight, b.conv1.bias, dt)
            h = o.relu2(o.norm2(h, mask))
            h = conv_nhwc(h, o.conv2.weight, o.conv2.bias, dt, padding=1)
        else:
            h = conv_nhwc(copy_to_row(h, row), piece(b.conv1.weight, row, 0),
                          piece(b.conv1.bias, row, 0), dt)
            h = o.relu2(o.norm2(h, mask))
            h = conv_nhwc(h, piece(o.conv2.weight, row, 1), None, dt, padding=1)
            h = reduce_from_row(h, row) + o.conv2.bias.to(dt)
        if self.dropout is not None:
            h = self.dropout(h)
        return torch.cat([x.to(dt), h], dim=-1)


class Transition(nn.Module):
    """BN, PReLU, then 1x1 conv and 2x2/2 average pool; with ``pool_first``
    the pool runs before the conv (both are linear, so they commute: the
    same map with 4x fewer conv FLOPs)."""

    def __init__(self, in_channels: int, features: int, pool_first: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_first = pool_first
        self.compute_dtype = compute_dtype
        self.norm = MaskedBatchNorm(in_channels)
        self.relu = PReLU(in_channels)
        self.conv = nn.Conv2d(in_channels, features, 1)

    def forward(self, x, mask=None):
        x = self.relu(self.norm(x, mask))
        if self.pool_first:
            x = avg_pool_nhwc(x, 2, 2)
            return conv_nhwc(x, self.conv.weight, self.conv.bias, self.compute_dtype)
        x = conv_nhwc(x, self.conv.weight, self.conv.bias, self.compute_dtype)
        return avg_pool_nhwc(x, 2, 2)


class DenseNet(nn.Module):
    """Full embedder: NHWC images ``[N, H, W, C]`` -> vectors ``[N, output_dim]``.

    ``mask`` ([N] bool) weights every BatchNorm's statistics, so padded
    prong slots contribute nothing.
    """

    def __init__(
        self,
        in_channels: int,
        output_dim: int,
        initial_features: int = 64,
        growth_rate: int = 32,
        batch_norm_size: int = 4,
        block_config: Sequence[int] = (6, 12, 24, 16),
        dropout: float = 0.0,
        stem_space_to_depth: bool = False,
        transition_pool_first: bool = False,
        remat: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        if stem_space_to_depth:
            conv0 = SpaceToDepthStem(in_channels, initial_features, compute_dtype)
        else:
            conv0 = nn.Conv2d(in_channels, initial_features, 7, stride=2, padding=3)
        features = nn.ModuleDict(dict(
            conv0=conv0,
            norm0=MaskedBatchNorm(initial_features),
            relu0=PReLU(initial_features),
        ))
        channels = initial_features
        for i, num_layers in enumerate(block_config):
            layers = []
            for _ in range(num_layers):
                layers.append(Bottleneck(channels, growth_rate, batch_norm_size,
                                         dropout, compute_dtype))
                channels += growth_rate
            features[f"dense{i + 1}"] = nn.ModuleDict(dict(layers=nn.ModuleList(layers)))
            if i != len(block_config) - 1:
                features[f"transition{i + 1}"] = Transition(
                    channels, channels // 2, transition_pool_first, compute_dtype)
                channels //= 2
        features["final_norm"] = MaskedBatchNorm(channels)
        features["final_relu"] = PReLU(channels)
        self.features = features
        self.output_block = OutputBlock(channels, output_dim, dropout)

    def forward(self, images, mask: Optional[torch.Tensor] = None):
        conv0 = self.features.conv0
        if isinstance(conv0, SpaceToDepthStem):
            x = conv0(images)
        else:
            x = conv_nhwc(images, conv0.weight, conv0.bias, self.compute_dtype,
                          stride=2, padding=3)
        return densenet_post_stem(self, x, mask)


def densenet_post_stem(net: DenseNet, x, mask=None):
    """Everything after the stem conv: the part of :class:`DenseNet` the
    sparse-stem family shares."""
    f = net.features
    x = f.relu0(f.norm0(x, mask))
    x = avg_pool_nhwc(x, 3, 2)
    i = 1
    while f"dense{i}" in f:
        for layer in f[f"dense{i}"].layers:
            x = remat(layer, x, mask) if net.remat else layer(x, mask)
        if f"transition{i}" in f:
            x = f[f"transition{i}"](x, mask)
        i += 1
    x = f.final_relu(f.final_norm(x, mask))
    x = x.mean(dim=(1, 2))   # global average pool
    return net.output_block(x, mask, net.compute_dtype)
