"""Shared MLP building blocks: LinearBlock and the prong feature embedding.

Port of ``dune_transformercvn_tpu/models/blocks.py``.  Parameters are kept in
float32 and cast to the compute dtype where they are used, as flax's
``param_dtype=float32, dtype=compute`` does.  Submodule names follow the
reference ``state_dict`` (``linear``, ``norm``, ``activation``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import MaskedBatchNorm, PReLU


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LinearBlock(nn.Module):
    """Linear (no bias when BN is on) -> masked BN -> PReLU/ReLU -> Dropout."""

    def __init__(
        self,
        in_features: int,
        features: int,
        batch_norm: bool = True,
        prelu: bool = True,
        dropout: float = 0.0,
        force_bias: bool = False,   # bias even with BN (the decoder stack)
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.linear = nn.Linear(in_features, features,
                                bias=force_bias or not batch_norm)
        self.norm = MaskedBatchNorm(features) if batch_norm else None
        self.activation = PReLU(features) if prelu else nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        x = dense(self.linear, x, self.compute_dtype)
        if self.norm is not None:
            x = self.norm(x, mask)
        x = self.activation(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x


def feature_embedding_widths(output_dim: int, initial_dim: int,
                             max_layers: int) -> List[int]:
    """Widths of the doubling stack: ``initial_dim``, doubled while the next
    doubling stays below ``output_dim`` (at most ``max_layers`` times), then
    ``output_dim``."""
    widths = [initial_dim]
    dim = initial_dim
    for _ in range(max_layers):
        if 2 * dim >= output_dim:
            break
        dim *= 2
        widths.append(dim)
    return widths + [output_dim]


class FeatureEmbedding(nn.Module):
    """Doubling-width LinearBlock stack from ``initial_dim`` up to
    ``output_dim`` over the concatenated prong features and event extras.

    When ``disabled`` (``Options.disable_smart_features``) it holds no
    parameters and returns zeros in the compute dtype.
    """

    def __init__(
        self,
        in_features: int,
        output_dim: int,
        initial_dim: int,
        max_layers: int,
        disabled: bool = False,
        batch_norm: bool = True,
        prelu: bool = True,
        dropout: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.output_dim = output_dim
        self.disabled = disabled
        self.compute_dtype = compute_dtype
        self.embedding = None
        if not disabled:
            widths = feature_embedding_widths(output_dim, initial_dim, max_layers)
            self.embedding = nn.ModuleList(
                LinearBlock(w_in, w_out, batch_norm=batch_norm, prelu=prelu,
                            dropout=dropout, compute_dtype=compute_dtype)
                for w_in, w_out in zip([in_features] + widths[:-1], widths)
            )

    def forward(self, data, extra, mask=None):
        if self.disabled:
            return torch.zeros((data.shape[0], self.output_dim),
                               dtype=self.compute_dtype, device=data.device)
        x = torch.cat([data, extra], dim=1).to(self.compute_dtype)
        for block in self.embedding:
            x = block(x, mask)
        return x


def make_divisible(value: int, divisor: int = 8) -> int:
    """Round to the nearest multiple of ``divisor``, never dropping below 90%."""
    rounded = max(divisor, int(value + divisor / 2) // divisor * divisor)
    if rounded < 0.9 * value:
        rounded += divisor
    return rounded
