"""Classification heads: event decoder and the halving-width prong decoder.

Port of ``dune_transformercvn_tpu/models/heads.py``.  The prong decoder's
hidden stack is one flat ``hidden_layers`` list in the reference's
``nn.Sequential`` order (Linear, BatchNorm, PReLU or ReLU, Dropout per
block), so its ``state_dict`` indices are the reference's; its BatchNorm is
masked to the real prongs.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.masked import MaskedBatchNorm, PReLU
from .blocks import dense


class EventDecoder(nn.Module):
    """One linear layer on the event token."""

    def __init__(self, in_features: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.hidden_layer = nn.Linear(in_features, num_classes)

    def forward(self, event_features):
        return dense(self.hidden_layer, event_features, self.compute_dtype)


def prong_decoder_widths(hidden_dim: int, num_layers: int,
                         min_dim: int = 8) -> List[int]:
    """Hidden widths: ``hidden_dim`` halved up to ``num_layers`` times while
    the half stays at least ``min_dim`` (128 -> 64 -> 32 -> 16 -> 8)."""
    widths, dim = [], hidden_dim
    for _ in range(num_layers):
        if dim // 2 < min_dim:
            break
        dim //= 2
        widths.append(dim)
    return widths


def linear_block_layers(batch_norm: bool, dropout: float) -> List[str]:
    """Roles of one block's entries in ``hidden_layers``, in order."""
    return (["linear"] + (["norm"] if batch_norm else []) + ["activation"]
            + (["dropout"] if dropout > 0.0 else []))


class ProngDecoder(nn.Module):
    def __init__(
        self,
        num_classes: int,
        hidden_dim: int,
        num_layers: int,
        batch_norm: bool = True,
        prelu: bool = True,
        dropout: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        layers = []
        dim = hidden_dim
        for width in prong_decoder_widths(hidden_dim, num_layers):
            for role in linear_block_layers(batch_norm, dropout):
                if role == "linear":
                    layers.append(nn.Linear(dim, width))   # bias forced on
                elif role == "norm":
                    layers.append(MaskedBatchNorm(width))
                elif role == "activation":
                    layers.append(PReLU(width) if prelu else nn.ReLU())
                else:
                    layers.append(nn.Dropout(dropout))
            dim = width
        self.hidden_layers = nn.ModuleList(layers)
        self.output_layer = nn.Linear(dim, num_classes)

    def forward(self, prong_features, mask: Optional[torch.Tensor] = None):
        """``prong_features``: [B, P, D]; ``mask``: [B, P] bool."""
        B, P, D = prong_features.shape
        x = prong_features.reshape(B * P, D)
        flat_mask = None if mask is None else mask.reshape(B * P)
        for layer in self.hidden_layers:
            if isinstance(layer, nn.Linear):
                x = dense(layer, x, self.compute_dtype)
            elif isinstance(layer, MaskedBatchNorm):
                x = layer(x, flat_mask)
            else:
                x = layer(x)
        x = dense(self.output_layer, x, self.compute_dtype)
        return x.reshape(B, P, self.num_classes)
