"""Attention pooling of a masked token set ``[B, T, D]`` to ``[B, D]``.

Port of ``dune_transformercvn_tpu/models/pooling.py``: the reference's
masked-softmax pooling (a scalar score per token) and learned-query
multi-head cross-attention pooling.  No network path uses them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel.mesh import whole
from .blocks import dense


class MaskedSoftmaxPooling(nn.Module):
    """Scalar attention score per token, masked softmax, weighted sum."""

    def __init__(self, dim: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.score = nn.Linear(dim, 1)

    def forward(self, tokens, mask):
        """``tokens``: [B, T, D]; ``mask``: [B, T] bool."""
        scores = dense(self.score, tokens, self.compute_dtype)[..., 0].float()
        # a row with no real token gets zero weights, not a NaN softmax
        empty = ~mask.any(-1, keepdim=True)
        scores = scores.masked_fill(~mask, float("-inf")).masked_fill(empty, 0.0)
        weights = torch.softmax(scores, -1).to(tokens.dtype).masked_fill(empty, 0.0)
        return torch.einsum("bt,btd->bd", weights, tokens)


class MultiHeadPooling(nn.Module):
    """A learned query attending over the tokens with ``num_heads`` heads
    (flax's ``MultiHeadDotProductAttention``: query scaled by
    ``1/sqrt(head_dim)``, masked keys at the dtype's minimum)."""

    def __init__(self, dim: int, num_heads: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.query = nn.Parameter(torch.empty(1, 1, dim).normal_(0.0, 0.02))
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, tokens, mask):
        """``tokens``: [B, T, D]; ``mask``: [B, T] bool."""
        B, T, D = tokens.shape
        dt = self.compute_dtype
        hd = D // self.num_heads
        q = dense(self.q, whole(self.query).expand(B, 1, D), dt).view(B, 1, self.num_heads, hd)
        k = dense(self.k, tokens, dt).view(B, T, self.num_heads, hd)
        v = dense(self.v, tokens, dt).view(B, T, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(hd), k)
        logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(dt).min)
        weights = torch.softmax(logits, -1)
        pooled = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, 1, D)
        return dense(self.out, pooled, dt)[:, 0]
