"""Masked shared transformer encoder over the [event, prong_1..20] sequence.

Port of ``dune_transformercvn_tpu/models/encoder.py`` (``EncoderLayer`` and
``TransformerEncoder``):

* batch-first ``[B, T, D]``; T is about 21 tokens, so attention is plain
  matmuls written as flax computes them (query scaled first, padded keys
  set to the dtype's minimum, softmax, attention-weight dropout shared over
  batch and heads);
* key-padding mask only: padded query rows are computed anyway, and the
  input and output are multiplied by the sequence mask;
* post-norm (torch's default) or pre-norm, exact-erf GELU, LayerNorm
  epsilon 1e-6 (flax's, not torch's 1e-5);
* feed-forward width equals ``hidden_dim``.

Submodule names are those of ``torch.nn.TransformerEncoderLayer``
(``self_attn.in_proj_weight``, ``self_attn.out_proj``, ``linear1``, ...), so
the stack's ``state_dict`` reads ``encoder.layers.{i}.*`` like the
reference's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import dense

LAYER_NORM_EPS = 1e-6


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch's packed q/k/v projection."""

    def __init__(self, hidden_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden_dim, hidden_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden_dim))
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x, key_mask, dtype):
        """``x``: [B, T, D]; ``key_mask``: [B, T] bool (True = real key)."""
        B, T, D = x.shape
        head_dim = D // self.num_heads
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        q, k, v = qkv.view(B, T, 3, self.num_heads, head_dim).unbind(2)
        q = q / math.sqrt(head_dim)
        weights = torch.einsum("bqhd,bkhd->bhqk", q, k)
        weights = weights.masked_fill(
            ~key_mask[:, None, None, :], torch.finfo(dtype).min)
        weights = torch.softmax(weights.float(), dim=-1).to(dtype)
        if self.training and self.dropout > 0.0:
            keep = F.dropout(torch.ones((1, 1, T, T), dtype=dtype, device=x.device),
                             self.dropout)
            weights = weights * keep
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, T, D)
        return dense(self.out_proj, out, dtype)


class EncoderLayer(nn.Module):
    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        activation: str = "gelu",
        norm_first: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm_first = norm_first
        self.activation = F.gelu if activation == "gelu" else F.relu
        self.self_attn = SelfAttention(hidden_dim, num_heads, dropout)
        self.linear1 = nn.Linear(hidden_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def _norm(self, norm: nn.LayerNorm, x):
        # statistics in float32, result in the compute dtype (flax LayerNorm)
        y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                         norm.bias, norm.eps)
        return y.to(self.compute_dtype)

    def _attn_block(self, x, key_mask):
        return self.dropout1(self.self_attn(x, key_mask, self.compute_dtype))

    def _ff_block(self, x):
        dt = self.compute_dtype
        h = self.dropout(self.activation(dense(self.linear1, x, dt)))
        return self.dropout2(dense(self.linear2, h, dt))

    def forward(self, x, key_mask):
        if self.norm_first:
            x = x + self._attn_block(self._norm(self.norm1, x), key_mask)
            return x + self._ff_block(self._norm(self.norm2, x))
        x = self._norm(self.norm1, x + self._attn_block(x, key_mask))
        return self._norm(self.norm2, x + self._ff_block(x))


class _LayerStack(nn.Module):
    """Holds ``layers`` as ``torch.nn.TransformerEncoder`` does."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerEncoder(nn.Module):
    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        num_layers: int,
        dropout: float = 0.0,
        activation: str = "gelu",
        norm_first: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.encoder = _LayerStack(
            EncoderLayer(hidden_dim, num_heads, dropout, activation,
                         norm_first, compute_dtype)
            for _ in range(num_layers)
        )

    def forward(self, embeddings, mask):
        """``embeddings``: [B, T, D]; ``mask``: [B, T] bool (True = real)."""
        seq_mask = mask[..., None].to(embeddings.dtype)
        x = embeddings * seq_mask
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return x * seq_mask
