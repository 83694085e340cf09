"""Masked shared transformer encoder over the [event, prong_1..20] sequence,
and the decoder layer and ISAB the JAX package exports beside it.

Port of ``dune_transformercvn_tpu/models/encoder.py`` (``EncoderLayer``,
``TransformerEncoder``, ``DecoderLayer`` and ``InducedSetAttentionBlock``):

* batch-first ``[B, T, D]``; T is about 21 tokens, so attention is plain
  matmuls written as flax computes them (query scaled first, masked keys
  set to the dtype's minimum, softmax, attention-weight dropout shared over
  batch and heads);
* the encoder takes a key-padding mask only: padded query rows are computed
  anyway, and the input and output are multiplied by the sequence mask;
* post-norm (torch's default) or pre-norm, exact-erf GELU, LayerNorm
  epsilon 1e-6 (flax's, not torch's 1e-5);
* feed-forward width equals ``hidden_dim``.

Submodule names are those of ``torch.nn.TransformerEncoderLayer``
(``self_attn.in_proj_weight``, ``self_attn.out_proj``, ``linear1``, ...), so
the stack's ``state_dict`` reads ``encoder.layers.{i}.*`` like the
reference's; :class:`DecoderLayer`'s are ``torch.nn.TransformerDecoderLayer``'s
(``self_attn``, ``multihead_attn``, ``norm1``-``norm3``), so that module's
``state_dict`` loads into it.  No network path runs the decoder layer or
the ISAB (the reference carries its ISAB unused, like the JAX package).

Under tensor parallelism (``parallel/mesh.py``) each attention runs
``heads / mp`` whole heads on each rank of its row and sums ``out_proj``'s
partial products over the row; each encoder layer's feed-forward runs
``linear1`` column-parallel and ``linear2`` row-parallel.  The LayerNorms,
and the decoder layer's feed-forward, compute whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import copy_to_row, cut_piece, piece, reduce_from_row, whole
from .blocks import dense, layer_norm, lecun_normal_

LAYER_NORM_EPS = 1e-6


class MultiHeadAttention(nn.Module):
    """Multi-head attention with torch's packed q/k/v projection: queries
    from ``x``, keys and values from ``memory`` (``x`` itself when None).
    With a TP row (``tp``) this rank runs its ``heads / mp`` heads: their
    rows of each of q, k and v, and their columns of ``out_proj``, whose
    partial products are summed over the row before its bias."""

    def __init__(self, hidden_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden_dim, hidden_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden_dim))
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)
        self.tp = None

    def tensor_parallel_pieces(self, model_parallel: int):
        """The tensors this layer reads in pieces over a row of
        ``model_parallel`` ranks, ``name -> (dim, blocks)``; ``None`` when
        its heads do not split."""
        if self.num_heads % model_parallel:
            return None
        return {"in_proj_weight": (0, 3), "in_proj_bias": (0, 3), "out_proj.weight": (1, 1)}

    def forward(self, x, mask, dtype, memory=None):
        """``x``: [B, Tq, D]; ``memory``: [B, Tk, D] or None; ``mask``: bool
        (True = attend) broadcastable to ``[B, heads, Tq, Tk]``, or None."""
        B, T, D = x.shape
        row = self.tp
        head_dim = D // self.num_heads
        if row is None:
            heads, w, b = self.num_heads, whole(self.in_proj_weight), whole(self.in_proj_bias)
        else:
            heads = self.num_heads // row.count
            x = copy_to_row(x, row)
            memory = None if memory is None else copy_to_row(memory, row)
            w = piece(self.in_proj_weight, row, 0, 3)
            b = piece(self.in_proj_bias, row, 0, 3)
        w, b, n = w.to(dtype), b.to(dtype), heads * head_dim
        if memory is None:
            q, k, v = F.linear(x.to(dtype), w, b).view(B, T, 3, heads, head_dim).unbind(2)
        else:
            q = F.linear(x.to(dtype), w[:n], b[:n]).view(B, T, heads, head_dim)
            k, v = F.linear(memory.to(dtype), w[n:], b[n:]).view(
                B, memory.shape[1], 2, heads, head_dim).unbind(2)
        q = q / math.sqrt(head_dim)
        weights = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            weights = weights.masked_fill(~mask, torch.finfo(dtype).min)
        weights = torch.softmax(weights.float(), dim=-1).to(dtype)
        if self.training and self.dropout > 0.0:
            keep = F.dropout(torch.ones((1, 1) + weights.shape[-2:], dtype=dtype,
                                        device=x.device), self.dropout)
            weights = weights * keep
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, T, n)
        if row is None:
            return dense(self.out_proj, out, dtype)
        out = F.linear(out, piece(self.out_proj.weight, row, 1).to(dtype))
        return reduce_from_row(out, row) + self.out_proj.bias.to(dtype)


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
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads, dropout)
        self.linear1 = nn.Linear(hidden_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.tp = None

    def tensor_parallel_pieces(self, model_parallel: int):
        """The feed-forward's tensors read in pieces over a row of
        ``model_parallel`` ranks, ``name -> (dim, blocks)``; ``None`` when
        its width does not split."""
        if self.linear1.weight.shape[0] % model_parallel:
            return None
        return {"linear1.weight": (0, 1), "linear1.bias": (0, 1), "linear2.weight": (1, 1)}

    def _norm(self, norm: nn.LayerNorm, x):
        return layer_norm(norm, x, self.compute_dtype)

    def _attn_block(self, x, key_mask):
        return self.dropout1(self.self_attn(x, key_mask[:, None, None, :],
                                            self.compute_dtype))

    def _ff_block(self, x):
        dt, row = self.compute_dtype, self.tp
        if row is None:
            h = self.dropout(self.activation(dense(self.linear1, x, dt)))
            return self.dropout2(dense(self.linear2, h, dt))
        h = F.linear(copy_to_row(x, row).to(dt), piece(self.linear1.weight, row, 0).to(dt),
                     piece(self.linear1.bias, row, 0).to(dt))
        h = self.activation(h)
        if self.training:
            # the whole layer's mask, drawn as one process draws it, cut to
            # this rank's channels
            keep = self.dropout(torch.ones(h.shape[:-1] + (h.shape[-1] * row.count,),
                                           dtype=h.dtype, device=h.device))
            h = h * cut_piece(keep, -1, 1, row.index, row.count)
        h = F.linear(h, piece(self.linear2.weight, row, 1).to(dt))
        return self.dropout2(reduce_from_row(h, row) + self.linear2.bias.to(dt))

    def forward(self, x, key_mask):
        if self.norm_first:
            x = x + self._attn_block(self._norm(self.norm1, x), key_mask)
            return x + self._ff_block(self._norm(self.norm2, x))
        x = self._norm(self.norm1, x + self._attn_block(x, key_mask))
        return self._norm(self.norm2, x + self._ff_block(x))


def _init_flax_(module: nn.Module, generator: Optional[torch.Generator]):
    """flax's initialisers on ``module``'s dense layers and attentions:
    lecun-normal kernels (q, k and v each of fan-in D), zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.weight.shape[1], generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, MultiHeadAttention):
            for w in m.in_proj_weight.chunk(3):
                lecun_normal_(w, w.shape[1], generator)
            nn.init.zeros_(m.in_proj_bias)


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer: self-attention over ``targets``,
    attention from ``targets`` to ``memory``, feed-forward; each sublayer
    with dropout, a residual add and a LayerNorm."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        activation: str = "gelu",
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.activation = F.gelu if activation == "gelu" else F.relu
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads, dropout)
        self.multihead_attn = MultiHeadAttention(hidden_dim, num_heads, dropout)
        self.linear1 = nn.Linear(hidden_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.norm3 = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.dropout3 = nn.Dropout(dropout)
        _init_flax_(self, generator)

    def forward(self, targets, memory, memory_mask=None, self_mask=None):
        """``targets``: [B, Tq, D]; ``memory``: [B, Tk, D]; ``memory_mask`` /
        ``self_mask``: bool attention masks (True = attend) broadcastable to
        ``[B, heads, Tq, Tk]`` / ``[B, heads, Tq, Tq]``, or None."""
        dt = self.compute_dtype
        h = self.self_attn(targets, self_mask, dt)
        targets = layer_norm(self.norm1, targets + self.dropout1(h), dt)
        h = self.multihead_attn(targets, memory_mask, dt, memory=memory)
        targets = layer_norm(self.norm2, targets + self.dropout2(h), dt)
        h = self.dropout(self.activation(dense(self.linear1, targets, dt)))
        h = dense(self.linear2, h, dt)
        return layer_norm(self.norm3, targets + self.dropout3(h), dt)


class InducedSetAttentionBlock(nn.Module):
    """ISAB (set transformer): a learned set of ``num_indices`` inducing
    points attends to the tokens, then the tokens attend to that summary,
    O(T * m) attention.  Tokens of another width than ``hidden_dim`` are
    projected first (``input_projection``).  The reference's own ISAB
    source is not at hand, so its names are the port's: ``inducing_points``
    ``[1, m, hidden]`` (flax's xavier-uniform: fan-in m, fan-out hidden),
    ``input_projection`` and ``layers.0`` / ``layers.1``."""

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        num_heads: int,
        num_indices: int = 8,
        dropout: float = 0.0,
        activation: str = "gelu",
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_projection = (nn.Linear(input_dim, hidden_dim)
                                 if input_dim != hidden_dim else None)
        self.inducing_points = nn.Parameter(torch.empty(1, num_indices, hidden_dim))
        self.layers = nn.ModuleList(
            DecoderLayer(hidden_dim, num_heads, dropout, activation, compute_dtype,
                         generator)
            for _ in range(2))
        if self.input_projection is not None:
            _init_flax_(self.input_projection, generator)
        bound = math.sqrt(6.0 / (num_indices + hidden_dim))
        with torch.no_grad():
            self.inducing_points.uniform_(-bound, bound, generator=generator)

    def forward(self, tokens, mask=None):
        """``tokens``: [B, T, input_dim]; ``mask``: [B, T] bool (True =
        real) or None.  The inducing points attend to the real tokens; every
        token attends to the real tokens, then to the whole summary."""
        if self.input_projection is not None:
            tokens = dense(self.input_projection, tokens, self.compute_dtype)
        inducing = whole(self.inducing_points).expand(tokens.shape[0], -1, -1).to(tokens.dtype)
        key_mask = None if mask is None else mask[:, None, None, :]
        summary = self.layers[0](inducing, tokens, memory_mask=key_mask)
        return self.layers[1](tokens, summary, self_mask=key_mask)


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
