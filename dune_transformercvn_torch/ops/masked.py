"""Mask-aware primitives: masked batch-norm and per-channel PReLU.

Port of ``dune_transformercvn_tpu/ops/masked.py``.  Static shapes keep padded
prong slots in the batch, so the normalisation statistics are weighted by a
per-sample (or per-site) mask, which equals running torch BatchNorm over the
packed real rows.  Tensors are channels-last: the channel axis is the last one.

Parameter and buffer names follow torch's ``BatchNorm``/``PReLU`` (``weight``,
``bias``, ``running_mean``, ``running_var``) so the reference ``state_dict``
loads as it is.  Cross-replica sync-BN is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class PReLU(nn.Module):
    """Per-channel parametric ReLU over the last axis; alpha starts at 0.25."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.weight.to(x.dtype)
        return torch.where(x > 0, x, alpha * x)


class MaskedBatchNorm(nn.Module):
    """Batch normalisation over all but the last axis, with sample weights.

    torch ``BatchNorm`` semantics: the biased variance normalises, the
    unbiased variance updates the running stats with momentum 0.1, and eval
    mode uses the running stats verbatim.  Statistics are taken in float32
    and the result comes back in the input dtype.  When the mask selects
    nothing, the running stats are left as they were.
    """

    momentum = 0.1
    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``x``: [N, ..., C]; ``mask``: None (all real), [N] per sample, or
        [N, *spatial] per site."""
        if self.training:
            mean, var = self._update_stats(x, mask)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)

    def _update_stats(self, x, mask):
        xf = x.float()
        dims = tuple(range(x.ndim - 1))
        if mask is None:
            count = torch.tensor(
                float(math.prod(x.shape[:-1])), device=x.device)
            total = xf.sum(dims)
            total_sq = xf.square().sum(dims)
        else:
            w = mask.float().reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
            # unmasked axes between the mask's and the channel axis
            spatial = math.prod(x.shape[mask.ndim:-1])
            count = w.sum() * spatial
            total = (xf * w).sum(dims)
            total_sq = (xf.square() * w).sum(dims)

        raw_count = count
        count = count.clamp(min=1.0)
        mean = total / count
        var = (total_sq / count - mean.square()).clamp(min=0.0)

        with torch.no_grad():
            m = self.momentum * (raw_count > 0).float()
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * unbiased)
        return mean, var
