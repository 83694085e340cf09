"""Mask-aware primitives: masked batch-norm and per-channel PReLU.

Port of ``dune_transformercvn_tpu/ops/masked.py``.  Static shapes keep padded
prong slots in the batch, so the normalisation statistics are weighted by a
per-sample (or per-site) mask, which equals running torch BatchNorm over the
packed real rows.  Tensors are channels-last: the channel axis is the last one.

Parameter and buffer names follow torch's ``BatchNorm``/``PReLU`` (``weight``,
``bias``, ``running_mean``, ``running_var``) so the reference ``state_dict``
loads as it is.

* **Cross-process sync-BN.**  :func:`sync_batch_norm` gives every
  :class:`MaskedBatchNorm` of a model a ``torch.distributed`` process group
  (the counterpart of the JAX package's ``axis_name``).  In training each
  layer then sums its packed float32 ``[total (C), total_sq (C), count]``
  over the group with one all-reduce, before the mean, the variance and the
  running-statistic update, so every rank normalises with the statistics of
  the global batch.  The all-reduce is autograd-aware: its backward sums the
  cotangent over the group, as ``lax.psum``'s transpose does.
* **Recompute.**  :func:`remat` runs a module under non-reentrant
  ``torch.utils.checkpoint`` (JAX's ``nn.remat``), optionally with a
  selective-checkpoint policy (JAX's ``save_only_these_names``).  The
  backward re-runs it with the random state of the first run, and the
  BatchNorms inside leave their running statistics alone during that
  re-run: JAX's functional remat updates them once.  Under tensor
  parallelism the re-run runs the partitioned forward again, its
  collectives included.
* **Tensor parallelism.**  Both modules read this rank's piece of a
  sharded weight, bias or running statistic (``parallel.local``): a norm2
  or relu2 between a column- and a row-parallel convolution works on its
  rank's channels (``parallel/mesh.py``); every other one holds whole
  tensors.
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..parallel.mesh import local, sum_over


class PReLU(nn.Module):
    """Per-channel parametric ReLU over the last axis; alpha starts at 0.25."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = local(self.weight).to(x.dtype)
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
        # the group the statistics are summed over (None: this process's
        # batch alone); set by sync_batch_norm
        self.process_group = None
        # > 0 while remat re-runs this layer: the running statistics stay
        self.frozen_stats = 0

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``x``: [N, ..., C]; ``mask``: None (all real), [N] per sample, or
        [N, *spatial] per site."""
        if self.training:
            mean, var = self._update_stats(x, mask)
        else:
            mean, var = local(self.running_mean), local(self.running_var)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * local(self.weight) + local(self.bias)).to(x.dtype)

    def _update_stats(self, x, mask):
        xf = x.float()
        dims = tuple(range(x.ndim - 1))
        if mask is None:
            # filled on the device: no copy from the host (a CUDA graph
            # cannot capture one)
            count = torch.full((), float(math.prod(x.shape[:-1])), device=x.device)
            total = xf.sum(dims)
            total_sq = xf.square().sum(dims)
        else:
            w = mask.float().reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
            # unmasked axes between the mask's and the channel axis
            spatial = math.prod(x.shape[mask.ndim:-1])
            count = w.sum() * spatial
            total = (xf * w).sum(dims)
            total_sq = (xf.square() * w).sum(dims)

        if self.process_group is not None:
            # one all-reduce per layer instead of three small ones
            channels = total.shape[0]
            packed = all_reduce_sum(torch.cat([total, total_sq, count.reshape(1)]),
                                    self.process_group)
            total, total_sq = packed[:channels], packed[channels:2 * channels]
            count = packed[-1]

        raw_count = count
        count = count.clamp(min=1.0)
        mean = total / count
        var = (total_sq / count - mean.square()).clamp(min=0.0)
        if self.frozen_stats:
            return mean, var

        with torch.no_grad():
            m = self.momentum * (raw_count > 0).float()
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            local(self.running_mean).mul_(1 - m).add_(m * mean)
            local(self.running_var).mul_(1 - m).add_(m * unbiased)
        return mean, var


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the cotangent over it."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return sum_over(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` summed over ``group``, differentiably: every rank's
    gradient of its input is the sum of all ranks' gradients of the output
    (a plain in-place ``all_reduce`` would leave each rank its own)."""
    return _AllReduceSum.apply(tensor, group)


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Sum the training statistics of every :class:`MaskedBatchNorm` of
    ``model`` over the process group ``group`` (``None`` turns it off), in
    the manner of ``nn.SyncBatchNorm.convert_sync_batchnorm`` but in place:
    no module or ``state_dict`` name changes.  Returns ``model``."""
    for module in model.modules():
        if isinstance(module, MaskedBatchNorm):
            module.process_group = group
    return model


@contextmanager
def _frozen(norms: Sequence[MaskedBatchNorm], inner=None):
    for norm in norms:
        norm.frozen_stats += 1
    try:
        with inner or nullcontext():
            yield
    finally:
        for norm in norms:
            norm.frozen_stats -= 1


def remat(module: nn.Module, *args, call: Optional[Callable] = None,
          policy: Optional[Callable] = None):
    """``module(*args)`` (or ``call(*args)``, a function that runs
    ``module``), keeping only its inputs for the backward, which recomputes
    the rest (non-reentrant ``torch.utils.checkpoint``).  The recompute
    draws the dropout of the first run and leaves the running statistics of
    the module's BatchNorms as the first run left them.  ``policy``, a
    selective-checkpoint policy (``fn(ctx, op, *args, **kwargs) ->
    CheckpointPolicy``), keeps the outputs of the ops it marks
    ``MUST_SAVE`` instead of recomputing them.  Without autograd it is a
    plain call."""
    call = module if call is None else call
    if not torch.is_grad_enabled():
        return call(*args)
    norms = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]

    def contexts():
        if policy is None:
            return nullcontext(), _frozen(norms)
        forward, recompute = create_selective_checkpoint_contexts(policy)
        return forward, _frozen(norms, recompute)

    return checkpoint(call, *args, use_reentrant=False, preserve_rng_state=True,
                      context_fn=contexts)
