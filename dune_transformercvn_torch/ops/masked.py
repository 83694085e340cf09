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
  selective-checkpoint policy (JAX's ``save_only_these_names``).  It
  keeps no state on the host, so the same code runs eagerly, compiled
  (one Dynamo graph) and inside a CUDA graph's capture:

  - the checkpointed body is functional, as flax lifts ``batch_stats``
    through ``nn.remat``: a :class:`MaskedBatchNorm` inside it hands its
    running-statistic update back instead of writing its buffers; the
    body returns the updates of its first run as extra outputs, without
    gradient, and :func:`remat` applies each once, outside the
    checkpoint.  The recompute computes activations only;
  - the recompute uses the body's random draws (:class:`Dropout`,
    drop-path) of the first run.  Eagerly it draws them again from the
    generator state the checkpoint saved (``preserve_rng_state``).  Under
    ``torch.compile``, inside a CUDA graph's capture and in the graph
    train step's body (:func:`keep_draws`), where the host can neither
    read nor rewind a generator, they are kept from the first run
    instead (a selective-checkpoint policy marks every seeded op
    ``MUST_SAVE``): the same draws, so the same bits.

  Under tensor parallelism and sync-BN the recompute runs the body's
  collectives again (the partitioned forward's, sync-BN's all-reduce of
  the statistics).
* **Tensor parallelism.**  Both modules read this rank's piece of a
  sharded weight, bias or running statistic (``parallel.local``): a norm2
  or relu2 between a column- and a row-parallel convolution works on its
  rank's channels (``parallel/mesh.py``); every other one holds whole
  tensors.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from functools import partial
from typing import Callable, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

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
            # one all-reduce per layer instead of three small ones; a
            # remat recompute runs it again (its backward needs the
            # global statistics)
            channels = total.shape[0]
            packed = all_reduce_sum(torch.cat([total, total_sq, count.reshape(1)]),
                                    self.process_group)
            total, total_sq = packed[:channels], packed[channels:2 * channels]
            count = packed[-1]

        raw_count = count
        count = count.clamp(min=1.0)
        mean = total / count
        var = (total_sq / count - mean.square()).clamp(min=0.0)
        with torch.no_grad():
            # the momentum, 0 where the mask selects nothing
            m = self.momentum * (raw_count > 0).float()
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
        self.update_running_stats(m, mean.detach(), unbiased)
        return mean, var

    @torch.no_grad()
    def update_running_stats(self, m, mean, unbiased) -> None:
        """``running = (1 - m) * running + m * batch`` for the mean and
        the unbiased variance; inside a remat body, handed to it (it
        leaves the body as an output)."""
        if _PENDING:
            _PENDING[-1].append((self, (m, mean, unbiased)))
            return
        local(self.running_mean).mul_(1 - m).add_(m * mean)
        local(self.running_var).mul_(1 - m).add_(m * unbiased)


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose draw is one out-of-place op, so that a
    selective checkpoint can keep it (:func:`remat`): on CUDA the fused
    ``native_dropout`` that ``nn.Dropout`` runs there; on the CPU the
    out-of-place ``bernoulli`` of ``nn.Dropout``'s noise (laid out
    contiguously, where ``nn.Dropout`` draws into the input's layout in
    place), scaled by ``1 / (1 - p)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if x.is_cuda:
            return torch.native_dropout(x, self.p, True)[0]
        return x * (x.detach().bernoulli(1.0 - self.p) / (1.0 - self.p))


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


# one list a remat body being run: the running-statistic updates its
# BatchNorms handed back, innermost last
_PENDING: List[list] = []
# keep_draws contexts entered
_KEEP_DRAWS = [0]


@contextmanager
def keep_draws():
    """Inside it, :func:`remat` keeps its body's random draws from the first
    run instead of rewinding the generator for the recompute, as it does
    under ``torch.compile`` and in a CUDA graph's capture: the graph train
    step's body runs in it, so its warm-up, its capture and its run on the
    CPU take one path."""
    _KEEP_DRAWS[0] += 1
    try:
        yield
    finally:
        _KEEP_DRAWS[0] -= 1


def _keeps_draws(args) -> bool:
    """Whether this remat keeps its draws: compiled, in :func:`keep_draws`,
    or while a CUDA graph captures the current stream."""
    if torch.compiler.is_compiling() or _KEEP_DRAWS[0]:
        return True
    return (any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
            and torch.cuda.is_current_stream_capturing())


def _keep_draws(policy: Optional[Callable], ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: the outputs of seeded random ops are
    kept from the first run; every other op follows ``policy`` (default:
    recompute)."""
    if torch.Tag.nondeterministic_seeded in getattr(op, "tags", ()):
        return CheckpointPolicy.MUST_SAVE
    if policy is None:
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy(ctx, op, *args, **kwargs)


def remat(module: nn.Module, *args, call: Optional[Callable] = None,
          policy: Optional[Callable] = None):
    """``module(*args)`` (or ``call(*args)``, a function that runs
    ``module``), keeping only its inputs for the backward, which recomputes
    the rest (non-reentrant ``torch.utils.checkpoint``).

    The running-statistic updates of the module's BatchNorms leave the
    checkpointed body as outputs of its first run and are applied here,
    once (inside an enclosing remat body, handed on to it); the recompute
    computes activations only, with the first run's random draws: drawn
    again from the saved generator state eagerly, kept from the first run
    where the host cannot rewind a generator (:func:`_keeps_draws`; the
    selective-checkpoint mode this takes sends each op through Python, so
    the eager path runs without it).  ``policy``, a selective-checkpoint
    policy (``fn(ctx, op, *args, **kwargs) -> CheckpointPolicy``), keeps
    the outputs of the ops it marks ``MUST_SAVE`` instead of recomputing
    them.  Without autograd it is a plain call."""
    call = module if call is None else call
    if not torch.is_grad_enabled():
        return call(*args)
    norms = any(isinstance(m, MaskedBatchNorm) for m in module.modules())
    order: List[MaskedBatchNorm] = []   # the first run's BatchNorms, in call order

    def body(*args):
        if not norms:
            return call(*args), []
        _PENDING.append([])
        try:
            out = call(*args)
        finally:
            pending = _PENDING.pop()
        if not order:
            order.extend(norm for norm, _ in pending)
        return out, [t for _, update in pending for t in update]

    if _keeps_draws(args):
        contexts, rewind = partial(create_selective_checkpoint_contexts,
                                   partial(_keep_draws, policy)), False
    elif policy is not None:
        contexts, rewind = partial(create_selective_checkpoint_contexts, policy), True
    else:
        contexts, rewind = noop_context_fn, True
    out, updates = checkpoint(body, *args, use_reentrant=False, preserve_rng_state=rewind,
                              context_fn=contexts)
    for i, norm in enumerate(order):
        norm.update_running_stats(*updates[3 * i:3 * i + 3])
    return out
