"""Classification losses: softmax focal loss (the live trainer's loss),
sigmoid focal loss and class-balanced loss.

Port of ``dune_transformercvn_tpu/ops/losses.py``.  Every function is
mask-aware through weights rather than boolean indexing: rows with target
``-1`` (padding prongs, wrap-padded eval rows) drop out by weight.  Losses
are computed in float32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """JAX's ``one_hot``: float32 rows, all zero for a target outside
    ``[0, num_classes)``."""
    classes = torch.arange(num_classes, device=targets.device)
    return (targets.long()[..., None] == classes).float()


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def softmax_focal_loss(
    logits: torch.Tensor,                    # [N, K]
    targets: torch.Tensor,                   # [N] int
    gamma: float,
    weights: Optional[torch.Tensor] = None,  # [N] sample weights
) -> torch.Tensor:
    """Mean ``-(1 - p_t)^gamma * log(p_t)``; plain cross-entropy at gamma 0."""
    logits = logits.float()
    safe = targets.long().clamp(0, logits.shape[-1] - 1)
    log_pt = F.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
    if gamma == 0.0:
        loss = -log_pt
    else:
        loss = -log_pt * (1.0 - torch.exp(log_pt)) ** gamma
    if weights is None:
        return loss.mean()
    w = weights.float()
    return (loss * w).sum() / w.sum().clamp(min=1.0)


def split_event_targets(targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(current, generation) targets from the 10-class detailed event
    target: current = {0..3} -> 0, {4..7} -> 1, 8 -> 2, 9 -> 3; generation
    = target mod 4 where a generation exists (target < 8), else -1.
    Padding (-1) stays -1 in both."""
    t = targets
    current = torch.where(t < 8, torch.div(t, 4, rounding_mode="floor"), t - 6)
    generation = torch.where(t < 8, t % 4, torch.full_like(t, -1))
    invalid = t < 0
    return (torch.where(invalid, torch.full_like(t, -1), current),
            torch.where(invalid, torch.full_like(t, -1), generation))


def binary_event_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-class sigmoid BCE against one-hot targets, averaged over every
    (real row, class) cell."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    one_hot = _one_hot(targets, num_classes)
    w = (targets >= 0).float()[:, None]
    bce = _bce_with_logits(logits, one_hot)
    return (bce * w).sum() / (w.sum() * num_classes).clamp(min=1.0)


def sigmoid_focal_loss(
    labels: torch.Tensor,   # [N, K] one-hot float
    logits: torch.Tensor,   # [N, K]
    alpha: torch.Tensor,    # [N, K] per-example weights
    gamma: float,
) -> torch.Tensor:
    """Per-class sigmoid focal loss normalised by the positive count."""
    logits = logits.float()
    labels = labels.float()
    bce = _bce_with_logits(logits, labels)
    if gamma == 0.0:
        modulator = 1.0
    else:
        modulator = torch.exp(-gamma * labels * logits
                              - gamma * torch.log1p(torch.exp(-logits)))
    return (alpha * modulator * bce).sum() / labels.sum().clamp(min=1.0)


def class_balanced_loss(
    targets: torch.Tensor,   # [N] int
    logits: torch.Tensor,    # [N, K]
    beta: float,
    gamma: float,
    loss_type: str = "focal",
) -> torch.Tensor:
    """Class-balanced loss with the reference's class weights
    ``[1, 2, beta, 1/beta]``; a padding row (target < 0) has an all-zero
    one-hot row, so it adds nothing and is not counted."""
    num_classes = logits.shape[-1]
    # filled on the device, as a CUDA graph can capture: [1, 2, beta, 1/beta]
    class_weights = torch.ones(4, device=logits.device)
    for i, weight in ((1, 2.0), (2, beta), (3, 1.0 / beta)):
        class_weights[i].fill_(weight)
    class_weights = class_weights / class_weights.sum()
    one_hot = _one_hot(targets, num_classes)
    sample_w = (class_weights[None, :num_classes] * one_hot).sum(1, keepdim=True)
    alpha = sample_w.expand_as(one_hot)
    denom = (sample_w != 0).sum().clamp(min=1) * num_classes

    if loss_type == "focal":
        return sigmoid_focal_loss(one_hot, logits, alpha, gamma)
    if loss_type == "sigmoid":
        bce = _bce_with_logits(logits.float(), one_hot)
        return (alpha * bce).sum() / denom
    if loss_type == "softmax":
        probs = torch.softmax(logits.float(), -1).clamp(1e-7, 1 - 1e-7)
        bce = -(one_hot * torch.log(probs) + (1 - one_hot) * torch.log(1 - probs))
        return (alpha * bce).sum() / denom
    raise ValueError(f"unknown loss_type: {loss_type}")
