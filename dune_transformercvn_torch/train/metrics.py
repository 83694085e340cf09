"""Streaming classification metrics: sufficient statistics on the device,
AUC on the host.

Port of ``dune_transformercvn_tpu/train/metrics.py``.  The state is a dict
of float32 tensors (correct counts, per-class histograms of the softmax
scores of positives and negatives, confusion matrices, the loss sum) that
each eval step adds to; :func:`finalize_metrics` turns it into accuracies
and macro one-vs-rest AUCs.  With B bins the AUC's discretisation error is
below 1/B.  The cross-device reduction waits for the data-parallel port
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def init_metric_state(num_event_classes: int, num_prong_classes: int, bins: int,
                      device=None) -> Dict[str, torch.Tensor]:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "event_correct": z(),
        "event_count": z(),
        "prong_correct": z(),
        "prong_count": z(),
        "event_pos": z(num_event_classes, bins),
        "event_neg": z(num_event_classes, bins),
        "prong_pos": z(num_prong_classes, bins),
        "prong_neg": z(num_prong_classes, bins),
        "event_confusion": z(num_event_classes, num_event_classes),
        "prong_confusion": z(num_prong_classes, num_prong_classes),
        "loss_sum": z(),
        "loss_count": z(),
    }


def _one_hot(targets, num_classes):
    return (targets.long()[..., None] == torch.arange(num_classes, device=targets.device)).float()


def _histogram_update(pos, neg, probs, targets, weights):
    """Add each (sample, class) score's weight to its bin of the class's
    positive or negative histogram."""
    num_classes, bins = pos.shape
    idx = (probs * bins).int().clamp(0, bins - 1).long()                 # [N, K]
    one_hot = _one_hot(targets.long().clamp(0, num_classes - 1), num_classes)
    w = weights[:, None]
    flat = (idx + torch.arange(num_classes, device=idx.device)[None, :] * bins).reshape(-1)
    pos.view(-1).index_add_(0, flat, (one_hot * w).reshape(-1))
    neg.view(-1).index_add_(0, flat, ((1.0 - one_hot) * w).reshape(-1))


def _confusion_update(matrix, targets, predictions, weights):
    k = matrix.shape[0]
    flat = targets.long().clamp(0, k - 1) * k + predictions
    matrix.view(-1).index_add_(0, flat, weights)


@torch.no_grad()
def update_metric_state(
    state: Dict[str, torch.Tensor],
    event_logits: torch.Tensor,   # [B, Kev] float32
    event_targets: torch.Tensor,  # [B]
    prong_logits: torch.Tensor,   # [B, P, Kpr]
    prong_targets: torch.Tensor,  # [B, P] (-1 padding)
    loss: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Add one batch to ``state`` in place and return it; rows with target
    ``-1`` are excluded."""
    ev_probs = torch.softmax(event_logits.float(), -1)
    ev_w = (event_targets >= 0).float()
    ev_pred = event_logits.argmax(-1)
    ev_correct = (ev_pred == event_targets).float() * ev_w

    kpr = prong_logits.shape[-1]
    pr_logits = prong_logits.reshape(-1, kpr)
    pr_targets = prong_targets.reshape(-1)
    pr_w = (pr_targets >= 0).float()
    pr_probs = torch.softmax(pr_logits.float(), -1)
    pr_pred = pr_logits.argmax(-1)
    pr_correct = (pr_pred == pr_targets).float() * pr_w

    _histogram_update(state["event_pos"], state["event_neg"], ev_probs, event_targets, ev_w)
    _histogram_update(state["prong_pos"], state["prong_neg"], pr_probs, pr_targets, pr_w)
    _confusion_update(state["event_confusion"], event_targets, ev_pred, ev_w)
    _confusion_update(state["prong_confusion"], pr_targets, pr_pred, pr_w)
    state["event_correct"] += ev_correct.sum()
    state["event_count"] += ev_w.sum()
    state["prong_correct"] += pr_correct.sum()
    state["prong_count"] += pr_w.sum()
    # weighted by valid events, so all-padding batches do not deflate it
    state["loss_sum"] += loss.float() * ev_w.sum()
    state["loss_count"] += ev_w.sum()
    return state


def _auc_from_histograms(pos: np.ndarray, neg: np.ndarray) -> np.ndarray:
    """Macro one-vs-rest AUC per class from score histograms:
    ``sum_b neg[b] * (pos_above[b] + 0.5 * pos[b]) / (P * N)``."""
    pos_above = pos[:, ::-1].cumsum(1)[:, ::-1] - pos  # strictly above each bin
    num = (neg * (pos_above + 0.5 * pos)).sum(1)
    denom = pos.sum(1) * neg.sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(denom > 0, num / np.maximum(denom, 1.0), np.nan)


def finalize_metrics(state) -> Dict[str, float]:
    """Host side: the reference's scalar tags from the sufficient statistics."""
    s = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
         for k, v in state.items()}
    event_acc = float(s["event_correct"] / max(s["event_count"], 1.0))
    prong_acc = float(s["prong_correct"] / max(s["prong_count"], 1.0))
    ev_auc_per_class = _auc_from_histograms(s["event_pos"], s["event_neg"])
    pr_auc_per_class = _auc_from_histograms(s["prong_pos"], s["prong_neg"])

    def macro(x):
        valid = np.isfinite(x)
        return float(x[valid].mean()) if valid.any() else float("nan")

    event_auc = macro(ev_auc_per_class)
    prong_auc = macro(pr_auc_per_class)
    return {
        "event_epoch_accuracy": event_acc,
        "prong_epoch_accuracy": prong_acc,
        "val_epoch_accuracy": (event_acc + prong_acc) / 2,
        "event_epoch_AUC": event_auc,
        "prong_epoch_AUC": prong_auc,
        "val_epoch_AUC": (event_auc + prong_auc) / 2,
        "val_loss": float(s["loss_sum"] / max(s["loss_count"], 1.0)),
        "event_auc_per_class": ev_auc_per_class,
        "prong_auc_per_class": pr_auc_per_class,
        "event_confusion": s["event_confusion"],
        "prong_confusion": s["prong_confusion"],
    }
