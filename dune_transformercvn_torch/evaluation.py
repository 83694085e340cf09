"""Offline evaluation: exact metrics, prediction dumps, report rendering.

The port's own copy of ``dune_transformercvn_tpu/evaluation.py`` (numpy
only; h5py and matplotlib imported where they are used), held equal to it
by ``tests/test_torch_port_loop.py``.  The library half of the reference's
Evaluate.ipynb testing flow (cells 9-28): batched inference over a split,
``eval_predictions.h5`` dump, accuracy / precision / recall / one-vs-rest
ROC-AUC (weighted and per class), ROC curves, and confusion matrices.
Metrics here are exact (rank-statistic AUC
with tie handling, no histogram binning) and implemented in NumPy so the
harness has no sklearn dependency; the streaming (psum-able) variants used
during training live in train/metrics.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Exact metric primitives
# ---------------------------------------------------------------------------

def binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Mann-Whitney AUC with tie correction; labels in {0, 1}."""
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    all_scores = np.concatenate([pos, neg])
    order = np.argsort(all_scores, kind="mergesort")
    ranks = np.empty(len(all_scores))
    # average ranks over ties
    sorted_scores = all_scores[order]
    unique, inverse, counts = np.unique(
        sorted_scores, return_inverse=True, return_counts=True
    )
    cum = np.concatenate([[0], np.cumsum(counts)])
    avg_rank = (cum[:-1] + cum[1:] + 1) / 2.0
    ranks[order] = avg_rank[inverse]
    rank_sum_pos = ranks[: len(pos)].sum()
    u = rank_sum_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def multiclass_auc(
    probs: np.ndarray, targets: np.ndarray, average: Optional[str] = "weighted"
):
    """One-vs-rest multiclass ROC-AUC (sklearn ``roc_auc_score`` semantics
    for multi_class='ovr')."""
    num_classes = probs.shape[1]
    per_class = np.full(num_classes, np.nan)
    support = np.zeros(num_classes)
    for c in range(num_classes):
        labels = (targets == c).astype(np.int64)
        support[c] = labels.sum()
        per_class[c] = binary_auc(probs[:, c], labels)
    if average is None:
        return per_class
    valid = np.isfinite(per_class)
    if not valid.any():
        return float("nan")
    if average == "macro":
        return float(per_class[valid].mean())
    if average == "weighted":
        w = support[valid] / max(support[valid].sum(), 1.0)
        return float((per_class[valid] * w).sum())
    raise ValueError(f"unknown average: {average}")


def precision_recall(
    predictions: np.ndarray, targets: np.ndarray, num_classes: int,
    average: str = "weighted",
) -> Tuple[float, float]:
    cm = confusion_matrix(predictions, targets, num_classes)
    tp = np.diag(cm).astype(np.float64)
    predicted = cm.sum(0).astype(np.float64)
    actual = cm.sum(1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        precision_c = np.where(predicted > 0, tp / predicted, 0.0)
        recall_c = np.where(actual > 0, tp / actual, 0.0)
    if average == "weighted":
        w = actual / max(actual.sum(), 1.0)
        return float((precision_c * w).sum()), float((recall_c * w).sum())
    if average == "macro":
        return float(precision_c.mean()), float(recall_c.mean())
    raise ValueError(average)


def confusion_matrix(predictions, targets, num_classes: int) -> np.ndarray:
    """Rows = true class, columns = predicted class."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (targets, predictions), 1)
    return cm


def roc_curve(scores: np.ndarray, labels: np.ndarray):
    """(fpr, tpr, thresholds) for a binary problem, descending thresholds."""
    order = np.argsort(-scores, kind="mergesort")
    scores, labels = scores[order], labels[order]
    distinct = np.where(np.diff(scores))[0]
    idx = np.concatenate([distinct, [len(scores) - 1]])
    tps = np.cumsum(labels)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    p = max(labels.sum(), 1)
    n = max(len(labels) - labels.sum(), 1)
    # prepend the (0, 0) origin anchor (sklearn's threshold=inf point) so
    # plotted curves start at the origin even when scores tie at the top
    fpr = np.concatenate([[0.0], fps / n])
    tpr = np.concatenate([[0.0], tps / p])
    thresholds = np.concatenate([[np.inf], scores[idx]])
    return fpr, tpr, thresholds


# ---------------------------------------------------------------------------
# Full-report evaluation
# ---------------------------------------------------------------------------

def evaluate_predictions(
    event_probs: np.ndarray,     # [N, Kev]
    event_targets: np.ndarray,   # [N]
    prong_probs: np.ndarray,     # [M, Kpr]  (real prongs only)
    prong_targets: np.ndarray,   # [M]
) -> Dict[str, object]:
    kev, kpr = event_probs.shape[1], prong_probs.shape[1]
    ev_pred = event_probs.argmax(1)
    pr_pred = prong_probs.argmax(1)

    ev_precision, ev_recall = precision_recall(ev_pred, event_targets, kev)
    pr_precision, pr_recall = precision_recall(pr_pred, prong_targets, kpr)

    return {
        "event_accuracy": float((ev_pred == event_targets).mean()),
        "event_precision": ev_precision,
        "event_recall": ev_recall,
        "event_auc": multiclass_auc(event_probs, event_targets, "weighted"),
        "event_auc_per_class": multiclass_auc(event_probs, event_targets, None),
        "event_confusion": confusion_matrix(ev_pred, event_targets, kev),
        "prong_accuracy": float((pr_pred == prong_targets).mean()),
        "prong_precision": pr_precision,
        "prong_recall": pr_recall,
        "prong_auc": multiclass_auc(prong_probs, prong_targets, "weighted"),
        "prong_auc_per_class": multiclass_auc(prong_probs, prong_targets, None),
        "prong_confusion": confusion_matrix(pr_pred, prong_targets, kpr),
    }


def save_predictions_h5(
    path: str,
    event_probs, event_targets, prong_probs, prong_targets,
    prong_event_index=None,
):
    """Dump predictions in the shape the reference writes
    (Evaluate.ipynb cell 21: eval_predictions.h5)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("event_probabilities", data=event_probs)
        f.create_dataset("event_targets", data=event_targets)
        f.create_dataset("prong_probabilities", data=prong_probs)
        f.create_dataset("prong_targets", data=prong_targets)
        if prong_event_index is not None:
            f.create_dataset("prong_event_index", data=prong_event_index)


def _fit_names(names, num_classes: int):
    """Class-name list sized to the probability columns (10-class models
    evaluated with the 4 coarse names would otherwise crash/skew plots)."""
    names = list(names)
    if len(names) == num_classes:
        return names
    return [
        names[i] if i < len(names) else f"class_{i}" for i in range(num_classes)
    ]


def confusion_figure(matrix: np.ndarray, names, title: str = ""):
    """Row-normalized confusion heatmap; the one shared renderer used by
    both the offline plots and the TensorBoard validation figures."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    matrix = np.asarray(matrix, dtype=np.float64)
    names = _fit_names(names, matrix.shape[0])
    with np.errstate(invalid="ignore"):
        norm = matrix / np.maximum(matrix.sum(1, keepdims=True), 1.0)
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
    ax.set_xticks(range(len(names)), names, rotation=45, ha="right", fontsize=7)
    ax.set_yticks(range(len(names)), names, fontsize=7)
    if len(names) <= 12:
        for i in range(len(names)):
            for j in range(len(names)):
                ax.text(j, i, f"{norm[i, j]:.2f}", ha="center", va="center",
                        fontsize=7,
                        color="white" if norm[i, j] > 0.5 else "black")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    if title:
        ax.set_title(title)
    fig.colorbar(im)
    fig.tight_layout()
    return fig


def save_plots(
    output_dir: str,
    event_probs, event_targets, prong_probs, prong_targets,
    event_names, prong_names,
) -> list:
    """ROC-curve and confusion-matrix figures (Evaluate.ipynb cells 25-28).

    Returns the list of written files. Uses matplotlib's Agg backend.
    """
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    written = []
    event_names = _fit_names(event_names, event_probs.shape[1])
    prong_names = _fit_names(prong_names, prong_probs.shape[1])

    def roc_figure(probs, targets, names, title, path):
        fig, ax = plt.subplots(figsize=(7, 6))
        for c, name in enumerate(names):
            labels = (targets == c).astype(np.int64)
            if labels.sum() == 0 or labels.sum() == len(labels):
                continue
            fpr, tpr, _ = roc_curve(probs[:, c], labels)
            auc = binary_auc(probs[:, c], labels)
            ax.plot(fpr, tpr, label=f"{name} (AUC {auc:.3f})")
        ax.plot([0, 1], [0, 1], "k--", linewidth=0.8)
        ax.set_xlabel("False positive rate")
        ax.set_ylabel("True positive rate")
        ax.set_title(title)
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    def save_confusion(predictions, targets, names, title, path):
        cm = confusion_matrix(predictions, targets, len(names))
        fig = confusion_figure(cm, names, title)
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    roc_figure(event_probs, event_targets, event_names, "Event ROC",
               os.path.join(output_dir, "event_roc.png"))
    roc_figure(prong_probs, prong_targets, prong_names, "Prong ROC",
               os.path.join(output_dir, "prong_roc.png"))
    save_confusion(event_probs.argmax(1), event_targets, event_names,
                   "Event confusion", os.path.join(output_dir, "event_confusion.png"))
    save_confusion(prong_probs.argmax(1), prong_targets, prong_names,
                   "Prong confusion", os.path.join(output_dir, "prong_confusion.png"))
    return written


def render_report(results: Dict[str, object], event_names, prong_names) -> str:
    lines = []
    lines.append("=" * 72)
    lines.append("Event classification")
    lines.append("-" * 72)
    lines.append(
        f"accuracy {results['event_accuracy']:.3f}  "
        f"precision {results['event_precision']:.3f}  "
        f"recall {results['event_recall']:.3f}  "
        f"ROC-AUC (weighted OVR) {results['event_auc']:.3f}"
    )
    for name, auc in zip(event_names, results["event_auc_per_class"]):
        lines.append(f"  AUC {name:28}: {auc:.3f}")
    lines.append("confusion (rows=true, cols=pred):")
    for row in results["event_confusion"]:
        lines.append("  " + " ".join(f"{v:7d}" for v in row))
    lines.append("=" * 72)
    lines.append("Prong classification")
    lines.append("-" * 72)
    lines.append(
        f"accuracy {results['prong_accuracy']:.3f}  "
        f"precision {results['prong_precision']:.3f}  "
        f"recall {results['prong_recall']:.3f}  "
        f"ROC-AUC (weighted OVR) {results['prong_auc']:.3f}"
    )
    for name, auc in zip(prong_names, results["prong_auc_per_class"]):
        lines.append(f"  AUC {name:28}: {auc:.3f}")
    lines.append("confusion (rows=true, cols=pred):")
    for row in results["prong_confusion"]:
        lines.append("  " + " ".join(f"{v:7d}" for v in row))
    lines.append("=" * 72)
    return "\n".join(lines)
