"""Metric logging: TensorBoard event files (reference-compatible tags) with a
JSONL fallback.

The port's own copy of ``dune_transformercvn_tpu/train/logging.py``.  The
reference logs per-step training scalars and epoch validation metrics to
TensorBoard (train.py:105, neutrino_full_base_trainer.py:185-224); its
Evaluate notebook reads those event files back by tag.  This writer keeps the
exact tag names (train_loss, event_loss, prong_loss, train_event_accuracy,
train_prong_accuracy, val_epoch_accuracy/AUC, event/prong_epoch_accuracy/AUC,
lr-AdamW/pg1) so the history-reading half of the evaluation harness works
unchanged.  Scalars always go to ``metrics.jsonl`` in the run dir too, and if
no TensorBoard backend is importable (a GPU host may lack ``tensorboard``)
the history reader consumes that.

TensorBoard reads and writes event files through its TensorFlow-free stub
(``tensorboard.compat.notf``, its "no_tensorflow" mode): the port needs no
TensorFlow, and importing one where it is installed costs a process ~12 s
before its first step.  A process that resolved TensorBoard's ``tf`` before
(through real TensorFlow) keeps it; the event files are the same.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types
from typing import Dict


def _without_tensorflow() -> None:
    """Mark TensorBoard's TensorFlow-free mode before its ``tf`` resolves."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))


class MetricLogger:
    def __init__(self, run_dir: str, enabled: bool = True):
        self.run_dir = run_dir
        self.enabled = enabled
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(run_dir, exist_ok=True)
        try:
            _without_tensorflow()
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=run_dir)
        except Exception:
            pass
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log_scalars(self, scalars: Dict[str, float], step: int):
        if not self.enabled:
            return
        clean = {
            k: float(v)
            for k, v in scalars.items()
            if isinstance(v, (int, float)) or getattr(v, "ndim", None) == 0
        }
        if self._tb is not None:
            for key, value in clean.items():
                self._tb.add_scalar(key, value, step)
        if self._jsonl is not None:
            self._jsonl.write(
                json.dumps({"step": int(step), "time": time.time(), **clean}) + "\n"
            )
            self._jsonl.flush()

    def log_confusion(self, tag: str, matrix, class_names, step: int):
        """Render a confusion matrix into TensorBoard (the legacy trainers'
        TB confusion figures, e.g. neutrino_trainer.py:96-111)."""
        if not self.enabled or self._tb is None:
            return
        try:
            import matplotlib.pyplot as plt

            from ..evaluation import confusion_figure

            fig = confusion_figure(matrix, class_names)
            self._tb.add_figure(tag, fig, step)
            plt.close(fig)
        except Exception:
            pass

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        self.flush()
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


def read_history(run_dir: str) -> Dict[str, list]:
    """Read back logged scalars as {tag: [(step, value), ...]}.

    Prefers TensorBoard event files (the reference Evaluate.ipynb flow),
    falling back to metrics.jsonl.  A resumed run's event files are read
    in the order they were written: their names number them without
    padding (``...9`` sorts after ``...10``), so each tag's events are
    put in wall-time order.
    """
    history: Dict[str, list] = {}
    try:
        _without_tensorflow()
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )

        acc = EventAccumulator(run_dir, size_guidance={"scalars": 0})
        acc.Reload()
        for tag in acc.Tags().get("scalars", []):
            history[tag] = [(e.step, e.value) for e in
                            sorted(acc.Scalars(tag), key=lambda e: e.wall_time)]
        if history:
            return history
    except Exception:
        pass

    path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                step = row.pop("step")
                row.pop("time", None)
                for key, value in row.items():
                    history.setdefault(key, []).append((step, value))
    return history
