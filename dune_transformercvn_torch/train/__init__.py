"""Training of the port on one device: losses in :mod:`..ops.losses`,
schedules, AdamW, the train state, metrics and the train/eval steps."""

from .metrics import finalize_metrics, init_metric_state, update_metric_state
from .optimizer import create_optimizer, decay_mask
from .state import TrainState, create_train_state
from .step import compute_losses, make_eval_step, make_train_step

__all__ = [
    "TrainState",
    "compute_losses",
    "create_optimizer",
    "create_train_state",
    "decay_mask",
    "finalize_metrics",
    "init_metric_state",
    "make_eval_step",
    "make_train_step",
    "update_metric_state",
]
