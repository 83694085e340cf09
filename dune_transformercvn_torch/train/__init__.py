"""Training of the port, on one device or data-parallel over processes:
losses in :mod:`..ops.losses`, schedules, the optimizers, the train state, metrics,
the train/eval steps, checkpoints, metric logging and the :class:`Trainer`
loop (``python -m dune_transformercvn_torch.train`` is its CLI)."""

from .checkpoint import CheckpointManager, restore_from_path
from .loop import Trainer
from .metrics import finalize_metrics, init_metric_state, update_metric_state
from .optimizer import create_optimizer, decay_mask
from .state import TrainState, create_train_state
from .step import compute_losses, make_eval_step, make_train_step

__all__ = [
    "CheckpointManager",
    "TrainState",
    "Trainer",
    "compute_losses",
    "create_optimizer",
    "create_train_state",
    "decay_mask",
    "finalize_metrics",
    "init_metric_state",
    "make_eval_step",
    "make_train_step",
    "restore_from_path",
    "update_metric_state",
]
