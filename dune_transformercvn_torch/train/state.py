"""Training state: the step, the model with its BatchNorm buffers, the
optimizer and its schedule, the frozen dataset statistics, and a seeded
generator.

Port of ``dune_transformercvn_tpu/train/state.py``.  Where the JAX package
threads an immutable pytree through a jitted step, the port keeps one
mutable object that :func:`.step.make_train_step`'s step updates in place.
The random streams (pixel noise, dropout) come from ``generator`` and differ
from JAX's by design: the tests compare the two with both turned off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..predict import to_device
from .optimizer import create_optimizer
from .schedules import from_options


@dataclass
class TrainState:
    step: int                            # optimizer steps taken
    model: nn.Module                     # parameters and BatchNorm buffers
    optimizer: torch.optim.Optimizer     # AdamW and its moments
    schedule: Callable[[int], float]     # learning-rate multiplier of the step
    base_lr: float
    norm: Dict[str, torch.Tensor]        # dataset statistics, frozen
    generator: torch.Generator           # seeds each step's noise and dropout


def create_train_state(model: nn.Module, options, norm: Mapping[str, np.ndarray],
                       steps_per_epoch: int, seed: int = 0) -> TrainState:
    """A fresh state for ``model`` (already on its device): AdamW from
    ``options``, the schedule of ``options`` over ``steps_per_epoch``."""
    device = next(model.parameters()).device
    return TrainState(
        step=0,
        model=model,
        optimizer=create_optimizer(options, model),
        schedule=from_options(options, steps_per_epoch),
        base_lr=float(options.learning_rate),
        norm=to_device(norm, device),
        generator=torch.Generator().manual_seed(seed),
    )
