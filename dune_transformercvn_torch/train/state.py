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
from typing import Any, Callable, Dict, Mapping

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

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the step, the model's parameters and
        BatchNorm buffers, AdamW's moments and step counts, the norm
        statistics and the generator's state.  Tensors are the live ones
        (the checkpoint manager copies them to the host); the schedule and
        base rate are rebuilt from the options."""
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "norm": dict(self.norm),
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Restore :meth:`state_dict`'s contents in place, bit for bit.
        The optimizer must have been built over the same parameters in the
        same groups (``create_optimizer`` on the same model config)."""
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        # torch.load's map_location moved AdamW's step counts to the
        # parameters' device; unless capturable or fused, AdamW keeps them
        # on the host (one device read per parameter and step otherwise)
        for group in self.optimizer.param_groups:
            if group.get("capturable") or group.get("fused"):
                continue
            for p in group["params"]:
                slot = self.optimizer.state.get(p, {})
                if "step" in slot:
                    slot["step"] = slot["step"].cpu()
        device = next(self.model.parameters()).device
        self.norm = {k: v.to(device) for k, v in state["norm"].items()}
        self.generator.set_state(state["generator"].cpu())


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
