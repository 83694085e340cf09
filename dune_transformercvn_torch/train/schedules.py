"""Learning-rate schedules as plain functions of the step counter.

Port of ``dune_transformercvn_tpu/train/schedules.py``: each factory returns
``schedule(step) -> multiplier`` (a Python float) of the base learning rate.
The train step evaluates it at the step count *before* the update, as optax
does, so a warmup's first step has learning rate 0.
"""

from __future__ import annotations

import math


def constant_schedule():
    return lambda step: 1.0


def constant_with_warmup(num_warmup_steps: int):
    def schedule(step):
        step = float(step)
        return step / max(1.0, num_warmup_steps) if step < num_warmup_steps else 1.0

    return schedule


def linear_with_warmup(num_warmup_steps: int, num_training_steps: int):
    def schedule(step):
        step = float(step)
        if step < num_warmup_steps:
            return step / max(1, num_warmup_steps)
        return max(0.0, (num_training_steps - step)
                   / max(1, num_training_steps - num_warmup_steps))

    return schedule


def cosine_with_warmup(num_warmup_steps: int, num_training_steps: int,
                       num_cycles: float = 0.5):
    def schedule(step):
        step = float(step)
        if step < num_warmup_steps:
            return step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def cosine_with_hard_restarts(num_warmup_steps: int, num_training_steps: int,
                              num_cycles: int = 1):
    def schedule(step):
        step = float(step)
        if step < num_warmup_steps:
            return step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        if progress >= 1.0:
            return 0.0
        phase = math.fmod(num_cycles * progress, 1.0)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * phase)))

    return schedule


def from_options(options, steps_per_epoch: int):
    """Linear-with-warmup when ``learning_rate_cycles < 1``, else cosine
    with hard restarts, as the reference trainer picks."""
    total_steps = steps_per_epoch * options.epochs
    warmup_steps = int(round(steps_per_epoch * options.learning_rate_warmup_epochs))
    if options.learning_rate_cycles < 1:
        return linear_with_warmup(warmup_steps, total_steps)
    return cosine_with_hard_restarts(warmup_steps, total_steps, options.learning_rate_cycles)
