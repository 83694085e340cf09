"""Train and eval steps on one device.

Port of ``compute_losses``, ``event_metric_view``, ``make_train_step`` and
``make_eval_step`` (``dune_transformercvn_tpu/train/step.py``) without the
mesh: one device, one step per call (:class:`.loop.Trainer` drives them).
The data-parallel step and several steps per dispatch wait (ROADMAP.md).

* The loss is the weighted event/prong focal loss; padding rows (target
  ``-1``) drop out by weight.
* A train step: forward in train mode (batch statistics, pixel noise,
  dropout, BatchNorm running statistics updated), backward, the gradients'
  global norm (returned as ``grad_norm``, taken before clipping), optax's
  global-norm clipping, then AdamW at ``base_lr * schedule(step)`` with
  ``step`` counted before the update.
* Noise and dropout draw from the default generators, seeded for the step
  from ``state.generator`` inside ``torch.random.fork_rng``: a step is
  reproducible from the state, and the caller's random streams are left as
  they were.
* The forward, backward and optimizer parts of a step are profiler ranges
  (``train_step.*``), which :mod:`..profile_training` reads.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from ..ops.losses import (binary_event_loss, class_balanced_loss,
                          softmax_focal_loss, split_event_targets)
from .metrics import update_metric_state
from .optimizer import clip_by_global_norm_, global_norm
from .state import TrainState


def event_metric_view(event_logits, event_targets, num_generation_classes: int):
    """The (logits, targets) pair the classification metrics run on: in split
    mode the 4-way current head and the current targets."""
    if num_generation_classes:
        current_targets, _ = split_event_targets(event_targets)
        return event_logits[:, :-num_generation_classes], current_targets
    return event_logits, event_targets


def compute_losses(
    event_logits, prong_logits, event_targets, prong_targets, gamma, event_scale,
    *,
    num_generation_classes: int = 0,
    generation_scale: float = 0.5,
    loss_beta: float = 2.5,
    binary_event: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted event + masked prong focal loss, and the train metrics.

    ``num_generation_classes > 0``: the split trainer's two class-balanced
    focal losses over derived current/generation targets.
    ``binary_event``: per-class sigmoid BCE for the event term.
    """
    extra_metrics = {}
    if num_generation_classes:
        current_logits = event_logits[:, :-num_generation_classes]
        generation_logits = event_logits[:, -num_generation_classes:]
        current_targets, generation_targets = split_event_targets(event_targets)
        current_loss = class_balanced_loss(current_targets, current_logits,
                                           loss_beta, gamma, "focal")
        generation_loss = class_balanced_loss(generation_targets, generation_logits,
                                              loss_beta, gamma, "focal")
        event_loss = current_loss + generation_scale * generation_loss
        extra_metrics = {"current_loss": current_loss, "generation_loss": generation_loss}
        event_logits, event_targets = current_logits, current_targets
        event_weights = (event_targets >= 0).float()
    else:
        event_weights = (event_targets >= 0).float()
        if binary_event:
            event_loss = binary_event_loss(event_logits, event_targets)
        else:
            event_loss = softmax_focal_loss(event_logits, event_targets, gamma,
                                            event_weights)

    kpr = prong_logits.shape[-1]
    flat_logits = prong_logits.reshape(-1, kpr)
    flat_targets = prong_targets.reshape(-1)
    weights = (flat_targets >= 0).float()
    prong_loss = softmax_focal_loss(flat_logits, flat_targets, gamma, weights)

    total = event_scale * event_loss + (1.0 - event_scale) * prong_loss

    with torch.no_grad():
        event_correct = (event_logits.argmax(-1) == event_targets).float() * event_weights
        event_accuracy = event_correct.sum() / event_weights.sum().clamp(min=1.0)
        prong_correct = (flat_logits.argmax(-1) == flat_targets).float()
        prong_accuracy = (prong_correct * weights).sum() / weights.sum().clamp(min=1.0)

    return total, {
        "train_loss": total.detach(),
        "event_loss": event_loss.detach(),
        "prong_loss": prong_loss.detach(),
        "train_event_accuracy": event_accuracy,
        "train_prong_accuracy": prong_accuracy,
        **{k: v.detach() for k, v in extra_metrics.items()},
    }


def _loss_kwargs(options, model) -> Dict:
    """Options -> the loss variant; the generation-class count comes from the
    model config, which decides the widened head's split point."""
    if options.split_event_targets and options.event_binary_loss:
        raise ValueError(
            "split_event_targets and event_binary_loss are mutually "
            "exclusive event-loss variants; enable at most one")
    return dict(
        num_generation_classes=model.cfg.num_generation_classes,
        generation_scale=options.generation_loss_proportion,
        loss_beta=options.loss_beta,
        binary_event=options.event_binary_loss,
    )


def make_train_step(model, options) -> Callable[[TrainState, Dict], Dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics``: one optimizer step of
    ``state.model`` (``model`` fixes the loss variant) on a batch of tensors
    on the model's device.  Updates ``state`` in place; the metrics are
    0-d tensors on the device (no synchronisation), ``grad_norm`` included."""
    gamma = options.loss_gamma
    event_scale = options.event_prong_loss_proportion
    loss_kwargs = _loss_kwargs(options, model)
    clip = float(options.gradient_clip or 0.0)

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        net = state.model
        net.train()
        params = [p for p in net.parameters() if p.requires_grad]
        device = params[0].device
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.generator))
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(seed)
            with record_function("train_step.forward"):
                event_logits, prong_logits = net(batch, state.norm)
                total, metrics = compute_losses(
                    event_logits, prong_logits, batch["event_targets"],
                    batch["prong_targets"], gamma, event_scale, **loss_kwargs)
            with record_function("train_step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                total.backward()

        with record_function("train_step.optimizer"):
            # optax updates every leaf: a parameter the loss did not reach
            # gets a zero gradient (its decay still applies)
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            norm = global_norm(grads)
            if clip > 0:
                clip_by_global_norm_(grads, clip, norm)
            lr = state.base_lr * state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
        state.step += 1
        metrics["grad_norm"] = norm
        return metrics

    return step


def make_eval_step(model, options) -> Callable[[TrainState, Dict, Dict], Dict]:
    """``step(state, batch, totals) -> totals``: eval-mode forward and loss;
    the metric sufficient statistics of the batch are added to ``totals``
    (from :func:`.metrics.init_metric_state`) in place, on the device."""
    gamma = options.loss_gamma
    event_scale = options.event_prong_loss_proportion
    loss_kwargs = _loss_kwargs(options, model)
    num_generation = loss_kwargs["num_generation_classes"]

    @torch.no_grad()
    def step(state: TrainState, batch, totals):
        net = state.model
        net.eval()
        event_logits, prong_logits = net(batch, state.norm)
        total, _ = compute_losses(
            event_logits, prong_logits, batch["event_targets"], batch["prong_targets"],
            gamma, event_scale, **loss_kwargs)
        metric_logits, metric_targets = event_metric_view(
            event_logits, batch["event_targets"], num_generation)
        return update_metric_state(totals, metric_logits, metric_targets,
                                   prong_logits, batch["prong_targets"], total)

    return step
