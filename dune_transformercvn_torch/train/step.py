"""Train and eval steps, on one device or data-parallel over processes.

Port of ``compute_losses``, ``event_metric_view``, ``make_train_step`` and
``make_eval_step`` (``dune_transformercvn_tpu/train/step.py``), one step per
call (:class:`.loop.Trainer` drives them).  In a process group of more than
one rank (:mod:`..parallel`) each rank steps on its own shard of the global
batch, as the JAX package's ``shard_map`` over the data axis does:

* the gradient is the mean over ranks of the per-rank losses' gradients,
  summed with one all-reduce of the flattened gradients after the backward;
  ``grad_norm`` and the clipping see the reduced gradient;
* the logged metrics are averaged over ranks (in the same all-reduce);
* without sync-BN (``options.sync_batch_norm`` off) the BatchNorm running
  statistics are averaged over ranks after the step (also in it), so every
  rank keeps the same state;
* each data shard draws its own noise and dropout: the shard's index is
  folded into the step's seed, while ``state.generator`` advances alike on
  every rank.

With tensor parallelism (a :class:`..parallel.Mesh` of ``mp > 1``) the ranks
of a TP row step on the same data shard with the same seed, so they draw
the same dropout and noise, as JAX's per-data-shard folds do, and the
partitioned layers compute 1/mp of their channels each (``parallel/mesh.py``).
The loss carries ``1 / world``; a sharded gradient, computed once a row,
is scaled by mp and summed over the "data" group (so are the sharded
running statistics of an unsynced run, with ``1 / dp``); the replicated
gradients, the metrics and the replicated statistics are summed over
every rank (each row holds mp equal copies, so that is the mean over the
data shards, and the row's replicas stay equal bit for bit).
``grad_norm`` counts each sharded gradient once, and the optimizer steps
the sharded parameters' pieces.

* The loss is the weighted event/prong focal loss; padding rows (target
  ``-1``) drop out by weight.
* A train step: forward in train mode (batch statistics, pixel noise,
  dropout, BatchNorm running statistics updated), backward, the gradients'
  global norm (returned as ``grad_norm``, taken before clipping), optax's
  global-norm clipping, then the optimizer at ``base_lr * schedule(step)`` with
  ``step`` counted before the update.
* Noise and dropout draw from the default generators, seeded for the step
  from ``state.generator`` inside ``torch.random.fork_rng``: a step is
  reproducible from the state, and the caller's random streams are left as
  they were.
* The forward, backward and optimizer parts of a step are profiler ranges
  (``train_step.*``), which :mod:`..profile_training` reads.

``compile=True`` is the counterpart of the JAX package's ``jax.jit``
(:func:`..utils.compile.compile_step`, one Inductor graph a batch shape):
the train step compiles its region from the network's forward through the
loss, and AOTAutograd gives it a compiled backward; the seed draw, the
zeroing of the gradients, the data-parallel all-reduce, the clipping and
the optimizer stay eager around it.  Sync-BN's all-reduce and the
tensor-parallel layers' collectives are traced into the graph.  The eval step compiles its forward through the metric
statistics.  Compiled dropout and pixel noise draw Inductor's Philox
offsets from the default generator the step seeds, so a compiled run is
reproducible from the state (its masks are not eager's).  Not with
``remat`` (``remat_cnn``, ``remat_embedder``, ``embedder_chunk``): that
raises (ROADMAP.md).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..ops.losses import (binary_event_loss, class_balanced_loss,
                          softmax_focal_loss, split_event_targets)
from ..ops.masked import MaskedBatchNorm
from ..parallel import Mesh, all_reduce_, default_mesh, local, shard_spec
from ..utils.compile import compile_step
from .metrics import update_metric_state
from .optimizer import clip_by_global_norm_, global_norm
from .state import TrainState

# folds the data shard into a step's seed (shard 0 keeps it): the 64-bit golden ratio
_RANK_STRIDE = 0x9E3779B97F4A7C15


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


def _check_compilable(model, train: bool):
    """What ``compile=True`` does not take yet raises here (ROADMAP.md)."""
    cfg = model.cfg
    if train and (cfg.remat_cnn or cfg.remat_embedder or cfg.embedder_chunk):
        raise ValueError("compile=True with remat_cnn, remat_embedder or embedder_chunk "
                         "is not supported: the recompute's BatchNorm freezing runs "
                         "eagerly")


def make_train_step(model, options, mesh: Optional[Mesh] = None, compile: bool = False,
                    shapes: int = 1
                    ) -> Callable[[TrainState, Dict], Dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics``: one optimizer step of
    ``state.model`` (``model`` fixes the loss variant) on a batch of tensors
    on the model's device -- this rank's data shard of the global batch when
    ``mesh`` (default: the process group, every rank a data shard) has more
    than one.  Updates ``state`` in place; the metrics are 0-d tensors on
    the device (no synchronisation on one device), ``grad_norm`` included.
    ``compile``: the forward and loss (and their backward) compiled, for up
    to ``shapes`` batch shapes."""
    gamma = options.loss_gamma
    event_scale = options.event_prong_loss_proportion
    loss_kwargs = _loss_kwargs(options, model)
    clip = float(options.gradient_clip or 0.0)
    mesh = mesh or default_mesh()

    def forward_loss(net, batch, norm):
        event_logits, prong_logits = net(batch, norm)
        return compute_losses(event_logits, prong_logits, batch["event_targets"],
                              batch["prong_targets"], gamma, event_scale, **loss_kwargs)

    if compile:
        _check_compilable(model, train=True)
        forward_loss = compile_step(forward_loss, shapes)
    size, shard = mesh.world_size, mesh.data_index
    # with sync-BN the statistics are already the global batch's
    stats = ([] if size == 1 or options.sync_batch_norm else
             [t for m in model.modules() if isinstance(m, MaskedBatchNorm)
              for t in (m.running_mean, m.running_var)])
    stat_pieces = [local(t) for t in stats if shard_spec(t) is not None]
    stats = [t for t in stats if shard_spec(t) is None]

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        net = state.model
        net.train()
        params = [p for p in net.parameters() if p.requires_grad]
        device = params[0].device
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.generator))
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed((seed + shard * _RANK_STRIDE) % 2 ** 64)
            with record_function("train_step.forward"):
                total, metrics = forward_loss(net, batch, state.norm)
            with record_function("train_step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                (total / size if size > 1 else total).backward()

        with record_function("train_step.optimizer"):
            # optax updates every leaf: a parameter the loss did not reach
            # gets a zero gradient (its decay still applies)
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            sharded = [local(g) for g in grads if shard_spec(g) is not None]
            if size > 1:
                # the gradients summed (each rank's loss carries 1/size),
                # the metrics and unsynced statistics averaged; a sharded
                # gradient, computed once a TP row, scaled by mp and summed
                # over the data shards, as the sharded statistics are
                keys = list(metrics)
                values = torch.stack([metrics[k] for k in keys]) / size
                if stats:
                    torch._foreach_div_(stats, size)
                all_reduce_([g for g in grads if shard_spec(g) is None] + [values] + stats)
                if sharded:
                    torch._foreach_mul_(sharded, mesh.mp)
                if stat_pieces:
                    torch._foreach_div_(stat_pieces, mesh.dp)
                if mesh.dp > 1 and sharded + stat_pieces:
                    all_reduce_(sharded + stat_pieces, mesh.data_group)
                metrics = dict(zip(keys, values.unbind()))
            norm = global_norm(grads)
            if clip > 0:
                clip_by_global_norm_(grads, clip, norm)
            lr = state.base_lr * state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            with _mixed_layouts() if sharded else nullcontext():
                state.optimizer.step()
        state.step += 1
        metrics["grad_norm"] = norm
        return metrics

    return step


def _mixed_layouts():
    """torch's optimizers step sharded and plain parameters in one list
    with the plain ones taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_eval_step(model, options, compile: bool = False,
                   shapes: int = 1) -> Callable[[TrainState, Dict, Dict], Dict]:
    """``step(state, batch, totals) -> totals``: eval-mode forward and loss;
    the metric sufficient statistics of the batch are added to ``totals``
    (from :func:`.metrics.init_metric_state`) in place, on the device.
    ``compile``: all of it compiled, for up to ``shapes`` batch shapes."""
    gamma = options.loss_gamma
    event_scale = options.event_prong_loss_proportion
    loss_kwargs = _loss_kwargs(options, model)
    num_generation = loss_kwargs["num_generation_classes"]

    def evaluate(net, batch, norm, totals):
        event_logits, prong_logits = net(batch, norm)
        total, _ = compute_losses(
            event_logits, prong_logits, batch["event_targets"], batch["prong_targets"],
            gamma, event_scale, **loss_kwargs)
        metric_logits, metric_targets = event_metric_view(
            event_logits, batch["event_targets"], num_generation)
        return update_metric_state(totals, metric_logits, metric_targets,
                                   prong_logits, batch["prong_targets"], total)

    if compile:
        _check_compilable(model, train=False)
        evaluate = compile_step(evaluate, shapes)

    @torch.no_grad()
    def step(state: TrainState, batch, totals):
        net = state.model
        net.eval()
        return evaluate(net, batch, state.norm, totals)

    return step
