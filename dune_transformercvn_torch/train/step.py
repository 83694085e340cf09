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
tensor-parallel layers' collectives are traced into the graph.  The eval
step compiles its forward through the metric statistics.  Compiled
dropout and pixel noise draw Inductor's Philox offsets from the default
generator the step seeds, so a compiled run is reproducible from the
state (its masks are not eager's).  The memory recipes (``remat_cnn``,
``remat_embedder``, ``embedder_chunk``, :func:`..ops.masked.remat`)
compile into the same one graph: each rematted region a checkpoint region
whose backward recomputes it, the running statistics updated once a step
outside it, the dropout masks drawn in the forward kept for the backward
(the backward graph draws nothing), and the chunks of a bank calls of one
region traced once (JAX's ``nn.scan``).  A graph break raises.

``graph=True`` is the counterpart of the JAX package's dispatch: on the
card the train step is one CUDA graph of ``steps_per_dispatch`` K whole
steps over K stacked batches (its ``lax.scan``; :func:`make_graph_train_step`)
and the eval step one graph a batch shape (:mod:`..utils.graphs`).  The
graph holds the forward (a remat recipe's recompute in its backward), the
backward, the gradients' norm, the clipping and the optimizer's update
(the graph-safe AdamW or any optax chain: :class:`.optimizer.GraphSafe`);
outside it stay the draws of each step's seed from ``state.generator``,
the schedule's rates, the copies of the batches and the norm statistics
into the graph's buffers, and the copy of the stacked metrics out.  It
composes with ``compile`` (the compiled forward and loss, warmed up before
the capture, run inside the graph).  In a process group (one process a
card, ``nccl``) the graph holds the step's data-parallel work as the
eager step runs it: each data shard's seed, the loss's ``1 / world``, the
same all-reduces in the same order and grouping (one function,
:func:`_reduction`, for both), sync-BN's and the tensor-parallel row's
collectives and ``global_norm``'s, so a replay's K steps are K eager
data-parallel steps bit for bit, the counterpart of the JAX package's
``shard_map`` of its ``lax.scan`` over the data axis.
:func:`check_graphable` raises for what it does not take: a group whose
collectives are not nccl's on the card (gloo with CUDA tensors), and int8
convolutions in a train step (the JAX package quantizes inference only).
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from ..ops.losses import (binary_event_loss, class_balanced_loss,
                          softmax_focal_loss, split_event_targets)
from ..ops import quant
from ..ops.masked import MaskedBatchNorm, keep_draws
from ..parallel import Mesh, all_reduce_, default_mesh, group_backend, local, shard_spec
from ..utils.compile import compile_step
from ..utils.graphs import StepGraphs
from .metrics import update_metric_state
from .optimizer import clip_by_global_norm_, global_norm, graph_safe
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


def check_graphable(mesh: Optional[Mesh], device, train: bool = False):
    """What ``graph=True`` does not take raises here (ROADMAP.md item 20): a
    process group of more than one rank on CUDA tensors whose backend is
    not nccl (gloo stages its collectives on the host, which a capture
    cannot record, and puts several ranks on one card), and, for a
    ``train`` step, int8 convolutions: the JAX package's int8 context is an
    inference transform (``ops/quant.py``: post-training quantization, whose
    rounding has no gradient), which its train step never runs.  The eval
    and predict steps take it.  On the CPU a group's graph step runs
    uncaptured, over gloo."""
    mesh = mesh or default_mesh()
    backend = group_backend()
    if mesh.world_size > 1 and torch.device(device).type == "cuda" and backend != "nccl":
        raise ValueError(
            f"graph=True in a process group of {mesh.world_size} ranks captures its "
            f"collectives on nccl, one process a card; this group's backend is {backend} "
            "(gloo stages its collectives on the host, which a CUDA graph cannot capture)")
    if train and quant.active():
        raise RuntimeError("a train step does not run int8 convolutions "
                           "(ops.quant.quantized_convs quantizes for inference, as the "
                           "JAX package's context does; its rounding has no gradient)")


def _shard_seed(seed: int, shard: int) -> int:
    """The seed data shard ``shard``'s draws of a step take (shard 0 keeps
    the step's ``seed``)."""
    return (seed + shard * _RANK_STRIDE) % 2 ** 64


def _reduction(model, options, mesh: Mesh) -> Callable:
    """``reduce(metrics, grads) -> metrics``: a step's data-parallel work
    after the backward, the same for the eager and the graph step.  In a
    world of one it returns ``metrics``.  Else the gradients summed (each
    rank's loss carries 1/size), the metrics and unsynced statistics
    averaged, in one all-reduce over every rank; a sharded gradient,
    computed once a TP row, scaled by mp and summed over the data shards,
    as the sharded statistics are."""
    size = mesh.world_size
    if size == 1:
        return lambda metrics, grads: metrics
    # with sync-BN the statistics are already the global batch's
    stats = ([] if options.sync_batch_norm else
             [t for m in model.modules() if isinstance(m, MaskedBatchNorm)
              for t in (m.running_mean, m.running_var)])
    stat_pieces = [local(t) for t in stats if shard_spec(t) is not None]
    stats = [t for t in stats if shard_spec(t) is None]

    def reduce(metrics, grads):
        sharded = [local(g) for g in grads if shard_spec(g) is not None]
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
        return dict(zip(keys, values.unbind()))

    return reduce


def make_train_step(model, options, mesh: Optional[Mesh] = None, compile: bool = False,
                    shapes: int = 1, graph: bool = False, steps_per_dispatch: int = 1
                    ) -> Callable[[TrainState, Dict], Dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics``: one optimizer step of
    ``state.model`` (``model`` fixes the loss variant) on a batch of tensors
    on the model's device -- this rank's data shard of the global batch when
    ``mesh`` (default: the process group, every rank a data shard) has more
    than one.  Updates ``state`` in place; the metrics are 0-d tensors on
    the device (no synchronisation on one device), ``grad_norm`` included.
    ``compile``: the forward and loss (and their backward) compiled, for up
    to ``shapes`` batch shapes.  ``graph``: :func:`make_graph_train_step`'s
    step, ``steps_per_dispatch`` steps a call."""
    gamma = options.loss_gamma
    event_scale = options.event_prong_loss_proportion
    loss_kwargs = _loss_kwargs(options, model)
    clip = float(options.gradient_clip or 0.0)
    mesh = mesh or default_mesh()

    def forward_loss(net, batch, norm):
        event_logits, prong_logits = net(batch, norm)
        return compute_losses(event_logits, prong_logits, batch["event_targets"],
                              batch["prong_targets"], gamma, event_scale, **loss_kwargs)

    if graph:
        check_graphable(mesh, next(model.parameters()).device, train=True)
    elif steps_per_dispatch != 1:
        raise ValueError("steps_per_dispatch > 1 runs as one CUDA graph: pass graph=True")
    if compile:
        forward_loss = compile_step(forward_loss, shapes)
    reduce = _reduction(model, options, mesh)
    if graph:
        return make_graph_train_step(forward_loss, clip, shapes, steps_per_dispatch,
                                     mesh, reduce)
    size, shard = mesh.world_size, mesh.data_index

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        net = state.model
        net.train()
        params = [p for p in net.parameters() if p.requires_grad]
        device = params[0].device
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.generator))
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(_shard_seed(seed, shard))
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
            metrics = reduce(metrics, grads)
            norm = global_norm(grads)
            if clip > 0:
                clip_by_global_norm_(grads, clip, norm)
            lr = state.base_lr * state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            sharded = any(shard_spec(g) is not None for g in grads)
            with _mixed_layouts() if sharded else nullcontext():
                state.optimizer.step()
        state.step += 1
        metrics["grad_norm"] = norm
        return metrics

    return step


@contextmanager
def _seeded_cpu(seed: int):
    """An eager step's draws on the CPU: the default generators seeded
    with the step's seed, the caller's streams left as they were."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


@contextmanager
def _seeded_graph(device, state: torch.Generator):
    """Inside a CUDA graph: ``device``'s default generator reads ``state``
    (registered with the graph and seeded before each replay), so the
    step draws what an eager step seeded alike draws."""
    default = torch.cuda.default_generators[device.index or 0]
    original = default.graphsafe_get_state()
    default.graphsafe_set_state(state)
    try:
        yield
    finally:
        default.graphsafe_set_state(original)


def make_graph_train_step(forward_loss, clip: float, shapes: int, steps: int, mesh: Mesh,
                          reduce: Callable):
    """The train step as one CUDA graph of ``steps`` K whole steps
    (forward, backward, the gradients' norm, clipping, the graph-safe
    optimizer's update), the counterpart of the JAX
    package's ``lax.scan`` over K stacked batches (``steps_per_dispatch``).
    In a process group (``mesh``) each step also does the eager step's
    data-parallel work (``reduce``, from :func:`_reduction`): this rank's
    data shard draws from its own seed, the loss carries ``1 / world``,
    and the step's all-reduces, sync-BN's, the TP row's and
    ``global_norm``'s run inside the graph, on nccl; every rank captures
    and replays in lockstep (:mod:`..utils.graphs`).

    ``step(state, batches) -> metrics``: K > 1 takes K stacked batches
    (every leaf ``[K, ...]``) and returns each metric stacked ``[K]``, as
    JAX's scanned step does; K = 1 takes one batch and returns 0-d
    metrics.  Step k of a call computes what the k-th eager step
    (:func:`make_train_step`) from the same state computes: the host draws
    its seed from ``state.generator`` and its rate from the schedule at
    ``state.step + k`` before the replay, the graph reads the K rates from
    a device buffer, and step k's noise and dropout draw from the k-th
    generator state registered with the graph, seeded with that seed (a
    remat recompute draws nothing: it keeps the forward's draws,
    :func:`..ops.masked.keep_draws`).
    Every gradient stays allocated (zeroed in place before each backward),
    the optimizer's state is restored in place on resume
    (``TrainState.load_state_dict``), and the norm statistics are copied in
    with the batches, so the graph keeps reading live memory.  The first
    call of a batch shape warms the body up (the state it changed put
    back) and captures it, up to ``shapes`` shapes (:mod:`..utils.graphs`).

    On a state whose model is on the CPU the same body runs without a
    capture: each step seeded as the eager step seeds, the rates read
    from a CPU tensor; the tests hold it to JAX there.  On CUDA it never
    runs uncaptured."""
    size, shard = mesh.world_size, mesh.data_index
    names: List[str] = []
    bound = {"state": None}

    def body(state, batches, norm, lrs, rng):
        net = state.model
        net.train()
        params = [p for p in net.parameters() if p.requires_grad]
        grads = [p.grad for p in params]
        pieces = [local(g) for g in grads]
        rows = []
        for k in range(steps):
            batch = {n: v[k] for n, v in batches.items()}
            with rng(k), keep_draws():
                with record_function("train_step.forward"):
                    total, metrics = forward_loss(net, batch, norm)
                with record_function("train_step.backward"):
                    torch._foreach_zero_(pieces)
                    (total / size if size > 1 else total).backward()
            with record_function("train_step.optimizer"):
                metrics = reduce(metrics, grads)
                norm_ = global_norm(grads)
                if clip > 0:
                    clip_by_global_norm_(grads, clip, norm_)
                state.optimizer.step(lr=lrs[k])
            metrics["grad_norm"] = norm_
            if not names:
                names.extend(metrics)
            rows.append(torch.stack([metrics[n].float() for n in names]))
        return torch.stack(rows)

    def graph_body(batches, norm, lrs, states):
        rates = lrs["lrs"]
        return body(bound["state"], batches, norm, rates,
                    lambda k: _seeded_graph(rates.device, states[k]))

    @contextmanager
    def put_back():
        """The warm-up's steps leave the state as it was."""
        with torch.no_grad():
            live = [local(t) for t in _state_tensors(bound["state"])]
            kept = [t.clone() for t in live]
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(live, kept)

    graphs = StepGraphs(graph_body, "train step graph", shapes, steps, put_back,
                        lockstep=size > 1)

    def step(state: TrainState, batches) -> Dict[str, torch.Tensor]:
        if steps > 1:
            leading = {v.shape[0] for v in batches.values()}
            if leading != {steps}:
                raise ValueError(f"a {steps}-step graph takes {steps} stacked batches "
                                 f"(every leaf [{steps}, ...]), got leading sizes {leading}")
        else:
            batches = {n: v.unsqueeze(0) for n, v in batches.items()}
        if not graph_safe(state.optimizer):
            raise ValueError("graph=True needs the graph-safe AdamW (any optax chain is "
                             "graph-safe): create the state with "
                             "create_train_state(..., graph=True)")
        state.model.train()
        params = [p for p in state.model.parameters() if p.requires_grad]
        device = params[0].device
        seeds = [_shard_seed(int(torch.randint(0, 2 ** 62, (1,), generator=state.generator)),
                             shard) for _ in range(steps)]
        rates = torch.tensor([state.base_lr * state.schedule(state.step + k)
                              for k in range(steps)], dtype=torch.float32)
        for p in params:       # every gradient allocated: the body zeroes them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if device.type != "cuda":
            out = body(state, batches, state.norm, rates.to(device),
                       lambda k: _seeded_cpu(seeds[k]))
        else:
            if bound["state"] is None:
                bound["state"], bound["grads"] = state, [p.grad for p in params]
            elif bound["state"] is not state:
                raise ValueError("a graph train step serves the TrainState of its first call")
            for p, g in zip(params, bound["grads"]):
                p.grad = g     # an eager step may have dropped them
            # (the rates on the host give the key; a capture copies them in)
            captured = graphs.get(device, batches, state.norm, {"lrs": rates})
            captured.load(batches, state.norm)
            # the rates as fills: no host buffer for a copy to wait on
            for static, rate in zip(captured.inputs[2]["lrs"], rates.tolist()):
                static.fill_(rate)
            for generator, seed in zip(captured.states, seeds):
                generator.manual_seed(seed)
            out = captured.replay().clone()
        state.step += steps
        if steps == 1:
            out = out[0]
        return dict(zip(names, out.unbind(-1)))

    step.graphs = graphs
    return step


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step updates in place: parameters, BatchNorm
    buffers, gradients and the optimizer's state."""
    optimizer = state.optimizer
    tensors = [t for t in state.model.state_dict(keep_vars=True).values()]
    tensors += [p.grad for p in state.model.parameters() if p.grad is not None]
    tensors += [t for slots in optimizer.state.values() for t in slots.values()
                if torch.is_tensor(t)]
    return tensors + [optimizer.count]


def _mixed_layouts():
    """torch's optimizers step sharded and plain parameters in one list
    with the plain ones taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_eval_step(model, options, compile: bool = False, shapes: int = 1,
                   graph: bool = False) -> Callable[[TrainState, Dict, Dict], Dict]:
    """``step(state, batch, totals) -> totals``: eval-mode forward and loss;
    the metric sufficient statistics of the batch are added to ``totals``
    (from :func:`.metrics.init_metric_state`) in place, on the device.
    ``compile``: all of it compiled, for up to ``shapes`` batch shapes.
    ``graph``: on the card, one CUDA graph a batch shape computes the
    batch's statistics into zeroed buffers of its own, and the step adds
    them to ``totals`` (the statistics are small integer counts and one
    loss sum: ``totals + (0 + x)`` is ``totals + x`` bit for bit); on the
    CPU the same body runs without a capture."""
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
        evaluate = compile_step(evaluate, shapes)

    @torch.no_grad()
    def step(state: TrainState, batch, totals):
        net = state.model
        net.eval()
        return evaluate(net, batch, state.norm, totals)

    if not graph:
        return step
    check_graphable(None, next(model.parameters()).device)
    bound = {}
    context = quant.current()

    @torch.no_grad()
    def graph_body(batch, norm, totals, states):
        for t in totals.values():
            t.zero_()
        net = bound["state"].model
        net.eval()
        return evaluate(net, batch, norm, totals)

    # a tensor-parallel model's forward holds the row's collectives
    graphs = StepGraphs(graph_body, "eval step graph", shapes,
                        lockstep=default_mesh().world_size > 1)

    def graph_step(state: TrainState, batch, totals):
        if bound.setdefault("state", state) is not state:
            raise ValueError("a graph eval step serves the TrainState of its first call")
        quant.check_context(context, "this graph eval step")
        device = next(state.model.parameters()).device
        state.model.eval()
        if device.type != "cuda":
            delta = graph_body(batch, state.norm, {k: torch.empty_like(v)
                                                   for k, v in totals.items()}, [])
        else:
            captured = graphs.get(device, batch, state.norm, totals)
            captured.load(batch, state.norm)
            delta = captured.replay()
        torch._foreach_add_([totals[k] for k in delta], list(delta.values()))
        return totals

    graph_step.graphs = graphs
    return graph_step
