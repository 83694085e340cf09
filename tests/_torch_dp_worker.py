"""One rank of the port's data-parallel tests: a process of a ``gloo``
group on the CPU, started by ``tests/test_torch_port_parallel.py``,
``tests/test_torch_port_ddp_parity.py``, ``tests/test_torch_port_tp.py``
and ``tests/test_torch_port_graph_dp.py``.

    python _torch_dp_worker.py <mode> <rendezvous file> <world size> <rank> \
        <input> <output>

``syncbn``: the input (``.npz``) holds cases of the global ``x``, ``mask``,
cotangent and BatchNorm state; this rank takes its rows, runs a train-mode
``MaskedBatchNorm`` synced over the group, backpropagates its rows'
cotangent and writes its output rows, its input and affine gradients and
the running statistics.

``compiled``: the input (``torch.save``) holds ``options`` (a dict), the
in-memory training and validation events and ``fit``'s arguments; this
rank fits an eager and a compiled ``Trainer`` (``compile=True``) and
writes each one's step metrics and gradients, final state and validation
result (sharded tensors of a tensor-parallel run gathered whole; also
started by ``tests/test_torch_port_tp.py``), and the eager fit's
spread under a reordering of each data shard's events (``reordered``).

``trainer``: the input (``torch.save``) holds ``options`` (a dict), the
JAX Trainer's initial ``variables`` and the run's ``log_dir``; this rank
builds the port's ``Trainer`` on them, fits, predicts the validation split
and writes its state, the elements whose gradient stayed above 1e-4 at
every step, its fit result, predictions and (rank 0) its logged history
and checkpoint index.

``graph``: the input (``torch.save``) holds ``options`` (a dict), the JAX
Trainer's initial ``variables``, the run's ``log_dir``, ``fit``'s arguments,
the global batch indices of 4 explicit ``steps`` and a ``work`` directory.
This rank fits the port's graph ``Trainer`` (``graph=True``; the option's
``steps_per_dispatch``) on the JAX weights, as ``trainer`` does (the
elements whose gradient stayed above 1e-4 read at each optimizer step);
then, with dropout and pixel noise on and sync-BN, plain and with
``remat_cnn``, the graph body's 2 calls of 2 steps against 4 eager
data-parallel steps from the same start (``noisy``: every metric and
every tensor of both states); then a graph Trainer fit with checkpoints
and a fresh one resumed at step 2 (``resumed``: both whole states).

Imports nothing of JAX: the port runs here as it does on the card.
"""

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)


def syncbn(inputs, rank, world_size):
    from dune_transformercvn_torch.ops.masked import MaskedBatchNorm, sync_batch_norm

    data = np.load(inputs)
    out = {}
    for case in sorted({k.split("/")[0] for k in data.files}):
        get = lambda key: data[f"{case}/{key}"]  # noqa: E731
        rows = get("x").shape[0] // world_size
        local = slice(rank * rows, (rank + 1) * rows)
        bn = MaskedBatchNorm(get("x").shape[-1])
        bn.load_state_dict({k: torch.from_numpy(get(k)) for k in
                            ("weight", "bias", "running_mean", "running_var")})
        sync_batch_norm(bn, dist.group.WORLD).train()
        x = torch.from_numpy(get("x")[local]).requires_grad_()
        y = bn(x, torch.from_numpy(get("mask")[local]))
        (y * torch.from_numpy(get("cot")[local])).sum().backward()
        out.update({f"{case}/y": y.detach().numpy(), f"{case}/grad_x": x.grad.numpy(),
                    f"{case}/grad_weight": bn.weight.grad.numpy(),
                    f"{case}/grad_bias": bn.bias.grad.numpy(),
                    f"{case}/running_mean": bn.running_mean.numpy(),
                    f"{case}/running_var": bn.running_var.numpy()})
    return out


def trainer(inputs, rank, world_size):
    from dune_transformercvn_torch import Options
    from dune_transformercvn_torch.from_jax import load_jax_variables
    from dune_transformercvn_torch.train import Trainer
    from dune_transformercvn_torch.train.logging import read_history

    setup = torch.load(inputs, weights_only=False)
    options = Options()
    options.update_options(setup["options"])
    ours = Trainer(options, log_dir=setup["log_dir"], name="run", device="cpu",
                   log_every_n_steps=1, verbose=True)
    load_jax_variables(ours.state.model, setup["variables"])
    # where the reduced, clipped gradient stayed above 1e-4 at every step
    stable = {n: torch.ones_like(p, dtype=torch.bool)
              for n, p in ours.state.model.named_parameters()}
    step = ours.train_step

    def tracked_step(state, batch):
        metrics = step(state, batch)
        for n, p in state.model.named_parameters():
            stable[n] &= p.grad.abs() > 1e-4
        return metrics

    ours.train_step = tracked_step
    result = ours.fit(**setup["fit"])
    out = {
        "run_dir": ours.run_dir,
        "global_batch": ours.global_batch,
        "steps_per_epoch": ours.steps_per_epoch,
        "step": ours.state.step,
        "result": {k: v for k, v in result.items() if np.ndim(v) == 0},
        "state": {k: v.clone() for k, v in ours.state.model.state_dict().items()},
        "stable": stable,
        "generator": ours.state.generator.get_state(),
        "predictions": ours.predict_split("validation"),
    }
    if ours.run_dir is not None:
        out["history"] = read_history(ours.run_dir)
        with open(os.path.join(ours.run_dir, "checkpoints", "index.json")) as f:
            out["index"] = json.load(f)
    return out


def reordered(batcher, perm):
    """``batcher``'s epochs with the events of each data shard's block of
    every global batch taken in the order ``perm``: the same batches, the
    same shards, summed in another order."""
    original, block = batcher.epoch_indices, len(perm)

    def epoch_indices(epoch):
        order = original(epoch)
        whole = len(order) // block * block
        return np.concatenate([order[:whole].reshape(-1, block)[:, list(perm)].reshape(-1),
                               order[whole:]])

    batcher.epoch_indices = epoch_indices


def compiled(inputs, rank, world_size):
    """An eager and a compiled ``Trainer`` (``compile=True``) on the same
    options and events, each fit on this rank's shards: every step's
    metrics and gradients, the final state and the validation result.
    Then the eager fit again under each of the other 23 orders of every
    data shard's 4 events: ``spread`` holds the largest change of each
    step's metrics, of each running statistic (elementwise) and of the
    validation loss, float32 summation order alone."""
    import itertools

    from dune_transformercvn_torch import Options
    from dune_transformercvn_torch.data import InMemoryEvents
    from dune_transformercvn_torch.parallel import full_tensors
    from dune_transformercvn_torch.train import Trainer
    from dune_transformercvn_torch.train.checkpoint import to_host

    torch._inductor.config.compile_threads = 1
    setup = torch.load(inputs, weights_only=False)

    def fit(compile, perm=None, grads=True):
        options = Options()
        options.update_options(setup["options"])
        datasets = (InMemoryEvents(*setup["training"]), InMemoryEvents(*setup["validation"]),
                    None)
        trainer = Trainer(options, debug=True, verbose=False, device="cpu",
                          datasets=datasets, compile=compile)
        if perm is not None:
            reordered(trainer.train_batcher, perm)
        steps, step = [], trainer.train_step

        def recorded(state, batch):
            metrics = step(state, batch)
            named = dict(state.model.named_parameters())
            kept = ({n: g.clone() for n, g in zip(named, full_tensors(
                [p.grad for p in named.values()]))} if grads else None)
            steps.append(({k: float(v) for k, v in metrics.items()}, kept))
            return metrics

        trainer.train_step = recorded
        result = trainer.fit(**setup["fit"])
        return {"steps": steps, "state": to_host(trainer.state.model.state_dict()),
                "result": {k: v for k, v in result.items() if np.ndim(v) == 0}}

    out = {"eager": fit(False), "compiled": fit(True)}
    eager = out["eager"]
    spread = out["spread"] = {
        "steps": [dict.fromkeys(metrics, 0.0) for metrics, _ in eager["steps"]],
        "state": {n: torch.zeros_like(t) for n, t in eager["state"].items() if "running_" in n},
        "val_loss": 0.0}
    for perm in itertools.permutations(range(setup["options"]["batch_size"])):
        if perm == tuple(sorted(perm)):
            continue
        got = fit(False, perm, grads=False)
        for (metrics, _), (want, _), largest in zip(got["steps"], eager["steps"],
                                                    spread["steps"]):
            for key in largest:
                largest[key] = max(largest[key], abs(metrics[key] - want[key]))
        for name, largest in spread["state"].items():
            torch.maximum(largest, (got["state"][name] - eager["state"][name]).abs(),
                          out=largest)
        spread["val_loss"] = max(spread["val_loss"],
                                 abs(got["result"]["val_loss"] - eager["result"]["val_loss"]))
    return out


def graph_state_tensors(trainer):
    """Everything a train step changes, by name (this rank's piece of a
    sharded tensor): the step, the generator, the model's parameters and
    buffers, the optimizer's count and slots."""
    from dune_transformercvn_torch.parallel import local

    state, optimizer = trainer.state, trainer.state.optimizer
    return {"step": torch.tensor(state.step), "generator": state.generator.get_state(),
            "count": optimizer.count.clone(),
            **{f"model.{n}": local(t).detach().clone()
               for n, t in state.model.state_dict().items()},
            **{f"slot.{i}.{name}": local(t).clone()
               for i, slots in enumerate(optimizer.state.values())
               for name, t in slots.items()}}


def graph_against_eager(setup, options):
    """The graph body (2 calls of a 2-step graph) and the eager step on the
    same 4 global batches from the same start, both with the graph-safe
    AdamW: the metrics and both states."""
    from dune_transformercvn_torch.predict import to_device
    from dune_transformercvn_torch.train import Trainer, make_train_step

    runs = []
    for graph in (True, False):
        trainer = Trainer(options(dict(static_batch_shapes=True, steps_per_dispatch=2)),
                          debug=True, verbose=False, device="cpu", graph=True)
        batches = [to_device(trainer.train_batcher.build_batch(np.asarray(idx)), "cpu")
                   for idx in setup["steps"]]
        if graph:
            stacked = [{k: torch.stack([b[k] for b in batches[i:i + 2]]) for k in batches[0]}
                       for i in (0, 2)]
            metrics = [trainer.train_step(trainer.state, group) for group in stacked]
            metrics = {k: torch.cat([m[k] for m in metrics]) for k in metrics[0]}
        else:
            step = make_train_step(trainer.state.model, trainer.options, trainer.mesh)
            metrics = [step(trainer.state, b) for b in batches]
            metrics = {k: torch.stack([m[k].float() for m in metrics]) for k in metrics[0]}
        runs.append({"metrics": metrics, "state": graph_state_tensors(trainer)})
    return {"graph": runs[0], "eager": runs[1]}


def graph(inputs, rank, world_size):
    from dune_transformercvn_torch import Options
    from dune_transformercvn_torch.from_jax import load_jax_variables
    from dune_transformercvn_torch.train import Trainer
    from dune_transformercvn_torch.train.checkpoint import to_host
    from dune_transformercvn_torch.train.logging import read_history

    setup = torch.load(inputs, weights_only=False)

    def options(overrides=None):
        opts = Options()
        opts.update_options({**setup["options"], **(overrides or {})})
        return opts

    ours = Trainer(options(), log_dir=setup["log_dir"], name="run", device="cpu",
                   log_every_n_steps=1, verbose=True, graph=True)
    load_jax_variables(ours.state.model, setup["variables"])
    # where the reduced, clipped gradient stayed above 1e-4 at every step
    stable = {n: torch.ones_like(p, dtype=torch.bool)
              for n, p in ours.state.model.named_parameters()}
    update = ours.state.optimizer.step

    def recorded(*args, **kwargs):
        for n, p in ours.state.model.named_parameters():
            stable[n] &= p.grad.abs() > 1e-4
        return update(*args, **kwargs)

    ours.state.optimizer.step = recorded
    result = ours.fit(**setup["fit"])
    out = {
        "run_dir": ours.run_dir,
        "global_batch": ours.global_batch,
        "step": ours.state.step,
        "count": int(ours.state.optimizer.count),
        "result": {k: v for k, v in result.items() if np.ndim(v) == 0},
        "state": {k: v.clone() for k, v in ours.state.model.state_dict().items()},
        "stable": stable,
        "generator": ours.state.generator.get_state(),
    }
    if ours.run_dir is not None:
        out["history"] = read_history(ours.run_dir)

    noisy = dict(dropout=0.1, pixel_noise_std=0.05)
    out["noisy"] = {name: graph_against_eager(setup, lambda o, v=variant: options(
        {**noisy, **v, **o})) for name, variant in (("plain", {}), ("remat_cnn",
                                                                    {"remat_cnn": True}))}

    run_dir = os.path.join(setup["work"], "graph_resume")
    whole = Trainer(options(noisy), run_dir=run_dir, device="cpu", verbose=False, graph=True)
    whole.fit(max_steps=4, eval_interval=2)
    resumed = Trainer(options(noisy), debug=True, device="cpu", verbose=False, graph=True)
    resumed.resume(os.path.join(run_dir, "checkpoints", "step_2"))
    resumed.fit(max_steps=4, eval_interval=4)
    out["resumed"] = {"whole": to_host(whole.state.state_dict()),
                      "resumed": to_host(resumed.state.state_dict())}
    return out


def main():
    mode, rendezvous, world_size, rank, inputs, output = sys.argv[1:7]
    world_size, rank = int(world_size), int(rank)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    # the first collective while the ranks are still in step: gloo's
    # rendezvous has a deadline the later, drifted collectives could miss
    dist.all_reduce(torch.zeros(1))
    try:
        out = {"syncbn": syncbn, "trainer": trainer, "compiled": compiled,
               "graph": graph}[mode](inputs, rank, world_size)
    finally:
        dist.destroy_process_group()
    if mode == "syncbn":
        np.savez(output, **out)
    else:
        torch.save(out, output)


if __name__ == "__main__":
    main()
