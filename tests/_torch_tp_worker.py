"""One rank of the port's tensor-parallel tests: a process of a ``gloo``
group on the CPU, started by ``tests/test_torch_port_tp.py`` and
``tests/test_torch_port_graph_dp.py``.

    python _torch_tp_worker.py <mode> <rendezvous file> <world size> <rank> \
        <input> <output>

The input (``torch.save``) holds ``options`` (a dict), the JAX Trainer's
initial ``variables``, the global batch indices of the explicit ``steps``
and a ``work`` directory.

``tp`` (4 ranks, dp2 x mp2): the layout of the sharded parameters and
buffers; what each rank computes in one train-mode forward (the
convolutions, linears and softmaxes of each partitioned layer, the
channels its norm2 and relu2 see, its sums over the TP row); the
optimizers' sharded pieces, trust ratios and ``global_norm`` against the
same arithmetic on whole tensors; ``validate`` and ``predict_split`` of the
port's ``Trainer`` on the JAX weights, then 3 explicit train steps (losses,
grad norms, the elements whose gradient stayed above 1e-4, the whole state
after); ``fit`` with a checkpoint at step 2 and a resume from it
to step 4; ``steps_per_dispatch`` 2 against single steps; the mesh's
clamp and its error.

``dp`` (2 ranks): the port's data-parallel Trainer through the same
``validate``, ``predict_split`` and 3 steps, with and without dropout and
noise: the reference of the ``tp`` run.

``families`` (2 ranks, dp1 x mp2): the input holds each family's tiny port
``ModelConfig``, a batch and its feature statistics; each rank runs the
network whole and a tensor-parallel copy of it, a train-mode forward and
a backward of the same cotangents, and writes both logits, the largest
difference of each gradient (whole; with its largest element) and of the
running statistics.

``graph`` (4 ranks, dp2 x mp2): the graph ``Trainer`` (``graph=True``,
the options' ``steps_per_dispatch``) fit on the JAX weights and logged
(the elements whose whole gradient stayed above 1e-4 read at each
optimizer step), its whole state; then, with dropout, pixel noise and
sync-BN on, the graph body's 2 calls of 2 steps against 4 eager steps
from the same start (each rank's pieces) and a graph Trainer resumed at
step 2 against the uninterrupted one (``_torch_dp_worker.py``'s).

Imports nothing of JAX: the port runs here as it does on the card.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)


def make_trainer(setup, **overrides):
    from dune_transformercvn_torch import Options
    from dune_transformercvn_torch.from_jax import load_jax_variables
    from dune_transformercvn_torch.train import Trainer

    options = Options()
    options.update_options({**setup["options"], **overrides.pop("options", {})})
    trainer = Trainer(options, device="cpu", verbose=False, **overrides)
    load_jax_variables(trainer.state.model, setup["variables"])
    return trainer


def whole_state(trainer):
    from dune_transformercvn_torch.train.checkpoint import to_host

    return to_host(trainer.state.state_dict())


def explicit_steps(trainer, steps):
    """The train steps on the given global batches: losses, grad norms and,
    by parameter name, where the whole gradient stayed above 1e-4."""
    from dune_transformercvn_torch.parallel import full_tensors
    from dune_transformercvn_torch.predict import to_device

    named = dict(trainer.state.model.named_parameters())
    stable = {n: torch.ones(p.shape, dtype=torch.bool) for n, p in named.items()}
    losses, norms = [], []
    for idx in steps:
        batch = to_device(trainer.train_batcher.build_batch(np.asarray(idx)), "cpu")
        metrics = trainer.train_step(trainer.state, batch)
        losses.append(float(metrics["train_loss"]))
        norms.append(float(metrics["grad_norm"]))
        grads = full_tensors([p.grad for p in named.values()])
        for (n, _), g in zip(named.items(), grads):
            stable[n] &= g.abs() > 1e-4
    return dict(losses=losses, grad_norms=norms, stable=stable)


def evaluation(trainer):
    result = trainer.validate()
    return dict(validation={k: v for k, v in result.items() if np.ndim(v) == 0},
                predictions=trainer.predict_split("validation"))


def optimizer_checks(mesh):
    """Each optimizer on a sharded packed q/k/v weight, a sharded position
    vector and a plain bias against the same optimizer on whole tensors,
    over 3 updates; ``global_norm`` and ``_trust_ratio`` alike.  Returns the
    largest difference of each (of ``global_norm``, relative)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from dune_transformercvn_torch.parallel import full_tensor, local, shard_spec
    from dune_transformercvn_torch.train import optimizer as opt

    rng = np.random.default_rng(5)
    shapes = {"qkv": (48, 16), "position": (1, 16), "bias": (48,)}
    leaves = {"qkv": 3, "position": 1, "bias": 3}
    dims = {"qkv": 0, "position": 1}
    start = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(3)]

    def sharded(t, name):
        if name not in dims:
            return t.clone()
        piece = t.chunk(mesh.mp, dims[name])[mesh.model_index].clone()
        return DTensor.from_local(piece, mesh.model_mesh, [Shard(dims[name])], run_check=False)

    out = {}
    for name in ("adamw", *opt.CHAINS):
        results = []
        for layout in ("whole", "sharded"):
            params = {k: torch.nn.Parameter(sharded(v, k) if layout == "sharded" else v.clone())
                      for k, v in start.items()}
            groups = [{"params": [params["qkv"], params["position"]], "weight_decay": 1e-2},
                      {"params": [params["bias"]], "weight_decay": 0.0}]
            if name == "adamw":
                optimizer = torch.optim.AdamW(groups, lr=1e-2)
            else:
                optimizer = opt.CHAINS[name](groups, 1e-2, {p: leaves[k]
                                                            for k, p in params.items()})
            for g in grads:
                for k, p in params.items():
                    p.grad = sharded(g[k], k) if layout == "sharded" else g[k].clone()
                with implicit_replication():
                    optimizer.step()
            results.append({k: full_tensor(p.detach()) for k, p in params.items()})
        out[name] = max(float((results[0][k] - results[1][k]).abs().max()) for k in shapes)

    whole = [grads[0][k] for k in shapes]
    pieces = [sharded(grads[0][k], k) for k in shapes]
    want = opt.global_norm(whole)
    out["global_norm"] = float((want - opt.global_norm(pieces)).abs() / want)
    u, p = grads[1]["qkv"], start["qkv"]
    want = opt._trust_ratio(u, p, 3, 1.0)
    piece_u, piece_p = sharded(u, "qkv"), sharded(p, "qkv")
    got = opt._trust_ratio(local(piece_u), local(piece_p), 3, 1.0, shard_spec(piece_p))
    got = full_tensor(DTensor.from_local(got, mesh.model_mesh, [Shard(0)], run_check=False))
    out["trust_ratio"] = float((got - want).abs().max())
    return out


def partition_record(setup):
    """One train-mode forward (no gradient) of a fresh TP Trainer's model on
    the first step's batch: for each partitioned layer (by module name) the
    weight shapes of its ``conv2d`` and ``linear`` calls and the input
    shapes of its ``softmax`` calls, the ranks of the groups its
    ``parallel.mesh.sum_over`` calls sum over, and for each bottleneck the
    channels its norm2 and relu2 see."""
    from torch.overrides import TorchFunctionMode

    from dune_transformercvn_torch.models.densenet import Bottleneck
    from dune_transformercvn_torch.models.encoder import EncoderLayer, MultiHeadAttention
    from dune_transformercvn_torch.parallel import mesh as mesh_module
    from dune_transformercvn_torch.predict import to_device

    trainer = make_trainer(setup, debug=True)
    model = trainer.state.model
    record, scope = {}, []

    def entry(name):
        return record.setdefault(name, dict(conv2d=[], linear=[], softmax=[], sums=[],
                                            channels={}))

    def enter(module, args, name):
        scope.append(name)

    def leave(module, args, output):
        scope.pop()

    def seen(module, args, output, name):
        owner, _, role = name.rpartition(".output_block.")
        entry(owner)["channels"][role] = args[0].shape[-1]

    for name, module in model.named_modules():
        if isinstance(module, (Bottleneck, MultiHeadAttention, EncoderLayer)):
            module.register_forward_pre_hook(lambda m, a, name=name: enter(m, a, name))
            module.register_forward_hook(leave)
        if name.endswith((".output_block.norm2", ".output_block.relu2")):
            module.register_forward_hook(lambda m, a, o, name=name: seen(m, a, o, name))

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if scope and name in ("conv2d", "linear"):
                entry(scope[-1])[name].append(tuple(args[1].shape))
            elif scope and name == "softmax":
                entry(scope[-1])[name].append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    sum_over = mesh_module.sum_over

    def counted(tensor, group):
        if scope:
            entry(scope[-1])["sums"].append(dist.get_process_group_ranks(group))
        return sum_over(tensor, group)

    batch = to_device(trainer.train_batcher.build_batch(np.asarray(setup["steps"][0])), "cpu")
    mesh_module.sum_over = counted
    try:
        model.train()
        with torch.no_grad(), Recorder():
            model(batch, trainer.state.norm)
    finally:
        mesh_module.sum_over = sum_over
    return record


def tp(setup, rank, world_size):
    from torch.distributed.tensor import DTensor

    from dune_transformercvn_torch.parallel import (create_mesh, full_tensor,
                                                    local_shard_ids, shard_spec)

    trainer = make_trainer(setup, debug=True)
    mesh = trainer.mesh
    model = trainer.state.model
    layout = {}
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        if isinstance(t, DTensor):
            spec = shard_spec(t)
            layout[name] = (tuple(t.to_local().shape), tuple(t.shape), spec.dim, spec.blocks)
    qkv = model.encoder.encoder.layers[0].self_attn.in_proj_weight
    out = dict(mesh=(mesh.dp, mesh.mp, mesh.data_index, mesh.model_index),
               shards=local_shard_ids(mesh), num_shards=trainer.num_shards,
               global_batch=trainer.global_batch, layout=layout,
               in_proj=(qkv.to_local().detach().clone(), full_tensor(qkv.detach())),
               partition=partition_record(setup))
    out["optimizers"] = optimizer_checks(mesh)
    out.update(evaluation(trainer))
    out.update(explicit_steps(trainer, setup["steps"]))
    out["moment_pieces"] = {
        name: tuple(trainer.state.optimizer.state[p]["exp_avg"].to_local().shape)
        for name, p in trainer.state.model.named_parameters() if isinstance(p, DTensor)}
    out["state"] = whole_state(trainer)
    out["noisy"] = noisy_steps(setup)

    # fit with a checkpoint at step 2 and 4; a fresh Trainer resumed at 2
    run_dir = os.path.join(setup["work"], "tp_run")
    fitted = make_trainer(setup, run_dir=run_dir, log_every_n_steps=1)
    out["fit"] = {k: v for k, v in fitted.fit(max_steps=4, eval_interval=2).items()
                  if np.ndim(v) == 0}
    out["fit_state"] = whole_state(fitted)
    resumed = make_trainer(setup, debug=True)
    resumed.resume(os.path.join(run_dir, "checkpoints", "step_2"))
    resumed.fit(max_steps=4, eval_interval=4)
    out["resumed_state"] = whole_state(resumed)
    out["run_dir"] = run_dir

    # steps_per_dispatch 2 against single steps of the same static shapes
    states = []
    for k in (1, 2):
        t = make_trainer(setup, debug=True, options=dict(static_batch_shapes=True,
                                                         steps_per_dispatch=k))
        t.fit(max_steps=4, eval_interval=4)
        states.append(whole_state(t)["model"])
    out["k2_max_diff"] = max(float((states[0][n] - states[1][n]).abs().max())
                             for n in states[0])

    clamped = create_mesh(4, model_parallel=8)
    out["clamped"] = (clamped.dp, clamped.mp)
    try:
        create_mesh(4, model_parallel=3)
        out["mp3"] = "no error"
    except ValueError as e:
        out["mp3"] = str(e)
    return out


def noisy_steps(setup, **options):
    """The explicit steps with dropout and pixel noise on: each data shard
    draws its own, the ranks of a TP row the same."""
    trainer = make_trainer(setup, debug=True, options=dict(dropout=0.1, pixel_noise_std=0.01,
                                                           **options))
    steps = explicit_steps(trainer, setup["steps"])
    return dict(losses=steps["losses"], grad_norms=steps["grad_norms"])


def families(setup, rank, world_size):
    """Each family's network whole and at dp1 x mp2, from the same weights:
    both logits, the largest difference of each gradient (beside its
    largest element) and of the running statistics."""
    import copy

    from dune_transformercvn_torch.models import TransformerCVN
    from dune_transformercvn_torch.ops.masked import MaskedBatchNorm
    from dune_transformercvn_torch.parallel import (all_reduce_, create_mesh, full_tensors,
                                                    shard_parameters, shard_spec)
    from dune_transformercvn_torch.predict import to_device

    mesh = create_mesh(world_size, model_parallel=world_size)
    out = {}
    for family, (cfg, batch, norm) in setup.items():
        batch = to_device(batch, "cpu")
        norm = {k: torch.as_tensor(v) for k, v in norm.items()}
        one = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).train()
        tp_model = copy.deepcopy(one)
        layout = shard_parameters(tp_model, mesh)
        results = []
        for model in (one, tp_model):
            event, prong = model(batch, norm)
            rng = torch.Generator().manual_seed(1)
            ((event * torch.randn(event.shape, generator=rng)).sum()
             + (prong * torch.randn(prong.shape, generator=rng)).sum()).backward()
            results.append((event.detach(), prong.detach()))
        params = [p for _, p in tp_model.named_parameters()]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        # a replicated gradient: the row's copies (or its cut pieces,
        # scaled by mp) summed, over mp
        plain = [g for g in grads if shard_spec(g) is None]
        all_reduce_(plain, mesh.model_mesh.get_group())
        torch._foreach_div_(plain, world_size)
        grads = dict(zip([n for n, _ in tp_model.named_parameters()], full_tensors(grads)))
        stats = {n: t for n, t in tp_model.named_buffers()}
        stats = dict(zip(stats, full_tensors(list(stats.values()))))
        grad_diffs = {}
        for name, p in one.named_parameters():
            want = p.grad if p.grad is not None else torch.zeros_like(p)
            grad_diffs[name] = (float((grads[name] - want).abs().max()),
                                float(want.abs().max()))
        out[family] = dict(
            sharded=len(layout),
            partitioned=sum(getattr(m, "tp", None) is not None for m in tp_model.modules()),
            logits=results,
            grads=grad_diffs,
            stats=max(float((stats[n] - t).abs().max()) for n, t in one.named_buffers()
                      if isinstance(one.get_submodule(n.rpartition(".")[0]), MaskedBatchNorm)))
    return out


def dp(setup, rank, world_size):
    serial = dict(num_gpu=2, model_parallel=1)
    trainer = make_trainer(setup, debug=True, options=serial)
    out = evaluation(trainer)
    out.update(explicit_steps(trainer, setup["steps"]))
    out["state"] = whole_state(trainer)
    out["noisy"] = noisy_steps(setup, **serial)
    return out


def graph(setup, rank, world_size):
    from _torch_dp_worker import graph_against_eager
    from dune_transformercvn_torch import Options
    from dune_transformercvn_torch.from_jax import load_jax_variables
    from dune_transformercvn_torch.parallel import full_tensors, local
    from dune_transformercvn_torch.train import Trainer
    from dune_transformercvn_torch.train.logging import read_history

    def options(overrides=None):
        opts = Options()
        opts.update_options({**setup["options"], **(overrides or {})})
        return opts

    ours = Trainer(options(), log_dir=setup["log_dir"], name="run", device="cpu",
                   log_every_n_steps=1, verbose=True, graph=True)
    load_jax_variables(ours.state.model, setup["variables"])
    named = dict(ours.state.model.named_parameters())
    stable = {n: torch.ones(p.shape, dtype=torch.bool) for n, p in named.items()}
    update = ours.state.optimizer.step

    def recorded(*args, **kwargs):
        for n, g in zip(named, full_tensors([p.grad for p in named.values()])):
            stable[n] &= g.abs() > 1e-4
        return update(*args, **kwargs)

    ours.state.optimizer.step = recorded
    ours.fit(**setup["fit"])
    out = dict(mesh=(ours.mesh.dp, ours.mesh.mp), step=ours.state.step,
               state=whole_state(ours), stable=stable)
    if ours.run_dir is not None:
        out["history"] = read_history(ours.run_dir)
    noisy = dict(dropout=0.1, pixel_noise_std=0.05)
    out["noisy"] = graph_against_eager(setup, lambda o: options({**noisy, **o}))
    run_dir = os.path.join(setup["work"], "graph_resume")
    whole = Trainer(options(noisy), run_dir=run_dir, device="cpu", verbose=False, graph=True)
    whole.fit(max_steps=4, eval_interval=2)
    resumed = Trainer(options(noisy), debug=True, device="cpu", verbose=False, graph=True)

    def storage(trainer):   # where each moment's piece lives
        return [local(t).data_ptr() for slots in trainer.state.optimizer.state.values()
                for t in slots.values()]

    before = storage(resumed)
    resumed.resume(os.path.join(run_dir, "checkpoints", "step_2"))
    out["moments_in_place"] = storage(resumed) == before
    resumed.fit(max_steps=4, eval_interval=4)
    out["resumed"] = {"whole": whole_state(whole), "resumed": whole_state(resumed)}
    return out


def main():
    mode, rendezvous, world_size, rank, inputs, output = sys.argv[1:7]
    world_size, rank = int(world_size), int(rank)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    # the first collective while the ranks are still in step
    dist.all_reduce(torch.zeros(1))
    try:
        out = {"tp": tp, "dp": dp, "families": families, "graph": graph}[mode](
            torch.load(inputs, weights_only=False), rank, world_size)
    finally:
        dist.destroy_process_group()
    torch.save(out, output)


if __name__ == "__main__":
    main()
