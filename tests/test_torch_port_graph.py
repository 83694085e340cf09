"""The port's graph-safe steps (``graph=True``: CUDA graphs on the card) on
the CPU, where the same step bodies run without a capture.

* The K-step train body (``make_train_step(..., graph=True,
  steps_per_dispatch=K)``) at K = 2 and 3 against the JAX package's scanned
  step (``make_train_step(..., steps_per_dispatch=K)``) on the same stacked
  batches with transplanted weights (tiny dense network, float32, dropout
  0, noise 0, clipping active, a warm-up then cosine rate): the stacked
  metrics at ``test_torch_port_train``'s tolerances (``grad_norm``
  ``rtol=1e-4``, the losses ``rtol=1e-5, atol=1e-7``), the running
  statistics at ``rtol=atol=1e-5`` and the parameters by its Adam rule.
* The same body against the eager step (``graph=False``) from the same
  state, with dropout and pixel noise on, dense and coo: equal bit for bit
  (metrics, parameters, BatchNorm buffers, the optimizer's moments and
  count, the generator): step k of a call draws what the k-th eager step
  draws.
* :class:`GraphAdamW` over 4 steps against optax's ``adamw`` within
  ``test_torch_port_optimizers``' ``PARAM_TOL`` (it takes optax's float32
  bias corrections), against ``torch.optim.AdamW`` within its
  ``ADAMW_TOL``, and its rate read from a tensor (the graph's way) equal
  bit for bit to its rate from the group.
* The eval body (statistics into zeroed buffers, then added) and
  ``predict_split(graph=True)`` against eager, bit for bit.
* What ``graph=True`` does not take raises: a multi-rank mesh on CUDA
  tensors whose backend is not nccl (gloo, or no group), int8 convolutions
  in a train step (one rank or a multi-rank mesh; JAX quantizes inference
  only), a predict or eval graph step inside an int8 context it was not
  made in (one made inside runs the int8 convolutions), K > 1 without a graph, batches not
  stacked K deep, a state without the graph-safe optimizer, CUDA without a
  card, a batch shape past the bound; a multi-rank mesh over nccl, and on
  the CPU, does not raise.  (Remat and the optax chains:
  ``tests/test_torch_port_graph_chains.py``; data- and tensor-parallel
  graph steps in gloo processes: ``tests/test_torch_port_graph_dp.py``.)
* The one-event graph (``utils.graphs.EventGraph``) runs its program
  uncaptured on the CPU; on the card it captures one graph (its own pool)
  and returns copies of the replay's outputs, and an event of another
  shape raises.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.train.step import make_train_step as jax_make_train_step
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.from_jax import load_jax_variables, state_dict_from_jax
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.ops import quant
from dune_transformercvn_torch.parallel import Mesh
from dune_transformercvn_torch.predict import make_predict_step, predict_split, to_device
from dune_transformercvn_torch.train import (create_optimizer, create_train_state,
                                             init_metric_state, make_eval_step,
                                             make_train_step, schedules)
from dune_transformercvn_torch.train.optimizer import (GraphAdamW, clip_by_global_norm_,
                                                       global_norm)
from dune_transformercvn_torch.train.step import check_graphable
from dune_transformercvn_torch.utils.graphs import EventGraph, StepGraphs
from test_torch_port_optimizers import (ADAMW_TOL, PARAM_TOL, STEPS_PER_EPOCH as OPT_EPOCH,
                                        assert_params_close, jax_run, network, optimizer_step,
                                        options, port_grads, steps)
from test_torch_port_train import (LOSS_TOL, STEPS_PER_EPOCH, assert_adam_params_close,
                                   batch_and_norm, family_config, start_both, step_options)

torch.set_num_threads(2)

assert network and steps   # fixtures of test_torch_port_optimizers


def stacked(batches):
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches]) for k in batches[0]}


def graph_state(model, opts, norm, seed=0):
    return create_train_state(model, opts, norm, STEPS_PER_EPOCH, seed=seed, graph=True)


@pytest.mark.parametrize("k", [2, 3])
def test_graph_steps_match_jax_scan(synthetic_file, k):
    batches, norm = batch_and_norm(synthetic_file, k, "dense")
    (jax_model, jopts, tx, mesh, jax_state), (model, opts, _), port_cfg = start_both(
        "dense", 0.5, 0.5, batches, norm)
    state = graph_state(model, opts, norm)
    assert isinstance(state.optimizer, GraphAdamW)
    jax_step = jax_make_train_step(jax_model, tx, jopts, mesh, steps_per_dispatch=k)
    jax_state, want = jax_step(jax_state, {n: jnp.asarray(v) for n, v in stacked(
        batches).items()})
    stable = {n: torch.ones_like(p, dtype=torch.bool) for n, p in model.named_parameters()}
    grads = []
    step = make_train_step(model, opts, graph=True, steps_per_dispatch=k)

    # the gradients of each of the K steps: the body keeps them in place,
    # so they are read after each step's clipping by a hook on the update
    update = state.optimizer.step

    def recorded(*args, **kwargs):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return update(*args, **kwargs)

    state.optimizer.step = recorded
    got = step(state, stacked([to_device(b, "cpu") for b in batches]))
    assert state.step == int(jax_state.step) == k and len(grads) == k
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == (k,)
        tol = dict(rtol=1e-4) if key == "grad_norm" else LOSS_TOL
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **tol,
                                   err_msg=key)
    assert float(got["grad_norm"][0]) > 0.5                 # clipping was active
    for step_grads in grads:
        for n, g in step_grads.items():
            stable[n] &= g.abs() > 1e-4
    want_sd = state_dict_from_jax(jax.device_get(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}), port_cfg)
    got_sd = model.state_dict()
    for name, want_t in want_sd.items():
        if name not in stable:                              # BatchNorm statistics
            np.testing.assert_allclose(got_sd[name].numpy(), want_t.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    assert assert_adam_params_close(got_sd, want_sd, stable, opts.learning_rate, k) > 1000


def everything(state):
    """A state's tensors, the host step and the generator, for equality."""
    optimizer = state.optimizer
    return {"step": state.step, "generator": state.generator.get_state(),
            "count": optimizer.count.clone(),
            **{f"model.{n}": t.clone() for n, t in state.model.state_dict().items()},
            **{f"slot.{i}.{name}": t.clone()
               for i, slots in enumerate(optimizer.state.values())
               for name, t in slots.items()}}


def assert_identical(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if torch.is_tensor(value):
            assert torch.equal(got[key], value), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("family", ["dense", "coo"])
def test_graph_body_is_the_eager_step(synthetic_file, family):
    """Three steps as one call of the graph body and three eager steps from
    the same state, dropout 0.1 and pixel noise 0.02: equal bit for bit."""
    batches, norm = batch_and_norm(synthetic_file, 3, family)
    _, port_cfg = family_config(family)
    port_cfg = dataclasses.replace(port_cfg, dropout=0.1, pixel_noise_std=0.02)
    opts = step_options(Options, 0.5, 0.5)
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(3))
    eager_model = copy.deepcopy(model)
    state, eager_state = graph_state(model, opts, norm, 7), graph_state(eager_model, opts,
                                                                        norm, 7)
    got = make_train_step(model, opts, graph=True, steps_per_dispatch=3)(
        state, stacked([to_device(b, "cpu") for b in batches]))
    eager_step = make_train_step(eager_model, opts)
    want = [eager_step(eager_state, to_device(b, "cpu")) for b in batches]
    assert got.keys() == want[0].keys()
    for key, value in got.items():
        assert torch.equal(value, torch.stack([w[key].float() for w in want])), key
    assert_identical(everything(state), everything(eager_state))
    # the noise and dropout drew: another seed moves the losses
    other = copy.deepcopy(eager_model)
    other_state = graph_state(other, opts, norm, 8)
    assert not torch.equal(make_train_step(other, opts)(other_state, to_device(
        batches[0], "cpu"))["train_loss"], want[0]["train_loss"])


def test_graph_adamw_matches_optax_and_adamw(network, steps):
    """Four steps of clipped, scheduled updates: the graph-safe AdamW
    against optax's adamw, against ``torch.optim.AdamW``, and with its rate
    read from a tensor against its rate from the group."""
    variables, port_cfg = network
    want = jax_run("adamw", variables, steps)
    opts = options(Options, "adamw")
    schedule = schedules.from_options(opts, OPT_EPOCH)
    runs = []
    for kind in ("graph", "tensor", "adamw"):
        model = load_jax_variables(TransformerCVN(port_cfg), variables)
        optimizer = create_optimizer(opts, model, graph=kind != "adamw")
        for step, grads in enumerate(steps):
            port_grads(model, variables, grads)
            if kind == "tensor":
                g = [p.grad for p in model.parameters()]
                clip_by_global_norm_(g, 3.0, global_norm(g))
                optimizer.step(lr=torch.tensor(opts.learning_rate * schedule(step)))
            else:
                optimizer_step(optimizer, model, opts.learning_rate, schedule, step)
        runs.append(model)
    graph, tensor, adamw = runs
    assert_params_close(graph, variables, want, **PARAM_TOL)
    for (name, p), q, r in zip(graph.named_parameters(), tensor.parameters(),
                               adamw.parameters()):
        assert torch.equal(p, q), name
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(), **ADAMW_TOL,
                                   err_msg=name)


def test_graph_eval_and_predict_are_eager(synthetic_file):
    """The eval body's statistics (into zeroed buffers, then added to the
    caller's totals) and ``predict_split(graph=True)``'s probabilities
    against the eager steps', bit for bit."""
    batches, norm = batch_and_norm(synthetic_file, 2, "dense")
    _, port_cfg = family_config("dense")
    opts = step_options(Options, 0.5, 0.0)
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(4))
    state = graph_state(model, opts, norm)
    totals, eager_totals = init_metric_state(4, 8, 64), init_metric_state(4, 8, 64)
    graph_eval, eager_eval = make_eval_step(model, opts, graph=True), make_eval_step(model, opts)
    for batch in batches:
        graph_eval(state, to_device(batch, "cpu"), totals)
        eager_eval(state, to_device(batch, "cpu"), eager_totals)
    assert float(totals["event_count"]) == 8
    for key, value in eager_totals.items():
        assert torch.equal(totals[key], value), key
    ds = InMemoryEvents(10, 5, (port_cfg.image_height, port_cfg.image_width))
    kwargs = dict(coo_granularity=1024, prong_bucket_multipliers=[4])
    got = predict_split(model, ds, ds.norm(), 4, "cpu", graph=True, **kwargs)
    want = predict_split(model, ds, ds.norm(), 4, "cpu", **kwargs)
    assert got.keys() == want.keys() and len(got["event_probabilities"]) == 10
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_what_graph_does_not_take_raises(synthetic_file, monkeypatch):
    from dune_transformercvn_torch.train import step as step_module

    (batch,), norm = batch_and_norm(synthetic_file, 1, "dense")
    _, port_cfg = family_config("dense")
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(5))
    opts = step_options(Options, 0.5, 0.0)
    # a train step under int8 convolutions (JAX quantizes inference only)
    with quant.quantized_convs(model, {n: 1.0 for n in quant._convs(model)}, device="cpu"):
        with pytest.raises(RuntimeError, match="int8"):
            make_train_step(model, opts, Mesh(2, 1, 0), graph=True)
        with pytest.raises(RuntimeError, match="int8"):
            make_train_step(model, opts, graph=True)
    # several ranks on CUDA tensors need nccl: not gloo (every rank on one
    # card, its collectives staged on the host), not a mesh without a group
    monkeypatch.setattr(step_module, "group_backend", lambda: "gloo")
    with pytest.raises(ValueError, match="nccl.*backend is gloo"):
        check_graphable(Mesh(2, 1, 0), "cuda")
    monkeypatch.setattr(step_module, "group_backend", lambda: None)
    with pytest.raises(ValueError, match="nccl"):
        check_graphable(Mesh(1, 2, 1), "cuda")
    # what runs: nccl on the card, and a group's steps on the CPU (gloo)
    monkeypatch.setattr(step_module, "group_backend", lambda: "nccl")
    check_graphable(Mesh(1, 2, 1), "cuda")
    monkeypatch.setattr(step_module, "group_backend", lambda: "gloo")
    make_train_step(model, opts, Mesh(2, 1, 0), graph=True)
    with pytest.raises(ValueError, match="graph=True"):
        make_train_step(model, opts, steps_per_dispatch=2)
    step = make_train_step(model, opts, graph=True, steps_per_dispatch=2)
    with pytest.raises(ValueError, match="2 stacked batches"):
        step(graph_state(model, opts, norm), stacked([to_device(batch, "cpu")] * 3))
    with pytest.raises(ValueError, match="graph-safe AdamW"):
        step(create_train_state(model, opts, norm, STEPS_PER_EPOCH),
             stacked([to_device(batch, "cpu")] * 2))
    # the predict and eval graph steps take int8, each in the context it
    # was made in: a step of float convs raises inside one
    predict = make_predict_step(model, graph=True)
    evaluate = make_eval_step(model, opts, graph=True)
    state = create_train_state(model, opts, norm, STEPS_PER_EPOCH)
    with quant.quantized_convs(model, {n: 1.0 for n in quant._convs(model)}, device="cpu"):
        with pytest.raises(RuntimeError, match="int8"):
            predict(to_device(batch, "cpu"), to_device(norm, "cpu"))
        with pytest.raises(RuntimeError, match="int8"):
            evaluate(state, to_device(batch, "cpu"), init_metric_state(4, 8, 64))
        int8 = make_predict_step(model, graph=True)(to_device(batch, "cpu"),
                                                    to_device(norm, "cpu"))
        int8_eval = make_eval_step(model, opts, graph=True)(
            state, to_device(batch, "cpu"), init_metric_state(4, 8, 64))
    floats = predict(to_device(batch, "cpu"), to_device(norm, "cpu"))
    assert not torch.equal(int8[0], floats[0])
    assert all(torch.isfinite(v).all() for v in int8_eval.values())


def test_graphs_need_a_card_and_keep_their_bound(monkeypatch):
    """A graph is captured on CUDA only, and past its ``shapes`` bound a new
    batch shape raises rather than running uncaptured."""
    graphs = StepGraphs(lambda x, states: x["x"] * 2, "a step", shapes=2)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        graphs.get("cpu", {"x": torch.zeros(3)})
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|NVIDIA|compiled"):
        graphs.get("cuda", {"x": torch.zeros(3)})
    monkeypatch.setattr(StepGraphs, "_capture", lambda self, device, trees: object())
    graphs.graphs.clear()
    first = graphs.get("cuda", {"x": torch.zeros(3)})
    assert graphs.get("cuda", {"x": torch.ones(3)}) is first      # the same shape
    graphs.get("cuda", {"x": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="past the 2 graph"):
        graphs.get("cuda", {"x": torch.zeros(5)})


class FakeCaptured:
    """A captured graph's stand-in: ``replay`` writes the static output."""

    def __init__(self, fn, trees):
        self.inputs = tuple({k: v.clone() for k, v in tree.items()} for tree in trees)
        self.fn, self.out = fn, None

    def load(self, *trees):
        for static, tree in zip(self.inputs, trees):
            for name, value in tree.items():
                static[name].copy_(value)

    def replay(self):
        event = self.inputs[0]
        self.out = [o.clone() for o in self.fn(event["pixels"], event["num_prongs"])]
        return self.out


def test_event_graph_serves_one_rung(monkeypatch):
    """On the CPU the program runs uncaptured; on the card one graph is
    captured for the rung, every call loads the event and replays, and the
    outputs returned are copies of the static ones; another shape raises."""
    calls = []

    def program(pixels, num_prongs):
        calls.append(pixels.shape)
        return pixels.sum((1, 2, 3)) * num_prongs, pixels[0].mean()

    graph = EventGraph(program, "rung 4")
    pixels, n = torch.rand(5, 3, 4, 4), torch.tensor(3, dtype=torch.int32)
    got = graph(pixels, n)
    assert torch.equal(got[0], pixels.sum((1, 2, 3)) * 3) and not graph.graphs.graphs
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|NVIDIA|compiled"):
        graph.graphs.get("cuda", {"pixels": pixels, "num_prongs": n})
    captured = []
    monkeypatch.setattr(StepGraphs, "_capture", lambda self, device, trees: captured.append(
        FakeCaptured(program, trees)) or captured[-1])
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: cuda))
    first = graph(pixels, n)
    second = graph(pixels * 2, torch.tensor(1, dtype=torch.int32))
    monkeypatch.undo()
    assert len(captured) == 1
    assert torch.equal(second[0], (pixels * 2).sum((1, 2, 3)))
    assert torch.equal(first[0], pixels.sum((1, 2, 3)) * 3)    # a copy, not overwritten
    assert all(o is not s for o, s in zip(second, captured[0].out))
    monkeypatch.setattr(StepGraphs, "_capture", lambda self, device, trees: captured[0])
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: cuda))
    try:
        with pytest.raises(RuntimeError, match="past the 1 graph"):
            graph(torch.rand(3, 3, 4, 4), n)
    finally:
        monkeypatch.undo()


def test_the_predict_graphs_stay_with_their_model(synthetic_file):
    """``predict_split(graph=True)`` keeps its graph step on the model, so a
    later call replays the graphs already captured (its bound raised by
    the call's), and a copy of the model gets a step of its own."""
    from dune_transformercvn_torch.predict import graph_predict_step

    _, port_cfg = family_config("dense")
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(6))
    step = graph_predict_step(model, False, 2)
    assert graph_predict_step(model, False, 3) is step and step.graphs.shapes == 5
    assert graph_predict_step(copy.deepcopy(model), False, 2) is not step
    assert graph_predict_step(model, True, 2) is not step
