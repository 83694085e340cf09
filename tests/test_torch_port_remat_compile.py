"""The compiled train step (``compile=True``) with the memory recipes:
``remat_cnn``, ``remat_embedder`` and ``embedder_chunk`` (with and without
``embedder_chunk_save_spatial``), the counterpart of the JAX package's
``nn.remat`` and ``nn.scan`` inside its jitted step.

* Each recipe's compiled step is one Dynamo graph with no graph break
  (``compile_step`` compiles with ``fullgraph``), and two compiled steps
  hold to the eager steps and to the JAX package's jitted step with the
  same recipe (tiny widths, ``test_torch_port_compile``'s ``SMALL``
  network, float32, dropout 0, pixel noise 0, transplanted weights): the
  metrics and, after the steps, the running statistics.  The running
  statistics move once a step: they equal those of the plain eager steps
  (no recipe; with chunking, whose convolutions run over other batch
  sizes, within ``TOL``).
* dense ``remat_cnn`` compiles with Inductor and is held to
  ``test_torch_port_compile.test_compiled_dense_steps_match_eager_and_jax``'s
  tolerances: ``TOL`` plus twice each reference's spread over the 23
  reorderings of the batch's events; gradients by its ``grads_close``.
  The other cases compile on the ``aot_eager`` backend, which runs the
  graph Dynamo and AOTAutograd traced (the checkpoint regions, the chunk
  region, the recompute in the backward) with eager kernels, so that the
  tests stay within their time here (Inductor compiles C++ for a CPU
  graph, ~40 s each): equal to the eager step bit for bit, and to JAX
  within ``TOL``.
* ``embedder_chunk``: the chunk body is one region (``invoke_subgraph``),
  traced once for each bank (event, prong) however many chunks run it,
  as JAX's ``nn.scan`` traces its body once.
* Dropout inside a rematted body: the compiled graph keeps the first
  run's draws (the forward graph draws, the backward graph draws
  nothing), and a compiled step with dropout 0.1 and pixel noise on
  equals the eager step bit for bit on ``aot_eager``.  Eagerly a remat
  runs no selective-checkpoint mode (its recompute draws again from the
  saved generator state), and equals a remat that keeps its draws
  (``keep_draws``, the graph step's) bit for bit.
* ``compile_step`` sets Dynamo's
  ``skip_fwd_side_effects_in_bwd_under_checkpoint`` only around its calls.
"""

import contextlib
import copy
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._dynamo.backends.common import aot_autograd
from torch._dynamo.utils import counters

from dune_transformercvn_tpu.train.step import make_train_step as jax_make_train_step
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.from_jax import state_dict_from_jax
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.predict import to_device
from dune_transformercvn_torch.train import create_train_state, make_train_step
import test_torch_port_train
from test_torch_port_compile import (FAMILY_CONFIG, SMALL, TOL, assert_within_spread,
                                     grads_close, network_largest, reorderings,
                                     train_spreads)
from test_torch_port_train import STEPS_PER_EPOCH, batch_and_norm, step_options

torch.set_num_threads(2)
torch._inductor.config.compile_threads = 1

CASES = [
    ("dense", {"remat_cnn": True}, "inductor"),
    ("coo", {"remat_cnn": True}, "aot_eager"),
    ("dense", {"remat_embedder": True}, "aot_eager"),
    ("sdxl", {"embedder_chunk": 8}, "aot_eager"),
    ("sdxl", {"embedder_chunk": 8, "embedder_chunk_save_spatial": 64}, "aot_eager"),
]


def small_configs(family, **overrides):
    """``(JAX config, port config)`` of the tiny ``family`` network, cut
    to ``SMALL``."""
    cfg, port = FAMILY_CONFIG(family, **overrides)
    return dataclasses.replace(cfg, **SMALL), dataclasses.replace(port, **SMALL)


@pytest.fixture
def small(monkeypatch):
    """``test_torch_port_train``'s networks cut to ``SMALL``."""
    monkeypatch.setattr(test_torch_port_train, "family_config", small_configs)


class Recorded:
    """A Dynamo backend that keeps each graph it is given and hands it to
    ``aot_eager``."""

    def __init__(self):
        self.graphs = []

    def __call__(self, gm, example_inputs):
        from torch._dynamo.backends.debugging import aot_eager

        self.graphs.append(gm)
        return aot_eager(gm, example_inputs)


def on_backend(monkeypatch, backend):
    """``compile_step`` as it is, its ``torch.compile`` given ``backend``."""
    compile = torch.compile

    def patched(fn, **kwargs):
        kwargs["backend"] = backend
        return compile(fn, **kwargs)

    monkeypatch.setattr(torch, "compile", patched)


def graph_events():
    return counters["stats"]["unique_graphs"], sum(counters["graph_break"].values())


def train_runs(family, batches, start, opts, **kwargs):
    """``runs(reordered)`` for ``train_spreads``: eager steps from
    ``start``."""
    def runs(reordered):
        net, state = copy.deepcopy(start)
        step = make_train_step(net, opts, **kwargs)
        steps = [step(state, to_device(b, "cpu")) for b in reordered or batches]
        return steps, {n: t.numpy() for n, t in net.state_dict().items() if "running_" in n}
    return runs


@pytest.mark.parametrize("family,flags,backend", CASES,
                         ids=[f"{f}-{'-'.join(x)}-{b}" for f, x, b in CASES])
def test_compiled_remat_steps_match_eager_and_jax(synthetic_file, small, monkeypatch,
                                                  family, flags, backend):
    batches, norm = batch_and_norm(synthetic_file, 2, family)
    jax_parts, (model, opts, state), port_cfg = test_torch_port_train.start_both(
        family, 43.0, 0.0, batches, norm, **flags)
    jax_model, jopts, tx, mesh, jax_state = jax_parts
    assert all(getattr(jax_model.cfg, k) == v == getattr(port_cfg, k) for k, v in flags.items())
    plain_cfg = dataclasses.replace(port_cfg, remat_cnn=False, remat_embedder=False,
                                    embedder_chunk=0, embedder_chunk_save_spatial=0)
    plain = TransformerCVN(plain_cfg)
    plain.load_state_dict(model.state_dict())
    plain_state = create_train_state(plain, opts, norm, STEPS_PER_EPOCH, seed=0)
    eager_model = copy.deepcopy(model)
    eager_state = create_train_state(eager_model, opts, norm, STEPS_PER_EPOCH, seed=0)
    start = copy.deepcopy((eager_model, eager_state))
    recorded = Recorded()
    on_backend(monkeypatch, recorded if backend == "aot_eager" else backend)
    before = graph_events()
    train = make_train_step(model, opts, compile=True)
    eager_train, plain_train = make_train_step(eager_model, opts), make_train_step(plain, opts)
    jax_train = jax_make_train_step(jax_model, tx, jopts, mesh)
    if backend == "inductor":
        orders = list(reorderings(batches, synthetic_file, family))
        eager_spread = train_spreads(train_runs(family, batches, start, opts), orders)

        def jax_runs(reordered):
            state = jax.tree_util.tree_map(jnp.copy, jax_state)
            steps = []
            for batch in reordered or batches:
                state, metrics = jax_train(state, {k: jnp.asarray(v) for k, v in batch.items()})
                steps.append(jax.device_get(metrics))
            sd = state_dict_from_jax(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats}), port_cfg)
            return steps, {n: t.numpy() for n, t in sd.items() if "running_" in n}

        jax_spread = train_spreads(jax_runs, orders)
    for i, batch in enumerate(batches):
        pb = to_device(batch, "cpu")
        got, eager, _ = train(state, pb), eager_train(eager_state, pb), plain_train(
            plain_state, pb)
        jax_state, want = jax_train(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        assert set(got) == set(want) == set(eager)
        grads = {n: p.grad for n, p in model.named_parameters()}
        eager_grads = {n: p.grad for n, p in eager_model.named_parameters()}
        for key in want:
            if backend == "inductor":
                assert_within_spread(got[key], eager[key], eager_spread[0][i][key],
                                     f"step {i}: {key} against eager")
                assert_within_spread(got[key], want[key], jax_spread[0][i][key],
                                     f"step {i}: {key} against JAX")
            else:
                assert torch.equal(got[key], eager[key]), key
                np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                           err_msg=f"step {i}: {key} against JAX")
        if backend == "inductor":
            grads_close(grads, eager_grads, network_largest(eager_grads))
        else:
            for name, g in eager_grads.items():
                assert torch.equal(grads[name], g), name
    assert graph_events() == (before[0] + 1, before[1])     # one graph, no break
    got_sd, plain_sd, eager_sd = model.state_dict(), plain.state_dict(), eager_model.state_dict()
    want_sd = state_dict_from_jax(jax.device_get(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}), port_cfg)
    stats = [n for n in got_sd if "running_" in n]
    assert stats and eager_sd.keys() == got_sd.keys()
    for name in stats:
        if backend == "inductor":
            assert_within_spread(got_sd[name], plain_sd[name], eager_spread[1][name],
                                 f"{name} against the plain steps")
            assert_within_spread(got_sd[name], want_sd[name], jax_spread[1][name],
                                 f"{name} against JAX")
        else:
            assert torch.equal(got_sd[name], eager_sd[name]), name
            if flags.get("embedder_chunk"):     # the bank's convolutions in other sizes
                np.testing.assert_allclose(got_sd[name].numpy(), plain_sd[name].numpy(),
                                           **TOL, err_msg=name)
            else:
                assert torch.equal(got_sd[name], plain_sd[name]), name
            np.testing.assert_allclose(got_sd[name].numpy(), want_sd[name].numpy(), **TOL,
                                       err_msg=name)
    if flags.get("embedder_chunk"):
        (gm,) = recorded.graphs
        calls = Counter(str(n.args[0].target) for n in gm.graph.nodes
                        if n.op == "call_function" and "invoke_subgraph" in str(n.target))
        chunks = -(-batch["slot_batch"].shape[0] // flags["embedder_chunk"])
        # the prong bank's chunks: calls of one region (a bank of one chunk
        # may be one call, or inlined)
        assert len(calls) <= 2 and max(calls.values()) == chunks > 1, calls


def random_ops(graph):
    return sum(1 for n in graph.graph.nodes if n.op == "call_function"
               and torch.Tag.nondeterministic_seeded in getattr(n.target, "tags", ()))


@pytest.mark.parametrize("flag", ["remat_cnn", "remat_embedder"])
def test_compiled_remat_keeps_the_first_runs_draws(synthetic_file, small, monkeypatch, flag):
    """Dropout 0.1 and pixel noise inside the compiled remat step: the
    forward graph draws, the backward graph (with its recompute) draws
    nothing, and two steps equal the eager steps bit for bit."""
    batches, norm = batch_and_norm(synthetic_file, 2, "dense")
    _, port_cfg = small_configs("dense")
    port_cfg = dataclasses.replace(port_cfg, dropout=0.1, pixel_noise_std=0.02, **{flag: True})
    opts = step_options(Options, 0.5, 0.0)
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(3))
    eager_model = copy.deepcopy(model)
    state, eager_state = (create_train_state(m, opts, norm, STEPS_PER_EPOCH, seed=5)
                          for m in (model, eager_model))
    graphs = {"forward": [], "backward": []}

    def keep(kind):
        def compiler(gm, example_inputs):
            graphs[kind].append(gm)
            return gm.forward
        return compiler

    on_backend(monkeypatch, aot_autograd(fw_compiler=keep("forward"),
                                         bw_compiler=keep("backward")))
    train, eager_train = make_train_step(model, opts, compile=True), make_train_step(
        eager_model, opts)
    for batch in batches:
        got, want = train(state, to_device(batch, "cpu")), eager_train(
            eager_state, to_device(batch, "cpu"))
        for key, value in want.items():
            assert torch.equal(got[key], value), key
    for name, tensor in eager_model.state_dict().items():
        assert torch.equal(model.state_dict()[name], tensor), name
    (forward,), (backward,) = graphs["forward"], graphs["backward"]
    assert random_ops(forward) > 0 and random_ops(backward) == 0


def test_eager_remat_rewinds_and_equals_keeping_the_draws(monkeypatch):
    """An eager remat of a body with a BatchNorm and dropout 0.5 takes no
    selective-checkpoint mode; inside ``keep_draws`` it takes one, and its
    output, input gradient, weight gradients and running statistics equal
    the eager remat's bit for bit."""
    from torch import nn

    from dune_transformercvn_torch.ops import masked

    taken = []
    contexts = masked.create_selective_checkpoint_contexts

    def counted(*args, **kwargs):
        taken.append(1)
        return contexts(*args, **kwargs)

    monkeypatch.setattr(masked, "create_selective_checkpoint_contexts", counted)

    class Body(nn.Module):
        def __init__(self):
            super().__init__()
            self.linear = nn.Linear(6, 6)
            self.norm = masked.MaskedBatchNorm(6)
            self.dropout = masked.Dropout(0.5)

        def forward(self, x):
            return self.dropout(torch.tanh(self.norm(self.linear(x)))).sum(-1)

    start = Body().train()
    x0 = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    runs = []
    for keep in (False, True):
        body, x = copy.deepcopy(start), x0.clone().requires_grad_(True)
        torch.manual_seed(11)
        with masked.keep_draws() if keep else contextlib.nullcontext():
            out = masked.remat(body, x)
            out.sum().backward()
        assert len(taken) == int(keep)
        runs.append([out, x.grad, *(p.grad for p in body.parameters()),
                     body.norm.running_mean, body.norm.running_var])
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    assert not torch.equal(runs[0][-2], start.norm.running_mean)


def test_compile_step_sets_the_checkpoint_flag_only_in_its_calls(monkeypatch):
    """Dynamo's ``skip_fwd_side_effects_in_bwd_under_checkpoint`` holds
    inside a compiled step's call and is back to its setting after."""
    from dune_transformercvn_torch.utils.compile import compile_step

    config = torch._dynamo.config
    seen = []

    def traced(fn, **kwargs):
        def call(*args):
            seen.append(config.skip_fwd_side_effects_in_bwd_under_checkpoint)
            return fn(*args)
        return call

    monkeypatch.setattr(torch, "compile", traced)
    before = config.skip_fwd_side_effects_in_bwd_under_checkpoint
    step = compile_step(lambda x: x + 1)
    assert not before and config.skip_fwd_side_effects_in_bwd_under_checkpoint is before
    assert torch.equal(step(torch.ones(2)), torch.full((2,), 2.0))
    assert seen == [True] and config.skip_fwd_side_effects_in_bwd_under_checkpoint is before
