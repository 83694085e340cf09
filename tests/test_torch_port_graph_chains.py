"""The graph-safe step bodies (``graph=True``) with the memory recipes and
with every optax chain, on the CPU, where the bodies run without a capture
(``tests/test_torch_port_cuda.py`` captures them on the card).

* The K = 2 train body with ``remat_cnn``, and with each of the seven optax
  chains (adam, sgd, rmsprop, adagrad, lamb, lars, lion), against the JAX
  package's scanned step (``make_train_step(..., steps_per_dispatch=2)``)
  on the same stacked batches with transplanted weights (tiny dense
  network, float32, dropout 0, noise 0, clipping active, a warm-up then
  cosine rate): the stacked metrics at ``test_torch_port_train``'s
  tolerances, the running statistics at ``rtol=atol=1e-5`` and the
  parameters by its Adam rule (:func:`.assert_adam_params_close`), the
  rate scaled by the chain's largest update per unit rate (lion: stable
  where the argument of its sign stayed above 1e-5, not the gradient).
* The same bodies against the eager step (``graph=False``) from the same
  state, dropout 0.1 and pixel noise 0.02 on: equal bit for bit (metrics,
  parameters, BatchNorm buffers, the optimizer's slots and count, the
  generator); for remat_cnn, remat_embedder and embedder_chunk too.
* A chain's run resumed across eager and graph: 2 eager steps saved
  through ``TrainState.state_dict`` and ``torch.save`` and restored into a
  graph state, then one K = 2 call, and the reverse, equal bit for bit to
  4 eager steps; the checkpoint keeps the count as an int in each param
  group, and a restore writes into the live tensors.  Live, every param
  group's count is the optimizer's one device tensor.
* The optimizers' float32 bias correction ``1 - b ** count`` (0-d tensors,
  as the update computes it) equals XLA's at every count up to 2^17.
"""

import copy
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.train import schedules as jax_schedules
from dune_transformercvn_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from dune_transformercvn_tpu.train.step import make_train_step as jax_make_train_step
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.from_jax import state_dict_from_jax
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.predict import to_device
from dune_transformercvn_torch.train import create_train_state, make_train_step
from dune_transformercvn_torch.train.optimizer import CHAINS, bias_correction, graph_safe
from test_torch_port_graph import assert_identical, everything, stacked
from test_torch_port_train import (LOSS_TOL, STEPS_PER_EPOCH, assert_adam_params_close,
                                   batch_and_norm, family_config, start_both, step_options)

torch.set_num_threads(2)

K = 2
# the largest size of one update per unit rate: rmsprop's and adagrad's
# first step is g / sqrt(0.1 g^2) = sqrt(10) at most; the others' at most 1
UPDATE_SCALE = {"rmsprop": 10 ** 0.5, "adagrad": 10 ** 0.5}


def with_optimizer(name, both, norm):
    """``start_both``'s two states with ``name``'s optimizer on both sides
    (JAX: the package's optax chain; the port: its graph-safe state)."""
    (jax_model, jopts, _, mesh, jax_state), (model, opts, _), port_cfg = both
    jopts.update_options(dict(optimizer=name))
    opts.update_options(dict(optimizer=name))
    tx = jax_create_optimizer(jopts, jax_schedules.from_options(jopts, STEPS_PER_EPOCH))
    jax_state = jax_state.replace(opt_state=jax.jit(tx.init)(jax_state.params))
    state = create_train_state(model, opts, norm, STEPS_PER_EPOCH, seed=0, graph=True)
    return (jax_model, jopts, tx, mesh, jax_state), (model, opts, state), port_cfg


@pytest.mark.parametrize("case", ["remat_cnn", *CHAINS])
def test_graph_body_matches_jax_scan(synthetic_file, case):
    """K = 2 steps as one call of the graph body against JAX's scanned
    step with the same recipe or chain."""
    batches, norm = batch_and_norm(synthetic_file, K, "dense")
    overrides = {"remat_cnn": True} if case == "remat_cnn" else {}
    both = start_both("dense", 0.5, 0.5, batches, norm, **overrides)
    name = "adamw" if case == "remat_cnn" else case
    (jax_model, jopts, tx, mesh, jax_state), (model, opts, state), port_cfg = (
        with_optimizer(name, both, norm))
    assert model.cfg.remat_cnn == (case == "remat_cnn") and graph_safe(state.optimizer)
    jax_step = jax_make_train_step(jax_model, tx, jopts, mesh, steps_per_dispatch=K)
    jax_state, want = jax_step(jax_state, {n: jnp.asarray(v) for n, v in stacked(
        batches).items()})
    grads = []
    update = state.optimizer.step

    def recorded(*args, **kwargs):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return update(*args, **kwargs)

    state.optimizer.step = recorded
    got = make_train_step(model, opts, graph=True, steps_per_dispatch=K)(
        state, stacked([to_device(b, "cpu") for b in batches]))
    assert state.step == int(jax_state.step) == K and len(grads) == K
    assert set(got) == set(want)
    for key in want:
        tol = dict(rtol=1e-4) if key == "grad_norm" else LOSS_TOL
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **tol,
                                   err_msg=key)
    assert float(got["grad_norm"][0]) > 0.5                 # clipping was active
    stable = {n: torch.ones_like(p, dtype=torch.bool) for n, p in model.named_parameters()}
    momentum = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    for step_grads in grads:
        for n, g in step_grads.items():
            if case == "lion":
                # the sign's argument, not the gradient, decides the update
                stable[n] &= (0.1 * g + 0.9 * momentum[n]).abs() > 1e-5
                momentum[n] = 0.99 * momentum[n] + 0.01 * g
            else:
                stable[n] &= g.abs() > 1e-4
    want_sd = state_dict_from_jax(jax.device_get(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}), port_cfg)
    got_sd = model.state_dict()
    for n, want_t in want_sd.items():
        if n not in stable:                                 # BatchNorm statistics
            np.testing.assert_allclose(got_sd[n].numpy(), want_t.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=n)
    lr = opts.learning_rate * UPDATE_SCALE.get(case, 1.0)
    assert assert_adam_params_close(got_sd, want_sd, stable, lr, K) > 1000


BODY_CASES = [("dense", {"remat_cnn": True}, "adamw"),
              ("coo", {"remat_embedder": True}, "adamw"),
              ("sdxl", {"embedder_chunk": 8, "embedder_chunk_save_spatial": 64}, "adamw"),
              *[("dense", {}, name) for name in CHAINS]]


@pytest.mark.parametrize("family,flags,name", BODY_CASES,
                         ids=[f"{f}-{'-'.join(x) or n}" for f, x, n in BODY_CASES])
def test_graph_body_is_the_eager_step(synthetic_file, family, flags, name):
    """K = 2 steps as one call of the graph body and 2 eager steps from the
    same state, dropout 0.1 and pixel noise 0.02: equal bit for bit."""
    batches, norm = batch_and_norm(synthetic_file, K, family)
    _, port_cfg = family_config(family)
    port_cfg = dataclasses.replace(port_cfg, dropout=0.1, pixel_noise_std=0.02, **flags)
    opts = step_options(Options, 0.5, 0.5)
    opts.update_options(dict(optimizer=name))
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(3))
    eager_model = copy.deepcopy(model)
    state, eager_state = (create_train_state(m, opts, norm, STEPS_PER_EPOCH, seed=7,
                                             graph=True) for m in (model, eager_model))
    got = make_train_step(model, opts, graph=True, steps_per_dispatch=K)(
        state, stacked([to_device(b, "cpu") for b in batches]))
    eager_step = make_train_step(eager_model, opts)
    want = [eager_step(eager_state, to_device(b, "cpu")) for b in batches]
    assert got.keys() == want[0].keys()
    for key, value in got.items():
        assert torch.equal(value, torch.stack([w[key].float() for w in want])), key
    assert_identical(everything(state), everything(eager_state))
    assert int(state.optimizer.count) == K


def checkpoint(state):
    buffer = io.BytesIO()
    torch.save(state.state_dict(), buffer)
    buffer.seek(0)
    return torch.load(buffer, weights_only=False)


@pytest.mark.parametrize("name", ["lamb", "lion"])
def test_chain_resumes_across_eager_and_graph(synthetic_file, name):
    """2 steps one way, a checkpoint, 2 steps the other way (one K = 2
    graph call, or 2 eager steps) from a fresh state restored from it:
    equal bit for bit to 4 eager steps, either way round."""
    batches, norm = batch_and_norm(synthetic_file, 4, "dense")
    _, port_cfg = family_config("dense")
    port_cfg = dataclasses.replace(port_cfg, dropout=0.1, pixel_noise_std=0.02)
    opts = step_options(Options, 0.5, 0.5)
    opts.update_options(dict(optimizer=name))
    start = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(3))
    batches = [to_device(b, "cpu") for b in batches]

    def fresh():
        model = copy.deepcopy(start)
        return create_train_state(model, opts, norm, STEPS_PER_EPOCH, seed=7, graph=True)

    def run(state, graph, chunk):
        if graph:
            make_train_step(state.model, opts, graph=True, steps_per_dispatch=K)(
                state, stacked(chunk))
        else:
            step = make_train_step(state.model, opts)
            for batch in chunk:
                step(state, batch)

    straight = fresh()
    run(straight, False, batches)
    for first_graph in (False, True):
        first = fresh()
        run(first, first_graph, batches[:2])
        saved = checkpoint(first)
        assert all(type(g["count"]) is int and g["count"] == 2
                   for g in saved["optimizer"]["param_groups"])
        resumed = fresh()
        live = [t for slots in resumed.optimizer.state.values() for t in slots.values()]
        count = resumed.optimizer.count
        resumed.load_state_dict(saved)
        assert resumed.optimizer.count is count and int(count) == 2
        assert all(a is b for a, b in zip(
            live, [t for slots in resumed.optimizer.state.values() for t in slots.values()]))
        run(resumed, not first_graph, batches[2:])
        assert_identical(everything(resumed), everything(straight))


def test_chain_groups_hold_the_live_count(synthetic_file):
    """An optax chain's step count is one device tensor, which every live
    param group holds (never a stale copy), an int in the checkpoint, and
    the live tensor again after a restore."""
    batches, norm = batch_and_norm(synthetic_file, 3, "dense")
    _, port_cfg = family_config("dense")
    opts = step_options(Options, 0.5, 0.5)
    opts.update_options(dict(optimizer="adam"))
    start = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(3))

    def fresh():
        return create_train_state(copy.deepcopy(start), opts, norm, STEPS_PER_EPOCH, seed=7,
                                  graph=True)

    def counts(state):
        groups = state.optimizer.param_groups
        assert all(g["count"] is state.optimizer.count for g in groups)
        return int(state.optimizer.count)

    state = fresh()
    step = make_train_step(state.model, opts)
    for batch in batches[:2]:
        step(state, to_device(batch, "cpu"))
    assert counts(state) == 2
    saved = checkpoint(state)
    assert [g["count"] for g in saved["optimizer"]["param_groups"]] == [2] * len(
        state.optimizer.param_groups)
    resumed = fresh()
    resumed.load_state_dict(saved)
    assert counts(resumed) == 2
    make_train_step(resumed.model, opts)(resumed, to_device(batches[2], "cpu"))
    assert counts(resumed) == 3


def test_bias_correction_is_xla_float32():
    """``1 - b ** count`` in float32 on 0-d tensors, for b 0.9 and 0.999
    and every count up to 2^17, against XLA's (optax's ``bias_correction``
    under ``jax.jit``): equal; numpy's float32 power is not (an ulp off
    from count 4 on)."""
    counts = np.arange(1, 2 ** 17 + 1, dtype=np.int32)
    for decay in (0.9, 0.999):
        want = np.asarray(jax.jit(lambda c: 1 - decay ** c)(jnp.asarray(counts)))
        got = np.array([float(bias_correction(decay, torch.tensor(float(c))))
                        for c in counts], np.float32)
        np.testing.assert_array_equal(got, want, err_msg=str(decay))
        numpy = np.float32(1) - np.float32(decay) ** counts.astype(np.float32)
        assert (numpy != want).any()


def test_graph_trainer_takes_remat_and_a_chain(tmp_path):
    """``Trainer(graph=True)`` with ``remat_cnn`` and lion (dropout and
    pixel noise on, K = 2, validation every 2 steps) fits 4 steps equal,
    bit for bit, to the eager Trainer's."""
    from dune_transformercvn_torch.data import InMemoryEvents
    from dune_transformercvn_torch.train import Trainer
    from test_torch_port_loop import H, W, tiny_options

    runs = []
    for graph in (True, False):
        datasets = (InMemoryEvents(16, 1, (H, W)), InMemoryEvents(8, 2, (H, W)), None)
        options = tiny_options(steps_per_dispatch=2, dropout=0.1, pixel_noise_std=0.05,
                               remat_cnn=True, optimizer="lion")
        trainer = Trainer(options, run_dir=str(tmp_path / str(graph)), device="cpu",
                          datasets=datasets, log_every_n_steps=1, graph=graph)
        assert trainer.state.model.cfg.remat_cnn
        trainer.fit(max_steps=4, eval_interval=2)
        runs.append(everything(trainer.state))
    assert runs[0]["step"] == 4
    assert_identical(*runs)
