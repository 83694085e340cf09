"""The port's optimizers against the JAX package's optax chains.

Every optimizer and alias of the JAX package's ``create_optimizer`` runs 4
steps on the parameters of a tiny dense network (two encoder layers, so
packed q/k/v projections) under a warm-up-then-cosine schedule with global
norm clipping that cuts two of the steps: JAX on its parameter tree (the
update jitted), the port on the same values carried by
``from_jax.state_dict_from_jax`` (its gradients carried the same way).  The
query, key and value gradients differ in scale by 10^4, so a trust ratio
taken over a packed ``in_proj`` tensor instead of per JAX leaf fails
(:func:`test_trust_ratio_is_per_jax_leaf` shows it).  Parameters agree within
``rtol=1e-6`` (``atol=1e-7`` for entries near zero): the two sides compute
the same float32 operations, apart from norms summed in other orders, a few
ulps.  AdamW (``torch.optim.AdamW``) takes its bias corrections
``1 - b ** t`` in float64 where optax takes them in float32; 0.999 is no
float32, so at t = 1 optax's ``1 - b2`` is off by 1.3e-5 of itself and its
update by half that, 6.5e-6 of the update's size, shrinking as t grows.  An
Adam update is at most about lr in size, so 4 steps at lr <= 1e-2 differ by
at most 4 * 1e-2 * 6.5e-6 = 2.6e-7: ``ADAMW_TOL``.  Then each stateful optimizer resumes
from a checkpoint bit for bit, and a port ``Trainer`` with lamb matches the
JAX ``Trainer`` over 4 steps.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.train import optimizer as jax_optimizer
from dune_transformercvn_tpu.train import schedules as jax_schedules
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import Batcher, InMemoryEvents
from dune_transformercvn_torch.from_jax import (jax_leaf_splits, load_jax_variables,
                                                state_dict_from_jax)
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.train import create_optimizer, create_train_state, schedules
from dune_transformercvn_torch.train.optimizer import (CHAINS, OptaxChain, clip_by_global_norm_,
                                                       global_norm)
from test_torch_port_loop_parity import TOL, fit_both, histories
from test_torch_port_network import random_variables, tiny_config

torch.set_num_threads(2)

NAMES = ["adamw", "adam", "sgd", "rmsprop", "adagrad", "lamb", "lars", "lion",
         "apex_adam", "apex_lamb", "apex_sgd"]
STATEFUL = ["adam", "rmsprop", "adagrad", "lamb", "lars", "lion"]
STEPS = 4
STEPS_PER_EPOCH = 2
CLIP = 3.0
# the global gradient norm of each step, against CLIP: clipped, not, clipped, not
GRAD_NORMS = (9.0, 1.5, 4.0, 2.0)
PARAM_TOL = dict(rtol=1e-6, atol=1e-7)
ADAMW_TOL = dict(rtol=1e-6, atol=2.6e-7)
# query / key / value gradient scales: a packed trust ratio would mix them
QKV_SCALE = {"query": 100.0, "key": 0.01, "value": 1.0}


def options(cls, name):
    opts = cls()
    opts.update_options(dict(
        optimizer=name, learning_rate=1e-2, l2_penalty=0.1, gradient_clip=CLIP,
        epochs=2, learning_rate_warmup_epochs=0.5, learning_rate_cycles=1))
    return opts


@pytest.fixture(scope="module")
def network():
    """A tiny dense network's JAX variables and its port config."""
    cfg, port_cfg = tiny_config()
    ds = InMemoryEvents(2, 0, (cfg.image_height, cfg.image_width))
    batch = Batcher(ds, batch_size=2, coo_granularity=64).build_batch(np.arange(2))
    variables = random_variables(
        JaxTransformerCVN(cfg), 5, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in ds.norm().items()}, train=False)
    return variables, port_cfg


def gradients(params, seed):
    """Seeded gradients for every leaf of ``params``, q/k/v scaled apart,
    each step's global norm set to ``GRAD_NORMS``."""
    rng = np.random.default_rng(seed)
    steps = []
    for norm in GRAD_NORMS:
        def draw(path, leaf):
            scale = QKV_SCALE.get(path[-2].key, 1.0) if len(path) > 1 else 1.0
            return (scale * rng.normal(size=leaf.shape)).astype(np.float32)
        tree = jax.tree_util.tree_map_with_path(draw, params)
        total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                            for g in jax.tree_util.tree_leaves(tree)))
        steps.append(jax.tree_util.tree_map(lambda g: (g * (norm / total)).astype(np.float32),
                                            tree))
    return steps


def jax_run(name, variables, steps):
    """The JAX package's chain over ``steps`` gradient trees."""
    opts = options(JaxOptions, name)
    schedule = jax_schedules.from_options(opts, STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_optimizer.create_optimizer(opts, schedule, params_template=params)
    state = tx.init(params)

    @jax.jit
    def update(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for grads in steps:
        params, state = update(params, state, grads)
    return jax.device_get(params)


def port_grads(model, variables, grads):
    """Each parameter's gradient, carried from the JAX tree like its value."""
    sd = state_dict_from_jax({"params": grads, "batch_stats": variables["batch_stats"]},
                             model.cfg)
    for name, p in model.named_parameters():
        p.grad = sd[name].clone()


def optimizer_step(optimizer, model, base_lr, schedule, step):
    """The optimizer part of the port's train step: clip, rate, update."""
    grads = [p.grad for p in model.parameters()]
    clip_by_global_norm_(grads, CLIP, global_norm(grads))
    for group in optimizer.param_groups:
        group["lr"] = base_lr * schedule(step)
    optimizer.step()


def port_run(name, variables, port_cfg, steps, optimizer_hook=None):
    opts = options(Options, name)
    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    optimizer = create_optimizer(opts, model)
    if optimizer_hook:
        optimizer_hook(optimizer)
    schedule = schedules.from_options(opts, STEPS_PER_EPOCH)
    for step, grads in enumerate(steps):
        port_grads(model, variables, grads)
        optimizer_step(optimizer, model, opts.learning_rate, schedule, step)
    return model, optimizer


def assert_params_close(model, variables, params, **tol):
    want = state_dict_from_jax({"params": params, "batch_stats": variables["batch_stats"]},
                               model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **tol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def steps(network):
    return gradients(network[0]["params"], 11)


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(network, steps, name):
    variables, port_cfg = network
    want = jax_run(name, variables, steps)
    model, optimizer = port_run(name, variables, port_cfg, steps)
    expected = {"adamw": torch.optim.AdamW, "apex_adam": torch.optim.AdamW,
                "apex_lamb": CHAINS["lamb"], "apex_sgd": CHAINS["sgd"]}.get(name)
    assert type(optimizer) is (expected or CHAINS[name])
    initial = state_dict_from_jax(variables, port_cfg)
    assert all(not torch.equal(p.detach(), initial[n]) for n, p in model.named_parameters())
    tol = ADAMW_TOL if type(optimizer) is torch.optim.AdamW else PARAM_TOL
    assert_params_close(model, variables, want, **tol)


@pytest.mark.parametrize("name", ["lamb", "lars"])
def test_trust_ratio_is_per_jax_leaf(network, steps, name):
    """With the q/k/v projections' trust ratio taken over the packed tensor
    (one leaf per parameter), the port no longer matches optax."""
    variables, port_cfg = network
    packed = [k for k, v in jax_leaf_splits(TransformerCVN(port_cfg)).items() if v == 3]
    assert len(packed) == 2 * port_cfg.num_encoder_layers
    want = jax_run(name, variables, steps)

    def one_leaf(optimizer):
        optimizer.leaves = {p: 1 for p in optimizer.leaves}

    model, _ = port_run(name, variables, port_cfg, steps, optimizer_hook=one_leaf)
    with pytest.raises(AssertionError):
        assert_params_close(model, variables, want, **PARAM_TOL)


@pytest.mark.parametrize("name", STATEFUL)
def test_resume_is_bit_exact(network, steps, name):
    """2 steps, a checkpoint through ``TrainState.state_dict`` and
    ``torch.save``, a fresh state restored from it, 2 more steps: equal bit
    for bit to 4 steps, parameters and optimizer state."""
    variables, port_cfg = network
    opts = options(Options, name)
    norm = {"mean": np.zeros(6, np.float32), "std": np.ones(6, np.float32),
            "extra_mean": np.zeros(4, np.float32), "extra_std": np.ones(4, np.float32)}

    def fresh():
        model = load_jax_variables(TransformerCVN(port_cfg), variables)
        return create_train_state(model, opts, norm, STEPS_PER_EPOCH)

    def run(state, chunk):
        for grads in chunk:
            port_grads(state.model, variables, grads)
            optimizer_step(state.optimizer, state.model, state.base_lr, state.schedule,
                           state.step)
            state.step += 1

    straight = fresh()
    run(straight, steps)
    first = fresh()
    run(first, steps[:2])
    buffer = io.BytesIO()
    torch.save(first.state_dict(), buffer)
    buffer.seek(0)
    resumed = fresh()
    resumed.load_state_dict(torch.load(buffer, weights_only=False))
    assert isinstance(resumed.optimizer, OptaxChain)
    assert all(g["count"] == 2 for g in resumed.optimizer.param_groups)
    run(resumed, steps[2:])
    for (name_a, a), (_, b) in zip(straight.model.state_dict().items(),
                                   resumed.model.state_dict().items()):
        assert torch.equal(a, b), name_a
    got, want = resumed.optimizer.state_dict(), straight.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert want["state"] and got["state"].keys() == want["state"].keys()
    for index, slots in want["state"].items():
        for key, tensor in slots.items():
            assert torch.equal(got["state"][index][key], tensor), (index, key)


def test_unknown_name_falls_back_to_adamw(capsys):
    opts = options(Options, "adadelta")
    assert isinstance(create_optimizer(opts, torch.nn.Linear(3, 2)), torch.optim.AdamW)
    assert "Using AdamW as a default" in capsys.readouterr().out


@pytest.fixture(scope="module")
def lamb_runs(tmp_path_factory):
    return fit_both(tmp_path_factory.mktemp("lamb"), optimizer="lamb")


@pytest.mark.parametrize("tag", ["train_loss", "val_loss", "val_epoch_AUC"])
def test_lamb_trainer_matches_jax(lamb_runs, tag):
    """The port's Trainer with lamb against the JAX Trainer over 4 steps:
    the logged values at the loop parity test's tolerance."""
    ours, _, _ = lamb_runs
    assert isinstance(ours.state.optimizer, CHAINS["lamb"])
    got, want = histories(lamb_runs)
    assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]
    np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                               **TOL, err_msg=tag)


def test_lamb_trainer_predictions_match_jax(lamb_runs):
    ours, theirs, _ = lamb_runs
    got, want = ours.predict_split("validation"), theirs.predict_split("validation")
    for key in ("event_probabilities", "prong_probabilities"):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
