"""A JAX ``Trainer``'s run dir taken over by the port
(``tools/jax_run_to_torch.py``), and the parity runbook's port stages
(``dune_transformercvn_torch.parity_run``), on the CPU at the tiny width
of ``tests/test_torch_port_loop.py``.

* A JAX Trainer fits 4 steps with a validation and an orbax checkpoint
  every 2 (float32, dropout 0, pixel noise 0, static batch shapes); the
  tool writes a port run
  dir: ``options.json`` the port loads as JAX's, ``metrics.jsonl`` copied,
  ``checkpoints/step_2`` and ``step_4`` with the JAX index's metrics and
  last step, each holding the step, the norm statistics, AdamW's count
  and the generator state a fresh port run starts from.
* The port's ``evaluate_run`` of the converted best checkpoint against
  the JAX package's ``evaluate.py`` flow on its own (probabilities at
  ``rtol=1e-4``, targets equal), and the port's resume of the converted
  step 4 for 2 more steps against the JAX Trainer's resume of its step 4:
  the losses, validation metrics and the final parameters at
  ``test_torch_port_loop_parity``'s ``TOL``.
* Each of the eight optimizers, on a tiny dense network (one dense block,
  one encoder layer: packed q/k/v): the JAX package's chain takes 2
  updates and is checkpointed with orbax (once for the module); the tool
  maps the checkpoint into the port's optimizer (moments, slots and
  count); 2 more updates on both sides agree at
  ``test_torch_port_optimizers``' tolerances, so every moment landed on
  its parameter.  A state the port's optimizer cannot take (another
  optimizer's slots) raises, naming the optimizer.
* ``parity_run --smoke --from_jax`` (``--ours_only`` on the tutorial
  option file cut to tiny widths) runs the port's train and evaluate CLIs
  as subprocesses and the tool on the JAX run dir; its scores, and those
  in its record, equal ``evaluation.evaluate_predictions`` of
  ``evaluate_run``'s predictions, for ours and for the converted JAX
  run.  Stages 3-4 are ``tools/parity_run.py``'s own functions.
"""

import dataclasses
import json
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.train import Trainer as JaxTrainer
from dune_transformercvn_tpu.train import optimizer as jax_optimizer
from dune_transformercvn_tpu.train import schedules as jax_schedules
from dune_transformercvn_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from dune_transformercvn_tpu.train.logging import read_history as jax_read_history
from dune_transformercvn_torch import Options, evaluation, parity_run
from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.evaluate import evaluate_run
from dune_transformercvn_torch.from_jax import state_dict_from_jax
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.train import Trainer, create_train_state, schedules
from dune_transformercvn_torch.train.logging import read_history
from test_torch_port_loop import index_entries, small_synthetic_file, tiny_options
from test_torch_port_loop_parity import LEARNING_RATE, TOL
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_torch.data import Batcher
from test_torch_port_network import random_variables, tiny_config
from test_torch_port_optimizers import (ADAMW_TOL, PARAM_TOL, STEPS_PER_EPOCH,  # noqa: F401
                                        assert_params_close, optimizer_step, port_grads,
                                        steps)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import jax_run_to_torch  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX Trainer fit 4 steps, and its run dir converted."""
    root = tmp_path_factory.mktemp("jax_run")
    path = small_synthetic_file(root / "train.h5", 64, 7)
    theirs = JaxTrainer(tiny_options(JaxOptions, training_file=path,
                                     learning_rate=LEARNING_RATE, static_batch_shapes=True),
                        run_dir=str(root / "jax"), log_every_n_steps=1)
    theirs.fit(max_steps=4, eval_interval=2)
    steps = jax_run_to_torch.convert(theirs.run_dir, str(root / "torch"))
    assert steps == [2, 4]
    return theirs, root, path


def test_converted_run_dir(jax_run):
    theirs, root, _ = jax_run
    ours = root / "torch"
    assert (Options.load(str(ours / "options.json")).to_dict()
            == JaxOptions.load(os.path.join(theirs.run_dir, "options.json")).to_dict())
    with open(ours / "metrics.jsonl") as f, \
            open(os.path.join(theirs.run_dir, "metrics.jsonl")) as g:
        assert f.read() == g.read()
    got = index_entries(str(ours / "checkpoints"))
    want = index_entries(os.path.join(theirs.run_dir, "checkpoints"))
    assert got[0] == want[0] == 4
    assert [(s, m, p) for s, m, p in got[1]] == [(s, m, p) for s, m, p in want[1]]
    fresh = Trainer(Options.load(str(ours / "options.json")), run_dir=None, debug=True,
                    verbose=False, device="cpu")
    for step in (2, 4):
        saved = torch.load(ours / "checkpoints" / f"step_{step}" / "state.pt",
                           weights_only=True)
        assert saved["step"] == step
        assert {float(s["step"]) for s in saved["optimizer"]["state"].values()} == {step}
        assert torch.equal(saved["generator"], fresh.state.generator.get_state())
        for key, value in jax.device_get(theirs.state.norm).items():
            np.testing.assert_array_equal(saved["norm"][key].numpy(), value)


def jax_evaluate(trainer, run_dir, checkpoint="best"):
    """``evaluate.py``'s flow on a JAX Trainer: restore, predict."""
    mgr = JaxCheckpointManager(os.path.join(run_dir, "checkpoints"))
    step = mgr.best_step() if checkpoint == "best" else mgr.latest_step()
    trainer.state = jax.device_put(mgr.restore(jax.device_get(trainer.state), step),
                                   trainer.state_sharding)
    return trainer.predict_split("validation")


def test_evaluate_run_of_the_converted_run_equals_jax_evaluate(jax_run):
    theirs, root, _ = jax_run
    got, _, _ = evaluate_run(str(root / "torch"), "best", device="cpu")
    want = jax_evaluate(theirs, theirs.run_dir)
    assert got.keys() == want.keys()
    for key in ("event_targets", "prong_targets", "prong_event_index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("event_probabilities", "prong_probabilities"):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_resume_of_the_converted_run_equals_jax_resume(jax_run):
    theirs, root, _ = jax_run
    ours = Trainer(Options.load(str(root / "torch" / "options.json")),
                   run_dir=str(root / "torch_resume"), device="cpu", log_every_n_steps=1)
    ours.resume(str(root / "torch" / "checkpoints" / "step_4"))
    theirs.resume(os.path.join(theirs.run_dir, "checkpoints", "step_4"))
    got_val = ours.fit(max_steps=6, eval_interval=2)
    want_val = theirs.fit(max_steps=6, eval_interval=2)
    got, want = read_history(ours.run_dir), jax_read_history(theirs.run_dir)
    for tag in ("train_loss", "event_loss", "prong_loss", "val_loss", "val_epoch_AUC"):
        mine = [(s, v) for s, v in got[tag] if s > 4]
        theirs_ = [(s, v) for s, v in want[tag] if s > 4]
        assert [s for s, _ in mine] == [s for s, _ in theirs_] and mine, tag
        np.testing.assert_allclose([v for _, v in mine], [v for _, v in theirs_], **TOL,
                                   err_msg=tag)
    for key in ("val_loss", "val_epoch_AUC", "event_epoch_AUC", "prong_epoch_AUC"):
        np.testing.assert_allclose(got_val[key], want_val[key], **TOL, err_msg=key)
    assert ours.state.step == int(theirs.state.step) == 6
    want_sd = state_dict_from_jax(jax.device_get(
        {"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}),
        ours.model_config)
    for name, tensor in ours.state.model.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), want_sd[name].numpy(), **TOL, err_msg=name)


# ---------------------------------------------------------------------------
# each optimizer's state
# ---------------------------------------------------------------------------

OPTIMIZERS = ["adamw", "adam", "sgd", "rmsprop", "adagrad", "lamb", "lars", "lion"]


@pytest.fixture(scope="module")
def network():
    """``test_torch_port_optimizers``' tiny dense network cut to one dense
    block and one encoder layer (packed q/k/v still): its JAX variables and
    its port config."""
    cut = dict(densenet_structure=(1,), num_encoder_layers=1)
    cfg, port_cfg = (dataclasses.replace(c, **cut) for c in tiny_config())
    ds = InMemoryEvents(2, 0, (cfg.image_height, cfg.image_width))
    batch = Batcher(ds, batch_size=2, coo_granularity=64).build_batch(np.arange(2))
    variables = random_variables(
        JaxTransformerCVN(cfg), 5, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in ds.norm().items()}, train=False)
    return variables, port_cfg


def optimizer_options(cls, name):
    opts = cls()
    opts.update_options(dict(
        optimizer=name, learning_rate=1e-2, l2_penalty=0.1, gradient_clip=3.0,
        epochs=2, learning_rate_warmup_epochs=0.5, learning_rate_cycles=1))
    return opts


def jax_checkpoint(name, variables, grads, path, norm):
    """The JAX chain of ``name`` after ``grads``' updates, checkpointed with
    orbax as the JAX Trainer's state is; returns ``(update, params, state)``."""
    opts = optimizer_options(JaxOptions, name)
    schedule = jax_schedules.from_options(opts, STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_optimizer.create_optimizer(opts, schedule, params_template=params)
    state = jax.jit(tx.init)(params)     # (eagerly, every leaf's op compiles)
    update = jax.jit(lambda p, s, g: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    for g in grads:
        params, state = update(params, state, g)
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(str(path), {"step": np.int32(len(grads)),
                                  "params": params, "batch_stats": variables["batch_stats"],
                                  "opt_state": state, "norm": norm,
                                  "base_rng": np.zeros(2, np.uint32)})
    checkpointer.wait_until_finished()
    return update, params, state


@pytest.fixture(scope="module")
def checkpoints(network, steps, tmp_path_factory):
    """``checkpoint(name) -> (path, update, params, state, norm)``: each
    optimizer's chain after 2 updates, checkpointed once for the module."""
    variables, port_cfg = network
    norm = InMemoryEvents(2, 0, (port_cfg.image_height, port_cfg.image_width)).norm()
    root, made = tmp_path_factory.mktemp("optax"), {}

    def checkpoint(name):
        if name not in made:
            made[name] = (root / name, *jax_checkpoint(name, variables, steps[:2],
                                                       root / name, norm), norm)
        return made[name]
    return checkpoint


def port_state(name, port_cfg, norm):
    """A fresh port state of ``name``'s optimizer, in the tool's
    ``trainer`` shape (``state``, ``model_config``)."""
    model = TransformerCVN(port_cfg)
    opts = optimizer_options(Options, name)
    state = create_train_state(model, opts, norm, STEPS_PER_EPOCH)
    return types.SimpleNamespace(state=state, model_config=port_cfg), opts


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_each_optimizers_state_carries_over(network, steps, checkpoints, name):
    variables, port_cfg = network
    path, update, params, state, norm = checkpoints(name)
    trainer, opts = port_state(name, port_cfg, norm)
    generator = trainer.state.generator.get_state()
    assert jax_run_to_torch.convert_checkpoint(str(path), trainer, name, generator) == 2
    assert trainer.state.step == 2
    model, optimizer = trainer.state.model, trainer.state.optimizer
    schedule = schedules.from_options(opts, STEPS_PER_EPOCH)
    for step, grads in enumerate(steps[2:], start=2):
        params, state = update(params, state, grads)
        port_grads(model, variables, grads)
        optimizer_step(optimizer, model, opts.learning_rate, schedule, step)
    tol = ADAMW_TOL if type(optimizer) is torch.optim.AdamW else PARAM_TOL
    assert_params_close(model, variables, jax.device_get(params), **tol)


# a state without the port's slots, a state with moments the port's
# optimizer has no slot for, and none where the port needs one
@pytest.mark.parametrize("saved,read", [("adamw", "lion"), ("adam", "sgd"), ("sgd", "rmsprop")])
def test_a_state_the_optimizer_cannot_take_raises(network, checkpoints, saved, read):
    path, *_, norm = checkpoints(saved)
    trainer, _ = port_state(read, network[1], norm)
    with pytest.raises(ValueError, match=f"port's '{read}'"):
        jax_run_to_torch.convert_checkpoint(str(path), trainer, read,
                                            trainer.state.generator.get_state())


# ---------------------------------------------------------------------------
# the parity runbook's port stages
# ---------------------------------------------------------------------------

def test_parity_run_smoke_scores_equal_evaluate_run(jax_run, tmp_path, monkeypatch):
    theirs, root, path = jax_run
    # the CLIs' subprocesses on the test's threads: the same sums
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    work = tmp_path / "work"
    scores = parity_run.main(["--smoke", "--data", path, "--steps", "4",
                              "--workdir", str(work), "--device", "cpu",
                              "--from_jax", theirs.run_dir])
    assert sorted(scores) == ["from_jax", "ours"]
    with open(work / "parity_run_smoke.json") as f:
        record = json.load(f)
    ours_dir = work / "ours" / "parity" / "version_0"
    for name, run_dir in (("ours", ours_dir), ("from_jax", work / "from_jax")):
        predictions, _, _ = evaluate_run(str(run_dir), "last", device="cpu")
        want = evaluation.evaluate_predictions(
            predictions["event_probabilities"], predictions["event_targets"],
            predictions["prong_probabilities"], predictions["prong_targets"])
        assert scores[name].keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_array_equal(np.asarray(scores[name][key]), np.asarray(value),
                                          err_msg=f"{name} {key}")
        assert record[f"{name}_metrics"] == parity_run.scalars(want)
    with open(ours_dir / "checkpoints" / "index.json") as f:
        assert json.load(f)["last"] == 4


def test_reference_stages_are_the_jax_runbooks():
    train_reference, eval_reference = parity_run.reference_stages()
    for fn in (train_reference, eval_reference):
        assert fn.__code__.co_filename == os.path.join(parity_run.REPO, "tools",
                                                       "parity_run.py")
    assert (train_reference.__name__, eval_reference.__name__) == ("train_reference",
                                                                   "eval_reference")
