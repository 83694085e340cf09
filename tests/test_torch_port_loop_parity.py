"""The port's Trainer against the JAX package's Trainer.

One JAX ``Trainer`` and one port ``Trainer`` (CPU) on the same synthetic
file (hit coordinates scaled to 48x40) with the same tiny options: float32,
dropout 0, pixel noise 0, a metric logged every step.  The port starts from
the JAX Trainer's initial weights (``from_jax.load_jax_variables``); both
``fit(max_steps=4, eval_interval=2)``.  Logged losses and validation metrics
agree at ``rtol=1e-4, atol=1e-5``, learning rates at ``rtol=1e-6``, and the
validation and checkpoint steps and the checkpoint index are the same.  The
JAX Trainer compiles its steps, so this file stands apart from
``test_torch_port_loop.py`` and gets a worker of its own.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.train import Trainer as JaxTrainer
from dune_transformercvn_tpu.train.logging import read_history as jax_read_history
from dune_transformercvn_tpu.train.state import param_count as jax_param_count
from dune_transformercvn_torch.from_jax import load_jax_variables
from dune_transformercvn_torch.train import Trainer
from dune_transformercvn_torch.train.logging import read_history
from dune_transformercvn_torch.utils.summary import param_count
from test_torch_port_loop import index_entries, small_synthetic_file, tiny_options

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
# near the production option file's 7.6e-6: an Adam step moves a weight by
# about lr whatever its gradient's last digits, so a large rate would turn
# float rounding of tiny gradients into visible loss differences
LEARNING_RATE = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    common = dict(training_file=small_synthetic_file(root / "train.h5", 64, 7),
                  learning_rate=LEARNING_RATE)
    theirs = JaxTrainer(tiny_options(JaxOptions, **common), run_dir=str(root / "jax"),
                        log_every_n_steps=1)
    ours = Trainer(tiny_options(**common), run_dir=str(root / "torch"), device="cpu",
                   log_every_n_steps=1)
    load_jax_variables(ours.state.model, jax.device_get(
        {"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}))
    results = ours.fit(max_steps=4, eval_interval=2), theirs.fit(max_steps=4, eval_interval=2)
    return ours, theirs, results


def histories(runs):
    ours, theirs, _ = runs
    return read_history(ours.run_dir), jax_read_history(theirs.run_dir)


def test_same_setup(runs):
    ours, theirs, _ = runs
    assert (ours.steps_per_epoch, ours.total_steps) == (theirs.steps_per_epoch,
                                                        theirs.total_steps)
    assert param_count(ours.state.model) == jax_param_count(theirs.state.params)
    assert ours.state.step == int(theirs.state.step) == 4


@pytest.mark.parametrize("tag", ["train_loss", "event_loss", "prong_loss",
                                 "val_epoch_AUC", "val_epoch_accuracy", "val_loss"])
def test_logged_metric_matches_jax(runs, tag):
    got, want = histories(runs)
    steps = [1, 2, 3, 4] if tag.endswith("_loss") and not tag.startswith("val") else [2, 4]
    assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == steps
    np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                               **TOL, err_msg=tag)


def test_learning_rates_match_jax(runs):
    got, want = histories(runs)
    tag = "lr-AdamW/pg1"
    assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                               rtol=1e-6)


def test_fit_results_match_jax(runs):
    _, _, (got, want) = runs
    for key in ("val_epoch_AUC", "val_epoch_accuracy", "val_loss",
                "event_epoch_AUC", "prong_epoch_AUC"):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_checkpoints_match_jax(runs):
    ours, theirs, _ = runs
    got = index_entries(os.path.join(ours.run_dir, "checkpoints"))
    want = index_entries(os.path.join(theirs.run_dir, "checkpoints"))
    assert got[0] == want[0] == 4
    assert [(s, p) for s, _, p in got[1]] == [(s, p) for s, _, p in want[1]] == [
        (2, "step_2"), (4, "step_4")]
    np.testing.assert_allclose([m for _, m, _ in got[1]], [m for _, m, _ in want[1]], **TOL)
    with open(os.path.join(ours.run_dir, "checkpoints", "index.json")) as f, \
            open(os.path.join(theirs.run_dir, "checkpoints", "index.json")) as g:
        a, b = json.load(f), json.load(g)
    assert a.keys() == b.keys() and a["checkpoints"][0].keys() == b["checkpoints"][0].keys()


def test_predictions_match_jax(runs):
    ours, theirs, _ = runs
    got, want = ours.predict_split("validation"), theirs.predict_split("validation")
    assert got.keys() == want.keys()
    for key in ("event_targets", "prong_targets", "prong_event_index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("event_probabilities", "prong_probabilities"):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
