"""The graph ``Trainer`` (``graph=True``) and the CLIs' ``--cuda_graph`` on
the CPU, where the graph-safe step bodies run without a capture, at the
tiny width of ``tests/test_torch_port_loop.py``.

* ``Trainer(graph=True)`` at ``steps_per_dispatch`` K = 2 against the JAX
  package's Trainer at K = 2 (``test_torch_port_loop_parity.fit_both``:
  batch 7, 7 steps an epoch, validation every 3 steps, 10 steps): each full
  group of 2 is one call of the 2-step body on stacked batches, the
  epoch's 7th batch the one-step body; the logged losses and the
  validation loss at that file's ``TOL`` (``rtol=1e-4, atol=1e-5``), rates
  at ``rtol=1e-6``, the same validation, log and checkpoint steps; the
  final validation probabilities within 1e-3 of JAX's, argmax equal
  wherever JAX's two largest lie more than twice the largest difference
  apart.  The validation's AUCs and accuracy count scores: the AUCs come
  from 64-bin histograms whose counts move by a whole prong when a
  probability within rounding of a bin edge crosses it (one crossing moves
  ``val_epoch_AUC`` by ~1.4e-4 on these 12 events; measured: the graph run
  1.4e-4 from JAX at step 4, the eager port's K = 2 run 5.9e-5), so they
  are held to ``AUC_SLACK``; the accuracy may move by one event whose two
  largest probabilities tie within rounding (measured: at step 10 an event
  with JAX's top two 2.2e-5 apart, the probabilities 7.4e-5 apart, half of
  the accuracy's 1/12 a event).
* With dropout and pixel noise on, a graph run checkpointed at step 2 and
  resumed in a fresh graph ``Trainer`` ends equal, bit for bit, to the
  uninterrupted run: the optimizer's moments and count and the norm
  statistics restore into the live tensors, and each step's seed comes
  from the checkpointed generator.
* The train and evaluate CLIs with ``--cuda_graph --device cpu``: a run
  of 4 steps at K = 2, and its evaluation equal to eager's.
"""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.evaluate import evaluate_run
from dune_transformercvn_torch.evaluate import main as evaluate_main
from dune_transformercvn_torch.train import Trainer
from dune_transformercvn_torch.train.__main__ import main as train_main
from dune_transformercvn_torch.train.__main__ import parser as train_parser
from dune_transformercvn_torch.train.optimizer import GraphAdamW
from test_torch_port_loop import (TINY, H, W, assert_same_state, index_entries,
                                  small_synthetic_file, tiny_options)
from test_torch_port_loop_parity import TOL, fit_both, histories

torch.set_num_threads(2)

# a few prongs' scores crossing histogram bin edges (module docstring)
AUC_SLACK = 1e-3


@pytest.fixture(scope="module")
def graph_k2_runs(tmp_path_factory):
    return fit_both(tmp_path_factory.mktemp("graph_k2"), max_steps=10, eval_interval=3,
                    graph=True, steps_per_dispatch=2, batch_size=7, checkpoint_top_k=10)


def test_graph_trainer_matches_jax_at_k2(graph_k2_runs):
    ours, theirs, (got_result, want_result) = graph_k2_runs
    assert isinstance(ours.state.optimizer, GraphAdamW)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 7
    assert ours.state.step == int(theirs.state.step) == 10
    got, want = histories(graph_k2_runs)
    assert [s for s, _ in got["train_loss"]] == [s for s, _ in want["train_loss"]] == [
        2, 4, 6, 7, 9, 10]
    assert [s for s, _ in got["val_loss"]] == [s for s, _ in want["val_loss"]] == [4, 6, 9, 10]
    for tag in ("train_loss", "event_loss", "prong_loss", "val_loss"):
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                                   **TOL, err_msg=tag)
    one_event = 0.5 / len(ours.validation_dataset)
    np.testing.assert_allclose([v for _, v in got["val_epoch_accuracy"]],
                               [v for _, v in want["val_epoch_accuracy"]], rtol=0,
                               atol=one_event + TOL["atol"])
    np.testing.assert_allclose([v for _, v in got["val_epoch_AUC"]],
                               [v for _, v in want["val_epoch_AUC"]], rtol=0, atol=AUC_SLACK)
    np.testing.assert_allclose([v for _, v in got["lr-AdamW/pg1"]],
                               [v for _, v in want["lr-AdamW/pg1"]], rtol=1e-6)
    np.testing.assert_allclose(got_result["val_loss"], want_result["val_loss"], **TOL)
    np.testing.assert_allclose(got_result["val_epoch_AUC"], want_result["val_epoch_AUC"],
                               rtol=0, atol=AUC_SLACK)
    got_p, want_p = ours.predict_split("validation"), theirs.predict_split("validation")
    for key in ("event_probabilities", "prong_probabilities"):
        diff = np.abs(got_p[key] - want_p[key]).max()
        top = np.sort(want_p[key], -1)
        clear = top[:, -1] - top[:, -2] > 2 * diff
        assert diff <= 1e-3 and clear.mean() > 0.9, (key, diff, clear.mean())
        np.testing.assert_array_equal(got_p[key].argmax(-1)[clear],
                                      want_p[key].argmax(-1)[clear], err_msg=key)
    mine = index_entries(os.path.join(ours.run_dir, "checkpoints"))
    theirs_index = index_entries(os.path.join(theirs.run_dir, "checkpoints"))
    assert mine[0] == theirs_index[0] == 10
    assert [(s, p) for s, _, p in mine[1]] == [(s, p) for s, _, p in theirs_index[1]]


def graph_trainer(run_dir, **overrides):
    datasets = (InMemoryEvents(16, 1, (H, W)), InMemoryEvents(8, 2, (H, W)), None)
    return Trainer(tiny_options(steps_per_dispatch=2, **overrides), run_dir=str(run_dir),
                   device="cpu", datasets=datasets, log_every_n_steps=1, graph=True)


def test_graph_trainer_resumes_bit_for_bit(tmp_path):
    noisy = dict(dropout=0.1, pixel_noise_std=0.05)
    whole = graph_trainer(tmp_path / "whole", **noisy)
    whole.fit(max_steps=6, eval_interval=2)
    resumed = graph_trainer(tmp_path / "resumed", **noisy)
    norm = resumed.state.norm["mean"]
    resumed.resume(str(tmp_path / "whole" / "checkpoints" / "step_2"))
    assert resumed.state.step == 2 and resumed.state.norm["mean"] is norm
    assert int(resumed.state.optimizer.count) == 2
    resumed.fit(max_steps=6, eval_interval=2)
    assert int(resumed.state.optimizer.count) == 6
    assert_same_state(resumed.state.state_dict(), whole.state.state_dict())


def test_the_clis_take_cuda_graph(tmp_path, monkeypatch):
    """``train --cuda_graph`` fits 4 steps at K = 2 through the graph-safe
    steps; ``evaluate --cuda_graph`` of the run writes the predictions
    eager ``evaluate_run`` makes."""
    assert not train_parser().parse_args([]).cuda_graph
    data = small_synthetic_file(tmp_path / "train.h5", 48, 5)
    (tmp_path / "options.json").write_text(json.dumps({**TINY, "training_file": data}))
    monkeypatch.chdir(tmp_path)
    train_main(**vars(train_parser().parse_args([
        "-o", "options.json", "-n", "run", "-l", "logs", "--device", "cpu", "--max_steps",
        "4", "-e", "2", "--steps_per_dispatch", "2", "--cuda_graph"])))
    run_dir = tmp_path / "logs" / "run" / "version_0"
    assert index_entries(str(run_dir / "checkpoints"))[0] == 4
    # the graph-safe AdamW's count, as each parameter's step
    state = torch.load(run_dir / "checkpoints" / "step_4" / "state.pt", weights_only=True)
    assert {float(s["step"]) for s in state["optimizer"]["state"].values()} == {4.0}
    evaluate_main([str(run_dir), "--device", "cpu", "--cuda_graph"])
    # the eager Trainer restores the graph-safe AdamW's checkpoint
    want, _, _ = evaluate_run(str(run_dir), device="cpu")
    with h5py.File(run_dir / "eval_predictions.h5") as f:
        for key, value in want.items():
            np.testing.assert_array_equal(f[key][:], value, err_msg=key)
