"""The port's data-parallel Trainer against the JAX package's.

The port's ``Trainer`` runs as 2 ranks of a ``gloo`` group on the CPU
(``tests/_torch_dp_worker.py``), each feeding its shard of every global
batch; the JAX ``Trainer`` runs with ``num_gpu=2`` over 2 of this process's
virtual devices.  Both train the tiny options of ``test_torch_port_loop.py``
(float32, dropout 0, pixel noise 0) on the same file, from the JAX
Trainer's initial weights (``from_jax.load_jax_variables``), with
``fit(max_steps=4, eval_interval=2)``; the validation split ends in a
wrap-padded batch.  Cases: the dense family with sync-BN (the default),
and the coo family with sync-BN off (the running statistics averaged over
the ranks after each step).

At the loop-parity tolerance (``rtol=1e-4, atol=1e-5``): the logged losses,
``grad_norm`` and validation metrics, the final BatchNorm statistics, and
the ``predict_split`` rows, in JAX's order.  The final parameters follow
``test_torch_port_train.check_train_steps``' rule: an Adam step moves a
weight by about +-lr whatever the last digits of its gradient, so the
elements whose reduced gradient stayed above 1e-4 at every step (recorded
by the worker) agree within ``1e-2 * lr`` plus the float32 rounding of 4
updates (4 spacings of the value: 4.8e-7 at 1.0), and the rest within
``2 * steps * lr``.  The learning rate is 1e-6, not the loop-parity file's
1e-5: at 1e-5 the two frameworks' last digits move a validation event
across an edge of the AUC histogram, which shifts the binned
``val_epoch_AUC`` by 8e-5 to 2e-3.  A step moves a stable element by about
1e-6, so a reduced gradient of the wrong sign, no update, or gradient
pieces copied back to the wrong parameters fail the rule.  The two ranks'
states are equal bit for bit, and only rank 0 wrote the run dir.  The
ranks start before the JAX Trainer fits and run beside it.

The compiled data-parallel step: two ``gloo`` ranks (the worker's mode
``compiled``) each fit an eager and a compiled ``Trainer``
(``compile=True``) at ``test_torch_port_loop.SMALL``'s width, with
sync-BN traced into the compiled graph as a functional all-reduce (its
backward sums the cotangent over the group, as the eager
``autograd.Function`` does).  Each rank's compiled steps against its eager
steps (dropout 0, noise 0): metrics, running statistics and the
validation loss within ``tests/test_torch_port_compile.py``'s ``TOL`` plus
twice the eager fit's own spread under a reordering of each shard's 4
events (the worker fits the other 23 orders; ``assert_within_spread``
there says why; the validation's AUCs and accuracies bin and count
scores, and need only be defined where eager's are), gradients by its
``grads_close`` rule, parameters by ``test_torch_port_train``'s Adam rule;
the ranks' compiled states equal bit for bit.  Measured on an AVX-512
host: the validation loss 8.8e-5 from eager against the reorderings'
spread of 3.3e-4 (within ``TOL`` alone too).  Inductor compiles its C++
with one worker in each rank (``compile_threads = 1``).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.train import Trainer as JaxTrainer
from dune_transformercvn_tpu.train.logging import read_history as jax_read_history
from dune_transformercvn_torch.from_jax import state_dict_from_jax
from dune_transformercvn_torch.models import ModelConfig
from test_torch_port_compile import assert_within_spread, grads_close, network_largest
from test_torch_port_loop import SMALL, TINY, H, W, small_synthetic_file, tiny_options
from test_torch_port_parallel import finish_ranks, start_ranks
from test_torch_port_train import assert_adam_params_close

TOL = dict(rtol=1e-4, atol=1e-5)
LEARNING_RATE = 1e-6
CASES = {
    "dense": {},
    "coo_sync_off": dict(embedder="coo", sync_batch_norm=False),
}
FIT = dict(max_steps=4, eval_interval=2)


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    overrides = dict(training_file=small_synthetic_file(root / "train.h5", 64, 7),
                     learning_rate=LEARNING_RATE, num_gpu=2, **CASES[request.param])
    theirs = JaxTrainer(tiny_options(JaxOptions, **overrides), run_dir=str(root / "jax"),
                        log_every_n_steps=1, verbose=True)
    variables = jax.device_get({"params": theirs.state.params,
                                "batch_stats": theirs.state.batch_stats})
    torch.save(dict(options={**TINY, **overrides}, variables=variables,
                    log_dir=str(root / "torch"), fit=FIT), root / "setup.pt")
    started = start_ranks("trainer", root / "setup.pt", root)
    result = theirs.fit(**FIT)
    predictions = theirs.predict_split("validation")
    ranks = [torch.load(p, weights_only=False) for p in finish_ranks(started)]
    return theirs, result, predictions, ranks, root


def test_same_setup_and_only_rank_0_writes(runs):
    theirs, _, _, ranks, root = runs
    assert theirs.num_shards == 2
    for rank in ranks:
        assert (rank["global_batch"], rank["steps_per_epoch"], rank["step"]) == (
            theirs.global_batch, theirs.steps_per_epoch, 4)
    assert ranks[0]["run_dir"] == str(root / "torch" / "run" / "version_0")
    assert ranks[1]["run_dir"] is None and "history" not in ranks[1]
    assert os.listdir(root / "torch" / "run") == ["version_0"]


@pytest.mark.parametrize("tag", ["train_loss", "event_loss", "prong_loss", "grad_norm",
                                 "val_epoch_AUC", "val_epoch_accuracy", "val_loss"])
def test_logged_metric_matches_jax(runs, tag):
    theirs, _, _, ranks, _ = runs
    got, want = ranks[0]["history"], jax_read_history(theirs.run_dir)
    steps = [2, 4] if tag.startswith("val") else [1, 2, 3, 4]
    assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == steps
    np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                               **TOL, err_msg=tag)


def test_validation_and_checkpoints_match_jax(runs):
    theirs, result, _, ranks, _ = runs
    for rank in ranks:   # every rank validated over the whole split
        for key in ("val_epoch_AUC", "val_epoch_accuracy", "val_loss",
                    "event_epoch_AUC", "prong_epoch_AUC"):
            np.testing.assert_allclose(rank["result"][key], result[key], **TOL, err_msg=key)
    got = [c["step"] for c in ranks[0]["index"]["checkpoints"]]
    assert got == [2, 4] and ranks[0]["index"]["last"] == 4
    assert sorted(os.listdir(os.path.join(theirs.run_dir, "checkpoints"))) == [
        "index.json", "step_2", "step_4"]


def test_final_state_matches_jax_and_ranks_agree(runs):
    theirs, _, _, ranks, _ = runs
    cfg = ModelConfig(**{f.name: getattr(theirs.model_config, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    want = state_dict_from_jax(jax.device_get(
        {"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}), cfg)
    got, other, stable = ranks[0]["state"], ranks[1]["state"], ranks[0]["stable"]
    assert got.keys() == want.keys() == other.keys()
    for name, tensor in want.items():
        assert torch.equal(got[name], other[name]), name
        if name not in stable:                              # BatchNorm statistics
            np.testing.assert_allclose(got[name].numpy(), tensor.numpy(), **TOL, err_msg=name)
    steps = FIT["max_steps"]
    assert assert_adam_params_close(got, want, stable, LEARNING_RATE, steps,
                                    rounding=True) > 1000
    assert torch.equal(ranks[0]["generator"], ranks[1]["generator"])


def test_predictions_match_jax(runs):
    _, _, want, ranks, _ = runs
    for got in (r["predictions"] for r in ranks):
        assert got.keys() == want.keys()
        for key in ("event_targets", "prong_targets", "prong_event_index"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in ("event_probabilities", "prong_probabilities"):
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_compiled_data_parallel_steps_match_eager(tmp_path):
    check_compiled_ranks(tmp_path, {**TINY, **SMALL, "num_gpu": 2, "sync_batch_norm": True})


def check_compiled_ranks(tmp_path, options):
    """Two ranks of ``options`` fit eagerly and compiled: each rank's
    compiled steps, statistics, parameters and validation loss against its
    eager ones; the ranks' compiled states equal bit for bit."""
    setup = {
        "options": options,
        "training": (32, 1, (H, W)),
        "validation": (8, 2, (H, W)),
        "fit": dict(max_steps=2, eval_interval=2),
    }
    torch.save(setup, tmp_path / "setup.pt")
    outputs = finish_ranks(start_ranks("compiled", tmp_path / "setup.pt", tmp_path),
                           timeout=600)
    ranks = [torch.load(path, weights_only=False) for path in outputs]
    lr = setup["options"]["learning_rate"]
    for rank in ranks:
        eager, got, spread = rank["eager"], rank["compiled"], rank["spread"]
        assert len(got["steps"]) == len(eager["steps"]) == 2
        stable = {n: torch.ones_like(g, dtype=torch.bool) for n, g in got["steps"][0][1].items()}
        for i, ((metrics, grads), (want_metrics, want_grads), step_spread) in enumerate(
                zip(got["steps"], eager["steps"], spread["steps"])):
            for key, value in want_metrics.items():
                assert_within_spread(metrics[key], value, step_spread[key], f"step {i}: {key}")
            grads_close(grads, want_grads, network_largest(want_grads))
            for name, grad in grads.items():
                stable[name] &= grad.abs() > 1e-4
        assert spread["state"] and max(float(s.max()) for s in spread["state"].values()) > 0
        for name, largest in spread["state"].items():
            assert_within_spread(got["state"][name], eager["state"][name], largest, name)
        assert assert_adam_params_close(got["state"], eager["state"], stable, lr, 2) > 100
        # the validation's loss; its AUCs and accuracies bin and count
        # scores, so they need only be defined where eager's are
        assert spread["val_loss"] > 0.0
        assert_within_spread(got["result"]["val_loss"], eager["result"]["val_loss"],
                             spread["val_loss"], "val_loss")
        finite = [{k for k, v in r["result"].items() if np.isfinite(v)} for r in (got, eager)]
        assert finite[0] == finite[1] and "val_loss" in finite[0], finite
    for name, tensor in ranks[0]["compiled"]["state"].items():
        assert torch.equal(ranks[1]["compiled"]["state"][name], tensor), name
