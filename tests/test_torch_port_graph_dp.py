"""The port's graph steps (``graph=True``) in a process group, on the CPU,
where each rank runs the graph-safe step bodies uncaptured over ``gloo``
(on the card the same bodies are CUDA graphs whose collectives run on
nccl).  The JAX side is its ``shard_map`` of the ``lax.scan`` over K
stacked batches, in this process's virtual devices.

* **DP** (``tests/_torch_dp_worker.py``'s ``graph`` mode, 2 ranks):
  ``Trainer(graph=True)`` at ``steps_per_dispatch`` K = 2 with sync-BN,
  float32, dropout 0, pixel noise 0, from the JAX Trainer's initial
  weights, against the JAX Trainer at ``num_gpu=2``, K = 2, both
  ``fit(max_steps=4, eval_interval=2)`` on
  ``test_torch_port_ddp_parity.py``'s file and rate (1e-6): the logged
  losses, ``grad_norm`` and validation metrics at that file's tolerance
  (``rtol=1e-4, atol=1e-5``), the final BatchNorm statistics at the same,
  the parameters by its Adam rule (the elements whose reduced gradient
  stayed above 1e-4 at every step within ``1e-2 * lr`` plus 4 float32
  spacings), the two ranks' states and generators equal bit for bit.
* In the same ranks, dropout 0.1 and pixel noise 0.05: 2 calls of the
  2-step body on 4 stacked global batches against 4 eager data-parallel
  steps from the same start, plain and with ``remat_cnn`` (sync-BN's
  all-reduce runs again in the recompute): every metric and every tensor
  of the state (parameters, BatchNorm buffers, the graph-safe AdamW's
  moments and count, the generator) equal bit for bit on each rank, and
  the ranks' parameters equal.
* **DP x TP** (``tests/_torch_tp_worker.py``'s ``graph`` mode, 4 ranks at
  dp2 x mp2, 2 attention heads): the graph Trainer at K = 2 against the
  JAX hybrid Trainer at ``num_gpu=4, model_parallel=2``, K = 2: losses and
  ``grad_norm`` at ``rtol=1e-4, atol=1e-5``, the parameters by the Adam
  rule, the statistics within JAX's hybrid-against-dp bound 3e-4
  (``test_torch_port_tp.py``), the four whole states equal; the graph
  body against the eager TP step with dropout and noise, bit for bit, on
  each rank's pieces.
* **Resume**: in both groups a graph Trainer with dropout and noise,
  checkpointed at step 2 and resumed in a fresh graph Trainer, ends equal
  bit for bit to the uninterrupted one; the TP ranks' AdamW moments, the
  sharded ones too, are restored into the live pieces (their storage
  unchanged), which a captured graph reads.

The ranks start before the JAX Trainers fit and run beside them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.train import Trainer as JaxTrainer
from dune_transformercvn_tpu.train.logging import read_history as jax_read_history
from dune_transformercvn_torch.from_jax import state_dict_from_jax
from dune_transformercvn_torch.models import ModelConfig
from test_torch_port_loop import TINY, assert_same_state, small_synthetic_file, tiny_options
from test_torch_port_parallel import finish_ranks, start_ranks
from test_torch_port_tp import finish as finish_tp
from test_torch_port_tp import start as start_tp
from test_torch_port_train import assert_adam_params_close

TOL = dict(rtol=1e-4, atol=1e-5)
LEARNING_RATE = 1e-6
# JAX's bound between its hybrid and dp Trainers' BatchNorm statistics
TP_STAT_ATOL = 3e-4
K = 2
FIT = dict(max_steps=4, eval_interval=2)
STEPS = 4
GROUPS = {
    "dp": dict(num_gpu=2),
    "tp": dict(num_gpu=4, model_parallel=2, num_attention_heads=2),
}


def port_state_dict(theirs):
    cfg = ModelConfig(**{f.name: getattr(theirs.model_config, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    return state_dict_from_jax(jax.device_get(
        {"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}), cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' ranks started, then both JAX Trainers fit beside them."""
    started = {}
    for group, overrides in GROUPS.items():
        root = tmp_path_factory.mktemp(group)
        options = dict(training_file=small_synthetic_file(root / "train.h5", 64, 7),
                       learning_rate=LEARNING_RATE, steps_per_dispatch=K, **overrides)
        theirs = JaxTrainer(tiny_options(JaxOptions, **options), run_dir=str(root / "jax"),
                            log_every_n_steps=1, verbose=True)
        variables = jax.device_get({"params": theirs.state.params,
                                    "batch_stats": theirs.state.batch_stats})
        rng = np.random.default_rng(11)
        steps = [rng.choice(len(theirs.training_dataset), theirs.global_batch, replace=False)
                 for _ in range(STEPS)]
        torch.save(dict(options={**TINY, **options}, variables=variables, steps=steps,
                        log_dir=str(root / "torch"), fit=FIT, work=str(root)),
                   root / "setup.pt")
        ranks = (start_ranks("graph", root / "setup.pt", root) if group == "dp"
                 else start_tp("graph", root / "setup.pt", root, 4))
        started[group] = (theirs, ranks)
    out = {}
    for group, (theirs, ranks) in started.items():
        result = theirs.fit(**FIT)
        got = ([torch.load(p, weights_only=False) for p in finish_ranks(ranks)]
               if group == "dp" else finish_tp(ranks))
        out[group] = (theirs, result, got)
    return out


@pytest.mark.parametrize("tag", ["train_loss", "event_loss", "prong_loss", "grad_norm",
                                 "val_epoch_AUC", "val_epoch_accuracy", "val_loss"])
def test_dp_graph_trainer_logs_what_jax_logs(runs, tag):
    theirs, _, ranks = runs["dp"]
    got, want = ranks[0]["history"], jax_read_history(theirs.run_dir)
    # a 2-step dispatch logs its last step
    assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == [2, 4]
    np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                               **TOL, err_msg=tag)


def test_dp_graph_trainer_state_matches_jax_and_ranks_agree(runs):
    theirs, result, ranks = runs["dp"]
    want = port_state_dict(theirs)
    got, other, stable = ranks[0]["state"], ranks[1]["state"], ranks[0]["stable"]
    for rank in ranks:
        assert rank["step"] == rank["count"] == int(theirs.state.step) == 4
        assert rank["global_batch"] == theirs.global_batch
        for key in ("val_epoch_AUC", "val_loss"):
            np.testing.assert_allclose(rank["result"][key], result[key], **TOL, err_msg=key)
    assert ranks[1]["run_dir"] is None
    assert got.keys() == want.keys() == other.keys()
    for name, tensor in want.items():
        assert torch.equal(got[name], other[name]), name
        if name not in stable:                              # BatchNorm statistics
            np.testing.assert_allclose(got[name].numpy(), tensor.numpy(), **TOL, err_msg=name)
    assert assert_adam_params_close(got, want, stable, LEARNING_RATE, FIT["max_steps"],
                                    rounding=True) > 1000
    assert torch.equal(ranks[0]["generator"], ranks[1]["generator"])


def assert_graph_is_eager(noisy):
    graph, eager = noisy["graph"], noisy["eager"]
    assert graph["metrics"].keys() == eager["metrics"].keys()
    for key, value in eager["metrics"].items():
        assert value.shape == (STEPS,) and torch.equal(graph["metrics"][key], value), key
    assert graph["state"].keys() == eager["state"].keys()
    for key, value in eager["state"].items():
        assert torch.equal(graph["state"][key], value), key
    assert int(graph["state"]["count"]) == int(graph["state"]["step"]) == STEPS


@pytest.mark.parametrize("variant", ["plain", "remat_cnn"])
def test_dp_graph_body_is_the_eager_dp_step(runs, variant):
    _, _, ranks = runs["dp"]
    for rank in ranks:
        assert_graph_is_eager(rank["noisy"][variant])
    params = [{k: v for k, v in r["noisy"][variant]["graph"]["state"].items()
               if k.startswith("model.")} for r in ranks]
    for key, value in params[0].items():
        assert torch.equal(params[1][key], value), key


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_graph_trainer_in_a_group_resumes_bit_for_bit(runs, group):
    _, _, ranks = runs[group]
    for rank in ranks:
        resumed = rank["resumed"]
        assert resumed["whole"]["step"] == 4
        assert_same_state(resumed["resumed"], resumed["whole"])
        if group == "tp":    # the moments a captured graph reads, restored in place
            assert rank["moments_in_place"]


def test_tp_graph_trainer_matches_jax_hybrid(runs):
    theirs, _, ranks = runs["tp"]
    assert ranks[0]["mesh"] == (2, 2) and all(r["step"] == 4 for r in ranks)
    got, want = ranks[0]["history"], jax_read_history(theirs.run_dir)
    for tag in ("train_loss", "event_loss", "prong_loss", "grad_norm"):
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == [2, 4]
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                                   **TOL, err_msg=tag)
    want_sd = port_state_dict(theirs)
    states = [r["state"]["model"] for r in ranks]
    stable = ranks[0]["stable"]
    for name, tensor in want_sd.items():
        for other in states[1:]:
            assert torch.equal(other[name], states[0][name]), name
        if name not in stable:
            np.testing.assert_allclose(states[0][name].numpy(), tensor.numpy(), rtol=0,
                                       atol=TP_STAT_ATOL, err_msg=name)
    assert assert_adam_params_close(states[0], want_sd, stable, LEARNING_RATE,
                                    FIT["max_steps"], rounding=True) > 1000


def test_tp_graph_body_is_the_eager_tp_step(runs):
    _, _, ranks = runs["tp"]
    for rank in ranks:
        assert_graph_is_eager(rank["noisy"])
