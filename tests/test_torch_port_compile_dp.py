"""The compiled data-parallel step on the CPU: two ``gloo`` ranks
(``tests/_torch_dp_worker.py``, mode ``compiled``) each fit an eager and a
compiled ``Trainer`` (``compile=True``) at the tiny width of
``tests/test_torch_port_compile_loop.py``, with sync-BN traced into the
compiled graph as a functional all-reduce (its backward sums the cotangent
over the group, as the eager ``autograd.Function`` does).  Each rank's
compiled steps against its eager steps (dropout 0, noise 0): metrics,
running statistics and the validation loss within
``tests/test_torch_port_compile.py``'s ``TOL`` plus twice the eager fit's
own spread under a reordering of each shard's 4 events (the worker fits
the other 23 orders; ``assert_within_spread`` there says why; the
validation's AUCs and accuracies bin and count scores, and need only be
defined where eager's are), gradients by its ``grads_close`` rule,
parameters by ``test_torch_port_train``'s Adam rule; the ranks' compiled
states equal bit for bit.  Measured on an AVX-512 host: the validation
loss 8.8e-5 from eager against the reorderings' spread of 3.3e-4 (within
``TOL`` alone too).

Inductor compiles its C++ with one worker in each rank
(``compile_threads = 1``).
"""

import numpy as np
import torch

from test_torch_port_compile import assert_within_spread, grads_close, network_largest
from test_torch_port_compile_loop import SMALL
from test_torch_port_loop import TINY, H, W
from test_torch_port_parallel import finish_ranks, start_ranks
from test_torch_port_train import assert_adam_params_close


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
