"""Sustained training (``dune_transformercvn_torch.sustained_train``, the
port of ``tools/sustained_train.py``) and the synthetic file's twin made in
memory, against the JAX package on the CPU.

* The twin: ``schema.make_synthetic_arrays`` equals the file
  ``make_synthetic_file`` writes, dataset for dataset, and the port's
  ``EventDataset`` over those arrays gives the splits that it and the JAX
  package's ``EventDataset`` read from the file (arrays, statistics and
  gathered batches), at two seeds.
* ``sustained_train`` (``build``, then ``fit``) over 20 steps with a
  validation every 10, on the production option file cut to tiny widths
  (``SUSTAINED``: float32, dropout 0, pixel noise 0, 48x40 images, batch
  4, static batch shapes, so that JAX compiles its steps once), against
  the JAX ``Trainer`` fit on the same file with the same options from the
  same initial weights (the JAX Trainer's, loaded before the fit): the
  logged losses and ``grad_norm`` of every step and the validation
  metrics at ``rtol=1e-3, atol=1e-5``.  The largest relative gap of a
  step's losses and ``grad_norm``, measured on an AVX-512 CPU, steps
  1-20: 4.3e-6, 2.4e-6, 3.9e-6, 2.4e-6, 4.3e-6, 4.0e-6, 6.1e-6, 2.4e-6,
  1.1e-5, 2.8e-5, 9.1e-6, 6.7e-6, 1.9e-6, 9.1e-6, 2.5e-6, 5.2e-6, 1.0e-6,
  3.6e-6, 3.4e-6, 2.0e-6; of the validation metrics at steps 10 and 20:
  3.4e-4 and 3.3e-4 (the AUCs; ``val_loss`` 5.9e-6 or less, the
  accuracies equal).  The AUCs count scores in 64-bin histograms, and a
  score within rounding of a bin edge may fall on the other side in the
  other framework: so the validation split holds 128 events (640 in the
  file), where one such crossing moves an AUC by ~1e-4 (at 13 events, by
  up to 8e-3).
* ``graph=True`` at K = 2 (the graph-safe step bodies, uncaptured on the
  CPU) against the eager steps at K = 2 with the same graph-safe AdamW,
  with the option file's dropout and pixel noise: every logged loss,
  ``grad_norm`` and validation metric and the final state equal bit for
  bit.
* The record has the keys of the JAX tool's record
  (``artifacts/sustained_train_v5e.json``), is written under its dispatch
  and never into the JAX tool's file.
"""

import json
import os
import types

import h5py
import jax
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.data.dataset import EventDataset as JaxEventDataset
from dune_transformercvn_tpu.data.schema import make_synthetic_file as jax_make_synthetic_file
from dune_transformercvn_tpu.train import Trainer as JaxTrainer
from dune_transformercvn_torch import Options, sustained_train
from dune_transformercvn_torch.data import EventDataset
from dune_transformercvn_torch.data.dataset import create_datasets
from dune_transformercvn_torch.data.schema import make_synthetic_arrays
from dune_transformercvn_torch.from_jax import load_jax_variables
from dune_transformercvn_torch.train.optimizer import create_optimizer
from test_torch_port_loop import H, W, small_synthetic_file

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-5)
# the production option file's network cut to tiny widths; its optimizer,
# rate, schedule, clip and loss as they stand; one device (the JAX package
# here sees 8 CPU devices and would take the option file's 4)
SUSTAINED = dict(
    densenet_structure=[1, 1], densenet_growth_rate=8, initial_pixel_dim=8,
    pixel_embedding_dim=16, feature_embedding_dim=8, position_embedding_dim=8,
    hidden_dim=32, num_encoder_layers=1, num_prong_decoder_layers=2,
    num_attention_heads=4, dropout=0.0, pixel_noise_std=0.0, compute_dtype="float32",
    train_validation_split=0.8, coo_bucket_granularity=1024, num_dataloader_workers=2,
    num_gpu=1, static_batch_shapes=True,
)
STEPS, EVAL, BATCH, EVENTS, SEED = 20, 10, 4, 640, 7
STEP_TAGS = ("train_loss", "event_loss", "prong_loss", "grad_norm")
VAL_TAGS = ("val_loss", "val_epoch_AUC", "val_epoch_accuracy", "event_epoch_AUC",
            "prong_epoch_AUC")


def options(cls=Options, **overrides):
    opts = cls.load(sustained_train.OPTION_FILE)
    opts.update_options({**SUSTAINED, **overrides})
    return opts


def scaled_arrays(num_events, seed, shape=(H, W)):
    """``make_synthetic_arrays`` with the hit coordinates scaled as
    ``small_synthetic_file`` scales the file's."""
    arrays = make_synthetic_arrays(num_events, seed=seed)
    for key in ("event_pixels_coordinates", "prong_pixels_coordinates"):
        coords = arrays[key].copy()
        coords[:, 1] = coords[:, 1] * shape[0] // 400
        coords[:, 2] = coords[:, 2] * shape[1] // 280
        arrays[key] = coords
    arrays["full_pixels_shape"] = np.array([3, *shape])
    return arrays


def history(run_dir):
    """``{tag: {step: value}}`` from a run's ``metrics.jsonl``."""
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            for tag, value in row.items():
                out.setdefault(tag, {})[row["step"]] = value
    return out


# ---------------------------------------------------------------------------
# the twin
# ---------------------------------------------------------------------------

DATASET_ARRAYS = ("features", "extra", "prong_mask", "event_targets", "prong_targets",
                  "event_compressed_index", "prong_compressed_index",
                  "event_pixels_coordinates", "event_pixels_values",
                  "prong_pixels_coordinates", "prong_pixels_values")


@pytest.mark.parametrize("seed", [3, 11])
def test_the_twin_equals_the_synthetic_file(tmp_path, seed):
    path = jax_make_synthetic_file(str(tmp_path / "train.h5"), num_events=40, seed=seed)
    arrays = make_synthetic_arrays(40, seed=seed)
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(arrays)
        for key in f:
            assert arrays[key].dtype == f[key].dtype, key
            np.testing.assert_array_equal(arrays[key], f[key][()], err_msg=key)
    indices = np.array([0, 3, 5, 1])
    for limit in ((0.0, 0.8), (0.8, 1.0)):
        for load in (False, True):
            kwargs = dict(limit_index=limit, event_current_targets=True,
                          load_full_dataset=load)
            twin = EventDataset(arrays, **kwargs)
            for other in (EventDataset(path, **kwargs), JaxEventDataset(path, **kwargs)):
                assert (twin.num_events, twin.num_features, twin.num_extra,
                        twin.num_event_classes, twin.num_prong_classes, twin.pixel_shape,
                        twin.pixel_features) == (
                    other.num_events, other.num_features, other.num_extra,
                    other.num_event_classes, other.num_prong_classes, other.pixel_shape,
                    other.pixel_features)
                for name in DATASET_ARRAYS:
                    np.testing.assert_array_equal(np.asarray(getattr(twin, name)),
                                                  np.asarray(getattr(other, name)),
                                                  err_msg=name)
                for got, want in zip(twin.compute_statistics(), other.compute_statistics()):
                    np.testing.assert_array_equal(got, want)
                got, want = twin.gather_events(indices), other.gather_events(indices)
                assert sorted(got) == sorted(want)
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_create_datasets_splits_the_twin_as_the_file(tmp_path):
    path = jax_make_synthetic_file(str(tmp_path / "train.h5"), num_events=40, seed=11)
    opts = options(training_file=path)
    twins = create_datasets(opts, make_synthetic_arrays(40, seed=11))
    for twin, split in zip(twins, create_datasets(opts)):
        if split is None:
            assert twin is None
            continue
        assert (twin.min_limit, twin.max_limit) == (split.min_limit, split.max_limit)
        np.testing.assert_array_equal(twin.event_targets, split.event_targets)


# ---------------------------------------------------------------------------
# the sustained run against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sustained")
    path = small_synthetic_file(root / "train.h5", EVENTS, SEED)
    arrays = scaled_arrays(EVENTS, SEED)
    with h5py.File(path, "r") as f:
        for key in f:
            np.testing.assert_array_equal(arrays[key], f[key][()], err_msg=key)
    theirs_opts = options(JaxOptions, training_file=path, batch_size=BATCH, epochs=1000,
                          eval_interval=EVAL, verbose_output=True)
    theirs = JaxTrainer(theirs_opts, name="sustained", log_dir=str(root / "jax"),
                        log_every_n_steps=1)
    start = jax.device_get({"params": theirs.state.params,
                            "batch_stats": theirs.state.batch_stats})
    ours = sustained_train.build(arrays, EVAL, BATCH, device="cpu", options=options(),
                                 workdir=str(root / "torch"), log_every_n_steps=1)
    load_jax_variables(ours.state.model, start)
    record = sustained_train.fit(ours, STEPS, EVENTS, out=str(root / "record.json"))
    theirs.fit(max_steps=STEPS)
    return record, root, theirs


def test_sustained_run_matches_the_jax_trainer(runs):
    record, root, theirs = runs
    got = history(os.path.join(root, "torch", "sustained", "version_0"))
    want = history(theirs.run_dir)
    assert record["steps"] == STEPS and int(theirs.state.step) == STEPS
    for tag in STEP_TAGS:
        assert sorted(got[tag]) == sorted(want[tag]) == list(range(1, STEPS + 1)), tag
        np.testing.assert_allclose([got[tag][s] for s in range(1, STEPS + 1)],
                                   [want[tag][s] for s in range(1, STEPS + 1)], **TOL,
                                   err_msg=tag)
    for tag in VAL_TAGS:
        assert sorted(got[tag]) == sorted(want[tag]) == [EVAL, STEPS], tag
        np.testing.assert_allclose([got[tag][s] for s in (EVAL, STEPS)],
                                   [want[tag][s] for s in (EVAL, STEPS)], **TOL, err_msg=tag)
    assert [c["step"] for c in record["val_auc_curve"]] == [EVAL, STEPS]
    np.testing.assert_allclose([c["val_epoch_AUC"] for c in record["val_auc_curve"]],
                               [want["val_epoch_AUC"][s] for s in (EVAL, STEPS)], **TOL)


def test_the_record_has_the_jax_tools_keys(runs):
    record, root, _ = runs
    with open(sustained_train.JAX_RECORD) as f:
        jax_record = json.load(f)
    assert set(jax_record) <= set(record), set(jax_record) - set(record)
    for key, value in jax_record.items():
        assert isinstance(record[key], type(value)) or (
            isinstance(value, (int, float)) and isinstance(record[key], (int, float))), key
    with open(root / "record.json") as f:
        assert json.load(f) == {"eager": json.loads(json.dumps(record))}
    steps = [w["step"] for w in record["window_events_per_second"]]
    assert steps and steps == sorted(steps) and record["events"] == EVENTS
    assert record["steady_state_events_per_second"] > 0
    assert record["final_val_epoch_AUC"] == record["val_auc_curve"][-1]["val_epoch_AUC"]
    assert [c["step"] for c in record["train_loss_curve"]] == list(range(1, STEPS + 1))
    with pytest.raises(ValueError, match="JAX tool's record"):
        sustained_train.run(steps=1, out=sustained_train.JAX_RECORD)


def test_steady_state_is_the_jax_tools_rule():
    windows = [{"step": s, "events_per_second": r} for s, r in
               [(1, 1.0), (2, 50.0), (50, 100.0), (80, 90.0), (100, 10.0), (150, 110.0),
                (160, 120.0), (200, 130.0), (240, 95.0)]]
    # the windows ending at 100 and 200 hold the validations at 80 and 160;
    # the other seven's second half, sorted [90, 95, 110, 120], at index 2
    assert sustained_train.steady_state(windows, {80, 160, 240}) == 110.0


# ---------------------------------------------------------------------------
# graph=True against eager
# ---------------------------------------------------------------------------

def test_graph_k2_equals_eager_bit_for_bit(tmp_path):
    arrays = scaled_arrays(EVENTS, SEED)
    kept, records = {}, {}
    for name, graph in (("eager", False), ("graph", True)):
        trainer = kept[name] = sustained_train.build(
            arrays, EVAL, BATCH, graph, 2, "cpu", options(dropout=0.1, pixel_noise_std=0.001),
            str(tmp_path / name), log_every_n_steps=1)
        if not graph:       # the graph step's AdamW, stepped eagerly
            trainer.state.optimizer = create_optimizer(trainer.options, trainer.state.model,
                                                       graph=True)
        records[name] = sustained_train.fit(trainer, STEPS, EVENTS, out=None)
    assert records["graph"]["dispatch"] == "cuda_graph_k2"
    got = history(os.path.join(tmp_path, "graph", "sustained", "version_0"))
    want = history(os.path.join(tmp_path, "eager", "sustained", "version_0"))
    for tag in STEP_TAGS + VAL_TAGS:
        assert got[tag] == want[tag] and got[tag], tag
    assert sorted(got["train_loss"]) == list(range(2, STEPS + 1, 2))
    for name, tensor in kept["eager"].state.model.state_dict().items():
        assert torch.equal(kept["graph"].state.model.state_dict()[name], tensor), name
    # uncaptured on the CPU: the K-step train graph and the eval graph, none
    # captured, so no warm-up launches
    assert kept["graph"].graph_captures() == [(0, 2), (0, 1)]
    assert kept["eager"].graph_captures() == []
    assert records["graph"]["k1_warmup_launches"] == 0


def test_warmup_launches_are_one_body_a_captured_graph():
    """Two launches of K1 a step: a train graph's warm-up runs K steps, an
    eval graph's one batch."""
    trainer = types.SimpleNamespace(graph_captures=lambda: [(1, 4), (3, 1), (1, 1)])
    assert sustained_train.warmup_launches(trainer) == 2 * 4 + 2 * 3 + 2
