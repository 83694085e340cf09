"""The port's Trainer, checkpoints, run dirs, logging, evaluation and CLIs.

Copies of framework-free JAX-package modules (``utils/rundir``,
``train/logging.read_history``, ``evaluation``) give the JAX package's
results on the same inputs; the parameter count equals the JAX package's.
``CheckpointManager`` keeps the JAX package's index and ranking; a restore
is bit-equal, and 3 steps + checkpoint + resume + 3 steps equal 6 steps
bit for bit with dropout and pixel noise on.  The ``train`` and
``evaluate`` CLIs run end to end on the CPU.  Everything is tiny
(48x40 images, DenseNet [1, 1]) and on the CPU (``device="cpu"``).

The compiled ``Trainer`` (``compile=True``) at this file's tiny width
with DenseNet [1] and one prong-decoder layer (``SMALL``): with dropout
and pixel noise on, a compiled run checkpointed at step 2 and resumed in a
fresh compiled ``Trainer`` ends equal, bit for bit, to the uninterrupted
compiled run (compiled dropout draws Inductor's Philox offsets from the
generator the step seeds from the state); ``train --compile`` and
``evaluate --compile`` reach the ``Trainer``.  Inductor compiles its C++
with one worker (``compile_threads = 1``).  The compiled data- and
tensor-parallel steps: ``tests/test_torch_port_ddp_parity.py`` and
``tests/test_torch_port_tp.py``.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu import evaluation as jax_evaluation
from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.data import Batcher as JaxBatcher
from dune_transformercvn_tpu.data import EventDataset as JaxEventDataset
from dune_transformercvn_tpu.models.network import ModelConfig as JaxModelConfig
from dune_transformercvn_tpu.models.network import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from dune_transformercvn_tpu.train.logging import read_history as jax_read_history
from dune_transformercvn_tpu.train.state import param_count as jax_param_count
from dune_transformercvn_tpu.utils import rundir as jax_rundir
from dune_transformercvn_torch import Options, evaluation
from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.data.schema import make_synthetic_file
from dune_transformercvn_torch.evaluate import main as evaluate_main
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from dune_transformercvn_torch.predict import predict_split
from dune_transformercvn_torch.train import CheckpointManager, Trainer
from dune_transformercvn_torch.train.__main__ import main as train_main
from dune_transformercvn_torch.train.__main__ import parser as train_parser
from dune_transformercvn_torch.train.checkpoint import restore_from_path
from dune_transformercvn_torch.train.logging import MetricLogger, read_history
from dune_transformercvn_torch.train.loop import resolve_device
from dune_transformercvn_torch.utils import rundir
from dune_transformercvn_torch.utils.summary import param_count, summarize_params

torch.set_num_threads(2)
torch._inductor.config.compile_threads = 1

# the compiled tests' network: DenseNet [1], one prong-decoder layer
SMALL = dict(densenet_structure=[1], num_prong_decoder_layers=1)

REPO = Path(__file__).resolve().parents[1]
H, W = 48, 40
TINY = dict(
    densenet_structure=[1, 1], densenet_growth_rate=8, initial_pixel_dim=8,
    pixel_embedding_dim=16, feature_embedding_dim=8, position_embedding_dim=8,
    hidden_dim=32, num_encoder_layers=1, num_prong_decoder_layers=2,
    num_attention_heads=4, dropout=0.0, pixel_noise_std=0.0,
    compute_dtype="float32", event_current_targets=True, loss_gamma=1.0,
    learning_rate=1e-3, gradient_clip=10.0, epochs=4, batch_size=4,
    train_validation_split=0.8, coo_bucket_granularity=1024,
    num_dataloader_workers=2, verbose_output=False,
)


def tiny_options(cls=Options, **overrides):
    options = cls()
    options.update_options({**TINY, **overrides})
    return options


def small_synthetic_file(path, num_events, seed, shape=(H, W)):
    """``make_synthetic_file`` with the hit coordinates scaled to ``shape``
    (48x40 by default)."""
    make_synthetic_file(str(path), num_events=num_events, seed=seed)
    with h5py.File(path, "r+") as f:
        for key in ("event_pixels_coordinates", "prong_pixels_coordinates"):
            coords = f[key][:]
            coords[:, 1] = coords[:, 1] * shape[0] // 400
            coords[:, 2] = coords[:, 2] * shape[1] // 280
            f[key][...] = coords
        f["full_pixels_shape"][...] = np.array([3, *shape])
    return str(path)


def memory_trainer(run_dir, seed=0, **overrides):
    """A CPU Trainer on 16 training events (4 steps an epoch) and 8
    validation events made in memory."""
    datasets = (InMemoryEvents(16, 1, (H, W)), InMemoryEvents(8, 2, (H, W)), None)
    return Trainer(tiny_options(seed=seed, **overrides), run_dir=str(run_dir),
                   device="cpu", datasets=datasets, log_every_n_steps=1)


def assert_same_state(got, want):
    """Two ``TrainState.state_dict()``s equal bit for bit."""
    assert got["step"] == want["step"]
    assert got["model"].keys() == want["model"].keys()
    for name, tensor in want["model"].items():
        assert torch.equal(got["model"][name], tensor), name
    g_opt, w_opt = got["optimizer"], want["optimizer"]
    assert g_opt["param_groups"] == w_opt["param_groups"]
    assert g_opt["state"].keys() == w_opt["state"].keys() and w_opt["state"]
    for index, slots in w_opt["state"].items():
        assert slots.keys() == g_opt["state"][index].keys()
        for key, tensor in slots.items():
            assert torch.equal(g_opt["state"][index][key].cpu(), tensor.cpu()), (index, key)
    for key, tensor in want["norm"].items():
        assert torch.equal(got["norm"][key], tensor), key
    assert torch.equal(got["generator"], want["generator"])


# ---------------------------------------------------------------------------
# copies of the JAX package's framework-free modules
# ---------------------------------------------------------------------------

def test_rundir_matches_jax(tmp_path):
    """Versions, creation and the auto-resume scan on the same layout."""
    results = []
    for module, root in ((rundir, tmp_path / "torch"), (jax_rundir, tmp_path / "jax")):
        made = [module.create_run_dir(str(root), "run") for _ in range(3)]
        os.makedirs(os.path.join(made[1], "checkpoints"))
        Path(made[1], "checkpoints", "index.json").write_text("{}")
        os.makedirs(root / "run" / "version_x")
        results.append((
            [os.path.relpath(p, root) for p in made],
            module.find_versions(str(root), "run"),
            os.path.relpath(module.find_resumable(str(root), "run"), root),
            module.find_resumable(str(root), "absent"),
        ))
    assert results[0] == results[1]
    assert results[0][2] == os.path.join("run", "version_1")


@pytest.mark.parametrize("source", ["tensorboard", "jsonl"])
def test_read_history_matches_jax(tmp_path, source):
    """The port's logger written, both readers reading: TensorBoard event
    files, and ``metrics.jsonl`` alone (a host without TensorBoard)."""
    logger = MetricLogger(str(tmp_path))
    for step in (1, 2, 4):
        logger.log_scalars({"train_loss": 1.0 / step, "lr-AdamW/pg1": 1e-3 * step,
                            "skipped": np.ones(3)}, step)
    logger.log_scalars({"val_epoch_AUC": 0.75}, 4)
    logger.close()
    if source == "jsonl":
        for name in os.listdir(tmp_path):
            if name.startswith("events.out"):
                os.remove(tmp_path / name)
    got, want = read_history(str(tmp_path)), jax_read_history(str(tmp_path))
    assert got == want
    assert set(got) == {"train_loss", "lr-AdamW/pg1", "val_epoch_AUC"}
    assert [s for s, _ in got["train_loss"]] == [1, 2, 4]


def evaluation_inputs():
    rng = np.random.default_rng(3)
    event_probs = rng.dirichlet(np.ones(4), 40).astype(np.float32)
    event_targets = rng.integers(0, 4, 40)
    prong_probs = rng.dirichlet(np.ones(8), 90).astype(np.float32)
    prong_targets = rng.integers(0, 7, 90)          # class 7 absent: NaN AUC
    scores = np.round(rng.uniform(size=50), 1)      # ties
    labels = rng.integers(0, 2, 50)
    return event_probs, event_targets, prong_probs, prong_targets, scores, labels


EVALUATION_CALLS = {
    "binary_auc": lambda m, i: m.binary_auc(i[4], i[5]),
    "multiclass_auc": lambda m, i: m.multiclass_auc(i[2], i[3]),
    "multiclass_auc_macro": lambda m, i: m.multiclass_auc(i[0], i[1], average="macro"),
    "precision_recall": lambda m, i: m.precision_recall(i[2].argmax(1), i[3], 8),
    "confusion_matrix": lambda m, i: m.confusion_matrix(i[0].argmax(1), i[1], 4),
    "roc_curve": lambda m, i: m.roc_curve(i[4], i[5]),
    "evaluate_predictions": lambda m, i: m.evaluate_predictions(*i[:4]),
    "render_report": lambda m, i: m.render_report(
        m.evaluate_predictions(*i[:4]), ["a", "b", "c", "d"], [f"p{k}" for k in range(8)]),
}


@pytest.mark.parametrize("name", sorted(EVALUATION_CALLS))
def test_evaluation_matches_jax(name):
    inputs = evaluation_inputs()
    got = EVALUATION_CALLS[name](evaluation, inputs)
    want = EVALUATION_CALLS[name](jax_evaluation, inputs)
    np.testing.assert_equal(got, want)


def test_predictions_h5_matches_jax(tmp_path):
    inputs = evaluation_inputs()[:4]
    index = np.arange(90) // 3
    evaluation.save_predictions_h5(str(tmp_path / "t.h5"), *inputs, index)
    jax_evaluation.save_predictions_h5(str(tmp_path / "j.h5"), *inputs, index)
    with h5py.File(tmp_path / "t.h5") as got, h5py.File(tmp_path / "j.h5") as want:
        assert set(got) == set(want) == {"event_probabilities", "event_targets",
                                         "prong_probabilities", "prong_targets",
                                         "prong_event_index"}
        for key in want:
            np.testing.assert_array_equal(got[key][:], want[key][:])


@pytest.mark.parametrize("family", ["dense", "coo", "sdxl", "sparse", "convnext", "fcnn",
                                    "mobilenet", "resnet"])
def test_param_count_matches_jax(synthetic_file, family):
    """Parameters only on both sides: BatchNorm statistics are buffers in the
    port and ``batch_stats`` in JAX."""
    dims = dict(features_dim=6, extra_dim=4, pixel_channels=3, num_event_classes=4,
                num_prong_classes=8, embedder=family,
                image_shape=(400, 280) if family == "sdxl" else (H, W))
    jax_cfg = JaxModelConfig.from_options(tiny_options(JaxOptions), **dims)
    ds = JaxEventDataset(synthetic_file, event_current_targets=True)
    ds.compute_statistics()
    batch = JaxBatcher(ds, batch_size=4, coo_granularity=1024).build_batch(np.arange(4))
    norm = {"mean": ds.mean, "std": ds.std,
            "extra_mean": ds.extra_mean, "extra_std": ds.extra_std}
    shapes = jax.eval_shape(
        lambda b, n: JaxTransformerCVN(jax_cfg).init(jax.random.PRNGKey(0), b, n, train=False),
        batch, norm)
    model = TransformerCVN(ModelConfig.from_options(tiny_options(), **dims))
    assert param_count(model) == jax_param_count(shapes["params"]) > 10_000
    assert summarize_params(model).endswith(f"{param_count(model):>12,}")


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

class TinyState:
    """The one method ``CheckpointManager.save`` calls."""

    def __init__(self, value):
        self.value = value

    def state_dict(self):
        return {"w": torch.full((2,), float(self.value))}


def index_entries(directory):
    with open(os.path.join(directory, "index.json")) as f:
        index = json.load(f)
    return index["last"], [(c["step"], c["metric"], os.path.basename(c["path"]))
                           for c in index["checkpoints"]]


@pytest.mark.parametrize("metrics,top_k,best", [
    ([0.5, 0.9, 0.7, 0.1], 2, 20),                  # top-2 by metric, and the last
    ([None, float("nan"), 0.3, None], 1, 30),       # None and NaN rank below 0.3
    ([float("nan"), None, float("nan")], 1, 30),    # nothing ranked: best = latest
])
def test_checkpoint_ranking_matches_jax(tmp_path, metrics, top_k, best):
    ours = CheckpointManager(str(tmp_path / "torch"), top_k=top_k)
    theirs = JaxCheckpointManager(str(tmp_path / "jax"), top_k=top_k)
    for i, metric in enumerate(metrics, 1):
        ours.save(TinyState(i), 10 * i, metric)
        theirs.save({"w": np.full(2, i, np.float32)}, 10 * i, metric)
    assert ours.best_step() == theirs.best_step() == best
    assert ours.latest_step() == theirs.latest_step() == 10 * len(metrics)
    theirs.close()
    got, want = index_entries(ours.directory), index_entries(theirs.directory)
    np.testing.assert_equal(got, want)
    kept = sorted(e for e in os.listdir(ours.directory) if e.startswith("step_"))
    assert kept == sorted(e for e in os.listdir(theirs.directory) if e.startswith("step_"))
    assert f"step_{10 * len(metrics)}" in kept and len(kept) <= top_k + 1


def test_checkpoint_index_survives_a_reload(tmp_path):
    first = CheckpointManager(str(tmp_path), top_k=1)
    for step, metric in ((1, 0.2), (2, 0.8), (3, None)):
        first.save(TinyState(step), step, metric)
    again = CheckpointManager(str(tmp_path), top_k=1)
    assert (again.best_step(), again.latest_step()) == (2, 3)
    assert index_entries(str(tmp_path)) == (3, [(2, 0.8, "step_2"), (3, None, "step_3")])
    again.save(TinyState(4), 4, 0.9)        # ranks above step 2, which goes
    assert (again.best_step(), again.latest_step()) == (4, 4)
    assert sorted(os.listdir(tmp_path)) == ["index.json", "step_4"]
    restored = torch.load(os.path.join(tmp_path, "step_4", "state.pt"), weights_only=True)
    assert torch.equal(restored["w"], torch.full((2,), 4.0))


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """A state with AdamW moments, saved by one Trainer, restored into
    another built from another seed."""
    trainer = memory_trainer(tmp_path / "a", dropout=0.1)
    trainer.fit(max_steps=2, eval_interval=100)     # validates, checkpoints step_2
    saved = trainer.state.state_dict()
    other = memory_trainer(tmp_path / "b", seed=5, dropout=0.1)
    assert not torch.equal(other.state.generator.get_state(), saved["generator"])
    other.resume(str(tmp_path / "a" / "checkpoints" / "step_2"))
    assert_same_state(other.state.state_dict(), saved)
    # and through the manager, by step
    fresh = memory_trainer(tmp_path / "c", seed=7, dropout=0.1)
    fresh.checkpoints.save(trainer.state, 2, 0.5)
    third = memory_trainer(tmp_path / "d", seed=9, dropout=0.1)
    CheckpointManager(fresh.checkpoints.directory).restore(third.state, 2)
    assert_same_state(third.state.state_dict(), saved)
    assert restore_from_path(str(tmp_path / "a" / "checkpoints" / "step_2"),
                             third.state) is third.state


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def test_read_history_orders_event_files_by_time(tmp_path):
    """A resumed run's two event files whose names sort the other way
    round (the writer numbers them unpadded: ``...10`` before ``...9``):
    the history is in the order the steps were logged."""
    for steps in ((1, 2, 3), (4, 5, 6)):
        logger = MetricLogger(str(tmp_path))
        for step in steps:
            logger.log_scalars({"train_loss": float(step)}, step)
        logger.close()
    first = min(tmp_path.glob("events.out.tfevents.*"), key=os.path.getmtime)
    first.rename(tmp_path / "events.out.tfevents.9999999999.host.1.9")
    os.remove(tmp_path / "metrics.jsonl")
    assert read_history(str(tmp_path))["train_loss"] == [(s, float(s)) for s in range(1, 7)]


def test_resume_is_bit_exact(tmp_path):
    """6 steps in one fit against 3 steps, a checkpoint, a fresh Trainer's
    ``resume(step_3)`` mid-epoch and 3 more steps, with dropout and pixel
    noise drawing from the state's generator."""
    noisy = dict(dropout=0.2, pixel_noise_std=0.05)
    whole = memory_trainer(tmp_path / "whole", **noisy)
    assert whole.steps_per_epoch == 4
    whole.fit(max_steps=6, eval_interval=100)
    first = memory_trainer(tmp_path / "split", **noisy)
    first.fit(max_steps=3, eval_interval=100)
    second = memory_trainer(tmp_path / "split", **noisy)
    second.resume(str(tmp_path / "split" / "checkpoints" / "step_3"))
    assert second.state.step == 3 and second.state.step % second.steps_per_epoch
    second.fit(max_steps=6, eval_interval=100)
    assert_same_state(second.state.state_dict(), whole.state.state_dict())
    got, want = read_history(str(tmp_path / "split")), read_history(str(tmp_path / "whole"))
    assert [s for s, _ in got["train_loss"]] == [1, 2, 3, 4, 5, 6]
    assert got["train_loss"] == want["train_loss"]
    assert got["val_loss"][-1] == want["val_loss"][-1]
    assert index_entries(str(tmp_path / "split" / "checkpoints"))[0] == 6


def test_trainer_logs_validates_and_checkpoints(tmp_path):
    """Validation and checkpoints every ``eval_interval`` steps and a final
    one; metrics of log steps only; the learning rate and events/s tags."""
    calls = []
    trainer = memory_trainer(tmp_path, dropout=0.1)
    trainer.log_every_n_steps = 3
    trainer.callbacks.append(lambda step, metrics: calls.append((step, metrics["val_loss"])))
    result = trainer.fit(max_steps=7, eval_interval=3)
    assert [s for s, _ in calls] == [3, 6, 7] and calls[-1][1] == result["val_loss"]
    history = read_history(str(tmp_path))
    assert [s for s, _ in history["train_loss"]] == [1, 2, 3, 6]
    for step, lr in history["lr-AdamW/pg1"]:
        assert math.isclose(lr, 1e-3 * trainer.schedule(step), rel_tol=1e-6)
    assert all(rate > 0 for _, rate in history["events_per_second"])
    assert [s for s, _ in history["val_epoch_AUC"]] == [3, 6, 7]
    assert "grad_norm" not in history                 # verbose only
    assert index_entries(str(tmp_path / "checkpoints"))[0] == 7
    assert json.loads((tmp_path / "options.json").read_text())["embedder"] == "dense"
    predictions = trainer.predict_split("validation")
    assert predictions["event_probabilities"].shape == (8, 4)
    np.testing.assert_allclose(predictions["event_probabilities"].sum(1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="no testing dataset"):
        trainer.predict_split("testing")


def test_profile_writes_a_trace_of_steps_11_to_15(tmp_path):
    trainer = memory_trainer(tmp_path)
    trainer.fit(max_steps=16, eval_interval=100, profile=True)
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train_step.forward", "train_step.backward", "train_step.optimizer"} <= names
    assert not torch.autograd.profiler._is_profiler_enabled


@pytest.mark.parametrize("rank", [0, 1])
def test_only_rank_0_profiles(tmp_path, monkeypatch, rank):
    """Without a run dir (as on the ranks other than 0 of a process group)
    the trace goes to ``<cwd>/profile``; a rank other than 0 writes none,
    or the ranks of one host would all write that one file."""
    monkeypatch.chdir(tmp_path)
    datasets = (InMemoryEvents(16, 1, (H, W)), InMemoryEvents(8, 2, (H, W)), None)
    trainer = Trainer(tiny_options(), debug=True, device="cpu", datasets=datasets)
    trainer.is_master = rank == 0
    trainer.fit(max_steps=16, eval_interval=100, profile=True)
    assert os.listdir(tmp_path) == (["profile"] if rank == 0 else [])


def test_an_exception_closes_the_profiler_and_the_checkpoint(tmp_path):
    """``fit``'s ``finally``: an open profiler session stops; the checkpoint
    saved before the callback raised is written and indexed."""
    def fail(step, metrics):
        raise KeyboardInterrupt

    trainer = memory_trainer(tmp_path)
    trainer.callbacks.append(fail)
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(max_steps=16, eval_interval=12, profile=True)
    assert trainer.state.step == 12
    assert not torch.autograd.profiler._is_profiler_enabled
    assert index_entries(str(tmp_path / "checkpoints"))[0] == 12
    assert (tmp_path / "checkpoints" / "step_12" / "state.pt").exists()


def test_steps_per_dispatch_runs_one_step_per_call(tmp_path):
    """K > 1 implies static batch shapes, as in the JAX package, and steps
    one at a time; metrics are logged where the JAX package's dispatches
    end: after the group of 3, then after the epoch's last step, which runs
    alone."""
    trainer = memory_trainer(tmp_path, steps_per_dispatch=3)
    assert trainer.train_batcher.fixed_caps is not None
    calls = []
    trainer.train_step = lambda state, batch, step=trainer.train_step: (
        calls.append(state.step), step(state, batch))[1]
    trainer.fit(max_steps=4, eval_interval=100)
    assert trainer.state.step == 4 and calls == [0, 1, 2, 3]
    assert [s for s, _ in read_history(str(tmp_path))["train_loss"]] == [3, 4]


def test_no_quiet_fallback_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available.*device='cpu'"):
        Trainer(tiny_options(), debug=True, device=None,
                datasets=(InMemoryEvents(8, 1, (H, W)), InMemoryEvents(4, 2, (H, W)), None))
    assert resolve_device("cpu") == torch.device("cpu")


def test_fold_eval_bn_is_not_ported():
    """The name dates from when the option raised.  ``predict_split`` with
    ``fold_eval_bn`` now predicts with a folded copy (ops/fold.py): the
    probabilities stay those of the raw model, and the caller's module is
    left as it was."""
    cfg = ModelConfig(**{k: v for k, v in TINY.items() if k in ModelConfig.__dataclass_fields__},
                      image_height=H, image_width=W, max_prongs=20)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():  # statistics a fold can see
        for name, buffer in model.named_buffers():
            buffer.copy_(torch.rand(buffer.shape) + 0.5)
    raw = {k: v.clone() for k, v in model.state_dict().items()}
    ds = InMemoryEvents(6, 0, (H, W))
    plain = predict_split(model, ds, ds.norm(), 4, "cpu")
    folded = predict_split(model, ds, ds.norm(), 4, "cpu", fold_eval_bn=True)
    for key in ("event_probabilities", "prong_probabilities"):
        np.testing.assert_allclose(folded[key], plain[key], atol=1e-5)
    for name, tensor in model.state_dict().items():
        assert torch.equal(tensor, raw[name]), name


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def run_cli(module, *args, cwd, expect=0):
    # the CLI reduces over as many threads as this process (the evaluate CLI
    # has no --threads and would take the host's core count): the same
    # summation order keeps its predictions bit-equal to this process's
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": str(torch.get_num_threads())}
    proc = subprocess.run([sys.executable, "-m", f"dune_transformercvn_torch.{module}", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == expect, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``python -m dune_transformercvn_torch.train`` for 4 steps on the CPU."""
    root = tmp_path_factory.mktemp("cli")
    data = small_synthetic_file(root / "train.h5", 64, 5)
    (root / "options.json").write_text(json.dumps({**TINY, "training_file": data}))
    out = run_cli("train", "-o", "options.json", "-n", "run", "-l", "logs", "--device", "cpu",
                  "--max_steps", "4", "-e", "2", "--threads", "2", cwd=root)
    return root, root / "logs" / "run" / "version_0", out


def test_train_cli_writes_the_run_dir(cli_run):
    _, run_dir, out = cli_run
    assert "Run directory: logs/run/version_0" in out
    for name in ("options.json", "metrics.jsonl", "checkpoints/index.json",
                 "checkpoints/step_2/state.pt", "checkpoints/step_4/state.pt"):
        assert (run_dir / name).exists(), name
    assert index_entries(str(run_dir / "checkpoints"))[0] == 4
    steps = [json.loads(line)["step"] for line in (run_dir / "metrics.jsonl").open()]
    assert max(steps) == 4


def test_evaluate_cli_matches_predict_split(cli_run):
    root, run_dir, _ = cli_run
    out = run_cli("evaluate", str(run_dir), "--device", "cpu", cwd=root)
    assert "Event classification" in out and "Predictions written to" in out
    options = Options.load(str(run_dir / "options.json"))
    trainer = Trainer(options, run_dir=None, debug=True, verbose=False, device="cpu")
    manager = CheckpointManager(str(run_dir / "checkpoints"))
    step = manager.best_step()
    assert f"Restoring best checkpoint: step {step}" in out
    manager.restore(trainer.state, step)
    want = trainer.predict_split("validation")
    with h5py.File(run_dir / "eval_predictions.h5") as f:
        assert set(f) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(f[key][:], value, err_msg=key)


def test_auto_resume_continues_the_version(cli_run):
    root, run_dir, _ = cli_run
    out = run_cli("train", "-o", "options.json", "-n", "run", "-l", "logs", "--device", "cpu",
                  "--max_steps", "6", "-e", "2", "--auto_resume", cwd=root)
    assert "Auto-resuming in logs/run/version_0" in out
    assert sorted(os.listdir(root / "logs" / "run")) == ["version_0"]
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    assert [r["step"] for r in rows if "val_epoch_AUC" in r] == [2, 4, 6]
    assert index_entries(str(run_dir / "checkpoints"))[0] == 6


def test_checkpoint_flag_resumes_into_a_new_run(cli_run, monkeypatch):
    """``-c <checkpoint>`` (in process): a new run dir that starts at the
    checkpoint's step."""
    root, run_dir, _ = cli_run
    monkeypatch.chdir(root)
    train_main(**vars(train_parser().parse_args([
        "-o", "options.json", "-n", "resumed", "-l", "logs", "--device", "cpu",
        "--max_steps", "3", "-c", str(run_dir / "checkpoints" / "step_2")])))
    rows = [json.loads(line)
            for line in (root / "logs" / "resumed" / "version_0" / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [3] and "val_epoch_AUC" in rows[0]
    assert index_entries(str(root / "logs" / "resumed" / "version_0" / "checkpoints"))[0] == 3


@pytest.mark.parametrize("flag", ["-g", "--log_compiles"])
def test_xla_only_flags_exit(tmp_path, flag):
    out = run_cli("train", flag, "--device", "cpu", cwd=tmp_path, expect=1)
    assert "no counterpart" in out


def compiled_trainer(run_dir, **overrides):
    datasets = (InMemoryEvents(16, 1, (H, W)), InMemoryEvents(8, 2, (H, W)), None)
    return Trainer(tiny_options(**SMALL, **overrides), run_dir=str(run_dir), device="cpu",
                   datasets=datasets, log_every_n_steps=1, compile=True)


def test_compiled_trainer_resumes_bit_for_bit(tmp_path):
    noisy = dict(dropout=0.1, pixel_noise_std=0.05)
    whole = compiled_trainer(tmp_path / "whole", **noisy)
    whole.fit(max_steps=4, eval_interval=2)
    resumed = compiled_trainer(tmp_path / "resumed", **noisy)
    resumed.resume(str(tmp_path / "whole" / "checkpoints" / "step_2"))
    assert resumed.state.step == 2
    resumed.fit(max_steps=4, eval_interval=2)
    assert_same_state(resumed.state.state_dict(), whole.state.state_dict())


def test_the_clis_take_compile(monkeypatch):
    """``--compile`` reaches the Trainer (the runs are the tests above)."""
    assert train_parser().parse_args(["--compile"]).compile
    assert not train_parser().parse_args([]).compile
    seen = {}

    def evaluate_run(*args, **kwargs):
        seen.update(kwargs)
        raise SystemExit(0)

    monkeypatch.setattr("dune_transformercvn_torch.evaluate.evaluate_run", evaluate_run)
    for argv, want in ((["run", "--compile"], True), (["run"], False)):
        try:
            evaluate_main(argv)
        except SystemExit:
            pass
        assert seen.pop("compile") is want
