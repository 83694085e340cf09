"""The embedder families beyond dense and coo through the port's entry
points on the CPU: the ``Trainer`` (2 steps, a validation, a checkpoint,
``predict_split``) for each of sdxl, sparse, convnext, fcnn, mobilenet and
resnet; ``evaluate_run`` of the sdxl run, which rebuilds the family and its
chunk options from the run's ``options.json``; and the ``train`` CLI with
``--sdxl`` and ``embedder_chunk`` set in the option file.  Tiny widths
(``test_torch_port_loop.TINY``), events made in memory, 48x40 images, 256x256
for sdxl.
"""

import json

import numpy as np
import pytest
import torch

from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.evaluate import evaluate_run
from dune_transformercvn_torch.train import Trainer
from dune_transformercvn_torch.train.logging import read_history
from _torch_families import FAMILIES, MOBILENET_STRUCTURE, image_shape  # same-dir helpers
from test_torch_port_loop import TINY, run_cli, small_synthetic_file, tiny_options

torch.set_num_threads(2)

SDXL = dict(initial_pixel_dim=4, embedder_chunk=4, embedder_chunk_save_spatial=64)


def family_options(family):
    extra = SDXL if family == "sdxl" else {}
    return tiny_options(mobilenet_structure=[list(r) for r in MOBILENET_STRUCTURE],
                        eval_interval=2, **extra)


def datasets(family):
    shape = image_shape(family)
    return InMemoryEvents(16, 1, shape), InMemoryEvents(8, 2, shape), None


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_fits_each_family(family, tmp_path):
    trainer = Trainer(family_options(family), embedder=family, run_dir=str(tmp_path),
                      device="cpu", datasets=datasets(family), log_every_n_steps=1,
                      verbose=False)
    cfg = trainer.model_config
    assert cfg.embedder == family and cfg.image_height == image_shape(family)[0]
    assert cfg.embedder_chunk == (4 if family == "sdxl" else 0)
    result = trainer.fit(max_steps=2)
    losses = [v for _, v in read_history(str(tmp_path))["train_loss"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    for key in ("val_loss", "event_epoch_AUC", "prong_epoch_AUC"):
        assert np.isfinite(result[key]), key
    assert (tmp_path / "checkpoints" / "step_2" / "state.pt").exists()
    predictions = trainer.predict_split("validation")
    assert predictions["event_probabilities"].shape == (8, 4)
    np.testing.assert_allclose(predictions["event_probabilities"].sum(-1), 1.0, rtol=1e-5)
    if family == "sdxl":
        saved = Options.load(str(tmp_path / "options.json"))
        assert (saved.embedder, saved.embedder_chunk) == ("sdxl", 4)
        again, results, _ = evaluate_run(str(tmp_path), "last", device="cpu",
                                         datasets=datasets(family))
        assert np.isfinite(results["event_auc"])
        np.testing.assert_allclose(again["event_probabilities"],
                                   predictions["event_probabilities"], rtol=1e-5, atol=1e-6)


def test_train_cli_runs_sdxl_with_embedder_chunk(tmp_path):
    """``--sdxl`` with ``embedder_chunk`` and ``embedder_chunk_save_spatial``
    in the option file: 2 steps on the CPU, the options recorded."""
    data = small_synthetic_file(tmp_path / "train.h5", 20, 3, image_shape("sdxl"))
    (tmp_path / "options.json").write_text(json.dumps(
        {**TINY, **SDXL, "embedder_chunk": 2, "training_file": str(data)}))
    out = run_cli("train", "-o", "options.json", "-n", "run", "-l", "logs", "--device", "cpu",
                  "--sdxl", "--max_steps", "2", "-e", "2", "--threads", "2", cwd=tmp_path)
    run_dir = tmp_path / "logs" / "run" / "version_0"
    assert "Run directory: logs/run/version_0" in out
    saved = json.loads((run_dir / "options.json").read_text())
    assert (saved["embedder"], saved["embedder_chunk"],
            saved["embedder_chunk_save_spatial"]) == ("sdxl", 2, 64)
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    assert max(r["step"] for r in rows) == 2
    assert all(np.isfinite(r["train_loss"]) for r in rows if "train_loss" in r)
