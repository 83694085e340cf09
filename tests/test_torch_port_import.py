"""The port's importer of reference Lightning checkpoints (``torch_import.py``)
against the JAX package's (``dune_transformercvn_tpu/torch_import.py``).

The reference network is not on this host, so the checkpoint is the port's
own tiny dense model (smart features on, so the feature-embedding stack is
mapped too; BatchNorm statistics away from their starts) saved in the
reference's on-disk shape: the network under ``network.``, the four frozen
normalization tensors (here not the training split's, so their origin
shows) and ``global_step``.  The port's names are the reference's, which is
what lets the JAX package's importer read the same file.

* the port's importer writes a run dir whose restored model gives logits
  bit-equal to the source model's, with the checkpoint's statistics and
  step;
* the JAX package's importer on the same file gives logits within 1e-5;
* a checkpoint of another architecture (2 encoder layers against the option
  file's 1) or activation (ReLU against PReLU) raises, naming the tensors;
* ``python -m dune_transformercvn_torch.torch_import`` then ``evaluate
  --device cpu`` run end to end;
* the importer takes no device and needs no card: it runs with CUDA absent,
  and the run dir it writes is restored where the caller says (without
  CUDA, a Trainer given no device raises).
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.models import ModelConfig as JaxModelConfig
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.torch_import import (
    import_reference_checkpoint as jax_import_reference_checkpoint)
from dune_transformercvn_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from dune_transformercvn_tpu.train.loop import Trainer as JaxTrainer
from dune_transformercvn_torch.data import Batcher
from dune_transformercvn_torch.predict import to_device
from dune_transformercvn_torch.torch_import import (extract_norm, import_reference_checkpoint,
                                                    strip_network_prefix)
from dune_transformercvn_torch.train import CheckpointManager, Trainer
from test_torch_port_loop import TINY, run_cli, small_synthetic_file, tiny_options

torch.set_num_threads(2)

GLOBAL_STEP = 7
SMART = dict(disable_smart_features=False)


def save_lightning_ckpt(model, norm, path):
    """The on-disk shape of a reference ModelCheckpoint ``.ckpt``."""
    sd = {f"network.{k}": v for k, v in model.state_dict().items()}
    sd.update({k: torch.as_tensor(np.asarray(v)) for k, v in norm.items()})
    torch.save({"state_dict": sd, "global_step": GLOBAL_STEP, "epoch": 1}, path)


def source_model(options, seed):
    """A port model of ``options`` with random BatchNorm statistics, and
    normalization statistics that are not the training split's."""
    trainer = Trainer(options, run_dir=None, debug=True, verbose=False, device="cpu")
    model = trainer.state.model.eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buffer in model.named_buffers():
            if name.endswith("running_var"):
                buffer.copy_(torch.from_numpy(rng.uniform(0.6, 1.5, buffer.shape)))
            elif name.endswith("running_mean"):
                buffer.copy_(torch.from_numpy(0.2 * rng.normal(size=buffer.shape)))
    norm = {k: (np.asarray(v) + np.float32(0.25)).astype(np.float32)
            for k, v in trainer.norm.items()}
    return model, norm, trainer


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = tmp_path_factory.mktemp("import")
    data = small_synthetic_file(root / "import.h5", 32, 3)
    options = tiny_options(training_file=data, **SMART)
    model, norm, trainer = source_model(options, 5)
    ckpt = str(root / "ref.ckpt")
    save_lightning_ckpt(model, norm, ckpt)
    batch = Batcher(trainer.validation_dataset, batch_size=4,
                    coo_granularity=512).build_batch(np.arange(4))
    with torch.no_grad():
        logits = model(to_device(batch, "cpu"), to_device(norm, "cpu"))
    return root, data, ckpt, norm, batch, logits


def restored_logits(run_dir, batch):
    options = tiny_options(training_file=json.load(open(run_dir / "options.json"))
                           ["training_file"], **SMART)
    trainer = Trainer(options, run_dir=None, debug=True, verbose=False, device="cpu")
    manager = CheckpointManager(str(run_dir / "checkpoints"))
    assert manager.latest_step() == GLOBAL_STEP
    manager.restore(trainer.state)
    assert trainer.state.step == GLOBAL_STEP
    with torch.no_grad():
        return trainer.state.model.eval()(to_device(batch, "cpu"), trainer.state.norm), trainer


def test_helpers():
    sd = {"network.a": torch.ones(1), "mean": torch.zeros(2), "std": torch.ones(2),
          "extra_mean": torch.tensor(0.0), "extra_std": torch.tensor(1.0)}
    assert set(strip_network_prefix(sd)) == {"a", "mean", "std", "extra_mean", "extra_std"}
    assert strip_network_prefix({"a": 1}) == {"a": 1}
    assert set(extract_norm(sd)) == {"mean", "std", "extra_mean", "extra_std"}
    assert extract_norm({"mean": torch.zeros(2)}) is None


def test_import_is_bit_exact(source):
    root, data, ckpt, norm, batch, logits = source
    out = root / "ours" / "version_0"
    import_reference_checkpoint(ckpt, tiny_options(training_file=data, **SMART), str(out),
                                verbose=False)
    got, trainer = restored_logits(out, batch)
    for g, w in zip(got, logits):
        assert torch.equal(g, w)
    for key, value in norm.items():
        np.testing.assert_array_equal(trainer.state.norm[key].numpy(), value)


def test_jax_importer_agrees(source):
    root, data, ckpt, norm, batch, logits = source
    out = str(root / "jax" / "version_0")
    options = tiny_options(JaxOptions, training_file=data, **SMART)
    jax_import_reference_checkpoint(ckpt, options, out, verbose=False)
    trainer = JaxTrainer(options, run_dir=None, debug=True, verbose=False)
    manager = JaxCheckpointManager(os.path.join(out, "checkpoints"),
                                   top_k=options.checkpoint_top_k)
    state = manager.restore(jax.device_get(trainer.state))
    assert int(state.step) == GLOBAL_STEP
    model = JaxTransformerCVN(trainer.model_config)
    assert isinstance(trainer.model_config, JaxModelConfig)
    ev, pr = jax.jit(lambda v, b, n: model.apply(v, b, n, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats},
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in state.norm.items()})
    np.testing.assert_allclose(np.asarray(ev), logits[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(pr), logits[1].numpy(), atol=1e-5)


@pytest.mark.parametrize("trained_with, match", [
    (dict(num_encoder_layers=2), "no place in the model.*encoder.encoder.layers.1"),
    (dict(linear_prelu_activation=False), "lacks.*activation.weight"),
])
def test_mismatch_raises(source, trained_with, match):
    root, data, _, _, _, _ = source
    model, norm, _ = source_model(tiny_options(training_file=data, **SMART, **trained_with), 6)
    ckpt = str(root / f"other_{len(match)}.ckpt")
    save_lightning_ckpt(model, norm, ckpt)
    with pytest.raises(KeyError, match=match):
        import_reference_checkpoint(ckpt, tiny_options(training_file=data, **SMART),
                                    str(root / "rejected"), verbose=False)


def test_cli_end_to_end(source):
    root, data, ckpt, _, _, _ = source
    (root / "opts.json").write_text(json.dumps({**TINY, **SMART, "training_file": data}))
    out = run_cli("torch_import", ckpt, "-o", "opts.json", "--out", "d", cwd=root)
    assert f"global_step {GLOBAL_STEP}" in out
    out = run_cli("evaluate", "d", "--device", "cpu", cwd=root)
    assert f"Restoring best checkpoint: step {GLOBAL_STEP}" in out
    assert "Event classification" in out and (root / "d" / "eval_predictions.h5").exists()


def test_import_needs_no_device(source, monkeypatch):
    root, data, ckpt, _, batch, logits = source
    assert "device" not in inspect.signature(import_reference_checkpoint).parameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = root / "no_card"
    import_reference_checkpoint(ckpt, tiny_options(training_file=data, **SMART), str(out),
                                verbose=False)
    got, _ = restored_logits(out, batch)
    for g, w in zip(got, logits):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_options(training_file=data, **SMART), run_dir=None, debug=True,
                verbose=False, device=None)
