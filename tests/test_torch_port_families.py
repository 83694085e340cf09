"""The port's whole TransformerCVN of every embedder family beyond dense and
coo against the JAX package's: sdxl, sparse, convnext, fcnn, mobilenet and
resnet.

Tiny networks (``_torch_families.family_configs``), float32, dropout 0,
pixel noise 0, weights from seeded numpy carried into the port by
``from_jax.load_jax_variables``, batches of the ``synthetic_file`` fixture.
Per family: the eval-mode logits; the train-mode logits and the BatchNorm
running statistics after one forward; ``ModelConfig.from_options`` with the
family's name.  (Each family's train step against JAX's is in its own file:
``test_torch_port_sdxl.py``, ``_sparse.py``, ``_variants.py``.)  Logits and
statistics are compared at ``rtol=atol=1e-4`` and ``1e-5``,
as the dense family's are: some thirty layers summed in another order by
XLA and by torch/oneDNN.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.models import ModelConfig as JaxModelConfig
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.from_jax import load_jax_variables, state_dict_from_jax
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from dune_transformercvn_torch.predict import to_device
from _torch_families import FAMILIES, batches_and_norm, family_configs  # same-dir helpers
from test_torch_port_network import random_variables

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_network_matches_jax(family, synthetic_file):
    """Eval-mode logits, then train-mode logits and running statistics."""
    (batch,), norm = batches_and_norm(synthetic_file, family)
    cfg, port_cfg = family_configs(family)
    jax_model = JaxTransformerCVN(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    variables = random_variables(jax_model, 21, jb, jn, train=False)
    want_eval = jax.jit(jax_model.apply)(variables, jb, jn)
    want_train, updated = jax.jit(partial(
        jax_model.apply, train=True, mutable=["batch_stats"]))(variables, jb, jn)

    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    b, n = to_device(batch, "cpu"), to_device(norm, "cpu")
    with torch.no_grad():
        got_eval = model.eval()(b, n)
        got_train = model.train()(b, n)
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want_sd = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": jax.device_get(updated["batch_stats"])},
        port_cfg)
    got_sd = model.state_dict()
    names = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    # the BatchNorm families' embedders hold statistics; sdxl's GroupNorm none
    assert any("pixel_embedding" in k for k in names) is (family != "sdxl")
    assert len(names) >= 10
    for name in names:
        np.testing.assert_allclose(got_sd[name].numpy(), want_sd[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_model_config_from_options_matches_jax(family):
    """The option file's fields land in both packages' configs alike, the
    MobileNet ladder and (for sdxl) the chunk options included, and the
    port builds the family's network."""
    options = Options()
    options.update_options(dict(mobilenet_structure=[[1, 8, 1, 1], [6, 16, 2, 2]]))
    jax_options = JaxOptions()
    jax_options.update_options(dict(mobilenet_structure=[[1, 8, 1, 1], [6, 16, 2, 2]]))
    if family == "sdxl":
        for o in (options, jax_options):
            o.update_options(dict(embedder_chunk=16, embedder_chunk_save_spatial=64))
    args = (6, 4, 3, 4, 8)
    port_cfg = ModelConfig.from_options(options, *args, embedder=family)
    jax_cfg = JaxModelConfig.from_options(jax_options, *args, embedder=family)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(port_cfg, f.name) == getattr(jax_cfg, f.name), f.name
    assert port_cfg.mobilenet_structure == ((1, 8, 1, 1), (6, 16, 2, 2))
    assert port_cfg.embedder_chunk == (16 if family == "sdxl" else 0)
    small = dataclasses.replace(port_cfg, densenet_structure=(1, 1), initial_pixel_dim=4,
                                pixel_embedding_dim=16, num_encoder_layers=1)
    model = TransformerCVN(small)
    assert type(model.prong_embedding.event_pixel_embedding).__name__ == {
        "sdxl": "SDXLEncoder", "sparse": "SparseDenseNet", "convnext": "SparseConvNeXt",
        "fcnn": "SparseFCNN", "mobilenet": "MobileNetV2", "resnet": "ResNetStack"}[family]
