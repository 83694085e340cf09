"""The port's whole TransformerCVN and serving loop against the JAX package.

A tiny dense-family network (32x32 images, DenseNet [2, 2], growth 8, two
encoder layers) runs on batches from the JAX package's ``Batcher`` over the
``synthetic_file`` fixture, with hit coordinates scaled down to 32x32 (which
also makes many duplicate pixels).  Weights are drawn from seeded numpy and
carried into the port by ``from_jax.load_jax_variables``.  Float32, dropout
0, pixel noise 0.  Tolerance ``rtol=atol=1e-4``: some thirty layers summed
in another order by XLA and by torch/oneDNN, with train-mode BatchNorm
re-normalising over a handful of rows.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options
from dune_transformercvn_tpu.data import Batcher, EventDataset
from dune_transformercvn_tpu.models import ModelConfig as JaxModelConfig
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.ops.scatter import densify_images as jax_densify
from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.from_jax import load_jax_variables, state_dict_from_jax
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from dune_transformercvn_torch.ops.scatter import densify_images
from dune_transformercvn_torch.predict import predict_split, to_device
from dune_transformercvn_torch.profile_serving import OPTION_FILE, production_config

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 32

VARIANTS = {
    # smart features on, the dedicated prong position vector, a learned
    # classifier token and split-target generation classes
    "smart": dict(disable_smart_features=False, fix_prong_position_embedding=True,
                  learned_classifier_token=True, num_generation_classes=4),
    # the production toggles: no smart features, the position quirk, plus
    # the space-to-depth stem and pool-first transitions
    "production": dict(disable_smart_features=True, stem_space_to_depth=True,
                       transition_pool_first=True),
}


def tiny_config(**overrides):
    cfg = JaxModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=8,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=2, num_prong_decoder_layers=2, num_attention_heads=4,
        densenet_structure=(2, 2), densenet_growth_rate=8,
        dropout=0.0, pixel_noise_std=0.0, image_height=SIZE, image_width=SIZE,
        compute_dtype="float32", **overrides)
    port = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return cfg, port


def random_variables(jax_module, seed, *args, **kwargs):
    """Variables drawn from seeded numpy in the shapes ``jax.eval_shape``
    gives (no compile); BN statistics and slopes away from their starts."""
    shapes = jax.eval_shape(partial(jax_module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            qkv = path[-2].key in ("query", "key", "value")
            fan_in = shape[0] if qkv else int(np.prod(shape[:-1]))
            value = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name == "var":
            value = rng.uniform(0.5, 2.0, shape)
        elif name in ("scale", "alpha"):
            value = rng.uniform(0.2, 1.2, shape)
        else:
            value = 0.3 * rng.normal(size=shape)
        return value.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return {c: jax.tree_util.tree_map(np.asarray, dict(t)) for c, t in tree.items()}


class Shrunk:
    """A dataset whose hit coordinates are scaled to ``SIZE`` x ``SIZE``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def gather_events(self, indices):
        raw = self.dataset.gather_events(indices)
        for key in ("event_coords", "prong_coords"):
            coords = raw[key].copy()
            coords[:, 1] = coords[:, 1] * SIZE // 400
            coords[:, 2] = coords[:, 2] * SIZE // 280
            raw[key] = coords
        return raw


@pytest.fixture(scope="module")
def data(synthetic_file):
    ds = EventDataset(synthetic_file, limit_index=(0.0, 0.22), event_current_targets=True)
    ds.compute_statistics()
    norm = {"mean": ds.mean, "std": ds.std,
            "extra_mean": ds.extra_mean, "extra_std": ds.extra_std}
    shrunk = Shrunk(ds)
    batch = Batcher(shrunk, batch_size=4, coo_granularity=512).build_batch(np.arange(4))
    return shrunk, batch, norm


def jax_outputs(module, batch, norm):
    """``TransformerCVN.__call__`` in eval mode, returning the hidden states
    of ``forward_from_images`` too."""
    cfg = module.cfg
    B, P = batch["features"].shape[0], batch["slot_batch"].shape[0]
    images = [
        jax_densify(batch[f"{k}_xy"], module.preprocess_values(batch[f"{k}_vals"], False),
                    batch[f"{k}_owner"], n, SIZE, SIZE, starts=batch[f"{k}_starts"],
                    space_to_depth=cfg.stem_space_to_depth)
        for k, n in (("event", B), ("prong", P))
    ]
    return module.forward_from_images(
        *images, batch["features"], batch["extra"], batch["prong_mask"],
        batch["slot_batch"], batch["slot_pos"], batch["slot_mask"], norm, False)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def setup(request, data):
    _, batch, norm = data
    cfg, port_cfg = tiny_config(**VARIANTS[request.param])
    jax_model = JaxTransformerCVN(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    variables = random_variables(jax_model, 21, jb, jn, train=False)
    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    return jax_model, variables, model, jb, jn, batch, norm


def test_network_eval_matches_jax(setup):
    """Logits through ``forward`` and hidden states through
    ``forward_from_images``, eval-mode BatchNorm."""
    jax_model, variables, model, jb, jn, batch, norm = setup
    want = jax.jit(partial(jax_model.apply, method=jax_outputs))(variables, jb, jn)
    b, n = to_device(batch, "cpu"), to_device(norm, "cpu")
    model.eval()
    with torch.no_grad():
        event_logits, prong_logits = model(b, n)
        cfg = model.cfg
        images = [
            densify_images(b[f"{k}_xy"], model.preprocess_values(b[f"{k}_vals"]),
                           b[f"{k}_owner"], num, SIZE, SIZE,
                           space_to_depth=cfg.stem_space_to_depth)
            for k, num in (("event", 4), ("prong", b["slot_batch"].shape[0]))
        ]
        got = model.forward_from_images(
            *images, b["features"], b["extra"], b["prong_mask"],
            b["slot_batch"], b["slot_pos"], b["slot_mask"], n)
    kev = cfg.num_event_classes + cfg.num_generation_classes
    assert tuple(event_logits.shape) == (4, kev)
    assert tuple(prong_logits.shape) == (4, cfg.max_prongs, cfg.num_prong_classes)
    np.testing.assert_allclose(event_logits.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(prong_logits.numpy(), np.asarray(want[1]), **TOL)
    for ours, theirs in zip(got, want):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_network_train_mode_matches_jax(setup):
    """Train-mode BatchNorm: logits from batch statistics, and the running
    statistics after one forward."""
    jax_model, variables, model, jb, jn, batch, norm = setup
    (event_logits, prong_logits), updated = jax.jit(partial(
        jax_model.apply, train=True, mutable=["batch_stats"]))(variables, jb, jn)
    model.load_state_dict(state_dict_from_jax(variables, model.cfg))
    model.train()
    with torch.no_grad():
        got_event, got_prong = model(to_device(batch, "cpu"), to_device(norm, "cpu"))
    model.eval()
    np.testing.assert_allclose(got_event.numpy(), np.asarray(event_logits), **TOL)
    np.testing.assert_allclose(got_prong.numpy(), np.asarray(prong_logits), **TOL)
    want = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": jax.device_get(updated["batch_stats"])},
        model.cfg)
    got = model.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) > 20
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    model.load_state_dict(state_dict_from_jax(variables, model.cfg))


@pytest.mark.parametrize("mode", ["divide", "log", "one_hot"])
def test_preprocess_values_matches_jax(mode):
    cfg, port_cfg = tiny_config(log_pixels=mode == "log", one_hot_pixels=mode == "one_hot")
    values = np.random.default_rng(4).uniform(0.0, 255.0, (7, 3)).astype(np.float32)
    values[0, 1] = 300.0                                    # outside the 256 levels
    want = jax.jit(partial(JaxTransformerCVN(cfg).apply, train=False,
                           method=JaxTransformerCVN.preprocess_values))({}, jnp.asarray(values))
    model = TransformerCVN(port_cfg).eval()
    got = model.preprocess_values(torch.from_numpy(values))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_predict_split_matches_jax(data):
    """The serving loop: every batch of the batcher (fixed shape, the
    wrap-padded tail trimmed) through the port and through JAX's
    predict-step arithmetic give the same probabilities and bookkeeping."""
    shrunk, _, norm = data
    cfg, port_cfg = tiny_config()
    jax_model = JaxTransformerCVN(cfg)
    kw = dict(batch_size=8, coo_granularity=512, fixed_shape=True)
    batches = list(Batcher(shrunk, drop_last=False, **kw).epoch(0))
    assert len(shrunk) % 8 and len(batches) == 3          # a wrap-padded tail
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = random_variables(jax_model, 5, first, jn, train=False)
    model = load_jax_variables(TransformerCVN(port_cfg), variables)

    @jax.jit
    def predict(v, batch):
        ev, pr = jax_model.apply(v, batch, jn, train=False)
        return jax.nn.softmax(ev[:, :cfg.num_event_classes], -1), jax.nn.softmax(pr, -1)

    ev_probs, pr_probs = [], []
    seen = 0
    for batch in batches:
        pe, pp = jax.device_get(predict(variables, {k: jnp.asarray(v) for k, v in batch.items()}))
        take = min(8, len(shrunk) - seen)
        ev_probs.append(pe[:take])
        pr_probs.append(pp[:take][batch["prong_targets"][:take] >= 0])
        seen += take

    out = predict_split(model, shrunk, norm, device="cpu", **kw)
    n = len(shrunk)
    prongs = int((shrunk.prong_targets >= 0).sum())
    assert out["event_probabilities"].shape == (n, 4)
    assert out["prong_probabilities"].shape == (prongs, 8)
    np.testing.assert_allclose(out["event_probabilities"], np.concatenate(ev_probs), **TOL)
    np.testing.assert_allclose(out["prong_probabilities"], np.concatenate(pr_probs), **TOL)
    np.testing.assert_array_equal(out["event_targets"], shrunk.event_targets)
    mask = shrunk.prong_targets >= 0
    np.testing.assert_array_equal(out["prong_targets"], shrunk.prong_targets[mask])
    np.testing.assert_array_equal(out["prong_event_index"], np.nonzero(mask)[0])
    assert not model.training


def test_model_config_from_options_matches_jax():
    options = Options.load(os.path.join(
        os.path.dirname(__file__), "..", "option_files",
        "fdhd_beam_2018prod_2023_08_07.json"))
    args = (6, 4, 3, 4, 8)
    jax_cfg = JaxModelConfig.from_options(options, *args)
    port_cfg = ModelConfig.from_options(options, *args)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(port_cfg, f.name) == getattr(jax_cfg, f.name), f.name
    assert port_cfg.dtype == torch.bfloat16
    assert port_cfg.densenet_structure == (3, 6, 12, 6, 3)
    assert port_cfg.disable_smart_features


def test_only_the_dense_family_is_ported():
    """Families beyond dense and coo are not ported yet."""
    _, port_cfg = tiny_config()
    with pytest.raises(NotImplementedError, match="sdxl"):
        TransformerCVN(dataclasses.replace(port_cfg, embedder="sdxl"))


def test_in_memory_events_batch_like_the_hdf5_dataset(data):
    """``InMemoryEvents`` (the GPU smoke's events, made without HDF5) gives
    the batcher what the HDF5 ``EventDataset`` does: the same batch keys,
    dtypes and trailing shapes, hits inside the image, and a serving pass
    with one probability row per event and per real prong."""
    _, want, norm = data
    ds = InMemoryEvents(12, 3, image_shape=(SIZE, SIZE))
    batch = Batcher(ds, batch_size=4, coo_granularity=512).build_batch(np.arange(4))
    assert sorted(batch) == sorted(want)
    for k in want:
        assert batch[k].dtype == want[k].dtype, k
        assert batch[k].shape[1:] == want[k].shape[1:], k
    for k in ("event", "prong"):
        real = batch[f"{k}_owner"] < batch[f"{k}_starts"].shape[0] - 1
        xy = batch[f"{k}_xy"][real]
        assert real.any() and xy.min() >= 0 and xy.max() < SIZE
    assert set(ds.norm()) == set(norm)

    _, port_cfg = tiny_config()
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(2))
    out = predict_split(model, ds, ds.norm(), batch_size=8, device="cpu",
                        coo_granularity=512)
    prongs = int(ds.prong_mask.sum())
    assert out["event_probabilities"].shape == (12, 4)
    assert out["prong_probabilities"].shape == (prongs, 8)
    for key in ("event_probabilities", "prong_probabilities"):
        assert np.isfinite(out[key]).all()
        np.testing.assert_allclose(out[key].sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(out["event_targets"], ds.event_targets)


def test_profile_serving_config_is_the_production_option_file():
    cfg = production_config("bfloat16")
    want = JaxModelConfig.from_options(Options.load(OPTION_FILE), 6, 4, 3, 4, 8)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name
    assert (cfg.image_height, cfg.image_width) == (400, 280)
