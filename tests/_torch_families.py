"""Helpers of the port's tests of the embedder families beyond dense and coo.

Tiny configurations of each family (two encoder layers, narrow widths;
DenseNet [2, 2] growth 8 for the sparse family, a two-row MobileNet ladder),
float32, dropout 0, pixel noise 0, and batches of the ``synthetic_file``
fixture with hit coordinates scaled to the family's images: 48x40, or
256x256 for sdxl, whose eight downsamples need at least 256 pixels a side.
"""

import dataclasses

import numpy as np

from dune_transformercvn_tpu.data import Batcher, EventDataset
from dune_transformercvn_tpu.models import ModelConfig as JaxModelConfig
from dune_transformercvn_torch.models import ModelConfig

FAMILIES = ("sdxl", "sparse", "convnext", "fcnn", "mobilenet", "resnet")
MOBILENET_STRUCTURE = ((1, 8, 1, 1), (6, 16, 2, 2))


def image_shape(family):
    return (256, 256) if family == "sdxl" else (48, 40)


def family_configs(family, **overrides):
    """``(JAX ModelConfig, port ModelConfig)`` of a tiny ``family`` network."""
    height, width = image_shape(family)
    fields = dict(
        hidden_dim=32, initial_feature_dim=8,
        initial_pixel_dim=4 if family == "sdxl" else 8,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=2, num_prong_decoder_layers=2, num_attention_heads=4,
        densenet_structure=(2, 2), densenet_growth_rate=8,
        mobilenet_structure=MOBILENET_STRUCTURE, dropout=0.0, pixel_noise_std=0.0,
        image_height=height, image_width=width, compute_dtype="float32",
        embedder=family)
    cfg = JaxModelConfig(**{**fields, **overrides})
    port = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return cfg, port


class Resized:
    """A dataset whose hit coordinates are scaled from 400x280 to ``shape``."""

    def __init__(self, dataset, shape):
        self.dataset = dataset
        self.shape = shape

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def gather_events(self, indices):
        raw = self.dataset.gather_events(indices)
        for key in ("event_coords", "prong_coords"):
            coords = raw[key].copy()
            coords[:, 1] = coords[:, 1] * self.shape[0] // 400
            coords[:, 2] = coords[:, 2] * self.shape[1] // 280
            raw[key] = coords
        return raw


def batches_and_norm(synthetic_file, family, count=1):
    """``count`` fixed-shape batches of 4 events at ``family``'s image size,
    and the split's feature statistics."""
    ds = EventDataset(synthetic_file, limit_index=(0.0, 0.3), event_current_targets=True)
    ds.compute_statistics()
    norm = {"mean": ds.mean, "std": ds.std,
            "extra_mean": ds.extra_mean, "extra_std": ds.extra_std}
    batcher = Batcher(Resized(ds, image_shape(family)), batch_size=4, coo_granularity=512,
                      fixed_shape=True)
    return [b for _, b in zip(range(count), batcher.epoch(0))], norm
