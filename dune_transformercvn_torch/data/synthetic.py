"""Events made in memory, served through ``EventDataset``'s code without HDF5.

The twin of ``schema.make_synthetic_file``'s file, event for event, is
``EventDataset(schema.make_synthetic_arrays(...))`` (``create_datasets``
splits it as the file); its hits lie along a line that depends on each
image's label, so a run on it learns.  :class:`InMemoryEvents` follows
only the file's statistics: about 5 prongs per event, 160 hits per event
image and 53 per prong image, along a label-dependent line, drawn faster
(``chip_smoke.py`` and :mod:`..profile_serving` feed them to
``predict_split`` on hosts that may lack ``h5py``).
"""

from __future__ import annotations

import numpy as np

from .dataset import EventDataset
from .schema import MAX_PRONGS


class InMemoryEvents(EventDataset):
    """An ``EventDataset`` whose arrays are made from ``seed``: it fills the
    attributes ``Batcher.build_batch`` and ``compute_statistics`` read."""

    def __init__(self, num_events: int, seed: int, image_shape=(400, 280),
                 channels: int = 3):
        rng = np.random.default_rng(seed)
        n = num_events
        H, W = image_shape
        self.load_full_dataset = True     # banks in RAM: the native gather
        self.event_targets = rng.integers(0, 4, n).astype(np.int32)
        counts = np.clip(rng.poisson(5.0, n), 1, MAX_PRONGS)
        self.prong_targets = np.full((n, MAX_PRONGS), -1, np.int32)
        for i, k in enumerate(counts):
            self.prong_targets[i, :k] = rng.integers(0, 8, k)
        self.prong_mask = self.prong_targets >= 0
        self.features = rng.normal(size=(n, MAX_PRONGS, 6)).astype(np.float32)
        self.features[~self.prong_mask] = 0.0
        self.extra = rng.normal(size=(n, 4)).astype(np.float32)

        def hits(labels, mean, first_column):
            per = np.maximum(rng.poisson(mean, len(labels)), 2)
            lab = np.repeat(labels, per)
            t = rng.uniform(0.0, 1.0, lab.size)
            angle = 0.3 + 0.5 * (lab % 4)
            x = np.clip((t * (H - 1)).astype(np.int64)
                        + rng.integers(-4, 5, lab.size), 0, H - 1)
            y = np.clip((np.clip(np.tan(angle) * t, 0, 1) * (W - 1)).astype(np.int64)
                        + rng.integers(-4, 5, lab.size), 0, W - 1)
            values = rng.uniform(16.0, 255.0, (lab.size, channels)).astype(np.float32)
            values *= (0.5 + 0.5 * ((lab % 4) + 1) / 4.0)[:, None]
            coords = np.stack([np.repeat(first_column, per), x, y], 1)
            return coords, values, per

        ev_c, ev_v, ev_n = hits(self.event_targets, 160.0, np.zeros(n, np.int64))
        prong_event = np.repeat(np.arange(n), counts)
        prong_index = np.concatenate([np.arange(k) for k in counts])
        pr_labels = self.prong_targets[prong_event, prong_index]
        pr_c, pr_v, pr_n = hits(pr_labels, 160.0 / 3, prong_index)
        pr_per_event = np.bincount(np.repeat(prong_event, pr_n), minlength=n)

        def csr(per):
            ends = np.cumsum(per)
            return np.stack([ends - per, ends], 1).astype(np.int64)

        self.event_compressed_index = csr(ev_n)
        self.prong_compressed_index = csr(pr_per_event)
        self.event_pixels_coordinates, self.event_pixels_values = ev_c, ev_v
        self.prong_pixels_coordinates, self.prong_pixels_values = pr_c, pr_v
        self.num_events, self.max_particles, self.num_features = self.features.shape
        self.num_extra = self.extra.shape[1]
        self.num_event_classes, self.num_prong_classes = 4, 8
        self.pixel_features, self.pixel_shape = channels, (H, W)
        self.compute_statistics()

    def norm(self):
        """The normalisation statistics ``predict_split`` takes."""
        return {"mean": self.mean, "std": self.std,
                "extra_mean": self.extra_mean, "extra_std": self.extra_std}

