"""HDF5 event dataset with CSR-over-events sparse pixel banks.

NumPy re-design of the reference's live dataset
(the reference's transformercvn/dataset/minkowski_dataset.py:89-281):

* fractional ``limit_index`` train/val split with identical rounding,
* optional 10->4 event-class remap (``event_current_targets``),
* either loads the pixel banks to RAM or ``np.memmap``'s the raw HDF5
  dataset extents for lazy reads (minkowski_dataset.py:156-167),
* forces ``prong_mask[:, 0] = True`` and synthesizes an all-ones event mask
  (minkowski_dataset.py:180-182),
* masked mean/std feature statistics shared train -> val/test
  (minkowski_dataset.py:219-242).

There is no per-item ``__getitem__`` -> collate pipeline here: batches are
assembled by :mod:`.batcher`, which slices the CSR banks for a whole batch of
events at once.

The port's own copy of ``dune_transformercvn_tpu/data/dataset.py``; it
also reads a mapping of the file's arrays by dataset name in place of the
file (``schema.make_synthetic_arrays``), with no ``h5py``.  Banks
loaded to RAM are gathered by the native C++ engine
(:func:`..utils.native.native_gather_ranges`), as in the JAX package;
memory-mapped banks, or ``gather_events(..., native=False)``, take the
numpy loop, which gives the same arrays.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.native import native_gather_ranges
from .schema import remap_event_current_targets

LimitIndex = Union[float, Tuple[float, float], Sequence[int], np.ndarray]


def _memmap_h5_dataset(path: str, dset) -> np.ndarray:
    """Memory-map a contiguous HDF5 dataset's raw extent (lazy, zero-copy);
    an array in memory is taken as it is."""
    if isinstance(dset, np.ndarray):
        return dset
    offset = dset.id.get_offset()
    if offset is None:  # chunked/compressed dataset: fall back to h5py reads
        return dset
    return np.memmap(path, mode="r", shape=dset.shape, offset=offset, dtype=dset.dtype)


class EventDataset:
    """One split of a TransformerCVN HDF5 file, or of a mapping of its
    arrays by dataset name (``data_file``)."""

    def __init__(
        self,
        data_file: Union[str, Mapping[str, np.ndarray]],
        limit_index: LimitIndex = 1.0,
        event_current_targets: bool = False,
        load_full_dataset: bool = False,
    ):
        self.data_file = data_file
        self.load_full_dataset = load_full_dataset

        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.extra_mean: Optional[np.ndarray] = None
        self.extra_std: Optional[np.ndarray] = None

        if isinstance(data_file, Mapping):
            file = data_file
        else:
            import h5py

            file = h5py.File(data_file, "r")
        self._file = file
        total_events = file["features"].shape[0]

        indices = self._compute_limit_index(limit_index, total_events)
        if indices.size == 0:
            raise ValueError(
                f"limit_index {limit_index!r} selects no events out of "
                f"{total_events} in {'the arrays given' if file is data_file else data_file}"
                " — adjust the split fractions "
                "(e.g. train_validation_split)"
            )
        self.min_limit = int(indices.min())
        self.max_limit = int(indices.max())
        lo, hi = self.min_limit, self.max_limit

        self.features = np.asarray(file["features"][lo:hi], dtype=np.float32)
        self.extra = np.asarray(file["extra"][lo:hi], dtype=np.float32)
        self.prong_mask = np.asarray(file["prong_mask"][lo:hi]).astype(bool)
        self.event_targets = np.asarray(file["event_target"][lo:hi]).astype(np.int32)
        self.prong_targets = np.asarray(file["prong_target"][lo:hi]).astype(np.int32)

        if event_current_targets:
            self.event_targets = remap_event_current_targets(self.event_targets)

        def values_dset(prefix: str):
            name = f"{prefix}_pixels_values"
            return file[name] if name in file else file[f"{prefix}_pixels_value"]

        # CSR-over-events ranges into the sparse pixel banks.
        self.event_compressed_index = np.asarray(
            file["event_compressed_index"][lo:hi], dtype=np.int64
        )
        self.prong_compressed_index = np.asarray(
            file["prong_compressed_index"][lo:hi], dtype=np.int64
        )
        self.min_event_index = int(self.event_compressed_index[0, 0])
        self.min_prong_index = int(self.prong_compressed_index[0, 0])
        max_event_index = int(self.event_compressed_index[-1, -1])
        max_prong_index = int(self.prong_compressed_index[-1, -1])

        if load_full_dataset:
            self.event_pixels_coordinates = np.ascontiguousarray(
                file["event_pixels_coordinates"][self.min_event_index:max_event_index],
                dtype=np.int64,
            )
            self.event_pixels_values = np.ascontiguousarray(
                values_dset("event")[self.min_event_index:max_event_index],
                dtype=np.float32,
            )
            self.prong_pixels_coordinates = np.ascontiguousarray(
                file["prong_pixels_coordinates"][self.min_prong_index:max_prong_index],
                dtype=np.int64,
            )
            self.prong_pixels_values = np.ascontiguousarray(
                values_dset("prong")[self.min_prong_index:max_prong_index],
                dtype=np.float32,
            )
            # Ranges become local to the loaded slice.
            self.event_compressed_index = self.event_compressed_index - self.min_event_index
            self.prong_compressed_index = self.prong_compressed_index - self.min_prong_index
        else:
            # Lazy: map the whole banks, keep the absolute global ranges.
            self.event_pixels_coordinates = _memmap_h5_dataset(
                data_file, file["event_pixels_coordinates"]
            )
            self.event_pixels_values = _memmap_h5_dataset(data_file, values_dset("event"))
            self.prong_pixels_coordinates = _memmap_h5_dataset(
                data_file, file["prong_pixels_coordinates"]
            )
            self.prong_pixels_values = _memmap_h5_dataset(data_file, values_dset("prong"))

        self.full_pixel_shape = np.asarray(file["full_pixels_shape"][:], dtype=np.int64)

        self.num_events, self.max_particles, self.num_features = self.features.shape
        self.num_extra = self.extra.shape[1]

        self.num_event_classes = int(self.event_targets.max()) + 1
        self.num_prong_classes = int(self.prong_targets.max()) + 1

        self.pixel_features = int(self.full_pixel_shape[0])
        self.pixel_shape = tuple(int(v) for v in self.full_pixel_shape[1:])

        # The first prong slot is always treated as real (reference quirk,
        # minkowski_dataset.py:181); loss masking still uses prong_target >= 0.
        self.prong_mask[:, 0] = True

    # -------------------------------------------------------------------------

    @staticmethod
    def _compute_limit_index(limit_index: LimitIndex, num_events: int) -> np.ndarray:
        if isinstance(limit_index, float):
            limit_index = (0.0, limit_index) if limit_index > 0 else (1.0 + limit_index, 1.0)
        if isinstance(limit_index, (list, tuple)):
            lower = int(round(limit_index[0] * num_events))
            upper = int(round(limit_index[1] * num_events))
            limit_index = np.arange(lower, upper)
        return np.sort(np.asarray(limit_index))

    def compute_statistics(
        self,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        extra_mean: Optional[np.ndarray] = None,
        extra_std: Optional[np.ndarray] = None,
    ):
        """Masked feature statistics; pass another split's stats to share them."""
        if mean is None or std is None:
            masked = self.features[self.prong_mask]
            mean = masked.mean(0)
            # ddof=1: the reference's torch ``.std()`` is unbiased
            # (minkowski_dataset.py:228)
            std = masked.std(0, ddof=1 if masked.shape[0] > 1 else 0)
            std = np.where(std < 1e-5, 1.0, std)
        if extra_mean is None or extra_std is None:
            extra_mean = np.asarray(self.extra.mean(), dtype=np.float32)
            extra_std = np.asarray(
                self.extra.std(ddof=1 if self.extra.size > 1 else 0),
                dtype=np.float32,
            )
            if float(extra_std) < 1e-5:
                extra_std = np.asarray(1.0, dtype=np.float32)

        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.extra_mean = np.asarray(extra_mean, dtype=np.float32)
        self.extra_std = np.asarray(extra_std, dtype=np.float32)
        return self.mean, self.std, self.extra_mean, self.extra_std

    def __len__(self) -> int:
        return self.num_events

    # -------------------------------------------------------------------------

    def gather_events(self, indices: np.ndarray, native: bool = True):
        """Slice all per-event fields and COO banks for a batch of events.

        Returns a dict of numpy arrays; COO hits are concatenated with a
        per-hit owner column (position of the event within ``indices`` for
        event hits, running real-prong slot for prong hits is derived later
        by the batcher).  Banks in RAM go through the native gather unless
        ``native`` is False.
        """
        indices = np.asarray(indices)
        # ranges are absolute into the memmapped banks (lazy path) or local
        # into the loaded slices (RAM path) — both set up in __init__
        ev_ranges = self.event_compressed_index[indices]
        pr_ranges = self.prong_compressed_index[indices]

        def slice_bank(coords, values, ranges):
            if native and self.load_full_dataset:
                return native_gather_ranges(ranges, coords, values)
            parts_c, parts_v, owners = [], [], []
            for row, (lo, hi) in enumerate(ranges):
                lo, hi = int(lo), int(hi)
                parts_c.append(np.asarray(coords[lo:hi]))
                parts_v.append(np.asarray(values[lo:hi], dtype=np.float32))
                owners.append(np.full(hi - lo, row, dtype=np.int64))
            return (
                np.concatenate(parts_c) if parts_c else np.zeros((0, 3), np.int64),
                np.concatenate(parts_v) if parts_v else np.zeros((0, self.pixel_features), np.float32),
                np.concatenate(owners) if owners else np.zeros((0,), np.int64),
            )

        ev_c, ev_v, ev_o = slice_bank(
            self.event_pixels_coordinates, self.event_pixels_values, ev_ranges
        )
        pr_c, pr_v, pr_o = slice_bank(
            self.prong_pixels_coordinates, self.prong_pixels_values, pr_ranges
        )

        return {
            "features": self.features[indices],
            "extra": self.extra[indices],
            "prong_mask": self.prong_mask[indices],
            "event_targets": self.event_targets[indices],
            "prong_targets": self.prong_targets[indices],
            "event_coords": ev_c.astype(np.int64),
            "event_values": ev_v,
            "event_owner": ev_o,
            "prong_coords": pr_c.astype(np.int64),
            "prong_values": pr_v,
            "prong_owner": pr_o,
        }


def create_datasets(options, training_file=None
                    ) -> Tuple[EventDataset, EventDataset, Optional[EventDataset]]:
    """Train/val/test splits following the reference split rules
    (trainers/neutrino_base.py:68-86).  ``training_file`` (a path, or a
    mapping of the file's arrays) takes the place of
    ``options.training_file``."""
    kwargs = dict(
        event_current_targets=options.event_current_targets,
        load_full_dataset=options.load_full_dataset,
    )
    source = options.training_file if training_file is None else training_file
    if len(options.validation_file) > 0:
        training = EventDataset(source, **kwargs)
        validation = EventDataset(options.validation_file, **kwargs)
    else:
        split = options.dataset_limit * options.train_validation_split
        training = EventDataset(source, (0.0, split), **kwargs)
        validation = EventDataset(source, (split, options.dataset_limit), **kwargs)

    testing = None
    if len(options.testing_file) > 0:
        testing = EventDataset(options.testing_file, **kwargs)

    # Class counts are derived from each split's own target max — a
    # reference quirk preserved deliberately (minkowski_dataset.py:174-175).
    # If a class never appears in the training split, the model head is too
    # narrow and eval targets get clipped into the last class: warn loudly
    # instead of corrupting metrics silently.
    import warnings

    for name, other in (("validation", validation), ("testing", testing)):
        if other is None:
            continue
        for attr in ("num_event_classes", "num_prong_classes"):
            if getattr(other, attr) > getattr(training, attr):
                warnings.warn(
                    f"{name} split has {attr}={getattr(other, attr)} > "
                    f"training's {getattr(training, attr)}: targets beyond "
                    "the training range will be clipped in losses/metrics "
                    "(class absent from the training split — enlarge the "
                    "split or the dataset)",
                    stacklevel=2,
                )

    return training, validation, testing
