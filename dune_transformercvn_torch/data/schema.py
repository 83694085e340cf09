"""HDF5 schema of TransformerCVN training files, plus a synthetic generator.

The port's own copy of ``dune_transformercvn_tpu/data/schema.py`` (numpy;
``h5py`` imported only by :func:`make_synthetic_file`), whose generator is
split here into :func:`make_synthetic_arrays`, the file's arrays in memory,
and the writer that stores them.

Schema (the reference's README.md:84-99):

| branch                     | shape         | description                          |
|----------------------------|---------------|--------------------------------------|
| event_target               | (Nevt,)       | event labels (0-7 CC modes, 8 NC, 9 Other after file-level packing; raw files use 13=NC, 15=Other) |
| prong_target               | (Nevt, 20)    | prong labels, -1 padding             |
| prong_mask                 | (Nevt, 20)    | 1 where prong_target != -1           |
| full_pixels_shape          | (3,)          | [C, 400, 280]                        |
| event_pixels_shape         | (4,)          | [1, C, 400, 280]                     |
| prong_pixels_shape         | (4,)          | [20, C, 400, 280]                    |
| event_pixels_coordinates   | (NevtHits, 3) | [0, x in 0-399, y in 0-279]          |
| prong_pixels_coordinates   | (NpngHits, 3) | [prong 0-19, x, y]                   |
| event_pixels_values        | (NevtHits, C) | per-view pixel values (raw counts)   |
| prong_pixels_values        | (NpngHits, C) | per-view pixel values                |
| features                   | (Nevt, 20, F) | per-prong reconstructed variables    |
| extra                      | (Nevt, E)     | per-event reconstructed variables    |
| event_compressed_index     | (Nevt, 2)     | [first, last) into event hit banks   |
| prong_compressed_index     | (Nevt, 2)     | [first, last) into prong hit banks   |

The live reference dataset uses ``*_pixels_values`` dataset names
(minkowski_dataset.py:150-167) even though the README table says
``*_pixels_value``; this module reads/writes the code's spelling and the
reader falls back to the README spelling.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

MAX_PRONGS = 20
IMAGE_HEIGHT = 400
IMAGE_WIDTH = 280
PIXEL_CHANNELS = 3

EVENT_CLASS_NAMES = (
    "Numu Charged Current",
    "Nue Charged Current",
    "Neutral Current",
    "Other",
)
PRONG_CLASS_NAMES = (
    "Electron",
    "Muon",
    "Proton",
    "Photon from Neutron",
    "Charged Pion",
    "Photon from Neutral Pion",
    "Other Photon",
    "Other",
)

NUM_EVENT_CLASSES_DETAILED = 10
NUM_EVENT_CLASSES = 4
NUM_PRONG_CLASSES = 8


def remap_event_current_targets(event_targets: np.ndarray) -> np.ndarray:
    """Fold the 10 detailed event labels onto the 4 'current' classes.

    Matches reference minkowski_dataset.py:127-133: labels 0-3 -> 0 (NumuCC),
    4-7 -> 1 (NueCC), 8 -> 2 (NC), 9 -> 3 (Other).
    """
    out = np.zeros_like(event_targets)
    out[(event_targets > 3) & (event_targets <= 7)] = 1
    out[event_targets == 8] = 2
    out[event_targets == 9] = 3
    return out


def split_current_targets(event_targets: np.ndarray) -> np.ndarray:
    """Host-side twin of ``ops.losses.split_event_targets``'s current half:
    the remap above with -1 padding propagated (split_dataset.py:10-13).
    Kept adjacent to :func:`remap_event_current_targets` so the 10→4 fold
    lives in one module; a property test pins the two implementations
    together."""
    out = remap_event_current_targets(event_targets)
    return np.where(event_targets < 0, -1, out)


def make_synthetic_file(path: str, num_events: int = 128, **kwargs) -> str:
    """Write a synthetic HDF5 file with the exact training schema: the
    arrays of :func:`make_synthetic_arrays` (same arguments), one dataset
    each.

    Pixel images get class-correlated structure (a noisy line whose angle
    depends on the label) so that a short training run can measurably reduce
    the loss — this is the integration-test fixture, mirroring the role of the
    reference's real fdhd_beam_2018prod file.
    """
    import h5py

    arrays = make_synthetic_arrays(num_events, **kwargs)
    with h5py.File(path, "w") as f:
        for name, value in arrays.items():
            f.create_dataset(name, data=value)
    return path


def make_synthetic_arrays(
    num_events: int = 128,
    num_features: int = 6,
    num_extra: int = 4,
    mean_prongs: float = 5.0,
    mean_hits_per_image: float = 160.0,
    detailed_targets: bool = True,
    seed: int = 0,
    fixed_prongs: int = 0,
    unique_pixels: bool = False,
) -> Dict[str, np.ndarray]:
    """The datasets of :func:`make_synthetic_file`'s file, by name, made in
    memory from ``seed`` (the same draws in the same order): what
    ``dataset.EventDataset`` reads from the file, it reads from this
    mapping too, so a host without ``h5py`` trains on the same events."""
    rng = np.random.default_rng(seed)

    num_classes = NUM_EVENT_CLASSES_DETAILED if detailed_targets else NUM_EVENT_CLASSES
    event_target = rng.integers(0, num_classes, size=num_events).astype(np.int64)
    # Guarantee every coarse class appears so AUC metrics are well defined.
    coarse_reps = [0, 4, 8, 9] if detailed_targets else [0, 1, 2, 3]
    for i, rep in enumerate(coarse_reps):
        if i < num_events:
            event_target[i] = rep

    if fixed_prongs:
        # Every event gets exactly this many prongs — after the reference's
        # max-prong batch trim there is NO padded row, so torch packed BN and
        # our masked BN see identical batches (the trajectory-parity fixture).
        prong_counts = np.full(num_events, min(fixed_prongs, MAX_PRONGS), np.int64)
    else:
        prong_counts = np.clip(
            rng.poisson(mean_prongs, size=num_events), 1, MAX_PRONGS
        ).astype(np.int64)

    prong_target = np.full((num_events, MAX_PRONGS), -1, dtype=np.int64)
    for i, n in enumerate(prong_counts):
        prong_target[i, :n] = rng.integers(0, NUM_PRONG_CLASSES, size=n)
    prong_mask = (prong_target >= 0).astype(np.int64)

    features = rng.normal(size=(num_events, MAX_PRONGS, num_features)).astype(np.float32)
    features[prong_mask == 0] = 0.0
    extra = rng.normal(size=(num_events, num_extra)).astype(np.float32)

    def synth_image_hits(label: int, n_hits: int):
        """COO hits along a label-dependent line with noise."""
        angle = 0.3 + 0.5 * (label % 4)
        t = rng.uniform(0.0, 1.0, size=n_hits)
        x = (t * (IMAGE_HEIGHT - 1)).astype(np.int64)
        y = (np.clip(np.tan(angle) * t, 0, 1) * (IMAGE_WIDTH - 1)).astype(np.int64)
        x = np.clip(x + rng.integers(-4, 5, size=n_hits), 0, IMAGE_HEIGHT - 1)
        y = np.clip(y + rng.integers(-4, 5, size=n_hits), 0, IMAGE_WIDTH - 1)
        values = rng.uniform(16.0, 255.0, size=(n_hits, PIXEL_CHANNELS)).astype(np.float32)
        values *= 0.5 + 0.5 * ((label % 4) + 1) / 4.0
        if unique_pixels:
            # One hit per pixel: the reference's sparse_to_dense overwrite
            # (`out[idx] += v` is last-write-wins on duplicates) and our
            # scatter-add then agree exactly (trajectory-parity fixture).
            _, keep = np.unique(x * IMAGE_WIDTH + y, return_index=True)
            x, y, values = x[keep], y[keep], values[keep]
        return x, y, values

    ev_coords, ev_values, ev_index = [], [], np.zeros((num_events, 2), np.int64)
    pr_coords, pr_values, pr_index = [], [], np.zeros((num_events, 2), np.int64)
    ev_cursor = pr_cursor = 0

    for i in range(num_events):
        n_hits = max(4, rng.poisson(mean_hits_per_image))
        x, y, v = synth_image_hits(int(event_target[i]), n_hits)
        coords = np.stack([np.zeros_like(x), x, y], axis=1)
        ev_coords.append(coords)
        ev_values.append(v)
        ev_index[i] = (ev_cursor, ev_cursor + n_hits)
        ev_cursor += n_hits

        start = pr_cursor
        for p in range(prong_counts[i]):
            n_hits = max(2, rng.poisson(mean_hits_per_image / 3))
            x, y, v = synth_image_hits(int(prong_target[i, p]), n_hits)
            coords = np.stack([np.full_like(x, p), x, y], axis=1)
            pr_coords.append(coords)
            pr_values.append(v)
            pr_cursor += n_hits
        pr_index[i] = (start, pr_cursor)

    return {
        "event_target": event_target,
        "prong_target": prong_target,
        "prong_mask": prong_mask,
        "features": features,
        "extra": extra,
        "full_pixels_shape": np.array([PIXEL_CHANNELS, IMAGE_HEIGHT, IMAGE_WIDTH], np.int64),
        "event_pixels_shape": np.array(
            [1, PIXEL_CHANNELS, IMAGE_HEIGHT, IMAGE_WIDTH], np.int64),
        "prong_pixels_shape": np.array(
            [MAX_PRONGS, PIXEL_CHANNELS, IMAGE_HEIGHT, IMAGE_WIDTH], np.int64),
        "event_pixels_coordinates": np.concatenate(ev_coords),
        "event_pixels_values": np.concatenate(ev_values),
        "prong_pixels_coordinates": np.concatenate(pr_coords),
        "prong_pixels_values": np.concatenate(pr_values),
        "event_compressed_index": ev_index,
        "prong_compressed_index": pr_index,
    }
