"""The port's own copies of the framework-free modules against the JAX
package's: ``config.Options``, ``data.schema``, ``data.dataset`` and
``data.batcher`` must give the same options, statistics and batches, array
for array (every key, ``event_starts`` and ``prong_starts`` included)."""

import glob
import os

import numpy as np
import pytest

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.data import schema as jax_schema
from dune_transformercvn_tpu.data.batcher import Batcher as JaxBatcher
from dune_transformercvn_tpu.data.dataset import EventDataset as JaxEventDataset
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import Batcher, EventDataset, InMemoryEvents, schema

OPTION_FILES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "option_files", "*.json")))


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    assert "event_starts" in got and "prong_starts" in got
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("path", OPTION_FILES, ids=os.path.basename)
def test_options_load_the_same(path):
    assert len(OPTION_FILES) >= 2
    assert Options.load(path).to_dict() == JaxOptions.load(path).to_dict()


def test_default_options_and_schema_constants_are_the_same():
    assert Options().to_dict() == JaxOptions().to_dict()
    for name in ("MAX_PRONGS", "IMAGE_HEIGHT", "IMAGE_WIDTH", "PIXEL_CHANNELS",
                 "EVENT_CLASS_NAMES", "PRONG_CLASS_NAMES"):
        assert getattr(schema, name) == getattr(jax_schema, name), name
    targets = np.array([-1, 0, 3, 4, 7, 8, 9], np.int32)
    np.testing.assert_array_equal(schema.split_current_targets(targets),
                                  jax_schema.split_current_targets(targets))
    np.testing.assert_array_equal(schema.remap_event_current_targets(targets),
                                  jax_schema.remap_event_current_targets(targets))


def test_make_synthetic_file_writes_the_same_file(tmp_path):
    h5py = pytest.importorskip("h5py")
    ours = schema.make_synthetic_file(str(tmp_path / "ours.h5"), num_events=9, seed=2)
    theirs = jax_schema.make_synthetic_file(str(tmp_path / "theirs.h5"), num_events=9, seed=2)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key][()], b[key][()], err_msg=key)


@pytest.mark.parametrize("fixed_shape", [False, True])
def test_batches_of_in_memory_events_are_the_same(fixed_shape):
    ds = InMemoryEvents(40, 5, image_shape=(48, 40))
    kw = dict(batch_size=8, coo_granularity=256, fixed_shape=fixed_shape, drop_last=False)
    ours, theirs = Batcher(ds, **kw), JaxBatcher(ds, **kw)
    assert ours.capacity_ladder == theirs.capacity_ladder
    for got, want in zip(ours.epoch(0), theirs.epoch(0)):
        assert_batches_equal(got, want)
    assert_batches_equal(ours.build_batch(np.array([3, 1, 4, 1, 5, 9, 2, 6])),
                         theirs.build_batch(np.array([3, 1, 4, 1, 5, 9, 2, 6])))


@pytest.mark.parametrize("num_workers", [1, 3])
def test_prefetch_applies_the_transform_to_every_batch_in_order(num_workers):
    """The prefetching batcher's per-batch ``transform`` (the Trainer pins
    batches with it) runs on every batch, the tail and a mid-epoch start
    included, and keeps the JAX batcher's order."""
    ds = InMemoryEvents(30, 5, image_shape=(48, 40))
    kw = dict(batch_size=8, coo_granularity=256, shuffle=True, drop_last=False)
    ours, theirs = Batcher(ds, **kw), JaxBatcher(ds, **kw)
    tagged = list(ours.prefetch_epoch(
        2, depth=2, num_workers=num_workers, start_batch=1,
        transform=lambda batch: dict(batch, tag=np.ones(1))))
    want = list(theirs.epoch(2, start_batch=1))
    assert len(tagged) == len(want) == 3
    for got, ref in zip(tagged, want):
        assert got.pop("tag")[0] == 1
        assert_batches_equal(got, ref)


@pytest.mark.parametrize("load_full_dataset", [False, True])
def test_hdf5_dataset_batches_and_statistics_are_the_same(synthetic_file, load_full_dataset):
    kw = dict(limit_index=(0.1, 0.6), event_current_targets=True,
              load_full_dataset=load_full_dataset)
    ours, theirs = EventDataset(synthetic_file, **kw), JaxEventDataset(synthetic_file, **kw)
    for got, want in zip(ours.compute_statistics(), theirs.compute_statistics()):
        np.testing.assert_array_equal(got, want)
    assert (ours.num_event_classes, ours.num_prong_classes, ours.pixel_shape) == (
        theirs.num_event_classes, theirs.num_prong_classes, theirs.pixel_shape)
    bkw = dict(batch_size=4, coo_granularity=512, shuffle=True, seed=3)
    for got, want in zip(Batcher(ours, **bkw).epoch(1), JaxBatcher(theirs, **bkw).epoch(1)):
        assert_batches_equal(got, want)

    # statistics handed from one split to another
    other = dict(kw, limit_index=(0.6, 1.0))
    a, b = EventDataset(synthetic_file, **other), JaxEventDataset(synthetic_file, **other)
    shared = theirs.compute_statistics()
    for got, want in zip(a.compute_statistics(*shared), b.compute_statistics(*shared)):
        np.testing.assert_array_equal(got, want)
