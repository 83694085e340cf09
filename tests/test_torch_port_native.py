"""The port's native COO engine (``csrc/coo_engine.cpp``) against the numpy
paths and the JAX package's native engine.

The engine builds with the host's C++ compiler into ``build/torch_kernels``
at first use.  Its kernel maps equal the JAX package's native ones up to
the numbering of the output sites: the JAX engine numbers them in the order
it meets them, the port's in ascending ``(owner, x, y)`` order, as numpy's
``np.unique`` does (``test_torch_port_coo_conv.py`` holds the port's maps
to the JAX package's numpy maps array for array).  Its CSR gather equals the
JAX package's and the numpy loop array for array, and the datasets' native
path gives the numpy path's batches, dtypes included.  A failed build
raises with the compiler's output.
"""

import numpy as np
import pytest

from dune_transformercvn_tpu.utils.native import native_build_conv_maps as jax_native_maps
from dune_transformercvn_tpu.utils.native import native_gather_ranges as jax_native_gather
from dune_transformercvn_torch.data import Batcher, EventDataset, InMemoryEvents
from dune_transformercvn_torch.utils import build, native


def test_engine_builds_at_first_use_into_build():
    lib = native.library()
    path = build.build_host("coo_engine")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libcoo_engine-")
    assert path.exists() and lib is native.library()


@pytest.mark.parametrize("kernel,stride", [(3, 1), (7, 2), (2, 2), (5, 1)])
def test_maps_match_jax_native_engine(kernel, stride):
    rng = np.random.default_rng(kernel)
    coords = np.argwhere(rng.uniform(size=(3, 24, 20)) < 0.1).astype(np.int64)
    out_coords, num_out, in_maps, out_maps = native.native_build_conv_maps(
        coords, kernel, stride, 24, 20, pad_to=64)
    j_coords, j_num, j_in, j_out = jax_native_maps(coords, kernel, stride, 24, 20, 64)
    assert num_out == j_num
    np.testing.assert_array_equal(in_maps, j_in)
    # the JAX engine's sites in ascending order, its pairs renumbered to match
    order = np.lexsort(j_coords.T[::-1])
    np.testing.assert_array_equal(out_coords, j_coords[order])
    rank = np.empty(num_out, np.int64)
    rank[order] = np.arange(num_out)
    real = j_out < j_num
    renumbered = np.where(real, rank[np.where(real, j_out, 0)], j_out)
    np.testing.assert_array_equal(out_maps, renumbered)
    assert out_maps.dtype == j_out.dtype and in_maps.dtype == j_in.dtype


def test_gather_matches_jax_native_and_the_loop():
    rng = np.random.default_rng(1)
    total, c = 500, 3
    coords = rng.integers(0, 100, (total, 3)).astype(np.int64)
    values = rng.normal(size=(total, c)).astype(np.float32)
    bounds = np.sort(rng.choice(total, 8, replace=False))
    ranges = np.stack([bounds[:-1], bounds[1:]], axis=1).astype(np.int64)
    ranges[2] = ranges[2, 0]                              # an empty event
    got = native.native_gather_ranges(ranges, coords, values)
    want = jax_native_gather(ranges, coords, values)
    loop = (np.concatenate([coords[a:b] for a, b in ranges]),
            np.concatenate([values[a:b] for a, b in ranges]),
            np.concatenate([np.full(b - a, i) for i, (a, b) in enumerate(ranges)]))
    for a, b, d in zip(got, want, loop):
        assert a.dtype == b.dtype == d.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, d)


def test_gather_refuses_ranges_outside_the_bank():
    coords, values = np.zeros((10, 3), np.int64), np.zeros((10, 3), np.float32)
    for bad in ([[0, 11]], [[-1, 3]], [[5, 4]]):
        with pytest.raises(ValueError, match="outside"):
            native.native_gather_ranges(np.array(bad), coords, values)


def assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_hdf5_dataset_native_path_matches_numpy(synthetic_file):
    """A RAM-loaded dataset gathers through the engine; its batches equal
    the numpy path's and a memory-mapped dataset's."""
    ram = EventDataset(synthetic_file, limit_index=(0.1, 0.9), load_full_dataset=True)
    lazy = EventDataset(synthetic_file, limit_index=(0.1, 0.9), load_full_dataset=False)
    idx = np.array([1, 5, 17, 30, 2])
    native_batch = ram.gather_events(idx)
    assert_same_arrays(native_batch, ram.gather_events(idx, native=False))
    assert_same_arrays(native_batch, lazy.gather_events(idx))


def test_in_memory_events_take_the_native_path(monkeypatch):
    """``InMemoryEvents`` hold their banks in RAM: the Batcher's batches go
    through the engine and equal the numpy path's."""
    ds = InMemoryEvents(40, 3, image_shape=(48, 40))
    calls = []
    gather = native.native_gather_ranges

    def counted(*args):
        calls.append(1)
        return gather(*args)

    monkeypatch.setattr("dune_transformercvn_torch.data.dataset.native_gather_ranges", counted)
    batcher = Batcher(ds, batch_size=8, coo_granularity=256)
    idx = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    got = batcher.build_batch(idx)
    assert len(calls) == 2                                   # event and prong banks
    monkeypatch.setattr(ds, "gather_events",
                        lambda indices: EventDataset.gather_events(ds, indices, native=False))
    assert_same_arrays(got, batcher.build_batch(idx))
    assert len(calls) == 2


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text('extern "C" int f() { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match="undefined_name"):
        build.build_host("broken", tmp_path, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no_such_compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        build.build_host("coo_engine", build.CSRC_DIR, tmp_path / "out")
