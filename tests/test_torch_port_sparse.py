"""The port's sparse-grid engine and sparse families against the JAX package.

* ``ops/sparse.py``: ``sparse_conv`` for odd and even kernels (centred, and
  anchored at the site), strides 1, 2 and 4, channelwise, with and without
  coordinate expansion, on extents that strides do not divide (ceil mode);
  ``sparse_avg_pool`` (window sums over counts, on the stride map);
  ``sparse_global_avg_pool`` and ``from_coo``.  Occupancies must be equal,
  features within ``rtol=atol=1e-5``.
* ``SparseDenseNet``, ``SparseFCNN`` and ``SparseConvNeXt`` as modules, in
  eval and train mode (BatchNorm over occupied sites, running statistics),
  with a masked slot that has hits: within ``rtol=atol=1e-5``.
* ConvNeXt's drop-path rates and ``DropPath`` itself.
* One train step of the sparse, convnext and fcnn networks against JAX's
  (``test_torch_port_train.check_train_steps``' tolerances).

Float32; variables from seeded numpy, carried by ``from_jax.WeightMapper``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.models import sparse_convnext as jax_convnext
from dune_transformercvn_tpu.models import sparse_densenet as jax_densenet
from dune_transformercvn_tpu.models import sparse_fcnn as jax_fcnn
from dune_transformercvn_tpu.ops import sparse as jax_sparse
from dune_transformercvn_torch.models.sparse_convnext import DropPath, SparseConvNeXt
from dune_transformercvn_torch.models.sparse_densenet import SparseDenseNet
from dune_transformercvn_torch.models.sparse_fcnn import SparseFCNN
from dune_transformercvn_torch.ops import sparse
from test_torch_port_models import assert_stats_match, carry, random_variables, run_both
from test_torch_port_train import check_train_steps

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N, H, W, C = 3, 13, 10, 4     # extents no stride divides


def grid(seed, n=N, h=H, w=W, c=C, density=0.2):
    """A random grid: features zero wherever the site is unoccupied."""
    rng = np.random.default_rng(seed)
    occupancy = rng.random((n, h, w)) < density
    features = rng.normal(size=(n, h, w, c)).astype(np.float32) * occupancy[..., None]
    return features.astype(np.float32), occupancy


def both(features, occupancy):
    return (jax_sparse.SparseGrid(jnp.asarray(features), jnp.asarray(occupancy)),
            sparse.SparseGrid(torch.from_numpy(features), torch.from_numpy(occupancy)))


def assert_grids_match(got, want):
    np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(want.occupancy))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), **TOL)


@pytest.mark.parametrize("expand", [True, False], ids=["expand", "stride_map"])
@pytest.mark.parametrize("kernel,stride", [
    (1, 1), (3, 1), (5, 1), (2, 1), (4, 1),      # odd centred, even anchored
    (3, 2), (7, 2), (2, 2), (4, 2), (4, 4), (1, 2), (2, 4),
])
def test_sparse_conv_matches_jax(kernel, stride, expand):
    features, occupancy = grid(kernel * 10 + stride)
    rng = np.random.default_rng(1)
    hwio = (rng.normal(size=(kernel, kernel, C, 6)) / kernel).astype(np.float32)
    jg, pg = both(features, occupancy)
    want = jax.jit(partial(jax_sparse.sparse_conv, stride=stride,
                           expand_coordinates=expand))(jg, jnp.asarray(hwio))
    got = sparse.sparse_conv(pg, torch.from_numpy(hwio.transpose(3, 2, 0, 1)), stride,
                             expand_coordinates=expand)
    assert got.features.shape == want.features.shape
    assert_grids_match(got, want)


@pytest.mark.parametrize("stride", [1, 2])
def test_channelwise_sparse_conv_matches_jax(stride):
    features, occupancy = grid(5)
    hwio = np.random.default_rng(2).normal(size=(5, 5, 1, C)).astype(np.float32)
    jg, pg = both(features, occupancy)
    want = jax.jit(partial(jax_sparse.sparse_conv, stride=stride,
                           feature_group_count=C))(jg, jnp.asarray(hwio))
    got = sparse.sparse_conv(pg, torch.from_numpy(hwio.transpose(3, 2, 0, 1)), stride,
                             groups=C)
    assert_grids_match(got, want)


@pytest.mark.parametrize("kernel,stride", [(2, 2), (3, 2), (2, 1), (3, 1), (4, 4)])
def test_sparse_avg_pool_matches_jax(kernel, stride):
    features, occupancy = grid(kernel + 7 * stride, density=0.3)
    jg, pg = both(features, occupancy)
    want = jax.jit(partial(jax_sparse.sparse_avg_pool, kernel=kernel, stride=stride))(jg)
    got = sparse.sparse_avg_pool(pg, kernel, stride)
    assert got.features.shape == want.features.shape
    assert_grids_match(got, want)


def test_global_avg_pool_and_from_coo_match_jax():
    """``from_coo`` drops padding and out-of-range hits (negative too), adds
    duplicates and occupies each kept hit's site; the global mean runs over
    occupied sites, and an empty image gives zeros."""
    rng = np.random.default_rng(3)
    R = 40
    xy = np.stack([rng.integers(-2, H + 2, R), rng.integers(-2, W + 2, R)], 1).astype(np.int32)
    xy[1] = xy[0]                                        # a duplicate
    owner = np.sort(rng.integers(0, N + 1, R)).astype(np.int32)   # owner N: padding
    owner[owner == 1] = 2                                # image 1 is empty
    values = rng.uniform(0.1, 1.0, (R, C)).astype(np.float32)
    want = jax.jit(partial(jax_sparse.from_coo, num_images=N, height=H, width=W))(
        jnp.asarray(xy), jnp.asarray(values), jnp.asarray(owner))
    got = sparse.from_coo(torch.from_numpy(xy), torch.from_numpy(values),
                          torch.from_numpy(owner), N, H, W)
    assert_grids_match(got, want)
    assert not got.occupancy[1].any()
    pooled = sparse.sparse_global_avg_pool(got)
    np.testing.assert_allclose(pooled.numpy(),
                               np.asarray(jax.jit(jax_sparse.sparse_global_avg_pool)(want)),
                               **TOL)
    assert not pooled[1].any()


# ---------------------------------------------------------------------------
# the sparse families as modules
# ---------------------------------------------------------------------------

SH, SW = 16, 12
MASK = np.array([True, True, False, True])


def images(seed):
    """Sparse positive images; the masked slot has hits too."""
    rng = np.random.default_rng(seed)
    occupied = rng.random((4, SH, SW)) < 0.15
    return (rng.uniform(0.1, 1.0, (4, SH, SW, 3)) * occupied[..., None]).astype(np.float32)


MODULES = {
    "sparse": (lambda: jax_densenet.SparseDenseNet(
                   output_dim=6, initial_features=8, growth_rate=4, batch_norm_size=2,
                   block_config=(2, 2)),
               lambda: SparseDenseNet(3, 6, initial_features=8, growth_rate=4,
                                      batch_norm_size=2, block_config=(2, 2)),
               lambda m: m.sparse_densenet("", "", (2, 2))),
    "fcnn": (lambda: jax_fcnn.SparseFCNN(output_dim=6, initial_features=8,
                                         stage_features=(8, 16)),
             lambda: SparseFCNN(3, 6, initial_features=8, stage_features=(8, 16)),
             lambda m: m.fcnn("", "")),
    "convnext": (lambda: jax_convnext.SparseConvNeXt(output_dim=6),
                 lambda: SparseConvNeXt(3, 6),
                 lambda m: m.convnext("", "")),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", sorted(MODULES))
def test_sparse_module_matches_jax(family, train):
    make_jax, make_port, fill = MODULES[family]
    x = images(4)
    jm = make_jax()
    variables = random_variables(jm, 9, jnp.asarray(x), jnp.asarray(MASK))
    if family == "convnext":     # layer scales far from their 1e-6 start
        variables["params"] = jax.tree_util.tree_map_with_path(
            lambda p, v: np.full_like(v, 0.5) if p[-1].key == "layer_scale" else v,
            variables["params"])
    pm = carry(make_port(), variables, fill)
    out, stats, got = run_both(jm, variables, pm, (jnp.asarray(x), jnp.asarray(MASK)),
                               (torch.from_numpy(x), torch.from_numpy(MASK)), train,
                               dict(train=train))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert_stats_match(pm, variables, stats, fill)


def test_drop_path_rates_and_masks():
    """Rates rise linearly to the rate at the last block (JAX's ladder);
    in training a sample's branch is dropped whole or kept and scaled; eval
    and rate 0 pass it through."""
    net = SparseConvNeXt(3, 6, hidden_depths=(2, 1, 2, 1), drop_path_rate=0.3)
    rates = [b.drop_path.rate for s in net.stages for b in s.blocks]
    np.testing.assert_allclose(rates, [0.3 * i / 5 for i in range(6)])
    drop = DropPath(0.5).train()
    x = torch.ones(64, 3, 2, 4)
    torch.manual_seed(0)
    y = drop(x)
    kept = y.flatten(1).amax(1)
    assert set(kept.tolist()) == {0.0, 2.0} and (y.flatten(1).amin(1) == kept).all()
    assert torch.equal(drop.eval()(x), x) and torch.equal(DropPath(0.0).train()(x), x)


@pytest.mark.parametrize("family", ["sparse", "convnext", "fcnn"])
def test_train_step_matches_jax(family, synthetic_file):
    check_train_steps(synthetic_file, family, 1, 0.5, 0.0)
