"""The port's general COO convolution against the JAX package's.

``build_conv_maps`` (the native engine) and ``build_conv_maps_numpy`` give
the JAX package's ``build_conv_maps_numpy`` arrays, array for array, for
kernels 1-7 at strides 1 and 2, with and without ``pad_to``.
``coo_conv_apply`` matches JAX's forward and its gradients in the features
and the weights (``rtol=1e-5, atol=1e-6``: at most 49 products a sum, in
other orders), and the port's occupancy-masked ``sparse_conv`` on the same
weights (the JAX package's bound between its two engines, ``1e-5``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.ops.coo_conv import build_conv_maps_numpy as jax_build_maps
from dune_transformercvn_tpu.ops.coo_conv import coo_conv_apply as jax_coo_conv_apply
from dune_transformercvn_torch.ops import (ConvMaps, build_conv_maps, build_conv_maps_numpy,
                                           coo_conv_apply)
from dune_transformercvn_torch.ops.sparse import SparseGrid, sparse_conv

TOL = dict(rtol=1e-5, atol=1e-6)
ENGINE_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(k, s) for k in range(1, 8) for s in (1, 2)]


def random_sites(seed, n=3, h=14, w=11, occupancy=0.15):
    rng = np.random.default_rng(seed)
    occupied = rng.uniform(size=(n, h, w)) < occupancy
    return np.argwhere(occupied).astype(np.int64), occupied, rng


@pytest.mark.parametrize("pad_to", [0, 300])
@pytest.mark.parametrize("kernel,stride", CASES)
def test_maps_match_jax(kernel, stride, pad_to):
    coords, _, _ = random_sites(kernel * 10 + stride)
    want = jax_build_maps(coords, kernel, stride, 14, 11, pad_to)
    for got in (build_conv_maps(coords, kernel, stride, 14, 11, pad_to),
                build_conv_maps_numpy(coords, kernel, stride, 14, 11, pad_to)):
        assert isinstance(got, ConvMaps) and got.num_out == want.num_out
        for field in ("out_coords", "in_maps", "out_maps"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert got.in_maps.shape[1] >= max(pad_to, 1)


def test_maps_of_no_sites():
    empty = np.zeros((0, 3), np.int64)
    for got in (build_conv_maps(empty, 3, 1, 8, 8), build_conv_maps_numpy(empty, 3, 1, 8, 8)):
        want = jax_build_maps(empty, 3, 1, 8, 8)
        assert got.num_out == 0 and got.in_maps.shape == want.in_maps.shape == (9, 1)
        np.testing.assert_array_equal(got.out_maps, want.out_maps)


def apply_jax(features, weights, maps, cotangent):
    fn = jax.jit(jax_coo_conv_apply, static_argnames="num_out")
    args = (jnp.asarray(maps.in_maps), jnp.asarray(maps.out_maps))

    def loss(f, w):
        return (fn(f, w, *args, num_out=maps.num_out) * cotangent).sum()

    out = fn(jnp.asarray(features), jnp.asarray(weights), *args, num_out=maps.num_out)
    grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(features), jnp.asarray(weights))
    return [np.asarray(x) for x in (out, *grads)]


def apply_port(features, weights, maps, cotangent):
    f = torch.tensor(features, requires_grad=True)
    w = torch.tensor(weights, requires_grad=True)
    out = coo_conv_apply(f, w, torch.from_numpy(maps.in_maps), torch.from_numpy(maps.out_maps),
                         maps.num_out)
    (out * torch.from_numpy(cotangent)).sum().backward()
    return [x.detach().numpy() for x in (out, f.grad, w.grad)]


@pytest.mark.parametrize("kernel,stride", [(1, 1), (2, 2), (3, 1), (3, 2), (5, 1), (7, 2)])
def test_apply_matches_jax(kernel, stride):
    """Forward and both gradients, with ``pad_to`` padding pairs."""
    coords, _, rng = random_sites(kernel + stride)
    maps = build_conv_maps(coords, kernel, stride, 14, 11, pad_to=160)
    features = rng.normal(size=(len(coords), 5)).astype(np.float32)
    weights = rng.normal(size=(kernel, kernel, 5, 4)).astype(np.float32)
    cotangent = rng.normal(size=(maps.num_out, 4)).astype(np.float32)
    got = apply_port(features, weights, maps, cotangent)
    want = apply_jax(features, weights, maps, cotangent)
    assert got[0].shape == (maps.num_out, 4)
    for name, a, b in zip(("output", "features grad", "weights grad"), got, want):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (1, 1), (3, 2), (7, 2), (2, 2)])
def test_apply_matches_sparse_conv(kernel, stride):
    """The gather-scatter engine and the occupancy-masked dense one are the
    same operator: each output row equals the dense output at its site, and
    the sites are the dense engine's occupancy."""
    coords, occupied, rng = random_sites(40 + kernel * 3 + stride, n=2, h=12, w=10)
    dense = rng.normal(size=(2, 12, 10, 3)).astype(np.float32) * occupied[..., None]
    weights = rng.normal(size=(kernel, kernel, 3, 4)).astype(np.float32)
    want = sparse_conv(SparseGrid(torch.from_numpy(dense), torch.from_numpy(occupied)),
                       torch.from_numpy(weights).permute(3, 2, 0, 1), stride)
    maps = build_conv_maps(coords, kernel, stride, 12, 10)
    got = coo_conv_apply(torch.from_numpy(dense[occupied]), torch.from_numpy(weights),
                         torch.from_numpy(maps.in_maps), torch.from_numpy(maps.out_maps),
                         maps.num_out)
    owner, x, y = maps.out_coords.T
    np.testing.assert_allclose(got.numpy(), want.features.numpy()[owner, x, y], **ENGINE_TOL)
    sites = np.zeros(want.occupancy.shape, bool)
    sites[owner, x, y] = True
    np.testing.assert_array_equal(sites, want.occupancy.numpy())
