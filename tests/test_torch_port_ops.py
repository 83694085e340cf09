"""The port's ops against the JAX package's, on the CPU.

Kernel K1's plain version (``densify_images_plain``, which ``densify_images``
takes for CPU tensors) against the JAX XLA scatter and against the Pallas
kernel in interpret mode, plain and space-to-depth layout, with the edge
cases of ``tests/test_ops.py``; ``pack_rows`` / ``pad_rows`` with padded
slots; ``MaskedBatchNorm`` and ``PReLU``.  Inputs come from numpy with a
seed.  Tolerances: the densify sums the same float32 values in the same
order on both sides, so it is exact (``rtol=1e-6``); BN reduces over a batch
in another order in XLA and in torch, so ``rtol=atol=1e-5``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.ops import masked as jax_masked
from dune_transformercvn_tpu.ops import scatter as jax_scatter
from dune_transformercvn_tpu.ops.pallas_densify import densify_images_pallas
from dune_transformercvn_torch.ops import densify as port_densify
from dune_transformercvn_torch.ops.masked import MaskedBatchNorm, PReLU
from dune_transformercvn_torch.ops.scatter import densify_images, pack_rows, pad_rows

torch.set_num_threads(1)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)


def edge_case_bank(C, H, W, counts, R, seed):
    """Owner-sorted bank with a duplicate pixel, x/y out of range and
    negative, a far-corner hit, an empty image and padding rows."""
    rng = np.random.default_rng(seed)
    N = len(counts)
    owner = np.repeat(np.arange(N), counts).astype(np.int32)
    n = owner.size
    xy = np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], 1).astype(np.int32)
    xy[1] = xy[0]                            # duplicate pixel -> accumulate
    xy[2] = (H + 4, 2)                       # out-of-range x -> dropped
    xy[3] = (3, W + 5)                       # out-of-range y -> dropped
    xy[5] = (-2, 4)                          # negative x -> dropped
    xy[6] = (7, -1)                          # negative y -> dropped
    xy[7] = (H - 1, W - 1)                   # far corner -> kept
    xy_full = np.concatenate([xy, rng.integers(0, H, (R - n, 2)).astype(np.int32)])
    owner_full = np.concatenate([owner, np.full(R - n, N, np.int32)])
    vals = rng.normal(size=(R, C)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return xy_full, vals, owner_full, starts


@pytest.mark.parametrize("space_to_depth", [False, True])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_densify_matches_xla_scatter_and_pallas(C, space_to_depth):
    N, H, W, R = 3, 16, 12, 24
    xy, vals, owner, starts = edge_case_bank(C, H, W, [6, 0, 9], R, seed=C)

    ref_xla = jax.jit(partial(
        jax_scatter.densify_images, num_images=N, height=H, width=W,
        space_to_depth=space_to_depth,
    ))(jnp.asarray(xy), jnp.asarray(vals), jnp.asarray(owner))
    ref_pallas = densify_images_pallas(
        jnp.asarray(xy), jnp.asarray(vals), jnp.asarray(starts), N, H, W,
        space_to_depth=space_to_depth, interpret=True,
    )
    out = densify_images(
        torch.from_numpy(xy), torch.from_numpy(vals), torch.from_numpy(owner),
        N, H, W, starts=torch.from_numpy(starts), space_to_depth=space_to_depth,
    )
    want = (N, H // 2, W // 2, 4 * C) if space_to_depth else (N, H, W, C)
    assert tuple(out.shape) == want and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_xla), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_pallas), rtol=1e-6)


def test_densify_drops_negative_owner_and_all_padding():
    """A negative owner is dropped, not wrapped to the last image; an empty
    or all-padding bank gives zero images."""
    H, W = 8, 6
    xy = np.array([[1, 2], [3, 4], [5, 1]], np.int32)
    vals = np.array([[1.0], [2.0], [4.0]], np.float32)
    owner = np.array([-1, 1, 2], np.int32)               # 2 == num_images: pad
    ref = jax.jit(partial(jax_scatter.densify_images, num_images=2, height=H,
                          width=W))(jnp.asarray(xy), jnp.asarray(vals), jnp.asarray(owner))
    out = densify_images(torch.from_numpy(xy), torch.from_numpy(vals),
                         torch.from_numpy(owner), 2, H, W)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.sum().item() == 2.0 and out[1, 3, 4, 0].item() == 2.0
    empty = densify_images(torch.zeros((0, 2), dtype=torch.int32),
                           torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int32),
                           2, H, W)
    assert tuple(empty.shape) == (2, H, W, 3) and not empty.any()


def test_densify_bf16_accumulates_in_bf16_like_jax():
    """On the production path the values are bf16 before densify; duplicates
    sum in bf16, in bank order, on both sides."""
    rng = np.random.default_rng(11)
    xy = np.tile(np.array([[2, 3]], np.int32), (7, 1))
    vals = rng.uniform(0.06, 1.0, (7, 3)).astype(np.float32)
    owner = np.zeros(7, np.int32)
    ref = jax.jit(partial(jax_scatter.densify_images, num_images=1, height=4,
                          width=5))(jnp.asarray(xy), jnp.asarray(vals, jnp.bfloat16),
                                    jnp.asarray(owner))
    out = densify_images(torch.from_numpy(xy), torch.from_numpy(vals).bfloat16(),
                         torch.from_numpy(owner), 1, 4, 5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def test_densify_rejects_odd_space_to_depth_and_cpu_kernel_call():
    xy = torch.zeros((1, 2), dtype=torch.int32)
    vals, owner = torch.ones((1, 3)), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="even"):
        densify_images(xy, vals, owner, 1, 5, 4, space_to_depth=True)
    with pytest.raises(ValueError, match="CUDA"):
        port_densify.densify_images_cuda(
            xy, vals, torch.tensor([0, 1], dtype=torch.int32), 1, 4, 4)
    assert port_densify.densify_images_cuda.launches == 0


@pytest.mark.parametrize("shape,want", [
    ((400, 280, 3), (14, 280)),      # production NHWC: 14 whole rows
    ((200, 140, 12), (7, 140)),      # production space-to-depth
    ((5, 3, 1), (5, 3)),             # whole image in one tile
    ((400, 280, 768), (1, 16)),      # one-hot pixels: a band of columns
])
def test_kernel_tile_fits_shared_memory(shape, want):
    rows, cols = port_densify.tile_shape(*shape)
    assert (rows, cols) == want
    assert rows * cols * shape[2] <= port_densify.TILE_FLOATS


def test_kernel_tile_rejects_too_many_channels():
    with pytest.raises(ValueError, match="channels"):
        port_densify.tile_shape(4, 4, port_densify.TILE_FLOATS + 1)


def slot_maps():
    """Packed slots for B=3 events with 2, 0 and 3 prongs, then padding."""
    B, L = 3, 4
    slot_batch = np.array([0, 0, 2, 2, 2, B, B, B], np.int32)
    slot_pos = np.array([0, 1, 0, 1, 2, 0, 0, 0], np.int32)
    return B, L, slot_batch, slot_pos


def test_pack_rows_matches_jax_clipping():
    B, L, slot_batch, slot_pos = slot_maps()
    data = np.random.default_rng(0).normal(size=(B, L, 5)).astype(np.float32)
    ref = jax.jit(jax_scatter.pack_rows)(
        jnp.asarray(data), jnp.asarray(slot_batch), jnp.asarray(slot_pos))
    out = pack_rows(torch.from_numpy(data), torch.from_numpy(slot_batch),
                    torch.from_numpy(slot_pos))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out[-1].numpy(), data[B - 1, 0])   # pads read row B-1


@pytest.mark.parametrize("negative", [False, True])
def test_pad_rows_matches_jax_drop(negative):
    B, L, slot_batch, slot_pos = slot_maps()
    if negative:   # JAX wraps a negative index once before dropping
        slot_batch = slot_batch.copy()
        slot_batch[4] = -1
        slot_pos = slot_pos.copy()
        slot_pos[1] = -3
    packed = np.random.default_rng(1).normal(size=(len(slot_batch), 6)).astype(np.float32)
    ref = jax.jit(partial(jax_scatter.pad_rows, batch_size=B, max_length=L))(
        jnp.asarray(packed), jnp.asarray(slot_batch), jnp.asarray(slot_pos))
    out = pad_rows(torch.from_numpy(packed), torch.from_numpy(slot_batch),
                   torch.from_numpy(slot_pos), B, L)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not out[1].any()                                          # no prongs


# ---------------------------------------------------------------------------
# masked batch-norm and PReLU
# ---------------------------------------------------------------------------


def bn_state(rng, C):
    return dict(
        scale=rng.uniform(0.5, 1.5, C).astype(np.float32),
        bias=rng.normal(size=C).astype(np.float32),
        mean=rng.normal(size=C).astype(np.float32),
        var=rng.uniform(0.5, 2.0, C).astype(np.float32),
    )


def port_bn(state):
    bn = MaskedBatchNorm(len(state["scale"]))
    bn.load_state_dict({
        "weight": torch.from_numpy(state["scale"]),
        "bias": torch.from_numpy(state["bias"]),
        "running_mean": torch.from_numpy(state["mean"]),
        "running_var": torch.from_numpy(state["var"]),
    })
    return bn


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "sample", "site", "empty"])
def test_masked_batchnorm_matches_jax(train, mask_kind):
    rng = np.random.default_rng(5)
    C = 6
    x = rng.normal(2.0, 3.0, size=(5, 4, 3, C)).astype(np.float32)
    mask = {
        "none": None,
        "sample": np.array([1, 0, 1, 1, 0], bool),
        "site": rng.random((5, 4, 3)) < 0.6,
        "empty": np.zeros(5, bool),
    }[mask_kind]
    state = bn_state(rng, C)
    variables = {
        "params": {"scale": state["scale"], "bias": state["bias"]},
        "batch_stats": {"mean": state["mean"], "var": state["var"]},
    }
    module = jax_masked.MaskedBatchNorm(C)
    jmask = None if mask is None else jnp.asarray(mask)
    y_ref, updated = jax.jit(partial(
        module.apply, use_running_average=not train, mutable=["batch_stats"],
    ))(variables, jnp.asarray(x), jmask)

    bn = port_bn(state).train(train)
    y = bn(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **MODULE_TOL)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **MODULE_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **MODULE_TOL)
    if mask_kind == "empty" or not train:   # stats untouched
        np.testing.assert_array_equal(bn.running_mean.numpy(), state["mean"])
        np.testing.assert_array_equal(bn.running_var.numpy(), state["var"])


def test_masked_batchnorm_keeps_input_dtype():
    bn = MaskedBatchNorm(4).eval()
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert bn(x).dtype == torch.bfloat16
    bn.train()
    assert bn(x, torch.tensor([True, False, True])).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prelu_matches_jax(dtype):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 3, 7)).astype(np.float32)
    alpha = rng.uniform(-0.5, 0.5, 7).astype(np.float32)
    ref = jax.jit(jax_masked.PReLU(7).apply)(
        {"params": {"alpha": alpha}}, jnp.asarray(x, dtype))
    mod = PReLU(7)
    mod.load_state_dict({"weight": torch.from_numpy(alpha)})
    out = mod(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-6, atol=1e-6)
