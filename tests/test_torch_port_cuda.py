"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip without one.  On the card, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the test suite's ``conftest.py`` sets up JAX, which the
GPU host does not have; this file imports no JAX).  Kernel K1 against its
plain version at small shapes with every edge case, in every dtype and
layout, the column-tiled path for wide rows, region borders at production
width, input checks, dispatch, and the tiny network on the card against the
CPU; kernel K2 (the coo stem's scatter) against its plain version forward
and backward, where tiles meet, its binning pass against the plain binning,
its input checks, and the coo network on the card against the CPU.  The
Trainer lands on the card when no device is given, and a train state it
checkpoints restores onto the card bit for bit.
"""

import numpy as np
import pytest
import torch

from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from dune_transformercvn_torch.ops import coo_stem as k2
from dune_transformercvn_torch.ops import densify as k1
from dune_transformercvn_torch.ops.coo_conv import coo_stem_conv
from dune_transformercvn_torch.ops.scatter import densify_images
from dune_transformercvn_torch.train import Trainer
from dune_transformercvn_torch.train.checkpoint import to_host

pytestmark = pytest.mark.cuda

# float32: duplicates summed in bank order on both sides.  bfloat16: the
# kernel rounds after every add, the plain version on the card once.
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
       torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def bank(C, H, W, counts, R, seed, device):
    rng = np.random.default_rng(seed)
    N = len(counts)
    owner = np.repeat(np.arange(N), counts).astype(np.int32)
    n = owner.size
    xy = np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], 1).astype(np.int32)
    xy[1] = xy[0]                            # duplicate pixel
    xy[2] = (H + 4, 2)                       # x out of range
    xy[3] = (3, W + 5)                       # y out of range
    xy[5] = (-2, 4)                          # negative x
    xy[6] = (7, -1)                          # negative y
    xy[7] = (H - 1, W - 1)                   # far corner
    xy = np.concatenate([xy, rng.integers(0, H, (R - n, 2)).astype(np.int32)])
    owner = np.concatenate([owner, np.full(R - n, N, np.int32)])
    vals = rng.uniform(0.0, 1.0, (R, C)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (xy, vals, owner, starts)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("space_to_depth", [False, True])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_kernel_matches_plain(cuda, C, space_to_depth, dtype):
    N, H, W = 3, 16, 12
    xy, vals, owner, starts = bank(C, H, W, [40, 0, 90], 160, C, cuda)
    vals = vals.to(dtype)
    before = k1.densify_images_cuda.launches
    out = k1.densify_images_cuda(xy, vals, starts, N, H, W, space_to_depth)
    assert k1.densify_images_cuda.launches == before + 1
    ref = k1.densify_images_plain(xy, vals, owner, N, H, W, space_to_depth)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_kernel_tiles_columns_of_wide_rows(cuda):
    """768 channels (one-hot pixels): one row is over a block's region, so
    blocks own bands of columns."""
    N, H, W, C = 2, 6, 40, 768
    assert k1.region_shape(H, W, C) == (1, 21)
    xy, vals, owner, starts = bank(C, H, W, [30, 20], 64, 1, cuda)
    out = k1.densify_images_cuda(xy, vals, starts, N, H, W)
    ref = k1.densify_images_plain(xy, vals, owner, N, H, W)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


def edge_bank(H, W, region_rows, C, device):
    """Hits on region borders (the last row of one region, the first of the
    next), duplicates on a region corner, an image whose hits all fall in
    one region, an empty image, then padding rows."""
    r = region_rows
    xy = np.array([[r - 1, 5], [r, 5], [r - 1, W - 1], [r, 0],     # image 0: borders
                   [r - 1, 0], [r - 1, 0], [r, 1], [r - 1, 0],     # corner duplicates
                   [1, 2], [2, 3], [1, 2], [0, 0],                 # image 1: one region
                   [H - 1, W - 1], [H - 2, W - 2], [-1, 3]],       # image 3; image 2 empty
                  np.int32)
    xy = np.concatenate([xy, np.zeros((5, 2), np.int32)])         # padding rows
    owner = np.array([0] * 8 + [1] * 4 + [3] * 3 + [4] * 5, np.int32)
    starts = np.array([0, 8, 12, 12, 15], np.int32)
    vals = np.random.default_rng(C).uniform(0.0, 1.0, (len(xy), C)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (xy, vals, owner, starts)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("space_to_depth", [False, True])
def test_kernel_region_edges_at_production_width(cuda, space_to_depth, dtype):
    """400x280x3 images (12 channels in space-to-depth, neither a multiple
    of the 16-byte vector): K1 against its plain version on region borders,
    duplicates on a region corner, one region, an empty image."""
    H, W, C = 400, 280, 3
    shape = (H // 2, W // 2, 4 * C) if space_to_depth else (H, W, C)
    rows = k1.region_shape(*shape)[0] * (2 if space_to_depth else 1)
    xy, vals, owner, starts = edge_bank(H, W, rows, C, cuda)
    vals = vals.to(dtype)
    out = k1.densify_images_cuda(xy, vals, starts, 4, H, W, space_to_depth)
    ref = k1.densify_images_plain(xy, vals, owner, 4, H, W, space_to_depth)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert not out[2].any()


def test_kernel_checks_its_inputs(cuda):
    xy, vals, owner, starts = bank(3, 16, 12, [10, 10], 32, 2, cuda)
    with pytest.raises(ValueError, match="int32"):
        k1.densify_images_cuda(xy.long(), vals, starts, 2, 16, 12)
    with pytest.raises(ValueError, match="contiguous"):
        k1.densify_images_cuda(xy, vals.t().contiguous().t(), starts, 2, 16, 12)
    with pytest.raises(ValueError, match="starts"):
        k1.densify_images_cuda(xy, vals, starts[:-1], 2, 16, 12)
    with pytest.raises(ValueError, match="dtype"):
        k1.densify_images_cuda(xy, vals.double(), starts, 2, 16, 12)
    with pytest.raises(ValueError, match="starts"):
        densify_images(xy, vals, owner, 2, 16, 12)        # no CSR offsets


def test_densify_images_sends_cuda_tensors_to_the_kernel(cuda):
    xy, vals, owner, starts = bank(3, 16, 12, [10, 10], 32, 3, cuda)
    before = k1.densify_images_cuda.launches
    out = densify_images(xy, vals, owner, 2, 16, 12, starts=starts)
    assert k1.densify_images_cuda.launches == before + 1
    torch.testing.assert_close(out, k1.densify_images_plain(xy, vals, owner, 2, 16, 12),
                               **TOL[torch.float32])


def test_tiny_network_on_the_card_matches_the_cpu(cuda):
    """The tiny network, float32 with TF32 off, through K1 on the card and
    the plain densify on the CPU (cuDNN and oneDNN sum in other orders)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=8,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=2, num_prong_decoder_layers=2, num_attention_heads=4,
        densenet_structure=(2, 2), densenet_growth_rate=8, image_height=32,
        image_width=32, compute_dtype="float32", disable_smart_features=False)
    rng = np.random.default_rng(0)
    B, P, S = 2, 4, 32
    event = bank(3, S, S, [50, 60], 128, 4, "cpu")
    prong = bank(3, S, S, [20, 0, 30, 25], 96, 5, "cpu")
    batch = {
        "event_xy": event[0], "event_vals": event[1] * 255, "event_owner": event[2],
        "event_starts": event[3],
        "prong_xy": prong[0], "prong_vals": prong[1] * 255, "prong_owner": prong[2],
        "prong_starts": prong[3],
        "features": torch.from_numpy(rng.normal(size=(B, 20, 6)).astype(np.float32)),
        "extra": torch.from_numpy(rng.normal(size=(B, 4)).astype(np.float32)),
        "prong_mask": torch.from_numpy(np.arange(20) < np.array([[1], [3]])),
        "slot_batch": torch.tensor([0, 1, 1, 1], dtype=torch.int32),
        "slot_pos": torch.tensor([0, 0, 1, 2], dtype=torch.int32),
        "slot_mask": torch.ones(P, dtype=torch.bool),
    }
    norm = {"mean": torch.zeros(6), "std": torch.ones(6),
            "extra_mean": torch.tensor(0.0), "extra_std": torch.tensor(1.0)}
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        want = model(batch, norm)
        model.to(cuda)
        got = model({k: v.to(cuda) for k, v in batch.items()},
                    {k: v.to(cuda) for k, v in norm.items()})
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K2: the coo stem's scatter
# ---------------------------------------------------------------------------

# float32 sums: the kernel adds in bank order, the plain index_add_ on the
# card with atomics in any order.  bfloat16 output: one rounding of sums
# that agree to float32 rounding, so at most one bf16 ulp apart.
K2_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}


def stem_inputs(H, W, counts, C_out, R, seed, device):
    xy, vals, owner, starts = bank(3, H, W, counts, R, seed, device)
    rng = np.random.default_rng(seed + 100)
    kernel = torch.from_numpy(0.1 * rng.normal(size=(7, 7, 3, C_out)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=C_out).astype(np.float32))
    return xy, vals, owner, starts, kernel.to(device), bias.to(device)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_out", [16, 64, 128])
def test_coo_stem_kernel_matches_plain(cuda, C_out, out_dtype):
    H, W = 37, 29                       # odd sizes: the stride-2 border
    xy, vals, owner, starts, kernel, bias = stem_inputs(H, W, [40, 0, 90], C_out, 160,
                                                        C_out, cuda)
    patches = k2.stem_patches(xy, vals, kernel, H, W)
    before = k2.scatter_patches_cuda.launches
    out = k2.scatter_patches_cuda(patches, xy, starts, bias, 3, H, W, out_dtype)
    assert k2.scatter_patches_cuda.launches == before + 1
    ref = k2.scatter_patches_plain(patches, xy, starts, bias, 3, H, W, out_dtype)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (3, 19, 15, C_out) and out.dtype == out_dtype
    torch.testing.assert_close(out.float(), ref.float(), **K2_TOL[out_dtype])


def stem_edge_inputs(C_out, device):
    """48x100 images (24x50 outputs: 6 x 2 tiles at C_out 64): windows that
    straddle two and four tiles, duplicates on a tile corner, an image whose
    hits all fall in one tile, an empty image, one whose hits are all off
    the grid, then padding rows."""
    xy = np.array([[14, 62], [14, 10], [3, 62],                      # image 0: straddles
                   [15, 63], [15, 63], [14, 62], [15, 63],           # corner duplicates
                   [18, 20], [19, 21], [18, 20],                     # image 1: one tile
                   [-1, 5], [52, 5], [5, 100],                       # image 3: off the grid
                   [47, 99], [0, 0]], np.int32)                      # image 4
    xy = np.concatenate([xy, np.zeros((5, 2), np.int32)])
    owner = np.array([0] * 7 + [1] * 3 + [3] * 3 + [4] * 2 + [5] * 5, np.int32)
    starts = np.array([0, 7, 10, 10, 13, 15], np.int32)
    rng = np.random.default_rng(C_out)
    vals = rng.uniform(0.0, 1.0, (len(xy), 3)).astype(np.float32)
    kernel = 0.1 * rng.normal(size=(7, 7, 3, C_out)).astype(np.float32)
    bias = rng.normal(size=C_out).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (xy, vals, owner, starts, kernel, bias)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_out", [12, 64])
def test_coo_stem_kernel_tile_edges(cuda, C_out, out_dtype):
    """K2 against its plain version where tiles meet (C_out 12: channels not
    a multiple of the 8-wide vector); the untouched images are the bias."""
    H, W, N = 48, 100, 5
    xy, vals, owner, starts, kernel, bias = stem_edge_inputs(C_out, cuda)
    patches = k2.stem_patches(xy, vals, kernel, H, W)
    out = k2.scatter_patches_cuda(patches, xy, starts, bias, N, H, W, out_dtype)
    ref = k2.scatter_patches_plain(patches, xy, starts, bias, N, H, W, out_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **K2_TOL[out_dtype])
    for i in (2, 3):
        assert torch.equal(out[i], bias.to(out_dtype).expand_as(out[i]))


@pytest.mark.parametrize("C_out", [12, 64, 128])
def test_coo_stem_binning_matches_plain(cuda, C_out):
    """K2's binning kernel against its plain version: the same bins, and the
    same bank-ordered hit lists."""
    xy, _, _, starts, _, _ = stem_edge_inputs(C_out, cuda)
    big = bank(3, 400, 280, [160, 0, 90, 3], 300, C_out, cuda)
    for xy_, starts_, n, H, W in ((xy, starts, 5, 48, 100), (big[0], big[3], 4, 400, 280)):
        bins, entries = k2.bin_hits_cuda(xy_, starts_, n, H, W, C_out)
        want_bins, want_entries = k2.bin_hits_plain(xy_, starts_, n, H, W, C_out)
        torch.cuda.synchronize()
        assert torch.equal(bins, want_bins)
        used = want_entries >= 0
        assert torch.equal(entries[used], want_entries[used])


def test_coo_stem_gradients_through_the_kernel(cuda):
    """``ScatterPatches`` with K2 forward against autograd of the plain
    stem, wrt values, weights and bias."""
    H, W = 48, 40
    xy, vals, owner, starts, kernel, bias = stem_inputs(H, W, [30, 12], 64, 64, 7, cuda)
    cot = torch.randn(2, 24, 20, 64, device=cuda)

    def grads(fn, device):
        args = [a.detach().to(device).clone().requires_grad_() for a in (vals, kernel, bias)]
        (fn(*args) * cot.to(device)).sum().backward()
        return [a.grad for a in args]

    got = grads(lambda v, k, b: k2.coo_stem_conv_cuda(xy, v, starts, k, b, 2, H, W), cuda)
    want = grads(lambda v, k, b: coo_stem_conv(xy.cpu(), v, owner.cpu(), k, b, 2, H, W),
                 "cpu")
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)
    assert float(got[0][42:].abs().max()) == 0.0      # padding rows


def test_coo_stem_kernel_checks_its_inputs(cuda):
    H, W = 16, 12
    xy, vals, owner, starts, kernel, bias = stem_inputs(H, W, [10, 10], 16, 32, 2, cuda)
    patches = k2.stem_patches(xy, vals, kernel, H, W)
    with pytest.raises(ValueError, match="int32"):
        k2.scatter_patches_cuda(patches, xy.long(), starts, bias, 2, H, W, torch.float32)
    with pytest.raises(ValueError, match="starts"):
        k2.scatter_patches_cuda(patches, xy, starts[:-1], bias, 2, H, W, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        k2.scatter_patches_cuda(patches, xy, starts, bias, 2, H, W, torch.float16)
    with pytest.raises(ValueError, match="starts"):
        coo_stem_conv(xy, vals, owner, kernel, bias, 2, H, W)       # no CSR offsets


def test_tiny_coo_network_on_the_card_matches_the_cpu(cuda):
    """The coo family through K2 on the card and the plain stem on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=16,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=2, num_prong_decoder_layers=2, num_attention_heads=4,
        densenet_structure=(2, 2), densenet_growth_rate=8, image_height=32,
        image_width=32, compute_dtype="float32", embedder="coo")
    rng = np.random.default_rng(1)
    B, P, S = 2, 4, 32
    event = bank(3, S, S, [50, 60], 128, 4, "cpu")
    prong = bank(3, S, S, [20, 0, 30, 25], 96, 5, "cpu")
    batch = {
        "event_xy": event[0], "event_vals": event[1] * 255, "event_owner": event[2],
        "event_starts": event[3],
        "prong_xy": prong[0], "prong_vals": prong[1] * 255, "prong_owner": prong[2],
        "prong_starts": prong[3],
        "features": torch.from_numpy(rng.normal(size=(B, 20, 6)).astype(np.float32)),
        "extra": torch.from_numpy(rng.normal(size=(B, 4)).astype(np.float32)),
        "prong_mask": torch.from_numpy(np.arange(20) < np.array([[1], [3]])),
        "slot_batch": torch.tensor([0, 1, 1, 1], dtype=torch.int32),
        "slot_pos": torch.tensor([0, 0, 1, 2], dtype=torch.int32),
        "slot_mask": torch.ones(P, dtype=torch.bool),
    }
    norm = {"mean": torch.zeros(6), "std": torch.ones(6),
            "extra_mean": torch.tensor(0.0), "extra_std": torch.tensor(1.0)}
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        want = model(batch, norm)
        model.to(cuda)
        before = k2.scatter_patches_cuda.launches
        got = model({k: v.to(cuda) for k, v in batch.items()},
                    {k: v.to(cuda) for k, v in norm.items()})
        assert k2.scatter_patches_cuda.launches == before + 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def tiny_trainer(run_dir, seed):
    """A Trainer with no device given, on 16 + 8 in-memory 48x40 events."""
    options = Options()
    options.update_options(dict(
        densenet_structure=[1, 1], densenet_growth_rate=8, initial_pixel_dim=8,
        pixel_embedding_dim=16, feature_embedding_dim=8, position_embedding_dim=8,
        hidden_dim=32, num_encoder_layers=1, num_prong_decoder_layers=2,
        num_attention_heads=4, dropout=0.1, pixel_noise_std=0.01, batch_size=4,
        compute_dtype="float32", num_dataloader_workers=2, verbose_output=False, seed=seed))
    datasets = (InMemoryEvents(16, 1, (48, 40)), InMemoryEvents(8, 2, (48, 40)), None)
    return Trainer(options, run_dir=run_dir, debug=run_dir is None, datasets=datasets)


def test_trainer_state_restores_onto_the_card_bit_equal(cuda, tmp_path):
    trainer = tiny_trainer(str(tmp_path), seed=0)
    assert trainer.device == cuda and next(trainer.state.model.parameters()).is_cuda
    before = k1.densify_images_cuda.launches
    trainer.fit(max_steps=2, eval_interval=100)           # checkpoints step_2
    assert k1.densify_images_cuda.launches == before + 2 * (2 + 2)
    want = to_host(trainer.state.state_dict())
    other = tiny_trainer(None, seed=3)
    other.resume(str(tmp_path / "checkpoints" / "step_2"))
    state = other.state
    assert next(state.model.parameters()).is_cuda
    assert all(v.is_cuda for v in state.norm.values())
    slots = [state.optimizer.state[p] for p in state.model.parameters()]
    assert all(s["exp_avg"].is_cuda and not s["step"].is_cuda for s in slots)
    got = to_host(state.state_dict())
    assert got["step"] == want["step"] == 2
    for name, tensor in want["model"].items():
        assert torch.equal(got["model"][name], tensor), name
    for index, slot in want["optimizer"]["state"].items():
        for key, tensor in slot.items():
            assert torch.equal(got["optimizer"]["state"][index][key], tensor), (index, key)
    for key, tensor in want["norm"].items():
        assert torch.equal(got["norm"][key], tensor), key
    assert torch.equal(got["generator"], want["generator"])


def test_trainer_batches_come_from_pinned_memory(cuda):
    """The Trainer's host batches are pinned on the batcher's threads, so the
    copy one step ahead does not wait for the stream."""
    trainer = tiny_trainer(None, seed=0)
    want = list(trainer.train_batcher.epoch(0))
    host = list(trainer._host_batches(trainer.train_batcher, 0))
    assert len(host) == len(want) == 4
    assert all(v.is_pinned() for batch in host for v in batch.values())
    for got, ref in zip(trainer._device_prefetch(iter(host)), want):
        assert got.keys() == ref.keys()
        for key, tensor in got.items():
            assert tensor.is_cuda
            np.testing.assert_array_equal(tensor.cpu().numpy(), ref[key])
