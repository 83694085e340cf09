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
checkpoints restores onto the card bit for bit.  Each of the other families'
tiny networks on the card against the CPU (K1 twice a forward), sdxl's
chunked embedder on the card against its full bank (forward and
gradients, with the save-spatial policy too), and the sparse-grid ops on
the card against the CPU.  K1 at 768 channels (one-hot pixels) at
production width, the general COO convolution on the card against
``sparse_conv``, and one lamb step on the card against the CPU.  An
AOTInductor package compiled for the card against the eager graph, and the
C++ loader with ``--device cuda`` against the package; one tensor-parallel
train step of 2 ranks over ``gloo`` on the one card against a world of one.
``torch.library.opcheck`` on the kernels' custom ops with CUDA tensors, and
the tiny dense and coo networks' compiled predict and train steps
(``compile=True``) against the eager ones, K1 or K2 inside the graphs.
CUDA graphs (``graph=True``): a captured K = 2 train step against eager
steps, the predict graph against eager, K1's launches in a replay read by
the profiler.  The memory recipes and the chains in one dispatch: captured
K = 2 steps with ``remat_cnn`` and ``remat_embedder`` (dense; coo, whose
recompute launches K2 again) and with lamb against eager, the compiled
``remat_cnn`` step against eager, and the optimizers' float32 bias
correction on the card against the CPU's.  On 2 cards, the data-parallel
graph step over nccl against the eager data-parallel step, and the graph
Trainer's fit (validations included) and ``predict_split`` against their
eager runs, bit for bit.  Serving in one dispatch: each exported rung
captured as one CUDA graph (``load_exported(..., graph=True)``) against its
program, and each package captured (``load_package(..., graph=True)``)
against the package, bit for bit, on events other than the one captured;
the meta's ``graph_bucket_ms`` and ``aoti_graph_bucket_ms``; the C++
loader's ``--graph`` (rung picked on the graph costs) against the package.
int8 in one dispatch: ``predict_split(graph=True)`` inside the context
against the eager int8 pass bit for bit, the ``_int_mm`` route's launches
counted per replay and K1 twice a batch; the compiled int8 step within
1e-3 (and the same argmax) of eager int8.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

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
    """The op ``tcvn::coo_stem_scatter`` with K2 forward against autograd of the plain
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


# ---------------------------------------------------------------------------
# the families beyond dense and coo
# ---------------------------------------------------------------------------

FAMILY_SHAPES = {"sdxl": (400, 280), "sparse": (48, 40), "convnext": (48, 40),
                 "fcnn": (48, 40), "mobilenet": (48, 40), "resnet": (48, 40)}


@pytest.mark.parametrize("family", sorted(FAMILY_SHAPES))
def test_family_network_on_the_card_matches_the_cpu(cuda, family):
    """Each family's tiny network, float32 with TF32 off, train mode (batch
    statistics), through K1 on the card and the plain densify on the CPU;
    sdxl in chunks of 2."""
    from dune_transformercvn_torch.data import Batcher
    from dune_transformercvn_torch.predict import to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = FAMILY_SHAPES[family]
    cfg = ModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=4 if family == "sdxl" else 8,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=1, num_prong_decoder_layers=2, num_attention_heads=4,
        densenet_structure=(2, 2), densenet_growth_rate=8,
        mobilenet_structure=((1, 8, 1, 1), (6, 16, 2, 2)), image_height=shape[0],
        image_width=shape[1], compute_dtype="float32", embedder=family,
        embedder_chunk=2 if family == "sdxl" else 0, dropout=0.0, pixel_noise_std=0.0)
    ds = InMemoryEvents(4, 3, shape)
    batch = Batcher(ds, batch_size=4).build_batch(np.arange(4))
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(1)).train()
    before = k1.densify_images_cuda.launches
    with torch.no_grad():
        want = model(to_device(batch, "cpu"), to_device(ds.norm(), "cpu"))
        model.to(cuda)
        got = model(to_device(batch, cuda), to_device(ds.norm(), cuda))
    assert k1.densify_images_cuda.launches == before + 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)


def test_sdxl_chunks_on_the_card_equal_the_full_bank(cuda):
    """Forward and gradients of the sdxl embedder in chunks of 2, with and
    without the save-spatial policy, against one full-bank call on the card."""
    from dune_transformercvn_torch.models.network import apply_embedder
    from dune_transformercvn_torch.models.sdxl import SDXLEncoder

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    cnn = SDXLEncoder(3, 8, 4).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.rand(6, 400, 280, 3, device=cuda, generator=gen) < 0.02).float()

    def run(**kwargs):
        cnn.zero_grad()
        out = apply_embedder(cnn, x, None, **kwargs)
        (out * torch.linspace(-1, 1, out.numel(), device=cuda).reshape(out.shape)).sum().backward()
        return out.detach(), [p.grad.clone() for p in cnn.parameters()]

    full = run()
    for kwargs in (dict(chunk=2), dict(chunk=2, save_spatial=100)):
        out, grads = run(**kwargs)
        torch.testing.assert_close(out, full[0], rtol=1e-4, atol=1e-5)
        for g, w in zip(grads, full[1]):
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (2, 2), (7, 2), (4, 4)])
def test_sparse_ops_on_the_card_match_the_cpu(cuda, kernel, stride):
    from dune_transformercvn_torch.ops import sparse

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(kernel + stride)
    occupancy = torch.rand(3, 37, 29, generator=gen) < 0.1
    features = torch.randn(3, 37, 29, 8, generator=gen) * occupancy[..., None]
    weight = torch.randn(16, 8, kernel, kernel, generator=gen) / kernel
    cpu = sparse.SparseGrid(features, occupancy)
    card = sparse.SparseGrid(features.to(cuda), occupancy.to(cuda))
    for op in (lambda g: sparse.sparse_conv(g, weight.to(g.features.device), stride),
               lambda g: sparse.sparse_avg_pool(g, kernel, stride)):
        want, got = op(cpu), op(card)
        assert torch.equal(got.occupancy.cpu(), want.occupancy)
        torch.testing.assert_close(got.features.cpu(), want.features, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sparse.sparse_global_avg_pool(card).cpu(),
                               sparse.sparse_global_avg_pool(cpu), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# export and the serving variants: int8, export, folding
# ---------------------------------------------------------------------------

# (N, H, W, C_in, C_out, kernel, stride, padding): k = C_in * kernel^2 not a
# multiple of 8 (147, 9 * 13, 35) and m <= 16 among them
INT8_SHAPES = [(2, 19, 13, 3, 16, 7, 2, 3), (3, 11, 9, 13, 20, 3, 1, 1),
               (1, 3, 4, 35, 8, 1, 1, 0), (2, 16, 12, 64, 32, 3, 2, 0),
               (4, 10, 7, 322, 226, 1, 1, 0)]


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int_mm_route_equals_plain_route(cuda, shape):
    """The card's im2col + ``torch._int_mm`` route gives the plain float64
    route's int32 sums bit for bit (both are exact)."""
    from dune_transformercvn_torch.ops import quant

    n, h, w, cin, cout, k, stride, padding = shape
    gen = torch.Generator().manual_seed(sum(shape))
    qx = torch.randint(-127, 128, (n, h, w, cin), generator=gen, dtype=torch.int8)
    qw = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8)
    before = quant.conv_int32_cuda.launches
    got = quant.conv_int32_cuda(qx.to(cuda), qw.to(cuda), stride, padding)
    assert quant.conv_int32_cuda.launches == before + 1
    want = quant.conv_int32_plain(qx, qw, stride, padding)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def tiny_serving_model(cuda_device=None):
    cfg = ModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=8,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=1, num_prong_decoder_layers=2, num_attention_heads=4,
        densenet_structure=(1, 1), densenet_growth_rate=8, image_height=32,
        image_width=32, compute_dtype="float32", features_dim=6, extra_dim=4)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(2)).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, buffer in model.named_buffers():
            buffer.copy_(torch.rand(buffer.shape, generator=gen) + 0.5)
    return model


def test_exported_artifact_runs_on_the_card(cuda, tmp_path):
    from dune_transformercvn_torch.export import (build_inference_fn, export_model,
                                                  load_exported)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tiny_serving_model().to(cuda)
    norm = {"mean": np.zeros(6, np.float32), "std": np.ones(6, np.float32),
            "extra_mean": np.float32(0.0), "extra_std": np.float32(1.0)}
    paths = export_model(model, norm, str(tmp_path), prong_buckets=(4,), bench_buckets=True)
    meta = (tmp_path / "transformercvn_export_meta.json").read_text()
    assert '"platforms": [\n    "cuda"\n  ]' in meta and '"bucket_ms_platform": "cuda"' in meta
    gen = torch.Generator().manual_seed(4)
    pixels = ((torch.rand(21, 3, 32, 32, generator=gen) < 0.05) * 200.0).to(cuda)
    n = torch.tensor(3, dtype=torch.int32, device=cuda)
    got = load_exported(paths["combined"])(pixels, n)
    with torch.no_grad():
        want = build_inference_fn(model, "combined", norm)(pixels, n)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g, w, rtol=0.0, atol=1e-6)


def test_folding_on_the_card_equals_the_cpu(cuda):
    """The fold on the card against the fold on the CPU, float32, within the
    bound the CPU tests hold it to JAX's (rtol 1e-6, atol 1e-7): the card's
    and the host's float32 sqrt and divide may round a scale one ulp apart
    (on an H100 some do)."""
    from dune_transformercvn_torch.ops.fold import fold_eval_batchnorm

    sd = tiny_serving_model().state_dict()
    want, n = fold_eval_batchnorm(sd)
    got, n_card = fold_eval_batchnorm({k: v.to(cuda) for k, v in sd.items()})
    assert n == n_card == 6
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].device.type == "cuda"
        torch.testing.assert_close(got[key].cpu(), value, rtol=1e-6, atol=1e-7, msg=key)


def test_kernel_at_768_channels_matches_plain(cuda):
    """K1 on one-hot pixels (768 channels, bfloat16) at production width:
    values 0 and 1 and duplicates sum to small integers, exact in bf16."""
    N, H, W, C = 2, 400, 280, 768
    xy, _, owner, starts = bank(C, H, W, [160, 60], 256, 8, cuda)
    rng = np.random.default_rng(9)
    hot = np.zeros((256, C), np.float32)
    for c in range(3):
        hot[np.arange(256), 256 * c + rng.integers(0, 256, 256)] = 1.0
    vals = torch.from_numpy(hot).to(cuda, torch.bfloat16)
    out = k1.densify_images_cuda(xy, vals, starts, N, H, W, False)
    ref = k1.densify_images_plain(xy, vals, owner, N, H, W, False)
    assert out.shape == (N, H, W, C) and out.dtype == torch.bfloat16
    assert torch.equal(out, ref)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (7, 2)])
def test_coo_conv_apply_on_the_card_matches_sparse_conv(cuda, kernel, stride):
    from dune_transformercvn_torch.ops import build_conv_maps, coo_conv_apply
    from dune_transformercvn_torch.ops.sparse import SparseGrid, sparse_conv

    rng = np.random.default_rng(kernel)
    occupied = rng.uniform(size=(2, 24, 20)) < 0.1
    dense = rng.normal(size=(2, 24, 20, 5)).astype(np.float32) * occupied[..., None]
    weights = rng.normal(size=(kernel, kernel, 5, 6)).astype(np.float32)
    maps = build_conv_maps(np.argwhere(occupied), kernel, stride, 24, 20, pad_to=400)
    features = torch.from_numpy(dense[occupied]).to(cuda).requires_grad_()
    w = torch.from_numpy(weights).to(cuda).requires_grad_()
    got = coo_conv_apply(features, w, torch.from_numpy(maps.in_maps).to(cuda),
                         torch.from_numpy(maps.out_maps).to(cuda), maps.num_out)
    want = sparse_conv(SparseGrid(torch.from_numpy(dense).to(cuda),
                                  torch.from_numpy(occupied).to(cuda)),
                       w.detach().permute(3, 2, 0, 1), stride)
    owner, x, y = torch.from_numpy(maps.out_coords).to(cuda).T
    torch.testing.assert_close(got, want.features[owner, x, y], rtol=1e-4, atol=1e-4)
    got.square().sum().backward()
    assert torch.isfinite(features.grad).all() and torch.isfinite(w.grad).all()


def test_lamb_step_on_the_card_matches_the_cpu(cuda):
    """One lamb step (per-leaf trust ratios over a packed q/k/v projection)
    on the card against the same step on the CPU."""
    from dune_transformercvn_torch.models import DecoderLayer
    from dune_transformercvn_torch.train import create_optimizer

    options = Options()
    options.update_options(dict(optimizer="lamb", learning_rate=1e-2, l2_penalty=0.1))
    results = []
    for device in ("cpu", cuda):
        model = DecoderLayer(16, 4, generator=torch.Generator().manual_seed(0)).to(device)
        optimizer = create_optimizer(options, model)
        for p in model.parameters():
            p.grad = torch.from_numpy(
                np.random.default_rng(p.numel()).normal(size=tuple(p.shape)).astype(
                    np.float32)).to(device)
        optimizer.step()
        results.append({n: p.detach().cpu() for n, p in model.named_parameters()})
    for name, want in results[0].items():
        torch.testing.assert_close(results[1][name], want, rtol=1e-6, atol=1e-7)


SERVING_NORM = {"mean": np.zeros(6, np.float32), "std": np.ones(6, np.float32),
                "extra_mean": np.float32(0.0), "extra_std": np.float32(1.0)}


@pytest.fixture(scope="module")
def card_packages(tmp_path_factory):
    """The tiny serving model on the card, its programs exported at the
    ladder (4, 20) with the bench, and their pid packages with theirs."""
    from dune_transformercvn_torch.aoti import package_run_dir
    from dune_transformercvn_torch.export import export_model

    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = tmp_path_factory.mktemp("card_packages")
    model = tiny_serving_model().to("cuda")
    programs = export_model(model, SERVING_NORM, str(out), prong_buckets=(4,),
                            bench_buckets=True)
    packages = package_run_dir(None, str(out), variants=("pid",), device="cuda", bench=True)
    return model, out, programs, packages


def serving_events(count, seed):
    gen = torch.Generator().manual_seed(seed)
    return [((torch.rand(21, 3, 32, 32, generator=gen) < 0.05) * 200.0) for _ in range(count)]


def test_captured_rungs_equal_their_programs(cuda, card_packages):
    """Each exported rung captured as one CUDA graph against its program,
    bit for bit, on events other than the one it was captured with; the
    meta has both rungs' eager and captured costs."""
    from dune_transformercvn_torch.export import load_exported

    _, out, programs, _ = card_packages
    meta = json.loads((out / "transformercvn_export_meta.json").read_text())
    assert sorted(meta["bucket_ms"]) == sorted(meta["graph_bucket_ms"]) == ["20", "4"]
    assert all(v > 0 for v in meta["graph_bucket_ms"].values())
    for key in ("pid", "pid_p4", "combined_p4"):
        capacity = 4 if key.endswith("_p4") else 20
        eager, graph = load_exported(programs[key]), load_exported(programs[key], graph=True)
        for i, pixels in enumerate(serving_events(3, 7)):
            rows = pixels[:1 + capacity].to(cuda)
            n = torch.tensor(min(3 + i, capacity), dtype=torch.int32, device=cuda)
            got, want = graph(rows, n), eager(rows, n)
            assert len(got) == len(want) and len(graph.graphs.graphs) == 1
            for g, w in zip(got, want):
                assert g.device.type == "cuda" and torch.equal(g, w), (key, i)


def test_captured_package_equals_the_package(cuda, card_packages):
    """Each pid package captured as one CUDA graph (loaded single-threaded,
    launching on the capturing stream) against the package run uncaptured,
    bit for bit, on events other than the captured one."""
    from dune_transformercvn_torch.aoti import load_package

    _, out, _, packages = card_packages
    meta = json.loads((out / "transformercvn_export_meta.json").read_text())
    assert sorted(meta["aoti_graph_bucket_ms"]) == ["20", "4"]
    for key, capacity in (("pid", 20), ("pid_p4", 4)):
        package = load_package(packages[key])
        graph = load_package(packages[key], graph=True)
        for i, pixels in enumerate(serving_events(3, 8)):
            rows = pixels[:1 + capacity].to(cuda)
            n = torch.tensor(min(2 + i, capacity), dtype=torch.int32, device=cuda)
            got, want = graph(rows, n), package(rows, n)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (key, i)
        assert len(graph.graphs.graphs) == 1


def test_aoti_package_and_loader_on_the_card(cuda, card_packages, tmp_path):
    from dune_transformercvn_torch.aoti import load_package
    from dune_transformercvn_torch.export import (build_inference_fn, select_bucket,
                                                  with_max_prongs)
    from dune_transformercvn_torch.utils.build import build_loader

    model, out, _, paths = card_packages
    norm = SERVING_NORM
    meta_path = out / "transformercvn_export_meta.json"
    meta = json.loads(meta_path.read_text())
    assert meta["aoti_platform"] == "cuda" and sorted(meta["aoti_bucket_ms"]) == ["20", "4"]
    gen = torch.Generator().manual_seed(4)
    pixels = ((torch.rand(21, 3, 32, 32, generator=gen) < 0.05) * 200.0)
    pixels.numpy().tofile(tmp_path / "pixels.bin")
    costs = {int(k): v for k, v in meta["aoti_bucket_ms"].items()}
    graph_costs = {int(k): v for k, v in meta["aoti_graph_bucket_ms"].items()}
    loader = build_loader()
    for n in (3, 17):
        rung = select_bucket((4, 20), n, costs)
        count = torch.tensor(n, dtype=torch.int32, device=cuda)
        rows = pixels[:1 + rung].to(cuda)
        package = load_package(paths["pid" if rung == 20 else f"pid_p{rung}"])(rows, count)
        with torch.no_grad():
            want = build_inference_fn(with_max_prongs(model, rung), "pid", norm)(rows, count)
        for g, w in zip(package, want):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        proc = subprocess.run(
            [str(loader), str(out / "transformercvn_pid"), str(meta_path),
             str(tmp_path / "pixels.bin"), str(n), str(tmp_path / "out.bin")],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert f"num_prongs {n} -> bucket {rung} [cost-aware" in proc.stderr
        read_loader_output(tmp_path / "out.bin", package)
        # --graph: the rung the graph costs pick, its package captured and
        # replayed; the outputs those of the package run uncaptured
        graph_rung = select_bucket((4, 20), n, graph_costs)
        rows = pixels[:1 + graph_rung].to(cuda)
        package = load_package(paths["pid" if graph_rung == 20 else f"pid_p{graph_rung}"])(
            rows, count)
        proc = subprocess.run(
            [str(loader), str(out / "transformercvn_pid"), str(meta_path),
             str(tmp_path / "pixels.bin"), str(n), str(tmp_path / "out_graph.bin"),
             "--graph", "--repeat", "3"], capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert f"num_prongs {n} -> bucket {graph_rung} [graph cost-aware" in proc.stderr
        assert "captured in" in proc.stderr and "replays after the first" in proc.stderr
        read_loader_output(tmp_path / "out_graph.bin", package)


def read_loader_output(path, package):
    """The loader's out.bin against the package's outputs (within 1e-6)."""
    with open(path, "rb") as f:
        assert struct.unpack("<I", f.read(4)) == (2,)
        for g in package:
            (rank,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{rank}q", f.read(8 * rank))
            assert dims == tuple(g.shape) and struct.unpack("<I", f.read(4)) == (11,)
            got = np.frombuffer(f.read(4 * g.numel()), "<f4").reshape(dims)
            np.testing.assert_allclose(got, g.cpu().numpy(), rtol=0.0, atol=1e-6)


TP_RANK = """
import datetime, json, sys
import torch, torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import test_torch_port_cuda as t
rank, rendezvous, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method="file://" + rendezvous, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=300))
loss, norm, state = t.tp_step(model_parallel=2)
dist.destroy_process_group()
json.dump(dict(loss=loss, norm=norm, state=state), open(out, "w"))
"""


def tp_step(model_parallel):
    """One train step of the tiny Trainer on the card (dropout and noise
    off) on the first global batch; its loss, grad norm and whole
    parameters."""
    from dune_transformercvn_torch.parallel import full_tensors
    from dune_transformercvn_torch.predict import to_device

    options = Options()
    options.update_options(dict(
        densenet_structure=[1, 1], densenet_growth_rate=8, initial_pixel_dim=8,
        pixel_embedding_dim=16, feature_embedding_dim=8, position_embedding_dim=16,
        hidden_dim=32, num_encoder_layers=1, num_prong_decoder_layers=2,
        num_attention_heads=2, dropout=0.0, pixel_noise_std=0.0, batch_size=4,
        compute_dtype="float32", num_dataloader_workers=1, verbose_output=False,
        num_gpu=model_parallel, model_parallel=model_parallel))
    datasets = (InMemoryEvents(16, 1, (48, 40)), InMemoryEvents(8, 2, (48, 40)), None)
    trainer = Trainer(options, debug=True, datasets=datasets)
    assert trainer.mesh.mp == model_parallel
    batch = to_device(trainer.train_batcher.build_batch(np.arange(4)), trainer.device)
    metrics = trainer.train_step(trainer.state, batch)
    params = dict(trainer.state.model.named_parameters())
    whole = full_tensors([p.detach() for p in params.values()])
    return (float(metrics["train_loss"]), float(metrics["grad_norm"]),
            {n: w.cpu().tolist() for n, w in zip(params, whole)})


def test_tensor_parallel_step_on_the_card(cuda, tmp_path):
    here = str(Path(__file__).resolve().parent)
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(Path(here).parent), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", TP_RANK, str(r),
                               str(tmp_path / "rendezvous"), str(outs[r]), here],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    ranks = [json.loads(o.read_text()) for o in outs]
    assert ranks[0] == ranks[1]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    loss, norm, state = tp_step(model_parallel=1)
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["norm"], norm, rtol=1e-4)
    for name, values in state.items():
        np.testing.assert_allclose(ranks[0]["state"][name], values, atol=1e-5, err_msg=name)


GRAPH_DP_RANK = """
import datetime, json, sys
import torch, torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import test_torch_port_cuda as t
rank, rendezvous, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(rank)
torch.backends.cudnn.deterministic = True
dist.init_process_group("nccl", init_method="file://" + rendezvous, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=300))
try:
    result = t.graph_dp_steps("cuda")
    result["fit"] = t.graph_dp_fit("cuda")
finally:
    dist.destroy_process_group()
json.dump(result, open(out, "w"))
"""


def graph_dp_options(**overrides):
    """The tiny network of the 2-card tests, 2 data shards of 4 events,
    sync-BN, dropout and pixel noise on."""
    options = Options()
    options.update_options(dict(
        densenet_structure=[1, 1], densenet_growth_rate=8, initial_pixel_dim=8,
        pixel_embedding_dim=16, feature_embedding_dim=8, position_embedding_dim=16,
        hidden_dim=32, num_encoder_layers=1, num_prong_decoder_layers=2,
        num_attention_heads=2, dropout=0.1, pixel_noise_std=0.02, batch_size=4,
        compute_dtype="float32", num_dataloader_workers=1, verbose_output=False,
        num_gpu=2, **overrides))
    return options


def graph_dp_datasets():
    return InMemoryEvents(32, 1, (48, 40)), InMemoryEvents(8, 2, (48, 40)), None


def state_tensors(trainer):
    """The model's parameters and buffers, the optimizer's slots and count,
    on the host, by name."""
    state = trainer.state
    tensors = {f"model.{n}": t.detach().cpu() for n, t in state.model.state_dict().items()}
    tensors.update({f"slot.{i}.{k}": t.cpu() for i, slots in
                    enumerate(state.optimizer.state.values()) for k, t in slots.items()})
    tensors["count"] = state.optimizer.count.cpu()
    return tensors


def graph_dp_steps(device):
    """This rank's part of 4 data-parallel steps of the tiny Trainer
    (sync-BN, dropout and pixel noise on), as 2 calls of a 2-step graph
    step and as 4 eager steps from the same start, both with the
    graph-safe AdamW: the tensors (metrics, parameters, buffers, moments,
    count) that differ, K1's launches a replay, and a digest of the graph
    run's parameters."""
    import hashlib
    import itertools

    from dune_transformercvn_torch.predict import to_device
    from dune_transformercvn_torch.train import make_train_step

    options = graph_dp_options(static_batch_shapes=True)
    runs, launches = [], None
    for graph in (False, True):
        trainer = Trainer(options, debug=True, datasets=graph_dp_datasets(), device=device,
                          graph=True)
        state, model = trainer.state, trainer.state.model
        batches = [to_device(b, device) for b in
                   itertools.islice(trainer.train_batcher.epoch(0), 4)]
        if graph:
            step = make_train_step(model, options, trainer.mesh, graph=True,
                                   steps_per_dispatch=2)
            out = [step(state, {k: torch.stack([a[k], b[k]]) for k in a})
                   for a, b in (batches[:2], batches[2:])]
            metrics = {k: torch.cat([m[k] for m in out]).cpu() for k in out[0]}
            if device == "cuda":
                (captured,) = step.graphs.graphs.values()
                launches = captured.launches
        else:
            step = make_train_step(model, options, trainer.mesh)
            out = [step(state, b) for b in batches]
            metrics = {k: torch.stack([m[k].float() for m in out]).cpu() for k in out[0]}
        runs.append({**state_tensors(trainer), **{f"metric.{k}": v for k, v in metrics.items()}})
    eager, graphed = runs
    digest = hashlib.sha256()
    for name, tensor in graphed.items():
        if name.startswith("model."):
            digest.update(tensor.contiguous().view(torch.uint8).numpy().tobytes())
    return dict(differ=[n for n in eager if not torch.equal(graphed[n], eager[n])],
                launches=launches, digest=digest.hexdigest(),
                steps=int(graphed["count"]))


def graph_dp_fit(device):
    """This rank's ``Trainer(graph=True)`` at K = 2 (sync-BN, dropout and
    noise on) fit 4 steps with a validation every 2, against the same
    Trainer with the eager data-parallel train and eval steps in place of
    its graphs: the names of the state's tensors and of the validation
    metrics that differ; then the graph Trainer's ``predict_split`` with
    and without graphs: the arrays that differ."""
    from dune_transformercvn_torch.predict import to_device
    from dune_transformercvn_torch.train import make_eval_step, make_train_step

    options = graph_dp_options(steps_per_dispatch=2)
    runs = []
    for graph in (True, False):
        trainer = Trainer(options, debug=True, datasets=graph_dp_datasets(), device=device,
                          graph=True)
        if not graph:
            eager = make_train_step(trainer.state.model, options, trainer.mesh)

            def two_steps(state, batches, eager=eager):
                batches = to_device(batches, device)
                out = [eager(state, {k: v[i] for k, v in batches.items()}) for i in range(2)]
                return {k: torch.stack([o[k] for o in out]) for k in out[0]}

            trainer.train_step = two_steps
            trainer.eval_step = make_eval_step(trainer.state.model, options)
        result = trainer.fit(max_steps=4, eval_interval=2)
        runs.append(dict(state=state_tensors(trainer), val=result, step=trainer.state.step))
        if graph:
            got, want = (trainer.predict_split("validation", graph=g) for g in (True, False))
            differ_predict = [k for k in want if not np.array_equal(got[k], want[k])]
    graphed, eager = runs
    return dict(
        state=[n for n in eager["state"] if not torch.equal(graphed["state"][n],
                                                            eager["state"][n])],
        val=[k for k in eager["val"]
             if not np.array_equal(graphed["val"][k], eager["val"][k], equal_nan=True)],
        predict=differ_predict, steps=[graphed["step"], eager["step"]])


def test_data_parallel_graph_step_over_nccl_is_the_eager_step(cuda, tmp_path):
    """2 ranks, one card each over nccl (skips below 2 cards), cuDNN
    deterministic: the tiny Trainer's 2-step graph step, with its
    all-reduces, sync-BN's and ``global_norm`` captured, against the eager
    data-parallel step on the same 4 global batches with dropout and noise,
    bit for bit on each rank; the ranks' parameters equal; K1 twice a step
    in a replay.  Then ``Trainer(graph=True).fit`` at K = 2 with two
    validations (the eval graph captured in the group) against the same
    Trainer with the eager train and eval steps, its state and validation
    metrics bit for bit, and its ``predict_split(graph=True)`` (each rank
    replays its shard, the rows gathered) against eager, bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA GPUs, one a rank over nccl")
    here = str(Path(__file__).resolve().parent)
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(Path(here).parent), os.environ.get("PYTHONPATH", "")]),
        "LOCAL_WORLD_SIZE": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", GRAPH_DP_RANK, str(r),
                               str(tmp_path / "rendezvous"), str(outs[r]), here],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env={**env, "LOCAL_RANK": str(r)}) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    ranks = [json.loads(o.read_text()) for o in outs]
    for rank in ranks:
        assert rank["differ"] == [] and rank["steps"] == 4, rank
        assert rank["launches"] == [4, 0], rank
        assert rank["fit"] == dict(state=[], val=[], predict=[], steps=[4, 4]), rank["fit"]
    assert ranks[0]["digest"] == ranks[1]["digest"]


@pytest.mark.parametrize("case", ["densify", "densify_s2d", "scatter_f32", "scatter_bf16",
                                  "bin"])
def test_custom_ops_pass_opcheck_on_the_card(cuda, case):
    """``torch.library.opcheck`` on the kernels' ops with CUDA tensors: the
    kernels launch (their launches counted), their fakes give their shapes,
    AOT dispatch equals eager, and K2's registered gradient is checked."""
    xy, vals, owner, starts = bank(3, 40, 36, [30, 0, 25], 96, 3, cuda)
    if case.startswith("densify"):
        before = k1.densify_images_cuda.launches
        op, args = k1.densify_op, (xy, vals, owner, starts, 3, 40, 36, case.endswith("s2d"))
    elif case.startswith("scatter"):
        before = k2.scatter_patches_cuda.launches
        patches = torch.randn(96, 4, 4, 64, device=cuda, requires_grad=True)
        bias = torch.randn(64, device=cuda, requires_grad=True)
        dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
        op, args = k2.scatter_patches, (patches, bias, xy, starts, 3, 40, 36, dtype)
    else:
        before = None
        op, args = k2.bin_hits, (xy, starts, 3, 40, 36, 64)
    results = torch.library.opcheck(op, args, rtol=1e-5, atol=1e-5)
    assert set(results.values()) == {"SUCCESS"}, results
    if before is not None:
        counter = k1.densify_images_cuda if case.startswith("densify") \
            else k2.scatter_patches_cuda
        assert counter.launches > before


@pytest.mark.parametrize("embedder", ["dense", "coo"])
def test_compiled_steps_on_the_card_match_eager(cuda, embedder):
    """The tiny network's compiled predict and train steps on the card
    against the eager ones, float32 with TF32 off, dropout and noise 0:
    probabilities, the first loss and grad_norm within 1e-4; K1 (dense) or
    K2 (coo) launched from inside the compiled graphs, twice a forward."""
    from dune_transformercvn_torch.data import Batcher
    from dune_transformercvn_torch.predict import make_predict_step, to_device
    from dune_transformercvn_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=16,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=1, num_prong_decoder_layers=1, num_attention_heads=4,
        densenet_structure=(1, 1), densenet_growth_rate=8, image_height=48,
        image_width=40, compute_dtype="float32", embedder=embedder, dropout=0.0,
        pixel_noise_std=0.0)
    ds = InMemoryEvents(8, 3, (48, 40))
    batch = to_device(Batcher(ds, batch_size=4).build_batch(np.arange(4)), cuda)
    norm = to_device(ds.norm(), cuda)
    models = [TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
              for _ in range(2)]
    counter = k2.scatter_patches_cuda if embedder == "coo" else k1.densify_images_cuda
    want = make_predict_step(models[0])(batch, norm)
    compiled = make_predict_step(models[1], compile=True)
    compiled(batch, norm)
    before = counter.launches
    got = compiled(batch, norm)
    assert counter.launches == before + 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    options = Options()
    options.update_options(dict(optimizer="AdamW", learning_rate=1e-5, gradient_clip=43.0))
    metrics = []
    for model, compile in zip(models, (False, True)):
        state = create_train_state(model, options, ds.norm(), 4, seed=0)
        metrics.append(make_train_step(model, options, compile=compile)(state, batch))
    for key in ("train_loss", "grad_norm"):
        torch.testing.assert_close(metrics[1][key], metrics[0][key], rtol=1e-4, atol=1e-4)


def int8_setup(cuda):
    """The tiny dense network on the card, its int8 scales calibrated on
    two of its batches, and the number of convolutions they quantize."""
    from dune_transformercvn_torch.ops import quant

    cfg, ds, batches, _ = graph_setup(cuda, "dense", 0.0, 0.0)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    scales = quant.calibrate_activation_scales(model, batches[:2], ds.norm())
    assert len(scales) == sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    return model, ds, scales


def test_int8_graph_predict_equals_eager(cuda):
    """``predict_split(graph=True)`` inside the int8 context against the
    eager int8 pass, bit for bit: the ``_int_mm`` route's GEMMs replayed,
    its counter one a quantized conv a batch (the warm-up's forward, then a
    replay a batch), K1 twice a batch."""
    from dune_transformercvn_torch.ops import quant
    from dune_transformercvn_torch.predict import predict_split

    model, ds, scales = int8_setup(cuda)
    with quant.quantized_convs(model, scales):
        want = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True)
        before = (quant.conv_int32_cuda.launches, k1.densify_images_cuda.launches)
        got = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True, graph=True)
        again = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True, graph=True)
    batches = len(ds) // 4
    assert quant.conv_int32_cuda.launches - before[0] == len(scales) * (1 + 2 * batches)
    assert k1.densify_images_cuda.launches - before[1] == 2 * (1 + 2 * batches)
    floats = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True, graph=True)
    assert not np.array_equal(floats["event_probabilities"], want["event_probabilities"])
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        np.testing.assert_array_equal(again[key], value, err_msg=key)


def test_compiled_int8_predict_on_the_card(cuda):
    """``predict_split(compile=True)`` inside the int8 context against the
    eager int8 pass: probabilities within 1e-3 and the same argmax (the
    bound of the CPU tests against JAX); the ``_int_mm`` route launched by
    the compiled graph once a quantized conv a batch."""
    from dune_transformercvn_torch.ops import quant
    from dune_transformercvn_torch.predict import predict_split

    model, ds, scales = int8_setup(cuda)
    with quant.quantized_convs(model, scales):
        want = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True)
        predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True, compile=True)
        before = quant.conv_int32_cuda.launches
        got = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True, compile=True)
    assert quant.conv_int32_cuda.launches - before == len(scales) * (len(ds) // 4)
    for key in ("event_probabilities", "prong_probabilities"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3, err_msg=key)
        np.testing.assert_array_equal(got[key].argmax(-1), want[key].argmax(-1))


def graph_setup(cuda, embedder="dense", dropout=0.1, noise=0.01):
    """The tiny network of the compiled tests on the card, with dropout and
    pixel noise, its options and 4 batches of 4 events in one shape."""
    from dune_transformercvn_torch.data import Batcher
    from dune_transformercvn_torch.predict import to_device

    cfg = ModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=16,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=1, num_prong_decoder_layers=1, num_attention_heads=4,
        densenet_structure=(1, 1), densenet_growth_rate=8, image_height=48,
        image_width=40, compute_dtype="float32", embedder=embedder, dropout=dropout,
        pixel_noise_std=noise)
    ds = InMemoryEvents(16, 3, (48, 40))
    batches = [to_device(b, cuda) for b in Batcher(ds, batch_size=4, fixed_shape=True)
               .epoch(0)]
    options = Options()
    options.update_options(dict(optimizer="AdamW", learning_rate=1e-3, gradient_clip=0.5,
                                l2_penalty=0.05))
    return cfg, ds, batches, options


def test_captured_steps_equal_eager_steps(cuda):
    """Two replays of a captured K = 2 train step (dropout and pixel noise
    on) against 4 eager steps from the same state, both with the graph-safe
    AdamW: each step's metrics and the running statistics within 2^-7 of
    their largest, the optimizer's count equal, K1 twice a step in each
    replay; the parameters within ``2 * steps * lr`` of eager's.  The graph
    launches eager's kernels, so these are mostly bit-equal, but some of
    the card's kernels sum in no fixed order, and a bias ahead of a
    BatchNorm has an exact gradient of 0 and a float one of rounding
    noise, which Adam turns into a step of about lr either way (measured:
    the event stem's ``conv0.bias`` 5.2e-4 from eager after 4 steps)."""
    from dune_transformercvn_torch.train import create_train_state, make_train_step

    cfg, ds, batches, options = graph_setup(cuda)
    start = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0))
    runs = []
    for graph in (False, True):
        model = TransformerCVN(cfg).to(cuda)
        model.load_state_dict(start.state_dict())
        state = create_train_state(model, options, ds.norm(), 4, seed=3, graph=True)
        if graph:
            step = make_train_step(model, options, graph=True, steps_per_dispatch=2)
            groups = [{k: torch.stack([a[k], b[k]]) for k in a}
                      for a, b in (batches[:2], batches[2:])]
            first = step(state, groups[0])
            before = k1.densify_images_cuda.launches
            second = step(state, groups[1])
            assert k1.densify_images_cuda.launches == before + 4
            (captured,) = step.graphs.graphs.values()
            assert captured.launches == [4, 0]
            metrics = {k: torch.cat([first[k], second[k]]).cpu() for k in first}
        else:
            step = make_train_step(model, options)
            steps = [step(state, b) for b in batches]
            metrics = {k: torch.stack([m[k].float() for m in steps]).cpu() for k in steps[0]}
        assert state.step == 4 and int(state.optimizer.count) == 4
        runs.append((metrics, {k: v.cpu() for k, v in model.state_dict().items()}))
    (want_m, want_sd), (got_m, got_sd) = runs
    params = {n for n, _ in start.named_parameters()}
    assert got_m.keys() == want_m.keys() and got_sd.keys() == want_sd.keys()
    for key, w in list(want_m.items()) + list(want_sd.items()):
        gap = float(((got_m if key in want_m else got_sd)[key].double() - w.double())
                    .abs().max())
        bound = (2 * 4 * options.learning_rate if key in params
                 else 2 ** -7 * max(float(w.abs().max()), 1e-30))
        assert gap <= bound, (key, gap, bound)


def test_predict_graph_equals_eager(cuda):
    """``predict_split(graph=True)`` against eager on the tiny dense and coo
    networks: the same kernels on the same shapes, equal; K1 (K2) twice a
    batch from the graph's replays."""
    from dune_transformercvn_torch.predict import predict_split

    for embedder, counter in (("dense", k1.densify_images_cuda),
                              ("coo", k2.scatter_patches_cuda)):
        cfg, ds, _, _ = graph_setup(cuda, embedder, 0.0, 0.0)
        model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
        want = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True)
        before = counter.launches
        got = predict_split(model, ds, ds.norm(), 4, cuda, fixed_shape=True, graph=True)
        # the warm-up's forward, then a replay a batch
        assert counter.launches == before + 2 + 2 * 4
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=(embedder, key))


def test_profiler_sees_k1_in_a_replay(cuda):
    """One replay of a K = 2 train graph under ``torch.profiler``: the
    trace holds K1's kernel 4 times, as the graph's count says."""
    from torch.profiler import ProfilerActivity, profile

    from dune_transformercvn_torch.train import create_train_state, make_train_step

    cfg, ds, batches, options = graph_setup(cuda)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    state = create_train_state(model, options, ds.norm(), 4, seed=3, graph=True)
    step = make_train_step(model, options, graph=True, steps_per_dispatch=2)
    group = {k: torch.stack([a, b]) for k, a, b in zip(batches[0], batches[0].values(),
                                                        batches[1].values())}
    step(state, group)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, group)
        torch.cuda.synchronize()
    traced = sum(e.count for e in prof.key_averages() if "densify_kernel" in e.key)
    (captured,) = step.graphs.graphs.values()
    assert traced == captured.launches[0] == 4, traced


def test_compiled_graph_steps_on_the_card(cuda):
    """``graph=True`` with ``compile=True``: the compiled forward and loss
    warmed up outside the capture and captured inside the train graph and
    the predict graph; the first loss and the probabilities against the
    compiled steps run without a graph (float32, TF32 off, dropout and
    noise 0) within 1e-4."""
    from dune_transformercvn_torch.predict import make_predict_step
    from dune_transformercvn_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ds, batches, options = graph_setup(cuda, "dense", 0.0, 0.0)
    norm = {k: torch.as_tensor(v).to(cuda) for k, v in ds.norm().items()}
    models = [TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
              for _ in range(2)]
    want = make_predict_step(models[0], compile=True)(batches[0], norm)
    got = make_predict_step(models[1], compile=True, graph=True)(batches[0], norm)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    metrics = []
    for model, graph in zip(models, (False, True)):
        state = create_train_state(model, options, ds.norm(), 4, seed=0, graph=True)
        step = make_train_step(model, options, compile=True, graph=graph)
        metrics.append([step(state, b) for b in batches[:2]])
    for key in ("train_loss", "grad_norm"):
        for g, w in zip(metrics[1], metrics[0]):
            torch.testing.assert_close(g[key], w[key], rtol=1e-4, atol=1e-4)


def captured_against_eager(cuda, cfg, ds, batches, options):
    """Two replays of a captured K = 2 train step against 4 eager steps
    from the same state (the graph-safe optimizer in both): the stacked
    metrics, the state dict and the optimizer's count, and the graph's
    kernel launches a replay."""
    from dune_transformercvn_torch.train import create_train_state, make_train_step

    start = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0))
    runs = []
    for graph in (False, True):
        model = TransformerCVN(cfg).to(cuda)
        model.load_state_dict(start.state_dict())
        state = create_train_state(model, options, ds.norm(), 4, seed=3, graph=True)
        if graph:
            step = make_train_step(model, options, graph=True, steps_per_dispatch=2)
            groups = [{k: torch.stack([a[k], b[k]]) for k in a}
                      for a, b in (batches[:2], batches[2:])]
            outs = [step(state, group) for group in groups]
            metrics = {k: torch.cat([o[k] for o in outs]).cpu() for k in outs[0]}
            (captured,) = step.graphs.graphs.values()
            launches = captured.launches
        else:
            step = make_train_step(model, options)
            steps = [step(state, b) for b in batches]
            metrics = {k: torch.stack([m[k].float() for m in steps]).cpu() for k in steps[0]}
        assert state.step == 4 and int(state.optimizer.count) == 4
        runs.append((metrics, {k: v.cpu() for k, v in model.state_dict().items()}))
    return runs, {n for n, _ in start.named_parameters()}, launches


def assert_captured_close(runs, params, lr):
    """``test_captured_steps_equal_eager_steps``' bounds: metrics and
    running statistics within 2^-7 of their largest, parameters within
    ``2 * steps * lr``."""
    (want_m, want_sd), (got_m, got_sd) = runs
    assert got_m.keys() == want_m.keys() and got_sd.keys() == want_sd.keys()
    for key, w in list(want_m.items()) + list(want_sd.items()):
        gap = float(((got_m if key in want_m else got_sd)[key].double() - w.double())
                    .abs().max())
        bound = (2 * 4 * lr if key in params
                 else 2 ** -7 * max(float(w.abs().max()), 1e-30))
        assert gap <= bound, (key, gap, bound)


@pytest.mark.parametrize("embedder,flag,launches", [
    ("dense", "remat_cnn", [4, 0]),
    ("dense", "remat_embedder", [4, 0]),
    # the coo stem lies inside the rematted embedder: the backward's
    # recompute launches K2 again, 4 times a step
    ("coo", "remat_embedder", [0, 8]),
])
def test_captured_remat_steps_equal_eager_steps(cuda, embedder, flag, launches):
    """A captured K = 2 train step with a memory recipe (dropout and pixel
    noise on) against 4 eager steps with it, within
    ``test_captured_steps_equal_eager_steps``' bounds; the kernels a replay
    launches, the recompute's included."""
    import dataclasses

    cfg, ds, batches, options = graph_setup(cuda, embedder)
    cfg = dataclasses.replace(cfg, **{flag: True})
    runs, params, got = captured_against_eager(cuda, cfg, ds, batches, options)
    assert got == launches
    assert_captured_close(runs, params, options.learning_rate)


def test_captured_lamb_step_equals_eager(cuda):
    """A captured K = 2 train step with lamb (count, rate and per-leaf
    trust ratios on the card) against 4 eager lamb steps."""
    cfg, ds, batches, options = graph_setup(cuda)
    options.update_options(dict(optimizer="lamb"))
    runs, params, launches = captured_against_eager(cuda, cfg, ds, batches, options)
    assert launches == [4, 0]
    assert_captured_close(runs, params, options.learning_rate)


def test_compiled_remat_step_on_the_card(cuda):
    """``compile=True`` with ``remat_cnn``: one graph, the first two losses
    and ``grad_norm`` against the eager remat step (float32, TF32 off,
    dropout and noise 0) within 1e-4."""
    import dataclasses

    from dune_transformercvn_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ds, batches, options = graph_setup(cuda, "dense", 0.0, 0.0)
    cfg = dataclasses.replace(cfg, remat_cnn=True)
    metrics = []
    for compile in (False, True):
        model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
        state = create_train_state(model, options, ds.norm(), 4, seed=0)
        step = make_train_step(model, options, compile=compile)
        metrics.append([step(state, b) for b in batches[:2]])
    for key in ("train_loss", "grad_norm"):
        for g, w in zip(metrics[1], metrics[0]):
            torch.testing.assert_close(g[key], w[key], rtol=1e-4, atol=1e-4)


def test_bias_correction_on_the_card(cuda):
    """The optimizers' float32 ``1 - b ** count`` on the card against the
    same on the CPU, 0-d as the optimizers compute it (XLA's bits there,
    ``tests/test_torch_port_graph_chains.py``), for b 0.9 and 0.999 and
    counts 1 to 2^16: the powers at most one unit in the last place apart,
    so each correction within 2^-23 / (1 - b ** count) of itself, 1.2e-4
    at count 1 and 1.2e-7 from count 2^16 on (the counts that differ are
    printed)."""
    from dune_transformercvn_torch.train.optimizer import bias_correction

    counts = np.arange(1, 2 ** 16 + 1, dtype=np.float32)
    for decay in (0.9, 0.999):
        want = np.array([float(bias_correction(decay, torch.tensor(float(c))))
                         for c in counts], np.float32)
        got = bias_correction(decay, torch.from_numpy(counts).to(cuda)).cpu().numpy()
        power = torch.pow(torch.full((counts.size,), decay, device=cuda),
                          torch.from_numpy(counts).to(cuda)).cpu().numpy()
        cpu_power = np.array([float(torch.pow(torch.tensor(decay), torch.tensor(float(c))))
                              for c in counts], np.float32)
        ulps = np.abs(power.view(np.int32).astype(np.int64) - cpu_power.view(np.int32))
        print(f"bias correction {decay}: {int((ulps > 0).sum())} of {counts.size} "
              f"powers differ, at most {int(ulps.max())} ulp, the correction at most "
              f"{float(np.max(np.abs(got / want - 1))):.3g} of itself")
        assert ulps.max() <= 1
        np.testing.assert_allclose(got, want, rtol=2 ** -23 / (1 - decay), atol=0)
