#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device and build: the card's name and power limit from ``nvidia-smi``;
   every kernel under ``dune_transformercvn_torch/csrc`` is built with
   ``nvcc``, one compiler process per source, all at once; TF32 is switched
   off so the float32 comparisons below are float32.
2. Kernel K1 (COO -> dense densify) against its plain PyTorch version on the
   card, at the serving path's shapes, float32 and bfloat16, plain and
   space-to-depth layout, on uniform banks with duplicate pixels, an empty
   image, coordinates out of range (negative too) and padding rows past
   ``starts[-1]``, and on the event and prong banks of one real batch of
   16 events (track-shaped hits); the median time of the kernel, the plain
   version and one ``index_put_`` call, the kernel's device time (calls
   queued behind a device sleep, so no host time between them), its share
   of its bound, and its time on the same bank with every CSR range empty
   (the zero fill alone).
3. Kernel K2 (the coo stem's scatter) against its plain version on the
   card, at the coo path's shapes (event banks of 16 and 64 images, prong
   banks of 128 and 384, the real batch's two banks, production stem
   weights), float32 and bfloat16 output, the same edge cases; its binning
   pass against the plain binning; gradients through ``ScatterPatches``
   against autograd of the plain version; the same times as K1 (library
   call: ``zeros().index_add_``, the bias, the cast), and the device time
   of its binning pass alone.
4. Dense serving at full width: the production option file, bfloat16,
   random weights from a seed, events made in memory from a seed;
   ``predict_split`` at batch 16 and at batch 64, one warm-up pass over the
   same events, then timed passes; K1 launched twice a batch, K2 never.
5. Coo serving: the same with the coo family; K2 twice a batch, K1 never.
6. Coo training at full width: the option file's AdamW, schedule, clip 43,
   dropout 0.1, pixel noise 0.001, bfloat16, batch 16: 3 warm-up steps and
   20 timed ones; finite loss and grad_norm, every parameter that got a
   gradient changed, BatchNorm statistics moved, K2 twice a step; then one
   eval pass over 64 events with finite AUCs.
7. Paths, float32: dense through K1 against the plain densify; coo logits
   against dense logits with the same weights; each coo embedder through K2
   against the plain stem; the card against the CPU at batch 4, both
   families.
8. A JSON line of every ported kernel, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import Batcher, InMemoryEvents
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.models.densenet import densenet_post_stem
from dune_transformercvn_torch.ops import coo_stem
from dune_transformercvn_torch.ops.coo_conv import coo_stem_conv_plain
from dune_transformercvn_torch.ops.densify import (
    densify_images_cuda, densify_images_plain)
from dune_transformercvn_torch.predict import predict_split, to_device
from dune_transformercvn_torch.profile_serving import OPTION_FILE, production_config
from dune_transformercvn_torch.train import (
    create_train_state, finalize_metrics, init_metric_state, make_eval_step,
    make_train_step)
from dune_transformercvn_torch.utils.build import build, sources

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
QUEUE_CYCLES = 10_000_000      # ~5 ms of device sleep ahead of a queued burst

H, W, C = 400, 280, 3
# K1 tolerances against the plain version (torch's index_put_).  float32:
# both add duplicates in bank order in float32.  bfloat16: the kernel rounds
# to bf16 after every add (as the TPU kernel does), the plain version on the
# card adds in float32 and rounds once; sums stay below ~4, so the gap is a
# few bf16 ulps of 2^-6.
K1_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -5)}
# K2 against its plain version: float32 sums in bank order against
# index_add_'s atomics in any order; a bfloat16 output rounds sums that agree
# to float32 rounding once, so they differ by at most one bf16 ulp.
K2_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}
K2_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# Logits through a kernel against logits through its plain version, float32
# with TF32 off: only cuDNN/cuBLAS summation order separates them.
PATH_TOL = dict(rtol=1e-4, atol=1e-4)
# coo against dense logits: the stem's float32 sums in another order,
# amplified by the BatchNorm divides (tests/test_coo_embedder.py's bound).
FAMILY_TOL = dict(rtol=1e-3, atol=1e-4)
# Serving: (batch size, events) -- a few seconds a pass -- and the timed
# passes after the warm-up.
SERVE_EVENTS = ((16, 512), (64, 1024))
SERVE_PASSES = 3
# Training: the option file's batch size, warm-up and timed steps, and the
# events of the eval pass.
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, EVAL_EVENTS = 16, 3, 20, 64
# The card against the CPU, float32: cuDNN and oneDNN sum in other orders
# through ~30 conv layers.
CPU_TOL = dict(rtol=1e-3, atol=1e-3)


def log(msg: str = ""):
    print(msg, flush=True)


def reset_counts():
    densify_images_cuda.launches = 0
    coo_stem.scatter_patches_cuda.launches = 0


def read_counts():
    return densify_images_cuda.launches, coo_stem.scatter_patches_cuda.launches


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = sources()
    with ThreadPoolExecutor(len(names)) as pool:
        outputs = dict(zip(names, pool.map(build, names)))
    log(f"[build] {sorted(outputs)} built in {time.perf_counter() - t0:.2f} s")
    for name, text in outputs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line or "Used" in line):
                log(f"[build] {name}: {line.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[build] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


# ---------------------------------------------------------------------------
# phases 2 and 3
# ---------------------------------------------------------------------------

def make_bank(rng, num_images, hits_per_image, bucket=8192):
    """An owner-sorted hit bank with the edge cases the batcher can produce."""
    counts = np.maximum(rng.poisson(hits_per_image, num_images), 1)
    counts[num_images // 3] = 0                      # an empty image
    n = int(counts.sum())
    owner = np.repeat(np.arange(num_images), counts).astype(np.int32)
    xy = np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], 1).astype(np.int32)
    dup = rng.random(n) < 0.1                        # duplicate the previous hit
    dup[0] = False
    dup[1:] &= owner[1:] == owner[:-1]
    for i in np.nonzero(dup)[0]:
        xy[i] = xy[i - 1]
    bad = rng.choice(n, size=max(8, n // 100), replace=False)
    xy[bad[0::4], 0] = -1 - rng.integers(0, 5, len(bad[0::4]))   # x < 0
    xy[bad[1::4], 0] = H + rng.integers(0, 5, len(bad[1::4]))    # x >= H
    xy[bad[2::4], 1] = -1 - rng.integers(0, 5, len(bad[2::4]))   # y < 0
    xy[bad[3::4], 1] = W + rng.integers(0, 5, len(bad[3::4]))    # y >= W
    R = max(bucket, -(-n // bucket) * bucket)        # padding rows at the end
    xy_full = np.concatenate([xy, rng.integers(0, H, (R - n, 2)).astype(np.int32)])
    owner_full = np.concatenate([owner, np.full(R - n, num_images, np.int32)])
    values = rng.uniform(16.0, 255.0, (R, C)).astype(np.float32) / 255.0
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return xy_full, values, owner_full, starts


def cuda_time_ms(fn, warmup=3, bursts=5, per_burst=20, queued=False):
    """Median over bursts of the mean time of one call, by CUDA events.
    ``queued``: the device first sleeps ~5 ms, so the host enqueues the whole
    burst ahead of it and the calls run back to back: the device's time,
    with no host time between calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(per_burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_burst)
    return statistics.median(times)


# (label, images, hits per image): the event and packed prong banks at batch
# 16 and 64 (prong slots from the batcher's capacity ladder)
BANKS = [("event b16", 16, 160.0), ("prong b16", 128, 160.0 / 3),
         ("event b64", 64, 160.0), ("prong b64", 384, 160.0 / 3)]
# the b16 forward's two banks, uniform (PR 2 and 3's row) and from a real batch
FORWARDS = {"uniform": ("event b16", "prong b16"),
            "serving": ("serving event b16", "serving prong b16")}


def bench_banks(seed):
    """Numpy banks ``(label, images, xy, values, owner, starts)``: the uniform
    banks of BANKS, then the event and prong banks of one ``Batcher`` batch of
    16 in-memory events (track-shaped hits, values scaled by 1/255 as
    ``preprocess_values`` does without noise)."""
    rng = np.random.default_rng(seed)
    for label, n, hits in BANKS:
        yield (label, n) + make_bank(rng, n, hits)
    batch = Batcher(InMemoryEvents(16, seed), batch_size=16).build_batch(np.arange(16))
    for key, n in (("event", 16), ("prong", batch["slot_batch"].shape[0])):
        yield (f"serving {key} b16", n, batch[f"{key}_xy"],
               batch[f"{key}_vals"] / np.float32(255.0), batch[f"{key}_owner"],
               batch[f"{key}_starts"])


def forward_totals(cases):
    """Sums of each timing over the two banks of each b16 forward in ``FORWARDS``."""
    return {name: {k: sum(cases[label][k] for label in labels)
                   for k in cases[labels[0]]}
            for name, labels in FORWARDS.items()}


def check_k1():
    """K1 against the plain version; returns (max abs err, kernel ms, plain
    ms, library ms, bound ms), the times summed over the two uniform banks
    of one batch-16 forward in bfloat16, plain layout (the serving path's
    calls)."""
    max_err = 0.0
    cases = {}
    log("[K1] case                                 max_abs_err  kernel_ms  device_ms  "
        "plain_ms   index_put_ms bound_ms  share  no_hit_ms")
    for label, n, xy, values, owner, starts in bench_banks(SEED):
        xy_t, owner_t = torch.from_numpy(xy).cuda(), torch.from_numpy(owner).cuda()
        starts_t = torch.from_numpy(starts).cuda()
        no_hits = torch.zeros_like(starts_t)
        x, y = xy_t[:, 0].long(), xy_t[:, 1].long()
        keep = (owner_t < n) & (x >= 0) & (x < H) & (y >= 0) & (y < W)
        flat = torch.where(keep, (owner_t.long() * H + x) * W + y, n * H * W)
        used = int(starts[-1])
        for dtype in (torch.float32, torch.bfloat16):
            vals_t = torch.from_numpy(values).to("cuda", dtype)
            for s2d in (False, True):
                out = densify_images_cuda(xy_t, vals_t, starts_t, n, H, W, s2d)
                ref = densify_images_plain(xy_t, vals_t, owner_t, n, H, W, s2d)
                torch.cuda.synchronize()
                assert out.shape == ref.shape and out.dtype == dtype, (out.shape, ref.shape)
                torch.testing.assert_close(out.float(), ref.float(), **K1_TOL[dtype])
                err = (out.float() - ref.float()).abs().max().item()
                max_err = max(max_err, err)
                # the output written once, the used hits and offsets read once
                nbytes = (out.numel() * out.element_size()
                          + used * (2 * 4 + C * vals_t.element_size()) + (n + 1) * 4)
                del out, ref
                bound = 1e3 * nbytes / HBM_BYTES_PER_S
                k_ms = cuda_time_ms(
                    lambda: densify_images_cuda(xy_t, vals_t, starts_t, n, H, W, s2d))
                d_ms = cuda_time_ms(
                    lambda: densify_images_cuda(xy_t, vals_t, starts_t, n, H, W, s2d),
                    queued=True)
                p_ms = cuda_time_ms(
                    lambda: densify_images_plain(xy_t, vals_t, owner_t, n, H, W, s2d))
                lib_ms = cuda_time_ms(lambda: vals_t.new_zeros((n * H * W + 1, C)).index_put_(
                    (flat,), vals_t, accumulate=True))
                empty_ms = cuda_time_ms(
                    lambda: densify_images_cuda(xy_t, vals_t, no_hits, n, H, W, s2d))
                name = f"{label} {str(dtype)[6:]} {'s2d' if s2d else 'nhwc'}"
                log(f"[K1] {name:<36} {err:<12.3g} {k_ms:<10.4f} {d_ms:<10.4f} "
                    f"{p_ms:<10.4f} {lib_ms:<12.4f} {bound:<9.4f} {bound / k_ms:<6.1%} "
                    f"{empty_ms:.4f}")
                if dtype == torch.bfloat16 and not s2d:
                    cases[label] = dict(kernel=k_ms, device=d_ms, plain=p_ms,
                                        library=lib_ms, bound=bound, no_hit=empty_ms)
    totals = forward_totals(cases)
    for name, t in totals.items():
        log(f"[K1] per b16 forward, {name} banks (2 banks, bf16): kernel "
            f"{t['kernel']:.4f} ms (device {t['device']:.4f}, no hits "
            f"{t['no_hit']:.4f}), plain {t['plain']:.4f} ms, index_put_ "
            f"{t['library']:.4f} ms, bound {t['bound']:.4f} ms, share of bound "
            f"{t['bound'] / t['kernel']:.1%} ({t['bound'] / t['device']:.1%} of device time)")
    t = totals["uniform"]
    return max_err, t["kernel"], t["plain"], t["library"], t["bound"]


def check_k2(stem_weight, stem_bias):
    """K2 against its plain version with the production stem (C_out 64);
    returns (max abs err, kernel ms, plain ms, library ms, bound ms), the
    times summed over the two uniform banks of one batch-16 forward with
    bfloat16 output (the coo path's calls)."""
    kernel = stem_weight.permute(2, 3, 1, 0).contiguous()          # HWIO
    bias = stem_bias.float().contiguous()
    out_h, out_w = coo_stem.out_shape(H, W)
    c_out = kernel.shape[-1]
    max_err = 0.0
    cases = {}
    log("[K2] case                                 max_abs_err  kernel_ms  device_ms  "
        "plain_ms   library_ms bound_ms  share  no_hit_ms")
    for label, n, xy, values, owner, starts in bench_banks(SEED + 1):
        xy_t, starts_t = torch.from_numpy(xy).cuda(), torch.from_numpy(starts).cuda()
        no_hits = torch.zeros_like(starts_t)
        vals_t = torch.from_numpy(values).cuda()
        patches = coo_stem.stem_patches(xy_t, vals_t, kernel, H, W).contiguous()
        flat, _ = coo_stem.tap_index(xy_t, starts_t, n, H, W)
        flat, rows = flat.reshape(-1), patches.reshape(-1, c_out)
        used = int(starts[-1])
        bins, entries = coo_stem.bin_hits_cuda(xy_t, starts_t, n, H, W, c_out)
        want_bins, want_entries = coo_stem.bin_hits_plain(xy_t, starts_t, n, H, W, c_out)
        listed = want_entries >= 0
        assert torch.equal(bins, want_bins), f"K2 binning, {label}: bins differ"
        assert torch.equal(entries[listed], want_entries[listed]), (
            f"K2 binning, {label}: hit lists differ")
        del bins, entries, want_bins, want_entries, listed
        for dtype in (torch.float32, torch.bfloat16):
            def run_kernel(starts=starts_t):
                return coo_stem.scatter_patches_cuda(patches, xy_t, starts, bias, n, H, W,
                                                     dtype)

            def run_plain():
                return coo_stem.scatter_patches_plain(patches, xy_t, starts_t, bias, n, H,
                                                      W, dtype)

            def run_library():
                grid = rows.new_zeros((n * out_h * out_w + 1, c_out)).index_add_(0, flat, rows)
                return (grid[:-1] + bias).to(dtype)

            out, ref = run_kernel(), run_plain()
            torch.cuda.synchronize()
            assert out.shape == ref.shape == (n, out_h, out_w, c_out) and out.dtype == dtype
            torch.testing.assert_close(out.float(), ref.float(), **K2_TOL[dtype])
            err = (out.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            del out, ref
            # the output written once; the used hits' patches, coordinates
            # and the offsets and bias read once
            nbytes = (n * out_h * out_w * c_out * dtype.itemsize
                      + used * (16 * c_out * 4 + 2 * 4) + (n + 1) * 4 + c_out * 4)
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            k_ms = cuda_time_ms(run_kernel)
            d_ms = cuda_time_ms(run_kernel, queued=True)
            p_ms = cuda_time_ms(run_plain, bursts=3, per_burst=5)
            lib_ms = cuda_time_ms(run_library, bursts=3, per_burst=5)
            empty_ms = cuda_time_ms(lambda: run_kernel(starts=no_hits))
            name = f"{label} out {str(dtype)[6:]}"
            log(f"[K2] {name:<36} {err:<12.3g} {k_ms:<10.4f} {d_ms:<10.4f} "
                f"{p_ms:<10.4f} {lib_ms:<10.4f} {bound:<9.4f} {bound / k_ms:<6.1%} "
                f"{empty_ms:.4f}")
            if dtype == torch.bfloat16:
                bin_ms = cuda_time_ms(
                    lambda: coo_stem.bin_hits_cuda(xy_t, starts_t, n, H, W, c_out),
                    queued=True)
                log(f"[K2]   {label}: the binning pass alone {bin_ms:.4f} ms of the "
                    f"device's {d_ms:.4f}")
                cases[label] = dict(kernel=k_ms, device=d_ms, plain=p_ms,
                                    library=lib_ms, bound=bound, no_hit=empty_ms)
        if label.endswith("b16") and not label.startswith("serving"):
            check_k2_gradients(patches, xy_t, starts_t, bias, n)
        del patches, flat, rows
        torch.cuda.empty_cache()
    totals = forward_totals(cases)
    for name, t in totals.items():
        log(f"[K2] per b16 forward, {name} banks (2 banks, bf16 out): kernel "
            f"{t['kernel']:.4f} ms (device {t['device']:.4f}, no hits "
            f"{t['no_hit']:.4f}), plain {t['plain']:.4f} ms, index_add_ + bias + cast "
            f"{t['library']:.4f} ms, bound {t['bound']:.4f} ms, share of bound "
            f"{t['bound'] / t['kernel']:.1%} ({t['bound'] / t['device']:.1%} of device time)")
    t = totals["uniform"]
    return max_err, t["kernel"], t["plain"], t["library"], t["bound"]


def check_k2_gradients(patches, xy, starts, bias, n):
    """Gradients wrt patches and bias: ``ScatterPatches`` (K2 forward, the
    hand-written gather backward) against autograd of the plain version."""
    cot = torch.randn((n,) + coo_stem.out_shape(H, W) + (patches.shape[-1],),
                      device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))

    def grads(fn):
        p, b = patches.clone().requires_grad_(), bias.clone().requires_grad_()
        (fn(p, b) * cot).sum().backward()
        return p.grad, b.grad

    got = grads(lambda p, b: coo_stem.ScatterPatches.apply(p, b, xy, starts, n, H, W,
                                                           torch.float32))
    want = grads(lambda p, b: coo_stem.scatter_patches_plain(p, xy, starts, b, n, H, W,
                                                             torch.float32))
    for g, w, name in zip(got, want, ("patches", "bias")):
        torch.testing.assert_close(g, w, **K2_GRAD_TOL, msg=f"K2 gradient wrt {name}")
    log(f"[K2] gradients, {n} images: patches max diff "
        f"{(got[0] - want[0]).abs().max().item():.3g}, bias "
        f"{(got[1] - want[1]).abs().max().item():.3g} (tol {K2_GRAD_TOL})")


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def serve(model, ds, batch_size):
    """One timed ``predict_split`` pass, with the kernels' counts reset
    just before it and read just after."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = predict_split(model, ds, ds.norm(), batch_size, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    num_batches = math.ceil(len(ds) / batch_size)
    want = ((2 * num_batches, 0) if model.cfg.embedder == "dense"
            else (0, 2 * num_batches))
    assert counts == want, (model.cfg.embedder, counts, want)

    n = len(ds)
    real_prongs = int((ds.prong_targets >= 0).sum())
    ev, pr = out["event_probabilities"], out["prong_probabilities"]
    assert ev.shape == (n, 4), ev.shape
    assert pr.shape == (real_prongs, 8), (pr.shape, real_prongs)
    assert np.isfinite(ev).all() and np.isfinite(pr).all()
    np.testing.assert_allclose(ev.sum(-1), 1.0, atol=1e-3)
    np.testing.assert_allclose(pr.sum(-1), 1.0, atol=1e-3)
    np.testing.assert_array_equal(out["event_targets"], ds.event_targets)
    return seconds, counts


def check_serving(embedder):
    """Returns the model and the kernels' launches over the timed passes."""
    cfg = dataclasses.replace(production_config("bfloat16"), embedder=embedder)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    log(f"[serve {embedder}] {os.path.basename(OPTION_FILE)}: densenet "
        f"{list(cfg.densenet_structure)} growth {cfg.densenet_growth_rate}, "
        f"{cfg.num_encoder_layers} encoder layers, {cfg.compute_dtype}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    total = np.zeros(2, np.int64)
    for batch_size, num_events in SERVE_EVENTS:
        ds = InMemoryEvents(num_events, SEED + batch_size)
        # warm-up over the same events: the batcher's slot ladder gives the
        # prong bank several sizes, and the timed passes meet none anew
        serve(model, ds, batch_size)
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(SERVE_PASSES):
            seconds, counts = serve(model, ds, batch_size)
            total += counts
            rates.append(num_events / seconds)
        log(f"[serve {embedder}] b{batch_size}: {num_events} events x {SERVE_PASSES} "
            f"passes, median {statistics.median(rates):.1f} events/s, min "
            f"{min(rates):.1f}, max {max(rates):.1f} (predict_split, host batching "
            f"included); launches per pass K1 {counts[0]}, K2 {counts[1]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, total


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

def check_training():
    """The coo family's train step at full width; returns K2's launches."""
    options = Options.load(OPTION_FILE)
    cfg = dataclasses.replace(production_config("bfloat16"), embedder="coo")
    assert (cfg.dropout, cfg.pixel_noise_std, options.gradient_clip) == (0.1, 0.001, 43)
    assert options.batch_size == TRAIN_BATCH and options.optimizer == "AdamW"
    steps = TRAIN_WARMUP + TRAIN_STEPS
    ds = InMemoryEvents(TRAIN_BATCH * steps, SEED + 3)
    batcher = Batcher(ds, batch_size=TRAIN_BATCH, shuffle=True, seed=SEED)
    batches = [to_device(b, "cuda") for b in batcher.epoch(0)]
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED)).to("cuda")
    state = create_train_state(model, options, ds.norm(), len(batcher), seed=SEED)
    step = make_train_step(model, options)
    log(f"[train] coo, {os.path.basename(OPTION_FILE)}: AdamW lr {options.learning_rate:g}, "
        f"warmup {options.learning_rate_warmup_epochs} epoch of {len(batcher)} steps, "
        f"clip {options.gradient_clip}, dropout {cfg.dropout}, pixel noise "
        f"{cfg.pixel_noise_std}, {cfg.compute_dtype}, batch {TRAIN_BATCH}")

    params_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats_before = {n: b.clone() for n, b in model.named_buffers()}
    got_grad = set()
    torch.cuda.synchronize()
    reset_counts()
    for batch in batches[:TRAIN_WARMUP]:
        metrics = step(state, batch)
        got_grad |= {n for n, p in model.named_parameters() if bool(p.grad.any())}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[TRAIN_WARMUP:steps]:
        metrics = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    assert counts == (0, 2 * steps), (counts, steps)
    loss, grad_norm = float(metrics["train_loss"]), float(metrics["grad_norm"])
    assert math.isfinite(loss) and math.isfinite(grad_norm), (loss, grad_norm)
    unchanged = [n for n, p in model.named_parameters()
                 if n in got_grad and torch.equal(p.detach(), params_before[n])]
    assert not unchanged, f"parameters with a gradient that did not change: {unchanged}"
    moved = [n for n in stats_before if n.endswith("running_mean")
             and not torch.equal(dict(model.named_buffers())[n], stats_before[n])]
    num_bn = sum(n.endswith("running_mean") for n in stats_before)
    assert len(moved) == num_bn, (len(moved), num_bn)
    log(f"[train] coo b{TRAIN_BATCH}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
        f"{1e3 * seconds / TRAIN_STEPS:.2f} ms/step, "
        f"{TRAIN_BATCH * TRAIN_STEPS / seconds:.1f} events/s; last loss {loss:.5f}, "
        f"grad_norm {grad_norm:.4f}; {len(got_grad)} of {len(params_before)} parameters "
        f"got a gradient, all changed; {num_bn} BatchNorm means moved; launches K1 "
        f"{counts[0]}, K2 {counts[1]} ({steps} steps); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    eval_ds = InMemoryEvents(EVAL_EVENTS, SEED + 4)
    eval_step = make_eval_step(model, options)
    totals = init_metric_state(4, 8, options.auc_bins, "cuda")
    reset_counts()
    for batch in Batcher(eval_ds, batch_size=TRAIN_BATCH, drop_last=False).epoch(0):
        totals = eval_step(state, to_device(batch, "cuda"), totals)
    eval_counts = read_counts()
    assert eval_counts == (0, 2 * EVAL_EVENTS // TRAIN_BATCH), eval_counts
    result = finalize_metrics(totals)
    for key in ("event_epoch_AUC", "prong_epoch_AUC", "val_loss"):
        assert math.isfinite(result[key]), (key, result[key])
    log(f"[train] eval over {EVAL_EVENTS} events: event AUC "
        f"{result['event_epoch_AUC']:.4f}, prong AUC {result['prong_epoch_AUC']:.4f}, "
        f"val_loss {result['val_loss']:.5f}; K2 launches {eval_counts[1]}")
    return counts[1] + eval_counts[1]


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

def max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_paths(bf16_model):
    cfg = production_config("float32")
    dense = TransformerCVN(cfg).eval()
    dense.load_state_dict(bf16_model.state_dict())
    dense = dense.to("cuda")
    coo = TransformerCVN(dataclasses.replace(cfg, embedder="coo")).eval()
    coo.load_state_dict(bf16_model.state_dict())
    coo = coo.to("cuda")
    ds = InMemoryEvents(16, SEED + 2)
    batch = Batcher(ds, batch_size=16).build_batch(np.arange(16))
    b = to_device(batch, "cuda")
    norm = to_device(ds.norm(), "cuda")
    P = b["slot_batch"].shape[0]
    with torch.inference_mode():
        ev_k, pr_k = dense(b, norm)
        images = [
            densify_images_plain(b[f"{k}_xy"], dense.preprocess_values(b[f"{k}_vals"]),
                                 b[f"{k}_owner"], n, H, W)
            for k, n in (("event", 16), ("prong", P))
        ]
        ev_p, pr_p, _, _ = dense.forward_from_images(
            *images, b["features"], b["extra"], b["prong_mask"],
            b["slot_batch"], b["slot_pos"], b["slot_mask"], norm)
        ev_c, pr_c = coo(b, norm)
    torch.testing.assert_close(ev_k, ev_p, **PATH_TOL)
    torch.testing.assert_close(pr_k, pr_p, **PATH_TOL)
    log(f"[paths] K1 vs plain densify, fp32 logits: event max diff "
        f"{max_diff(ev_k, ev_p):.3g}, prong {max_diff(pr_k, pr_p):.3g} (tol {PATH_TOL})")
    torch.testing.assert_close(ev_c, ev_k, **FAMILY_TOL)
    torch.testing.assert_close(pr_c, pr_k, **FAMILY_TOL)
    log(f"[paths] coo vs dense logits, same weights, fp32: event max diff "
        f"{max_diff(ev_c, ev_k):.3g}, prong {max_diff(pr_c, pr_k):.3g} (tol {FAMILY_TOL})")

    pe = coo.prong_embedding
    with torch.inference_mode():
        for key, n, net, mask in (("event", 16, pe.event_pixel_embedding, None),
                                  ("prong", P, pe.prong_pixel_embedding, b["slot_mask"])):
            values = coo.preprocess_values(b[f"{key}_vals"])
            via_k2 = net((b[f"{key}_xy"], values, b[f"{key}_owner"], n, b[f"{key}_starts"]),
                         mask)
            conv0 = net.features.conv0
            stem = coo_stem_conv_plain(b[f"{key}_xy"], values, b[f"{key}_owner"],
                                       conv0.weight.permute(2, 3, 1, 0), conv0.bias, n, H, W)
            via_plain = densenet_post_stem(net, stem, mask)
            torch.testing.assert_close(via_k2, via_plain, **PATH_TOL)
            log(f"[paths] coo {key} embedder through K2 vs the plain stem, fp32: max diff "
                f"{max_diff(via_k2, via_plain):.3g} (tol {PATH_TOL})")

    small = Batcher(ds, batch_size=4).build_batch(np.arange(4))
    for name, model in (("dense", dense), ("coo", coo)):
        with torch.inference_mode():
            ev_g, pr_g = model(to_device(small, "cuda"), norm)
            cpu_model = model.to("cpu")
            ev_cpu, pr_cpu = cpu_model(to_device(small, "cpu"), to_device(ds.norm(), "cpu"))
        torch.testing.assert_close(ev_g.cpu(), ev_cpu, **CPU_TOL)
        torch.testing.assert_close(pr_g.cpu(), pr_cpu, **CPU_TOL)
        log(f"[paths] {name}: card vs CPU, fp32 logits (batch 4): event max diff "
            f"{max_diff(ev_g.cpu(), ev_cpu):.3g}, prong {max_diff(pr_g.cpu(), pr_cpu):.3g} "
            f"(tol {CPU_TOL})")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke "
                 "test needs an NVIDIA GPU")
    device_and_build()
    k1 = check_k1()
    dense_model, dense_counts = check_serving("dense")
    conv0 = dense_model.prong_embedding.event_pixel_embedding.features.conv0
    k2 = check_k2(conv0.weight.detach().float(), conv0.bias.detach().float())
    _, coo_counts = check_serving("coo")
    train_launches = check_training()
    check_paths(dense_model)
    kernels = []
    for (err, ms, plain_ms, lib_ms, bound_ms), name, source, replaces, launches in (
            (k1, "densify", "dune_transformercvn_torch/csrc/densify.cu",
             "dune_transformercvn_tpu/ops/pallas_densify.py:61", int(dense_counts[0])),
            (k2, "coo_stem_scatter", "dune_transformercvn_torch/csrc/coo_stem.cu",
             "dune_transformercvn_tpu/ops/pallas_coo_stem.py:146",
             int(coo_counts[1]) + train_launches)):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
