#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device and build: the card's name and power limit from ``nvidia-smi``;
   every kernel under ``dune_transformercvn_torch/csrc`` is built with
   ``nvcc``; TF32 is switched off so the float32 comparisons below are
   float32.
2. Kernel K1 (COO -> dense densify) against its plain PyTorch version on the
   card, at the serving path's shapes, float32 and bfloat16, plain and
   space-to-depth layout, with duplicate pixels, an empty image, coordinates
   out of range (negative too) and padding rows past ``starts[-1]``; the
   median time of both.
3. Serving at full width: the production option file, bfloat16, random
   weights from a seed, events made in memory from a seed; ``predict_split``
   at batch 16 and at batch 64, one warm-up pass over the same events (so
   every prong-slot shape is seen), then timed passes with K1's launch
   count reset before each and read after it; probabilities finite, rows
   summing to 1, shapes right.
4. Kernel path against plain path: with float32 compute, ``model.forward``
   (through K1) against ``model.forward_from_images`` on plainly densified
   images; and the card against the CPU on a small batch.
5. A JSON line of every ported kernel, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dune_transformercvn_torch.data import Batcher, InMemoryEvents
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.ops.densify import (
    densify_images_cuda, densify_images_plain)
from dune_transformercvn_torch.predict import predict_split, to_device
from dune_transformercvn_torch.profile_serving import OPTION_FILE, production_config
from dune_transformercvn_torch.utils.build import build, sources

SEED = 0

H, W, C = 400, 280, 3
# K1 tolerances against the plain version (torch's index_put_).  float32:
# both add duplicates in bank order in float32.  bfloat16: the kernel rounds
# to bf16 after every add (as the TPU kernel does), the plain version on the
# card adds in float32 and rounds once; sums stay below ~4, so the gap is a
# few bf16 ulps of 2^-6.
K1_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -5)}
# Logits through K1 against logits through the plain densify, float32 with
# TF32 off: the images agree to float32 rounding and the rest runs the same
# ops, so only cuDNN/cuBLAS summation order separates them.
PATH_TOL = dict(rtol=1e-4, atol=1e-4)
# Serving: (batch size, events) -- a few seconds a pass at the rates of
# PERF.md -- and the timed passes after the warm-up.
SERVE_EVENTS = ((16, 512), (64, 1024))
SERVE_PASSES = 3
# The card against the CPU, float32: cuDNN and oneDNN sum in other orders
# through ~30 conv layers.
CPU_TOL = dict(rtol=1e-3, atol=1e-3)


def log(msg: str = ""):
    print(msg, flush=True)


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
    outputs = {name: build(name) for name in sources()}
    log(f"[build] {sorted(outputs)} built in {time.perf_counter() - t0:.2f} s")
    for name, text in outputs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line or "Used" in line):
                log(f"[build] {name}: {line.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[build] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


# ---------------------------------------------------------------------------
# phase 2
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


def cuda_time_ms(fn, warmup=3, bursts=5, per_burst=20):
    """Median over bursts of the mean time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_burst)
    return statistics.median(times)


def check_k1():
    """K1 against the plain version; returns (max abs err, kernel ms, plain
    ms) with the times summed over the two banks of one batch-16 forward
    in bfloat16, plain layout (the serving path's calls)."""
    rng = np.random.default_rng(SEED)
    # (label, images, hits per image): the event and packed prong banks at
    # batch 16 and 64 (prong slots from the batcher's capacity ladder)
    banks = [("event b16", 16, 160.0), ("prong b16", 128, 160.0 / 3),
             ("event b64", 64, 160.0), ("prong b64", 384, 160.0 / 3)]
    max_err = 0.0
    forward_ms = {"kernel": 0.0, "plain": 0.0}
    log("[K1] case                          max_abs_err   kernel_ms   plain_ms")
    for label, n, hits in banks:
        xy, values, owner, starts = make_bank(rng, n, hits)
        xy_t, owner_t = torch.from_numpy(xy).cuda(), torch.from_numpy(owner).cuda()
        starts_t = torch.from_numpy(starts).cuda()
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
                k_ms = cuda_time_ms(
                    lambda: densify_images_cuda(xy_t, vals_t, starts_t, n, H, W, s2d))
                p_ms = cuda_time_ms(
                    lambda: densify_images_plain(xy_t, vals_t, owner_t, n, H, W, s2d))
                name = f"{label} {str(dtype)[6:]} {'s2d' if s2d else 'nhwc'}"
                log(f"[K1] {name:<30} {err:<13.3g} {k_ms:<11.4f} {p_ms:.4f}")
                if dtype == torch.bfloat16 and not s2d and label.endswith("b16"):
                    forward_ms["kernel"] += k_ms
                    forward_ms["plain"] += p_ms
    log(f"[K1] per b16 forward (2 banks, bf16): kernel {forward_ms['kernel']:.4f} ms, "
        f"plain {forward_ms['plain']:.4f} ms")
    return max_err, forward_ms["kernel"], forward_ms["plain"]


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def serve(model, ds, batch_size):
    """One timed ``predict_split`` pass, with K1's count read around it."""
    torch.cuda.synchronize()
    densify_images_cuda.launches = 0
    t0 = time.perf_counter()
    out = predict_split(model, ds, ds.norm(), batch_size, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = densify_images_cuda.launches
    num_batches = math.ceil(len(ds) / batch_size)
    assert launches == 2 * num_batches, (launches, num_batches)

    n = len(ds)
    real_prongs = int((ds.prong_targets >= 0).sum())
    ev, pr = out["event_probabilities"], out["prong_probabilities"]
    assert ev.shape == (n, 4), ev.shape
    assert pr.shape == (real_prongs, 8), (pr.shape, real_prongs)
    assert np.isfinite(ev).all() and np.isfinite(pr).all()
    np.testing.assert_allclose(ev.sum(-1), 1.0, atol=1e-3)
    np.testing.assert_allclose(pr.sum(-1), 1.0, atol=1e-3)
    np.testing.assert_array_equal(out["event_targets"], ds.event_targets)
    return seconds, launches


def check_serving():
    cfg = production_config("bfloat16")
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    log(f"[serve] {os.path.basename(OPTION_FILE)}: densenet {list(cfg.densenet_structure)} "
        f"growth {cfg.densenet_growth_rate}, {cfg.num_encoder_layers} encoder layers, "
        f"{cfg.compute_dtype}, {sum(p.numel() for p in model.parameters())} parameters")
    total = 0
    for batch_size, num_events in SERVE_EVENTS:
        ds = InMemoryEvents(num_events, SEED + batch_size)
        # warm-up over the same events: the batcher's slot ladder gives the
        # prong bank several sizes, and the timed passes meet none anew
        serve(model, ds, batch_size)
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(SERVE_PASSES):
            seconds, launches = serve(model, ds, batch_size)
            total += launches
            rates.append(num_events / seconds)
        log(f"[serve] b{batch_size}: {num_events} events x {SERVE_PASSES} passes, "
            f"median {statistics.median(rates):.1f} events/s, min {min(rates):.1f}, "
            f"max {max(rates):.1f} (predict_split, host batching included); "
            f"K1 launches {launches} per pass; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, total


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def check_paths(bf16_model):
    cfg = production_config("float32")
    model = TransformerCVN(cfg).eval()
    model.load_state_dict(bf16_model.state_dict())
    model = model.to("cuda")
    ds = InMemoryEvents(16, SEED + 2)
    batch = Batcher(ds, batch_size=16).build_batch(np.arange(16))
    b = to_device(batch, "cuda")
    norm = to_device(ds.norm(), "cuda")
    with torch.inference_mode():
        ev_k, pr_k = model(b, norm)
        images = [
            densify_images_plain(b[f"{k}_xy"], model.preprocess_values(b[f"{k}_vals"]),
                                 b[f"{k}_owner"], n, H, W)
            for k, n in (("event", 16), ("prong", b["slot_batch"].shape[0]))
        ]
        ev_p, pr_p, _, _ = model.forward_from_images(
            *images, b["features"], b["extra"], b["prong_mask"],
            b["slot_batch"], b["slot_pos"], b["slot_mask"], norm)
    torch.testing.assert_close(ev_k, ev_p, **PATH_TOL)
    torch.testing.assert_close(pr_k, pr_p, **PATH_TOL)
    log(f"[paths] K1 vs plain densify, fp32 logits: event max diff "
        f"{(ev_k - ev_p).abs().max().item():.3g}, prong "
        f"{(pr_k - pr_p).abs().max().item():.3g} (tol {PATH_TOL})")

    small = Batcher(ds, batch_size=4).build_batch(np.arange(4))
    with torch.inference_mode():
        ev_g, pr_g = model(to_device(small, "cuda"), norm)
        cpu_model = model.to("cpu")
        ev_c, pr_c = cpu_model(to_device(small, "cpu"), to_device(ds.norm(), "cpu"))
    torch.testing.assert_close(ev_g.cpu(), ev_c, **CPU_TOL)
    torch.testing.assert_close(pr_g.cpu(), pr_c, **CPU_TOL)
    log(f"[paths] card vs CPU, fp32 logits (batch 4): event max diff "
        f"{(ev_g.cpu() - ev_c).abs().max().item():.3g}, prong "
        f"{(pr_g.cpu() - pr_c).abs().max().item():.3g} (tol {CPU_TOL})")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke "
                 "test needs an NVIDIA GPU")
    device_and_build()
    max_err, k1_ms, plain_ms = check_k1()
    model, launches = check_serving()
    check_paths(model)
    log(json.dumps({"kernels": [{
        "name": "densify",
        "route": "cuda",
        "source": "dune_transformercvn_torch/csrc/densify.cu",
        "replaces": "dune_transformercvn_tpu/ops/pallas_densify.py:61",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
