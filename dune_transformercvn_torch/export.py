"""Export: the one-event serving graphs of the LArSoft hook.

Port of ``dune_transformercvn_tpu/export.py``.  The reference exports three
TorchScript graphs (CreateCompiled.ipynb cells 6-14), each taking ONE tensor
``[(1+Npng), 3, 400, 280]`` of raw pixel counts, with dummy features, extra
and masks made inside the graph and the 10-class event output folded to 4
as ``[sum 0:4, sum 4:8, 8, 9]``:

* ``pid``        -> (event softmax [4], prong softmax [Npng, 8])
* ``embeddings`` -> (event vector [D], prong vectors [Npng, D])
* ``combined``   -> all four

The port writes the same three graphs as ``torch.export`` programs
(``torch.export.save``, ``.pt2``), with the JAX package's calling
convention: static shapes, input ``[1 + max_prongs, C, H, W]`` float32 raw
counts plus a 0-d int32 ``num_prongs``; rows past ``num_prongs`` are zeroed
and masked inside the graph and the caller reads the first ``num_prongs``
output rows.  A ladder of prong capacities (``prong_buckets``) gives one
graph per rung and variant, the same weights in each, so a 3-prong event
need not pay for 20 prong images.  :func:`load_exported` round-trips an
artifact.  A program exported on the card runs on the card.

One event is one dispatch there with ``load_exported(path, graph=True)``:
the program captured once into a CUDA graph (``utils.graphs.EventGraph``),
each call a copy of the event into its static inputs and one replay, as
the JAX package runs one PJRT ``Execute`` of a compiled rung an event.
With ``bench_buckets`` on the card the meta records each rung's captured
cost, ``graph_bucket_ms``, beside the eager ``bucket_ms``; the serving
side passes ``select_bucket`` the costs of the dispatch it uses.

CLI::

    python -m dune_transformercvn_torch.export <run_dir> [--check]
        [--buckets 4,8,12 | none] [--bench_buckets] [--device cuda|cpu] [--aoti]

``--aoti`` then compiles every written program into an AOTInductor package
for the same device (:mod:`.aoti`), timed too with ``--bench_buckets``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import time
import warnings
from dataclasses import replace
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .models.network import TransformerCVN
from .train.loop import resolve_device
from .utils.graphs import EventGraph

VARIANTS = ("pid", "embeddings", "combined")

# Default prong-capacity ladder (the JAX package's).  A caller serving an
# Npng-prong event picks a rung P >= Npng: the cheapest by the measured
# ``bucket_ms`` of the export meta, else the smallest (select_bucket).
DEFAULT_PRONG_BUCKETS = (4, 8, 12)


def _normalize_buckets(prong_buckets: Sequence[int] | None,
                       max_prongs: int) -> Tuple[int, ...]:
    """Sorted unique capacities clipped to [1, max_prongs]; the full
    capacity is always present so every event has a bucket."""
    buckets = {int(p) for p in (prong_buckets or ())}
    buckets = {p for p in buckets if 1 <= p < max_prongs}
    buckets.add(max_prongs)
    return tuple(sorted(buckets))


def select_bucket(prong_buckets: Sequence[int], num_prongs: int,
                  bucket_ms: Dict[int, float] | None = None) -> int:
    """Serving-side dispatch: among capacities >= ``num_prongs``, the
    cheapest by ``bucket_ms`` when every eligible rung has a cost (ties to
    the smaller capacity), else the smallest; an over-full event takes the
    largest rung."""
    eligible = [p for p in prong_buckets if p >= num_prongs]
    if not eligible:
        return max(prong_buckets)
    if bucket_ms and all(p in bucket_ms for p in eligible):
        return min(eligible, key=lambda p: (bucket_ms[p], p))
    return min(eligible)


def _fold_event_probs(probs: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Fold a detailed 10-class softmax onto the 4 current classes
    (CreateCompiled.ipynb cell 6: [sum 0:4, sum 4:8, 8, 9])."""
    if num_classes != 10:
        return probs
    return torch.stack([probs[..., 0:4].sum(-1), probs[..., 4:8].sum(-1),
                        probs[..., 8], probs[..., 9]], dim=-1)


class InferenceGraph(nn.Module):
    """One-event inference over raw pixel maps: ``forward(pixel_maps [1+P, C,
    H, W] float32 raw counts, num_prongs 0-d int32)`` -> the ``variant``'s
    tuple.  ``norm`` (the dataset statistics) is held as buffers."""

    def __init__(self, model: TransformerCVN, variant: str,
                 norm: Mapping[str, np.ndarray]):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown export variant {variant!r}; one of {VARIANTS}")
        if model.cfg.one_hot_pixels:
            # the reference exporter hardcodes /255-or-log1p preprocessing too
            raise NotImplementedError(
                "export of one_hot_pixels models is not supported (the raw-count "
                "input convention assumes /255 or log1p preprocessing)")
        self.model = model
        self.variant = variant
        device = next(model.parameters()).device
        for key in ("mean", "std", "extra_mean", "extra_std"):
            self.register_buffer(key, torch.as_tensor(np.asarray(norm[key]), device=device))

    def forward(self, pixel_maps, num_prongs):
        cfg = self.model.cfg
        P = cfg.max_prongs
        # NCHW (the LArSoft convention) -> NHWC, preprocess without noise
        images = pixel_maps.permute(0, 2, 3, 1).float()
        images = torch.log1p(images) if cfg.log_pixels else images / 255.0
        images = images.to(cfg.dtype)
        prong_ids = torch.arange(P, device=pixel_maps.device)
        real = prong_ids < num_prongs
        # zeroed padding rows leave the BatchNorm masking nothing to leak
        prong_images = images[1:] * real[:, None, None, None].to(images.dtype)
        # dummy reco features and extra (cell 6 makes zeros and ones masks)
        features = images.new_zeros((1, P, cfg.features_dim), dtype=torch.float32)
        extra = images.new_zeros((1, cfg.extra_dim), dtype=torch.float32)
        slot_batch = (~real).to(torch.int32)          # 1 == out of range: padding
        norm = {"mean": self.mean, "std": self.std,
                "extra_mean": self.extra_mean, "extra_std": self.extra_std}
        event_logits, prong_logits, event_hidden, prong_hidden = (
            self.model.forward_from_images(
                images[:1], prong_images, features, extra, real[None, :],
                slot_batch, prong_ids.to(torch.int32), real, norm))
        # split-mode models carry generation logits after the current head
        event_probs = torch.softmax(event_logits[0, :cfg.num_event_classes], dim=-1)
        event_probs = _fold_event_probs(event_probs, cfg.num_event_classes)
        prong_probs = torch.softmax(prong_logits[0], dim=-1)
        if self.variant == "pid":
            return event_probs, prong_probs
        if self.variant == "embeddings":
            return event_hidden[0], prong_hidden[0]
        return event_probs, prong_probs, event_hidden[0], prong_hidden[0]


def build_inference_fn(model: TransformerCVN, variant: str,
                       norm: Mapping[str, np.ndarray]) -> InferenceGraph:
    """The ``variant``'s one-event graph over ``model`` (put in eval mode)."""
    return InferenceGraph(model.eval(), variant, norm)


def with_max_prongs(model: TransformerCVN, max_prongs: int) -> TransformerCVN:
    """``model`` at another prong capacity, sharing its parameters and
    buffers: a shallow copy whose ``cfg`` alone differs (no parameter shape
    depends on ``max_prongs``)."""
    if max_prongs == model.cfg.max_prongs:
        return model
    rung = copy.copy(model)
    rung.cfg = replace(model.cfg, max_prongs=max_prongs)
    return rung


def export_program(graph: InferenceGraph, example_pixels, example_n):
    """``torch.export`` of one graph at the example inputs' shapes, with no
    autograd (``torch.utils.checkpoint`` then stays off the graph).  The
    program keeps no example inputs: saved, they would add the pixel maps
    (28 MB at 400x280 and 20 prongs) to every artifact."""
    with torch.no_grad(), warnings.catch_warnings():
        # a chunked sdxl embedder whose chunk does not divide P warns per trace
        warnings.simplefilter("ignore", UserWarning)
        exported = torch.export.export(graph, (example_pixels, example_n), strict=False)
    exported.example_inputs = None
    return exported


def _time_bucket_ms(fn, example_pixels, example_n, *, rounds: int = 32,
                    repeats: int = 3) -> float:
    """Per-event ms of one rung's graph: the best of ``repeats`` windows of
    ``rounds`` back-to-back calls, by CUDA events on the card and
    ``perf_counter`` on the CPU, after one warm-up call.  (The JAX package
    times 96 rounds of a compiled call of ~1.5 ms; an eager graph's call is
    host-bound at tens of ms, and 32 fill a window of seconds.)"""
    device = example_pixels.device
    fn(example_pixels, example_n)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(rounds):
                fn(example_pixels, example_n)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(rounds):
                fn(example_pixels, example_n)
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms / rounds)
    return best


def _output_avals(exported) -> list:
    """Shape and dtype of each output of an ``ExportedProgram``."""
    outputs = next(n for n in exported.graph.nodes if n.op == "output").args[0]
    return [{"shape": list(n.meta["val"].shape),
             "dtype": str(n.meta["val"].dtype).replace("torch.", "")} for n in outputs]


def export_model(
    model: TransformerCVN,
    norm: Mapping[str, np.ndarray],
    output_dir: str,
    prefix: str = "transformercvn",
    prong_buckets: Sequence[int] | None = None,
    bench_buckets: bool = False,
    device=None,
) -> Dict[str, str]:
    """Write the three graphs for every rung of ``prong_buckets`` (the full
    capacity always among them); returns ``{variant[_pP]: path}``.

    Each artifact is one ``torch.export`` program,
    ``{prefix}_{variant}[_pP].pt2`` (the full capacity unsuffixed), traced
    in eval mode with no autograd on ``device`` (``None``: the card), where
    it then runs.  ``{prefix}_export_meta.json`` records the calling
    convention with the JAX package's keys.  ``bench_buckets`` times each
    rung's pid graph per event on ``device`` and records ``bucket_ms``, from
    which the serving side picks the cheapest eligible rung; on the card
    also ``graph_bucket_ms``, the program captured as one CUDA graph
    (``load_exported(..., graph=True)``).  ``model``'s
    parameters must be on ``device``; its training flags are as they were
    when it returns.
    """
    device = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != device.type:
        raise ValueError(f"the model's parameters are on {on}, not on {device}")
    with _eval_mode(model):
        return _export(model, norm, output_dir, prefix, prong_buckets, bench_buckets, device)


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    """``model`` in eval mode, each module's training flag restored after."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


def _export(model, norm, output_dir, prefix, prong_buckets, bench_buckets,
            device) -> Dict[str, str]:
    cfg = model.cfg
    os.makedirs(output_dir, exist_ok=True)
    buckets = _normalize_buckets(prong_buckets, cfg.max_prongs)
    pixel_shape = (1 + cfg.max_prongs, cfg.pixel_channels, cfg.image_height, cfg.image_width)
    example_n = torch.tensor(3, dtype=torch.int32, device=device)

    paths: Dict[str, str] = {}
    output_avals: Dict[str, list] = {}
    bucket_files: Dict[str, Dict[str, str]] = {v: {} for v in VARIANTS}
    bucket_ms: Dict[str, float] = {}
    graph_ms: Dict[str, float] = {}
    for bucket in buckets:
        rung = with_max_prongs(model, bucket)
        example_pixels = torch.zeros((1 + bucket,) + pixel_shape[1:], device=device)
        suffix = "" if bucket == cfg.max_prongs else f"_p{bucket}"
        for variant in VARIANTS:
            exported = export_program(build_inference_fn(rung, variant, norm),
                                      example_pixels, example_n)
            if bucket == cfg.max_prongs:
                output_avals[variant] = _output_avals(exported)
            name = f"{prefix}_{variant}{suffix}.pt2"
            path = os.path.join(output_dir, name)
            torch.export.save(exported, path)
            paths[variant + suffix] = path
            bucket_files[variant][str(bucket)] = name
            if bench_buckets and variant == "pid":
                program = _no_grad_call(exported.module())
                bucket_ms[str(bucket)] = _time_bucket_ms(program, example_pixels, example_n)
                if device.type == "cuda":
                    graph_ms[str(bucket)] = _time_bucket_ms(
                        EventGraph(program, f"{name} graph"), example_pixels, example_n)

    with open(os.path.join(output_dir, f"{prefix}_export_meta.json"), "w") as f:
        json.dump({
            "input_shape": list(pixel_shape),
            "input_dtypes": ["f32", "i32"],
            "platforms": [device.type],
            "outputs": output_avals,
            "max_prongs": cfg.max_prongs,
            "prong_buckets": list(buckets),
            "bucket_files": bucket_files,
            **({"bucket_ms": bucket_ms, "bucket_ms_platform": device.type}
               if bucket_ms else {}),
            **({"graph_bucket_ms": graph_ms} if graph_ms else {}),
            "num_event_classes_folded": 4,
            "num_prong_classes": cfg.num_prong_classes,
            "hidden_dim": cfg.hidden_dim,
            "variants": {
                "pid": "event softmax [4], prong softmax [max_prongs, Kpr]",
                "embeddings": "event vector [D], prong vectors [max_prongs, D]",
                "combined": "pid outputs + embeddings outputs",
            },
            "calling_convention": (
                "pick a bucket P >= num_prongs from prong_buckets -- the "
                "cheapest per the costs of the dispatch used when present "
                "(bucket_ms: the program called eagerly; graph_bucket_ms: "
                "load_exported(..., graph=True), one CUDA graph replay; "
                "aoti_bucket_ms / aoti_graph_bucket_ms: the same for the "
                "AOTInductor packages and the C++ loader without / with "
                "--graph), else the smallest (select_bucket); pad prong maps "
                "to P rows ([1+P, C, H, W] float32 raw counts on the "
                "exporting device), pass the real count as a 0-d int32 "
                "num_prongs; read the first num_prongs output rows"),
        }, f, indent=2)
    return paths


def _no_grad_call(module):
    def call(pixels, num_prongs):
        with torch.no_grad():
            return module(pixels, num_prongs)
    return call


def load_exported(path: str, graph: bool = False):
    """Round-trip loader: a callable ``(pixels, num_prongs) -> outputs``
    over the saved program (on the device it was exported on).  ``graph``:
    on the card the program is captured at the first call as one CUDA
    graph and each call replays it (``utils.graphs.EventGraph``; the
    outputs returned are copies); on the CPU it runs uncaptured."""
    program = _no_grad_call(torch.export.load(path).module())
    return EventGraph(program, f"{os.path.basename(path)} graph") if graph else program


def export_run_dir(run_dir: str, output_dir: str = None, checkpoint: str = "best",
                   embedder: str = None,
                   prong_buckets: Sequence[int] | None = DEFAULT_PRONG_BUCKETS,
                   bench_buckets: bool = False, device=None,
                   datasets=None) -> Dict[str, str]:
    """The CreateCompiled flow: a port run dir's checkpoint (``best`` or
    ``last``) -> the serving graphs, BatchNorm-folded when the run's
    ``fold_eval_bn`` is set; into ``<run_dir>/export`` by default.
    ``datasets``: the Trainer's (train, validation, test), whose statistics
    normalise the features (default: the option file's HDF5 files)."""
    from .config import Options
    from .ops.fold import fold_eval_batchnorm
    from .train import CheckpointManager, Trainer

    options = Options.load(os.path.join(run_dir, "options.json"))
    trainer = Trainer(options, embedder=embedder, run_dir=None, debug=True,
                      verbose=False, device=device, datasets=datasets)
    mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"),
                            top_k=options.checkpoint_top_k)
    step = mgr.ranked_best_step() if checkpoint == "best" else None
    if checkpoint == "best" and step is None:
        warnings.warn(
            "no ranked checkpoint in this run (never completed a validation "
            "pass?) -- exporting the LATEST checkpoint instead of 'best'",
            stacklevel=2)
    step = mgr.latest_step() if step is None else step
    mgr.restore(trainer.state, step)
    model = trainer.state.model
    if options.fold_eval_bn:
        # the serving graphs skip the conv -> BN normalize passes
        model.load_state_dict(fold_eval_batchnorm(model.state_dict(), model.cfg.embedder)[0])
    norm = {k: v.cpu().numpy() for k, v in trainer.state.norm.items()}
    return export_model(model, norm, output_dir or os.path.join(run_dir, "export"),
                        prong_buckets=prong_buckets, bench_buckets=bench_buckets,
                        device=trainer.device)


def check_exported(path: str, max_prongs: int, channels: int, height: int, width: int,
                   num_prongs: int = 3, seed: int = 0, device=None) -> None:
    """Sanity-run an exported artifact on ``device`` (CreateCompiled.ipynb
    cells 10-13: 'Check to make sure the traced models work')."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pixels = rng.uniform(size=(1 + max_prongs, channels, height, width)) < 0.01
    pixels = (pixels * rng.uniform(16, 255, pixels.shape)).astype(np.float32)
    outputs = load_exported(path)(torch.from_numpy(pixels).to(device),
                                  torch.tensor(num_prongs, dtype=torch.int32, device=device))
    for i, out in enumerate(outputs):
        value = out.float().cpu().numpy()
        if not np.isfinite(value).all():
            raise ValueError(f"non-finite output {i} from {path}")
        print(f"  output {i}: shape {value.shape}, "
              f"range [{value.min():.4f}, {value.max():.4f}]")


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(description=__doc__)
    parser.add_argument("run_dir")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--checkpoint", default="best", choices=["best", "last"])
    parser.add_argument("--sdxl", action="store_true")
    parser.add_argument("--sparse", action="store_true")
    parser.add_argument("--embedder", default=None,
                        help="Override the embedder family (default: the run's "
                             "recorded options.json value)")
    parser.add_argument("--check", action="store_true",
                        help="sanity-run each exported artifact")
    parser.add_argument("--buckets", default=None,
                        help="comma list of prong-capacity buckets (the full capacity "
                             "is always added), or 'none' for the single max_prongs "
                             "graph; default "
                             f"{','.join(map(str, DEFAULT_PRONG_BUCKETS))}")
    parser.add_argument("--bench_buckets", action="store_true",
                        help="time each rung's pid graph on the export device and "
                             "record per-event bucket_ms in the export meta (on the "
                             "card also graph_bucket_ms, the program as one CUDA graph)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to export for (default cuda; no fallback)")
    parser.add_argument("--aoti", action="store_true",
                        help="also compile each program into an AOTInductor package "
                             "(<name>.aoti.pt2) for the same device, read back from its "
                             ".pt2 file; with --bench_buckets each rung's pid package "
                             "is timed too (aoti_bucket_ms in the meta; on the card "
                             "also aoti_graph_bucket_ms, the package as one CUDA graph)")
    args = parser.parse_args(argv)
    embedder = "sparse" if args.sparse else "sdxl" if args.sdxl else args.embedder
    if args.buckets is None:
        buckets = DEFAULT_PRONG_BUCKETS
    elif args.buckets.strip().lower() == "none":
        buckets = ()
    else:
        buckets = tuple(int(p) for p in args.buckets.split(","))
    paths = export_run_dir(args.run_dir, args.output_dir, args.checkpoint, embedder,
                           prong_buckets=buckets, bench_buckets=args.bench_buckets,
                           device=args.device)
    for variant, path in paths.items():
        print(f"{variant}: {path}")
    if args.aoti:
        from .aoti import package_run_dir

        packages = package_run_dir(args.run_dir, os.path.dirname(next(iter(paths.values()))),
                                   device=args.device, bench=args.bench_buckets)
        for variant, path in packages.items():
            print(f"{variant} package: {path}")

    if args.check:
        export_dir = os.path.dirname(next(iter(paths.values())))
        meta_path = os.path.join(export_dir, "transformercvn_export_meta.json")
        if not os.path.exists(meta_path):
            raise SystemExit(f"export metadata missing: {meta_path}")
        with open(meta_path) as f:
            meta = json.load(f)
        shape = meta["input_shape"]
        for key, path in paths.items():
            # a rung's artifact takes [1+P, C, H, W]; P is in its key
            capacity = int(key.rsplit("_p", 1)[1]) if "_p" in key else meta["max_prongs"]
            print(f"checking {key}:")
            check_exported(path, capacity, shape[1], shape[2], shape[3],
                           num_prongs=min(3, capacity), device=args.device)


if __name__ == "__main__":
    main()
