"""Serving readings that ``chip_smoke.py`` does not take: the one-event
ladder at full depth, and int8 ``predict_split`` compiled.

    python3 serving_probe.py ladder [--out serving_ladder_h100.json]
    python3 serving_probe.py int8 [--out serving_int8_h100.json]

``ladder``: the production option file's network at full depth, bfloat16,
random weights from a seed, saved as a run dir's checkpoint; exported
through ``export.export_run_dir`` with the ladder (4, 20) and
``bench_buckets`` (each rung's eager ``bucket_ms`` and captured
``graph_bucket_ms``), its ``pid`` programs packaged with AOTInductor through
``aoti.package_run_dir(variants=("pid",), bench=True)`` (``aoti_bucket_ms``
and ``aoti_graph_bucket_ms``: two full-depth compiles, minutes each), then
the C++ loader on one event at ``num_prongs`` 3 and 17, without and with
``--graph``: the rung it picks and its mean run time.  Nothing else runs on
the card meanwhile.

``int8``: the option file's network at ``chip_smoke.CUT_DEPTH``, bfloat16,
scales calibrated on 4 batches; ``predict_split`` at batch 16 over
``chip_smoke.VARIANT_EVENTS`` events in static batch shapes (one graph a
mode), int8 and bf16, eager, as CUDA graphs
(``graph=True``) and compiled (``compile=True``, Inductor into an empty
cache: the first compiled pass's seconds, the compile included), two timed
passes of each in turns after a first pass of each; the compiled and graph
int8 outputs against the eager int8 pass.

Both print one JSON line (the card's name and power limit in it) and write
it to ``--out``.  Need one CUDA device."""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", tempfile.mkdtemp(prefix="serving_probe_"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as s  # noqa: E402
from dune_transformercvn_torch import Options  # noqa: E402
from dune_transformercvn_torch.aoti import package_run_dir  # noqa: E402
from dune_transformercvn_torch.data import Batcher, InMemoryEvents  # noqa: E402
from dune_transformercvn_torch.export import export_run_dir, select_bucket  # noqa: E402
from dune_transformercvn_torch.models import TransformerCVN  # noqa: E402
from dune_transformercvn_torch.ops import quant  # noqa: E402
from dune_transformercvn_torch.predict import predict_split, to_device  # noqa: E402
from dune_transformercvn_torch.train import CheckpointManager, Trainer  # noqa: E402
from dune_transformercvn_torch.utils.build import build_loader  # noqa: E402

LADDER, PRONGS, LOADER_REPEAT = (4,), (3, 17), 50


def ladder(smi):
    """The full-depth ladder: {rung: {bucket_ms, graph_bucket_ms,
    aoti_bucket_ms, aoti_graph_bucket_ms}}, the compile seconds and the C++
    loader's readings."""
    work = tempfile.mkdtemp(prefix="ladder_")
    run_dir = os.path.join(work, "run")
    options = Options.load(s.OPTION_FILE)
    options.compute_dtype = "bfloat16"
    datasets = s.fit_datasets()
    trainer = Trainer(options, run_dir=run_dir, datasets=datasets, device="cuda", verbose=False)
    CheckpointManager(os.path.join(run_dir, "checkpoints")).save(trainer.state, 0)
    del trainer
    s.free_memory()
    t0 = time.perf_counter()
    export_run_dir(run_dir, checkpoint="last", prong_buckets=LADDER, bench_buckets=True,
                   device="cuda", datasets=datasets)
    export_s = time.perf_counter() - t0
    print(f"exported in {export_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    package_run_dir(run_dir, variants=("pid",), device="cuda", bench=True)
    package_s = time.perf_counter() - t0
    export_dir = os.path.join(run_dir, "export")
    meta_path = os.path.join(export_dir, "transformercvn_export_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    rungs = {str(p): {key: meta[key][str(p)] for key in (
        "bucket_ms", "graph_bucket_ms", "aoti_bucket_ms", "aoti_graph_bucket_ms")}
        for p in meta["prong_buckets"]}
    print(json.dumps({"rungs": rungs}), flush=True)

    loader = build_loader()
    ds = InMemoryEvents(64, s.SEED + 14)
    index = next(i for i in range(len(ds)) if int((ds.prong_targets[i] >= 0).sum()) <= 3)
    full, _ = s.event_pixel_maps(ds, index, meta["max_prongs"])
    pixels_bin = os.path.join(export_dir, "event.bin")
    full.cpu().numpy().tofile(pixels_bin)
    runs = []
    for n in PRONGS:
        for graph in (False, True, True, False):
            proc = subprocess.run(
                [str(loader), os.path.join(export_dir, "transformercvn_pid"), meta_path,
                 pixels_bin, str(n), os.path.join(export_dir, "out.bin"), "--repeat",
                 str(LOADER_REPEAT), *(["--graph"] if graph else [])],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"the loader exited {proc.returncode}:\n{proc.stderr[-4000:]}")
            lines = proc.stderr.splitlines()
            reading = {"num_prongs": n, "graph": graph,
                       "rung": int(s.loader_reading(proc.stderr, "num_prongs")
                                   .split("bucket ")[1].split()[0]),
                       "run_ms": float(s.loader_reading(proc.stderr, "run:").split()[1]),
                       "stderr": lines}
            costs = meta["aoti_graph_bucket_ms" if graph else "aoti_bucket_ms"]
            assert reading["rung"] == select_bucket(
                meta["aoti_prong_buckets"], n, {int(k): v for k, v in costs.items()})
            runs.append(reading)
            print(json.dumps({k: v for k, v in reading.items() if k != "stderr"}), flush=True)
    return {"rungs": rungs, "export_s": export_s, "package_s": package_s,
            "aoti_compile_s": meta["aoti_compile_s"], "loader_runs": runs,
            "loader_repeat": LOADER_REPEAT}


def timed_pass(model, ds, norm, scales, **flags):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (quant.quantized_convs(model, scales) if scales else contextlib.nullcontext()):
        out = predict_split(model, ds, norm, s.TRAIN_BATCH, "cuda", fixed_shape=True, **flags)
    torch.cuda.synchronize()
    return out, len(ds) / (time.perf_counter() - t0), time.perf_counter() - t0


def int8(smi):
    """int8 and bf16 ``predict_split`` at b16, eager, graphs and compiled."""
    model = TransformerCVN(s.cut_config("bfloat16"),
                           generator=torch.Generator().manual_seed(s.SEED)).cuda()
    ds = InMemoryEvents(s.VARIANT_EVENTS, s.SEED + 14)
    norm = ds.norm()
    batches = [to_device(b, "cuda") for b in Batcher(ds, batch_size=s.TRAIN_BATCH).epoch(0)]
    with torch.no_grad():
        for batch in batches[:s.STAT_FORWARDS]:
            model(batch, to_device(norm, "cuda"))
    model.eval()
    scales = quant.calibrate_activation_scales(model, batches[:s.CALIBRATION_BATCHES], norm)
    del batches
    modes = {"eager": {}, "graph": {"graph": True}, "compiled": {"compile": True}}
    first, rates, outs = {}, {}, {}
    with s.bench_precision():
        for name, flags in modes.items():
            for dtype in ("int8", "bf16"):
                out, rate, seconds = timed_pass(model, ds, norm,
                                                scales if dtype == "int8" else None, **flags)
                first[f"{dtype}_{name}"] = seconds
                print(f"first pass {dtype} {name}: {seconds:.2f} s", flush=True)
        for turn in range(2):
            for name, flags in modes.items():
                for dtype in (("int8", "bf16") if turn == 0 else ("bf16", "int8")):
                    out, rate, _ = timed_pass(model, ds, norm,
                                              scales if dtype == "int8" else None, **flags)
                    rates.setdefault(f"{dtype}_{name}", []).append(rate)
                    outs[f"{dtype}_{name}"] = out
    want = outs["int8_eager"]
    agreement = {}
    for name in ("graph", "compiled"):
        got = outs[f"int8_{name}"]
        agreement[name] = {
            k: {"max_diff": float(np.abs(got[f"{k}_probabilities"]
                                         - want[f"{k}_probabilities"]).max()),
                "argmax": float((got[f"{k}_probabilities"].argmax(-1)
                                 == want[f"{k}_probabilities"].argmax(-1)).mean())}
            for k in ("event", "prong")}
    for key, value in want.items():
        np.testing.assert_array_equal(outs["int8_graph"][key], value, err_msg=key)
    steady = {k: len(ds) / max(v) for k, v in rates.items()}
    return {"events": len(ds), "batch": s.TRAIN_BATCH, "depth": dict(s.CUT_DEPTH),
            "events_per_s": rates, "first_pass_s": first,
            "compile_s": {d: first[f"{d}_compiled"] - steady[f"{d}_compiled"]
                          for d in ("int8", "bf16")},
            "against_eager_int8": agreement, "int8_convs": len(scales)}


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("what", choices=("ladder", "int8"))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    smi = s.device_and_build()
    record = {"probe": args.what, "device": smi, "torch": torch.__version__,
              **(ladder(smi) if args.what == "ladder" else int8(smi))}
    line = json.dumps(record)
    print(line, flush=True)
    out = args.out or f"serving_{args.what}_h100.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
