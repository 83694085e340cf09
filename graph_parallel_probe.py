#!/usr/bin/env python3
"""Data-parallel training at ``chip_smoke.CUT_DEPTH`` on several NVIDIA
GPUs, one process a card over nccl, with the compiled step beside the
eager step and the 4-step CUDA graph: a reading that ``chip_smoke.py``
does not take (the compiled step's cold compile costs minutes on every
rank).

    python3 graph_parallel_probe.py [--ranks 4]

The option file's widths at ``CUT_DEPTH``, bf16, b16 a data shard, static
shapes, sync-BN, its dropout and noise.  Each run takes ``PAR_STEPS``
steps from the same seeded start: eager; ``PAR_STEPS / PAR_K`` replays of
the ``PAR_K``-step graph, whose state and metrics must equal eager's bit
for bit; the compiled step (``compile=True``, its first call the cold
compile), with train_loss's largest gap from eager's.  Per rank: ms/step
over the last ``PAR_TIMED`` steps, the first call's seconds, peak memory
and K1's launches, with the card's name and power limit.  Needs
``--ranks`` CUDA devices."""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 1500


def smoke():
    sys.path.insert(0, HERE)
    import chip_smoke

    return chip_smoke


def run(s, ranks, device, graph, compile):
    """``PAR_STEPS`` steps of the cut network from its seeded start; returns
    the whole state on the host, train_loss for each step and the reading."""
    s.free_memory()
    options = s.fit_options()
    options.batch_size = s.TRAIN_BATCH
    options.num_gpu, options.model_parallel = ranks, 1
    options.sync_batch_norm = True
    options.static_batch_shapes = True
    trainer = s.Trainer(options, debug=True, device=device, verbose=False, graph=True,
                        datasets=(s.InMemoryEvents(ranks * s.TRAIN_BATCH * s.PAR_STEPS,
                                                   s.SEED + 80),
                                  s.InMemoryEvents(s.DP_VAL_EVENTS, s.SEED + 81), None))
    batches = [s.to_device(b, device) for b in
               itertools.islice(trainer.train_batcher.epoch(0), s.PAR_STEPS)]
    model, mesh = trainer.state.model, trainer.mesh
    k = s.PAR_K if graph else 1
    if graph:
        step = s.make_train_step(model, options, mesh, graph=True, steps_per_dispatch=k)
        calls = s.stack_groups(batches, k)
    else:
        step = s.make_train_step(model, options, mesh, compile=compile)
        calls = batches
    untimed = len(calls) - s.PAR_TIMED // k
    torch.cuda.reset_peak_memory_stats(device)

    def steps():
        out, first_s = [], None
        for i, call in enumerate(calls):
            if i == untimed:
                s.meet(device)
                t0 = time.perf_counter()
            t = time.perf_counter()
            out.append(step(trainer.state, call))
            if i == 0:
                torch.cuda.synchronize(device)
                first_s = time.perf_counter() - t
        torch.cuda.synchronize(device)
        return out, first_s, time.perf_counter() - t0

    (metrics, first_s, seconds), counts = s.counted(steps)
    losses = torch.cat([m["train_loss"].float().reshape(-1) for m in metrics]).cpu()
    reading = dict(ms_per_step=1e3 * seconds / s.PAR_TIMED, first_s=first_s, k1=counts[0],
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    host = s.to_host(trainer.state.state_dict())
    assert trainer.state.step == s.PAR_STEPS and torch.isfinite(losses).all(), losses
    del trainer, model, step, calls, batches
    s.free_memory()
    return host, losses, reading


def rank_main(rank, ranks, rendezvous, out_path):
    import torch.distributed as dist

    s = smoke()
    device = s.join_tp_group(rank, ranks, "nccl", rendezvous)
    out = dict(rank=rank, device=str(device), runs={})
    try:
        host, losses, out["runs"]["eager"] = run(s, ranks, device, False, False)
        eager = s.flat_state(host)
        host, graph_losses, out["runs"]["graph_k4"] = run(s, ranks, device, True, False)
        got = s.flat_state(host)
        out["runs"]["graph_k4"]["exact"] = bool(
            torch.equal(graph_losses, losses) and all(torch.equal(got[n], eager[n])
                                                      for n in eager))
        _, compiled_losses, out["runs"]["compiled"] = run(s, ranks, device, False, True)
        out["runs"]["compiled"]["loss_gap"] = float((compiled_losses - losses).abs().max())
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.rank, args.ranks, os.path.join(args.work, "rendezvous"),
                         os.path.join(args.work, f"rank{args.rank}.json"))
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        sys.exit(f"graph_parallel_probe: needs {args.ranks} NVIDIA GPUs")
    s = smoke()
    smi = s.device_and_build()
    work = tempfile.mkdtemp(prefix="graph_parallel_probe_")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ranks", str(args.ranks), "--rank",
         str(r), "--work", work], cwd=HERE,
        env={**os.environ, "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(args.ranks)})
        for r in range(args.ranks)]
    try:
        for proc in procs:
            proc.wait(timeout=TIMEOUT_S)
    finally:
        s.stop(procs)
    if any(proc.returncode != 0 for proc in procs):
        sys.exit(f"graph_parallel_probe: ranks exited {[proc.returncode for proc in procs]}")
    for r in range(args.ranks):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            result = json.load(f)
        for name, run_ in result["runs"].items():
            extra = (f"; against eager {'bit for bit' if run_['exact'] else 'NOT bit for bit'}"
                     if "exact" in run_ else
                     f"; train_loss within {run_['loss_gap']:.3g} of eager's"
                     if "loss_gap" in run_ else "")
            print(f"[graph-dp probe] dp{args.ranks}, depth {s.CUT_DEPTH}, bf16, "
                  f"b{s.TRAIN_BATCH} a data shard, rank {r} on {result['device']}, {name}: "
                  f"{run_['ms_per_step']:.2f} ms/step over the last {s.PAR_TIMED} of "
                  f"{s.PAR_STEPS} steps; first call {run_['first_s']:.2f} s; peak "
                  f"{run_['peak_gib']:.2f} GiB; K1 {run_['k1']}{extra} ({smi})", flush=True)
        assert result["runs"]["graph_k4"]["exact"], (r, "graph_k4 differs from eager")


if __name__ == "__main__":
    main()
