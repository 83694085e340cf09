"""Training CLI of the port, with the flags of the repository's ``train.py``:

    python -m dune_transformercvn_torch.train -o <options.json> -n <name>
        [-c ckpt] [--auto_resume] [-b N] [-e eval_steps] [--max_steps N]
        [-v] [-d] [--device cuda|cpu] [--compile] [--cuda_graph]

Where a flag names something of XLA, the port does its eager counterpart:
``--debug_nans`` turns on autograd's anomaly detection, ``--profile``
writes a ``torch.profiler`` trace of steps 11-15, ``--threads`` sets
torch's CPU threads.  ``-g`` and ``--log_compiles`` have no counterpart in
the eager port and exit with a message.  ``--device`` (default ``cuda``) is
the port's own.  The HDF5 files are read with ``h5py``.

Data-parallel training runs one process per device under ``torchrun``,
whose variables (``RANK``, ``WORLD_SIZE``, ...) make the CLI join a process
group (``nccl`` on the card, ``gloo`` with ``--device cpu``) and leave it at
exit; ``num_gpu`` (``--gpus``) is clamped to the world size::

    torchrun --nproc_per_node 2 -m dune_transformercvn_torch.train -o <options.json> \
        -n <name> --gpus 2 --device cpu

``--cuda_graph`` (with ``--steps_per_dispatch`` K, K steps a replay)
captures each rank's steps with their collectives on nccl, one process a
card; with ``--device cpu`` the ranks run the same step bodies uncaptured
over gloo.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from typing import Optional


def main(
    training_file: Optional[str],
    options_file: Optional[str],
    checkpoint: Optional[str],
    name: str,
    log_dir: Optional[str],
    fp16: bool,
    fp32: bool,
    graph: bool,
    verbose: bool,
    batch_size: Optional[int],
    eval: int,
    gpus: Optional[int],
    threads: Optional[int],
    debug: bool,
    sparse: bool,
    sdxl: bool,
    max_steps: Optional[int] = None,
    steps_per_dispatch: Optional[int] = None,
    model_parallel: Optional[int] = None,
    embedder: Optional[str] = None,
    profile: bool = False,
    debug_nans: bool = False,
    auto_resume: bool = False,
    log_compiles: bool = False,
    device: str = "cuda",
    compile: bool = False,
    cuda_graph: bool = False,
):
    if graph or log_compiles:
        flag = "-g/--graph" if graph else "--log_compiles"
        raise SystemExit(
            f"{flag} dumps or logs XLA compilations, which the port has no "
            "counterpart of (--compile's graphs log through TORCH_LOGS=graph_code)")

    import torch

    from ..config import Options
    from ..parallel import world

    master = world()[1] == 0

    if sparse:
        embedder_name = "sparse"
    elif sdxl:
        embedder_name = "sdxl"
    elif embedder:
        embedder_name = embedder
    else:
        embedder_name = "dense"

    options = Options()
    if options_file is not None:
        with open(options_file) as f:
            options.update_options(json.load(f))

    options.verbose_output = verbose
    if training_file is not None:
        options.training_file = training_file
    if gpus is not None:
        print(f"Overriding device count: {gpus}")
        options.num_gpu = gpus
    if batch_size is not None:
        print(f"Overriding Batch Size: {batch_size}")
        options.batch_size = batch_size
    if steps_per_dispatch is not None:
        options.steps_per_dispatch = steps_per_dispatch
    if model_parallel is not None:
        options.model_parallel = model_parallel
    if threads is not None:
        torch.set_num_threads(threads)
    if fp16:
        options.compute_dtype = "bfloat16"
    if fp32:
        options.compute_dtype = "float32"
    if eval is not None:  # -e overrides; else keep the option-file value
        options.eval_interval = eval

    if debug:
        print("Debug Mode: small batch, no logger")
        options.batch_size = min(options.batch_size, 32)
        options.num_dataloader_workers = 0

    if not options.training_file:
        raise SystemExit(
            "No training file configured: pass -o <options.json> with a "
            "training_file entry, or -t <file.h5>."
        )

    if debug_nans:
        # aborts with a traceback at the backward of the first op that
        # produced a NaN
        torch.autograd.set_detect_anomaly(True)

    if master:
        options.display()

    from .loop import Trainer

    run_dir = None
    if auto_resume:
        # Preemption recovery: continue the newest version dir that already
        # has checkpoints instead of starting version_N+1.
        from ..utils.rundir import find_resumable

        run_dir = find_resumable(log_dir or os.getcwd(), name)
        if run_dir is not None:
            print(f"Auto-resuming in {run_dir}")

    trainer = Trainer(
        options,
        embedder=embedder_name,
        name=name,
        log_dir=log_dir,
        run_dir=run_dir,
        debug=debug,
        verbose=verbose,  # options.verbose_output was clobbered to this above
        device=device,
        compile=compile,
        graph=cuda_graph,
    )
    if checkpoint is not None:
        trainer.resume(checkpoint)
    elif auto_resume and run_dir is not None:
        trainer.resume()

    if trainer.run_dir is not None and master:
        print(f"Run directory: {trainer.run_dir}")

    trainer.fit(max_steps=max_steps, profile=profile)


def parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__)
    p.add_argument("-t", "--training_file", type=str, default=None,
                   help="Input file containing training data.")
    p.add_argument("-o", "--options_file", type=str, default=None,
                   help="JSON file with option overloads.")
    p.add_argument("-c", "--checkpoint", type=str, default=None,
                   help="Optional checkpoint to resume from.")
    p.add_argument("-n", "--name", type=str, default="lightning_logs",
                   help="The sub-directory to create for this run.")
    p.add_argument("-l", "--log_dir", type=str, default=None,
                   help="Output directory for checkpoints and logs.")
    p.add_argument("-fp16", action="store_true",
                   help="bfloat16 compute (float32 parameters and optimizer).")
    p.add_argument("-fp32", action="store_true",
                   help="Force float32 compute.")
    p.add_argument("-g", "--graph", action="store_true",
                   help="XLA only: no counterpart in the port (exits).")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Output additional information.")
    p.add_argument("-b", "--batch_size", type=int, default=None,
                   help="Override per-device batch size.")
    p.add_argument("-e", "--eval", type=int, default=None,
                   help="Number of steps between validations.")
    p.add_argument("--gpus", type=int, default=None,
                   help="Override device count (num_gpu; one process each).")
    p.add_argument("--threads", type=int, default=None,
                   help="torch.set_num_threads for host CPU work.")
    p.add_argument("-d", "--debug", action="store_true",
                   help="Debug smoke-path super-switch.")
    p.add_argument("--sparse", action="store_true",
                   help="Use the sparse-convolution network.")
    p.add_argument("--sdxl", action="store_true",
                   help="Use the SDXL-style attention CNN network.")
    p.add_argument("--embedder", type=str, default=None,
                   choices=["dense", "coo", "sdxl", "sparse", "mobilenet",
                            "resnet", "convnext", "fcnn"],
                   help="Pixel-embedder family (generalizes --sparse/--sdxl).")
    p.add_argument("--max_steps", type=int, default=None,
                   help="Stop after N optimizer steps (smoke runs).")
    p.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="Implies static batch shapes; with --cuda_graph each group "
                        "of K steps is one CUDA graph replay, else one step a call.")
    p.add_argument("--model_parallel", type=int, default=None,
                   help="Tensor-parallel group size (the port runs without).")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace of steps 11-15.")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True).")
    p.add_argument("--log_compiles", action="store_true",
                   help="XLA only: no counterpart in the port (exits).")
    p.add_argument("--auto_resume", action="store_true",
                   help="Continue the latest version dir from its last "
                        "checkpoint (preemption recovery).")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device to train on (default cuda; no fallback).")
    p.add_argument("--compile", action="store_true",
                   help="Compile the train, eval and predict steps with torch.compile "
                        "(Inductor), one graph a batch shape: the counterpart of jax.jit. "
                        "Takes the option file's remat_cnn, remat_embedder and "
                        "embedder_chunk.")
    p.add_argument("--cuda_graph", action="store_true",
                   help="Replay the train (K steps a graph), eval and predict steps as "
                        "CUDA graphs, one a batch shape: one process, or one a card "
                        "under torchrun (nccl; --model_parallel too); every optimizer "
                        "and the option file's remat_cnn, remat_embedder and "
                        "embedder_chunk.")
    return p


if __name__ == "__main__":
    from ..parallel import init_from_env

    args = parser().parse_args()
    grouped = init_from_env(args.device)
    try:
        main(**vars(args))
    finally:
        if grouped:
            import torch.distributed

            torch.distributed.destroy_process_group()
