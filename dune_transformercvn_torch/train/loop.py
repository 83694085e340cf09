"""The training orchestrator: the port of
``dune_transformercvn_tpu/train/loop.py::Trainer``, on one device or
data-parallel over the processes of a ``torch.distributed`` group.

Covers dataset creation and statistic sharing (neutrino_base.py:20-49),
per-step LR scheduling, periodic validation with streaming metrics,
TensorBoard/JSONL logging with the reference tag names, top-k checkpointing
keyed on ``val_epoch_AUC`` and resume, and run-dir versioning with the
resolved ``options.json`` dumped beside the logs (train.py:145-149).

Data parallelism (:mod:`..parallel`): one process per device, the group
initialised by the caller.  ``options.num_gpu`` is the device count, clamped
to the world size as the JAX package's ``create_mesh`` clamps it; the global
batch is ``batch_size`` times the number of data shards, each data shard is
assembled and stepped on by its own ranks, and only rank 0 writes the run
dir.  Tensor parallelism (``model_parallel`` mp > 1) is the JAX package's
hybrid mesh: the world is ``world // mp`` data shards of ``mp`` adjacent
ranks, each rank holding 1/mp of every channel-sharded parameter and its
moments and computing 1/mp of the partitioned layers' channels
(``parallel.shard_parameters``); an mp above the world runs without
tensor parallelism, with JAX's note.
"""

from __future__ import annotations

import functools
import itertools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Options
from ..data import Batcher
from ..data.dataset import create_datasets
from ..models.network import ModelConfig, TransformerCVN
from ..ops.masked import sync_batch_norm
from ..parallel import (barrier, create_mesh, data_axis_size, is_hybrid, local_rank,
                        local_shard_ids, shard_parameters)
from ..predict import pinned, predict_split, to_device
from ..utils.rundir import create_run_dir
from .checkpoint import CheckpointManager, restore_from_path, to_host
from .logging import MetricLogger
from .metrics import finalize_metrics, init_metric_state, reduce_metric_state
from .state import create_train_state
from .step import make_eval_step, make_train_step


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A card without an index is the process's
    own, ``cuda:LOCAL_RANK``, which becomes the current device.  There is no
    quiet fallback: without CUDA only an explicit ``"cpu"`` runs."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available (torch.cuda.is_available() is False); pass "
                "device='cpu' (--device cpu) to run on the CPU")
        torch.cuda.set_device(local_rank() if device.index is None else device)
    return device


class Trainer:
    """Trains, validates, checkpoints and predicts, on one device or as one
    rank of a data-parallel process group (every rank builds a Trainer with
    the same options and makes the same calls).

    ``datasets``: a ``(training, validation, testing)`` tuple (testing may be
    ``None``) used in place of ``create_datasets(options)``, e.g. events made
    in memory on a host without h5py; statistics are shared from training
    as they are for the HDF5 splits.

    ``options.steps_per_dispatch`` K > 1 implies static batch shapes, as in
    the JAX package, and keeps its cadence: logs, validations and
    checkpoints fall at the ends of groups of K steps, and an epoch's tail
    of fewer than K batches runs as single steps.  Eagerly every step is
    its own call.  ``graph=True`` is the counterpart of the JAX package's
    dispatch (``make_train_step(..., graph=True)``): each full group of K
    batches is stacked and runs as one replay of a CUDA graph of K steps
    (JAX's ``lax.scan``), the tail as the one-step graph (JAX's
    ``_train_dispatch_iter``), the logs read the group's last step, and
    validation and ``predict_split`` replay graphs of their own.  It takes
    one process, or a process group of one process a card over nccl (data-
    and tensor-parallel: each rank replays its data shard's K steps with
    the step's collectives inside, in lockstep with the others, every rank
    in the batch shapes the global index list gives; gloo with CUDA
    tensors raises, ``step.check_graphable``), every optimizer (AdamW
    as :class:`.optimizer.GraphAdamW`; the optax chains are graph-safe)
    and every memory recipe (``remat_cnn``, ``remat_embedder``,
    ``embedder_chunk``); on a ``"cpu"`` device the same step bodies run
    without a capture, a group's over gloo.

    ``compile=True`` compiles the train, eval and predict steps (the JAX
    package jits them): one Inductor graph for each batch shape, with
    Dynamo's recompile limit raised by the shapes each batcher can lay out
    (``Batcher.shape_bound``; past it a step raises), the memory recipes
    included (``train/step.py`` says what stays eager).
    """

    def __init__(
        self,
        options: Options,
        embedder: Optional[str] = None,
        name: str = "lightning_logs",
        log_dir: Optional[str] = None,
        run_dir: Optional[str] = None,
        debug: bool = False,
        verbose: Optional[bool] = None,
        callbacks=None,
        log_every_n_steps: int = 50,
        device=None,
        datasets=None,
        compile: bool = False,
        graph: bool = False,
    ):
        self.device = resolve_device(device)
        self.compile, self.graph = compile, graph
        self.options = options
        # Resolve the embedder family: explicit argument wins, else the
        # options value (evaluate reloads it from the run dir's
        # options.json); record the resolution so options.json carries it.
        options.embedder = embedder or options.embedder or "dense"
        embedder = options.embedder
        self.verbose = options.verbose_output if verbose is None else verbose
        # Validation callbacks fn(step, metrics) -- the HPO reporting hook
        # (reference SHERPA pattern: send the epoch objective per validation,
        # network/sherpa/*.py); any tuner can subscribe here.
        self.callbacks = list(callbacks or [])

        # ---- processes: one device each, dp data shards of mp ranks ----------
        # model_parallel > 1 adds the "model" axis (tensor parallelism);
        # batches shard over the data axis only, so num_shards (per-shard
        # batch layout, step accounting) is dp.  An mp above the devices
        # falls back to no TP (checkpoints are layout-independent, so a
        # TP-trained run's options.json still evaluates on one device).
        self.mesh = create_mesh(options.num_gpu, options.model_parallel, self.device.type)
        self.num_shards = data_axis_size(self.mesh)
        self.rank = self.mesh.rank

        # ---- data ------------------------------------------------------------
        self.training_dataset, self.validation_dataset, self.testing_dataset = (
            create_datasets(options) if datasets is None else datasets
        )
        if options.normalize_features:
            stats = self.training_dataset.compute_statistics()
            self.validation_dataset.compute_statistics(*stats)
            if self.testing_dataset is not None:
                self.testing_dataset.compute_statistics(*stats)
            mean, std, extra_mean, extra_std = stats
        else:
            f = self.training_dataset.num_features
            mean, std = np.zeros(f, np.float32), np.ones(f, np.float32)
            extra_mean, extra_std = np.float32(0.0), np.float32(1.0)
        self.norm = {
            "mean": mean, "std": std,
            "extra_mean": extra_mean, "extra_std": extra_std,
        }

        # Reference step accounting (neutrino_base.py:47-49): batch_size is
        # per-device; the global batch is batch_size * device count.
        self.global_batch = options.batch_size * self.num_shards
        self.steps_per_epoch = len(self.training_dataset) // self.global_batch
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"dataset of {len(self.training_dataset)} events is smaller than "
                f"the global batch {self.global_batch}"
            )
        self.total_steps = self.steps_per_epoch * options.epochs

        self.steps_per_dispatch = max(1, int(options.steps_per_dispatch))
        batcher_kwargs = dict(
            batch_size=self.global_batch,
            num_shards=self.num_shards,
            prong_bucket_multipliers=options.prong_bucket_multipliers,
            coo_granularity=options.coo_bucket_granularity,
            seed=options.seed,
            fixed_shape=options.static_batch_shapes or self.steps_per_dispatch > 1,
            # each rank assembles only its data shard; the bucket sizes come
            # from the global index list, so every rank builds the same shapes
            local_shards=local_shard_ids(self.mesh) if self.num_shards > 1 else None,
        )
        self.train_batcher = Batcher(self.training_dataset, shuffle=True, **batcher_kwargs)
        # drop_last=False: validation splits smaller than the global batch
        # still validate (the wrap-padded tail rows carry target -1 and are
        # excluded from losses and metric statistics)
        self.val_batcher = Batcher(
            self.validation_dataset, shuffle=False, drop_last=False, **batcher_kwargs
        )
        if len(self.validation_dataset) == 0:
            raise ValueError("validation split is empty; adjust train_validation_split")
        self.num_workers = max(
            1, min(options.num_dataloader_workers, os.cpu_count() or 1)
        )
        # Scalar-log cadence (Lightning's log_every_n_steps, default 50 --
        # what the reference trainer runs with); each flush reads one step's
        # metrics back from the device.
        self.log_every_n_steps = max(1, int(log_every_n_steps))

        # ---- model + optimizer + state ----------------------------------------
        ds = self.training_dataset
        self.model_config = ModelConfig.from_options(
            options,
            ds.num_features,
            ds.num_extra,
            ds.pixel_features,
            ds.num_event_classes,
            ds.num_prong_classes,
            image_shape=ds.pixel_shape,
            embedder=embedder,
        )
        model = TransformerCVN(
            self.model_config, generator=torch.Generator().manual_seed(options.seed)
        ).to(self.device)
        if options.sync_batch_norm and self.num_shards > 1:
            sync_batch_norm(model, self.mesh.data_group)
        if is_hybrid(self.mesh):
            # tensor parallelism: channel-shard the parameters over the
            # model axis before the optimizer makes their moments
            shard_parameters(model, self.mesh)
        self.state = create_train_state(
            model, options, self.norm, self.steps_per_epoch, seed=options.seed, graph=graph
        )
        self.schedule = self.state.schedule
        if self.verbose:
            from ..utils.summary import param_count, summarize_params

            print(summarize_params(model, max_depth=2))
            print(f"Parameters: {param_count(model):,}")
            print(f"Device: {self.device} ({self.num_shards} data shard(s) of "
                  f"{self.mesh.mp} process(es)); global batch {self.global_batch}")

        # ---- step functions (compile, graph: one graph a batch shape) ---------
        train_shapes, val_shapes = ((self.train_batcher.shape_bound(),
                                     self.val_batcher.shape_bound())
                                    if compile or graph else (1, 1))
        self.train_step = make_train_step(
            model, options, self.mesh, compile, train_shapes, graph,
            self.steps_per_dispatch if graph else 1)
        # the tail of fewer than K batches: the one-step graph, made at need
        self._single_train_step = self.train_step if (
            not graph or self.steps_per_dispatch == 1) else None
        self.eval_step = make_eval_step(model, options, compile, val_shapes, graph)

        # ---- run dir / logging / checkpoints: rank 0 writes -------------------
        self.is_master = self.rank == 0
        if run_dir is None and not debug and self.is_master:
            run_dir = create_run_dir(log_dir or os.getcwd(), name)
        self.run_dir = run_dir
        self.logger = MetricLogger(run_dir, enabled=run_dir is not None and self.is_master)
        # every rank given a run dir can resume from it; only rank 0 saves
        self.checkpoints = (
            CheckpointManager(
                os.path.join(run_dir, "checkpoints"), top_k=options.checkpoint_top_k
            )
            if run_dir is not None
            else None
        )
        if run_dir is not None and self.is_master:
            options.save(os.path.join(run_dir, "options.json"))

    # -------------------------------------------------------------------------

    def _host_batches(self, batcher, epoch, start_batch=0, pin=True):
        """The epoch's batches, assembled on the worker threads and, for the
        card, copied there into pinned memory (``pin``)."""
        return batcher.prefetch_epoch(
            epoch,
            depth=max(2, self.num_workers),
            num_workers=self.num_workers,
            start_batch=start_batch,
            transform=pinned if pin and self.device.type == "cuda" else None,
        )

    def _single_step(self):
        if self._single_train_step is None:
            self._single_train_step = make_train_step(
                self.state.model, self.options, self.mesh, self.compile,
                self.train_batcher.shape_bound(), graph=True)
        return self._single_train_step

    def _dispatches(self, host_batches, grouped: int):
        """``(steps, call, took)`` for each call of a train step over the
        epoch's batches, the first ``grouped`` in groups of K: ``took`` is
        the steps of the dispatch that ends with the call (the cadence is
        checked there), 0 inside a group.  Eagerly one step a call; with
        ``graph`` a full group of K stacked batches is one call, as the JAX
        package's ``_train_dispatch_iter`` yields."""
        K, state = self.steps_per_dispatch, self.state
        if not self.graph:
            for i, batch in enumerate(self._device_prefetch(host_batches)):
                took = 1 if i >= grouped else 0 if (i + 1) % K else K
                yield 1, functools.partial(self.train_step, state, batch), took
            return
        on_card = self.device.type == "cuda"

        def placed(batch):  # pinned for the graph's copy, or CPU tensors
            return pinned(batch) if on_card else to_device(batch, self.device)

        group = []
        for i, batch in enumerate(host_batches):
            if i >= grouped or K == 1:
                yield 1, functools.partial(self._single_step(), state, placed(batch)), 1
                continue
            group.append(batch)
            if len(group) == K:
                stacked = {k: np.stack([b[k] for b in group]) for k in group[0]}
                group = []
                yield K, functools.partial(self.train_step, state, placed(stacked)), K

    def _device_prefetch(self, host_iterator):
        """Move batches to the device one step ahead.  The copies come from
        pinned memory and do not block the host, so batch i+1's copy is
        queued behind step i's kernels while the host goes on."""
        pending = None
        for batch in host_iterator:
            ready, pending = pending, to_device(batch, self.device, non_blocking=True)
            if ready is not None:
                yield ready
        if pending is not None:
            yield pending

    def resume(self, checkpoint_path: Optional[str] = None):
        """Restore the full train state from a checkpoint path or the run
        dir's latest (the `-c` / auto-resume flow)."""
        if checkpoint_path is not None:
            restore_from_path(checkpoint_path, self.state)
        else:
            if self.checkpoints is None:
                raise FileNotFoundError(
                    "resume() without a checkpoint_path needs a run_dir-backed "
                    "trainer (this one has no CheckpointManager)"
                )
            self.checkpoints.restore(self.state)
        if self.verbose:
            print(f"Resumed from step {self.state.step}")

    # -------------------------------------------------------------------------

    def validate(self) -> Dict[str, float]:
        """Metrics over the validation split.  Eval mode: the BatchNorm
        statistics are not updated and nothing draws from the state's
        generator."""
        # model_config.num_event_classes == the metric head's class count (the
        # 4-way current head when split_event_targets, else the dataset's)
        totals = init_metric_state(
            self.model_config.num_event_classes,
            self.training_dataset.num_prong_classes,
            self.options.auc_bins,
            self.device,
        )
        for batch in self._device_prefetch(self._host_batches(self.val_batcher, 0)):
            totals = self.eval_step(self.state, batch, totals)
        return finalize_metrics(reduce_metric_state(totals, self.mesh.data_group))

    def predict_split(self, split: str = "validation", graph: Optional[bool] = None):
        """Batched inference over a split (the Evaluate.ipynb cell-14 loop).

        Returns event probabilities/targets for every event and prong
        probabilities/targets for every *real* prong, plus each prong's
        owning event index; in split mode the targets are remapped to the
        4-way current head's.  With ``options.fold_eval_bn`` it predicts with
        a BatchNorm-folded copy of the model (the JAX Trainer's
        ``_inference_state``); training and validation keep the raw state.
        Data-parallel, each rank predicts its data shard of every batch and
        every rank returns all rows, in order.  ``graph`` (default: the
        Trainer's) predicts through CUDA graphs.
        """
        dataset = {
            "training": self.training_dataset,
            "validation": self.validation_dataset,
            "testing": self.testing_dataset,
        }[split]
        if dataset is None:
            raise ValueError(f"no {split} dataset configured")
        options = self.options
        return predict_split(
            self.state.model,
            dataset,
            {k: v.cpu().numpy() for k, v in self.state.norm.items()},
            self.global_batch,
            self.device,
            coo_granularity=options.coo_bucket_granularity,
            fixed_shape=options.static_batch_shapes or self.num_shards > 1,
            prong_bucket_multipliers=options.prong_bucket_multipliers,
            fold_eval_bn=options.fold_eval_bn,
            mesh=self.mesh,
            compile=self.compile,
            graph=self.graph if graph is None else graph,
        )

    def _log_confusions(self, metrics: Dict[str, float], step: int):
        if not self.verbose or "event_confusion" not in metrics:
            return
        from ..data.schema import EVENT_CLASS_NAMES, PRONG_CLASS_NAMES

        kev = metrics["event_confusion"].shape[0]
        event_names = (
            EVENT_CLASS_NAMES if kev == len(EVENT_CLASS_NAMES)
            else [f"class_{i}" for i in range(kev)]
        )
        self.logger.log_confusion(
            "val_event_confusion", metrics["event_confusion"], event_names, step
        )
        self.logger.log_confusion(
            "val_prong_confusion", metrics["prong_confusion"], PRONG_CLASS_NAMES, step
        )

    def _after_validation(self, metrics: Dict[str, float], step: int):
        self.logger.log_scalars(metrics, step)
        self._log_confusions(metrics, step)
        # a sharded state is gathered whole on every rank of its TP row
        host = to_host(self.state.state_dict()) if is_hybrid(self.mesh) else None
        if self.checkpoints is not None and self.is_master:
            self.checkpoints.save(self.state, step, metrics.get("val_epoch_AUC"), host)
        barrier()  # the save lands before any rank goes on
        for callback in self.callbacks:
            callback(step, metrics)

    def _fetch_async(self, metrics):
        """Start copying one step's metrics to the host without waiting for
        the step: ``(keys, values, event)``, read once ``event`` has passed
        (on the CPU the values are there already)."""
        keys = list(metrics)
        # a K-step dispatch's metrics are stacked [K]: its last step's
        values = torch.stack([metrics[k].detach().float().reshape(-1)[-1] for k in keys])
        if self.device.type != "cuda":
            return keys, values, None
        values = values.to("cpu", non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return keys, values, event

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, profile_dir: str):
        if self.device.type == "cuda":  # the traced steps' kernels end inside the trace
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        if self.verbose:
            print(f"Profiler trace written to {path}")

    def fit(
        self,
        max_steps: Optional[int] = None,
        eval_interval: Optional[int] = None,
        profile: bool = False,
    ) -> Dict[str, float]:
        """Run the full training loop; returns the last validation metrics.

        ``profile=True`` writes a ``torch.profiler`` Chrome trace of steps
        ~11-15 to ``<run_dir>/profile/trace.json`` (viewable in Perfetto);
        data-parallel, rank 0 traces and the other ranks do not.
        """
        options = self.options
        eval_interval = eval_interval or options.eval_interval
        limit = max_steps or self.total_steps
        last_val: Dict[str, float] = {}
        profile_dir = (
            os.path.join(self.run_dir or os.getcwd(), "profile")
            if profile and self.is_master else None
        )
        profiler = None

        start_step = self.state.step
        start_epoch = start_step // self.steps_per_epoch
        step = start_step
        last_eval_step = -1
        # mid-epoch resume: skip the already-consumed batches of the resumed
        # epoch in index space -- nothing is assembled or transferred for them
        # (the epoch order is deterministic in (seed, epoch))
        resume_skip = start_step % self.steps_per_epoch
        t_start = time.time()
        window_start, window_events = time.time(), 0
        # Metrics are read one step late: reading the step just queued would
        # stall the host until the device finishes it, and the step is
        # host-bound (PERF.md §5).  A log step's metrics start their copy to
        # the host right after it; the next step reads them.
        pending_log = None  # (step, _fetch_async result) awaiting the read

        def flush_pending_log():
            nonlocal pending_log, window_start, window_events
            if pending_log is None:
                return
            log_step, (keys, values, event) = pending_log
            pending_log = None
            if event is not None:
                event.synchronize()
            host = dict(zip(keys, values.tolist()))
            # schedule(log_step) is the lr the NEXT update will apply (the
            # update that produced log_step used step log_step-1) -- matching
            # Lightning's LearningRateMonitor, which logs the post-scheduler-
            # step param-group lr: both series are {(k, schedule(k))}.
            host["lr-AdamW/pg1"] = float(options.learning_rate) * float(
                self.schedule(log_step))
            elapsed = time.time() - window_start
            # a log step flushed right after the previous one (before a
            # validation) has an empty window: no rate, rather than 0
            if elapsed > 0 and window_events:
                host["events_per_second"] = window_events / elapsed
            window_start, window_events = time.time(), 0
            if not self.verbose:
                host.pop("grad_norm", None)
            self.logger.log_scalars(host, log_step)

        K = self.steps_per_dispatch
        try:
            for epoch in range(start_epoch, options.epochs):
                start_batch, resume_skip = resume_skip, 0
                # the JAX package dispatches the epoch's batches in groups of
                # K and its tail of fewer than K as single steps; the cadence
                # below is checked where each dispatch ends
                n = max(0, min(self.steps_per_epoch - start_batch, limit - step))
                grouped = n - n % K
                # a graph's groups are stacked, then pinned
                host_iterator = self._host_batches(self.train_batcher, epoch, start_batch,
                                                   pin=not self.graph)
                for steps, call, took in self._dispatches(
                        itertools.islice(host_iterator, n), grouped):
                    if (
                        profile_dir is not None
                        and step - start_step >= 10
                        and profiler is None
                    ):
                        profiler = self._start_profile()
                    metrics = call()
                    step += steps
                    window_events += self.global_batch * steps
                    if profiler is not None and step - start_step >= 15:
                        self._stop_profile(profiler, profile_dir)
                        profiler = None
                        profile_dir = None  # capture exactly one trace per run
                    if not took:
                        continue  # inside a group of K

                    flush_pending_log()
                    if self.logger.enabled and (
                        step % self.log_every_n_steps < took or step <= 2
                    ):
                        pending_log = (step, self._fetch_async(metrics))

                    if step % eval_interval < took:
                        flush_pending_log()
                        last_val = self.validate()
                        last_eval_step = step
                        self._after_validation(last_val, step)
                        if self.verbose:
                            print(
                                f"step {step}: val_epoch_AUC="
                                f"{last_val['val_epoch_AUC']:.4f} "
                                f"val_epoch_accuracy="
                                f"{last_val['val_epoch_accuracy']:.4f}"
                            )
                host_iterator.close()  # stop its prefetch thread mid-epoch
                if step >= limit:
                    break

            if profiler is not None:  # trace still open (run shorter than 15 steps)
                self._stop_profile(profiler, profile_dir)
                profiler = None
            flush_pending_log()

            # final validation + checkpoint (unless the last step already did it)
            if step != last_eval_step:
                last_val = self.validate()
                self._after_validation(last_val, step)
        finally:
            # Always land here -- including on exceptions and Ctrl-C -- so an
            # open profiler session is closed (an open session slows
            # everything after it in the process).
            if profiler is not None:
                profiler.stop()
        if self.verbose:
            print(
                f"Finished {step - start_step} steps in "
                f"{time.time() - t_start:.1f}s; "
                f"val_epoch_AUC={last_val['val_epoch_AUC']:.4f}"
            )
        self.logger.flush()
        return last_val
