"""Host-side batch assembly producing fixed-shape, shard-ready arrays.

The port's own copy of ``dune_transformercvn_tpu/data/batcher.py`` (numpy
only), kept array-for-array identical so both packages see the same batches
(tests/test_torch_port_data.py holds them together).  The notes on static
shapes below are the JAX package's reasons for them.

The reference collates variable-length COO tensors per batch and trims the
prong axis to the batch max (neutrino_full_base_trainer.py:132-135,
minkowski_dataset.py:29-86) — dynamic shapes that would force an XLA
recompilation per step.  Here every batch has one of a small set of static
shapes:

* the packed-prong axis (only *real* prongs get CNN work, mirroring the
  reference's masked_pack trick, packed_data.py:60-76) is rounded up to
  ``batch_size_per_shard * multiplier`` for a fixed multiplier ladder;
* COO hit counts are rounded up to a coarse granularity;
* padding COO rows carry an out-of-range owner index so the on-device
  scatter-add (`.at[...].add(..., mode="drop")`) ignores them with zero
  branching.

All arrays are laid out ``[num_shards * per_shard, ...]`` along axis 0 so a
``shard_map`` over a 1-D "data" mesh gives each device its own shard with
purely local indices — no cross-device gathers in the input path.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .schema import MAX_PRONGS


@dataclass(frozen=True)
class BatchShape:
    """Static shape signature of a batch (one XLA specialization each)."""

    per_shard: int          # events per shard
    prong_slots: int        # packed prong slots per shard
    event_hits: int         # COO bucket for event hits per shard
    prong_hits: int         # COO bucket for prong hits per shard


def _bucket(value: int, granularity: int) -> int:
    return max(granularity, -(-value // granularity) * granularity)


class Batcher:
    """Assembles global batches from an :class:`EventDataset`.

    Parameters
    ----------
    dataset:
        An ``EventDataset``.
    batch_size:
        Global batch size (events per optimization step).
    num_shards:
        Data-parallel mesh size; ``batch_size`` must divide evenly.
    prong_bucket_multipliers:
        Ladder of packed-prong capacities in average-prongs-per-event, or
        ``None`` for the measured-optimal automatic choice (see below).
    coo_granularity:
        COO hit-count bucket granularity per shard.
    local_shards:
        Multi-host: the data-shard ids this host feeds.  Assembly then
        touches only those shards' events (per-host work is O(local
        batch), SURVEY §2.3 "each host reads a disjoint HDF5 slice")
        while the static bucket sizes are still chosen from the *global*
        index list's metadata, so every host compiles identical shapes
        without communication.  ``None`` assembles all shards.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_shards: int = 1,
        prong_bucket_multipliers: Optional[Sequence[int]] = None,
        coo_granularity: int = 8192,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        fixed_shape: bool = False,
        local_shards: Optional[Sequence[int]] = None,
    ):
        if batch_size % num_shards != 0:
            raise ValueError(
                f"batch_size={batch_size} not divisible by num_shards={num_shards}"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.per_shard = batch_size // num_shards
        # The ladder is stored as absolute slot capacities; multipliers (in
        # average-prongs-per-event) are the user-facing unit.
        if prong_bucket_multipliers is not None:
            caps = {int(m) * self.per_shard
                    for m in prong_bucket_multipliers}
            caps.add((MAX_PRONGS + 1) * self.per_shard)
        elif self.per_shard >= 32:
            # The JAX package's ladder, kept so both packages build the same
            # batches: every multiple of 128 packed slots spanning 4 prongs/
            # event up to the MAX_PRONGS+1 worst case (chosen there for the
            # TPU's 128-wide lane axis; not re-measured on the GPU).
            # Capacity space, not multiplier space: per_shard values sharing
            # few factors with 128 (e.g. 33 or 40) have no 128-aligned
            # multiplier.
            lo = -(-(4 * self.per_shard) // 128)
            hi = -(-((MAX_PRONGS + 1) * self.per_shard) // 128)
            caps = {128 * r for r in range(lo, hi + 1)}
        else:
            # Small shards keep the coarse reference-occupancy ladder.
            caps = {m * self.per_shard for m in (4, 8, 12, 16, 21, MAX_PRONGS + 1)}
        self.capacity_ladder = sorted(caps)
        self.coo_granularity = coo_granularity
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if local_shards is not None:
            local_shards = sorted(int(s) for s in local_shards)
            if any(s < 0 or s >= num_shards for s in local_shards):
                raise ValueError(
                    f"local_shards {local_shards} out of range for "
                    f"num_shards={num_shards}"
                )
        self.local_shards = local_shards

        # fixed_shape: one static signature for every batch (exactly one XLA
        # specialization, and shard shapes that agree across hosts without
        # communication).  Caps are data-independent upper bounds: the sum of
        # the per_shard largest per-event counts bounds any shard's total.
        self.fixed_caps = None
        if fixed_shape:
            self.fixed_caps = self._bounding_caps()

    def shape_bound(self) -> int:
        """How many batch shapes this batcher can lay out: one with
        ``fixed_shape``; else each rung of the capacity ladder up to the one
        the fullest batch needs, times each hit bucket up to the fullest
        batch's, for the event and the prong banks (the caps
        ``fixed_shape`` would take)."""
        if self.fixed_caps is not None:
            return 1
        caps = self._bounding_caps()
        rungs = self.capacity_ladder.index(caps.prong_slots) + 1
        return (rungs * (caps.event_hits // self.coo_granularity)
                * (caps.prong_hits // self.coo_granularity))

    def _bounding_caps(self) -> BatchShape:
        ds = self.dataset
        b = self.per_shard

        def cap(counts):
            # Any shard holds b distinct events, so the sum of the b largest
            # per-event counts bounds every shard — far tighter than the
            # worst-case ``b * max`` on skewed data (one 4,000-hit event no
            # longer inflates every batch's bucket by 4,000 * b).
            counts = np.asarray(counts)
            top = int(np.sort(counts)[::-1][:b].sum())
            # The wrap-padded tail batch (drop_last=False) can DUPLICATE a
            # heavy event, exceeding the distinct-events bound.  Tails only
            # exist for unshuffled batchers (validation/predict), so the
            # tail's composition is deterministic: bound its shard sums
            # exactly.  A shuffled drop_last=False batcher (no current
            # caller) falls back to the worst-case duplicate bound.
            r = len(counts) % self.batch_size
            if not self.drop_last and r:
                if self.shuffle:
                    top = max(top, b * int(counts.max()))
                else:
                    tail = np.resize(counts[-r:], self.batch_size)
                    shard_sums = tail.reshape(self.num_shards, b).sum(1)
                    top = max(top, int(shard_sums.max()))
            return top

        prong_counts = ds.prong_mask.sum(1)
        ev_hits = ds.event_compressed_index[:, 1] - ds.event_compressed_index[:, 0]
        pr_hits = ds.prong_compressed_index[:, 1] - ds.prong_compressed_index[:, 0]
        return BatchShape(
            per_shard=b,
            prong_slots=self._prong_capacity(cap(prong_counts)),
            event_hits=_bucket(cap(ev_hits), self.coo_granularity),
            prong_hits=_bucket(cap(pr_hits), self.coo_granularity),
        )

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size

    # -------------------------------------------------------------------------

    def _prong_capacity(self, max_needed: int) -> int:
        for cap in self.capacity_ladder:
            if cap >= max_needed:
                return cap
        return self.capacity_ladder[-1]

    def build_batch(
        self, indices: np.ndarray, valid: Optional[np.ndarray] = None,
        shards: Optional[Sequence[int]] = None,
    ) -> Dict[str, np.ndarray]:
        """Assemble one batch for the given *global* event indices.

        ``valid`` marks rows that are real (wrap-padded tail rows get
        ``False``): invalid rows keep their images/masks (static shapes) but
        their event and prong targets are set to -1 so losses and metrics
        exclude them.

        ``shards`` (default: the constructor's ``local_shards``) restricts
        assembly to a subset of the data shards: only those shards' events
        are gathered and packed, and the returned arrays hold
        ``len(shards)`` shard blocks in the given order — exactly the rows
        ``local_batch_rows`` would slice out of the full assembly (bit
        -equal; proven by tests/test_multihost_exec.py).  Bucket sizes are
        always chosen from the full index list's per-event metadata
        (prong-mask counts and CSR hit ranges — cheap RAM lookups), so
        every host agrees on shapes with no communication.
        """
        S, b = self.num_shards, self.per_shard
        assert len(indices) == S * b
        indices = np.asarray(indices)
        if shards is None:
            shards = self.local_shards
        shards = list(range(S)) if shards is None else [int(s) for s in shards]
        L = len(shards)
        ds = self.dataset

        # --- choose the static bucket sizes for this batch -------------------
        # Metadata only (per-event prong counts + CSR hit ranges over the
        # FULL global index list) so the choice is identical on every host.
        counts_all = ds.prong_mask[indices].sum(-1).reshape(S, b)
        ev_ranges = ds.event_compressed_index[indices]
        pr_ranges = ds.prong_compressed_index[indices]
        ev_per_shard = (ev_ranges[:, 1] - ev_ranges[:, 0]).reshape(S, b).sum(-1)
        pr_per_shard = (pr_ranges[:, 1] - pr_ranges[:, 0]).reshape(S, b).sum(-1)

        if self.fixed_caps is not None:
            prong_cap = self.fixed_caps.prong_slots
            ev_cap = self.fixed_caps.event_hits
            pr_cap = self.fixed_caps.prong_hits
            needed_prongs = int(counts_all.sum(-1).max())
            needed_ev = int(ev_per_shard.max())
            needed_pr = int(pr_per_shard.max())
            if needed_prongs > prong_cap or needed_ev > ev_cap or needed_pr > pr_cap:
                raise ValueError(
                    f"fixed_shape caps exceeded: need (prongs {needed_prongs}, "
                    f"event hits {needed_ev}, prong hits {needed_pr}) vs caps "
                    f"({prong_cap}, {ev_cap}, {pr_cap})"
                )
        else:
            prong_cap = self._prong_capacity(int(counts_all.sum(-1).max()))
            ev_cap = _bucket(int(ev_per_shard.max()), self.coo_granularity)
            pr_cap = _bucket(int(pr_per_shard.max()), self.coo_granularity)

        # --- gather only the selected shards' events -------------------------
        local_indices = indices.reshape(S, b)[shards].reshape(-1)
        raw = ds.gather_events(local_indices)
        if valid is not None and not valid.all():
            valid_local = valid.reshape(S, b)[shards].reshape(-1)
            raw["event_targets"] = np.where(valid_local, raw["event_targets"], -1)
            raw["prong_targets"] = np.where(
                valid_local[:, None], raw["prong_targets"], -1
            )
        counts = counts_all[shards]                      # [L, b]
        ev_owner_g = raw["event_owner"]                  # row within the gather
        pr_owner_g = raw["prong_owner"]
        ev_shard = ev_owner_g // b                       # local shard position
        pr_shard = pr_owner_g // b

        C = raw["event_values"].shape[1] if raw["event_values"].size else self.dataset.pixel_features

        # --- packed prong slot maps ------------------------------------------
        slot_batch = np.full((L, prong_cap), b, dtype=np.int32)   # b == OOB pad
        slot_pos = np.zeros((L, prong_cap), dtype=np.int32)
        slot_mask = np.zeros((L, prong_cap), dtype=bool)
        slot_start = np.zeros((L, b), dtype=np.int64)             # first slot per event
        for s in range(L):
            cursor = 0
            for i in range(b):
                n = int(counts[s, i])
                slot_start[s, i] = cursor
                slot_batch[s, cursor:cursor + n] = i
                slot_pos[s, cursor:cursor + n] = np.arange(n)
                slot_mask[s, cursor:cursor + n] = True
                cursor += n

        # --- COO banks, padded to the bucket with OOB owners ------------------
        def pack_coo(coords, values, owner_g, shard_of_hit, caps, owner_local_fn,
                     oob, num_owners):
            out_xy = np.zeros((L, caps, 2), dtype=np.int32)
            out_v = np.zeros((L, caps, C), dtype=np.float32)
            out_o = np.full((L, caps), oob, dtype=np.int32)
            # per-image CSR offsets over the owner-sorted bank (dataset hits
            # arrive grouped by event/prong, so local owners are already
            # ascending) — consumed by the Pallas densify fast path
            out_starts = np.zeros((L, num_owners + 1), dtype=np.int32)
            for s in range(L):
                sel = shard_of_hit == s
                n = int(sel.sum())
                out_xy[s, :n] = coords[sel][:, 1:3]
                out_v[s, :n] = values[sel]
                local = owner_local_fn(s, coords[sel], owner_g[sel])
                # Out-of-range owners (e.g. a prong hit indexing past its
                # event's slots) keep drop-mode semantics: mark them with the
                # OOB sentinel so they sort to the end, stay out of the CSR
                # counts, and are dropped by the device scatter.
                local = np.where(
                    (local >= 0) & (local < num_owners), local, num_owners
                )
                if n > 1 and np.any(np.diff(local) < 0):
                    # CSR order normally guarantees ascending owners; sort
                    # (stably) if a file breaks that so the offsets stay valid
                    order = np.argsort(local, kind="stable")
                    out_xy[s, :n] = out_xy[s, :n][order]
                    out_v[s, :n] = out_v[s, :n][order]
                    local = local[order]
                out_o[s, :n] = local
                out_starts[s, 1:] = np.cumsum(
                    np.bincount(local[local < num_owners], minlength=num_owners)
                )
            return out_xy, out_v, out_o, out_starts

        ev_xy, ev_v, ev_o, ev_starts = pack_coo(
            raw["event_coords"], raw["event_values"], ev_owner_g, ev_shard, ev_cap,
            lambda s, c, og: og % b,                      # owner: local event row
            oob=b, num_owners=b,
        )

        def prong_owner_local(s, coords, owner_g):
            local_event = owner_g % b
            # packed slot = slot_start[event] + prong index within event.
            # A hit whose prong index falls outside [0, real prong count)
            # must NOT spill into a neighboring event's slot range (the
            # slot arithmetic alone would land it there for every event
            # but the shard's last): mark it OOB so it is dropped.
            p = coords[:, 0]
            slot = slot_start[s, local_event] + p
            in_event = (p >= 0) & (p < counts[s, local_event])
            return np.where(in_event, slot, prong_cap)

        pr_xy, pr_v, pr_o, pr_starts = pack_coo(
            raw["prong_coords"], raw["prong_values"], pr_owner_g, pr_shard, pr_cap,
            prong_owner_local,
            oob=prong_cap, num_owners=prong_cap,
        )

        def flat(x):  # [S, ...] -> [S * dim0, ...]
            return np.ascontiguousarray(x.reshape(-1, *x.shape[2:]))

        return {
            "features": raw["features"].astype(np.float32),
            "extra": raw["extra"].astype(np.float32),
            "prong_mask": raw["prong_mask"],
            "event_targets": raw["event_targets"].astype(np.int32),
            "prong_targets": raw["prong_targets"].astype(np.int32),
            "event_xy": flat(ev_xy),
            "event_vals": flat(ev_v),
            "event_owner": flat(ev_o),
            "event_starts": flat(ev_starts),
            "prong_xy": flat(pr_xy),
            "prong_vals": flat(pr_v),
            "prong_owner": flat(pr_o),
            "prong_starts": flat(pr_starts),
            "slot_batch": flat(slot_batch),
            "slot_pos": flat(slot_pos),
            "slot_mask": flat(slot_mask),
        }

    def shape_of(self, batch: Dict[str, np.ndarray]) -> BatchShape:
        S = self.num_shards
        return BatchShape(
            per_shard=batch["features"].shape[0] // S,
            prong_slots=batch["slot_batch"].shape[0] // S,
            event_hits=batch["event_owner"].shape[0] // S,
            prong_hits=batch["prong_owner"].shape[0] // S,
        )

    # -------------------------------------------------------------------------

    def epoch_indices(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(order)
        return order

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the epoch's batches, optionally starting at ``start_batch``
        (mid-epoch resume: skipping happens in index space, before any
        assembly or transfer)."""
        order = self.epoch_indices(epoch)
        n_full = len(order) // self.batch_size
        for k in range(start_batch, n_full):
            yield self.build_batch(order[k * self.batch_size:(k + 1) * self.batch_size])
        if not self.drop_last and len(order) % self.batch_size:
            yield self._tail_batch(order)

    def _tail_batch(self, order: np.ndarray) -> Dict[str, np.ndarray]:
        """Wrap-padded final batch with the padded rows marked invalid."""
        tail = order[(len(order) // self.batch_size) * self.batch_size:]
        pad = np.resize(tail, self.batch_size)
        valid = np.arange(self.batch_size) < len(tail)
        return self.build_batch(pad, valid=valid)

    def prefetch_epoch(
        self, epoch: int = 0, depth: int = 2, num_workers: int = 1,
        start_batch: int = 0, transform: Optional[Callable] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Epoch iterator with background prefetch.

        ``num_workers > 1`` runs batch assembly on a thread pool (the role of
        the reference's DataLoader worker processes; numpy/h5 slicing release
        the GIL) while preserving batch order; ``depth`` strictly bounds how
        many prepared batches may be in flight (it also caps the effective
        pool parallelism — raise both together for multi-core hosts).
        ``transform`` is applied to each batch on the thread that built it
        (e.g. copying it into pinned memory).
        """
        if num_workers > 1:
            yield from self._pool_epoch(epoch, depth, num_workers, start_batch,
                                        transform)
            return

        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()  # set when the consumer abandons mid-epoch
        err: List[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.epoch(epoch, start_batch):
                    if transform is not None:
                        item = transform(item)
                    if not put(item):
                        return  # consumer gone: drop the batch, exit cleanly
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # GeneratorExit path (e.g. fit stopping at max_steps): unblock
            # the worker and release the queued batches instead of pinning
            # depth+1 assembled global batches for the rest of the process.
            stop.set()

            def _drain():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass

            # Drain once to unblock an in-flight q.put (it can still land
            # within its 0.1 s window after `stop` is set), wait for the
            # worker to observe `stop` and exit, then drain again so that
            # late put is also released — otherwise one assembled global
            # batch stays pinned in the queue until the generator is GC'd.
            # The join is bounded: a worker mid-assembly of a slow batch can
            # outlive the timeout, in which case its one queued batch stays
            # pinned until the daemon thread finishes (the leak is deferred,
            # not eliminated); consumer exit itself never blocks >1 s.
            _drain()
            t.join(timeout=1.0)
            _drain()

    def _pool_epoch(self, epoch: int, depth: int, num_workers: int,
                    start_batch: int = 0, transform: Optional[Callable] = None):
        from concurrent.futures import ThreadPoolExecutor

        order = self.epoch_indices(epoch)
        starts = list(range(0, len(order) - self.batch_size + 1, self.batch_size))
        if not self.drop_last and len(order) % self.batch_size:
            starts.append(-1)  # wrap-pad tail marker
        starts = starts[start_batch:]

        def build(start):
            if start < 0:
                batch = self._tail_batch(order)
            else:
                batch = self.build_batch(order[start:start + self.batch_size])
            return batch if transform is None else transform(batch)

        window = max(depth, 1)  # depth strictly bounds in-flight batches
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            futures = [pool.submit(build, s) for s in starts[:window]]
            cursor = window
            for i in range(len(starts)):
                yield futures[i].result()
                futures[i] = None
                if cursor < len(starts):
                    futures.append(pool.submit(build, starts[cursor]))
                    cursor += 1
