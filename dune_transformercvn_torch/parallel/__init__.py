"""Data parallelism over processes (:mod:`.mesh`)."""

from .mesh import (all_gather_rows, all_reduce_, barrier, data_parallel_size,
                   init_from_env, local_batch_rows, local_rank, local_shard_ids,
                   shard_ids_of, world)

__all__ = [
    "all_gather_rows",
    "all_reduce_",
    "barrier",
    "data_parallel_size",
    "init_from_env",
    "local_batch_rows",
    "local_rank",
    "local_shard_ids",
    "shard_ids_of",
    "world",
]
