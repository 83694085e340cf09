"""Event data for the port: the JAX package's framework-free ``data`` modules
(numpy only; h5py imported lazily), re-exported, plus :mod:`.synthetic`,
events made in memory for runs on a host without HDF5 files.
"""

from dune_transformercvn_tpu.data.batcher import Batcher
from dune_transformercvn_tpu.data.dataset import EventDataset
from dune_transformercvn_tpu.data.schema import MAX_PRONGS, split_current_targets

from .synthetic import InMemoryEvents

__all__ = ["Batcher", "EventDataset", "InMemoryEvents", "MAX_PRONGS",
           "split_current_targets"]
