"""Event data for the port: its own copies of the JAX package's
framework-free ``data`` modules (numpy only; h5py imported lazily), plus
:mod:`.synthetic`, events made in memory for runs on a host without HDF5
files.
"""

from .batcher import Batcher
from .dataset import EventDataset
from .schema import MAX_PRONGS, split_current_targets
from .synthetic import InMemoryEvents

__all__ = ["Batcher", "EventDataset", "InMemoryEvents", "MAX_PRONGS",
           "split_current_targets"]
