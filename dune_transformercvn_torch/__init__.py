"""dune_transformercvn_torch — the PyTorch/CUDA port of TransformerCVN.

A second package beside :mod:`dune_transformercvn_tpu` (the JAX reference):
the same modules, file for file, written as ``torch.nn.Module``s, with each
Pallas kernel of the JAX package replaced by a hand-written CUDA kernel for
NVIDIA Hopper (``csrc/``, built with ``nvcc`` at first use by
:mod:`.utils.build`).  Nothing here builds or loads CUDA at import time.

The port stands alone: it imports nothing of the JAX package and keeps its
own copies of the framework-free modules it needs (:mod:`.config`, the
``data`` package's schema, dataset and batcher, :mod:`.evaluation`,
``utils.rundir`` and ``train.logging``).  Entry points:
``python -m dune_transformercvn_torch.train`` and ``.evaluate``.
"""

from .config import Options

__version__ = "0.1.0"

__all__ = ["Options"]
