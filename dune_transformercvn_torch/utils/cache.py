"""On-disk compile caches for ``torch.compile``.

Port of ``dune_transformercvn_tpu/utils/cache.py``: there the persistent
XLA cache lets every CLI surface skip recompiling a jitted step in a new
process.  Here Inductor's FX-graph cache (the generated kernels and their
wrapper) and AOTAutograd's cache (the traced joint forward and backward)
do the same for the port's compiled steps (:mod:`.compile`).  Both key on
the graph, the inputs' shapes, dtypes and devices, and the compiler's
configuration.  :func:`enable_compile_cache` points them at
``dune_tcvn_torch_cache`` under the temporary directory (``/tmp`` unless
``TMPDIR`` names another).  ``TORCHINDUCTOR_CACHE_DIR`` relocates the cache,
and ``DUNE_TCVN_NO_COMPILE_CACHE=1`` opts out, as in JAX.

The JAX module's other switch, ``enable_fast_prng``, has no counterpart:
torch's CUDA generator is Philox already, and Inductor's compiled dropout
draws Philox offsets of its own.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

CACHE_NAME = "dune_tcvn_torch_cache"


def enable_compile_cache() -> Optional[str]:
    """Idempotently turn on the FX-graph and AOTAutograd caches in the
    cache directory, which it returns; with ``DUNE_TCVN_NO_COMPILE_CACHE``
    set, turn both off and return ``None``."""
    import torch._functorch.config as functorch_config
    import torch._inductor.config as inductor_config

    if os.environ.get("DUNE_TCVN_NO_COMPILE_CACHE"):
        inductor_config.fx_graph_cache = False
        functorch_config.enable_autograd_cache = False
        return None
    path = os.environ.setdefault(
        "TORCHINDUCTOR_CACHE_DIR", os.path.join(tempfile.gettempdir(), CACHE_NAME))
    inductor_config.fx_graph_cache = True
    functorch_config.enable_autograd_cache = True
    return path
