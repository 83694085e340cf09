"""The coo family's compiled steps: predict, eval and two train steps with
kernel K2's op (``tcvn::coo_stem_scatter``, its plain version on the CPU)
and its registered gradient inside the compiled graphs, against the same
steps run eagerly and against the JAX package's jitted steps.  The
network, data and tolerances are ``tests/test_torch_port_compile.py``'s;
this file is apart so that a second test worker compiles it.
"""

import torch

from test_torch_port_compile import check_compiled_steps

torch.set_num_threads(2)
torch._inductor.config.compile_threads = 1


def test_compiled_coo_steps_match_eager_and_jax(synthetic_file, monkeypatch):
    check_compiled_steps(synthetic_file, "coo", monkeypatch)
