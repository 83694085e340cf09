"""The compiled tensor-parallel step on the CPU: two ``gloo`` ranks at dp1 x
mp2 (``tests/_torch_dp_worker.py``, mode ``compiled``) each fit an eager
and a compiled ``Trainer`` (``compile=True``, ``model_parallel=2``) at the
tiny width of ``tests/test_torch_port_compile_loop.py`` with 2 attention
heads (a head of 16, so the packed q/k/v is sharded too).  The partitioned
layers' collectives (the row's sums forward and backward, the gathers of
the other sharded weights) are traced into the compiled graphs.  Each
rank's compiled steps against its eager steps (dropout 0, noise 0):
metrics, running statistics and the validation loss within
``tests/test_torch_port_compile.py``'s ``TOL`` plus twice the eager fit's
own spread over the other 23 orders of the batch's 4 events
(``assert_within_spread``).  Measured on an AVX-512 host (8 cores): the
validation loss 1.87e-4 from eager (1.07e-4 of it, past ``TOL``'s 1e-4
alone) against a spread of 2.93e-4, a bound of 7.7e-4; with Inductor's
``cpp.simdlen`` at 256 bits the compiled loss falls inside ``TOL``, so the
gap is the order of the float32 sums.  Gradients (whole) by its
``grads_close`` rule, parameters by ``test_torch_port_train``'s Adam rule;
the ranks' whole compiled states equal bit for bit
(``test_torch_port_compile_dp.check_compiled_ranks``).

Inductor compiles its C++ with one worker in each rank
(``compile_threads = 1``).
"""

from test_torch_port_compile_loop import SMALL
from test_torch_port_compile_dp import check_compiled_ranks
from test_torch_port_loop import TINY


def test_compiled_tensor_parallel_steps_match_eager(tmp_path):
    check_compiled_ranks(tmp_path, {**TINY, **SMALL, "num_gpu": 2, "model_parallel": 2,
                                    "num_attention_heads": 2})
