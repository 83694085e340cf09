"""The compiled ``Trainer`` (``compile=True``) on the CPU at the tiny width
of ``tests/test_torch_port_loop.py``
(DenseNet [1], one prong-decoder layer, 48x40 events made in memory).

* With dropout and pixel noise on, a compiled run checkpointed at step 2
  and resumed in a fresh compiled ``Trainer`` ends equal, bit for bit, to
  the uninterrupted compiled run: compiled dropout draws Inductor's Philox
  offsets from the generator the step seeds from the state.
* ``train --compile`` and ``evaluate --compile`` reach the ``Trainer``.

``tests/test_torch_port_compile_dp.py`` runs the compiled data-parallel
step.  Inductor compiles its C++ with one worker (``compile_threads = 1``).
"""

import torch

from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.evaluate import main as evaluate_main
from dune_transformercvn_torch.train import Trainer
from dune_transformercvn_torch.train.__main__ import parser as train_parser
from test_torch_port_loop import H, W, assert_same_state, tiny_options

torch.set_num_threads(2)
torch._inductor.config.compile_threads = 1

# the compiled tests' network: DenseNet [1], one prong-decoder layer
SMALL = dict(densenet_structure=[1], num_prong_decoder_layers=1)


def compiled_trainer(run_dir, **overrides):
    datasets = (InMemoryEvents(16, 1, (H, W)), InMemoryEvents(8, 2, (H, W)), None)
    return Trainer(tiny_options(**SMALL, **overrides), run_dir=str(run_dir), device="cpu",
                   datasets=datasets, log_every_n_steps=1, compile=True)


def test_compiled_trainer_resumes_bit_for_bit(tmp_path):
    noisy = dict(dropout=0.1, pixel_noise_std=0.05)
    whole = compiled_trainer(tmp_path / "whole", **noisy)
    whole.fit(max_steps=4, eval_interval=2)
    resumed = compiled_trainer(tmp_path / "resumed", **noisy)
    resumed.resume(str(tmp_path / "whole" / "checkpoints" / "step_2"))
    assert resumed.state.step == 2
    resumed.fit(max_steps=4, eval_interval=2)
    assert_same_state(resumed.state.state_dict(), whole.state.state_dict())


def test_the_clis_take_compile(monkeypatch):
    """``--compile`` reaches the Trainer (the runs are the tests above)."""
    assert train_parser().parse_args(["--compile"]).compile
    assert not train_parser().parse_args([]).compile
    seen = {}

    def evaluate_run(*args, **kwargs):
        seen.update(kwargs)
        raise SystemExit(0)

    monkeypatch.setattr("dune_transformercvn_torch.evaluate.evaluate_run", evaluate_run)
    for argv, want in ((["run", "--compile"], True), (["run"], False)):
        try:
            evaluate_main(argv)
        except SystemExit:
            pass
        assert seen.pop("compile") is want
