"""The port's bench (``python -m dune_transformercvn_torch.bench``) and its
contract, mirroring ``tests/test_bench_contract.py``: exactly one JSON line
on stdout in every case.

* Without CUDA (this host) it prints ``"error": "no_cuda"`` with a null
  ``value`` and exits 0, run as a subprocess, as a harness runs it.
* ``--device cpu`` on a tiny option file, in process, with the bench's
  sizes cut (48x40 events, a few passes and steps) and its compiled rows
  compiled by AOTAutograd's eager backend (Inductor's compile of the same
  steps is ``tests/test_torch_port_compile*.py``'s): the record carries
  every row's every field.
* A row that runs out of device memory becomes its ``_oom`` field (rows
  stubbed); any other failure still prints one line, with ``error``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dune_transformercvn_torch import bench, predict
from dune_transformercvn_torch.train import step as train_step

REPO = Path(__file__).resolve().parents[1]
TINY = dict(hidden_dim=16, initial_feature_dim=8, initial_pixel_dim=4, feature_embedding_dim=4,
            pixel_embedding_dim=8, position_embedding_dim=4, num_encoder_layers=1,
            num_prong_decoder_layers=1, num_attention_heads=2, disable_smart_features=True,
            densenet_structure=[1], densenet_growth_rate=4, dropout=0.1,
            pixel_noise_std=0.001, batch_size=16, optimizer="AdamW", gradient_clip=43)
SERVE_FIELDS = ("events_per_second", "events_per_second_range", "peak_gib")
TRAIN_FIELDS = ("ms_per_step", "ms_per_step_range", "events_per_second", "peak_gib",
                "tflops_per_step", "mfu")
ROWS = [(kind, b, mode) for kind in ("inference", "train") for b in (16, 64)
        for mode in ("eager", "compiled")]


def one_record(text):
    lines = text.strip().splitlines()
    assert len(lines) == 1, lines
    record = json.loads(lines[0])
    assert record["metric"] == "inference_events_per_second"
    assert {"value", "unit", "vs_baseline"} <= set(record)
    return record


@pytest.fixture
def small_bench(monkeypatch, tmp_path):
    """The bench cut to a tiny CPU run; returns its argv."""
    monkeypatch.setattr(bench, "IMAGE_SHAPE", (48, 40))
    monkeypatch.setattr(bench, "SERVE_EVENTS", {16: 32, 64: 64})
    monkeypatch.setattr(bench, "SERVE_PASSES", 2)
    monkeypatch.setattr(bench, "TRAIN_WARMUP", 2)
    monkeypatch.setattr(bench, "TRAIN_WINDOWS", 2)
    monkeypatch.setattr(bench, "TRAIN_STEPS", 1)

    def eager_backend(fn, shapes=1):
        return torch.compile(fn, backend="aot_eager", dynamic=False)

    monkeypatch.setattr(predict, "compile_step", eager_backend)
    monkeypatch.setattr(train_step, "compile_step", eager_backend)
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "cache"))
    options = tmp_path / "tiny.json"
    options.write_text(json.dumps(TINY))
    return ["--device", "cpu", "--options", str(options)]


def test_no_cuda_prints_one_structured_json_line():
    env = {k: v for k, v in os.environ.items() if k != "DUNE_TCVN_PLATFORM"}
    proc = subprocess.run([sys.executable, "-m", "dune_transformercvn_torch.bench"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**env, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = one_record(proc.stdout)
    assert record["error"] == "no_cuda"
    assert record["value"] is None and record["vs_baseline"] is None


def test_cpu_run_carries_every_field(small_bench, capsys):
    assert bench.main(small_bench) == 0
    record = one_record(capsys.readouterr().out)
    assert "error" not in record
    for kind, b, mode in ROWS:
        fields = SERVE_FIELDS if kind == "inference" else TRAIN_FIELDS
        fields += ("compile_s",) if mode == "compiled" else ()
        for field in fields:
            assert f"{kind}_b{b}_{mode}_{field}" in record, (kind, b, mode, field)
        rate = record[f"{kind}_b{b}_{mode}_events_per_second"]
        assert rate > 0 and f"{kind}_b{b}_{mode}_oom" not in record
    assert record["value"] == record["inference_b16_eager_events_per_second"]
    assert record["vs_baseline"] == pytest.approx(record["value"] / 43.2)
    lo, hi = record["train_b16_eager_ms_per_step_range"]
    assert lo <= record["train_b16_eager_ms_per_step"] <= hi
    # FLOPs scale with the batch; no device peak (and no memory) on the CPU
    assert 0 < record["train_b16_eager_tflops_per_step"] < record[
        "train_b64_eager_tflops_per_step"]
    assert record["train_b16_eager_mfu"] is None and record["peak_bf16_flops"] is None
    assert record["device"] == record["kind"] == "cpu" and record["power_limit"] is None
    assert record["inference_b16_eager_peak_gib"] is None


def test_an_out_of_memory_row_becomes_a_field(small_bench, monkeypatch, capsys):
    """b64 training stubbed to run out of memory: its rows become ``_oom``
    fields, the other rows stand, one line, exit 0."""
    def train_row(cfg, options, device, batch_size, compile, peak):
        if batch_size == 64:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 9.00 GiB\nmore")
        return {"ms_per_step": 1.0}

    monkeypatch.setattr(bench, "serve_row", lambda *a: {"events_per_second": 50.0})
    monkeypatch.setattr(bench, "train_row", train_row)
    assert bench.main(small_bench) == 0
    record = one_record(capsys.readouterr().out)
    for mode in ("eager", "compiled"):
        assert record[f"train_b64_{mode}_oom"] == \
            "CUDA out of memory. Tried to allocate 9.00 GiB"
        assert f"train_b64_{mode}_ms_per_step" not in record
        assert record[f"train_b16_{mode}_ms_per_step"] == 1.0
    assert record["value"] == 50.0


def test_a_failure_still_prints_one_line(small_bench, monkeypatch, capsys):
    def broken(*args):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(bench, "serve_row", broken)
    with pytest.raises(RuntimeError):
        bench.main(small_bench)
    record = one_record(capsys.readouterr().out)
    assert record["error"] == "RuntimeError: kernel launch failed"
    assert record["value"] is None
