"""Where Inductor's compile time goes on the GPU host, and whether the
port's bench, in a process of its own, loads a graph from the compile
cache that this process filled.

    python3 compile_probe.py

Builds the kernels as ``chip_smoke.py`` does (which also switches TF32
off), prints the FX-graph cache key's matmul precision setting before and
after, compiles the bf16 serving graph at batch 16 of the option file at
``chip_smoke.CUT_DEPTH`` into an empty cache under torch's default setting,
with Dynamo's compile-time breakdown and Inductor's counters, then runs the
bench's compiled b16 serving row in a subprocess on that cache and prints
its time and counters.  Needs one CUDA device."""
import contextlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

os.environ["TORCHINDUCTOR_CACHE_DIR"] = tempfile.mkdtemp(prefix="probe_cache_")
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as s
from torch._dynamo.utils import counters, compile_times
from torch._inductor import codecache, metrics
from dune_transformercvn_torch import bench
from dune_transformercvn_torch.data import InMemoryEvents
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.predict import predict_split

ic = torch._inductor.config
print("compile_threads", ic.compile_threads, "affinity", len(os.sched_getaffinity(0)),
      "cpu_count", os.cpu_count(), "worker_start_method", getattr(ic, "worker_start_method", None),
      {k: v for k, v in os.environ.items() if "INDUCTOR" in k or "TRITON" in k}, flush=True)
src = inspect.getsource(codecache.FxGraphHashDetails.__init__)
print("key has fp32_precision", "fp32_precision" in src, "allow_tf32", "allow_tf32" in src)
print("default fp32_precision", torch.backends.cuda.matmul.fp32_precision,
      torch.backends.cuda.matmul.allow_tf32, flush=True)
smi = s.device_and_build()
print("after smoke set-up fp32_precision", torch.backends.cuda.matmul.fp32_precision, flush=True)


@contextlib.contextmanager
def default_precision():
    m = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "none"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.fp32_precision = m


s.enable_compile_cache()
model = TransformerCVN(s.cut_config("bfloat16"),
                       generator=torch.Generator().manual_seed(s.SEED)).cuda()
ds = InMemoryEvents(bench.SERVE_EVENTS[16], bench.SEED + 1)
with default_precision():
    print("inside", torch.backends.cuda.matmul.fp32_precision, torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32, flush=True)
    t0 = time.perf_counter()
    predict_split(model, ds, ds.norm(), 16, "cuda", fixed_shape=True, compile=True)
    torch.cuda.synchronize()
    print(f"in-process cold serving b16 first pass {time.perf_counter() - t0:.1f} s; kernels "
          f"{metrics.generated_kernel_count}", flush=True)
print({k: dict(v) for k, v in counters.items() if k in ("inductor", "aot_autograd")})
print(compile_times(), flush=True)

code = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from torch._dynamo.utils import counters, compile_times
import chip_smoke as s
from dune_transformercvn_torch import bench
work = sys.argv[1]
with open(s.OPTION_FILE) as f:
    fields = json.load(f)
fields.update({k: list(v) if isinstance(v, tuple) else v for k, v in s.CUT_DEPTH.items()})
path = os.path.join(work, "cut.json")
json.dump(fields, open(path, "w"))
bench.enable_compile_cache()
options, cfg = bench.setup(path, torch.device("cuda"))
t0 = time.perf_counter()
row = bench.serve_row(cfg, torch.device("cuda"), 16, True)
print("bench subprocess serve b16 compiled", round(time.perf_counter() - t0, 1), "s", row, flush=True)
print({k: dict(v) for k, v in counters.items() if k in ("inductor", "aot_autograd")})
print(compile_times(), flush=True)
"""
t0 = time.perf_counter()
proc = subprocess.run([sys.executable, "-c", code, tempfile.mkdtemp()], capture_output=True,
                      text=True, timeout=600)
print(f"subprocess rc {proc.returncode} in {time.perf_counter() - t0:.1f} s")
print(proc.stdout)
print(proc.stderr[-3000:], flush=True)
