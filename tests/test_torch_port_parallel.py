"""The port's data parallelism (``dune_transformercvn_torch/parallel``,
``ops/masked.py``'s sync-BN) against the JAX package's, on the CPU.

* The shard helpers ``shard_ids_of`` and ``local_batch_rows`` are
  array-equal to the JAX package's over the layouts of
  ``tests/test_multihost.py``.
* Sync-BN: a ``MaskedBatchNorm`` synced over a 2-process ``gloo`` group
  (``tests/_torch_dp_worker.py``) against the JAX package's
  ``MaskedBatchNorm(axis_name="data")`` under ``shard_map`` over 2 virtual
  devices, on the same seeded inputs, with per-sample and per-site masks,
  one rank's mask or both selecting nothing: the output rows, the input
  gradient, the affine gradients summed over the ranks (as the train
  step's all-reduce sums them) and the running statistics.  float32; the
  two sides sum in other orders, so ``rtol=1e-5, atol=1e-6``.
"""

import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from dune_transformercvn_tpu.ops import masked as jax_masked
from dune_transformercvn_tpu.parallel import mesh as jax_mesh
from dune_transformercvn_torch import parallel

WORKER = Path(__file__).with_name("_torch_dp_worker.py")
TOL = dict(rtol=1e-5, atol=1e-6)


def start_ranks(mode, inputs, directory, world_size=2):
    """The worker's ``world_size`` ranks, started; ``finish_ranks`` waits."""
    directory = Path(directory)
    suffix = ".npz" if mode == "syncbn" else ".pt"
    outputs = [directory / f"{mode}_rank{r}{suffix}" for r in range(world_size)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(directory / f"{mode}_rendezvous"),
         str(world_size), str(r), str(inputs), str(outputs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
        for r in range(world_size)]
    return procs, outputs


def communicate_all(procs, timeout):
    """Every process's output, all of them within ``timeout`` seconds in
    all (not each); past it ``subprocess.TimeoutExpired``."""
    deadline = time.monotonic() + timeout
    return [p.communicate(timeout=max(0.1, deadline - time.monotonic()))[0] for p in procs]


def finish_ranks(started, timeout=300):
    """Wait for every rank, ``timeout`` seconds for all of them; any
    rank's failure fails the test with its output."""
    procs, outputs = started
    try:
        logs = communicate_all(procs, timeout)
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return outputs


# ---------------------------------------------------------------------------
# the shard helpers
# ---------------------------------------------------------------------------

def fake_devices(process_of):
    return [SimpleNamespace(process_index=p) for p in process_of]


LAYOUTS = [[0, 0, 0, 0, 1, 1, 1, 1], [0, 1, 0, 1], [0] * 8, [0, 0, 1, 1],
           np.random.default_rng(0).integers(0, 3, size=16).tolist()]


@pytest.mark.parametrize("layout", LAYOUTS, ids=range(len(LAYOUTS)))
def test_shard_helpers_match_jax(layout):
    devices = fake_devices(layout)
    num_shards = len(layout)
    batch = np.arange(num_shards * 3 * 2).reshape(num_shards * 3, 2)
    seen = []
    for process in range(max(layout) + 1):
        ids = parallel.shard_ids_of(devices, process)
        assert ids == jax_mesh.shard_ids_of(devices, process)
        seen += ids
        if ids:
            np.testing.assert_array_equal(
                parallel.local_batch_rows(batch, num_shards, ids),
                jax_mesh.local_batch_rows(batch, num_shards, ids))
    assert sorted(seen) == list(range(num_shards))


def test_a_world_of_one():
    """No process group: one shard, rank 0, ``num_gpu`` clamped to 1 with
    the JAX package's note, and 0 meaning every device."""
    assert parallel.world() == (1, 0)
    assert parallel.local_shard_ids() == [0]
    assert parallel.data_parallel_size(4) == 1
    assert parallel.data_parallel_size(0) == parallel.data_parallel_size(None) == 1


# ---------------------------------------------------------------------------
# sync-BN
# ---------------------------------------------------------------------------

C = 5


def syncbn_cases():
    rng = np.random.default_rng(11)
    cases = {}
    for name in ("sample", "site", "sample_rank1_empty", "site_rank1_empty", "all_empty"):
        x = rng.normal(2.0, 3.0, size=(8, 3, 2, C)).astype(np.float32)
        mask = (rng.random(8) < 0.7) if name.startswith("sample") else (
            rng.random((8, 3, 2)) < 0.6)
        mask[:1] = True                       # rank 0 always selects something
        if name.endswith("rank1_empty"):
            mask[4:] = False
        if name == "all_empty":
            mask = np.zeros(8, bool)
        cases[name] = dict(
            x=x, mask=mask, cot=rng.normal(size=x.shape).astype(np.float32),
            weight=rng.uniform(0.5, 1.5, C).astype(np.float32),
            bias=rng.normal(size=C).astype(np.float32),
            running_mean=rng.normal(size=C).astype(np.float32),
            running_var=rng.uniform(0.5, 2.0, C).astype(np.float32))
    return cases


def jax_syncbn(case):
    """Output, gradients of x / scale / bias and updated statistics of the
    JAX package's psum'd BatchNorm, sharded over 2 devices."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    module = jax_masked.MaskedBatchNorm(C, axis_name="data")

    def shard(params, stats, x, mask):
        y, updated = module.apply({"params": params, "batch_stats": stats}, x, mask,
                                  mutable=["batch_stats"])
        return y, updated["batch_stats"]

    sharded = jax.shard_map(shard, mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
                            out_specs=(P("data"), P()))
    stats = {"mean": jnp.asarray(case["running_mean"]), "var": jnp.asarray(case["running_var"])}

    def loss(params, x):
        y, updated = sharded(params, stats, x, jnp.asarray(case["mask"]))
        return jnp.sum(y * case["cot"]), (y, updated)

    params = {"scale": jnp.asarray(case["weight"]), "bias": jnp.asarray(case["bias"])}
    (_, (y, updated)), (g_params, g_x) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(case["x"]))
    return dict(y=y, grad_x=g_x, grad_weight=g_params["scale"], grad_bias=g_params["bias"],
                running_mean=updated["mean"], running_var=updated["var"])


@pytest.fixture(scope="module")
def syncbn_runs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("syncbn")
    cases = syncbn_cases()
    inputs = directory / "cases.npz"
    np.savez(inputs, **{f"{name}/{k}": v for name, case in cases.items()
                        for k, v in case.items()})
    started = start_ranks("syncbn", inputs, directory)
    want = {name: jax_syncbn(case) for name, case in cases.items()}
    ranks = [np.load(path) for path in finish_ranks(started)]
    return cases, want, ranks


@pytest.mark.parametrize("case", ["sample", "site", "sample_rank1_empty",
                                  "site_rank1_empty", "all_empty"])
def test_sync_batchnorm_matches_jax_psum(syncbn_runs, case):
    cases, want, ranks = syncbn_runs
    got = lambda key: [r[f"{case}/{key}"] for r in ranks]  # noqa: E731
    for key in ("y", "grad_x"):
        np.testing.assert_allclose(np.concatenate(got(key)), np.asarray(want[case][key]),
                                   **TOL, err_msg=key)
    for key in ("grad_weight", "grad_bias"):
        np.testing.assert_allclose(sum(got(key)), np.asarray(want[case][key]), **TOL,
                                   err_msg=key)
    for key in ("running_mean", "running_var"):
        rank0, rank1 = got(key)
        np.testing.assert_array_equal(rank0, rank1, err_msg=key)
        np.testing.assert_allclose(rank0, np.asarray(want[case][key]), **TOL, err_msg=key)
        if case == "all_empty":   # the global count is 0: the statistics stay
            np.testing.assert_array_equal(rank0, cases[case][key])
        else:
            assert not np.array_equal(rank0, cases[case][key]), key

