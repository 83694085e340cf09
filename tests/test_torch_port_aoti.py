"""The AOTInductor serving packages (``aoti.py``) and their C++ loader
(``csrc/aoti_loader.cpp``), on the CPU, against the eager graphs of
``export.py`` and the JAX package's ``build_inference_fn``.

The network is a tiny dense one (DenseNet [1], one encoder layer, hidden
32, 32x32 images, ``max_prongs`` 4, float32) carrying seeded JAX weights
(``from_jax``).  ``export_model`` writes the ladder (2, 4);
``package_run_dir`` packages ``embeddings`` and ``combined`` at the full
capacity, then ``pid`` at both rungs with the bench, for the CPU (each
package once: four compiles).

* Each variant's package equals the eager ``InferenceGraph`` at
  ``num_prongs`` 0, 3 and 4 within ``rtol=1e-4, atol=1e-5``; the package of
  the in-memory ``pid`` program gives the same outputs, bit for bit, as the
  package of the program read back from its ``.pt2`` file.
* The loader (``build_loader()``, run as a subprocess with ``--device cpu``
  and the test's thread count) writes outputs bit-equal to
  ``load_package``'s on the same package, within the same tolerance of
  JAX's ``build_inference_fn``, in the binary format of
  ``native/pjrt_loader.cc`` (read by this file's own reader), PJRT's F32
  code.
* It picks rungs as ``export.select_bucket`` does with a cost for every
  eligible rung, with one rung lacking a cost, and for an over-full event,
  as its stderr says.
* With ``--graph`` it picks rungs by the meta's ``aoti_graph_bucket_ms``
  when every eligible rung has one, else as without it, as
  ``select_bucket`` does given those costs (``--dry_run``: the rung only,
  nothing loaded); ``--graph --device cpu`` exits 2, nothing run.
* ``load_package(..., graph=True)`` on the CPU runs the package uncaptured,
  bit-equal to ``load_package``'s, and captures nothing.
* A broken source makes ``build_loader()`` raise with the compiler's
  output; a missing package, a meta for another device, a short pixel file
  and ``--device cuda`` on a host without CUDA exit non-zero.
* Inductor is given a C++ compiler that links OpenMP: ``$CXX`` when its
  driver finds ``libgomp.spec``, else ``g++``, else an error.
"""

import dataclasses
import json
import os
import shutil
import struct
import subprocess
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu import export as jax_export
from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.models import ModelConfig as JaxModelConfig
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_torch import aoti
from dune_transformercvn_torch.export import (VARIANTS, build_inference_fn, export_model,
                                              export_program, select_bucket, with_max_prongs)
from dune_transformercvn_torch.from_jax import load_jax_variables
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from dune_transformercvn_torch.utils import build
from test_torch_port_network import random_variables

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
H = W = 32
P = 4
RUNGS = (2, 4)
NORM = {"mean": np.zeros(5, np.float32), "std": np.ones(5, np.float32),
        "extra_mean": np.float32(0.0), "extra_std": np.float32(1.0)}
PJRT_F32 = 11


def configs():
    o = JaxOptions()
    o.update_options(dict(
        densenet_structure=[1], densenet_growth_rate=8, initial_pixel_dim=8,
        pixel_embedding_dim=16, feature_embedding_dim=8, position_embedding_dim=8,
        hidden_dim=32, num_encoder_layers=1, num_attention_heads=4, compute_dtype="float32"))
    cfg = dataclasses.replace(JaxModelConfig.from_options(
        o, features_dim=5, extra_dim=3, pixel_channels=3, num_event_classes=10,
        num_prong_classes=8, image_shape=(H, W), embedder="dense"), max_prongs=P)
    return cfg, ModelConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(ModelConfig)})


def raw_pixels(seed):
    rng = np.random.default_rng(seed)
    pixels = rng.uniform(size=(1 + P, 3, H, W)) < 0.05
    return (pixels * rng.uniform(16, 255, pixels.shape)).astype(np.float32)


def read_outputs(path):
    """The loader's out.bin: u32 count, then per output u32 rank, i64
    dims[rank], u32 PJRT dtype code and the raw little-endian float32s."""
    outs = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<I", f.read(4))
        for _ in range(n):
            (rank,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{rank}q", f.read(8 * rank))
            (dtype,) = struct.unpack("<I", f.read(4))
            data = np.frombuffer(f.read(4 * int(np.prod(dims))), dtype="<f4")
            outs.append((dtype, data.reshape(dims)))
        assert f.read() == b""
    return outs


@pytest.fixture(scope="module")
def packaged(tmp_path_factory):
    root = tmp_path_factory.mktemp("aoti")
    cfg, port_cfg = configs()
    images = jnp.zeros((1 + P, H, W, 3))
    example = (images[:1], images[1:], jnp.zeros((1, P, 5)), jnp.zeros((1, 3)),
               jnp.ones((1, P), bool), jnp.zeros(P, jnp.int32), jnp.arange(P, dtype=jnp.int32),
               jnp.ones(P, bool), {k: jnp.asarray(v) for k, v in NORM.items()})
    jax_model = JaxTransformerCVN(cfg)
    variables = random_variables(jax_model, 13, *example,
                                 method=JaxTransformerCVN.forward_from_images, train=False)
    model = load_jax_variables(TransformerCVN(port_cfg), variables).eval()
    out = root / "export"
    export_model(model, NORM, str(out), prong_buckets=RUNGS[:1], device="cpu")
    paths = aoti.package_run_dir(None, str(out), variants=("embeddings", "combined"),
                                 prong_buckets=(P,), device="cpu")
    paths.update(aoti.package_run_dir(None, str(out), variants=("pid",), prong_buckets=RUNGS,
                                      device="cpu", bench=True))
    pixels = raw_pixels(5)
    pixels.tofile(root / "pixels.bin")
    return dict(root=root, out=out, paths=paths, model=model, jax_model=jax_model,
                variables=variables, pixels=pixels, loader=build.build_loader())


def run_loader(packaged, model, num_prongs, *extra, meta=None, expect=0):
    root = packaged["root"]
    out_bin = root / f"out_{num_prongs}.bin"
    proc = subprocess.run(
        [str(packaged["loader"]), str(model), str(meta or packaged["out"] /
                                                   "transformercvn_export_meta.json"),
         str(root / "pixels.bin"), str(num_prongs), str(out_bin), *extra],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads())})
    if expect == 0:
        assert proc.returncode == 0, proc.stderr[-3000:]
    else:
        assert proc.returncode != 0, proc.stderr[-3000:]
        assert expect == 1 or proc.returncode == expect, proc.stderr[-3000:]
    return proc, out_bin


def test_meta_records_the_packages(packaged):
    meta = json.loads((packaged["out"] / "transformercvn_export_meta.json").read_text())
    assert meta["aoti_platform"] == "cpu"
    assert meta["aoti_prong_buckets"] == list(RUNGS) and meta["aoti_variants"] == ["pid"]
    assert meta["aoti_files"]["pid"] == {"2": "transformercvn_pid_p2.aoti.pt2",
                                         "4": "transformercvn_pid.aoti.pt2"}
    assert sorted(meta["aoti_bucket_ms"]) == ["2", "4"]
    assert all(v > 0 for v in meta["aoti_bucket_ms"].values())
    assert sorted(meta["bucket_files"]["pid"]) == ["2", "4"]   # the programs stay
    for key, path in packaged["paths"].items():
        assert path.endswith(".aoti.pt2") and os.path.exists(path), key
        assert os.path.exists(path[:-len(".aoti.pt2")] + ".pt2"), key


@pytest.mark.parametrize("variant", VARIANTS)
def test_package_matches_eager_graph(packaged, variant):
    package = aoti.load_package(packaged["paths"][variant])
    graph = build_inference_fn(packaged["model"], variant, NORM)
    pixels = torch.from_numpy(packaged["pixels"])
    for n in (0, 3, P):
        count = torch.tensor(n, dtype=torch.int32)
        with torch.no_grad():
            want = graph(pixels, count)
        got = package(pixels, count)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL, err_msg=f"{variant} {n}")


def test_rung_package_matches_eager_rung(packaged):
    package = aoti.load_package(packaged["paths"]["pid_p2"])
    graph = build_inference_fn(with_max_prongs(packaged["model"], 2), "pid", NORM)
    pixels = torch.from_numpy(packaged["pixels"][:3])
    count = torch.tensor(2, dtype=torch.int32)
    with torch.no_grad():
        want = graph(pixels, count)
    for g, w in zip(package(pixels, count), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_in_memory_program_packages_as_the_loaded_one(packaged, tmp_path):
    pixels = torch.from_numpy(packaged["pixels"])
    count = torch.tensor(3, dtype=torch.int32)
    program = export_program(build_inference_fn(packaged["model"], "pid", NORM), pixels, count)
    path = aoti.package_program(program, str(tmp_path / "pid.aoti.pt2"), "cpu", P)
    for a, b in zip(aoti.load_package(path)(pixels, count),
                    aoti.load_package(packaged["paths"]["pid"])(pixels, count)):
        assert torch.equal(a, b)


def test_package_for_another_device_raises(packaged, tmp_path):
    pixels = torch.from_numpy(packaged["pixels"])
    program = export_program(build_inference_fn(packaged["model"], "pid", NORM), pixels,
                             torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="exported on cpu"):
        aoti.package_program(program, str(tmp_path / "x.aoti.pt2"), "cuda", P)


@pytest.mark.parametrize("variant", VARIANTS)
def test_loader_matches_package_and_jax(packaged, variant):
    path = packaged["paths"][variant]
    pixels = torch.from_numpy(packaged["pixels"])
    fn = jax.jit(partial(jax_export.build_inference_fn(packaged["jax_model"], variant),
                         packaged["variables"], {k: jnp.asarray(v) for k, v in NORM.items()}))
    for n in (1, 3):
        proc, out_bin = run_loader(packaged, path, n, "--device", "cpu", "--repeat", "2")
        assert "loaded" in proc.stderr and "run:" in proc.stderr
        got = read_outputs(out_bin)
        want = aoti.load_package(path)(pixels, torch.tensor(n, dtype=torch.int32))
        jax_want = jax.device_get(fn(jnp.asarray(packaged["pixels"]),
                                     jnp.asarray(n, jnp.int32)))
        assert len(got) == len(want) == len(jax_want)
        for (dtype, g), w, j in zip(got, want, jax_want):
            assert dtype == PJRT_F32
            np.testing.assert_array_equal(g, w.numpy())
            np.testing.assert_allclose(g, j, **TOL, err_msg=f"{variant} {n}")


CASES = {
    "costs for every rung": {"2": 5.0, "4": 1.0},
    "ties to the smaller rung": {"2": 1.0, "4": 1.0},
    "one rung without a cost": {"2": 1.0},
    "no costs": None,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_picks_rungs_as_select_bucket(packaged, case, tmp_path):
    meta = json.loads((packaged["out"] / "transformercvn_export_meta.json").read_text())
    costs = CASES[case]
    meta.pop("aoti_bucket_ms")
    if costs is not None:
        meta["aoti_bucket_ms"] = costs
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(meta, indent=2))
    prefix = packaged["out"] / "transformercvn_pid"
    for n in (0, 1, 2, 3, 4, 7):                     # 7: over-full
        proc, out_bin = run_loader(packaged, prefix, n, "--device", "cpu", meta=path)
        want = select_bucket(RUNGS, n, None if costs is None else
                             {int(k): v for k, v in costs.items()})
        line = next(l for l in proc.stderr.splitlines() if l.startswith("num_prongs"))
        eligible = [p for p in RUNGS if p >= n] or [max(RUNGS)]
        aware = costs is not None and all(str(p) in costs for p in eligible)
        suffix = "" if want == P else f"_p{want}"
        tail = (f" [cost-aware {costs[str(want)]:.3f} ms]" if aware else "")
        assert line == (f"num_prongs {n} -> bucket {want}{tail} "
                        f"({prefix}{suffix}.aoti.pt2)"), (case, n, line)
        outputs = read_outputs(out_bin)
        assert outputs[1][1].shape == (want, 8)


GRAPH_CASES = {
    # (aoti_bucket_ms, aoti_graph_bucket_ms)
    "graph costs for every rung": ({"2": 5.0, "4": 1.0}, {"2": 1.0, "4": 3.0}),
    "graph costs tie": ({"2": 5.0, "4": 1.0}, {"2": 2.0, "4": 2.0}),
    "a rung without a graph cost": ({"2": 5.0, "4": 1.0}, {"2": 1.0}),
    "no graph costs": ({"2": 5.0, "4": 1.0}, None),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_loader_picks_rungs_on_graph_costs(packaged, case, tmp_path):
    """``--graph`` picks by the captured rungs' costs where every eligible
    rung has one, else by the uncaptured ones', as ``select_bucket`` given
    those costs; without ``--graph`` the graph costs are not read.  A card
    package's meta, ``--dry_run``: the choice alone, nothing loaded."""
    meta = json.loads((packaged["out"] / "transformercvn_export_meta.json").read_text())
    eager, graph = GRAPH_CASES[case]
    meta.update(aoti_platform="cuda", aoti_bucket_ms=eager)
    if graph is not None:
        meta["aoti_graph_bucket_ms"] = graph
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(meta, indent=2))
    prefix = packaged["out"] / "transformercvn_pid"
    for n in (0, 1, 2, 3, 4, 7):
        eligible = [p for p in RUNGS if p >= n] or [max(RUNGS)]
        use_graph = graph is not None and all(str(p) in graph for p in eligible)
        for flags, costs, tag in ((("--graph",), graph if use_graph else eager,
                                   "graph cost-aware" if use_graph else "cost-aware"),
                                  ((), eager, "cost-aware")):
            proc, _ = run_loader(packaged, prefix, n, "--dry_run", *flags, meta=path)
            want = select_bucket(RUNGS, n, {int(k): v for k, v in costs.items()})
            suffix = "" if want == P else f"_p{want}"
            assert proc.stderr.splitlines() == [
                f"num_prongs {n} -> bucket {want} [{tag} {costs[str(want)]:.3f} ms] "
                f"({prefix}{suffix}.aoti.pt2)"], (case, n, flags, proc.stderr)


def test_graph_loader_needs_the_card(packaged):
    """``--graph`` on the CPU exits 2 with a message and runs nothing."""
    proc, _ = run_loader(packaged, packaged["paths"]["pid"], 1, "--device", "cpu",
                         "--graph", expect=2)
    assert proc.returncode == 2 and "--graph captures a CUDA graph" in proc.stderr
    assert "loaded" not in proc.stderr and "wrote" not in proc.stdout


def test_graph_package_runs_uncaptured_on_the_cpu(packaged):
    pixels = torch.from_numpy(packaged["pixels"])
    count = torch.tensor(3, dtype=torch.int32)
    graph = aoti.load_package(packaged["paths"]["pid"], graph=True)
    got = graph(pixels, count)
    want = aoti.load_package(packaged["paths"]["pid"])(pixels, count)
    assert len(got) == len(want) == 2 and not graph.graphs.graphs
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_broken_source_raises(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "aoti_loader.cpp").write_text(
        (build.CSRC_DIR / "aoti_loader.cpp").read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="failed on"):
        build.build_loader(src, tmp_path / "out")
    assert not any((tmp_path / "out").glob("aoti_loader-*"))


def test_loader_failures_exit_nonzero(packaged, tmp_path):
    proc, _ = run_loader(packaged, tmp_path / "missing.aoti.pt2", 1, "--device", "cpu",
                         expect=1)
    assert "aoti_loader failed" in proc.stderr
    proc, _ = run_loader(packaged, packaged["paths"]["pid"], 1, expect=1)   # --device cuda
    assert "CUDA is not available" in proc.stderr
    meta = json.loads((packaged["out"] / "transformercvn_export_meta.json").read_text())
    meta["aoti_platform"] = "cuda"
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    proc, _ = run_loader(packaged, packaged["paths"]["pid"], 1, "--device", "cpu",
                         meta=tmp_path / "meta.json", expect=1)
    assert 'records packages for "cuda"' in proc.stderr
    short = tmp_path / "short.bin"
    shutil.copy(packaged["root"] / "pixels.bin", short)
    with open(short, "r+b") as f:
        f.truncate(100)
    proc = subprocess.run([str(packaged["loader"]), packaged["paths"]["pid"],
                           str(packaged["out"] / "transformercvn_export_meta.json"), str(short),
                           "1", str(tmp_path / "o.bin"), "--device", "cpu"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "input shape wants" in proc.stderr


def test_inductor_compiler_links_openmp(tmp_path, monkeypatch):
    """A ``$CXX`` whose driver lacks OpenMP's link spec (as the H100 host's
    does) is passed over for ``g++``; with neither, packaging raises."""
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho libgomp.spec\n")
    fake.chmod(0o755)
    real = shutil.which("g++")
    monkeypatch.setenv("CXX", str(fake))
    assert aoti.inductor_compiler() == real
    monkeypatch.setenv("PATH", str(tmp_path))
    os.symlink(fake, tmp_path / "g++")
    with pytest.raises(RuntimeError, match="libgomp.spec"):
        aoti.inductor_compiler()
