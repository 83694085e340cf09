"""The port's export (``export.py``) against the JAX package's
(``dune_transformercvn_tpu/export.py``), on the CPU.

* ``_fold_event_probs``, ``_normalize_buckets`` and ``select_bucket`` give
  JAX's results on JAX's cases and on seeded random ladders and costs;
* ``build_inference_fn`` of every variant equals JAX's at ``num_prongs`` 0,
  3 and 20, on weights carried from JAX, for the dense family at JAX's
  tiny export config (10 event classes, 64x48) and for coo: probabilities
  within 1e-5, hidden vectors within 1e-4 (atol and rtol);
* garbage in the padding rows leaves the outputs alone;
* ``python -m dune_transformercvn_torch.export --device cpu --check
  --bench_buckets --buckets 4`` on a run dir the port's ``train`` CLI made
  in 2 steps writes and checks the ladder's 6 artifacts (the default
  ladder's 12 cost ~40 s more on a CPU): each loads and equals the eager graph
  of the restored model (atol 1e-6), a rung equals the full graph on its
  first ``num_prongs`` rows, and the meta has JAX's keys, and JAX's values
  where they do not depend on the model (no ``graph_bucket_ms`` on the
  CPU, where ``load_exported(..., graph=True)`` runs the program
  uncaptured, bit-equal to ``load_exported``'s);
* the pid artifact round-trips for every other family;
* without CUDA, ``export_model`` with no device raises; a model on another
  device than the one asked for raises; a model in train mode is in train
  mode again after its export, on the device it was on.
"""

import dataclasses
import json
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
from dune_transformercvn_torch import Options, export
from dune_transformercvn_torch.export import (VARIANTS, build_inference_fn, export_model,
                                              export_program, load_exported, with_max_prongs)
from dune_transformercvn_torch.from_jax import load_jax_variables
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from dune_transformercvn_torch.train import CheckpointManager, Trainer
from _torch_families import FAMILIES, family_configs  # same-dir helpers
from test_torch_port_loop import TINY, run_cli, small_synthetic_file
from test_torch_port_network import random_variables

torch.set_num_threads(2)

PROB_TOL = dict(atol=1e-5, rtol=0.0)
HIDDEN_TOL = dict(atol=1e-4, rtol=1e-4)
H, W, P = 64, 48, 20
NORM = {"mean": np.zeros(5, np.float32), "std": np.ones(5, np.float32),
        "extra_mean": np.float32(0.0), "extra_std": np.float32(1.0)}


def test_fold_event_probs_matches_jax():
    rng = np.random.default_rng(0)
    for classes in (10, 4):
        probs = rng.dirichlet(np.ones(classes), size=3).astype(np.float32)
        want = np.asarray(jax_export._fold_event_probs(jnp.asarray(probs), classes))
        got = export._fold_event_probs(torch.from_numpy(probs), classes).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    folded = export._fold_event_probs(torch.arange(10.0) / 45.0, 10)
    np.testing.assert_allclose(folded.numpy(), [6 / 45, 22 / 45, 8 / 45, 9 / 45], rtol=1e-6)


def test_bucket_rules_match_jax():
    cases = [((4, 8, 12), 20), ((8, 4, 8, 50), 20), (None, 20), ((4, 8), 8), ((), 5)]
    for buckets, capacity in cases:
        assert (export._normalize_buckets(buckets, capacity)
                == jax_export._normalize_buckets(buckets, capacity))
    head = {4: 1.55, 8: 2.62, 12: 3.92, 20: 5.07}
    assert export.select_bucket((4, 8, 12, 20), 3, head) == 4
    assert export.select_bucket((4, 8), 13) == 8
    rng = np.random.default_rng(1)
    for _ in range(300):
        capacity = int(rng.integers(1, 24))
        ladder = export._normalize_buckets(
            rng.integers(-2, 26, size=rng.integers(0, 6)).tolist(), capacity)
        assert ladder == jax_export._normalize_buckets(ladder, capacity)
        # rounded costs give ties, which go to the smaller capacity
        costs = {p: float(rng.integers(1, 5)) for p in ladder if rng.random() < 0.9}
        for n in range(0, capacity + 3):
            for ms in (None, costs):
                assert (export.select_bucket(ladder, n, ms)
                        == jax_export.select_bucket(ladder, n, ms)), (ladder, n, ms)


def export_configs(embedder="dense"):
    """JAX's tiny export config (tests/test_export.py), in both packages."""
    o = JaxOptions()
    o.update_options(dict(
        densenet_structure=[1], densenet_growth_rate=8, initial_pixel_dim=8,
        pixel_embedding_dim=16, feature_embedding_dim=8, position_embedding_dim=8,
        hidden_dim=32, num_encoder_layers=1, num_attention_heads=4, compute_dtype="float32"))
    cfg = JaxModelConfig.from_options(o, features_dim=5, extra_dim=3, pixel_channels=3,
                                      num_event_classes=10, num_prong_classes=8,
                                      image_shape=(H, W), embedder=embedder)
    return cfg, ModelConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(ModelConfig)})


def raw_pixels(seed, rows=1 + P):
    rng = np.random.default_rng(seed)
    pixels = rng.uniform(size=(rows, 3, H, W)) < 0.02
    return (pixels * rng.uniform(16, 255, pixels.shape)).astype(np.float32)


def jax_example_inputs():
    """``forward_from_images``'s inputs for one event (the shapes JAX's
    variables are drawn in)."""
    images = jnp.zeros((1 + P, H, W, 3))
    return (images[:1], images[1:], jnp.zeros((1, P, 5)), jnp.zeros((1, 3)),
            jnp.ones((1, P), bool), jnp.zeros(P, jnp.int32), jnp.arange(P, dtype=jnp.int32),
            jnp.ones(P, bool), {k: jnp.asarray(v) for k, v in NORM.items()})


@pytest.fixture(scope="module", params=["dense", "coo"])
def models(request):
    cfg, port_cfg = export_configs(request.param)
    jax_model = JaxTransformerCVN(cfg)
    variables = random_variables(jax_model, 11, *jax_example_inputs(),
                                 method=JaxTransformerCVN.forward_from_images, train=False)
    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    return request.param, jax_model, variables, model


def test_inference_fn_matches_jax(models):
    _, jax_model, variables, model = models
    fn = jax.jit(partial(jax_export.build_inference_fn(jax_model, "combined"), variables,
                         {k: jnp.asarray(v) for k, v in NORM.items()}))
    pixels = raw_pixels(1)
    graphs = {v: build_inference_fn(model, v, NORM) for v in VARIANTS}
    for n in (0, 3, 20):
        want = jax.device_get(fn(jnp.asarray(pixels), jnp.asarray(n, jnp.int32)))
        with torch.no_grad():
            got = {v: g(torch.from_numpy(pixels), torch.tensor(n, dtype=torch.int32))
                   for v, g in graphs.items()}
        assert [t.shape for t in got["combined"]] == [(4,), (P, 8), (32,), (P, 32)]
        for g, w, tol in zip(got["combined"], want, (PROB_TOL, PROB_TOL,
                                                      HIDDEN_TOL, HIDDEN_TOL)):
            np.testing.assert_allclose(g.numpy(), w, **tol, err_msg=f"num_prongs {n}")
        for a, b in zip(got["pid"] + got["embeddings"], got["combined"]):
            assert torch.equal(a, b)


def test_padding_rows_do_not_leak(models):
    _, _, _, model = models
    graph = build_inference_fn(model, "combined", NORM)
    pixels = torch.from_numpy(raw_pixels(2))
    poisoned = pixels.clone()
    poisoned[1 + 4:] = 255.0
    n = torch.tensor(4, dtype=torch.int32)
    with torch.no_grad():
        clean, dirty = graph(pixels, n), graph(poisoned, n)
    for a, b in zip(clean, dirty):
        rows = slice(None) if a.ndim == 1 else slice(0, 4)
        torch.testing.assert_close(b[rows], a[rows], rtol=0.0, atol=1e-6)


@pytest.fixture(scope="module")
def cli_export(tmp_path_factory):
    """A run dir the ``train`` CLI made in 2 steps, exported by the
    ``export`` CLI with the ladder (4,), timed and checked; and the run's
    restored model."""
    root = tmp_path_factory.mktemp("cli")
    data = small_synthetic_file(root / "train.h5", 32, 9)
    (root / "options.json").write_text(json.dumps({**TINY, "training_file": data}))
    run_cli("train", "-o", "options.json", "-n", "run", "-l", "logs", "--device", "cpu",
            "--max_steps", "2", "-e", "2", "--threads", "2", cwd=root)
    run_dir = root / "logs" / "run" / "version_0"
    out = run_cli("export", str(run_dir), "--device", "cpu", "--buckets", "4",
                  "--bench_buckets", "--check", cwd=root)
    options = Options.load(str(run_dir / "options.json"))
    trainer = Trainer(options, run_dir=None, debug=True, verbose=False, device="cpu")
    CheckpointManager(str(run_dir / "checkpoints")).restore(trainer.state)
    norm = {k: v.numpy() for k, v in trainer.state.norm.items()}
    return run_dir / "export", out, trainer.state.model, norm


def test_cli_exports_and_checks_a_trained_run(cli_export):
    export_dir, out, _, _ = cli_export
    assert sorted(p.name for p in export_dir.iterdir()) == sorted(
        [f"transformercvn_{v}{s}.pt2" for v in VARIANTS for s in ("", "_p4")]
        + ["transformercvn_export_meta.json"])
    assert out.count("checking ") == 6 and out.count("output 0: shape") == 6
    # the default ladder: 4 rungs of 3 graphs
    assert len(export._normalize_buckets(export.DEFAULT_PRONG_BUCKETS, P)) * len(VARIANTS) == 12


def test_artifacts_round_trip(cli_export):
    export_dir, _, model, norm = cli_export
    cfg = model.cfg
    rng = np.random.default_rng(4)
    pixels = rng.uniform(size=(1 + P, 3, cfg.image_height, cfg.image_width)) < 0.02
    pixels = torch.from_numpy((pixels * 200.0).astype(np.float32))
    n = torch.tensor(3, dtype=torch.int32)
    outputs = {}
    for variant in VARIANTS:
        for capacity, suffix in ((4, "_p4"), (P, "")):
            rows = pixels[:1 + capacity]
            eager = build_inference_fn(with_max_prongs(model, capacity), variant, norm)
            with torch.no_grad():
                want = eager(rows, n)
            got = load_exported(str(export_dir / f"transformercvn_{variant}{suffix}.pt2"))(
                rows, n)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0.0, atol=1e-6)
            outputs[capacity] = got
        for rung, full in zip(outputs[4], outputs[P]):   # the first 3 rows agree
            rows = slice(None) if full.ndim == 1 else slice(0, 3)
            torch.testing.assert_close(rung[rows], full[rows], rtol=0.0, atol=1e-5)


def test_graph_loader_runs_uncaptured_on_the_cpu(cli_export):
    """``load_exported(..., graph=True)`` on the CPU: the program uncaptured,
    bit-equal to ``load_exported``'s; the CPU meta has no graph costs."""
    export_dir, _, model, _ = cli_export
    cfg = model.cfg
    pixels = torch.from_numpy((np.random.default_rng(6).uniform(
        size=(1 + P, 3, cfg.image_height, cfg.image_width)) < 0.02).astype(np.float32) * 90)
    n = torch.tensor(2, dtype=torch.int32)
    path = str(export_dir / "transformercvn_pid.pt2")
    graph = load_exported(path, graph=True)
    for g, w in zip(graph(pixels, n), load_exported(path)(pixels, n)):
        assert torch.equal(g, w)
    assert not graph.graphs.graphs
    meta = json.loads((export_dir / "transformercvn_export_meta.json").read_text())
    assert "bucket_ms" in meta and "graph_bucket_ms" not in meta


def test_meta_matches_jax(cli_export, tmp_path):
    export_dir, _, model, _ = cli_export
    cfg, _ = export_configs()
    jax_model = JaxTransformerCVN(cfg)
    variables = random_variables(jax_model, 12, *jax_example_inputs(),
                                 method=JaxTransformerCVN.forward_from_images, train=False)
    jax_export.export_model(jax_model, variables, {k: jnp.asarray(v) for k, v in NORM.items()},
                            str(tmp_path), prong_buckets=(4,), bench_buckets=True)
    got = json.loads((export_dir / "transformercvn_export_meta.json").read_text())
    want = json.loads((tmp_path / "transformercvn_export_meta.json").read_text())
    assert got.keys() == want.keys()
    for key in ("input_dtypes", "prong_buckets", "num_event_classes_folded",
                "num_prong_classes", "variants", "platforms", "bucket_ms_platform"):
        assert got[key] == want[key], key
    mc = model.cfg
    assert got["input_shape"] == [1 + P, 3, mc.image_height, mc.image_width]
    assert (got["max_prongs"], got["hidden_dim"]) == (P, mc.hidden_dim)
    assert got["outputs"]["combined"] == [
        {"shape": s, "dtype": "float32"} for s in ([4], [P, 8], [mc.hidden_dim],
                                                    [P, mc.hidden_dim])]
    assert {v: [o["dtype"] for o in outs] for v, outs in got["outputs"].items()} == {
        v: [o["dtype"] for o in outs] for v, outs in want["outputs"].items()}
    assert got["bucket_ms"].keys() == want["bucket_ms"].keys() == {"4", "20"}
    assert all(v > 0 for v in got["bucket_ms"].values())
    assert {v: {p: f.replace(".pt2", "") for p, f in files.items()}
            for v, files in got["bucket_files"].items()} == {
        v: {p: f.replace(".stablehlo", "") for p, f in files.items()}
        for v, files in want["bucket_files"].items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_pid_round_trips_for_family(family, tmp_path):
    _, cfg = family_configs(family)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(5)).eval()
    rung = with_max_prongs(model, 2)
    graph = build_inference_fn(rung, "pid", NORM | {"mean": np.zeros(cfg.features_dim),
                                                   "std": np.ones(cfg.features_dim)})
    rng = np.random.default_rng(6)
    pixels = rng.uniform(size=(3, cfg.pixel_channels, cfg.image_height, cfg.image_width))
    pixels = torch.from_numpy(((pixels < 0.02) * 200.0).astype(np.float32))
    n = torch.tensor(2, dtype=torch.int32)
    path = str(tmp_path / f"{family}.pt2")
    torch.export.save(export_program(graph, pixels, n), path)
    with torch.no_grad():
        want = graph(pixels, n)
    got = load_exported(path)(pixels, n)
    assert [t.shape for t in got] == [(4,), (2, 8)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0.0, atol=1e-6)


def test_no_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = export_configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model(TransformerCVN(cfg), NORM, str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_export_leaves_the_model_as_it_was(tmp_path):
    _, cfg = export_configs()
    model = TransformerCVN(dataclasses.replace(cfg, max_prongs=2)).train()
    with pytest.raises(ValueError, match="parameters are on cpu, not on meta"):
        export_model(model, NORM, str(tmp_path / "meta"), device="meta")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    paths = export_model(model, NORM, str(tmp_path), prong_buckets=(), device="cpu")
    assert sorted(paths) == sorted(VARIANTS)
    assert all(m.training for m in model.modules())
    for key, value in model.state_dict().items():
        assert value.device.type == "cpu" and torch.equal(value, state[key]), key
