"""Weights across the frameworks, and the port package's hygiene.

* ``from_jax.state_dict_from_jax`` is the exact inverse of the JAX package's
  ``torch_import.transplant_dense_network``: JAX variables -> port
  ``state_dict`` -> JAX variables again, leaf for leaf, with every key of
  the port's ``state_dict`` read by the importer (so the port's names are
  the reference network's);
* ``load_jax_variables`` is strict both ways;
* every other family's mapping takes each JAX leaf once, fills every port
  tensor and inverts leaf for leaf;
* no module of the port imports JAX (or flax, optax, orbax) or any name of
  the JAX package; importing the port builds and loads no CUDA code.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.data import Batcher, EventDataset
from dune_transformercvn_tpu.models import ModelConfig as JaxModelConfig
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.torch_import import (
    _TrackedDict, _none_tree, transplant_dense_network)
from dune_transformercvn_torch.from_jax import (load_jax_variables, map_jax_variables,
                                                state_dict_from_jax)
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from _torch_families import FAMILIES, batches_and_norm, family_configs  # same-dir helpers

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dune_transformercvn_torch"

VARIANTS = {
    # smart features on (their MLP is mapped too), dropout > 0 (the
    # reference's Dropout entries shift the prong decoder's indices),
    # pre-norm encoder
    "smart": dict(disable_smart_features=False, dropout=0.1, transformer_norm_first=True),
    # the production toggles
    "production": dict(disable_smart_features=True, stem_space_to_depth=True),
}


def tiny_config(**overrides):
    cfg = JaxModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=8,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=2, num_prong_decoder_layers=3, num_attention_heads=4,
        densenet_structure=(2, 1, 2), densenet_growth_rate=8,
        image_height=32, image_width=32, compute_dtype="float32", **overrides)
    port = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return cfg, port


@pytest.fixture(scope="module")
def batch_and_norm(synthetic_file):
    ds = EventDataset(synthetic_file, limit_index=(0.0, 0.1))
    ds.compute_statistics()
    batch = Batcher(ds, batch_size=4, coo_granularity=512).build_batch(np.arange(4))
    norm = {"mean": ds.mean, "std": ds.std,
            "extra_mean": ds.extra_mean, "extra_std": ds.extra_std}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in norm.items()})


def seeded_variables(cfg, batch_and_norm, seed):
    """A variable tree of ``cfg``'s network with distinct seeded values in
    every leaf (shapes from ``jax.eval_shape``: no compile)."""
    shapes = jax.eval_shape(partial(JaxTransformerCVN(cfg).init, train=False),
                            jax.random.PRNGKey(0), *batch_and_norm)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda leaf: rng.normal(size=leaf.shape).astype(np.float32), shapes)
    return {c: dict(t) for c, t in tree.items()}


def leaves_by_path(tree):
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dict_inverts_torch_import(variant, batch_and_norm):
    cfg, port_cfg = tiny_config(**VARIANTS[variant])
    variables = seeded_variables(cfg, batch_and_norm, seed=3)
    sd = _TrackedDict(state_dict_from_jax(variables, port_cfg))

    params = _none_tree(variables["params"])
    stats = _none_tree(variables["batch_stats"])
    transplant_dense_network(sd, params, stats, heads=cfg.num_attention_heads)

    assert set(sd) == sd.accessed, sorted(set(sd) - sd.accessed)
    for collection, back in (("params", params), ("batch_stats", stats)):
        want, got = leaves_by_path(variables[collection]), leaves_by_path(back)
        assert set(got) == set(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=f"{collection}{path}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_load_jax_variables_fills_every_tensor(variant, batch_and_norm):
    cfg, port_cfg = tiny_config(**VARIANTS[variant])
    variables = seeded_variables(cfg, batch_and_norm, seed=4)
    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    num_leaves = len(jax.tree_util.tree_leaves(variables))
    # q, k and v kernels and biases (6 leaves) pack into in_proj (2 tensors)
    assert len(model.state_dict()) == num_leaves - 4 * cfg.num_encoder_layers
    got = model.state_dict()
    np.testing.assert_array_equal(
        got["prong_embedding.event_pixel_embedding.features.conv0.weight"].numpy(),
        variables["params"]["event_pixel_embedding"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        got["prong_embedding.combined_embedding.norm.running_var"].numpy(),
        variables["batch_stats"]["combined_embedding"]["MaskedBatchNorm_0"]["var"])


def test_load_jax_variables_is_strict(batch_and_norm):
    cfg, port_cfg = tiny_config(learned_classifier_token=True)
    variables = seeded_variables(cfg, batch_and_norm, seed=5)
    model = TransformerCVN(port_cfg)
    assert tuple(model.classifier_embedding.shape) == (1, 1, 32)
    load_jax_variables(model, variables)
    np.testing.assert_array_equal(model.classifier_embedding.detach().numpy(),
                                  variables["params"]["classifier_embedding"])

    extra = {c: dict(t) for c, t in variables.items()}
    extra["params"]["unexpected"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_variables(model, extra)

    missing = {c: dict(t) for c, t in variables.items()}
    del missing["params"]["prong_position_embedding"]
    with pytest.raises(KeyError, match="prong_position_embedding"):
        load_jax_variables(model, missing)


@pytest.mark.parametrize("family", FAMILIES)
def test_every_family_round_trips_through_from_jax(family, synthetic_file):
    """``map_jax_variables`` takes every JAX leaf exactly once and fills
    every parameter and buffer of the family's port network; inverting each
    tensor's layout change (OIHW -> HWIO, ``[out, in]`` -> ``[in, out]``)
    gives its JAX leaf back bit for bit."""
    (batch,), norm = batches_and_norm(synthetic_file, family)
    cfg, port_cfg = family_configs(family)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    variables = seeded_variables(cfg, (jb, jn), seed=6)
    mapper = map_jax_variables(variables, port_cfg)
    model = TransformerCVN(port_cfg)
    model.load_state_dict(mapper.state_dict(), strict=True)
    leaves = {"/".join([c, *(k.key for k in path)]): np.asarray(leaf)
              for c in ("params", "batch_stats")
              for path, leaf in jax.tree_util.tree_leaves_with_path(variables[c])}
    taken = [leaf for sources in mapper.sources.values() for leaf in sources]
    assert sorted(taken) == sorted(leaves)
    for name, tensor in model.state_dict().items():
        if len(mapper.sources[name]) != 1:           # the encoder's packed q/k/v
            continue
        (source,), value = mapper.sources[name], tensor.numpy()
        if source.endswith("kernel"):    # attention's out kernel is [h, hd, D]
            value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
        np.testing.assert_array_equal(value.reshape(leaves[source].shape), leaves[source],
                                      err_msg=name)


def test_initialisation_depends_only_on_the_generator():
    _, port_cfg = tiny_config()
    torch.manual_seed(123)
    before = torch.get_rng_state()
    a = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    torch.set_rng_state(before)
    torch.manual_seed(456)
    b = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0, msg=name)
    w = a["prong_embedding.event_pixel_embedding.features.conv0.weight"]
    assert w.abs().max() <= 2.0 / np.sqrt(3 * 7 * 7) / 0.8796 + 1e-6   # 2-std truncation
    assert float(a["prong_embedding.event_pixel_embedding.features.conv0.bias"].abs().max()) == 0


# ---------------------------------------------------------------------------
# package hygiene
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dune_transformercvn_tpu")


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            if node.module == "dune_transformercvn_tpu":
                yield from (f"dune_transformercvn_tpu.{a.name}" for a in node.names)


def test_port_imports_no_jax_and_only_framework_free_modules():
    """No module of the port imports JAX or any name of the JAX package,
    not even its framework-free ``config`` and ``data`` (the port keeps its
    own copies)."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 25 and {
        PORT / "parallel" / "mesh.py", PORT / "export.py", PORT / "torch_import.py",
        PORT / "ops" / "fold.py", PORT / "ops" / "quant.py", PORT / "ops" / "coo_conv.py",
        PORT / "utils" / "native.py", PORT / "models" / "encoder.py",
        PORT / "train" / "optimizer.py", PORT / "aoti.py", PORT / "bench.py",
        PORT / "utils" / "cache.py", PORT / "utils" / "compile.py"} <= set(files)
    names = set()
    for path in files:
        for name in imported_modules(path):
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(REPO)} imports {name}")
            names.add(name)
    assert "torch" in names and "numpy" in names


def code_strings(path: Path):
    """The string constants of a Python file's code (docstrings left out)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {id(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings]


def test_port_loads_nothing_of_the_jax_package():
    """No string the port's code or the smoke uses names the JAX package or
    its native build product (``native/_coo_engine.so``): the port builds its
    own engine from ``csrc/coo_engine.cpp``; its C++ and CUDA sources
    include nothing of the JAX package's."""
    # the smoke's JSON line cites each TPU kernel it replaces by file:line
    citation = re.compile(r"dune_transformercvn_tpu/[\w/]+\.py:\d+")
    for path in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                                 REPO / "compile_probe.py",
                                                 REPO / "recipes_probe.py"]:
        for text in code_strings(path):
            if citation.fullmatch(text):
                continue
            assert "_coo_engine" not in text and "dune_transformercvn_tpu" not in text \
                and "native/" not in text, f"{path.relative_to(REPO)}: {text!r}"
    sources = sorted((PORT / "csrc").glob("*.c*"))
    assert {p.name for p in sources} >= {"coo_engine.cpp", "densify.cu", "coo_stem.cu"}
    for path in sources:
        includes = [line for line in path.read_text().splitlines()
                    if line.startswith("#include")]
        assert all("native" not in line and "tpu" not in line for line in includes), path


def test_chip_smoke_imports_no_jax():
    """The smoke, and the compile and recipes probes beside it, stand on
    the port alone: no JAX and nothing of the JAX package."""
    names = set(imported_modules(REPO / "chip_smoke.py"))
    assert not {n for n in names if n.split(".")[0] in FORBIDDEN}
    assert "dune_transformercvn_torch.data" in names
    assert "dune_transformercvn_torch.train" in names
    probe = set(imported_modules(REPO / "compile_probe.py"))
    assert not {n for n in probe if n.split(".")[0] in FORBIDDEN}
    assert {"chip_smoke", "dune_transformercvn_torch"} <= probe, probe
    recipes = set(imported_modules(REPO / "recipes_probe.py"))
    assert "torch" in recipes and not {n for n in recipes if n.split(".")[0] in FORBIDDEN}


def test_importing_the_port_builds_and_loads_no_cuda(tmp_path):
    """In a fresh interpreter: import every module of the port; JAX stays
    unimported, CUDA uninitialised, no kernel library built or loaded."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys, torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from dune_transformercvn_torch.utils import build\n"
        "from dune_transformercvn_torch.ops import coo_stem, densify\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'dune_transformercvn_tpu')], 'jax imported'\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert build._loaded == {}\n"
        "from dune_transformercvn_torch.utils import native\n"
        "assert native._lib is None\n"
        "assert densify._kernel.cache_info().currsize == 0\n"
        "assert densify.densify_images_cuda.launches == 0\n"
        "assert coo_stem._kernel.cache_info().currsize == 0\n"
        "assert coo_stem.scatter_patches_cuda.launches == 0\n"
        "print(len(sys.argv), 'ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "DUNE_TCVN_PLATFORM"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
