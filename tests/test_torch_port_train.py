"""The port's training pieces against the JAX package: losses, schedules,
the decay rule (every family), global-norm clipping, one and three train
steps of the dense and the coo family, and the eval step with its metrics.

Networks are tiny (48x40 images, DenseNet [2, 2], two encoder layers),
float32, dropout 0, pixel noise 0, weights from seeded numpy carried by
``from_jax``; batches come from the ``synthetic_file`` fixture with hit
coordinates scaled to 48x40.  Tolerances: losses and metrics ``rtol=1e-5``;
``grad_norm`` ``rtol=1e-4``; BatchNorm running statistics ``rtol=1e-5``
with ``atol=1e-5`` for means near zero (both frameworks take the batch
variance as E[x^2] - E[x]^2 in float32, whose cancellation turns
summation-order rounding into a few 1e-6 absolute); parameters after the steps
``atol = 1e-6 + 1e-2 * lr``.  The learning rate, 1e-5, is near the
production option file's 7.6e-6.

At the end of this file, the compiled train step (``compile=True``) with
the memory recipes:
``remat_cnn``, ``remat_embedder`` and ``embedder_chunk`` (with and without
``embedder_chunk_save_spatial``), the counterpart of the JAX package's
``nn.remat`` and ``nn.scan`` inside its jitted step.

* Each recipe's compiled step is one Dynamo graph with no graph break
  (``compile_step`` compiles with ``fullgraph``), and two compiled steps
  hold to the eager steps and to the JAX package's jitted step with the
  same recipe (tiny widths, ``test_torch_port_compile``'s ``SMALL``
  network, float32, dropout 0, pixel noise 0, transplanted weights): the
  metrics and, after the steps, the running statistics.  The running
  statistics move once a step: they equal those of the plain eager steps
  (no recipe; with chunking, whose convolutions run over other batch
  sizes, within ``TOL``).
* dense ``remat_cnn`` compiles with Inductor and is held to
  ``test_torch_port_compile.test_compiled_dense_steps_match_eager_and_jax``'s
  tolerances: ``TOL`` plus twice each reference's spread over the 23
  reorderings of the batch's events; gradients by its ``grads_close``.
  The other cases compile on the ``aot_eager`` backend, which runs the
  graph Dynamo and AOTAutograd traced (the checkpoint regions, the chunk
  region, the recompute in the backward) with eager kernels, so that the
  tests stay within their time here (Inductor compiles C++ for a CPU
  graph, ~40 s each): equal to the eager step bit for bit, and within
  ``TOL`` of JAX's step: for the dense and coo families, of JAX's step
  run in float64 (:func:`jax_float64_steps`), for sdxl of its float32
  step.  The float64 run is JAX's exact function: on AVX-512 hosts JAX's
  own float32 coo ``remat_cnn`` step is the one far from it (first
  ``grad_norm`` 10.697811 against 10.6989105488 in float64, 1.03e-4 of
  it, more than twice its spread over the 23 reorderings of the batch's
  events, 4.66e-4), while the port's is 10.698912 (1.1e-7 of it).  JAX's
  first BatchNorm takes ``E[x^2] - E[x]^2`` over sums that cancel, and its
  float32 sums round more there than the reorderings show.
* ``embedder_chunk``: the chunk body is one region (``invoke_subgraph``),
  traced once for each bank (event, prong) however many chunks run it,
  as JAX's ``nn.scan`` traces its body once.
* Dropout inside a rematted body: the compiled graph keeps the first
  run's draws (the forward graph draws, the backward graph draws
  nothing), and a compiled step with dropout 0.1 and pixel noise on
  equals the eager step bit for bit on ``aot_eager``.  Eagerly a remat
  runs no selective-checkpoint mode (its recompute draws again from the
  saved generator state), and equals a remat that keeps its draws
  (``keep_draws``, the graph step's) bit for bit.
* ``compile_step`` sets Dynamo's
  ``skip_fwd_side_effects_in_bwd_under_checkpoint`` only around its calls.
"""

import contextlib
import copy
import dataclasses
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch._dynamo.backends.common import aot_autograd
from torch._dynamo.utils import counters

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.data import Batcher, EventDataset
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.ops import losses as jax_losses
from dune_transformercvn_tpu.parallel.mesh import create_mesh
from dune_transformercvn_tpu.train import schedules as jax_schedules
from dune_transformercvn_tpu.train.metrics import finalize_metrics as jax_finalize_metrics
from dune_transformercvn_tpu.train.metrics import init_metric_state as jax_init_metric_state
from dune_transformercvn_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from dune_transformercvn_tpu.train.optimizer import decay_mask as jax_decay_mask
from dune_transformercvn_tpu.train.state import TrainState as JaxTrainState
from dune_transformercvn_tpu.train.step import make_eval_step as jax_make_eval_step
from dune_transformercvn_tpu.train.step import make_train_step as jax_make_train_step
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.from_jax import (load_jax_variables, map_jax_variables,
                                                state_dict_from_jax)
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.ops import losses
from dune_transformercvn_torch.predict import to_device
from dune_transformercvn_torch.train import (create_optimizer, create_train_state,
                                             decay_mask, finalize_metrics,
                                             init_metric_state, make_eval_step,
                                             make_train_step, schedules)
from dune_transformercvn_torch.train.optimizer import OptaxChain, clip_by_global_norm_, global_norm
from _torch_families import batches_and_norm, family_configs  # same-dir test helpers
from test_torch_port_coo import Scaled, tiny_coo_config
from test_torch_port_network import random_variables

torch.set_num_threads(1)
torch._inductor.config.compile_threads = 1

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def loss_inputs(seed, n=12, k=4):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(n, k))).astype(np.float32)
    targets = rng.integers(0, 10 if k == 4 else k, n).astype(np.int32)
    targets[[1, 5]] = -1                                   # padding rows
    return logits, targets


@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_softmax_focal_loss_matches_jax(gamma):
    logits, targets = loss_inputs(1, k=8)
    targets = np.where(targets >= 0, targets % 8, -1).astype(np.int32)
    w = (targets >= 0).astype(np.float32)
    for weights in (None, w):
        want = jax_losses.softmax_focal_loss(
            jnp.asarray(logits), jnp.asarray(targets), gamma,
            None if weights is None else jnp.asarray(weights))
        got = losses.softmax_focal_loss(
            torch.from_numpy(logits), torch.from_numpy(targets), gamma,
            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_event_losses_match_jax():
    logits, targets = loss_inputs(2)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    jl, jt = jnp.asarray(logits), jnp.asarray(targets)
    for got, want in zip(losses.split_event_targets(tt), jax_losses.split_event_targets(jt)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    current = np.where(targets >= 0, targets % 4, -1).astype(np.int32)
    np.testing.assert_allclose(
        losses.binary_event_loss(tl, torch.from_numpy(current)).numpy(),
        np.asarray(jax_losses.binary_event_loss(jl, jnp.asarray(current))), **LOSS_TOL)
    for loss_type in ("focal", "sigmoid", "softmax"):
        for gamma in (0.0, 1.5):
            got = losses.class_balanced_loss(torch.from_numpy(current), tl, 2.5, gamma,
                                             loss_type)
            want = jax_losses.class_balanced_loss(jnp.asarray(current), jl, 2.5, gamma,
                                                  loss_type)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL,
                                       err_msg=f"{loss_type} {gamma}")
    labels = (np.arange(4) == current[:, None]).astype(np.float32)
    alpha = np.random.default_rng(3).uniform(0.1, 1.0, labels.shape).astype(np.float32)
    for gamma in (0.0, 2.0):
        np.testing.assert_allclose(
            losses.sigmoid_focal_loss(torch.from_numpy(labels), tl,
                                      torch.from_numpy(alpha), gamma).numpy(),
            np.asarray(jax_losses.sigmoid_focal_loss(jnp.asarray(labels), jl,
                                                     jnp.asarray(alpha), gamma)),
            **LOSS_TOL)


# ---------------------------------------------------------------------------
# schedules, decay rule, clipping, optimizer names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("constant_schedule", ()),
    ("constant_with_warmup", (7,)),
    ("linear_with_warmup", (7, 40)),
    ("cosine_with_warmup", (7, 40)),
    ("cosine_with_hard_restarts", (7, 40, 3)),
])
def test_schedules_match_jax(name, args):
    ours, theirs = getattr(schedules, name)(*args), getattr(jax_schedules, name)(*args)
    total = args[1] if len(args) > 1 else 40
    steps = np.arange(0, 3 * total + 1)
    got = np.array([ours(int(s)) for s in steps])
    want = np.array([float(theirs(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cycles", [0, 4])
def test_schedule_from_options_matches_jax(cycles):
    kw = dict(epochs=5, learning_rate_warmup_epochs=0.5, learning_rate_cycles=cycles)
    opts, jopts = Options(), JaxOptions()
    opts.update_options(kw)
    jopts.update_options(kw)
    ours, theirs = schedules.from_options(opts, 6), jax_schedules.from_options(jopts, 6)
    for s in range(0, 3 * 30 + 1):
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-6, atol=1e-6)


def batcher_of(synthetic_file, family="coo"):
    """The batcher :func:`batch_and_norm` lays the dense and coo families'
    batches out with: 4 events, a fixed shape, over the scaled dataset."""
    assert family in ("dense", "coo"), family
    ds = EventDataset(synthetic_file, limit_index=(0.0, 0.3), event_current_targets=True)
    ds.compute_statistics()
    return Batcher(Scaled(ds), batch_size=4, coo_granularity=512, fixed_shape=True)


def batch_and_norm(synthetic_file, count=1, family="coo"):
    if family not in ("dense", "coo"):
        return batches_and_norm(synthetic_file, family, count)
    batcher = batcher_of(synthetic_file, family)
    ds = batcher.dataset.dataset
    norm = {"mean": ds.mean, "std": ds.std,
            "extra_mean": ds.extra_mean, "extra_std": ds.extra_std}
    batches = [b for _, b in zip(range(count), batcher.epoch(0))]
    return batches, norm


def family_config(family, **overrides):
    if family not in ("dense", "coo"):
        return family_configs(family, disable_smart_features=False, **overrides)
    cfg, port_cfg = tiny_coo_config(disable_smart_features=False, **overrides)
    if family == "dense":
        cfg = dataclasses.replace(cfg, embedder="dense")
        port_cfg = dataclasses.replace(port_cfg, embedder="dense")
    return cfg, port_cfg


@pytest.mark.parametrize("family", ["dense", "coo", "sdxl", "sparse", "convnext", "fcnn",
                                    "mobilenet", "resnet"])
def test_decay_mask_matches_jax_leaf_by_leaf(family, synthetic_file):
    """The port's decay groups, carried leaf by leaf through ``from_jax``'s
    mapping, are JAX's ``decay_mask``, for every family; the coo stem's
    ``stem_bias`` is decayed though it is stored as ``conv0.bias``."""
    (batch,), norm = batch_and_norm(synthetic_file, family=family)
    cfg, port_cfg = family_config(family)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(JaxTransformerCVN(cfg), 1, jb,
                                 {k: jnp.asarray(v) for k, v in norm.items()}, train=False)
    want = {"/".join(["params", *(k.key for k in path)]): flag for path, flag
            in jax.tree_util.tree_leaves_with_path(jax_decay_mask(variables["params"]))}
    sources = map_jax_variables(variables, port_cfg).sources
    model = TransformerCVN(port_cfg)
    got = decay_mask(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    covered = set()
    for name, flag in got.items():
        assert sources[name], name
        for leaf in sources[name]:
            assert want[leaf] == flag, (name, leaf)
            covered.add(leaf)
    assert covered == set(want)
    if family in ("dense", "coo"):
        stem_bias = "prong_embedding.event_pixel_embedding.features.conv0.bias"
        assert got[stem_bias] is (family == "coo")
    assert not got["encoder.encoder.layers.0.self_attn.in_proj_bias"]
    assert got["encoder.encoder.layers.0.norm1.weight"]


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_clipping_matches_optax(scale):
    """Above and below 43 (and at it): ``g / ||g|| * 43`` only when
    ``||g|| >= 43``."""
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((7, 5), (13,), (2, 3, 4))]
    norm0 = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [(g * (43.0 * scale / norm0)).astype(np.float32) for g in grads]
    tx = optax.clip_by_global_norm(43.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = global_norm(ours)
    np.testing.assert_allclose(norm.numpy(), np.asarray(optax.global_norm(grads)), rtol=1e-6)
    clip_by_global_norm_(ours, 43.0, norm)
    for g, w in zip(ours, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if scale < 1.0:
        for g, raw in zip(ours, grads):
            np.testing.assert_array_equal(g.numpy(), raw)


def test_only_adamw_is_ported():
    """AdamW (and its alias) is ``torch.optim.AdamW``; the other optimizers
    are ported too, as the port's optax chains
    (``tests/test_torch_port_optimizers.py`` holds each to optax)."""
    model = torch.nn.Linear(3, 2)
    opts = Options()
    for name in ("AdamW", "apex_adam"):
        opts.optimizer = name
        assert isinstance(create_optimizer(opts, model), torch.optim.AdamW)
    for name in ("lamb", "sgd", "apex_sgd", "lion"):
        opts.optimizer = name
        assert isinstance(create_optimizer(opts, model), OptaxChain)


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------

def step_options(cls, clip, warmup_epochs):
    opts = cls()
    opts.update_options(dict(
        optimizer="AdamW", learning_rate=1e-5, l2_penalty=0.05, gradient_clip=clip,
        epochs=3, learning_rate_warmup_epochs=warmup_epochs, learning_rate_cycles=2,
        loss_gamma=1.0, event_prong_loss_proportion=0.9))
    return opts


STEPS_PER_EPOCH = 4


def start_both(family, clip, warmup_epochs, batches, norm, port_only=None, **overrides):
    """The same weights in a JAX train state and in a port train state
    (``overrides``: model config fields, on both sides; ``port_only``: on
    the port's side alone)."""
    cfg, port_cfg = family_config(family, **overrides)
    port_cfg = dataclasses.replace(port_cfg, **(port_only or {}))
    jax_model = JaxTransformerCVN(cfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    variables = random_variables(jax_model, 31, jb, jn, train=False)
    # the stems' biases at their initial zero: over sparse images a biased
    # stem output is nearly constant, and the first BatchNorm's
    # E[x^2] - E[x]^2 would cancel to a few digits
    for embedder in ("event_pixel_embedding", "prong_pixel_embedding"):
        tree = variables["params"][embedder]
        if "stem_bias" in tree:
            tree["stem_bias"] = np.zeros_like(tree["stem_bias"])
        elif "bias" in tree.get("Conv_0", {}):
            tree["Conv_0"]["bias"] = np.zeros_like(tree["Conv_0"]["bias"])
    jopts = step_options(JaxOptions, clip, warmup_epochs)
    tx = jax_create_optimizer(jopts, jax_schedules.from_options(jopts, STEPS_PER_EPOCH))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jax_state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax.jit(tx.init)(params), norm=jn, base_rng=jax.random.PRNGKey(0))
    mesh = create_mesh(1)

    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    opts = step_options(Options, clip, warmup_epochs)
    state = create_train_state(model, opts, norm, STEPS_PER_EPOCH, seed=0)
    return (jax_model, jopts, tx, mesh, jax_state), (model, opts, state), port_cfg


@pytest.mark.parametrize("family,steps,clip,warmup", [
    ("dense", 1, 0.5, 0.0),     # clipping active, lr = base at step 0
    ("coo", 1, 43.0, 0.0),
    ("dense", 3, 43.0, 0.5),    # warmup: lr 0, then base / 2, then the cosine
    ("coo", 3, 0.5, 0.5),
])
def test_train_steps_match_jax(synthetic_file, family, steps, clip, warmup):
    check_train_steps(synthetic_file, family, steps, clip, warmup)


def test_remat_train_steps_match_jax(synthetic_file):
    """With ``remat_cnn`` and ``remat_embedder`` on both sides (the JAX
    package's ``nn.remat``, the port's ``torch.utils.checkpoint``), the
    steps of the main path's family match JAX's as the plain steps do."""
    check_train_steps(synthetic_file, "dense", 3, 0.5, 0.5,
                      remat_cnn=True, remat_embedder=True)


@pytest.mark.parametrize("family", ["dense", "coo", "sparse", "convnext"])
@pytest.mark.parametrize("option", ["remat_cnn", "remat_embedder"])
def test_remat_steps_equal_plain_steps_bit_for_bit(synthetic_file, family, option):
    """Two steps with dropout and pixel noise on (and drop-path, convnext):
    with either memory option the loss, the metrics, every gradient and,
    after the steps, every parameter and BatchNorm statistic equal the plain
    steps' bit for bit.  The recompute draws the first run's dropout, and
    the running statistics move once a step, not again in the recompute.
    (convnext does not read ``remat_cnn``: there the two runs are plain.)"""
    batches, norm = batch_and_norm(synthetic_file, 2, family)

    def run(**flags):
        port_cfg = dataclasses.replace(family_config(family)[1], dropout=0.2,
                                       pixel_noise_std=0.05, **flags)
        model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(3))
        opts = step_options(Options, 0.5, 0.0)
        state = create_train_state(model, opts, norm, STEPS_PER_EPOCH, seed=0)
        step = make_train_step(model, opts)
        steps = []
        for batch in batches:
            metrics = step(state, to_device(batch, "cpu"))
            steps.append((metrics, {n: p.grad.clone() for n, p in model.named_parameters()}))
        return steps, model.state_dict()

    (plain, plain_state), (remat, remat_state) = run(), run(**{option: True})
    for (metrics, grads), (remat_metrics, remat_grads) in zip(plain, remat):
        for key, value in metrics.items():
            assert torch.equal(remat_metrics[key], value), key
        for name, grad in grads.items():
            assert torch.equal(remat_grads[name], grad), name
    for name, tensor in plain_state.items():
        assert torch.equal(remat_state[name], tensor), name


def check_train_steps(synthetic_file, family, steps, clip, warmup, port_only=None,
                      **overrides):
    """Loss, metrics, grad_norm, BatchNorm statistics and parameters after
    the steps.  Parameters: an Adam step moves an element by
    ``lr * m / (sqrt(v) + eps)``, about +-lr wherever |g| >> eps = 1e-8,
    whatever g's last digits; so where the (clipped) |g| exceeded
    1e-4 = 1e4 * eps at every step they are compared at
    ``1e-6 + 1e-2 * lr``.  Where |g| is small, float rounding decides the
    update: a bias ahead of a BatchNorm has exact gradient 0 and a float
    gradient of rounding noise, and a weight whose gradient cancels can
    differ by a factor of two between the frameworks, moving the update by a
    fraction of lr.  There only the bound ``2 * steps * lr`` is checked."""
    batches, norm = batch_and_norm(synthetic_file, steps, family)
    (jax_model, jopts, tx, mesh, jax_state), (model, opts, state), port_cfg = start_both(
        family, clip, warmup, batches, norm, port_only, **overrides)
    assert (port_cfg.remat_cnn, port_cfg.remat_embedder) == (
        jax_model.cfg.remat_cnn, jax_model.cfg.remat_embedder)
    jax_step = jax_make_train_step(jax_model, tx, jopts, mesh)
    step = make_train_step(model, opts)
    lr = opts.learning_rate
    stable = {n: torch.ones_like(p, dtype=torch.bool) for n, p in model.named_parameters()}
    for i, batch in enumerate(batches):
        jax_state, want = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(state, to_device(batch, "cpu"))
        assert state.step == i + 1 and int(jax_state.step) == i + 1
        assert set(want) == set(got)
        for key in want:
            tol = dict(rtol=1e-4) if key == "grad_norm" else LOSS_TOL
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **tol,
                                       err_msg=f"step {i}: {key}")
        if i == 0 and clip == 0.5:
            assert float(got["grad_norm"]) > clip          # clipping was active
        for n, p in model.named_parameters():
            stable[n] &= p.grad.abs() > 1e-4

    want_sd = state_dict_from_jax(jax.device_get(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}), port_cfg)
    got_sd = model.state_dict()
    for name, want_t in want_sd.items():
        if name not in stable:                              # BatchNorm statistics
            np.testing.assert_allclose(got_sd[name].numpy(), want_t.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    assert assert_adam_params_close(got_sd, want_sd, stable, lr, steps) > 1000


def assert_adam_params_close(got, want, stable, lr, steps, rounding=False):
    """The parameters of two state dicts after ``steps`` Adam steps at
    ``lr``, by :func:`check_train_steps`' rule: elements whose |g| stayed
    above 1e-4 (``stable``, by parameter name) within ``1e-6 + 1e-2 * lr``,
    the rest within ``2 * steps * lr``.  ``rounding`` replaces the 1e-6 by
    the float32 rounding of ``steps`` updates, ``steps`` spacings of the
    value, for a rate too small for 1e-6 to tell one step from none.
    Returns the stable elements' count."""
    moved = 0
    for name, ok in stable.items():
        w = want[name].numpy()
        diff, ok = np.abs(got[name].numpy() - w), ok.numpy()
        floor = steps * np.spacing(np.abs(w)) if rounding else 1e-6
        assert (diff <= floor + 1e-2 * lr)[ok].all(), (name, diff[ok].max())
        assert (diff <= 2 * steps * lr).all(), (name, diff.max())
        moved += int(ok.sum())
    return moved


def test_eval_step_matches_jax(synthetic_file):
    """The metric sufficient statistics of two eval batches, and the AUCs
    and accuracies ``finalize_metrics`` makes of them."""
    batches, norm = batch_and_norm(synthetic_file, 2)
    (jax_model, jopts, _, mesh, jax_state), (model, opts, state), _ = start_both(
        "coo", 43.0, 0.0, batches, norm)
    jax_eval = jax_make_eval_step(jax_model, jopts, mesh)
    eval_step = make_eval_step(model, opts)
    jax_totals = jax_init_metric_state(4, 8, 64)
    totals = init_metric_state(4, 8, 64)
    for batch in batches:
        jax_totals = jax_eval(jax_state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax_totals)
        totals = eval_step(state, to_device(batch, "cpu"), totals)
    jax_totals = jax.device_get(jax_totals)
    assert set(totals) == set(jax_totals)
    for key, want in jax_totals.items():
        np.testing.assert_allclose(totals[key].numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert float(totals["event_count"]) == 8 and float(totals["prong_count"]) > 8
    got, want = finalize_metrics(totals), jax_finalize_metrics(jax_totals)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-6, err_msg=key)
    assert np.isfinite(got["event_epoch_AUC"]) and np.isfinite(got["prong_epoch_AUC"])

# ---------------------------------------------------------------------------
# The compiled train step (``compile=True``) with the memory recipes:
# ``remat_cnn``, ``remat_embedder`` and ``embedder_chunk`` (with and without
# ``embedder_chunk_save_spatial``), the counterpart of the JAX package's
# ``nn.remat`` and ``nn.scan`` inside its jitted step (the module
# docstring's last part says what each case holds).  The compiled tests'
# helpers live in ``test_torch_port_compile``, which imports this module:
# they are read from it at call time (``_compiled``).
# ---------------------------------------------------------------------------

def _compiled():
    """``test_torch_port_compile``, imported when a test runs (it imports
    this module, so a module-level import would be circular)."""
    import test_torch_port_compile
    return test_torch_port_compile


REMAT_CASES = [
    ("dense", {"remat_cnn": True}, "inductor"),
    ("coo", {"remat_cnn": True}, "aot_eager"),
    ("dense", {"remat_embedder": True}, "aot_eager"),
    ("sdxl", {"embedder_chunk": 8}, "aot_eager"),
    ("sdxl", {"embedder_chunk": 8, "embedder_chunk_save_spatial": 64}, "aot_eager"),
]


def small_configs(family, **overrides):
    """``(JAX config, port config)`` of the tiny ``family`` network, cut
    to ``SMALL``."""
    cfg, port = _compiled().FAMILY_CONFIG(family, **overrides)
    return dataclasses.replace(cfg, **_compiled().SMALL), dataclasses.replace(port, **_compiled().SMALL)


@pytest.fixture
def small(monkeypatch):
    """``test_torch_port_train``'s networks cut to ``SMALL``."""
    monkeypatch.setattr(sys.modules[__name__], "family_config", small_configs)


class Recorded:
    """A Dynamo backend that keeps each graph it is given and hands it to
    ``aot_eager``."""

    def __init__(self):
        self.graphs = []

    def __call__(self, gm, example_inputs):
        from torch._dynamo.backends.debugging import aot_eager

        self.graphs.append(gm)
        return aot_eager(gm, example_inputs)


def on_backend(monkeypatch, backend):
    """``compile_step`` as it is, its ``torch.compile`` given ``backend``."""
    compile = torch.compile

    def patched(fn, **kwargs):
        kwargs["backend"] = backend
        return compile(fn, **kwargs)

    monkeypatch.setattr(torch, "compile", patched)


def graph_events():
    return counters["stats"]["unique_graphs"], sum(counters["graph_break"].values())


def train_runs(family, batches, start, opts, **kwargs):
    """``runs(reordered)`` for ``train_spreads``: eager steps from
    ``start``."""
    def runs(reordered):
        net, state = copy.deepcopy(start)
        step = make_train_step(net, opts, **kwargs)
        steps = [step(state, to_device(b, "cpu")) for b in reordered or batches]
        return steps, {n: t.numpy() for n, t in net.state_dict().items() if "running_" in n}
    return runs


def jax_float64_steps(jax_model, tx, jopts, mesh, jax_state, batches, port_cfg, monkeypatch):
    """JAX's jitted steps from ``jax_state`` over ``batches`` in float64:
    ``([metrics of each step], {running statistic name: tensor})`` in the
    port's names.  x64 on, the compute dtype float64, and ``jnp.float32``
    read as float64 while the step traces (the JAX package casts to it by
    name); the weights, the optimizer state and the batches widened."""
    def wide(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    with jax.enable_x64(True), monkeypatch.context() as patch:
        patch.setattr(jnp, "float32", jnp.float64)
        model = type(jax_model)(dataclasses.replace(jax_model.cfg, compute_dtype="float64"))
        train = jax_make_train_step(model, tx, jopts, mesh)
        state = jax.tree_util.tree_map(lambda a: jnp.asarray(wide(a)), jax_state)
        steps = []
        for batch in batches:
            state, metrics = train(state, {k: jnp.asarray(wide(v)) for k, v in batch.items()})
            steps.append(jax.device_get(metrics))
        sd = state_dict_from_jax(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}), port_cfg)
    assert steps[0]["grad_norm"].dtype == np.float64
    return steps, {n: t for n, t in sd.items() if "running_" in n}


@pytest.mark.parametrize("family,flags,backend", REMAT_CASES,
                         ids=[f"{f}-{'-'.join(x)}-{b}" for f, x, b in REMAT_CASES])
def test_compiled_remat_steps_match_eager_and_jax(synthetic_file, small, monkeypatch,
                                                  family, flags, backend):
    batches, norm = batch_and_norm(synthetic_file, 2, family)
    jax_parts, (model, opts, state), port_cfg = start_both(
        family, 43.0, 0.0, batches, norm, **flags)
    jax_model, jopts, tx, mesh, jax_state = jax_parts
    assert all(getattr(jax_model.cfg, k) == v == getattr(port_cfg, k) for k, v in flags.items())
    plain_cfg = dataclasses.replace(port_cfg, remat_cnn=False, remat_embedder=False,
                                    embedder_chunk=0, embedder_chunk_save_spatial=0)
    plain = TransformerCVN(plain_cfg)
    plain.load_state_dict(model.state_dict())
    plain_state = create_train_state(plain, opts, norm, STEPS_PER_EPOCH, seed=0)
    eager_model = copy.deepcopy(model)
    eager_state = create_train_state(eager_model, opts, norm, STEPS_PER_EPOCH, seed=0)
    start = copy.deepcopy((eager_model, eager_state))
    recorded = Recorded()
    on_backend(monkeypatch, recorded if backend == "aot_eager" else backend)
    before = graph_events()
    train = make_train_step(model, opts, compile=True)
    eager_train, plain_train = make_train_step(eager_model, opts), make_train_step(plain, opts)
    jax_train = jax_make_train_step(jax_model, tx, jopts, mesh)
    if backend == "inductor":
        orders = list(_compiled().reorderings(batches, synthetic_file, family))
        eager_spread = _compiled().train_spreads(train_runs(family, batches, start, opts), orders)

        def jax_runs(reordered):
            state = jax.tree_util.tree_map(jnp.copy, jax_state)
            steps = []
            for batch in reordered or batches:
                state, metrics = jax_train(state, {k: jnp.asarray(v) for k, v in batch.items()})
                steps.append(jax.device_get(metrics))
            sd = state_dict_from_jax(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats}), port_cfg)
            return steps, {n: t.numpy() for n, t in sd.items() if "running_" in n}

        jax_spread = _compiled().train_spreads(jax_runs, orders)
    exact = (jax_float64_steps(jax_model, tx, jopts, mesh, jax_state, batches, port_cfg,
                               monkeypatch)
             if backend == "aot_eager" and family in ("dense", "coo") else None)
    for i, batch in enumerate(batches):
        pb = to_device(batch, "cpu")
        got, eager, _ = train(state, pb), eager_train(eager_state, pb), plain_train(
            plain_state, pb)
        jax_state, want = jax_train(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        assert set(got) == set(want) == set(eager)
        grads = {n: p.grad for n, p in model.named_parameters()}
        eager_grads = {n: p.grad for n, p in eager_model.named_parameters()}
        for key in want:
            if backend == "inductor":
                _compiled().assert_within_spread(got[key], eager[key], eager_spread[0][i][key],
                                     f"step {i}: {key} against eager")
                _compiled().assert_within_spread(got[key], want[key], jax_spread[0][i][key],
                                     f"step {i}: {key} against JAX")
            else:
                assert torch.equal(got[key], eager[key]), key
                np.testing.assert_allclose(
                    got[key].numpy(), np.asarray(exact[0][i][key] if exact else want[key]),
                    **_compiled().TOL, err_msg=f"step {i}: {key} against JAX")
        if backend == "inductor":
            _compiled().grads_close(grads, eager_grads, _compiled().network_largest(eager_grads))
        else:
            for name, g in eager_grads.items():
                assert torch.equal(grads[name], g), name
    assert graph_events() == (before[0] + 1, before[1])     # one graph, no break
    got_sd, plain_sd, eager_sd = model.state_dict(), plain.state_dict(), eager_model.state_dict()
    want_sd = state_dict_from_jax(jax.device_get(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}), port_cfg)
    stats = [n for n in got_sd if "running_" in n]
    assert stats and eager_sd.keys() == got_sd.keys()
    for name in stats:
        if backend == "inductor":
            _compiled().assert_within_spread(got_sd[name], plain_sd[name], eager_spread[1][name],
                                 f"{name} against the plain steps")
            _compiled().assert_within_spread(got_sd[name], want_sd[name], jax_spread[1][name],
                                 f"{name} against JAX")
        else:
            assert torch.equal(got_sd[name], eager_sd[name]), name
            if flags.get("embedder_chunk"):     # the bank's convolutions in other sizes
                np.testing.assert_allclose(got_sd[name].numpy(), plain_sd[name].numpy(),
                                           **_compiled().TOL, err_msg=name)
            else:
                assert torch.equal(got_sd[name], plain_sd[name]), name
            np.testing.assert_allclose(got_sd[name].numpy(),
                                       (exact[1] if exact else want_sd)[name].numpy(), **_compiled().TOL,
                                       err_msg=name)
    if flags.get("embedder_chunk"):
        (gm,) = recorded.graphs
        calls = Counter(str(n.args[0].target) for n in gm.graph.nodes
                        if n.op == "call_function" and "invoke_subgraph" in str(n.target))
        chunks = -(-batch["slot_batch"].shape[0] // flags["embedder_chunk"])
        # the prong bank's chunks: calls of one region (a bank of one chunk
        # may be one call, or inlined)
        assert len(calls) <= 2 and max(calls.values()) == chunks > 1, calls


def random_ops(graph):
    return sum(1 for n in graph.graph.nodes if n.op == "call_function"
               and torch.Tag.nondeterministic_seeded in getattr(n.target, "tags", ()))


@pytest.mark.parametrize("flag", ["remat_cnn", "remat_embedder"])
def test_compiled_remat_keeps_the_first_runs_draws(synthetic_file, small, monkeypatch, flag):
    """Dropout 0.1 and pixel noise inside the compiled remat step: the
    forward graph draws, the backward graph (with its recompute) draws
    nothing, and two steps equal the eager steps bit for bit."""
    batches, norm = batch_and_norm(synthetic_file, 2, "dense")
    _, port_cfg = small_configs("dense")
    port_cfg = dataclasses.replace(port_cfg, dropout=0.1, pixel_noise_std=0.02, **{flag: True})
    opts = step_options(Options, 0.5, 0.0)
    model = TransformerCVN(port_cfg, generator=torch.Generator().manual_seed(3))
    eager_model = copy.deepcopy(model)
    state, eager_state = (create_train_state(m, opts, norm, STEPS_PER_EPOCH, seed=5)
                          for m in (model, eager_model))
    graphs = {"forward": [], "backward": []}

    def keep(kind):
        def compiler(gm, example_inputs):
            graphs[kind].append(gm)
            return gm.forward
        return compiler

    on_backend(monkeypatch, aot_autograd(fw_compiler=keep("forward"),
                                         bw_compiler=keep("backward")))
    train, eager_train = make_train_step(model, opts, compile=True), make_train_step(
        eager_model, opts)
    for batch in batches:
        got, want = train(state, to_device(batch, "cpu")), eager_train(
            eager_state, to_device(batch, "cpu"))
        for key, value in want.items():
            assert torch.equal(got[key], value), key
    for name, tensor in eager_model.state_dict().items():
        assert torch.equal(model.state_dict()[name], tensor), name
    (forward,), (backward,) = graphs["forward"], graphs["backward"]
    assert random_ops(forward) > 0 and random_ops(backward) == 0


def test_eager_remat_rewinds_and_equals_keeping_the_draws(monkeypatch):
    """An eager remat of a body with a BatchNorm and dropout 0.5 takes no
    selective-checkpoint mode; inside ``keep_draws`` it takes one, and its
    output, input gradient, weight gradients and running statistics equal
    the eager remat's bit for bit."""
    from torch import nn

    from dune_transformercvn_torch.ops import masked

    taken = []
    contexts = masked.create_selective_checkpoint_contexts

    def counted(*args, **kwargs):
        taken.append(1)
        return contexts(*args, **kwargs)

    monkeypatch.setattr(masked, "create_selective_checkpoint_contexts", counted)

    class Body(nn.Module):
        def __init__(self):
            super().__init__()
            self.linear = nn.Linear(6, 6)
            self.norm = masked.MaskedBatchNorm(6)
            self.dropout = masked.Dropout(0.5)

        def forward(self, x):
            return self.dropout(torch.tanh(self.norm(self.linear(x)))).sum(-1)

    start = Body().train()
    x0 = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    runs = []
    for keep in (False, True):
        body, x = copy.deepcopy(start), x0.clone().requires_grad_(True)
        torch.manual_seed(11)
        with masked.keep_draws() if keep else contextlib.nullcontext():
            out = masked.remat(body, x)
            out.sum().backward()
        assert len(taken) == int(keep)
        runs.append([out, x.grad, *(p.grad for p in body.parameters()),
                     body.norm.running_mean, body.norm.running_var])
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    assert not torch.equal(runs[0][-2], start.norm.running_mean)


def test_compile_step_sets_the_checkpoint_flag_only_in_its_calls(monkeypatch):
    """Dynamo's ``skip_fwd_side_effects_in_bwd_under_checkpoint`` holds
    inside a compiled step's call and is back to its setting after."""
    from dune_transformercvn_torch.utils.compile import compile_step

    config = torch._dynamo.config
    seen = []

    def traced(fn, **kwargs):
        def call(*args):
            seen.append(config.skip_fwd_side_effects_in_bwd_under_checkpoint)
            return fn(*args)
        return call

    monkeypatch.setattr(torch, "compile", traced)
    before = config.skip_fwd_side_effects_in_bwd_under_checkpoint
    step = compile_step(lambda x: x + 1)
    assert not before and config.skip_fwd_side_effects_in_bwd_under_checkpoint is before
    assert torch.equal(step(torch.ones(2)), torch.full((2,), 2.0))
    assert seen == [True] and config.skip_fwd_side_effects_in_bwd_under_checkpoint is before
