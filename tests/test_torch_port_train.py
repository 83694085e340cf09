"""The port's training pieces against the JAX package: losses, schedules,
the decay rule, global-norm clipping, one and three train steps of the
dense and the coo family, and the eval step with its metrics.

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
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from dune_transformercvn_torch.train.optimizer import clip_by_global_norm_, global_norm
from test_torch_port_coo import Scaled, tiny_coo_config  # same-dir test helpers
from test_torch_port_network import random_variables

torch.set_num_threads(1)

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


def batch_and_norm(synthetic_file, count=1):
    ds = EventDataset(synthetic_file, limit_index=(0.0, 0.3), event_current_targets=True)
    ds.compute_statistics()
    norm = {"mean": ds.mean, "std": ds.std,
            "extra_mean": ds.extra_mean, "extra_std": ds.extra_std}
    batcher = Batcher(Scaled(ds), batch_size=4, coo_granularity=512, fixed_shape=True)
    batches = [b for _, b in zip(range(count), batcher.epoch(0))]
    return batches, norm


def family_config(family):
    cfg, port_cfg = tiny_coo_config(disable_smart_features=False)
    if family == "dense":
        cfg = dataclasses.replace(cfg, embedder="dense")
        port_cfg = dataclasses.replace(port_cfg, embedder="dense")
    return cfg, port_cfg


@pytest.mark.parametrize("family", ["dense", "coo"])
def test_decay_mask_matches_jax_leaf_by_leaf(family, synthetic_file):
    """The port's decay groups, carried leaf by leaf through ``from_jax``'s
    mapping, are JAX's ``decay_mask``; the coo stem's ``stem_bias`` is
    decayed though it is stored as ``conv0.bias``."""
    (batch,), norm = batch_and_norm(synthetic_file)
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
    model = torch.nn.Linear(3, 2)
    opts = Options()
    for name in ("AdamW", "apex_adam"):
        opts.optimizer = name
        assert isinstance(create_optimizer(opts, model), torch.optim.AdamW)
    for name in ("lamb", "sgd", "apex_sgd", "lion"):
        opts.optimizer = name
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            create_optimizer(opts, model)


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


def start_both(family, clip, warmup_epochs, batches, norm):
    """The same weights in a JAX train state and in a port train state."""
    cfg, port_cfg = family_config(family)
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
        else:
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
    batches, norm = batch_and_norm(synthetic_file, steps)
    (jax_model, jopts, tx, mesh, jax_state), (model, opts, state), port_cfg = start_both(
        family, clip, warmup, batches, norm)
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
    params = dict(model.named_parameters())
    moved = 0
    for name, want_t in want_sd.items():
        got_t, w = got_sd[name], want_t.numpy()
        if name not in params:                              # BatchNorm statistics
            np.testing.assert_allclose(got_t.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)
            continue
        diff = np.abs(got_t.numpy() - w)
        ok = stable[name].numpy()
        assert (diff[ok] <= 1e-6 + 1e-2 * lr).all(), (name, diff[ok].max())
        assert (diff <= 2 * steps * lr).all(), (name, diff.max())
        moved += int(ok.sum())
    assert moved > 1000


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
