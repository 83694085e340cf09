"""The port's compiled steps (``compile=True``: ``torch.compile`` with
Inductor, the counterpart of the JAX package's ``jax.jit``) and the custom
ops that keep kernels K1 and K2 inside the compiled graphs.

* ``torch.library.opcheck`` on ``tcvn::densify``, ``tcvn::coo_stem_scatter``
  (its registered gradient too) and ``tcvn::coo_stem_bin``, on the CPU
  (their plain versions; ``tests/test_torch_port_cuda.py`` runs the same on
  the card, where the kernels launch).
* The dense family's predict, eval and train steps compiled against the
  same steps run eagerly and against the JAX package's jitted steps, on the
  same seeded batches (``synthetic_file`` at 48x40, 4 events, fixed shape)
  with transplanted weights; tiny widths (DenseNet [1], one encoder layer,
  one prong-decoder layer), float32, dropout 0, pixel noise 0.
  ``tests/test_torch_port_coo.py`` runs the coo family's.
* Compiled against eager, and compiled against JAX: probabilities and the
  metric statistics (each score histogram's cumulative counts within 2: a
  probability within rounding of one of the 64 bin edges may cross it)
  within ``rtol=1e-4, atol=1e-5`` (Inductor fuses and reorders float32
  sums; the eager port holds JAX to 1e-5, ``tests/test_torch_port_train.py``;
  an eval-mode forward sums nothing across events); the train steps'
  losses, ``grad_norm`` and the BatchNorm running statistics within that
  plus twice the reference's own spread under a reordering of the batch's
  events (:func:`assert_within_spread`, :func:`train_spreads`); parameters
  after the Adam steps by ``test_torch_port_train``'s rule.  Every gradient against eager's within
  1e-3 of its tensor's largest element plus 1e-3 of the network's largest
  gradient: the BatchNorms' E[x^2] - E[x]^2 over a batch of 4 turn
  reordered sums into gradient differences of ~1e-4 of a tensor's largest
  (6.7e-4 at most, measured); the BatchNorm right after the coo stem,
  whose sparse output is nearly constant, 6e-3 of its largest, 2.5e-4 of
  the network's; a bias ahead of a BatchNorm has exact gradient 0 and a
  float one of rounding noise, ~4e-5 of the network's largest.
* A prong-capacity ladder of two rungs compiles one graph a rung, and a
  shape that comes again compiles nothing; ``Batcher.shape_bound`` covers
  every shape a shuffled batcher lays out, and a shape past the recompile
  limit ``compile_step`` sets raises.
* A compiled predict step made outside an int8 context raises inside one
  (int8 steps compile: ``tests/test_torch_port_quant.py``; remat steps:
  the end of ``tests/test_torch_port_train.py``).

Inductor compiles its C++ with one worker here
(``compile_threads = 1``), beside the test workers.
"""

import copy
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.train.metrics import init_metric_state as jax_init_metric_state
from dune_transformercvn_tpu.train.step import make_eval_step as jax_make_eval_step
from dune_transformercvn_tpu.train.step import make_predict_step as jax_make_predict_step
from dune_transformercvn_tpu.train.step import make_train_step as jax_make_train_step
from dune_transformercvn_torch import Options
from dune_transformercvn_torch.data import Batcher, InMemoryEvents
from dune_transformercvn_torch.from_jax import state_dict_from_jax
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.ops import coo_stem, densify, quant
from dune_transformercvn_torch.parallel import Mesh
from dune_transformercvn_torch.predict import make_predict_step, predict_split, to_device
from dune_transformercvn_torch.train import (create_train_state, init_metric_state,
                                             make_eval_step, make_train_step)
import test_torch_port_train
from test_torch_port_train import (STEPS_PER_EPOCH, assert_adam_params_close,
                                   batch_and_norm, step_options)

torch.set_num_threads(2)
torch._inductor.config.compile_threads = 1

TOL = dict(rtol=1e-4, atol=1e-5)
ORDER_MULTIPLE = 2
GRAD_SHARE, GRAD_FLOOR = 1e-3, 1e-3
HISTOGRAM_SLACK = 2
# the tiny network the compiled tests share (each graph compiles once a run)
SMALL = dict(densenet_structure=(1,), num_encoder_layers=1, num_prong_decoder_layers=1)
FAMILY_CONFIG = test_torch_port_train.family_config


def small_configs(family):
    """``(JAX config, port config)`` of the tiny ``family`` network, cut to
    ``SMALL``."""
    cfg, port = FAMILY_CONFIG(family)
    return dataclasses.replace(cfg, **SMALL), dataclasses.replace(port, **SMALL)


def start_small(family, batches, norm, monkeypatch):
    """``test_torch_port_train.start_both`` on the ``SMALL`` network."""
    monkeypatch.setattr(test_torch_port_train, "family_config", small_configs)
    return test_torch_port_train.start_both(family, 43.0, 0.0, batches, norm)


def compile_count():
    return torch._dynamo.utils.counters["stats"]["unique_graphs"]


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------

def op_inputs(seed=0, n=3, height=16, width=12, hits=64):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(-1, height + 1, hits), rng.integers(-1, width + 1, hits)], 1)
    owner = np.sort(rng.integers(0, n + 1, hits))        # owner n: padding rows
    starts = np.searchsorted(owner, np.arange(n + 1))
    return (torch.from_numpy(xy.astype(np.int32)), torch.from_numpy(owner.astype(np.int32)),
            torch.from_numpy(starts.astype(np.int32)), n, height, width)


@pytest.mark.parametrize("case", ["densify", "densify_s2d", "scatter_f32", "scatter_bf16",
                                  "bin"])
def test_custom_ops_pass_opcheck(case):
    """Schema, fake (the shapes ``region_shape`` / ``out_shape`` /
    ``tile_plan`` give), autograd registration and AOT dispatch of each op,
    with inputs carrying padding rows and coordinates off the grid."""
    xy, owner, starts, n, h, w = op_inputs()
    gen = torch.Generator().manual_seed(1)
    if case.startswith("densify"):
        values = torch.rand(xy.shape[0], 3, generator=gen)
        op, args = densify.densify_op, (xy, values, owner, starts, n, h, w,
                                        case.endswith("s2d"))
    elif case.startswith("scatter"):
        patches = torch.randn(xy.shape[0], 4, 4, 8, generator=gen).requires_grad_()
        bias = torch.randn(8, generator=gen).requires_grad_()
        dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
        op, args = coo_stem.scatter_patches, (patches, bias, xy, starts, n, h, w, dtype)
    else:
        op, args = coo_stem.bin_hits, (xy, starts, n, h, w, 8)
    results = torch.library.opcheck(op, args)
    assert set(results.values()) == {"SUCCESS"}, results


def test_the_ops_are_the_eager_path():
    """Eager callers reach the plain versions through the ops, bit for bit,
    and the registered gradient is the gather the JAX package's VJP
    computes (the plain scatter's autograd)."""
    xy, owner, starts, n, h, w = op_inputs(2)
    values = torch.rand(xy.shape[0], 3, generator=torch.Generator().manual_seed(3))
    from dune_transformercvn_torch.ops.scatter import densify_images

    assert torch.equal(densify_images(xy, values, owner, n, h, w, starts=starts),
                       densify.densify_images_plain(xy, values, owner, n, h, w))
    patches = torch.randn(xy.shape[0], 4, 4, 8, generator=torch.Generator().manual_seed(4))
    bias = torch.randn(8, generator=torch.Generator().manual_seed(5))
    cot = torch.randn(n, *coo_stem.out_shape(h, w), 8,
                      generator=torch.Generator().manual_seed(6))
    grads = []
    for fn in (coo_stem.scatter_patches, lambda p, b, *a: coo_stem.scatter_patches_plain(
            p, a[0], a[1], b, *a[2:])):
        p, b = patches.clone().requires_grad_(), bias.clone().requires_grad_()
        out = fn(p, b, xy, starts, n, h, w, torch.float32)
        (out * cot).sum().backward()
        grads.append((out.detach(), p.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# compiled steps against eager and against JAX
# ---------------------------------------------------------------------------

def grads_close(got, want, largest):
    """Two gradient dicts: each tensor within ``GRAD_SHARE`` of its largest
    element plus ``GRAD_FLOOR`` of ``largest``, the network's largest."""
    assert got.keys() == want.keys()
    for name, g in want.items():
        bound = GRAD_SHARE * float(g.abs().max()) + GRAD_FLOOR * largest
        diff = float((got[name] - g).abs().max())
        assert diff <= bound, (name, diff, bound)


def totals_close(got, want):
    """Metric sufficient statistics: sums and counts within ``TOL``; each
    score histogram's per-class totals equal, and its cumulative counts
    within ``HISTOGRAM_SLACK`` (a probability within rounding of a bin edge
    may land in the next bin)."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        if key.endswith(("_pos", "_neg")):
            np.testing.assert_array_equal(g.sum(-1), w.sum(-1), err_msg=key)
            slack = np.abs(np.cumsum(g, -1) - np.cumsum(w, -1)).max()
            assert slack <= HISTOGRAM_SLACK, (key, slack)
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=key)


def network_largest(grads):
    return max(float(g.abs().max()) for g in grads.values())


def assert_within_spread(got, want, spread, msg=""):
    """``|got - want| <= atol + rtol * |want| + ORDER_MULTIPLE * spread``
    (``TOL``'s ``atol`` and ``rtol``), elementwise; ``spread``: the
    reference's own largest change when only the order of each batch's
    events changes.

    A train step's BatchNorms take ``E[x^2] - E[x]^2`` over a batch of 4
    in float32; where a channel's mean is large against its spread that
    subtraction cancels most digits, so the order of the sums alone moves
    the normalised values, the loss, the gradient and its norm.  Inductor
    sums in its own order, which also depends on the host's vector width
    (AVX-512 and AVX2 differ; Inductor's ``cpp.simdlen`` at 256 bits
    moves a compiled result back inside ``TOL``).  The compiled order is
    one more order: its distance from the reference is at most its own
    distance from some order's float32 result plus the reference's, each
    at most one spread, hence ``ORDER_MULTIPLE`` = 2 (as
    ``test_torch_port_network.test_network_train_mode_matches_jax``);
    ``TOL`` stays for what is not order (fused multiply-adds, another
    ``exp``)."""
    got, want, spread = (np.asarray(x, np.float64) for x in (got, want, spread))
    diff = np.abs(got - want)
    bound = TOL["atol"] + TOL["rtol"] * np.abs(want) + ORDER_MULTIPLE * spread
    assert (diff <= bound).all(), (msg, float(diff.max()),
                                   float(bound.reshape(-1)[np.argmax(diff - bound)]))


def reorderings(batches, synthetic_file, family):
    """For each of the other 23 orders of 4 events, ``batches`` (those of
    ``batch_and_norm``) with each batch's events taken in that order."""
    from test_torch_port_train import batcher_of

    batcher = batcher_of(synthetic_file, family)
    chunks = batcher.epoch_indices(0)[:4 * len(batches)].reshape(len(batches), 4)
    for chunk, batch in zip(chunks, batches):
        same = batcher.build_batch(chunk)
        assert all(np.array_equal(same[k], v) for k, v in batch.items())
    for perm in itertools.permutations(range(4)):
        if perm != (0, 1, 2, 3):
            yield [batcher.build_batch(chunk[list(perm)]) for chunk in chunks]


def train_spreads(runs, reordered):
    """The largest change of each train step's metrics and of the final
    running statistics over ``reordered`` (:func:`reorderings`):
    ``runs(batches) -> ([metrics of each step], {running statistic name:
    array})`` runs the steps from the same start."""
    want_steps, want_stats = runs(None)
    steps = [dict.fromkeys(m, 0.0) for m in want_steps]
    stats = {n: np.zeros_like(v) for n, v in want_stats.items()}
    for batches in reordered:
        got_steps, got_stats = runs(batches)
        for got, want, largest in zip(got_steps, want_steps, steps):
            for key in largest:
                largest[key] = max(largest[key], abs(float(got[key]) - float(want[key])))
        for name, largest in stats.items():
            np.maximum(largest, np.abs(got_stats[name] - want_stats[name]), out=largest)
    return steps, stats


def check_compiled_steps(synthetic_file, family, monkeypatch):
    """Predict, eval and two train steps of ``family``: compiled against
    eager and against JAX."""
    batches, norm = batch_and_norm(synthetic_file, 2, family)
    jax_parts, (model, opts, state), port_cfg = start_small(family, batches, norm,
                                                            monkeypatch)
    jax_model, jopts, tx, mesh, jax_state = jax_parts
    jax_batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    port_batches = [to_device(b, "cpu") for b in batches]
    eager_model = copy.deepcopy(model)
    eager_state = create_train_state(eager_model, opts, norm, STEPS_PER_EPOCH, seed=0)

    # predict: the softmax of the eval-mode forward
    before = compile_count()
    got = make_predict_step(model, compile=True)(port_batches[0], state.norm)
    eager = make_predict_step(eager_model)(port_batches[0], eager_state.norm)
    want = jax_make_predict_step(jax_model, mesh)(jax_state, jax_batches[0])
    for g, e, w in zip(got, eager, want):
        torch.testing.assert_close(g, e, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert compile_count() == before + 1

    # eval: the metric statistics of both batches, added in place
    totals = init_metric_state(4, 8, 64)
    eager_totals = init_metric_state(4, 8, 64)
    jax_totals = jax_init_metric_state(4, 8, 64)
    step, eager_step = make_eval_step(model, opts, compile=True), make_eval_step(model, opts)
    jax_eval = jax_make_eval_step(jax_model, jopts, mesh)
    for pb, jb in zip(port_batches, jax_batches):
        step(state, pb, totals)
        eager_step(eager_state, pb, eager_totals)
        jax_totals = jax_eval(jax_state, jb, jax_totals)
    totals_close(totals, eager_totals)
    totals_close(totals, jax.device_get(jax_totals))
    assert float(totals["event_count"]) == 8

    # two train steps: metrics, gradients, running statistics, parameters,
    # the first three against each reference's spread over the reorderings
    train = make_train_step(model, opts, compile=True)
    eager_train = make_train_step(eager_model, opts)
    jax_train = jax_make_train_step(jax_model, tx, jopts, mesh)
    start = copy.deepcopy((eager_model, eager_state))

    def jax_runs(reordered):
        state = jax.tree_util.tree_map(jnp.copy, jax_state)
        steps = []
        for batch in reordered or batches:
            state, metrics = jax_train(state, {k: jnp.asarray(v) for k, v in batch.items()})
            steps.append(jax.device_get(metrics))
        sd = state_dict_from_jax(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}), port_cfg)
        return steps, {n: t.numpy() for n, t in sd.items() if "running_" in n}

    def eager_runs(reordered):
        net, state = copy.deepcopy(start)
        step = make_train_step(net, opts)
        steps = [step(state, to_device(b, "cpu")) for b in reordered or batches]
        return steps, {n: t.numpy() for n, t in net.state_dict().items() if "running_" in n}

    orders = list(reorderings(batches, synthetic_file, family))
    jax_spread, eager_spread = train_spreads(jax_runs, orders), train_spreads(eager_runs, orders)
    stable = {n: torch.ones_like(p, dtype=torch.bool) for n, p in model.named_parameters()}
    for i, (pb, jb) in enumerate(zip(port_batches, jax_batches)):
        got, eager = train(state, pb), eager_train(eager_state, pb)
        jax_state, want = jax_train(jax_state, jb)
        assert set(got) == set(want) == set(eager)
        for key in want:
            assert_within_spread(got[key], eager[key], eager_spread[0][i][key],
                                 f"step {i}: {key} against eager")
            assert_within_spread(got[key], want[key], jax_spread[0][i][key],
                                 f"step {i}: {key} against JAX")
        grads = {n: p.grad for n, p in model.named_parameters()}
        eager_grads = {n: p.grad for n, p in eager_model.named_parameters()}
        grads_close(grads, eager_grads, network_largest(eager_grads))
        for n, g in grads.items():
            stable[n] &= g.abs() > 1e-4
    assert compile_count() == before + 3           # predict, eval, train: once each
    got_sd, eager_sd = model.state_dict(), eager_model.state_dict()
    want_sd = state_dict_from_jax(jax.device_get(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}), port_cfg)
    stats = [n for n in got_sd if "running_" in n]
    assert stats and set(stats) == set(jax_spread[1]) == set(eager_spread[1])
    assert jax_spread[0][0]["grad_norm"] > 0 and eager_spread[0][0]["grad_norm"] > 0
    for name in stats:
        assert_within_spread(got_sd[name], eager_sd[name], eager_spread[1][name],
                             f"{name} against eager")
        assert_within_spread(got_sd[name], want_sd[name], jax_spread[1][name],
                             f"{name} against JAX")
    assert assert_adam_params_close(got_sd, want_sd, stable, opts.learning_rate, 2) > 100
    assert assert_adam_params_close(got_sd, eager_sd, stable, opts.learning_rate, 2) > 100


def test_compiled_dense_steps_match_eager_and_jax(synthetic_file, monkeypatch):
    """Measured on an AVX-512 host (8 cores): step 0's ``grad_norm``
    (12.75) compiled 1.43e-3 from JAX against JAX's spread of 8.80e-4 over
    the 23 reorderings (bound 3.04e-3; ``TOL`` alone allowed 1.29e-3), and
    1.25e-3 from eager against eager's spread of 8.77e-4; with Inductor's
    ``cpp.simdlen`` at 256 bits the compiled step falls inside ``TOL``."""
    check_compiled_steps(synthetic_file, "dense", monkeypatch)


def test_repeated_shapes_do_not_recompile():
    """``predict_split(compile=True)`` over a ladder of two prong-capacity
    rungs: one graph for each rung it meets, the probabilities of eager
    ``predict_split``, and a second pass over the same shapes compiles
    nothing."""
    cfg = dataclasses.replace(small_configs("dense")[1], disable_smart_features=True)
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0))
    ds = InMemoryEvents(24, 6, (cfg.image_height, cfg.image_width))
    kwargs = dict(coo_granularity=4096, prong_bucket_multipliers=[4])
    shapes = {tuple(b[k].shape[0] for k in ("slot_batch", "event_xy", "prong_xy"))
              for b in Batcher(ds, batch_size=4, drop_last=False, **kwargs).epoch(0)}
    # both rungs (4 x 4 and 21 x 4 prong slots), one hit bucket each
    assert sorted(s[0] for s in shapes) == [16, 84], shapes
    eager = predict_split(model, ds, ds.norm(), 4, "cpu", **kwargs)
    before = compile_count()
    got = predict_split(model, ds, ds.norm(), 4, "cpu", compile=True, **kwargs)
    assert compile_count() == before + 2
    for key, value in eager.items():
        np.testing.assert_allclose(got[key], value, **TOL, err_msg=key)
    predict_split(model, ds, ds.norm(), 4, "cpu", compile=True, **kwargs)
    assert compile_count() == before + 2


def test_shape_bound_covers_every_batch_shape():
    """``Batcher.shape_bound`` counts the rungs up to the fullest batch's
    and the hit buckets up to the fullest batch's: the shapes of shuffled
    epochs are among them, and ``fixed_shape`` lays out one."""
    ds = InMemoryEvents(64, 9, (48, 40))
    kwargs = dict(coo_granularity=512, prong_bucket_multipliers=[4, 8])
    batcher = Batcher(ds, batch_size=4, shuffle=True, drop_last=False, **kwargs)
    caps = batcher._bounding_caps()
    ladder = batcher.capacity_ladder[:batcher.capacity_ladder.index(caps.prong_slots) + 1]
    bound = {(slots, ev, pr) for slots in ladder
             for ev in range(512, caps.event_hits + 1, 512)
             for pr in range(512, caps.prong_hits + 1, 512)}
    met = {tuple(b[k].shape[0] for k in ("slot_batch", "event_xy", "prong_xy"))
           for epoch in range(4) for b in batcher.epoch(epoch)}
    assert batcher.shape_bound() == len(bound) > len(met) > 1, (len(bound), met)
    assert met <= bound, met - bound
    assert Batcher(ds, batch_size=4, fixed_shape=True, **kwargs).shape_bound() == 1


def test_a_shape_past_the_recompile_limit_raises(monkeypatch):
    """``compile_step`` raises Dynamo's recompile limit by the shapes it is
    given; a shape past it raises instead of running eagerly."""
    from dune_transformercvn_torch.utils.compile import compile_step

    monkeypatch.setattr(torch._dynamo.config, "recompile_limit", 0)
    monkeypatch.setattr(torch._dynamo.config, "fail_on_recompile_limit_hit", False)

    def double(x):
        return x * 2 + 1

    step = compile_step(double, shapes=2)
    assert torch._dynamo.config.fail_on_recompile_limit_hit
    for n in (3, 5, 3):
        torch.testing.assert_close(step(torch.ones(n)), torch.full((n,), 3.0))
    with pytest.raises(torch._dynamo.exc.FailOnRecompileLimitHit):
        step(torch.ones(7))


def test_compile_refuses_what_it_does_not_take():
    """A tensor-parallel step is made (it compiles,
    ``tests/test_torch_port_tp.py``), and so are remat steps
    (``tests/test_torch_port_train.py``) and int8 steps
    (``tests/test_torch_port_quant.py``); a compiled predict step made
    outside an int8 context raises inside one, before it compiles: its
    graph would be traced with float convolutions.  Nothing compiles."""
    cfg = small_configs("dense")[1]
    model = TransformerCVN(cfg, generator=torch.Generator().manual_seed(0))
    opts = step_options(Options, 43.0, 0.0)
    tp = Mesh(dp=1, mp=2, rank=0)
    make_train_step(model, opts, tp, compile=True)
    before = compile_count()
    step = make_predict_step(model, compile=True)
    with quant.quantized_convs(model, {}, device="cpu"), \
            pytest.raises(RuntimeError, match="int8"):
        step({}, {})
    assert compile_count() == before

