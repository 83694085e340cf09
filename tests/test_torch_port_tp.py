"""The port's tensor parallelism (``parallel/mesh.py``'s hybrid mesh) against
the JAX package's (``dune_transformercvn_tpu/parallel/mesh.py``), on the CPU.

The port's ``Trainer`` runs as 4 ranks of a ``gloo`` group at dp2 x mp2
(``tests/_torch_tp_worker.py``, a file rendezvous), beside the port's dp2
Trainer as 2 ranks and the JAX ``Trainer`` at ``num_gpu=4,
model_parallel=2`` over 4 of this process's virtual devices, all from the
JAX Trainer's initial weights, on the tiny options of
``test_torch_port_loop.py`` with 2 attention heads (a head of 16, so the
packed q/k/v projection shards too), float32, dropout 0, pixel noise 0.

* The state is channel-sharded: the set of parameters held as ``DTensor``
  pieces is what JAX's ``state_shardings`` shards on the same weights,
  through ``from_jax``'s names, plus the norm2 / relu2 tensors between each
  bottleneck's column- and row-parallel convolutions (their running
  statistics too); each piece lies along the dimension its layer computes
  with (input channels of conv2, ``linear2`` and ``out_proj``, whole heads
  of each of q, k and v in the packed ``in_proj``, else the port's
  dimension of JAX's last axis), it and its AdamW moments 1/mp of the
  whole; the rule also matches JAX's on every embedder family's tiny
  network.
* The compute is partitioned: in one train-mode forward each rank's
  bottlenecks run conv1 to ``expand / mp`` channels, norm2 and relu2 on
  them and conv2 from them, each attention ``heads / mp`` heads, each
  feed-forward ``linear1`` to ``hidden / mp``; each of those layers sums
  over its TP row once.  Every family's network at dp1 x mp2 equals it run
  whole (logits, gradients, running statistics).
* 3 explicit steps on the same global batches equal the port's dp2 Trainer
  (loss ``rtol=2e-5``, grad_norm ``rtol=2e-4``, parameters and BatchNorm
  statistics ``atol=3e-4``: JAX's bounds between its hybrid and dp
  Trainers, at JAX's rate of 1e-4; and the parameters by
  ``test_torch_port_train.assert_adam_params_close``, whose elements with a
  gradient above 1e-4 at every step agree within ``1e-6 + 1e-2 * lr``) and
  the JAX hybrid Trainer (losses and grad norms at the
  DDP-parity test's ``rtol=1e-4, atol=1e-5``, parameters by
  ``assert_adam_params_close``, statistics within JAX's 3e-4: the port's
  dp2 Trainer is as far from JAX's as the TP one, 1.4e-5 on this run); the
  four ranks' whole states are equal bit for bit.
* With dropout and pixel noise on, the same 3 steps still equal dp2's:
  the ranks of a TP row draw their data shard's masks.
* ``validate`` and ``predict_split`` on the starting weights agree with dp2
  (``atol=1e-5``, as JAX's hybrid test holds its predictions) and JAX.
* Each optimizer, ``global_norm`` and the lamb trust ratio give on pieces
  what they give on whole tensors.
* ``fit`` writes checkpoints of whole tensors; a fresh TP Trainer resumed at
  step 2 ends equal to the uninterrupted one bit for bit, and the checkpoint
  loads into a one-process Trainer, whose validation agrees.
* ``steps_per_dispatch`` 2 equals single steps; an mp above the world
  clamps, mp 3 on 4 ranks raises; the pure rules (``mesh_shape``,
  ``channel_sharded``, ``tp_rows_process_local``) match JAX's.

The compiled tensor-parallel step: two ``gloo`` ranks at dp1 x mp2
(``tests/_torch_dp_worker.py``, mode ``compiled``) each fit an eager and a
compiled ``Trainer`` (``compile=True``, ``model_parallel=2``) at
``test_torch_port_loop.SMALL``'s width with 2 attention heads (a head of
16, so the packed q/k/v is sharded too).  The partitioned layers'
collectives (the row's sums forward and backward, the gathers of the
other sharded weights) are traced into the compiled graphs.  Each rank's
compiled steps against its eager steps (dropout 0, noise 0): metrics,
running statistics and the validation loss within
``tests/test_torch_port_compile.py``'s ``TOL`` plus twice the eager fit's
own spread over the other 23 orders of the batch's 4 events
(``assert_within_spread``).  Measured on an AVX-512 host (8 cores): the
validation loss 1.87e-4 from eager (1.07e-4 of it, past ``TOL``'s 1e-4
alone) against a spread of 2.93e-4, a bound of 7.7e-4; with Inductor's
``cpp.simdlen`` at 256 bits the compiled loss falls inside ``TOL``, so the
gap is the order of the float32 sums.  Gradients (whole) by its
``grads_close`` rule, parameters by ``test_torch_port_train``'s Adam rule;
the ranks' whole compiled states equal bit for bit
(``test_torch_port_ddp_parity.check_compiled_ranks``).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.parallel import mesh as jax_mesh
from dune_transformercvn_tpu.train import Trainer as JaxTrainer
from dune_transformercvn_torch import Options, parallel
from dune_transformercvn_torch.from_jax import (jax_channel_axes, map_jax_variables,
                                                state_dict_from_jax)
from dune_transformercvn_torch.models import ModelConfig, TransformerCVN
from dune_transformercvn_torch.train import Trainer
from _torch_families import FAMILIES, batches_and_norm, family_configs  # same-dir helpers
from test_torch_port_ddp_parity import check_compiled_ranks
from test_torch_port_loop import SMALL, TINY, small_synthetic_file, tiny_options
from test_torch_port_parallel import communicate_all
from test_torch_port_train import assert_adam_params_close

WORKER = Path(__file__).with_name("_torch_tp_worker.py")
TOL = dict(rtol=1e-4, atol=1e-5)
# JAX's tensor-parallel test trains at the options' default rate, 1e-4
OVERRIDES = dict(num_attention_heads=2, num_gpu=4, model_parallel=2, learning_rate=1e-4)
STEPS = 3


def start(mode, setup, directory, world_size):
    outputs = [directory / f"{mode}_rank{r}.pt" for r in range(world_size)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(directory / f"{mode}_rendezvous"),
         str(world_size), str(r), str(setup), str(outputs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"}) for r in range(world_size)]
    return procs, outputs


def finish(started, timeout=400):
    procs, outputs = started
    try:
        logs = communicate_all(procs, timeout)
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outputs]


def port_config(theirs):
    return ModelConfig(**{f.name: getattr(theirs.model_config, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def jax_state_dict(state, cfg):
    return state_dict_from_jax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}), cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    options = dict(TINY, training_file=small_synthetic_file(root / "train.h5", 64, 7),
                   **OVERRIDES)
    theirs = JaxTrainer(tiny_options(JaxOptions, **options), debug=True)
    variables = jax.device_get({"params": theirs.state.params,
                                "batch_stats": theirs.state.batch_stats})
    rng = np.random.default_rng(3)
    steps = [rng.choice(len(theirs.training_dataset), theirs.global_batch, replace=False)
             for _ in range(STEPS)]
    torch.save(dict(options=options, variables=variables, steps=steps, work=str(root)),
               root / "setup.pt")
    tp_ranks = start("tp", root / "setup.pt", root, 4)
    dp_ranks = start("dp", root / "setup.pt", root, 2)

    jax_run = dict(validation=theirs.validate(), predictions=theirs.predict_split("validation"))
    state = theirs.state
    jax_metrics = []
    for idx in steps:
        state, m = theirs.train_step(state, theirs._device_batch(
            theirs.train_batcher.build_batch(idx)))
        jax_metrics.append((float(m["train_loss"]), float(m["grad_norm"])))
    jax_run.update(metrics=jax_metrics, state=jax_state_dict(state, port_config(theirs)))
    return dict(theirs=theirs, variables=variables, jax=jax_run, root=root,
                tp=finish(tp_ranks), dp=finish(dp_ranks))


def test_mesh_and_batch_layout(runs):
    theirs, ranks = runs["theirs"], runs["tp"]
    assert theirs.num_shards == 2 and theirs.global_batch == 8
    for r, out in enumerate(ranks):
        assert out["mesh"] == (2, 2, r // 2, r % 2)
        assert out["shards"] == [r // 2]
        assert (out["num_shards"], out["global_batch"]) == (2, 8)
    assert ranks[0]["clamped"] == (4, 1)
    assert "does not divide" in ranks[0]["mp3"]


# the layers whose pieces lie along their input channels (row-parallel)
ROW_PARALLEL = ("output_block.conv2.weight", "linear2.weight", "out_proj.weight")
# the tensors between a bottleneck's column- and row-parallel convolutions
BETWEEN = (".output_block.norm2.", ".output_block.relu2.")


def test_state_is_channel_sharded_as_jax_shards_it(runs):
    theirs, variables, ranks = runs["theirs"], runs["variables"], runs["tp"]
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    shardings = jax_mesh.state_shardings(variables, JaxMesh(devices, ("data", "model")))
    sharded = {"/".join(str(k.key) for k in path)
               for path, spec in jax.tree_util.tree_leaves_with_path(
                   jax.tree_util.tree_map(lambda s: s.spec, shardings),
                   is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
               if "model" in spec}
    cfg = port_config(theirs)
    sources = map_jax_variables(variables, cfg).sources
    want = set()
    for name, paths in sources.items():
        hits = {p in sharded for p in paths}
        assert len(hits) == 1, (name, paths)           # a packed tensor shards whole
        if hits.pop():
            want.add(name)
    assert any(n.endswith("in_proj_weight") for n in want)
    model = TransformerCVN(cfg)
    axes = jax_channel_axes(model)
    between = {n for n, _ in (*model.named_parameters(), *model.named_buffers())
               if any(b in n for b in BETWEEN)}
    assert len(between) == 4 * 5        # 4 bottlenecks: norm2's 4 tensors, relu2's alpha
    for out in ranks:
        assert set(out["layout"]) == want | between
        for name, (piece, whole, dim, blocks) in out["layout"].items():
            if name.endswith(ROW_PARALLEL):
                assert (dim, blocks) == (1, 1), name
            elif name.endswith(("in_proj_weight", "in_proj_bias")):
                assert (dim, blocks) == (0, 3), name
            else:
                assert (dim, blocks) == (axes[name][1] if name in axes else 0, 1), name
            assert piece[dim] * 2 == whole[dim], name
            assert piece[:dim] + piece[dim + 1:] == whole[:dim] + whole[dim + 1:], name
            if name in out["moment_pieces"]:
                assert out["moment_pieces"][name] == piece, name
        assert set(out["moment_pieces"]) == {n for n in out["layout"] if "running_" not in n}
        # the packed q/k/v: this rank's heads of each of q, k and v
        local, whole = out["in_proj"]
        hidden = whole.shape[1]
        heads = whole.view(3, hidden, hidden).chunk(2, 1)[out["mesh"][3]]
        assert torch.equal(local, heads.reshape(-1, hidden))


def test_each_rank_computes_its_part_of_the_partitioned_layers(runs):
    """conv1 to expand/mp channels, norm2 and relu2 on them, conv2 from
    them; heads/mp heads; linear1 to hidden/mp; one sum over the TP row a
    layer in the forward."""
    theirs = runs["theirs"]
    cfg = theirs.model_config
    expand = cfg.densenet_batch_norm_size * cfg.densenet_growth_rate
    hidden, heads = cfg.hidden_dim, cfg.num_attention_heads
    for out in runs["tp"]:
        record, rank = out["partition"], out["mesh"][2] * 2 + out["mesh"][3]
        row = [rank - rank % 2, rank - rank % 2 + 1]
        bottlenecks = [n for n in record if ".layers." in n and n.startswith("prong_embedding")]
        attentions = [n for n in record if n.endswith("self_attn")]
        feed_forwards = [n for n in record if n.startswith("encoder") and n not in attentions]
        assert len(bottlenecks) == 2 * sum(cfg.densenet_structure)
        assert len(attentions) == len(feed_forwards) == cfg.num_encoder_layers
        for name in bottlenecks:
            r = record[name]
            (conv1, conv2) = r["conv2d"]
            assert conv1[:2] == (expand // 2, conv1[1]) and conv2[:2] == (
                cfg.densenet_growth_rate, expand // 2), (name, r)
            assert r["channels"] == {"norm2": expand // 2, "relu2": expand // 2}, name
            assert r["sums"] == [row], name
        for name in attentions:
            r = record[name]
            assert r["linear"] == [(3 * hidden // 2, hidden), (hidden, hidden // 2)], name
            assert [s[1] for s in r["softmax"]] == [heads // 2], name
            assert r["sums"] == [row], name
        for name in feed_forwards:
            r = record[name]
            assert r["linear"] == [(hidden // 2, hidden), (hidden, hidden // 2)], name
            assert r["sums"] == [row], name


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory, synthetic_file):
    root = tmp_path_factory.mktemp("tp_families")
    setup = {}
    for family in ("dense", "coo", *FAMILIES):
        (batch,), norm = batches_and_norm(synthetic_file, family)
        setup[family] = (family_configs(family, num_attention_heads=2)[1], batch, norm)
    torch.save(setup, root / "setup.pt")
    return finish(start("families", root / "setup.pt", root, 2))


@pytest.mark.parametrize("family", ("dense", "coo", *FAMILIES))
def test_every_family_at_mp2_equals_its_network_whole(family_runs, family):
    """Each family's network at dp1 x mp2, its encoder (and the dense and
    coo bottlenecks) partitioned and every other sharded weight gathered in
    the forward, equals the same network run whole, float32: logits within
    ``TOL``; each gradient within 1e-3 of its tensor's largest element plus
    1e-3 of the network's largest, ``test_torch_port_compile.py``'s rule
    for reordered float32 sums (the row-parallel layers sum their partial
    products in another order, and the train-mode BatchNorms over 4 events
    amplify it: ~1e-4 of a tensor's largest in the dense family, ~1e-6 of
    the network's in a bias ahead of a BatchNorm, whose exact gradient is
    0); the running statistics within 1e-5."""
    for out in family_runs:
        got = out[family]
        assert got["sharded"] > 0 and got["partitioned"] > 0, got
        for whole_run, tp_run in zip(*got["logits"]):
            torch.testing.assert_close(tp_run, whole_run, **TOL)
        largest = max(m for _, m in got["grads"].values())
        for name, (diff, own) in got["grads"].items():
            assert diff <= 1e-3 * (own + largest), (name, diff, own, largest)
        assert got["stats"] <= 1e-5, got


@pytest.mark.parametrize("family", ("dense", "coo", *FAMILIES))
def test_sharding_rule_matches_jax_on_every_family(family, synthetic_file):
    (batch,), norm = batches_and_norm(synthetic_file, family)
    cfg, port_cfg = family_configs(family, num_attention_heads=2)
    shapes = jax.eval_shape(
        lambda b, n: JaxTransformerCVN(cfg).init(jax.random.PRNGKey(0), b, n, train=False),
        {k: jnp.asarray(v) for k, v in batch.items()}, {k: jnp.asarray(v) for k, v in norm.items()})
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    shardings = jax_mesh.state_shardings(variables, JaxMesh(devices, ("data", "model")))
    flat = {"/".join(str(k.key) for k in path): "model" in s.spec
            for path, s in jax.tree_util.tree_leaves_with_path(
                shardings, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))}
    sources = map_jax_variables(variables, port_cfg).sources
    got = parallel.state_shardings(TransformerCVN(port_cfg), 2)
    assert set(got) <= set(sources)
    for name, dim in got.items():
        assert {flat[p] for p in sources[name]} == {dim is not None}, name


def test_steps_match_data_parallel(runs):
    tp, dp = runs["tp"][0], runs["dp"][0]
    np.testing.assert_allclose(tp["losses"], dp["losses"], rtol=2e-5)
    np.testing.assert_allclose(tp["grad_norms"], dp["grad_norms"], rtol=2e-4)
    for name, want in dp["state"]["model"].items():
        np.testing.assert_allclose(tp["state"]["model"][name].numpy(), want.numpy(),
                                   atol=3e-4, err_msg=name)
    # and each element whose gradient stayed above 1e-4 moved as dp2's did
    assert assert_adam_params_close(tp["state"]["model"], dp["state"]["model"], tp["stable"],
                                    OVERRIDES["learning_rate"], STEPS) > 1000


def test_dropout_and_noise_match_data_parallel(runs):
    """With dropout and pixel noise on, a TP row draws its data shard's
    masks, which dp2's rank of that shard draws too."""
    tp, dp = runs["tp"][0]["noisy"], runs["dp"][0]["noisy"]
    np.testing.assert_allclose(tp["losses"], dp["losses"], rtol=2e-5)
    np.testing.assert_allclose(tp["grad_norms"], dp["grad_norms"], rtol=2e-4)
    clean = runs["dp"][0]["losses"]
    assert all(abs(a - b) > 1e-4 for a, b in zip(dp["losses"], clean))


def test_steps_match_jax_hybrid_trainer(runs):
    tp, want = runs["tp"][0], runs["jax"]
    np.testing.assert_allclose(tp["losses"], [m[0] for m in want["metrics"]], **TOL)
    np.testing.assert_allclose(tp["grad_norms"], [m[1] for m in want["metrics"]], **TOL)
    got = tp["state"]["model"]
    for name, tensor in want["state"].items():
        if name not in tp["stable"]:                        # BatchNorm statistics
            np.testing.assert_allclose(got[name].numpy(), tensor.numpy(), atol=3e-4,
                                       err_msg=name)
    assert assert_adam_params_close(got, want["state"], tp["stable"],
                                    OVERRIDES["learning_rate"], STEPS) > 1000


def test_ranks_hold_one_state(runs):
    first = runs["tp"][0]["state"]
    for out in runs["tp"][1:]:
        for key in ("model", "optimizer"):
            assert torch.equal(torch.cat([t.reshape(-1).float() for t in _tensors(first[key])]),
                               torch.cat([t.reshape(-1).float() for t in _tensors(out["state"][key])]))
        assert out["losses"] == runs["tp"][0]["losses"]


def _tensors(tree):
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=torch.is_tensor)
    return [t for t in leaves if torch.is_tensor(t)]


def test_validation_and_predictions_match(runs):
    tp, dp, want = runs["tp"][0], runs["dp"][0], runs["jax"]
    for key in ("val_loss", "val_epoch_accuracy", "event_epoch_AUC", "prong_epoch_AUC"):
        np.testing.assert_allclose(tp["validation"][key], dp["validation"][key], atol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(tp["validation"][key], want["validation"][key], **TOL,
                                   err_msg=key)
    for other, tol in ((dp["predictions"], dict(atol=1e-5)), (want["predictions"], TOL)):
        for key in ("event_targets", "prong_targets", "prong_event_index"):
            np.testing.assert_array_equal(tp["predictions"][key], other[key], err_msg=key)
        for key in ("event_probabilities", "prong_probabilities"):
            np.testing.assert_allclose(tp["predictions"][key], other[key], **tol, err_msg=key)


@pytest.mark.parametrize("name", ("adamw", "adam", "sgd", "rmsprop", "adagrad", "lamb",
                                  "lars", "lion", "global_norm", "trust_ratio"))
def test_optimizers_on_pieces_equal_whole(runs, name):
    for out in runs["tp"]:
        assert out["optimizers"][name] <= 1e-6, (name, out["optimizers"][name])


def test_fit_checkpoint_resume_bit_exact(runs):
    ranks = runs["tp"]
    for out in ranks:
        for key in ("model", "optimizer"):
            assert torch.equal(
                torch.cat([t.reshape(-1).float() for t in _tensors(out["fit_state"][key])]),
                torch.cat([t.reshape(-1).float() for t in _tensors(out["resumed_state"][key])]))
    assert sorted(os.listdir(Path(ranks[0]["run_dir"]) / "checkpoints")) == [
        "index.json", "step_2", "step_4"]


def test_checkpoint_evaluates_on_one_process(runs, capsys):
    tp = runs["tp"][0]
    options = tiny_options(Options, **dict(TINY, training_file=str(runs["root"] / "train.h5"),
                                           **OVERRIDES))
    one = Trainer(options, debug=True, device="cpu", verbose=False)
    assert "running without tensor parallelism" in capsys.readouterr().out
    assert one.mesh.mp == 1 and one.num_shards == 1
    one.resume(os.path.join(tp["run_dir"], "checkpoints", "step_4"))
    state = one.state.model.state_dict()
    for name, tensor in tp["fit_state"]["model"].items():
        assert torch.equal(state[name], tensor), name
    result = one.validate()
    for key in ("val_loss", "val_epoch_accuracy", "event_epoch_AUC", "prong_epoch_AUC"):
        np.testing.assert_allclose(result[key], tp["fit"][key], **TOL, err_msg=key)


def test_steps_per_dispatch_2_equals_single_steps(runs):
    for out in runs["tp"]:
        assert out["k2_max_diff"] == 0.0


@pytest.mark.parametrize("devices, mp", [(1, 16), (4, 2), (8, 2), (8, 4), (8, 8), (4, 1),
                                          (8, 3), (4, 3)])
def test_mesh_shape_matches_jax(devices, mp):
    try:
        mesh = jax_mesh.create_mesh(devices, model_parallel=mp)
    except ValueError:
        with pytest.raises(ValueError, match="does not divide"):
            parallel.mesh_shape(devices, devices, mp)
        return
    model = mesh.shape["model"] if jax_mesh.is_hybrid(mesh) else 1
    assert parallel.mesh_shape(devices, devices, mp) == (jax_mesh.data_axis_size(mesh), model)


@pytest.mark.parametrize("shape", [(32, 64), (7, 7, 3, 64), (64,), (16, 4), (), (1, 16),
                                   (128, 8, 16), (8, 16), (3, 24)])
def test_channel_rule_matches_jax_state_shardings(shape):
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    spec = jax_mesh.state_shardings({"leaf": jnp.zeros(shape)},
                                    JaxMesh(devices, ("data", "model")))["leaf"].spec
    assert parallel.channel_sharded(shape, 2) == ("model" in spec)


def test_tp_rows_stay_on_a_host():
    assert parallel.tp_rows_process_local(8, 2, 4)
    assert parallel.tp_rows_process_local(8, 4, 4)
    assert not parallel.tp_rows_process_local(8, 4, 2)
    assert not parallel.tp_rows_process_local(6, 2, 3)
    assert parallel.tp_rows_process_local(4, 4, 4)


def test_compiled_tensor_parallel_steps_match_eager(tmp_path):
    check_compiled_ranks(tmp_path, {**TINY, **SMALL, "num_gpu": 2, "model_parallel": 2,
                                    "num_attention_heads": 2})
