"""The port's eval-time BatchNorm folding (``ops/fold.py``) against the JAX
package's (``dune_transformercvn_tpu/ops/fold.py``).

Tiny networks (32x32 images, DenseNet [2, 2], float32) with variables drawn
from seeded numpy, BatchNorm statistics away from their starts, carried
into the port with ``from_jax``.  The count of folds equals JAX's for the
dense family, the coo family (whose stem is not folded) and the
space-to-depth stem; the folded ``state_dict`` equals JAX's folded
variables carried across (rtol 1e-6, atol 1e-7: the two compute the affine
in float32 with rsqrt against 1/sqrt); folded eval logits equal unfolded
ones within JAX's own bound (atol 2e-4, rtol 1e-4); families that are not
DenseNet-like are left as they are; and the ``Trainer``'s folded
``predict_split`` equals the JAX ``Trainer``'s on the same weights while its
raw state stays untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.config import Options as JaxOptions
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.ops.fold import count_foldable as jax_count_foldable
from dune_transformercvn_tpu.ops.fold import fold_eval_batchnorm as jax_fold
from dune_transformercvn_tpu.train import Trainer as JaxTrainer
from dune_transformercvn_torch.from_jax import load_jax_variables, state_dict_from_jax
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.ops.fold import count_foldable, fold_eval_batchnorm, folded_copy
from dune_transformercvn_torch import predict
from dune_transformercvn_torch.predict import to_device
from dune_transformercvn_torch.train import Trainer
from _torch_families import batches_and_norm, family_configs  # same-dir helpers
from test_torch_port_loop import small_synthetic_file, tiny_options
from test_torch_port_network import data, random_variables, tiny_config  # noqa: F401

torch.set_num_threads(2)

FOLD_TOL = dict(rtol=1e-6, atol=1e-7)
LOGIT_TOL = dict(rtol=1e-4, atol=2e-4)
CASES = {
    "dense": dict(),
    "coo": dict(embedder="coo"),
    "s2d": dict(stem_space_to_depth=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def folded(request, data):
    _, batch, norm = data
    cfg, port_cfg = tiny_config(**CASES[request.param])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    variables = random_variables(JaxTransformerCVN(cfg), 31, jb, jn, train=False)
    jax_folded = jax.device_get(jax.jit(lambda v: jax_fold(v)[0])(variables))
    model = load_jax_variables(TransformerCVN(port_cfg), variables).eval()
    return request.param, variables, jax_folded, model, batch, norm


def test_count_foldable_matches_jax(folded):
    name, variables, _, model, _, _ = folded
    want = jax_count_foldable(variables["params"])
    assert count_foldable(model) == want
    assert count_foldable(model.state_dict(), model.cfg.embedder) == want
    # [2, 2]: four bottlenecks an embedder, two embedders, plus the two
    # stems outside the coo family
    assert want == (8 if name == "coo" else 10)


def test_folded_state_matches_jax(folded):
    _, variables, jax_folded, model, _, _ = folded
    raw = {k: v.clone() for k, v in model.state_dict().items()}
    got, n = fold_eval_batchnorm(model.state_dict(), model.cfg.embedder)
    assert n == jax_count_foldable(variables["params"])
    want = state_dict_from_jax(jax_folded, model.cfg)
    assert got.keys() == want.keys()
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, **FOLD_TOL, msg=key)
    changed = [k for k in got if not torch.equal(got[k], raw[k])]
    assert len(changed) == 6 * n      # conv weight + bias, BN's four tensors
    for key, value in model.state_dict().items():   # values only, a new dict
        assert torch.equal(value, raw[key]), key


def test_folded_logits_equal_unfolded(folded):
    _, _, _, model, batch, norm = folded
    b, n = to_device(batch, "cpu"), to_device(norm, "cpu")
    clone = folded_copy(model)
    assert clone is not model
    with torch.no_grad():
        want, got = model(b, n), clone(b, n)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **LOGIT_TOL)
    bn = clone.prong_embedding.event_pixel_embedding.features.dense1.layers[0].output_block.norm2
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))


@pytest.mark.parametrize("family", ["resnet", "sparse"])
def test_non_densenet_family_is_noop(synthetic_file, family):
    cfg, port_cfg = family_configs(family)
    (batch,), norm = batches_and_norm(synthetic_file, family)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    variables = random_variables(JaxTransformerCVN(cfg), 2, jb, jn, train=False)
    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    assert jax_count_foldable(variables["params"]) == count_foldable(model) == 0
    sd = model.state_dict()
    got, n = fold_eval_batchnorm(sd, family)
    assert n == 0 and all(got[k] is sd[k] for k in sd)
    assert folded_copy(model) is model


def test_trainer_predict_split_folds_as_jax(tmp_path, monkeypatch):
    """Both Trainers with ``fold_eval_bn`` on the same weights and BatchNorm
    statistics: the port predicts with a folded copy (made once a call), as
    the JAX Trainer predicts with its folded ``_inference_state``; training
    keeps the raw state."""
    common = dict(training_file=small_synthetic_file(tmp_path / "fold.h5", 48, 5),
                  fold_eval_bn=True)
    theirs = JaxTrainer(tiny_options(JaxOptions, **common), run_dir=None, debug=True,
                        verbose=False)
    rng = np.random.default_rng(4)

    def draw(path, x):
        value = (rng.uniform(0.5, 2.0, x.shape) if path[-1].key == "var"
                 else 0.3 * rng.normal(size=x.shape))
        return value.astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(draw, jax.device_get(theirs.state.batch_stats))
    theirs.state = jax.device_put(theirs.state.replace(batch_stats=stats),
                                  theirs.state_sharding)
    ours = Trainer(tiny_options(**common), run_dir=None, debug=True, verbose=False,
                   device="cpu")
    load_jax_variables(ours.state.model, jax.device_get(
        {"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}))
    raw = {k: v.clone() for k, v in ours.state.model.state_dict().items()}
    copies = []
    monkeypatch.setattr(predict, "folded_copy",
                        lambda model: copies.append(model) or folded_copy(model))

    got, want = ours.predict_split("validation"), theirs.predict_split("validation")
    assert copies == [ours.state.model]
    for key in ("event_probabilities", "prong_probabilities"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)
    for key in ("event_targets", "prong_targets", "prong_event_index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, value in ours.state.model.state_dict().items():
        assert torch.equal(value, raw[key]), key
