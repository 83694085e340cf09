"""The port's MobileNet, ResNet and attention-pooling modules against the
JAX package's.

* ``MobileNetV2`` (squeeze-excitation, the stretched stem kernel, padding
  ``((kh - 1) // 2, (kw - 1) // 2)``) at 30x20 images, a two-row ladder;
  ``ResNetStack`` (7x7/2 stem, -inf-padded max pool, projection shortcuts)
  at 64x48 (its last stage then sees 2x2 maps, not a single pixel);
  both in eval and in train mode with a masked slot (masked BatchNorm, the
  running statistics), within ``rtol=atol=1e-5``.
* ``MaskedSoftmaxPooling`` (an all-masked row gives zeros) and
  ``MultiHeadPooling`` within ``rtol=atol=1e-5``.
* One train step of the mobilenet and resnet networks against JAX's
  (``test_torch_port_train.check_train_steps``' tolerances).

Float32; variables from seeded numpy, carried by ``from_jax.WeightMapper``
(the pooling modules' by hand: no network holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.models import mobilenet as jax_mobilenet
from dune_transformercvn_tpu.models import pooling as jax_pooling
from dune_transformercvn_tpu.models import resnet as jax_resnet
from dune_transformercvn_torch.models.mobilenet import MobileNetV2, initial_kernel
from dune_transformercvn_torch.models.pooling import MaskedSoftmaxPooling, MultiHeadPooling
from dune_transformercvn_torch.models.resnet import ResNetStack
from test_torch_port_models import assert_stats_match, carry, random_variables, run_both
from test_torch_port_train import check_train_steps

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
STRUCTURE = ((1, 8, 1, 1), (6, 16, 2, 2))
MASK = np.array([True, False, True, True])


def images(seed, h, w):
    rng = np.random.default_rng(seed)
    occupied = rng.random((4, h, w)) < 0.2
    return (rng.uniform(0.1, 1.0, (4, h, w, 3)) * occupied[..., None]).astype(np.float32)


MODULES = {
    "mobilenet": (lambda: jax_mobilenet.MobileNetV2(
                      output_dim=24, initial_features=8, structure=STRUCTURE,
                      input_shape=(30, 20)),
                  lambda: MobileNetV2(3, 24, initial_features=8, structure=STRUCTURE,
                                      input_shape=(30, 20)),
                  lambda m: m.mobilenet("", ""), (30, 20)),
    "resnet": (lambda: jax_resnet.ResNetStack(output_dim=12, initial_features=8),
               lambda: ResNetStack(3, 12, initial_features=8),
               lambda m: m.resnet("", ""), (64, 48)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", sorted(MODULES))
def test_variant_module_matches_jax(family, train):
    make_jax, make_port, fill, (h, w) = MODULES[family]
    x = images(6, h, w)
    jm = make_jax()
    variables = random_variables(jm, 11, jnp.asarray(x), jnp.asarray(MASK))
    pm = carry(make_port(), variables, fill)
    out, stats, got = run_both(jm, variables, pm, (jnp.asarray(x), jnp.asarray(MASK)),
                               (torch.from_numpy(x), torch.from_numpy(MASK)), train,
                               dict(train=train))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert_stats_match(pm, variables, stats, fill)


def test_mobilenet_names_and_stem_follow_the_reference():
    """The reference's ``resnet.{i}`` names, and the stem kernel stretched
    along the longer image axis: (123, 3) padded (61, 1) at 400x280."""
    assert initial_kernel((400, 280)) == (123, 3) == jax_mobilenet.initial_kernel((400, 280))
    assert initial_kernel((280, 400)) == (3, 123)
    net = MobileNetV2(3, 24, initial_features=8, structure=STRUCTURE, input_shape=(400, 280))
    stem = net.resnet[0].conv
    assert stem.kernel_size == (123, 3) and stem.padding == (61, 1) and stem.stride == (2, 2)
    names = set(net.state_dict())
    for name in ("resnet.0.conv.weight", "resnet.0.norm.running_var",
                 "resnet.1.convolutions.0.conv.weight",       # depthwise (ratio 1)
                 "resnet.1.convolutions.1.fc1.weight", "resnet.1.convolutions.2.weight",
                 "resnet.1.convolutions.3.running_mean",
                 "resnet.2.convolutions.0.conv.weight",       # expand
                 "resnet.2.convolutions.4.weight", "resnet.4.conv.weight"):
        assert name in names, name


@pytest.mark.parametrize("empty_row", [False, True])
def test_masked_softmax_pooling_matches_jax(empty_row):
    rng = np.random.default_rng(7)
    tokens = rng.normal(size=(3, 5, 8)).astype(np.float32)
    mask = rng.random((3, 5)) < 0.6
    mask[0, 0] = True
    mask[2] = not empty_row and mask[2]
    jm = jax_pooling.MaskedSoftmaxPooling()
    variables = random_variables(jm, 3, jnp.asarray(tokens), jnp.asarray(mask))
    want = jax.jit(jm.apply)(variables, jnp.asarray(tokens), jnp.asarray(mask))
    pm = MaskedSoftmaxPooling(8)
    dense = variables["params"]["Dense_0"]
    pm.load_state_dict({"score.weight": torch.from_numpy(dense["kernel"].T.copy()),
                        "score.bias": torch.from_numpy(dense["bias"])})
    got = pm(torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if empty_row:
        assert not got[2].any()


def test_multi_head_pooling_matches_jax():
    rng = np.random.default_rng(8)
    tokens = rng.normal(size=(3, 6, 8)).astype(np.float32)
    mask = rng.random((3, 6)) < 0.6
    mask[:, 0] = True
    jm = jax_pooling.MultiHeadPooling(num_heads=2)
    variables = random_variables(jm, 4, jnp.asarray(tokens), jnp.asarray(mask))
    want = jax.jit(jm.apply)(variables, jnp.asarray(tokens), jnp.asarray(mask))
    p = variables["params"]
    attn = p["MultiHeadDotProductAttention_0"]
    sd = {"query": torch.from_numpy(p["query"])}
    for port, name in (("q", "query"), ("k", "key"), ("v", "value")):
        sd[f"{port}.weight"] = torch.from_numpy(attn[name]["kernel"].reshape(8, 8).T.copy())
        sd[f"{port}.bias"] = torch.from_numpy(attn[name]["bias"].reshape(8))
    sd["out.weight"] = torch.from_numpy(attn["out"]["kernel"].reshape(8, 8).T.copy())
    sd["out.bias"] = torch.from_numpy(attn["out"]["bias"])
    pm = MultiHeadPooling(8, num_heads=2)
    pm.load_state_dict(sd, strict=True)
    got = pm(torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("family", ["mobilenet", "resnet"])
def test_train_step_matches_jax(family, synthetic_file):
    check_train_steps(synthetic_file, family, 1, 0.5, 0.0)
