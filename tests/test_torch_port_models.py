"""The port's model modules against the JAX package's, on the CPU.

Each JAX module's variables are drawn from seeded numpy (so BatchNorm
statistics and PReLU slopes are not their trivial starts), carried into the
port by ``from_jax.WeightMapper``, and both sides run the same numpy inputs
in float32, in eval mode and in train mode (batch statistics and the
running-stat update), with dropout 0.  Tolerance ``rtol=atol=1e-5``: the
same arithmetic, summed in another order by XLA and by torch/oneDNN.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.models import blocks as jax_blocks
from dune_transformercvn_tpu.models import densenet as jax_densenet
from dune_transformercvn_tpu.models import encoder as jax_encoder
from dune_transformercvn_tpu.models import heads as jax_heads
from dune_transformercvn_torch.from_jax import WeightMapper
from dune_transformercvn_torch.models.blocks import (
    FeatureEmbedding, LinearBlock, feature_embedding_widths, make_divisible)
from dune_transformercvn_torch.models.densenet import DenseNet, space_to_depth
from dune_transformercvn_torch.models.encoder import EncoderLayer, TransformerEncoder
from dune_transformercvn_torch.models.heads import EventDecoder, ProngDecoder

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def random_variables(jax_module, seed, *args, **kwargs):
    """Variables of ``jax_module`` drawn from seeded numpy: the tree's
    shapes come from ``jax.eval_shape`` (tracing, no compile); kernels are
    scaled by 1/sqrt(fan-in), BN statistics and slopes are not their
    trivial starts, variances stay positive."""
    shapes = jax.eval_shape(partial(jax_module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            qkv = path[-2].key in ("query", "key", "value")
            fan_in = shape[0] if qkv else int(np.prod(shape[:-1]))
            value = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name == "var":
            value = rng.uniform(0.5, 2.0, shape)
        elif name in ("scale", "alpha"):
            value = rng.uniform(0.2, 1.2, shape)
        else:
            value = 0.3 * rng.normal(size=shape)
        return value.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return {c: jax.tree_util.tree_map(np.asarray, dict(t)) for c, t in tree.items()}


def carry(module, variables, fill):
    """Load ``variables`` into the port ``module`` via ``fill(mapper)``."""
    mapper = WeightMapper(variables)
    fill(mapper)
    module.load_state_dict(mapper.state_dict(), strict=True)
    return module


def run_both(jax_module, variables, port_module, jax_args, torch_args, train,
             jax_kwargs=None):
    """Apply both modules; returns (jax_out, jax_stats, port_out)."""
    kw = dict(jax_kwargs or {})
    if train:
        out, updated = jax.jit(partial(jax_module.apply, mutable=["batch_stats"], **kw))(
            variables, *jax_args)
        stats = updated.get("batch_stats", {})
    else:
        out = jax.jit(partial(jax_module.apply, **kw))(variables, *jax_args)
        stats = variables.get("batch_stats", {})
    port_module.train(train)
    with torch.no_grad():
        port_out = port_module(*torch_args)
    return out, stats, port_out


def assert_stats_match(port_module, variables, stats, fill):
    """The port's running stats equal the JAX batch_stats after the step."""
    mapper = WeightMapper({"params": variables["params"], "batch_stats": stats})
    fill(mapper)
    want = mapper.state_dict()
    got = port_module.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names, "no statistics were compared"
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# blocks and heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_norm,prelu,force_bias", [
    (True, True, False), (False, True, False), (True, False, True)])
@pytest.mark.parametrize("train", [False, True])
def test_linear_block_matches_jax(batch_norm, prelu, force_bias, train):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(9, 12)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0], bool)
    jm = jax_blocks.LinearBlock(16, batch_norm=batch_norm, prelu=prelu,
                                force_bias=force_bias)
    v = random_variables(jm, 2, jnp.asarray(x))
    pm = carry(LinearBlock(12, 16, batch_norm=batch_norm, prelu=prelu,
                           force_bias=force_bias), v, lambda m: m.linear_block("", ""))
    assert (pm.linear.bias is not None) == (force_bias or not batch_norm)
    out, stats, got = run_both(jm, v, pm, (jnp.asarray(x), jnp.asarray(mask)),
                               (torch.from_numpy(x), torch.from_numpy(mask)),
                               train, dict(train=train))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    if batch_norm:
        assert_stats_match(pm, v, stats, lambda m: m.linear_block("", ""))


@pytest.mark.parametrize("train", [False, True])
def test_feature_embedding_matches_jax(train):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(10, 6)).astype(np.float32)
    extra = rng.normal(size=(10, 4)).astype(np.float32)
    mask = rng.random(10) < 0.7
    jm = jax_blocks.FeatureEmbedding(output_dim=32, initial_dim=8, max_layers=100)
    args = (jnp.asarray(data), jnp.asarray(extra), jnp.asarray(mask))
    v = random_variables(jm, 4, *args)
    pm = carry(FeatureEmbedding(10, 32, 8, 100), v,
               lambda m: m.feature_embedding("", ""))
    assert len(pm.embedding) == len(feature_embedding_widths(32, 8, 100)) == 3
    out, stats, got = run_both(
        jm, v, pm, args,
        (torch.from_numpy(data), torch.from_numpy(extra), torch.from_numpy(mask)),
        train, dict(train=train))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert_stats_match(pm, v, stats, lambda m: m.feature_embedding("", ""))


def test_feature_embedding_disabled_is_zeros_without_params():
    jm = jax_blocks.FeatureEmbedding(output_dim=24, initial_dim=8, max_layers=4,
                                     disabled=True, dtype=jnp.bfloat16)
    x = jnp.ones((5, 6))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x, jnp.ones((5, 4)))
    ref = jax.jit(jm.apply)(variables, x, jnp.ones((5, 4)))
    pm = FeatureEmbedding(10, 24, 8, 4, disabled=True, compute_dtype=torch.bfloat16)
    assert not jax.tree_util.tree_leaves(variables) and not pm.state_dict()
    out = pm(torch.ones(5, 6), torch.ones(5, 4))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape == (5, 24)
    assert not out.any()


def test_make_divisible_matches_jax():
    for value in (1, 7, 8, 12, 31, 32, 100, 255, 256, 257):
        assert make_divisible(value) == jax_blocks.make_divisible(value)


def test_event_decoder_matches_jax():
    x = np.random.default_rng(5).normal(size=(6, 32)).astype(np.float32)
    jm = jax_heads.EventDecoder(8)
    v = random_variables(jm, 6, jnp.asarray(x))
    pm = carry(EventDecoder(32, 8), v, lambda m: m.linear("hidden_layer", "Dense_0"))
    out = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)


@pytest.mark.parametrize("train,dropout", [(False, 0.0), (True, 0.0), (False, 0.1)])
def test_prong_decoder_matches_jax(train, dropout):
    """128 -> 64 -> 32 -> 16 -> 8 with forced biases, masked BN over B*P
    rows; with dropout > 0 the reference's Dropout entries shift the
    ``hidden_layers`` indices (compared in eval, where dropout is off: the
    two frameworks draw different dropout masks by design)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    mask = rng.random((3, 5)) < 0.6
    mask[:, 0] = True
    jm = jax_heads.ProngDecoder(num_classes=8, hidden_dim=128, num_layers=4,
                                dropout=dropout)
    v = random_variables(jm, 8, jnp.asarray(x), jnp.asarray(mask))
    pm = carry(ProngDecoder(8, 128, 4, dropout=dropout), v,
               lambda m: m.prong_decoder("", "", True, dropout))
    widths = [m.out_features for m in pm.hidden_layers if isinstance(m, torch.nn.Linear)]
    assert widths == [64, 32, 16, 8]
    out, stats, got = run_both(
        jm, v, pm, (jnp.asarray(x), jnp.asarray(mask)),
        (torch.from_numpy(x), torch.from_numpy(mask)), train, dict(train=train))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert_stats_match(pm, v, stats, lambda m: m.prong_decoder("", "", True, dropout))


# ---------------------------------------------------------------------------
# transformer encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_first", [False, True])
def test_encoder_layer_matches_jax(norm_first):
    B, T, D, heads = 3, 7, 32, 4
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    keep = np.ones((B, T), bool)
    keep[0, 4:] = False
    keep[2, 1:] = False                   # only the event token is real
    attn_mask = jnp.broadcast_to(jnp.asarray(keep)[:, None, None, :], (B, 1, T, T))
    jm = jax_encoder.EncoderLayer(hidden_dim=D, num_heads=heads, norm_first=norm_first)
    v = random_variables(jm, 12, jnp.asarray(x), attn_mask)
    pm = carry(EncoderLayer(D, heads, norm_first=norm_first), v,
               lambda m: m.encoder_layer("", "", D)).eval()
    out = jax.jit(jm.apply)(v, jnp.asarray(x), attn_mask)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)


@pytest.mark.parametrize("norm_first", [False, True])
def test_transformer_encoder_matches_jax_with_padding(norm_first):
    B, T, D, heads = 4, 6, 32, 8
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = rng.random((B, T)) < 0.6
    mask[:, 0] = True
    jm = jax_encoder.TransformerEncoder(hidden_dim=D, num_heads=heads, num_layers=3,
                                        norm_first=norm_first)
    v = random_variables(jm, 14, jnp.asarray(x), jnp.asarray(mask))
    pm = carry(TransformerEncoder(D, heads, 3, norm_first=norm_first), v,
               lambda m: m.transformer_encoder("", "", D)).eval()
    assert [k for k in pm.state_dict() if k.endswith("in_proj_weight")] == [
        f"encoder.layers.{i}.self_attn.in_proj_weight" for i in range(3)]
    out = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert not got[~torch.from_numpy(mask)].any()     # padded rows zeroed


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["direct", "s2d_pre", "pool_first"])
@pytest.mark.parametrize("train", [False, True])
def test_densenet_matches_jax(variant, train):
    """32x32 images, blocks [2, 2], growth 8: the direct stem, the s2d stem
    fed input already in s2d layout (as kernel K1 emits it), and
    transitions that pool first."""
    rng = np.random.default_rng(17)
    images = np.maximum(rng.normal(size=(8, 32, 32, 3)), 0).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    kw = dict(initial_features=8, growth_rate=8, batch_norm_size=2,
              block_config=(2, 2), stem_space_to_depth=variant == "s2d_pre",
              transition_pool_first=variant == "pool_first")
    jm = jax_densenet.DenseNet(output_dim=16, stem_in_channels=3, **kw)
    x = images
    if variant == "s2d_pre":
        x = space_to_depth(torch.from_numpy(images)).numpy()
        assert x.shape == (8, 16, 16, 12)
    v = random_variables(jm, 18, jnp.asarray(x))
    pm = carry(DenseNet(3, 16, **kw), v, lambda m: m.densenet("", "", (2, 2)))
    out, stats, got = run_both(
        jm, v, pm, (jnp.asarray(x), jnp.asarray(mask)),
        (torch.from_numpy(x), torch.from_numpy(mask)), train, dict(train=train))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    assert_stats_match(pm, v, stats, lambda m: m.densenet("", "", (2, 2)))


@pytest.mark.parametrize("size", [(20, 14), (21, 15)])
def test_densenet_s2d_stem_equals_direct_stem(size):
    """Same weights: the space-to-depth stem computes the direct 7x7/2 map,
    on plain input and on input already in s2d layout; odd extents take the
    direct conv."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(initial_features=8, growth_rate=8, batch_norm_size=2, block_config=(1,))
    direct = DenseNet(3, 16, **kw).eval()
    s2d = DenseNet(3, 16, stem_space_to_depth=True, **kw).eval()
    s2d.load_state_dict(direct.state_dict(), strict=True)
    x = torch.rand(2, *size, 3, generator=gen)
    with torch.no_grad():
        want = direct(x)
        torch.testing.assert_close(s2d(x), want, **TOL)
        if size[0] % 2 == 0:
            torch.testing.assert_close(s2d(space_to_depth(x)), want, **TOL)
