"""The port's ``DecoderLayer`` and ``InducedSetAttentionBlock`` against the
JAX package's.

Weights are drawn from seeded numpy in the shapes ``jax.eval_shape`` gives
and carried by ``from_jax.WeightMapper`` (``decoder_layer`` / ``isab``);
the JAX gradients of the parameters are carried the same way.  Float32,
dropout 0, masks that pad some tokens of each sequence.  Outputs agree
within ``rtol=atol=1e-5`` and gradients within ``rtol=1e-4, atol=1e-5``:
three LayerNorms and two softmaxes a layer, summed in other orders.  A
``torch.nn.TransformerDecoderLayer``'s ``state_dict`` loads strictly into
the port's layer, which then computes what torch's does.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.models.encoder import DecoderLayer as JaxDecoderLayer
from dune_transformercvn_tpu.models.encoder import (
    InducedSetAttentionBlock as JaxInducedSetAttentionBlock)
from dune_transformercvn_torch.from_jax import WeightMapper
from dune_transformercvn_torch.models import DecoderLayer, InducedSetAttentionBlock
from test_torch_port_network import random_variables

torch.set_num_threads(2)

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, TQ, TK, D, HEADS = 3, 5, 7, 16, 4


def padding_mask(rng, batch, length):
    """[batch, length] bool, True = real; every row keeps at least 2."""
    counts = rng.integers(2, length + 1, batch)
    return np.arange(length)[None, :] < counts[:, None]


def port_state_dict(variables, method):
    mapper = WeightMapper(variables)
    getattr(mapper, method)("", "", D)
    return mapper.state_dict()


def compare(jax_module, port_module, method, args, port_call, seed):
    """Forward and gradients (parameters and float inputs) of both
    modules on the same weights; ``args`` are numpy inputs, masks last."""
    rng = np.random.default_rng(seed)
    jargs = [jnp.asarray(a) if a is not None else None for a in args]
    variables = random_variables(jax_module, seed, *jargs)
    port_module.load_state_dict(port_state_dict(variables, method), strict=True)
    floats = [i for i, a in enumerate(args) if a is not None and a.dtype == np.float32]

    def out_fn(params, *inputs):
        full = list(jargs)
        for i, x in zip(floats, inputs):
            full[i] = x
        return jax_module.apply({"params": params}, *full)

    want = jax.jit(out_fn)(variables["params"], *[jargs[i] for i in floats])
    cotangent = rng.normal(size=want.shape).astype(np.float32)
    grads = jax.jit(jax.grad(lambda *a: (out_fn(*a) * cotangent).sum(),
                             argnums=tuple(range(1 + len(floats)))))(
        variables["params"], *[jargs[i] for i in floats])

    tensors = [torch.tensor(a, requires_grad=i in floats) if a is not None else None
               for i, a in enumerate(args)]
    got = port_call(port_module, *tensors)
    (got * torch.from_numpy(cotangent)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OUT_TOL)
    want_params = port_state_dict({"params": jax.device_get(grads[0])}, method)
    for name, p in port_module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_params[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    for i, g in zip(floats, grads[1:]):
        np.testing.assert_allclose(tensors[i].grad.numpy(), np.asarray(g), **GRAD_TOL,
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("masked", [False, True])
def test_decoder_layer_matches_jax(activation, masked):
    rng = np.random.default_rng(3)
    targets = rng.normal(size=(B, TQ, D)).astype(np.float32)
    memory = rng.normal(size=(B, TK, D)).astype(np.float32)
    memory_mask = self_mask = None
    if masked:
        memory_mask = np.broadcast_to(padding_mask(rng, B, TK)[:, None, None, :], (B, 1, TQ, TK))
        self_mask = np.broadcast_to(padding_mask(rng, B, TQ)[:, None, None, :], (B, 1, TQ, TQ))
    jax_layer = JaxDecoderLayer(hidden_dim=D, num_heads=HEADS, activation=activation)
    layer = DecoderLayer(D, HEADS, activation=activation)
    compare(jax_layer, layer, "decoder_layer", (targets, memory, memory_mask, self_mask),
            lambda m, t, mem, mm, sm: m(t, mem, memory_mask=mm, self_mask=sm), 5)


@pytest.mark.parametrize("input_dim", [D, 10])
@pytest.mark.parametrize("masked", [False, True])
def test_isab_matches_jax(input_dim, masked):
    """With and without ``input_projection``, with and without a mask."""
    rng = np.random.default_rng(7)
    tokens = rng.normal(size=(B, 9, input_dim)).astype(np.float32)
    mask = padding_mask(rng, B, 9) if masked else None
    jax_block = JaxInducedSetAttentionBlock(hidden_dim=D, num_heads=HEADS, num_indices=4)
    block = InducedSetAttentionBlock(input_dim, D, HEADS, num_indices=4)
    assert (block.input_projection is None) == (input_dim == D)
    compare(jax_block, block, "isab", (tokens, mask), lambda m, t, k: m(t, k), 9)


def test_isab_initialisers():
    """The inducing points are flax's xavier-uniform of [1, m, D] (fan-in m,
    fan-out D); every dense and attention weight is drawn (none left as
    ``torch.empty``); the same generator seed gives the same block."""
    make = partial(InducedSetAttentionBlock, 10, D, HEADS, num_indices=4)
    block = make(generator=torch.Generator().manual_seed(0))
    bound = np.sqrt(6.0 / (4 + D))
    points = block.inducing_points.detach()
    assert points.shape == (1, 4, D) and points.abs().max() <= bound
    assert points.abs().max() > 0.5 * bound
    for name, p in block.named_parameters():
        assert torch.isfinite(p).all(), name
    again = make(generator=torch.Generator().manual_seed(0))
    for (name, a), b in zip(block.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


def test_torch_decoder_layer_state_dict_loads():
    """The reference's ``torch.nn.TransformerDecoderLayer`` names: its
    ``state_dict`` loads strictly and the outputs agree (its LayerNorm
    epsilon set to flax's 1e-6; key-padding masks)."""
    torch.manual_seed(0)
    reference = torch.nn.TransformerDecoderLayer(
        D, HEADS, dim_feedforward=D, dropout=0.0, activation="gelu", layer_norm_eps=1e-6,
        batch_first=True).eval()
    layer = DecoderLayer(D, HEADS).eval()
    layer.load_state_dict(reference.state_dict(), strict=True)
    rng = np.random.default_rng(2)
    targets = torch.from_numpy(rng.normal(size=(B, TQ, D)).astype(np.float32))
    memory = torch.from_numpy(rng.normal(size=(B, TK, D)).astype(np.float32))
    tq = torch.from_numpy(padding_mask(rng, B, TQ))
    tk = torch.from_numpy(padding_mask(rng, B, TK))
    with torch.no_grad():
        want = reference(targets, memory, tgt_key_padding_mask=~tq,
                         memory_key_padding_mask=~tk)
        got = layer(targets, memory, memory_mask=tk[:, None, None, :],
                    self_mask=tq[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **OUT_TOL)
