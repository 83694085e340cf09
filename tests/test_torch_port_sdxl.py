"""The port's sdxl family: the SDXL encoder, diffusers' layout, and the
chunked embedder.

* ``SDXLEncoder`` against the JAX package's at 400x280 (eight downsamples
  to 1x1), init width 4, float32 within ``rtol=atol=1e-5``; in bfloat16
  within 2^-5 of the largest float32 output (each framework's bfloat16
  output sits a few percent from its own float32 one, and the two round at
  different points, as ``test_torch_port_network.py`` sets out).
* Its ``state_dict`` is ``tests/_diffusers_ref.py::SDXLNet``'s: that
  module's weights load strictly and give its output (``rtol=1e-5``,
  ``atol=1e-6``: the same ops, one transposed input).
* ``network.apply_embedder``: a bank in chunks gives the full bank's output
  and input gradient (``rtol=1e-5``, ``atol=1e-6``: per-sample GroupNorm,
  convs over sub-batches) and parameter gradients (``1e-4``: float32 sums
  over the whole bank's pixels, in chunks), a bank no larger than the chunk runs as one rematted
  chunk, a chunk that does not divide the bank warns and runs one full-bank
  call, the save-spatial policy keeps the small conv outputs and gives
  blanket remat's gradients bit for bit, and the parameter names do not
  depend on chunking.
* One chunked train step of the whole network (chunk 2, save-spatial 100)
  against the JAX package's step (``test_torch_port_train.check_train_steps``'
  tolerances).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from dune_transformercvn_tpu.models.sdxl import SDXLEncoder as JaxSDXLEncoder
from dune_transformercvn_torch.models import TransformerCVN, network
from dune_transformercvn_torch.models.sdxl import SDXLEncoder
from _diffusers_ref import SDXLNet  # same-dir test helpers
from _torch_families import family_configs
from test_torch_port_models import carry, random_variables
from test_torch_port_train import check_train_steps

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
H, W = 400, 280


def images(n, seed):
    """Sparse positive pixel maps, NHWC."""
    rng = np.random.default_rng(seed)
    occupied = rng.random((n, H, W)) < 0.02
    return (rng.uniform(0.1, 1.0, (n, H, W, 3)) * occupied[..., None]).astype(np.float32)


def encoders(dtype="float32"):
    x = images(3, 1)
    jm = JaxSDXLEncoder(output_dim=8, init_block_dim=4, dtype=jnp.dtype(dtype))
    variables = random_variables(jm, 5, jnp.asarray(x))
    pm = carry(SDXLEncoder(3, 8, 4, compute_dtype=getattr(torch, dtype)), variables,
               lambda m: m.sdxl("", ""))
    return x, jm, variables, pm


def test_sdxl_encoder_matches_jax():
    x, jm, variables, pm = encoders()
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sdxl_encoder_bfloat16_matches_jax():
    x, _, variables, pm32 = encoders()
    with torch.no_grad():
        want32 = pm32(torch.from_numpy(x)).numpy()
    jm = JaxSDXLEncoder(output_dim=8, init_block_dim=4, dtype=jnp.bfloat16)
    want16 = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)).astype(jnp.float32))
    pm = SDXLEncoder(3, 8, 4, compute_dtype=torch.bfloat16)
    pm.load_state_dict(pm32.state_dict(), strict=True)
    with torch.no_grad():
        got16 = pm(torch.from_numpy(x))
    assert got16.dtype == torch.bfloat16
    assert np.abs(want16 - want32).max() > 1e-3               # bfloat16 did round
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=0,
                               atol=2 ** -5 * np.abs(want32).max())


def test_state_dict_is_the_diffusers_references():
    torch.manual_seed(0)
    ref = SDXLNet(input_features=3, output_features=8, init_block_dim=4).eval()
    port = SDXLEncoder(3, 8, 4)
    assert [(k, v.shape) for k, v in port.state_dict().items()] == [
        (k, v.shape) for k, v in ref.state_dict().items()]
    port.load_state_dict(ref.state_dict(), strict=True)
    x = images(2, 2)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        got = port(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the chunked embedder
# ---------------------------------------------------------------------------

def gradients(cnn, x, **kwargs):
    """Output and the gradients of a fixed projection of it wrt the
    parameters and the images."""
    cnn.zero_grad()
    x = x.clone().requires_grad_()
    out = network.apply_embedder(cnn, x, None, **kwargs)
    weights = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
    (out * weights).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in cnn.named_parameters()}, x.grad


def assert_same(a, b, **tol):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                torch.testing.assert_close(x[k], y[k], **tol, msg=k)
        else:
            torch.testing.assert_close(x, y, **tol)


@pytest.fixture(scope="module")
def bank():
    torch.manual_seed(1)
    cnn = SDXLEncoder(3, 8, 4)
    return cnn, torch.from_numpy(images(6, 3))


@pytest.mark.parametrize("chunk", [2, 6, 8])
def test_chunked_bank_equals_the_full_bank(bank, chunk):
    cnn, x = bank
    full = gradients(cnn, x)
    chunked = gradients(cnn, x, chunk=chunk)
    assert_same(chunked[::2], full[::2], rtol=1e-5, atol=1e-6)
    # a parameter's gradient sums over every pixel of the bank (conv_in's
    # bias: 6 x 400 x 280 terms), per chunk and then over the chunks
    assert_same(chunked[1:2], full[1:2], rtol=1e-4, atol=1e-4)


def test_a_chunk_that_does_not_divide_the_bank_warns(bank):
    cnn, x = bank
    full = gradients(cnn, x)
    with pytest.warns(UserWarning, match="embedder_chunk=4 does not divide bank size 6"):
        got = gradients(cnn, x, chunk=4)
    assert_same(got, full, rtol=0, atol=0)


def test_save_spatial_keeps_small_conv_outputs_and_equals_blanket_remat(bank, monkeypatch):
    """Threshold 100 keeps the conv outputs from 12x8 down (the resnets,
    downsamples, shortcut and ``conv_out`` there) and recomputes the rest."""
    cnn, x = bank
    decisions = []
    policy_fn = network._save_small_convs

    def counting(threshold, ctx, op, *args, **kwargs):
        policy = policy_fn(threshold, ctx, op, *args, **kwargs)
        if op is torch.ops.aten.convolution.default and not ctx.is_recompute:
            decisions.append(policy)
        return policy

    blanket = gradients(cnn, x, chunk=2)
    monkeypatch.setattr(network, "_save_small_convs", counting)
    selective = gradients(cnn, x, chunk=2, save_spatial=100)
    saved = decisions.count(CheckpointPolicy.MUST_SAVE)
    # a chunk of 2 images, three chunks: block 4's downsample (to 12x8);
    # blocks 5-7 (12x8, 6x4, 3x2) two resnets of two convs and a
    # downsample each; the shortcuts where the width changes (blocks 6 and
    # 8); block 8's (1x1) two resnets; the mid block's two; conv_out
    assert len(decisions) % 3 == 0 and saved < len(decisions)
    assert saved == 3 * (1 + 3 * 5 + 2 + 4 + 4 + 1), saved
    assert_same(selective, blanket, rtol=0, atol=0)


def test_parameter_names_do_not_depend_on_chunking():
    _, port_cfg = family_configs("sdxl")
    plain = TransformerCVN(port_cfg).state_dict()
    chunked = TransformerCVN(dataclasses.replace(
        port_cfg, embedder_chunk=2, embedder_chunk_save_spatial=100)).state_dict()
    assert [(k, v.shape) for k, v in plain.items()] == [
        (k, v.shape) for k, v in chunked.items()]
    assert "prong_embedding.prong_pixel_embedding.encoder.mid_block.attn.to_q.weight" in plain


def test_chunked_train_step_matches_jax(synthetic_file):
    """The port's chunked step against the JAX package's full-bank step
    (the JAX package's ``test_embedder_chunk.py`` holds its ``nn.scan``
    chunks to the full bank; compiling them here would double the test)."""
    check_train_steps(synthetic_file, "sdxl", 1, 0.5, 0.0,
                      port_only=dict(embedder_chunk=2, embedder_chunk_save_spatial=100))
