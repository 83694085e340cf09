"""The port's coo family against the JAX package: the sparse stem (kernel
K2's contract through its plain version, forward and gradient),
``CooStemDenseNet`` and the coo ``TransformerCVN``.

Inputs are made from numpy seeds: hit banks at 48x40 with an empty image,
hits off the grid (negative too) inside a CSR range and padding rows past
``starts[-1]``.  Float32, dropout 0, pixel noise 0.  Tolerances: the stem
forward ``rtol=atol=1e-6`` (``tests/test_ops.py``: the same products summed
in another order), its gradients ``1e-5``, whole networks ``1e-4`` (the
network tests' bound).

The coo family's compiled steps: predict, eval and two train steps with
kernel K2's op (``tcvn::coo_stem_scatter``, its plain version on the CPU)
and its registered gradient inside the compiled graphs, against the same
steps run eagerly and against the JAX package's jitted steps; the
network, data and tolerances are ``tests/test_torch_port_compile.py``'s
(``check_compiled_steps``, imported at call time: that module imports
this one through ``test_torch_port_train``).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_transformercvn_tpu.data import Batcher, EventDataset
from dune_transformercvn_tpu.models import ModelConfig as JaxModelConfig
from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.models.coo_densenet import CooStemDenseNet as JaxCooStemDenseNet
from dune_transformercvn_tpu.ops.coo_conv import coo_stem_conv as jax_coo_stem_conv
from dune_transformercvn_tpu.ops.pallas_coo_stem import coo_stem_conv_pallas
from dune_transformercvn_torch.from_jax import (WeightMapper, load_jax_variables,
                                                state_dict_from_jax)
from dune_transformercvn_torch.models import CooStemDenseNet, ModelConfig, TransformerCVN
from dune_transformercvn_torch.ops import coo_stem
from dune_transformercvn_torch.ops.coo_conv import coo_stem_conv
from dune_transformercvn_torch.predict import to_device
from test_torch_port_network import random_variables  # same-dir test helpers

torch.set_num_threads(1)

H, W, C_IN = 48, 40, 3
STEM_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)


def hit_bank(seed, counts=(17, 0, 9)):
    """An owner-sorted bank: ``counts`` hits per image, then five malformed
    hits inside the last image's CSR range (off the grid on every side, and
    the two corners of the 2x2 origin cell), then five padding rows with an
    out-of-range owner past ``starts[-1]``."""
    rng = np.random.default_rng(seed)
    B = len(counts)
    xy = [np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], 1) for n in counts]
    xy.append(np.array([[H + 3, 1], [1, W + 2], [-1, 3], [0, 0], [1, 1]]))
    xy.append(rng.integers(0, H, (5, 2)))
    xy = np.concatenate(xy).astype(np.int32)
    owner = np.concatenate([np.full(n, b) for b, n in enumerate(counts)]
                           + [np.full(5, B - 1), np.full(5, B)]).astype(np.int32)
    values = rng.normal(size=(len(xy), C_IN)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts[:-1]), [sum(counts) + 5]]).astype(np.int32)
    return xy, values, owner, starts


def stem_weights(seed, c_out):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(7, 7, C_IN, c_out)).astype(np.float32),
            rng.normal(size=(c_out,)).astype(np.float32))


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("c_out", [16, 64])
def test_coo_stem_conv_matches_jax(c_out):
    xy, values, owner, starts = hit_bank(3)
    kernel, bias = stem_weights(4, c_out)
    B = len(starts) - 1
    j = [jnp.asarray(a) for a in (xy, values, owner, kernel, bias)]
    want = np.asarray(jax.jit(partial(jax_coo_stem_conv, batch=B, height=H, width=W))(*j))
    pallas = np.asarray(coo_stem_conv_pallas(
        jnp.asarray(xy), jnp.asarray(values), jnp.asarray(starts), jnp.asarray(kernel),
        jnp.asarray(bias), num_images=B, height=H, width=W, interpret=True))

    got = coo_stem_conv(t(xy), t(values), t(owner), t(kernel), t(bias), B, H, W,
                        starts=t(starts))
    assert tuple(got.shape) == (B, 24, 20, c_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **STEM_TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **STEM_TOL)
    assert np.abs(want[1]).max() == np.abs(bias).max()      # the empty image is the bias

    # the kernel route's pieces, with K2's plain version
    patches = coo_stem.stem_patches(t(xy), t(values), t(kernel), H, W)
    assert tuple(patches.shape) == (len(xy), 4, 4, c_out)
    split = coo_stem.scatter_patches_plain(patches, t(xy), t(starts), t(bias), B, H, W,
                                           torch.float32)
    np.testing.assert_allclose(split.numpy(), got.numpy(), **STEM_TOL)
    routed = coo_stem.coo_stem_conv_cuda(t(xy), t(values), t(starts), t(kernel), t(bias),
                                         B, H, W)
    np.testing.assert_allclose(routed.numpy(), got.numpy(), **STEM_TOL)


def test_coo_stem_conv_casts_like_jax_in_bfloat16():
    """bfloat16 values: weights rounded to bf16, float32 sums, bias, one cast."""
    xy, values, owner, starts = hit_bank(5)
    kernel, bias = stem_weights(6, 16)
    B = len(starts) - 1
    want = np.asarray(jax.jit(partial(jax_coo_stem_conv, batch=B, height=H, width=W))(
        jnp.asarray(xy), jnp.asarray(values, jnp.bfloat16), jnp.asarray(owner),
        jnp.asarray(kernel), jnp.asarray(bias)).astype(jnp.float32))
    vals = t(values).bfloat16()
    for got in (coo_stem_conv(t(xy), vals, t(owner), t(kernel), t(bias), B, H, W),
                coo_stem.coo_stem_conv_cuda(t(xy), vals, t(starts), t(kernel), t(bias),
                                            B, H, W)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


def test_coo_stem_gradients_match_jax():
    """Gradients of ``sum(out * cot)`` wrt values, weights and bias: through
    the op ``tcvn::coo_stem_scatter`` (plain forward, the registered backward), through
    torch autograd of the plain path, and JAX's ``jax.grad`` of the Pallas
    path (its custom VJP)."""
    xy, values, owner, starts = hit_bank(7, counts=(11, 6))
    kernel, bias = stem_weights(8, 64)
    B = len(starts) - 1
    cot = np.random.default_rng(9).normal(size=(B, 24, 20, 64)).astype(np.float32)

    def jax_loss(v, k, b):
        out = coo_stem_conv_pallas(jnp.asarray(xy), v, jnp.asarray(starts), k, b,
                                   num_images=B, height=H, width=W, interpret=True)
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        jnp.asarray(values), jnp.asarray(kernel), jnp.asarray(bias))

    def torch_grads(fn):
        args = [t(a).clone().requires_grad_() for a in (values, kernel, bias)]
        (fn(*args) * t(cot)).sum().backward()
        return [a.grad.numpy() for a in args]

    routed = torch_grads(lambda v, k, b: coo_stem.coo_stem_conv_cuda(
        t(xy), v, t(starts), k, b, B, H, W))
    plain = torch_grads(lambda v, k, b: coo_stem_conv(
        t(xy), v, t(owner), k, b, B, H, W))
    for name, r, p, w in zip(("values", "weights", "bias"), routed, plain, want):
        np.testing.assert_allclose(r, np.asarray(w), **GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(r, p, **GRAD_TOL, err_msg=name)
    # the malformed hits off the grid and the padding rows get exactly 0;
    # hits (0, 0) and (1, 1) are on the grid and do get a gradient
    real = sum((11, 6))
    np.testing.assert_array_equal(routed[0][real:real + 3], 0.0)
    np.testing.assert_array_equal(routed[0][real + 5:], 0.0)
    assert np.abs(routed[0][real + 3:real + 5]).min() > 0


@pytest.mark.parametrize("out_h,out_w,c_out,want", [
    (200, 140, 64, (4, 32)),          # production stem: 140 = 4 x 32 + 12
    (200, 140, 128, (4, 16)),         # 140 = 8 x 16 + 12
    (24, 20, 16, (4, 20)),            # one tile spans the width
    (19, 15, 12, (4, 15)),            # channels not a multiple of 8
    (3, 2, 64, (4, 2)),               # narrower than 4 columns
])
def test_kernel_tile_plan(out_h, out_w, c_out, want):
    """K2's tiles cover every output element exactly once; a block fits its
    thread limit, a thread's sums its registers (4 x 8 float32), an image's
    tile counts the binning's shared memory; a window reaches at most 2 x 2
    tiles."""
    rows, cols = coo_stem.tile_plan(out_h, out_w, c_out)
    assert (rows, cols) == want
    assert cols * -(-c_out // coo_stem.CHANNEL_GROUP) <= coo_stem.THREADS
    assert rows * coo_stem.CHANNEL_GROUP == 32
    assert rows >= 4 and (cols >= 4 or cols == out_w)
    cover = np.zeros((out_h, out_w, c_out), np.int32)
    tiles = 0
    for r0 in range(0, out_h, rows):
        for c0 in range(0, out_w, cols):
            cover[r0:r0 + rows, c0:c0 + cols] += 1
            tiles += 1
    assert (cover == 1).all()
    assert tiles <= coo_stem.MAX_TILES_PER_IMAGE
    # the binning's shared memory: a count per tile and 4 x 1024 staged keys
    assert 4 * (coo_stem.MAX_TILES_PER_IMAGE + 4 * 1024) <= 48 * 1024


def test_kernel_tile_plan_rejects_what_does_not_fit():
    assert coo_stem.out_shape(400, 280) == (200, 140)
    with pytest.raises(ValueError, match="channels"):
        coo_stem.tile_plan(200, 140, 520)          # 65 groups of 8: 3 columns
    assert coo_stem.tile_plan(200, 140, 512) == (4, 4)      # 4 x 64 threads
    with pytest.raises(ValueError, match="tiles"):
        coo_stem.tile_plan(2000, 1000, 64)         # 500 x 32 tiles an image


def numpy_bins(xy, starts, num_images, height, width, c_out):
    """A numpy counting sort of the (hit, tile) pairs: per image, count per
    tile, exclusive scan from ``4 * starts[i]``, then place each hit with its
    packed window origin in bank order."""
    out_h, out_w = coo_stem.out_shape(height, width)
    rows, cols = coo_stem.tile_plan(out_h, out_w, c_out)
    tiles_w = -(-out_w // cols)
    tiles = -(-out_h // rows) * tiles_w
    r = len(xy)
    bins = np.zeros((num_images * tiles, 2), np.int32)
    entries = np.full((4 * r, 2), -1, np.int32)
    for i in range(num_images):
        lo = min(max(int(starts[i]), 0), r)
        hi = min(max(int(starts[i + 1]), lo), r)
        lists = [[] for _ in range(tiles)]
        for g in range(lo, hi):
            x, y = int(xy[g, 0]), int(xy[g, 1])
            if not (0 <= x < height and 0 <= y < width):
                continue
            ox0, oy0 = (x - 2) // 2, (y - 2) // 2
            touched = {(max(ox0 + a, 0) // rows) * tiles_w + max(oy0 + b, 0) // cols
                       for a in range(4) for b in range(4)
                       if ox0 + a < out_h and oy0 + b < out_w}
            for t in sorted(touched):
                lists[t].append((g, (ox0 + 1) << 16 | (oy0 + 1)))
        pos = 4 * lo
        for t, hits in enumerate(lists):
            bins[i * tiles + t] = (pos, len(hits))
            entries[pos:pos + len(hits)] = np.array(hits, np.int32).reshape(-1, 2)
            pos += len(hits)
    return bins, entries


def track_bank(seed):
    """Hits on tile borders, duplicated on a tile corner, all of one image in
    one tile, and an image every tile of which stays untouched."""
    rng = np.random.default_rng(seed)
    xy = np.array([[14, 62], [14, 62], [14, 63], [15, 10], [3, 62], [0, 0],   # image 0
                   [18, 20], [19, 21], [18, 20],                              # image 1
                   [-1, 5], [H + 2, 5],                                       # image 2
                   [47, 99], [1, 1]], np.int32)                               # image 3
    xy = np.concatenate([xy, rng.integers(0, 48, (5, 2)).astype(np.int32)])   # padding
    starts = np.array([0, 6, 9, 11, 13], np.int32)
    return xy, starts


@pytest.mark.parametrize("bank,c_out", [("hits", 64), ("hits", 128), ("tracks", 64),
                                        ("tracks", 12)])
def test_bin_hits_plain_matches_a_numpy_counting_sort(bank, c_out):
    """K2's binning, in its plain version, against a numpy counting sort:
    the same tiles, counts, first entries and bank-ordered lists."""
    if bank == "hits":
        xy, _, _, starts = hit_bank(13, counts=(40, 0, 25))
        height, width = H, W
    else:
        xy, starts = track_bank(14)
        height, width = 48, 100
    n = len(starts) - 1
    bins, entries = coo_stem.bin_hits_plain(t(xy), t(starts), n, height, width, c_out)
    want_bins, want_entries = numpy_bins(xy, starts, n, height, width, c_out)
    np.testing.assert_array_equal(bins.numpy(), want_bins)
    np.testing.assert_array_equal(entries.numpy(), want_entries)
    if bank == "tracks":
        per_image = bins.numpy()[:, 1].reshape(n, -1)
        assert (per_image[1] > 0).sum() == 1 and per_image[1].max() == 3   # one tile
        assert not per_image[2].any()                                       # untouched
        # (14, 62) reaches 2 x 2 tiles of 4 rows x 32 columns at C_out 64
        assert (per_image[0] > 0).sum() >= (4 if c_out == 64 else 2)


@pytest.mark.parametrize("c_out", [12, 64])
def test_binned_tile_walk_reproduces_the_plain_scatter(c_out):
    """The scatter kernel's arithmetic in numpy: each tile adds its binned
    hits' taps (at their packed window origins) in list order over
    bias-free float32 sums, then the bias;
    equal to ``scatter_patches_plain`` up to float32 rounding."""
    xy, starts = track_bank(15)
    height, width = 48, 100
    n = len(starts) - 1
    rng = np.random.default_rng(16)
    values = rng.normal(size=(len(xy), C_IN)).astype(np.float32)
    kernel = 0.1 * rng.normal(size=(7, 7, C_IN, c_out)).astype(np.float32)
    bias = rng.normal(size=c_out).astype(np.float32)
    patches = coo_stem.stem_patches(t(xy), t(values), t(kernel), height, width)
    want = coo_stem.scatter_patches_plain(patches, t(xy), t(starts), t(bias), n, height,
                                          width, torch.float32).numpy()
    out_h, out_w = coo_stem.out_shape(height, width)
    rows, cols = coo_stem.tile_plan(out_h, out_w, c_out)
    bins, entries = coo_stem.bin_hits_plain(t(xy), t(starts), n, height, width, c_out)
    p = patches.numpy()
    got = np.zeros((n, out_h, out_w, c_out), np.float32)
    tiles_w = -(-out_w // cols)
    tiles = -(-out_h // rows) * tiles_w
    for tile, (first, count) in enumerate(bins.numpy()):
        i, k = divmod(tile, tiles)
        r0, c0 = (k // tiles_w) * rows, (k % tiles_w) * cols
        for g, origin in entries.numpy()[first:first + count]:
            ox0, oy0 = (origin >> 16) - 1, (origin & 0xFFFF) - 1
            for a in range(4):
                for b in range(4):
                    r, c = ox0 + a, oy0 + b
                    if r0 <= r < min(r0 + rows, out_h) and c0 <= c < min(c0 + cols, out_w):
                        got[i, r, c] += p[g, a, b]
    np.testing.assert_allclose(got + bias, want, **STEM_TOL)
    assert np.abs(want[2] - bias).max() == 0.0     # every tile of image 2 untouched


# ---------------------------------------------------------------------------
# the embedder and the network
# ---------------------------------------------------------------------------

EMBEDDER = dict(initial_features=8, growth_rate=8, batch_norm_size=2,
                block_config=(2, 2))


def embedder_inputs(seed):
    """A bank of four images and a BatchNorm mask that leaves one out."""
    xy, values, owner, starts = hit_bank(seed, counts=(30, 0, 25, 12))
    return xy, np.abs(values), owner, starts, np.array([True, True, False, True])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("inputs", ["coo", "image"])
def test_coo_densenet_matches_jax(inputs, train):
    xy, values, owner, starts, mask = embedder_inputs(11)
    B = len(starts) - 1
    coo_in = (jnp.asarray(xy), jnp.asarray(values), jnp.asarray(owner), B,
              jnp.asarray(starts))
    jax_net = JaxCooStemDenseNet(output_dim=12, image_height=H, image_width=W, **EMBEDDER)
    variables = random_variables(jax_net, 12, coo_in, jnp.asarray(mask), train=False)
    m = WeightMapper(variables)
    m.densenet("", "", EMBEDDER["block_config"])
    net = CooStemDenseNet(C_IN, 12, H, W, **EMBEDDER)
    net.load_state_dict(m.state_dict())

    if inputs == "coo":
        j_in, t_in = coo_in, (t(xy), t(values), t(owner), B, t(starts))
    else:
        image = np.zeros((B + 1, H, W, C_IN), np.float32)
        keep = (xy[:, 0] >= 0) & (xy[:, 0] < H) & (xy[:, 1] >= 0) & (xy[:, 1] < W)
        np.add.at(image, (owner[keep], xy[keep, 0], xy[keep, 1]), values[keep])
        j_in, t_in = jnp.asarray(image[:B]), t(image[:B])
    fn = jax.jit(lambda v: jax_net.apply(v, j_in, jnp.asarray(mask), train,
                                         mutable=["batch_stats"] if train else False))
    out = fn(variables)
    want, updated = (out if train else (out, None))
    net.train(train)
    with torch.no_grad():
        got = net(t_in, t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)
    if train:
        m2 = WeightMapper({"params": variables["params"],
                           "batch_stats": jax.device_get(updated["batch_stats"])})
        m2.densenet("", "", EMBEDDER["block_config"])
        sd = net.state_dict()
        stats = {k: v for k, v in m2.state_dict().items() if k.endswith(("mean", "var"))}
        assert len(stats) == 2 * 12     # stem, 4 bottlenecks x 2, transition, final, output
        for k, v in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **NET_TOL, err_msg=k)


def tiny_coo_config(**overrides):
    cfg = JaxModelConfig(
        hidden_dim=32, initial_feature_dim=8, initial_pixel_dim=8,
        feature_embedding_dim=8, pixel_embedding_dim=16, position_embedding_dim=8,
        num_encoder_layers=2, num_prong_decoder_layers=2, num_attention_heads=4,
        densenet_structure=(2, 2), densenet_growth_rate=8,
        dropout=0.0, pixel_noise_std=0.0, image_height=H, image_width=W,
        compute_dtype="float32", embedder="coo", **overrides)
    port = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    return cfg, port


class Scaled:
    """A dataset whose hit coordinates are scaled to ``H`` x ``W``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def gather_events(self, indices):
        raw = self.dataset.gather_events(indices)
        for key in ("event_coords", "prong_coords"):
            coords = raw[key].copy()
            coords[:, 1] = coords[:, 1] * H // 400
            coords[:, 2] = coords[:, 2] * W // 280
            raw[key] = coords
        return raw


@pytest.fixture(scope="module")
def coo_data(synthetic_file):
    ds = EventDataset(synthetic_file, limit_index=(0.0, 0.22), event_current_targets=True)
    ds.compute_statistics()
    norm = {"mean": ds.mean, "std": ds.std,
            "extra_mean": ds.extra_mean, "extra_std": ds.extra_std}
    batch = Batcher(Scaled(ds), batch_size=4, coo_granularity=512).build_batch(np.arange(4))
    return batch, norm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_coo_network_matches_jax(coo_data, train):
    batch, norm = coo_data
    cfg, port_cfg = tiny_coo_config(disable_smart_features=False)
    jax_model = JaxTransformerCVN(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    variables = random_variables(jax_model, 21, jb, jn, train=False)
    model = load_jax_variables(TransformerCVN(port_cfg), variables)
    assert isinstance(model.prong_embedding.event_pixel_embedding, CooStemDenseNet)

    out = jax.jit(partial(jax_model.apply, train=train,
                          mutable=["batch_stats"] if train else False))(variables, jb, jn)
    (want_event, want_prong), updated = out if train else (out, None)
    model.train(train)
    with torch.no_grad():
        got_event, got_prong = model(to_device(batch, "cpu"), to_device(norm, "cpu"))
    np.testing.assert_allclose(got_event.numpy(), np.asarray(want_event), **NET_TOL)
    np.testing.assert_allclose(got_prong.numpy(), np.asarray(want_prong), **NET_TOL)
    if train:
        want = state_dict_from_jax(
            {"params": variables["params"],
             "batch_stats": jax.device_get(updated["batch_stats"])}, port_cfg)
        got = model.state_dict()
        names = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(names) > 20
        for name in names:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **NET_TOL,
                                       err_msg=name)


def test_coo_logits_equal_dense_logits(coo_data):
    """One ``state_dict`` in both families: the stem is linear in its input,
    so the sparse stem over the hits equals the dense conv over the
    densified image (``tests/test_coo_embedder.py``'s bound)."""
    batch, norm = coo_data
    _, coo_cfg = tiny_coo_config(disable_smart_features=False)
    dense = TransformerCVN(dataclasses.replace(coo_cfg, embedder="dense"),
                           generator=torch.Generator().manual_seed(3))
    coo = TransformerCVN(coo_cfg)
    coo.load_state_dict(dense.state_dict())
    b, n = to_device(batch, "cpu"), to_device(norm, "cpu")
    for train in (False, True):
        dense.train(train)
        coo.train(train)
        with torch.no_grad():
            for got, want in zip(coo(b, n), dense(b, n)):
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)


def test_compiled_coo_steps_match_eager_and_jax(synthetic_file, monkeypatch):
    from test_torch_port_compile import check_compiled_steps

    torch._inductor.config.compile_threads = 1
    check_compiled_steps(synthetic_file, "coo", monkeypatch)
