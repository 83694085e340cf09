"""The port's int8 post-training quantization (``ops/quant.py``) against the
JAX package's (``dune_transformercvn_tpu/ops/quant.py``), on the CPU, where
the port's int8 product is its plain version (``F.conv2d`` in float64 on
the integer grid; the card's ``torch._int_mm`` route is held to it in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).

* ``quantize_weight``: the int8 weights array-equal to JAX's, the scales
  within rtol 1e-7;
* ``int8_conv`` against JAX's ``int8_conv`` (atol 1e-5, rtol 1e-5) for a
  1x1, a 3x3 pad 1, the 7x7 stride-2 pad-3 stem and a strided 3x3;
* the calibrated scales: the same convs as JAX's after the name mapping of
  ``from_jax``, the same values within rtol 1e-4 (float32 activations of
  two frameworks), for the dense family (NHWC helper) and sdxl (NCHW);
* quantized predictions against JAX's quantized predictions, with the same
  scales: probabilities within 1e-3 and the same argmax.  Not tighter,
  because a value at a rounding tie of the int8 grid may land one level
  apart between the frameworks' float32 activations;
* quantized against float within JAX's own bounds (< 0.05, argmax equal);
* with no scale a conv is bit-equal to the float one; a grouped conv falls
  through; without CUDA, ``quantized_convs`` with no device raises;
* folding and int8 compose: ``predict_split(fold_eval_bn=True)`` inside the
  context quantizes the folded copy it makes, bit-equal to quantizing a
  model folded beforehand, and a copy the context was not told of raises;
* int8 in one dispatch a batch: ``predict_split`` inside the context with
  ``compile=True`` (Inductor, one graph: static batch shapes) and with
  ``graph=True`` (uncaptured on the CPU) against JAX's jitted int8 predict
  (``quantized_convs`` inside ``jax.jit``, as ``tools/int8_drift.py`` runs
  it) on the same batches, within the bound of the eager comparison above
  (atol 1e-3, the same argmax); the compiled against the eager int8 step
  within the same bound, the graph body equal to it;
* no stale step: the graph predict step kept on a model is keyed on
  ``(compile, quant.current())``, so one made with float convs is replaced
  inside a context and the reverse; a compiled or graph step made in one
  context raises in another before it runs anything;
* ``torch.library.opcheck`` on ``tcvn::int8_conv`` with CPU tensors.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dune_transformercvn_tpu.models import TransformerCVN as JaxTransformerCVN
from dune_transformercvn_tpu.ops.quant import calibrate_activation_scales as jax_calibrate
from dune_transformercvn_tpu.ops.quant import int8_conv as jax_int8_conv
from dune_transformercvn_tpu.ops.quant import quantize_weight as jax_quantize_weight
from dune_transformercvn_tpu.ops.quant import quantized_convs as jax_quantized_convs
from dune_transformercvn_torch.from_jax import load_jax_variables, map_jax_variables
from dune_transformercvn_torch.data import Batcher
from dune_transformercvn_torch.models import TransformerCVN
from dune_transformercvn_torch.models.densenet import conv_nhwc
from dune_transformercvn_torch.ops import quant
from dune_transformercvn_torch.ops.quant import (calibrate_activation_scales, int8_conv,
                                                 quantize_weight, quantized_convs)
from dune_transformercvn_torch.ops.fold import fold_eval_batchnorm
from dune_transformercvn_torch.predict import (graph_predict_step, make_predict_step,
                                               predict_split, to_device)
from _torch_families import batches_and_norm, family_configs  # same-dir helpers
from test_torch_port_network import data, random_variables, tiny_config  # noqa: F401

torch.set_num_threads(2)
torch._inductor.config.compile_threads = 1

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE_TOL = dict(rtol=1e-4, atol=0.0)


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)      # HWIO
    kernel[..., 3] = 0.0                                            # the 1e-12 floor
    q_want, s_want = jax.device_get(jax.jit(jax_quantize_weight)(kernel))
    q, s = quantize_weight(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().transpose(2, 3, 1, 0), q_want)
    np.testing.assert_allclose(s.numpy(), s_want, rtol=1e-7)


# (kernel, C_in, C_out, stride, padding): 1x1, 3x3 pad 1, the 7x7/2 stem, strided
CONVS = {"1x1": (1, 12, 16, 1, 0), "3x3": (3, 16, 8, 1, 1),
         "stem": (7, 3, 16, 2, 3), "strided": (3, 8, 16, 2, 0)}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_int8_conv_matches_jax(case):
    k, cin, cout, stride, padding = CONVS[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(2, 19, 13, cin)).astype(np.float32)
    kernel = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    scale = float(np.abs(x).max() / 127.0)
    mod = nn.Conv(cout, (k, k), strides=(stride, stride), padding=padding,
                  dtype=jnp.float32)
    want = jax.device_get(jax.jit(lambda x, w, b: jax_int8_conv(x, w, b, mod, scale))(
        x, kernel, bias))
    got = int8_conv(torch.from_numpy(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(bias), scale, stride, padding, torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


def jax_to_port_names(variables, cfg):
    """JAX conv module path -> the port's conv module name."""
    sources = map_jax_variables(variables, cfg).sources
    return {src[0][len("params/"):-len("/kernel")]: name[:-len(".weight")]
            for name, src in sources.items()
            if name.endswith(".weight") and len(src) == 1 and src[0].endswith("/kernel")}


def setup_family(batch, norm, cfg, port_cfg, seed):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    jax_model = JaxTransformerCVN(cfg)
    variables = random_variables(jax_model, seed, jb, jn, train=False)
    model = load_jax_variables(TransformerCVN(port_cfg), variables).eval()
    return jax_model, variables, model, jb, jn


def check_scales_match_jax(jax_model, variables, model, jb, jn, batch, norm):
    want = jax_calibrate(jax_model, variables, [jb], jn)
    got = calibrate_activation_scales(model, [batch], norm)
    names = jax_to_port_names(variables, model.cfg)
    assert want and {names[k] for k in want} == set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[names[key]], value, **SCALE_TOL, err_msg=key)
    return want, got, names


@pytest.fixture(scope="module")
def dense(data):
    _, batch, norm = data
    cfg, port_cfg = tiny_config()
    jax_model, variables, model, jb, jn = setup_family(batch, norm, cfg, port_cfg, 41)
    want, got, names = check_scales_match_jax(jax_model, variables, model, jb, jn,
                                              batch, norm)
    return jax_model, variables, model, jb, jn, batch, norm, want, got, names


def test_calibration_matches_jax_dense(dense):
    *_, want, got, names = dense
    # every conv of the network: stem, bottlenecks, transitions, both embedders
    assert len(got) == 2 * (1 + 2 * 4 + 1)


def test_calibration_matches_jax_sdxl(synthetic_file):
    cfg, port_cfg = family_configs("sdxl")
    (batch,), norm = batches_and_norm(synthetic_file, "sdxl")
    _, _, names = check_scales_match_jax(*setup_family(batch, norm, cfg, port_cfg, 42),
                                         batch, norm)
    assert any("conv_shortcut" in n for n in names.values())


def forward_probs(model, batch, norm):
    with torch.no_grad():
        ev, pr = model(to_device(batch, "cpu"), to_device(norm, "cpu"))
    return torch.softmax(ev, -1).numpy(), torch.softmax(pr, -1).numpy()


def jax_int8_predict(jax_model, scales):
    """JAX's int8 predict: the context inside ``jax.jit``
    (``tools/int8_drift.py``)."""

    @jax.jit
    def predict_q(v, b, n):
        with jax_quantized_convs(v["params"], scales):
            ev, pr = jax_model.apply(v, b, n, train=False)
        return jax.nn.softmax(ev, -1), jax.nn.softmax(pr, -1)

    return predict_q


def test_quantized_predict_matches_jax(dense):
    jax_model, variables, model, jb, jn, batch, norm, want, _, names = dense
    jax_ev, jax_pr = jax.device_get(jax_int8_predict(jax_model, want)(variables, jb, jn))
    with quantized_convs(model, {names[k]: v for k, v in want.items()}, device="cpu"):
        ev, pr = forward_probs(model, batch, norm)
    real = batch["prong_mask"]
    np.testing.assert_allclose(ev, jax_ev, atol=1e-3)
    np.testing.assert_allclose(pr[real], jax_pr[real], atol=1e-3)
    np.testing.assert_array_equal(ev.argmax(-1), jax_ev.argmax(-1))
    np.testing.assert_array_equal(pr[real].argmax(-1), jax_pr[real].argmax(-1))


def test_quantized_close_to_float(dense):
    *_, model, _, _, batch, norm, _, got, _ = dense
    ev, pr = forward_probs(model, batch, norm)
    with quantized_convs(model, got, device="cpu"):
        ev_q, pr_q = forward_probs(model, batch, norm)
    assert np.isfinite(ev_q).all() and np.isfinite(pr_q).all()
    assert np.abs(ev_q - ev).max() < 0.05 and np.abs(pr_q - pr).max() < 0.05
    np.testing.assert_array_equal(ev_q.argmax(-1), ev.argmax(-1))
    assert not np.array_equal(ev_q, ev)            # the int8 route did run


def test_no_scale_is_bit_equal(dense):
    *_, model, _, _, batch, norm, _, _, _ = dense
    ev, pr = forward_probs(model, batch, norm)
    with quantized_convs(model, {}, device="cpu"):
        ev_q, pr_q = forward_probs(model, batch, norm)
    np.testing.assert_array_equal(ev_q, ev)
    np.testing.assert_array_equal(pr_q, pr)


class Depthwise(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(8, 8, 3, padding=1, groups=8)

    def forward(self, x):
        c = self.conv
        return conv_nhwc(x, c.weight, c.bias, x.dtype, 1, c.padding, c.groups)


def test_unsupported_conv_falls_through():
    module = Depthwise()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 8, 8, 8)).astype(np.float32))
    want = module(x)
    with quantized_convs(module, {"conv": 0.1}, device="cpu"):
        got = module(x)
    assert torch.equal(got, want)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with quantized_convs(Depthwise(), {"conv": 0.1}):
            pass
    with pytest.raises(ValueError, match="parameters are on cpu"):
        with quantized_convs(Depthwise(), {"conv": 0.1}, device="meta"):
            pass


def test_fold_and_int8_compose(dense, data):
    *_, model, _, _, batch, norm, _, got, _ = dense
    dataset = data[0]
    folded = copy.deepcopy(model)
    folded.load_state_dict(fold_eval_batchnorm(model.state_dict())[0])

    def predict(m, fold):
        return predict_split(m, dataset, norm, 4, "cpu", fold_eval_bn=fold)

    with quantized_convs(folded, got, device="cpu"):
        want = predict(folded, False)
    with quantized_convs(model, got, device="cpu"):
        out = predict(model, True)
        with pytest.raises(RuntimeError, match="does not know"):
            forward_probs(copy.deepcopy(model), batch, norm)
    for key, value in want.items():
        np.testing.assert_array_equal(out[key], value, err_msg=key)
    # the int8 route ran on the folded copy
    assert not np.array_equal(out["event_probabilities"],
                              predict(model, True)["event_probabilities"])


def assert_int8_close(got, want, what):
    """Probabilities within 1e-3 and the same argmax (the eager int8
    comparison's bound, ``test_quantized_predict_matches_jax``)."""
    for key in ("event_probabilities", "prong_probabilities"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3, err_msg=(what, key))
        np.testing.assert_array_equal(got[key].argmax(-1), want[key].argmax(-1),
                                      err_msg=(what, key))


def jax_predict_split(jax_model, variables, scales, dataset, norm, batch_size):
    """JAX's jitted int8 predict over the batches ``predict_split`` lays out
    (static shapes), trimmed and masked as it trims and masks them."""
    predict_q = jax_int8_predict(jax_model, scales)
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    batcher = Batcher(dataset, batch_size=batch_size, coo_granularity=8192,
                      drop_last=False, fixed_shape=True)
    events, prongs, seen = [], [], 0
    for batch in batcher.epoch(0):
        ev, pr = jax.device_get(predict_q(variables, {k: jnp.asarray(v) for k, v in
                                                      batch.items()}, jn))
        take = min(batch_size, len(dataset) - seen)
        events.append(ev[:take])
        prongs.append(pr[:take][batch["prong_targets"][:take] >= 0])
        seen += take
    return {"event_probabilities": np.concatenate(events),
            "prong_probabilities": np.concatenate(prongs)}


def test_int8_in_one_dispatch_matches_jax(dense, data):
    """``predict_split`` inside the int8 context with ``compile=True`` (one
    Inductor graph, the int8 product ``tcvn::int8_conv`` inside it) and with
    ``graph=True`` (the graph body, uncaptured on the CPU) against JAX's
    jitted int8 predict, and against the eager int8 step."""
    jax_model, variables, model, *_, norm, want, _, names = dense
    dataset = data[0]
    scales = {names[k]: v for k, v in want.items()}
    run = {}
    with quantized_convs(model, scales, device="cpu"):
        for mode in ("eager", "compile", "graph"):
            run[mode] = predict_split(model, dataset, norm, 4, "cpu", fixed_shape=True,
                                      compile=mode == "compile", graph=mode == "graph")
    jax_run = jax_predict_split(jax_model, variables, want, dataset, norm, 4)
    for mode, out in run.items():
        assert_int8_close(out, jax_run, mode)
    assert_int8_close(run["compile"], run["eager"], "compiled against eager")
    for key, value in run["eager"].items():
        np.testing.assert_array_equal(run["graph"][key], value, err_msg=key)
    # the int8 route ran: the float predictions differ
    floats = predict_split(model, dataset, norm, 4, "cpu", fixed_shape=True)
    assert not np.array_equal(floats["event_probabilities"],
                              run["eager"]["event_probabilities"])


def test_no_step_runs_in_another_context(dense):
    """The graph predict steps kept on a model are keyed on the context:
    inside a context a float step is not used, outside it an int8 step is
    not, nor one context's step in another's (other scales); entering
    again with the same scales is the same context, whose step is kept; a
    compiled or graph step made in one context raises in another before it
    runs (nothing compiles here)."""
    *_, model, _, _, batch, norm, _, got, _ = dense
    floats = graph_predict_step(model, False, 1)
    assert floats.key == (False, None)
    assert graph_predict_step(model, False, 1) is floats
    doubled = {k: 2 * v for k, v in got.items()}
    with quantized_convs(model, got, device="cpu"):
        context = quant.current()
        int8 = graph_predict_step(model, False, 1)
        assert int8 is not floats and int8.key == (False, context)
        assert graph_predict_step(model, False, 1) is int8
        with pytest.raises(RuntimeError, match="made outside an int8 context"):
            floats(to_device(batch, "cpu"), to_device(norm, "cpu"))
        compiled = make_predict_step(model, compile=True)
        with quantized_convs(model, doubled, device="cpu"):
            other = graph_predict_step(model, False, 1)
            assert other.key == (False, quant.current()) and quant.current() is not context
            with pytest.raises(RuntimeError, match="inside another"):
                compiled(to_device(batch, "cpu"), to_device(norm, "cpu"))
    assert quant.current() is None
    with pytest.raises(RuntimeError, match="called outside it"):
        int8(to_device(batch, "cpu"), to_device(norm, "cpu"))
    assert graph_predict_step(model, False, 1) is floats
    with quantized_convs(model, dict(got), device="cpu"):
        assert quant.current() is context
        # the other context's step went when this one's came back
        assert graph_predict_step(model, False, 1) is not int8


def test_int8_conv_op_passes_opcheck():
    rng = np.random.default_rng(3)
    qx = torch.from_numpy(rng.integers(-127, 128, (2, 9, 7, 5)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (6, 5, 3, 3)).astype(np.int8))
    torch.library.opcheck(quant.int8_conv_op, (qx, qw, [2, 1], [1, 0]))
    out = quant.int8_conv_op(qx, qw, [2, 1], [1, 0])
    assert out.dtype == torch.int32 and out.shape == (2, 5, 5, 6)
    assert torch.equal(out, quant.conv_int32_plain(qx, qw, (2, 1), (1, 0)))
