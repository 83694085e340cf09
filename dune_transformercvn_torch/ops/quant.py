"""Post-training int8 quantization of the inference path's convolutions.

Port of ``dune_transformercvn_tpu/ops/quant.py``: standard symmetric PTQ.

* **Weights**: per-output-channel symmetric int8, quantized from the float32
  parameters at each call (:func:`quantize_weight`).
* **Activations**: one symmetric int8 scale per conv input, calibrated by
  running a few batches through the float network and recording each conv
  input's max |x| (:func:`calibrate_activation_scales`).  A context holds
  each scale as a 0-d float32 tensor on the model's device, made when it is
  entered: a call reads no host value.
* **The product**: int8 x int8 with int32 accumulation, dequantized by
  ``s_w * s_x``, plus the bias, cast to the compute dtype
  (:func:`int8_conv`).  Two routes with one contract, chosen by the
  tensor's device: on the card an im2col plus ``torch._int_mm`` (int8 GEMM
  on cuBLASLt; the JAX package computes the same product with XLA's int8
  convolution, not a Pallas kernel); on the CPU the plain version,
  ``F.conv2d`` in float64 on the integer grid, which is exact and so equal
  to the int32 result.  The two are one custom op, ``tcvn::int8_conv``
  (:func:`int8_conv_op`), so ``torch.compile`` keeps the product in its
  graph and a CUDA graph records its GEMMs; its launch counter
  (``conv_int32_cuda.launches``) ticks where the route runs, and
  ``utils/graphs.py`` takes a capture's ticks back and adds them per replay.

Flax intercepts ``nn.Conv.__call__``; the port calls its convolutions
functionally, so :func:`quantized_convs` and the calibration set a context
that the conv helpers consult (:func:`intercept`, from
``models/densenet.py::conv_nhwc`` and ``models/sdxl.py::conv``).  The
context is process-wide state (``_STATE.active``), not a ``ContextVar``:
Dynamo reads a module attribute and guards on it, so a compiled forward
traced inside a context quantizes as the eager one does, as JAX's context
wraps ``model.apply`` inside ``jax.jit``.  The compiled and graph steps
serve the context they were made in (:func:`current`; ``predict.py``).  The
quantized set is JAX's: the ``nn.Conv2d`` modules that run through those
helpers, 2-D, ungrouped (the helpers never dilate).  The sparse families'
convolutions (``ops/sparse.py``, ``lax.conv`` in JAX), the s2d stem and the
coo family's sparse stem are no ``nn.Conv`` in JAX and run unchanged here.
A conv without a calibrated scale, or grouped, runs unchanged.  Keys are the
convs' module names in the port's ``state_dict``, as JAX reads its kernels by
module path: a copy of the model made inside a context (the BatchNorm-folded
copy of ``predict_split(fold_eval_bn=True)``) is bound to it by name
(:func:`bind`), and a conv of a model the context does not know raises
rather than run in float.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class _State:
    """The interceptor the conv helpers consult: None outside a context."""
    active = None


_STATE = _State()

# im2col chunks of at most this many bytes (int8 columns or int32 products)
IM2COL_CHUNK_BYTES = 1 << 30


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(int(e) for e in v)


def quantize_weight(weight: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of an OIHW weight
    (JAX reduces its HWIO kernel over the same three axes).  Returns
    ``(q int8, scale float32 [C_out])``."""
    w = weight.float()
    scale = w.abs().amax(dim=tuple(range(1, w.ndim))) / 127.0
    scale = scale.clamp(min=1e-12)
    q = torch.round(w / scale.reshape((-1,) + (1,) * (w.ndim - 1)))
    return q.clamp(-127, 127).to(torch.int8), scale


def scale_tensor(act_scale, device) -> torch.Tensor:
    """An activation scale (a float, or a 0-d tensor) as a 0-d float32
    tensor on ``device``."""
    if torch.is_tensor(act_scale):
        return act_scale.to(device=device, dtype=torch.float32)
    return torch.tensor(act_scale, dtype=torch.float32, device=device)


def quantize_activation(x: torch.Tensor, act_scale) -> torch.Tensor:
    """``clip(round(x / s_x), -127, 127)`` as int8, in float32 (``act_scale``
    a float or a 0-d float32 tensor on ``x``'s device)."""
    s_x = scale_tensor(act_scale, x.device)
    return torch.round(x.float() / s_x).clamp(-127, 127).to(torch.int8)


def conv_int32_plain(qx: torch.Tensor, qw: torch.Tensor, stride, padding) -> torch.Tensor:
    """int8 NHWC ``qx`` conv int8 OIHW ``qw`` -> int32 NHWC, as ``F.conv2d``
    in float64: every product and partial sum is an integer below 2^53, so
    the result is exact."""
    y = F.conv2d(qx.permute(0, 3, 1, 2).double(), qw.double(), None,
                 _pair(stride), _pair(padding))
    return y.permute(0, 2, 3, 1).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv_int32_cuda(qx: torch.Tensor, qw: torch.Tensor, stride, padding) -> torch.Tensor:
    """The same product on the card: im2col of ``qx`` (zero-padded,
    ``Tensor.unfold`` windows in (C, kh, kw) order, the OIHW weight's) and
    ``torch._int_mm`` against the weight as a column-major ``[K, C_out]``.
    ``_int_mm`` takes m > 16 and k, n multiples of 8: K and C_out are padded
    with zero columns (the 7x7 stem's K = 147 becomes 152) and a short M with
    zero rows.  Images are taken in chunks of at most IM2COL_CHUNK_BYTES of
    columns or products."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    co, ci, kh, kw = qw.shape
    n, h, w, _ = qx.shape
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    k, kp, np_ = ci * kh * kw, _round_up(ci * kh * kw, 8), _round_up(co, 8)
    weight = qw.new_zeros((np_, kp))
    weight[:co, :k] = qw.reshape(co, k)
    weight_t = weight.t()                                       # [Kp, Np], column-major
    per_image = ho * wo * max(kp, 4 * np_)
    chunk = max(1, IM2COL_CHUNK_BYTES // per_image)
    xp = F.pad(qx, (0, 0, pw, pw, ph, ph)) if ph or pw else qx
    out = torch.empty((n, ho, wo, co), dtype=torch.int32, device=qx.device)
    for i in range(0, n, chunk):
        part = xp[i:i + chunk]
        m = part.shape[0] * ho * wo
        # [n, ho, wo, C, kh, kw] windows -> [M, K] columns (a copy)
        cols = part.unfold(1, kh, sh).unfold(2, kw, sw).reshape(m, k)
        mp = m if m > 16 else 32
        if (mp, kp) == (m, k):
            a = cols
        else:
            a = qx.new_zeros((mp, kp))
            a[:m, :k] = cols
        y = torch._int_mm(a, weight_t)
        out[i:i + chunk] = y[:m, :co].reshape(part.shape[0], ho, wo, co)
    conv_int32_cuda.launches += 1
    return out


conv_int32_cuda.launches = 0   # convolutions run by this route (a few GEMMs each)


# The two routes as one op: the plain version for CPU tensors, the _int_mm
# route for CUDA tensors, and a fake that gives the output's shape.
@torch.library.custom_op("tcvn::int8_conv", mutates_args=(), device_types="cpu",
                         schema="(Tensor qx, Tensor qw, int[] stride, int[] padding) -> Tensor")
def int8_conv_op(qx, qw, stride, padding):
    """int32 NHWC sums of int8 ``qx`` conv int8 ``qw``: the plain route on
    the CPU, :func:`conv_int32_cuda` on the card."""
    return conv_int32_plain(qx, qw, stride, padding)


@int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(qx, qw, stride, padding):
    return conv_int32_cuda(qx, qw, stride, padding)


@int8_conv_op.register_fake
def _int8_conv_fake(qx, qw, stride, padding):
    (sh, sw), (ph, pw) = stride, padding
    n, h, w, _ = qx.shape
    co, _, kh, kw = qw.shape
    return qx.new_empty((n, (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1, co),
                        dtype=torch.int32)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              act_scale, stride=1, padding=0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 x int8 -> int32 convolution of NHWC ``x`` with an OIHW
    ``weight``, dequantized by ``s_w * s_x``, plus ``bias``, in
    ``out_dtype`` (default ``x``'s).  ``act_scale``: a float, or a 0-d
    float32 tensor on ``x``'s device.  CPU tensors take the plain route,
    CUDA tensors the ``_int_mm`` route (:func:`int8_conv_op`)."""
    s_x = scale_tensor(act_scale, x.device)
    qx = quantize_activation(x, s_x)
    qw, s_w = quantize_weight(weight)
    acc = int8_conv_op(qx, qw, list(_pair(stride)), list(_pair(padding)))
    y = acc.float() * (s_w * s_x)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)


class _Context:
    """The conv names of the context's model and of every copy of it bound
    with :func:`bind`, by the identity of each conv's weight parameter (held
    by weak reference, so a dead copy's ids cannot be taken for another's)."""

    def __init__(self, model: nn.Module):
        self.names: Dict[int, Tuple[str, weakref.ref]] = {}
        self.bind(model)

    def bind(self, model: nn.Module) -> None:
        self.names.update({id(conv.weight): (name, weakref.ref(conv.weight))
                           for name, conv in _convs(model).items()})

    def name(self, weight) -> Optional[str]:
        """The module name of the conv whose weight is ``weight``; None for a
        weight that is no parameter (the s2d stem's rearranged kernel).  A
        parameter of a model the context does not know raises: its convs
        would run in float with no word."""
        if not isinstance(weight, nn.Parameter):
            return None
        entry = self.names.get(id(weight))
        # under Dynamo the weight's id is guarded; a dead copy's id is not
        # checked there
        if entry is None or (not torch.compiler.is_compiling() and entry[1]() is not weight):
            raise RuntimeError(
                "a convolution of a model that this int8 context does not know ran "
                "inside it; quantized_convs(model, ...) quantizes `model`, and a copy "
                "of it must be bound with ops.quant.bind(copy)")
        return entry[0]


class _Quantize(_Context):
    """Runs each conv with a scale as :func:`int8_conv`."""

    def __init__(self, model: nn.Module, scales: Dict[str, torch.Tensor]):
        super().__init__(model)
        self.scales = scales   # conv module name -> 0-d float32 scale on the device

    def __call__(self, x, weight, bias, stride, padding, groups, out_dtype):
        name = self.name(weight)
        scale = None if name is None else self.scales.get(name)
        if scale is None or groups != 1:
            return None
        return int8_conv(x, weight, bias, scale, stride, padding, out_dtype)


class _Record(_Context):
    """Records each conv's input max |x| and lets it run."""

    def __init__(self, model: nn.Module):
        super().__init__(model)
        self.maxima: Dict[str, torch.Tensor] = {}

    def __call__(self, x, weight, bias, stride, padding, groups, out_dtype):
        name = self.name(weight)
        if name is not None:
            m = x.detach().float().abs().amax()
            prev = self.maxima.get(name)
            self.maxima[name] = m if prev is None else torch.maximum(prev, m)
        return None


def current():
    """The active context (its interceptor), or None: what a compiled or
    graph step is keyed on, so that a step made in one context never runs
    in another."""
    return _STATE.active


def active() -> bool:
    """Whether a quantization or calibration context is active (the conv
    helpers ask before they lay out an input for :func:`intercept`)."""
    return _STATE.active is not None


def check_context(made_in, what: str) -> None:
    """Raise unless the active context is ``made_in`` (:func:`current` when
    ``what`` was made): a compiled or captured step of float convs must not
    run inside an int8 context, nor one of int8 convs outside it."""
    if _STATE.active is not made_in:
        raise RuntimeError(
            f"{what} was made {'outside' if made_in is None else 'inside'} an int8 "
            "context (ops.quant.quantized_convs) and is called "
            f"{'outside it' if _STATE.active is None else 'inside another'}; make the "
            "step where it runs")


def intercept(x, weight, bias, stride, padding, groups, out_dtype) -> Optional[torch.Tensor]:
    """Called by the conv helpers with NHWC ``x`` and the conv's weight
    parameter: the int8 result when a :func:`quantized_convs` context
    quantizes this conv, else None (the helper runs its float conv)."""
    active = _STATE.active
    if active is None:
        return None
    return active(x, weight, bias, stride, padding, groups, out_dtype)


def bind(model: nn.Module) -> None:
    """Inside a :func:`quantized_convs` or calibration context, let the
    convs of ``model``, a copy of the context's model (``ops.fold.folded_copy``
    binds its folded copy), run as the context's convs of the same module
    names.  Outside a context it does nothing."""
    active = _STATE.active
    if active is not None:
        active.bind(model)


@contextlib.contextmanager
def _active(interceptor):
    previous, _STATE.active = _STATE.active, interceptor
    try:
        yield interceptor
    finally:
        _STATE.active = previous


def _convs(model: nn.Module) -> Dict[str, nn.Conv2d]:
    return {name: m for name, m in model.named_modules() if isinstance(m, nn.Conv2d)}


def _check_device(model: nn.Module, device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (torch.cuda.is_available() is False); "
                           "pass device='cpu' to run the int8 convolutions on the CPU")
    on = next(model.parameters()).device
    if on.type != device.type:
        raise ValueError(f"the model's parameters are on {on}, not on {device}")
    return device


# model -> {(its scales, device): the context's interceptor}
_CONTEXTS: "weakref.WeakKeyDictionary[nn.Module, Dict]" = weakref.WeakKeyDictionary()


@contextlib.contextmanager
def quantized_convs(model: nn.Module, act_scales: Mapping[str, float], device=None):
    """Context: every conv of ``model`` whose module name has a calibrated
    scale > 0 in ``act_scales`` runs as an int8 convolution; the others run
    unchanged.  ``device`` (``None``: the card, which must be there) is
    where the model lives; its parameters must be there.  The scales go to
    the device once: entering again with the same model and the same scale
    values enters the same context (:func:`current`), whose compiled and
    graph steps are reused."""
    _check_device(model, device)
    on = next(model.parameters()).device
    scales = {name: float(act_scales[name]) for name in _convs(model)
              if name in act_scales and act_scales[name] > 0}
    kept = _CONTEXTS.setdefault(model, {})
    key = (tuple(sorted(scales.items())), on)
    if key not in kept:
        kept[key] = _Quantize(model, {name: scale_tensor(value, on)
                                      for name, value in scales.items()})
    with _active(kept[key]):
        yield


def make_calibration_fn(model: nn.Module):
    """Returns ``fn(batch, norm) -> {conv name: max |x| (0-d tensor)}``: one
    eval-mode forward that records each conv input's max |x|.  Feed it a few
    representative batches and take the per-conv max."""

    def calibrate(batch, norm):
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), _active(_Record(model)) as rec:
                model(batch, norm)
            return rec.maxima
        finally:
            model.train(was_training)

    return calibrate


def calibrate_activation_scales(model: nn.Module, batches: Iterable[Mapping],
                                norm: Mapping, *, headroom: float = 1.0) -> Dict[str, float]:
    """Run ``batches`` (the ``Batcher``'s, numpy or tensors) through the
    float network on its device and return per-conv activation scales
    ``max|x| * headroom / 127``."""
    from ..predict import to_device

    device = next(model.parameters()).device
    calibrate = make_calibration_fn(model)
    norm_t = to_device(norm, device)
    maxima: Dict[str, float] = {}
    for batch in batches:
        for key, value in calibrate(to_device(batch, device), norm_t).items():
            maxima[key] = max(maxima.get(key, 0.0), float(value))
    return {key: (value * headroom) / 127.0 for key, value in maxima.items() if value > 0.0}
