"""The optimizers: the JAX package's optax chains with the reference's decay
rule, after global-norm clipping, at the scheduled learning rate.

Port of ``dune_transformercvn_tpu/train/optimizer.py``: ``adamw`` (the
option files' "AdamW"), ``adam``, ``sgd``, ``rmsprop``, ``adagrad``,
``lamb``, ``lars`` and ``lion``, with the reference's aliases
(``apex_adam`` -> adamw, ``apex_lamb`` -> lamb, ``apex_sgd`` -> sgd); an
unknown name falls back to AdamW with the JAX package's message.

* **Decay rule.**  Weight decay applies to every parameter whose JAX leaf
  is not named ``bias`` (the live reference excludes biases only).  So
  norm scales, PReLU alphas, position vectors and the coo stem's
  ``stem_bias``, whose leaf name is not ``bias``, are decayed.  The JAX
  names come from :func:`..from_jax.jax_leaf_names`; a rule on the port's
  own names would exempt the coo stem's ``conv0.bias``.  The parameters
  sit in two groups, decayed and not, and ``weight_decay`` is the masked
  ``add_decayed_weights`` of each chain.
* **Clipping** is optax's ``clip_by_global_norm``: ``g / ||g|| * max`` when
  ``||g|| >= max``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  one).
* **Learning rate.**  The train step sets ``group["lr"]`` to
  ``base_lr * schedule(step)`` before every update; each chain applies it
  where optax's ``scale_by_learning_rate`` sits (for lars, before the
  momentum, so the trace accumulates lr-scaled updates).
* **AdamW** is ``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8), which
  computes optax's ``adamw``: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd
  * p)``, with its bias corrections in float64 where optax's are float32
  (an update differs by up to 6.5e-6 of its size at the first steps).  The other seven are :class:`OptaxChain` subclasses that compute
  optax 0.2.6's chains with its defaults, not ``torch.optim``'s (rmsprop's
  decay 0.9 and adagrad's initial accumulator 0.1, each with its epsilon
  inside the square root; L2 decay added to the gradient before adam, sgd,
  rmsprop and adagrad).
* **Trust ratios** (lamb, lars) are per JAX leaf: a port parameter that
  packs several leaves along its first axis (the attention's q/k/v
  ``in_proj_weight`` / ``in_proj_bias``) takes one ratio per leaf
  (:func:`..from_jax.jax_leaf_splits`).
* **No host state in an update** (:class:`GraphSafe`): the seven chains
  and the graph-safe AdamW (:class:`GraphAdamW`, ``create_optimizer(...,
  graph=True)``) keep optax's step count (int32) and the learning rate as
  0-d tensors on the parameters' device and make their slots with the
  optimizer, so a CUDA graph captures an update and each replay reads the
  rate the host wrote (``train/step.py``'s ``graph=True``); eagerly they
  launch the same kernels.  The bias corrections are optax's float32
  ``1 - b ** count``, computed on the device.  A checkpoint keeps the
  count as an int in each saved param group (the chains) or as each
  parameter's ``step`` (AdamW's layout), and a restore copies into the
  live tensors, so a captured graph keeps reading them.
* optax updates every leaf, so a parameter that got no gradient gets a zero
  one here (its moments stay zero, its decay still applies).
* **Tensor parallelism** (``parallel.shard_parameters``): a sharded
  parameter's slots are made from it, so they are sharded alike (a packed
  ``in_proj`` holds whole heads of each of q, k and v); the optax
  chains update each rank's pieces, a trust ratio sums its norms' squares
  over the TP row, and :func:`global_norm` counts each sharded gradient
  once.  ``torch.optim.AdamW`` steps a mix of sharded and plain parameters
  under DTensor's ``implicit_replication`` (the train step enters it); the
  graph-safe AdamW steps each rank's pieces, as the chains do, so a CUDA
  graph of a tensor-parallel step captures plain kernels.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..from_jax import jax_leaf_names, jax_leaf_splits
from ..parallel.mesh import local, shard_like, shard_spec

_ALIASES = {"apex_adam": "adamw", "apex_lamb": "lamb", "apex_sgd": "sgd"}


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies."""
    return {name: leaf != "bias" for name, leaf in jax_leaf_names(model).items()}


def _decayed(g, p, group):
    """optax's ``add_decayed_weights`` of the group (0 where masked off)."""
    wd = group["weight_decay"]
    return g + wd * p if wd else g


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay ** count`` in float32, on ``count``'s device
    (``count``: a float32 0-d tensor): 0.999 is no float32, so at small
    counts this differs from the float64 value by up to 1.3e-5 of itself.
    On the CPU, ``torch.pow`` of 0-d float32 tensors gives XLA's bits at
    every count up to 2^17 (numpy's float32 power differs by an ulp from
    count 4 on; ``tests/test_torch_port_graph_chains.py``); the card's
    against the CPU's: ``tests/test_torch_port_cuda.py``."""
    return 1.0 - torch.pow(torch.full_like(count, decay), count)


def _adam(g, state, corrections, b1: float, b2: float, eps: float):
    """optax's ``scale_by_adam`` (eps outside the square root), its moments
    updated in place; ``corrections``: decay -> its bias correction."""
    mu, nu = state["mu"], state["nu"]
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
    mu_hat = mu / corrections[b1]
    nu_hat = nu / corrections[b2]
    return mu_hat / (nu_hat.sqrt() + eps)


def _trust_ratio(u, p, leaves: int, coefficient: float, shard=None):
    """optax's ``scale_by_trust_ratio`` on each of the ``leaves`` JAX leaves
    stacked along the first axis: ``u * c * ||p|| / ||u||``, ratio 1 where
    either norm is zero.  ``u`` and ``p`` are this rank's pieces of a
    parameter sharded as ``shard`` (:func:`..parallel.mesh.shard_spec`), or
    the whole of a plain one."""
    if shard is None:
        uv, pv = u.reshape(leaves, -1), p.reshape(leaves, -1)
        p_norm = torch.linalg.vector_norm(pv, dim=1, keepdim=True)
        u_norm = torch.linalg.vector_norm(uv, dim=1, keepdim=True)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                            coefficient * p_norm / u_norm)
        return (uv * ratio).reshape(u.shape)
    # each local row's leaf, by its row of the whole parameter
    rows = u.shape[0]
    local_rows = torch.arange(rows, device=u.device)
    whole_rows, whole_row = rows, local_rows
    if shard.dim == 0:
        # this rank's piece of each of the shard's blocks (q, k, v)
        block_rows = rows // shard.blocks
        whole_rows = rows * shard.count
        whole_row = ((local_rows // block_rows) * (whole_rows // shard.blocks)
                     + shard.index * block_rows + local_rows % block_rows)
    leaf = whole_row // (whole_rows // leaves)
    squares = torch.zeros(2, leaves, device=u.device, dtype=torch.float32)
    squares[0].index_add_(0, leaf, p.reshape(rows, -1).float().square().sum(1))
    squares[1].index_add_(0, leaf, u.reshape(rows, -1).float().square().sum(1))
    torch.distributed.all_reduce(squares, group=shard.group)
    p_norm, u_norm = squares.sqrt().to(u.dtype)
    ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                        coefficient * p_norm / u_norm)
    return u * ratio[leaf].reshape((rows,) + (1,) * (u.ndim - 1))


class GraphSafe(torch.optim.Optimizer):
    """An optimizer with no host state in its update: ``count`` (optax's
    step count, int32) and ``lr`` are 0-d tensors on the parameters'
    device, and the slots are made with the optimizer.  ``step(lr=t)``
    reads the rate from the tensor ``t`` (a graph's buffer the host fills
    before each replay); ``step()`` fills ``lr`` from ``group["lr"]``
    first, as the eager train step sets it."""

    def _make_scalars(self, lr: float) -> None:
        device = self.param_groups[0]["params"][0].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.lr = torch.full((), float(lr), device=device)

    def _advance(self, lr: torch.Tensor = None):
        """The step's rate and its count (float32), the count advanced."""
        if lr is None:
            lr = self.lr.fill_(self.param_groups[0]["lr"])
        self.count.add_(1)
        return lr, self.count.float()

    def _load_in_place(self, state_dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, then its slot tensors
        copied into the live ones, which stay in ``self.state``: a sharded
        parameter's (tensor parallelism) as this rank's piece of the whole
        tensor loaded."""
        live = {p: self.state[p] for group in self.param_groups for p in group["params"]}
        super().load_state_dict(state_dict)
        for p, tensors in live.items():
            for name, tensor in tensors.items():
                value = self.state[p][name]
                if shard_spec(value) is None:
                    value = shard_like(value, tensor)
                local(tensor).copy_(local(value))
            self.state[p] = tensors


class OptaxChain(GraphSafe):
    """One of the JAX package's optax chains.  Each group holds ``lr`` (the
    step's rate), ``weight_decay`` and ``count``: optax's step count, live
    the one device tensor ``self.count`` that every group holds, an int in
    the checkpoint's param groups;
    ``slots`` names each parameter's state tensors and their initial
    values, ``decays`` the decays whose bias corrections the update reads;
    ``leaves`` maps a parameter to the JAX leaves it packs.  Each
    subclass's ``update(p, g, state, group, lr, corrections, leaves)``
    gives the increment added to a parameter."""

    slots: Dict[str, float] = {}
    decays = ()

    def __init__(self, groups, lr: float, leaves: Dict[nn.Parameter, int]):
        super().__init__(groups, dict(lr=lr, weight_decay=0.0))
        self.leaves = leaves
        self._make_scalars(lr)
        self._share_count()
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {name: torch.full_like(p, value,
                                                       memory_format=torch.preserve_format)
                                 for name, value in self.slots.items()}

    @torch.no_grad()
    def step(self, closure=None, lr: torch.Tensor = None):
        lr, count = self._advance(lr)
        corrections = {decay: bias_correction(decay, count) for decay in self.decays}
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                pieces = {name: local(value) for name, value in self.state[p].items()}
                local(p).add_(self.update(local(p), local(g), pieces, group, lr, corrections,
                                          (self.leaves[p], shard_spec(p))))

    def state_dict(self):
        state = super().state_dict()
        count = int(self.count)
        state["param_groups"] = [{**group, "count": count} for group in state["param_groups"]]
        return state

    def load_state_dict(self, state_dict):
        self._load_in_place(state_dict)
        self.count.fill_(int(state_dict["param_groups"][0]["count"]))
        self._share_count()

    def _share_count(self) -> None:
        """Every group's ``count`` the live tensor: one count, never stale."""
        for group in self.param_groups:
            group["count"] = self.count


class Adam(OptaxChain):
    """``chain(add_decayed_weights(wd, mask), adam(lr))``."""

    slots = {"mu": 0.0, "nu": 0.0}
    decays = (0.9, 0.999)

    def update(self, p, g, state, group, lr, corrections, leaves):
        return -lr * _adam(_decayed(g, p, group), state, corrections, 0.9, 0.999, 1e-8)


class SGD(OptaxChain):
    """``chain(add_decayed_weights(wd, mask), sgd(lr))``: no momentum."""

    def update(self, p, g, state, group, lr, corrections, leaves):
        return -lr * _decayed(g, p, group)


class RMSprop(OptaxChain):
    """``chain(add_decayed_weights(wd, mask), rmsprop(lr))``: decay 0.9,
    ``g / sqrt(nu + 1e-8)``."""

    slots = {"nu": 0.0}

    def update(self, p, g, state, group, lr, corrections, leaves):
        g = _decayed(g, p, group)
        nu = state["nu"]
        nu.mul_(0.9).addcmul_(g, g, value=1 - 0.9)
        return -lr * (g * torch.rsqrt(nu + 1e-8))


class Adagrad(OptaxChain):
    """``chain(add_decayed_weights(wd, mask), adagrad(lr))``: the sum of
    squares starts at 0.1, ``g / sqrt(sum + 1e-7)``."""

    slots = {"sum_of_squares": 0.1}

    def update(self, p, g, state, group, lr, corrections, leaves):
        g = _decayed(g, p, group)
        total = state["sum_of_squares"]
        total.addcmul_(g, g)
        scale = torch.where(total > 0, torch.rsqrt(total + 1e-7), torch.zeros_like(total))
        return -lr * (scale * g)


class Lamb(OptaxChain):
    """``lamb(lr, weight_decay, mask)``: ``scale_by_adam(eps=1e-6)``, the
    masked decay, the trust ratio of each leaf, then ``-lr``."""

    slots = {"mu": 0.0, "nu": 0.0}
    decays = (0.9, 0.999)

    def update(self, p, g, state, group, lr, corrections, leaves):
        u = _decayed(_adam(g, state, corrections, 0.9, 0.999, 1e-6), p, group)
        return -lr * _trust_ratio(u, p, leaves[0], 1.0, leaves[1])


class Lars(OptaxChain):
    """``lars(lr, weight_decay, mask)``: the masked decay, a trust ratio on
    every leaf (coefficient 1e-3, eps 0), ``-lr``, then ``trace(0.9)``."""

    slots = {"trace": 0.0}

    def update(self, p, g, state, group, lr, corrections, leaves):
        u = -lr * _trust_ratio(_decayed(g, p, group), p, leaves[0], 1e-3, leaves[1])
        return state["trace"].mul_(0.9).add_(u)


class Lion(OptaxChain):
    """``lion(lr, weight_decay=wd, mask)``: ``sign(0.1 g + 0.9 m)``, then
    ``m = 0.01 g + 0.99 m``, the masked decay and ``-lr``."""

    slots = {"mu": 0.0}

    def update(self, p, g, state, group, lr, corrections, leaves):
        mu = state["mu"]
        u = torch.sign((1 - 0.9) * g + 0.9 * mu)
        mu.mul_(0.99).add_(g, alpha=1 - 0.99)
        return -lr * _decayed(u, p, group)


class GraphAdamW(GraphSafe):
    """optax's ``adamw`` (betas 0.9 / 0.999, eps 1e-8, the groups' masked
    decay) in ``_foreach_`` ops, with no host state in its update
    (:class:`GraphSafe`; the moments ``exp_avg`` / ``exp_avg_sq``).  Its
    checkpoint has ``torch.optim.AdamW``'s layout (the count as each
    parameter's ``step``), so either optimizer restores the other's;
    :meth:`load_state_dict` restores into the live tensors, so a captured
    graph keeps reading them."""

    betas = (0.9, 0.999)
    eps = 1e-8

    def __init__(self, groups, lr: float):
        super().__init__(groups, dict(lr=lr, betas=self.betas, eps=self.eps,
                                      weight_decay=0.0))
        self._make_scalars(lr)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {name: torch.zeros_like(p, memory_format=torch.preserve_format)
                                 for name in ("exp_avg", "exp_avg_sq")}

    @torch.no_grad()
    def step(self, closure=None, lr: torch.Tensor = None):
        lr, count = self._advance(lr)
        b1, b2 = self.betas
        c1, c2 = bias_correction(b1, count), bias_correction(b2, count)
        for group in self.param_groups:
            if not group["params"]:
                continue
            # each rank's pieces of sharded tensors: plain tensors, one
            # kernel list (no DTensor dispatch, nothing to redistribute)
            params = [local(p) for p in group["params"]]
            grads = [local(p.grad) for p in group["params"]]
            mu = [local(self.state[p]["exp_avg"]) for p in group["params"]]
            nu = [local(self.state[p]["exp_avg_sq"]) for p in group["params"]]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mu, c1)
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, params, alpha=group["weight_decay"])
            torch._foreach_mul_(update, lr)
            torch._foreach_sub_(params, update)

    def state_dict(self):
        state = super().state_dict()
        step = self.count.float().cpu()
        state["state"] = {i: {**slots, "step": step} for i, slots in state["state"].items()}
        return state

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        slots = {i: dict(s) for i, s in state_dict["state"].items()}
        steps = [s.pop("step") for s in slots.values() if "step" in s]
        state_dict["state"] = slots
        self._load_in_place(state_dict)
        if steps:
            self.count.copy_(steps[0].round())


CHAINS = {"adam": Adam, "sgd": SGD, "rmsprop": RMSprop, "adagrad": Adagrad,
          "lamb": Lamb, "lars": Lars, "lion": Lion}


def optimizer_name(options) -> str:
    """The optimizer ``options`` ask for, aliases resolved; a name the
    JAX package does not know falls back to AdamW with its message."""
    name = _ALIASES.get(options.optimizer.lower(), options.optimizer.lower())
    if name != "adamw" and name not in CHAINS:
        print(f"Unable to load desired optimizer: {options.optimizer}. "
              "Using AdamW as a default.")
        name = "adamw"
    return name


def graph_safe(optimizer) -> bool:
    """Whether a graph step can capture ``optimizer``'s update."""
    return isinstance(optimizer, GraphSafe)


def create_optimizer(options, model: nn.Module, graph: bool = False) -> torch.optim.Optimizer:
    """``options.optimizer`` over ``model``'s parameters in two groups,
    decayed and not, with ``lr`` set to the base rate (the train step scales
    it by the schedule before every update).  ``graph``: AdamW as the
    graph-safe :class:`GraphAdamW` (every optax chain is graph-safe)."""
    name = optimizer_name(options)
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if mask[n]],
         "weight_decay": options.l2_penalty},
        {"params": [p for n, p in params.items() if not mask[n]],
         "weight_decay": 0.0},
    ]
    if name == "adamw":
        if graph:
            return GraphAdamW(groups, options.learning_rate)
        return torch.optim.AdamW(groups, lr=options.learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    splits = jax_leaf_splits(model)
    return CHAINS[name](groups, options.learning_rate,
                        {p: splits[n] for n, p in params.items()})


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every gradient (float32 gradients), in
    a few multi-tensor launches rather than a few per parameter.  A sharded
    gradient counts once: its pieces' squares are summed over the TP row."""
    sharded = [g for g in grads if shard_spec(g) is not None]
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    squares = torch.stack(torch._foreach_norm([local(g) for g in sharded])).square().sum()
    torch.distributed.all_reduce(squares, group=shard_spec(sharded[0]).group)
    plain = [g for g in grads if shard_spec(g) is None]
    if plain:
        squares = squares + torch.stack(torch._foreach_norm(plain)).square().sum()
    return squares.sqrt()


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm`` in place, given the global ``norm``:
    ``g * (max_norm / norm)`` when ``norm >= max_norm``, else ``g`` (optax
    computes ``g / norm * max_norm``: the same to a float32 rounding)."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([local(g) for g in grads], scale)
