"""Optimizers and LR schedules of the port, mirroring
`unast_tpu/train/optim.py` and the optax chains it builds, term for term, as
plain tensor code over param dicts (no torch.optim): global-norm clipping;
then Adam's moments with bias correction and decayed weights (after Adam
for adamw, before it for adam), or Adafactor's factored second moments
(optax.scale_by_factored_rms) with block-RMS clipping and decayed
weights; then -lr from the schedule at the chain's own step count.
ParamsEma appends the JAX package's params_ema: an exponential moving
average of the updated params, kept in the optimizer state.

The generator and the discriminator are two optimizers over disjoint
partitions of the param tree (split_params), each stepped once an outer
step, as in JAX.
"""

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..parallel import collectives as C

B1, B2, EPS = 0.9, 0.999, 1e-8
# optax.scale_by_factored_rms defaults (unast_tpu/train/optim.py uses them)
FACTOR_DECAY, FACTOR_MIN_DIM, FACTOR_EPS = 0.8, 128, 1e-30


# ---------------------------------------------------------------------------
# Trees of tensors (nested dicts and lists)
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """fn over the tensor leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The tensor leaves of a tree, in tree_map's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_paths(tree, prefix: str = ""):
    """{'a/0/w': leaf} of a tree: each leaf under its '/'-joined keys and
    list indices."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}{k}/"))
    return out


# ---------------------------------------------------------------------------
# Schedules (multiplier on the base lr, LambdaLR semantics)
# ---------------------------------------------------------------------------


def multistep_schedule(base_lr: float, milestones, gamma: float):
    """unast_tpu/train/optim.py::multistep_schedule: lr *= gamma at each
    milestone step."""
    ms = sorted(milestones)
    return lambda step: base_lr * gamma ** sum(step >= m for m in ms)


def linear_warmup_decay_schedule(base_lr: float, warmup_steps: int,
                                 total_steps: int):
    """unast_tpu/train/optim.py::linear_warmup_decay_schedule: linear warmup
    to base_lr, then linear decay to 0."""
    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        return base_lr * max(0.0, (total_steps - step)
                             / max(1.0, total_steps - warmup_steps))
    return fn


def transformer_schedule(base_lr: float, warmup_steps: int):
    """unast_tpu/train/optim.py::transformer_schedule: step / warmup^1.5
    during warmup, then 1 / sqrt(step)."""
    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(1.0, float(warmup_steps) ** 1.5)
        return base_lr / math.sqrt(max(1.0, step))
    return fn


def make_schedule(args) -> Callable[[int], float]:
    """unast_tpu/train/optim.py::make_schedule: lr as a function of the
    optimizer's step count."""
    sched = getattr(args, "sched_type", "transformer")
    lr = args.lr
    if sched == "multistep":
        ms = [m * args.epoch_steps for m in args.lr_milestones]
        return multistep_schedule(lr, ms, args.lr_gamma)
    if sched == "linear":
        return linear_warmup_decay_schedule(
            lr, args.warmup_steps, args.epochs * args.epoch_steps)
    if sched == "transformer":
        return transformer_schedule(lr, args.warmup_steps)
    return lambda step: lr


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


class OptState(NamedTuple):
    """The Adam chain's state: its step count (that of optax's scale_by_adam
    and scale_by_schedule, which move together) and Adam's two moments."""
    count: int
    mu: Any
    nu: Any


class FactoredState(NamedTuple):
    """The Adafactor chain's state (optax.FactoredState): its step count and,
    per leaf, the row and column second moments of a factored leaf, or the
    full second moment of one that is not factored; the unused ones are
    zeros of shape [1], as in optax."""
    count: int
    v_row: Any
    v_col: Any
    v: Any


class EmaState(NamedTuple):
    """ParamsEma's state (unast_tpu/train/optim.py::EmaState after the
    inner chain's): the inner optimizer's state and the params' EMA."""
    inner: Any
    ema: Any


def global_norm(tree, axes=None) -> torch.Tensor:
    """unast_tpu/train/optim.py::global_norm: sqrt of the sum of squares of
    every leaf, in float32. axes: under a model-parallel mesh, per leaf (in
    tree_leaves order) the axes it is split over (parallel/mesh.py's
    MeshPlan); the squares of a split leaf are then summed over those
    axes' ranks (parallel/collectives.py's active axes), and a replicated
    leaf counts once."""
    squares = [(x.float() ** 2).sum() for x in tree_leaves(tree)]
    if axes is None:
        return torch.sqrt(sum(squares))
    return torch.sqrt(C.reduce_grouped(squares, axes))


def _factored_dims(shape):
    """optax's _factored_dims with factored=True: the two largest axes
    (numpy's argsort order, so equal sizes pick as optax does), or None
    when the second largest is under FACTOR_MIN_DIM or the leaf is 1-D."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _factored_init(p):
    dims = _factored_dims(tuple(p.shape))
    one = p.new_zeros((1,))
    if dims is None:
        return one, one, torch.zeros_like(p)
    d1, d0 = dims
    shape = list(p.shape)
    row = shape[:d0] + shape[d0 + 1:]
    col = shape[:d1] + shape[d1 + 1:]
    return p.new_zeros(row), p.new_zeros(col), one


def _factored_update(g, v_row, v_col, v, count):
    """optax.scale_by_factored_rms's update of one leaf at step `count`:
    (update, v_row, v_col, v)."""
    # optax's _decay_rate_pow, in float32 as there
    decay = np.float32(1) - np.float32(count + 1) ** np.float32(-FACTOR_DECAY)
    keep, take = float(decay), float(np.float32(1) - decay)
    dims = _factored_dims(tuple(g.shape))
    g2 = g * g + FACTOR_EPS
    one = g.new_zeros((1,))
    if dims is None:
        v = keep * v + take * g2
        return g * v ** -0.5, one, one, v
    d1, d0 = dims
    v_row = keep * v_row + take * g2.mean(dim=d0)
    v_col = keep * v_col + take * g2.mean(dim=d1)
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
    col_factor = v_col ** -0.5
    return (g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1),
            v_row, v_col, one)


class Optimizer:
    """unast_tpu/train/optim.py::make_optimizer's optax chain for one param
    partition, as init(params) -> state and update(grads, state, params)
    -> (updates, state); apply_updates adds the updates."""

    def __init__(self, optim_type: str, weight_decay: float, grad_clip: float,
                 schedule: Callable[[int], float]):
        if optim_type not in ("adam", "adamw", "adafactor"):
            raise ValueError(f"unknown optim_type {optim_type}")
        self.optim_type = optim_type
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.schedule = schedule

    def init(self, params):
        if self.optim_type == "adafactor":
            parts = [_factored_init(p) for p in tree_leaves(params)]
            return FactoredState(0, *(tree_unflatten(params, list(x))
                                      for x in zip(*parts)))
        return OptState(0, tree_map(torch.zeros_like, params),
                        tree_map(torch.zeros_like, params))

    def update(self, grads, state, params, norm=None):
        """norm: the gradient's global norm for the clip when `grads` is a
        part of the gradient (a ZeRO shard, parallel/mesh.py); None
        computes it from `grads`."""
        g = grads
        if self.grad_clip > 0:      # optax.clip_by_global_norm
            if norm is None:
                norm = global_norm(g)
            if not bool(norm < self.grad_clip):
                g = tree_map(lambda t: t / norm.to(t.dtype) * self.grad_clip, g)
        wd = self.weight_decay
        if self.optim_type == "adam" and wd:   # torch Adam's L2, before the moments
            g = tree_map(lambda t, p: t + wd * p, g, params)
        if self.optim_type == "adafactor":
            u, state = self._adafactor(g, state)
        else:
            u, state = self._adam(g, state)
        if self.optim_type != "adam" and wd:   # optax.add_decayed_weights
            u = tree_map(lambda t, p: t + wd * p, u, params)
        # optax.scale_by_schedule(-schedule), at the count before this step
        step_size = -float(torch.tensor(self.schedule(state.count - 1),
                                        dtype=torch.float32))
        u = tree_map(lambda t: t * step_size, u)
        return u, state

    def _adam(self, g, state: OptState):
        """optax.scale_by_adam."""
        count = state.count + 1
        mu = tree_map(lambda t, m: (1 - B1) * t + B1 * m, g, state.mu)
        nu = tree_map(lambda t, v: (1 - B2) * t * t + B2 * v, g, state.nu)
        c1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** count
        c2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** count
        u = tree_map(lambda m, v: (m / c1.to(m.device)) /
                     (torch.sqrt(v / c2.to(v.device)) + EPS), mu, nu)
        return u, OptState(count, mu, nu)

    def _adafactor(self, g, state: FactoredState):
        """optax.scale_by_factored_rms, then optax.clip_by_block_rms(1.0):
        each leaf's update divided by max(1, its RMS)."""
        out = [_factored_update(*xs, state.count) for xs in zip(
            tree_leaves(g), tree_leaves(state.v_row), tree_leaves(state.v_col),
            tree_leaves(state.v))]
        u, v_row, v_col, v = (tree_unflatten(g, list(x)) for x in zip(*out))
        u = tree_map(lambda t: t / torch.clamp(torch.sqrt((t * t).mean()), min=1.0), u)
        return u, FactoredState(state.count + 1, v_row, v_col, v)


class ParamsEma:
    """optax.chain(inner, unast_tpu/train/optim.py::params_ema(decay)): the
    inner optimizer's updates pass through untouched, and the state keeps
    an EMA of the updated params, decay * ema + (1 - decay) * new params,
    started from a copy of the params."""

    def __init__(self, inner, decay: float):
        self.inner = inner
        self.decay = decay

    def init(self, params) -> EmaState:
        return EmaState(self.inner.init(params), tree_map(torch.clone, params))

    def update(self, grads, state: EmaState, params, norm=None):
        u, inner = self.inner.update(grads, state.inner, params, norm)
        new_p = apply_updates(params, u)
        d = self.decay
        ema = tree_map(lambda e, p: d * e + (1.0 - d) * p, state.ema, new_p)
        return u, EmaState(inner, ema)


def find_ema(opt_state):
    """unast_tpu/train/optim.py::find_ema: the EMA param tree of an
    optimizer state, or None when it has none."""
    return opt_state.ema if isinstance(opt_state, EmaState) else None


def make_optimizer(args, schedule=None) -> Optimizer:
    """unast_tpu/train/optim.py::make_optimizer: grad_clip > 0 clips by the
    global norm first; adam or adamw with b1 0.9, b2 0.999, eps 1e-8, or
    adafactor (factored RMS, block-RMS clip 1.0)."""
    schedule = schedule or make_schedule(args)
    return Optimizer(getattr(args, "optim_type", "adamw"),
                     getattr(args, "weight_decay", 0.0) or 0.0,
                     getattr(args, "grad_clip", 0.0) or 0.0, schedule)


def apply_updates(params, updates):
    """optax.apply_updates: params + updates, leaf by leaf."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def split_params(params):
    """unast_tpu/train/optim.py::split_params: (generator params,
    discriminator params or None)."""
    gen = {k: v for k, v in params.items() if k != "discriminator"}
    return gen, params.get("discriminator")
