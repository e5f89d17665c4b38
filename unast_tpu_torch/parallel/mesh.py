"""The device mesh, the ZeRO state-sharding rule and the data-parallel
train step of the port, mirroring the dp part of
`unast_tpu/parallel/mesh.py`.

JAX shards one program over a mesh and lets GSPMD insert the collectives.
Torch runs one process per device, so the dp axis is a process group, and
the train step keeps GSPMD's semantics by hand: each rank runs the step on
its share of the global batch's rows with every mean, normaliser and
BatchNorm statistic taken over the global batch (parallel/collectives.py),
its gradients are summed over the ranks (an all-reduce), and the update is
that of the global batch. The step computes the global batch's losses and
update, not a mean of per-rank steps.

  - dp: the batch dimension (dim 1 of the stacked micro-batches [n, B,
    ...]) split over the ranks.
  - ZeRO (`zero=`), over the dp ranks, as in JAX: zero=1 shards the
    optimizer state (Adam's moments, Adafactor's statistics, the params'
    EMA): each rank keeps its 1/dp slice of every leaf that splits and
    updates only that slice, then the updated params are all-gathered;
    zero=3 shards the params at rest too: they are gathered ONCE at step
    start (never at each use inside cm's decode loops) and the new params
    are sliced back at its end. The gradient is reduced by an all-reduce
    whose every rank then keeps its slice (gloo has no reduce-scatter);
    the global norm of the clip is taken over the whole gradient. The
    update of an Adam slice is elementwise, so it equals the slice of the
    whole update; Adafactor's factored statistics need the whole leaf, so
    under ZeRO its (small) state is gathered for the update and sliced
    back. The BatchNorm state stays replicated.
  - The leaf a rank slices, and along which dim, is JAX's rule
    (`_add_dp`): the largest dp-divisible dim that the tp rule
    (`_spec_for`, whose tp and ep axes take their dims even at size 1)
    leaves free; a leaf that does not split stays replicated.

tp, sp, ep and pp (the megatron splits, the sharded time axis, the expert
axis, GPipe) come with the next slice (ROADMAP.md queue 1 item 7c):
make_mesh raises NotImplementedError for them.
"""

import re
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..train.optim import ParamsEma, apply_updates
from ..train.steps import make_train_step
from . import collectives as C

NEXT_SLICE = "ROADMAP.md queue 1 item 7c"


def make_mesh(dp: int, tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1):
    """unast_tpu/parallel/mesh.py::make_mesh for dp alone: a
    torch.distributed DeviceMesh of one 'dp' dimension over the dp ranks
    of the initialized process group (multihost.
    maybe_initialize_distributed), whose world size must be dp. Its device
    type is the backend's: 'cuda' under NCCL, 'cpu' under gloo (also when
    gloo carries CUDA tensors, as two ranks sharing one card do). tp, sp,
    ep or pp above 1 raise NotImplementedError."""
    later = [f"{k}={v}" for k, v in (("tp", tp), ("sp", sp), ("ep", ep),
                                     ("pp", pp)) if v > 1]
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: the port's mesh has only the dp axis; "
            f"tp, sp, ep and pp come with the next slice ({NEXT_SLICE})")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel/multihost.py::maybe_initialize_distributed)")
    if dist.get_world_size() != dp:
        raise ValueError(f"dp={dp} but the process group has "
                         f"{dist.get_world_size()} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (dp,), mesh_dim_names=("dp",))


def dp_group(mesh):
    """The dp process group of a mesh."""
    return mesh.get_group("dp")


def dp_rank(mesh) -> int:
    return mesh.get_local_rank("dp")


def dp_size(mesh) -> int:
    return mesh["dp"].size()


# Column-split (output dim over tp): attention q/k/v, FFN up-projections
# (dense lin1, conformer macaron 'up' halves, conformer conv pointwise-in).
_COL_W = re.compile(r"(^|/)(q|k|v|lin1|up|conv_pw1)/w$")
_COL_B = re.compile(r"(^|/)(q|k|v|lin1|up|conv_pw1)/b$")
# Row-split (input dim over tp): attention out-proj, FFN down-projections.
_ROW_W = re.compile(r"(^|/)(out|lin2|down|conv_pw2)/w$")
# Expert-stacked MoE FFN weights: leading [E] axis over 'ep'.
_MOE = re.compile(r"(^|/)moe/(lin1|lin2)/(w|b)$")


def _spec_for(path: str, shape) -> list:
    """unast_tpu/parallel/mesh.py::_spec_for as a list of axis names (or
    None) per dim; the ep axis is a mesh axis only when ep > 1, so with the
    dp-only mesh it is None, as in JAX."""
    ndim = len(shape)
    spec = [None] * ndim
    m = _MOE.search(path)
    if m:
        kind, wb = m.group(2), m.group(3)
        if wb == "w" and ndim == 3:
            spec[2 if kind == "lin1" else 1] = "tp"
        elif wb == "b" and ndim == 2 and kind == "lin1":
            spec[1] = "tp"
        return spec
    if ndim == 2:
        if _COL_W.search(path):
            spec[1] = "tp"
        elif _ROW_W.search(path):
            spec[0] = "tp"
    if ndim == 1 and _COL_B.search(path):
        spec[0] = "tp"
    return spec


def zero_dim(path: str, shape, dp: int) -> Optional[int]:
    """unast_tpu/parallel/mesh.py::_add_dp on top of _spec_for: the dim of
    a leaf at `path` of `shape` that ZeRO splits over dp ranks (the
    largest still-unsharded dp-divisible one, the lower index on a tie), or
    None when none splits (the leaf stays replicated)."""
    spec = _spec_for(path, shape)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] >= dp and shape[i] % dp == 0:
            return i
    return None


# ---------------------------------------------------------------------------
# Trees with NamedTuples (train states, optimizer states)
# ---------------------------------------------------------------------------


def _map(fn, tree, *rest, path=""):
    """fn(path, leaf, *rest leaves) over a tree of dicts, lists, tuples and
    NamedTuples; paths join keys, indices and field names with '/'."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=f"{path}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                                 path=f"{path}{f}/") for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest), path=f"{path}{i}/")
                          for i, v in enumerate(tree))
    return fn(path.rstrip("/"), tree, *rest)


def _leaves(tree, *rest):
    out = []
    _map(lambda _, *xs: out.append(xs), tree, *rest)
    return out


def train_state_shardings(mesh, ts, zero: int = 0) -> Any:
    """unast_tpu/parallel/mesh.py::train_state_shardings for the dp axis: a
    tree of ts's structure holding, per tensor leaf, the dim ZeRO splits
    over the dp ranks, or None for a replicated leaf (every non-tensor
    leaf too). zero=1: the optimizer states' leaves; zero=3: the params'
    too. The BN state stays replicated."""
    dp = dp_size(mesh) if mesh is not None else 1

    def rule(split):
        return lambda path, x: (zero_dim(path, tuple(x.shape), dp)
                                if split and torch.is_tensor(x) and x.ndim >= 1
                                and dp > 1 else None)

    if not hasattr(ts, "_replace"):
        return _map(rule(False), ts)
    return type(ts)(**{
        f: _map(rule(bool(zero) and (f in ("gen_opt", "disc_opt")
                                     or (f == "params" and zero >= 3))),
                getattr(ts, f), path=f"{f}/")
        for f in ts._fields})


def batch_shardings(mesh, batches) -> Any:
    """unast_tpu/parallel/mesh.py::batch_shardings as this rank's slice of
    stacked micro-batches [n, B, ...]: rows [r*B/dp, (r+1)*B/dp) of the B
    axis of every leaf of 2 or more dims; other leaves are kept whole."""
    r, n = dp_rank(mesh), dp_size(mesh)

    def take(_, x):
        if not torch.is_tensor(x) or x.ndim < 2:
            return x
        if x.shape[1] % n:
            raise ValueError(f"batch of {x.shape[1]} rows does not divide over dp={n}")
        k = x.shape[1] // n
        return x[:, r * k:(r + 1) * k]
    return _map(take, batches)


class DataParallel:
    """The data-parallel half of a sharded train step: the dp group, this
    rank, the ZeRO level and the split dims of each TrainState field
    (train_state_shardings). make_train_step(cfg, args, dp=...) calls it
    to gather the params at step start, reduce the gradients and the
    metrics, update the optimizer states' slices and slice the params
    back at step end."""

    def __init__(self, mesh, ts, zero: int = 0):
        if zero not in (0, 1, 3):
            raise ValueError(f"zero must be 0, 1 or 3, got {zero}")
        self.mesh, self.zero = mesh, zero
        self.group = dp_group(mesh)
        self.rank, self.size = dp_rank(mesh), dp_size(mesh)
        self.dims = train_state_shardings(mesh, ts, zero)

    # -- slicing and gathering ------------------------------------------

    def shard(self, tree, dims, copy: bool = False):
        """Each split leaf's slice of this rank (contiguous copies with
        `copy`, views otherwise); replicated leaves as they are."""
        def take(_, x, d):
            if d is None:
                return x
            k = x.shape[d] // self.size
            s = x.narrow(d, self.rank * k, k)
            return s.contiguous().clone() if copy else s
        return _map(take, tree, dims)

    def gather(self, tree, dims):
        """The whole leaves of a tree of this rank's slices: one all_gather
        per dtype over every split leaf, flattened into one buffer."""
        parts = [(x, d) for x, d in _leaves(tree, dims)
                 if d is not None and torch.is_tensor(x)]
        whole = {}
        for dtype in {x.dtype for x, _ in parts}:
            group = [(x, d) for x, d in parts if x.dtype == dtype]
            flat = torch.cat([x.reshape(-1) for x, _ in group])
            every = C.all_gather(flat[None], self.group).reshape(self.size, -1)
            off = 0
            for x, d in group:
                n = x.numel()
                whole[id(x)] = torch.cat(
                    [every[r, off:off + n].reshape(x.shape) for r in range(self.size)],
                    dim=d)
                off += n

        def put(_, x, d):
            return whole[id(x)] if d is not None and torch.is_tensor(x) else x
        return _map(put, tree, dims)

    def all_reduce(self, tensors: list) -> list:
        """The sums over the ranks of a list of tensors, one all_reduce per
        dtype over their flattened concatenation."""
        out = list(tensors)
        for dtype in {t.dtype for t in tensors}:
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = C.all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]),
                                self.group)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].reshape(tensors[i].shape)
                off += n
        return out

    # -- the step's hooks -------------------------------------------------

    def params_in(self, params):
        """The params a step computes with: gathered under zero=3."""
        return self.gather(params, self.dims.params) if self.zero >= 3 else params

    def params_out(self, params):
        """The params a step keeps at rest: sliced under zero=3."""
        return (self.shard(params, self.dims.params, copy=True)
                if self.zero >= 3 else params)

    def update(self, tx, opt_dims, grads, opt_state, params, norm):
        """(new whole params, new optimizer state) of one update of `tx`
        (train/optim.py's Optimizer, or ParamsEma around one) from the
        global gradient `grads`, whose global norm is `norm`. zero=0: the
        replicated update. zero>=1: an Adam chain updates this rank's
        slices (its state holds only those) and the params are
        all-gathered; an Adafactor chain gathers its state, updates the
        whole leaves and keeps its slices."""
        if self.zero == 0:
            u, state = tx.update(grads, opt_state, params, norm)
            return apply_updates(params, u), state
        inner = tx.inner if isinstance(tx, ParamsEma) else tx
        if inner.optim_type == "adafactor":
            whole = self.gather(opt_state, opt_dims)
            u, state = tx.update(grads, whole, params, norm)
            return apply_updates(params, u), self.shard(state, opt_dims, copy=True)
        pdims = (opt_dims.inner if isinstance(tx, ParamsEma) else opt_dims).mu
        g, p = self.shard(grads, pdims), self.shard(params, pdims)
        u, state = tx.update(g, opt_state, p, norm)
        return self.gather(apply_updates(p, u), pdims), state

    # -- whole states -----------------------------------------------------

    def place(self, ts):
        """ts (whole, the same on every rank) as this rank keeps it at
        rest: its slices of the split leaves."""
        return type(ts)(**{f: self.shard(getattr(ts, f), getattr(self.dims, f),
                                         copy=True) for f in ts._fields})

    def whole(self, ts):
        """The whole TrainState of the ranks' slices (a collective: every
        rank calls it), for a checkpoint or an evaluation."""
        return type(ts)(**{f: self.gather(getattr(ts, f), getattr(self.dims, f))
                           for f in ts._fields})


def state_bytes(tree) -> int:
    """Bytes of the tensor leaves of a tree (a rank's optimizer state)."""
    return sum(x.numel() * x.element_size() for (x,) in _leaves(tree)
               if torch.is_tensor(x))


def shard_train_step(train_step, mesh, ts, example_batches=None, zero: int = 0):
    """unast_tpu/parallel/mesh.py::shard_train_step: (sharded step, ts
    placed) for `train_step`, a train/steps.py::make_train_step step, over
    the mesh's dp ranks. Every rank calls the sharded step with its own
    torch.Generator (the caller gives each rank its own stream, as
    train/loop.py does) and its share of the global batch (batch_shardings
    of it, or the rank's own rows); the step returns this rank's TrainState
    (its slices under ZeRO) and the global batch's metrics, the same on
    every rank. `example_batches` is not needed (torch traces nothing
    ahead) and is accepted for the JAX signature. zero in {0, 1, 3}."""
    cfg, args = train_step.config
    plan = DataParallel(mesh, ts, zero)
    return make_train_step(cfg, args, dp=plan), plan.place(ts)
