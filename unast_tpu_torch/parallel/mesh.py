"""The device mesh, the sharding rules and the sharded train steps of the
port, mirroring `unast_tpu/parallel/mesh.py` for the dp, tp, ep, sp and pp
axes.

JAX shards one program over a mesh and lets GSPMD insert the collectives.
Torch runs one process per device, so each mesh axis is a process group
and the steps keep GSPMD's semantics by hand (parallel/collectives.py):

  - dp: the batch dimension (dim 1 of the stacked micro-batches [n, B,
    ...], dim 0 of a family step's flat batch) split over the dp ranks.
    Each rank runs the step on its rows with every mean, normaliser and
    BatchNorm statistic taken over the global batch, its gradients are
    summed over the dp ranks, and the update is that of the global batch.
  - tp: megatron's split of each transformer layer (_spec_for): q/k/v,
    lin1, up and conv_pw1 (with their biases) by columns, out, lin2, down
    and conv_pw2 by rows. Each rank keeps its slice of those params and of
    their optimizer state; the model code attends with the rank's heads
    and all-reduces the row splits' partial sums (collectives.copy_to /
    reduce_from). conv_pw1 feeds a GLU, so its slice takes the matching
    parts of both halves (models/conformer.py). A leaf whose tp dim does
    not divide stays replicated (the RNN attention's v/w [attn_dim, 1];
    GSPMD pads it).
  - ep: the MoE expert stacks' leading [E] axis (models/moe.py); each ep
    rank computes its experts on its dp shard's tokens and the combine is
    all-reduced over ep.
  - ZeRO (`zero=`), over the dp ranks on top of the tp and ep slices, as
    JAX's _add_dp: zero=1 shards the optimizer state (Adam's moments,
    Adafactor's statistics, the params' EMA): each rank keeps its 1/dp
    slice of every leaf that splits and updates only that slice, then the
    updated params are all-gathered; zero=3 shards the params at rest too:
    they are gathered ONCE at step start (never at each use inside cm's
    decode loops) and the new params are sliced back at its end. The
    gradient is reduced by an all-reduce whose every rank then keeps its
    slice (gloo has no reduce-scatter); the global norm of the clip is
    taken over the whole gradient. The update of an Adam slice is
    elementwise, so it equals the slice of the whole update; Adafactor's
    factored statistics and block-RMS clip need the whole leaf, so under
    ZeRO or a model split its (small) state, the gradient and the params
    are gathered for the update and sliced back. The BatchNorm state
    stays replicated.

  - sp: the time axis. Each sp rank of a dp coordinate takes the dp
    rows whole (batch_shardings: the denoising noise, SpecAugment and the
    decoders' right shift act on whole sequences) and the model splits
    them at its prenets: the encoders and teacher-forced decoders run on
    the rank's T/sp frames, attention gathers K and V, the convs exchange
    halos, BatchNorm takes its statistics over dp x sp and the MoE layers
    group the global batch's tokens (models/moe.py); their outputs are
    gathered whole (models/networks.py, parallel/collectives.py), so the
    greedy decodes, the losses and the discriminator run on whole
    sequences, the same on every sp rank, and each rank differentiates
    1/sp of them (train/steps.py). The gradients are summed over dp x sp.
    A checkpointed layer (remat) recomputes inside the region it ran in
    (models/transformer.py::_ckpt). The RNN backbone opens no region: its
    recurrences run on whole sequences, replicated over sp, as GSPMD runs
    a lax.scan over a time-sharded axis (models/networks.py). Params and
    optimizer state stay replicated over sp, as in JAX.
  - pp: GPipe stages of the transformer stacks (parallel/pipeline.py):
    each pp rank runs L/pp layers of every pipelined stack; everything
    else runs replicated on every pp rank, and the pipeline's backward
    leaves every gradient whole on each (a tp rank's: its slices), so
    they are summed over dp (x sp) alone. Inside a stage the layers run
    their tp all-reduces and sp gathers among the ranks of the stage's pp
    coordinate; an MoE stack runs unstaged, its experts over ep, as in
    JAX. Params and optimizer state stay replicated over pp, as JAX's
    train_state_shardings keeps them at rest.

The axes combine as in JAX: check_mesh refuses only what JAX refuses.
The tp, ep, sp and pp ranks of one dp group hold the same rows and the
same dropout stream (the loop seeds it from the dp coordinate), so every
replicated activation is the same on each of them; a split activation's
dropout draws the whole mask and keeps the rank's slice (nn.dropout).
The family steps (shard_family_step) shard over dp and tp only, as JAX's
(tests/test_sharded_families.py).
"""

import dataclasses
import math
import re
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..train.optim import (ParamsEma, apply_updates, global_norm, tree_leaves,
                           tree_unflatten)
from . import collectives as C


def make_mesh(dp: int, tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1):
    """unast_tpu/parallel/mesh.py::make_mesh: a torch.distributed DeviceMesh
    over the initialized process group (multihost.
    maybe_initialize_distributed), whose world size must be dp * tp * ep *
    sp * pp, laid out row-major over ('dp', 'tp'[, 'ep'][, 'sp'][, 'pp'])
    as JAX's (each of the last three only when above 1): rank r's
    coordinates are JAX's device r's. Its device type is the backend's:
    'cuda' under NCCL, 'cpu' under gloo (also when gloo carries CUDA
    tensors, as ranks sharing one card do)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel/multihost.py::maybe_initialize_distributed)")
    if dist.get_world_size() != dp * tp * ep * sp * pp:
        raise ValueError(f"dp={dp} x tp={tp} x ep={ep} x sp={sp} x pp={pp} but "
                         f"the process group has {dist.get_world_size()} ranks")
    dims = mesh_dims(dp, tp, sp, ep, pp)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(n for _, n in dims),
                            mesh_dim_names=tuple(k for k, _ in dims))


def mesh_dims(dp: int, tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1):
    """make_mesh's axes as [(name, size)], in JAX's order: 'dp', 'tp', then
    'ep', 'sp' and 'pp' where above 1. Rank r sits at index r of the
    row-major layout of these sizes."""
    return [("dp", dp), ("tp", tp)] + [(k, n) for k, n in (
        ("ep", ep), ("sp", sp), ("pp", pp)) if n > 1]


def joint_group(mesh, names):
    """The process group over the mesh's axes `names` (those it has) for
    this rank's coordinates on the others, or None when they hold one
    rank: every rank makes every such group, in one order (a
    collective)."""
    names = [n for n in names if axis_size(mesh, n) > 1]
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    order = [mesh.mesh_dim_names.index(n) for n in names]
    rest = [i for i in range(len(mesh.mesh_dim_names)) if i not in order]
    rows = mesh.mesh.permute(rest + order).reshape(
        -1, math.prod(axis_size(mesh, n) for n in names))
    mine = None
    for row in rows.tolist():
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


def axis_size(mesh, name: str) -> int:
    """The size of the mesh's axis `name`; 1 when it has none."""
    return mesh[name].size() if name in mesh.mesh_dim_names else 1


def mesh_axis(mesh, name: str) -> Optional[C.Axis]:
    """The axis `name` of the mesh as this rank sees it (collectives.Axis),
    or None when the mesh has none or it has size 1."""
    if axis_size(mesh, name) == 1:
        return None
    return C.Axis(mesh.get_group(name), mesh.get_local_rank(name),
                  axis_size(mesh, name))


def dp_group(mesh):
    """The dp process group of a mesh."""
    return mesh.get_group("dp")


def dp_rank(mesh) -> int:
    return mesh.get_local_rank("dp")


def dp_size(mesh) -> int:
    return axis_size(mesh, "dp")


# Column-split (output dim over tp): attention q/k/v, FFN up-projections
# (dense lin1, conformer macaron 'up' halves, conformer conv pointwise-in).
_COL_W = re.compile(r"(^|/)(q|k|v|lin1|up|conv_pw1)/w$")
_COL_B = re.compile(r"(^|/)(q|k|v|lin1|up|conv_pw1)/b$")
# Row-split (input dim over tp): attention out-proj, FFN down-projections.
_ROW_W = re.compile(r"(^|/)(out|lin2|down|conv_pw2)/w$")
# Expert-stacked MoE FFN weights: leading [E] axis over 'ep'.
_MOE = re.compile(r"(^|/)moe/(lin1|lin2)/(w|b)$")
# conv_pw1 feeds a GLU: its tp slice takes the matching part of each half
_HALVES = re.compile(r"(^|/)conv_pw1/(w|b)$")


def _spec_for(path: str, shape, ep_axis: bool = False) -> list:
    """unast_tpu/parallel/mesh.py::_spec_for as a list of axis names (or
    None) per dim; with ep_axis (the mesh has an ep axis above 1) the MoE
    stacks' leading dim is 'ep', else None, as in JAX."""
    ndim = len(shape)
    spec = [None] * ndim
    m = _MOE.search(path)
    if m:
        ep = "ep" if ep_axis else None
        kind, wb = m.group(2), m.group(3)
        if wb == "w" and ndim == 3:
            spec[0] = ep
            spec[2 if kind == "lin1" else 1] = "tp"
        elif wb == "b" and ndim == 2:
            spec[0] = ep
            if kind == "lin1":
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


def zero_dim(path: str, shape, dp: int, ep_axis: bool = False) -> Optional[int]:
    """unast_tpu/parallel/mesh.py::_add_dp on top of _spec_for: the dim of
    a leaf at `path` of `shape` (the whole leaf's) that ZeRO splits over dp
    ranks (the largest still-unsharded dp-divisible one, the lower index on
    a tie), or None when none splits (the leaf stays replicated)."""
    spec = _spec_for(path, shape, ep_axis)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] >= dp and shape[i] % dp == 0:
            return i
    return None


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf's model-parallel split: ((dim, axis name), ...) over the
    mesh's tp and ep axes, and whether its tp slice takes the matching
    part of each of its two halves (conv_pw1). An empty `dims` is a
    replicated leaf. A leaf of the trees below (not a tuple)."""
    dims: tuple = ()
    halves: bool = False

    @property
    def axes(self) -> tuple:
        return tuple(a for _, a in self.dims)


REPLICATED = Split()


def split_rule(path: str, shape, tp: int, ep: int) -> Split:
    """The port's tp / ep split of the whole leaf at `path` of `shape`:
    _spec_for's dims whose axis has size above 1; a tp dim that does not
    divide stays replicated (GSPMD pads it); an ep dim that does not
    divide raises ValueError (the experts are whole)."""
    dims = []
    for i, a in enumerate(_spec_for(path, shape, ep_axis=ep > 1)):
        n = {"tp": tp, "ep": ep}.get(a, 1)
        if n == 1:
            continue
        halves = a == "tp" and bool(_HALVES.search(path))
        if shape[i] % (2 * n if halves else n):
            if a == "ep":
                raise ValueError(f"{path}: {shape[i]} experts do not divide "
                                 f"over ep={ep}")
            continue
        dims.append((i, a))
    return Split(tuple(dims), bool(_HALVES.search(path)) and
                 any(a == "tp" for _, a in dims))


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
    too. The BN state stays replicated. The tp and ep splits of the same
    leaves are model_shardings'."""
    dp = axis_size(mesh, "dp")
    ep_axis = axis_size(mesh, "ep") > 1

    def rule(split):
        return lambda path, x: (zero_dim(path, tuple(x.shape), dp, ep_axis)
                                if split and torch.is_tensor(x) and x.ndim >= 1
                                and dp > 1 else None)

    if not hasattr(ts, "_replace"):
        return _map(rule(False), ts)
    return type(ts)(**{
        f: _map(rule(bool(zero) and (f in ("gen_opt", "disc_opt")
                                     or (f == "params" and zero >= 3))),
                getattr(ts, f), path=f"{f}/")
        for f in ts._fields})


def model_shardings(mesh, tree, prefix: str = "") -> Any:
    """The tp and ep splits of a tree's tensor leaves (split_rule by path,
    `prefix` leading each path), as a tree of Split."""
    tp, ep = axis_size(mesh, "tp"), axis_size(mesh, "ep")
    return _map(lambda path, x: (split_rule(path, tuple(x.shape), tp, ep)
                                 if torch.is_tensor(x) and x.ndim >= 1
                                 else REPLICATED), tree, path=prefix)


def batch_shardings(mesh, batches, dim: int = 1) -> Any:
    """unast_tpu/parallel/mesh.py::batch_shardings as this rank's slice of
    stacked micro-batches [n, B, ...]: rows [r*B/dp, (r+1)*B/dp) of the B
    axis of every leaf of 2 or more dims, r the rank's dp coordinate (its
    tp, ep, sp and pp peers take the same rows); other leaves are kept
    whole. JAX also splits the time axis over 'sp' here; an sp rank takes
    its rows' whole sequences instead and the model splits them after the
    whole-sequence noise, SpecAugment and right shift (models/
    networks.py). dim=0 slices a family step's flat batch [B, ...] (every
    leaf of 1 or more dims)."""
    r, n = dp_rank(mesh), dp_size(mesh)

    def take(_, x):
        if not torch.is_tensor(x) or x.ndim < dim + 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"batch of {x.shape[dim]} rows does not divide over dp={n}")
        k = x.shape[dim] // n
        return x.narrow(dim, r * k, k)
    return _map(take, batches)


def _narrow(x, dim: int, n: int, r: int, halves: bool = False):
    """Rank r's 1/n slice of x along dim; with `halves`, the matching
    slice of each half, joined."""
    if halves:
        h = x.shape[dim] // 2
        return torch.cat([_narrow(x.narrow(dim, i * h, h), dim, n, r)
                          for i in (0, 1)], dim=dim)
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k)


def _join(parts, dim: int, halves: bool = False):
    """The whole of the ranks' slices `parts` (in rank order) along dim;
    with `halves`, each slice holds a part of each half."""
    if halves:
        h = parts[0].shape[dim] // 2
        return torch.cat([p.narrow(dim, i * h, h) for i in (0, 1) for p in parts],
                         dim=dim)
    return torch.cat(parts, dim=dim)


class MeshPlan:
    """The sharded half of a sharded train step: the mesh's dp, tp and ep
    axes, the ZeRO level, the ZeRO dim of each TrainState leaf
    (train_state_shardings: `dims`) and its tp / ep split (model_shardings:
    `splits`). make_train_step(cfg, args, plan=...) and the family steps
    call it to gather the params at step start, reduce the gradients and
    the metrics over dp, take the global norm, update the optimizer
    states' slices and slice the params back at step end; place and whole
    move a whole state to the ranks' slices and back."""

    def __init__(self, mesh, ts, zero: int = 0):
        if zero not in (0, 1, 3):
            raise ValueError(f"zero must be 0, 1 or 3, got {zero}")
        if zero and not hasattr(ts, "gen_opt"):
            raise ValueError("ZeRO shards a joint TrainState (gen_opt, "
                             "disc_opt); a family step takes zero=0")
        self.mesh, self.zero = mesh, zero
        self.size = dp_size(mesh)
        self.group = dp_group(mesh) if self.size > 1 else None
        self.rank = dp_rank(mesh) if self.size > 1 else 0
        self.tp, self.ep = mesh_axis(mesh, "tp"), mesh_axis(mesh, "ep")
        self.sp, self.pp = mesh_axis(mesh, "sp"), mesh_axis(mesh, "pp")
        # the gradients' group: dp x sp (an sp rank's share is its frames;
        # a pp rank's gradients are whole after the pipeline's backward,
        # a tp or ep rank's its slices, summed with the same slices)
        self.grad_group = (joint_group(mesh, ("dp", "sp")) if self.sp
                           else self.group)
        self.dims = train_state_shardings(mesh, ts, zero)
        self.splits = model_shardings(mesh, ts)

    def axes(self):
        """The collectives context of a step on this mesh (a with-block):
        the dp group of the global-batch reductions (none at dp 1), dp x sp
        in a time-split region, and the tp, ep, sp and pp axes."""
        return C.mesh_axes(dp=self.group, tp=self.tp, ep=self.ep, sp=self.sp,
                           pp=self.pp, dp_sp=self.grad_group)

    @property
    def model_split(self) -> bool:
        return self.tp is not None or self.ep is not None

    # -- slicing and gathering over dp (ZeRO) ------------------------------

    def shard(self, tree, dims, copy: bool = False):
        """Each ZeRO-split leaf's dp slice of this rank (contiguous copies
        with `copy`, views otherwise); replicated leaves as they are."""
        def take(_, x, d):
            if d is None:
                return x
            s = _narrow(x, d, self.size, self.rank)
            return s.contiguous().clone() if copy else s
        return _map(take, tree, dims)

    def gather(self, tree, dims):
        """The whole leaves (over dp) of a tree of this rank's slices."""
        parts = [(x, (d, "dp", False)) for x, d in _leaves(tree, dims)
                 if d is not None and torch.is_tensor(x)]
        whole = self._gather(parts)
        return _map(lambda _, x, d: whole.get(id(x), x), tree, dims)

    # -- slicing and gathering over tp and ep ---------------------------------

    def _axis(self, name: str):
        return {"dp": (self.group, self.rank, self.size),
                "tp": self.tp, "ep": self.ep}[name]

    def _gather(self, parts) -> dict:
        """{id(x): whole} for parts [(x, (dim, axis name, halves))]: one
        all_gather per axis and dtype over the flattened slices."""
        whole = {}
        for name in dict.fromkeys(a for _, (_, a, _) in parts):
            group, _, n = self._axis(name)
            for dtype in dict.fromkeys(x.dtype for x, _ in parts):
                sel = [(x, d, h) for x, (d, a, h) in parts
                       if a == name and x.dtype == dtype]
                if not sel:
                    continue
                flat = torch.cat([x.reshape(-1) for x, _, _ in sel])
                every = C.all_gather(flat[None], group).reshape(n, -1)
                off = 0
                for x, d, h in sel:
                    k = x.numel()
                    whole[id(x)] = _join([every[r, off:off + k].reshape(x.shape)
                                          for r in range(n)], d, h)
                    off += k
        return whole

    def mp_shard(self, tree, splits, copy: bool = False):
        """Each split leaf's tp / ep slice of this rank."""
        def take(_, x, s):
            for d, a in s.dims:
                _, r, n = self._axis(a)
                x = _narrow(x, d, n, r, s.halves and a == "tp")
            return x.contiguous().clone() if copy and s.dims else x
        return _map(take, tree, splits)

    def mp_gather(self, tree, splits):
        """The whole leaves (over tp and ep) of a tree of this rank's
        slices: the ep dims gathered first, then the tp dims."""
        for axis in ("ep", "tp"):
            parts = [(x, (d, a, s.halves and a == "tp"))
                     for x, s in _leaves(tree, splits) if torch.is_tensor(x)
                     for d, a in s.dims if a == axis]
            if parts:
                whole = self._gather(parts)
                tree = _map(lambda _, x, s: whole.get(id(x), x), tree, splits)
        return tree

    def all_reduce(self, tensors: list, group=None) -> list:
        """The sums over the dp ranks (or `group`'s) of a list of tensors,
        one all_reduce per dtype over their flattened concatenation; the
        tensors themselves at dp 1."""
        group = self.group if group is None else group
        if group is None:
            return list(tensors)
        out = list(tensors)
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = C.all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]),
                                group)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].reshape(tensors[i].shape)
                off += n
        return out

    def reduce_grads(self, grads: list) -> list:
        """A step's gradients summed over the dp x sp ranks (dp alone
        without sp; a pp rank's are whole already)."""
        return self.all_reduce(grads, self.grad_group)

    # -- the step's hooks -------------------------------------------------

    def param_splits(self, field: str):
        """The splits of the params an optimizer state `field` updates:
        the generator partition for 'gen_opt', the discriminator's for
        'disc_opt', all of them otherwise (a family state's 'opt')."""
        sp = self.splits.params
        if field == "gen_opt":
            return {k: v for k, v in sp.items() if k != "discriminator"}
        if field == "disc_opt":
            return sp["discriminator"]
        return sp

    def global_norm(self, grads, field: str):
        """optim.global_norm of this rank's gradient slices: a split leaf's
        squares summed over its axes, a replicated leaf counted once."""
        return global_norm(grads, [s.axes for (s,) in
                                   _leaves(self.param_splits(field))])

    def split_sum(self, params, fn):
        """The sum over the params' leaves of fn(leaf) (a scalar), a split
        leaf's reduced over its axes (the whole tree's sum)."""
        leaves = _leaves(params, self.splits.params)
        return C.reduce_grouped([fn(x) for x, _ in leaves],
                                [s.axes for _, s in leaves])

    def params_in(self, params):
        """The params a step computes with: gathered over dp under zero=3
        (the tp / ep slices stay)."""
        return self.gather(params, self.dims.params) if self.zero >= 3 else params

    def params_out(self, params):
        """The params a step keeps at rest: sliced over dp under zero=3."""
        return (self.shard(params, self.dims.params, copy=True)
                if self.zero >= 3 else params)

    def update(self, tx, field: str, grads, opt_state, params, norm):
        """(new params, new optimizer state) of one update of `tx`
        (train/optim.py's Optimizer, or ParamsEma around one) on the
        optimizer state `field` from the dp-reduced gradient slices
        `grads`, whose global norm is `norm`. An Adam chain updates this
        rank's slices (elementwise): under zero>=1 its dp slices, then the
        params are all-gathered over dp. An Adafactor chain under ZeRO or a
        model split gathers the whole gradient, params and state, updates
        the whole leaves and keeps its slices."""
        opt_dims = getattr(self.dims, field)
        inner = tx.inner if isinstance(tx, ParamsEma) else tx
        if inner.optim_type == "adafactor" and (self.zero or self.model_split):
            psplit, osplit = self.param_splits(field), getattr(self.splits, field)
            whole = self.mp_gather(self.gather(opt_state, opt_dims), osplit)
            wp = self.mp_gather(params, psplit)
            u, state = tx.update(self.mp_gather(grads, psplit), whole, wp, norm)
            new = self.mp_shard(apply_updates(wp, u), psplit, copy=True)
            state = self.mp_shard(state, osplit, copy=True)
            return new, self.shard(state, opt_dims, copy=True)
        if self.zero == 0:
            u, state = tx.update(grads, opt_state, params, norm)
            return apply_updates(params, u), state
        pdims = (opt_dims.inner if isinstance(tx, ParamsEma) else opt_dims).mu
        g, p = self.shard(grads, pdims), self.shard(params, pdims)
        u, state = tx.update(g, opt_state, p, norm)
        return self.gather(apply_updates(p, u), pdims), state

    def reduce_metrics(self, metrics: dict) -> dict:
        """Each metric (a rank's share of the global batch's) summed over
        the dp ranks."""
        keys = list(metrics)
        return dict(zip(keys, self.all_reduce([metrics[k] for k in keys])))

    def apply(self, tx, field: str, grads, opt_state, params):
        """A family step's update: (new params, new optimizer state, the
        gradient's global norm) from this rank's gradient slices, summed
        over dp first."""
        grads = tree_unflatten(grads, self.all_reduce(tree_leaves(grads)))
        norm = self.global_norm(grads, field)
        new, state = self.update(tx, field, grads, opt_state, params, norm)
        return new, state, norm

    # -- whole states -----------------------------------------------------

    def place(self, ts):
        """ts (whole, the same on every rank) as this rank keeps it at
        rest: its tp / ep slices of the split leaves, then its dp slices
        of the ZeRO-split ones."""
        return type(ts)(**{f: self.shard(
            self.mp_shard(getattr(ts, f), getattr(self.splits, f), copy=True),
            getattr(self.dims, f), copy=True) for f in ts._fields})

    def whole(self, ts):
        """The whole state of the ranks' slices (a collective: every rank
        calls it), for a checkpoint or an evaluation."""
        return type(ts)(**{f: self.mp_gather(
            self.gather(getattr(ts, f), getattr(self.dims, f)),
            getattr(self.splits, f)) for f in ts._fields})

    def place_tree(self, tree):
        """A whole param tree outside the state (a teacher's) as this rank
        computes with it: its tp / ep slices."""
        return self.mp_shard(tree, model_shardings(self.mesh, tree), copy=True)


def state_bytes(tree) -> int:
    """Bytes of the tensor leaves of a tree (a rank's optimizer state)."""
    return sum(x.numel() * x.element_size() for (x,) in _leaves(tree)
               if torch.is_tensor(x))


def check_mesh(cfg, tp: int = 1, ep: int = 1, sp: int = 1, pp: int = 1):
    """Refuse a model or a mesh the axes cannot split (ValueError), as JAX
    refuses them: tp must divide nhead and ffn_dim, ep the experts
    (moe_experts), and a pp axis must equal cfg.pp and divide num_layers.
    Every other combination of the axes runs (the module docstring)."""
    if tp > 1 and cfg.model_type == "transformer" and (
            cfg.nhead % tp or cfg.ffn_dim % tp):
        raise ValueError(f"--tp {tp} must divide nhead {cfg.nhead} and "
                         f"ffn_dim {cfg.ffn_dim}")
    if ep > 1 and cfg.moe_experts % ep:
        raise ValueError(f"--ep {ep} must divide moe_experts {cfg.moe_experts}")
    if pp > 1 and (cfg.pp != pp or cfg.num_layers % pp):
        raise ValueError(f"a pp axis of {pp} needs cfg.pp == {pp} (got "
                         f"{cfg.pp}) dividing num_layers {cfg.num_layers}")


def shard_train_step(train_step, mesh, ts, example_batches=None, zero: int = 0):
    """unast_tpu/parallel/mesh.py::shard_train_step: (sharded step, ts
    placed) for `train_step`, a train/steps.py::make_train_step step, over
    the mesh's dp, tp and ep axes. Every rank calls the sharded step with
    its dp coordinate's torch.Generator (the same on its tp and ep peers;
    train/loop.py seeds it so) and its dp share of the global batch
    (batch_shardings of it); the step returns this rank's TrainState (its
    tp / ep slices, and dp slices under ZeRO) and the global batch's
    metrics, the same on every rank. `example_batches` is not needed
    (torch traces nothing ahead) and is accepted for the JAX signature.
    zero in {0, 1, 3}. An sp or pp axis: see the module docstring; the pp
    axis reaches the stacks through the step's collectives context, where
    JAX's shard_train_step installs it with set_pp_mesh. Every
    combination of the axes that check_mesh takes runs: sp with remat,
    MoE or the RNN backbone, a pp axis with tp, ep or sp."""
    from ..train.steps import make_train_step
    cfg, args = train_step.config
    check_mesh(cfg, *(axis_size(mesh, n) for n in ("tp", "ep", "sp", "pp")))
    plan = MeshPlan(mesh, ts, zero)
    return make_train_step(cfg, args, plan=plan), plan.place(ts)


def shard_family_step(make_step, mesh, ts):
    """(sharded step, ts placed, plan) of a family step over the mesh,
    zero 0: make_step(plan=...) makes it (train/ctc.py's make_ctc_step,
    train/fastspeech.py's make_distill_step or train/melgan.py's
    make_vocoder_step with their other arguments bound). Each rank gives
    it its dp rows of the flat batch (batch_shardings(mesh, batch,
    dim=0)) and keeps its tp slices of the params and the optimizer state
    (plan.place_tree slices a teacher's params). A mesh with an sp or pp
    axis raises ValueError: JAX shards the family steps over dp and tp
    only (tests/test_sharded_families.py)."""
    if axis_size(mesh, "sp") > 1 or axis_size(mesh, "pp") > 1:
        raise ValueError("the family steps shard over dp and tp (and ep); "
                         "not over an sp or pp axis")
    plan = MeshPlan(mesh, ts)
    return make_step(plan=plan), plan.place(ts), plan
