"""The collectives of the port's mesh, the global-batch reductions the model
and the losses run through, and Megatron's conjugate pair for the tensor-
and expert-parallel splits.

Under JAX the mesh axes are shardings of one program: GSPMD computes every
mean, every BatchNorm statistic and every decode loop's stop test over the
GLOBAL batch, and inserts the all-reduces of the megatron splits
(unast_tpu/parallel/mesh.py). The port runs one process per device
instead, so the places where a per-rank computation would differ from the
global one call the helpers below. They are identities unless a mesh is
active (`mesh_axes(...)`, which parallel/mesh.py's sharded steps enter, or
`data_parallel(group)` for the dp axis alone).

The global-batch reductions run over the dp group only: the tp and ep
ranks of one dp group hold the same rows (the batch splits over 'dp'
alone), so each computes the same share and a reduction over them would
count it again.

- `total(x)`: the sum of x over the dp ranks, no gradient (a denominator:
  mask sums, valid-token counts);
- `mean(x)`: the mean of x's elements over the global batch, each rank's
  share of it (x.sum() / (x.numel() * ranks)), so the sum over the ranks
  is the global mean and so are its summed gradients;
- `sum_grad(x)`: the sum over the dp ranks with its gradient (an
  all-reduce whose backward all-reduces the incoming gradient), for
  statistics of the activations (BatchNorm's, the MoE router's);
- `any_rank(flag)`: a decode loop's go-on test over the global batch.

The model-parallel axes ('tp', 'ep'): a split layer computes a part of
its output on each rank of the axis, from an input every rank holds.

- `copy_to(x, axes)`: identity forward, all-reduce of the gradient over
  `axes` backward; at the input of a column split (each rank's branch
  gives a part of the input's gradient);
- `reduce_from(x, axes)`: all-reduce over `axes` forward, identity
  backward; after a row split (the parts of the output add up);
- `take(w, dim, axis)`: this rank's slice of a replicated tensor, with the
  gradient of the whole all-reduced (so a replicated param sliced at use
  gets its whole gradient on every rank);
- `gather(x, dim, axis)`: the ranks' slices joined, without a gradient.

The collectives work on either backend: gloo (the CPU's, and ranks sharing
one card) takes host copies of CUDA tensors; NCCL takes them as they are.
Only all_reduce and all_gather are used, which both backends have.
"""

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group, this rank's
    coordinate on it and its size."""
    group: object
    rank: int
    size: int


_GROUP = None   # the active data-parallel process group, or None
_AXES = {}      # the active model-parallel axes by name ('tp', 'ep')


@contextlib.contextmanager
def data_parallel(group):
    """Make `group` the data-parallel group of the global-batch reductions
    for the `with` block."""
    with mesh_axes(dp=group):
        yield


@contextlib.contextmanager
def mesh_axes(dp=None, tp: Optional[Axis] = None, ep: Optional[Axis] = None):
    """Make `dp` (a process group, or None) the group of the global-batch
    reductions and `tp` and `ep` (Axis records, or None: size 1) the
    model-parallel axes for the `with` block."""
    global _GROUP, _AXES
    prev = _GROUP, _AXES
    _GROUP = dp
    _AXES = {k: a for k, a in (("tp", tp), ("ep", ep))
             if a is not None and a.size > 1}
    try:
        yield
    finally:
        _GROUP, _AXES = prev


def active() -> bool:
    return _GROUP is not None


def ranks() -> int:
    """The ranks of the active dp group; 1 without one."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


def rank() -> int:
    """This rank's coordinate in the active dp group; 0 without one."""
    return 0 if _GROUP is None else dist.get_rank(_GROUP)


def axis_size(name: str) -> int:
    """The size of the active model-parallel axis `name`; 1 without one."""
    a = _AXES.get(name)
    return 1 if a is None else a.size


def axis_rank(name: str) -> int:
    """This rank's coordinate on the active axis `name`; 0 without one."""
    a = _AXES.get(name)
    return 0 if a is None else a.rank


def _on_host(group, t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the ranks of `group`, a new tensor on t's device."""
    host = _on_host(group, t)
    buf = (t.detach().to("cpu", copy=True) if host else t.detach().clone()).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device) if host else buf


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors (each of t's shape) joined along `dim`, in rank
    order, on t's device."""
    host = _on_host(group, t)
    src = (t.detach().to("cpu") if host else t.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


def _reduce(t: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        t = all_reduce(t, g)
    return t


class _SumGrad(torch.autograd.Function):
    """all_reduce(sum) whose backward all-reduces the gradient: rank r's
    input reaches every rank's loss, so its gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return _reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def total(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active dp group's ranks, without a gradient; x
    itself without a group."""
    return x if _GROUP is None else all_reduce(x, _GROUP)


def sum_grad(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active dp group's ranks, with its gradient; x
    itself without a group."""
    return x if _GROUP is None else _SumGrad.apply(x, _GROUP)


def mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() without a group; with one, this rank's share of the mean
    over the global batch, x.sum() / (x.numel() * ranks)."""
    if _GROUP is None:
        return x.mean()
    return x.sum() / (x.numel() * ranks())


def any_rank(flag: torch.Tensor) -> bool:
    """bool(flag) without a group; with one, whether it holds on any dp
    rank."""
    if _GROUP is None:
        return bool(flag)
    return bool(all_reduce(flag.reshape(1).to(torch.int32), _GROUP)[0] > 0)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The dp ranks' x joined along dim 0 in rank order (the global
    batch's rows), without a gradient; x itself without a group."""
    return x if _GROUP is None else all_gather(x, _GROUP, dim=0)


def _groups(axes) -> tuple:
    names = (axes,) if isinstance(axes, str) else axes
    return tuple(_AXES[n].group for n in names if n in _AXES)


def copy_to(x: torch.Tensor, axes="tp") -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the active `axes`
    ('tp', 'ep' or both) backward. x itself when none is active."""
    groups = _groups(axes)
    return _CopyTo.apply(x, groups) if groups else x


def reduce_from(x: torch.Tensor, axes="tp") -> torch.Tensor:
    """x all-reduced over the active `axes` forward, the gradient passed
    through backward. x itself when none is active."""
    groups = _groups(axes)
    return _ReduceFrom.apply(x, groups) if groups else x


def reduce_grouped(values, axes) -> torch.Tensor:
    """The sum of the scalars `values`, each summed over the ranks of its
    active axes (axes[i] for values[i]; () for a replicated value, counted
    once): one reduce_from per distinct axes tuple."""
    parts = {}
    for v, a in zip(values, axes):
        parts[a] = v if a not in parts else parts[a] + v
    return sum(reduce_from(v, a) for a, v in parts.items())


def take(w: torch.Tensor, dim: int, axis: str = "tp") -> torch.Tensor:
    """This rank's 1/size slice of the replicated `w` along `dim`, its
    gradient all-reduced over the axis into the whole; w without it."""
    n = axis_size(axis)
    if n == 1:
        return w
    k = w.shape[dim] // n
    return copy_to(w, axis).narrow(dim, axis_rank(axis) * k, k)


def split_of(x: torch.Tensor, dim: int, axis: str = "tp", at=None) -> tuple:
    """nn.dropout's split record of x as this rank's slice of a tensor
    split evenly along `dim` over the active `axis` (for a tensor whose dim
    `at` is that one, when given); () without the axis."""
    n = axis_size(axis)
    if n == 1:
        return ()
    k = x.shape[dim]
    return ((dim if at is None else at, k * n, axis_rank(axis) * k),)


def gather(x: torch.Tensor, dim: int, axis: str = "tp") -> torch.Tensor:
    """The axis' ranks' slices of x joined along `dim` in rank order,
    without a gradient; x without the axis."""
    a = _AXES.get(axis)
    return x if a is None else all_gather(x, a.group, dim=dim)
