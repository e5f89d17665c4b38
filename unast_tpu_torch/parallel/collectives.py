"""The collectives of the port's data parallelism, and the global-batch
reductions the model and the losses run through.

Under JAX the dp axis is a sharding of one program: GSPMD computes every
mean, every BatchNorm statistic and every decode loop's stop test over the
GLOBAL batch (unast_tpu/parallel/mesh.py). The port runs one process per
device instead, so the places where a per-rank computation would differ
from the global one call the helpers below. They are identities unless a
data-parallel group is active (`data_parallel(group)`, which
parallel/mesh.py's sharded train step enters):

- `total(x)`: the sum of x over the ranks, no gradient (a denominator:
  mask sums, valid-token counts);
- `mean(x)`: the mean of x's elements over the global batch, each rank's
  share of it (x.sum() / (x.numel() * ranks)), so the sum over the ranks
  is the global mean and so are its summed gradients;
- `sum_grad(x)`: the sum over the ranks with its gradient (an all-reduce
  whose backward all-reduces the incoming gradient), for statistics of the
  activations (BatchNorm's, the MoE router's);
- `any_rank(flag)`: a decode loop's go-on test over the global batch.

The collectives work on either backend: gloo (the CPU's, and two ranks
sharing one card) takes host copies of CUDA tensors; NCCL takes them as
they are. Only all_reduce and all_gather are used, which both backends
have.
"""

import contextlib

import torch
import torch.distributed as dist

_GROUP = None   # the active data-parallel process group, or None


@contextlib.contextmanager
def data_parallel(group):
    """Make `group` the data-parallel group of the global-batch reductions
    for the `with` block."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def active() -> bool:
    return _GROUP is not None


def ranks() -> int:
    """The ranks of the active group; 1 without one."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


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


def total(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active group's ranks, without a gradient; x
    itself without a group."""
    return x if _GROUP is None else all_reduce(x, _GROUP)


def sum_grad(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active group's ranks, with its gradient; x itself
    without a group."""
    return x if _GROUP is None else _SumGrad.apply(x, _GROUP)


def mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() without a group; with one, this rank's share of the mean
    over the global batch, x.sum() / (x.numel() * ranks)."""
    if _GROUP is None:
        return x.mean()
    return x.sum() / (x.numel() * ranks())


def any_rank(flag: torch.Tensor) -> bool:
    """bool(flag) without a group; with one, whether it holds on any rank."""
    if _GROUP is None:
        return bool(flag)
    return bool(all_reduce(flag.reshape(1).to(torch.int32), _GROUP)[0] > 0)
