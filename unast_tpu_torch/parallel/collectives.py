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

The global-batch reductions run over the dp group, and inside a time-split
region (`sequence`) over the dp x sp group: the tp, ep and pp ranks of one
dp group hold the same rows (the batch splits over 'dp' alone), so each
computes the same share and a reduction over them would count it again;
the sp ranks hold disjoint frames of the same rows.

- `total(x)`: the sum of x over the ranks, no gradient (a denominator:
  mask sums, valid-token counts);
- `mean(x)`: the mean of x's elements over the global batch, each rank's
  share of it (x.sum() / (x.numel() * ranks)), so the sum over the ranks
  is the global mean and so are its summed gradients;
- `sum_grad(x)`: the sum over the ranks with its gradient (an all-reduce
  whose backward all-reduces the incoming gradient), for statistics of
  the activations (BatchNorm's, the MoE router's);
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

The sequence axis ('sp'): inside `sequence(T)` every activation of the
region holds this rank's frames [start, start + local) of a sequence of T
frames, local = ceil(T / sp); the last rank's frames past T are padding
(zeros at the entry, kept out of every statistic and mask).

- `split_time(x)`: this rank's frames of a whole sequence (the padding
  zero), with its gradient;
- `gather_time(x)`: the whole sequence of the ranks' frames (trimmed to
  T), whose backward sums the gradient over sp and keeps this rank's
  frames (a reduce-scatter, as an all-reduce and a slice: gloo has no
  reduce-scatter);
- `halo(x, left, right)`: x with the previous rank's last `left` frames
  before it and the next rank's first `right` after it (zeros at the
  sequence's ends), and the conjugate exchange of their gradients;
- `time_split(x, dim)`: nn.dropout's split record of such an activation,
  so that its mask is the whole sequence's, sliced;
- `valid_frames()`: which of this rank's frames lie inside T.

A checkpointed layer (models/transformer.py::_ckpt) recomputes its
forward inside the backward, after its regions were left: `snapshot()`
takes the active context (groups, axes, regions) when the layer runs and
`restored(snap)` re-enters it for the recompute, so that it gathers,
exchanges halos and draws dropout as the forward did.

The pipeline axis ('pp'): `send` and `recv` move a tensor to and from
another rank (parallel/pipeline.py posts them in one order on every rank
of the axis, the schedule's), `broadcast` and `all_reduce` over its group.

The collectives work on either backend: gloo (the CPU's, and ranks sharing
one card) takes host copies of CUDA tensors; NCCL takes them as they are.
Only all_reduce, all_gather, broadcast and point-to-point send / recv are
used, which both backends have.
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
_DP_SP = None   # the dp x sp group of a time-split region's reductions
_AXES = {}      # the active axes by name ('tp', 'ep', 'sp', 'pp')
_SEQ = []       # the active time-split regions (Seq), innermost last


class Seq(NamedTuple):
    """A time-split region: the sequence's T frames (`whole`), the frames
    each sp rank holds (`local`, ceil(T / sp)) and this rank's first
    (`start`)."""
    whole: int
    local: int
    start: int


@contextlib.contextmanager
def data_parallel(group):
    """Make `group` the data-parallel group of the global-batch reductions
    for the `with` block."""
    with mesh_axes(dp=group):
        yield


class Snapshot(NamedTuple):
    """A collectives context: the dp group, the dp x sp group, the axes
    and the time-split regions (`mesh_axes`, `snapshot`, `restored`)."""
    group: object
    dp_sp: object
    axes: dict
    seq: tuple


@contextlib.contextmanager
def mesh_axes(dp=None, tp: Optional[Axis] = None, ep: Optional[Axis] = None,
              sp: Optional[Axis] = None, pp: Optional[Axis] = None,
              dp_sp=None):
    """Make `dp` (a process group, or None) the group of the global-batch
    reductions, `dp_sp` (the dp x sp group, or None: `dp`) theirs inside a
    time-split region, and `tp`, `ep`, `sp` and `pp` (Axis records, or
    None: size 1) the model-parallel axes for the `with` block."""
    axes = {k: a for k, a in (("tp", tp), ("ep", ep), ("sp", sp), ("pp", pp))
            if a is not None and a.size > 1}
    with restored(Snapshot(dp, dp if dp_sp is None else dp_sp, axes, ())):
        yield


def snapshot() -> Snapshot:
    """The active collectives context, for `restored` to re-enter later
    (a checkpointed layer's recompute, which runs inside the backward,
    after the forward's regions were left)."""
    return Snapshot(_GROUP, _DP_SP, dict(_AXES), tuple(_SEQ))


@contextlib.contextmanager
def restored(snap: Snapshot):
    """Enter the collectives context `snap` for the `with` block: its
    groups, axes and time-split regions, whatever is active now."""
    global _GROUP, _DP_SP, _AXES, _SEQ
    prev = _GROUP, _DP_SP, _AXES, _SEQ
    _GROUP, _DP_SP, _AXES, _SEQ = snap.group, snap.dp_sp, dict(snap.axes), list(snap.seq)
    try:
        yield
    finally:
        _GROUP, _DP_SP, _AXES, _SEQ = prev


def _group():
    """The group of the global-batch reductions here: dp x sp inside a
    time-split region, dp outside."""
    return _DP_SP if _SEQ else _GROUP


def active() -> bool:
    return _group() is not None


def ranks() -> int:
    """The ranks of the active reduction group; 1 without one."""
    g = _group()
    return 1 if g is None else dist.get_world_size(g)


def rank() -> int:
    """This rank's coordinate in the active dp group; 0 without one."""
    return 0 if _GROUP is None else dist.get_rank(_GROUP)


def dp_ranks() -> int:
    """The ranks of the active dp group (the sp ranks of a time-split
    region left out); 1 without one."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


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
    """x summed over the active reduction group's ranks, without a
    gradient; x itself without a group."""
    g = _group()
    return x if g is None else all_reduce(x, g)


def sum_grad(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active reduction group's ranks, with its
    gradient; x itself without a group."""
    g = _group()
    return x if g is None else _SumGrad.apply(x, g)


def mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() without a group; with one, this rank's share of the mean
    over the global batch, x.sum() / (x.numel() * ranks)."""
    if _group() is None:
        return x.mean()
    return x.sum() / (x.numel() * ranks())


def any_rank(flag: torch.Tensor) -> bool:
    """bool(flag) without a group; with one, whether it holds on any rank
    of the active reduction group."""
    g = _group()
    if g is None:
        return bool(flag)
    return bool(all_reduce(flag.reshape(1).to(torch.int32), g)[0] > 0)


def gather_ranks(x: torch.Tensor) -> torch.Tensor:
    """The active reduction group's ranks' x (each of x's shape) joined
    along dim 0, without a gradient; x itself without a group."""
    g = _group()
    return x if g is None else all_gather(x, g, dim=0)


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


# ---------------------------------------------------------------------------
# The sequence axis
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def sequence(whole: int, local: Optional[int] = None):
    """A time-split region over a sequence of `whole` frames for the `with`
    block (it yields its Seq): under an active sp axis, every activation
    inside holds this rank's `local` frames of it (ceil(whole / sp) unless
    given: a frame-level view of a region over groups of frames) and the
    global-batch reductions run over dp x sp; without one, nothing changes
    (it yields None)."""
    a = _AXES.get("sp")
    if a is None:
        yield None
        return
    local = -(-whole // a.size) if local is None else local
    _SEQ.append(Seq(whole, local, a.rank * local))
    try:
        yield _SEQ[-1]
    finally:
        _SEQ.pop()


def seq() -> Optional[Seq]:
    """The innermost active time-split region, or None."""
    return _SEQ[-1] if _SEQ else None


def split_time(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's frames along `dim` of x, a whole sequence of the active
    region's T frames: zero-padded to local * sp frames, then sliced (with
    its gradient); x itself outside a region."""
    s = seq()
    if s is None:
        return x
    if x.shape[dim] != s.whole:
        raise ValueError(f"split_time: {x.shape[dim]} frames along dim {dim}, "
                         f"the region has {s.whole}")
    pad = s.local * axis_size("sp") - s.whole
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return x.narrow(dim, s.start, s.local)


class _GatherTime(torch.autograd.Function):
    """all_gather along `dim`, trimmed to `whole`; backward: the gradient
    summed over the ranks (all_reduce), this rank's frames kept."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank, whole):
        ctx.dim, ctx.group, ctx.size, ctx.rank = dim, group, size, rank
        ctx.local = x.shape[dim]
        return all_gather(x, group, dim=dim).narrow(dim, 0, whole)

    @staticmethod
    def backward(ctx, g):
        d, n = ctx.dim, ctx.local
        pad = n * ctx.size - g.shape[d]
        if pad:
            shape = list(g.shape)
            shape[d] = pad
            g = torch.cat([g, g.new_zeros(shape)], dim=d)
        g = all_reduce(g.contiguous(), ctx.group)
        return g.narrow(d, ctx.rank * n, n), None, None, None, None, None


def gather_time(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole sequence (T frames along `dim`) of the sp ranks' frames x
    of the active region, with its gradient (see _GatherTime); x itself
    outside a region."""
    s, a = seq(), _AXES.get("sp")
    if s is None:
        return x
    return _GatherTime.apply(x, dim, a.group, a.size, a.rank, s.whole)


class _Halo(torch.autograd.Function):
    """The halo exchange of `halo`; backward: each halo's gradient goes
    back to the rank whose frames it holds."""

    @staticmethod
    def forward(ctx, x, left, right, group, size, rank):
        ctx.args = left, right, group, size, rank
        b, n, c = x.shape
        edges = torch.cat([x[:, :right], x[:, n - left:]], dim=1)
        every = all_gather(edges[None], group, dim=0)    # [sp, B, r + l, C]
        zl = x.new_zeros((b, left, c))
        zr = x.new_zeros((b, right, c))
        lh = every[rank - 1, :, right:] if rank > 0 else zl
        rh = every[rank + 1, :, :right] if rank < size - 1 else zr
        return torch.cat([lh, x, rh], dim=1)

    @staticmethod
    def backward(ctx, g):
        left, right, group, size, rank = ctx.args
        n = g.shape[1] - left - right
        gx = g[:, left:left + n].clone()
        # this rank's halo gradients, by whose frames they are: [left
        # halo (the previous rank's last frames), right halo (the next's
        # first)]
        mine = torch.cat([g[:, :left], g[:, left + n:]], dim=1)
        every = all_gather(mine[None].contiguous(), group, dim=0)
        if rank > 0 and right:      # the previous rank's right halo: my first
            gx[:, :right] += every[rank - 1, :, left:]
        if rank < size - 1 and left:   # the next rank's left halo: my last
            gx[:, n - left:] += every[rank + 1, :, :left]
        return gx, None, None, None, None, None


def halo(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """x [B, local, C], this rank's frames of the active region, with the
    previous sp rank's last `left` frames before it and the next rank's
    first `right` frames after it (zeros before the first frame and after
    the last rank's, whose frames past T are zeroed first), so that a conv
    of that reach over the result without padding gives this rank's frames
    of the conv over the whole sequence. x itself, padded with zeros,
    outside a region."""
    s, a = seq(), _AXES.get("sp")
    if s is None:
        return torch.nn.functional.pad(x, (0, 0, left, right))
    if max(left, right) > s.local:
        raise ValueError(f"a halo of {max(left, right)} frames reaches past "
                         f"the {s.local} frames of the neighbouring rank")
    x = x * valid_frames(x.device)[:, None].to(x.dtype)
    return _Halo.apply(x, left, right, a.group, a.size, a.rank)


def valid_frames(device=None) -> Optional[torch.Tensor]:
    """bool [local]: which of this rank's frames of the active region lie
    inside the sequence's T frames; None outside a region."""
    s = seq()
    if s is None:
        return None
    return torch.arange(s.start, s.start + s.local, device=device) < s.whole


def time_split(x: torch.Tensor, dim: int = 1) -> tuple:
    """nn.dropout's split record of x, an activation of the active region
    whose dim `dim` holds this rank's frames: the whole sequence's mask is
    drawn and sliced (the frames past T take ones); () outside a region."""
    s = seq()
    if s is None:
        return ()
    return ((dim % x.ndim, s.whole, s.start),)


# ---------------------------------------------------------------------------
# The pipeline axis
# ---------------------------------------------------------------------------


def axis(name: str) -> Optional[Axis]:
    """The active axis `name`, or None."""
    return _AXES.get(name)


class _Sent(NamedTuple):
    """A pending send and the buffer it reads, kept alive until wait()."""
    work: object
    buf: torch.Tensor

    def wait(self):
        self.work.wait()


def send(t: torch.Tensor, dst: int, group) -> _Sent:
    """Send t to the global rank `dst` (a rank of `group`'s backend)
    without waiting; wait() on the result before the next collective."""
    buf = (t.detach().to("cpu") if _on_host(group, t) else t.detach()).contiguous()
    return _Sent(dist.isend(buf, dst), buf)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of like's shape and dtype received from the global rank
    `src`, on like's device."""
    host = _on_host(group, like)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, src)
    return buf.to(like.device) if host else buf


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """t of the global rank `src` on every rank of `group` (t's shape and
    dtype on each), a new tensor on t's device."""
    host = _on_host(group, t)
    buf = (t.detach().to("cpu", copy=True) if host else t.detach().clone()).contiguous()
    dist.broadcast(buf, src, group=group)
    return buf.to(t.device) if host else buf
