"""Pipeline parallelism of the port: GPipe stages of a transformer layer
stack, mirroring `unast_tpu/parallel/pipeline.py`.

The L layers split into pp contiguous stages of L/pp; the batch splits
into M micro-batches (default_micro: the first of 4 pp, 2 pp and pp that
divides it). Stage s runs its layers on micro-batch m at tick s + m of the
fill-and-drain schedule's M + pp - 1 ticks, and micro-batch m's layer l
draws its dropout from the generator seeded with (base, l * M + m), one
base per stack call drawn from the ctx (JAX's fold of the layer and micro
index into rng_base), so the staged stack draws what the one-process
schedule draws.

JAX computes every stage at every tick in one GSPMD program (a vmap over a
stage axis sharded over 'pp', the hop a jnp.roll that lowers to a
collective-permute) and autodiff gives the backward drain. Here each rank
of the mesh's pp axis is one process that runs only its stage's layers
(`_Staged`, an autograd.Function): its forward receives each micro-batch
from the previous stage (stage 0 slices it from its input), runs the
stage's layers with their graph kept, and sends the result on; the last
stage's outputs are broadcast to every pp rank, as JAX's psum gives them
to every device. The backward drains in reverse: the last stage takes
each micro-batch's output gradient (the same on every pp rank, whose
loss is the whole loss), every stage back-propagates through its layers
and sends the input's gradient back, and one all-reduce over pp gives
every rank the input's, the micro arguments' (the decoder's memory) and
every layer's gradient (each layer's from its stage). So after the
backward every param's gradient is the same on every pp rank, as the
replicated part of the step's are, and the sharded step sums them over
dp alone. Every rank posts its sends, receives and collectives in the
same order, micro-batch by micro-batch, so gloo cannot deadlock.

The stages combine with the other axes, as JAX's _pp_stage_constraint
leaves the trailing dims to GSPMD: the pp axis's group holds the ranks of
one coordinate on every other axis, so a stage's hops and its all-reduce
join the ranks of one tp (and sp) coordinate, while the layers' tp
all-reduces and sp gathers run among the ranks of the stage's pp
coordinate, in the same order on each. Under tp each rank's layer
gradients are its tp slices, and the all-reduce over pp sums the slices of
one tp coordinate. Under sp the micro-batches hop as the rank's frames,
inside the time-split region the stack was called in, and the micro
arguments (the padding bias, the decoder's memory and masks) are the
whole sequences' that the unpipelined stack reads. An MoE stack does not
pipeline (models/transformer.py): under pp x ep it runs unstaged, its
experts over ep.

Without a pp axis (the loop's --pp, as JAX's loop: its mesh has no 'pp')
gpipe_stack runs the same schedule in one process.
"""

from typing import Optional

import torch
import torch.distributed as dist

from . import collectives as C

_PP = None   # the pp axis installed by set_pp_mesh (collectives.Axis)


def set_pp_mesh(mesh):
    """unast_tpu/parallel/pipeline.py::set_pp_mesh: install (or clear, with
    None or a mesh without a pp axis above 1) the pp axis gpipe_stack
    stages over when the collectives context has none, until cleared:
    every pipelined stack then runs staged, so every rank of the axis must
    make the same calls. The sharded step needs none: its collectives
    context carries its mesh's pp axis (mesh.py::MeshPlan)."""
    global _PP
    from .mesh import mesh_axis
    _PP = None if mesh is None else mesh_axis(mesh, "pp")


def default_micro(b: int, pp: int) -> int:
    """JAX's default micro-batch count: the first of 4 pp, 2 pp and pp that
    divides the batch b, else 1."""
    return next((m for m in (4 * pp, 2 * pp, pp) if b % m == 0), 1)


def _split(a, n: int):
    """a's n micro-batches along dim 0 (None: n Nones)."""
    return [None] * n if a is None else list(a.chunk(n))


def _run(layers, ids, layer_fn, seed, train: bool, n_micro: int, m: int,
         x, margs):
    """Layers `ids` of `layers` on micro-batch m, each with its generator
    (transformer._layer_ctx of layer * M + m)."""
    from ..models import transformer as T
    for li in ids:
        lctx = T._layer_ctx(seed, train, li * n_micro + m, x.device)
        x = layer_fn(layers[li], lctx, x, *margs)
    return x


class _Staged(torch.autograd.Function):
    """This pp rank's stage of the schedule (module docstring). forward(
    plan, x, *margs, *leaves) with plan = (axis, layers, n_layers,
    layer_fn, seed, train, n_micro, n_margs, need: whether to keep the
    stage's graph for a backward)."""

    @staticmethod
    def forward(ctx, plan, x, *rest):
        (axis, layers, n_layers, layer_fn, seed, train, n_micro, n_margs,
         need) = plan
        margs, leaves = rest[:n_margs], rest[n_margs:]
        per = n_layers // axis.size
        s, last = axis.rank, axis.size - 1
        ids = range(s * per, (s + 1) * per)
        own = [_detach(t, need) for t in _owned(leaves, layers, ids)]
        dm = [None if a is None else _detach(a, need and a.requires_grad)
              for a in margs]
        local = _with_leaves(layers, ids, own)
        prev, nxt = _peer(axis, s - 1), _peer(axis, s + 1)
        xs = list(x.chunk(n_micro))
        with torch.set_grad_enabled(need):   # the slices keep their graph
            mslices = [_split(a, n_micro) for a in dm]
        saved, outs, works = [], [], []
        for m in range(n_micro):
            inp = xs[m] if s == 0 else C.recv(xs[m], prev, axis.group)
            inp = _detach(inp, need)
            with torch.set_grad_enabled(need):
                out = _run(local, ids, layer_fn, seed, train, n_micro, m, inp,
                           [a[m] for a in mslices])
            if s < last:
                works.append(C.send(out, nxt, axis.group))
            else:
                outs.append(out.detach())
            saved.append((inp, out))
        for w in works:
            w.wait()
        y = torch.cat(outs) if s == last else torch.empty_like(x)
        y = C.broadcast(y, _peer(axis, last), axis.group)
        ctx.plan, ctx.saved, ctx.own, ctx.dm = plan, saved, own, dm
        ctx.n_leaves = len(leaves)
        ctx.leaf_ids = [i for i, _ in _owned_index(leaves, layers, ids)]
        ctx.shapes = [(t.shape, t.dtype) for t in leaves]
        return y

    @staticmethod
    def backward(ctx, g):
        axis, n_micro = ctx.plan[0], ctx.plan[6]
        s, last = axis.rank, axis.size - 1
        prev, nxt = _peer(axis, s - 1), _peer(axis, s + 1)
        gs = list(g.contiguous().chunk(n_micro))
        wrt_m = [a for a in ctx.dm if a is not None and a.requires_grad]
        dx = [torch.zeros_like(t) for t in gs]
        dm = [torch.zeros_like(a) for a in wrt_m]
        dp = [torch.zeros_like(t) for t in ctx.own]
        works = []
        for m in reversed(range(n_micro)):
            inp, out = ctx.saved[m]
            go = gs[m] if s == last else C.recv(out, nxt, axis.group)
            wrt = [inp] + wrt_m + list(ctx.own)
            # <out, go>'s gradient is go's vector-Jacobian product (passing
            # go as grad_outputs would import sympy, seconds, per process)
            with torch.enable_grad():
                grads = torch.autograd.grad((out * go).sum(), wrt,
                                            allow_unused=True)
            gi = grads[0] if grads[0] is not None else torch.zeros_like(inp)
            if s > 0:
                works.append(C.send(gi, prev, axis.group))
            else:
                dx[m] = gi
            for acc, gr in zip(dm + dp, grads[1:]):
                if gr is not None:
                    acc += gr
        for w in works:
            w.wait()
        # every rank's share, summed over pp: the input's (stage 0's), the
        # micro arguments' (every stage's) and each layer's (its stage's)
        full = [None] * ctx.n_leaves
        for i, t in zip(ctx.leaf_ids, dp):
            full[i] = t
        full = [torch.zeros(sh, dtype=dt, device=g.device) if t is None else t
                for t, (sh, dt) in zip(full, ctx.shapes)]
        parts = [torch.cat(dx)] + dm + full
        summed = _all_reduce(parts, axis.group)
        it = iter(summed[1:1 + len(dm)])
        dmargs = [next(it) if a is not None and a.requires_grad else None
                  for a in ctx.dm]
        ctx.saved = None
        return (None, summed[0], *dmargs, *summed[1 + len(dm):])


def _detach(t, need: bool):
    return t.detach().requires_grad_(need)


def _layer_leaves(lp) -> list:
    """The tensor leaves of one layer's tree, in a fixed order."""
    if isinstance(lp, dict):
        return [x for k in sorted(lp) for x in _layer_leaves(lp[k])]
    if isinstance(lp, (list, tuple)):
        return [x for v in lp for x in _layer_leaves(v)]
    return [lp] if torch.is_tensor(lp) else []


def _rebuild(lp, it):
    if isinstance(lp, dict):
        return {k: _rebuild(lp[k], it) for k in sorted(lp)}
    if isinstance(lp, (list, tuple)):
        return type(lp)(_rebuild(v, it) for v in lp)
    return next(it) if torch.is_tensor(lp) else lp


def _owned_index(leaves, layers, ids):
    """(index into leaves, leaf) of the layers `ids`."""
    sizes = [len(_layer_leaves(lp)) for lp in layers]
    starts = [sum(sizes[:i]) for i in range(len(layers))]
    return [(starts[i] + j, leaves[starts[i] + j])
            for i in ids for j in range(sizes[i])]


def _owned(leaves, layers, ids):
    return [t for _, t in _owned_index(leaves, layers, ids)]


def _with_leaves(layers, ids, own):
    """layers with the trees of `ids` rebuilt on the leaves `own`."""
    out = list(layers)
    it = iter(own)
    for i in ids:
        out[i] = _rebuild(layers[i], it)
    return out


def _peer(axis, coord: int) -> int:
    """The global rank of coordinate `coord` of the pp axis."""
    if not 0 <= coord < axis.size:
        return -1
    return dist.get_global_rank(axis.group, coord)


def _all_reduce(tensors, group) -> list:
    """Each tensor summed over the group: one all_reduce per dtype."""
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


def gpipe_stack(layers, n_layers: int, pp: int, ctx, x, micro_args,
                layer_fn, n_micro: int = 0):
    """unast_tpu/parallel/pipeline.py::gpipe_stack: the layer stack `layers`
    (a list of n_layers per-layer trees) as a pp-stage GPipe pipeline
    (the pp > 1 path of models/transformer.py's encoder and decoder).

    x: [B, T, D]; micro_args: tensors with a leading batch dim B (or None)
    that each layer takes beside x, micro-sliced with it; layer_fn(lp,
    lctx, x_mb, *micro_args_mb) runs one layer. n_micro: micro-batches
    (0: default_micro). Over the collectives context's pp axis (or
    set_pp_mesh's) of size pp, this rank runs its stage (_Staged); without
    one, the whole schedule runs here. Returns [B, T, D] on every rank."""
    from ..models import transformer as T
    if n_layers % pp:
        raise ValueError(f"{n_layers} layers do not divide into {pp} stages")
    b = x.shape[0]
    n_micro = n_micro if n_micro > 0 else default_micro(b, pp)
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} micro-batches")
    seed = T._stack_seed(ctx)
    axis = C.axis("pp") or _PP
    if axis is None:
        margs = [_split(a, n_micro) for a in micro_args]
        outs = [_run(layers, range(n_layers), layer_fn, seed, ctx.train,
                     n_micro, m, xm, [a[m] for a in margs])
                for m, xm in enumerate(x.chunk(n_micro))]
        return torch.cat(outs)
    if axis.size != pp:
        raise ValueError(f"pp={pp} stages over a pp axis of {axis.size} ranks")
    leaves = [t for lp in layers for t in _layer_leaves(lp)]
    need = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in [x, *micro_args, *leaves])
    plan = (axis, layers, n_layers, layer_fn, seed, ctx.train, n_micro,
            len(micro_args), need)
    return _Staged.apply(plan, x, *micro_args, *leaves)


def make_pp_mesh(pp: int):
    """unast_tpu/parallel/pipeline.py::make_pp_mesh: a 1-D ('pp',) mesh of
    pipeline stages over the initialized process group, whose world size
    must be pp."""
    from .mesh import make_mesh
    return make_mesh(1, pp=pp)


def stack_for_pipeline(p, pp: int):
    """unast_tpu/parallel/pipeline.py::stack_for_pipeline: encoder params
    {'layers': [L trees]} -> one tree whose leaves are stacked [S, L/S,
    ...] (stage axis leading)."""
    n = len(p["layers"])
    if n % pp:
        raise ValueError(f"{n} layers do not divide into {pp} stages")

    def stack(*xs):
        x0 = xs[0]
        if isinstance(x0, dict):
            return {k: stack(*(x[k] for x in xs)) for k in x0}
        if isinstance(x0, (list, tuple)):
            return type(x0)(stack(*(x[i] for x in xs)) for i in range(len(x0)))
        return torch.stack(xs).reshape((pp, n // pp) + tuple(x0.shape))

    return stack(*p["layers"])


def _unstack(stage_params) -> list:
    """stack_for_pipeline's [S, L/S, ...] tree -> the list of L layer trees."""
    s, per = _layer_leaves(stage_params)[0].shape[:2]

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(take(v, i) for v in t)
        return t[i // per, i % per]

    return [take(stage_params, i) for i in range(s * per)]


def pipeline_encoder(stage_params, ctx, x, pad_mask, nhead: int,
                     dropout_p: float, mesh, n_micro: int):
    """unast_tpu/parallel/pipeline.py::pipeline_encoder: the transformer
    encoder (models/transformer.py::encoder's semantics, attention
    through the additive bias) as a pp-stage GPipe pipeline over the
    mesh's pp axis. stage_params: stack_for_pipeline's output; x: [B, T,
    D]; pad_mask: bool [B, T]; B must divide into n_micro micro-batches.
    Returns [B, T, D] on every rank, equal (up to float association) to
    the sequential encoder, and differentiable in x and the params."""
    from ..models import transformer as T
    from .mesh import mesh_axis
    axis: Optional[C.Axis] = mesh_axis(mesh, "pp")
    layers = _unstack(stage_params)
    bias = T.padding_bias(pad_mask)

    def one(lp, lctx, x_mb, bias_mb):
        return T.encoder_layer(lp, lctx, x_mb, bias_mb, nhead, dropout_p)

    with C.mesh_axes(pp=axis):
        return gpipe_stack(layers, len(layers), 1 if axis is None else axis.size,
                           ctx, x, (bias,), one, n_micro=n_micro)
