"""Mixture-of-Experts FFN, mirroring `unast_tpu/models/moe.py`.

A Switch/GShard sparse FFN that replaces the dense transformer FFN when
ModelConfig.moe_experts > 0. Two paths with the same routing
(ModelConfig.moe_impl):

  - 'dispatch': GShard grouped one-hot dispatch. Tokens are routed in
    groups of S (moe_group_size; auto: the largest divisor of the token
    count <= 4096) with per-group capacity C = ceil(top_k * S / E *
    capacity_factor); tokens past capacity fall through the residual.
  - 'ragged': dropless. The flat top-k assignments are sorted by expert
    (a stable sort), and each projection is one matmul per expert over
    its contiguous run of tokens (JAX's lax.ragged_dot, which is XLA,
    not Pallas). The runs' lengths are read on the host: one sync per
    MoE layer.

Router: a float32 softmax over E experts, top-k in {1, 2} with the lower
index first on a tie (lax.top_k's order; torch.topk leaves ties
unspecified, so the top-k here is k rounds of argmax); top-1 keeps the
raw probability as its gate, top-k > 1 normalizes the selected gates.
The Switch load-balance loss E * sum_e f_e * P_e over the valid tokens is
appended to ctx.aux_losses when the ctx collects. A T == 1 input (the
KV-cached decode step) runs every expert and combines them by the gates,
exactly, with no capacity and no aux loss.

A bf16 product here is torch's bf16 matmul, which accumulates in float32
and rounds once, as JAX's preferred_element_type=f32 then astype does.

Under data and sequence parallelism the dispatch route groups the GLOBAL
batch's tokens in JAX's flat order (row, then frame), as JAX's sharded
step does: the router's probabilities and the valid mask of every rank's
tokens are gathered over the reduction group (dp, or dp x sp inside a
time-split region: N x E floats) and put at their global indices (the
last sp rank's padding frames are no tokens and are left out), the groups
and the capacity cumsum run over the groups this rank's tokens fall in,
and the rank keeps its own tokens' outputs. A slot's FFN sees that slot
alone, so a slot a remote token fills touches no local output, and the
gradients flow through the local tokens' gates only.

Expert parallelism (the ep axis, parallel/collectives.py): each ep rank
holds E / ep experts (the leading axis of lin1 / lin2) and computes them
on the tokens of its dp shard, which every ep rank of the group holds; the
combine over its experts is a partial sum, all-reduced over ep (under this
batch layout no all-to-all is needed). Within an expert, tp splits lin1 by
columns and lin2 by rows as the dense FFN; lin2's bias, replicated over
tp, is combined apart and reduced over ep alone. The inputs of the split
region (the tokens and the gates) pass through copy_to, so the replicated
router gets its whole gradient on every rank.
"""

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import nn
from ..parallel import collectives as C


class MoeOpts(NamedTuple):
    """unast_tpu/models/moe.py::MoeOpts: routing options
    (ModelConfig.moe_opts); a plain tuple prefix of the fields works too."""

    top_k: int = 1
    capacity_factor: float = 1.25
    impl: str = "dispatch"
    group_size: int = 0


def moe_init(gen: torch.Generator, d_model: int, ffn_dim: int, n_experts: int):
    """unast_tpu/models/moe.py::moe_init: the router [D, E] (no bias) and
    the expert-stacked FFN weights lin1 {w [E, D, F], b [E, F]} and lin2
    {w [E, F, D], b [E, D]}, each expert initialized like the dense FFN."""
    router = nn.linear_init(gen, d_model, n_experts, bias=False,
                            torch_default=True)

    def stack(ps):
        return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}

    lin1 = stack([nn.linear_init(gen, d_model, ffn_dim, torch_default=True)
                  for _ in range(n_experts)])
    lin2 = stack([nn.linear_init(gen, ffn_dim, d_model, torch_default=True)
                  for _ in range(n_experts)])
    return {"router": router, "lin1": lin1, "lin2": lin2}


def _router_probs(p, x):
    """unast_tpu/models/moe.py::_router_probs: x [..., D] -> float32 probs
    [..., E]."""
    logits = x @ nn.weight(p["router"], x.dtype)
    return torch.softmax(logits.float(), dim=-1)


def _top_k(probs, k: int):
    """lax.top_k over the last axis with its tie order (the lower index
    first): k rounds of argmax, which returns the first maximum."""
    vals, idx = [], []
    rest = probs
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idx.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def _splits(e_dim: int, f_dim: int, h, n_experts: int) -> tuple:
    """nn.dropout's split record of an expert hidden h whose dim e_dim
    holds this rank's experts (of n_experts) and f_dim its hidden units."""
    ep = C.axis_size("ep")
    out = () if ep == 1 else (
        (e_dim, n_experts, C.axis_rank("ep") * h.shape[e_dim]),)
    return out + C.split_of(h, f_dim)


def _local_experts(n_experts: int) -> slice:
    """The experts of this ep rank."""
    k = n_experts // C.axis_size("ep")
    return slice(C.axis_rank("ep") * k, (C.axis_rank("ep") + 1) * k)


def _combine(eq: str, gates, y, b2):
    """The gated sum over this rank's experts of their outputs y (partial
    over tp when tp > 1, the bias b2 [E_loc, D] then left out of y), as
    einsum(eq, gates, .) with `gates` over every expert: the gates' local
    experts taken through copy_to, the partial sums reduced over tp and
    ep; lin2's bias, replicated over tp, combined apart and reduced over
    ep alone."""
    local = _local_experts(gates.shape[-1 if eq.startswith("bte") else -2])
    pick = ((lambda g: g[..., local]) if eq.startswith("bte")
            else (lambda g: g[..., local, :]))
    out = C.reduce_from(torch.einsum(
        eq, pick(C.copy_to(gates, ("tp", "ep"))).to(y.dtype), y), ("tp", "ep"))
    if b2 is None:
        return out
    gb = pick(C.copy_to(gates, "ep")).to(y.dtype)
    bias = (torch.einsum("bte,ed->btd", gb, b2) if eq.startswith("bte")
            else torch.einsum("...ec,ed->...d", gb, b2))
    return out + C.reduce_from(bias, "ep")


def _expert_ffn(p, ctx: nn.Ctx, h, dropout_p: float, n_experts: int,
                groups=()):
    """unast_tpu/models/moe.py::_expert_ffn: h [..., E, C, D] dispatched
    tokens -> the same shape, through each expert's relu FFN. Under tp
    (lin1 a column split, lin2 a row split) returns (the partial products
    without lin2's bias, the bias [E, D]); else (the outputs, None).
    groups: nn.dropout's split record of h's leading dims (the groups of
    the global batch that this rank holds)."""
    w1 = nn.weight(p["lin1"], h.dtype)
    b1 = p["lin1"]["b"].to(h.dtype)
    y = torch.relu(torch.einsum("...ecd,edf->...ecf", h, w1) + b1[..., None, :])
    y = nn.dropout(ctx, y, dropout_p,
                   split=tuple(groups) + _splits(-3, -1, y, n_experts))
    w2 = nn.weight(p["lin2"], h.dtype)
    b2 = p["lin2"]["b"].to(h.dtype)
    out = torch.einsum("...ecf,efd->...ecd", y, w2)
    if C.axis_size("tp") > 1:
        return out, b2
    return out + b2[..., None, :], None


def _top1_round(remaining, valid, counts, capacity: int):
    """unast_tpu/models/moe.py::_top1_round: one top-1 routing round over
    `remaining` [G, S, E] probs with per-group capacity. Returns (chosen
    one-hot before the drop, gate [G, S] after it, dispatch [G, S, E, C],
    the updated counts [G, E])."""
    e = remaining.shape[-1]
    idx = torch.argmax(remaining, dim=-1)
    gate = remaining.amax(dim=-1) * valid
    onehot = F.one_hot(idx, e).float() * valid[..., None]
    # a token's slot: the tokens given to its expert earlier in the group,
    # plus those of earlier rounds
    pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]
    pos_tok = (pos * onehot).sum(dim=-1)
    keep = (pos_tok < capacity) & (gate > 0)
    kept = onehot * keep[..., None].float()
    # one_hot of a slot past capacity is all zeros, as jax.nn.one_hot gives
    slot = (pos_tok.long()[..., None]
            == torch.arange(capacity, device=pos_tok.device)).float()
    dispatch = kept[..., None] * slot[..., None, :]
    return onehot, gate * keep.float(), dispatch, counts + kept.sum(dim=1)


def _auto_group(n: int, group_size: int) -> int:
    """unast_tpu/models/moe.py::_auto_group: the largest divisor of n that
    is at most the requested group size (4096 when 0)."""
    s = min(n, group_size if group_size > 0 else 4096)
    while n % s:
        s -= 1
    return s


def moe_ffn(p, ctx: nn.Ctx, x, pad_mask, dropout_p: float, opts=MoeOpts()):
    """unast_tpu/models/moe.py::moe_ffn: the sparse FFN over x [B, T, D];
    pad_mask bool [B, T] True = PAD (PAD tokens take no capacity and do
    not count toward the aux loss) or None. T == 1 runs the exact
    dense-combine path; otherwise the dispatch or ragged path per
    opts.impl. Appends the load-balance loss to ctx.aux_losses when it is
    a list.

    Inside a time-split region x holds this rank's frames of sequences of
    T frames and pad_mask is the whole sequences'; the frames past T (the
    last sp rank's padding) are no tokens of JAX's flat batch: they take
    no capacity and no aux mass, and give zeros."""
    opts = MoeOpts(*opts)
    seq = C.seq()
    t_whole = x.shape[1] if seq is None else seq.whole
    if t_whole == 1:
        return _moe_dense(p, ctx, x, dropout_p, opts.top_k)
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    probs = _router_probs(p, xf)                       # [N, E] float32
    valid = (torch.ones((b, t_whole), device=x.device) if pad_mask is None
             else (~pad_mask).float())
    valid = C.split_time(valid).reshape(n)             # padding frames 0
    ids = _TokenIds.of(b, t, x.device)
    if opts.impl == "ragged":
        out, top1_assign = _moe_ragged(p, ctx, xf, probs, valid, ids,
                                       dropout_p, opts.top_k)
    else:
        out, top1_assign = _moe_dispatch(p, ctx, xf, probs, valid, ids,
                                         dropout_p, opts)
    if ctx.aux_losses is not None:
        # over the global batch under data (and sequence) parallelism,
        # each dp rank's share: an sp rank's loss is scaled by 1 / sp
        # (train/steps.py::_accumulate) and sum_grad's backward sums the
        # gradient over dp x sp, so that the dp shares make the whole
        n_valid = torch.clamp(C.total(valid.sum()), min=1.0)
        e = probs.shape[-1]
        frac = C.total(top1_assign.sum(dim=0)) / n_valid          # f_e
        mean_prob = C.sum_grad((probs * valid[:, None]).sum(dim=0)) / n_valid
        ctx.aux_losses.append(e * (frac * mean_prob).sum() / C.dp_ranks())
    return out.reshape(b, t, d)


class _TokenIds(NamedTuple):
    """Where this rank's tokens sit in JAX's flat order of the global batch
    (row b, frame t at b * T + t; dp rank r's rows after those of the
    ranks before it, an sp rank's frames at its region's offset): `ids`
    [N] (-1 for an sp rank's padding frames), the global token count, the
    first and last global index of this rank's tokens (None without one),
    and `mine`, the positions of this rank's tokens among its N (not
    padding), known without reading the device."""
    ids: torch.Tensor
    total: int
    first: Optional[int]
    last: Optional[int]
    mine: torch.Tensor

    @staticmethod
    def of(b: int, t: int, device) -> "_TokenIds":
        seq = C.seq()
        t_whole, start = (t, 0) if seq is None else (seq.whole, seq.start)
        row0 = C.rank() * b
        frames = start + torch.arange(t, device=device)
        ids = (row0 + torch.arange(b, device=device))[:, None] * t_whole + frames
        ids = torch.where(frames < t_whole, ids, -1).reshape(-1)
        inside = max(0, min(t, t_whole - start))   # this rank's frames in T
        first, last = ((row0 * t_whole + start,
                        (row0 + b - 1) * t_whole + start + inside - 1)
                       if inside else (None, None))
        mine = (torch.arange(b, device=device)[:, None] * t
                + torch.arange(inside, device=device)).reshape(-1)
        return _TokenIds(ids, b * t_whole * C.dp_ranks(), first, last, mine)

    def global_rows(self, v: torch.Tensor) -> torch.Tensor:
        """[total, ...] of the active group's ranks' rows v [N, ...]
        (without a gradient), each at its global index."""
        every, at = C.gather_ranks(v.detach()), C.gather_ranks(self.ids)
        keep = at >= 0
        out = v.new_zeros((self.total,) + tuple(v.shape[1:]))
        out[at[keep]] = every[keep]
        return out


def _moe_dispatch(p, ctx: nn.Ctx, xf, probs, valid, ids: _TokenIds,
                  dropout_p: float, opts: MoeOpts):
    """unast_tpu/models/moe.py::_moe_dispatch: GShard grouped one-hot
    dispatch. xf [N, D] -> (out [N, D], top-1 assignment one-hot [N, E]).
    Under data or sequence parallelism the groups are those of the global
    batch's tokens (see the module docstring): the rounds run over the
    groups [g0, g1) that hold this rank's tokens, the remote tokens of
    those groups in from the gathered probabilities (without gradients)
    and out of the expert input (zeros). The expert hidden's dropout draws
    the mask of every group and keeps those."""
    n, d = xf.shape
    e = probs.shape[-1]
    s = _auto_group(ids.total, opts.group_size)
    cap = max(1, int(math.ceil(opts.top_k * s / e * opts.capacity_factor)))
    g0, g1 = (0, 1) if ids.first is None else (ids.first // s, ids.last // s + 1)
    g = g1 - g0
    mine = ids.mine
    pos = ids.ids[mine] - g0 * s       # this rank's tokens in the groups
    rem = probs * valid[:, None]
    every = ids.global_rows(torch.cat([rem, valid[:, None]], dim=1))[g0 * s:g1 * s]
    remaining = every[:, :e].index_copy(0, pos, rem[mine]).reshape(g, s, e)
    valid_g = every[:, e].reshape(g, s)
    counts = torch.zeros((g, e), device=xf.device)
    rounds = []
    top1_assign = None
    for _ in range(opts.top_k):
        onehot, gate, disp, counts = _top1_round(remaining, valid_g, counts,
                                                 cap)
        if top1_assign is None:
            top1_assign = onehot.reshape(g * s, e)[pos]
        rounds.append((gate, disp))
        remaining = remaining * (1.0 - onehot)
    if opts.top_k > 1:  # normalize the selected gates; top-1 keeps the prob
        denom = sum(gt for gt, _ in rounds) + 1e-9
        rounds = [(gt / denom, disp) for gt, disp in rounds]
    combine = sum(gt[..., None, None] * disp for gt, disp in rounds)
    dispatch = sum(disp for _, disp in rounds)[:, :, _local_experts(e)]
    xg = xf.new_zeros((g * s, d)).index_copy(
        0, pos, C.copy_to(xf, ("tp", "ep"))[mine])   # remote tokens: zeros
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(xf.dtype),
                             xg.reshape(g, s, d))
    expert_out, b2 = _expert_ffn(p, ctx, expert_in, dropout_p, e,
                                 groups=((0, ids.total // s, g0),))
    out = _combine("gsec,gecd->gsd", combine, expert_out, b2).reshape(g * s, d)
    return (xf.new_zeros((n, d)).index_copy(0, mine, out[pos]),
            probs.new_zeros((n, e)).index_copy(0, mine, top1_assign))


def _ragged_rows(ctx: nn.Ctx, dropout_p: float, flat_e, order, lo: int,
                 hi: int, ids: _TokenIds, top_k: int) -> tuple:
    """nn.dropout's split record of the expert hidden of the sorted rows
    order[lo:hi] (this ep rank's experts' runs): under an active reduction
    group, their rows of the global batch's sorted assignments (a padding
    frame's, row 0: its gate is 0), so that every rank draws the global
    mask and keeps its rows; else the slice [lo, hi) of this rank's. ()
    when nothing is drawn."""
    if not ctx.train or dropout_p == 0.0:
        return ()
    if not C.active():
        return ((0, len(order), lo),) if hi - lo < len(order) else ()
    every = ids.global_rows(flat_e.reshape(-1, top_k)).reshape(-1)
    rank_of = torch.empty_like(every)
    rank_of[torch.argsort(every, stable=True)] = torch.arange(
        every.numel(), device=every.device)
    a = order[lo:hi]
    tok = ids.ids[a // top_k]
    rows = torch.where(tok >= 0, rank_of[(tok * top_k + a % top_k).clamp(min=0)], 0)
    return ((0, every.numel(), rows),)


def _moe_ragged(p, ctx: nn.Ctx, xf, probs, valid, ids: _TokenIds,
                dropout_p: float, top_k: int):
    """unast_tpu/models/moe.py::_moe_ragged: the dropless path. The [N*K]
    assignments sorted by expert (stably, as jnp.argsort) give contiguous
    runs; each projection is one matmul per expert over its run, and the
    gated outputs add back per token. PAD tokens keep a real expert with
    gate 0. xf [N, D] -> (out [N, D], top-1 assignment one-hot [N, E]).
    Each token's output is its own; only the expert hidden's dropout
    reaches across ranks (_ragged_rows)."""
    n, d = xf.shape
    e = probs.shape[-1]
    vals, idx = _top_k(probs, top_k)                   # [N, K]
    if top_k > 1:
        vals = vals / (vals.sum(dim=-1, keepdim=True) + 1e-9)
    vals = vals * valid[:, None]
    flat_e = idx.reshape(-1)
    flat_g = vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sizes = torch.bincount(flat_e, minlength=e).tolist()   # one host sync
    starts = [sum(sizes[:i]) for i in range(e + 1)]
    # this ep rank's experts: their contiguous run of the sorted rows
    local = _local_experts(e)
    lo, hi = starts[local.start], starts[local.stop]
    tok = order[lo:hi] // top_k                        # source token ids
    xs = C.copy_to(xf, ("tp", "ep"))[tok]              # [rows, D]
    w1 = nn.weight(p["lin1"], xs.dtype)
    b1 = p["lin1"]["b"].to(xs.dtype)
    w2 = nn.weight(p["lin2"], xs.dtype)
    b2 = p["lin2"]["b"].to(xs.dtype)
    # an ep rank whose experts got no token runs one empty product, so
    # that its copy_to still reaches the loss and joins the backward's
    # all-reduce
    runs = [(ei - local.start, a - lo, a + sizes[ei] - lo)
            for ei, a in zip(range(local.start, local.stop), starts[local])
            if sizes[ei]] or [(0, 0, 0)]
    h = torch.cat([torch.relu(xs[a:z] @ w1[ei] + b1[ei]) for ei, a, z in runs])
    h = nn.dropout(ctx, h, dropout_p,
                   split=_ragged_rows(ctx, dropout_p, flat_e, order, lo, hi,
                                      ids, top_k) + C.split_of(h, -1))
    split_tp = C.axis_size("tp") > 1
    y = torch.cat([h[a:z] @ w2[ei] + (0 if split_tp else b2[ei])
                   for ei, a, z in runs])
    gate = C.copy_to(flat_g, ("tp", "ep"))[order[lo:hi], None].to(y.dtype)
    out = C.reduce_from(torch.zeros_like(xf).index_add(0, tok, y * gate),
                        ("tp", "ep"))
    if split_tp:   # lin2's bias, replicated over tp, reduced over ep alone
        bias = torch.cat([b2[ei].expand(z - a, -1) for ei, a, z in runs])
        gb = C.copy_to(flat_g, "ep")[order[lo:hi], None].to(y.dtype)
        out = out + C.reduce_from(
            torch.zeros_like(xf).index_add(0, tok, bias * gb), "ep")
    top1_assign = F.one_hot(idx[:, 0], e).float() * valid[:, None]
    return out, top1_assign


def _moe_dense(p, ctx: nn.Ctx, x, dropout_p: float, top_k: int):
    """unast_tpu/models/moe.py::_moe_dense: the exact no-drop path of a
    single decode step: every expert on every token, combined by the
    top-k gates. x: [B, 1, D]."""
    probs = _router_probs(p, x)                        # [B, T, E] float32
    e = probs.shape[-1]
    vals, idx = _top_k(probs, top_k)
    if top_k > 1:
        vals = vals / (vals.sum(dim=-1, keepdim=True) + 1e-9)
    gates = (F.one_hot(idx, e).float() * vals[..., None]).sum(dim=-2)
    w1 = nn.weight(p["lin1"], x.dtype)
    b1 = p["lin1"]["b"].to(x.dtype)
    h = torch.relu(torch.einsum("btd,edf->btef", C.copy_to(x, ("tp", "ep")), w1)
                   + b1[None, None])
    h = nn.dropout(ctx, h, dropout_p, split=_splits(-2, -1, h, e))
    w2 = nn.weight(p["lin2"], x.dtype)
    b2 = p["lin2"]["b"].to(x.dtype)
    y = torch.einsum("btef,efd->bted", h, w2)
    if C.axis_size("tp") > 1:
        return _combine("bte,bted->btd", gates, y, b2)
    return _combine("bte,bted->btd", gates, y + b2[None, None], None)
