"""Post-LN transformer encoder, teacher-forced decoder and the KV-cached
incremental decode step, mirroring `unast_tpu/models/transformer.py` on its
unrolled path.

Batch-first [B, T, D] throughout; masks are additive float32 biases;
softmax and layernorm run in float32 whatever the activation dtype.
A layer's FFN is the MoE FFN (models/moe.py) when it carries "moe".

`scan_layers` is the same loop over the same per-layer params, each layer
with its own generator seeded from one draw of the ctx (JAX's
fold_in(base, li) of _layer_ctx). `remat` wraps each layer in
torch.utils.checkpoint (non-reentrant) with those per-layer generators, so
the recompute draws the same dropout masks; `remat_policy` picks what a
layer saves (_ckpt). MoE aux losses of a scanned or checkpointed layer are
its output and reach the outer ctx once (_take_aux).

`pp > 1` runs a stack as GPipe stages (parallel/pipeline.py::gpipe_stack,
as JAX's encoder and decoder call it): over the mesh's pp axis when the
step has one, else the same schedule in one process; MoE stacks and a
decoder that returns its cross-attention weights take the plain stack,
as in JAX. Inside a time-split region (parallel/collectives.py's
sequence) x holds a sequence-parallel rank's frames against whole-
sequence pad masks and memory: self-attention gathers K and V over the
sp ranks and a causal one offsets its queries by the rank's first frame.
"""

import functools
import math
from typing import List, NamedTuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import nn
from ..ops.attention import flash_attention
from ..parallel import collectives as C

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Multi-head attention
# ---------------------------------------------------------------------------


def mha_init(gen: torch.Generator, d_model: int, nhead: int):
    """unast_tpu/models/transformer.py::mha_init."""
    def in_proj():
        w = nn.xavier_uniform(gen, (d_model, d_model), 1.0,
                              fan_in=d_model, fan_out=3 * d_model)
        return {"w": w, "b": torch.zeros(d_model)}

    q, k, v = in_proj(), in_proj(), in_proj()
    out = nn.linear_init(gen, d_model, d_model, torch_default=True)
    out["b"] = torch.zeros(d_model)
    return {"q": q, "k": k, "v": v, "out": out}


def _split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """unast_tpu/models/transformer.py::_split_heads: [B,T,D] -> [B,T,H,D/H]."""
    b, t, d = x.shape
    return x.reshape(b, t, nhead, d // nhead)


def _fused_proj(ps, x: torch.Tensor) -> List[torch.Tensor]:
    """unast_tpu/models/transformer.py::_fused_proj: several same-input
    [D, D] projections as one wide matmul, split back (views)."""
    w = torch.cat([nn.weight(p, x.dtype) for p in ps], dim=1)
    b = torch.cat([p["b"] for p in ps])
    y = x @ w + b.to(x.dtype)
    return list(torch.split(y, y.shape[-1] // len(ps), dim=-1))


def attention_core(q, k, v, bias, ctx: nn.Ctx, dropout_p: float,
                   weights_out=None, head_split=()):
    """unast_tpu/models/transformer.py::attention_core.

    q: [B, Tq, H, Dh], k/v: [B, Tk, H, Dh], bias: additive [B|1, 1|H, Tq, Tk]
    or None. Scores are float32 (q and k upcast before the product, as
    preferred_element_type=f32 does); the probabilities are cast to v's
    dtype and the product accumulates in float32 before the cast back. If
    `weights_out` is a list, the float32 pre-dropout probabilities
    [B, H, Tq, Tk] are appended (the guided-attention loss reads them).
    head_split: nn.dropout's split record of the probabilities: under
    tensor parallelism the local heads (dim 1), inside a time-split region
    the rank's queries (dim 2)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    if weights_out is not None:
        weights_out.append(w)
    w = nn.dropout(ctx, w, dropout_p, split=head_split)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def local_heads(nhead: int) -> int:
    """The heads of this rank: nhead over the active tp axis (its q/k/v
    column slices hold nhead / tp whole heads)."""
    return nhead // C.axis_size("tp")


def row_linear(p, x: torch.Tensor) -> torch.Tensor:
    """nn.linear of a layer split by rows over the active tp axis (the
    attention out-projection, the FFN down-projections): the partial
    products all-reduced, then the bias, replicated, added once. Plain
    nn.linear without the axis."""
    if C.axis_size("tp") == 1:
        return nn.linear(p, x)
    y = C.reduce_from(x @ nn.weight(p, x.dtype))
    return y + p["b"].to(x.dtype) if "b" in p else y


def mha(p, ctx: nn.Ctx, q_in, kv_in, bias, nhead: int, dropout_p: float,
        impl: str = "xla", kv_lens=None, causal: bool = False,
        weights_out=None):
    """unast_tpu/models/transformer.py::mha (non-cached attention).
    impl='flash' runs ops/attention.py::flash_attention with (kv_lens,
    causal) in place of the additive bias, unless `weights_out` asks for
    the probabilities, which the kernel never forms (attention_core then);
    attention-weight dropout is not applied on the flash path.

    Under tensor parallelism (parallel/collectives.py's tp axis) q/k/v are
    this rank's column slices and `out` its row slice: the rank attends
    with its nhead / tp heads (a per-head bias takes their slice), and the
    out-projection's partial sums are all-reduced; `weights_out` then gets
    the local heads' probabilities.

    Inside a time-split region q_in holds this rank's frames: a
    self-attention gathers its K and V over the sp ranks (the whole
    sequence's keys; kv_lens and the bias are the whole sequence's), and a
    causal one offsets its queries by the rank's first frame (q_start);
    cross-attention reads the whole memory."""
    self_attn = q_in is kv_in
    q_in = C.copy_to(q_in)
    kv_in = q_in if self_attn else C.copy_to(kv_in)
    if self_attn:
        q, k, v = _fused_proj([p["q"], p["k"], p["v"]], q_in)
    else:
        q = nn.linear(p["q"], q_in)
        k, v = _fused_proj([p["k"], p["v"]], kv_in)
    seq = C.seq()
    if self_attn and seq is not None:
        k, v = C.gather_time(torch.cat([k, v], dim=-1)).chunk(2, dim=-1)
    q_start = seq.start if seq is not None and causal else 0
    heads = local_heads(nhead)
    q, k, v = (_split_heads(x, heads) for x in (q, k, v))
    if impl == "flash" and weights_out is None:
        o = flash_attention(q, k, v, kv_lens, causal=causal, q_start=q_start)
    else:
        if bias is not None and bias.shape[1] > 1:
            bias = C.take(bias, 1)
        o = attention_core(q, k, v, bias, ctx, dropout_p,
                           weights_out=weights_out,
                           head_split=C.split_of(q, 2, at=1)
                           + C.time_split(q, dim=2))
    b, t, h, dh = o.shape
    return row_linear(p["out"], o.reshape(b, t, h * dh))


# ---------------------------------------------------------------------------
# Mask/bias builders
# ---------------------------------------------------------------------------


def padding_bias(pad_mask: torch.Tensor) -> torch.Tensor:
    """unast_tpu/models/transformer.py::padding_bias: bool [B, Tk] (True =
    PAD) -> additive float32 [B, 1, 1, Tk]."""
    zero = torch.zeros((), dtype=torch.float32, device=pad_mask.device)
    return torch.where(pad_mask, zero + NEG_INF, zero)[:, None, None, :]


def causal_bias(t: int, device=None, q_start: int = 0, tq=None) -> torch.Tensor:
    """unast_tpu/models/transformer.py::causal_bias: additive [1, 1, T, T];
    with q_start / tq, the rows of queries [q_start, q_start + tq) (a
    sequence-parallel rank's) against the T keys: [1, 1, tq, T]."""
    tq = t if tq is None else tq
    m = (torch.arange(t, device=device)[None, :]
         <= torch.arange(q_start, q_start + tq, device=device)[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(m, zero, zero + NEG_INF)[None, None]


def chunk_bias(t: int, chunk: int, left_chunks: int, device=None) -> torch.Tensor:
    """unast_tpu/models/transformer.py::chunk_bias: additive [1, 1, T, T]
    block-chunk mask (the streaming CTC encoder's): a query in chunk
    cq = q // chunk attends keys in chunks [cq - left_chunks, cq];
    left_chunks < 0 = unlimited left context."""
    cq = torch.arange(t, device=device) // chunk
    ok = cq[None, :] <= cq[:, None]  # no future chunks
    if left_chunks >= 0:
        ok &= cq[None, :] >= cq[:, None] - left_chunks
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, zero + NEG_INF)[None, None]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_layer_init(gen: torch.Generator, d_model: int, nhead: int,
                       ffn_dim: int, moe: int = 0):
    """unast_tpu/models/transformer.py::encoder_layer_init; moe > 0 gives
    the layer an MoE FFN of that many experts."""
    p = {
        "attn": mha_init(gen, d_model, nhead),
        "ln1": nn.layernorm_init(d_model),
        "ln2": nn.layernorm_init(d_model),
    }
    p.update(_ffn_init(gen, d_model, ffn_dim, moe))
    return p


def _ffn_init(gen: torch.Generator, d_model: int, ffn_dim: int, moe: int):
    """A layer's FFN params: an MoE FFN of `moe` experts, else the dense
    lin1 / lin2 pair."""
    if moe > 0:
        from . import moe as MoE
        return {"moe": MoE.moe_init(gen, d_model, ffn_dim, moe)}
    return {"lin1": nn.linear_init(gen, d_model, ffn_dim, torch_default=True),
            "lin2": nn.linear_init(gen, ffn_dim, d_model, torch_default=True)}


def encoder_init(gen: torch.Generator, d_model: int, nhead: int, ffn_dim: int,
                 nlayers: int, moe: int = 0):
    """unast_tpu/models/transformer.py::encoder_init."""
    return {"layers": [encoder_layer_init(gen, d_model, nhead, ffn_dim, moe)
                       for _ in range(nlayers)]}


def _ffn(p, ctx: nn.Ctx, x, dropout_p: float, pad_mask=None,
         moe_opts=(1, 1.25)):
    """unast_tpu/models/transformer.py::_ffn: the dense relu FFN, or the
    MoE FFN when the layer carries expert params. Under tensor parallelism
    lin1 is a column split and lin2 a row split (the hidden's dropout
    draws the whole mask and keeps this rank's columns)."""
    if "moe" in p:
        from . import moe as MoE
        return MoE.moe_ffn(p["moe"], ctx, x, pad_mask, dropout_p,
                           opts=moe_opts)
    h = torch.relu(nn.linear(p["lin1"], C.copy_to(x)))
    h = nn.dropout(ctx, h, dropout_p,
                   split=C.split_of(h, -1) + C.time_split(h))
    return row_linear(p["lin2"], h)


def _has_moe(p) -> bool:
    """unast_tpu/models/transformer.py::_has_moe."""
    return "moe" in p["layers"][0]


def _take_aux(inner: nn.Ctx, device) -> torch.Tensor:
    """unast_tpu/models/transformer.py::_take_aux: the sum of the aux losses
    an inner-layer ctx collected (0 when none). A scanned or checkpointed
    layer returns it as an output, so that the outer ctx gets it once and
    a recompute does not append it again."""
    if inner.aux_losses:
        return sum(inner.aux_losses)
    return torch.zeros((), device=device)


# aten ops whose outputs a policy saves (JAX's checkpoint policies):
# 'dots' the unbatched products (dots_with_no_batch_dims_saveable),
# 'dots_all' the batched ones too (dots_saveable).
_SAVED_OPS = {"dots": ("mm", "addmm"),
              "dots_all": ("mm", "addmm", "bmm", "baddbmm")}


def _ckpt(fn, policy: str = ""):
    """unast_tpu/models/transformer.py::_ckpt: fn under
    torch.utils.checkpoint (non-reentrant). policy '' saves nothing in the
    layer; 'dots' saves the outputs of aten.mm and aten.addmm; 'dots_all'
    also those of aten.bmm and aten.baddbmm (the attention products), by
    create_selective_checkpoint_contexts. The flash kernel is no aten op,
    so it runs again in the recompute, as JAX recomputes a pallas_call.
    With gradients off there is nothing to recompute and fn runs plainly.

    The recompute runs inside the backward, after the forward left its
    time-split region: fn runs inside the collectives context active when
    the layer ran (collectives.snapshot / restored), so that the
    recompute gathers K and V, exchanges halos, takes BatchNorm's
    statistics and draws dropout over the sp ranks as the forward did
    (every sp rank recomputes its layers in one order, posting the same
    collectives)."""
    if policy:
        ops = [getattr(torch.ops.aten, n).default for n in _SAVED_OPS[policy]]
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, ops)}
    else:
        kw = {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        snap = C.snapshot()

        def inside(*a):
            with C.restored(snap):
                return fn(*a)

        return checkpoint(inside, *args, use_reentrant=False, **kw)

    return run


def _stack_seed(ctx: nn.Ctx):
    """One draw of the ctx's generator, the base of a scanned or
    checkpointed stack's per-layer generators (JAX's rng_base =
    ctx.next_rng()); None when nothing will draw (eval mode or no
    generator)."""
    if not ctx.train or ctx.generator is None:
        return None
    g = ctx.next_rng()
    return int(torch.randint(0, 2 ** 62, (1,), generator=g,
                             device=g.device).item())


def _layer_ctx(seed, train: bool, li: int, device, collect: bool = False):
    """unast_tpu/models/transformer.py::_layer_ctx: layer li's ctx, its
    generator seeded from (seed, li) (nn.fold_generator, JAX's fold_in);
    collect gives it its own aux list (see _take_aux)."""
    gen = None if seed is None else nn.fold_generator(seed, li, device)
    return nn.Ctx(generator=gen, train=train,
                  aux_losses=[] if collect else None)


def _run_layers(ctx: nn.Ctx, layers, x, layer_fn, collect: bool, remat: bool,
                remat_policy: str):
    """The scanned or checkpointed stack: layer_fn(lp, inner_ctx, x) over
    `layers`, each layer with its _layer_ctx, under _ckpt when remat. The
    per-layer aux sums reach ctx.aux_losses once when collect."""
    seed = _stack_seed(ctx)

    def one(lp, li, x):
        inner = _layer_ctx(seed, ctx.train, li, x.device, collect=collect)
        return layer_fn(lp, inner, x), _take_aux(inner, x.device)

    if remat:
        one = _ckpt(one, remat_policy)
    aux = torch.zeros((), device=x.device)
    for li, lp in enumerate(layers):
        x, a = one(lp, li, x)
        aux = aux + a
    if collect:
        ctx.aux_losses.append(aux)
    return x


def encoder_layer(p, ctx: nn.Ctx, x, bias, nhead: int, dropout_p: float,
                  impl: str = "xla", kv_lens=None, pad_mask=None,
                  moe_opts=(1, 1.25)):
    """unast_tpu/models/transformer.py::encoder_layer (post-LN)."""
    a = mha(p["attn"], ctx, x, x, bias, nhead, dropout_p,
            impl=impl, kv_lens=kv_lens)
    x = nn.layernorm(p["ln1"], x + _drop(ctx, a, dropout_p))
    f = _ffn(p, ctx, x, dropout_p, pad_mask=pad_mask, moe_opts=moe_opts)
    return nn.layernorm(p["ln2"], x + _drop(ctx, f, dropout_p))


def _drop(ctx: nn.Ctx, x, dropout_p: float):
    """A layer's residual-branch dropout of x [B, T, D] (the whole
    sequence's mask inside a time-split region)."""
    return nn.dropout(ctx, x, dropout_p, split=C.time_split(x))


def encoder(p, ctx: nn.Ctx, x, pad_mask, nhead: int, dropout_p: float,
            impl: str = "xla", scan_layers: bool = False,
            remat: bool = False, moe_opts=(1, 1.25), remat_policy: str = "",
            extra_bias=None, pp: int = 1, pp_micro: int = 0):
    """unast_tpu/models/transformer.py::encoder. x: [B, T, D], pad_mask:
    bool [B, T] True = PAD. impl='flash' passes the per-row valid lengths
    (kv_lens) to the kernel instead of the bias. extra_bias: an additive
    [1|B, 1|H, T, T] bias summed with the padding bias in every layer
    (chunk_bias, the CTC encoder's relative bias); it needs impl='xla'
    (ValueError otherwise: the kernel takes only kv_lens and causal, as
    JAX asserts). scan_layers / remat / remat_policy: see the module
    docstring; moe_opts: models/moe.py::MoeOpts for MoE layers. pp > 1:
    GPipe stages of pp_micro micro-batches (0: pipeline.default_micro),
    an MoE stack excepted (module docstring)."""
    if extra_bias is not None and impl == "flash":
        raise ValueError("extra_bias requires the xla attention path")
    bias = padding_bias(pad_mask) if impl != "flash" else None
    if extra_bias is not None:
        bias = bias + extra_bias
    kv_lens = ((~pad_mask).sum(dim=1, dtype=torch.int32)
               if impl == "flash" else None)
    if pp > 1 and not _has_moe(p):
        from ..parallel.pipeline import gpipe_stack

        def one(lp, lctx, x_mb, bias_mb, kvl_mb, pad_mb):
            return encoder_layer(lp, lctx, x_mb, bias_mb, nhead, dropout_p,
                                 impl=impl, kv_lens=kvl_mb, pad_mask=pad_mb,
                                 moe_opts=moe_opts)

        return gpipe_stack(p["layers"], len(p["layers"]), pp, ctx, x,
                           (bias, kv_lens, pad_mask), one, n_micro=pp_micro)
    layer = functools.partial(encoder_layer, bias=bias, nhead=nhead,
                              dropout_p=dropout_p, impl=impl, kv_lens=kv_lens,
                              pad_mask=pad_mask, moe_opts=moe_opts)
    if scan_layers or remat:
        collect = ctx.aux_losses is not None and _has_moe(p)
        return _run_layers(ctx, p["layers"], x, layer, collect, remat,
                           remat_policy)
    for lp in p["layers"]:
        x = layer(lp, ctx, x)
    return x


# ---------------------------------------------------------------------------
# Decoder (parallel teacher-forced path)
# ---------------------------------------------------------------------------


def decoder_layer_init(gen: torch.Generator, d_model: int, nhead: int,
                       ffn_dim: int, moe: int = 0):
    """unast_tpu/models/transformer.py::decoder_layer_init; moe > 0 gives
    the layer an MoE FFN of that many experts."""
    p = {
        "self": mha_init(gen, d_model, nhead),
        "cross": mha_init(gen, d_model, nhead),
        "ln1": nn.layernorm_init(d_model),
        "ln2": nn.layernorm_init(d_model),
        "ln3": nn.layernorm_init(d_model),
    }
    p.update(_ffn_init(gen, d_model, ffn_dim, moe))
    return p


def decoder_init(gen: torch.Generator, d_model: int, nhead: int, ffn_dim: int,
                 nlayers: int, moe: int = 0):
    """unast_tpu/models/transformer.py::decoder_init."""
    return {"layers": [decoder_layer_init(gen, d_model, nhead, ffn_dim, moe)
                       for _ in range(nlayers)]}


def decoder_layer(p, ctx: nn.Ctx, x, memory, self_bias, cross_bias,
                  nhead: int, dropout_p: float, impl: str = "xla",
                  tgt_lens=None, mem_lens=None, cross_weights_out=None,
                  pad_mask=None, moe_opts=(1, 1.25)):
    """unast_tpu/models/transformer.py::decoder_layer (post-LN): causal
    self-attention, cross-attention over memory, FFN."""
    a = mha(p["self"], ctx, x, x, self_bias, nhead, dropout_p,
            impl=impl, kv_lens=tgt_lens, causal=True)
    x = nn.layernorm(p["ln1"], x + _drop(ctx, a, dropout_p))
    a = mha(p["cross"], ctx, x, memory, cross_bias, nhead, dropout_p,
            impl=impl, kv_lens=mem_lens, weights_out=cross_weights_out)
    x = nn.layernorm(p["ln2"], x + _drop(ctx, a, dropout_p))
    f = _ffn(p, ctx, x, dropout_p, pad_mask=pad_mask, moe_opts=moe_opts)
    return nn.layernorm(p["ln3"], x + _drop(ctx, f, dropout_p))


def decoder(p, ctx: nn.Ctx, x, memory, tgt_pad_mask, mem_pad_mask,
            nhead: int, dropout_p: float, impl: str = "xla",
            scan_layers: bool = False, cross_weights_out=None,
            remat: bool = False, moe_opts=(1, 1.25), remat_policy: str = "",
            pp: int = 1, pp_micro: int = 0):
    """unast_tpu/models/transformer.py::decoder: teacher-forced parallel
    decode. x: [B, Tt, D], memory: [B, Ts, D], pad masks bool True = PAD.
    impl='flash' passes the target and memory valid lengths to the kernel
    (causal self-attention); if `cross_weights_out` is a list, each
    layer's float32 cross-attention probabilities [B, H, Tt, Ts] are
    appended (that attention then runs through attention_core), and the
    stack is not rematerialised, as in JAX (the guided-attention loss
    needs the probabilities saved). scan_layers / remat / remat_policy /
    moe_opts / pp / pp_micro: as in encoder; the pipelined stack falls
    back to the plain one when cross_weights_out is asked for, as JAX's.
    Inside a time-split region x holds the rank's frames and
    tgt_pad_mask is the whole sequence's."""
    seq = C.seq()
    t = tgt_pad_mask.shape[1]
    self_bias = (causal_bias(t, x.device, seq.start, x.shape[1])
                 if seq is not None else causal_bias(t, x.device)
                 ) + padding_bias(tgt_pad_mask)
    cross_bias = padding_bias(mem_pad_mask)
    tgt_lens = mem_lens = None
    if impl == "flash":
        tgt_lens = (~tgt_pad_mask).sum(dim=1, dtype=torch.int32)
        mem_lens = (~mem_pad_mask).sum(dim=1, dtype=torch.int32)
    remat = remat and cross_weights_out is None
    if pp > 1 and cross_weights_out is None and not _has_moe(p):
        from ..parallel.pipeline import gpipe_stack
        sb = self_bias.expand((x.shape[0],) + self_bias.shape[1:])

        def one(lp, lctx, x_mb, mem_mb, sb_mb, cb_mb, tl_mb, ml_mb, pad_mb):
            return decoder_layer(lp, lctx, x_mb, mem_mb, sb_mb, cb_mb, nhead,
                                 dropout_p, impl=impl, tgt_lens=tl_mb,
                                 mem_lens=ml_mb, pad_mask=pad_mb,
                                 moe_opts=moe_opts)

        return gpipe_stack(p["layers"], len(p["layers"]), pp, ctx, x,
                           (memory, sb, cross_bias, tgt_lens, mem_lens,
                            tgt_pad_mask), one, n_micro=pp_micro)
    layer = functools.partial(decoder_layer, memory=memory,
                              self_bias=self_bias, cross_bias=cross_bias,
                              nhead=nhead, dropout_p=dropout_p, impl=impl,
                              tgt_lens=tgt_lens, mem_lens=mem_lens,
                              cross_weights_out=cross_weights_out,
                              pad_mask=tgt_pad_mask, moe_opts=moe_opts)
    if scan_layers or remat:
        collect = ctx.aux_losses is not None and _has_moe(p)
        return _run_layers(ctx, p["layers"], x, layer, collect, remat,
                           remat_policy)
    for lp in p["layers"]:
        x = layer(lp, ctx, x)
    return x


# ---------------------------------------------------------------------------
# Incremental decode with KV cache
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """unast_tpu/models/transformer.py::DecodeCache. Leaves are stacked over
    layers at axis 0; decoder_step writes self_k/self_v in place."""

    self_k: torch.Tensor   # [L, B, max_len, H, Dh]
    self_v: torch.Tensor   # [L, B, max_len, H, Dh]
    cross_k: torch.Tensor  # [L, B, Ts, H, Dh]
    cross_v: torch.Tensor  # [L, B, Ts, H, Dh]


def init_cache(p, memory: torch.Tensor, max_len: int, nhead: int) -> DecodeCache:
    """unast_tpu/models/transformer.py::init_cache: allocate the self caches
    and project the cross-attention K/V once per sequence (this rank's
    heads under tensor parallelism)."""
    b, _, d = memory.shape
    nlayers = len(p["layers"])
    heads = local_heads(nhead)
    memory = C.copy_to(memory)
    kv = [_fused_proj([lp["cross"]["k"], lp["cross"]["v"]], memory)
          for lp in p["layers"]]
    cross_k = torch.stack([_split_heads(k, heads) for k, _ in kv])
    cross_v = torch.stack([_split_heads(v, heads) for _, v in kv])
    shape = (nlayers, b, max_len, heads, d // nhead)
    return DecodeCache(torch.zeros(shape, dtype=memory.dtype, device=memory.device),
                       torch.zeros(shape, dtype=memory.dtype, device=memory.device),
                       cross_k, cross_v)


def decoder_step(p, ctx: nn.Ctx, x, pos: int, cache: DecodeCache, mem_bias,
                 nhead: int, dropout_p: float, moe_opts=(1, 1.25)):
    """unast_tpu/models/transformer.py::decoder_step, unrolled path. One
    decode step of x [B, 1, D] at position `pos` (a Python int). Writes this
    step's K/V into the cache IN PLACE and returns (y [B, 1, D], cache).

    Self-attention reads cache positions [0, pos] only. JAX attends over
    the whole max_len buffer with -1e9 on the positions past `pos`; those
    carry weight exp(-1e9 - m) = 0 exactly in float32, so the result is
    the same up to the order of the sums. JAX's scan_layers form of the
    step is the same loop. An MoE layer's FFN takes the exact dense
    path here (T == 1). Under tensor parallelism the cache holds this
    rank's heads and the projections are split as in mha."""
    heads = local_heads(nhead)
    for li, lp in enumerate(p["layers"]):
        q, k_t, v_t = (_split_heads(y, heads) for y in _fused_proj(
            [lp["self"]["q"], lp["self"]["k"], lp["self"]["v"]], C.copy_to(x)))
        split = C.split_of(q, 2, at=1)
        cache.self_k[li, :, pos] = k_t[:, 0]
        cache.self_v[li, :, pos] = v_t[:, 0]
        a = attention_core(q, cache.self_k[li, :, :pos + 1],
                           cache.self_v[li, :, :pos + 1], None, ctx, dropout_p,
                           head_split=split)
        b_, t_, h_, dh_ = a.shape
        a = row_linear(lp["self"]["out"], a.reshape(b_, t_, h_ * dh_))
        x = nn.layernorm(lp["ln1"], x + nn.dropout(ctx, a, dropout_p))

        q = _split_heads(nn.linear(lp["cross"]["q"], C.copy_to(x)), heads)
        a = attention_core(q, cache.cross_k[li], cache.cross_v[li],
                           mem_bias, ctx, dropout_p, head_split=split)
        a = row_linear(lp["cross"]["out"], a.reshape(b_, t_, h_ * dh_))
        x = nn.layernorm(lp["ln2"], x + nn.dropout(ctx, a, dropout_p))

        f = _ffn(lp, ctx, x, dropout_p, moe_opts=moe_opts)
        x = nn.layernorm(lp["ln3"], x + nn.dropout(ctx, f, dropout_p))
    return x, cache
