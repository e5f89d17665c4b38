"""Post-LN transformer encoder, teacher-forced decoder and the KV-cached
incremental decode step, mirroring `unast_tpu/models/transformer.py` on its
unrolled path.

Batch-first [B, T, D] throughout; masks are additive float32 biases;
softmax and layernorm run in float32 whatever the activation dtype.
`scan_layers`, `remat`, pipeline stages and MoE come with later slices.
"""

import math
from typing import List, NamedTuple

import torch

from .. import nn
from ..ops.attention import flash_attention

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
    w = torch.cat([p["w"].to(x.dtype) for p in ps], dim=1)
    b = torch.cat([p["b"] for p in ps])
    y = x @ w + b.to(x.dtype)
    return list(torch.split(y, y.shape[-1] // len(ps), dim=-1))


def attention_core(q, k, v, bias, ctx: nn.Ctx, dropout_p: float,
                   weights_out=None):
    """unast_tpu/models/transformer.py::attention_core.

    q: [B, Tq, H, Dh], k/v: [B, Tk, H, Dh], bias: additive [B|1, 1|H, Tq, Tk]
    or None. Scores are float32 (q and k upcast before the product, as
    preferred_element_type=f32 does); the probabilities are cast to v's
    dtype and the product accumulates in float32 before the cast back. If
    `weights_out` is a list, the float32 pre-dropout probabilities
    [B, H, Tq, Tk] are appended (the guided-attention loss reads them)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    if weights_out is not None:
        weights_out.append(w)
    w = nn.dropout(ctx, w, dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def mha(p, ctx: nn.Ctx, q_in, kv_in, bias, nhead: int, dropout_p: float,
        impl: str = "xla", kv_lens=None, causal: bool = False,
        weights_out=None):
    """unast_tpu/models/transformer.py::mha (non-cached attention).
    impl='flash' runs ops/attention.py::flash_attention with (kv_lens,
    causal) in place of the additive bias, unless `weights_out` asks for
    the probabilities, which the kernel never forms (attention_core then);
    attention-weight dropout is not applied on the flash path."""
    if q_in is kv_in:
        q, k, v = _fused_proj([p["q"], p["k"], p["v"]], q_in)
    else:
        q = nn.linear(p["q"], q_in)
        k, v = _fused_proj([p["k"], p["v"]], kv_in)
    q, k, v = (_split_heads(x, nhead) for x in (q, k, v))
    if impl == "flash" and weights_out is None:
        o = flash_attention(q, k, v, kv_lens, causal=causal)
    else:
        o = attention_core(q, k, v, bias, ctx, dropout_p,
                           weights_out=weights_out)
    b, t, h, dh = o.shape
    return nn.linear(p["out"], o.reshape(b, t, h * dh))


# ---------------------------------------------------------------------------
# Mask/bias builders
# ---------------------------------------------------------------------------


def padding_bias(pad_mask: torch.Tensor) -> torch.Tensor:
    """unast_tpu/models/transformer.py::padding_bias: bool [B, Tk] (True =
    PAD) -> additive float32 [B, 1, 1, Tk]."""
    zero = torch.zeros((), dtype=torch.float32, device=pad_mask.device)
    return torch.where(pad_mask, zero + NEG_INF, zero)[:, None, None, :]


def causal_bias(t: int, device=None) -> torch.Tensor:
    """unast_tpu/models/transformer.py::causal_bias: additive [1, 1, T, T]."""
    m = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
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
                       ffn_dim: int):
    """unast_tpu/models/transformer.py::encoder_layer_init (dense FFN)."""
    return {
        "attn": mha_init(gen, d_model, nhead),
        "ln1": nn.layernorm_init(d_model),
        "ln2": nn.layernorm_init(d_model),
        "lin1": nn.linear_init(gen, d_model, ffn_dim, torch_default=True),
        "lin2": nn.linear_init(gen, ffn_dim, d_model, torch_default=True),
    }


def encoder_init(gen: torch.Generator, d_model: int, nhead: int, ffn_dim: int,
                 nlayers: int):
    """unast_tpu/models/transformer.py::encoder_init."""
    return {"layers": [encoder_layer_init(gen, d_model, nhead, ffn_dim)
                       for _ in range(nlayers)]}


def _ffn(p, ctx: nn.Ctx, x, dropout_p: float):
    """unast_tpu/models/transformer.py::_ffn (dense FFN only)."""
    if "moe" in p:
        raise NotImplementedError("MoE FFN layers come with a later slice")
    h = nn.dropout(ctx, torch.relu(nn.linear(p["lin1"], x)), dropout_p)
    return nn.linear(p["lin2"], h)


def encoder_layer(p, ctx: nn.Ctx, x, bias, nhead: int, dropout_p: float,
                  impl: str = "xla", kv_lens=None):
    """unast_tpu/models/transformer.py::encoder_layer (post-LN)."""
    a = mha(p["attn"], ctx, x, x, bias, nhead, dropout_p,
            impl=impl, kv_lens=kv_lens)
    x = nn.layernorm(p["ln1"], x + nn.dropout(ctx, a, dropout_p))
    f = _ffn(p, ctx, x, dropout_p)
    return nn.layernorm(p["ln2"], x + nn.dropout(ctx, f, dropout_p))


def encoder(p, ctx: nn.Ctx, x, pad_mask, nhead: int, dropout_p: float,
            impl: str = "xla", extra_bias=None):
    """unast_tpu/models/transformer.py::encoder, unrolled path. x: [B, T, D],
    pad_mask: bool [B, T] True = PAD. impl='flash' passes the per-row
    valid lengths (kv_lens) to the kernel instead of the bias.
    extra_bias: an additive [1|B, 1|H, T, T] bias summed with the padding
    bias in every layer (chunk_bias, the CTC encoder's relative bias); it
    needs impl='xla' (ValueError otherwise: the kernel takes only kv_lens
    and causal, as JAX asserts)."""
    if extra_bias is not None and impl == "flash":
        raise ValueError("extra_bias requires the xla attention path")
    bias = padding_bias(pad_mask) if impl != "flash" else None
    if extra_bias is not None:
        bias = bias + extra_bias
    kv_lens = ((~pad_mask).sum(dim=1, dtype=torch.int32)
               if impl == "flash" else None)
    for lp in p["layers"]:
        x = encoder_layer(lp, ctx, x, bias, nhead, dropout_p,
                          impl=impl, kv_lens=kv_lens)
    return x


# ---------------------------------------------------------------------------
# Decoder (parallel teacher-forced path)
# ---------------------------------------------------------------------------


def decoder_layer_init(gen: torch.Generator, d_model: int, nhead: int,
                       ffn_dim: int):
    """unast_tpu/models/transformer.py::decoder_layer_init (dense FFN)."""
    return {
        "self": mha_init(gen, d_model, nhead),
        "cross": mha_init(gen, d_model, nhead),
        "ln1": nn.layernorm_init(d_model),
        "ln2": nn.layernorm_init(d_model),
        "ln3": nn.layernorm_init(d_model),
        "lin1": nn.linear_init(gen, d_model, ffn_dim, torch_default=True),
        "lin2": nn.linear_init(gen, ffn_dim, d_model, torch_default=True),
    }


def decoder_init(gen: torch.Generator, d_model: int, nhead: int, ffn_dim: int,
                 nlayers: int):
    """unast_tpu/models/transformer.py::decoder_init."""
    return {"layers": [decoder_layer_init(gen, d_model, nhead, ffn_dim)
                       for _ in range(nlayers)]}


def decoder_layer(p, ctx: nn.Ctx, x, memory, self_bias, cross_bias,
                  nhead: int, dropout_p: float, impl: str = "xla",
                  tgt_lens=None, mem_lens=None, cross_weights_out=None):
    """unast_tpu/models/transformer.py::decoder_layer (post-LN, dense FFN):
    causal self-attention, cross-attention over memory, FFN."""
    a = mha(p["self"], ctx, x, x, self_bias, nhead, dropout_p,
            impl=impl, kv_lens=tgt_lens, causal=True)
    x = nn.layernorm(p["ln1"], x + nn.dropout(ctx, a, dropout_p))
    a = mha(p["cross"], ctx, x, memory, cross_bias, nhead, dropout_p,
            impl=impl, kv_lens=mem_lens, weights_out=cross_weights_out)
    x = nn.layernorm(p["ln2"], x + nn.dropout(ctx, a, dropout_p))
    f = _ffn(p, ctx, x, dropout_p)
    return nn.layernorm(p["ln3"], x + nn.dropout(ctx, f, dropout_p))


def decoder(p, ctx: nn.Ctx, x, memory, tgt_pad_mask, mem_pad_mask,
            nhead: int, dropout_p: float, impl: str = "xla",
            cross_weights_out=None):
    """unast_tpu/models/transformer.py::decoder, the unrolled path:
    teacher-forced parallel decode. x: [B, Tt, D], memory: [B, Ts, D],
    pad masks bool True = PAD. impl='flash' passes the target and memory
    valid lengths to the kernel (causal self-attention); if
    `cross_weights_out` is a list, each layer's float32 cross-attention
    probabilities [B, H, Tt, Ts] are appended (that attention then runs
    through attention_core)."""
    t = x.shape[1]
    self_bias = causal_bias(t, x.device) + padding_bias(tgt_pad_mask)
    cross_bias = padding_bias(mem_pad_mask)
    tgt_lens = mem_lens = None
    if impl == "flash":
        tgt_lens = (~tgt_pad_mask).sum(dim=1, dtype=torch.int32)
        mem_lens = (~mem_pad_mask).sum(dim=1, dtype=torch.int32)
    for lp in p["layers"]:
        x = decoder_layer(lp, ctx, x, memory, self_bias, cross_bias, nhead,
                          dropout_p, impl=impl, tgt_lens=tgt_lens,
                          mem_lens=mem_lens,
                          cross_weights_out=cross_weights_out)
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
    and project the cross-attention K/V once per sequence."""
    b, _, d = memory.shape
    nlayers = len(p["layers"])
    kv = [_fused_proj([lp["cross"]["k"], lp["cross"]["v"]], memory)
          for lp in p["layers"]]
    cross_k = torch.stack([_split_heads(k, nhead) for k, _ in kv])
    cross_v = torch.stack([_split_heads(v, nhead) for _, v in kv])
    shape = (nlayers, b, max_len, nhead, d // nhead)
    return DecodeCache(torch.zeros(shape, dtype=memory.dtype, device=memory.device),
                       torch.zeros(shape, dtype=memory.dtype, device=memory.device),
                       cross_k, cross_v)


def decoder_step(p, ctx: nn.Ctx, x, pos: int, cache: DecodeCache, mem_bias,
                 nhead: int, dropout_p: float):
    """unast_tpu/models/transformer.py::decoder_step, unrolled path. One
    decode step of x [B, 1, D] at position `pos` (a Python int). Writes this
    step's K/V into the cache IN PLACE and returns (y [B, 1, D], cache).

    Self-attention reads cache positions [0, pos] only. JAX attends over
    the whole max_len buffer with -1e9 on the positions past `pos`; those
    carry weight exp(-1e9 - m) = 0 exactly in float32, so the result is
    the same up to the order of the sums."""
    for li, lp in enumerate(p["layers"]):
        q, k_t, v_t = (_split_heads(y, nhead) for y in _fused_proj(
            [lp["self"]["q"], lp["self"]["k"], lp["self"]["v"]], x))
        cache.self_k[li, :, pos] = k_t[:, 0]
        cache.self_v[li, :, pos] = v_t[:, 0]
        a = attention_core(q, cache.self_k[li, :, :pos + 1],
                           cache.self_v[li, :, :pos + 1], None, ctx, dropout_p)
        b_, t_, h_, dh_ = a.shape
        a = nn.linear(lp["self"]["out"], a.reshape(b_, t_, h_ * dh_))
        x = nn.layernorm(lp["ln1"], x + nn.dropout(ctx, a, dropout_p))

        q = _split_heads(nn.linear(lp["cross"]["q"], x), nhead)
        a = attention_core(q, cache.cross_k[li], cache.cross_v[li],
                           mem_bias, ctx, dropout_p)
        a = nn.linear(lp["cross"]["out"], a.reshape(b_, t_, h_ * dh_))
        x = nn.layernorm(lp["ln2"], x + nn.dropout(ctx, a, dropout_p))

        f = _ffn(lp, ctx, x, dropout_p)
        x = nn.layernorm(lp["ln3"], x + nn.dropout(ctx, f, dropout_p))
    return x, cache
