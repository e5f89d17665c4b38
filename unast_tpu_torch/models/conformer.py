"""Conformer speech encoder, mirroring `unast_tpu/models/conformer.py`
(Gulati et al. 2020), selected by `speech_encoder='conformer'`: the same
[B, T, D] -> [B, T, D] contract as the transformer speech encoder.

Block (pre-LN, macaron):
    x += 1/2 FFN(LN(x))          (swish, dropout)
    x += MHSA(LN(x))             (transformer.mha: fused QKV, the flash
                                  kernel with attn_impl='flash')
    x += Conv(LN(x))             (pointwise -> GLU -> depthwise(k) -> BN ->
                                  swish -> pointwise; pad frames zeroed
                                  before the depthwise window)
    x += 1/2 FFN(LN(x))
    x  = LN(x)

Absolute sinusoid positions come from the surrounding model; BatchNorm
statistics include the zeroed pad frames, as JAX's do. The BN state is the
layer's output, so a recompute under the checkpoint (remat) does not move
the running statistics a second time.

Under tensor parallelism (parallel/collectives.py's tp axis) the FFNs'
up and the conv module's conv_pw1 are column splits, down and conv_pw2
row splits (parallel/mesh.py). conv_pw1 feeds the GLU, so its rank slice
holds the matching parts of both halves (value channels [r d/tp, (r+1)
d/tp) and their gates); the depthwise conv and the BatchNorm then run on
those d/tp channels with their replicated per-channel leaves sliced at use
(their gradients all-reduced into the whole), and the new running
statistics are gathered whole. BatchNorm's statistics are per channel, so
the tp split needs no reduction of them (the dp one stays).
Inside a time-split region (parallel/collectives.py's sequence) x holds a
sequence-parallel rank's frames: attention gathers K and V, the
depthwise conv takes halos of k // 2 and k - 1 - k // 2 frames after the
pad mask, BatchNorm the whole sequences' statistics and each dropout the
whole sequence's mask.
"""

import torch
import torch.nn.functional as F

from .. import nn
from ..parallel import collectives as C
from . import transformer as T


def _ffn_init(gen: torch.Generator, d: int, ffn_dim: int):
    return {"ln": nn.layernorm_init(d),
            "up": nn.linear_init(gen, d, ffn_dim, torch_default=True),
            "down": nn.linear_init(gen, ffn_dim, d, torch_default=True)}


def _half_ffn(p, ctx: nn.Ctx, x, dropout_p: float):
    """unast_tpu/models/conformer.py::_half_ffn: x + 1/2 FFN(LN(x))."""
    h = F.silu(nn.linear(p["up"], C.copy_to(nn.layernorm(p["ln"], x))))
    h = nn.dropout(ctx, h, dropout_p,
                   split=C.split_of(h, -1) + C.time_split(h))
    return x + 0.5 * T._drop(ctx, T.row_linear(p["down"], h), dropout_p)


def _depthwise_init(gen: torch.Generator, d: int, kernel: int):
    """unast_tpu/models/conformer.py::_depthwise_init: w [k, 1, C], b [C]
    (torch Conv1d(groups=C)'s default init, fan_in = k)."""
    return {"w": nn.torch_linear_uniform(gen, (kernel, 1, d), kernel),
            "b": nn.torch_linear_uniform(gen, (d,), kernel)}


def _depthwise_conv(p, x, kernel: int):
    """unast_tpu/models/conformer.py::_depthwise_conv: a per-channel conv
    over time of x [B, T, C], F.conv1d(groups=C) with lax's asymmetric
    'same' pads (k // 2 left, k - 1 - k // 2 right); inside a time-split
    region the pads are the neighbouring ranks' frames (collectives.halo)."""
    c = x.shape[-1]
    xt = C.halo(x, kernel // 2, kernel - 1 - kernel // 2).transpose(1, 2)
    w = nn.weight(p, x.dtype).permute(2, 1, 0)             # [C, 1, k]
    return F.conv1d(xt, w, groups=c).transpose(1, 2) + p["b"].to(x.dtype)


def conformer_layer_init(gen: torch.Generator, d: int, nhead: int,
                         ffn_dim: int, kernel: int):
    """unast_tpu/models/conformer.py::conformer_layer_init -> (params,
    state {"bn": ...})."""
    params = {
        "ff1": _ffn_init(gen, d, ffn_dim),
        "attn_ln": nn.layernorm_init(d),
        "attn": T.mha_init(gen, d, nhead),
        "conv_ln": nn.layernorm_init(d),
        "conv_pw1": nn.linear_init(gen, d, 2 * d, torch_default=True),
        "conv_dw": _depthwise_init(gen, d, kernel),
        "conv_pw2": nn.linear_init(gen, d, d, torch_default=True),
        "ff2": _ffn_init(gen, d, ffn_dim),
        "out_ln": nn.layernorm_init(d),
    }
    params["conv_bn"], bn_s = nn.batchnorm_init(d)
    return params, {"bn": bn_s}


def conformer_layer(p, s, ctx: nn.Ctx, x, pad_mask, bias, nhead: int,
                    dropout_p: float, kernel: int, impl: str = "xla",
                    kv_lens=None):
    """unast_tpu/models/conformer.py::conformer_layer. x: [B, T, D],
    pad_mask bool [B, T] True = PAD (this rank's frames of it inside a
    time-split region, the padding frames PAD; bias and kv_lens are the
    whole sequence's). Returns (y, new_state)."""
    x = _half_ffn(p["ff1"], ctx, x, dropout_p)

    h = nn.layernorm(p["attn_ln"], x)
    a = T.mha(p["attn"], ctx, h, h, bias, nhead, dropout_p,
              impl=impl, kv_lens=kv_lens)
    x = x + T._drop(ctx, a, dropout_p)

    h = nn.layernorm(p["conv_ln"], x)
    h = h * (~pad_mask)[..., None].to(h.dtype)   # no pad leak into the conv
    h = F.glu(nn.linear(p["conv_pw1"], C.copy_to(h)), dim=-1)
    dw, bn, bn_s = p["conv_dw"], p["conv_bn"], s["bn"]
    if C.axis_size("tp") > 1:   # this rank's channels of the per-channel leaves
        dw, bn, bn_s = ({k: C.take(v, -1) for k, v in t.items()}
                        for t in (dw, bn, bn_s))
    h = _depthwise_conv(dw, h, kernel)
    h, bn_s = nn.batchnorm(bn, bn_s, h, ctx.train)
    if C.axis_size("tp") > 1:
        bn_s = {k: C.gather(v, -1) for k, v in bn_s.items()}
    h = T.row_linear(p["conv_pw2"], F.silu(h))
    x = x + T._drop(ctx, h, dropout_p)

    x = _half_ffn(p["ff2"], ctx, x, dropout_p)
    return nn.layernorm(p["out_ln"], x), {"bn": bn_s}


def conformer_encoder_init(gen: torch.Generator, d: int, nhead: int,
                           ffn_dim: int, nlayers: int, kernel: int):
    """unast_tpu/models/conformer.py::conformer_encoder_init -> (params,
    state), each with a `layers` list."""
    inits = [conformer_layer_init(gen, d, nhead, ffn_dim, kernel)
             for _ in range(nlayers)]
    return ({"layers": [p for p, _ in inits]},
            {"layers": [s for _, s in inits]})


def conformer_encoder(p, s, ctx: nn.Ctx, x, pad_mask, nhead: int,
                      dropout_p: float, kernel: int, impl: str = "xla",
                      scan_layers: bool = False, remat: bool = False,
                      remat_policy: str = ""):
    """unast_tpu/models/conformer.py::conformer_encoder: x [B, T, D] ->
    ([B, T, D], new_state). scan_layers and remat as in
    transformer.encoder: each layer then has its own generator seeded from
    one draw of the ctx, and under remat runs in transformer._ckpt, its BN
    state an output of the checkpointed function."""
    bias = T.padding_bias(pad_mask) if impl != "flash" else None
    kv_lens = ((~pad_mask).sum(dim=1, dtype=torch.int32)
               if impl == "flash" else None)

    local_pad = ~C.split_time(~pad_mask)

    def layer(lp, ls, c, x):
        return conformer_layer(lp, ls, c, x, local_pad, bias, nhead, dropout_p,
                               kernel, impl=impl, kv_lens=kv_lens)

    if scan_layers or remat:
        seed = T._stack_seed(ctx)

        def one(lp, ls, li, x):
            return layer(lp, ls, T._layer_ctx(seed, ctx.train, li, x.device),
                         x)

        if remat:
            one = T._ckpt(one, remat_policy)
    else:
        def one(lp, ls, li, x):
            return layer(lp, ls, ctx, x)

    new_states = []
    for li, (lp, ls) in enumerate(zip(p["layers"], s["layers"])):
        x, ns = one(lp, ls, li, x)
        new_states.append(ns)
    return x, {"layers": new_states}
