"""Shared NN modules of the port: masks, positional encoding, the speech and
text prenets (with the RNN text decoder's incremental causal prenet) and
postnets, the highway network and the CBHG of the vocoder. Mirrors
`unast_tpu/models/modules.py`; all activations are [B, T, C]
channels-last. Inside a time-split region (parallel/collectives.py's
sequence) they hold a sequence-parallel rank's frames: the convs take
halos (nn.conv1d), BatchNorm the whole sequences' statistics and each
dropout the whole sequence's mask (collectives.time_split); the caller
gives positional_encoding the rank's first frame as its offset.
"""

import functools
import math

import numpy as np
import torch

from .. import nn
from ..parallel import collectives as C
from .config import ModelConfig, VOCAB_SIZE, PAD_IDX


def lens_to_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """unast_tpu/models/modules.py::lens_to_mask: [B] -> bool [B, max_len],
    True where t < len."""
    pos = torch.arange(max_len, device=lens.device)[None, :]
    return pos < lens[:, None]


def noise_fn(ctx: nn.Ctx, x, mask_p: float = 0.3):
    """unast_tpu/models/modules.py::noise_fn: the denoising AE's input
    noise, zeroing each time step of x [B, T, D] with probability mask_p in
    train mode (a no-op in eval mode or at mask_p = 0)."""
    if not ctx.train or mask_p == 0.0:
        return x
    keep = torch.rand(x.shape[:2], generator=ctx.next_rng(),
                      device=x.device) < 1.0 - mask_p
    return x * keep[..., None].to(x.dtype)


# ---------------------------------------------------------------------------
# Positional encoding: x*sqrt(d) + PE, dropout .1
# ---------------------------------------------------------------------------


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """unast_tpu/models/modules.py::sinusoid_table."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


@functools.lru_cache(maxsize=8)
def _pe_table(d_model: int, device: torch.device) -> torch.Tensor:
    """The 5000-row table on `device`, built once per (width, device): the
    decode loops read one row of it per step."""
    return torch.from_numpy(sinusoid_table(5000, d_model)).to(device)


def positional_encoding(ctx: nn.Ctx, x, dropout_p: float = 0.1, offset: int = 0,
                        scale: bool = True):
    """unast_tpu/models/modules.py::positional_encoding. x: [B, T, D];
    `offset` is the position of x[:, 0] (incremental decode, or a
    sequence-parallel rank's first frame)."""
    d = x.shape[-1]
    t = x.shape[1]
    if torch.compiler.is_compiling():
        # under torch.export the table is a constant of the program; the
        # cache would keep the trace's fake tensor
        table = torch.from_numpy(sinusoid_table(offset + t, d)).to(x.device)
    else:
        table = _pe_table(d, x.device)
    pos = table[offset:offset + t]
    if scale:
        x = x * math.sqrt(d)
    x = x + pos[None, :, :].to(x.dtype)
    return nn.dropout(ctx, x, dropout_p, split=C.time_split(x))


# ---------------------------------------------------------------------------
# SpeechPrenet: 2-layer MLP num_mels -> s_pre_hid -> e_in
# ---------------------------------------------------------------------------


def speech_prenet_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/modules.py::speech_prenet_init."""
    return {
        "fc1": nn.linear_init(gen, cfg.num_mels, cfg.s_pre_hid),
        "fc2": nn.linear_init(gen, cfg.s_pre_hid, cfg.e_in),
    }


def speech_prenet(p, ctx: nn.Ctx, x, cfg: ModelConfig):
    """unast_tpu/models/modules.py::speech_prenet, with the reference's
    duplicate-dropout quirk: fc1 -> relu -> dropout -> fc2 -> relu (no
    trailing dropout). Casts to cfg.dtype, the speech activation entry."""
    x = x.to(cfg.dtype)
    h = torch.relu(nn.linear(p["fc1"], x))
    x = nn.dropout(ctx, h, cfg.s_pre_drop, split=C.time_split(h))
    return torch.relu(nn.linear(p["fc2"], x))


# ---------------------------------------------------------------------------
# SpeechPostnet: 5 causal convs k=5 (pad-left 4) + the mel/stop heads
# ---------------------------------------------------------------------------


def speech_postnet_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/modules.py::speech_postnet_init -> (params, state)."""
    params = {
        "conv1": nn.conv1d_init(gen, cfg.num_mels, cfg.hidden, 5, w_init="tanh"),
        "convs": [nn.conv1d_init(gen, cfg.hidden, cfg.hidden, 5, w_init="tanh")
                  for _ in range(3)],
        "conv2": nn.conv1d_init(gen, cfg.hidden, cfg.num_mels, 5),
        "mel_proj": nn.linear_init(
            gen, cfg.hidden, cfg.reduction_factor * cfg.num_mels,
            torch_default=True),
        "stop_proj": nn.linear_init(gen, cfg.hidden, cfg.reduction_factor,
                                    torch_default=True),
    }
    bn_p, bn_s = {}, {}
    for i in range(4):
        bn_p[f"bn{i}"], bn_s[f"bn{i}"] = nn.batchnorm_init(cfg.hidden)
    params["bn"] = bn_p
    return params, {"bn": bn_s}


def speech_postnet(p, s, ctx: nn.Ctx, x, cfg: ModelConfig):
    """unast_tpu/models/modules.py::speech_postnet: residual mel refinement
    over the whole sequence. Returns (residual, new_state)."""
    new_bn = {}
    h = nn.conv1d(p["conv1"], x, padding=(4, 0))
    h, new_bn["bn0"] = nn.batchnorm(p["bn"]["bn0"], s["bn"]["bn0"], h, ctx.train)
    h = nn.dropout(ctx, torch.tanh(h), cfg.s_post_drop, split=C.time_split(h))
    for i, cp in enumerate(p["convs"]):
        h2 = nn.conv1d(cp, h, padding=(4, 0))
        h2, new_bn[f"bn{i+1}"] = nn.batchnorm(
            p["bn"][f"bn{i+1}"], s["bn"][f"bn{i+1}"], h2, ctx.train)
        h = nn.dropout(ctx, torch.tanh(h2), cfg.s_post_drop,
                       split=C.time_split(h2))
    h = nn.conv1d(p["conv2"], h, padding=(4, 0))
    return h, {"bn": new_bn}


def speech_mel_and_stop(p, dec_out):
    """unast_tpu/models/modules.py::speech_mel_and_stop: decoder hidden
    [B, Tg, H] -> (mel [B, Tg, r*num_mels], stop logits [B, Tg, r])."""
    return nn.linear(p["mel_proj"], dec_out), nn.linear(p["stop_proj"], dec_out)


# ---------------------------------------------------------------------------
# TextPrenet: Embedding(46, emb, pad 0) + 3x conv k=5 same-pad BN+ReLU+drop
# ---------------------------------------------------------------------------


def text_prenet_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/modules.py::text_prenet_init -> (params, state)."""
    params = {
        "embed": nn.embedding_init(gen, VOCAB_SIZE, cfg.t_emb_dim,
                                   padding_idx=PAD_IDX),
        "conv1": nn.conv1d_init(gen, cfg.t_emb_dim, cfg.e_in, 5, w_init="relu"),
        "conv2": nn.conv1d_init(gen, cfg.e_in, cfg.e_in, 5, w_init="relu"),
        "conv3": nn.conv1d_init(gen, cfg.e_in, cfg.e_in, 5, w_init="relu"),
    }
    bn_p, bn_s = {}, {}
    for i in (1, 2, 3):
        bn_p[f"bn{i}"], bn_s[f"bn{i}"] = nn.batchnorm_init(cfg.e_in)
    params["bn"] = bn_p
    return params, {"bn": bn_s}


def text_embed(p, ctx: nn.Ctx, ids, cfg: ModelConfig):
    """unast_tpu/models/modules.py::text_embed: ids -> embeddings in
    cfg.dtype (the text activation entry), PAD positions zeroed."""
    emb = nn.embedding(p["embed"], ids).to(cfg.dtype)
    emb = emb * (ids != PAD_IDX)[..., None].to(emb.dtype)
    return nn.dropout(ctx, emb, cfg.t_pre_drop)


def text_prenet_step_init(p, batch: int, cfg: ModelConfig, dtype, device=None):
    """unast_tpu/models/modules.py::text_prenet_step_init: one rolling
    buffer of the last 5 positions per conv layer's input (zeros are the
    causal conv's left padding)."""
    def zeros(c):
        return torch.zeros((batch, 5, c), dtype=dtype, device=device)
    return zeros(cfg.t_emb_dim), zeros(cfg.e_in), zeros(cfg.e_in)


def text_prenet_step(p, s, ctx: nn.Ctx, emb_t, bufs, cfg: ModelConfig):
    """unast_tpu/models/modules.py::text_prenet_step: one position of the
    causal conv stack. emb_t: [B, emb]. Returns (y [B, e_in], new_bufs).
    Equals text_prenet_convs(causal=True) at every position (BN on running
    statistics): each conv is one window product, y_i = sum_k w[k] .
    x[i-4+k]."""
    def conv_pos(cp, buf):
        w = nn.weight(cp, buf.dtype)                         # [5, Cin, Cout]
        y = buf.flatten(1) @ w.flatten(0, 1)
        if "b" in cp:
            y = y + cp["b"].to(buf.dtype)
        return y

    new_bufs = []
    h = emb_t
    for i, buf in enumerate(bufs, start=1):
        buf = torch.cat([buf[:, 1:], h[:, None]], dim=1)
        new_bufs.append(buf)
        h, _ = nn.batchnorm(p["bn"][f"bn{i}"], s["bn"][f"bn{i}"],
                            conv_pos(p[f"conv{i}"], buf), train=False)
        h = nn.dropout(ctx, torch.relu(h), cfg.t_pre_drop)
    return h, tuple(new_bufs)


def text_prenet_convs(p, s, ctx: nn.Ctx, x, cfg: ModelConfig, causal=False):
    """unast_tpu/models/modules.py::text_prenet_convs -> (x, new_state).
    causal=True pads 4 frames on the left only: the RNN text decoder's
    input path."""
    pad = (4, 0) if causal else (2, 2)
    new_bn = {}
    for i in (1, 2, 3):
        x = nn.conv1d(p[f"conv{i}"], x, padding=pad)
        x, new_bn[f"bn{i}"] = nn.batchnorm(
            p["bn"][f"bn{i}"], s["bn"][f"bn{i}"], x, ctx.train)
        x = nn.dropout(ctx, torch.relu(x), cfg.t_pre_drop,
                       split=C.time_split(x))
    return x, {"bn": new_bn}


# ---------------------------------------------------------------------------
# TextPostnet: dropout + Linear hidden -> 46
# ---------------------------------------------------------------------------


def text_postnet_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/modules.py::text_postnet_init."""
    return {"fc": nn.linear_init(gen, cfg.hidden, VOCAB_SIZE, torch_default=True)}


def text_postnet(p, ctx: nn.Ctx, x, cfg: ModelConfig):
    """unast_tpu/models/modules.py::text_postnet."""
    return nn.linear(p["fc"], nn.dropout(ctx, x, cfg.t_post_drop,
                                         split=C.time_split(x)))


# ---------------------------------------------------------------------------
# Highway network
# ---------------------------------------------------------------------------


def highway_init(gen: torch.Generator, units: int, num_layers: int = 4):
    """unast_tpu/models/modules.py::highway_init."""
    linears, gates = [], []
    for _ in range(num_layers):
        linears.append(nn.linear_init(gen, units, units))
        gates.append(nn.linear_init(gen, units, units))
    return {"linears": linears, "gates": gates}


def highway(p, x):
    """unast_tpu/models/modules.py::highway: x <- relu(W x) * t + x * (1 - t),
    t = sigmoid(G x), per layer."""
    for fc, gate in zip(p["linears"], p["gates"]):
        h = torch.relu(nn.linear(fc, x))
        t = torch.sigmoid(nn.linear(gate, x))
        x = h * t + x * (1.0 - t)
    return x


# ---------------------------------------------------------------------------
# CBHG. The conv bank is CHAINED as in the reference (conv_k reads the
# output of conv_{k-1}, not the input), and an even kernel's conv, padded
# k // 2 on each side, gives one frame too many, which is trimmed.
# ---------------------------------------------------------------------------


def cbhg_init(gen: torch.Generator, hidden: int, K: int = 16,
              projection_size: int = 256, num_gru_layers: int = 2):
    """unast_tpu/models/modules.py::cbhg_init -> (params, state): the bank of
    K convs with their BNs, two projection convs with theirs, a 4-layer
    highway and a bidirectional GRU of num_gru_layers layers, hidden // 2
    per direction."""
    params = {"bank": [], "bn_bank": []}
    state = {"bn_bank": []}
    c_in = projection_size
    for k in range(1, K + 1):
        params["bank"].append(nn.conv1d_init(gen, c_in, hidden, k,
                                             torch_default=True))
        bp, bs = nn.batchnorm_init(hidden)
        params["bn_bank"].append(bp)
        state["bn_bank"].append(bs)
        c_in = hidden
    params["proj1"] = nn.conv1d_init(gen, hidden * K, hidden, 3,
                                     torch_default=True)
    params["proj2"] = nn.conv1d_init(gen, hidden, projection_size, 3,
                                     torch_default=True)
    params["bn_proj1"], state["bn_proj1"] = nn.batchnorm_init(hidden)
    params["bn_proj2"], state["bn_proj2"] = nn.batchnorm_init(projection_size)
    params["highway"] = highway_init(gen, projection_size)
    gru = []
    d_in = projection_size
    for _ in range(num_gru_layers):
        gru.append({"fwd": nn.gru_cell_init(gen, d_in, hidden // 2),
                    "bwd": nn.gru_cell_init(gen, d_in, hidden // 2)})
        d_in = hidden
    params["gru"] = gru
    return params, state


def _maxpool2_same(x):
    """unast_tpu/models/modules.py::_maxpool2_same: torch MaxPool1d(k=2,
    stride=1, pad=1) then the last frame trimmed, on [B, T, C]: out[t] =
    max(x[t-1], x[t]), with -inf before the first frame."""
    return torch.cat([x[:, :1], torch.maximum(x[:, 1:], x[:, :-1])], dim=1)


def _gru_bidir(gru_params, x):
    """unast_tpu/models/modules.py::_gru_bidir: a stacked bidirectional GRU
    over [B, T, C] (no masking: the backward direction starts at the last,
    possibly padded, frame), as a Python loop over time. Each direction's
    input half of the gates is one product over the sequence."""
    for layer_p in gru_params:
        b, t_len = x.shape[:2]
        outs = []
        for name, steps in (("fwd", range(t_len)),
                            ("bwd", range(t_len - 1, -1, -1))):
            cell = layer_p[name]
            gates_in = nn.gru_gates_in(cell, x)                  # [B, T, 3H]
            h = torch.zeros((b, cell["wh"].shape[0]), dtype=x.dtype,
                            device=x.device)
            seq = [None] * t_len
            for t in steps:
                h = nn.gru_cell(cell, gates_in[:, t], h)
                seq[t] = h
            outs.append(torch.stack(seq, dim=1))
        x = torch.cat(outs, dim=-1)
    return x


def cbhg(p, s, ctx: nn.Ctx, x, K: int = 16):
    """unast_tpu/models/modules.py::cbhg. x: [B, T, projection_size] ->
    [B, T, hidden]. BN uses batch statistics in train mode. Returns (y,
    new_state)."""
    new_state = {"bn_bank": []}
    outs = []
    h = x
    for k in range(1, K + 1):
        y = nn.conv1d(p["bank"][k - 1], h, padding=(k // 2, k // 2))
        if k % 2 == 0:
            y = y[:, :-1]
        y, bs = nn.batchnorm(p["bn_bank"][k - 1], s["bn_bank"][k - 1], y,
                             ctx.train)
        new_state["bn_bank"].append(bs)
        h = torch.relu(y)
        outs.append(h)
    y = _maxpool2_same(torch.cat(outs, dim=-1))             # [B, T, hidden*K]
    y = nn.conv1d(p["proj1"], y, padding=(1, 1))
    y, new_state["bn_proj1"] = nn.batchnorm(p["bn_proj1"], s["bn_proj1"], y,
                                            ctx.train)
    y = nn.conv1d(p["proj2"], torch.relu(y), padding=(1, 1))
    y, new_state["bn_proj2"] = nn.batchnorm(p["bn_proj2"], s["bn_proj2"], y,
                                            ctx.train)
    y = highway(p["highway"], y + x)
    return _gru_bidir(p["gru"], y), new_state
