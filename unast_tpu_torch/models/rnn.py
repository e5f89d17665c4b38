"""The recurrent backbone of the port, mirroring `unast_tpu/models/rnn.py`:
the masked LSTM encoder (which the LSTM discriminator of models/unast.py
runs on too), location-sensitive attention with its explicit state,
additive attention, and one step of the LSTM decoder. The decoders' time
loops live in models/networks.py.

Packed-sequence semantics as in JAX: the carry freezes once t >= length,
so the final state of a row is its state at its last valid step, and the
backward direction keeps its zero start through the trailing pads and first
updates at t = length - 1. Outputs are zeroed at pads. The JAX `lax.scan`
becomes a Python loop over time; the input half of every gate (x @ wi + b)
is one product over the whole sequence ahead of the loop.

Under a sequence-parallel axis these recurrences run on whole sequences,
replicated over the sp ranks, as GSPMD runs JAX's scan over a time-sharded
axis (models/networks.py).
"""

from typing import NamedTuple, Optional

import torch

from .. import nn
from .modules import lens_to_mask


def rnn_encoder_init(gen: torch.Generator, d_in: int, hidden: int,
                     num_layers: int, bidirectional: bool):
    """unast_tpu/models/rnn.py::rnn_encoder_init."""
    layers = []
    for li in range(num_layers):
        d = d_in if li == 0 else hidden * (2 if bidirectional else 1)
        layer = {"fwd": nn.lstm_cell_init(gen, d, hidden)}
        if bidirectional:
            layer["bwd"] = nn.lstm_cell_init(gen, d, hidden)
        layers.append(layer)
    p = {"layers": layers}
    if bidirectional:
        p["reduce_h"] = nn.linear_init(gen, hidden * 2, hidden, torch_default=True)
        p["reduce_c"] = nn.linear_init(gen, hidden * 2, hidden, torch_default=True)
    return p


def _scan_dir(cell_p, x_tm, mask_tm, reverse: bool):
    """unast_tpu/models/rnn.py::_scan_dir: masked LSTM scan. x_tm:
    [T, B, D], mask_tm: bool [T, B]. Returns (outputs [T, B, H],
    (h_final, c_final))."""
    t_len, b = x_tm.shape[:2]
    h = torch.zeros((b, cell_p["wh"].shape[0]), dtype=x_tm.dtype,
                    device=x_tm.device)
    c = h
    gates_in = nn.lstm_gates_in(cell_p, x_tm)          # [T, B, 4H]
    outs = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        h_new, c_new = nn.lstm_cell(cell_p, gates_in[t], h, c)
        m = mask_tm[t][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        outs[t] = h
    return torch.stack(outs), (h, c)


def rnn_encoder(p, ctx: nn.Ctx, x, lens, dropout_p: float):
    """unast_tpu/models/rnn.py::rnn_encoder. x: [B, T, D], lens: [B].
    Returns (outputs [B, T, H * dirs] zeroed at pads, (h, c) [L, B, H]):
    a bidirectional stack's final states are concatenated per layer and
    reduced to H by reduce_h / reduce_c. Dropout between layers."""
    t = x.shape[1]
    mask_tm = lens_to_mask(lens.to(x.device), t).transpose(0, 1)   # [T, B]
    h_list, c_list = [], []
    bidir = "bwd" in p["layers"][0]
    inp = x.transpose(0, 1)                                          # time-major
    for li, lp in enumerate(p["layers"]):
        out, (h, c) = _scan_dir(lp["fwd"], inp, mask_tm, reverse=False)
        if bidir:
            bwd, (hb, cb) = _scan_dir(lp["bwd"], inp, mask_tm, reverse=True)
            out = torch.cat([out, bwd], dim=-1)
            h, c = torch.cat([h, hb], dim=-1), torch.cat([c, cb], dim=-1)
        h_list.append(h)
        c_list.append(c)
        inp = out * mask_tm[..., None].to(out.dtype)
        if li + 1 < len(p["layers"]):
            inp = nn.dropout(ctx, inp, dropout_p)
    h, c = torch.stack(h_list), torch.stack(c_list)
    if bidir and "reduce_h" in p:
        h = nn.linear(p["reduce_h"], h)
        c = nn.linear(p["reduce_c"], c)
    return inp.transpose(0, 1), (h, c)


# ---------------------------------------------------------------------------
# Location-sensitive attention (Tacotron2-style)
# ---------------------------------------------------------------------------


class LSAState(NamedTuple):
    """unast_tpu/models/rnn.py::LSAState."""
    processed_memory: torch.Tensor   # [B, S, A]
    attn_weights: torch.Tensor       # [B, S]
    attn_cum: torch.Tensor           # [B, S]


def lsa_init(gen: torch.Generator, hidden: int, enc_dim: int, attn_dim: int,
             n_filters: int = 32, kernel_size: int = 31):
    """unast_tpu/models/rnn.py::lsa_init."""
    return {
        "query": nn.linear_init(gen, hidden, attn_dim, bias=False, w_init="tanh"),
        "memory": nn.linear_init(gen, enc_dim, attn_dim, bias=False, w_init="tanh"),
        "v": nn.linear_init(gen, attn_dim, 1, bias=False),
        "loc_conv": nn.conv1d_init(gen, 2, n_filters, kernel_size, bias=False),
        "loc_dense": nn.linear_init(gen, n_filters, attn_dim, bias=False,
                                    w_init="tanh"),
    }


def lsa_init_state(p, memory) -> LSAState:
    """unast_tpu/models/rnn.py::lsa_init_state: the per-sequence state, the
    memory projected once and zero weights."""
    b, s, _ = memory.shape
    zeros = torch.zeros((b, s), dtype=memory.dtype, device=memory.device)
    return LSAState(nn.linear(p["memory"], memory), zeros, zeros)


def _attend(energies, memory, pad_mask):
    """Softmax of energies [B, S] in float32 over the unpadded positions
    (pad_mask True = PAD), then the weighted sum of memory [B, S, E] with
    float32 accumulation. Returns (ctxt [B, E], weights [B, S]), both in
    memory's dtype."""
    energies = energies.masked_fill(pad_mask, float("-inf"))
    w = torch.softmax(energies.float(), dim=-1).to(memory.dtype)
    ctxt = torch.bmm(w.float()[:, None], memory.float())[:, 0]
    return ctxt.to(memory.dtype), w


def lsa_attend(p, state: LSAState, query_h, memory, pad_mask):
    """unast_tpu/models/rnn.py::lsa_attend. query_h: [B, H] (the decoder's
    top-layer hidden), memory: [B, S, E], pad_mask: bool [B, S] True=PAD.
    The location conv runs over the previous and cumulative weights, with
    the kernel's half-width of padding on each side and no bias. Returns
    (ctxt [B, E], new_state)."""
    cat = torch.stack([state.attn_weights, state.attn_cum], dim=-1)   # [B, S, 2]
    ks = p["loc_conv"]["w"].shape[0]
    loc = nn.conv1d(p["loc_conv"], cat, padding=((ks - 1) // 2, (ks - 1) // 2))
    loc = nn.linear(p["loc_dense"], loc)                              # [B, S, A]
    q = nn.linear(p["query"], query_h)[:, None, :]                    # [B, 1, A]
    energies = nn.linear(p["v"], torch.tanh(q + loc + state.processed_memory))
    ctxt, w = _attend(energies.squeeze(-1), memory, pad_mask)
    return ctxt, LSAState(state.processed_memory, w, state.attn_cum + w)


# ---------------------------------------------------------------------------
# Additive ("Luong"-named in the reference) attention
# ---------------------------------------------------------------------------


def additive_attn_init(gen: torch.Generator, hidden: int, enc_dim: int,
                       attn_dim: int):
    """unast_tpu/models/rnn.py::additive_attn_init."""
    return {
        "proj_hid": nn.linear_init(gen, hidden, attn_dim, bias=False,
                                   torch_default=True),
        "proj_eo": nn.linear_init(gen, enc_dim, attn_dim, bias=False,
                                  torch_default=True),
        "fc2": nn.linear_init(gen, attn_dim, 1, bias=False, torch_default=True),
    }


def additive_attend(p, query_h, memory, pad_mask):
    """unast_tpu/models/rnn.py::additive_attend: score = v . tanh(W_h h +
    W_e e). query_h: [B, H] -> ctxt [B, E]."""
    q = nn.linear(p["proj_hid"], query_h)[:, None, :]
    e = nn.linear(p["proj_eo"], memory)
    scores = nn.linear(p["fc2"], torch.tanh(q + e)).squeeze(-1)
    return _attend(scores, memory, pad_mask)[0]


# ---------------------------------------------------------------------------
# Decoder (one step; the time loops are in networks.py)
# ---------------------------------------------------------------------------


def rnn_decoder_init(gen: torch.Generator, d_in: int, enc_out_size: int,
                     hidden: int, num_layers: int, attention: Optional[str],
                     attn_dim: int):
    """unast_tpu/models/rnn.py::rnn_decoder_init: num_layers LSTM cells (the
    first reads the input and, with attention, the context), the attention
    and, with attention, the output projection `proj`."""
    input_size = d_in + (enc_out_size if attention else 0)
    p = {"cells": [nn.lstm_cell_init(gen, input_size if li == 0 else hidden,
                                     hidden) for li in range(num_layers)]}
    if attention == "lsa":
        p["attn"] = lsa_init(gen, hidden, enc_out_size, attn_dim)
    elif attention == "luong":
        p["attn"] = additive_attn_init(gen, hidden, enc_out_size, attn_dim)
    if attention:
        p["proj"] = nn.linear_init(gen, enc_out_size + hidden, hidden,
                                   w_init="tanh")
    return p


def rnn_decoder_step(p, ctx: nn.Ctx, x, hidden_state, memory, pad_mask,
                     attn_state: Optional[LSAState], dropout_p: float,
                     attention: Optional[str]):
    """unast_tpu/models/rnn.py::rnn_decoder_step. x: [B, D_in];
    hidden_state: (h, c) [L, B, H]; attention: 'lsa', 'luong' or None.
    Attention reads the PREVIOUS top-layer hidden; dropout falls between
    layers and after `proj`. attn_state is the LSAState for 'lsa' and
    passes through otherwise. Returns (out [B, H], (h, c), attn_state)."""
    h, c = hidden_state
    if attention == "lsa":
        ctxt, attn_state = lsa_attend(p["attn"], attn_state, h[-1], memory,
                                      pad_mask)
        x = torch.cat([x, ctxt], dim=-1)
    elif attention == "luong":
        ctxt = additive_attend(p["attn"], h[-1], memory, pad_mask)
        x = torch.cat([x, ctxt], dim=-1)
    new_h, new_c = [], []
    inp = x
    for li, cell in enumerate(p["cells"]):
        hi, ci = nn.lstm_cell(cell, nn.lstm_gates_in(cell, inp), h[li], c[li])
        new_h.append(hi)
        new_c.append(ci)
        inp = hi
        if li + 1 < len(p["cells"]):
            inp = nn.dropout(ctx, inp, dropout_p)
    out = inp
    if attention:
        out = nn.dropout(ctx, torch.tanh(nn.linear(
            p["proj"], torch.cat([out, ctxt], dim=-1))), dropout_p)
    return out, (torch.stack(new_h), torch.stack(new_c)), attn_state
