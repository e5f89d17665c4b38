"""The recurrent encoder of the port: a masked LSTM scan, mirroring the
encoder half of `unast_tpu/models/rnn.py`. The LSTM discriminator
(models/unast.py) runs on it; the RNN backbone's decoder and attention come
with a later slice.

Packed-sequence semantics as in JAX: the carry freezes once t >= length,
so the final state of a row is its state at its last valid step, and the
backward direction keeps its zero start through the trailing pads and first
updates at t = length - 1. Outputs are zeroed at pads. The JAX `lax.scan`
becomes a Python loop over time; the input half of every gate (x @ wi + b)
is one product over the whole sequence ahead of the loop.
"""

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
