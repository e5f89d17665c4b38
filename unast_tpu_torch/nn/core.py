"""Functional NN primitives of the port: linear / conv1d / embedding / norms /
dropout / the LSTM and GRU cells and their initializers, as plain
functions over dicts of tensors.

Mirrors `unast_tpu/nn/core.py`. Layouts are the JAX package's so the
param trees map name for name (bridge.py): linear `w` is [in, out], conv
`w` is [k, in, out], activations are [B, T, C]. Weights are cast to the
activation dtype at use, as in JAX; `cast_weights` does that cast once
ahead of time with the same rounding.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import collectives as C


@dataclasses.dataclass
class Ctx:
    """Per-forward context (unast_tpu/nn/core.py::Ctx). `generator` is the
    one stream of draws of a train-mode forward: every stochastic op takes
    its draws from it (next_rng), on the device of the activations, so it
    advances op by op as JAX's fold-in counter does. Its bits differ from
    JAX's. Eval mode needs none.

    `aux_losses`: None, or a list the caller sets (train/steps.py does for
    MoE configs); layers append auxiliary scalar losses to it (the MoE
    load-balance term) and the objective sums them."""

    generator: Optional[torch.Generator] = None
    train: bool = False
    aux_losses: Optional[list] = None

    def next_rng(self) -> torch.Generator:
        """unast_tpu/nn/core.py::Ctx.next_rng: the generator a stochastic
        op draws from."""
        if self.generator is None:
            raise ValueError("Ctx.generator is None but a stochastic op needs randomness")
        return self.generator

    @staticmethod
    def eval() -> "Ctx":
        return Ctx(generator=None, train=False)


def fold_generator(seed: int, index: int, device) -> torch.Generator:
    """A torch.Generator on `device` seeded from the pair (seed, index)
    through numpy's SeedSequence: the counterpart of
    jax.random.fold_in(key(seed), index)."""
    state = np.random.SeedSequence([seed, index]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


# ---------------------------------------------------------------------------
# Initializers (unast_tpu/nn/core.py:53-105)
# ---------------------------------------------------------------------------

_GAINS = {
    "linear": 1.0,
    "conv1d": 1.0,
    "sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
}


def calculate_gain(nonlinearity: str, param: float = 0.01) -> float:
    """unast_tpu/nn/core.py::calculate_gain."""
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + param ** 2))
    return _GAINS[nonlinearity]


def _uniform(gen: torch.Generator, shape, a: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-a, a, generator=gen)


def xavier_uniform(gen: torch.Generator, shape, gain: float = 1.0,
                   fan_in=None, fan_out=None) -> torch.Tensor:
    """unast_tpu/nn/core.py::xavier_uniform."""
    if fan_in is None:
        fan_out_, fan_in_ = shape[0], shape[1]
        if len(shape) > 2:
            rf = math.prod(shape[2:])
            fan_in_, fan_out_ = fan_in_ * rf, fan_out_ * rf
        fan_in, fan_out = fan_in_, fan_out_
    return _uniform(gen, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def torch_linear_uniform(gen: torch.Generator, shape, fan_in) -> torch.Tensor:
    """unast_tpu/nn/core.py::torch_linear_uniform: U(-1/sqrt(fan_in), ..)."""
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in))


def linear_init(gen: torch.Generator, d_in: int, d_out: int, bias: bool = True,
                w_init: str = "linear", torch_default: bool = False):
    """unast_tpu/nn/core.py::linear_init. Weight stored [d_in, d_out]."""
    if torch_default:
        w = torch_linear_uniform(gen, (d_in, d_out), d_in)
    else:
        w = xavier_uniform(gen, (d_in, d_out), calculate_gain(w_init),
                           fan_in=d_in, fan_out=d_out)
    p = {"w": w}
    if bias:
        p["b"] = torch_linear_uniform(gen, (d_out,), d_in)
    return p


def conv1d_init(gen: torch.Generator, c_in: int, c_out: int, kernel_size: int,
                bias: bool = True, w_init: str = "linear",
                torch_default: bool = False):
    """unast_tpu/nn/core.py::conv1d_init. Weight stored [k, in, out]."""
    fan_in = c_in * kernel_size
    fan_out = c_out * kernel_size
    if torch_default:
        w = torch_linear_uniform(gen, (kernel_size, c_in, c_out), fan_in)
    else:
        w = xavier_uniform(gen, (kernel_size, c_in, c_out),
                           calculate_gain(w_init), fan_in=fan_in,
                           fan_out=fan_out)
    p = {"w": w}
    if bias:
        p["b"] = torch_linear_uniform(gen, (c_out,), fan_in)
    return p


def embedding_init(gen: torch.Generator, vocab: int, dim: int,
                   padding_idx: Optional[int] = None):
    """unast_tpu/nn/core.py::embedding_init: N(0, 1) rows, PAD row zero."""
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32)
    if padding_idx is not None:
        w[padding_idx] = 0.0
    return {"w": w}


def batchnorm_init(c: int):
    """unast_tpu/nn/core.py::batchnorm_init -> (params, state)."""
    params = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    state = {"mean": torch.zeros(c), "var": torch.ones(c)}
    return params, state


def layernorm_init(c: int):
    """unast_tpu/nn/core.py::layernorm_init."""
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------


def weight(p, dtype: torch.dtype, name: str = "w") -> torch.Tensor:
    """unast_tpu/nn/core.py::weight: the weight `name` of p in `dtype`. An
    int8 weight-only leaf (nn/quant.py: {name}_q int8 + {name}_scale per
    output channel) is dequantized in `dtype`, as JAX does: the scale is
    rounded to `dtype` before the product."""
    q = p.get(name + "_q")
    if q is None:
        return p[name].to(dtype)
    return q.to(dtype) * p[name + "_scale"].to(dtype)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """unast_tpu/nn/core.py::linear. x: [..., in] @ w [in, out]."""
    y = x @ weight(p, x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv1d(p, x: torch.Tensor, padding) -> torch.Tensor:
    """unast_tpu/nn/core.py::conv1d. x: [B, T, Cin] -> [B, T', Cout];
    padding: int (symmetric) or (left, right); `w` is [k, Cin, Cout].
    Inside a time-split region (parallel/collectives.py's sequence) x holds
    this rank's frames: the padding comes from the neighbouring ranks'
    frames (collectives.halo, which zeroes the frames past the sequence),
    so the result is this rank's frames of the conv of the whole."""
    if isinstance(padding, int):
        padding = (padding, padding)
    if C.seq() is not None:
        x = C.halo(x, *padding)
        padding = (0, 0)
    xt = F.pad(x.transpose(1, 2), tuple(padding))           # [B, Cin, T+l+r]
    w = weight(p, x.dtype).permute(2, 1, 0)                  # [Cout, Cin, k]
    y = F.conv1d(xt, w).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding(p, ids: torch.Tensor) -> torch.Tensor:
    """unast_tpu/nn/core.py::embedding (row gather). An int8 table takes
    its int8 rows first, then scales them in float32."""
    q = p.get("w_q")
    if q is not None:
        return q[ids].float() * p["w_scale"]
    return p["w"][ids]


BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def batchnorm(p, s, x: torch.Tensor, train: bool):
    """unast_tpu/nn/core.py::batchnorm over the channel axis of [B, T, C] or
    [B, C] (torch BatchNorm1d semantics). train: normalise by the batch's
    statistics (biased variance, gradients flow through them) and move the
    running state toward them (unbiased variance), detached as JAX's state
    output is. Under data parallelism (parallel/collectives.py) the
    statistics are the global batch's; inside a time-split region x [B,
    local, C] holds this rank's frames and the statistics are those of the
    global batch's whole sequences, the frames past the sequence left out.
    Returns (y, new_state)."""
    dims = tuple(range(x.ndim - 1))
    if train:
        xf = x.float()
        n = x.numel() // x.shape[-1]
        seq = C.seq()
        if seq is not None:   # this rank's frames of dp x sp's sequences
            n = x.shape[0] * C.dp_ranks() * seq.whole
            w = C.valid_frames(x.device)[:, None].float()
            mean = C.sum_grad((xf * w).sum(dim=dims)) / n
            var = C.sum_grad((((xf - mean) ** 2) * w).sum(dim=dims)) / n
        elif C.active():   # the global batch's statistics, as GSPMD's under dp
            n *= C.ranks()
            mean = C.sum_grad(xf.sum(dim=dims)) / n
            var = C.sum_grad(((xf - mean) ** 2).sum(dim=dims)) / n
        else:
            mean = xf.mean(dim=dims)
            var = xf.var(dim=dims, unbiased=False)
        unbiased = var.detach() * (n / max(1, n - 1))
        new_s = {
            "mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean.detach(),
            "var": (1 - BN_MOMENTUM) * s["var"] + BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + BN_EPS) * p["scale"]
    y = ((x - mean.to(x.dtype)) * inv.to(x.dtype)) + p["bias"].to(x.dtype)
    return y, new_s


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """unast_tpu/nn/core.py::layernorm: float32 inside, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def dropout(ctx: Ctx, x: torch.Tensor, p: float, split=()) -> torch.Tensor:
    """unast_tpu/nn/core.py::dropout (inverted, torch semantics): in train
    mode each element is kept with probability 1 - p and scaled by
    1 / (1 - p); a no-op in eval mode or at p = 0. The mask is drawn from
    ctx.next_rng(), so its bits differ from JAX's.

    split: for x a slice of a tensor split over a model-parallel axis,
    ((dim, whole size, start), ...) per split dim: the mask of the whole
    tensor is drawn and x takes its slice, so every rank of the axis
    advances the generator alike and the ranks' masks are those of the
    unsplit tensor. A slice reaching past the whole (the padding frames of
    the last sequence-parallel rank) keeps those elements. A start that is
    a LongTensor takes those indices of the whole along dim instead (the
    MoE's rows of the global batch's sorted assignments)."""
    if not ctx.train or p == 0.0:
        return x
    keep = 1.0 - p
    shape = list(x.shape)
    for d, n, _ in split:
        shape[d] = n
    mask = torch.rand(shape, generator=ctx.next_rng(),
                      device=x.device) < keep
    for d, n, s in split:
        if torch.is_tensor(s):
            mask = mask.index_select(d, s)
            continue
        over = s + x.shape[d] - n
        if over > 0:
            pad = list(mask.shape)
            pad[d] = over
            mask = torch.cat([mask, mask.new_ones(pad)], dim=d)
        mask = mask.narrow(d, s, x.shape[d])
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


# ---------------------------------------------------------------------------
# LSTM cell (torch gate order [i f g o]; U(-1/sqrt(H), 1/sqrt(H)) init)
# ---------------------------------------------------------------------------


def lstm_cell_init(gen: torch.Generator, d_in: int, hidden: int):
    """unast_tpu/nn/core.py::lstm_cell_init: input and hidden weights
    [in, 4H] and two biases [4H], gates in the order [i f g o]."""
    a = 1.0 / math.sqrt(hidden)
    return {
        "wi": _uniform(gen, (d_in, 4 * hidden), a),
        "wh": _uniform(gen, (hidden, 4 * hidden), a),
        "bi": _uniform(gen, (4 * hidden,), a),
        "bh": _uniform(gen, (4 * hidden,), a),
    }


def lstm_gates_in(p, x: torch.Tensor) -> torch.Tensor:
    """The input half of lstm_cell's gates for every step at once:
    x [..., Din] @ wi + (bi + bh), in x's dtype."""
    return x @ weight(p, x.dtype, "wi") + (p["bi"] + p["bh"]).to(x.dtype)


def lstm_cell(p, gates_in, h, c):
    """unast_tpu/nn/core.py::lstm_cell, one step. gates_in: [B, 4H], this
    step's lstm_gates_in(p, x) (computed ahead for the whole sequence);
    h, c: [B, H]. Returns (h', c')."""
    gates = gates_in + h @ weight(p, h.dtype, "wh")
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


# ---------------------------------------------------------------------------
# GRU cell (torch gate order [r z n])
# ---------------------------------------------------------------------------


def gru_cell_init(gen: torch.Generator, d_in: int, hidden: int):
    """unast_tpu/nn/core.py::gru_cell_init: input and hidden weights
    [in, 3H] and two biases [3H], gates in the order [r z n]."""
    a = 1.0 / math.sqrt(hidden)
    return {
        "wi": _uniform(gen, (d_in, 3 * hidden), a),
        "wh": _uniform(gen, (hidden, 3 * hidden), a),
        "bi": _uniform(gen, (3 * hidden,), a),
        "bh": _uniform(gen, (3 * hidden,), a),
    }


def gru_gates_in(p, x: torch.Tensor) -> torch.Tensor:
    """The input half of gru_cell's gates for every step at once:
    x [..., Din] @ wi + bi, in x's dtype."""
    return x @ weight(p, x.dtype, "wi") + p["bi"].to(x.dtype)


def gru_cell(p, gates_in, h):
    """unast_tpu/nn/core.py::gru_cell, one step with torch's GRU equations:
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)). gates_in: [B, 3H], this
    step's gru_gates_in(p, x); h: [B, H]. Returns h'."""
    gh = h @ weight(p, h.dtype, "wh") + p["bh"].to(h.dtype)
    ir, iz, in_ = torch.chunk(gates_in, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1 - z) * n + z * h


def cast_weights(tree, dtype: torch.dtype):
    """Cast every linear/conv/embedding weight (`w`, and its `b`) and every
    LSTM/GRU cell's weight matrices (`wi`, `wh`) to the activation dtype
    once, ahead of use. The apply functions cast these leaves to x.dtype
    anyway, so the rounding is the same. The cells' biases stay float32
    (lstm_gates_in adds its two in float32 before the cast, as JAX does),
    as do norm params and BN statistics."""
    if isinstance(tree, dict):
        out = {k: cast_weights(v, dtype) for k, v in tree.items()}
        for k in (("w", "b") if "w" in tree else ("wi", "wh") if "wh" in tree
                  else ()):
            if k in tree:
                out[k] = tree[k].to(dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_weights(v, dtype) for v in tree)
    return tree


def tree_to(tree, device):
    """Move every tensor leaf of a nested dict/list tree to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)
