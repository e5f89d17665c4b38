"""Functional NN primitives of the port: linear / conv1d / embedding / norms /
dropout / the LSTM cell and their initializers, as plain functions over
dicts of tensors.

Mirrors `unast_tpu/nn/core.py`. Layouts are the JAX package's so the
param trees map name for name (bridge.py): linear `w` is [in, out], conv
`w` is [k, in, out], activations are [B, T, C]. Weights are cast to the
activation dtype at use, as in JAX; `cast_weights` does that cast once
ahead of time with the same rounding.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Ctx:
    """Per-forward context (unast_tpu/nn/core.py::Ctx). `generator` is the
    one stream of draws of a train-mode forward: every stochastic op takes
    its draws from it (next_rng), on the device of the activations, so it
    advances op by op as JAX's fold-in counter does. Its bits differ from
    JAX's. Eval mode needs none."""

    generator: Optional[torch.Generator] = None
    train: bool = False

    def next_rng(self) -> torch.Generator:
        """unast_tpu/nn/core.py::Ctx.next_rng: the generator a stochastic
        op draws from."""
        if self.generator is None:
            raise ValueError("Ctx.generator is None but a stochastic op needs randomness")
        return self.generator

    @staticmethod
    def eval() -> "Ctx":
        return Ctx(generator=None, train=False)


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


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """unast_tpu/nn/core.py::linear. x: [..., in] @ w [in, out]."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv1d(p, x: torch.Tensor, padding) -> torch.Tensor:
    """unast_tpu/nn/core.py::conv1d. x: [B, T, Cin] -> [B, T', Cout];
    padding: int (symmetric) or (left, right); `w` is [k, Cin, Cout]."""
    if isinstance(padding, int):
        padding = (padding, padding)
    xt = F.pad(x.transpose(1, 2), tuple(padding))           # [B, Cin, T+l+r]
    w = p["w"].to(x.dtype).permute(2, 1, 0)                  # [Cout, Cin, k]
    y = F.conv1d(xt, w).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding(p, ids: torch.Tensor) -> torch.Tensor:
    """unast_tpu/nn/core.py::embedding (row gather)."""
    return p["w"][ids]


BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def batchnorm(p, s, x: torch.Tensor, train: bool):
    """unast_tpu/nn/core.py::batchnorm over the channel axis of [B, T, C] or
    [B, C] (torch BatchNorm1d semantics). train: normalise by the batch's
    statistics (biased variance, gradients flow through them) and move the
    running state toward them (unbiased variance), detached as JAX's state
    output is. Returns (y, new_state)."""
    dims = tuple(range(x.ndim - 1))
    if train:
        xf = x.float()
        mean = xf.mean(dim=dims)
        var = xf.var(dim=dims, unbiased=False)
        n = x.numel() // x.shape[-1]
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


def dropout(ctx: Ctx, x: torch.Tensor, p: float) -> torch.Tensor:
    """unast_tpu/nn/core.py::dropout (inverted, torch semantics): in train
    mode each element is kept with probability 1 - p and scaled by
    1 / (1 - p); a no-op in eval mode or at p = 0. The mask is drawn from
    ctx.next_rng(), so its bits differ from JAX's."""
    if not ctx.train or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=ctx.next_rng(),
                      device=x.device) < keep
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
    return x @ p["wi"].to(x.dtype) + (p["bi"] + p["bh"]).to(x.dtype)


def lstm_cell(p, gates_in, h, c):
    """unast_tpu/nn/core.py::lstm_cell, one step. gates_in: [B, 4H], this
    step's lstm_gates_in(p, x) (computed ahead for the whole sequence);
    h, c: [B, H]. Returns (h', c')."""
    gates = gates_in + h @ p["wh"].to(h.dtype)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def cast_weights(tree, dtype: torch.dtype):
    """Cast every linear/conv/embedding weight (`w`, and its `b`) to the
    activation dtype once, ahead of use. The apply functions cast these
    leaves to x.dtype anyway, so the rounding is the same; norm params
    and BN statistics stay float32 as in JAX."""
    if isinstance(tree, dict):
        out = {k: cast_weights(v, dtype) for k, v in tree.items()}
        if "w" in tree:
            for k in ("w", "b"):
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
