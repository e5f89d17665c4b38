"""The least time one H100 could take for a flash-attention call: frozen
copies of the forward and backward bounds the repository's chip smoke
test computes (chip_smoke.py::attention_bound and backward_bound), taking
the call's shapes instead of its tensors.

A call: q [B, Tq, H, D] of `dtype`, keys valid per row (kv_lens, or all
Tk), causal or not, the queries at q_start of the keys' sequence. Work:
the products over the (query, key) pairs the data keeps; bytes: each
input and output moved once. Float32 work is three TF32 products (split
TF32, as the float32 kernels compute it).
"""

import numpy as np

from .flops import PEAK_BF16, PEAK_BYTES, PEAK_TF32


def kept_pairs(tq, lens, causal, q_start=0):
    rows = np.arange(tq) + q_start
    return sum(int(np.minimum(rows + 1, n).sum()) if causal else tq * int(n)
               for n in lens)


def _item(dtype):
    return 2 if dtype == "bfloat16" else 4


def attention_bound(q_shape, dtype, lens, causal, q_start=0):
    """(ms, 'operations' or 'bytes') of one forward."""
    b, tq, h, d = q_shape
    lens = np.asarray(lens, np.int64)
    flops = 4 * h * d * kept_pairs(tq, lens, causal, q_start)
    nbytes = _item(dtype) * (2 * b * tq * h * d + 2 * h * d * int(lens.sum())) + 4 * b
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_BF16 if dtype == "bfloat16" else 3 * flops / PEAK_TF32
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def backward_bound(q_shape, dtype, lens, causal, q_start=0):
    """(ms, 'operations' or 'bytes') of one backward: five products (S,
    dV, dP, dQ, dK), against q, o, dO, dQ and the kept k, v, dK, dV rows."""
    b, tq, h, d = q_shape
    lens = np.asarray(lens, np.int64)
    flops = 5 * 2 * h * d * kept_pairs(tq, lens, causal, q_start)
    t_ops = flops / PEAK_BF16 if dtype == "bfloat16" else 3 * flops / PEAK_TF32
    nbytes = _item(dtype) * (4 * b * tq * h * d + 4 * h * d * int(lens.sum())) + 4 * b
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
