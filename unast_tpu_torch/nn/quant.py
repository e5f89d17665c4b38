"""Int8 weight-only quantization for serving, mirroring
`unast_tpu/nn/quant.py`.

Every >= 2-D floating weight leaf named `w`, `wi` or `wh` becomes
{name}_q (int8, the same shape) and {name}_scale (float32 over the last
axis, the output channels): symmetric, scale = amax / 127 over every axis
but the last, so an expert stack [E, D, F] gets one scale per output
channel across all its experts. Biases, norms and 1-D leaves stay as they
are. nn/core.py::weight dequantizes at every use, in the compute dtype, as
JAX does; the forward code serves both trees. Training on a quantized tree
is not supported.
"""

import torch

_WEIGHT_KEYS = ("w", "wi", "wh")


def quantize_leaf(w: torch.Tensor):
    """unast_tpu/nn/quant.py::quantize_leaf: a [..., out] float weight ->
    (int8 of the same shape, float32 [out] scale). torch.round rounds half
    to even, as jnp.round does."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_params(params):
    """unast_tpu/nn/quant.py::quantize_params: replace every weight leaf of
    the tree with its {name}_q / {name}_scale pair."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if (k in _WEIGHT_KEYS and isinstance(v, torch.Tensor)
                    and v.ndim >= 2 and v.is_floating_point()):
                out[k + "_q"], out[k + "_scale"] = quantize_leaf(v)
            else:
                out[k] = quantize_params(v)
        return out
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_params(v) for v in params)
    return params


def dequantize_params(params):
    """unast_tpu/nn/quant.py::dequantize_params: the dense float32 weights
    back from the int8 + scale pairs (up to the rounding)."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k.endswith("_q"):
                name = k[:-2]
                out[name] = v.float() * params[name + "_scale"].float()
            elif k.endswith("_scale") and k[:-6] + "_q" in params:
                continue
            else:
                out[k] = dequantize_params(v)
        return out
    if isinstance(params, (list, tuple)):
        return type(params)(dequantize_params(v) for v in params)
    return params


def quantized_bytes(params) -> int:
    """unast_tpu/nn/quant.py::quantized_bytes: the bytes of every leaf of a
    (possibly quantized) tree."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()
