"""Neural vocoders of the port, mirroring `unast_tpu/models/melgan.py`: the
MelGAN generator (mel [B, T, 80] -> tanh-bounded raw waveform [B, T*hop]
in one forward pass; three transposed-conv stages of stride 5/5/11, each
followed by dilated residual blocks), the HiFi-GAN generator (the same
skeleton with multi-receptive-field fusion), and the adversarial
fine-tune's multi-scale (MelGAN) and multi-period (HiFi-GAN)
discriminators.

Weights keep JAX's layouts, so bridge.melgan_from_jax maps them name for
name: a 1-D conv's `w` is [k, in, out] (WIO), a 2-D conv's [kh, kw, in,
out] (HWIO); the permutes happen at the call. Activations are [B, W, C]
(or [B, H, W, C]) channels-last, as in JAX. Each weight is cast to the
activation dtype at use (nn.weight).
"""

import math

import torch
import torch.nn.functional as F

from .. import nn

LEAK = 0.2  # MelGAN LeakyReLU slope


def _lrelu(x):
    return F.leaky_relu(x, LEAK)


def _conv_init(gen: torch.Generator, c_in: int, c_out: int, k: int):
    """unast_tpu/models/melgan.py::_conv_init: w [k, in, out], b [out],
    both U(-1/sqrt(k*in), ..)."""
    fan_in = k * c_in
    return {"w": nn.torch_linear_uniform(gen, (k, c_in, c_out), fan_in),
            "b": nn.torch_linear_uniform(gen, (c_out,), fan_in)}


def _conv(p, x, dilation: int = 1):
    """unast_tpu/models/melgan.py::_conv: same-padded 1-D conv of x
    [B, W, C], the span's padding split (span//2, span - span//2)."""
    k = p["w"].shape[0]
    span = (k - 1) * dilation
    xt = F.pad(x.transpose(1, 2), (span // 2, span - span // 2))
    y = F.conv1d(xt, nn.weight(p, x.dtype).permute(2, 1, 0),
                 dilation=dilation).transpose(1, 2)
    return y + p["b"].to(x.dtype)


def _convT(p, x, stride: int):
    """unast_tpu/models/melgan.py::_convT: lax.conv_transpose(x, w,
    (stride,), 'SAME') with transpose_kernel=False, k = 2*stride, which
    upsamples W exactly stride-fold.

    lax takes it as a correlation of the stride-dilated input (zeros
    between samples) with the kernel as given, padded by
    lax._conv_transpose_padding(k, s, 'SAME'): pad_len = k + s - 2 = 3s - 2,
    pad_a = ceil(pad_len / 2) (as s <= k - 1), pad_b = pad_len - pad_a; for
    s = 5 (7, 6), for s = 11 (16, 15); the output is W*s long. torch's
    conv_transpose1d is the adjoint of a strided conv: the same sum with the
    kernel flipped, padded by k - 1 - p on each side. So p = k - 1 - pad_a
    (2 for s = 5, 5 for s = 11) puts pad_a on the left; the right gets one
    sample more than pad_b, whose last output sample is dropped."""
    k = p["w"].shape[0]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else math.ceil(pad_len / 2)
    w = nn.weight(p, x.dtype).permute(1, 2, 0).flip(-1)   # [in, out, k]
    y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride,
                           padding=k - 1 - pad_a)
    y = y[..., :x.shape[1] * stride].transpose(1, 2)
    return y + p["b"].to(x.dtype)


def _resblock_init(gen: torch.Generator, c: int, dilations=(1, 3, 9)):
    """unast_tpu/models/melgan.py::_resblock_init."""
    return [{"d1": _conv_init(gen, c, c, 3), "d2": _conv_init(gen, c, c, 1)}
            for _ in dilations]


def _resblock(ps, x, dilations=(1, 3, 9)):
    """unast_tpu/models/melgan.py::_resblock."""
    for p, d in zip(ps, dilations):
        h = _conv(p["d1"], _lrelu(x), dilation=d)
        x = x + _conv(p["d2"], _lrelu(h))
    return x


def melgan_init(gen: torch.Generator, n_mels: int = 80, base: int = 256,
                rates=(5, 5, 11), dilations=(1, 3, 9)):
    """unast_tpu/models/melgan.py::melgan_init: params of a mel -> wav
    generator with prod(rates) == hop; the channels halve each stage, to
    no fewer than 32."""
    params = {"pre": _conv_init(gen, n_mels, base, 7), "ups": [], "res": []}
    c = base
    for r in rates:
        c_out = max(c // 2, 32)
        params["ups"].append(_conv_init(gen, c, c_out, 2 * r))
        params["res"].append(_resblock_init(gen, c_out, dilations))
        c = c_out
    params["post"] = _conv_init(gen, c, 1, 7)
    return params


def melgan_forward(p, mel, rates=(5, 5, 11), dilations=(1, 3, 9)):
    """unast_tpu/models/melgan.py::melgan_forward: mel [B, T, n_mels] ->
    wav [B, T * prod(rates)], tanh-bounded."""
    x = _conv(p["pre"], mel)
    for up, res, r in zip(p["ups"], p["res"], rates):
        x = _convT(up, _lrelu(x), r)
        x = _resblock(res, x, dilations)
    x = _conv(p["post"], _lrelu(x))
    return torch.tanh(x)[..., 0]


def num_params(p) -> int:
    """unast_tpu/models/melgan.py::num_params: the count of weights."""
    if isinstance(p, dict):
        return sum(num_params(v) for v in p.values())
    if isinstance(p, (list, tuple)):
        return sum(num_params(v) for v in p)
    return int(math.prod(p.shape))


# ---------------------------------------------------------------------------
# HiFi-GAN generator: multi-receptive-field fusion per stage
# ---------------------------------------------------------------------------

MRF_KERNELS = (3, 7, 11)
MRF_DILATIONS = (1, 3, 5)


def _resblock1_init(gen: torch.Generator, c: int, k: int,
                    dilations=MRF_DILATIONS):
    """unast_tpu/models/melgan.py::_resblock1_init."""
    return [{"c1": _conv_init(gen, c, c, k), "c2": _conv_init(gen, c, c, k)}
            for _ in dilations]


def _resblock1(ps, x, dilations=MRF_DILATIONS):
    """unast_tpu/models/melgan.py::_resblock1 (HiFi-GAN ResBlock1): per
    dilation d, x += conv_k(lrelu(conv_k(lrelu(x), dil=d)), dil=1)."""
    for p, d in zip(ps, dilations):
        h = _conv(p["c1"], _lrelu(x), dilation=d)
        x = x + _conv(p["c2"], _lrelu(h))
    return x


def hifigan_init(gen: torch.Generator, n_mels: int = 80, base: int = 256,
                 rates=(5, 5, 11), kernels=MRF_KERNELS,
                 dilations=MRF_DILATIONS):
    """unast_tpu/models/melgan.py::hifigan_init: mel -> wav generator with
    MRF stages (one ResBlock1 stack per kernel size); prod(rates) == hop."""
    params = {"pre": _conv_init(gen, n_mels, base, 7), "ups": [], "mrf": []}
    c = base
    for r in rates:
        c_out = max(c // 2, 32)
        params["ups"].append(_conv_init(gen, c, c_out, 2 * r))
        params["mrf"].append([_resblock1_init(gen, c_out, k, dilations)
                              for k in kernels])
        c = c_out
    params["post"] = _conv_init(gen, c, 1, 7)
    return params


def hifigan_forward(p, mel, rates=(5, 5, 11), dilations=MRF_DILATIONS):
    """unast_tpu/models/melgan.py::hifigan_forward: mel [B, T, n_mels] ->
    wav [B, T * prod(rates)], tanh-bounded; each stage's ResBlock1 stacks
    averaged."""
    x = _conv(p["pre"], mel)
    for up, stage, r in zip(p["ups"], p["mrf"], rates):
        x = _convT(up, _lrelu(x), r)
        acc = None
        for res in stage:
            y = _resblock1(res, x, dilations)
            acc = y if acc is None else acc + y
        x = acc / len(stage)
    x = _conv(p["post"], _lrelu(x))
    return torch.tanh(x)[..., 0]


def generator_init(gen: torch.Generator, kind: str = "melgan",
                   n_mels: int = 80, base: int = 256):
    """unast_tpu/models/melgan.py::generator_init."""
    if kind == "hifigan":
        return hifigan_init(gen, n_mels=n_mels, base=base)
    if kind == "melgan":
        return melgan_init(gen, n_mels=n_mels, base=base)
    raise ValueError(f"unknown generator kind {kind!r}")


def generator_forward(p, mel):
    """unast_tpu/models/melgan.py::generator_forward: HiFi-GAN when the tree
    has 'mrf', else MelGAN."""
    return hifigan_forward(p, mel) if "mrf" in p else melgan_forward(p, mel)


def receptive_field(p) -> int:
    """unast_tpu/models/melgan.py::receptive_field: the one-sided context
    in mel frames the chunked and streaming vocoders keep (48 for the MRF,
    24 for MelGAN; conservative, exactness-tested)."""
    return 48 if "mrf" in p else 24


# ---------------------------------------------------------------------------
# Multi-scale waveform discriminator (MelGAN)
# ---------------------------------------------------------------------------

_D_LAYERS = ((15, 1, 16, 1), (41, 16, 64, 4), (41, 64, 256, 4),
             (41, 256, 256, 4), (5, 256, 256, 1))  # (k, c_in, c_out, stride)


def _strided_conv(p, x, stride: int):
    """unast_tpu/models/melgan.py::_strided_conv: x [B, W, C] padded
    (k//2, k-1-k//2), then a conv of the given stride."""
    k = p["w"].shape[0]
    xt = F.pad(x.transpose(1, 2), (k // 2, k - 1 - k // 2))
    y = F.conv1d(xt, nn.weight(p, x.dtype).permute(2, 1, 0),
                 stride=stride).transpose(1, 2)
    return y + p["b"].to(x.dtype)


def discriminator_init(gen: torch.Generator, scales: int = 3):
    """unast_tpu/models/melgan.py::discriminator_init: per scale the
    _D_LAYERS convs and a k3 conv to one logit channel."""
    out = []
    for _ in range(scales):
        layers = [_conv_init(gen, c_in, c_out, k)
                  for (k, c_in, c_out, _) in _D_LAYERS]
        layers.append(_conv_init(gen, _D_LAYERS[-1][2], 1, 3))
        out.append(layers)
    return out


def _avgpool2(x):
    """unast_tpu/models/melgan.py::_avgpool2: pairwise means over W (an odd
    last sample dropped)."""
    n = x.shape[1] - x.shape[1] % 2
    return x[:, :n].reshape(x.shape[0], n // 2, 2, x.shape[2]).mean(dim=2)


def discriminator_forward(p, wav):
    """unast_tpu/models/melgan.py::discriminator_forward: wav [B, n] -> per
    scale (features list, logits [B, T', 1]); each scale sees the signal
    average-pooled 2x further."""
    x = wav[..., None]
    outs = []
    for scale in p:
        h = x
        feats = []
        for lp, (_, _, _, stride) in zip(scale[:-1], _D_LAYERS):
            h = _lrelu(_strided_conv(lp, h, stride))
            feats.append(h)
        outs.append((feats, _strided_conv(scale[-1], h, 1)))
        x = _avgpool2(x)
    return outs


# ---------------------------------------------------------------------------
# Multi-period discriminator (HiFi-GAN)
# ---------------------------------------------------------------------------

_PERIODS = (2, 3, 5, 7, 11)
_P_CHANNELS = (32, 128, 512, 1024)  # stride 3 over time each


def _conv2_init(gen: torch.Generator, c_in: int, c_out: int, kh: int,
                kw: int = 1):
    """unast_tpu/models/melgan.py::_conv2_init: w [kh, kw, in, out]."""
    fan_in = kh * kw * c_in
    return {"w": nn.torch_linear_uniform(gen, (kh, kw, c_in, c_out), fan_in),
            "b": nn.torch_linear_uniform(gen, (c_out,), fan_in)}


def _conv2(p, x, stride: int = 1):
    """unast_tpu/models/melgan.py::_conv2: x [B, H, W, C], a (kh, 1) kernel
    strided over H (time) only, H padded (kh//2, kh-1-kh//2). The
    permuted kernel is made contiguous: torch's float64 CPU conv2d refuses
    the gradient of a strided one."""
    kh = p["w"].shape[0]
    xt = F.pad(x.permute(0, 3, 1, 2), (0, 0, kh // 2, kh - 1 - kh // 2))
    y = F.conv2d(xt, nn.weight(p, x.dtype).permute(3, 2, 0, 1).contiguous(),
                 stride=(stride, 1)).permute(0, 2, 3, 1)
    return y + p["b"].to(x.dtype)


def mpd_init(gen: torch.Generator, periods=_PERIODS):
    """unast_tpu/models/melgan.py::mpd_init."""
    out = []
    for _ in periods:
        c = 1
        layers = []
        for c_out in _P_CHANNELS:
            layers.append(_conv2_init(gen, c, c_out, 5))
            c = c_out
        layers.append(_conv2_init(gen, c, 1024, 5))
        layers.append(_conv2_init(gen, 1024, 1, 3))
        out.append(layers)
    return out


def mpd_forward(p, wav, periods=_PERIODS):
    """unast_tpu/models/melgan.py::mpd_forward: wav [B, n] -> per period
    (features list, logits [B, T', period, 1]). The wav is reflect-padded
    (the edge sample excluded, as jnp.pad's 'reflect') to a multiple of the
    period and folded to [B, n/period, period, 1]."""
    outs = []
    for layers, period in zip(p, periods):
        pad = (-wav.shape[1]) % period
        x = wav
        if pad:
            x = F.pad(wav[:, None], (0, pad), mode="reflect")[:, 0]
        x = x.reshape(x.shape[0], -1, period)[..., None]
        feats = []
        h = x
        for lp in layers[:-2]:
            h = _lrelu(_conv2(lp, h, stride=3))
            feats.append(h)
        h = _lrelu(_conv2(layers[-2], h, stride=1))
        feats.append(h)
        outs.append((feats, _conv2(layers[-1], h, stride=1)))
    return outs


def adv_disc_init(gen: torch.Generator, kind: str = "msd"):
    """unast_tpu/models/melgan.py::adv_disc_init: kind 'msd', 'mpd' or
    'msd+mpd' -> {'msd': ..., 'mpd': ...}."""
    d = {}
    if "msd" in kind:
        d["msd"] = discriminator_init(gen)
    if "mpd" in kind:
        d["mpd"] = mpd_init(gen)
    if not d:
        raise ValueError(f"unknown discriminator kind {kind!r}")
    return d


def adv_disc_forward(p, wav):
    """unast_tpu/models/melgan.py::adv_disc_forward: one flat list of
    (features, logits) over the sub-discriminators of an adv_disc_init
    dict, or of a bare MSD list (the legacy tree)."""
    if isinstance(p, list):
        return discriminator_forward(p, wav)
    outs = []
    if "msd" in p:
        outs += discriminator_forward(p["msd"], wav)
    if "mpd" in p:
        outs += mpd_forward(p["mpd"], wav)
    return outs
