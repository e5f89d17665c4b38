"""Plain PyTorch and NumPy reference of one-pass text-to-speech: a
FastSpeech student (text encoder, duration predictor, length regulator,
frame decoder, mel head and convolutional postnet) and a MelGAN generator,
then the cut at the frame count and the silence trim on the host, in PCM16.

It imports nothing of the program. Its weights are in the program's
layouts (benchmark/reference/model.py makes them from a seed); its texts
are phonemised by the benchmark's frozen lexicon (benchmark/data/
lexicon.json). The program's served durations are what the reference is
teacher-forced on, as a served model's tokens are: `log_durations` gives
the reference's own prediction to judge them by.
"""

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M

HOP = 275                     # 22,050 Hz at 12.5 ms a frame
TRIM_FRAME, TRIM_HOP, TRIM_TOP_DB = 2048, 512, 60.0
SPACE = 3
MELGAN_RATES = (5, 5, 11)
MELGAN_DILATIONS = (1, 3, 9)
LEAK = 0.2


# ---------------------------------------------------------------------------
# Text: the frozen lexicon
# ---------------------------------------------------------------------------

def load_lexicon(root):
    with open(os.path.join(root, "benchmark", "data", "lexicon.json")) as f:
        return json.load(f)


def phonemize(text: str, lexicon) -> list:
    """Phoneme ids of a text of lexicon words joined by single spaces:
    each word's ids, the space symbol between words, EOS at the end."""
    ids = []
    for i, w in enumerate(text.split(" ")):
        if i:
            ids.append(SPACE)
        ids.extend(lexicon[w])
    return ids + [M.EOS]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def fastspeech_spec(c):
    post = M.speech_postnet_spec(c)
    del post["stop_proj"]
    post["mel_proj"] = M._linear(c["e_in"], c["num_mels"], torch_default=True)
    d = c["e_in"]
    dur = {"conv1": M._conv(d, d, 3, M.RELU_GAIN), "ln1": M._ln(d),
           "conv2": M._conv(d, d, 3, M.RELU_GAIN), "ln2": M._ln(d),
           "fc": M._linear(d, 1, torch_default=True)}
    return {"prenet": M.text_prenet_spec(c),
            "encoder": M.stack_spec(c, M._enc_layer),
            "dur": dur,
            "decoder": M.stack_spec(c, M._enc_layer),
            "postnet": post}


def fastspeech_state(c):
    return {"prenet": M.bn_state(c["e_in"], ("bn1", "bn2", "bn3")),
            "postnet": M.bn_state(c["hidden"], [f"bn{i}" for i in range(4)])}


def _mg_conv(c_in, c_out, k):
    a = 1.0 / math.sqrt(k * c_in)
    return {"w": M._u(a, k, c_in, c_out), "b": M._u(a, c_out)}


def melgan_spec(n_mels=80, base=256):
    spec = {"pre": _mg_conv(n_mels, base, 7), "ups": [], "res": []}
    c = base
    for r in MELGAN_RATES:
        c_out = max(c // 2, 32)
        spec["ups"].append(_mg_conv(c, c_out, 2 * r))
        spec["res"].append([{"d1": _mg_conv(c_out, c_out, 3),
                             "d2": _mg_conv(c_out, c_out, 1)}
                            for _ in MELGAN_DILATIONS])
        c = c_out
    spec["post"] = _mg_conv(c, 1, 7)
    return spec


# ---------------------------------------------------------------------------
# FastSpeech, eval mode
# ---------------------------------------------------------------------------

def _encode(ctx, p, s, text, lens, c):
    x = M.text_embed(ctx, p["prenet"], text, c)
    x, _ = M.text_prenet_convs(ctx, p["prenet"], s["prenet"], x, c)
    x = M.positional_encoding(ctx, x)
    return M.encoder(ctx, p["encoder"], x, lens, c, c["e_drop"])


def log_durations(ctx, p, h, lens):
    keep = M.lens_mask(lens, h.shape[1])[..., None].float()
    x = M.conv1d(ctx, p["conv1"], h * keep, (1, 1))
    x = M.layernorm(p["ln1"], torch.relu(x), ctx.rnd)
    x = M.conv1d(ctx, p["conv2"], x * keep, (1, 1))
    x = M.layernorm(p["ln2"], torch.relu(x), ctx.rnd)
    return M.linear(ctx, p["fc"], x)[..., 0] * keep[..., 0]


def fastspeech(p, s, c, text, lens, durations, max_len, prec="f32"):
    """(post mel [B, max_len, n_mels], out_lens, log-duration predictions)
    with the given integer durations [B, Tt]."""
    ctx = M.Ctx(None, False, M.rounder(prec))
    h = _encode(ctx, p, s, text, lens, c)
    logd = log_durations(ctx, p["dur"], h, lens)
    ends = torch.cumsum(durations.long(), dim=1)
    out_lens = torch.clamp(ends[:, -1], max=max_len)
    pos = torch.arange(max_len, device=text.device)
    owner = (pos[None, :, None] >= ends[:, None, :]).sum(dim=-1)
    frames = torch.gather(h, 1, owner.clamp(max=h.shape[1] - 1)[..., None]
                          .expand(-1, -1, h.shape[2]))
    frames = frames * M.lens_mask(out_lens, max_len)[..., None].float()
    frames = M.positional_encoding(ctx, frames, scale=False)
    d = M.encoder(ctx, p["decoder"], frames, out_lens, c, c["d_drop"])
    pre = M.linear(ctx, p["postnet"]["mel_proj"], d)
    resid, _ = M.speech_postnet(ctx, p["postnet"], s["postnet"], pre, c)
    keep = M.lens_mask(out_lens, max_len)[..., None].float()
    return (pre + resid) * keep, out_lens, logd


# ---------------------------------------------------------------------------
# MelGAN
# ---------------------------------------------------------------------------

def _conv(rnd, p, x, dilation=1):
    k = p["w"].shape[0]
    span = (k - 1) * dilation
    xt = F.pad(rnd(x).transpose(1, 2), (span // 2, span - span // 2))
    y = F.conv1d(xt, rnd(p["w"]).permute(2, 1, 0), dilation=dilation)
    return rnd(y.transpose(1, 2) + p["b"])


def _conv_transpose(rnd, p, x, stride):
    """Upsampling by `stride` as a correlation of the stride-dilated input
    with the kernel as given, padded (pad_a, pad_b), pad_a + pad_b =
    k + stride - 2, pad_a = ceil of half (TensorFlow's and XLA's 'SAME'
    transposed convolution)."""
    k = p["w"].shape[0]
    b, t, c = x.shape
    dil = x.new_zeros((b, (t - 1) * stride + 1, c))
    dil[:, ::stride] = x
    pad_len = k + stride - 2
    pad_a = math.ceil(pad_len / 2)
    xt = F.pad(rnd(dil).transpose(1, 2), (pad_a, pad_len - pad_a))
    y = F.conv1d(xt, rnd(p["w"]).permute(2, 1, 0))
    return rnd(y.transpose(1, 2) + p["b"])


def melgan(p, mel, prec="f32"):
    """mel [B, T, n_mels] -> wav [B, T * 275] in [-1, 1]."""
    rnd = M.rounder(prec)
    lrelu = lambda x: F.leaky_relu(x, LEAK)
    x = _conv(rnd, p["pre"], mel)
    for up, res, r in zip(p["ups"], p["res"], MELGAN_RATES):
        x = _conv_transpose(rnd, up, lrelu(x), r)
        for q, d in zip(res, MELGAN_DILATIONS):
            h = _conv(rnd, q["d1"], lrelu(x), dilation=d)
            x = rnd(x + _conv(rnd, q["d2"], lrelu(h)))
    return torch.tanh(_conv(rnd, p["post"], lrelu(x)))[..., 0]


# ---------------------------------------------------------------------------
# Host: PCM16, the cut and the trim
# ---------------------------------------------------------------------------

def pcm16(wav: np.ndarray) -> np.ndarray:
    return np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


def trim_bounds(y: np.ndarray):
    """(start, end) of the samples to keep: centred frames of TRIM_FRAME
    samples every TRIM_HOP, each frame's mean square in dB below the
    loudest frame's; the span from the first to the last frame within
    TRIM_TOP_DB of it (librosa.effects.trim)."""
    n = len(y)
    if n == 0:
        return 0, 0
    y2 = (y.astype(np.float64) / 32767.0) ** 2 if y.dtype == np.int16 else \
        y.astype(np.float64) ** 2
    pad = TRIM_FRAME // 2
    padded = np.concatenate([np.zeros(pad), y2, np.zeros(pad)])
    n_frames = 1 + (n + 2 * pad - TRIM_FRAME) // TRIM_HOP
    mse = np.array([padded[i * TRIM_HOP:i * TRIM_HOP + TRIM_FRAME].sum()
                    for i in range(n_frames)]) / TRIM_FRAME
    db = 10.0 * np.log10(np.maximum(mse, 1e-10) / max(mse.max(), 1e-10))
    keep = np.flatnonzero(db > -TRIM_TOP_DB)
    if len(keep) == 0:
        return 0, 0
    return int(keep[0]) * TRIM_HOP, min(n, (int(keep[-1]) + 1) * TRIM_HOP)
