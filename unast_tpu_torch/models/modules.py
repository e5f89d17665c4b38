"""Shared NN modules of the port: masks, positional encoding, the speech and
text prenets and postnets. Mirrors `unast_tpu/models/modules.py`; all
activations are [B, T, C] channels-last.
"""

import functools
import math

import numpy as np
import torch

from .. import nn
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
    `offset` is the position of x[:, 0] (incremental decode)."""
    d = x.shape[-1]
    t = x.shape[1]
    pos = _pe_table(d, x.device)[offset:offset + t]
    if scale:
        x = x * math.sqrt(d)
    x = x + pos[None, :, :].to(x.dtype)
    return nn.dropout(ctx, x, dropout_p)


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
    x = nn.dropout(ctx, torch.relu(nn.linear(p["fc1"], x)), cfg.s_pre_drop)
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
    h = nn.dropout(ctx, torch.tanh(h), cfg.s_post_drop)
    for i, cp in enumerate(p["convs"]):
        h2 = nn.conv1d(cp, h, padding=(4, 0))
        h2, new_bn[f"bn{i+1}"] = nn.batchnorm(
            p["bn"][f"bn{i+1}"], s["bn"][f"bn{i+1}"], h2, ctx.train)
        h = nn.dropout(ctx, torch.tanh(h2), cfg.s_post_drop)
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


def text_prenet_convs(p, s, ctx: nn.Ctx, x, cfg: ModelConfig, causal=False):
    """unast_tpu/models/modules.py::text_prenet_convs -> (x, new_state)."""
    pad = (4, 0) if causal else (2, 2)
    new_bn = {}
    for i in (1, 2, 3):
        x = nn.conv1d(p[f"conv{i}"], x, padding=pad)
        x, new_bn[f"bn{i}"] = nn.batchnorm(
            p["bn"][f"bn{i}"], s["bn"][f"bn{i}"], x, ctx.train)
        x = nn.dropout(ctx, torch.relu(x), cfg.t_pre_drop)
    return x, {"bn": new_bn}


# ---------------------------------------------------------------------------
# TextPostnet: dropout + Linear hidden -> 46
# ---------------------------------------------------------------------------


def text_postnet_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/modules.py::text_postnet_init."""
    return {"fc": nn.linear_init(gen, cfg.hidden, VOCAB_SIZE, torch_default=True)}


def text_postnet(p, ctx: nn.Ctx, x, cfg: ModelConfig):
    """unast_tpu/models/modules.py::text_postnet."""
    return nn.linear(p["fc"], nn.dropout(ctx, x, cfg.t_post_drop))
