"""FastSpeech non-autoregressive TTS of the port, mirroring
`unast_tpu/models/fastspeech.py`: text encoder -> per-token duration
predictor -> length regulator -> frame-level transformer decoder -> mel
head + convolutional postnet, the whole mel in one forward pass (output
length = the sum of the predicted durations, no stop token), with the
optional FastSpeech-2 pitch and energy adaptors.

The duration sources of distillation are here too: per-frame argmax or
expected-mass counts over a teacher's cross-attention
(`durations_from_attention`) and the monotonic alignment search
(`mas_durations`, JAX's two lax.scans as loops over frames). The length
regulator gathers each frame's token by the same cumsum index JAX turns
into a one-hot matmul: the same values. The encoders are
models/transformer.py's, so attn_impl='flash' runs the flash kernel on
the text encoder and on the non-causal frame decoder.
"""

import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from .. import nn
from . import modules as M
from . import transformer as T
from .config import ModelConfig

# pitch-conditioning normalisation (unast_tpu/models/fastspeech.py:43-47)
_LOG_F0_CENTER = 5.5
_LOG_F0_SCALE = 0.5
_ENERGY_CENTER = 0.3


# ---------------------------------------------------------------------------
# Duration predictor: 2x (conv1d k3 -> ReLU -> LayerNorm -> dropout) -> linear
# ---------------------------------------------------------------------------


def duration_predictor_init(gen: torch.Generator, d: int):
    """unast_tpu/models/fastspeech.py::duration_predictor_init."""
    return {
        "conv1": nn.conv1d_init(gen, d, d, 3, w_init="relu"),
        "ln1": nn.layernorm_init(d),
        "conv2": nn.conv1d_init(gen, d, d, 3, w_init="relu"),
        "ln2": nn.layernorm_init(d),
        "fc": nn.linear_init(gen, d, 1, torch_default=True),
    }


def duration_predictor(p, ctx: nn.Ctx, x, pad_mask, dropout_p: float = 0.1):
    """unast_tpu/models/fastspeech.py::duration_predictor: x [B, Tt, D] ->
    float32 log-duration predictions [B, Tt], zero on PAD tokens; PAD
    positions are zeroed before each k=3 conv."""
    keep = (~pad_mask)[..., None].to(x.dtype)
    h = nn.conv1d(p["conv1"], x * keep, padding=(1, 1))
    h = nn.dropout(ctx, nn.layernorm(p["ln1"], torch.relu(h)), dropout_p)
    h = nn.conv1d(p["conv2"], h * keep, padding=(1, 1))
    h = nn.dropout(ctx, nn.layernorm(p["ln2"], torch.relu(h)), dropout_p)
    logd = nn.linear(p["fc"], h)[..., 0].float()
    return logd * (~pad_mask)


# ---------------------------------------------------------------------------
# Length regulator and the duration sources
# ---------------------------------------------------------------------------


def _owner(durations, tm: int):
    """[B, Tm] index of the token that owns each frame: the number of
    tokens whose cumulative end is <= the frame (Tt past the last one),
    and the [B, Tt] cumulative ends."""
    ends = torch.cumsum(durations.long(), dim=1)
    pos = torch.arange(tm, device=durations.device)
    return (pos[None, :, None] >= ends[:, None, :]).sum(dim=-1), ends


def length_regulate(x, durations, max_len: int):
    """unast_tpu/models/fastspeech.py::length_regulate: x [B, Tt, D],
    durations int [B, Tt] (0 on PAD) -> (frames [B, max_len, D], out_lens
    [B] = sum(durations) clipped to max_len). Frame j takes the token whose
    cumulative-duration interval holds j, by a gather where JAX multiplies
    by the one-hot (the same values); frames past out_lens are zero."""
    tt = x.shape[1]
    idx, ends = _owner(durations, max_len)
    out_lens = torch.clamp(ends[:, -1], max=max_len)
    frames = torch.gather(x, 1, idx.clamp(max=tt - 1)[..., None].expand(
        -1, -1, x.shape[2]))
    valid = M.lens_to_mask(out_lens, max_len)[..., None].to(x.dtype)
    return frames * valid, out_lens


def durations_from_attention(attn, mel_len, text_len, soft: bool = False):
    """unast_tpu/models/fastspeech.py::durations_from_attention: attn
    [L, B, H, Tm, Tt] teacher cross-attention probabilities -> int
    durations [B, Tt] summing to mel_len. soft=False: per-frame argmax
    counts (the first maximum; PAD columns at -inf). soft=True: the
    expected attention mass per token, floored, the leftover frames handed
    to the largest fractional parts (a stable sort, as jnp.argsort's, so
    ties go to the earlier token)."""
    a = attn.float().mean(dim=(0, 2))  # [B, Tm, Tt]
    tm, tt = a.shape[1], a.shape[2]
    text_valid = M.lens_to_mask(text_len, tt)
    frame_valid = M.lens_to_mask(mel_len, tm)
    if not soft:
        am = torch.where(text_valid[:, None, :], a,
                         torch.full_like(a, -math.inf))
        onehot = F.one_hot(torch.argmax(am, dim=-1), tt)
        return (onehot * frame_valid.long()[..., None]).sum(dim=1)
    mass = a * text_valid[:, None, :]
    mass = mass / torch.clamp(mass.sum(dim=-1, keepdim=True), min=1e-6)
    soft_d = (mass * frame_valid.float()[..., None]).sum(dim=1)
    base = torch.floor(soft_d)
    frac = soft_d - base
    short = mel_len.long() - base.sum(dim=1).long()
    order = torch.argsort(-frac, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return base.long() + (rank < short[:, None]).long()


def mas_durations(attn, mel_len, text_len):
    """unast_tpu/models/fastspeech.py::mas_durations: the monotonic
    alignment search (Viterbi) over the layer/head-averaged teacher
    attention [L, B, H, Tm, Tt]: the best monotonic surjective frame ->
    token path from token 0 at frame 0 to token text_len-1 at the last
    valid frame, maximising the summed log attention; its frame counts as
    int durations [B, Tt]. A diagonal move needs advance > stay strictly;
    PAD frames force a stay. JAX's forward and backward lax.scans are
    loops over the frames."""
    a = attn.float().mean(dim=(0, 2))  # [B, Tm, Tt]
    b, tm, tt = a.shape
    dev = a.device
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)
    text_valid = M.lens_to_mask(text_len, tt)
    frame_valid = M.lens_to_mask(mel_len, tm)
    log_a = torch.log(torch.clamp(a, 1e-9, 1.0))
    log_a = torch.where(text_valid[:, None, :], log_a, neg)
    log_a = torch.where(frame_valid[:, :, None], log_a, torch.zeros_like(log_a))
    q = torch.where(torch.arange(tt, device=dev) == 0, log_a[:, 0, :], neg)
    neg_col = neg.expand(b, 1)
    from_prev = []
    for t in range(1, tm):
        advance = torch.cat([neg_col, q[:, :-1]], dim=1)
        advance = torch.where(frame_valid[:, t, None], advance, neg)
        from_prev.append(advance > q)
        q = torch.maximum(q, advance) + log_a[:, t]
    j = torch.clamp(text_len.long() - 1, min=0)
    dur = torch.zeros((b, tt), dtype=torch.long, device=dev)
    for t in range(tm - 1, 0, -1):
        dur.scatter_add_(1, j[:, None], frame_valid[:, t, None].long())
        j = j - from_prev[t - 1].gather(1, j[:, None])[:, 0].long()
    dur[:, 0] += frame_valid[:, 0].long()
    return dur * text_valid.long()


def _span_onehot(durations, tm: int):
    """unast_tpu/models/fastspeech.py::_span_onehot: float32 [B, Tm, Tt]
    frame -> token one-hot of the duration spans (length_regulate's rule;
    frames past the last span are all zero)."""
    idx, _ = _owner(durations, tm)
    return F.one_hot(idx, durations.shape[1] + 1)[..., :-1].float()


def token_energy_in_graph(mel, durations, text_valid):
    """unast_tpu/models/fastspeech.py::token_energy_in_graph: the mean
    over each token's span of the frame energy (the mel's mean over bins)
    -> float32 [B, Tt], 0 on PAD tokens."""
    onehot = _span_onehot(durations, mel.shape[1])
    e_frame = mel.float().mean(dim=-1)
    num = torch.einsum("bmt,bm->bt", onehot, e_frame)
    den = onehot.sum(dim=1)
    return (num / torch.clamp(den, min=1.0)) * text_valid


def token_log_f0_in_graph(f0, durations, text_valid):
    """unast_tpu/models/fastspeech.py::token_log_f0_in_graph: the mean
    log-F0 over each token's voiced frames (f0 [B, Tm], 0 = unvoiced) ->
    float32 [B, Tt], 0 where the span is unvoiced or the token is PAD."""
    onehot = _span_onehot(durations, f0.shape[1])
    voiced = (f0 > 0).float()
    logf = torch.log(torch.clamp(f0, min=1e-3)) * voiced
    num = torch.einsum("bmt,bm->bt", onehot, logf)
    den = torch.einsum("bmt,bm->bt", onehot, voiced)
    return (num / torch.clamp(den, min=1.0)) * text_valid


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def fastspeech_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/fastspeech.py::fastspeech_init -> (params, state):
    the text prenet, the encoder, the duration predictor, the frame
    decoder and the speech postnet with its stop head deleted and a
    frame-level mel head (e_in -> num_mels); with cfg.nar_pitch / nar_energy
    the `pitch` / `energy` predictors and their `*_proj` conditionings.
    The state holds the prenet's and the postnet's BatchNorm statistics."""
    prenet_p, prenet_s = M.text_prenet_init(gen, cfg)
    postnet_p, postnet_s = M.speech_postnet_init(gen, cfg)
    del postnet_p["stop_proj"]
    postnet_p["mel_proj"] = nn.linear_init(gen, cfg.e_in, cfg.num_mels,
                                           torch_default=True)
    params = {
        "prenet": prenet_p,
        "encoder": T.encoder_init(gen, cfg.e_in, cfg.nhead, cfg.ffn_dim,
                                  cfg.num_layers),
        "dur": duration_predictor_init(gen, cfg.e_in),
        "decoder": T.encoder_init(gen, cfg.e_in, cfg.nhead, cfg.ffn_dim,
                                  cfg.num_layers),
        "postnet": postnet_p,
    }
    if cfg.nar_pitch:
        params["pitch"] = duration_predictor_init(gen, cfg.e_in)
        params["pitch_proj"] = nn.linear_init(gen, 1, cfg.e_in,
                                              torch_default=True)
    if cfg.nar_energy:
        params["energy"] = duration_predictor_init(gen, cfg.e_in)
        params["energy_proj"] = nn.linear_init(gen, 1, cfg.e_in,
                                               torch_default=True)
    return params, {"prenet": prenet_s, "postnet": postnet_s}


def _encode(p, s, ctx: nn.Ctx, cfg: ModelConfig, text, pad_mask):
    """unast_tpu/models/fastspeech.py::_encode: embed -> conv prenet ->
    positions -> transformer stack. Returns (h [B, Tt, D], prenet state)."""
    x = M.text_embed(p["prenet"], ctx, text, cfg)
    x, prenet_s = M.text_prenet_convs(p["prenet"], s["prenet"], ctx, x, cfg)
    x = M.positional_encoding(ctx, x)
    h = T.encoder(p["encoder"], ctx, x, pad_mask, cfg.nhead, cfg.e_drop,
                  impl=cfg.attn_impl)
    return h, prenet_s


def predict_variances(p, s, cfg: ModelConfig, text, text_lens):
    """unast_tpu/models/fastspeech.py::predict_variances: the eval-mode
    (no dropout, running BN statistics) predictions the distillation
    losses regress: (log_dur [B, Tt], log_f0 or None, energy or None)."""
    pad_mask = ~M.lens_to_mask(text_lens, text.shape[1])
    ctx = nn.Ctx.eval()
    h, _ = _encode(p, s, ctx, cfg, text, pad_mask)
    log_dur = duration_predictor(p["dur"], ctx, h, pad_mask, cfg.d_drop)
    log_f0 = (duration_predictor(p["pitch"], ctx, h, pad_mask, cfg.d_drop)
              if cfg.nar_pitch else None)
    energy = (duration_predictor(p["energy"], ctx, h, pad_mask, cfg.d_drop)
              if cfg.nar_energy else None)
    return log_dur, log_f0, energy


def predict_log_durations(p, s, cfg: ModelConfig, text, text_lens):
    """unast_tpu/models/fastspeech.py::predict_log_durations."""
    return predict_variances(p, s, cfg, text, text_lens)[0]


def fastspeech_forward(p, s, ctx: nn.Ctx, cfg: ModelConfig, text, text_lens,
                       durations=None, max_len: Optional[int] = None,
                       speed: float = 1.0, pitch_target=None,
                       pitch_shift: float = 1.0, energy_target=None,
                       energy_scale: float = 1.0):
    """unast_tpu/models/fastspeech.py::fastspeech_forward: text [B, Tt] ->
    ((pre, post [B, max_len, num_mels], out_lens, log_dur_pred [B, Tt]),
    new_state).

    durations: int [B, Tt] teacher durations (training), or None: then
    round(expm1(log_dur) / speed) in float32, rounded half to even as
    jnp.round. With cfg.nar_pitch the token states are conditioned on the
    normalised token log-F0 (pitch_target, else the pitch predictor's, its
    voiced tokens shifted by log(pitch_shift)); with cfg.nar_energy on the
    centred token energy (energy_target, else the predictor's times
    energy_scale). The predictors read the encoder output before either
    conditioning. The frames get positional_encoding(scale=False)."""
    tt = text.shape[1]
    max_len = int(max_len or cfg.max_mel_len)
    pad_mask = ~M.lens_to_mask(text_lens, tt)

    h, prenet_s = _encode(p, s, ctx, cfg, text, pad_mask)
    h_raw = h
    keep_tok = (~pad_mask)[..., None].to(h.dtype)

    log_dur = duration_predictor(p["dur"], ctx, h_raw, pad_mask, cfg.d_drop)
    if durations is None:
        durations = torch.round(torch.expm1(log_dur) / speed).long()
        durations = torch.clamp(durations, min=0) * (~pad_mask)

    if cfg.nar_pitch:
        if pitch_target is None:
            pf = duration_predictor(p["pitch"], ctx, h_raw, pad_mask,
                                    cfg.d_drop)
            shift = torch.log(torch.tensor(pitch_shift, dtype=torch.float32))
            pf = torch.where(pf > 0, pf + shift.to(pf.device), pf)
        else:
            pf = pitch_target.float()
        pf = torch.where(pf > 0, (pf - _LOG_F0_CENTER) / _LOG_F0_SCALE,
                         torch.zeros_like(pf))
        emb = nn.linear(p["pitch_proj"], pf[..., None]).to(h.dtype)
        h = h + emb * keep_tok

    if cfg.nar_energy:
        if energy_target is None:
            ef = duration_predictor(p["energy"], ctx, h_raw, pad_mask,
                                    cfg.d_drop) * energy_scale
        else:
            ef = energy_target.float()
        ef = torch.where(ef != 0, ef - _ENERGY_CENTER, torch.zeros_like(ef))
        emb = nn.linear(p["energy_proj"], ef[..., None]).to(h.dtype)
        h = h + emb * keep_tok

    frames, out_lens = length_regulate(h, durations, max_len)
    frames = M.positional_encoding(ctx, frames, scale=False)
    frame_pad = ~M.lens_to_mask(out_lens, max_len)
    d = T.encoder(p["decoder"], ctx, frames, frame_pad, cfg.nhead,
                  cfg.d_drop, impl=cfg.attn_impl)

    pre = nn.linear(p["postnet"]["mel_proj"], d)
    resid, postnet_s = M.speech_postnet(p["postnet"], s["postnet"], ctx,
                                        pre, cfg)
    keep = (~frame_pad)[..., None].to(pre.dtype)
    return ((pre * keep, (pre + resid) * keep, out_lens, log_dur),
            {"prenet": prenet_s, "postnet": postnet_s})


# ---------------------------------------------------------------------------
# The artefact's format stamp
# ---------------------------------------------------------------------------

NAR_PICKLE_FORMAT = 2
"""unast_tpu/models/fastspeech.py::NAR_PICKLE_FORMAT. Format 2: the frame
decoder's input takes positional_encoding(scale=False); weights of format
1 were trained under sqrt(d) input scaling and give wrong mels here."""


def check_nar_format(obj, path: str):
    """unast_tpu/models/fastspeech.py::load_nar_pickle's stamp rule on a
    loaded object: a {'nar_format', 'pv'} dict of another format raises
    ValueError; an unversioned (params, net_state) pair warns. Returns
    the (params, net_state) tuple."""
    if isinstance(obj, dict) and "nar_format" in obj:
        if obj["nar_format"] != NAR_PICKLE_FORMAT:
            raise ValueError(
                f"{path}: NAR format {obj['nar_format']} != "
                f"{NAR_PICKLE_FORMAT}: re-distill (format 2 changed the "
                "frame-decoder PE scaling; old weights are incompatible)")
        return tuple(obj["pv"])
    warnings.warn(f"{path}: unversioned NAR weights (no format stamp); "
                  "cannot verify the frame-decoder PE vintage", stacklevel=3)
    return tuple(obj)


def save_nar_checkpoint(path: str, params, net_state):
    """unast_tpu/models/fastspeech.py::save_nar_pickle for the port: one
    torch.save file {'nar_format': 2, 'pv': (params, net_state)} of plain
    trees (CPU tensors)."""
    cpu = (nn.tree_to(params, "cpu"), nn.tree_to(net_state, "cpu"))
    torch.save({"nar_format": NAR_PICKLE_FORMAT, "pv": cpu}, path)


def load_nar_checkpoint(path: str, device="cpu"):
    """unast_tpu/models/fastspeech.py::load_nar_pickle for the port ->
    (params, net_state) on `device`, loaded with weights_only=True; a stale
    stamp raises ValueError, an unversioned pair warns."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return tuple(nn.tree_to(t, device) for t in check_nar_format(obj, path))
