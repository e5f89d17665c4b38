"""UNAST facade of the port: init, the six task methods, the LSTM
discriminator (and the MLP one) and the CBHG vocoder, mirroring
`unast_tpu/models/unast.py`.

All tasks are functions (params, state, ctx, cfg, batch) -> (outputs,
new_state). The cross-modal tasks make their greedy pseudo-pairs under
torch.no_grad(), the counterpart of JAX's stop_gradient over them, so those
encodes and decodes keep no graph and take no part in the backward.
"""

import torch
from torch.profiler import record_function

from .. import nn
from .config import EOS_IDX, ModelConfig
from . import ctc as CT
from . import modules as M
from . import networks as N
from . import rnn as R


def unast_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/unast.py::unast_init. Returns (params, state) with
    text_m and speech_m, and the LSTM discriminator when
    cfg.use_discriminator (its input is the encoder output,
    cfg.enc_out_dim wide)."""
    text_p, text_s = N.text_init(gen, cfg)
    speech_p, speech_s = N.speech_init(gen, cfg)
    params = {"text_m": text_p, "speech_m": speech_p}
    if cfg.use_discriminator:
        params["discriminator"] = lstm_discriminator_init(
            gen, cfg.enc_out_dim, cfg.disc_hid, cfg.disc_bidirectional,
            cfg.disc_num_layers)
    return params, {"text_m": text_s, "speech_m": speech_s}


def num_params(params) -> int:
    """unast_tpu/models/unast.py::num_params: the element count of every
    leaf of the tree."""
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(num_params(v) for v in params)
    return params.numel()


def _merge(state, **updates):
    out = dict(state)
    out.update(updates)
    return out


def _latent(enc_outputs, cfg: ModelConfig):
    """unast_tpu/models/unast.py::_latent: the per-position latent the
    discriminator sees: the transformer memory, or the RNN encoder's output
    sequence (enc_out of ((h, c), enc_out))."""
    if cfg.model_type == "transformer":
        return enc_outputs
    return enc_outputs[1]


# ---------------------------------------------------------------------------
# The six task methods
# ---------------------------------------------------------------------------


def text_ae(params, state, ctx, cfg: ModelConfig, text, text_len,
            ret_enc_hid=False, cross_weights_out=None):
    """unast_tpu/models/unast.py::text_ae, the denoising text autoencoder.
    Keeps the text prenet's new BN state."""
    (enc, mask), ts = N.text_encode(params["text_m"], state["text_m"], ctx,
                                    cfg, text, text_len, noise_in=True)
    logits, ts = N.text_decode_sequence(params["text_m"], ts, ctx, cfg,
                                        text, text_len, enc, mask,
                                        cross_weights_out=cross_weights_out)
    new_state = _merge(state, text_m=ts)
    if ret_enc_hid:
        return (logits, _latent(enc, cfg), text_len, mask), new_state
    return logits, new_state


def speech_ae(params, state, ctx, cfg: ModelConfig, mel, mel_len,
              ret_enc_hid=False, cross_weights_out=None):
    """unast_tpu/models/unast.py::speech_ae, the denoising speech
    autoencoder. Keeps the speech postnet's new BN state."""
    (enc, mask), ss = N.speech_encode(params["speech_m"], state["speech_m"],
                                      ctx, cfg, mel, mel_len, noise_in=True)
    (pre, post, stop, _), ss = N.speech_decode_sequence(
        params["speech_m"], ss, ctx, cfg, mel, mel_len, enc, mask,
        cross_weights_out=cross_weights_out)
    new_state = _merge(state, speech_m=ss)
    if ret_enc_hid:
        return (pre, post, stop, _latent(enc, cfg), mel_len, mask), new_state
    return (pre, post, stop), new_state


def _pseudo_encode_grad(ctx: nn.Ctx, moe_encoder: bool = True):
    """The grad mode of a cross-modal task's pseudo-pair encode: off, as
    JAX's stop_gradient over the pseudo-pair makes it, unless the ctx
    collects MoE aux losses and the encoder has MoE layers (not the
    conformer). JAX's encode appends those with their gradient (only its
    outputs are stopped), so the port keeps it then."""
    return torch.set_grad_enabled(torch.is_grad_enabled() and moe_encoder
                                  and ctx.aux_losses is not None)


def cm_text_in(params, state, ctx, cfg: ModelConfig, text, text_len,
               ret_enc_hid=False, infer_mel_len=None):
    """unast_tpu/models/unast.py::cm_text_in, back-translation with text in:
    a no-grad greedy TTS makes pseudo-speech (its BN state discarded), then
    speech encode -> text decode with gradients."""
    with _pseudo_encode_grad(ctx):
        (t_enc, t_mask), _ = N.text_encode(params["text_m"], state["text_m"],
                                           ctx, cfg, text, text_len)
    with torch.no_grad():
        (_, post_pred, _, pred_lens), _ = N.speech_infer(
            params["speech_m"], state["speech_m"], ctx, cfg, t_enc, t_mask,
            max_len=infer_mel_len)
    (s_enc, s_mask), ss = N.speech_encode(params["speech_m"],
                                          state["speech_m"], ctx, cfg,
                                          post_pred, pred_lens)
    logits, ts = N.text_decode_sequence(params["text_m"], state["text_m"],
                                        ctx, cfg, text, text_len,
                                        s_enc, s_mask)
    new_state = _merge(state, text_m=ts, speech_m=ss)
    if ret_enc_hid:
        return (logits, _latent(s_enc, cfg), pred_lens, s_mask), new_state
    return logits, new_state


def _cm_ctc_draft(params, cfg: ModelConfig, s_enc, s_mask, max_len):
    """unast_tpu/models/unast.py::_cm_ctc_draft: the hybrid CTC head's
    one-pass greedy transcript off the speech-encoder memory, with EOS
    appended as the AR decode's output carries it. Returns (ids, lens)."""
    logits = nn.linear(params["speech_m"]["ctc_head"], s_enc).float()
    ids, lens = CT.ctc_greedy_decode(logits, s_mask, max_len)
    rows = torch.arange(ids.shape[0], device=ids.device)
    at = torch.clamp(lens, max=max_len - 1)
    ids[rows, at] = torch.where(lens < max_len, EOS_IDX, ids[rows, max_len - 1])
    return ids, torch.clamp(lens + 1, max=max_len)


def cm_speech_in(params, state, ctx: nn.Ctx, cfg: ModelConfig, mel, mel_len,
                 ret_enc_hid=False, infer_text_len=None,
                 text_decode: str = "ar"):
    """unast_tpu/models/unast.py::cm_speech_in, back-translation with speech
    in: a no-grad pseudo-transcript, then text encode -> speech decode with
    gradients. text_decode 'ar': the KV-cached greedy decode; 'spec': the
    CTC-drafted speculative decode (networks.text_tr_spec_infer, with an
    eval-mode Ctx as in JAX: verifying needs a deterministic scorer),
    equal to the eval-mode greedy transcript; 'ctc': the CTC head's
    greedy output itself (_cm_ctc_draft). 'spec' and 'ctc' need
    cfg.ctc_weight > 0 and the transformer backbone (ValueError)."""
    with _pseudo_encode_grad(ctx, cfg.speech_encoder != "conformer"):
        (s_enc, s_mask), _ = N.speech_encode(params["speech_m"],
                                             state["speech_m"], ctx, cfg,
                                             mel, mel_len)
    with torch.no_grad():
        if text_decode != "ar":
            if cfg.ctc_weight <= 0 or cfg.model_type != "transformer":
                raise ValueError(
                    "cm text_decode 'spec'/'ctc' needs ctc_weight>0 and the "
                    "transformer backbone")
            cap = infer_text_len or cfg.max_text_len
            if text_decode == "ctc":
                text_pred, text_pred_len = _cm_ctc_draft(
                    params, cfg, s_enc, s_mask, cap)
            else:
                logits = nn.linear(params["speech_m"]["ctc_head"],
                                   s_enc).float()
                draft, _ = CT.ctc_greedy_decode(logits, s_mask, cap)
                text_pred, text_pred_len, _ = N.text_tr_spec_infer(
                    params["text_m"], nn.Ctx.eval(), cfg, s_enc, s_mask,
                    draft, max_len=cap)
        else:
            (text_pred, text_pred_len), _ = N.text_infer(
                params["text_m"], state["text_m"], ctx, cfg, s_enc, s_mask,
                max_len=infer_text_len)
    (t_enc, t_mask), ts = N.text_encode(params["text_m"], state["text_m"],
                                        ctx, cfg, text_pred, text_pred_len)
    (pre, post, stop, _), ss = N.speech_decode_sequence(
        params["speech_m"], state["speech_m"], ctx, cfg, mel, mel_len,
        t_enc, t_mask)
    new_state = _merge(state, text_m=ts, speech_m=ss)
    if ret_enc_hid:
        return ((pre, post, stop, _latent(t_enc, cfg), text_pred_len, t_mask),
                new_state)
    return (pre, post, stop), new_state


def tts(params, state, ctx, cfg: ModelConfig, text, text_len, mel=None,
        mel_len=None, infer=False, ret_enc_hid=False, cross_weights_out=None):
    """unast_tpu/models/unast.py::tts, text -> mel. infer=True: the greedy
    mel decode; else the teacher-forced decode of mel. `cross_weights_out`
    (a list) collects the teacher-forced decoder's cross-attention
    probabilities for the guided-attention loss. Returns ((pre, post, stop,
    stop_lens[, text latent]), new_state)."""
    (t_enc, t_mask), ts = N.text_encode(params["text_m"], state["text_m"],
                                        ctx, cfg, text, text_len)
    if infer:
        (pre, post, stop, stop_lens), ss = N.speech_infer(
            params["speech_m"], state["speech_m"], ctx, cfg, t_enc, t_mask)
    else:
        (pre, post, stop, stop_lens), ss = N.speech_decode_sequence(
            params["speech_m"], state["speech_m"], ctx, cfg, mel, mel_len,
            t_enc, t_mask, cross_weights_out=cross_weights_out)
    new_state = _merge(state, text_m=ts, speech_m=ss)
    if ret_enc_hid:
        return (pre, post, stop, stop_lens, _latent(t_enc, cfg)), new_state
    return (pre, post, stop, stop_lens), new_state


def asr(params, state, ctx, cfg: ModelConfig, text=None, text_len=None,
        mel=None, mel_len=None, infer=False, ret_enc_hid=False,
        cross_weights_out=None):
    """unast_tpu/models/unast.py::asr, mel -> text. infer=True: the greedy
    decode, (ids, stop_lens); else teacher-forced logits of text. Returns
    (out[, speech latent]), new_state."""
    (s_enc, s_mask), ss = N.speech_encode(params["speech_m"],
                                          state["speech_m"], ctx, cfg,
                                          mel, mel_len)
    if infer:
        out, ts = N.text_infer(params["text_m"], state["text_m"], ctx, cfg,
                               s_enc, s_mask)
    else:
        out, ts = N.text_decode_sequence(params["text_m"], state["text_m"],
                                         ctx, cfg, text, text_len,
                                         s_enc, s_mask,
                                         cross_weights_out=cross_weights_out)
    new_state = _merge(state, text_m=ts, speech_m=ss)
    if ret_enc_hid:
        return (out, _latent(s_enc, cfg)), new_state
    return out, new_state


# ---------------------------------------------------------------------------
# LSTM discriminator
# ---------------------------------------------------------------------------


def mlp_discriminator_init(gen: torch.Generator, enc_dim: int,
                           hidden: int = 1024):
    """unast_tpu/models/unast.py::mlp_discriminator_init: the Lample-style
    3 x hidden LeakyReLU(0.2) MLP, fc1..fc4 (torch-default Linear init)."""
    dims = [(enc_dim, hidden), (hidden, hidden), (hidden, hidden), (hidden, 1)]
    return {f"fc{i + 1}": nn.linear_init(gen, a, b, torch_default=True)
            for i, (a, b) in enumerate(dims)}


def mlp_discriminator(p, ctx: nn.Ctx, x, dropout_p=0.2, slope=0.2):
    """unast_tpu/models/unast.py::mlp_discriminator: x [..., enc_dim] ->
    logits [...]."""
    for name in ("fc1", "fc2", "fc3"):
        x = nn.dropout(ctx, torch.nn.functional.leaky_relu(
            nn.linear(p[name], x), slope), dropout_p)
    return nn.linear(p["fc4"], x).squeeze(-1)


def lstm_discriminator_init(gen: torch.Generator, d_in: int, hidden: int,
                            bidirectional: bool, num_layers: int):
    """unast_tpu/models/unast.py::lstm_discriminator_init: an RNN encoder
    over the latent sequence and a linear head on its final top-layer h."""
    return {
        "rnn": R.rnn_encoder_init(gen, d_in, hidden, num_layers, bidirectional),
        "fc2": nn.linear_init(gen, hidden, 1, torch_default=True),
    }


def lstm_discriminator(p, ctx: nn.Ctx, latents, lens, dropout_p=0.2,
                       slope=0.2):
    """unast_tpu/models/unast.py::lstm_discriminator. latents: [B, S, D]
    (zero-padded), lens: [B]. Returns [B] logits: the top layer's final h
    (reduced from both directions) -> leaky ReLU -> dropout -> fc2."""
    with record_function("unast/lstm_discriminator"):
        _, (h, _) = R.rnn_encoder(p["rnn"], ctx, latents, lens, dropout_p)
        top = torch.nn.functional.leaky_relu(h[-1], slope)
        return nn.linear(p["fc2"], nn.dropout(ctx, top, dropout_p)).squeeze(-1)


# ---------------------------------------------------------------------------
# CBHG vocoder: mel -> magnitude spectrogram
# ---------------------------------------------------------------------------


def vocoder_init(gen: torch.Generator, cfg: ModelConfig, n_fft: int = 2048):
    """unast_tpu/models/unast.py::vocoder_init -> (params, state): a 1x1 conv
    num_mels -> hidden, the CBHG at hidden width, a 1x1 conv to the
    n_fft // 2 + 1 magnitude bins."""
    pre = nn.conv1d_init(gen, cfg.num_mels, cfg.hidden, 1)
    cbhg_p, cbhg_s = M.cbhg_init(gen, cfg.hidden, projection_size=cfg.hidden)
    post = nn.conv1d_init(gen, cfg.hidden, n_fft // 2 + 1, 1)
    return {"pre": pre, "cbhg": cbhg_p, "post": post}, {"cbhg": cbhg_s}


def vocoder(p, s, ctx: nn.Ctx, mel, dtype=None):
    """unast_tpu/models/unast.py::vocoder: mel [B, T, num_mels] -> mag
    [B, T, n_fft // 2 + 1], in `dtype` if given, else mel's. Returns
    (mag, new_state)."""
    if dtype is not None:
        mel = mel.to(dtype)
    x = nn.conv1d(p["pre"], mel, padding=(0, 0))
    x, cbhg_s = M.cbhg(p["cbhg"], s["cbhg"], ctx, x)
    return nn.conv1d(p["post"], x, padding=(0, 0)), {"cbhg": cbhg_s}
