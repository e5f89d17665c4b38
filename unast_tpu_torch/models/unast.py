"""UNAST facade of the port: init, the six task methods and the LSTM
discriminator, mirroring `unast_tpu/models/unast.py`. The CBHG vocoder and
the MLP discriminator come with a later slice.

All tasks are functions (params, state, ctx, cfg, batch) -> (outputs,
new_state). The cross-modal tasks make their greedy pseudo-pairs under
torch.no_grad(), the counterpart of JAX's stop_gradient over them, so those
encodes and decodes keep no graph and take no part in the backward.
"""

import torch
from torch.profiler import record_function

from .. import nn
from .config import ModelConfig
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


def _merge(state, **updates):
    out = dict(state)
    out.update(updates)
    return out


def _latent(enc_outputs, cfg: ModelConfig):
    """unast_tpu/models/unast.py::_latent: the per-position latent the
    discriminator sees, the transformer memory (the RNN backbone's output
    sequence in JAX; that backbone comes with a later slice)."""
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


def cm_text_in(params, state, ctx, cfg: ModelConfig, text, text_len,
               ret_enc_hid=False, infer_mel_len=None):
    """unast_tpu/models/unast.py::cm_text_in, back-translation with text in:
    a no-grad greedy TTS makes pseudo-speech (its BN state discarded), then
    speech encode -> text decode with gradients."""
    with torch.no_grad():
        (t_enc, t_mask), _ = N.text_encode(params["text_m"], state["text_m"],
                                           ctx, cfg, text, text_len)
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


def cm_speech_in(params, state, ctx, cfg: ModelConfig, mel, mel_len,
                 ret_enc_hid=False, infer_text_len=None,
                 text_decode: str = "ar"):
    """unast_tpu/models/unast.py::cm_speech_in, back-translation with speech
    in: a no-grad greedy ASR makes a pseudo-transcript, then text encode ->
    speech decode with gradients. Only text_decode='ar' (the KV-cached
    greedy decode) is ported; 'spec' and 'ctc' need the CTC head of a
    later slice."""
    if text_decode != "ar":
        raise NotImplementedError(
            f"cm text_decode={text_decode!r} needs the CTC head (models/ctc.py), "
            "which comes with a later slice of the port")
    with torch.no_grad():
        (s_enc, s_mask), _ = N.speech_encode(params["speech_m"],
                                             state["speech_m"], ctx, cfg,
                                             mel, mel_len)
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
