"""Model FLOPs of the benchmark's entries, from a configuration's widths
and the inputs' real lengths (two per multiply-add; matrix products and
convolutions only; attention over the (query, key) pairs the masks keep,
half a square for a causal one; a rematerialised forward is not counted).

And the H100's published peaks (NVIDIA's data sheet, SXM part, dense).
"""

PEAK_BF16 = 989e12      # FLOP/s, tensor cores, bf16
PEAK_TF32 = 495e12      # FLOP/s, tensor cores, TF32
PEAK_F32 = 67e12        # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12    # bytes/s, HBM3
VOCAB = 46


def _pairs(tq, tk, causal, full_square=False):
    if causal and not full_square:
        return tq * (tq + 1) // 2
    return tq * tk


def _enc_layer(t, d, f, full_square=False):
    return 8 * t * d * d + 4 * d * _pairs(t, t, False) + 4 * t * d * f


def _dec_layer(tq, tk, d, f, full_square=False):
    return (8 * tq * d * d + 4 * d * _pairs(tq, tq, True, full_square)
            + 4 * tq * d * d + 4 * tk * d * d + 4 * d * tq * tk
            + 4 * tq * d * f)


def sp_forward(c, t, s, full_square=False):
    """Forward FLOPs of one utterance of t text tokens and s mel frames
    through the supervised objective: TTS (text encoder, speech decoder,
    mel and stop heads, postnet) and ASR (speech encoder, text decoder,
    logits). full_square counts a causal attention over the whole square,
    as a masked plain attention computes it."""
    d, f, L = c["e_in"], c["ffn_dim"], c["num_layers"]
    m, h, sp, te = c["num_mels"], c["hidden"], c["s_pre_hid"], c["t_emb_dim"]
    text_prenet = 2 * 5 * (te * d + 2 * d * d) * t
    speech_prenet = 2 * s * (m * sp + sp * d)
    text_enc = text_prenet + L * _enc_layer(t, d, f)
    speech_dec = (speech_prenet + L * _dec_layer(s, t, d, f, full_square)
                  + 2 * s * h * (m + 1)
                  + 2 * 5 * s * (m * h + 3 * h * h + h * m))
    speech_enc = speech_prenet + L * _enc_layer(s, d, f)
    text_dec = L * _dec_layer(t, s, d, f, full_square) + 2 * t * h * VOCAB
    return text_enc + speech_dec + speech_enc + text_dec


def sp_step(c, text_lens, mel_lens):
    """Model FLOPs of one supervised step: forward and backward (three
    forwards) of every utterance of every micro-batch."""
    return 3 * sum(sp_forward(c, int(t), int(s))
                   for t, s in zip(text_lens, mel_lens))


def fastspeech_forward(c, t, frames):
    """Forward FLOPs of one utterance through the FastSpeech student: the
    text encoder over t tokens, the duration predictor, the frame decoder,
    the mel head and the postnet over the frames produced."""
    d, f, L = c["e_in"], c["ffn_dim"], c["num_layers"]
    m, h, te = c["num_mels"], c["hidden"], c["t_emb_dim"]
    enc = 2 * 5 * (te * d + 2 * d * d) * t + L * _enc_layer(t, d, f)
    dur = 2 * 2 * 3 * d * d * t + 2 * d * t
    dec = L * _enc_layer(frames, d, f)
    head = 2 * frames * d * m + 2 * 5 * frames * (m * h + 3 * h * h + h * m)
    return enc + dur + dec + head


def melgan_forward(frames, n_mels=80, base=256, rates=(5, 5, 11),
                   dilations=(1, 3, 9)):
    """Forward FLOPs of the MelGAN generator over `frames` mel frames:
    the 7-tap input conv, per stage the transposed conv (2 * rate taps
    an input sample), then per dilation a 3-tap and a 1-tap conv at the
    stage's rate, and the 7-tap output conv."""
    total = 2 * 7 * n_mels * base * frames
    c, rate = base, 1
    for r in rates:
        c_out = max(c // 2, 32)
        total += 2 * (2 * r) * c * c_out * frames * rate
        rate *= r
        total += len(dilations) * 2 * (3 + 1) * c_out * c_out * frames * rate
        c = c_out
    return total + 2 * 7 * c * frames * rate
