"""The transformer backbone networks of the port, mirroring
`unast_tpu/models/networks.py`: TextTransformer and SpeechTransformer init,
encode (with the denoising AE's input noise), teacher-forced decode
(`*_decode_sequence`) and KV-cached greedy decode (`*_infer`), plus the
model_type dispatchers.

Each JAX `lax.while_loop` decode is a Python loop with the same early exit:
it stops once every row's stop condition fired, which costs one host sync
per step to read the stop flags. Fixed [B, max_len(+1), ...] buffers, the
go-frame, the reduction_factor grouping and the stop bookkeeping are the
JAX package's. Under a train-mode Ctx (the cm objective's pseudo-pair
decodes) every step draws fresh dropout masks from the Ctx's one
generator, as JAX folds the step index into its key (_fold_ctx). The RNN
backbone and the conformer encoder come with later slices.
"""

from typing import Optional

import torch
from torch.profiler import record_function

from .. import nn
from .config import ModelConfig, PAD_IDX, SOS_IDX, EOS_IDX
from . import modules as M
from . import transformer as T


def check_ported(cfg: ModelConfig):
    """Raise on a configuration this slice of the port does not run."""
    later = {
        "model_type='rnn'": cfg.model_type != "transformer",
        "speech_encoder='conformer'": cfg.speech_encoder != "transformer",
        "moe_experts > 0": cfg.moe_experts > 0,
        "pp > 1": cfg.pp > 1,
        "scan_layers": cfg.scan_layers,
        "remat": cfg.remat,
    }
    off = [name for name, on in later.items() if on]
    if off:
        raise NotImplementedError(
            f"{', '.join(off)}: not in the serving and training slices of "
            "the port; these come with later slices (ROADMAP.md queue 1)")


# ===========================================================================
# TextTransformer
# ===========================================================================


def text_transformer_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::text_transformer_init -> (params, state)."""
    check_ported(cfg)
    prenet_p, prenet_s = M.text_prenet_init(gen, cfg)
    params = {
        "prenet": prenet_p,
        "encoder": T.encoder_init(gen, cfg.e_in, cfg.nhead, cfg.ffn_dim,
                                  cfg.num_layers),
        "decoder": T.decoder_init(gen, cfg.e_in, cfg.nhead, cfg.ffn_dim,
                                  cfg.num_layers),
        "postnet": M.text_postnet_init(gen, cfg),
    }
    return params, {"prenet": prenet_s}


def text_tr_encode(p, s, ctx, cfg: ModelConfig, ids, lens, noise_in=False):
    """unast_tpu/models/networks.py::text_tr_encode. ids: [B, T] int;
    noise_in: the denoising AE's noise on the embeddings. Returns
    ((memory [B, T, D], pad_mask), new_state)."""
    check_ported(cfg)
    pad_mask = ~M.lens_to_mask(lens, ids.shape[1])
    x = M.text_embed(p["prenet"], ctx, ids, cfg)
    if noise_in:
        x = M.noise_fn(ctx, x, cfg.noise_mask_p)
    x, prenet_s = M.text_prenet_convs(p["prenet"], s["prenet"], ctx, x, cfg)
    x = M.positional_encoding(ctx, x)
    memory = T.encoder(p["encoder"], ctx, x, pad_mask, cfg.nhead, cfg.e_drop,
                       impl=cfg.attn_impl)
    return (memory, pad_mask), {"prenet": prenet_s}


def text_tr_decode_sequence(p, ctx, cfg: ModelConfig, tgt, tgt_lens,
                            memory, mem_pad_mask, cross_weights_out=None):
    """unast_tpu/models/networks.py::text_tr_decode_sequence: teacher-forced
    parallel decode of tgt [B, T] (shifted right behind SOS) -> logits
    [B, T, V]. The decoder input embeds without the conv stack, so no BN
    state is touched."""
    sos = torch.full((tgt.shape[0], 1), SOS_IDX, dtype=tgt.dtype,
                     device=tgt.device)
    tgt_in = torch.cat([sos, tgt[:, :-1]], dim=1)
    tgt_pad_mask = ~M.lens_to_mask(tgt_lens, tgt.shape[1])
    x = M.text_embed(p["prenet"], ctx, tgt_in, cfg)
    x = M.positional_encoding(ctx, x)
    h = T.decoder(p["decoder"], ctx, x, memory, tgt_pad_mask, mem_pad_mask,
                  cfg.nhead, cfg.d_drop, impl=cfg.attn_impl,
                  cross_weights_out=cross_weights_out)
    return M.text_postnet(p["postnet"], ctx, h, cfg)


def text_tr_infer(p, ctx, cfg: ModelConfig, memory, mem_pad_mask,
                  max_len: Optional[int] = None):
    """unast_tpu/models/networks.py::text_tr_infer, greedy (temperature 0).
    Returns (ids [B, max_len] masked past stop, stop_lens [B])."""
    max_len = max_len or cfg.max_text_len
    b = memory.shape[0]
    dev = memory.device
    cache = T.init_cache(p["decoder"], memory, max_len, cfg.nhead)
    mem_bias = T.padding_bias(mem_pad_mask)
    tokens = torch.full((b, max_len + 1), PAD_IDX, dtype=torch.long, device=dev)
    tokens[:, 0] = SOS_IDX
    stop_lens = torch.full((b,), max_len, dtype=torch.long, device=dev)
    for i in range(max_len):
        if not bool((stop_lens == max_len).any()):
            break
        text_tr_infer.steps += 1
        x = M.text_embed(p["prenet"], ctx, tokens[:, i:i + 1], cfg)
        x = M.positional_encoding(ctx, x, offset=i)
        h, cache = T.decoder_step(p["decoder"], ctx, x, i, cache, mem_bias,
                                  cfg.nhead, cfg.d_drop)
        logits = M.text_postnet(p["postnet"], ctx, h, cfg)
        choice = torch.argmax(logits[:, -1], dim=-1)
        tokens[:, i + 1] = choice
        newly = (choice == EOS_IDX) & (stop_lens == max_len)
        stop_lens = torch.where(newly, i + 1, stop_lens)
    res = tokens[:, 1:] * M.lens_to_mask(stop_lens, max_len).to(tokens.dtype)
    return res, stop_lens


text_tr_infer.steps = 0   # decode steps run, in all calls


# ===========================================================================
# SpeechTransformer
# ===========================================================================


def speech_transformer_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::speech_transformer_init (transformer
    speech encoder) -> (params, state)."""
    check_ported(cfg)
    prenet = M.speech_prenet_init(gen, cfg)
    enc = T.encoder_init(gen, cfg.e_in, cfg.nhead, cfg.ffn_dim, cfg.num_layers)
    dec = T.decoder_init(gen, cfg.e_in, cfg.nhead, cfg.ffn_dim, cfg.num_layers)
    postnet_p, postnet_s = M.speech_postnet_init(gen, cfg)
    params = {"prenet": prenet, "encoder": enc, "decoder": dec,
              "postnet": postnet_p}
    return params, {"postnet": postnet_s}


def speech_tr_encode(p, s, ctx, cfg: ModelConfig, mel, lens, noise_in=False):
    """unast_tpu/models/networks.py::speech_tr_encode (absolute PE,
    transformer encoder). mel: [B, T, num_mels]; noise_in: the denoising
    AE's noise on the frames. Returns ((memory, pad_mask), state)."""
    check_ported(cfg)
    pad_mask = ~M.lens_to_mask(lens, mel.shape[1])
    x = M.noise_fn(ctx, mel, cfg.noise_mask_p) if noise_in else mel
    x = M.speech_prenet(p["prenet"], ctx, x, cfg)
    x = M.positional_encoding(ctx, x)
    memory = T.encoder(p["encoder"], ctx, x, pad_mask, cfg.nhead, cfg.e_drop,
                       impl=cfg.attn_impl)
    return (memory, pad_mask), s


def speech_tr_decode_sequence(p, s, ctx, cfg: ModelConfig, tgt, tgt_lens,
                              memory, mem_pad_mask, cross_weights_out=None):
    """unast_tpu/models/networks.py::speech_tr_decode_sequence:
    teacher-forced decode of tgt [B, T, num_mels] behind a zero go-frame.
    With reduction_factor r the decoder runs over T/r frame groups, step
    g reading the last frame of group g-1, and the heads' r frames and r
    stop logits a group are ungrouped to per-frame shapes. Returns ((pre,
    post [B, T, num_mels], stop [B, T], tgt_lens), new_state)."""
    b, t = tgt.shape[:2]
    r = cfg.reduction_factor
    if t % r:
        raise ValueError(f"mel length {t} not divisible by reduction {r}")
    go = torch.zeros((b, 1, cfg.num_mels), dtype=tgt.dtype, device=tgt.device)
    tgt_in = torch.cat([go, tgt[:, r - 1:t - 1:r]], dim=1)
    group_lens = -(-tgt_lens // r) if r > 1 else tgt_lens
    tgt_pad_mask = ~M.lens_to_mask(group_lens, t // r)
    x = M.speech_prenet(p["prenet"], ctx, tgt_in, cfg)
    x = M.positional_encoding(ctx, x)
    h = T.decoder(p["decoder"], ctx, x, memory, tgt_pad_mask, mem_pad_mask,
                  cfg.nhead, cfg.d_drop, impl=cfg.attn_impl,
                  cross_weights_out=cross_weights_out)
    pre, stop = M.speech_mel_and_stop(p["postnet"], h)
    pre = pre.reshape(b, t, cfg.num_mels)
    resid, postnet_s = M.speech_postnet(p["postnet"], s["postnet"], ctx, pre, cfg)
    return ((pre, pre + resid, stop.reshape(b, t), tgt_lens),
            dict(s, postnet=postnet_s))


def speech_tr_infer(p, s, ctx, cfg: ModelConfig, memory, mem_pad_mask,
                    max_len: Optional[int] = None):
    """unast_tpu/models/networks.py::speech_tr_infer: KV-cached greedy decode,
    a row stops the first step sigmoid(stop) >= cfg.stop_threshold. The
    postnet runs once over the whole buffer INCLUDING the leading zero
    go-frame, which is then dropped. Returns ((pre, post, stops,
    stop_lens), new_state)."""
    max_len = max_len or cfg.max_mel_len
    b = memory.shape[0]
    dev = memory.device
    r = cfg.reduction_factor
    n_groups = -(-max_len // r)           # decode runs ceil(max_len/r) steps
    cap = n_groups * r                    # frame capacity (>= max_len)
    cache = T.init_cache(p["decoder"], memory, n_groups, cfg.nhead)
    mem_bias = T.padding_bias(mem_pad_mask)
    frames = torch.zeros((b, cap + 1, cfg.num_mels), dtype=memory.dtype,
                         device=dev)
    stops = torch.zeros((b, cap), dtype=memory.dtype, device=dev)
    stop_lens = torch.full((b,), cap, dtype=torch.long, device=dev)
    for g in range(n_groups):
        if not bool((stop_lens == cap).any()):
            break
        speech_tr_infer.steps += 1
        # input: last frame of the previous group (go-frame for g=0)
        cur = frames[:, g * r:g * r + 1]
        x = M.speech_prenet(p["prenet"], ctx, cur, cfg)
        x = M.positional_encoding(ctx, x, offset=g)
        h, cache = T.decoder_step(p["decoder"], ctx, x, g, cache, mem_bias,
                                  cfg.nhead, cfg.d_drop)
        mel_t, stop_t = M.speech_mel_and_stop(p["postnet"], h)
        frames[:, g * r + 1:g * r + 1 + r] = mel_t.reshape(b, r, cfg.num_mels)
        stops[:, g * r:g * r + r] = stop_t.reshape(b, r)
        fired = torch.sigmoid(stop_t[:, 0]) >= cfg.stop_threshold   # [B, r]
        first = torch.argmax(fired.to(torch.int32), dim=-1)   # first stop
        newly = fired.any(dim=-1) & (stop_lens == cap)
        stop_lens = torch.where(newly, g * r + first + 1, stop_lens)

    stop_lens = torch.clamp(stop_lens, max=max_len)
    mask = M.lens_to_mask(stop_lens, max_len).to(frames.dtype)
    resid, postnet_s = M.speech_postnet(p["postnet"], s["postnet"], ctx,
                                        frames, cfg)
    pre = frames[:, 1:max_len + 1] * mask[..., None]
    post = (frames + resid)[:, 1:max_len + 1] * mask[..., None]
    stops = stops[:, :max_len] * mask
    return (pre, post, stops, stop_lens), dict(s, postnet=postnet_s)


speech_tr_infer.steps = 0   # decode steps (frame groups) run, in all calls


# ===========================================================================
# Dispatch helpers (unast_tpu/models/networks.py:705-754)
# ===========================================================================


def text_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::text_init (transformer only)."""
    return text_transformer_init(gen, cfg)


def speech_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::speech_init (transformer only)."""
    return speech_transformer_init(gen, cfg)


def text_encode(p, s, ctx, cfg, ids, lens, noise_in=False):
    """unast_tpu/models/networks.py::text_encode (transformer only)."""
    return text_tr_encode(p, s, ctx, cfg, ids, lens, noise_in)


def speech_encode(p, s, ctx, cfg, mel, lens, noise_in=False):
    """unast_tpu/models/networks.py::speech_encode (transformer only)."""
    return speech_tr_encode(p, s, ctx, cfg, mel, lens, noise_in)


def text_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory, mem_mask,
                         cross_weights_out=None):
    """unast_tpu/models/networks.py::text_decode_sequence (transformer
    only): (logits, state), the state untouched."""
    check_ported(cfg)
    return text_tr_decode_sequence(p, ctx, cfg, tgt, tgt_lens, memory,
                                   mem_mask, cross_weights_out), s


def speech_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory, mem_mask,
                           cross_weights_out=None):
    """unast_tpu/models/networks.py::speech_decode_sequence (transformer
    only)."""
    check_ported(cfg)
    return speech_tr_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory,
                                     mem_mask, cross_weights_out)


def text_infer(p, s, ctx, cfg, memory, mem_mask, max_len=None):
    """unast_tpu/models/networks.py::text_infer (transformer only)."""
    check_ported(cfg)
    with record_function("unast/text_infer"):
        return text_tr_infer(p, ctx, cfg, memory, mem_mask, max_len), s


def speech_infer(p, s, ctx, cfg, memory, mem_mask, max_len=None):
    """unast_tpu/models/networks.py::speech_infer (transformer only)."""
    check_ported(cfg)
    with record_function("unast/speech_infer"):
        return speech_tr_infer(p, s, ctx, cfg, memory, mem_mask, max_len)
