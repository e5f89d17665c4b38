"""The backbone networks of the port, mirroring
`unast_tpu/models/networks.py`: TextTransformer, SpeechTransformer, TextRNN
and SpeechRNN init, encode (with the denoising AE's input noise),
teacher-forced decode (`*_decode_sequence`) and greedy decode (`*_infer`:
KV-cached for the transformer; the LSTM state and the attention state
carried step to step for the RNN), plus the model_type dispatchers.

Each JAX `lax.scan` over time (the RNN decoders) is a Python loop. Each
JAX `lax.while_loop` decode is a Python loop with the same early exit:
it stops once every row's stop condition fired, which costs one host sync
per step to read the stop flags. Fixed [B, max_len(+1), ...] buffers, the
go-frame, the reduction_factor grouping and the stop bookkeeping are the
JAX package's. Under a train-mode Ctx (the cm objective's pseudo-pair
decodes) every step draws fresh dropout masks from the Ctx's one
generator, as JAX folds the step index into its key (_fold_ctx). The
conformer encoder comes with a later slice.

The RNN text decoder reads its gold inputs through the text prenet's
CAUSAL convs (once over the sequence), and its greedy decode evaluates the
same convs incrementally (modules.text_prenet_step), as JAX does. The RNN
speech decoder's prenet is one pointwise MLP, run here once over the
teacher-forced inputs ahead of the loop (JAX runs it inside its scan):
the same values in eval mode, the same distribution of dropout masks in
train mode.
"""

from typing import Optional

import torch
from torch.profiler import record_function

from .. import nn
from .config import ModelConfig, PAD_IDX, SOS_IDX, EOS_IDX
from . import modules as M
from . import rnn as R
from . import transformer as T


def check_ported(cfg: ModelConfig):
    """Raise on a configuration the port does not run yet."""
    later = {
        "speech_encoder='conformer'": cfg.speech_encoder != "transformer",
        "moe_experts > 0": cfg.moe_experts > 0,
        "pp > 1": cfg.pp > 1,
        "scan_layers": cfg.scan_layers,
        "remat": cfg.remat,
    }
    off = [name for name, on in later.items() if on]
    if off:
        raise NotImplementedError(
            f"{', '.join(off)}: not in the port yet; these come with later "
            "slices (ROADMAP.md queue 1)")


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


def text_tr_spec_infer(p, ctx, cfg: ModelConfig, memory, mem_pad_mask,
                       draft, max_len: Optional[int] = None):
    """unast_tpu/models/networks.py::text_tr_spec_infer: speculative greedy
    decoding. Each round scores candidate = accepted prefix + draft suffix
    (e.g. the CTC head's greedy output) in ONE teacher-forced parallel
    forward (text_tr_decode_sequence), accepts the longest prefix where
    the decoder's greedy choice equals the candidate plus one corrected
    token at the first mismatch, so at least one token a round. The
    output is greedy decoding under the parallel scorer; the Ctx must be
    in eval mode. draft: [B, >= max_len] ids (PAD-padded). Returns (ids
    [B, max_len] masked past stop, stop_lens [B], rounds). JAX's
    while_loop is a Python loop with one host sync a round."""
    if ctx.train:
        raise ValueError("speculative decode requires an eval-mode Ctx "
                         "(dropout would break verify determinism)")
    max_len = max_len or cfg.max_text_len
    b = memory.shape[0]
    dev = memory.device
    draft = draft[:, :max_len].long()
    if draft.shape[1] < max_len:
        draft = torch.nn.functional.pad(draft, (0, max_len - draft.shape[1]),
                                        value=PAD_IDX)
    pos = torch.arange(max_len, device=dev)
    lens_full = torch.full((b,), max_len, dtype=torch.long, device=dev)
    n = torch.zeros((b,), dtype=torch.long, device=dev)
    tokens = torch.full((b, max_len), PAD_IDX, dtype=torch.long, device=dev)
    stop_lens = torch.full((b,), max_len, dtype=torch.long, device=dev)
    rounds = 0
    while True:
        live = (stop_lens == max_len) & (n < max_len)
        if not bool(live.any()):
            break
        text_tr_spec_infer.rounds += 1
        cand = torch.where(pos[None] < n[:, None], tokens, draft)
        logits = text_tr_decode_sequence(p, ctx, cfg, cand, lens_full,
                                         memory, mem_pad_mask)
        g = torch.argmax(logits, dim=-1)
        bad = (g != cand).long()
        # longest all-ok prefix, then one corrected token at the mismatch
        n_match = (torch.cumsum(bad, dim=1) == 0).sum(dim=1)
        n_new = torch.clamp(n_match + 1, max=max_len)
        in_new = pos[None] < n_new[:, None]
        accepted = torch.where(in_new, g, PAD_IDX)
        # EOS inside the newly accepted region ends the row
        is_eos = (accepted == EOS_IDX) & in_new
        first_eos = torch.argmax(is_eos.long(), dim=1)
        stop_lens = torch.where(live & is_eos.any(dim=1), first_eos + 1,
                                stop_lens)
        tokens = torch.where(live[:, None], accepted, tokens)
        n = torch.where(live, n_new, n)
        rounds += 1
    res = tokens * M.lens_to_mask(stop_lens, max_len).to(tokens.dtype)
    return res, stop_lens, rounds


text_tr_spec_infer.rounds = 0   # verify rounds run, in all calls


def text_tr_beam_search(p, ctx, cfg: ModelConfig, memory, mem_pad_mask,
                        beam: int = 4, max_len: Optional[int] = None,
                        length_penalty: float = 0.6):
    """unast_tpu/models/networks.py::text_tr_beam_search: KV-cached beam
    search with beams on a flattened [B*K] axis (the per-step reorder is a
    gather of the self-attention caches; the cross caches are equal
    across a row's beams); finished beams are frozen (EOS again at no
    cost), and the best finished beam of each row is picked under GNMT
    length normalisation ((5 + len) / 6) ** length_penalty. Returns (ids
    [B, max_len] masked past stop, stop_lens [B])."""
    max_len = max_len or cfg.max_text_len
    b = memory.shape[0]
    dev = memory.device
    k = beam
    mem_k = torch.repeat_interleave(memory, k, dim=0)            # [B*K, Ts, D]
    pad_k = torch.repeat_interleave(mem_pad_mask, k, dim=0)
    cache = T.init_cache(p["decoder"], mem_k, max_len, cfg.nhead)
    mem_bias = T.padding_bias(pad_k)
    tokens = torch.full((b * k, max_len + 1), PAD_IDX, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = SOS_IDX
    # beam 0 starts live, the others at -1e9, so the first expansion
    # seeds distinct continuations
    scores = torch.tensor([0.0] + [-1e9] * (k - 1), device=dev).repeat(b)
    finished = torch.zeros((b * k,), dtype=torch.bool, device=dev)
    fin_lens = torch.full((b * k,), max_len, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)[:, None] * k
    for i in range(max_len):
        if bool(finished.all()):
            break
        text_tr_beam_search.steps += 1
        x = M.text_embed(p["prenet"], ctx, tokens[:, i:i + 1], cfg)
        x = M.positional_encoding(ctx, x, offset=i)
        h, cache = T.decoder_step(p["decoder"], ctx, x, i, cache, mem_bias,
                                  cfg.nhead, cfg.d_drop)
        logits = M.text_postnet(p["postnet"], ctx, h, cfg)[:, -1]
        logp = torch.log_softmax(logits.float(), dim=-1)
        # frozen beams: only the EOS continuation, no score change
        v = logp.shape[-1]
        frozen = torch.full((v,), -1e9, device=dev)
        frozen[EOS_IDX] = 0.0
        logp = torch.where(finished[:, None], frozen[None, :], logp)
        cand = (scores[:, None] + logp).reshape(b, k * v)
        top_scores, top_idx = torch.topk(cand, k, dim=-1)         # [B, K]
        flat_src = (rows + top_idx // v).reshape(-1)
        tok = (top_idx % v).reshape(-1)
        tokens = tokens[flat_src]
        cache = T.DecodeCache(cache.self_k[:, flat_src],
                              cache.self_v[:, flat_src],
                              cache.cross_k, cache.cross_v)
        finished = finished[flat_src]
        fin_lens = fin_lens[flat_src]
        scores = top_scores.reshape(-1)
        tokens[:, i + 1] = tok
        newly = (tok == EOS_IDX) & ~finished
        fin_lens = torch.where(newly, i + 1, fin_lens)
        finished = finished | (tok == EOS_IDX)
    # the best beam of each row under GNMT length normalization
    lp = ((5.0 + fin_lens.float()) / 6.0) ** length_penalty
    best = torch.argmax((scores / lp).reshape(b, k), dim=-1)
    flat_best = torch.arange(b, device=dev) * k + best
    res = tokens[flat_best][:, 1:]
    stop_lens = fin_lens[flat_best]
    return res * M.lens_to_mask(stop_lens, max_len).to(res.dtype), stop_lens


text_tr_beam_search.steps = 0   # decode steps run, in all calls


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
    if cfg.ctc_weight > 0:
        # hybrid CTC/attention (train/steps.py sp objective): per-frame
        # head over 46 symbols + 1 blank on the encoder output
        from .config import VOCAB_SIZE
        params["ctc_head"] = nn.linear_init(gen, cfg.e_in, VOCAB_SIZE + 1,
                                            torch_default=True)
    return params, {"postnet": postnet_s}


def speech_tr_encode(p, s, ctx, cfg: ModelConfig, mel, lens, noise_in=False,
                     extra_bias=None, add_pe=True):
    """unast_tpu/models/networks.py::speech_tr_encode (transformer encoder).
    mel: [B, T, num_mels]; noise_in: the denoising AE's noise on the
    frames; extra_bias: an additive attention bias for every layer
    (transformer.encoder; the CTC encoder's chunk mask and relative bias);
    add_pe=False skips the absolute sinusoid PE (the relative-position CTC
    encoder). Returns ((memory, pad_mask), state)."""
    check_ported(cfg)
    pad_mask = ~M.lens_to_mask(lens, mel.shape[1])
    x = M.noise_fn(ctx, mel, cfg.noise_mask_p) if noise_in else mel
    x = M.speech_prenet(p["prenet"], ctx, x, cfg)
    if add_pe:
        x = M.positional_encoding(ctx, x)
    memory = T.encoder(p["encoder"], ctx, x, pad_mask, cfg.nhead, cfg.e_drop,
                       impl=cfg.attn_impl, extra_bias=extra_bias)
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
# TextRNN
# ===========================================================================


def text_rnn_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::text_rnn_init -> (params, state)."""
    check_ported(cfg)
    prenet_p, prenet_s = M.text_prenet_init(gen, cfg)
    params = {
        "prenet": prenet_p,
        "encoder": R.rnn_encoder_init(gen, cfg.e_in, cfg.hidden,
                                      cfg.num_layers, cfg.e_bi),
        "decoder": R.rnn_decoder_init(gen, cfg.e_in, cfg.enc_out_dim,
                                      cfg.hidden, cfg.num_layers,
                                      cfg.d_attn, cfg.attn_dim),
        "postnet": M.text_postnet_init(gen, cfg),
    }
    return params, {"prenet": prenet_s}


def text_rnn_encode(p, s, ctx, cfg: ModelConfig, ids, lens, noise_in=False):
    """unast_tpu/models/networks.py::text_rnn_encode. Returns ((((h, c),
    enc_out [B, T, enc_out_dim]), pad_mask), new_state)."""
    pad_mask = ~M.lens_to_mask(lens, ids.shape[1])
    x = M.text_embed(p["prenet"], ctx, ids, cfg)
    if noise_in:
        x = M.noise_fn(ctx, x, cfg.noise_mask_p)
    x, prenet_s = M.text_prenet_convs(p["prenet"], s["prenet"], ctx, x, cfg)
    enc_out, hc = R.rnn_encoder(p["encoder"], ctx, x, lens, cfg.e_drop)
    return ((hc, enc_out), pad_mask), {"prenet": prenet_s}


def _init_attn_state(p, cfg: ModelConfig, enc_out):
    """unast_tpu/models/networks.py::_init_attn_state: the LSAState for
    'lsa'. JAX carries a dummy state for the other mechanisms to keep its
    scan carry uniform; here they carry None."""
    if cfg.d_attn == "lsa":
        return R.lsa_init_state(p["decoder"]["attn"], enc_out)
    return None


def _rnn_decode_loop(p, ctx, cfg: ModelConfig, x, hc, enc_out, enc_pad_mask):
    """The teacher-forced decoder over inputs x [B, T, D]: -> [B, T, H]."""
    attn = _init_attn_state(p, cfg, enc_out)
    outs = []
    for i in range(x.shape[1]):
        out, hc, attn = R.rnn_decoder_step(
            p["decoder"], ctx, x[:, i], hc, enc_out, enc_pad_mask, attn,
            cfg.d_drop, cfg.d_attn)
        outs.append(out)
    return torch.stack(outs, dim=1)


def text_rnn_decode_sequence(p, s, ctx, cfg: ModelConfig, tgt, tgt_lens,
                             enc_outputs, enc_pad_mask):
    """unast_tpu/models/networks.py::text_rnn_decode_sequence:
    teacher-forced decode of tgt [B, T] (shifted right behind SOS) through
    the CAUSAL prenet convs -> (logits [B, T, V], new_state)."""
    hc, enc_out = enc_outputs
    sos = torch.full((tgt.shape[0], 1), SOS_IDX, dtype=tgt.dtype,
                     device=tgt.device)
    tgt_in = torch.cat([sos, tgt[:, :-1]], dim=1)
    x = M.text_embed(p["prenet"], ctx, tgt_in, cfg)
    x, prenet_s = M.text_prenet_convs(p["prenet"], s["prenet"], ctx, x, cfg,
                                      causal=True)
    h_seq = _rnn_decode_loop(p, ctx, cfg, x, hc, enc_out, enc_pad_mask)
    return M.text_postnet(p["postnet"], ctx, h_seq, cfg), {"prenet": prenet_s}


def text_rnn_infer(p, s, ctx, cfg: ModelConfig, enc_outputs, enc_pad_mask,
                   max_len: Optional[int] = None):
    """unast_tpu/models/networks.py::text_rnn_infer: greedy decode, the
    causal prenet evaluated incrementally (BN on running statistics).
    Returns (ids [B, max_len] masked past stop, stop_lens [B])."""
    max_len = max_len or cfg.max_text_len
    hc, enc_out = enc_outputs
    b = enc_out.shape[0]
    dev = enc_out.device
    tokens = torch.full((b, max_len), PAD_IDX, dtype=torch.long, device=dev)
    stop_lens = torch.full((b,), max_len, dtype=torch.long, device=dev)
    bufs = M.text_prenet_step_init(p["prenet"], b, cfg, enc_out.dtype, dev)
    cur_emb = M.text_embed(p["prenet"], ctx, torch.full(
        (b,), SOS_IDX, dtype=torch.long, device=dev), cfg)
    attn = _init_attn_state(p, cfg, enc_out)
    for i in range(max_len):
        if not bool((stop_lens == max_len).any()):
            break
        text_rnn_infer.steps += 1
        x_t, bufs = M.text_prenet_step(p["prenet"], s["prenet"], ctx, cur_emb,
                                       bufs, cfg)
        out, hc, attn = R.rnn_decoder_step(
            p["decoder"], ctx, x_t, hc, enc_out, enc_pad_mask, attn,
            cfg.d_drop, cfg.d_attn)
        choice = torch.argmax(M.text_postnet(p["postnet"], ctx, out, cfg), dim=-1)
        tokens[:, i] = choice
        newly = (choice == EOS_IDX) & (stop_lens == max_len)
        stop_lens = torch.where(newly, i + 1, stop_lens)
        cur_emb = M.text_embed(p["prenet"], ctx, choice, cfg)
    return tokens * M.lens_to_mask(stop_lens, max_len).to(tokens.dtype), stop_lens


text_rnn_infer.steps = 0   # decode steps run, in all calls


# ===========================================================================
# SpeechRNN
# ===========================================================================


def speech_rnn_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::speech_rnn_init -> (params, state). The
    RNN decoder takes one frame a step: reduction_factor must be 1."""
    assert cfg.reduction_factor == 1, (
        "reduction_factor > 1 is implemented for the transformer speech "
        "decoder only (the RNN decoder consumes one frame per step)")
    check_ported(cfg)
    params = {
        "prenet": M.speech_prenet_init(gen, cfg),
        "encoder": R.rnn_encoder_init(gen, cfg.e_in, cfg.hidden,
                                      cfg.num_layers, cfg.e_bi),
        "decoder": R.rnn_decoder_init(gen, cfg.e_in, cfg.enc_out_dim,
                                      cfg.hidden, cfg.num_layers,
                                      cfg.d_attn, cfg.attn_dim),
    }
    params["postnet"], postnet_s = M.speech_postnet_init(gen, cfg)
    return params, {"postnet": postnet_s}


def speech_rnn_encode(p, s, ctx, cfg: ModelConfig, mel, lens, noise_in=False):
    """unast_tpu/models/networks.py::speech_rnn_encode. Returns ((((h, c),
    enc_out), pad_mask), state)."""
    pad_mask = ~M.lens_to_mask(lens, mel.shape[1])
    x = M.noise_fn(ctx, mel, cfg.noise_mask_p) if noise_in else mel
    x = M.speech_prenet(p["prenet"], ctx, x, cfg)
    enc_out, hc = R.rnn_encoder(p["encoder"], ctx, x, lens, cfg.e_drop)
    return ((hc, enc_out), pad_mask), s


def speech_rnn_decode_sequence(p, s, ctx, cfg: ModelConfig, tgt, tgt_lens,
                               enc_outputs, enc_pad_mask):
    """unast_tpu/models/networks.py::speech_rnn_decode_sequence:
    teacher-forced decode of tgt [B, T, num_mels] behind a zero go-frame.
    The postnet runs over the buffer WITH the leading zero frame, which is
    then shifted off. Returns ((pre, post, stop [B, T], tgt_lens),
    new_state)."""
    hc, enc_out = enc_outputs
    go = torch.zeros((tgt.shape[0], 1, cfg.num_mels), dtype=tgt.dtype,
                     device=tgt.device)
    x = M.speech_prenet(p["prenet"], ctx, torch.cat([go, tgt[:, :-1]], dim=1),
                        cfg)
    h_seq = _rnn_decode_loop(p, ctx, cfg, x, hc, enc_out, enc_pad_mask)
    pre, stop = M.speech_mel_and_stop(p["postnet"], h_seq)
    buf = torch.cat([torch.zeros_like(pre[:, :1]), pre], dim=1)
    resid, postnet_s = M.speech_postnet(p["postnet"], s["postnet"], ctx, buf, cfg)
    return ((pre, (buf + resid)[:, 1:], stop.squeeze(-1), tgt_lens),
            dict(s, postnet=postnet_s))


def speech_rnn_infer(p, s, ctx, cfg: ModelConfig, enc_outputs, enc_pad_mask,
                     max_len: Optional[int] = None):
    """unast_tpu/models/networks.py::speech_rnn_infer: greedy decode, a row
    stops the first step sigmoid(stop) >= cfg.stop_threshold; the postnet
    runs once over the buffer with its leading zero go-frame. pre, post
    and stops are masked past each row's stop_len. Returns ((pre, post,
    stops, stop_lens), new_state)."""
    max_len = max_len or cfg.max_mel_len
    hc, enc_out = enc_outputs
    b = enc_out.shape[0]
    dev = enc_out.device
    frames = torch.zeros((b, max_len + 1, cfg.num_mels), dtype=enc_out.dtype,
                         device=dev)
    stops = torch.zeros((b, max_len), dtype=enc_out.dtype, device=dev)
    stop_lens = torch.full((b,), max_len, dtype=torch.long, device=dev)
    attn = _init_attn_state(p, cfg, enc_out)
    for i in range(max_len):
        if not bool((stop_lens == max_len).any()):
            break
        speech_rnn_infer.steps += 1
        x = M.speech_prenet(p["prenet"], ctx, frames[:, i], cfg)
        out, hc, attn = R.rnn_decoder_step(
            p["decoder"], ctx, x, hc, enc_out, enc_pad_mask, attn,
            cfg.d_drop, cfg.d_attn)
        mel_t, stop_t = M.speech_mel_and_stop(p["postnet"], out)
        frames[:, i + 1] = mel_t
        stops[:, i] = stop_t[:, 0]
        newly = ((torch.sigmoid(stop_t[:, 0]) >= cfg.stop_threshold)
                 & (stop_lens == max_len))
        stop_lens = torch.where(newly, i + 1, stop_lens)
    mask = M.lens_to_mask(stop_lens, max_len).to(frames.dtype)
    resid, postnet_s = M.speech_postnet(p["postnet"], s["postnet"], ctx,
                                        frames, cfg)
    pre = frames[:, 1:] * mask[..., None]
    post = (frames + resid)[:, 1:] * mask[..., None]
    return (pre, post, stops * mask, stop_lens), dict(s, postnet=postnet_s)


speech_rnn_infer.steps = 0   # decode steps run, in all calls


# ===========================================================================
# Dispatch helpers (unast_tpu/models/networks.py:705-754)
# ===========================================================================


def _is_tr(cfg: ModelConfig) -> bool:
    check_ported(cfg)
    return cfg.model_type == "transformer"


def text_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::text_init."""
    return (text_transformer_init if _is_tr(cfg) else text_rnn_init)(gen, cfg)


def speech_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/networks.py::speech_init."""
    return (speech_transformer_init if _is_tr(cfg) else speech_rnn_init)(gen, cfg)


def text_encode(p, s, ctx, cfg, ids, lens, noise_in=False):
    """unast_tpu/models/networks.py::text_encode."""
    fn = text_tr_encode if _is_tr(cfg) else text_rnn_encode
    return fn(p, s, ctx, cfg, ids, lens, noise_in)


def speech_encode(p, s, ctx, cfg, mel, lens, noise_in=False):
    """unast_tpu/models/networks.py::speech_encode."""
    fn = speech_tr_encode if _is_tr(cfg) else speech_rnn_encode
    return fn(p, s, ctx, cfg, mel, lens, noise_in)


def text_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory, mem_mask,
                         cross_weights_out=None):
    """unast_tpu/models/networks.py::text_decode_sequence: (logits, state).
    cross_weights_out collects the transformer decoder's cross-attention
    weights; the RNN decoder leaves it as it is."""
    if _is_tr(cfg):
        return text_tr_decode_sequence(p, ctx, cfg, tgt, tgt_lens, memory,
                                       mem_mask, cross_weights_out), s
    return text_rnn_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory,
                                    mem_mask)


def speech_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory, mem_mask,
                           cross_weights_out=None):
    """unast_tpu/models/networks.py::speech_decode_sequence."""
    if _is_tr(cfg):
        return speech_tr_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory,
                                         mem_mask, cross_weights_out)
    return speech_rnn_decode_sequence(p, s, ctx, cfg, tgt, tgt_lens, memory,
                                      mem_mask)


def text_infer(p, s, ctx, cfg, memory, mem_mask, max_len=None):
    """unast_tpu/models/networks.py::text_infer: ((ids, stop_lens), s)."""
    with record_function("unast/text_infer"):
        if _is_tr(cfg):
            return text_tr_infer(p, ctx, cfg, memory, mem_mask, max_len), s
        return text_rnn_infer(p, s, ctx, cfg, memory, mem_mask, max_len), s


def speech_infer(p, s, ctx, cfg, memory, mem_mask, max_len=None):
    """unast_tpu/models/networks.py::speech_infer."""
    fn = speech_tr_infer if _is_tr(cfg) else speech_rnn_infer
    with record_function("unast/speech_infer"):
        return fn(p, s, ctx, cfg, memory, mem_mask, max_len)
