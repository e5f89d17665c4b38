"""CTC non-autoregressive ASR of the port, mirroring
`unast_tpu/models/ctc.py`: mel -> token posteriors in ONE forward pass
(Graves et al. 2006). The speech encoder (prenet + transformer stack, the
AR model's) feeds a per-frame linear head over the 46 symbols + 1 blank;
greedy decode is argmax -> collapse repeats -> drop blanks.

The encoder runs the flash-attention kernel with attn_impl='flash' when
no extra bias is set (ctc_chunk 0, ctc_pos 'abs'); the chunk mask and the
relative-position bias ride the additive bias of the plain route, as in
JAX. The streaming step keeps per-layer K/V caches of the last ctc_left
chunks. Prefix beam search is host numpy, copied. Forced alignment's two
lax.scan passes are Python loops over the frames. The loss is optax's
ctc_loss with its log_epsilon floor: torch's ctc_loss for the rows that
some alignment fits, and optax's log-space recursion, ported, for the
rows no alignment fits (where torch's is infinite and optax's large and
finite).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..parallel import collectives as C
from . import modules as M
from . import networks as N
from . import transformer as T
from .config import VOCAB_SIZE, ModelConfig

BLANK_ID = VOCAB_SIZE  # 46 — one past the symbol table
LOG_EPSILON = -1e5     # optax.ctc_loss's stand-in for log(0)


def ctc_asr_init(gen: torch.Generator, cfg: ModelConfig):
    """unast_tpu/models/ctc.py::ctc_asr_init -> (params, state): the
    speech transformer's prenet and encoder plus the CTC head, and with
    cfg.ctc_pos='rel' a per-head relative position table `rel_pos`
    [nhead, rel_table_size(cfg)] (0.02 * normal) in place of the
    absolute PE."""
    enc_p, enc_s = N.speech_transformer_init(gen, cfg)
    del enc_p["decoder"], enc_p["postnet"]
    state = {k: v for k, v in enc_s.items() if k != "postnet"}
    enc_p["ctc_head"] = nn.linear_init(gen, cfg.e_in, VOCAB_SIZE + 1,
                                       torch_default=True)
    if cfg.ctc_pos == "rel":
        if not (cfg.ctc_chunk > 0 and cfg.ctc_left >= 0):
            raise ValueError(
                "ctc_pos='rel' needs a bounded chunk attention field "
                "(ctc_chunk > 0, ctc_left >= 0)")
        enc_p["rel_pos"] = 0.02 * torch.randn(
            (cfg.nhead, rel_table_size(cfg)), generator=gen)
    return enc_p, state


def rel_table_size(cfg: ModelConfig) -> int:
    """unast_tpu/models/ctc.py::rel_table_size: the distances of the chunk
    field, -(chunk-1) .. (left+1)*chunk-1."""
    return (cfg.ctc_left + 2) * cfg.ctc_chunk - 1


def rel_bias(table, q_pos, k_pos, cfg: ModelConfig) -> torch.Tensor:
    """unast_tpu/models/ctc.py::rel_bias: table [H, S] -> additive float32
    [1, H, Tq, Tk], bias[0, h, i, j] = table[h, q_pos[i] - k_pos[j] +
    chunk - 1], distances clamped to the table (those pairs are masked)."""
    d = q_pos[:, None] - k_pos[None, :] + (cfg.ctc_chunk - 1)
    d = torch.clamp(d, 0, table.shape[1] - 1)
    return table[:, d][None].float()


def ctc_logits(p, s, ctx: nn.Ctx, cfg: ModelConfig, mel, mel_len):
    """unast_tpu/models/ctc.py::ctc_logits: mel [B, T, n_mels] -> (logits
    float32 [B, T, V+1], frame pad mask [B, T] True = PAD, new state).
    cfg.ctc_chunk > 0 applies the chunk mask (transformer.chunk_bias), so
    these weights serve ctc_stream_step exactly; cfg.ctc_pos='rel' adds
    rel_bias to it and skips the absolute PE."""
    extra = None
    t = mel.shape[1]
    if cfg.ctc_chunk > 0:
        extra = T.chunk_bias(t, cfg.ctc_chunk, cfg.ctc_left, mel.device)
    if cfg.ctc_pos == "rel":
        pos = torch.arange(t, device=mel.device)
        extra = extra + rel_bias(p["rel_pos"], pos, pos, cfg)
    (memory, pad_mask), new_s = N.speech_tr_encode(
        p, s, ctx, cfg, mel, mel_len, extra_bias=extra,
        add_pe=cfg.ctc_pos != "rel")
    logits = nn.linear(p["ctc_head"], memory).float()
    return logits, pad_mask, new_s


def ctc_greedy_decode(logits, pad_mask, max_text_len: int):
    """unast_tpu/models/ctc.py::ctc_greedy_decode: per-frame argmax ->
    collapse repeats -> drop blanks, compacted to the left. Returns (ids
    [B, max_text_len] long, lens [B]); tokens past max_text_len drop."""
    b = logits.shape[0]
    tok = torch.argmax(logits, dim=-1)                            # [B, T]
    prev = torch.cat([torch.full_like(tok[:, :1], -1), tok[:, :-1]], dim=1)
    keep = (tok != BLANK_ID) & (tok != prev) & ~pad_mask
    pos = torch.cumsum(keep.long(), dim=1) - 1
    dst = torch.where(keep & (pos < max_text_len), pos,
                      torch.full_like(pos, max_text_len))
    out = torch.zeros((b, max_text_len + 1), dtype=tok.dtype, device=tok.device)
    # every dropped token lands in the dump slot max_text_len, cut below
    out.scatter_(1, dst, tok)
    lens = torch.clamp(keep.sum(dim=1), max=max_text_len)
    return out[:, :max_text_len], lens


def ctc_asr_infer(p, s, ctx: nn.Ctx, cfg: ModelConfig, mel, mel_len):
    """unast_tpu/models/ctc.py::ctc_asr_infer: one-pass greedy ASR.
    Returns ((ids, lens), new state)."""
    logits, pad_mask, new_s = ctc_logits(p, s, ctx, cfg, mel, mel_len)
    return ctc_greedy_decode(logits, pad_mask, cfg.max_text_len), new_s


# ---------------------------------------------------------------------------
# Streaming (online) inference over a chunk-masked model
# ---------------------------------------------------------------------------


def ctc_stream_init(p, cfg: ModelConfig, batch_size: int, device=None):
    """unast_tpu/models/ctc.py::ctc_stream_init: the carry of
    ctc_stream_step, per-layer K/V caches of the last cfg.ctc_left chunks
    [B, left*chunk, H, Dh] in cfg.dtype, their validity mask and the
    stream's frame position (a Python int). Needs a chunk-masked model
    with bounded left context."""
    if cfg.ctc_chunk <= 0:
        raise ValueError("streaming needs a chunk-masked model")
    if cfg.ctc_left < 0:
        raise ValueError("streaming needs bounded left context")
    m = cfg.ctc_left * cfg.ctc_chunk
    nlayers = len(p["encoder"]["layers"])
    shape = (batch_size, m, cfg.nhead, cfg.e_in // cfg.nhead)
    return {"k": [torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(nlayers)],
            "v": [torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(nlayers)],
            "valid": torch.zeros((batch_size, m), dtype=torch.bool,
                                 device=device),
            "pos": 0}


def ctc_stream_step(p, ctx: nn.Ctx, cfg: ModelConfig, carry, mel_chunk,
                    frame_valid):
    """unast_tpu/models/ctc.py::ctc_stream_step: one online encoder step
    over mel_chunk [B, ctc_chunk, n_mels] (frame_valid bool [B, chunk],
    False for pad frames), equal to ctc_logits' chunk-masked forward on
    those frames. Returns (new carry, logits float32 [B, chunk, V+1],
    per-frame argmax [B, chunk])."""
    if ctx.train:
        raise ValueError("streaming inference requires an eval-mode Ctx")
    c = cfg.ctc_chunk
    m = carry["valid"].shape[1]
    b = mel_chunk.shape[0]
    dev = mel_chunk.device
    x = M.speech_prenet(p["prenet"], ctx, mel_chunk, cfg)
    if cfg.ctc_pos != "rel":
        x = M.positional_encoding(ctx, x, offset=carry["pos"])
    key_valid = torch.cat([carry["valid"], frame_valid], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(key_valid, zero, zero + T.NEG_INF)[:, None, None, :]
    if cfg.ctc_pos == "rel":
        # cache slot j holds the key m-j frames before the chunk start;
        # query i sits at in-window position m+i
        bias = bias + rel_bias(p["rel_pos"], m + torch.arange(c, device=dev),
                               torch.arange(m + c, device=dev), cfg)
    new_k, new_v = [], []
    for li, lp in enumerate(p["encoder"]["layers"]):
        attn = lp["attn"]
        q, k, v = T._fused_proj([attn["q"], attn["k"], attn["v"]], x)
        q, k, v = (T._split_heads(t, cfg.nhead) for t in (q, k, v))
        k_full = torch.cat([carry["k"][li], k], dim=1)
        v_full = torch.cat([carry["v"][li], v], dim=1)
        o = T.attention_core(q, k_full, v_full, bias, ctx, cfg.e_drop)
        a = nn.linear(attn["out"], o.reshape(b, c, -1))
        x = nn.layernorm(lp["ln1"], x + a)
        f = T._ffn(lp, ctx, x, cfg.e_drop)
        x = nn.layernorm(lp["ln2"], x + f)
        new_k.append(k_full[:, k_full.shape[1] - m:])
        new_v.append(v_full[:, v_full.shape[1] - m:])
    logits = nn.linear(p["ctc_head"], x).float()
    new_carry = {"k": new_k, "v": new_v,
                 "valid": key_valid[:, key_valid.shape[1] - m:],
                 "pos": carry["pos"] + c}
    return new_carry, logits, torch.argmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# Prefix beam search (host numpy)
# ---------------------------------------------------------------------------


def ctc_prefix_beam_search(log_probs: "np.ndarray", n_frames: int,
                           beam: int = 8, max_text_len: int = 300):
    """unast_tpu/models/ctc.py::ctc_prefix_beam_search (copied): prefix
    beam search over one utterance's CTC log-posteriors [T, V+1] (Hannun
    et al. 2014), merging the mass of every alignment of a prefix.
    Returns a Python list of ids."""
    lp = np.asarray(log_probs, np.float64)[:n_frames]
    NEG = -1e30

    def logsumexp2(a, b):
        m = max(a, b)
        if m <= NEG:
            return NEG
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    # beams: prefix tuple -> (log p ending in blank, log p ending in tok)
    beams = {(): (0.0, NEG)}
    for t in range(lp.shape[0]):
        frame = lp[t]
        top = np.argsort(frame)[::-1][: max(beam, 8)]  # prune the vocab
        nxt = {}

        def acc(prefix, pb, pnb):
            b0, nb0 = nxt.get(prefix, (NEG, NEG))
            nxt[prefix] = (logsumexp2(b0, pb), logsumexp2(nb0, pnb))

        for prefix, (pb, pnb) in beams.items():
            p_tot = logsumexp2(pb, pnb)
            for k in top:
                pk = float(frame[k])
                if k == BLANK_ID:
                    acc(prefix, p_tot + pk, NEG)
                elif prefix and k == prefix[-1]:
                    # repeat: extends ONLY the blank-ending mass; the
                    # non-blank mass collapses into the same prefix
                    acc(prefix, NEG, pnb + pk)
                    if len(prefix) < max_text_len:
                        acc(prefix + (int(k),), NEG, pb + pk)
                else:
                    if len(prefix) < max_text_len:
                        acc(prefix + (int(k),), NEG, p_tot + pk)
        beams = dict(sorted(nxt.items(),
                            key=lambda kv: -logsumexp2(*kv[1]))[:beam])
    best = max(beams.items(), key=lambda kv: logsumexp2(*kv[1]))[0]
    return list(best)


# ---------------------------------------------------------------------------
# Forced alignment
# ---------------------------------------------------------------------------


def ctc_forced_align(log_probs, frame_valid, labels, label_lens,
                     blank_split: bool = False):
    """unast_tpu/models/ctc.py::ctc_forced_align: Viterbi alignment over
    the CTC graph (states blank, l1, blank, ..., lU, blank) constrained to
    emit exactly the labels, and the frames per token: blank runs count
    toward the preceding token (leading blanks to token 0), or with
    blank_split each interior blank run splits half/half between its two
    tokens. log_probs [B, T, V+1], frame_valid bool [B, T], labels [B, U],
    label_lens [B] -> durations [B, U] (long). JAX's forward and backward
    lax.scan are loops over the frames here."""
    b, t, _ = log_probs.shape
    u = labels.shape[1]
    dev = log_probs.device
    s_dim = 2 * u + 1
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)
    s_idx = torch.arange(s_dim, device=dev)
    is_lab = (s_idx % 2) == 1
    tok_of_state = torch.clamp(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                               0, u - 1)
    lab_ids = torch.where(is_lab[None, :],
                          labels[:, torch.clamp(s_idx // 2, 0, u - 1)],
                          torch.full_like(labels[:, :1], BLANK_ID))   # [B, S]
    s_valid = s_idx[None, :] < (2 * label_lens[:, None] + 1)
    # skip (s-2 -> s) only into a label state whose label differs from
    # the label two states back (CTC's repeated-label rule)
    prev2_lab = torch.cat([torch.full_like(lab_ids[:, :2], -1),
                           lab_ids[:, :-2]], dim=1)
    skip_ok = is_lab[None, :] & (s_idx >= 2)[None, :] & (lab_ids != prev2_lab)
    emit = torch.gather(log_probs.float(), 2,
                        lab_ids[:, None, :].expand(b, t, s_dim))    # [B, T, S]

    q = torch.where((s_idx[None, :] <= 1) & s_valid, emit[:, 0], neg)
    deltas = []
    for f in range(1, t):
        prev1 = torch.cat([neg.expand(b, 1), q[:, :-1]], dim=1)
        prev2 = torch.cat([neg.expand(b, 2), q[:, :-2]], dim=1)
        prev2 = torch.where(skip_ok, prev2, neg)
        best = torch.maximum(q, torch.maximum(prev1, prev2))
        delta = torch.where(prev2 >= best, 2, torch.where(prev1 >= best, 1, 0))
        q_new = torch.where(s_valid, best + emit[:, f], neg)
        # PAD frames carry the lattice unchanged (stay-only, score 0)
        valid_t = frame_valid[:, f, None]
        q = torch.where(valid_t, q_new, q)
        deltas.append(torch.where(valid_t, delta, 0))
    # end in the last blank (2U) or the last label (2U-1), the better
    e_blank = torch.clamp(2 * label_lens, 0, s_dim - 1)
    e_label = torch.clamp(2 * label_lens - 1, 0, s_dim - 1)
    qb = q.gather(1, e_blank[:, None])[:, 0]
    ql = q.gather(1, e_label[:, None])[:, 0]
    j = torch.where(qb >= ql, e_blank, e_label)
    states = [None] * t
    for f in range(t - 1, 0, -1):
        states[f] = j
        j = j - deltas[f - 1].gather(1, j[:, None])[:, 0]
    states[0] = j
    states = torch.stack(states, dim=1)                               # [B, T]
    prec = tok_of_state[states]        # preceding token (blank 2k -> k-1)
    if blank_split:
        isb = (states % 2) == 0
        fol = torch.clamp(states // 2, 0, u - 1)  # following token
        fidx = torch.arange(t, device=dev)[None, :].expand(b, t)
        lab_here = (~isb) & frame_valid
        # nearest label frame at/before f (running max) and at/after f
        run_start = torch.cummax(torch.where(lab_here, fidx, -1), dim=1)[0] + 1
        nxt = torch.flip(torch.cummin(torch.flip(
            torch.where(lab_here, fidx, t), [1]), dim=1)[0], [1])
        interior = (nxt < t) & (run_start > 0)
        second = (fidx - run_start) * 2 >= (nxt - run_start)
        tok = torch.where(isb & interior & second, fol, prec)
    else:
        tok = prec
    dur = (F.one_hot(tok, u) * frame_valid[:, :, None].long()).sum(dim=1)
    return dur * M.lens_to_mask(label_lens, u).long()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _loss_dtype(logits) -> torch.dtype:
    return torch.float64 if logits.dtype == torch.float64 else torch.float32


def _optax_ctc_per_seq(logits, logit_paddings, labels, label_paddings):
    """optax.ctc_loss's per-sequence loss (optax/losses/_classification.py::
    ctc_loss_with_forward_probs, blank BLANK_ID, log_epsilon -1e5), its
    lax.scan over frames a Python loop: logits [B, T, V+1], paddings float
    [B, T] / [B, N] (1 = PAD), labels [B, N] -> [B], in float32 (float64
    for float64 logits). Where no alignment fits a row, its loss is large
    and finite, as in optax."""
    batch, _, _ = logits.shape
    maxlabellen = labels.shape[1]
    dt = _loss_dtype(logits)
    logprobs = torch.log_softmax(logits.to(dt), dim=-1)
    labellens = maxlabellen - label_paddings.sum(dim=1).long()
    # repeat[b, n] == 1.0 when label[b, n] == label[b, n+1]
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    logprobs_phi = logprobs[:, :, BLANK_ID:BLANK_ID + 1].transpose(0, 1)
    logprobs_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(-1, logprobs.shape[1], -1)
    ).transpose(0, 1)                                               # [T, B, N]
    phi = torch.full((batch, maxlabellen + 1), LOG_EPSILON, dtype=dt,
                     device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((batch, maxlabellen), LOG_EPSILON, dtype=dt,
                      device=logits.device)

    def update_phi_score(phi, added_score):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added_score)],
                         dim=-1)

    pads = logit_paddings.to(dt).transpose(0, 1)
    for t in range(logprobs_emit.shape[0]):
        prev_phi, prev_emit = phi, emit
        # emit-to-phi epsilon transition, except if the next label repeats
        phi = update_phi_score(prev_phi, prev_emit + LOG_EPSILON * repeat)
        le, lp = logprobs_emit[t], logprobs_phi[t]
        # phi-to-emit transition
        next_emit = torch.logaddexp(phi[:, :-1] + le, prev_emit + le)
        # self-loop transition
        next_phi = phi + lp
        # emit-to-phi blank transition only when the next label repeats
        next_phi = update_phi_score(
            next_phi, prev_emit + lp + LOG_EPSILON * (1.0 - repeat))
        pad = pads[t].reshape(batch, 1)
        emit = pad * prev_emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi + (1.0 - pad) * next_phi
    # the last row gets the last epsilon transition
    phi_last = update_phi_score(phi, emit)
    return -phi_last.gather(1, labellens[:, None])[:, 0]


def ctc_loss(logits, frame_pad_mask, labels, label_lens):
    """unast_tpu/models/ctc.py::ctc_loss: the mean per-sequence CTC loss
    of optax.ctc_loss (blank BLANK_ID, log_epsilon -1e5) over logits
    [B, T, V+1] (frame_pad_mask True = PAD), labels [B, N] (0 = PAD past
    label_lens). A row fits some alignment when its frames cover its
    labels plus one blank between each repeated pair; those rows take
    torch's ctc_loss (the same value up to rounding: optax's floor adds
    exp(-1e5) = 0), the others optax's recursion (_optax_ctc_per_seq).
    float32, or float64 for float64 logits."""
    in_lens = (~frame_pad_mask).sum(dim=1)
    n = labels.shape[1]
    in_label = M.lens_to_mask(label_lens, n)
    repeats = ((labels[:, 1:] == labels[:, :-1]) & in_label[:, 1:]).sum(dim=1)
    fits = in_lens >= label_lens + repeats
    logp = torch.log_softmax(logits.to(_loss_dtype(logits)), dim=-1)
    per_seq = F.ctc_loss(logp.transpose(0, 1), labels.long(), in_lens,
                         label_lens, blank=BLANK_ID, reduction="none",
                         zero_infinity=True)
    if not bool(fits.all()):
        rows = torch.nonzero(~fits)[:, 0]
        per_seq = per_seq.index_put((rows,), _optax_ctc_per_seq(
            logits[rows], frame_pad_mask[rows].float(), labels[rows],
            (~in_label[rows]).float()))
    return C.mean(per_seq)
