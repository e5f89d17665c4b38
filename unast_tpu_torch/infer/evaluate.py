"""Evaluation of the port, mirroring `unast_tpu/infer/evaluate.py` (the
reference's evaluate / evaluate_main, src/train.py:474-565, 985-998): per
batch, every objective's loss in eval mode, PER from the greedy ASR, and
in test mode the per-utterance dumps (text_preds.json and the predicted
mels) and the discriminator's accuracy d_score.

The losses and decodes of a batch run on the params' device; PER and the
dumps on the host. SpecAugment draws its spans even in eval mode (as in
JAX), from a generator seeded per batch; with the config's spans at 0 a
batch draws nothing that reaches its results but the discriminator
shuffle's permutation, which a mean loss and a count do not see.
"""

import json
import os
from typing import Dict

import numpy as np
import torch

from .. import nn
from ..models import networks as N
from ..models import unast as U
from ..models.config import ModelConfig
from ..train import losses as L
from ..train.augment import specaugment
from ..train.optim import tree_leaves
from ..train.steps import disc_shuffle_batch, seeded_generator
from .metrics import compute_d_score, compute_per


@torch.no_grad()
def eval_batch(params, net_state, gen: torch.Generator, cfg: ModelConfig,
               text, mel, text_len, mel_len, s_eos_weight: float = 5.0,
               t_eos_weight: float = 1.0):
    """unast_tpu/infer/evaluate.py::eval_batch: all objective losses (eval
    mode: no dropout, running BN statistics) plus greedy ASR and TTS of one
    batch on the params' device; `gen` (there) feeds SpecAugment and the
    discriminator shuffle. Returns (losses, (text_pred, text_pred_len),
    (post_pred, stop_lens), (d_out, d_target)); the last pair is None
    without the discriminator."""
    ctx = nn.Ctx(generator=gen, train=False)
    gold_stop = L.stop_label_from_lens(mel_len, mel.shape[1])
    out: Dict[str, torch.Tensor] = {}

    logits, _ = U.text_ae(params, net_state, ctx, cfg, text, text_len)
    out["t_ae"] = L.text_loss(text, logits, t_eos_weight)
    (pre, post, stop), _ = U.speech_ae(params, net_state, ctx, cfg, mel, mel_len)
    out["s_ae"] = L.speech_loss(mel, gold_stop, pre, post, mel_len, stop,
                                s_eos_weight)

    mel_aug = specaugment(ctx.next_rng(), mel, mel_len,
                          cfg.spec_freq_mask, cfg.spec_time_mask)
    (pre, post, stop, _), _ = U.tts(params, net_state, ctx, cfg, text,
                                    text_len, mel, mel_len)
    out["tts"] = L.speech_loss(mel, gold_stop, pre, post, mel_len, stop,
                               s_eos_weight)
    logits, _ = U.asr(params, net_state, ctx, cfg, text, text_len,
                      mel_aug, mel_len)
    out["asr"] = L.text_loss(text, logits, t_eos_weight)

    (pre, post, stop), _ = U.cm_speech_in(params, net_state, ctx, cfg,
                                          mel, mel_len)
    out["s_cm"] = L.speech_loss(mel, gold_stop, pre, post, mel_len, stop,
                                s_eos_weight)
    logits, _ = U.cm_text_in(params, net_state, ctx, cfg, text, text_len)
    out["t_cm"] = L.text_loss(text, logits, t_eos_weight)

    (text_pred, text_pred_len), _ = U.asr(params, net_state, ctx, cfg,
                                          mel=mel, mel_len=mel_len, infer=True)
    (_, post_pred, _, stop_lens), _ = U.tts(params, net_state, ctx, cfg,
                                            text, text_len, infer=True)

    d_out = d_target = None
    if cfg.use_discriminator and "discriminator" in params:
        (t_enc, _), _ = N.text_encode(params["text_m"], net_state["text_m"],
                                      ctx, cfg, text, text_len)
        (s_enc, _), _ = N.speech_encode(params["speech_m"],
                                        net_state["speech_m"], ctx, cfg,
                                        mel, mel_len)
        d_hid, d_len, d_target = disc_shuffle_batch(
            ctx.next_rng(), U._latent(t_enc, cfg), text_len,
            U._latent(s_enc, cfg), mel_len, train_discriminator=True)
        d_out = U.lstm_discriminator(params["discriminator"], ctx, d_hid, d_len)
        out["dis"] = L.discriminator_loss(d_out, d_target)

    return (out, (text_pred, text_pred_len), (post_pred, stop_lens),
            (d_out, d_target))


def batch_to(batch, device):
    """(text, mel, text_len, mel_len) of a collated numpy batch as tensors
    on `device`, ids and lengths as int64."""
    return tuple(torch.from_numpy(np.asarray(batch[k])).to(
        device, torch.long if k != "mel" else torch.float32)
        for k in ("text", "mel", "text_len", "mel_len"))


def evaluate(params, net_state, cfg: ModelConfig, args, batches,
             is_test: bool = False, rng: int = 0):
    """unast_tpu/infer/evaluate.py::evaluate. batches: collated numpy
    batches (with 'fnames'); batch i draws from a generator seeded from
    (rng, i). Returns (per, {loss: [per batch]}), and d_score too with
    is_test, which also writes args.out_test_dir/text_preds.json and
    mels/<fname>.pt.npy."""
    device = tree_leaves(params)[0].device
    losses: Dict[str, list] = {}
    per_sum, n_iters, d_score = 0.0, 0, 0.0
    text_pred_dict = {}
    if is_test:
        os.makedirs(os.path.join(args.out_test_dir, "mels"), exist_ok=True)

    for bi, batch in enumerate(batches):
        text, mel, text_len, mel_len = batch_to(batch, device)
        out, (text_pred, text_pred_len), (post_pred, stop_lens), d_pair = \
            eval_batch(params, net_state, seeded_generator(rng, bi, device),
                       cfg, text, mel, text_len, mel_len,
                       args.s_eos_weight, args.t_eos_weight)
        for k, v in out.items():
            losses.setdefault(k, []).append(float(v))
        tp = text_pred.cpu().numpy()
        tpl = text_pred_len.cpu().numpy()
        per_sum += compute_per(batch["text"], tp, batch["text_len"], tpl)
        n_iters += 1
        if is_test:
            gt, gl = batch["text"], batch["text_len"]
            for i, fname in enumerate(batch["fnames"]):
                text_pred_dict[fname] = {"gt": gt[i, :gl[i]].tolist(),
                                         "pred": tp[i, :tpl[i]].tolist()}
            pp = post_pred.float().cpu().numpy()
            sl = stop_lens.cpu().numpy()
            for i, fname in enumerate(batch["fnames"]):
                np.save(os.path.join(args.out_test_dir, "mels", fname + ".pt"),
                        pp[i, :sl[i]])
            if d_pair[0] is not None:
                d_score += (compute_d_score(d_pair[0].float().cpu().numpy(),
                                            d_pair[1].float().cpu().numpy())
                            / len(batch["fnames"]) / 2)

    per = per_sum / max(1, n_iters)
    if is_test:
        with open(os.path.join(args.out_test_dir, "text_preds.json"), "w") as f:
            json.dump(text_pred_dict, f)
        return per, losses, d_score / max(1, n_iters)
    return per, losses
