"""Loss functions of the port, mirroring `unast_tpu/train/losses.py`.

All reductions accumulate in float32. Padding is handled by masks as the
JAX package does, including its unmasked stop BCE over padded frames.
"""

import torch
import torch.nn.functional as F

from ..models.config import PAD_IDX, EOS_IDX
from ..models.modules import lens_to_mask


def masked_mse(gold_mel, pred_mel, mel_mask):
    """unast_tpu/train/losses.py::masked_mse: mean squared error over the
    kept elements; mel_mask broadcasts to gold_mel, 1 = keep."""
    diff2 = (gold_mel.float() - pred_mel.float()) ** 2
    m = torch.broadcast_to(mel_mask, gold_mel.shape).float()
    return (diff2 * m).sum() / m.sum().clamp(min=1.0)


def text_loss(gold_char, logits, eos_weight: float = 1.0):
    """unast_tpu/train/losses.py::text_loss: cross entropy over [B, T]
    tokens, EOS weighted, PAD ignored, normalised by the applied weights."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = gold_char.long()
    nll = -torch.gather(logp, -1, gold[..., None])[..., 0]
    w = torch.where(gold == EOS_IDX, eos_weight, 1.0)
    w = torch.where(gold == PAD_IDX, 0.0, w).to(nll.dtype)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def bce_with_logits(logits, labels, pos_weight=None):
    """unast_tpu/train/losses.py::bce_with_logits (torch
    binary_cross_entropy_with_logits semantics, mean reduction)."""
    x = logits.float()
    y = labels.float()
    log_p = F.logsigmoid(x)
    log_np = F.logsigmoid(-x)
    if pos_weight is not None:
        loss = -(pos_weight * y * log_p + (1.0 - y) * log_np)
    else:
        loss = -(y * log_p + (1.0 - y) * log_np)
    return loss.mean()


def speech_loss(gold_mel, stop_label, pred_mel, post_pred_mel, mel_len,
                stop_pred, eos_weight: float = 1.0):
    """unast_tpu/train/losses.py::speech_loss: pre-MSE + post-MSE + the
    stop BCE with eos_weight on the positive label, unmasked."""
    t = pred_mel.shape[1]
    mel_mask = lens_to_mask(mel_len, t)[..., None]
    pred_loss = masked_mse(gold_mel, pred_mel, mel_mask)
    post_loss = masked_mse(gold_mel, post_pred_mel, mel_mask)
    stop_weight = torch.where(stop_label == 1, eos_weight, 1.0)
    stop_loss = bce_with_logits(stop_pred, stop_label, pos_weight=stop_weight)
    return pred_loss + post_loss + stop_loss


def discriminator_loss(output, target):
    """unast_tpu/train/losses.py::discriminator_loss (BCE with logits)."""
    return bce_with_logits(output, target)


def discriminator_target(batch_size: int, target_type: str,
                         smoothing: float = 0.1, device=None):
    """unast_tpu/train/losses.py::discriminator_target: smoothed labels,
    text 0.9, speech 0.1."""
    t = torch.full((batch_size,), 1.0 - smoothing, dtype=torch.float32,
                   device=device)
    if target_type == "speech":
        t = 1.0 - t
    return t


def stop_label_from_lens(mel_len, max_len: int):
    """unast_tpu/train/losses.py::stop_label_from_lens: one_hot(mel_len - 1)
    float32 gold stop labels [B, max_len]."""
    pos = torch.arange(max_len, device=mel_len.device)
    return (pos[None, :] == (mel_len - 1)[:, None]).float()


def guided_attention_loss(attn, q_len, k_len, sigma: float = 0.2):
    """unast_tpu/train/losses.py::guided_attention_loss: the mean over valid
    (q, k) positions of attn * (1 - exp(-(q/Ql - k/Kl)^2 / (2 sigma^2))).
    attn: [..., B, H, Tq, Tk] probabilities; q_len, k_len: [B]."""
    tq, tk = attn.shape[-2], attn.shape[-1]
    dev = attn.device
    qs = torch.arange(tq, dtype=torch.float32, device=dev)[:, None]
    ks = torch.arange(tk, dtype=torch.float32, device=dev)[None, :]
    ql = q_len.float().clamp(min=1.0)[:, None, None]
    kl = k_len.float().clamp(min=1.0)[:, None, None]
    w = 1.0 - torch.exp(-((qs / ql - ks / kl) ** 2) / (2.0 * sigma ** 2))
    valid = ((qs < ql) & (ks < kl)).float()              # [B, Tq, Tk]
    w = w[:, None, :, :]
    valid = valid[:, None, :, :]
    num = (attn.float() * w * valid).sum()
    den = torch.broadcast_to(valid, attn.shape).sum().clamp(min=1.0)
    return num / den
