"""Input augmentation of the port, mirroring `unast_tpu/train/augment.py`
(the denoising AE's noise_fn lives in models/modules.py, as in JAX).

The reference's "frequency" mask indexes the time axis, so both masks mask
time spans; that is reproduced here.
"""

import torch


def _randint(gen, high, b, device):
    """b integers, the i-th uniform in [0, high[i]) (high an int or [b])."""
    high = torch.as_tensor(high, device=device)
    u = torch.rand((b,), generator=gen, device=device)
    return (u * high).floor().long().clamp(max=torch.clamp(high - 1, min=0))


def specaugment(gen: torch.Generator, mel, mel_len, freq_mask: int = 20,
                time_mask: int = 100):
    """unast_tpu/train/augment.py::specaugment (its defaults: the reference's
    two time masks, mean fill). mel: [B, T, M]; two random time spans of
    each row are replaced by that row's mean over the whole padded
    [T, M] tensor. Span lengths: uniform in [0, freq_mask) and
    [0, time_mask), the second redrawn in [0, max(len // 2, 1)) where it
    would reach len, the first cut to len - 1; each span starts uniformly
    in [0, max(len - span, 1)). Draws come from `gen`, on mel's device."""
    b = mel.shape[0]
    dev = mel.device
    mel_len = mel_len.to(dev).long()
    f_len = _randint(gen, max(freq_mask, 1), b, dev)
    t_len = _randint(gen, max(time_mask, 1), b, dev)
    bad = (mel_len - t_len) <= 0
    t_alt = _randint(gen, torch.clamp(mel_len // 2, min=1), b, dev)
    t_len = torch.where(bad, t_alt, t_len)
    f_len = torch.minimum(f_len, torch.clamp(mel_len - 1, min=0))

    def rand_start(span):
        hi = torch.clamp(mel_len - span, min=1)
        return (torch.rand((b,), generator=gen, device=dev) * hi).long()

    f_zero = rand_start(f_len)
    t_zero = rand_start(t_len)
    fill = mel.mean(dim=(1, 2))
    pos = torch.arange(mel.shape[1], device=dev)[None, :]
    span_t = (pos >= t_zero[:, None]) & (pos < (t_zero + t_len)[:, None])
    span_f = (pos >= f_zero[:, None]) & (pos < (f_zero + f_len)[:, None])
    return torch.where((span_t | span_f)[:, :, None], fill[:, None, None], mel)
