"""The one general generator of the benchmark's inputs.

Every quantity a traffic file draws (utterance durations, text lengths,
text characters) comes from a scaled Beta distribution on [lo, hi] with a
stated mean. The sizes themselves are fixed by the file alone: the n
values of a set are the n mid-quantiles of the distribution, computed
from a fixed sample, so that every seed gets the same set of sizes and
the same work, and the seed only deals them out (which utterance, which
micro-batch, which words) and draws the contents.
"""

import numpy as np

QUANTILE_SAMPLE = 200_000
BETA_CONCENTRATION = 4.0


def quantiles(lo, hi, mean, n):
    """n sizes in [lo, hi]: the mid-quantiles (i + 0.5) / n of lo +
    (hi - lo) * Beta(a, b), a + b = BETA_CONCENTRATION, of the given mean."""
    m = (mean - lo) / (hi - lo)
    if not 0.0 < m < 1.0:
        raise ValueError(f"mean {mean} must lie inside ({lo}, {hi})")
    a, b = BETA_CONCENTRATION * m, BETA_CONCENTRATION * (1.0 - m)
    sample = np.random.default_rng(0).beta(a, b, QUANTILE_SAMPLE)
    q = np.quantile(sample, (np.arange(n) + 0.5) / n)
    return lo + (hi - lo) * q


def rng(seed, *stream):
    """The numpy generator of one stream of a run's draws."""
    return np.random.default_rng([int(seed) % 2 ** 64, *stream])


def utterance_lengths(t, n):
    """(mel frames, text tokens) of n utterances: durations in seconds
    from t['seconds'] = [lo, hi, mean] at t['frames_per_second'], text
    lengths from t['tokens'] = [lo, hi] mapped linearly from the
    durations (a longer clip holds a longer transcript)."""
    lo, hi, mean = t["seconds"]
    sec = quantiles(lo, hi, mean, n)
    frames = np.round(sec * t["frames_per_second"]).astype(np.int64)
    tlo, thi = t["tokens"]
    tokens = np.round(tlo + (sec - lo) / (hi - lo) * (thi - tlo)).astype(np.int64)
    return frames, tokens


def train_steps(t, seed, n_steps, device):
    """n_steps step inputs for the supervised step, each t['micro_batches']
    micro-batches of t['batch'] utterances padded to t['mel_pad'] frames
    and t['text_pad'] tokens, made on `device`: every step holds the same
    multiset of lengths, dealt to its rows by the seed; mel frames are
    N(0, 1) clipped to [-4, 4] (the scale of normalised log-mels), tokens
    uniform over the phoneme symbols, ending in EOS. Returns a list of
    (text [n, B, Tt] int64, mel [n, B, Tm, n_mels], text_len [n, B],
    mel_len [n, B]) and the real frames of one step."""
    import torch
    n, b = t["micro_batches"], t["batch"]
    frames, tokens = utterance_lengths(t, n * b)
    out = []
    for s in range(n_steps):
        r = rng(seed, 1, s)
        order = r.permutation(n * b)
        mel_len = torch.as_tensor(frames[order].reshape(n, b), device=device)
        text_len = torch.as_tensor(tokens[order].reshape(n, b), device=device)
        g = torch.Generator(device=device).manual_seed(int(r.integers(2 ** 62)))
        mel = torch.randn((n, b, t["mel_pad"], t["num_mels"]), generator=g,
                          device=device).clamp_(-4.0, 4.0)
        pos = torch.arange(t["mel_pad"], device=device)
        mel *= (pos[None, None, :] < mel_len[..., None])[..., None]
        text = torch.randint(t["token_ids"][0], t["token_ids"][1],
                             (n, b, t["text_pad"]), generator=g, device=device)
        tpos = torch.arange(t["text_pad"], device=device)[None, None, :]
        text = torch.where(tpos < text_len[..., None] - 1, text,
                           torch.where(tpos == text_len[..., None] - 1,
                                       torch.full_like(text, 2),
                                       torch.zeros_like(text)))
        out.append((text, mel, text_len, mel_len))
    return out, int(frames.sum())


def texts(t, lexicon_words, seed, n_batches):
    """n_batches batches of t['batch'] texts: each batch takes the same
    multiset of character counts (t['chars'] = [lo, hi, mean]), each text
    made of lexicon words drawn by the seed and joined by spaces, filled
    to within the shortest word's length of its count (at least one
    word)."""
    lo, hi, mean = t["chars"]
    b = t["batch"]
    targets = np.round(quantiles(lo, hi, mean, b)).astype(np.int64)
    by_len = {}
    for w in sorted(lexicon_words):
        by_len.setdefault(len(w), []).append(w)
    lengths = np.array(sorted(by_len))
    out = []
    for i in range(n_batches):
        r = rng(seed, 2, i)
        batch = []
        for target in targets[r.permutation(b)]:
            words, room = [], int(target) + 1
            while room - 1 >= lengths[0]:
                fits = lengths[lengths <= room - 1]
                n = int(fits[r.integers(len(fits))])
                pool = by_len[n]
                words.append(pool[r.integers(len(pool))])
                room -= n + 1
            batch.append(" ".join(words) if words else by_len[lengths[0]][0])
        out.append(batch)
    return out
