"""Frame-level F0 (pitch) extraction — normalized-autocorrelation method.
Copied verbatim from `unast_tpu/audio/pitch.py` (numpy).

Host-side numpy, used offline (dataset preparation for the FastSpeech
pitch adaptor, models/fastspeech.py) and for verification (the pitch-
control gate measures the F0 of synthesized audio,
scripts/pitch_control_check.py). The reference has no pitch modeling
anywhere (SURVEY §2); this supports a capability addition.

Method: for each analysis frame, the normalized autocorrelation
r(k) = sum(x_t x_{t+k}) / sqrt(sum x_t^2 * sum x_{t+k}^2) is evaluated
over lags for [fmin, fmax]; the peak lag gives F0, frames with peak
correlation below `voiced_threshold` (or too little energy) are unvoiced
(f0 = 0). Frame placement matches the DSP's mel frames (hop 275,
centered), so f0[t] aligns with mel[t].
"""

import numpy as np


def extract_f0(wav: np.ndarray, sr: int = 22050, hop: int = 275,
               win: int = 1102, fmin: float = 70.0, fmax: float = 400.0,
               voiced_threshold: float = 0.3) -> np.ndarray:
    """unast_tpu/audio/pitch.py::extract_f0. wav: float32 [n] -> f0
    float32 [n_frames] (0 = unvoiced), with
    n_frames = 1 + n // hop (centered frames, matching the mel count)."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    half = win // 2
    y = np.pad(wav, half, mode="reflect")
    n_frames = 1 + n // hop
    lag_min = max(1, int(sr / fmax))
    lag_max = min(win - 1, int(sr / fmin))
    f0 = np.zeros((n_frames,), np.float32)
    for t in range(n_frames):
        fr = y[t * hop:t * hop + win]
        fr = fr - fr.mean()
        e0 = float(fr @ fr)
        if e0 < 1e-8:
            continue
        # full autocorrelation via one FFT (O(win log win) per frame)
        nfft = 1
        while nfft < 2 * win:
            nfft <<= 1
        spec = np.fft.rfft(fr, nfft)
        ac = np.fft.irfft(spec * np.conj(spec), nfft)[:lag_max + 1]
        # normalize by the energy of the overlapping segments
        csum = np.cumsum(fr * fr)
        e_head = csum[win - 1 - np.arange(lag_min, lag_max + 1)]
        e_tail = csum[-1] - csum[np.arange(lag_min, lag_max + 1) - 1]
        denom = np.sqrt(np.maximum(e_head * e_tail, 1e-12))
        r = ac[lag_min:lag_max + 1] / denom
        peak = float(r.max())
        if peak >= voiced_threshold:
            # a periodic signal peaks at EVERY multiple of the period —
            # start at the SMALLEST lag within 5% of the best peak
            # (octave-error guard: plain argmax can land on 2x/3x the
            # period), climb to the local maximum, refine parabolically
            k = int(np.argmax(r >= 0.95 * peak))
            while k + 1 < len(r) and r[k + 1] > r[k]:
                k += 1
            lag = float(lag_min + k)
            if 0 < k < len(r) - 1:
                a, b, c = float(r[k - 1]), float(r[k]), float(r[k + 1])
                den = a - 2 * b + c
                if abs(den) > 1e-12:
                    lag += 0.5 * (a - c) / den
            f0[t] = sr / lag
    return f0


def token_log_f0(f0: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """unast_tpu/audio/pitch.py::token_log_f0. Token-level mean log-F0
    over VOICED frames: f0 [T], durations
    [Tt] (summing to <= T) -> log-f0 [Tt] (0 where the whole span is
    unvoiced). numpy counterpart of the in-graph reduction in
    train/fastspeech.py (used by tests)."""
    out = np.zeros((len(durations),), np.float32)
    t = 0
    for i, d in enumerate(durations):
        span = f0[t:t + int(d)]
        v = span[span > 0]
        if len(v):
            out[i] = np.log(v).mean()
        t += int(d)
    return out


def mel_f0_template(mel: np.ndarray, f0s: np.ndarray = None,
                    sr: int = 22050, n_fft: int = 2048, win: int = 1102,
                    preemph: float = 0.97, band: int = 30,
                    floor: float = 0.25) -> np.ndarray:
    """unast_tpu/audio/pitch.py::mel_f0_template. Per-frame F0 read off a
    (normalized-log) MEL spectrogram by
    TEMPLATE MATCHING: for each candidate F0, the synthetic corpus's
    two-partial line spectrum (fundamental + one octave harmonic,
    data/dataset.py::synth_audio) is projected through the exact analysis
    chain — preemphasis gain, hann-mainlobe leakage, mel filterbank, dB,
    clip-normalization — and each frame picks the best-cosine template.

    Why not wav-domain autocorrelation on vocoded audio: the serving mag
    lift + Griffin-Lim destroys periodicity (measured 1/100 voiced frames
    on GOLD-mel reconstructions). Why not a mel argmax: preemphasis tilts
    the octave harmonic above the fundamental. Caveat: frames whose
    analysis window spans a phoneme boundary are two-tone mixtures and
    match poorly — compare MEDIANS of the same readout (the pitch-control
    gate compares synth@shift medians, so selection biases cancel), and
    use phoneme_dur_s >= 0.08 so mid-phoneme frames are pure."""
    from .filters import hann_window, mel_filterbank
    if f0s is None:
        f0s = np.arange(90.0, 580.0, 4.0)
    n_freqs = 1 + n_fft // 2
    basis = mel_filterbank(sr, n_fft, mel.shape[1])
    kern = np.abs(np.fft.rfft(hann_window(win, n_fft)))[:40]
    bank = []
    for f0 in f0s:
        mag = np.zeros(n_freqs)
        for f, a in ((f0, 0.5), (2 * f0, 0.25)):
            g = abs(1 - preemph * np.exp(-2j * np.pi * f / sr))
            ci = int(round(f / (sr / 2) * (n_freqs - 1)))
            for d in range(-39, 40):
                j = ci + d
                if 0 <= j < n_freqs:
                    mag[j] += a * g * kern[abs(d)]
        db = 20 * np.log10(np.maximum(basis @ mag, 1e-5)) - 20.0
        bank.append(np.clip((db + 100.0) / 100.0, 0.0, 1.0))
    tb = np.stack(bank)[:, :band]
    tb = tb - tb.mean(axis=1, keepdims=True)
    tb /= np.maximum(np.linalg.norm(tb, axis=1, keepdims=True), 1e-9)

    m = np.asarray(mel, np.float32)[:, :band]
    mm = m - m.mean(axis=1, keepdims=True)
    mm = mm / np.maximum(np.linalg.norm(mm, axis=1, keepdims=True), 1e-9)
    f0 = np.asarray(f0s, np.float32)[np.argmax(mm @ tb.T, axis=1)]
    f0[m.max(axis=1) < floor] = 0.0
    return f0
