"""Objective audio-quality metrics (pure numpy, no external deps), copied
from `unast_tpu/audio/metrics.py`.

The reference has no perceptual vocoder metric at all — its vocoder
trainer logs only the L1/L2 regression loss (src/train_vocoder.py:84-98).
Mel-cepstral distortion (MCD, Kubichek 1993) is the standard objective
proxy for vocoder quality: the RMS distance between mel-cepstral
coefficient vectors of time-aligned reference and synthesized audio,
reported in dB. Complements the multi-resolution-STFT spectral
convergence used by the MelGAN gates (train/melgan.py::mr_stft_loss),
which scores envelope fit; MCD weights the smoothed spectral SHAPE
(formant structure) via the low-order cepstrum.
"""

import numpy as np

from .params import AudioParams, DEFAULT


def mel_cepstra(mel_norm: np.ndarray, p: AudioParams = DEFAULT,
                n_mfcc: int = 13) -> np.ndarray:
    """unast_tpu/audio/metrics.py::mel_cepstra. Pipeline-normalized mel
    ([T, M] in [0, 1], the (dB - ref + max)/max
    layout of audio/dsp.py) -> mel-cepstral coefficients [T, n_mfcc]
    (orthonormal DCT-II of the natural-log mel magnitudes)."""
    mel_norm = np.asarray(mel_norm, np.float64)
    db = mel_norm * p.max_db - p.max_db + p.ref_db
    logm = db * (np.log(10.0) / 20.0)  # dB -> ln magnitude
    m = mel_norm.shape[1]
    k = np.arange(n_mfcc)[:, None]
    n = np.arange(m)[None, :]
    basis = np.cos(np.pi * k * (n + 0.5) / m) * np.sqrt(2.0 / m)
    basis[0] *= np.sqrt(0.5)
    return logm @ basis.T


def mcd(mel_ref: np.ndarray, mel_syn: np.ndarray,
        p: AudioParams = DEFAULT, n_mfcc: int = 13) -> float:
    """unast_tpu/audio/metrics.py::mcd. MCD in dB between two
    pipeline-normalized mels, frame-aligned over
    the common length (c0 — overall energy — excluded, the convention)."""
    cr = mel_cepstra(mel_ref, p, n_mfcc)[:, 1:]
    cs = mel_cepstra(mel_syn, p, n_mfcc)[:, 1:]
    t = min(len(cr), len(cs))
    if t == 0:
        return float("nan")
    d = np.sqrt(2.0 * np.sum((cr[:t] - cs[:t]) ** 2, axis=1))
    return float((10.0 / np.log(10.0)) * np.mean(d))


def mcd_wav(wav_ref: np.ndarray, wav_syn: np.ndarray,
            p: AudioParams = DEFAULT, n_mfcc: int = 13, device=None) -> float:
    """unast_tpu/audio/metrics.py::mcd_wav: MCD between two TIME-ALIGNED
    waveforms (no trim — alignment is the caller's contract; both run
    through the port's own wav->mel DSP on `device`, None = cuda)."""
    from . import dsp
    mr, _, nr = dsp.wav_to_mel_mag(np.asarray(wav_ref, np.float32), p,
                                   trim=False, device=device)
    ms, _, ns = dsp.wav_to_mel_mag(np.asarray(wav_syn, np.float32), p,
                                   trim=False, device=device)
    return mcd(mr[:nr].cpu().numpy(), ms[:ns].cpu().numpy(), p, n_mfcc)
