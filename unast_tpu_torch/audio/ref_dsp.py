"""Host-side numpy DSP of the port, copied from `unast_tpu/audio/ref_dsp.py`:
silence trim and preemphasis, and the numpy wav -> (mel, mag) path (a
reflect-padded STFT and the Slaney mel filterbank) that the synthetic
dataset builds its mels with. The trim stands in for the JAX package's
ctypes trim (unast_tpu/native), which computes the same bounds."""

import numpy as np

from .filters import hann_window, mel_filterbank
from .params import AudioParams, DEFAULT


def trim_silence(y: np.ndarray, p: AudioParams = DEFAULT):
    """unast_tpu/audio/ref_dsp.py::trim_silence (librosa.effects.trim
    semantics): drop leading/trailing frames whose centered RMS power is more
    than top_db below the signal max. Returns (trimmed, (start, end))."""
    frame, hop = p.trim_frame_length, p.trim_hop_length
    if len(y) == 0:
        return y, (0, 0)
    pad = frame // 2
    ypad = np.pad(y.astype(np.float64), pad)
    n_frames = 1 + (len(ypad) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
    mse = np.mean(ypad[idx] ** 2, axis=1)
    db = 10.0 * np.log10(np.maximum(mse, 1e-10) / max(np.max(mse), 1e-10))
    non_silent = db > -p.trim_top_db
    if not non_silent.any():
        return y[:0], (0, 0)
    first = int(np.argmax(non_silent))
    last = int(len(non_silent) - np.argmax(non_silent[::-1]))
    start = first * hop
    end = min(len(y), last * hop)
    return y[start:end], (start, end)


def preemphasis(y: np.ndarray, coef: float) -> np.ndarray:
    """unast_tpu/audio/ref_dsp.py::preemphasis."""
    return np.append(y[0], y[1:] - coef * y[:-1])


def stft(y: np.ndarray, p: AudioParams = DEFAULT) -> np.ndarray:
    """unast_tpu/audio/ref_dsp.py::stft: (n_freqs, T) complex STFT,
    center=True with reflect padding, float64."""
    n_fft, hop = p.n_fft, p.hop_length
    window = hann_window(p.win_length, n_fft).astype(np.float64)
    y = np.pad(y.astype(np.float64), n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * window[None, :]
    return np.fft.rfft(frames, n=n_fft, axis=1).T


def wav_to_mel_mag(y: np.ndarray, p: AudioParams = DEFAULT, trim: bool = True):
    """unast_tpu/audio/ref_dsp.py::wav_to_mel_mag: wav -> (mel (T, n_mels),
    mag (T, n_freqs)) float32, dB-normalized and clipped to [1e-8, 1]."""
    if trim:
        y, _ = trim_silence(y, p)
    y = preemphasis(y, p.preemphasis)
    mag = np.abs(stft(y, p))
    mel_basis = mel_filterbank(p.sr, p.n_fft, p.num_mels).astype(np.float64)
    mel = 20.0 * np.log10(np.maximum(1e-5, mel_basis @ mag))
    mag_db = 20.0 * np.log10(np.maximum(1e-5, mag))
    mel = np.clip((mel - p.ref_db + p.max_db) / p.max_db, 1e-8, 1.0)
    mag_db = np.clip((mag_db - p.ref_db + p.max_db) / p.max_db, 1e-8, 1.0)
    return mel.T.astype(np.float32), mag_db.T.astype(np.float32)
