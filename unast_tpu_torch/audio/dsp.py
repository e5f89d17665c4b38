"""Audio DSP of the port: STFT / mel / Griffin-Lim in torch ops, batched over
a leading B axis. Mirrors `unast_tpu/audio/dsp.py`; FFTs are torch.fft,
the dft_* magnitude path is a float32 matmul (TF32 must be off on the
card for it to be float32), de-emphasis is a log-depth scan.

Shapes: signals [B, n], frames [B, T, n_fft], spectra [B, T, n_freqs].
"""

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..device import resolve_device
from . import ref_dsp
from .filters import mel_filterbank, hann_window
from .params import AudioParams, DEFAULT


def _q_factor(n_fft: int, hop: int) -> int:
    return -(-n_fft // hop)  # ceil


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::frame_signal, batched: [B, n] (already
    center-padded) -> [B, T, n_fft] frames, T = 1 + (n - n_fft) // hop."""
    return y.unfold(-1, n_fft, hop)


def overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::overlap_add, batched: [B, T, n_fft] ->
    [B, out_len] as Q = ceil(n_fft / hop) shifted adds of hop-wide blocks."""
    b, n_frames, n_fft = frames.shape
    q = _q_factor(n_fft, hop)
    blocks = F.pad(frames, (0, q * hop - n_fft)).reshape(b, n_frames, q, hop)
    acc = frames.new_zeros((b, n_frames + q, hop))
    for qi in range(q):
        acc[:, qi:qi + n_frames] += blocks[:, :, qi]
    flat = acc.reshape(b, -1)[:, :n_fft + hop * (n_frames - 1)]
    if out_len <= flat.shape[1]:
        return flat[:, :out_len]
    return F.pad(flat, (0, out_len - flat.shape[1]))


def preemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::preemphasis, along the last axis: out[0] =
    y[0], out[t] = y[t] - coef * y[t-1]."""
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


def deemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::deemphasis: out[t] = y[t] + coef*out[t-1] along
    the last axis, as a log-depth (Hillis-Steele) scan: after the step with
    shift s, out[t] sums coef^j y[t-j] for j < 2s. Stops once coef^s is 0
    in float32, where the remaining terms are exactly 0."""
    out = y
    n = y.shape[-1]
    shift, a = 1, float(coef)
    while shift < n and np.float32(a) != 0.0:
        out = torch.cat([out[..., :shift],
                         out[..., shift:] + a * out[..., :-shift]], dim=-1)
        shift, a = 2 * shift, a * a
    return out


class _Consts(NamedTuple):
    window: torch.Tensor      # [n_fft] periodic Hann, centered
    lo: int                   # nonzero support of the window: [lo, hi)
    hi: int
    dft_c: torch.Tensor       # [hi - lo, n_freqs] windowed cos
    dft_s: torch.Tensor       # [hi - lo, n_freqs] windowed sin
    mel_w: torch.Tensor       # [n_freqs, n_mels]


@functools.lru_cache(maxsize=8)
def _consts(p: AudioParams, device: torch.device) -> _Consts:
    """The window, DFT matrices (unast_tpu/audio/dsp.py::_dft_matrices: built
    in float64 over the window's support, stored float32) and mel
    filterbank, on `device`, built once per (params, device)."""
    window = np.asarray(hann_window(p.win_length, p.n_fft), np.float64)
    nz = np.nonzero(window)[0]
    lo, hi = int(nz[0]), int(nz[-1]) + 1
    k = np.arange(p.n_fft // 2 + 1)
    t = np.arange(lo, hi)
    ang = -2.0 * np.pi * np.outer(t, k) / p.n_fft
    c = (np.cos(ang) * window[lo:hi, None]).astype(np.float32)
    s = (np.sin(ang) * window[lo:hi, None]).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return _Consts(dev(hann_window(p.win_length, p.n_fft)), lo, hi, dev(c),
                   dev(s), dev(mel_filterbank(p.sr, p.n_fft, p.num_mels).T))


def stft(y: torch.Tensor, p: AudioParams = DEFAULT, window=None) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::stft, batched: [B, n] -> [B, T, n_freqs]
    complex64; center=True with reflect padding."""
    if window is None:
        window = _consts(p, y.device).window
    half = p.n_fft // 2
    y = F.pad(y[:, None], (half, half), mode="reflect")[:, 0]
    frames = frame_signal(y, p.n_fft, p.hop_length) * window
    return torch.fft.rfft(frames, n=p.n_fft, dim=-1)


def istft(spec: torch.Tensor, p: AudioParams = DEFAULT, window=None) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::istft, batched: [B, T, n_freqs] complex ->
    [B, hop*(T-1)] real; window-sum-square normalized, center-cropped."""
    if window is None:
        window = _consts(p, spec.device).window
    n_fft, hop = p.n_fft, p.hop_length
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    n_frames = frames.shape[1]
    full_len = n_fft + hop * (n_frames - 1)
    out = overlap_add(frames, hop, full_len)
    w2 = (window ** 2).expand(1, n_frames, n_fft)
    wss = overlap_add(w2, hop, full_len)
    out = out / torch.clamp(wss, min=1e-10)
    return out[:, n_fft // 2:full_len - n_fft // 2]


def _frame_magnitudes(y_padded: torch.Tensor, p: AudioParams) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::_frame_magnitudes, batched: [B, n]
    preemphasized + center-padded -> [B, T, n_freqs] |STFT|. The dft_*
    modes are two float32 matmuls over the window's support."""
    c = _consts(p, y_padded.device)
    frames = frame_signal(y_padded, p.n_fft, p.hop_length)
    if p.stft_mode == "fft":
        return torch.fft.rfft(frames * c.window, n=p.n_fft, dim=-1).abs()
    if p.stft_mode not in ("dft_high", "dft_highest"):
        raise ValueError(f"unknown stft_mode {p.stft_mode!r}")
    fr = frames[..., c.lo:c.hi]
    re = fr @ c.dft_c
    im = fr @ c.dft_s
    return torch.sqrt(re * re + im * im)


def _wav_to_mel_mag_core(y_padded: torch.Tensor, p: AudioParams):
    """unast_tpu/audio/dsp.py::_wav_to_mel_mag_core, batched, so also its
    vmapped _wav_to_mel_mag_core_batch: framing -> windowed DFT -> mel
    projection -> dB-normalize of [B, n] preemphasized + center-padded
    signals. Returns (mel [B, T, n_mels], mag [B, T, n_freqs])."""
    mag = _frame_magnitudes(y_padded, p)
    mel = mag @ _consts(p, y_padded.device).mel_w
    mel = 20.0 * torch.log10(torch.clamp(mel, min=1e-5))
    mag_db = 20.0 * torch.log10(torch.clamp(mag, min=1e-5))
    mel = torch.clamp((mel - p.ref_db + p.max_db) / p.max_db, 1e-8, 1.0)
    mag_db = torch.clamp((mag_db - p.ref_db + p.max_db) / p.max_db, 1e-8, 1.0)
    return mel, mag_db


# Bucketed input lengths (seconds), as in the JAX package.
_LENGTH_BUCKETS_S = (1, 2, 4, 6, 8, 11)


def _host_prep(y: np.ndarray, p: AudioParams, trim: bool):
    """unast_tpu/audio/dsp.py::_host_prep: trim (native.trim_silence, the
    counterpart of the JAX package's C++ trim) + preemphasis + reflect
    center pad on the host. Returns (y_refl, n_frames_valid, n_samples)."""
    y = np.asarray(y, dtype=np.float32)
    if trim:
        y, _ = native.trim_silence(y, p.trim_frame_length, p.trim_hop_length,
                                   p.trim_top_db)
    n = len(y)
    half = p.n_fft // 2
    if n > 0:
        y_pre = ref_dsp.preemphasis(y, p.preemphasis)
        y_refl = np.pad(y_pre, half, mode="reflect")
    else:
        y_refl = np.zeros(2 * half, dtype=np.float32)
    return y_refl, (1 + n // p.hop_length if n > 0 else 0), n


def wav_to_mel_mag(y: np.ndarray, p: AudioParams = DEFAULT, trim: bool = True,
                   device=None):
    """unast_tpu/audio/dsp.py::wav_to_mel_mag: wav -> (mel [T, n_mels],
    mag [T, n_freqs], n_frames) on `device` (None = cuda). The trim,
    preemphasis and reflect padding run on the host; the signal is
    zero-padded to a length bucket and the rest runs on the device. The
    arrays are padded to the bucket's frame count; n_frames are valid."""
    dev = resolve_device(device)
    y_refl, n_frames_valid, n = _host_prep(np.asarray(y), p, trim)
    bucket = next(
        (int(b * p.sr) for b in _LENGTH_BUCKETS_S if n <= b * p.sr),
        ((n + p.sr - 1) // p.sr) * p.sr if n > 0 else p.sr,
    )
    half = p.n_fft // 2
    y_pad = np.zeros(bucket + 2 * half, dtype=np.float32)
    y_pad[:len(y_refl)] = y_refl
    mel, mag = _wav_to_mel_mag_core(torch.from_numpy(y_pad)[None].to(dev), p)
    return mel[0], mag[0], n_frames_valid


def wav_to_mel_mag_batch(wavs, p: AudioParams = DEFAULT, trim: bool = True,
                         bucket_s: float = 0.0, device=None):
    """unast_tpu/audio/dsp.py::wav_to_mel_mag_batch: wavs -> (mel [B, T,
    n_mels], mag [B, T, n_freqs] on `device` (None = cuda), n_frames [B]
    int32 on the host), one length bucket for the batch (its longest clip
    after the trim) and one batched pass. Each row equals wav_to_mel_mag
    of its clip over its valid frames. bucket_s > 0 pins that bucket for
    every call; a clip longer than it raises AssertionError, as in JAX."""
    dev = resolve_device(device)
    half = p.n_fft // 2
    prepped = [_host_prep(np.asarray(y), p, trim) for y in wavs]
    n_max = max(pp[2] for pp in prepped)
    if bucket_s > 0:
        assert n_max <= bucket_s * p.sr, (n_max, bucket_s)
        bucket = int(bucket_s * p.sr)
    else:
        bucket = next(
            (int(b * p.sr) for b in _LENGTH_BUCKETS_S if n_max <= b * p.sr),
            ((n_max + p.sr - 1) // p.sr) * p.sr if n_max > 0 else p.sr,
        )
    y_pad = np.zeros((len(prepped), bucket + 2 * half), dtype=np.float32)
    for i, (y_refl, _, _) in enumerate(prepped):
        y_pad[i, :len(y_refl)] = y_refl
    mel, mag = _wav_to_mel_mag_core(torch.from_numpy(y_pad).to(dev), p)
    return mel, mag, np.asarray([pp[1] for pp in prepped], np.int32)


def griffin_lim(spectrogram: torch.Tensor, p: AudioParams = DEFAULT) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::griffin_lim, batched: [B, T, n_freqs]
    magnitude -> [B, hop*(T-1)] waveform after p.n_iter ISTFT<->STFT rounds
    (fast Griffin-Lim when p.gl_momentum > 0)."""
    window = _consts(p, spectrogram.device).window
    n_frames = spectrogram.shape[1]
    m = p.gl_momentum / (1.0 + p.gl_momentum)
    spec_c = spectrogram.to(torch.complex64)
    x_best, est_prev = spec_c, torch.zeros_like(spec_c)
    for _ in range(p.n_iter):
        x_t = istft(x_best, p, window)
        est = stft(x_t, p, window)[:, :n_frames]
        est_m = est - m * est_prev
        phase = est_m / torch.clamp(est_m.abs(), min=1e-8)
        x_best, est_prev = spec_c * phase, est
    return istft(x_best, p, window)


def _mag_to_wav_core(mag: torch.Tensor, p: AudioParams) -> torch.Tensor:
    """unast_tpu/audio/dsp.py::_mag_to_wav_core, batched: normalized
    magnitude [B, T, n_freqs] -> de-emphasized waveform [B, hop*(T-1)]."""
    mag = torch.clamp(mag, 0.0, 1.0) * p.max_db - p.max_db + p.ref_db
    mag = torch.pow(10.0, mag * 0.05)
    wav = griffin_lim(mag ** p.power, p)
    return deemphasis(wav, p.preemphasis)


def mag_to_wav(mag, p: AudioParams = DEFAULT, trim: bool = True,
               device=None) -> np.ndarray:
    """unast_tpu/audio/dsp.py::mag_to_wav: normalized magnitude [T, n_freqs]
    -> waveform (np.float32) by _mag_to_wav_core on `device` (None = cuda),
    silence-trimmed on the host."""
    mag = torch.as_tensor(np.asarray(mag)).to(resolve_device(device))
    wav = _mag_to_wav_core(mag[None], p)[0].float().cpu().numpy()
    if trim:
        wav, _ = ref_dsp.trim_silence(wav, p)
    return wav


def mel_to_mag_pseudo_inverse(p: AudioParams = DEFAULT) -> np.ndarray:
    """unast_tpu/audio/dsp.py::mel_to_mag_pseudo_inverse: (n_mels, n_freqs)
    least-squares pseudo-inverse of the mel filterbank."""
    w = mel_filterbank(p.sr, p.n_fft, p.num_mels)
    return np.linalg.pinv(w).T.astype(np.float32)
