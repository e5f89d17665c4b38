"""Audio DSP of the port (counterpart of unast_tpu/audio)."""

from .params import AudioParams, DEFAULT
from .filters import mel_filterbank, hann_window, hz_to_mel, mel_to_hz
from .dsp import (
    stft, istft, frame_signal, overlap_add, preemphasis, deemphasis,
    wav_to_mel_mag, wav_to_mel_mag_batch, griffin_lim,
    mel_to_mag_pseudo_inverse,
)
from . import ref_dsp

__all__ = [
    "AudioParams", "DEFAULT", "mel_filterbank", "hann_window", "hz_to_mel",
    "mel_to_hz", "stft", "istft", "frame_signal", "overlap_add",
    "preemphasis", "deemphasis", "wav_to_mel_mag", "wav_to_mel_mag_batch",
    "griffin_lim",
    "mel_to_mag_pseudo_inverse", "ref_dsp",
]
