"""Host helpers of the port in numpy, the counterpart of
`unast_tpu/native/__init__.py` (whose C++ library native/unast_native.cpp
the port does not load): the PCM16 WAV decode, the silence trim on float
or int16 samples, the single-call batch collate from a packed shard
(data/shard.py) and preemphasis. Each gives what the C++ path gives: the
same samples, bounds and batches, float for float. The batch Levenshtein
distance is infer/metrics.py::levenshtein_batch."""

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np


def read_wav(path: str, expect_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """unast_tpu/native/__init__.py::read_wav (C++ read_wav_pcm16): a
    PCM16 WAV -> (float32 samples in [-1, 1], sample_rate). The RIFF
    chunks are walked as the C++ reader walks them (the fmt chunk's extra
    bytes skipped, odd chunks padded); stereo and wider frames are the
    float32 sum of their channels times 1/32768 over the channel count."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise IOError(f"cannot decode {path}")
    pos, channels, sr = 12, 1, 0
    while pos + 8 <= len(data):
        cid, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        pos += 8
        if cid == b"fmt ":
            fmt, channels, sr = struct.unpack_from("<HHI", data, pos)
            bits = struct.unpack_from("<H", data, pos + 14)[0]
            if fmt != 1 or bits != 16:
                raise IOError(f"cannot decode {path}")
            pos += size
        elif cid == b"data":
            frames = size // (2 * channels)
            raw = data[pos:pos + frames * 2 * channels]
            frames = len(raw) // (2 * channels)
            pcm = np.frombuffer(raw[:frames * 2 * channels], "<i2")
            scale = np.float32(1.0 / 32768.0)
            if channels == 1:
                out = pcm.astype(np.float32) * scale
            else:
                frames_ch = pcm.reshape(frames, channels).astype(np.float32)
                acc = frames_ch[:, 0].copy()
                for c in range(1, channels):
                    acc += frames_ch[:, c]
                out = acc * scale / np.float32(channels)
            if expect_sr is not None and sr != expect_sr:
                raise ValueError(f"{path}: sr {sr} != {expect_sr}")
            return out, int(sr)
        else:
            pos += size + (size & 1)
    raise IOError(f"cannot decode {path}")


def _trim_bounds(y2: np.ndarray, n: int, frame_length: int, hop: int,
                 top_db: float) -> Tuple[int, int]:
    """The C++ trim_silence_bounds on the squared samples y2 (float64):
    centred RMS frames of frame_length, each a running sum from its first
    in-range sample (np.cumsum adds in the C++ loop's order), over
    frame_length; frames within top_db of the loudest are kept."""
    if n == 0:
        return 0, n
    pad = frame_length // 2
    n_frames = 1 + ((n + 2 * pad) - frame_length) // hop
    padded = np.concatenate([np.zeros(pad), y2, np.zeros(pad)])
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n_frames)[:, None]
    mse = np.cumsum(padded[idx], axis=1)[:, -1] / frame_length
    max_mse = max(float(mse.max()), 1e-10)
    db = 10.0 * np.log10(np.maximum(mse, 1e-10) / max_mse)
    keep = np.flatnonzero(db > -top_db)
    if len(keep) == 0:
        return 0, 0
    return int(keep[0]) * hop, min(n, (int(keep[-1]) + 1) * hop)


def trim_silence(y: np.ndarray, frame_length: int = 2048, hop: int = 512,
                 top_db: float = 60.0):
    """unast_tpu/native/__init__.py::trim_silence (C++
    trim_silence_bounds; librosa.effects.trim semantics). Returns
    (trimmed, (start, end))."""
    y = np.ascontiguousarray(y, np.float32)
    s, e = _trim_bounds(y.astype(np.float64) ** 2, len(y), frame_length, hop,
                        top_db)
    return y[s:e], (s, e)


def trim_silence_i16(y: np.ndarray, frame_length: int = 2048,
                     hop: int = 512, top_db: float = 60.0):
    """unast_tpu/native/__init__.py::trim_silence_i16 (C++
    trim_silence_bounds_i16): the trim on PCM16 samples, each scaled by
    1/32767 in float64 as the C++ loop does. Returns (trimmed int16,
    (start, end))."""
    y = np.ascontiguousarray(y, np.int16)
    s, e = _trim_bounds((y.astype(np.float64) / 32767.0) ** 2, len(y),
                        frame_length, hop, top_db)
    return y[s:e], (s, e)


class ShardHandle(NamedTuple):
    """An open packed shard (data/shard.py's format): its bytes, mapped,
    the [n_items, 4] index and the mel width."""

    mm: np.ndarray
    index: np.ndarray
    n_mels: int


def shard_open(path: str) -> Optional[ShardHandle]:
    """unast_tpu/native/__init__.py::shard_open: map a packed shard and
    check its index against its size, or None where the C++ reader
    refuses it (bad magic or version, truncated, n_mels <= 0)."""
    mm = np.memmap(path, np.uint8, mode="r")
    if len(mm) < 24 or bytes(mm[:4]) != b"UNSH":
        return None
    version, n, n_mels = struct.unpack("<IQI", bytes(mm[4:20]))
    if version != 1 or n_mels <= 0 or 24 + n * 32 > len(mm):
        return None
    index = np.frombuffer(mm[24:24 + n * 32], np.uint64).reshape(n, 4)
    size = np.uint64(len(mm))
    if n and ((index[:, 0] + index[:, 1] * np.uint64(4) > size).any()
              or (index[:, 2] + index[:, 3] * np.uint64(2 * n_mels) > size).any()):
        return None
    return ShardHandle(mm, index, int(n_mels))


def shard_collate(h: Optional[ShardHandle], idx: np.ndarray, text_cap: int,
                  mel_cap: int, n_mels: int):
    """unast_tpu/native/__init__.py::shard_collate (C++ shard_collate):
    (text [B, text_cap] int32, mel [B, mel_cap, n_mels] float32 from the
    stored float16, text_len, mel_len), padded and truncated as
    data/batching.py::collate does; None without a handle."""
    if h is None:
        return None
    idx = np.ascontiguousarray(idx, np.int64)
    b = len(idx)
    text = np.zeros((b, text_cap), np.int32)
    mel = np.zeros((b, mel_cap, n_mels), np.float32)
    tl = np.zeros((b,), np.int32)
    ml = np.zeros((b,), np.int32)
    for j, i in enumerate(idx):
        off, tn, moff, mf = (int(v) for v in h.index[i])
        t, m = min(tn, text_cap), min(mf, mel_cap)
        text[j, :t] = np.frombuffer(h.mm[off:off + 4 * t], "<i4")
        mel[j, :m] = np.frombuffer(h.mm[moff:moff + 2 * m * n_mels],
                                   "<f2").reshape(m, n_mels)
        tl[j], ml[j] = t, m
    return text, mel, tl, ml


def preemphasis(y: np.ndarray, coef: float = 0.97) -> np.ndarray:
    """unast_tpu/native/__init__.py::preemphasis (C++ preemphasis): out[0]
    = y[0], out[t] = y[t] - coef * y[t-1], rounded once to float32 as the
    library's fused multiply-add does (it is built for the host's CPU):
    the float32 product is exact in float64."""
    y = np.ascontiguousarray(y, np.float32)
    if len(y) == 0:
        return y.copy()
    c = np.float64(np.float32(coef))
    return np.concatenate([y[:1], (y[1:].astype(np.float64)
                                   - c * y[:-1]).astype(np.float32)])
