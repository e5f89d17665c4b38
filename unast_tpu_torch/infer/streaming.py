"""Streaming TTS and ASR of the port, mirroring
`unast_tpu/infer/streaming.py`.

MelganStreamer: the neural vocoders (models/melgan.py) are fully
convolutional, so output chunk [t0, t1) depends only on mel frames
[t0 - R, t1 + R) for a receptive field R. Vocoding a context window and
keeping its interior reproduces the whole forward, provided each window
edge lies >= R frames inside the sequence or on the sequence's true edge
(zero-padding beyond the sequence would feed the biases' activations the
whole forward never sees); so windows are truncated at the sequence's
boundaries, giving at most three window shapes (first / interior / last).
Contract: the concatenated chunks equal generator_forward(mel zero-padded
to a chunk multiple) cut to T*hop samples.

StreamingCtcAsr: online CTC ASR over a chunk-masked model
(models/ctc.py::ctc_stream_step), one encoder pass per chunk with
per-layer K/V caches of the last cfg.ctc_left chunks; the emitted tokens
equal the one-shot greedy transcript of the same model.

stream_tts: a Synthesizer's one-pass mel (nar_pv) through the streamer.
"""

from typing import Iterator

import numpy as np
import torch

from .. import nn
from ..models import ctc as CT
from ..models import melgan as G
from ..train.optim import tree_leaves


class MelganStreamer:
    """unast_tpu/infer/streaming.py::MelganStreamer: chunked mel -> wav.
    Each step vocodes a boundary-truncated context window on the params'
    device and yields its interior chunk*hop samples."""

    def __init__(self, params, hop: int, chunk: int = 32, ctx: int = None,
                 n_mels: int = 80):
        self.params = params
        self.hop = hop
        self.chunk = chunk
        self.ctx = G.receptive_field(params) if ctx is None else ctx
        self.n_mels = n_mels
        self.device = tree_leaves(params)[0].device

    def _fn(self, win: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            wav = G.generator_forward(
                self.params, torch.from_numpy(win).to(self.device))[0]
            return wav.float().cpu().numpy()

    def warm(self, t_total: int = None):
        """unast_tpu/infer/streaming.py::MelganStreamer.warm: one call at
        each of the three window shapes (cuDNN picks its algorithms)."""
        c, x = self.chunk, self.ctx
        for w in {c, c + x, c + 2 * x}:
            self._fn(np.zeros((1, w, self.n_mels), np.float32))

    def stream(self, mel) -> Iterator[np.ndarray]:
        """unast_tpu/infer/streaming.py::MelganStreamer.stream: mel
        [T, n_mels] -> float32 chunks whose concatenation is
        generator_forward(mel zero-padded to a chunk multiple)[: T*hop]."""
        mel = np.asarray(mel, np.float32)
        t_total = mel.shape[0]
        t_pad = -(-t_total // self.chunk) * self.chunk
        padded = np.zeros((t_pad, self.n_mels), np.float32)
        padded[:t_total] = mel
        emitted = 0
        for t0 in range(0, t_pad, self.chunk):
            t1 = t0 + self.chunk
            a = max(0, t0 - self.ctx)
            b = min(t_pad, t1 + self.ctx)
            wav = self._fn(padded[None, a:b])
            lo = (t0 - a) * self.hop
            out = wav[lo:lo + self.chunk * self.hop]
            take = min(len(out), t_total * self.hop - emitted)
            if take <= 0:
                break
            emitted += take
            yield out[:take]


class StreamingCtcAsr:
    """unast_tpu/infer/streaming.py::StreamingCtcAsr: online CTC ASR over
    a chunk-masked model (cfg.ctc_chunk > 0, ctc_left >= 0).

        s = StreamingCtcAsr(params, cfg).reset(batch_size=1)
        for mel_chunk in feed:           # [B, <=chunk, n_mels]
            new_ids = s.step(mel_chunk)  # the newly decoded tokens per row
        transcript = s.emitted[0]
    """

    def __init__(self, params, cfg):
        assert cfg.ctc_chunk > 0 and cfg.ctc_left >= 0, (
            "StreamingCtcAsr needs a chunk-masked model "
            "(cfg.ctc_chunk > 0, ctc_left >= 0)")
        self.params = params
        self.cfg = cfg
        self.device = tree_leaves(params)[0].device

    def reset(self, batch_size: int = 1):
        """Start new streams: empty caches and transcripts."""
        self.carry = CT.ctc_stream_init(self.params, self.cfg, batch_size,
                                        self.device)
        self._prev = np.full((batch_size,), -1, np.int64)
        self.emitted = [[] for _ in range(batch_size)]
        return self

    def _step(self, mel_chunk: np.ndarray, valid: np.ndarray):
        with torch.inference_mode():
            carry, _, tok = CT.ctc_stream_step(
                self.params, nn.Ctx.eval(), self.cfg, self.carry,
                torch.from_numpy(mel_chunk).to(self.device),
                torch.from_numpy(valid).to(self.device))
        return carry, tok.cpu().numpy()

    def warm(self):
        """One step on zeros at the reset batch size, its carry dropped."""
        b = self._prev.shape[0]
        c, nm = self.cfg.ctc_chunk, self.cfg.num_mels
        self._step(np.zeros((b, c, nm), np.float32), np.zeros((b, c), bool))
        return self

    def step(self, mel_chunk, n_valid=None):
        """unast_tpu/infer/streaming.py::StreamingCtcAsr.step: feed
        [B, t, n_mels] with t <= cfg.ctc_chunk (a short chunk is
        zero-padded and masked); n_valid: optional [B] valid frame counts.
        Returns the newly emitted ids per row; `emitted` accumulates the
        transcripts, capped at cfg.max_text_len."""
        mel_chunk = np.asarray(mel_chunk, np.float32)
        b, t = mel_chunk.shape[:2]
        c = self.cfg.ctc_chunk
        assert t <= c, (t, c)
        if n_valid is None:
            n_valid = np.full((b,), t, np.int64)
        if t < c:
            mel_chunk = np.pad(mel_chunk, ((0, 0), (0, c - t), (0, 0)))
        valid = np.arange(c)[None, :] < np.asarray(n_valid)[:, None]
        self.carry, tok = self._step(mel_chunk, valid)
        new = [[] for _ in range(b)]
        cap = self.cfg.max_text_len
        for i in range(b):
            for f in range(int(n_valid[i])):
                k = tok[i, f]
                if (k != CT.BLANK_ID and k != self._prev[i]
                        and len(self.emitted[i]) < cap):
                    new[i].append(int(k))
                    self.emitted[i].append(int(k))
                self._prev[i] = k
        return new


def stream_tts(syn, text: str, chunk: int = 32,
               ctx: int = None) -> Iterator[np.ndarray]:
    """unast_tpu/infer/streaming.py::stream_tts: a Synthesizer with
    melgan_params (and nar_pv for the one-pass mel) -> waveform chunks of
    `text`; the first is ready after the mel pass and one vocoder window."""
    if syn.melgan_params is None:
        raise ValueError("stream_tts needs Synthesizer(melgan_params=...)")
    mel = syn.tts_mels([text])[0]
    streamer = MelganStreamer(syn.melgan_params, syn.audio_params.hop_length,
                              chunk=chunk, ctx=ctx)
    yield from streamer.stream(mel)
