"""Batch serving API of the port, mirroring `unast_tpu/infer/serve.py`:

    syn = Synthesizer(params, net_state, cfg)          # device defaults to cuda
    wavs = syn.tts(["hello world", ...])               # list of np wavs
    texts = syn.asr([wav1, wav2])                      # list of strings

Requests are padded into fixed text/mel buckets, decoded greedily with the
KV-cached loops (models/networks.py), and vocoded with the mel
pseudo-inverse lift and batched Griffin-Lim, all on the device. The
options of the JAX Synthesizer that this slice does not port raise
NotImplementedError.
"""

from typing import List, Sequence

import numpy as np
import torch

from .. import nn
from ..audio import dsp, ref_dsp
from ..audio.params import DEFAULT as AUDIO_DEFAULT
from ..device import resolve_device
from ..models import unast as U
from ..models.config import ModelConfig
from ..text import raw_text_to_phoneme_ids, sequence_to_text
from ..text.symbols import symbols


def _not_ported(what: str, slice_name: str):
    raise NotImplementedError(
        f"Synthesizer {what} is not in the serving slice of the port; it "
        f"comes with the {slice_name} (ROADMAP.md queue 1)")


class Synthesizer:
    """Batched text->wav / mel->text endpoints
    (unast_tpu/infer/serve.py::Synthesizer)."""

    def __init__(self, params, net_state, cfg: ModelConfig,
                 vocoder_pv=None, audio_params=AUDIO_DEFAULT,
                 text_buckets: Sequence[int] = (32, 64, 128, 304),
                 mel_buckets: Sequence[int] = (256, 512, 816),
                 max_batch: int = 8, mesh=None, quantize: str = None,
                 nar_pv=None, melgan_params=None, ctc_pv=None,
                 melgan_chunk=None, pcm16: bool = False, device=None):
        """params / net_state: the port's trees (bridge.params_from_jax
        converts JAX ones). device: None means cuda, and raises when there
        is no CUDA device; tests pass device='cpu'."""
        unported = [
            ("mesh", mesh is not None, "multi-device slice"),
            ("quantize", quantize is not None, "int8 quantization slice"),
            ("nar_pv", nar_pv is not None, "one-pass families slice"),
            ("melgan_params", melgan_params is not None,
             "one-pass families slice"),
            ("ctc_pv", ctc_pv is not None, "one-pass families slice"),
            ("melgan_chunk", melgan_chunk is not None,
             "one-pass families slice"),
            ("vocoder_pv", vocoder_pv is not None, "RNN/CBHG vocoder slice"),
            ("pcm16", pcm16, "one-pass families slice"),
            ("model_type='rnn'", cfg.model_type != "transformer",
             "RNN backbone slice"),
        ]
        for what, given, slice_name in unported:
            if given:
                _not_ported(what, slice_name)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.audio_params = audio_params
        # clamp (not drop) buckets above the model caps, so long requests
        # still get the full-capacity bucket
        self.text_buckets = sorted({min(b, cfg.max_text_len)
                                    for b in text_buckets})
        self.mel_buckets = sorted({min(b, cfg.max_mel_len)
                                   for b in mel_buckets})
        self.max_batch = max_batch
        # Weights are cast to the activation dtype once here; the nn apply
        # functions would cast them at every use with the same rounding.
        self.params = nn.tree_to(nn.cast_weights(params, cfg.dtype), self.device)
        self.net_state = nn.tree_to(net_state, self.device)
        self._lift = torch.from_numpy(
            dsp.mel_to_mag_pseudo_inverse(audio_params)).to(self.device)
        # decode steps of the last tts/asr call, one entry per batch chunk
        self.last_decode_steps: List[int] = []

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, args, **kw):
        """unast_tpu/infer/serve.py::Synthesizer.from_checkpoint: a
        Synthesizer on the params and BN state of a train/checkpoint.py
        checkpoint (a save directory means its model_best.ckpt), for the
        model of the flat config namespace `args` (train/config.py). The
        device is kw's, else args.device."""
        from ..train.checkpoint import load_ckp
        from ..train.config import model_config_from_args
        from ..train.steps import init_train_state
        cfg = model_config_from_args(args)
        kw.setdefault("device", getattr(args, "device", None))
        template = init_train_state(torch.Generator().manual_seed(0), cfg, args,
                                    kw["device"])
        _, _, ts, _ = load_ckp(ckpt_path, template)
        return cls(ts.params, ts.net_state, cfg, **kw)

    def _bucket(self, buckets, need):
        """unast_tpu/infer/serve.py::Synthesizer._bucket: the smallest
        bucket that fits `need`, else the largest."""
        for b in buckets:
            if need <= b:
                return b
        return buckets[-1]

    # -- TTS -----------------------------------------------------------------

    def _tts_chunk_seqs(self, seqs):
        """unast_tpu/infer/serve.py::Synthesizer._tts_chunk_seqs: phoneme-id
        arrays (at most max_batch) -> (post [n, Tcap, n_mels] on the device,
        stop_lens np, n)."""
        n = len(seqs)
        tl = self._bucket(self.text_buckets, max(len(s) for s in seqs))
        ids = np.zeros((n, tl), np.int64)
        lens = np.zeros((n,), np.int64)
        for i, s in enumerate(seqs):
            s = s[:tl]
            ids[i, :len(s)] = s
            lens[i] = len(s)
        with torch.inference_mode():
            (_, post, _, stop_lens), _ = U.tts(
                self.params, self.net_state, nn.Ctx.eval(), self.cfg,
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(lens).to(self.device), infer=True)
        stop_lens = stop_lens.cpu().numpy()
        r = self.cfg.reduction_factor
        self.last_decode_steps.append(int(-(-stop_lens.max() // r)))
        return post, stop_lens, n

    def tts_mels(self, texts: List[str]):
        """unast_tpu/infer/serve.py::Synthesizer.tts_mels: texts -> list of
        (mel [T, n_mels] np.float32)."""
        self.last_decode_steps = []
        out = []
        for start in range(0, len(texts), self.max_batch):
            post, stop_lens, n = self._tts_chunk_seqs(
                [np.asarray(raw_text_to_phoneme_ids(t), np.int64)
                 for t in texts[start:start + self.max_batch]])
            post = post.float().cpu().numpy()
            out.extend(post[i, :stop_lens[i]] for i in range(n))
        return out

    def tts(self, texts: List[str]):
        """unast_tpu/infer/serve.py::Synthesizer.tts: texts -> list of
        waveforms (np.float32). Vocoding (pseudo-inverse lift, then Griffin-Lim) runs batched at a
        fixed mel bucket per chunk; each waveform is then cut at its stop
        length and silence-trimmed on the host."""
        return self._tts_wavs_from_seqs(
            [np.asarray(raw_text_to_phoneme_ids(t), np.int64) for t in texts])

    def tts_long(self, text: str, pause_s: float = 0.1):
        """Unbounded-length text -> one waveform: split at word boundaries
        into segments within max_text_len, synthesized as one batch and
        joined with `pause_s` of silence (unast_tpu/infer/serve.py::
        Synthesizer.tts_long)."""
        space = symbols.index(" ")
        ids = raw_text_to_phoneme_ids(text)
        cap = self.cfg.max_text_len
        segs, cur = [], []
        for tok in ids:
            cur.append(tok)
            if len(cur) >= cap:
                try:
                    cut = len(cur) - 1 - cur[::-1].index(space)
                except ValueError:
                    cut = len(cur)  # no space: hard split at the cap
                head, cur = cur[:cut], [t for t in cur[cut:] if t != space]
                if head:
                    segs.append(head)
        if cur:
            segs.append(cur)
        wavs = self._tts_wavs_from_seqs([np.asarray(s, np.int64) for s in segs])
        if len(wavs) == 1:
            return wavs[0]
        gap = np.zeros(int(pause_s * self.audio_params.sr), np.float32)
        out = []
        for i, w in enumerate(wavs):
            if i:
                out.append(gap)
            out.append(w)
        return np.concatenate(out)

    def _vocode(self, mel_b: torch.Tensor) -> torch.Tensor:
        """The lift vocoder of unast_tpu/infer/serve.py::Synthesizer (its
        _vocode_fn): [rows, T, n_mels] -> [rows, hop*(T-1)] waveforms by the
        float32 lift
        mel_b @ lift (a bf16 mel is cast first; torch does not promote
        bf16 @ f32 the way jnp does), clip, batched Griffin-Lim."""
        mag = torch.clamp(mel_b.float() @ self._lift, 1e-8, 1.0)
        return dsp._mag_to_wav_core(mag, self.audio_params)

    def _tts_wavs_from_seqs(self, seqs):
        """unast_tpu/infer/serve.py::Synthesizer._tts_wavs_from_seqs:
        phoneme-id sequences -> trimmed waveforms, max_batch at a time."""
        p = self.audio_params
        self.last_decode_steps = []
        out = []
        for start in range(0, len(seqs), self.max_batch):
            post, stop_lens, n = self._tts_chunk_seqs(
                seqs[start:start + self.max_batch])
            tb = self._bucket(self.mel_buckets, max(1, int(stop_lens[:n].max())))
            with torch.inference_mode():
                wavs = self._vocode(post[:, :tb]).cpu().numpy()
            for i in range(n):
                # stop_lens counts the stop-fired frame; the cut excludes it
                frames = int(stop_lens[i]) - 1
                w, _ = ref_dsp.trim_silence(
                    wavs[i, :p.hop_length * max(1, frames)], p)
                out.append(w)
        return out

    # -- ASR -----------------------------------------------------------------

    def asr_ids(self, mels: List[np.ndarray], beam: int = 1,
                ctc_beam: int = 1, spec: bool = False):
        """unast_tpu/infer/serve.py::Synthesizer.asr_ids: mels (list of
        [T, n_mels]) -> list of phoneme-id np arrays, greedy (beam 1)."""
        if beam > 1:
            _not_ported("beam > 1", "one-pass families slice")
        if ctc_beam > 1:
            _not_ported("ctc_beam > 1", "one-pass families slice")
        if spec:
            _not_ported("spec=True", "one-pass families slice")
        self.last_decode_steps = []
        out = []
        for start in range(0, len(mels), self.max_batch):
            chunk = mels[start:start + self.max_batch]
            n = len(chunk)
            ml = self._bucket(self.mel_buckets, max(len(m) for m in chunk))
            mel = np.zeros((n, ml, self.cfg.num_mels), np.float32)
            lens = np.zeros((n,), np.int64)
            for i, m in enumerate(chunk):
                m = np.asarray(m, np.float32)[:ml]
                mel[i, :len(m)] = m
                lens[i] = len(m)
            with torch.inference_mode():
                (ids, stop_lens), _ = U.asr(
                    self.params, self.net_state, nn.Ctx.eval(), self.cfg,
                    mel=torch.from_numpy(mel).to(self.device),
                    mel_len=torch.from_numpy(lens).to(self.device), infer=True)
            ids = ids.cpu().numpy()
            stop_lens = stop_lens.cpu().numpy()
            self.last_decode_steps.append(int(stop_lens.max()))
            out.extend(ids[i, :stop_lens[i]] for i in range(n))
        return out

    def asr(self, wavs: List[np.ndarray], beam: int = 1):
        """unast_tpu/infer/serve.py::Synthesizer.asr: waveforms -> decoded
        text strings (mels on the device)."""
        mels = []
        for wav in wavs:
            mel, _, n = dsp.wav_to_mel_mag(np.asarray(wav, np.float32),
                                           self.audio_params,
                                           device=self.device)
            mels.append(mel[:n].cpu().numpy())
        return [sequence_to_text(ids.tolist())
                for ids in self.asr_ids(mels, beam=beam)]

    def warmup(self):
        """unast_tpu/infer/serve.py::Synthesizer.warmup: one dummy request
        per bucket, so the first real request finds the device's libraries
        (cuBLAS, cuFFT plans) loaded."""
        with torch.inference_mode():
            for tb in self.text_buckets:
                U.tts(self.params, self.net_state, nn.Ctx.eval(), self.cfg,
                      torch.ones((1, tb), dtype=torch.long, device=self.device),
                      torch.full((1,), tb, dtype=torch.long, device=self.device),
                      infer=True)
            for mb in self.mel_buckets:
                U.asr(self.params, self.net_state, nn.Ctx.eval(), self.cfg,
                      mel=torch.zeros((1, mb, self.cfg.num_mels),
                                      device=self.device),
                      mel_len=torch.full((1,), mb, dtype=torch.long,
                                         device=self.device), infer=True)
            self._vocode(torch.zeros((1, self.mel_buckets[0],
                                      self.cfg.num_mels), device=self.device))
