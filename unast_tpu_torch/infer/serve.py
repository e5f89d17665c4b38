"""Batch serving API of the port, mirroring `unast_tpu/infer/serve.py`:

    syn = Synthesizer(params, net_state, cfg)          # device defaults to cuda
    wavs = syn.tts(["hello world", ...])               # list of np wavs
    texts = syn.asr([wav1, wav2])                      # list of strings

Requests are padded into fixed text/mel buckets. TTS mels come from the
AR model's greedy decode (models/networks.py: the KV-cached transformer
loops or the RNN loops) or, with `nar_pv`, from a distilled FastSpeech
student in one pass (models/fastspeech.py). Waveforms come from a neural
vocoder (`melgan_params`: MelGAN or HiFi-GAN, models/melgan.py, over the
whole bucket or in exact context windows of `melgan_chunk` frames), else
from the CBHG vocoder's magnitudes (`vocoder_pv`) or the mel
pseudo-inverse lift through batched Griffin-Lim, all on the device;
`pcm16` quantises them to int16 there. ASR can also run through a CTC
model (`ctc_pv`): one-pass greedy, prefix beam search over its posteriors
(`ctc_beam`), or as the draft of the AR decoder's speculative decode
(`spec`); `beam` runs the AR beam search. `quantize='int8'` serves int8
weight-only copies of the weights (nn/quant.py), dequantized at every use.
With `mesh` (parallel/mesh.py::make_mesh, one rank per device) every rank
serves its 1/dp share of each request batch with replicated weights and
the results are gathered, so every rank returns the whole batch.
"""

from typing import List, Sequence

import numpy as np
import torch

from .. import native, nn
from ..nn import quant as Q
from ..audio import dsp
from ..audio.params import DEFAULT as AUDIO_DEFAULT
from ..device import resolve_device
from ..models import ctc as CT, fastspeech as FS, melgan as MG, networks as N
from ..models import unast as U
from ..models.config import ModelConfig
from ..text import raw_text_to_phoneme_ids, sequence_to_text
from ..text.symbols import symbols


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
        converts JAX ones). vocoder_pv: optional (params, state) of a
        trained CBHG vocoder (infer/vocoder.py; bridge.vocoder_from_jax):
        the magnitudes then come from it instead of the pseudo-inverse
        lift. ctc_pv: optional (params, state) of a CTC model
        (models/ctc.py, the same cfg; train/ctc.py, bridge.ctc_from_jax):
        asr_ids then decodes through it. nar_pv: optional (params, state)
        of a FastSpeech student (models/fastspeech.py, the same cfg;
        train/fastspeech.py, bridge.fastspeech_from_jax): TTS mels then
        come from its one pass (the AR trees still serve ASR).
        melgan_params: optional MelGAN or HiFi-GAN generator params
        (models/melgan.py; train/melgan.py, bridge.melgan_from_jax): it
        then vocodes, ahead of vocoder_pv and the lift. melgan_chunk: the
        generator runs over exact context windows of this many frames
        (None: only when a bucket holds more than _MELGAN_AUTO_FRAMES
        frames in all; 0: never). pcm16: waveforms are quantised to int16
        on the device and tts() returns int16 arrays. quantize: None, or
        'int8' to quantize params, vocoder_pv's and nar_pv's params
        (nn/quant.py::quantize_params; any other value raises ValueError);
        the int8 leaves stay int8 on the device and nn.weight dequantizes
        them in cfg.dtype at every use. device: None means
        cuda, and raises when there is no CUDA device; tests pass
        device='cpu'. mesh: None, or a dp mesh (parallel/mesh.py::
        make_mesh) over ranks that all make this Synthesizer with the same
        weights and all make the same calls: each rank serves its 1/dp
        share of every request batch on its device, a short batch padded
        by repeating its last request, and the results are gathered in
        order (unast_tpu/infer/serve.py's sharded batches); max_batch must
        divide over dp (ValueError)."""
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import dp_group, dp_rank, dp_size
            from ..parallel.mesh import axis_size
            if axis_size(mesh, "tp") > 1 or axis_size(mesh, "ep") > 1:
                raise ValueError("Synthesizer(mesh=) shards the request "
                                 "batch over 'dp' only, as JAX's does")
            self._dp = (dp_group(mesh), dp_rank(mesh), dp_size(mesh))
            if max_batch % self._dp[2]:
                raise ValueError(f"max_batch {max_batch} must divide over "
                                 f"dp={self._dp[2]}")
        if quantize is not None:
            # int8 weight-only (nn/quant.py), as JAX: the AR params, the
            # CBHG vocoder's and the FastSpeech student's, nothing else
            if quantize != "int8":
                raise ValueError(f"quantize must be 'int8' or None, got "
                                 f"{quantize!r}")
            params = Q.quantize_params(params)
            if vocoder_pv is not None:
                vocoder_pv = (Q.quantize_params(vocoder_pv[0]), vocoder_pv[1])
            if nar_pv is not None:
                nar_pv = (Q.quantize_params(nar_pv[0]), nar_pv[1])
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
        self.ctc_pv = self.vocoder_pv = self.nar_pv = None
        if ctc_pv is not None:
            self.ctc_pv = self._place(ctc_pv)
        if vocoder_pv is not None:
            self.vocoder_pv = self._place(vocoder_pv)
        if nar_pv is not None:
            # kept float32: its pitch and energy conditionings take float32
            # inputs, whose weights JAX does not round to cfg.dtype
            self.nar_pv = nn.tree_to(tuple(nar_pv), self.device)
        # the generator's weights stay float32 and are cast to the mel's
        # dtype at use, as in JAX (stream_tts feeds it float32 mels)
        self.melgan_params = (None if melgan_params is None
                              else nn.tree_to(melgan_params, self.device))
        self.melgan_chunk = melgan_chunk
        self.pcm16 = bool(pcm16)
        self._lift = torch.from_numpy(
            dsp.mel_to_mag_pseudo_inverse(audio_params)).to(self.device)
        # decode steps of the last tts/asr call, one entry per batch chunk
        self.last_decode_steps: List[int] = []

    def _sharded(self, fn, *rows):
        """fn(*rows) over the request rows (tensors [n, ...]); with a mesh,
        this rank's share of them (rows padded to a multiple of dp by
        repeating the last one), the tensor outputs gathered over the
        ranks in row order and cut back to n rows (unast_tpu/infer/
        serve.py::Synthesizer._pad_chunk and _place)."""
        if self.mesh is None:
            return fn(*rows)
        from ..parallel import collectives as C
        group, rank, dp = self._dp
        n = rows[0].shape[0]
        k = -(-n // dp)
        idx = torch.clamp(torch.arange(rank * k, (rank + 1) * k), max=n - 1)
        if self.cfg.moe_experts > 0 and self.cfg.moe_impl == "dispatch":
            # the MoE dispatch groups the padded global batch's tokens, as
            # JAX's sharded encoder does (models/moe.py), so it needs the
            # dp group. Every other path runs without it: its rows are
            # independent, and under the group each decode's stop check
            # (collectives.any_rank) would all-reduce at every step and
            # run every rank's loop to the slowest rank's length.
            with C.data_parallel(group):
                out = fn(*(r[idx.to(r.device)] for r in rows))
        else:
            out = fn(*(r[idx.to(r.device)] for r in rows))
        return tuple(C.all_gather(o, group)[:n] if torch.is_tensor(o) else o
                     for o in out)

    def _place(self, pv):
        """(params, state) on the device, the weights cast to cfg.dtype."""
        return (nn.tree_to(nn.cast_weights(pv[0], self.cfg.dtype), self.device),
                nn.tree_to(pv[1], self.device))

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
            post, stop_lens = self._sharded(
                self._tts_impl, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(lens).to(self.device))
        stop_lens = stop_lens.cpu().numpy()
        if self.nar_pv is None:
            r = self.cfg.reduction_factor
            self.last_decode_steps.append(int(-(-stop_lens.max() // r)))
        return post, stop_lens, n

    def _tts_impl(self, ids, lens):
        """unast_tpu/infer/serve.py::Synthesizer._tts_impl: the AR model's
        greedy mel decode -> (post, stop_lens); with nar_pv _nar_tts_impl's
        one pass."""
        if self.nar_pv is not None:
            return self._nar_tts_impl(ids, lens)
        (_, post, _, stop_lens), _ = U.tts(
            self.params, self.net_state, nn.Ctx.eval(), self.cfg, ids, lens,
            infer=True)
        return post, stop_lens

    def _nar_tts_impl(self, ids, lens):
        """unast_tpu/infer/serve.py::Synthesizer._nar_tts_impl: the
        FastSpeech student's one pass at max_mel_len frames -> (post,
        out_lens); out_lens counts every frame (no stop frame)."""
        (_, post, out_lens, _), _ = FS.fastspeech_forward(
            *self.nar_pv, nn.Ctx.eval(), self.cfg, ids, lens,
            max_len=self.cfg.max_mel_len)
        return post, out_lens

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
        waveforms (np.float32; np.int16 with pcm16). Vocoding (the neural
        vocoder, else the CBHG vocoder or pseudo-inverse lift then
        Griffin-Lim) runs batched at a fixed mel bucket per chunk; each
        waveform is then cut at its frame count and silence-trimmed on
        the host."""
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

    def _out(self, w: torch.Tensor) -> torch.Tensor:
        """unast_tpu/infer/serve.py::Synthesizer's _out_op: with pcm16,
        round(clip(w, -1, 1) * 32767) as int16 on the device, in w's
        dtype as JAX computes it; else w."""
        if not self.pcm16:
            return w
        return torch.round(torch.clamp(w, -1.0, 1.0) * 32767.0).to(torch.int16)

    def _vocode(self, mel_b: torch.Tensor) -> torch.Tensor:
        """unast_tpu/infer/serve.py::Synthesizer's _vocode_fn: [rows, T,
        n_mels] -> waveforms, through _out. With melgan_params the
        generator ([rows, T*hop], _melgan_vocode); else with vocoder_pv
        the CBHG vocoder (eval mode, in the mel's dtype) gives the
        magnitudes, or the float32 lift mel_b @ lift (a bf16 mel is cast
        first; torch does not promote bf16 @ f32 the way jnp does), then
        clip to [1e-8, 1] and batched Griffin-Lim ([rows, hop*(T-1)])."""
        if self.melgan_params is not None:
            return self._melgan_vocode(mel_b)
        if self.vocoder_pv is not None:
            mag, _ = U.vocoder(*self.vocoder_pv, nn.Ctx.eval(), mel_b)
        else:
            mag = mel_b.float() @ self._lift
        return self._out(dsp._mag_to_wav_core(torch.clamp(mag, 1e-8, 1.0),
                                              self.audio_params))

    # total mel frames per vocoder call above which melgan_chunk=None
    # chunks (unast_tpu/infer/serve.py::Synthesizer._MELGAN_AUTO_FRAMES)
    _MELGAN_AUTO_FRAMES = 65536

    def _melgan_vocode(self, mel_b: torch.Tensor) -> torch.Tensor:
        """unast_tpu/infer/serve.py::Synthesizer._melgan_vocode: [rows, T,
        n_mels] -> _out(wavs [rows, T*hop]). Chunked (melgan_chunk, or the
        auto rule), every window is one uniform (chunk + 2*ctx)-frame slice
        of mel_b, its start clamped at the bucket's edges (which only
        widens the interior's margin), so each has >= ctx frames of context
        or a true edge on each side and the concatenation equals the whole
        forward. A window returns chunk*hop samples from lo_c =
        min(lo, (win - chunk)*hop), so the final partial chunk keeps its
        residual offset lo - lo_c for the trim. Every window is queued on
        the device before the joined result is fetched."""
        rows, t = mel_b.shape[0], mel_b.shape[1]
        chunk = self.melgan_chunk
        if chunk is None:
            chunk = 256 if rows * t > self._MELGAN_AUTO_FRAMES else 0
        ctx = MG.receptive_field(self.melgan_params)
        win = chunk + 2 * ctx
        if not chunk or t <= win:
            return self._out(MG.generator_forward(self.melgan_params, mel_b))
        hop = self.audio_params.hop_length
        pieces = []
        for t0 in range(0, t, chunk):
            a = min(max(0, t0 - ctx), t - win)
            lo = (t0 - a) * hop
            lo_c = min(lo, (win - chunk) * hop)
            wav = MG.generator_forward(self.melgan_params, mel_b[:, a:a + win])
            block = self._out(wav[:, lo_c:lo_c + chunk * hop])
            off = lo - lo_c
            pieces.append(block[:, off:off + min(chunk, t - t0) * hop])
        return torch.cat(pieces, dim=1)

    def _tts_wavs_from_seqs(self, seqs):
        """unast_tpu/infer/serve.py::Synthesizer._tts_wavs_from_seqs:
        phoneme-id sequences -> waveforms, max_batch at a time, each cut at
        its frame count and silence-trimmed on the host (native.py's trim;
        on int16 samples with pcm16)."""
        p = self.audio_params
        trim = native.trim_silence_i16 if self.pcm16 else native.trim_silence
        self.last_decode_steps = []
        out = []
        for start in range(0, len(seqs), self.max_batch):
            post, stop_lens, n = self._tts_chunk_seqs(
                seqs[start:start + self.max_batch])
            tb = self._bucket(self.mel_buckets, max(1, int(stop_lens[:n].max())))
            with torch.inference_mode():
                wavs, = self._sharded(lambda m: (self._vocode(m),), post[:, :tb])
                wavs = wavs.cpu().numpy()
            for i in range(n):
                # AR stop_lens counts the stop-fired frame, which the cut
                # drops; NAR out_lens is the exact frame count
                frames = int(stop_lens[i]) - (self.nar_pv is None)
                w, _ = trim(wavs[i, :p.hop_length * max(1, frames)],
                            frame_length=p.trim_frame_length,
                            hop=p.trim_hop_length, top_db=p.trim_top_db)
                out.append(w)
        return out

    # -- ASR -----------------------------------------------------------------

    def _asr_impl(self, mel, mel_len):
        """unast_tpu/infer/serve.py::Synthesizer._asr_impl: the AR model's
        greedy decode -> (ids, stop_lens)."""
        (ids, stop_lens), _ = U.asr(self.params, self.net_state,
                                    nn.Ctx.eval(), self.cfg, mel=mel,
                                    mel_len=mel_len, infer=True)
        return ids, stop_lens

    def _ctc_asr_impl(self, mel, mel_len):
        """unast_tpu/infer/serve.py::Synthesizer._ctc_asr_impl: one-pass
        greedy CTC through ctc_pv -> (ids, lens)."""
        (ids, lens), _ = CT.ctc_asr_infer(*self.ctc_pv, nn.Ctx.eval(),
                                          self.cfg, mel, mel_len)
        return ids, lens

    def _asr_beam_impl(self, mel, mel_len, beam: int):
        """unast_tpu/infer/serve.py::Synthesizer._asr_beam_impl: the AR
        model's KV-cached beam search -> (ids, stop_lens)."""
        ectx = nn.Ctx.eval()
        (enc, mask), _ = N.speech_encode(self.params["speech_m"],
                                         self.net_state["speech_m"], ectx,
                                         self.cfg, mel, mel_len)
        return N.text_tr_beam_search(self.params["text_m"], ectx, self.cfg,
                                     enc, mask, beam=beam)

    def _spec_asr_impl(self, mel, mel_len):
        """unast_tpu/infer/serve.py::Synthesizer._spec_asr_impl: the CTC
        model's greedy output drafts, the AR decoder verifies it in
        parallel teacher-forced passes (networks.text_tr_spec_infer): the
        AR model's greedy transcript. -> (ids, stop_lens, rounds)."""
        ectx = nn.Ctx.eval()
        (draft, _), _ = CT.ctc_asr_infer(*self.ctc_pv, ectx, self.cfg,
                                         mel, mel_len)
        (enc, mask), _ = N.speech_encode(self.params["speech_m"],
                                         self.net_state["speech_m"], ectx,
                                         self.cfg, mel, mel_len)
        return N.text_tr_spec_infer(self.params["text_m"], ectx, self.cfg,
                                    enc, mask, draft)

    def _ctc_log_probs(self, mel, mel_len):
        """unast_tpu/infer/serve.py::Synthesizer._ctc_log_probs: ctc_pv's
        log-posteriors [B, T, V+1] and valid frame counts [B]."""
        logits, pad, _ = CT.ctc_logits(*self.ctc_pv, nn.Ctx.eval(), self.cfg,
                                       mel, mel_len)
        return torch.log_softmax(logits, dim=-1), (~pad).sum(dim=1)

    def asr_ids(self, mels: List[np.ndarray], beam: int = 1,
                ctc_beam: int = 1, spec: bool = False):
        """unast_tpu/infer/serve.py::Synthesizer.asr_ids: mels (list of
        [T, n_mels]) -> list of phoneme-id np arrays. Greedy by default:
        the AR decoder, or with ctc_pv the one-pass CTC decode. beam > 1
        (transformer backbone): the AR beam search; ctc_beam > 1 (with
        ctc_pv): prefix beam search over the CTC posteriors on the host;
        spec=True (with ctc_pv, transformer backbone): the AR model's
        greedy transcript by CTC-drafted speculative decoding, its verify
        rounds in self.last_spec_rounds. Options that need what the
        Synthesizer lacks raise ValueError, as in JAX."""
        if beam > 1 and self.cfg.model_type != "transformer":
            raise ValueError("beam search requires the transformer backbone")
        if ctc_beam > 1 and self.ctc_pv is None:
            raise ValueError("ctc_beam needs Synthesizer(ctc_pv=...)")
        if spec:
            if self.ctc_pv is None:
                raise ValueError("spec=True needs Synthesizer(ctc_pv=...)")
            if self.cfg.model_type != "transformer":
                raise ValueError("speculative decode requires the "
                                 "transformer backbone")
            self.last_spec_rounds = []
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
            mel_t = torch.from_numpy(mel).to(self.device)
            lens_t = torch.from_numpy(lens).to(self.device)
            if ctc_beam > 1:
                with torch.inference_mode():
                    lp, n_frames = self._sharded(self._ctc_log_probs, mel_t,
                                                 lens_t)
                lp, n_frames = lp.cpu().numpy(), n_frames.cpu().numpy()
                out.extend(np.asarray(CT.ctc_prefix_beam_search(
                    lp[i], int(n_frames[i]), beam=ctc_beam,
                    max_text_len=self.cfg.max_text_len), np.int64)
                    for i in range(n))
                continue
            with torch.inference_mode():
                if spec:
                    ids, stop_lens, rounds = self._sharded(
                        self._spec_asr_impl, mel_t, lens_t)
                    self.last_spec_rounds.append(rounds)
                elif beam > 1:
                    ids, stop_lens = self._sharded(
                        lambda m, l: self._asr_beam_impl(m, l, beam), mel_t, lens_t)
                elif self.ctc_pv is not None:
                    ids, stop_lens = self._sharded(self._ctc_asr_impl, mel_t, lens_t)
                else:
                    ids, stop_lens = self._sharded(self._asr_impl, mel_t, lens_t)
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
                self._tts_impl(
                    torch.ones((1, tb), dtype=torch.long, device=self.device),
                    torch.full((1,), tb, dtype=torch.long, device=self.device))
            asr = self._ctc_asr_impl if self.ctc_pv is not None else self._asr_impl
            for mb in self.mel_buckets:
                asr(torch.zeros((1, mb, self.cfg.num_mels), device=self.device),
                    torch.full((1,), mb, dtype=torch.long, device=self.device))
            self._vocode(torch.zeros((1, self.mel_buckets[0], self.cfg.num_mels),
                                     dtype=self.cfg.dtype, device=self.device))
