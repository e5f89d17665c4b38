"""Datasets of the port, copied from `unast_tpu/data/dataset.py` (numpy,
the same seeds, so equal arguments give equal items).

LJSpeechDataset: rows of a pipe-separated manifest, phonemized on access,
mels from the offline cache `<cache_dir>/<id>.mel.npy` that data/prepare.py
writes (the port's or the JAX package's: the same files).

SyntheticSpeechDataset: a seeded corpus of sentences with procedurally
generated audio (per-phoneme harmonic or formant stacks) and mels from the
numpy DSP (audio/ref_dsp.py), so the whole path runs with no corpus on
disk.

With `include_f0=True` an item also holds its frame-level F0: the
`<id>.f0.npy` cache of prepare's --f0, or audio/pitch.py::extract_f0 of
the synthetic waveform.
"""

import os
from typing import Dict, List, Tuple

import numpy as np

from ..text import raw_text_to_phoneme_ids
from ..audio.params import DEFAULT as AUDIO_DEFAULT
from ..audio import ref_dsp


def load_manifest(path: str) -> List[Tuple[str, str]]:
    """unast_tpu/data/dataset.py::load_manifest: pipe-separated rows
    `id|raw_text|normalized_text` (LJSpeech metadata.csv / split CSV
    format, src/preprocess.py:20-23). Returns [(id, text)] using the
    normalized column when present."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if not parts or not parts[0]:
                continue
            text = parts[2] if len(parts) > 2 and parts[2] else parts[1]
            rows.append((parts[0], text))
    return rows


class LJSpeechDataset:
    """unast_tpu/data/dataset.py::LJSpeechDataset. Items: dict(ids
    int32[Tt], mel float32[Tm, n_mels], fname str).
    Text is phonemized on access and memoized (the reference re-phonemizes
    every __getitem__, src/preprocess.py:33 — memoization is a free win)."""

    def __init__(self, manifest_path: str, cache_dir: str,
                 include_mag: bool = False, include_f0: bool = False):
        self.rows = load_manifest(manifest_path)
        self.cache_dir = cache_dir
        self.include_mag = include_mag
        # frame F0 from the offline cache (prepare.py --f0), for the
        # FastSpeech pitch adaptor
        self.include_f0 = include_f0
        self._phon_cache: Dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int):
        fname, text = self.rows[i]
        if i not in self._phon_cache:
            self._phon_cache[i] = np.asarray(
                raw_text_to_phoneme_ids(text), np.int32)
        item = {
            "ids": self._phon_cache[i],
            "mel": np.load(os.path.join(self.cache_dir, fname + ".mel.npy")),
            "fname": fname,
        }
        if self.include_mag:
            item["mag"] = np.load(
                os.path.join(self.cache_dir, fname + ".mag.npy"))
        if self.include_f0:
            item["f0"] = np.load(
                os.path.join(self.cache_dir, fname + ".f0.npy"))
        return item


_SYNTH_WORDS = [
    "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
    "speech", "model", "learns", "shared", "latent", "space", "text",
    "audio", "printer", "press", "machine", "book", "history", "first",
    "second", "sound", "wave", "signal", "process", "number", "seven",
    "green", "light", "tower", "river", "stone", "night", "morning",
]


def synth_sentence(rng: np.random.Generator, n_words: Tuple[int, int]):
    """unast_tpu/data/dataset.py::synth_sentence: n_words[0]..n_words[1]
    words drawn from the synthetic vocabulary."""
    k = int(rng.integers(n_words[0], n_words[1] + 1))
    return " ".join(rng.choice(_SYNTH_WORDS, size=k))


# Formant-timbre grid: 7x7 (F1, F2) pairs covering 46 phoneme ids with
# >= ~3.8 mel-bin separation between ANY two ids' signatures (measured
# with the package DSP). The harmonic timbre's 12 Hz id spacing is
# SUB-mel-bin (~0.3 bin at f0, ~0.5 at 2*f0) and pid%37 makes 18 ids
# acoustically identical — gold-mel ASR still works (it reads exact
# filterbank-leakage ratios) but NO regression-smoothed synthesis can
# round-trip it (measured: template-NN confusion 26.7% harmonic vs 0.0%
# formant under blur+noise) — use timbre='formant' for corpora whose
# round-trip intelligibility should be achievable.
_FORMANT_F1 = (400.0, 800.0, 1200.0, 1600.0, 2000.0, 2400.0, 3000.0)
_FORMANT_F2 = (3600.0, 4400.0, 5200.0, 6000.0, 6800.0, 7600.0, 8400.0)

# Intrinsic per-identity duration factors for synth_audio(dur_jitter>0):
# a fixed 0.6-1.5 spread scattered over ids by a coprime stride (so
# adjacent ids differ). Deterministic — the duration PREDICTOR's
# learnable signal; see synth_audio's docstring.
_DUR_FACTOR = 0.6 + 0.9 * ((np.arange(46) * 19) % 46) / 45.0


def synth_audio(ids: np.ndarray, sr: int, rng: np.random.Generator,
                phoneme_dur_s: float = 0.08,
                f0_scale: float = 1.0, gain: float = 1.0,
                timbre: str = "harmonic", dur_jitter: float = 0.0,
                return_durs: bool = False) -> np.ndarray:
    """unast_tpu/data/dataset.py::synth_audio. Each phoneme id becomes a
    short tone whose spectrum is a deterministic function of the id —
    audio correlates with the text, so
    ASR/TTS training on this corpus is learnable in principle. `f0_scale`
    multiplies every fundamental (per-utterance pitch variability for the
    FastSpeech pitch adaptor: without it, pitch is a function of phoneme
    identity and a trained decoder ignores pitch conditioning entirely —
    measured shift response exactly 1.000).

    timbre='harmonic' (default): f0 = 120 + 12*(pid % 37) + octave — the
    historical corpus; ids are sub-mel-bin apart (see _FORMANT_F1 note).
    timbre='formant': two 'formant' sines from a coarse 7x7 grid — every
    id pair is multiple mel bins apart, so round-trip intelligibility
    (synthesize -> DSP -> ASR) is achievable, not just gold-mel ASR.
    f0_scale is identity-preserving here: it scales an added low buzz
    (120 Hz) rather than the formants.

    `dur_jitter` > 0 makes each phoneme's length
    _DUR_FACTOR[pid] * (1 + U(-j, j)) * phoneme_dur_s: an INTRINSIC
    per-identity factor (fixed 0.6–1.5 spread, like real phone classes
    — vowels long, stops short) plus unpredictable noise. Without it
    every phoneme is the same length, so NAR duration modeling on this
    corpus is trivially solved by a uniform predictor (the oracle grid
    IS uniform); with it the identity part is what a duration predictor
    must LEARN (held-out texts carry different id sequences) while the
    noise part bounds achievable accuracy — and the forced aligner must
    track genuinely non-uniform boundaries. `return_durs=True`
    additionally returns the per-phoneme sample counts (the alignment
    oracle for scripts/align_probe.py)."""
    base = max(1, int(phoneme_dur_s * sr))
    if dur_jitter > 0:
        fac = _DUR_FACTOR[np.asarray(ids, np.int64) % len(_DUR_FACTOR)] \
            * (1.0 + dur_jitter * (2.0 * rng.random(len(ids)) - 1.0))
        lens = np.maximum(1, (base * fac).astype(np.int64))
    else:
        lens = np.full(len(ids), base, np.int64)
    segs = []
    for pid, n in zip(ids, lens):
        t = np.arange(n) / sr
        if timbre == "formant":
            f1 = _FORMANT_F1[int(pid) % 7]
            f2 = _FORMANT_F2[(int(pid) // 7) % 7]
            seg = (0.6 * np.sin(2 * np.pi * f1 * t)
                   + 0.4 * np.sin(2 * np.pi * f2 * t)
                   + 0.1 * np.sin(2 * np.pi * 120.0 * f0_scale * t)
                   + 0.02 * rng.standard_normal(n))
        else:
            f0 = (120.0 + 12.0 * (int(pid) % 37)) * f0_scale
            seg = (0.5 * np.sin(2 * np.pi * f0 * t)
                   + 0.25 * np.sin(2 * np.pi * 2 * f0 * t)
                   + 0.02 * rng.standard_normal(n))
        env = np.hanning(n)
        segs.append(seg * env)
    wav = np.concatenate(segs) if segs else np.zeros(base)
    wav = (0.5 * gain * wav
           / max(1e-6, np.max(np.abs(wav)))).astype(np.float32)
    return (wav, lens) if return_durs else wav


def add_realism(wav: np.ndarray, rng: np.random.Generator, sr: int,
                silence_s=(0.2, 0.7), noise_db: float = -45.0,
                breath_db: float = -28.0, return_offsets: bool = False):
    """Make a synthetic clip look like a real recording to the front end
    (unast_tpu/data/dataset.py::add_realism): leading/trailing room-tone
    silence (so the librosa-semantics trim, audio/ref_dsp.py, actually
    trims a nontrivial span), an additive broadband noise floor under the
    speech, and a breath-like unvoiced noise burst before the first word.

    Levels are chosen against the trim_top_db=60 gate: the silence tails
    sit at ~-75 dB relative to peak (well below the gate, so they ARE
    trimmed), the speech-span noise floor at `noise_db` (default -45 dB,
    above the gate but psychoacoustically a quiet room), the breath at
    `breath_db` — loud enough that the trim keeps it, like real breaths
    that precede speech inside the trimmed span."""
    peak = float(np.max(np.abs(wav))) or 1.0
    n = len(wav)
    out = wav + (10 ** (noise_db / 20)) * peak * rng.standard_normal(n)
    # breath: short exhale-shaped band noise immediately before speech
    nb = int(rng.uniform(0.08, 0.15) * sr)
    breath = rng.standard_normal(nb)
    # crude band-shaping: first difference (high-pass) + smoothing
    breath = np.convolve(np.diff(breath, prepend=0.0),
                         np.ones(8) / 8, mode="same")
    breath *= (10 ** (breath_db / 20)) * peak / (
        np.max(np.abs(breath)) or 1.0)
    breath *= np.hanning(nb)
    sil_amp = (10 ** (-75.0 / 20)) * peak
    lead = sil_amp * rng.standard_normal(int(rng.uniform(*silence_s) * sr))
    tail = sil_amp * rng.standard_normal(int(rng.uniform(*silence_s) * sr))
    full = np.concatenate([lead, breath, out, tail]).astype(np.float32)
    if return_offsets:
        # (lead, breath, tail) sample counts: the breath sits ABOVE the
        # trim gate, so the mel path's silence-trim keeps it — any
        # alignment oracle recorded against the bare speech must shift
        # its frame origin by the kept prefix (oracle_durs
        # misalignment on --realism corpora).
        return full, (len(lead), nb, len(tail))
    return full


class SyntheticSpeechDataset:
    """unast_tpu/data/dataset.py::SyntheticSpeechDataset. Deterministic
    (seeded) synthetic corpus; mels computed once via the
    reference-parity CPU DSP and cached in memory."""

    def __init__(self, size: int = 64, seed: int = 0,
                 n_words: Tuple[int, int] = (2, 5), params=AUDIO_DEFAULT,
                 phoneme_dur_s: float = 0.08, include_f0: bool = False,
                 pitch_jitter: float = 0.0, gain_jitter: float = 0.0,
                 jitter_variants: int = 1, timbre: str = "harmonic"):
        self.size = size
        self.params = params
        self.phoneme_dur_s = phoneme_dur_s
        self.timbre = timbre
        self.include_f0 = include_f0  # frame-level F0 (audio/pitch.py)
        # per-utterance log-uniform F0 scale in [e^-j, e^j] (see
        # synth_audio.f0_scale; needed to train a usable pitch adaptor)
        self.pitch_jitter = pitch_jitter
        # per-utterance log-uniform amplitude scale (energy adaptor)
        self.gain_jitter = gain_jitter
        # jitter_variants > 1: each access cycles through K differently-
        # jittered renditions of the utterance. With a single fixed
        # rendition the TEXT identifies the utterance and thus its jitter
        # — a conditioning-free decoder just memorizes it (measured:
        # energy-adaptor response collapses); cycling variants breaks
        # text -> jitter as a function, making the conditioning necessary.
        self.jitter_variants = max(1, int(jitter_variants))
        self._access: Dict[int, int] = {}
        self._items: Dict[int, dict] = {}
        rng = np.random.default_rng(seed)
        self._texts = [synth_sentence(rng, n_words) for _ in range(size)]
        self._seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, i: int):
        v = 0
        if self.jitter_variants > 1:
            v = self._access.get(i, 0) % self.jitter_variants
            self._access[i] = self._access.get(i, 0) + 1
        key = (i, v)
        if key not in self._items:
            rng = np.random.default_rng(
                self._seed * 100003 + i + 7919 * v)
            ids = np.asarray(raw_text_to_phoneme_ids(self._texts[i]), np.int32)
            scale = (float(np.exp(rng.uniform(-self.pitch_jitter,
                                              self.pitch_jitter)))
                     if self.pitch_jitter > 0 else 1.0)
            gain = (float(np.exp(rng.uniform(-self.gain_jitter,
                                             self.gain_jitter)))
                    if self.gain_jitter > 0 else 1.0)
            wav = synth_audio(ids, self.params.sr, rng,
                              phoneme_dur_s=self.phoneme_dur_s,
                              f0_scale=scale, gain=gain,
                              timbre=self.timbre)
            mel, mag = ref_dsp.wav_to_mel_mag(wav, self.params, trim=False)
            # raw wav kept for neural-vocoder training (train/melgan.py);
            # collate ignores extra keys
            self._items[key] = {"ids": ids, "mel": mel, "mag": mag,
                                "wav": wav.astype(np.float32),
                                "fname": f"SYN-{i:05d}"}
            if self.include_f0:
                from ..audio.pitch import extract_f0
                f0 = extract_f0(wav, self.params.sr,
                                self.params.hop_length)[: len(mel)]
                self._items[key]["f0"] = f0
        return self._items[key]
