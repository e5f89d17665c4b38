"""Offline wav -> mel/mag preprocessor of the port, mirroring
`unast_tpu/data/prepare.py` (parity with src/prepare_data.py). Writes
`<id>.mel.npy` / `<id>.mag.npy` (and with --f0 `<id>.f0.npy`) into the
cache dir, the same files the JAX package writes, and optionally packs
them into one mel shard and the trimmed PCM16 waveforms into one wav
shard (data/shard.py). `--cpu` runs the numpy DSP (audio/ref_dsp.py),
with `--workers N` in a process pool; otherwise the DSP runs on the
device (audio/dsp.py), `--batch` clips a call at one pinned length bucket
(`--bucket_s`).

Usage:
  python -m unast_tpu_torch.data.prepare --data_path <LJSpeech-1.1> \
      --cache_dir <out> [--cpu] [--workers N] [--device cpu]
"""

import argparse
import os
import sys
import time
import wave

import numpy as np

from .. import native
from ..audio import ref_dsp
from ..audio.params import DEFAULT as P
from ..device import resolve_device
from .dataset import load_manifest


def read_wav(path: str, expect_sr: int = 22050) -> np.ndarray:
    """unast_tpu/data/prepare.py::read_wav: a PCM16 WAV -> float32 in
    [-1, 1] (channels averaged)."""
    with wave.open(path, "rb") as w:
        assert w.getframerate() == expect_sr, (
            f"{path}: sr {w.getframerate()} != {expect_sr}")
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype=np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return (data / 32768.0).astype(np.float32)


def read_wav_pcm16(path: str, expect_sr: int = 22050) -> np.ndarray:
    """unast_tpu/data/prepare.py::read_wav_pcm16: the raw int16 samples
    (channels averaged), so a wav shard is byte-exact with the .wav
    payload."""
    with wave.open(path, "rb") as w:
        assert w.getframerate() == expect_sr, (
            f"{path}: sr {w.getframerate()} != {expect_sr}")
        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(
                axis=1).astype(np.int16)
    return data


def process_clip(wav_path: str, cache_dir: str, fid: str, on_device: bool,
                 with_f0: bool = False, with_mag: bool = True, device=None):
    """unast_tpu/data/prepare.py::process_clip: one clip's caches, by the
    device DSP (dsp.wav_to_mel_mag on `device`) or the numpy one. Returns
    its frame count."""
    wav = read_wav(wav_path)
    if on_device:
        from ..audio import dsp
        mel, mag, n_frames = dsp.wav_to_mel_mag(wav, device=device)
        mel = mel[:n_frames].cpu().numpy()
        # only fetch mag from the device when it will be written (the
        # [T, 1025] float32 copy is ~13x the mel's)
        mag = mag[:n_frames].cpu().numpy() if with_mag else None
    else:
        mel, mag = ref_dsp.wav_to_mel_mag(wav)
    np.save(os.path.join(cache_dir, fid + ".mel.npy"), mel)
    if with_mag:
        # mags (1025 bins) only matter for vocoder training; --no_mag
        # skips them for model-training-only caches
        np.save(os.path.join(cache_dir, fid + ".mag.npy"), mag)
    if with_f0:
        _save_f0(wav, mel.shape[0], cache_dir, fid)
    return mel.shape[0]


def _save_f0(wav: np.ndarray, n_frames: int, cache_dir: str, fid: str):
    """unast_tpu/data/prepare.py::_save_f0: frame F0 over the trimmed span
    the mel was computed from (numpy trim, audio/pitch.py::extract_f0)."""
    from ..audio.pitch import extract_f0
    y, _ = ref_dsp.trim_silence(wav, P)
    f0 = extract_f0(y, P.sr, P.hop_length)[:n_frames]
    np.save(os.path.join(cache_dir, fid + ".f0.npy"), f0.astype(np.float32))


def _trimmed_len(wav: np.ndarray) -> int:
    """unast_tpu/data/prepare.py::_trimmed_len: the silence-trimmed sample
    count, by dsp._host_prep's trim (native.trim_silence)."""
    y, _ = native.trim_silence(np.asarray(wav, np.float32),
                               P.trim_frame_length, P.trim_hop_length,
                               P.trim_top_db)
    return len(y)


def main(argv=None):
    """unast_tpu/data/prepare.py::main, with --device (the card unless
    'cpu'; --cpu still means the numpy DSP)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--cache_dir", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="numpy reference DSP instead of the device path")
    ap.add_argument("--workers", type=int, default=0,
                    help="process pool size for the --cpu path")
    ap.add_argument("--batch", type=int, default=32,
                    help="clips per batched device DSP call (device path "
                         "only; 1 = the per-clip path)")
    ap.add_argument("--bucket_s", type=float, default=11.0,
                    help="pin ONE sample-length bucket (seconds) for the "
                         "batched DSP call, so every call has one shape. "
                         "0 = auto-bucket per batch")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--shard_out", type=str, default=None,
                    help="also pack the cached corpus into ONE mmap-able "
                         "shard file (data/shard.py; phonemizes the "
                         "manifest transcripts for the text ids)")
    ap.add_argument("--f0", action="store_true",
                    help="also cache frame-level F0 (<id>.f0.npy, "
                         "audio/pitch.py) for the FastSpeech pitch adaptor")
    ap.add_argument("--wav_shard_out", type=str, default=None,
                    help="also pack the PCM16 waveforms into ONE mmap-able "
                         "wav shard (data/shard.py::WavShardDataset), "
                         "manifest order == the mel shard's")
    ap.add_argument("--no_mag", action="store_true",
                    help="skip the .mag.npy caches (only vocoder training "
                         "reads them; saves ~13x the mel bytes)")
    ap.add_argument("--device", default="cuda",
                    help="device of the DSP when not --cpu (default cuda)")
    args = ap.parse_args(argv)
    device = None if args.cpu else resolve_device(args.device)
    t0 = time.perf_counter()

    manifest = os.path.join(args.data_path, "metadata.csv")
    rows = load_manifest(manifest)
    if args.limit:
        rows = rows[:args.limit]
    os.makedirs(args.cache_dir, exist_ok=True)
    if args.cpu and args.workers > 1:
        import multiprocessing as mp
        jobs = [(os.path.join(args.data_path, "wavs", fid + ".wav"),
                 args.cache_dir, fid, False, args.f0, not args.no_mag)
                for fid, _ in rows]
        with mp.Pool(args.workers) as pool:
            frames = pool.starmap(process_clip, jobs, chunksize=32)
        print(f"[prepare] done: {len(rows)} clips, {sum(frames)} frames in "
              f"{time.perf_counter() - t0:.3f} s")
        return
    total = 0
    if not args.cpu and args.batch > 1:
        # Batched device path: one call per --batch clips at one pinned
        # length bucket.
        from ..audio import dsp
        done = 0
        # cap mirrors the bucket assert inside dsp.wav_to_mel_mag_batch
        # (bucket_s * p.sr, checked against the TRIMMED length)
        cap = int(args.bucket_s * P.sr) if args.bucket_s > 0 else 0
        for c0 in range(0, len(rows), args.batch):
            chunk = rows[c0:c0 + args.batch]
            orig_n = len(chunk)
            wavs = [read_wav(os.path.join(args.data_path, "wavs",
                                          fid + ".wav"))
                    for fid, _ in chunk]
            if cap and any(len(w) > cap for w in wavs):
                # over-long clips can't ride the pinned bucket: route them
                # through the per-clip path. The bucket assert checks the
                # TRIMMED length, so trim-check first: a raw-over-cap clip
                # whose trimmed span fits stays on the batched path.
                keep = [j for j, w in enumerate(wavs)
                        if len(w) <= cap or _trimmed_len(w) <= cap]
                for j, (fid, _) in enumerate(chunk):
                    if j in keep:
                        continue
                    print(f"[prepare] {fid}: {len(wavs[j]) / P.sr:.1f}s "
                          f"trimmed > bucket_s {args.bucket_s} — "
                          f"per-clip path", file=sys.stderr)
                    total += process_clip(
                        os.path.join(args.data_path, "wavs", fid + ".wav"),
                        args.cache_dir, fid, on_device=True, with_f0=args.f0,
                        with_mag=not args.no_mag, device=device)
                chunk = [chunk[j] for j in keep]
                wavs = [wavs[j] for j in keep]
                if not chunk:
                    done += orig_n
                    continue
            # pad the final chunk to the pinned batch size, one shape for
            # every call
            pad_wavs = wavs + [np.zeros(1, np.float32)] * (args.batch
                                                           - len(wavs))
            mel_d, mag_d, nf = dsp.wav_to_mel_mag_batch(
                pad_wavs, bucket_s=args.bucket_s, device=device)
            mels = mel_d.cpu().numpy()
            mags = None if args.no_mag else mag_d.cpu().numpy()
            for j, (fid, _) in enumerate(chunk):
                n = int(nf[j])
                np.save(os.path.join(args.cache_dir, fid + ".mel.npy"),
                        mels[j, :n])
                if mags is not None:
                    np.save(os.path.join(args.cache_dir, fid + ".mag.npy"),
                            mags[j, :n])
                if args.f0:
                    _save_f0(wavs[j], n, args.cache_dir, fid)
                total += n
            done += orig_n
            if done % 512 < args.batch and done < len(rows):
                print(f"[prepare] {done}/{len(rows)} clips, {total} "
                      f"frames", file=sys.stderr)
    else:
        for i, (fid, _) in enumerate(rows):
            wav_path = os.path.join(args.data_path, "wavs", fid + ".wav")
            total += process_clip(wav_path, args.cache_dir, fid,
                                  on_device=not args.cpu, with_f0=args.f0,
                                  with_mag=not args.no_mag, device=device)
            if (i + 1) % 500 == 0:
                print(f"[prepare] {i + 1}/{len(rows)} clips, {total} "
                      f"frames", file=sys.stderr)
    print(f"[prepare] done: {len(rows)} clips, {total} frames in "
          f"{time.perf_counter() - t0:.3f} s")
    if args.shard_out:
        _write_shard_from_cache(rows, args.cache_dir, args.shard_out)
    if args.wav_shard_out:
        write_wav_shard_from_dir(rows, os.path.join(args.data_path, "wavs"),
                                 args.wav_shard_out)


def write_wav_shard_from_dir(rows, wavs_dir: str, out_path: str,
                             trim: bool = True):
    """unast_tpu/data/prepare.py::write_wav_shard_from_dir: pack
    <wavs_dir>/<fid>.wav (PCM16, manifest order) into one wav shard, the
    int16 samples with no float round-trip, TRIMMED (trim=True) by the
    bounds of the mel path's trim (native.trim_silence_i16; the dB
    decision is scale-invariant), so frame t of the mel corresponds to
    samples [t*hop, (t+1)*hop) of the sharded wav, the alignment
    data/shard.py::MelWavCrops depends on. trim=False packs the raw
    payload."""
    from .shard import write_wav_shard

    class _Seq:
        def __len__(self):
            return len(rows)

        def __iter__(self):
            for fid, _ in rows:
                pcm = read_wav_pcm16(os.path.join(wavs_dir, fid + ".wav"))
                if trim:
                    pcm, _ = native.trim_silence_i16(
                        pcm, P.trim_frame_length, P.trim_hop_length,
                        P.trim_top_db)
                yield pcm

    write_wav_shard(_Seq(), out_path)
    print(f"[prepare] wav shard: {out_path} "
          f"({os.path.getsize(out_path) / 1e6:.1f} MB)")


def _write_shard_from_cache(rows, cache_dir: str, out_path: str):
    """unast_tpu/data/prepare.py::_write_shard_from_cache: the cached mels
    and the phonemized transcripts, in manifest order, into one shard."""
    from ..text import raw_text_to_phoneme_ids
    from .shard import write_shard

    def items():
        for fid, text in rows:
            yield {"ids": np.asarray(raw_text_to_phoneme_ids(text),
                                     np.int32),
                   "mel": np.load(os.path.join(cache_dir,
                                               fid + ".mel.npy"))}

    write_shard(items(), out_path)
    print(f"[prepare] shard: {out_path} "
          f"({os.path.getsize(out_path) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
