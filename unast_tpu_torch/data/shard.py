"""Packed dataset shards of the port, copied from `unast_tpu/data/shard.py`:
the whole corpus in ONE mmap-able binary file, in the JAX package's format
byte for byte, so a shard written by either package reads in the other.

The reference materializes one .npy pair per utterance
(src/prepare_data.py:10-46 — 13k+ small files whose per-item open/parse
cost sits on the training hot path). A packed shard gives zero-copy reads
through one mmap and a single-call batch collate (native.py::shard_collate,
the numpy counterpart of the JAX package's C++ one: pad/truncate +
f16->f32).

Format v1 (little-endian), shared with the C reader:
    0:  magic b"UNSH" | u32 version=1 | u64 n_items | u32 n_mels | u32 pad
    24: index, n_items x 4 u64: text_off, text_count, mel_off, mel_frames
        (absolute byte offsets; text = int32 tokens, mel = float16 frames)
    payload

Mels are stored float16: the DSP's log-compressed, [0,1]-normalized mels
(src/utils.py:235-278 semantics) lose nothing material at f16 (the
training path casts to bf16 anyway), and the corpus file halves.

Write:  python -m unast_tpu_torch.data.shard --out corpus.unsh [--synthetic ...]
Read:   PackedShardDataset("corpus.unsh") — drop-in for LJSpeechDataset
        in BatchIterator; the iterator detects `collate_batch` and
        assembles batches in one call.
"""

import os
import struct
from typing import Optional

import numpy as np

from .. import native
from ..device import resolve_device

MAGIC = b"UNSH"
VERSION = 1
HEADER = struct.Struct("<4sIQII")  # magic, version, n_items, n_mels, pad


def write_shard(items, path: str, n_mels: int = 80):
    """unast_tpu/data/shard.py::write_shard. items: iterable of dicts with
    'ids' (int32 [T]) and 'mel' (float [F, n_mels]) — any dataset object
    works. Writes `path`."""
    seq = [(np.ascontiguousarray(it["ids"], np.int32),
            np.ascontiguousarray(it["mel"], np.float16)) for it in items]
    n = len(seq)
    index = np.zeros((n, 4), np.uint64)
    off = HEADER.size + index.nbytes
    for i, (ids, mel) in enumerate(seq):
        assert mel.ndim == 2 and mel.shape[1] == n_mels, mel.shape
        index[i] = (off, len(ids), off + ids.nbytes, mel.shape[0])
        off += ids.nbytes + mel.nbytes
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(HEADER.pack(MAGIC, VERSION, n, n_mels, 0))
        f.write(index.tobytes())
        for ids, mel in seq:
            f.write(ids.tobytes())
            f.write(mel.tobytes())
    os.replace(tmp, path)
    return path


class PackedShardDataset:
    """unast_tpu/data/shard.py::PackedShardDataset. Reads a packed shard.
    Item access returns the standard {'ids', 'mel', 'fname'} dict (mel
    float32); `collate_batch` assembles a whole fixed-shape batch in one
    call (native.shard_collate; the item-by-item loop if the shard's index
    fails native.shard_open's checks)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic, version, n, n_mels, _ = HEADER.unpack(
                f.read(HEADER.size))
        if magic != MAGIC or version != VERSION:
            raise ValueError(f"{path}: not a v{VERSION} UNSH shard")
        self.n_mels = int(n_mels)
        self._n = int(n)
        self._mm = np.memmap(path, np.uint8, mode="r")
        self._index = np.frombuffer(
            self._mm[HEADER.size:HEADER.size + n * 32], np.uint64
        ).reshape(self._n, 4)
        self._h = native.shard_open(path)  # None -> item-by-item collate

    def __len__(self):
        return self._n

    def lens(self, idx):
        """(text_lens, mel_frames) int32 arrays for `idx` (no payload IO)."""
        e = self._index[np.asarray(idx, np.int64)]
        return e[:, 1].astype(np.int32), e[:, 3].astype(np.int32)

    def __getitem__(self, i: int):
        off, tn, moff, mf = (int(v) for v in self._index[i])
        ids = np.frombuffer(self._mm[off:off + 4 * tn], np.int32)
        mel = np.frombuffer(
            self._mm[moff:moff + 2 * mf * self.n_mels], np.float16
        ).reshape(mf, self.n_mels).astype(np.float32)
        return {"ids": ids, "mel": mel, "fname": f"SHARD-{i:06d}"}

    def mel_crop(self, i: int, t0: int, frames: int) -> np.ndarray:
        """float32 [frames, n_mels] window starting at frame t0
        (zero-padded past the end) — reads only the window's bytes."""
        _, _, moff, mf = (int(v) for v in self._index[i])
        t0 = min(max(t0, 0), mf)
        take = max(0, min(frames, mf - t0))
        row = 2 * self.n_mels
        mel = np.frombuffer(
            self._mm[moff + row * t0:moff + row * (t0 + take)], np.float16
        ).reshape(take, self.n_mels)
        out = np.zeros((frames, self.n_mels), np.float32)
        out[:take] = mel
        return out

    def collate_batch(self, idx, text_cap: int, mel_cap: int):
        """One fixed-shape batch {'text','mel','text_len','mel_len',
        'fnames'} — native.shard_collate, matching batching.collate."""
        idx = np.ascontiguousarray(idx, np.int64)
        b = len(idx)
        out = native.shard_collate(self._h, idx, text_cap, mel_cap,
                                   self.n_mels) if self._h else None
        if out is None:
            text = np.zeros((b, text_cap), np.int32)
            mel = np.zeros((b, mel_cap, self.n_mels), np.float32)
            tl = np.zeros((b,), np.int32)
            ml = np.zeros((b,), np.int32)
            for j, i in enumerate(idx):
                it = self[int(i)]
                t = min(len(it["ids"]), text_cap)
                m = min(len(it["mel"]), mel_cap)
                text[j, :t] = it["ids"][:t]
                mel[j, :m] = it["mel"][:m]
                tl[j], ml[j] = t, m
            out = (text, mel, tl, ml)
        text, mel, tl, ml = out
        return {"text": text, "mel": mel, "text_len": tl, "mel_len": ml,
                "fnames": [f"SHARD-{int(i):06d}" for i in idx]}


WAV_MAGIC = b"UNWV"
WAV_HEADER = struct.Struct("<4sIQII")  # magic, version, n_items, sr, pad


def write_wav_shard(wavs, path: str, sr: int = 22050):
    """unast_tpu/data/shard.py::write_wav_shard. Pack waveforms into ONE
    mmap-able int16 file (vocoder-training sibling of `write_shard`; index: n_items x 2 u64 = off, n_samples).

    `wavs`: SIZED iterable (len() must work) of 1-D arrays — int16 is
    stored verbatim; float is treated as [-1, 1] and quantized exactly
    like infer/synthesize.py::write_wav, so a shard built from float
    equals one built from the PCM16 .wav files those floats produce.
    Streams item-by-item: peak memory is one waveform."""
    n = len(wavs)
    index = np.zeros((n, 2), np.uint64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(WAV_HEADER.pack(WAV_MAGIC, VERSION, n, sr, 0))
        f.write(index.tobytes())  # placeholder, rewritten below
        off = WAV_HEADER.size + index.nbytes
        for i, w in enumerate(wavs):
            w = np.asarray(w)
            if w.dtype != np.int16:
                w = (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
            w = np.ascontiguousarray(w)
            index[i] = (off, len(w))
            f.write(w.tobytes())
            off += w.nbytes
        f.seek(WAV_HEADER.size)
        f.write(index.tobytes())
    os.replace(tmp, path)
    return path


class WavShardDataset:
    """unast_tpu/data/shard.py::WavShardDataset. Reads a packed wav shard.
    `crop` slices only the requested window
    out of the mmap — random-crop vocoder sampling touches ~F*hop*2 bytes
    per draw instead of decoding whole files (the measured host-data cost
    that dominated corpus vocoder training wall time)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic, version, n, sr, _ = WAV_HEADER.unpack(
                f.read(WAV_HEADER.size))
        if magic != WAV_MAGIC or version != VERSION:
            raise ValueError(f"{path}: not a v{VERSION} UNWV wav shard")
        self.sr = int(sr)
        self._n = int(n)
        self._mm = np.memmap(path, np.uint8, mode="r")
        self._index = np.frombuffer(
            self._mm[WAV_HEADER.size:WAV_HEADER.size + n * 16], np.uint64
        ).reshape(self._n, 2)

    def __len__(self):
        return self._n

    def lens(self, idx):
        return self._index[np.asarray(idx, np.int64), 1].astype(np.int64)

    def _pcm(self, i: int, s0: int, count: int):
        off, ns = (int(v) for v in self._index[i])
        s0 = min(max(s0, 0), int(ns))
        take = max(0, min(count, int(ns) - s0))
        pcm = np.frombuffer(
            self._mm[off + 2 * s0:off + 2 * (s0 + take)], np.int16)
        return pcm, take

    def crop(self, i: int, s0: int, count: int) -> np.ndarray:
        """float32 [count] window starting at sample s0 (zero-padded past
        the end), scaled exactly as data/prepare.py::read_wav."""
        pcm, take = self._pcm(i, s0, count)
        out = np.zeros((count,), np.float32)
        out[:take] = pcm.astype(np.float32) / 32768.0
        return out

    def __getitem__(self, i: int) -> np.ndarray:
        ns = int(self._index[i, 1])
        return self.crop(i, 0, ns)


class MelWavCrops:
    """unast_tpu/data/shard.py::MelWavCrops. Aligned (mel shard, wav shard)
    view for vocoder training — both
    shards written in the same manifest order. `crop_pair` reads ONLY the
    crop window from each mmap; `__getitem__` keeps the {'mel','wav'}
    item contract of train/melgan.py's slow path."""

    def __init__(self, mel_ds: "PackedShardDataset", wav_ds: WavShardDataset,
                 indices=None):
        assert len(mel_ds) == len(wav_ds), (len(mel_ds), len(wav_ds))
        self.mel_ds = mel_ds
        self.wav_ds = wav_ds
        self.idx = (np.arange(len(mel_ds), dtype=np.int64)
                    if indices is None else np.asarray(indices, np.int64))

    def __len__(self):
        return len(self.idx)

    def crop_lens(self, i: int):
        """(mel_frames, wav_samples) for view index i — index IO only."""
        j = int(self.idx[i])
        return (int(self.mel_ds._index[j, 3]),
                int(self.wav_ds._index[j, 1]))

    def crop_pair(self, i: int, t0: int, frames: int, hop: int):
        j = int(self.idx[i])
        return (self.mel_ds.mel_crop(j, t0, frames),
                self.wav_ds.crop(j, t0 * hop, frames * hop))

    def __getitem__(self, i: int):
        j = int(self.idx[i])
        return {"mel": self.mel_ds[j]["mel"], "wav": self.wav_ds[j]}


class SubsetShard:
    """unast_tpu/data/shard.py::SubsetShard. Index-remapped view of a
    PackedShardDataset (train/held-out splits of one shard) that keeps the
    collate_batch fast path."""

    def __init__(self, ds, indices):
        self.ds = ds
        self.idx = np.asarray(indices, np.int64)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[int(self.idx[i])]

    def lens(self, idx):
        return self.ds.lens(self.idx[np.asarray(idx, np.int64)])

    def collate_batch(self, idx, text_cap: int, mel_cap: int):
        return self.ds.collate_batch(
            self.idx[np.asarray(idx, np.int64)], text_cap, mel_cap)


def main(argv: Optional[list] = None):
    """unast_tpu/data/shard.py::main: write a shard of the synthetic corpus
    or of an LJSpeech cache's split, and read it back."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--data_path", default=None,
                    help="LJSpeech cache dir (data/prepare.py output); "
                         "omit for --synthetic")
    ap.add_argument("--split", default="labeled_train")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic_size", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="as the port's other entry points: the card unless "
                         "'cpu' (packing itself is host numpy)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.synthetic or not args.data_path:
        from .dataset import SyntheticSpeechDataset
        ds = SyntheticSpeechDataset(size=args.synthetic_size, seed=0)
    else:
        from .dataset import LJSpeechDataset
        from .splits import REFERENCE_SPLITS_DIR
        local = os.path.join(args.data_path, "splits")
        splits = local if os.path.isdir(local) else REFERENCE_SPLITS_DIR
        ds = LJSpeechDataset(os.path.join(splits, args.split + ".csv"),
                             os.path.join(args.data_path, "mel_cache"))
    write_shard((ds[i] for i in range(len(ds))), args.out)
    got = PackedShardDataset(args.out)
    print(f"wrote {args.out}: {len(got)} items, "
          f"{os.path.getsize(args.out) / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
