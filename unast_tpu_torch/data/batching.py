"""Fixed-shape batching of the port, copied from
`unast_tpu/data/batching.py`: numpy, the same seeds, so for equal datasets
and arguments it gives exactly the JAX package's batches.

collate zero-pads text and mel to fixed maxima (or to length buckets);
BatchIterator is an infinite shuffled stream with drop_last semantics;
BatchGetter holds the three streams of a train step (supervised,
unsupervised, full). A dataset with `collate_batch` (a packed shard,
data/shard.py) takes the fast path: lengths from its index, each batch
assembled in one call.
"""

from typing import Sequence

import numpy as np


def collate(items: Sequence[dict], text_len: int, mel_len: int,
            n_mels: int = 80, include_mag: bool = False,
            n_freqs: int = 1025):
    """unast_tpu/data/batching.py::collate: pad a list of items to fixed
    [B, text_len] / [B, mel_len, n_mels]. Items longer than the fixed
    shapes are truncated (lengths clamped)."""
    b = len(items)
    text = np.zeros((b, text_len), np.int32)
    mel = np.zeros((b, mel_len, n_mels), np.float32)
    t_lens = np.zeros((b,), np.int32)
    m_lens = np.zeros((b,), np.int32)
    mag = np.zeros((b, mel_len, n_freqs), np.float32) if include_mag else None
    fnames = []
    for i, it in enumerate(items):
        ids = it["ids"][:text_len]
        m = it["mel"][:mel_len]
        text[i, :len(ids)] = ids
        mel[i, :len(m)] = m
        t_lens[i] = len(ids)
        m_lens[i] = len(m)
        if include_mag:
            mg = it["mag"][:mel_len]
            mag[i, :len(mg)] = mg
        fnames.append(it.get("fname", str(i)))
    out = {"text": text, "mel": mel, "text_len": t_lens, "mel_len": m_lens,
           "fnames": fnames}
    if include_mag:
        out["mag"] = mag
    if items and "f0" in items[0]:
        # frame-level F0 rides along when the dataset provides it
        # (include_f0=True; the NAR pitch adaptor)
        f0 = np.zeros((b, mel_len), np.float32)
        for i, it in enumerate(items):
            v = it["f0"][:mel_len]
            f0[i, :len(v)] = v
        out["f0"] = f0
    return out


def as_tuple(batch):
    """(text, mel, text_len, mel_len) — process_batch layout
    (src/train.py:80-94; the gold stop label is built in-step)."""
    return batch["text"], batch["mel"], batch["text_len"], batch["mel_len"]


class BatchIterator:
    """unast_tpu/data/batching.py::BatchIterator: an infinite shuffled
    iterator with drop_last=True semantics.

    Optional bucketing (`text_buckets`/`mel_buckets`: ascending length
    lists): each batch is padded to the smallest bucket covering its longest
    item instead of the global max, so short batches stop paying
    full-length attention cost. `next_stacked` unifies all n micro-batches
    to the largest bucket among them, so a train step's micro-batches share
    one shape."""

    def __init__(self, dataset, batch_size: int, text_len: int, mel_len: int,
                 seed: int = 0, include_mag: bool = False,
                 n_mels: int = 80, text_buckets=None, mel_buckets=None):
        self.ds = dataset
        self.bs = batch_size
        self.text_len = text_len
        self.mel_len = mel_len
        self.include_mag = include_mag
        self.n_mels = n_mels
        self.text_buckets = sorted(text_buckets) if text_buckets else None
        self.mel_buckets = sorted(mel_buckets) if mel_buckets else None
        self._rng = np.random.default_rng(seed)
        self._order = None
        self._pos = 0

    def _reshuffle(self):
        self._order = self._rng.permutation(len(self.ds))
        self._pos = 0

    @staticmethod
    def _pick_bucket(buckets, need, cap):
        for b in buckets:
            if need <= b:
                return min(b, cap)
        return cap

    def _next_indices(self):
        """Exactly batch_size dataset indices; datasets smaller than a
        batch wrap around (reshuffled per pass) so fixed shapes hold."""
        idx = []
        while len(idx) < self.bs:
            if self._order is None or self._pos >= len(self._order) or (
                    len(self._order) >= self.bs
                    and self._pos + self.bs > len(self._order)):
                self._reshuffle()
            take = min(self.bs - len(idx), len(self._order) - self._pos)
            idx.extend(self._order[self._pos:self._pos + take])
            self._pos += take
        return idx

    def skip(self, n: int):
        """Advance past n batches as next_batch would, loading no item."""
        for _ in range(n):
            self._next_indices()

    def _next_items(self):
        return [self.ds[int(i)] for i in self._next_indices()]

    def _shapes_for(self, items):
        tl, ml = self.text_len, self.mel_len
        if self.text_buckets:
            need = max(len(it["ids"]) for it in items)
            tl = self._pick_bucket(self.text_buckets, need, self.text_len)
        if self.mel_buckets:
            need = max(len(it["mel"]) for it in items)
            ml = self._pick_bucket(self.mel_buckets, need, self.mel_len)
        return tl, ml

    def _shard_shapes(self, idx_lists):
        """(text_len, mel_len) of a packed shard's batches `idx_lists`, from
        its index: the smallest buckets covering their longest items."""
        tl, ml = self.text_len, self.mel_len
        if self.text_buckets or self.mel_buckets:
            t_need = m_need = 0
            for idx in idx_lists:
                tls, mls = self.ds.lens(idx)
                t_need = max(t_need, int(tls.max()))
                m_need = max(m_need, int(mls.max()))
            if self.text_buckets:
                tl = self._pick_bucket(self.text_buckets, t_need, self.text_len)
            if self.mel_buckets:
                ml = self._pick_bucket(self.mel_buckets, m_need, self.mel_len)
        return tl, ml

    def next_batch(self):
        """unast_tpu/data/batching.py::BatchIterator.next_batch."""
        if hasattr(self.ds, "collate_batch") and not self.include_mag:
            # packed-shard fast path (data/shard.py): lengths from the
            # index, the whole batch assembled in one call
            idx = self._next_indices()
            return self.ds.collate_batch(idx, *self._shard_shapes([idx]))
        items = self._next_items()
        tl, ml = self._shapes_for(items)
        return collate(items, tl, ml, n_mels=self.n_mels,
                       include_mag=self.include_mag)

    def next_stacked(self, n: int):
        """Stack n micro-batches along a new leading axis, the layout of a
        train step's micro-batches. All micro-batches are padded to the
        largest bucket among them."""
        if hasattr(self.ds, "collate_batch") and not self.include_mag:
            idx_lists = [self._next_indices() for _ in range(n)]
            tl, ml = self._shard_shapes(idx_lists)
            bs = [self.ds.collate_batch(idx, tl, ml) for idx in idx_lists]
            return tuple(np.stack([as_tuple(b)[j] for b in bs])
                         for j in range(4))
        item_lists = [self._next_items() for _ in range(n)]
        tl = ml = 0
        for items in item_lists:
            t_i, m_i = self._shapes_for(items)
            tl, ml = max(tl, t_i), max(ml, m_i)
        bs = [collate(items, tl, ml, n_mels=self.n_mels,
                      include_mag=self.include_mag) for items in item_lists]
        return tuple(np.stack([as_tuple(b)[j] for b in bs]) for j in range(4))


class BatchGetter:
    """unast_tpu/data/batching.py::BatchGetter: three infinite streams,
    supervised (labeled), unsupervised, and full (discriminator) —
    src/train.py:32-78."""

    def __init__(self, args, supervised_ds, unsupervised_ds, full_ds,
                 n_mels: int = 80):
        kw = dict(batch_size=args.train_batch_size,
                  text_len=args.data_text_len, mel_len=args.data_mel_len,
                  n_mels=n_mels,
                  text_buckets=getattr(args, "text_buckets", None),
                  mel_buckets=getattr(args, "mel_buckets", None))
        self.supervised = BatchIterator(supervised_ds, seed=args.seed + 1, **kw)
        self.unsupervised = BatchIterator(unsupervised_ds, seed=args.seed + 2, **kw)
        self.full = BatchIterator(full_ds, seed=args.seed + 3, **kw)

    def step_batches(self, args, use_discriminator: bool):
        """All stacked micro-batches for ONE outer train step:
        ae/cm from the unsupervised stream, sp from the supervised stream,
        d from the full stream (src/train.py:607-638)."""
        batches = {}
        if args.ae_steps > 0:
            batches["ae"] = self.unsupervised.next_stacked(args.ae_steps)
        if args.cm_steps > 0:
            batches["cm"] = self.unsupervised.next_stacked(args.cm_steps)
        if args.sp_steps > 0:
            batches["sp"] = self.supervised.next_stacked(args.sp_steps)
        if use_discriminator and args.d_steps > 0:
            batches["d"] = self.full.next_stacked(args.d_steps)
        return batches

    def skip_steps(self, args, use_discriminator: bool, n: int):
        """Advance every stream past n step_batches(args, use_discriminator)
        calls, loading no item (a resumed run's data position)."""
        self.unsupervised.skip(n * (max(0, args.ae_steps) + max(0, args.cm_steps)))
        self.supervised.skip(n * max(0, args.sp_steps))
        if use_discriminator:
            self.full.skip(n * max(0, args.d_steps))
