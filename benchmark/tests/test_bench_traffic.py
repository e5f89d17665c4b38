"""The one general generator: deterministic per seed, inside its stated
ranges, and the same set of sizes for every seed."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import traffic as T
from benchmark.reference import serve as RS

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _traffic(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def test_quantiles_lie_in_range_with_the_stated_mean():
    q = T.quantiles(1.1, 10.1, 6.6, 4096)
    assert q.min() >= 1.1 and q.max() <= 10.1
    assert abs(q.mean() - 6.6) < 0.01
    assert np.all(np.diff(q) >= 0)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3])
def test_train_steps_are_the_seed_s_and_hold_one_multiset(seed):
    t = dict(_traffic("sp_warmup"), batch=4, mel_pad=820, text_pad=304)
    a, frames = T.train_steps(t, seed, 2, "cpu")
    b, _ = T.train_steps(t, seed, 2, "cpu")
    c, frames_c = T.train_steps(t, seed + 1, 2, "cpu")
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert not torch.equal(a[0][1], c[0][1])
    assert frames == frames_c
    fps = t["frames_per_second"]
    for text, mel, tl, ml in a:
        assert ml.min() >= round(t["seconds"][0] * fps)
        assert ml.max() <= round(t["seconds"][1] * fps) <= t["mel_pad"]
        assert tl.min() >= t["tokens"][0] and tl.max() <= t["tokens"][1]
        assert sorted(ml.reshape(-1).tolist()) == sorted(
            c[0][3].reshape(-1).tolist())
        rows = torch.arange(text.shape[-1])
        valid = rows[None, None, :] < tl[..., None]
        assert torch.all((text == 0) == ~valid)
        assert torch.all(text.gather(-1, (tl - 1)[..., None]) == 2)
        pad = torch.arange(mel.shape[2])[None, None, :] >= ml[..., None]
        assert torch.all(mel[pad] == 0)


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_texts_are_the_seed_s_and_fill_their_character_counts(seed):
    t = _traffic("nar_melgan_serve")
    lex = RS.load_lexicon(os.path.dirname(BENCH))
    a = T.texts(t, lex, seed, 3)
    assert a == T.texts(t, lex, seed, 3)
    assert a != T.texts(t, lex, seed + 1, 3)
    targets = sorted(np.round(T.quantiles(*t["chars"], t["batch"])).astype(int))
    lo, hi, _ = t["chars"]
    for batch in a:
        assert len(batch) == t["batch"]
        lens = sorted(len(x) for x in batch)
        shortest = min(len(w) for w in lex)
        assert all(lo - shortest <= n <= hi for n in lens)
        assert all(0 <= want - got <= shortest
                   for want, got in zip(targets, lens))
        assert all(w in lex for x in batch for w in x.split(" "))
