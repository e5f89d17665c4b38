"""The port's data preparation (data/prepare.py, its device DSP path
audio/dsp.py::wav_to_mel_mag_batch, native.py's numpy host helpers), its
packed shards (data/shard.py, the shard path of data/batching.py), F0
(audio/pitch.py), MCD (audio/metrics.py) and CMUdict (text/cmudict.py)
against the JAX package on the CPU.

The corpus is tests/torch_ctc_golden.py::prep_corpus: three synthetic
clips with leading and trailing noise, as PCM16 wavs and a metadata.csv.
The JAX package's numpy paths run live (its --cpu prepare, its shard
writers and readers, its C++ host helpers through unast_tpu.native); the
JAX side of the jitted device DSP and of mcd_wav comes from the
hash-guarded golden tests/goldens/torch_ctc.npz. Tolerances: --cpu
caches, F0 caches, shards (mel and wav) byte for byte, batches, shard
readers and the native helpers exactly equal; device-path caches within
5e-4 (tests/test_audio.py::test_wav_to_mel_matches_jax's); MCD within
1e-6.
"""

import os
import struct
import wave

import numpy as np
import pytest
import torch

from unast_tpu import native as JN
from unast_tpu.audio import metrics as JMe, pitch as JP
from unast_tpu.data import batching as JB, prepare as JPr, shard as JS
from unast_tpu.text import cmudict as JCmu

from unast_tpu_torch import native as TN
from unast_tpu_torch.audio import dsp as TD, metrics as TMe, pitch as TP
from unast_tpu_torch.data import batching as TB, prepare as TPr, shard as TS
from unast_tpu_torch.data.dataset import SyntheticSpeechDataset
from unast_tpu_torch.text import cmudict as TCmu

import torch_ctc_golden as CG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    z = np.load(CG.GOLDEN)
    assert str(z["source_hash"]) == CG.source_hash(), (
        "tests/goldens/torch_ctc.npz is stale: run "
        "`JAX_PLATFORMS=cpu python tests/torch_ctc_golden.py`")
    return {k[len("prep/"):]: z[k] for k in z.files if k.startswith("prep/")} | {
        "mcd_wav": z["mcd_wav"]}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The corpus, and both packages' --cpu prepare of it with F0, a mel
    shard and a wav shard."""
    root = tmp_path_factory.mktemp("corpus")
    fids = CG.prep_corpus(str(root))
    for name, mod in (("jax", JPr), ("port", TPr)):
        mod.main(["--data_path", str(root), "--cache_dir", str(root / name),
                  "--cpu", "--f0", "--shard_out", str(root / f"{name}.unsh"),
                  "--wav_shard_out", str(root / f"{name}.unwv")])
    return root, fids


def _files(d):
    return sorted(os.listdir(d))


def test_native_helpers_match_cpp(prepared, tmp_path):
    """read_wav, trim_silence, trim_silence_i16 and preemphasis against
    unast_tpu.native's C++ library, on the corpus, a stereo file with an
    odd-sized chunk before its data, and silence."""
    assert JN.available()
    root, fids = prepared
    stereo = tmp_path / "stereo.wav"
    pcm = np.random.default_rng(3).integers(-30000, 30000, (900, 2)).astype("<i2")
    with open(stereo, "wb") as f:
        fmt = struct.pack("<HHIIHH", 1, 2, 16000, 64000, 4, 16)
        body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
                + b"LIST" + struct.pack("<I", 3) + b"abc\0"
                + b"data" + struct.pack("<I", pcm.nbytes) + pcm.tobytes())
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    paths = [str(root / "wavs" / f"{fid}.wav") for fid in fids] + [str(stereo)]
    for path in paths:
        y, sr = TN.read_wav(path)
        ry, rsr = JN.read_wav(path)
        assert sr == rsr and y.dtype == ry.dtype and np.array_equal(y, ry), path
        assert TN.trim_silence(y)[1] == JN.trim_silence(y)[1]
        assert np.array_equal(TN.preemphasis(y), JN.preemphasis(y))
        i16 = (np.clip(y, -1, 1) * 32767).astype(np.int16)
        got, se = TN.trim_silence_i16(i16)
        ref, rse = JN.trim_silence_i16(i16)
        assert se == rse and np.array_equal(got, ref)
    with pytest.raises(ValueError):
        TN.read_wav(str(stereo), expect_sr=22050)
    for y in (np.zeros(5000, np.float32), np.zeros(0, np.float32)):
        assert TN.trim_silence(y)[1] == JN.trim_silence(y)[1]


def test_prepare_cpu_caches_and_shards_match_jax(prepared):
    root, fids = prepared
    names = _files(root / "jax")
    assert names == _files(root / "port") and len(names) == 3 * len(fids)
    for name in names:
        a, b = np.load(root / "port" / name), np.load(root / "jax" / name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for ext in ("unsh", "unwv"):
        assert (root / f"port.{ext}").read_bytes() == (root / f"jax.{ext}").read_bytes()
    # prepare's readers against JAX's (the wave module)
    path = str(root / "wavs" / f"{fids[0]}.wav")
    assert np.array_equal(TPr.read_wav(path), JPr.read_wav(path))
    assert np.array_equal(TPr.read_wav_pcm16(path), JPr.read_wav_pcm16(path))


@pytest.mark.parametrize("batch", ["2", "1"])
def test_prepare_device_path_matches_jax(prepared, golden, tmp_path, batch):
    """The device path on the CPU (--device cpu), batched at the pinned
    bucket and per clip, against JAX's batched device path: the same
    frame counts, mel and mag within 5e-4, F0 equal; without --device,
    the card, which this host lacks."""
    root, fids = prepared
    argv = ["--data_path", str(root), "--cache_dir", str(tmp_path / "c"),
            "--device", "cpu"] + CG.PREP_ARGV
    argv[argv.index("--batch") + 1] = batch
    TPr.main(argv)
    names = sorted(golden.keys() - {"mcd_wav"})
    assert _files(tmp_path / "c") == names
    for name in names:
        a, r = np.load(tmp_path / "c" / name), golden[name]
        assert a.shape == r.shape, name
        if name.endswith(".f0.npy"):
            assert np.array_equal(a, r), name
        else:
            np.testing.assert_allclose(a, r, atol=5e-4, rtol=0, err_msg=name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPr.main(argv[:-len(CG.PREP_ARGV) - 2])


def test_wav_to_mel_mag_batch_rows_equal_unbatched(prepared):
    """Each row of the batched DSP equals wav_to_mel_mag of its clip over
    its valid frames, within 1e-4: the DFT is two float32 matmuls whose
    blocking follows the batch's frame count, and a bin whose sum cancels
    to near the 1e-5 floor carries that rounding into its dB value."""
    root, fids = prepared
    wavs = [TPr.read_wav(str(root / "wavs" / f"{fid}.wav")) for fid in fids]
    mel, mag, nf = TD.wav_to_mel_mag_batch(wavs, device="cpu")
    assert mel.shape[0] == 3 and nf.dtype == np.int32
    for i, w in enumerate(wavs):
        m1, g1, n1 = TD.wav_to_mel_mag(w, device="cpu")
        assert n1 == nf[i]
        np.testing.assert_allclose(mel[i, :n1].numpy(), m1[:n1].numpy(), atol=1e-4)
        np.testing.assert_allclose(mag[i, :n1].numpy(), g1[:n1].numpy(), atol=1e-4)
    with pytest.raises(AssertionError):
        TD.wav_to_mel_mag_batch(wavs, bucket_s=0.5, device="cpu")
    y = torch.from_numpy(wavs[0])
    assert np.allclose(TD.preemphasis(y, 0.97).numpy(),
                       np.append(wavs[0][:1], wavs[0][1:] - 0.97 * wavs[0][:-1]))


def test_shard_readers_and_batches_match_jax(prepared):
    root, fids = prepared
    mel_path, wav_path = str(root / "port.unsh"), str(root / "port.unwv")
    mine, ref = TS.PackedShardDataset(mel_path), JS.PackedShardDataset(mel_path)
    assert len(mine) == len(ref) == 3 and mine.n_mels == ref.n_mels
    for i in range(3):
        a, b = mine[i], ref[i]
        assert a.keys() == b.keys() and a["fname"] == b["fname"]
        assert np.array_equal(a["ids"], b["ids"]) and np.array_equal(a["mel"], b["mel"])
        # the shard's mel is the cache's, through float16
        cache = np.load(root / "port" / f"{fids[i]}.mel.npy")
        assert np.array_equal(a["mel"], cache.astype(np.float16).astype(np.float32))
        for t0, n in ((0, 5), (7, 40), (1000, 3)):
            assert np.array_equal(mine.mel_crop(i, t0, n), ref.mel_crop(i, t0, n))
    idx = np.array([2, 0, 2])
    for got, want in zip(mine.lens(idx), ref.lens(idx)):
        assert np.array_equal(got, want)
    for caps in ((8, 16), (64, 400)):
        a, b = mine.collate_batch(idx, *caps), ref.collate_batch(idx, *caps)
        for k in b:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (caps, k)
    sub_m, sub_r = TS.SubsetShard(mine, [2, 1]), JS.SubsetShard(ref, [2, 1])
    assert np.array_equal(sub_m[0]["mel"], sub_r[0]["mel"])
    for k, v in sub_r.collate_batch([1, 0], 32, 64).items():
        assert np.array_equal(np.asarray(sub_m.collate_batch([1, 0], 32, 64)[k]),
                              np.asarray(v)), k
    wm, wr = TS.WavShardDataset(wav_path), JS.WavShardDataset(wav_path)
    assert wm.sr == wr.sr and np.array_equal(wm.lens([0, 1, 2]), wr.lens([0, 1, 2]))
    for i in range(3):
        assert np.array_equal(wm[i], wr[i])
        assert np.array_equal(wm.crop(i, 300, 5000), wr.crop(i, 300, 5000))
    cm, cr = TS.MelWavCrops(mine, wm, [1, 2]), JS.MelWavCrops(ref, wr, [1, 2])
    assert len(cm) == len(cr) and cm.crop_lens(1) == cr.crop_lens(1)
    for a, b in zip(cm.crop_pair(0, 3, 10, 275), cr.crop_pair(0, 3, 10, 275)):
        assert np.array_equal(a, b)
    assert all(np.array_equal(cm[1][k], cr[1][k]) for k in ("mel", "wav"))
    # the trimmed wav shard lines up with the mel frames
    assert all(abs(wm.lens([i])[0] // 275 + 1 - mine.lens([i])[1][0]) <= 1
               for i in range(3))
    # BatchIterator's shard path against JAX's, with and without buckets
    for kw in ({}, {"text_buckets": [16, 64], "mel_buckets": [64, 128]}):
        it_m = TB.BatchIterator(mine, 2, 64, 256, seed=4, **kw)
        it_r = JB.BatchIterator(ref, 2, 64, 256, seed=4, **kw)
        for _ in range(3):
            a, b = it_m.next_batch(), it_r.next_batch()
            assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b)
        for a, b in zip(it_m.next_stacked(2), it_r.next_stacked(2)):
            assert np.array_equal(a, b)


def test_shard_item_path_and_corrupt_index(prepared, tmp_path):
    """A shard whose index runs past its end opens with no handle (the
    C++ reader refuses it too) and collates item by item."""
    root, _ = prepared
    data = bytearray((root / "port.unsh").read_bytes())
    struct.pack_into("<Q", data, 24 + 3 * 8, 10 ** 6)   # item 0's mel_frames
    bad = tmp_path / "bad.unsh"
    bad.write_bytes(bytes(data))
    assert TN.shard_open(str(bad)) is None and JN.shard_open(str(bad)) is None
    good = TS.PackedShardDataset(str(root / "port.unsh"))
    ok = TN.shard_open(str(root / "port.unsh"))
    assert ok is not None
    item = TS.PackedShardDataset(str(root / "port.unsh"))
    item._h = None
    a, b = item.collate_batch([1, 2], 16, 32), good.collate_batch([1, 2], 16, 32)
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b)


def test_shard_main_matches_jax(tmp_path):
    argv = ["--synthetic", "--synthetic_size", "2"]
    TS.main(["--out", str(tmp_path / "t.unsh"), "--device", "cpu"] + argv)
    JS.main(["--out", str(tmp_path / "j.unsh")] + argv)
    assert (tmp_path / "t.unsh").read_bytes() == (tmp_path / "j.unsh").read_bytes()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--out", str(tmp_path / "x.unsh")] + argv)


def test_pitch_matches_jax(prepared):
    root, fids = prepared
    wav = TPr.read_wav(str(root / "wavs" / f"{fids[1]}.wav"))
    f0 = TP.extract_f0(wav)
    assert np.array_equal(f0, JP.extract_f0(wav)) and (f0 > 0).any()
    durs = np.array([3, 5, 0, 7, 10])
    assert np.array_equal(TP.token_log_f0(f0, durs), JP.token_log_f0(f0, durs))
    mel = np.load(root / "port" / f"{fids[1]}.mel.npy")
    assert np.array_equal(TP.mel_f0_template(mel), JP.mel_f0_template(mel))


def test_f0_items_collate_like_jax():
    mine = SyntheticSpeechDataset(size=2, seed=1, include_f0=True)
    from unast_tpu.data.dataset import SyntheticSpeechDataset as JDs
    ref = JDs(size=2, seed=1, include_f0=True)
    a = TB.collate([mine[0], mine[1]], 32, 200)
    b = JB.collate([ref[0], ref[1]], 32, 200)
    assert a.keys() == b.keys() and "f0" in a
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b)


def test_mcd_matches_jax(prepared, golden):
    root, fids = prepared
    m0 = np.load(root / "port" / f"{fids[0]}.mel.npy")
    m1 = np.load(root / "port" / f"{fids[1]}.mel.npy")
    np.testing.assert_allclose(TMe.mel_cepstra(m0), JMe.mel_cepstra(m0), atol=1e-6)
    assert abs(TMe.mcd(m0, m1) - JMe.mcd(m0, m1)) < 1e-6
    assert np.isnan(TMe.mcd(m0[:0], m1))
    wavs = [TPr.read_wav(str(root / "wavs" / f"{fid}.wav")) for fid in fids[:2]]
    n = min(len(w) for w in wavs)
    got = TMe.mcd_wav(wavs[0][:n], wavs[1][:n], device="cpu")
    assert abs(got - float(golden["mcd_wav"])) < 1e-6 * max(1.0, got)


def test_cmudict_matches_jax(tmp_path):
    text = ("ABBE  AE1 B IY0\nABBE(1)  AE1 B EY0\n'BOUT  B AW1 T\n"
            "BAD  B AE1 XX\n;;; comment\nZOO  Z UW1\n")
    path = tmp_path / "cmudict.txt"
    path.write_text(text, encoding="latin-1")
    for keep in (True, False):
        mine, ref = TCmu.CMUDict(str(path), keep), JCmu.CMUDict(str(path), keep)
        assert len(mine) == len(ref)
        for w in ("abbe", "'bout", "bad", "zoo", "none"):
            assert mine.lookup(w) == ref.lookup(w), (keep, w)
    with open(path, encoding="latin-1") as f:
        assert TCmu.CMUDict(f).lookup("ABBE") == ["AE1 B IY0", "AE1 B EY0"]
