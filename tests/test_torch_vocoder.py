"""The port's CBHG vocoder (models/modules.py's highway and CBHG,
models/unast.py::vocoder, infer/vocoder.py's step, trainer, checkpoints,
make_mags and CLI), audio/dsp.py::mag_to_wav and the vocoder's serving
paths (Synthesizer(vocoder_pv=), synthesize_text(vocoder_pv=), vocode)
against the JAX package on the CPU. The server's --vocoder_ckpt is
tests/test_torch_port_rules.py::test_vocoder_options_run.

The same weights go to both sides: the port's vocoder_init from torch seed
0 at hidden 16 and n_fft 2048, as numpy trees (tests/torch_vocoder_golden.
py), which bridge.vocoder_from_jax turns into the port's. The JAX side
comes from the hash-guarded golden tests/goldens/torch_vocoder.npz.
Tolerances, float32 throughout: 1e-5 for highway, cbhg and vocoder in eval
mode and with train-mode BN, and for the new BN state; the vocoder step
over two updates: losses 1e-6 relative; the BN state, Adam's first
moments and the new params as test_vocoder_step_matches_optax says;
waveforms 2e-3 of their peak (Griffin-Lim; see
tests/test_torch_serve.py::test_synthesizer_matches_jax); checkpoints,
make_mags and the CLI exact.
"""

import functools

import numpy as np
import pytest
import torch

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.audio import dsp as tdsp
from unast_tpu_torch.audio.params import AudioParams as TAudioParams
from unast_tpu_torch.bridge import params_from_jax, vocoder_from_jax
from unast_tpu_torch.infer import synthesize
from unast_tpu_torch.infer import vocoder as TV
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.models import TINY, modules as TM, unast as TU
from unast_tpu_torch.train.config import parse_with_config
from unast_tpu_torch.train import optim as TO
from unast_tpu_torch.train.optim import make_optimizer, tree_paths

import torch_ops_golden as OG
import torch_serve_golden as SG
import torch_train_golden as G
import torch_vocoder_golden as VG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol, err_msg=what)


def _peak_close(b, a, what=""):
    assert a.shape == b.shape and len(a) > 0, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=2e-3 * np.abs(a).max(), rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def golden():
    z = np.load(VG.GOLDEN)
    assert str(z["source_hash"]) == VG.source_hash(), (
        "tests/goldens/torch_vocoder.npz is stale: the JAX package, a golden "
        "module, the config or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_vocoder_golden.py`")
    out = {k: z[k] for k in z.files}
    assert str(out["init_hash"]) == G.init_hash(VG.init_trees()[0]), (
        "the port's vocoder_init changed; run the golden module again")
    return out


@functools.lru_cache(maxsize=1)
def _vocoder():
    """The port's (params, state) of the case, through the bridge."""
    return vocoder_from_jax(*VG.init_trees())


def _tree(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}


@pytest.mark.parametrize("mode", VG.MODES)
def test_cbhg_and_vocoder_match_jax(golden, mode):
    """highway, cbhg and vocoder (with the chained conv bank and the even
    kernels' trimmed frame), and the BN state they return."""
    p, s = _vocoder()
    mel, _, x = (torch.from_numpy(a) for a in VG.inputs())
    ctx = tnn.Ctx(train=mode == "train")
    _close(TM.highway(p["cbhg"]["highway"], x), golden[f"{mode}/highway"], 1e-5, "highway")
    cb, cb_s = TM.cbhg(p["cbhg"], s["cbhg"], ctx, x)
    _close(cb, golden[f"{mode}/cbhg"], 1e-5, "cbhg")
    vo, vo_s = TU.vocoder(p, s, ctx, mel)
    assert vo.shape == (2, 20, VG.N_FFT // 2 + 1)
    _close(vo, golden[f"{mode}/vocoder"], 1e-5, "vocoder")
    for name, tree in (("cbhg_state", cb_s), ("vocoder_state", vo_s)):
        ref = _tree(golden, f"{mode}/{name}/")
        mine = G.flatten(tree)
        assert mine.keys() == ref.keys()
        for k, r in ref.items():
            _close(mine[k], r, 1e-5, f"{name}/{k}")


def test_vocoder_step_matches_optax(golden):
    """Two updates of make_vocoder_step (train mode, the summed l1 loss,
    clip + adamw of configs/vocoder.json at a flat lr) against JAX's step
    with optax, from the same weights and batch. Adam's first moment (0.1
    x the clipped gradient, then its running mean) within 1e-4 relative
    plus 1e-5 of its tree's largest. The params as the normalised update
    (new - old) / lr: within 1e-3 where JAX's first moments are above 1e-6
    at every update so far (measured: 6.0e-5 after one update, 2.8e-4
    after two); elsewhere each update may flip sign (the gradient of a
    bank conv's bias, which batch-statistics BN cancels, is float32 noise
    of about 1e-9, and Adam scales it to +-lr; the second update's
    m / sqrt(v) turns with the ratio of two gradients, whose float32
    noise is first order where they are below 1e-5), so within 2 a
    step."""
    p, s = _vocoder()
    old = G.flatten(p)
    mel, mag, _ = (torch.from_numpy(a) for a in VG.inputs())
    args = parse_with_config(VG.STEP_ARGV)
    tx = make_optimizer(args)
    step = TV.make_vocoder_step(args, tx)
    opt = tx.init(p)
    big = {k: True for k in old}
    for i in range(2):
        p, s, opt, loss = step(p, s, opt, torch.Generator().manual_seed(i), mel, mag)
        np.testing.assert_allclose(float(loss), golden[f"step/{i}/loss"], rtol=1e-6)
        for k, r in _tree(golden, f"step/{i}/state/").items():
            # after the first update a bank conv's bias (noise, see above)
            # differs by up to 2 lr, and its BN's running mean, at momentum
            # 0.1, by up to 0.2 lr; the normalisation cancels it downstream
            tol = 1e-5 + (0.2 * args.lr if i and k.endswith("/mean") else 0.0)
            np.testing.assert_allclose(G.flatten(s)[k], r, atol=tol, rtol=1e-5,
                                       err_msg=k)
        mu, ref_mu = G.flatten(opt.mu), _tree(golden, f"step/{i}/mu/")
        top = max(np.abs(r).max() for r in ref_mu.values())
        for k, r in ref_mu.items():
            np.testing.assert_allclose(mu[k], r, rtol=1e-4, atol=1e-5 * top, err_msg=k)
            big[k] = big[k] & (np.abs(r) > 1e-6)
        mine, ref = G.flatten(p), _tree(golden, f"step/{i}/params/")
        assert mine.keys() == ref.keys() == old.keys()
        for k, r in ref.items():
            u_mine, u_ref = (mine[k] - old[k]) / args.lr, (r - old[k]) / args.lr
            np.testing.assert_allclose(u_mine[big[k]], u_ref[big[k]], atol=1e-3,
                                       err_msg=k)
            assert (np.abs(u_mine - u_ref) <= 2 * (i + 1) + 1e-3).all(), k
        assert opt.count == i + 1


def test_mag_to_wav_matches_jax(golden):
    wav = tdsp.mag_to_wav(VG.mag_case(), TAudioParams(n_iter=2), device="cpu")
    _peak_close(wav, golden["mag_to_wav"], "mag_to_wav")


def _serving_models():
    mp, ms = params_from_jax(*VG.serve_trees())
    return mp, ms, _vocoder()


def test_synthesizer_with_vocoder_matches_jax(golden):
    """Synthesizer(vocoder_pv=) on the TINY transformer: mel -> CBHG ->
    clip -> batched Griffin-Lim, waveforms against the JAX Synthesizer's."""
    assert str(golden["serve_init_hash"]) == G.init_hash(VG.serve_trees()[0])
    mp, ms, vpv = _serving_models()
    syn = Synthesizer(mp, ms, TINY, vocoder_pv=vpv, device="cpu",
                      audio_params=TAudioParams(n_iter=2), **SG.KW)
    for i, w in enumerate(syn.tts(SG.TEXTS)):
        _peak_close(w, golden[f"tts/{i}"], f"tts {i}")


def test_synthesize_text_with_vocoder_matches_jax(golden):
    mp, ms, vpv = _serving_models()
    wav = synthesize.synthesize_text(mp, ms, TINY, VG.SYNTH_TEXT, vocoder_pv=vpv,
                                     audio_params=TAudioParams(n_iter=2))
    _peak_close(wav, golden["synthesize_text"], "synthesize_text")


def test_bridge_carries_the_vocoder_tree():
    """vocoder_from_jax carries a JAX vocoder_init tree (its shapes from
    JAX's init, kept in tests/goldens/torch_ops.npz) name for name and
    value for value, with the port's names and shapes."""
    shapes = SG.unflatten({k[len("vocoder_shapes/"):]: np.empty(tuple(v))
                           for k, v in OG.load().items()
                           if k.startswith("vocoder_shapes/")})
    rng = np.random.default_rng(5)
    jp, js = (TO.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), t)
              for t in shapes)
    ref = G.flatten({"p": jp, "s": js})
    tp, ts = vocoder_from_jax(jp, js)
    mine = G.flatten({"p": tp, "s": ts})
    params, state = VG.init_trees()
    assert mine.keys() == ref.keys() == G.flatten({"p": params, "s": state}).keys()
    assert {"p/cbhg/bank/15/w", "p/cbhg/bn_bank/0/scale", "p/cbhg/gru/1/bwd/wh",
            "p/cbhg/highway/gates/3/b", "s/cbhg/bn_bank/15/var",
            "s/cbhg/bn_proj2/mean", "p/post/w"} <= mine.keys()
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_checkpoint_round_trip_and_make_mags(tmp_path):
    """save_vocoder_ckpt / load_vocoder_ckpt give back the trees exactly;
    a file of another tree is refused; make_mags writes each dump's
    magnitudes, cut to its frames, equal to one vocoder call on the padded
    batch."""
    p, s = _vocoder()
    path = str(tmp_path / "v.ckpt")
    TV.save_vocoder_ckpt(p, s, path)
    lp, ls = TV.load_vocoder_ckpt(path, device="cpu")
    for a, b in ((lp, p), (ls, s)):
        fa, fb = tree_paths(a), tree_paths(b)
        assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fb)
    bad = dict(p, cbhg=dict(p["cbhg"], gru=p["cbhg"]["gru"][:1]))
    TV.save_vocoder_ckpt(bad, s, str(tmp_path / "bad.ckpt"))
    with pytest.raises(ValueError, match="template"):
        TV.load_vocoder_ckpt(str(tmp_path / "bad.ckpt"), device="cpu")
    rng = np.random.default_rng(6)
    mels = {"a": rng.uniform(size=(11, 80)), "b": rng.uniform(size=(7, 80))}
    for f, m in mels.items():
        np.save(tmp_path / f"{f}.pt", m.astype(np.float32))      # -> <f>.pt.npy
    TV.make_mags(lp, ls, str(tmp_path), ["a", "b"], out_dir=str(tmp_path / "out"),
                 batch_size=2, mel_len=16)
    batch = np.zeros((2, 16, 80), np.float32)
    for i, m in enumerate(mels.values()):
        batch[i, :len(m)] = m
    want = TV._vocode_batch(p, s, torch.from_numpy(batch)).numpy()
    for i, (f, m) in enumerate(mels.items()):
        got = np.load(tmp_path / "out" / f"{f}.mag.npy")
        assert got.shape == (len(m), VG.N_FFT // 2 + 1)
        np.testing.assert_array_equal(got, want[i, :len(m)])


def test_vocoder_cli_trains_and_infers(tmp_path, capsys):
    """`python -m unast_tpu_torch.infer.vocoder` (its main, in this process)
    on configs/vocoder.json cut to hidden 8 and 32 frames: one epoch on a
    synthetic corpus of 4 items (3 train, 1 valid, batch 2), a finite
    loss, a checkpoint; then --infer writes a .mag.npy for each dump of
    <out_test_dir>/mels equal to make_mags of the loaded checkpoint."""
    ck = str(tmp_path / "v.ckpt")
    cut = ["--config", str(VG.CONFIG), "--hidden", "8", "--data_mel_len", "32",
           "--device", "cpu", "--vocoder_ckpt", ck]
    TV.main(cut + ["--synthetic", "--synthetic_size", "4", "--train_batch_size", "2",
                   "--epochs", "1"])
    loss = float(capsys.readouterr().out.split("final vocoder loss: ")[1].split()[0])
    assert np.isfinite(loss) and loss > 0
    mels_dir = tmp_path / "test_out" / "mels"
    mels_dir.mkdir(parents=True)
    np.save(mels_dir / "x.pt", np.random.default_rng(7).uniform(size=(9, 80)).astype(np.float32))
    TV.main(cut + ["--infer", "--out_test_dir", str(tmp_path / "test_out")])
    got = np.load(mels_dir / "x.mag.npy")
    p, s = TV.load_vocoder_ckpt(ck, device="cpu")
    assert p["pre"]["w"].shape == (1, 80, 8)
    TV.make_mags(p, s, str(mels_dir), ["x"], out_dir=str(tmp_path / "ref"), mel_len=32)
    np.testing.assert_array_equal(got, np.load(tmp_path / "ref" / "x.mag.npy"))


def test_train_vocoder_split_and_batches():
    """train_vocoder trains on JAX's split (a numpy permutation seeded by
    args.seed, its last valid_size items held out) with
    BatchIterator(include_mag=True): it reads train items only, two
    batches of 2 an epoch, and returns one finite mean loss an epoch."""
    from unast_tpu_torch.data.dataset import SyntheticSpeechDataset
    args = parse_with_config(["--config", str(VG.CONFIG), "--hidden", "8",
                              "--data_mel_len", "24", "--train_batch_size", "2"])
    args.hidden_size, args.n_fft, args.valid_size = 8, 2048, 2
    held = set(np.random.default_rng(args.seed).permutation(6)[4:].tolist())

    class Recorder(SyntheticSpeechDataset):
        read = []

        def __getitem__(self, i):
            self.read.append(int(i))
            return super().__getitem__(i)
    ds = Recorder(size=6, seed=args.seed)
    params, vstate, losses = TV.train_vocoder(args, ds, epochs=2, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert len(Recorder.read) == 8 and not set(Recorder.read) & held, Recorder.read
    assert params["post"]["w"].shape == (1, 8, 1025)


def test_vocode_writes_manifest_wavs(tmp_path):
    """synthesize.vocode: each <fid>.mag.npy of a manifest becomes
    <fid>.wav, the PCM16 of mag_to_wav."""
    import wave
    (tmp_path / "list.csv").write_text("u1|hello|hello\nu2|world|world\n")
    rng = np.random.default_rng(8)
    mags = {f: rng.uniform(size=(12, 1025)).astype(np.float32) for f in ("u1", "u2")}
    for f, m in mags.items():
        np.save(tmp_path / f"{f}.mag.npy", m)
    ap = TAudioParams(n_iter=2)
    synthesize.vocode(str(tmp_path / "list.csv"), str(tmp_path), str(tmp_path / "o"),
                      params=ap, device="cpu")
    for f, m in mags.items():
        with wave.open(str(tmp_path / "o" / f"{f}.wav")) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        want = tdsp.mag_to_wav(m, ap, device="cpu")
        np.testing.assert_array_equal(pcm, (np.clip(want, -1, 1) * 32767).astype(np.int16))
