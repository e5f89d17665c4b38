"""The port's neural vocoders and streaming (models/melgan.py,
train/melgan.py, Synthesizer(melgan_params=, melgan_chunk=, pcm16=),
infer/streaming.py, bridge.melgan_from_jax) against the JAX package on
the CPU.

The same weights go to both sides: the port's inits as numpy trees
(tests/torch_melgan_golden.py), through bridge.melgan_from_jax. The JAX
side comes from the hash-guarded golden tests/goldens/torch_melgan.npz,
except crop_batch, which is numpy and runs live. Tolerances, float32
throughout: convs, generators, discriminator features and logits, STFT
magnitudes and losses 1e-5 (relative where values are large); one
vocoder step and one adversarial step: metrics 1e-5 relative (grad_norm
1e-4), params 1e-4 relative plus 1e-6 where JAX's first moment is above
the FFT's rounding noise (the golden's grad classes), within 2 lr
elsewhere, at most MAX_NOISE_SHARE of a leaf below that noise; PCM16
samples equal wherever JAX's scaled sample is more than PCM_MARGIN from a
rounding tie (elsewhere within one step, the float output being held to
1e-5); chunked and streamed vocoding equal to the whole forward within
the JAX tests' 1e-6 and 2e-5.
"""

import numpy as np
import pytest
import torch

from unast_tpu_torch.bridge import (ctc_from_jax, fastspeech_from_jax,
                                    melgan_from_jax, params_from_jax)
from unast_tpu_torch import nn as tnn
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.infer.streaming import (MelganStreamer, StreamingCtcAsr,
                                             stream_tts)
from unast_tpu_torch.models import ctc as TC, melgan as TG
import unast_tpu_torch.models as TMs
from unast_tpu_torch.train import melgan as TTM
from unast_tpu_torch.train.config import parse_with_config

import torch_ctc_golden as CG
import torch_melgan_golden as MG
import torch_train_golden as G

PCM_MARGIN = 0.01   # in LSB: a sample this close to a rounding tie may round either way
MAX_NOISE_SHARE = 0.2   # of a leaf's elements where JAX's gradient is rounding noise


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
    z = np.load(MG.GOLDEN)
    assert str(z["source_hash"]) == MG.source_hash(), (
        "tests/goldens/torch_melgan.npz is stale: the JAX package, a golden "
        "module or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_melgan_golden.py`")
    out = {k: z[k] for k in z.files}
    for k, v in MG.init_hashes().items():
        assert str(out[f"init_hash/{k}"]) == v, (
            f"the port's init behind {k} changed; run the golden module again")
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_rel(got, want, tol=1e-5):
    """Within tol of want's largest magnitude (and at least 1e-7 absolute)."""
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=max(tol * float(np.abs(want).max()), 1e-7))


def _gen(kind="melgan"):
    return melgan_from_jax(MG.gen_tree(kind))


def test_convs_match_jax(golden):
    """_conv (k7, dilation 3) and _convT at strides 5 and 11: lax's SAME
    transposed-conv padding, the kernel as given."""
    cp = melgan_from_jax(MG.conv_trees())
    x = _t(MG.conv_input())
    _close_rel(TG._conv(cp["conv"], x, dilation=3), golden["conv"])
    for s in (5, 11):
        y = TG._convT(cp[f"up{s}"], x, s)
        assert y.shape == (2, 7 * s, 4)
        _close_rel(y, golden[f"convT{s}"])


@pytest.mark.parametrize("kind", ["melgan", "hifigan"])
def test_generators_match_jax(golden, kind):
    p = _gen(kind)
    wav = TG.generator_forward(p, _t(MG.gen_mel()))
    assert wav.shape == (2, 9 * MG.HOP) and float(wav.abs().max()) <= 1.0
    np.testing.assert_allclose(_np(wav), golden[f"gen/{kind}"], rtol=0, atol=1e-5)
    assert TG.receptive_field(p) == (48 if kind == "hifigan" else 24)
    assert TG.num_params(p) == sum(a.size for a in G.flatten(MG.gen_tree(kind)).values())


def test_discriminators_match_jax(golden):
    """adv_disc_forward over msd+mpd: every feature and logit; the MPD folds
    the reflect-padded wav by its period; a bare MSD list (the legacy tree)
    dispatches to discriminator_forward."""
    d = melgan_from_jax(MG.disc_tree("msd+mpd", 3))
    wav = _t(MG.disc_wav())
    outs = TG.adv_disc_forward(d, wav)
    assert len(outs) == 3 + 5
    for i, (feats, logits) in enumerate(outs):
        _close_rel(logits, golden[f"disc/{i}/logits"])
        n_feats = sum(1 for k in golden if k.startswith(f"disc/{i}/feat/"))
        assert len(feats) == n_feats
        for j, f in enumerate(feats):
            _close_rel(f, golden[f"disc/{i}/feat/{j}"])
    for (_, period_logits), p in zip(outs[3:], (2, 3, 5, 7, 11)):
        assert period_logits.shape[2:] == (p, 1)
    legacy = TG.adv_disc_forward(d["msd"], wav)
    assert all(torch.equal(a[1], b[1]) for a, b in zip(legacy, outs[:3]))


def test_stft_loss_matches_jax(golden):
    mel, wav = MG.step_case()
    _close_rel(TTM.stft_mag(_t(wav), 512, 128), golden["stft_mag"])
    pred = TG.generator_forward(_gen(), _t(mel))
    loss, sc = TTM.mr_stft_loss(pred, _t(wav))
    np.testing.assert_allclose(float(loss), golden["mr_stft/loss"], rtol=1e-5)
    np.testing.assert_allclose(float(sc), golden["mr_stft/sc"], rtol=1e-5)
    zero, _ = TTM.mr_stft_loss(_t(wav), _t(wav))
    assert float(zero) == 0.0


def _check_metrics(m, golden, prefix):
    keys = {k[len(prefix):] for k in golden if k.startswith(prefix)}
    assert keys == set(m), (keys, set(m))
    for k in keys:
        np.testing.assert_allclose(float(m[k]), golden[prefix + k],
                                   rtol=1e-4 if k == "grad_norm" else 1e-5,
                                   atol=1e-7, err_msg=k)


def _check_params(flat, lr, golden, prefix, grad_prefix):
    """New params (flat) 1e-4 relative plus 1e-6 where JAX's first moment
    is above MG.GRAD_NOISE of its leaf's largest (grad class 2). Below it
    the first Adam step's sign may flip on the FFT's rounding, and where
    JAX's moment is exactly 0 (at init every hinge of the discriminator's
    loss is active, so its real and fake terms cancel) the port's holds
    rounding: within 2 lr there. A leaf may have at most MAX_NOISE_SHARE
    of its elements below the noise floor, so a leaf whose gradient the
    port lost cannot pass."""
    want = {k[len(prefix):]: golden[k] for k in golden if k.startswith(prefix)}
    assert set(flat) == set(want)
    for path, v in flat.items():
        cls = golden[grad_prefix + path]
        assert (cls == 1).mean() <= MAX_NOISE_SHARE, (path, (cls == 1).mean())
        tight = cls == 2
        np.testing.assert_allclose(v[tight], want[path][tight], rtol=1e-4, atol=1e-6,
                                   err_msg=path)
        assert (np.abs(v - want[path]) <= 2 * lr + 1e-6).all(), path


def test_vocoder_and_adversarial_steps_match_jax(golden):
    """One make_vocoder_step and one make_adversarial_step (ADV_DISC) from
    the same generator, AdamW with optax's weight decay 1e-4 behind the
    global-norm clip: metrics, the new generator, and the discriminator's
    update per leaf (its sum and its sum of magnitudes, small leaves
    whole)."""
    args = parse_with_config(MG.STEP_ARGV)
    mel, wav = (_t(a) for a in MG.step_case())
    vs = TTM.VocTrainState(_gen(), TTM._voc_tx(args).init(_gen()), 0)
    new, m = TTM.make_vocoder_step(args)(vs, mel, wav)
    _check_metrics(m, golden, "voc_step/metric/")
    _check_params(G.flatten(new.params), args.lr, golden, "voc_step/params/",
                  "voc_step/grad/")
    disc0 = melgan_from_jax(MG.disc_tree(MG.ADV_DISC, 2))
    tx = TTM._voc_tx(args)
    ats = TTM.AdvTrainState(vs.params, vs.opt, disc0, tx.init(disc0), 0)
    new, m = TTM.make_adversarial_step(args)(ats, mel, wav)
    _check_metrics(m, golden, "adv_step/metric/")
    _check_params(G.flatten(new.gen), args.lr, golden, "adv_step/gen/",
                  "adv_step/gen_grad/")
    old, disc = G.flatten(disc0), G.flatten(new.disc)
    _check_params({k: a for k, a in disc.items() if f"adv_step/disc/{k}" in golden},
                  args.lr, golden, "adv_step/disc/", "adv_step/disc_grad/")
    for path, a in disc.items():
        d = a.astype(np.float64) - old[path]
        # each element moves by at most about lr; one whose gradient is
        # within rounding of zero may move differently (2 lr of slack)
        slack = 1e-4 * np.abs(d).sum() + 2 * args.lr
        for kind, got in (("abs", np.abs(d).sum()), ("sum", d.sum())):
            np.testing.assert_allclose(got, golden[f"adv_step/disc_{kind}/{path}"],
                                       rtol=0, atol=slack, err_msg=path)


def _syn(**kw):
    jp, js = params_from_jax(*CG.joint_trees())
    return Synthesizer(jp, js, MG.syn_cfg(TMs), nar_pv=fastspeech_from_jax(*MG.nar_trees()),
                       melgan_params=_gen(), device="cpu", **MG.SYN_KW, **kw)


def _assert_pcm_equal(got, want, want_float):
    """int16 samples equal where JAX's scaled float sample is more than
    PCM_MARGIN from a rounding tie, within one step elsewhere."""
    scaled = np.clip(want_float.astype(np.float64), -1, 1) * 32767.0
    near = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) <= PCM_MARGIN
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff[~near] == 0).all() and (diff <= 1).all(), (diff.max(), near.sum())


def test_synthesizer_melgan_pcm16_and_chunks_match_jax(golden):
    """Synthesizer(nar_pv=, melgan_params=): NAR mels, float and PCM16
    waveforms (the NAR frame rule keeps every frame, the int16 trim) as
    JAX's; melgan_chunk=CHUNK over exact context windows equal to the
    whole-bucket vocode within 1e-6, and its PCM16 waveforms within one
    step of the whole vocode's; melgan_chunk=None vocodes this small
    bucket whole."""
    whole, whole16 = _syn(melgan_chunk=0), _syn(melgan_chunk=0, pcm16=True)
    np.testing.assert_allclose(whole.tts_mels(MG.SYN_TEXTS[:1])[0],
                               golden["syn/mels/0"], rtol=1e-5, atol=1e-5)
    f32, i16 = whole.tts(MG.SYN_TEXTS), whole16.tts(MG.SYN_TEXTS)
    for i, (w, w16) in enumerate(zip(f32, i16)):
        want = golden[f"syn/pcm16_0/{i}"]
        assert w.dtype == np.float32 and w.shape == want.shape
        np.testing.assert_allclose(w, want, rtol=0, atol=1e-5)
        assert w16.dtype == np.int16 and w16.shape == golden[f"syn/pcm16_1/{i}"].shape
        _assert_pcm_equal(w16, golden[f"syn/pcm16_1/{i}"], want)
    mel_b = whole._tts_chunk_seqs([np.arange(3, 11)])[0]
    chunked = _syn(melgan_chunk=MG.CHUNK, pcm16=True)
    with torch.inference_mode():
        full = whole._melgan_vocode(mel_b)
        chunked.pcm16 = False
        windows = chunked._melgan_vocode(mel_b)
        chunked.pcm16 = True
        assert torch.equal(_syn()._melgan_vocode(mel_b), full)   # auto: whole
    assert windows.shape == full.shape == (1, MG.SYN_MAX_MEL * MG.HOP)
    np.testing.assert_allclose(_np(windows), _np(full), rtol=0, atol=1e-6)
    for w16, want in zip(chunked.tts(MG.SYN_TEXTS), i16):
        assert w16.shape == want.shape
        assert (np.abs(w16.astype(np.int32) - want) <= 1).all()


def test_streaming_vocoder_matches_jax_and_whole_forward(golden):
    """MelganStreamer and stream_tts: the concatenated chunks equal JAX's
    and the whole forward of the mel zero-padded to a chunk multiple
    (2e-5, as tests/test_streaming.py); a context of 1 frame does not."""
    p = _gen()
    mel = MG.stream_mel()
    got = np.concatenate(list(MelganStreamer(p, MG.HOP, chunk=8).stream(mel)))
    np.testing.assert_allclose(got, golden["streamer"], rtol=2e-5, atol=2e-5)
    padded = np.zeros((32, 80), np.float32)
    padded[:30] = mel
    with torch.inference_mode():
        full = _np(TG.generator_forward(p, _t(padded[None])))[0, :30 * MG.HOP]
    np.testing.assert_allclose(got, full, rtol=2e-5, atol=2e-5)
    short = np.concatenate(list(MelganStreamer(p, MG.HOP, chunk=8, ctx=1).stream(mel)))
    assert not np.allclose(short, full, rtol=2e-5, atol=2e-5)
    syn = _syn(melgan_chunk=0)
    streamed = np.concatenate(list(stream_tts(syn, MG.STREAM_TEXT, chunk=MG.CHUNK)))
    np.testing.assert_allclose(streamed, golden["stream_tts"], rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="melgan_params"):
        next(stream_tts(Synthesizer(*params_from_jax(*CG.joint_trees()), MG.syn_cfg(TMs),
                                    device="cpu"), MG.STREAM_TEXT))


def test_streaming_ctc_asr_matches_jax_and_one_shot(golden):
    """StreamingCtcAsr fed one chunk a step: the emitted transcripts equal
    JAX's and the one-shot greedy decode of the same chunk-masked model."""
    cfg = CG.variant_cfg("chunk", TMs)
    p, s = ctc_from_jax(*CG.ctc_trees("chunk"))
    mel, lens = CG.mel_case()
    asr = StreamingCtcAsr(p, cfg).reset(batch_size=2).warm()
    for t0 in range(0, mel.shape[1], MG.ASR_FEED):
        part = mel[:, t0:t0 + MG.ASR_FEED]
        asr.step(part, n_valid=np.clip(lens - t0, 0, part.shape[1]))
    (ids, n), _ = TC.ctc_asr_infer(p, s, tnn.Ctx.eval(), cfg, _t(mel), _t(lens).long())
    for i in range(2):
        assert asr.emitted[i] == golden[f"stream_asr/{i}"].tolist()
        assert asr.emitted[i] == ids[i, :int(n[i])].tolist()


def test_crop_batch_matches_jax(tmp_path):
    """crop_batch is numpy: the port's and JAX's draw the same crops from
    the same seed, on items and on MelWavCrops over packed shards."""
    from unast_tpu.train.melgan import crop_batch as jax_crop_batch
    from unast_tpu_torch.data.shard import (MelWavCrops, PackedShardDataset,
                                            WavShardDataset, write_shard,
                                            write_wav_shard)
    rng = np.random.default_rng(35)
    frames = [90, 30, 12]
    items = [{"ids": np.arange(3, 9, dtype=np.int32),
              "mel": rng.uniform(size=(f, 80)).astype(np.float32),
              "wav": rng.uniform(-1, 1, size=f * MG.HOP).astype(np.float32)}
             for f in frames]
    write_shard(items, str(tmp_path / "m.unsh"))
    write_wav_shard([it["wav"] for it in items], str(tmp_path / "w.unwv"))
    crops = MelWavCrops(PackedShardDataset(str(tmp_path / "m.unsh")),
                        WavShardDataset(str(tmp_path / "w.unwv")))
    for ds in (items, crops):
        a = TTM.crop_batch(ds, np.random.default_rng(3), 5, 20, MG.HOP)
        b = jax_crop_batch(ds, np.random.default_rng(3), 5, 20, MG.HOP)
        assert a[0].shape == (5, 20, 80) and a[1].shape == (5, 20 * MG.HOP)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
