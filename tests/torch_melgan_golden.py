"""The cases of tests/test_torch_melgan.py, and the golden of the JAX
package on them: models/melgan.py (the same-padded and transposed convs,
the MelGAN and HiFi-GAN generators, the multi-scale and multi-period
discriminators through their dispatch), train/melgan.py (stft_mag,
mr_stft_loss, one vocoder step and one adversarial step),
Synthesizer(nar_pv=, melgan_params=, pcm16=), infer/streaming.py
(MelganStreamer, stream_tts, StreamingCtcAsr).

JAX compiles the steps and the Synthesizer's programs for minutes on one
CPU core, more than the port's test budget, so this module runs them once
and keeps what they return in tests/goldens/torch_melgan.npz, guarded by
hashes as tests/torch_ctc_golden.py's file is; the tests refuse a stale
golden: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_melgan_golden.py

Weights, from the port's inits (torch seeds below): generators of base
BASE (melgan seed 0, hifigan seed 1), the adversarial step's
discriminator of kind ADV_DISC (seed 2), the discriminators of the
forward case msd+mpd (seed 3), the FastSpeech student of the serving
cases (seed 4, TINY, duration bias raised by 2) beside torch_ctc_golden's
joint model, and its chunk-masked CTC model for StreamingCtcAsr. With
each step's params, the class of JAX's first moment per element
(grad_class), which tells the tests where a param must match tightly.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_ctc_golden as CG
import torch_train_golden as G

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_melgan.npz"
BASE = 32
ADV_DISC = "msd"
HOP = 275
STEP_ARGV = ["--lr", "1e-3", "--vocoder_grad_clip", "5.0",
             "--melgan_disc", ADV_DISC]
SYN_MAX_MEL = 96
SYN_KW = dict(text_buckets=(8, 16), mel_buckets=(SYN_MAX_MEL,), max_batch=2)
SYN_TEXTS = ["hi there", "ok"]
CHUNK = 16          # melgan_chunk and the streamers' chunk
STREAM_TEXT = "hi there"
ASR_FEED = 4        # frames fed to StreamingCtcAsr a step (one chunk)
# a first moment at or below GRAD_NOISE of its leaf's largest is rounding
# noise: the log-magnitude STFT term weighs a bin by 1/|X|, so the FFT's
# rounding at near-zero bins flips the sign of gradient elements up to
# 1e-4..3e-4 of their leaf's largest (JAX against the port, measured)
GRAD_NOISE = 1e-3


def _to_np(t):
    return CG._to_np(t)


def grad_class(mu):
    """Per element of Adam's first moment after one step: 0 where it is
    exactly 0, 1 where it is nonzero but at most GRAD_NOISE of its leaf's
    largest, 2 above."""
    mu = np.abs(np.asarray(mu))
    return np.where(mu == 0, 0, np.where(mu <= GRAD_NOISE * mu.max(), 1, 2)).astype(np.uint8)


def adam_mu(opt_state):
    """The first moment `mu` of an optax chain's Adam state."""
    import jax
    return next(x.mu for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))


def gen_tree(kind: str):
    """The port's generator_init(kind, base=BASE) as a numpy tree (torch
    seed 0 for melgan, 1 for hifigan)."""
    import torch
    from unast_tpu_torch.models.melgan import generator_init
    seed = {"melgan": 0, "hifigan": 1}[kind]
    return _to_np(generator_init(torch.Generator().manual_seed(seed), kind,
                                 base=BASE))


def disc_tree(kind: str, seed: int):
    """The port's adv_disc_init(kind) as a numpy tree."""
    import torch
    from unast_tpu_torch.models.melgan import adv_disc_init
    return _to_np(adv_disc_init(torch.Generator().manual_seed(seed), kind))


def conv_trees():
    """A k7 conv (6 -> 4 channels) and the k10 / k22 transposed convs of
    strides 5 and 11 (torch seed 5)."""
    import torch
    from unast_tpu_torch.models.melgan import _conv_init
    g = torch.Generator().manual_seed(5)
    return _to_np({"conv": _conv_init(g, 6, 4, 7), "up5": _conv_init(g, 6, 4, 10),
                   "up11": _conv_init(g, 6, 4, 22)})


def nar_trees():
    """The serving cases' FastSpeech student: fastspeech_init at TINY, torch
    seed 4, the duration bias raised by 2 (about 6 frames a token)."""
    import torch
    from unast_tpu_torch.models import TINY
    from unast_tpu_torch.models.fastspeech import fastspeech_init
    p, s = _to_np(fastspeech_init(torch.Generator().manual_seed(4), TINY))
    p["dur"]["fc"]["b"] = p["dur"]["fc"]["b"] + np.float32(2.0)
    return p, s


def syn_cfg(cfg_module):
    """The serving cases' config: TINY, flash, ctc_weight 0.3 (the joint
    model's head), max_mel_len SYN_MAX_MEL so chunking takes windows."""
    return cfg_module.TINY.replace(attn_impl="flash", ctc_weight=CG.CTC_WEIGHT,
                                   max_mel_len=SYN_MAX_MEL)


def conv_input():
    """x [2, 7, 6] normal, numpy seed 30."""
    return np.random.default_rng(30).normal(size=(2, 7, 6)).astype(np.float32)


def gen_mel(frames: int = 9, seed: int = 31):
    """mel [2, frames, 80] uniform in [0, 1)."""
    return np.random.default_rng(seed).uniform(size=(2, frames, 80)).astype(np.float32)


def disc_wav():
    """wav [1, 128] uniform in [-1, 1), numpy seed 32 (128 is no multiple
    of 3, 7 or 11, so the MPD reflect-pads)."""
    return np.random.default_rng(32).uniform(-1, 1, size=(1, 128)).astype(np.float32)


def step_case():
    """A crop batch: mel [2, 8, 80] uniform and wav [2, 8*HOP] a noisy sine,
    numpy seed 33 (2200 samples: the 2048-point STFT fits once)."""
    rng = np.random.default_rng(33)
    mel = rng.uniform(size=(2, 8, 80)).astype(np.float32)
    n = np.arange(8 * HOP)
    wav = 0.5 * np.sin(2 * np.pi * np.array([[220.0], [330.0]]) * n / 22050.0)
    wav = wav + 0.05 * rng.normal(size=wav.shape)
    return mel, wav.astype(np.float32)


def stream_mel():
    """mel [30, 80] uniform, numpy seed 34 (30 is no multiple of 8)."""
    return np.random.default_rng(34).uniform(size=(30, 80)).astype(np.float32)


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the modules
    it builds on, and the library versions."""
    import jax
    import jaxlib
    import optax
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    files = (sorted((ROOT / "unast_tpu").rglob("*.py"))
             + [Path(__file__), here / "torch_ctc_golden.py",
                here / "torch_serve_golden.py", here / "torch_train_golden.py"])
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, optax, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def init_hashes():
    """{name: hash} of every port init the golden was made from."""
    return {"melgan": G.init_hash(gen_tree("melgan")),
            "hifigan": G.init_hash(gen_tree("hifigan")),
            "conv": G.init_hash(conv_trees()),
            "nar": G.init_hash(nar_trees()[0]),
            "joint": G.init_hash(CG.joint_trees()[0])}


def freeze():
    """Run the JAX package on every case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu import models as JM
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.infer.streaming import (MelganStreamer, StreamingCtcAsr,
                                           stream_tts)
    from unast_tpu.models import melgan as MG
    from unast_tpu.train import melgan as TM
    from unast_tpu.train.config import parse_with_config

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    out = {"source_hash": np.array(source_hash())}
    for k, v in init_hashes().items():
        out[f"init_hash/{k}"] = np.array(v)
    cp = J(conv_trees())
    x = jnp.asarray(conv_input())
    out["conv"] = np.asarray(MG._conv(cp["conv"], x, dilation=3))
    out["convT5"] = np.asarray(MG._convT(cp["up5"], x, 5))
    out["convT11"] = np.asarray(MG._convT(cp["up11"], x, 11))
    for kind in ("melgan", "hifigan"):
        out[f"gen/{kind}"] = np.asarray(jax.jit(MG.generator_forward)(
            J(gen_tree(kind)), jnp.asarray(gen_mel())))
    outs = MG.adv_disc_forward(J(disc_tree("msd+mpd", 3)), jnp.asarray(disc_wav()))
    for i, (feats, logits) in enumerate(outs):
        out[f"disc/{i}/logits"] = np.asarray(logits)
        for j, f in enumerate(feats):
            out[f"disc/{i}/feat/{j}"] = np.asarray(f)

    mel, wav = step_case()
    pred = np.asarray(MG.generator_forward(J(gen_tree("melgan")), jnp.asarray(mel)))
    out["stft_mag"] = np.asarray(TM.stft_mag(jnp.asarray(wav), 512, 128))
    loss, sc = TM.mr_stft_loss(jnp.asarray(pred), jnp.asarray(wav))
    out["mr_stft/loss"], out["mr_stft/sc"] = np.asarray(loss), np.asarray(sc)

    args = parse_with_config(STEP_ARGV)
    gp = J(gen_tree("melgan"))
    tx = TM._voc_tx(args)
    vs = TM.VocTrainState(gp, tx.init(gp), jnp.int32(0))
    vs, m = jax.jit(TM.make_vocoder_step(args))(vs, jnp.asarray(mel), jnp.asarray(wav))
    for k, v in m.items():
        out[f"voc_step/metric/{k}"] = np.asarray(v)
    for path, a in G.flatten(jax.device_get(vs.params)).items():
        out[f"voc_step/params/{path}"] = a
    for path, mu in G.flatten(jax.device_get(adam_mu(vs.opt))).items():
        out[f"voc_step/grad/{path}"] = grad_class(mu)
    disc = J(disc_tree(ADV_DISC, 2))
    ats = TM.AdvTrainState(gp, tx.init(gp), disc, tx.init(disc), jnp.int32(0))
    ats, m = jax.jit(TM.make_adversarial_step(args))(ats, jnp.asarray(mel),
                                                     jnp.asarray(wav))
    for k, v in m.items():
        out[f"adv_step/metric/{k}"] = np.asarray(v)
    for path, a in G.flatten(jax.device_get(ats.gen)).items():
        out[f"adv_step/gen/{path}"] = a
    for path, mu in G.flatten(jax.device_get(adam_mu(ats.gen_opt))).items():
        out[f"adv_step/gen_grad/{path}"] = grad_class(mu)
    # the discriminator's update is large: per leaf, its sum and its sum of
    # magnitudes, with the last layer of each scale whole
    old = G.flatten(disc_tree(ADV_DISC, 2))
    d_mu = G.flatten(jax.device_get(adam_mu(ats.disc_opt)))
    for path, a in G.flatten(jax.device_get(ats.disc)).items():
        d = a.astype(np.float64) - old[path]
        out[f"adv_step/disc_sum/{path}"] = np.asarray(d.sum())
        out[f"adv_step/disc_abs/{path}"] = np.asarray(np.abs(d).sum())
        if a.size <= 1024:
            out[f"adv_step/disc/{path}"] = a
            out[f"adv_step/disc_grad/{path}"] = grad_class(d_mu[path])

    scfg = syn_cfg(JM)
    jp, js = J(CG.joint_trees())
    mp = J(gen_tree("melgan"))
    for pcm16 in (False, True):
        syn = Synthesizer(jp, js, scfg, nar_pv=J(nar_trees()), melgan_params=mp,
                          pcm16=pcm16, melgan_chunk=0, **SYN_KW)
        for i, w in enumerate(syn.tts(SYN_TEXTS)):
            out[f"syn/pcm16_{int(pcm16)}/{i}"] = np.asarray(w)
    out["syn/mels/0"] = np.asarray(syn.tts_mels(SYN_TEXTS[:1])[0])
    out["stream_tts"] = np.concatenate(list(stream_tts(syn, STREAM_TEXT, chunk=CHUNK)))
    out["streamer"] = np.concatenate(list(MelganStreamer(
        mp, HOP, chunk=8).stream(stream_mel())))

    ccfg = CG.variant_cfg("chunk", JM)
    asr = StreamingCtcAsr(J(CG.ctc_trees("chunk")[0]), ccfg)
    cmel, clen = CG.mel_case()
    asr.reset(batch_size=2)
    for t0 in range(0, cmel.shape[1], ASR_FEED):
        part = cmel[:, t0:t0 + ASR_FEED]
        asr.step(part, n_valid=np.clip(clen - t0, 0, part.shape[1]))
    for i in range(2):
        out[f"stream_asr/{i}"] = np.asarray(asr.emitted[i], np.int32)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
