"""Neural-vocoder trainer of the port, mirroring `unast_tpu/train/melgan.py`:
the MelGAN or HiFi-GAN generator (models/melgan.py) trained on (mel, wav)
crops with the multi-resolution STFT loss (spectral convergence +
log-magnitude L1 at three resolutions) plus a time-domain L1, then
optionally fine-tuned adversarially (hinge GAN + feature matching, the
STFT term kept) against the multi-scale and/or multi-period
discriminators.

The optimizer is optax.adamw(lr) with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8, weight decay 1e-4) behind global-norm clipping at
--vocoder_grad_clip: train/optim.py's Optimizer with those numbers.

CLI: python -m unast_tpu_torch.train.melgan [--vocoder_steps N]
     [--melgan_gen hifigan] [--melgan_adv_steps N] [--device cpu]
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from ..audio.dsp import frame_signal
from ..device import resolve_device
from ..models import melgan as G
from .optim import (Optimizer, apply_updates, global_norm, tree_leaves,
                    tree_map, tree_unflatten)

RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))
ADAMW_WEIGHT_DECAY = 1e-4   # optax.adamw's default


def _wide(x):
    """x in float32, the JAX package's dtype for the STFT loss, or in
    float64 when it is float64 (a well-conditioned reference run)."""
    return x if x.dtype == torch.float64 else x.float()


def stft_mag(y, n_fft: int, hop: int):
    """unast_tpu/train/melgan.py::stft_mag: y [B, n] -> magnitudes
    [B, T, n_fft//2+1] in float32 (float64 for a float64 y), framed with
    no padding under numpy's symmetric np.hanning window."""
    y = _wide(y)
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(y.device, y.dtype)
    frames = frame_signal(y, n_fft, hop) * window
    return torch.abs(torch.fft.rfft(frames, n=n_fft, dim=-1))


def mr_stft_loss(pred, gold):
    """unast_tpu/train/melgan.py::mr_stft_loss: the mean over RESOLUTIONS
    of spectral convergence plus the mean log-magnitude L1. Returns (loss,
    mean spectral convergence)."""
    eps = 1e-7
    scs, mags = [], []
    for n_fft, hop in RESOLUTIONS:
        pm = stft_mag(pred, n_fft, hop)
        gm = stft_mag(gold, n_fft, hop)
        b = gm.shape[0]
        sc = (torch.linalg.vector_norm((gm - pm).reshape(b, -1), dim=1)
              / torch.clamp(torch.linalg.vector_norm(gm.reshape(b, -1), dim=1),
                            min=eps))
        scs.append(sc.mean())
        mags.append(torch.abs(torch.log(gm + eps) - torch.log(pm + eps)).mean())
    sc_mean = sum(scs) / len(scs)
    return sc_mean + sum(mags) / len(mags), sc_mean


class VocTrainState(NamedTuple):
    """unast_tpu/train/melgan.py::VocTrainState."""
    params: Any
    opt: Any
    step: int


def _voc_tx(args) -> Optimizer:
    """unast_tpu/train/melgan.py::_voc_tx: AdamW at --lr behind global-norm
    clipping at --vocoder_grad_clip (none at 0)."""
    lr = float(getattr(args, "lr", 1e-4) or 1e-4)
    clip = float(getattr(args, "vocoder_grad_clip", 5.0) or 0.0)
    return Optimizer("adamw", ADAMW_WEIGHT_DECAY, clip, lambda step: lr)


def init_voc_state(gen: torch.Generator, args, n_mels: int = 80,
                   device=None) -> VocTrainState:
    """unast_tpu/train/melgan.py::init_voc_state: a --melgan_gen generator
    of width --melgan_base from `gen` (a CPU generator) on `device` (None =
    cuda) and its optimizer state."""
    dev = resolve_device(device)
    params = G.generator_init(
        gen, kind=str(getattr(args, "melgan_gen", "") or "melgan"),
        n_mels=n_mels, base=int(getattr(args, "melgan_base", 0) or 256))
    params = tree_map(lambda x: x.to(dev), params)
    return VocTrainState(params, _voc_tx(args).init(params), 0)


def _grads(loss, live):
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(live, [torch.zeros_like(x) if g is None else g
                                 for x, g in zip(leaves, grads)])


def _live(tree):
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


def make_vocoder_step(args, wav_l1_weight: float = 1.0):
    """unast_tpu/train/melgan.py::make_vocoder_step: step(vs, mel [B, F,
    n_mels], wav [B, F*hop]) -> (new vs, metrics {'voc/stft', 'voc/sc',
    'voc/l1', 'grad_norm'})."""
    tx = _voc_tx(args)

    def step(vs: VocTrainState, mel, wav):
        live = _live(vs.params)
        pred = G.generator_forward(live, mel)
        stft, sc = mr_stft_loss(pred, wav)
        l1 = torch.abs(_wide(pred) - _wide(wav)).mean()
        grads = _grads(stft + wav_l1_weight * l1, live)
        with torch.no_grad():
            updates, opt = tx.update(grads, vs.opt, vs.params)
            params = apply_updates(vs.params, updates)
            metrics = {"voc/stft": stft.detach(), "voc/sc": sc.detach(),
                       "voc/l1": l1.detach(), "grad_norm": global_norm(grads)}
        return VocTrainState(params, opt, vs.step + 1), metrics

    return step


class AdvTrainState(NamedTuple):
    """unast_tpu/train/melgan.py::AdvTrainState."""
    gen: Any
    gen_opt: Any
    disc: Any
    disc_opt: Any
    step: int


def init_adv_state(gen: torch.Generator, vs: VocTrainState, args
                   ) -> AdvTrainState:
    """unast_tpu/train/melgan.py::init_adv_state: the STFT-pretrained
    generator of `vs`, and a --melgan_disc discriminator ('msd', 'mpd' or
    'msd+mpd') from `gen` on the generator's device, each with a fresh
    optimizer state."""
    dev = tree_leaves(vs.params)[0].device
    disc = G.adv_disc_init(gen, str(getattr(args, "melgan_disc", "") or "msd"))
    disc = tree_map(lambda x: x.to(dev), disc)
    tx = _voc_tx(args)
    return AdvTrainState(vs.params, tx.init(vs.params), disc, tx.init(disc), 0)


def _d_loss(disc, wav, fake):
    loss = 0.0
    for (_, lr_), (_, lf) in zip(G.adv_disc_forward(disc, wav),
                                 G.adv_disc_forward(disc, fake)):
        loss = loss + (torch.relu(1.0 - lr_).mean() + torch.relu(1.0 + lf).mean())
    return loss


def make_adversarial_step(args, fm_weight: float = 10.0,
                          stft_weight: float = 1.0):
    """unast_tpu/train/melgan.py::make_adversarial_step: step(ts, mel, wav)
    -> (new ts, metrics {'adv/g', 'adv/fm', 'voc/stft', 'voc/sc',
    'adv/d'}). The discriminator updates first, on the real wav and the
    generator's output without its gradient; the generator then trains
    against the UPDATED discriminator (hinge term, feature matching on the
    real features without their gradient, the STFT term); 'adv/d' is the
    discriminator loss re-evaluated after its update."""
    g_tx, d_tx = _voc_tx(args), _voc_tx(args)

    def step(ts: AdvTrainState, mel, wav):
        with torch.no_grad():
            fake_sg = G.generator_forward(ts.gen, mel)
        live_d = _live(ts.disc)
        d_grads = _grads(_d_loss(live_d, wav, fake_sg), live_d)
        with torch.no_grad():
            d_up, d_opt = d_tx.update(d_grads, ts.disc_opt, ts.disc)
            disc = apply_updates(ts.disc, d_up)
            real_outs = G.adv_disc_forward(disc, wav)

        live_g = _live(ts.gen)
        pred = G.generator_forward(live_g, mel)
        stft, sc = mr_stft_loss(pred, wav)
        adv = fm = 0.0
        for (fr, _), (ff, lf) in zip(real_outs, G.adv_disc_forward(disc, pred)):
            adv = adv - lf.mean()
            for a, b in zip(fr, ff):
                fm = fm + torch.abs(a - b).mean()
        g_grads = _grads(stft_weight * stft + adv + fm_weight * fm, live_g)
        with torch.no_grad():
            g_up, g_opt = g_tx.update(g_grads, ts.gen_opt, ts.gen)
            gen = apply_updates(ts.gen, g_up)
            metrics = {"adv/g": adv.detach(), "adv/fm": fm.detach(),
                       "voc/stft": stft.detach(), "voc/sc": sc.detach(),
                       "adv/d": _d_loss(disc, wav, fake_sg)}
        return AdvTrainState(gen, g_opt, disc, d_opt, ts.step + 1), metrics

    return step


def crop_batch(ds, rng: np.random.Generator, batch: int, frames: int,
               hop: int):
    """unast_tpu/train/melgan.py::crop_batch: random aligned (mel [B, F,
    80], wav [B, F*hop]) crops of items with a 'wav' key, zero-padded when
    short. A dataset with crop_pair / crop_lens (data/shard.py::
    MelWavCrops) reads only the window; both paths draw the same rng
    sequence, so a seed gives the same crops."""
    fast = hasattr(ds, "crop_pair")
    mels, wavs = [], []
    for _ in range(batch):
        i = int(rng.integers(len(ds)))
        if fast:
            mf, ns = ds.crop_lens(i)
            t_max = max(1, min(mf - frames, ns // hop - frames))
            t0 = int(rng.integers(t_max)) if t_max > 1 else 0
            m, w = ds.crop_pair(i, t0, frames, hop)
        else:
            it = ds[i]
            mel, wav = it["mel"], it["wav"]
            t_max = max(1, min(mel.shape[0] - frames,
                               len(wav) // hop - frames))
            t0 = int(rng.integers(t_max)) if t_max > 1 else 0
            m = mel[t0:t0 + frames]
            w = wav[t0 * hop:(t0 + frames) * hop]
            if m.shape[0] < frames:
                m = np.pad(m, ((0, frames - m.shape[0]), (0, 0)))
            if len(w) < frames * hop:
                w = np.pad(w, (0, frames * hop - len(w)))
        mels.append(m)
        wavs.append(w)
    return (np.stack(mels).astype(np.float32),
            np.stack(wavs).astype(np.float32))


def main(argv=None):
    """unast_tpu/train/melgan.py::main: train vocoder_steps steps (default
    2000) of --melgan_gen on crops of the synthetic corpus, then
    melgan_adv_steps adversarial steps, and save the generator's state to
    checkpoint_path. Runs on --device (default cuda). Returns the
    VocTrainState."""
    from ..audio.params import DEFAULT as P
    from ..data.dataset import SyntheticSpeechDataset
    from .checkpoint import save_ckp
    from .config import parse_with_config

    args = parse_with_config(argv)
    dev = resolve_device(getattr(args, "device", None))
    n_steps = int(getattr(args, "vocoder_steps", 0) or 2000)
    frames = int(getattr(args, "vocoder_crop_frames", 0) or 40)
    bs = args.train_batch_size

    ds = SyntheticSpeechDataset(size=int(args.synthetic_size), seed=0)
    vs = init_voc_state(torch.Generator().manual_seed(0), args, device=dev)
    gen_kind = str(getattr(args, "melgan_gen", "") or "melgan")
    print(f"{gen_kind} generator: {G.num_params(vs.params)} params")
    step = make_vocoder_step(args)
    rng = np.random.default_rng(args.seed)

    def crops():
        mel, wav = crop_batch(ds, rng, bs, frames, P.hop_length)
        return torch.from_numpy(mel).to(dev), torch.from_numpy(wav).to(dev)

    m = {}
    for i in range(n_steps):
        vs, m = step(vs, *crops())
        if (i + 1) % 100 == 0:
            print(f"step {i + 1}: " + " ".join(
                f"{k} {float(v):.4f}" for k, v in sorted(m.items())))

    adv_steps = int(getattr(args, "melgan_adv_steps", 0) or 0)
    if adv_steps > 0:
        ats = init_adv_state(torch.Generator().manual_seed(1), vs, args)
        a_step = make_adversarial_step(args)
        for i in range(adv_steps):
            ats, m = a_step(ats, *crops())
            if (i + 1) % 100 == 0:
                print(f"adv step {i + 1}: " + " ".join(
                    f"{k} {float(v):.4f}" for k, v in sorted(m.items())))
        # the fine-tuned generator with its own Adam moments
        vs = VocTrainState(ats.gen, ats.gen_opt, ats.step)

    if args.checkpoint_path:
        save_ckp(0, float(m["voc/sc"]), vs, True, args.checkpoint_path)
    return vs


if __name__ == "__main__":
    main()
