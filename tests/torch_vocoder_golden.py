"""The cases of tests/test_torch_vocoder.py, and the golden of the JAX package
on them: the CBHG vocoder (models/unast.py::vocoder, infer/vocoder.py),
mag_to_wav and the Synthesizer serving through the vocoder.

The JAX side compiles the CBHG's forward and its train step, Griffin-Lim
and the Synthesizer's programs for every bucket, half a minute on one CPU
core, more than the port's test budget. So this module runs them once and
keeps what they return in tests/goldens/torch_vocoder.npz; the tests run
the port on the same weights and inputs and hold it to that file. The
file records a hash of the JAX package's sources, of this module and of
configs/vocoder.json, and of the versions of jax, jaxlib, optax and numpy,
and one of the weights; the tests refuse a golden whose hashes no longer
match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_vocoder_golden.py

Cases: the vocoder at hidden HIDDEN (configs/vocoder.json's 256 cut to
TINY's scale), 80 mels and n_fft 2048, with the weights of the port's
vocoder_init from torch seed 0 (init_trees) on both sides; inputs from
numpy seed 3 (inputs). highway, cbhg and vocoder in eval mode and in
train mode (batch BN statistics, no dropout in the CBHG); two updates of
make_vocoder_step with the train args of configs/vocoder.json (adamw,
clip 1.0, l1 loss) but sched_type 'none', so that both updates move the
params by lr = 1e-3 (the config's linear warm-up gives the first update
lr 0), with Adam's first moments; mag_to_wav of mag_case() (two
Griffin-Lim iterations); the Synthesizer on torch_train_golden's TINY
transformer weights with the stop bias lowered by 100 and this vocoder as
vocoder_pv, serving torch_serve_golden's TEXTS; synthesize_text of one
text on the same models.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_serve_golden as SG
import torch_train_golden as G

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "vocoder.json"
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_vocoder.npz"
HIDDEN, N_FFT = 16, 2048
MODES = ("eval", "train")
STEP_ARGV = ["--config", str(CONFIG), "--sched_type", "none"]
SYNTH_TEXT = "go now"


def to_np(t):
    if isinstance(t, dict):
        return {k: to_np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [to_np(v) for v in t]
    return t.numpy()


def init_trees():
    """(params, BN state) of the port's vocoder_init at HIDDEN and N_FFT,
    torch seed 0, as nested dicts and lists of numpy arrays."""
    import torch
    from unast_tpu_torch.models import ModelConfig, unast
    return to_np(unast.vocoder_init(torch.Generator().manual_seed(0),
                                    ModelConfig(hidden=HIDDEN), N_FFT))


def inputs():
    """mel [2, 20, 80] and mag [2, 20, 1025] uniform in [0, 1), x [2, 20,
    HIDDEN] normal (the highway's and the CBHG's input), numpy seed 3."""
    rng = np.random.default_rng(3)
    mel = rng.uniform(size=(2, 20, 80)).astype(np.float32)
    mag = rng.uniform(size=(2, 20, N_FFT // 2 + 1)).astype(np.float32)
    x = rng.normal(size=(2, 20, HIDDEN)).astype(np.float32)
    return mel, mag, x


def mag_case():
    """mag_to_wav's input: a [30, 1025] magnitude in [0, 1.2) (some bins
    over the clip at 1), numpy seed 4."""
    return np.random.default_rng(4).uniform(0, 1.2, size=(30, N_FFT // 2 + 1)
                                            ).astype(np.float32)


def serve_trees():
    """(model params, model state) of the Synthesizer case: the TINY
    transformer of torch_train_golden.init_trees with the stop bias lowered
    by 100."""
    params, state = G.init_trees()
    stop = params["speech_m"]["postnet"]["stop_proj"]
    stop["b"] = stop["b"] + np.float32(SG.STOP_BIAS)
    return params, state


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the modules
    it builds on, the config and the library versions."""
    import jax
    import jaxlib
    import optax
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    files = (sorted((ROOT / "unast_tpu").rglob("*.py"))
             + [Path(__file__), here / "torch_serve_golden.py",
                here / "torch_train_golden.py", CONFIG])
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, optax, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def freeze():
    """Run the JAX package on every case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    from unast_tpu import nn
    from unast_tpu.audio import dsp
    from unast_tpu.audio.params import AudioParams
    from unast_tpu.infer import vocoder as V
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.infer.synthesize import synthesize_text
    from unast_tpu.models import TINY, modules, unast
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.optim import make_optimizer

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    params, vstate = init_trees()
    mel, mag, x = inputs()
    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(G.init_hash(params))}
    for mode in MODES:
        ctx = nn.Ctx(rng=None, train=mode == "train")

        @jax.jit
        def run(p, s):
            cb = modules.cbhg(p["cbhg"], s["cbhg"], ctx, x)
            return (modules.highway(p["cbhg"]["highway"], x), cb,
                    unast.vocoder(p, s, ctx, mel))
        hw, (cb, cb_s), (vo, vo_s) = jax.device_get(run(J(params), J(vstate)))
        out[f"{mode}/highway"], out[f"{mode}/cbhg"], out[f"{mode}/vocoder"] = hw, cb, vo
        for name, tree in (("cbhg_state", cb_s), ("vocoder_state", vo_s)):
            for path, a in G.flatten(tree).items():
                out[f"{mode}/{name}/{path}"] = a

    args = parse_with_config(STEP_ARGV)
    tx = make_optimizer(args)
    step = V.make_vocoder_step(args, tx)
    p, s, opt = J(params), J(vstate), tx.init(J(params))
    for i in range(2):
        p, s, opt, loss = step(p, s, opt, jax.random.PRNGKey(i), jnp.asarray(mel),
                               jnp.asarray(mag))
        out[f"step/{i}/loss"] = np.asarray(loss)
        mu = next(x.mu for x in jax.tree_util.tree_leaves(
            opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(x, optax.ScaleByAdamState))
        for name, tree in (("params", p), ("state", s), ("mu", mu)):
            for path, a in G.flatten(jax.device_get(tree)).items():
                out[f"step/{i}/{name}/{path}"] = a

    ap = AudioParams(n_iter=2)
    out["mag_to_wav"] = dsp.mag_to_wav(mag_case(), ap)

    mp, ms = serve_trees()
    out["serve_init_hash"] = np.array(G.init_hash(mp))
    vpv = (J(params), J(vstate))
    syn = Synthesizer(J(mp), J(ms), TINY, vocoder_pv=vpv, audio_params=ap, **SG.KW)
    for i, w in enumerate(syn.tts(SG.TEXTS)):
        out[f"tts/{i}"] = w
    out["synthesize_text"] = synthesize_text(J(mp), J(ms), TINY, SYNTH_TEXT,
                                             vocoder_pv=vpv, audio_params=ap)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
