"""The case of tests/test_torch_train.py's whole-step test, and the golden of
the JAX train step on it.

The JAX step (unast_tpu/train/steps.py::make_train_step) at TINY width with
the discriminator, guided attention and attn_impl='flash' (Pallas in
interpret mode) takes some 80 s a mode to trace and compile on one CPU
core, more than the port's whole test budget. So this module runs it once,
in both deterministic modes, and keeps what it returns in
tests/goldens/torch_train_step.npz; the test runs the port on the same
weights and inputs and holds it to that file. The file records a hash of
the JAX package's sources, of this module and of the flagship config, and
of the versions of jax, jaxlib, optax and numpy, and one of the weights;
the test refuses a golden whose hashes no longer match: a change to any of
them means running this module again.

    JAX_PLATFORMS=cpu python tests/torch_train_golden.py

Case: TINY dims with use_discriminator and attn_impl='flash' in float32;
the weights of the port's unast_init from torch seed 0 (init_trees), on
both sides;
the train args of configs/transformer_d_curriculum_fast.json (adamw, clip
1.0, multistep lr 1e-4, ga_weight 0.5, ae 2 / cm 1 / d 1 micro-batches)
with sp_steps cut to 2; batches of 2 from numpy seed 0, text 12 and mel 20
long with ragged lengths. Modes: 'eval' (objective_eval_mode) and 'train'
(train mode with every drop probability and mask at 0: the config's
dropouts, noise_mask_p and SpecAugment spans, and the two fixed ones,
positional_encoding's 0.1 and lstm_discriminator's 0.2, patched to 0 on
both sides by unast_tpu_torch/train/steps.py::zero_fixed_dropouts).
"""

import contextlib
import hashlib
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "transformer_d_curriculum_fast.json"
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_train_step.npz"
MODES = ("eval", "train")
STEPS = {"ae": 2, "cm": 1, "sp": 2, "d": 1}
B, TEXT_LEN, MEL_LEN, NUM_MELS = 2, 12, 20, 80


def model_overrides(mode):
    """ModelConfig.replace keywords on TINY for `mode`."""
    from unast_tpu_torch.train.steps import ZERO_DROPOUTS
    kw = dict(use_discriminator=True, attn_impl="flash")
    if mode == "train":
        kw.update(ZERO_DROPOUTS)
    return kw


def batches_np(seed: int = 0):
    """{objective: (text [n, B, Tt] int32, mel [n, B, Tm, 80] float32,
    text_len [n, B] int32, mel_len [n, B] int32)}: tokens 3..45 with EOS at
    len - 1 and PAD after, mel uniform in [0, 1) and zero past len."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n in STEPS.items():
        tl = rng.integers(4, TEXT_LEN + 1, size=(n, B)).astype(np.int32)
        ml = rng.integers(6, MEL_LEN + 1, size=(n, B)).astype(np.int32)
        text = rng.integers(3, 46, size=(n, B, TEXT_LEN)).astype(np.int32)
        mel = rng.uniform(0, 1, size=(n, B, MEL_LEN, NUM_MELS)).astype(np.float32)
        pos = np.arange(TEXT_LEN)
        text = np.where(pos == tl[..., None] - 1, 2, text)
        text = np.where(pos >= tl[..., None], 0, text).astype(np.int32)
        mel = mel * (np.arange(MEL_LEN) < ml[..., None])[..., None]
        out[name] = (text, mel, tl, ml)
    return out


def init_trees():
    """(params, BN state) of the port's unast_init at TINY with the
    discriminator, torch seed 0, as nested dicts and lists of numpy arrays;
    the JAX package's trees have the same names and shapes."""
    import torch
    from unast_tpu_torch.models import TINY, unast_init
    params, state = unast_init(torch.Generator().manual_seed(0),
                               TINY.replace(use_discriminator=True))

    def to_np(t):
        if isinstance(t, dict):
            return {k: to_np(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_np(v) for v in t]
        return t.numpy()
    return to_np(params), to_np(state)


def init_hash(params) -> str:
    """sha256 of the flattened weights."""
    h = hashlib.sha256()
    for k, v in sorted(flatten(params).items()):
        h.update(k.encode())
        h.update(v.tobytes())
    return h.hexdigest()


def flatten(tree):
    """{path: float32 numpy array} of a nested dict/list tree."""
    from unast_tpu_torch.train.optim import tree_paths
    return {k: np.asarray(v, np.float32) for k, v in tree_paths(tree).items()}


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module, the config and
    the versions of the libraries that make the JAX step's numbers."""
    import jax
    import jaxlib
    import optax
    h = hashlib.sha256()
    files = sorted((ROOT / "unast_tpu").rglob("*.py")) + [Path(__file__), CONFIG]
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, optax, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def freeze():
    """Run the JAX step in both modes and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    from unast_tpu.models import TINY, modules, unast
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.optim import split_params
    from unast_tpu.train.steps import TrainState, make_optimizers, make_train_step
    from unast_tpu_torch.train.steps import zero_fixed_dropouts

    def adam_mu(opt_state):
        return next(s.mu for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))

    params, state = jax.tree_util.tree_map(jnp.asarray, init_trees())
    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(init_hash(params))}
    batches = jax.tree_util.tree_map(jnp.asarray, batches_np())
    for mode in MODES:
        cfg = TINY.replace(**model_overrides(mode))
        args = parse_with_config(["--config", str(CONFIG), "--sp_steps", "2"])
        args.objective_eval_mode = mode == "eval"
        gen_tx, disc_tx = make_optimizers(cfg, args)
        gen_p, disc_p = split_params(params)
        ts = TrainState(params, state, gen_tx.init(gen_p), disc_tx.init(disc_p),
                        jnp.int32(0))
        patch = (zero_fixed_dropouts(modules, unast) if mode == "train"
                 else contextlib.nullcontext())
        with patch:
            new, metrics = jax.jit(make_train_step(cfg, args))(
                ts, jax.random.PRNGKey(1), batches)
        trees = {"metrics": dict(metrics), "params": new.params,
                 "state": new.net_state, "gen_mu": adam_mu(new.gen_opt),
                 "disc_mu": adam_mu(new.disc_opt)}
        for name, tree in trees.items():
            for path, a in flatten(jax.device_get(tree)).items():
                out[f"{mode}/{name}/{path}"] = a
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    freeze()
