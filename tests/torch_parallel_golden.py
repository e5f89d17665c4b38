"""The data-parallel cases of tests/test_torch_parallel.py (and of its
worker, tests/torch_parallel_worker.py) and the golden of the JAX package
on them.

The case: one joint step (ae, cm, sp and d micro-batches, the
discriminator, guided attention and flash on, every dropout at 0) at TINY
from the port's unast_init (torch seed 0) on a global batch of B = 4 rows
whose first two rows (dp rank 0's) are long and whose last two (rank 1's)
are short, so each rank holds a different number of valid frames and
tokens. The JAX package runs it sharded over a 2-device CPU mesh (dp = 2)
with zero 0, 1 and 3 (unast_tpu/parallel/mesh.py::shard_train_step);
compiling those steps takes minutes, so this module runs them once and
keeps the metrics, the new params, the new BN state and the first Adam
moments of both optimizers in tests/goldens/torch_parallel.npz. The file records a hash of
the JAX package's sources, of this module and its config, and of the
library versions, and one of the weights; the test refuses a golden whose
hashes no longer match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_parallel_golden.py

Also the serving case of Synthesizer(mesh=): serve_trees (TINY, torch
seed 3), one_pass_trees, three texts and three random mels (asr_mels,
numpy seed 5), and asr_margins, the greedy ASR decode's top-1 lead at
every step.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "transformer_d_curriculum_fast.json"
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_parallel.npz"
ZEROS = (0, 1, 3)
ARGS = dict(ae_steps=1, cm_steps=1, sp_steps=1, d_steps=1)
STEPS = {"ae": 1, "cm": 1, "sp": 1, "d": 1}
B, TEXT_LEN, MEL_LEN, NUM_MELS = 4, 12, 20, 80
SYN_KW = dict(text_buckets=(16,), mel_buckets=(24,), max_batch=4)
SYN_TEXTS = ["hello world", "hi", "ok then"]


def model_overrides():
    """ModelConfig.replace keywords on TINY: the discriminator, flash, and
    every configured dropout at 0 (with steps.zero_fixed_dropouts)."""
    from unast_tpu_torch.train.steps import ZERO_DROPOUTS
    return dict(use_discriminator=True, attn_impl="flash", **ZERO_DROPOUTS)


def batches_np(seed: int = 0):
    """{objective: (text [1, B, Tt] int32, mel [1, B, Tm, 80] float32,
    text_len [1, B] int32, mel_len [1, B] int32)}: rows 0-1 long (text
    10-12 tokens, 16-20 frames), rows 2-3 short (4-6 tokens, 6-9 frames);
    tokens 3..45 with EOS at len - 1 and PAD after, mel uniform in [0, 1)
    and zero past len."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n in STEPS.items():
        tl = np.concatenate([rng.integers(10, TEXT_LEN + 1, size=(n, 2)),
                             rng.integers(4, 7, size=(n, 2))], 1).astype(np.int32)
        ml = np.concatenate([rng.integers(16, MEL_LEN + 1, size=(n, 2)),
                             rng.integers(6, 10, size=(n, 2))], 1).astype(np.int32)
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
    discriminator, torch seed 0, as numpy trees."""
    import torch_train_golden as G
    return G.init_trees()


def serve_trees():
    """The Synthesizer case's (params, BN state): the port's unast_init at
    TINY, torch seed 3."""
    import torch
    from unast_tpu_torch.models import TINY, unast_init
    return unast_init(torch.Generator().manual_seed(3), TINY)


def one_pass_trees():
    """Synthesizer keywords of the one-pass options at TINY: a FastSpeech
    student (torch seed 1, duration bias raised by 2), MelGAN at base 32
    (seed 2) and a CTC model (seed 3)."""
    import torch
    from unast_tpu_torch.models import TINY
    from unast_tpu_torch.models.ctc import ctc_asr_init
    from unast_tpu_torch.models.fastspeech import fastspeech_init
    from unast_tpu_torch.models.melgan import generator_init
    nar = fastspeech_init(torch.Generator().manual_seed(1), TINY)
    nar[0]["dur"]["fc"]["b"] += 2.0
    return {"nar_pv": nar,
            "melgan_params": generator_init(torch.Generator().manual_seed(2), base=32),
            "ctc_pv": ctc_asr_init(torch.Generator().manual_seed(3), TINY)}


def asr_mels():
    """Three uniform mels of 24, 17 and 9 frames (numpy seed 5)."""
    rng = np.random.default_rng(5)
    return [rng.uniform(0, 1, (n, NUM_MELS)).astype(np.float32)
            for n in (24, 17, 9)]


def asr_margins(syn, mels, ids):
    """The top-1 minus top-2 logit at every step of syn's greedy ASR decode
    of `mels` along `ids` (teacher-forced through the decoder with the
    speech encoder's memory, eval mode): one float32 tensor per request,
    its steps up to its stop."""
    import torch
    from unast_tpu_torch import nn
    from unast_tpu_torch.models import networks as N
    cfg, ctx = syn.cfg, nn.Ctx.eval()
    n = syn._bucket(syn.mel_buckets, max(len(m) for m in mels))
    mel = torch.zeros((len(mels), n, cfg.num_mels))
    for i, m in enumerate(mels):
        mel[i, :len(m)] = torch.from_numpy(m[:n])
    lens = torch.tensor([min(n, len(m)) for m in mels])
    tgt = torch.zeros((len(mels), cfg.max_text_len), dtype=torch.long)
    for i, x in enumerate(ids):
        tgt[i, :len(x)] = x
    with torch.no_grad():
        (mem, pad), _ = N.speech_encode(syn.params["speech_m"],
                                        syn.net_state["speech_m"], ctx, cfg,
                                        mel, lens)
        logits = N.text_tr_decode_sequence(
            syn.params["text_m"], ctx, cfg, tgt,
            torch.full((len(mels),), cfg.max_text_len), mem, pad).float()
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    return [margin[i, :len(x)] for i, x in enumerate(ids)]


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module, the train
    golden module it builds on, the config and the library versions."""
    import jax
    import jaxlib
    import optax
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    files = (sorted((ROOT / "unast_tpu").rglob("*.py"))
             + [Path(__file__), here / "torch_train_golden.py", CONFIG])
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, optax, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def load():
    """The golden as a dict, after checking its hashes."""
    import torch_train_golden as G
    z = np.load(GOLDEN)
    assert str(z["source_hash"]) == source_hash(), (
        "tests/goldens/torch_parallel.npz is stale: the JAX package, "
        "tests/torch_parallel_golden.py, its config or a library version "
        "changed; run `JAX_PLATFORMS=cpu python tests/torch_parallel_golden.py`")
    assert str(z["init_hash"]) == G.init_hash(init_trees()[0]), (
        "the port's unast_init changed; run the golden module again")
    return {k: z[k] for k in z.files}


def freeze():
    """Run the JAX package's sharded step under each ZeRO level on a
    2-device CPU mesh and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import torch_train_golden as G
    from unast_tpu.models import TINY, modules, unast
    from unast_tpu.parallel import make_mesh, shard_train_step
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.optim import split_params
    from unast_tpu.train.steps import TrainState, make_optimizers, make_train_step
    from unast_tpu_torch.train.steps import zero_fixed_dropouts

    def adam_mu(opt_state):
        return next(s.mu for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))

    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(G.init_hash(init_trees()[0]))}
    batches = jax.tree_util.tree_map(jnp.asarray, batches_np())
    cfg = TINY.replace(**model_overrides())
    argv = ["--config", str(CONFIG)]
    for k, v in ARGS.items():
        argv += [f"--{k}", str(v)]
    args = parse_with_config(argv)
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    for zero in ZEROS:
        # the sharded step donates its state: fresh arrays for each level
        params, state = jax.tree_util.tree_map(jnp.asarray, init_trees())
        gen_tx, disc_tx = make_optimizers(cfg, args)
        gen_p, disc_p = split_params(params)
        ts = TrainState(params, state, gen_tx.init(gen_p), disc_tx.init(disc_p),
                        jnp.int32(0))
        with zero_fixed_dropouts(modules, unast):
            step, placed = shard_train_step(make_train_step(cfg, args), mesh, ts,
                                            batches, zero=zero)
            new, metrics = step(placed, jax.random.PRNGKey(1), batches)
        trees = {"metrics": dict(metrics), "params": new.params,
                 "state": new.net_state, "gen_mu": adam_mu(new.gen_opt),
                 "disc_mu": adam_mu(new.disc_opt)}
        for name, tree in trees.items():
            for path, a in G.flatten(jax.device_get(tree)).items():
                out[f"{zero}/{name}/{path}"] = a
        print(f"zero {zero}: {float(metrics['grad_norm'])}", flush=True)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
