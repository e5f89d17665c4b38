"""The cases of tests/test_torch_loop.py that JAX compiles slowly, and the
golden of the JAX package's results on them.

JAX's eval_batch (six losses and four greedy decodes in one jitted
function, Pallas in interpret mode) and its training loop (a warm-start
step, the joint step and eval_batch, each compiled) take minutes to
compile on one CPU core, more than the port's whole test budget. So this
module runs them once and keeps what they return in
tests/goldens/torch_loop.npz; the test runs the port on the same weights
and data and holds it to that file. As tests/torch_train_golden.py does,
the file records a hash of the JAX package's sources, of this module, of
the configs and of the jax, jaxlib, optax and numpy versions, and one of
each case's weights; the test refuses a golden whose hashes no longer
match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_loop_golden.py

Cases, all in float32 with the SpecAugment spans at 0 (eval_batch draws
them even in eval mode, from streams the port cannot reproduce):
  - 'batches': data/batching.py::BatchGetter.step_batches over the
    synthetic GETTER_SETS, BATCH_STEPS steps under each of BATCH_BUCKETS,
    and BatchIterator's first two batches of the validation set, kept as
    sha256 hashes of each array (array_hash);
  - 'eval': unast_tpu/infer/evaluate.py::evaluate in test mode (dumps,
    d_score) at TINY with the discriminator and attn_impl='flash', on the
    weights of torch_train_golden.init_trees, over EVAL_BATCHES batches of
    two from the synthetic corpus at TINY's caps (seed 4: on these weights
    every greedy choice of its ASR and TTS decodes leads its runner-up by
    more than the test's 1e-3 margin, 5.0e-3 at the least; on seed 5, the
    loop's test set, one ASR step leads by 1.4e-5, too near a tie for equal
    ids to mean parity);
  - 'loop': unast_tpu/train/loop.py::train on configs/transformer_test.json
    with --synthetic, --sp_warmup_steps 1 and objective_eval_mode, started
    from the port's unast_init weights (torch seed = the config's seed)
    instead of JAX's init, for the config's 2 epochs of 2 steps: its
    metrics.jsonl records.
"""

import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
LOOP_CONFIG = ROOT / "configs" / "transformer_test.json"
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_loop.npz"
EVAL_BATCHES, EVAL_B = 2, 2
NO_SPEC = dict(spec_freq_mask=0, spec_time_mask=0)


# the batch case: BatchGetter over synthetic (ae/cm, sp, d) datasets of
# these (size, seed), BATCH_STEPS steps under each of BATCH_BUCKETS, and
# the loop's validation batches
GETTER_SETS = ((2, 1), (5, 2), (6, 4))
BATCH_BUCKETS = ({}, {"text_buckets": [8, 16], "mel_buckets": [64, 128]})
BATCH_STEPS = 3


def batch_args(buckets):
    """The port's flat args of the batch case under `buckets`."""
    from unast_tpu_torch.train.config import train_args
    return train_args(LOOP_CONFIG, train_batch_size=3, data_text_len=24,
                      data_mel_len=150, eval_batch_size=4, **buckets)


def array_hash(a) -> str:
    """sha256 of an array's dtype, shape and bytes: equal hashes, equal
    arrays of one dtype."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str} {a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def item_hashes(item) -> dict:
    """{key: array_hash or repr} of a collated item dict."""
    return {k: array_hash(v) if isinstance(v, np.ndarray) else repr(v)
            for k, v in item.items()}


def loop_argv(**flags):
    """The loop case's command line, with extra --key value flags."""
    argv = ["--config", str(LOOP_CONFIG), "--synthetic",
            "--sp_warmup_steps", "1"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def eval_batches(dataset_cls, collate):
    """EVAL_BATCHES collated batches of EVAL_B from dataset_cls(size=...,
    seed=4) at TINY's caps (text 16, mel 24); either package's synthetic
    dataset and collate give the same arrays."""
    ds = dataset_cls(size=EVAL_BATCHES * EVAL_B, seed=4)
    return [collate([ds[i * EVAL_B + j] for j in range(EVAL_B)], 16, 24)
            for i in range(EVAL_BATCHES)]


def loop_init_trees(args):
    """(params, BN state) of the port's unast_init for the loop case's
    config, torch seed args.seed, as numpy trees."""
    import torch
    from unast_tpu_torch.models import unast_init
    from unast_tpu_torch.train.config import model_config_from_args
    params, state = unast_init(torch.Generator().manual_seed(args.seed),
                               model_config_from_args(args))
    to_np = lambda t: {k: to_np(v) for k, v in t.items()} if isinstance(t, dict) \
        else [to_np(v) for v in t] if isinstance(t, list) else t.numpy()
    return to_np(params), to_np(state)


def metrics_records(path):
    """metrics.jsonl as {step/key: value} without the wall-clock times."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k not in ("step", "time"):
                    out[f"{rec['step']}/{k}"] = v
    return out


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module, the configs and
    the versions of the libraries that make the JAX side's numbers."""
    import jax
    import jaxlib
    import optax
    h = hashlib.sha256()
    files = sorted((ROOT / "unast_tpu").rglob("*.py")) + [Path(__file__), LOOP_CONFIG]
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, optax, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def freeze():
    """Run both cases in JAX and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu.data import SyntheticSpeechDataset, collate
    from unast_tpu.infer.evaluate import evaluate
    from unast_tpu.models import TINY
    from unast_tpu.train import loop
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.optim import split_params
    from unast_tpu.train.steps import TrainState, make_optimizers
    import torch_train_golden as G

    out = {"source_hash": np.array(source_hash())}
    from unast_tpu.data import batching as JB, dataset as JD
    for i, buckets in enumerate(BATCH_BUCKETS):
        args = batch_args(buckets)
        getter = JB.BatchGetter(args, *(JD.SyntheticSpeechDataset(size=n, seed=s_)
                                        for n, s_ in GETTER_SETS))
        for step in range(BATCH_STEPS):
            for k, arrays in getter.step_batches(args, True).items():
                for j, a in enumerate(arrays):
                    out[f"batches/{i}/{step}/{k}/{j}"] = np.array(array_hash(a))
    it = JB.BatchIterator(JD.SyntheticSpeechDataset(size=6, seed=3), batch_size=3,
                          text_len=24, mel_len=150, seed=batch_args({}).seed)
    it._reshuffle()
    for n in range(2):
        for k, v in item_hashes(it.next_batch()).items():
            out[f"val/{n}/{k}"] = np.array(v)
    params, state = jax.tree_util.tree_map(jnp.asarray, G.init_trees())
    out["eval/init_hash"] = np.array(G.init_hash(params))
    cfg = TINY.replace(use_discriminator=True, attn_impl="flash", **NO_SPEC)
    with tempfile.TemporaryDirectory() as tmp:
        args = parse_with_config(["--out_test_dir", tmp])
        per, losses, d_score = evaluate(
            params, state, cfg, args,
            eval_batches(SyntheticSpeechDataset, collate), is_test=True)
        out.update({"eval/per": np.array(per), "eval/d_score": np.array(d_score)})
        out.update({f"eval/loss/{k}": np.array(v, np.float32)
                    for k, v in losses.items()})
        with open(os.path.join(tmp, "text_preds.json")) as f:
            for fname, rec in json.load(f).items():
                out[f"eval/pred/{fname}"] = np.array(rec["pred"], np.int32)
        for name in os.listdir(os.path.join(tmp, "mels")):
            out[f"eval/mel/{name[:-len('.pt.npy')]}"] = np.load(
                os.path.join(tmp, "mels", name))

    make_cfg = loop.model_config_from_args

    def cfg_no_spec(a):
        return make_cfg(a).replace(**NO_SPEC)

    with tempfile.TemporaryDirectory() as tmp:
        args = parse_with_config(loop_argv(checkpoint_path=tmp))
        args.objective_eval_mode = True
        p0, s0 = jax.tree_util.tree_map(jnp.asarray, loop_init_trees(args))
        out["loop/init_hash"] = np.array(G.init_hash(p0))

        def init_from_port(key, cfg, args):
            gen_tx, disc_tx = make_optimizers(cfg, args)
            gen_p, disc_p = split_params(p0)
            return TrainState(p0, s0, gen_tx.init(gen_p), disc_tx.init(disc_p),
                              jnp.int32(0))
        saved = loop.init_train_state, loop.model_config_from_args
        loop.init_train_state, loop.model_config_from_args = init_from_port, cfg_no_spec
        try:
            loop.train(args)
        finally:
            loop.init_train_state, loop.model_config_from_args = saved
        for k, v in metrics_records(os.path.join(tmp, "metrics.jsonl")).items():
            out[f"loop/metrics/{k}"] = np.array(v)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    freeze()
