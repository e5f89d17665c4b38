"""Small cases of the port's tests (tests/test_torch_serve.py: the nn ops
and transformer.mha; tests/test_torch_train.py: the schedules and the
optimizer updates; tests/test_torch_loop.py: the optimizers with EMA and
Adafactor) and the golden of the JAX package on them.

Each case runs a handful of JAX ops, and JAX compiles every op or jitted
update on first use, seconds on a shared core; so this module runs them once
and keeps what they return in tests/goldens/torch_ops.npz. The file
records a hash of the JAX package's sources, of this module and of the
jax, jaxlib, optax and numpy versions, and one of the attention weights; the
tests refuse a golden whose hashes no longer match: then run this module
again.

    JAX_PLATFORMS=cpu python tests/torch_ops_golden.py

Cases: nn_ops_case (numpy seed 1) through linear, the causal and the
symmetric conv1d, embedding, layernorm and BatchNorm in eval and train
mode (nn_ops); transformer.mha on the weights of the port's mha_init at
TINY (torch seed 6), self-attention under a causal + padding bias and
cross-attention under a padding bias (mha_case); train/optim.py's
make_schedule under each of SCHEDULES at SCHEDULE_STEPS; make_optimizer
(OPT_CASES) and steps.py's make_optimizers' generator chain (EMA_CASES):
two updates of opt_case's or ema_case's tree, the params after each (and
the EMA).

Also the JAX sides that tests/test_torch_serve.py, test_torch_rnn.py,
test_torch_train.py and test_torch_loop.py ran live before: one jitted
transformer.decoder_step on decoder_params() (the port's decoder_init at
TINY, torch seed 8) from a filled cache (decoder_step_case, numpy seed
2); transformer._stack_layers of encoder_params() (torch seed 9); the
shapes of unast_init's trees for the RNN backbone under each decoder
attention of tests/torch_rnn_golden.py, of lstm_discriminator_init(32,
16, bidirectional, 2 layers) and of the CBHG vocoder_init at
tests/torch_vocoder_golden.py's widths; audio/dsp.py's wav_to_mel_mag of
wav_case(); and, as array_hash digests, the items of data/dataset.py's
SyntheticSpeechDataset under DATASET_KW, synth_audio, add_realism and an
include_f0 item (dataset_case).
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_train_golden as G

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_ops.npz"
D_MODEL, NHEAD = 32, 2   # TINY's
SCHEDULES = ("multistep", "linear", "transformer", "none")
SCHEDULE_STEPS = (0, 1, 20, 39, 40, 49, 50, 99, 100, 149, 150, 400)
SCHEDULE_KW = dict(lr=0.01, warmup_steps=40, epochs=3, epoch_steps=50,
                   lr_milestones=[1, 2])
# (optim_type, grad_clip): the clip triggered (1.0) or not
OPT_CASES = (("adamw", 1.0), ("adamw", 100.0), ("adam", 1.0))
OPT_KW = dict(lr=0.01, weight_decay=0.1, sched_type="multistep")
# (optim_type, grad_clip, ema_decay)
EMA_CASES = (("adafactor", 1.0, 0.0), ("adafactor", 1e4, 0.99), ("adamw", 1.0, 0.9))
DEC_MAX_LEN, DEC_POS = 10, 4
RNN_ATTNS = ("lsa", "luong")
DATASET_KW = ({}, {"timbre": "formant", "pitch_jitter": 0.2, "gain_jitter": 0.3,
                   "jitter_variants": 2})


def nn_ops_case():
    """x [2, 7, 6] and the weights of the nn op case (numpy seed 1): a
    linear, a conv [5, 6, 4], a BatchNorm's params and state, a [9, 6]
    embedding and its ids [2, 3]."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    lin = {"w": rng.normal(size=(6, 5)).astype(np.float32),
           "b": rng.normal(size=(5,)).astype(np.float32)}
    conv = {"w": rng.normal(size=(5, 6, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    bn_p = {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
            "bias": rng.normal(size=6).astype(np.float32)}
    bn_s = {"mean": rng.normal(size=6).astype(np.float32),
            "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    ids = np.array([[0, 3, 5], [7, 0, 1]], np.int32)
    emb = {"w": rng.normal(size=(9, 6)).astype(np.float32)}
    return x, lin, conv, bn_p, bn_s, ids, emb


def nn_ops(nn, x, lin, conv, bn_p, bn_s, ids, emb):
    """The nn op case's outputs on either side (nn: either package's; the
    weights and inputs as that side's arrays): linear, the causal and the
    symmetric conv, embedding, layernorm, then per train flag the
    BatchNorm output and its new mean and var."""
    out = [nn.linear(lin, x), nn.conv1d(conv, x, (4, 0)), nn.conv1d(conv, x, 2),
           nn.embedding(emb, ids), nn.layernorm(bn_p, x)]
    for train in (False, True):
        y, st = nn.batchnorm(bn_p, bn_s, x, train)
        out += [y, st["mean"], st["var"]]
    return out


def mha_params():
    """The port's mha_init(D_MODEL, NHEAD), torch seed 6, as numpy, with
    its zero in-projection biases set to normal draws (numpy seed 6)."""
    import torch
    from unast_tpu_torch.models.transformer import mha_init
    p = mha_init(torch.Generator().manual_seed(6), D_MODEL, NHEAD)
    rng = np.random.default_rng(6)
    out = {k: {n: t.numpy() for n, t in v.items()} for k, v in p.items()}
    for k in ("q", "k", "v", "out"):
        out[k]["b"] = rng.normal(size=D_MODEL).astype(np.float32) * 0.1
    return out


def mha_case(cross: bool):
    """The attention case (numpy seed 7): queries x [2, 6, D], keys and
    values kv [2, 9, D] for cross-attention (x itself for self-attention),
    key padding pad [2, Tk] (the second row's last 3 keys)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, D_MODEL)).astype(np.float32)
    kv = rng.normal(size=(2, 9, D_MODEL)).astype(np.float32) if cross else x
    pad = np.zeros((2, kv.shape[1]), bool)
    pad[1, -3:] = True
    return x, kv, pad


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return t.numpy()


def decoder_params():
    """The port's decoder_init at TINY's widths (2 layers), torch seed 8,
    as numpy."""
    import torch
    from unast_tpu_torch.models.transformer import decoder_init
    return _np_tree(decoder_init(torch.Generator().manual_seed(8), D_MODEL, NHEAD,
                                 2 * D_MODEL, 2))


def encoder_params():
    """The port's encoder_init at TINY's widths (2 layers), torch seed 9,
    as numpy."""
    import torch
    from unast_tpu_torch.models.transformer import encoder_init
    return _np_tree(encoder_init(torch.Generator().manual_seed(9), D_MODEL, NHEAD,
                                 2 * D_MODEL, 2))


def decoder_step_case():
    """(memory [2, 7, D], its padding [2, 7], the step's input x [2, 1, D],
    the self-attention cache's prior contents [L, 2, max_len, H, D/H]),
    numpy seed 2; the step runs at position DEC_POS of DEC_MAX_LEN with
    the cache's v holding -prior."""
    rng = np.random.default_rng(2)
    memory = rng.normal(size=(2, 7, D_MODEL)).astype(np.float32)
    pad = np.array([[False] * 7, [False] * 4 + [True] * 3])
    x = rng.normal(size=(2, 1, D_MODEL)).astype(np.float32)
    prior = rng.normal(size=(2, 2, DEC_MAX_LEN, NHEAD, D_MODEL // NHEAD))
    return memory, pad, x, prior.astype(np.float32)


def wav_case():
    """A 30000-sample wav: a 220 Hz tone from 0.2 s on, plus noise (numpy
    seed 5)."""
    rng = np.random.default_rng(5)
    t = np.arange(30000) / 22050.0
    return (0.4 * np.sin(2 * np.pi * 220 * t) * (t > 0.2)
            + 0.01 * rng.normal(size=t.shape)).astype(np.float32)


def dataset_case(D, kw_index: int):
    """{name: array or scalar} of data/dataset.py module D (either
    package's): SyntheticSpeechDataset(size=3, seed=4, **DATASET_KW[i])'s
    items 0, 1, 2; with i = 0 also synth_audio and add_realism on fixed
    ids and seeds and SyntheticSpeechDataset(size=1, include_f0=True)[0]."""
    out = {}
    ds = D.SyntheticSpeechDataset(size=3, seed=4, **DATASET_KW[kw_index])
    out["len"] = len(ds)
    for i in range(3):
        for k, v in ds[i].items():
            out[f"item/{i}/{k}"] = v
    if kw_index == 0:
        ids = np.array([5, 17, 40, 3], np.int32)
        wav, durs = D.synth_audio(ids, 22050, np.random.default_rng(1),
                                  dur_jitter=0.3, return_durs=True)
        out["synth/wav"], out["synth/durs"] = wav, durs
        real, offsets = D.add_realism(wav, np.random.default_rng(2), 22050,
                                      return_offsets=True)
        out["realism/wav"], out["realism/offsets"] = real, np.asarray(offsets)
        for k, v in D.SyntheticSpeechDataset(size=1, include_f0=True)[0].items():
            out[f"f0_item/{k}"] = v
    return out


def _shape_paths(tree, prefix=""):
    """{path: shape} of a tree of dicts, lists and tuples of shaped leaves
    (jax.eval_shape's), paths as tree_paths joins them."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_shape_paths(v, f"{prefix}{k}/"))
    return out


def digest(v) -> str:
    """A digest of an array (dtype, shape and bytes) or of a scalar's repr."""
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        h = hashlib.sha256(f"{a.dtype.str} {a.shape}".encode())
        h.update(a.tobytes())
        return h.hexdigest()
    return f"{type(v).__name__} {v!r}"


def argv(**kw):
    """A JAX command line of --key value flags."""
    return [x for k, v in kw.items() for x in (f"--{k}", str(v))]


def _like(rng, tree, scale=1.0):
    """A tree of tree's structure, normal draws times scale, float32."""
    if isinstance(tree, dict):
        return {k: _like(rng, v, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(rng, v, scale) for v in tree]
    return (rng.normal(size=tree.shape) * scale).astype(np.float32)


def opt_case():
    """(params, [grads, grads]) of the optimizer case, numpy seed 8."""
    rng = np.random.default_rng(8)
    shapes = {"a": {"w": np.empty((5, 3))}, "b": [np.empty((4,))]}
    params = _like(rng, shapes)
    return params, [_like(rng, shapes, 2.0) for _ in range(2)]


def ema_case():
    """(params, [grads, grads]) of the EMA / Adafactor case, numpy seed 9:
    factored leaves (3-D with unequal largest dims, 2-D with equal ones)
    and unfactored ones (1-D, and 2-D with a dim under 128)."""
    rng = np.random.default_rng(9)
    shapes = {"b": [np.empty((4,))], "c": np.empty((3, 140, 150)),
              "d": {"w": np.empty((128, 128))}, "e": np.empty((5, 300))}
    params = _like(rng, shapes)
    return params, [_like(rng, shapes, 2.0) for _ in range(2)]


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module, the RNN and
    vocoder golden modules whose configs it takes, and the versions of the
    libraries that
    make the JAX side's numbers (read from the
    installed distributions, which costs no import)."""
    from importlib.metadata import version
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    for f in (sorted((ROOT / "unast_tpu").rglob("*.py"))
              + [Path(__file__), here / "torch_rnn_golden.py",
                 here / "torch_vocoder_golden.py"]):
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in ("jax", "jaxlib", "optax", "numpy"):
        h.update(f"{lib} {version(lib)}".encode())
    return h.hexdigest()


def load():
    """The golden as a dict, after checking its hashes."""
    z = np.load(GOLDEN)
    assert str(z["source_hash"]) == source_hash(), (
        "tests/goldens/torch_ops.npz is stale: the JAX package, "
        "tests/torch_ops_golden.py or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_ops_golden.py`")
    assert str(z["init_hash"]) == G.init_hash(mha_params()), (
        "the port's mha_init changed; run the golden module again")
    assert str(z["dec_init_hash"]) == G.init_hash(
        {"dec": decoder_params(), "enc": encoder_params()}), (
        "the port's decoder_init or encoder_init changed; run the golden "
        "module again")
    return {k: z[k] for k in z.files}


def freeze():
    """Run the JAX package on both cases and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu import nn
    from unast_tpu.models import transformer as T

    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(G.init_hash(mha_params())),
           "dec_init_hash": np.array(G.init_hash(
               {"dec": decoder_params(), "enc": encoder_params()}))}
    jd = jax.tree_util.tree_map(jnp.asarray, decoder_params())
    memory, pad, x, prior = decoder_step_case()

    @jax.jit
    def jax_step(jd, memory, prior, x):
        jc = T.init_cache(jd, memory, DEC_MAX_LEN, NHEAD)
        jc = jc._replace(self_k=prior, self_v=-prior)
        return T.decoder_step(jd, nn.Ctx.eval(), x, jnp.int32(DEC_POS), jc,
                              T.padding_bias(pad), NHEAD, 0.0)

    y, jc = jax_step(jd, memory, prior, x)
    out["dec_step/y"] = np.asarray(y)
    for name in ("self_k", "self_v", "cross_k"):
        out[f"dec_step/{name}"] = np.asarray(getattr(jc, name))
    stacked = T._stack_layers(jax.tree_util.tree_map(jnp.asarray,
                                                     encoder_params()["layers"]))
    for path, a in G.flatten(jax.device_get(stacked)).items():
        out[f"stack/{path}"] = a
    from unast_tpu.data import dataset as JD
    from unast_tpu.models import TINY as JTINY, unast as JU
    import torch_rnn_golden as RG
    for attn in RNN_ATTNS:
        shapes = jax.eval_shape(lambda k: JU.unast_init(
            k, JTINY.replace(**RG.model_overrides(attn))), jax.random.PRNGKey(0))
        for path, sds in _shape_paths(shapes).items():
            out[f"rnn_shapes/{attn}/{path}"] = np.asarray(sds, np.int64)
    shapes = jax.eval_shape(lambda k: JU.lstm_discriminator_init(k, 32, 16, True, 2),
                            jax.random.PRNGKey(4))
    for path, sds in _shape_paths(shapes).items():
        out[f"disc_shapes/{path}"] = np.asarray(sds, np.int64)
    import torch_vocoder_golden as VG
    shapes = jax.eval_shape(lambda k: JU.vocoder_init(
        k, JU.ModelConfig(hidden=VG.HIDDEN), VG.N_FFT), jax.random.PRNGKey(0))
    for path, sds in _shape_paths(shapes).items():
        out[f"vocoder_shapes/{path}"] = np.asarray(sds, np.int64)
    from unast_tpu.audio import dsp as JDsp
    mel, mag, n = JDsp.wav_to_mel_mag(wav_case())
    out["wav_to_mel/mel"], out["wav_to_mel/mag"] = np.asarray(mel), np.asarray(mag)
    out["wav_to_mel/n"] = np.asarray(n)
    for i in range(len(DATASET_KW)):
        for k, v in dataset_case(JD, i).items():
            out[f"dataset/{i}/{k}"] = np.array(digest(v))
    x, lin, conv, bn_p, bn_s, ids, emb = nn_ops_case()
    for i, a in enumerate(nn_ops(nn, x, J(lin), J(conv), J(bn_p), J(bn_s),
                                 jnp.asarray(ids), J(emb))):
        out[f"nn_ops/{i}"] = np.asarray(a)
    jp = {k: J(v) for k, v in mha_params().items()}
    for cross in (False, True):
        x, kv, pad = mha_case(cross)
        bias = T.padding_bias(pad)
        if not cross:
            bias = bias + T.causal_bias(6)
        out[f"mha/{int(cross)}/bias"] = np.asarray(bias)
        out[f"mha/{int(cross)}/out"] = np.asarray(
            T.mha(jp, nn.Ctx.eval(), x, kv, bias, NHEAD, 0.0))
    import optax
    from unast_tpu.models import TINY
    from unast_tpu.train import optim as JO, steps as JS
    from unast_tpu.train.config import parse_with_config
    for sched in SCHEDULES:
        f = JO.make_schedule(parse_with_config(argv(sched_type=sched, **SCHEDULE_KW)))
        out[f"schedule/{sched}"] = np.array([float(f(t)) for t in SCHEDULE_STEPS])

    def updates(tx, params, grads, key, ema=False):
        jp, st = params, tx.init(params)
        update = jax.jit(tx.update)
        for step, g in enumerate(grads):
            u, st = update(g, st, jp)
            jp = optax.apply_updates(jp, u)
            for i, a in enumerate(jax.tree_util.tree_leaves(jp)):
                out[f"{key}/{step}/params/{i}"] = np.asarray(a)
            if ema:
                for i, a in enumerate(jax.tree_util.tree_leaves(JO.find_ema(st))):
                    out[f"{key}/{step}/ema/{i}"] = np.asarray(a)

    for optim_type, clip in OPT_CASES:
        tx = JO.make_optimizer(parse_with_config(argv(
            optim_type=optim_type, grad_clip=clip, **OPT_KW)))
        updates(tx, *opt_case(), f"opt/{optim_type}-{clip}")
    for optim_type, clip, ema in EMA_CASES:
        tx = JS.make_optimizers(TINY, parse_with_config(argv(
            optim_type=optim_type, grad_clip=clip, ema_decay=ema, **OPT_KW)))[0]
        updates(tx, *ema_case(), f"ema/{optim_type}-{clip}-{ema}", ema > 0)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    freeze()
