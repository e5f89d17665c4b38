"""The cases of tests/test_torch_fastspeech.py, and the golden of the JAX
package on them: models/fastspeech.py (the duration predictor, the length
regulator, both duration extractions over a teacher's attention, the
monotonic alignment search, the variance targets, the forward with
teacher durations and free-running), train/fastspeech.py (one
distillation step per duration source, eval_nar_mse), Synthesizer(
nar_pv=)'s mels and a NAR pickle of save_nar_pickle.

JAX compiles the distillation steps (the teacher's pass, the flash
encoders in Pallas interpret mode, the gradients) for minutes on one CPU
core, more than the port's test budget, so this module runs them once
and keeps what they return in tests/goldens/torch_fastspeech.npz. The
file records a hash of the JAX package's sources, of this module and the
golden modules it builds on, and of the jax, jaxlib, optax and numpy
versions, and one of the weights; the tests refuse a golden whose hashes
no longer match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_fastspeech_golden.py

Weights, from the port's inits (torch seed 0): the student of
fastspeech_init at TINY with nar_pitch and nar_energy, its duration bias
raised by DUR_BIAS so the free-running lengths fill frames (fs_trees
'fwd'); the small student of STEP_KW for the steps and the pickle
(fs_trees 'step'); the teacher is torch_ctc_golden's joint model (TINY,
ctc_weight 0.3, so its speech model has the CTC head). Every config runs
attn_impl 'flash'. The steps: STEP_ARGV (adamw, lr 1e-3, clip 1.0) with
every dropout at 0, one step from the same state per source of SOURCES
('durs' hands the argmax durations in with the batch, so its update is
the argmax step's and only its metrics are kept); with each step's
params, the class of JAX's first moment per element (grad_class), which
tells the tests where a param must match tightly.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_ctc_golden as CG
import torch_train_golden as G

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_fastspeech.npz"
DUR_BIAS = 2.0
FWD_KW = dict(nar_pitch=True, nar_energy=True, attn_impl="flash")
STEP_KW = dict(num_layers=1, hidden=16, e_in=16, t_emb_dim=16, s_pre_hid=16,
               ffn_dim=32, nhead=1, nar_pitch=True, nar_energy=True,
               attn_impl="flash")
TEACHER_KW = dict(ctc_weight=CG.CTC_WEIGHT, attn_impl="flash")
STEP_ARGV = ["--optim_type", "adamw", "--lr", "1e-3", "--sched_type", "none",
             "--grad_clip", "1.0", "--weight_decay", "0.01"]
SOURCES = ("argmax", "soft", "mas", "uniform", "ctc", "durs")
FREE = dict(speed=1.25, pitch_shift=1.2, energy_scale=0.9)
SYN_KW = dict(text_buckets=(8, 16), mel_buckets=(24,), max_batch=2)
TEXTS = ["hi there", "ok", "go now"]
MU_FLOOR = 1e-7    # a first moment at or below it is rounding noise (grad_class)


def _to_np(t):
    return CG._to_np(t)


def grad_class(mu):
    """Per element of Adam's first moment after one step: 0 where it is
    exactly 0, 1 where it is nonzero but at most MU_FLOOR (rounding noise
    around a gradient that may be 0 in exact arithmetic), 2 above."""
    mu = np.abs(np.asarray(mu))
    return np.where(mu == 0, 0, np.where(mu <= MU_FLOOR, 1, 2)).astype(np.uint8)


def adam_mu(opt_state):
    """The first moment `mu` of an optax chain's Adam state."""
    import jax
    return next(x.mu for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))


def fs_trees(kind: str):
    """(params, state) of the port's fastspeech_init, torch seed 0, as numpy
    trees: 'fwd' at TINY with FWD_KW and the duration bias raised by
    DUR_BIAS, 'step' at TINY with STEP_KW."""
    import torch
    from unast_tpu_torch.models import TINY
    from unast_tpu_torch.models.fastspeech import fastspeech_init
    p, s = fastspeech_init(torch.Generator().manual_seed(0),
                           TINY.replace(**(FWD_KW if kind == "fwd" else STEP_KW)))
    p, s = _to_np(p), _to_np(s)
    if kind == "fwd":
        p["dur"]["fc"]["b"] = p["dur"]["fc"]["b"] + np.float32(DUR_BIAS)
    return p, s


def cfg(kind: str, cfg_module):
    """The config of `kind` ('fwd', 'step' or 'teacher') from cfg_module
    (the JAX or the port's models package)."""
    kw = {"fwd": FWD_KW, "step": STEP_KW, "teacher": TEACHER_KW}[kind]
    return cfg_module.TINY.replace(**kw)


def text_case():
    """text [2, 8] ids in 3..45 (numpy seed 20), lengths [8, 5], PAD after."""
    rng = np.random.default_rng(20)
    lens = np.array([8, 5], np.int32)
    text = rng.integers(3, 46, size=(2, 8)).astype(np.int32)
    return np.where(np.arange(8) < lens[:, None], text, 0).astype(np.int32), lens


def fwd_targets():
    """Teacher-forced inputs of the forward: durations 0-4 a token (0 on
    PAD), token log-F0 around 5.5 with unvoiced zeros, token energies
    around 0.3 with zeros; numpy seed 21."""
    rng = np.random.default_rng(21)
    text, lens = text_case()
    valid = np.arange(8) < lens[:, None]
    dur = (rng.integers(0, 5, size=(2, 8)) * valid).astype(np.int32)
    f0 = rng.uniform(5.0, 6.0, size=(2, 8)) * (rng.uniform(size=(2, 8)) > 0.3)
    en = rng.uniform(0.2, 0.5, size=(2, 8)) * (rng.uniform(size=(2, 8)) > 0.2)
    return dur, (f0 * valid).astype(np.float32), (en * valid).astype(np.float32)


def regulate_case():
    """length_regulate's inputs: x [2, 6, 32] normal (seed 22), durations
    summing to 11 and 16, max_len 14 (the second row is clipped)."""
    x = np.random.default_rng(22).normal(size=(2, 6, 32)).astype(np.float32)
    dur = np.array([[3, 0, 2, 5, 1, 0], [4, 4, 4, 4, 0, 0]], np.int32)
    return x, dur, 14


def attn_cases():
    """Teacher attention [L 2, B 2, H 2, Tm 20, Tt 8] with mel_len [20, 13]
    and text_len [8, 5]: 'random' (softmax of normal logits, seed 23,
    with a diagonal trend) and 'tied' (each valid frame 0.75 on one valid
    token and 0.25 on the next, the same in every layer and head, so the
    expected masses are exact quarters and many fractional parts tie)."""
    mel_len = np.array([20, 13], np.int32)
    text_len = np.array([8, 5], np.int32)
    rng = np.random.default_rng(23)
    t = np.arange(20)[:, None] / 20.0
    j = np.arange(8)[None, :] / 8.0
    logits = rng.normal(size=(2, 2, 2, 20, 8)) - 6.0 * np.abs(t - j)
    rand = np.exp(logits - logits.max(-1, keepdims=True))
    rand = (rand / rand.sum(-1, keepdims=True)).astype(np.float32)
    tied = np.zeros((2, 2, 2, 20, 8), np.float32)
    for b in range(2):
        n = int(text_len[b])
        for f in range(20):
            k = (f * n) // 20
            tied[:, b, :, f, k] += 0.75
            tied[:, b, :, f, (k + 1) % n] += 0.25
    return {"random": rand, "tied": tied}, mel_len, text_len


def variance_case():
    """mel [2, 20, 80] uniform (seed 24) zero past [20, 13] frames and f0
    [2, 20] in 80-300 Hz with unvoiced zeros; the spans are the 'random'
    attention case's argmax durations."""
    rng = np.random.default_rng(24)
    mel = rng.uniform(size=(2, 20, 80)).astype(np.float32)
    mel *= (np.arange(20) < np.array([20, 13])[:, None])[..., None]
    f0 = rng.uniform(80.0, 300.0, size=(2, 20)) * (rng.uniform(size=(2, 20)) > 0.3)
    return mel, f0.astype(np.float32)


def step_batch():
    """One distillation batch: text_case(), mel [2, 20, 80] uniform (seed
    25) zero past [20, 13] frames, frame F0 [2, 20] (80-300 Hz, unvoiced
    zeros, zero past the frames)."""
    text, tl = text_case()
    rng = np.random.default_rng(25)
    ml = np.array([20, 13], np.int32)
    fv = np.arange(20) < ml[:, None]
    mel = rng.uniform(size=(2, 20, 80)).astype(np.float32) * fv[..., None]
    f0 = rng.uniform(80.0, 300.0, size=(2, 20)) * (rng.uniform(size=(2, 20)) > 0.3)
    return {"text": text, "text_len": tl, "mel": mel.astype(np.float32),
            "mel_len": ml, "f0": (f0 * fv).astype(np.float32)}


def eval_batch():
    """eval_nar_mse's batch: text_case() and gold mels [2, 40, 80] uniform
    (seed 26) of 40 and 27 frames."""
    text, tl = text_case()
    rng = np.random.default_rng(26)
    ml = np.array([40, 27], np.int32)
    mel = rng.uniform(size=(2, 40, 80)) * (np.arange(40) < ml[:, None])[..., None]
    return {"text": text, "text_len": tl, "mel": mel.astype(np.float32),
            "mel_len": ml}


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


def _jax_durations(source, tp, ts, tcfg, batch):
    """The durations unast_tpu/train/fastspeech.py's step computes for
    `source` (its branches, on the JAX package's functions)."""
    import jax
    import jax.numpy as jnp
    from unast_tpu import nn
    from unast_tpu.models import ctc as C, fastspeech as F
    from unast_tpu.models import networks as N, unast as U
    from unast_tpu.models.modules import lens_to_mask
    text, tl, mel, ml = (batch[k] for k in ("text", "text_len", "mel", "mel_len"))
    if source == "uniform":
        ratio = ml.astype(jnp.float32) / jnp.maximum(tl, 1).astype(jnp.float32)
        k = jnp.arange(text.shape[1] + 1, dtype=jnp.float32)[None, :]
        bounds = jnp.round(k * ratio[:, None])
        dur = (bounds[:, 1:] - bounds[:, :-1]).astype(jnp.int32)
        return dur * lens_to_mask(tl, text.shape[1]).astype(jnp.int32)
    if source == "ctc":
        (mem, pad), _ = N.speech_encode(tp["speech_m"], ts["speech_m"],
                                        nn.Ctx.eval(), tcfg, mel, ml)
        logits = nn.linear(tp["speech_m"]["ctc_head"], mem).astype(jnp.float32)
        return C.ctc_forced_align(jax.nn.log_softmax(logits, axis=-1), ~pad,
                                  text, tl, blank_split=True)
    ws = []
    U.tts(tp, ts, nn.Ctx.eval(), tcfg, text, tl, mel, ml, cross_weights_out=ws)
    attn = jnp.stack(ws)
    if source == "mas":
        return F.mas_durations(attn, ml, tl)
    return F.durations_from_attention(attn, ml, tl, soft=(source == "soft"))


def freeze():
    """Run the JAX package on every case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu import models as JM, nn
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.models import fastspeech as F, modules, unast as U
    from unast_tpu.models.modules import lens_to_mask
    from unast_tpu.train import fastspeech as TF
    from unast_tpu.train.config import parse_with_config
    from unast_tpu_torch.train.steps import ZERO_DROPOUTS, zero_fixed_dropouts

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(G.init_hash(fs_trees("fwd")[0])),
           "step_init_hash": np.array(G.init_hash(fs_trees("step")[0])),
           "joint_init_hash": np.array(G.init_hash(CG.joint_trees()[0]))}
    ectx = nn.Ctx.eval()
    fcfg = cfg("fwd", JM)
    fp, fs = J(fs_trees("fwd"))
    text, tl = (jnp.asarray(a) for a in text_case())
    pad = ~lens_to_mask(tl, 8)

    x = jnp.asarray(np.random.default_rng(27).normal(size=(2, 8, 32)), jnp.float32)
    out["dur_pred"] = np.asarray(F.duration_predictor(fp["dur"], ectx, x, pad))
    rx, rdur, rmax = regulate_case()
    frames, lens = F.length_regulate(jnp.asarray(rx), jnp.asarray(rdur), rmax)
    out["regulate/frames"], out["regulate/lens"] = np.asarray(frames), np.asarray(lens)

    attns, ml, atl = attn_cases()
    for name, a in attns.items():
        for soft in (False, True):
            out[f"attn_dur/{name}/{int(soft)}"] = np.asarray(F.durations_from_attention(
                jnp.asarray(a), jnp.asarray(ml), jnp.asarray(atl), soft=soft))
        out[f"mas/{name}"] = np.asarray(F.mas_durations(
            jnp.asarray(a), jnp.asarray(ml), jnp.asarray(atl)))
    vmel, vf0 = variance_case()
    spans = jnp.asarray(out["attn_dur/random/0"])
    tv = lens_to_mask(jnp.asarray(atl), 8).astype(jnp.float32)
    out["energy_tgt"] = np.asarray(F.token_energy_in_graph(jnp.asarray(vmel), spans, tv))
    out["log_f0_tgt"] = np.asarray(F.token_log_f0_in_graph(jnp.asarray(vf0), spans, tv))

    dur, f0_t, en_t = (jnp.asarray(a) for a in fwd_targets())
    def forward(p, s, durations=None, pitch_target=None, energy_target=None,
                max_len=None, speed=1.0, pitch_shift=1.0, energy_scale=1.0):
        return F.fastspeech_forward(
            p, s, ectx, fcfg, text, tl, durations=durations, max_len=max_len,
            speed=speed, pitch_target=pitch_target, pitch_shift=pitch_shift,
            energy_target=energy_target, energy_scale=energy_scale)
    fwd = jax.jit(forward, static_argnames=("max_len", "speed", "pitch_shift",
                                            "energy_scale"))
    (pre, post, olens, logd), ns = fwd(fp, fs, durations=dur, max_len=32,
                                       pitch_target=f0_t, energy_target=en_t)
    for k, v in dict(pre=pre, post=post, lens=olens, log_dur=logd).items():
        out[f"fwd_teacher/{k}"] = np.asarray(v)
    (pre, post, olens, logd), _ = fwd(fp, fs, max_len=64, **FREE)
    for k, v in dict(pre=pre, post=post, lens=olens, log_dur=logd).items():
        out[f"fwd_free/{k}"] = np.asarray(v)
    logd, logf, ener = F.predict_variances(fp, fs, fcfg, text, tl)
    out["var/log_dur"], out["var/log_f0"], out["var/energy"] = (
        np.asarray(logd), np.asarray(logf), np.asarray(ener))

    scfg = cfg("step", JM).replace(**ZERO_DROPOUTS)
    tcfg = cfg("teacher", JM)
    tp, ts = J(CG.joint_trees())
    batch = J(step_batch())
    sp, ss = J(fs_trees("step"))
    argmax_dur = None
    with zero_fixed_dropouts(modules, U):
        for source in SOURCES:
            args = parse_with_config(STEP_ARGV + ["--nar_dur_source", (
                "argmax" if source == "durs" else source)])
            d = jax.jit(lambda tp, ts, b, src=source: _jax_durations(
                "argmax" if src == "durs" else src, tp, ts, tcfg, b))(tp, ts, batch)
            out[f"step/{source}/dur"] = np.asarray(d)
            b = dict(batch)
            if source == "durs":
                b["durs"] = argmax_dur
            elif source == "argmax":
                argmax_dur = d
            tx = TF.make_optimizer(args, TF.make_schedule(args))
            fst = TF.FSTrainState(sp, ss, tx.init(sp), jnp.int32(0))
            step = jax.jit(TF.make_distill_step(scfg, tcfg, args))
            new, m = step(fst, tp, ts, jax.random.PRNGKey(0), b)
            for k, v in m.items():
                out[f"step/{source}/metric/{k}"] = np.asarray(v)
            if source == "durs":   # the argmax step's update, by construction
                continue
            for name, tree in (("params", new.params), ("state", new.net_state)):
                for path, a in G.flatten(jax.device_get(tree)).items():
                    out[f"step/{source}/{name}/{path}"] = a
            for path, mu in G.flatten(jax.device_get(adam_mu(new.opt))).items():
                out[f"step/{source}/grad/{path}"] = grad_class(mu)

    fst = TF.FSTrainState(fp, fs, None, jnp.int32(0))
    mse, lens = TF.eval_nar_mse(fst, fcfg, eval_batch())
    out["eval_mse"], out["eval_lens"] = np.asarray(mse), np.asarray(lens, np.int32)

    jp, js = J(CG.joint_trees())
    syn = Synthesizer(jp, js, fcfg.replace(ctc_weight=CG.CTC_WEIGHT),
                      nar_pv=(fp, fs), **SYN_KW)
    for i, m in enumerate(syn.tts_mels(TEXTS)):
        out[f"syn/{i}"] = np.asarray(m)

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nar.pkl")
        F.save_nar_pickle(path, *J(fs_trees("step")))
        out["nar_pickle"] = np.fromfile(path, np.uint8)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
