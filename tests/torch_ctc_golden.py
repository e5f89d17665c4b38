"""The cases of tests/test_torch_ctc.py and tests/test_torch_data_prep.py,
and the golden of the JAX package on them: data/prepare.py's device path
and audio/metrics.py::mcd_wav, the CTC model (models/ctc.py), its trainer (train/ctc.py), the
hybrid CTC/attention sp objective, cm_speech_in's 'ctc' and 'spec'
pseudo-transcripts, the speculative decode and the beam search
(models/networks.py), and Synthesizer(ctc_pv=)'s asr_ids.

JAX compiles each of these (the flash encoder in Pallas interpret mode,
the CTC and sp gradients, the decode loops, the Synthesizer's programs),
minutes on one CPU core in all, more than the port's test budget. So
this module runs them once and keeps what they return in
tests/goldens/torch_ctc.npz; the tests run the port on the same weights
and inputs and hold it to that file. The file records a hash of the JAX
package's sources, of this module and the golden modules it builds on,
and of the versions of jax, jaxlib, optax and numpy, and one of the
weights; the tests refuse a golden whose hashes no longer match: then
run this module again.

    JAX_PLATFORMS=cpu python tests/torch_ctc_golden.py

Weights, from the port's inits on both sides (torch seed 0): the CTC
model of ctc_asr_init at TINY with ctc_chunk 4, ctc_left 1 and ctc_pos
'rel' (ctc_trees; without `rel_pos` for the other variants), and the
joint model of unast_init at TINY with ctc_weight 0.3 (joint_trees).
Cases: ctc_logits and greedy decode of mel_case() under each of VARIANTS;
prefix beam search (beam 3) and forced alignment (both blank rules) over
the 'abs' log-posteriors with align_labels(); ctc_loss and its gradient
on loss_case(), whose last row no alignment fits, in float32 and in
float64 (jax.enable_x64); two make_ctc_step
updates (adamw, STEP_ARGV) at TINY with every dropout at 0 and flash on;
the sp objective with ctc_weight 0.3 in objective_eval_mode, its loss,
aux and gradients, on both of torch_train_golden's sp micro-batches;
cm_speech_in under 'ctc' and 'spec', _cm_ctc_draft, text_tr_spec_infer
with the CTC draft and text_tr_beam_search (beam 3) on the joint model's
speech encoding of mel_case(); the Synthesizer on the joint model with
the 'abs' CTC model as ctc_pv, serving torch_serve_golden's asr_mels()
under each of ASR_OPTIONS. Data: prepare's batched device path (--batch
2 --bucket_s 4 --f0) over the corpus of prep_corpus(), its caches kept
by name; mcd_wav of two waveforms of that corpus.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_serve_golden as SG
import torch_train_golden as G

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_ctc.npz"
VARIANTS = {
    "abs": dict(),
    "abs_flash": dict(attn_impl="flash"),
    "chunk": dict(ctc_chunk=4, ctc_left=1),
    "rel": dict(ctc_chunk=4, ctc_left=1, ctc_pos="rel"),
}
STEP_ARGV = ["--optim_type", "adamw", "--lr", "1e-3", "--sched_type", "none",
             "--grad_clip", "1.0", "--weight_decay", "0.01"]
SYN_KW = dict(mel_buckets=(16, 24), max_batch=4)
ASR_OPTIONS = {"ctc": {}, "ctc_beam": {"ctc_beam": 3}, "spec": {"spec": True},
               "beam": {"beam": 3}}
CTC_WEIGHT = 0.3
PREP_ARGV = ["--batch", "2", "--bucket_s", "4", "--f0"]


def prep_corpus(root) -> list:
    """An LJSpeech-layout corpus under `root` (wavs/<id>.wav PCM16 at
    22050 Hz and metadata.csv): the waveforms of the port's
    SyntheticSpeechDataset(size=3, seed=0) with low noise before and after
    (numpy seed 8), so the silence trim cuts them. Returns the ids."""
    from unast_tpu_torch.data.dataset import SyntheticSpeechDataset
    from unast_tpu_torch.infer.synthesize import write_wav
    ds = SyntheticSpeechDataset(size=3, seed=0)
    rng = np.random.default_rng(8)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    rows, fids = [], []
    for i in range(3):
        fid = f"LJ000-{i:04d}"
        noise = [1e-4 * rng.normal(size=n) for n in (1500 + 700 * i, 2500)]
        write_wav(os.path.join(root, "wavs", fid + ".wav"), np.concatenate(
            [noise[0], ds[i]["wav"], noise[1]]).astype(np.float32))
        rows.append(f"{fid}|{ds._texts[i]}|{ds._texts[i]}")
        fids.append(fid)
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return fids


def variant_cfg(name, cfg_module):
    """The TINY config of CTC variant `name` from cfg_module (the JAX or
    the port's models package)."""
    return cfg_module.TINY.replace(**VARIANTS[name])


def ctc_trees(variant: str = "rel"):
    """(params, state) of the port's ctc_asr_init (torch seed 0, TINY with
    ctc_chunk 4, ctc_left 1, ctc_pos 'rel') as numpy trees; variants other
    than 'rel' drop `rel_pos`."""
    import torch
    from unast_tpu_torch.models import TINY
    from unast_tpu_torch.models.ctc import ctc_asr_init
    p, s = ctc_asr_init(torch.Generator().manual_seed(0),
                        TINY.replace(**VARIANTS["rel"]))
    p, s = _to_np(p), _to_np(s)
    if variant != "rel":
        del p["rel_pos"]
    return p, s


def joint_trees():
    """(params, state) of the port's unast_init at TINY with ctc_weight
    0.3 (so speech_m carries ctc_head), torch seed 0, as numpy trees."""
    import torch
    from unast_tpu_torch.models import TINY, unast_init
    return _to_np(unast_init(torch.Generator().manual_seed(0),
                             TINY.replace(ctc_weight=CTC_WEIGHT)))


def _to_np(t):
    if isinstance(t, dict):
        return {k: _to_np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_to_np(v) for v in t]
    return t.numpy()


def mel_case():
    """mel [2, 20, 80] uniform in [0, 1), zero past mel_len [20, 13];
    numpy seed 5."""
    rng = np.random.default_rng(5)
    lens = np.array([20, 13], np.int32)
    mel = rng.uniform(size=(2, 20, 80)).astype(np.float32)
    mel *= (np.arange(20) < lens[:, None])[..., None]
    return mel, lens


def align_labels():
    """Forced alignment's labels [2, 5] (0 = PAD) with a repeated pair,
    and their lengths."""
    return (np.array([[5, 9, 9, 20, 31], [12, 7, 3, 0, 0]], np.int32),
            np.array([5, 3], np.int32))


def loss_case():
    """ctc_loss's inputs: logits [3, 10, 47] normal (numpy seed 6), frame
    pad mask from lengths [10, 7, 4], labels [3, 6] with lengths [6, 3, 5]
    (a repeated pair in rows 0 and 1); row 2's 4 frames cannot hold its 5
    labels, so no alignment fits it."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 10, 47)).astype(np.float32)
    pad = np.arange(10)[None] >= np.array([10, 7, 4])[:, None]
    labels = np.array([[4, 8, 8, 15, 23, 42], [6, 6, 11, 0, 0, 0],
                       [3, 9, 27, 14, 40, 0]], np.int32)
    return logits, pad, labels, np.array([6, 3, 5], np.int32)


def step_batches():
    """Two CTC train batches (text [2, 8] with EOS at len - 1, mel [2, 20,
    80]), numpy seed 7."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        tl = np.array([8, 5], np.int32)
        ml = np.array([20, 16], np.int32)
        text = rng.integers(3, 46, size=(2, 8)).astype(np.int32)
        text = np.where(np.arange(8) == tl[:, None] - 1, 2, text)
        text = np.where(np.arange(8) >= tl[:, None], 0, text).astype(np.int32)
        mel = rng.uniform(size=(2, 20, 80)).astype(np.float32)
        mel *= (np.arange(20) < ml[:, None])[..., None]
        out.append({"text": text, "text_len": tl, "mel": mel, "mel_len": ml})
    return out


def sp_batch(i: int):
    """torch_train_golden's sp micro-batch i: (text, mel, text_len,
    mel_len). In micro-batch 0, row 0's 7 frames cannot hold its 12
    labels (no CTC alignment fits it); every row of micro-batch 1 fits."""
    return tuple(a[i] for a in G.batches_np()["sp"])


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the modules
    it builds on, and the library versions."""
    import jax
    import jaxlib
    import optax
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    files = (sorted((ROOT / "unast_tpu").rglob("*.py"))
             + [Path(__file__), here / "torch_serve_golden.py",
                here / "torch_train_golden.py"])
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
    from unast_tpu import models as JM
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.models import ctc as C, modules, networks as N, unast as U
    from unast_tpu.train import ctc as TC
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.steps import sp_loss_fn
    from unast_tpu_torch.train.steps import ZERO_DROPOUTS, zero_fixed_dropouts

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(G.init_hash(ctc_trees()[0])),
           "joint_init_hash": np.array(G.init_hash(joint_trees()[0]))}
    mel, mel_len = mel_case()
    ectx = nn.Ctx.eval()

    for name in VARIANTS:
        cfg = variant_cfg(name, JM)
        p, s = J(ctc_trees("rel" if name == "rel" else name))
        logits, pad, _ = jax.jit(lambda p, s, m, l: C.ctc_logits(
            p, s, ectx, cfg, m, l))(p, s, jnp.asarray(mel), jnp.asarray(mel_len))
        ids, lens = C.ctc_greedy_decode(logits, pad, cfg.max_text_len)
        out[f"{name}/logits"] = np.asarray(logits)
        out[f"{name}/ids"], out[f"{name}/lens"] = np.asarray(ids), np.asarray(lens)
        if name == "abs":
            lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
            for i in range(2):
                out[f"prefix_beam/{i}"] = np.asarray(C.ctc_prefix_beam_search(
                    lp[i], int(mel_len[i]), beam=3, max_text_len=cfg.max_text_len),
                    np.int32)
            labels, label_lens = align_labels()
            for split in (False, True):
                out[f"align/{int(split)}"] = np.asarray(C.ctc_forced_align(
                    jnp.asarray(lp), ~pad, jnp.asarray(labels),
                    jnp.asarray(label_lens), blank_split=split))

    logits, pad, labels, label_lens = loss_case()
    loss, grad = jax.value_and_grad(lambda x: C.ctc_loss(
        x, jnp.asarray(pad), jnp.asarray(labels), jnp.asarray(label_lens)))(
        jnp.asarray(logits))
    out["loss/value"], out["loss/grad"] = np.asarray(loss), np.asarray(grad)
    with jax.enable_x64(True):
        loss, grad = jax.value_and_grad(lambda x: C.ctc_loss(
            x, jnp.asarray(pad), jnp.asarray(labels), jnp.asarray(label_lens)))(
            jnp.asarray(logits, jnp.float64))
    out["loss64/value"], out["loss64/grad"] = np.asarray(loss), np.asarray(grad)

    cfg = JM.TINY.replace(attn_impl="flash", **ZERO_DROPOUTS)
    args = parse_with_config(STEP_ARGV)
    params, state = J(ctc_trees("abs"))
    tx = TC.make_optimizer(args, TC.make_schedule(args))
    ts = TC.CtcTrainState(params, state, tx.init(params), jnp.int32(0))
    with zero_fixed_dropouts(modules, U):
        step = jax.jit(TC.make_ctc_step(cfg, args))
        for i, b in enumerate(step_batches()):
            ts, m = step(ts, jax.random.PRNGKey(i), J(b))
            out[f"step/{i}/loss"] = np.asarray(m["ctc/loss"])
            out[f"step/{i}/grad_norm"] = np.asarray(m["grad_norm"])
    mu = next(x.mu for x in jax.tree_util.tree_leaves(
        ts.opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))
    for name, tree in (("params", ts.params), ("mu", mu)):
        for path, a in G.flatten(jax.device_get(tree)).items():
            out[f"step/{name}/{path}"] = a

    jcfg = JM.TINY.replace(attn_impl="flash", ctc_weight=CTC_WEIGHT)
    jp, js = J(joint_trees())
    sp_args = parse_with_config(["--config", str(G.CONFIG)])
    sp_args.objective_eval_mode = True

    def sp(p, batch):
        return sp_loss_fn(p, js, jax.random.PRNGKey(0), batch, jcfg, sp_args,
                          1.0)
    sp_grad = jax.jit(jax.value_and_grad(sp, has_aux=True))
    for i in range(2):
        (loss, (aux, _)), grads = sp_grad(jp, J(sp_batch(i)))
        out[f"sp{i}/loss"] = np.asarray(loss)
        for k, v in aux.items():
            out[f"sp{i}/aux/{k}"] = np.asarray(v)
        for path, a in G.flatten(jax.device_get(grads)).items():
            out[f"sp{i}/grad/{path}"] = a

    jmel, jlen = jnp.asarray(mel), jnp.asarray(mel_len)
    for td in ("ctc", "spec"):
        (pre, post, stop, lat, tl, _), _ = jax.jit(lambda p, s: U.cm_speech_in(
            p, s, ectx, jcfg, jmel, jlen, ret_enc_hid=True, text_decode=td))(jp, js)
        for k, v in dict(pre=pre, post=post, stop=stop, latent=lat,
                         text_len=tl).items():
            out[f"cm_{td}/{k}"] = np.asarray(v)

    @jax.jit
    def decodes(p, s):
        (enc, mask), _ = N.speech_encode(p["speech_m"], s["speech_m"], ectx,
                                         jcfg, jmel, jlen)
        draft_ids, draft_lens = U._cm_ctc_draft(p, jcfg, enc, mask,
                                                jcfg.max_text_len)
        logits = nn.linear(p["speech_m"]["ctc_head"], enc).astype(jnp.float32)
        draft, _ = C.ctc_greedy_decode(logits, mask, jcfg.max_text_len)
        spec = N.text_tr_spec_infer(p["text_m"], ectx, jcfg, enc, mask, draft)
        greedy = N.text_tr_infer(p["text_m"], ectx, jcfg, enc, mask)
        beam = N.text_tr_beam_search(p["text_m"], ectx, jcfg, enc, mask, beam=3)
        return (draft_ids, draft_lens), spec, greedy, beam
    (d_ids, d_lens), spec, greedy, beam = decodes(jp, js)
    out["draft/ids"], out["draft/lens"] = np.asarray(d_ids), np.asarray(d_lens)
    out["spec/ids"], out["spec/lens"] = np.asarray(spec[0]), np.asarray(spec[1])
    out["spec/rounds"] = np.asarray(spec[2])
    out["greedy/ids"], out["greedy/lens"] = np.asarray(greedy[0]), np.asarray(greedy[1])
    out["beam/ids"], out["beam/lens"] = np.asarray(beam[0]), np.asarray(beam[1])

    syn = Synthesizer(jp, js, jcfg, ctc_pv=J(ctc_trees("abs")), **SYN_KW)
    for name, kw in ASR_OPTIONS.items():
        for i, ids in enumerate(syn.asr_ids(SG.asr_mels(), **kw)):
            out[f"syn/{name}/{i}"] = np.asarray(ids, np.int32)
        if name == "spec":
            out["syn/spec_rounds"] = np.asarray(syn.last_spec_rounds)
    import tempfile
    from unast_tpu.audio.metrics import mcd_wav
    from unast_tpu.data import prepare as JP
    with tempfile.TemporaryDirectory() as tmp:
        prep_corpus(tmp)
        JP.main(["--data_path", tmp, "--cache_dir", os.path.join(tmp, "c")]
                + PREP_ARGV)
        for name in sorted(os.listdir(os.path.join(tmp, "c"))):
            out[f"prep/{name}"] = np.load(os.path.join(tmp, "c", name))
        wavs = [JP.read_wav(os.path.join(tmp, "wavs", f"LJ000-{i:04d}.wav"))
                for i in (0, 1)]
        n = min(len(w) for w in wavs)
        out["mcd_wav"] = np.asarray(mcd_wav(wavs[0][:n], wavs[1][:n]))
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
