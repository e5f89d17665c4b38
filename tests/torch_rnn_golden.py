"""The cases of tests/test_torch_rnn.py, and the goldens of the JAX package on
them: the RNN backbone (model_type='rnn') at TINY width, from its cells
(gru_case, attn_queries, step_inputs, prenet_case) up.

JAX compiles each of these programs in a second to minutes on one CPU
core (the joint train step some 30-60 s a case, the Synthesizer one
program per bucket), more than the port's test budget. So this module
runs them once and keeps what they return in two files:
tests/goldens/torch_rnn.npz (the GRU cell, both attentions and the decoder
step over a few chained steps, the incremental text prenet, the
teacher-forced decoders, the greedy decodes, the six task methods and the
Synthesizer) and tests/goldens/torch_rnn_step.npz (the joint train step);
the tests run the port on the same weights and inputs and hold it to
them. Each file records a hash of the JAX package's sources, of this
module and of configs/rnn_d_test.json, and of the versions of jax, jaxlib,
optax and numpy, and one of the weights; the tests refuse a golden whose
hashes no longer match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_rnn_golden.py

Cases: TINY dims with the RNN backbone as configs/rnn_d_test.json sets it
(bidirectional encoders, the discriminator with one layer of 16), under
each decoder attention ATTNS ('lsa' with attn_dim 16, 'luong', none), in
float32; the weights of the port's unast_init from torch seed 0
(init_trees), on both sides. The joint step takes the train args of
configs/rnn_d_test.json (adamw, clip 1.0, multistep lr 2e-3, ae 1 / cm 1 /
sp 1 / d 1 micro-batches, cm decodes cut to 8 frames and 6 tokens) on
batches of 2 from numpy seed 0 (text 12 and mel 20 long, ragged), in the
modes of torch_train_golden: 'eval' (objective_eval_mode) and 'train'
(every drop probability and mask at 0). The Synthesizer serves TEXTS,
LONG_TEXT and the mels of torch_serve_golden at the 'lsa' weights with the
stop bias lowered by 100, with torch_serve_golden's buckets and two
Griffin-Lim iterations.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_serve_golden as SG
import torch_train_golden as G

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "rnn_d_test.json"
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_rnn.npz"
STEP_GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_rnn_step.npz"
ATTNS = ("lsa", "luong", None)
STEP_ATTNS = ("lsa", "luong")
MODES = G.MODES
TASKS = ("text_ae", "speech_ae", "cm_text_in", "cm_speech_in", "tts", "asr")
STEPS = {"ae": 1, "cm": 1, "sp": 1, "d": 1}
B, TEXT_LEN, MEL_LEN = 2, 12, 20
STOP_BIAS = -100.0


def model_overrides(attn, mode=None):
    """ModelConfig.replace keywords on TINY for decoder attention `attn`
    (and the step's `mode`): the RNN backbone of configs/rnn_d_test.json."""
    kw = dict(model_type="rnn", e_bi=True, d_attn=attn, attn_dim=16,
              use_discriminator=True, disc_hid=16, disc_num_layers=1)
    if mode == "train":
        from unast_tpu_torch.train.steps import ZERO_DROPOUTS
        kw.update(ZERO_DROPOUTS)
    return kw


def init_trees(attn):
    """(params, BN state) of the port's unast_init at the case's width for
    `attn`, torch seed 0, as nested dicts and lists of numpy arrays."""
    import torch
    from unast_tpu_torch.models import TINY, unast_init
    params, state = unast_init(torch.Generator().manual_seed(0),
                               TINY.replace(**model_overrides(attn)))

    def to_np(t):
        if isinstance(t, dict):
            return {k: to_np(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_np(v) for v in t]
        return t.numpy()
    return to_np(params), to_np(state)


def inputs():
    """Task inputs (text [2, 12] int32, text_len, mel [2, 20, 80], mel_len)
    and decoder memory: ((h, c) [2, 2, 32], enc_out [2, 15, 64]) with
    mem_pad (True = PAD; 15 and 6 valid), numpy seed 7."""
    rng = np.random.default_rng(7)
    text = rng.integers(3, 46, size=(B, TEXT_LEN)).astype(np.int32)
    tlens = np.array([TEXT_LEN, 7], np.int32)
    mel = rng.uniform(size=(B, MEL_LEN, 80)).astype(np.float32)
    mlens = np.array([MEL_LEN, 9], np.int32)
    h, c = (rng.normal(size=(2, B, 32)).astype(np.float32) for _ in range(2))
    enc_out = rng.normal(size=(B, 15, 64)).astype(np.float32)
    mem_pad = np.arange(15)[None, :] >= np.array([15, 6])[:, None]
    return text, tlens, mel, mlens, ((h, c), enc_out), mem_pad


def gru_case():
    """(port gru_cell_init(6 -> 5) from torch seed 3 as numpy, x [3, 4, 6],
    h0 [4, 5]) from numpy seed 11."""
    import torch
    from unast_tpu_torch import nn
    p = {k: v.numpy() for k, v in
         nn.gru_cell_init(torch.Generator().manual_seed(3), 6, 5).items()}
    rng = np.random.default_rng(11)
    return p, rng.normal(size=(3, 4, 6)).astype(np.float32), rng.normal(
        size=(4, 5)).astype(np.float32)


def attn_queries():
    """Three decoder-hidden queries [3, 2, 32], numpy seed 12."""
    return np.random.default_rng(12).normal(size=(3, 2, 32)).astype(np.float32)


def step_inputs():
    """Two decoder-step inputs [2, 2, 32], numpy seed 13."""
    return np.random.default_rng(13).normal(size=(2, 2, 32)).astype(np.float32)


def prenet_case(bn_names):
    """BN running statistics for the names (mean normal, var in [0.5, 2))
    and embeddings [2, 7, 32], numpy seed 14."""
    rng = np.random.default_rng(14)
    s = {"bn": {k: {"mean": rng.normal(size=32).astype(np.float32),
                    "var": rng.uniform(0.5, 2, 32).astype(np.float32)}
                for k in bn_names}}
    return s, rng.normal(size=(2, 7, 32)).astype(np.float32)


def batches_np(seed: int = 0):
    """{objective: (text [1, B, 12] int32, mel [1, B, 20, 80], text_len,
    mel_len)} as torch_train_golden.batches_np makes them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n in STEPS.items():
        tl = rng.integers(4, TEXT_LEN + 1, size=(n, B)).astype(np.int32)
        ml = rng.integers(6, MEL_LEN + 1, size=(n, B)).astype(np.int32)
        text = rng.integers(3, 46, size=(n, B, TEXT_LEN)).astype(np.int32)
        mel = rng.uniform(0, 1, size=(n, B, MEL_LEN, 80)).astype(np.float32)
        pos = np.arange(TEXT_LEN)
        text = np.where(pos == tl[..., None] - 1, 2, text)
        text = np.where(pos >= tl[..., None], 0, text).astype(np.int32)
        mel = mel * (np.arange(MEL_LEN) < ml[..., None])[..., None]
        out[name] = (text, mel, tl, ml)
    return out


def run_tasks(U, N, params, state, ctx, cfg, text, tlens, mel, mlens, memory,
              mem_pad):
    """{name: outputs} of the six task methods (with their latents), the
    two teacher-forced decoders on `memory` and the two greedy decodes,
    for models.unast / models.networks U, N of either package."""
    kw = dict(ret_enc_hid=True)
    out = {
        "text_ae": U.text_ae(params, state, ctx, cfg, text, tlens, **kw)[0],
        "speech_ae": U.speech_ae(params, state, ctx, cfg, mel, mlens, **kw)[0],
        "cm_text_in": U.cm_text_in(params, state, ctx, cfg, text, tlens,
                                   infer_mel_len=24, **kw)[0],
        "cm_speech_in": U.cm_speech_in(params, state, ctx, cfg, mel, mlens,
                                       infer_text_len=16, **kw)[0],
        "tts": U.tts(params, state, ctx, cfg, text, tlens, mel, mlens, **kw)[0],
        "asr": U.asr(params, state, ctx, cfg, text, tlens, mel, mlens, **kw)[0],
    }
    tm, sm = params["text_m"], params["speech_m"]
    ts, ss = state["text_m"], state["speech_m"]
    out["text_decode"] = N.text_decode_sequence(tm, ts, ctx, cfg, text, tlens,
                                                memory, mem_pad)[0]
    out["speech_decode"] = N.speech_decode_sequence(sm, ss, ctx, cfg, mel, mlens,
                                                    memory, mem_pad)[0]
    out["text_infer"] = N.text_infer(tm, ts, ctx, cfg, memory, mem_pad)[0]
    out["speech_infer"] = N.speech_infer(sm, ss, ctx, cfg, memory, mem_pad)[0]
    return out


def leaves(out):
    """The arrays of a nested tuple/list output, in order."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in leaves(o)]
    return [out]


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the modules
    it builds on, the config and the versions of the libraries that make
    the JAX side's numbers."""
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


def serve_trees():
    """The Synthesizer case's (params, state): init_trees('lsa') with the
    stop bias lowered by STOP_BIAS."""
    params, state = init_trees("lsa")
    stop = params["speech_m"]["postnet"]["stop_proj"]
    stop["b"] = stop["b"] + np.float32(STOP_BIAS)
    return params, state


def freeze():
    """Run the JAX package on every case and write GOLDEN and STEP_GOLDEN."""
    import contextlib
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    from unast_tpu import nn
    from unast_tpu.audio.params import AudioParams
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.models import TINY, modules, networks, rnn, unast
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.optim import split_params
    from unast_tpu.train.steps import TrainState, make_optimizers, make_train_step
    from unast_tpu_torch.train.steps import zero_fixed_dropouts

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    text, tlens, mel, mlens, memory, mem_pad = inputs()
    out = {"source_hash": np.array(source_hash())}
    ectx = nn.Ctx.eval()
    (h0, c0), enc_out = memory

    p, x, h = gru_case()
    for i in range(3):
        h = jax.jit(nn.gru_cell)(J(p), x[i], h)
        out[f"cells/gru/{i}"] = np.asarray(h)
    queries = attn_queries()
    for attn in ("lsa", "luong"):
        jp = J(init_trees(attn)[0]["text_m"]["decoder"]["attn"])
        st = rnn.lsa_init_state(jp, enc_out) if attn == "lsa" else None
        for i, q in enumerate(queries):
            if attn == "lsa":
                c, st = jax.jit(rnn.lsa_attend)(jp, st, q, enc_out, mem_pad)
                out[f"cells/lsa/{i}/weights"] = np.asarray(st.attn_weights)
                out[f"cells/lsa/{i}/cum"] = np.asarray(st.attn_cum)
            else:
                c = jax.jit(rnn.additive_attend)(jp, q, enc_out, mem_pad)
            out[f"cells/{attn}/{i}/ctxt"] = np.asarray(c)
    xs = step_inputs()
    for attn in ATTNS:
        jp = J(init_trees(attn)[0]["speech_m"]["decoder"])
        st = rnn.lsa_init_state(jp["attn"], enc_out) if attn == "lsa" else None
        hc = (h0, c0)
        for i, x_ in enumerate(xs):
            o, hc, st = jax.jit(lambda jp, x_, hc, st: rnn.rnn_decoder_step(
                jp, ectx, x_, hc, enc_out, mem_pad, st, 0.3, attn))(jp, x_, hc, st)
            for name, a in (("out", o), ("h", hc[0]), ("c", hc[1])):
                out[f"cells/step/{attn}/{i}/{name}"] = np.asarray(a)
    params, state = init_trees("lsa")
    bn_s, emb = prenet_case(state["text_m"]["prenet"]["bn"])
    jp = J(params["text_m"]["prenet"])

    @jax.jit
    def prenet(jp, js):
        bufs = modules.text_prenet_step_init(jp, 2, TINY, jnp.float32)
        ys = []
        for i in range(emb.shape[1]):
            y, bufs = modules.text_prenet_step(jp, js, ectx, emb[:, i], bufs, TINY)
            ys.append(y)
        return jnp.stack(ys, axis=1)
    out["cells/prenet_step"] = np.asarray(prenet(jp, J(bn_s)))

    for attn in ATTNS:
        params, state = init_trees(attn)
        out[f"{attn}/init_hash"] = np.array(G.init_hash(params))
        cfg = TINY.replace(**model_overrides(attn))
        res = jax.jit(lambda p, s: run_tasks(
            unast, networks, p, s, nn.Ctx.eval(), cfg, text, tlens, mel, mlens,
            J(memory), mem_pad))(J(params), J(state))
        for name, o in res.items():
            for i, a in enumerate(leaves(o)):
                out[f"{attn}/{name}/{i}"] = np.asarray(a)

    params, state = serve_trees()
    out["serve/init_hash"] = np.array(G.init_hash(params))
    syn = Synthesizer(J(params), J(state), TINY.replace(**model_overrides("lsa")),
                      audio_params=AudioParams(n_iter=2), **SG.KW)
    for i, m in enumerate(syn.tts_mels(SG.TEXTS)):
        out[f"serve/tts_mels/{i}"] = m
    for i, w in enumerate(syn.tts(SG.TEXTS) + [syn.tts_long(SG.LONG_TEXT)]):
        out[f"serve/tts/{i}"] = w
    for i, ids in enumerate(syn.asr_ids(SG.asr_mels())):
        out[f"serve/asr_ids/{i}"] = np.asarray(ids)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")

    def adam_mu(opt_state):
        return next(s.mu for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))

    out = {"source_hash": np.array(source_hash())}
    batches = J(batches_np())
    for attn in STEP_ATTNS:
        params, state = init_trees(attn)
        out[f"{attn}/init_hash"] = np.array(G.init_hash(params))
        for mode in MODES:
            cfg = TINY.replace(**model_overrides(attn, mode))
            args = parse_with_config(["--config", str(CONFIG)])
            args.objective_eval_mode = mode == "eval"
            gen_tx, disc_tx = make_optimizers(cfg, args)
            gen_p, disc_p = split_params(J(params))
            ts = TrainState(J(params), J(state), gen_tx.init(gen_p),
                            disc_tx.init(disc_p), jnp.int32(0))
            patch = (zero_fixed_dropouts(modules, unast) if mode == "train"
                     else contextlib.nullcontext())
            with patch:
                new, metrics = jax.jit(make_train_step(cfg, args))(
                    ts, jax.random.PRNGKey(1), batches)
            trees = {"metrics": dict(metrics), "params": new.params,
                     "state": new.net_state, "gen_mu": adam_mu(new.gen_opt),
                     "disc_mu": adam_mu(new.disc_opt)}
            for name, tree in trees.items():
                for path, a in G.flatten(jax.device_get(tree)).items():
                    out[f"{attn}/{mode}/{name}/{path}"] = a
    np.savez_compressed(STEP_GOLDEN, **out)
    print(f"wrote {STEP_GOLDEN} ({os.path.getsize(STEP_GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
