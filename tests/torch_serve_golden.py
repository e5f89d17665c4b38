"""The cases of tests/test_torch_serve.py that compile slowly in JAX (the
Synthesizer, the encoders, the greedy decodes), and the golden of the JAX
package on them.

The JAX Synthesizer compiles its decode, vocoder and DSP programs for
every bucket it serves, some 25 s on one CPU core, and the encoders and
greedy decodes some seconds each, the slowest part of the port's serving
tests. So this module runs them once and keeps what they return in
tests/goldens/torch_serve.npz; the tests run the port on the same weights
and inputs and hold it to that file.
The file records a hash of the JAX package's sources, of this module and
of the jax, jaxlib and numpy versions, and one of the weights; the test
refuses a golden whose hashes no longer match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_serve_golden.py

Weights: JAX's unast_init at TINY from PRNGKey(0), kept in the golden
too and read back by models_np, on both sides. Cases:
unast_tpu/infer/serve.py::Synthesizer with the stop bias lowered by 100
(every TTS request decodes the full max_mel_len), text buckets (8, 16),
mel buckets (16, 24), max_batch 4, two Griffin-Lim iterations: tts_mels
and tts of TEXTS, tts_long of LONG_TEXT, and asr_ids of two uniform mels
(numpy seed 13, 20 and 11 frames); the text and speech encoders under
each of IMPLS on inputs(0); the greedy decodes (text encode -> speech
decode, speech encode -> text decode) with attn_impl 'flash' on inputs(3)
under each stop bias of GREEDY_STOP_BIASES.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_serve.npz"
STOP_BIAS = -100.0
KW = dict(text_buckets=(8, 16), mel_buckets=(16, 24), max_batch=4)
TEXTS = ["hi there", "ok", "go now"]
IMPLS = ("xla", "flash")
GREEDY_STOP_BIASES = (-100.0, 100.0)
LONG_TEXT = "go now and see the sun over the hills"   # 3 segments at TINY


def asr_mels():
    """The ASR requests: uniform mels of 20 and 11 frames, numpy seed 13."""
    return [np.random.default_rng(13).uniform(0, 1, (n, 80)).astype(np.float32)
            for n in (20, 11)]


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the versions
    of the libraries that make the JAX side's numbers."""
    import jax
    import jaxlib
    h = hashlib.sha256()
    for f in sorted((ROOT / "unast_tpu").rglob("*.py")) + [Path(__file__)]:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def models_np(golden, stop_bias: float = 0.0):
    """(params, state) numpy trees of the cases, as the golden holds them:
    JAX's unast_init at TINY from PRNGKey(0) (JAX runs its init op by op,
    some 5-15 s on a shared core, so the golden keeps its result), the
    stop bias moved by stop_bias."""
    params, state = (unflatten({k[len(pre):]: v for k, v in golden.items()
                                if k.startswith(pre)})
                     for pre in ("init/params/", "init/state/"))
    stop = params["speech_m"]["postnet"]["stop_proj"]
    stop["b"] = stop["b"] + np.float32(stop_bias)
    return params, state


def unflatten(flat):
    """{"a/0/b": array} -> {"a": [{"b": array}]}: the inverse of
    torch_train_golden.flatten (all-digit keys become list indices)."""
    root = {}
    for path, a in flat.items():
        node, parts = root, path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.array(a)

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t
    return lists(root)


def inputs(seed=0, b=2):
    """ids [b, 16] (3..45), text lens (16, 9), mel [b, 24, 80] uniform and
    mel lens (24, 13), from numpy seed `seed`; TINY's caps."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 46, size=(b, 16)).astype(np.int32)
    tlens = np.array([16, 9][:b], np.int32)
    mel = rng.uniform(0, 1, size=(b, 24, 80)).astype(np.float32)
    mlens = np.array([24, 13][:b], np.int32)
    return ids, tlens, mel, mlens


def jax_models():
    """JAX's unast_init at TINY from PRNGKey(0)."""
    import jax
    from unast_tpu.models import TINY, unast
    return unast.unast_init(jax.random.PRNGKey(0), TINY)


def freeze():
    """Run the JAX package on every case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu import nn
    from unast_tpu.audio.params import AudioParams
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.models import TINY, networks as N
    import torch_train_golden as G

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    ectx = nn.Ctx.eval()
    params, state = jax_models()
    out = {"source_hash": np.array(source_hash())}
    for name, tree in (("params", params), ("state", state)):
        for path, a in G.flatten(jax.device_get(tree)).items():
            out[f"init/{name}/{path}"] = a
    params, state = models_np(out, STOP_BIAS)
    out["init_hash"] = np.array(G.init_hash(params))
    syn = Synthesizer(J(params), J(state), TINY, audio_params=AudioParams(n_iter=2), **KW)
    for i, m in enumerate(syn.tts_mels(TEXTS)):
        out[f"tts_mels/{i}"] = m
    for i, w in enumerate(syn.tts(TEXTS) + [syn.tts_long(LONG_TEXT)]):
        out[f"tts/{i}"] = w
    for i, ids in enumerate(syn.asr_ids(asr_mels())):
        out[f"asr_ids/{i}"] = np.asarray(ids)

    params, state = J(models_np(out))
    ids, tlens, mel, mlens = inputs()
    for impl in IMPLS:
        cfg = TINY.replace(attn_impl=impl)
        (tm, tmask), _ = jax.jit(lambda p, s: N.text_tr_encode(
            p["text_m"], s["text_m"], ectx, cfg, ids, tlens))(params, state)
        (sm, _), _ = jax.jit(lambda p, s: N.speech_tr_encode(
            p["speech_m"], s["speech_m"], ectx, cfg, mel, mlens))(params, state)
        out[f"encoders/{impl}/text"] = np.asarray(tm)
        out[f"encoders/{impl}/text_mask"] = np.asarray(tmask)
        out[f"encoders/{impl}/speech"] = np.asarray(sm)

    cfg = TINY.replace(attn_impl="flash")
    ids, tlens, mel, mlens = inputs(seed=3)

    @jax.jit
    def decodes(p, s):
        (t_enc, t_mask), _ = N.text_tr_encode(p["text_m"], s["text_m"], ectx, cfg,
                                              ids, tlens)
        speech, _ = N.speech_tr_infer(p["speech_m"], s["speech_m"], ectx, cfg,
                                      t_enc, t_mask)
        (s_enc, s_mask), _ = N.speech_tr_encode(p["speech_m"], s["speech_m"], ectx,
                                                cfg, mel, mlens)
        return speech, N.text_tr_infer(p["text_m"], ectx, cfg, s_enc, s_mask)
    for bias in GREEDY_STOP_BIASES:
        (pre, post, stops, sl), (tids, tl) = decodes(*J(models_np(out, bias)))
        for name, a in dict(pre=pre, post=post, stops=stops, stop_lens=sl,
                            ids=tids, text_lens=tl).items():
            out[f"greedy/{bias}/{name}"] = np.asarray(a)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
