"""The case of tests/test_torch_serve.py::test_synthesizer_matches_jax, and
the golden of the JAX package's Synthesizer on it.

The JAX Synthesizer compiles its decode, vocoder and DSP programs for
every bucket it serves, some 25 s on one CPU core, the slowest part of the
port's serving tests. So this module runs it once and keeps what it
returns in tests/goldens/torch_serve.npz; the test runs the port's
Synthesizer on the same weights and requests and holds it to that file.
The file records a hash of the JAX package's sources, of this module and
of the jax, jaxlib and numpy versions, and one of the weights; the test
refuses a golden whose hashes no longer match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_serve_golden.py

Case: unast_tpu/infer/serve.py::Synthesizer at TINY on JAX's init from
PRNGKey(0) with the stop bias lowered by 100 (every TTS request decodes
the full max_mel_len), text buckets (8, 16), mel buckets (16, 24),
max_batch 4, two Griffin-Lim iterations: tts_mels and tts of TEXTS,
tts_long of LONG_TEXT, and asr_ids of two uniform mels (numpy seed 13,
20 and 11 frames).
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


def jax_models():
    """(params, state) of the case: JAX's unast_init at TINY from
    PRNGKey(0), the stop bias lowered by 100."""
    import jax
    from unast_tpu.models import TINY, unast
    params, state = unast.unast_init(jax.random.PRNGKey(0), TINY)
    stop = params["speech_m"]["postnet"]["stop_proj"]
    stop["b"] = stop["b"] + STOP_BIAS
    return params, state


def freeze():
    """Run the JAX Synthesizer on the case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from unast_tpu.audio.params import AudioParams
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.models import TINY
    import torch_train_golden as G

    params, state = jax_models()
    syn = Synthesizer(params, state, TINY, audio_params=AudioParams(n_iter=2), **KW)
    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(G.init_hash(params))}
    for i, m in enumerate(syn.tts_mels(TEXTS)):
        out[f"tts_mels/{i}"] = m
    for i, w in enumerate(syn.tts(TEXTS) + [syn.tts_long(LONG_TEXT)]):
        out[f"tts/{i}"] = w
    for i, ids in enumerate(syn.asr_ids(asr_mels())):
        out[f"asr_ids/{i}"] = np.asarray(ids)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    freeze()
