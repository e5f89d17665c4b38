"""The serving-export cases of tests/test_torch_export.py and the golden of
the JAX package on them.

The case: a Synthesizer at TINY with attn_impl='flash' (text bucket 16,
mel bucket 24, max_batch 2) over the port's inits: unast_init (torch seed
0), a FastSpeech student (fastspeech_init, torch seed 1, its duration bias
raised by 2 so that it makes frames), a CTC model (ctc_asr_init, torch
seed 2) and a MelGAN generator (generator_init, base 32, torch seed 3).
The JAX package exports it with unast_tpu/infer/export.py::
export_synthesizer at batch 2, loads the bundle back and calls its
nar_tts, ctc_asr and vocode programs on inputs(); the Pallas flash kernel
runs in interpret mode inside them, which takes a while, so this module
runs them once and keeps the outputs in tests/goldens/torch_export.npz,
with a hash of the JAX package's sources, this module and the library
versions, and one of the weights. The test refuses a stale file: then run

    JAX_PLATFORMS=cpu python tests/torch_export_golden.py
"""

import hashlib
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_export.npz"
SYN_KW = dict(text_buckets=(16,), mel_buckets=(24,), max_batch=2)
BATCH = 2


def trees():
    """{'ar', 'nar', 'ctc': (params, state), 'melgan': params} of the
    port's inits, as torch trees."""
    import torch
    from unast_tpu_torch.models import TINY, unast_init
    from unast_tpu_torch.models.ctc import ctc_asr_init
    from unast_tpu_torch.models.fastspeech import fastspeech_init
    from unast_tpu_torch.models.melgan import generator_init
    g = lambda s: torch.Generator().manual_seed(s)
    nar = fastspeech_init(g(1), TINY)
    nar[0]["dur"]["fc"]["b"] += 2.0
    return {"ar": unast_init(g(0), TINY), "nar": nar,
            "ctc": ctc_asr_init(g(2), TINY),
            "melgan": generator_init(g(3), base=32)}


def inputs():
    """(ids [2, 16] with lens [2] for nar_tts; mel [2, 24, 80] uniform,
    numpy seed 4, with mel_len [2] for ctc_asr and vocode), as numpy."""
    ids = np.zeros((BATCH, 16), np.int64)
    ids[0, :5], ids[1, :3] = [5, 6, 7, 8, 2], [9, 10, 2]
    lens = np.array([5, 3], np.int64)
    mel = np.random.default_rng(4).uniform(0, 1, (BATCH, 24, 80)).astype(np.float32)
    return ids, lens, mel, np.array([24, 12], np.int64)


def _np(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def weights_hash() -> str:
    """sha256 of every weight of trees()."""
    import torch_train_golden as G
    h = hashlib.sha256()
    for name, t in sorted(trees().items()):
        h.update(name.encode())
        h.update(G.init_hash(_np(t)).encode())
    return h.hexdigest()


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the library
    versions."""
    import jax
    import jaxlib
    h = hashlib.sha256()
    for f in sorted((ROOT / "unast_tpu").rglob("*.py")) + [Path(__file__)]:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def load():
    """The golden as a dict, after checking its hashes."""
    z = np.load(GOLDEN)
    assert str(z["source_hash"]) == source_hash(), (
        "tests/goldens/torch_export.npz is stale: the JAX package, "
        "tests/torch_export_golden.py or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_export_golden.py`")
    assert str(z["weights_hash"]) == weights_hash(), (
        "the port's inits changed; run the golden module again")
    return {k: z[k] for k in z.files}


def freeze():
    """Export the JAX Synthesizer, call its bundle's programs and write
    GOLDEN."""
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu.infer.export import export_synthesizer, load_bundle
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.models import TINY

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, _np(t))
    t = trees()
    cfg = TINY.replace(attn_impl="flash")
    syn = Synthesizer(*J(t["ar"]), cfg, nar_pv=J(t["nar"]),
                      melgan_params=J(t["melgan"]), ctc_pv=J(t["ctc"]), **SYN_KW)
    ids, lens, mel, mlens = inputs()
    out = {"source_hash": np.array(source_hash()),
           "weights_hash": np.array(weights_hash())}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "syn.zip")
        export_synthesizer(syn, path, batch=BATCH)
        b = load_bundle(path)
        post, out_lens = b.call("nar_tts", b.weights["nar"], jnp.asarray(ids, jnp.int32),
                                jnp.asarray(lens, jnp.int32))
        got_ids, got_lens = b.call("ctc_asr", b.weights["ctc"], jnp.asarray(mel),
                                   jnp.asarray(mlens, jnp.int32))
        wav = b.call("vocode", b.weights["melgan"], jnp.asarray(mel))
    for k, v in dict(post=post, out_lens=out_lens, ids=got_ids, lens=got_lens,
                     wav=wav).items():
        out[k] = np.asarray(v)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
