"""The cases of tests/test_torch_attention.py that hold the port's plain
flash attention to the JAX package, and the golden of the JAX side on them.

JAX runs its Pallas flash-attention kernel in interpret mode on the CPU, a
few seconds a case on one core, the slowest part of the port's attention
tests. So this module runs the JAX kernel (and the plain attention_core)
once on every case and keeps the outputs in
tests/goldens/torch_attention.npz; the tests run the port on the same
inputs and hold it to that file. The file records a hash of the JAX
package's sources, of this module and of the versions of jax, jaxlib and
numpy; the tests refuse a golden whose hash no longer matches: then run
this module again.

    JAX_PLATFORMS=cpu python tests/torch_attention_golden.py

Cases: CASES in float32 (inputs(0, 2, tq, tk, 2, d)), through the kernel
and through attention_core under the same padding (and causal) bias;
BF16_CAUSAL in bfloat16 (inputs(1, 2, 32, 32, 2, 64)); VIEW_LAYOUTS, the
strided views of one fused projection (view_inputs(layout, 4, 2, 24, 24,
2, 16)) as contiguous copies.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_attention.npz"
CASES = [  # (causal, tq, tk, d)
    (False, 40, 56, 64),
    (True, 40, 40, 64),
    (False, 24, 33, 32),
    (True, 17, 30, 16),
]
BF16_CAUSAL = (False, True)
# (causal, Tq, Tk, D) of the lse cases: logsumexp of the recompute
# backward's _ref_scores, at TINY shapes
LSE_CASES = [(False, 20, 20, 32), (True, 20, 20, 32), (True, 12, 28, 16)]
VIEW_LAYOUTS = ("qkv", "cross")


def inputs(seed, b, tq, tk, h, d):
    """q [B, Tq, H, D], k, v [B, Tk, H, D] normal float32 and kv_lens (Tk,
    then Tk - 9), from numpy seed `seed`."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, h, d)).astype(np.float32)
    kv_lens = np.array([tk, max(1, tk - 9)][:b], np.int32)
    return q, k, v, kv_lens


def fused_inputs(layout, seed, b, tq, tk, h, d):
    """The fused projection(s) of a view case and its kv_lens: 'qkv' one
    [B, T, 3HD] array, 'cross' q [B, Tq, H, D] and one [B, Tk, 2HD] k/v
    array, from numpy seed `seed`."""
    rng = np.random.default_rng(seed)
    if layout == "qkv":
        x = (rng.normal(size=(b, tq, 3 * h * d)).astype(np.float32),)
    else:
        x = (rng.normal(size=(b, tq, h, d)).astype(np.float32),
             rng.normal(size=(b, tk, 2 * h * d)).astype(np.float32))
    return x, np.array([tk, max(1, tk - 9)][:b], np.int32)


def key(*case) -> str:
    return "/".join(str(c) for c in case)


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the versions
    of jax, jaxlib and numpy."""
    import jax
    import jaxlib
    h = hashlib.sha256()
    for f in sorted((ROOT / "unast_tpu").rglob("*.py")) + [Path(__file__)]:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def attention_core_ref(q, k, v, kv_lens, causal):
    """The JAX package's plain attention_core under the kernels' masks:
    padding by kv_lens and, if causal, key j <= query i (top-left
    aligned)."""
    import jax.numpy as jnp
    from unast_tpu import nn
    from unast_tpu.models.transformer import attention_core, causal_bias, padding_bias
    pad = jnp.arange(k.shape[1])[None, :] >= jnp.asarray(kv_lens)[:, None]
    bias = padding_bias(pad)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        if tq == tk:
            bias = bias + causal_bias(tq)
        else:
            keep = jnp.arange(tk)[None, :] <= jnp.arange(tq)[:, None]
            bias = bias + jnp.where(keep, 0.0, -1e9)[None, None]
    return attention_core(q, k, v, bias, nn.Ctx.eval(), 0.0)


def freeze():
    """Run the JAX side of every case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu.ops import flash_attention

    out = {"source_hash": np.array(source_hash())}
    for case in CASES:
        causal, tq, tk, d = case
        q, k, v, kv_lens = inputs(0, 2, tq, tk, 2, d)
        out["f32/" + key(*case)] = np.asarray(
            flash_attention(q, k, v, jnp.asarray(kv_lens), causal=causal))
        out["core/" + key(*case)] = np.asarray(attention_core_ref(q, k, v, kv_lens, causal))
    for causal in BF16_CAUSAL:
        q, k, v, kv_lens = inputs(1, 2, 32, 32, 2, 64)
        qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        out[f"bf16/{causal}"] = np.asarray(
            flash_attention(qb, kb, vb, jnp.asarray(kv_lens), causal=causal)
            .astype(jnp.float32))
    for layout in VIEW_LAYOUTS:
        x, lens = fused_inputs(layout, 4, 2, 24, 24, 2, 16)
        parts = ([a.reshape(2, 24, 2, 16) for a in np.split(x[0], 3, axis=-1)]
                 if layout == "qkv" else
                 [x[0]] + [a.reshape(2, 24, 2, 16) for a in np.split(x[1], 2, axis=-1)])
        out[f"views/{layout}"] = np.asarray(flash_attention(
            *(np.ascontiguousarray(a) for a in parts), jnp.asarray(lens)))
    from jax.scipy.special import logsumexp
    from unast_tpu.ops.attention import _ref_scores
    for case in LSE_CASES:
        causal, tq, tk, d = case
        q, k, v, kv_lens = inputs(7, 2, tq, tk, 2, d)

        def heads(x):  # [B, T, H, D] -> [B*H, T, D], as _flash's wrapper
            return x.transpose(0, 2, 1, 3).reshape(4, x.shape[1], d)
        s = _ref_scores(heads(q), heads(k), np.repeat(kv_lens, 2), causal,
                        1.0 / np.sqrt(d))
        out["lse/" + key(*case)] = np.asarray(logsumexp(s, axis=-1)).reshape(2, 2, tq)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    freeze()
