"""The cases of tests/test_torch_train.py that hold the port's parts of the
train step to the JAX package (the flash-attention backward, the losses,
the RNN encoder and LSTM discriminator, the teacher-forced decoders, the
six task methods, SpecAugment's draws), and the golden of the JAX side on
them.

JAX compiles these (the decoders and tasks at TINY, jax.grad through the
Pallas kernel in interpret mode) in some 25 s on one CPU core, the slowest
part of the port's training tests. So this module runs them once and keeps
what they return in tests/goldens/torch_train_parts.npz; the tests run the
port on the same weights and inputs and hold it to that file. The file
records a hash of the JAX package's sources, of this module and of
tests/torch_train_golden.py (whose init_trees gives the weights), and of
the versions of jax, jaxlib, optax and numpy, and one of the weights; the
tests refuse a golden whose hashes no longer match: then run this module
again.

    JAX_PLATFORMS=cpu python tests/torch_train_parts_golden.py

Cases: the weights of torch_train_golden.init_trees (TINY with the
discriminator, the port's init from torch seed 0). FLASH_F32 and
FLASH_BF16, jax.grad of sum(flash_attention(q, k, v) * w) on
attn_case's inputs; every loss of LOSSES on loss_inputs(); the
discriminator's RNN encoder and lstm_discriminator on encoder_inputs();
DECODERS, the teacher-forced decoders with their cross-attention weights,
and TASKS in eval mode on dec_inputs(); SpecAugment (F 20, T 100) of a
[4000, 120, 3] batch from PRNGKey(11), as the masked frames.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_train_golden as G

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_train_parts.npz"
FLASH_F32 = [  # (layout, causal, tq, tk, h, d)
    ("qkv", True, 24, 24, 2, 16),      # decoder self-attention
    ("cross", False, 17, 30, 2, 32),   # cm cross-attention, Tq != Tk
]
FLASH_BF16 = ("qkv", True, 20, 20, 2, 32)
DECODERS = [(side, impl) for side in ("text", "speech") for impl in ("xla", "flash")]
TASKS = ["text_ae", "speech_ae", "cm_text_in", "cm_speech_in", "tts", "asr"]
SPEC = dict(n=4000, t=120, m=3, seed=10, key=11)


def attn_case(layout, seed, b, tq, tk, h, d):
    """Fused projections as the port's mha hands them to the kernel: 'qkv'
    one [B, T, 3HD] array, 'cross' q [B, Tq, H, D] and one [B, Tk, 2HD]
    k/v array; plus ragged kv_lens and an output weight w."""
    rng = np.random.default_rng(seed)
    if layout == "qkv":
        fused = [rng.normal(size=(b, tq, 3 * h * d)).astype(np.float32)]
    else:
        fused = [rng.normal(size=(b, tq, h, d)).astype(np.float32),
                 rng.normal(size=(b, tk, 2 * h * d)).astype(np.float32)]
    lens = np.array([tk, max(1, tk - 9)][:b], np.int32)
    w = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    return fused, lens, w


def bf16_case():
    """FLASH_BF16's fused input rounded to bfloat16 (held as float32),
    kv_lens and w."""
    import torch
    layout, causal, tq, tk, h, d = FLASH_BF16
    fused, lens, w = attn_case(layout, 1, 2, tq, tk, h, d)
    return ([torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in fused],
            lens, w)


def loss_inputs():
    rng = np.random.default_rng(5)
    b, t, v, m = 3, 9, 46, 4
    gold = rng.integers(3, v, size=(b, t)).astype(np.int32)
    lens = np.array([9, 5, 2], np.int32)
    gold[0, 8], gold[1, 4] = 2, 2
    gold[1, 5:], gold[2, 2:] = 0, 0
    return dict(
        gold=gold, lens=lens,
        logits=rng.normal(size=(b, t, v)).astype(np.float32),
        mel=rng.normal(size=(b, t, m)).astype(np.float32),
        pre=rng.normal(size=(b, t, m)).astype(np.float32),
        post=rng.normal(size=(b, t, m)).astype(np.float32),
        stop=rng.normal(size=(b, t)).astype(np.float32),
        d_out=rng.normal(size=(6,)).astype(np.float32),
        attn=rng.uniform(size=(2, b, 2, t, t + 3)).astype(np.float32),
        k_lens=np.array([12, 6, 1], np.int32))


LOSSES = {
    "masked_mse": lambda L, x, a: L.masked_mse(
        a(x["mel"]), a(x["pre"]), a(np.arange(9)[None, :, None] < x["lens"][:, None, None])),
    "text_loss": lambda L, x, a: L.text_loss(a(x["gold"]), a(x["logits"]), 3.0),
    "bce_with_logits": lambda L, x, a: L.bce_with_logits(
        a(x["stop"]), a(x["stop"] > 0), a(np.where(x["stop"] > 1, 8.0, 1.0).astype(np.float32))),
    "speech_loss": lambda L, x, a: L.speech_loss(
        a(x["mel"]), L.stop_label_from_lens(a(x["lens"]), 9), a(x["pre"]),
        a(x["post"]), a(x["lens"]), a(x["stop"]), 8.0),
    "discriminator_loss": lambda L, x, a: L.discriminator_loss(
        a(x["d_out"]), L.discriminator_target(6, "speech")),
    "discriminator_target": lambda L, x, a: L.discriminator_target(4, "text"),
    "stop_label_from_lens": lambda L, x, a: L.stop_label_from_lens(a(x["lens"]), 9),
    "guided_attention_loss": lambda L, x, a: L.guided_attention_loss(
        a(x["attn"]), a(x["lens"]), a(x["k_lens"]), 0.3),
}


def encoder_inputs():
    """x [4, 10, 32] normal, zero past lens (10, 7, 3, 1), numpy seed 6."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 10, 32)).astype(np.float32)
    lens = np.array([10, 7, 3, 1], np.int32)
    return x * (np.arange(10) < lens[:, None])[..., None], lens


def dec_inputs():
    rng = np.random.default_rng(7)
    text = rng.integers(3, 46, size=(2, 12)).astype(np.int32)
    tlens = np.array([12, 7], np.int32)
    mel = rng.uniform(size=(2, 20, 80)).astype(np.float32)
    mlens = np.array([20, 9], np.int32)
    memory = rng.normal(size=(2, 15, 32)).astype(np.float32)
    mem_pad = np.arange(15)[None, :] >= np.array([15, 6])[:, None]
    return text, tlens, mel, mlens, memory, mem_pad


def spec_inputs():
    rng = np.random.default_rng(SPEC["seed"])
    mel = rng.normal(size=(SPEC["n"], SPEC["t"], SPEC["m"])).astype(np.float32)
    lens = rng.integers(1, SPEC["t"] + 1, size=(SPEC["n"],)).astype(np.int32)
    return mel, lens


def decode(N, cfg, p, s, ctx, side, tgt, tgt_lens, memory, mem_pad):
    """(outputs, cross-attention weights) of N's teacher-forced decoder."""
    ws = []
    out, _ = (N.text_decode_sequence if side == "text" else
              N.speech_decode_sequence)(p, s, ctx, cfg, tgt, tgt_lens, memory,
                                        mem_pad, cross_weights_out=ws)
    return (out if side == "text" else out[:3]), ws


def task(U, name):
    """fn(params, state, ctx, cfg, text, tlens, mel, mlens) -> (outputs,
    state) for task `name` of U (models.unast of either package)."""
    return {
        "text_ae": lambda *a: U.text_ae(*a[:6], ret_enc_hid=True),
        "speech_ae": lambda *a: U.speech_ae(*a[:4], *a[6:], ret_enc_hid=True),
        "cm_text_in": lambda *a: U.cm_text_in(*a[:6], ret_enc_hid=True,
                                               infer_mel_len=24),
        "cm_speech_in": lambda *a: U.cm_speech_in(*a[:4], *a[6:], ret_enc_hid=True,
                                                   infer_text_len=16),
        "tts": lambda *a: U.tts(*a, ret_enc_hid=True),
        "asr": lambda *a: U.asr(*a, ret_enc_hid=True),
    }[name]


def leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in leaves(o)]
    return [out]


def jax_grads(layout, fused, lens, w, causal, h, d, dtype):
    """jax.grad of sum(flash_attention(q, k, v) * w) on the same q, k, v
    (contiguous), flattened to [B, T, H*D]."""
    import jax
    import jax.numpy as jnp
    from unast_tpu.ops import flash_attention
    if layout == "qkv":
        q, k, v = np.split(fused[0], 3, axis=-1)
    else:
        q = fused[0].reshape(fused[0].shape[:2] + (h * d,))
        k, v = np.split(fused[1], 2, axis=-1)
    q, k, v = (jnp.asarray(x.reshape(x.shape[:2] + (h, d)), dtype) for x in (q, k, v))

    def loss(q, k, v):
        o = flash_attention(q, k, v, jnp.asarray(lens), causal=causal)
        return jnp.sum(o.astype(jnp.float32) * w)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x.astype(jnp.float32)).reshape(x.shape[:2] + (h * d,))
            for x in g]


def source_hash() -> str:
    import jax
    import jaxlib
    import optax
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    files = (sorted((ROOT / "unast_tpu").rglob("*.py"))
             + [Path(__file__), here / "torch_train_golden.py"])
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, optax, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def freeze():
    """Run the JAX side of every case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from unast_tpu import nn
    from unast_tpu.models import TINY, networks, rnn, unast
    from unast_tpu.train import losses
    from unast_tpu.train.augment import specaugment

    ectx = nn.Ctx.eval()
    params, state = G.init_trees()
    out = {"source_hash": np.array(source_hash()),
           "init_hash": np.array(G.init_hash(params))}
    params, state = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state))
    for case in FLASH_F32:
        layout, causal, tq, tk, h, d = case
        fused, lens, w = attn_case(layout, 0, 2, tq, tk, h, d)
        for name, g in zip("qkv", jax_grads(layout, fused, lens, w, causal, h, d,
                                            jnp.float32)):
            out[f"flash_f32/{layout}/d{name}"] = g
    layout, causal, tq, tk, h, d = FLASH_BF16
    fused, lens, w = bf16_case()
    for name, g in zip("qkv", jax_grads(layout, fused, lens, w, causal, h, d,
                                        jnp.bfloat16)):
        out[f"flash_bf16/d{name}"] = g
    x = loss_inputs()
    for name, fn in LOSSES.items():
        out[f"loss/{name}"] = np.asarray(fn(losses, x, jnp.asarray))
    xe, le = encoder_inputs()
    jd = params["discriminator"]
    enc_out, (h_, c_) = jax.jit(lambda p: rnn.rnn_encoder(p, ectx, xe, le, 0.2))(jd["rnn"])
    out["encoder/out"], out["encoder/h"], out["encoder/c"] = (
        np.asarray(a) for a in (enc_out, h_, c_))
    out["discriminator"] = np.asarray(jax.jit(
        lambda p: unast.lstm_discriminator(p, ectx, xe, le))(jd))
    disc = TINY.replace(use_discriminator=True)
    text, tlens, mel, mlens, memory, mem_pad = dec_inputs()

    def run(params, state):
        dec = {(side, impl): decode(
            networks, disc.replace(attn_impl=impl), params[f"{side}_m"],
            state[f"{side}_m"], ectx, side,
            *((text, tlens) if side == "text" else (mel, mlens)), memory, mem_pad)
            for side, impl in DECODERS}
        tasks = {name: task(unast, name)(params, state, ectx, disc, text, tlens, mel,
                                         mlens) for name in TASKS}
        return dec, tasks
    dec, tasks = jax.device_get(jax.jit(run)(params, state))
    for (side, impl), (o, ws) in dec.items():
        for i, a in enumerate(leaves(o)):
            out[f"dec/{side}/{impl}/out/{i}"] = np.asarray(a)
        for i, a in enumerate(ws):
            out[f"dec/{side}/{impl}/ws/{i}"] = np.asarray(a)
    for name, (o, new_state) in tasks.items():
        for i, a in enumerate(leaves(o)):
            out[f"task/{name}/out/{i}"] = np.asarray(a)
        out[f"task/{name}/state_keys"] = np.array(sorted(G.flatten(new_state)))
    mel_s, lens_s = spec_inputs()
    ref = np.asarray(specaugment(jax.random.PRNGKey(SPEC["key"]), jnp.asarray(mel_s),
                                 jnp.asarray(lens_s), 20, 100))
    out["spec/masked"] = np.packbits((ref != mel_s).any(-1), axis=-1)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    freeze()
