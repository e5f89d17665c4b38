"""The port's training slice (unast_tpu_torch/train, the teacher-forced
decoders, the LSTM discriminator and the flash-attention backward) against
the JAX package on the CPU at TINY width.

The same weights go to both sides (the port's init from a torch seed, as
numpy trees that JAX takes as they are and the bridge turns into the
port's) and the same inputs, made with numpy from a seed.
JAX's Pallas kernel runs in interpret mode, as its own tests run it.
Tolerances, float32 throughout unless said:
  - flash backward: 1e-4 (that of tests/test_ops.py) against jax.grad
    through the JAX flash_attention; bfloat16 within one bf16 rounding of
    each gradient element (2**-8 relative, both sides round their float32
    result once) plus 1e-3 of the gradient's largest element for the
    float32 sums taken in another order before the rounding;
  - losses, schedules and one optimizer update: 1e-6 relative;
  - rnn_encoder, lstm_discriminator, the decoders and the six task methods
    in eval mode: 1e-5, 1e-4 after the greedy decodes of the cm tasks;
  - the whole train step, both deterministic modes: see
    test_train_step_matches_jax. Its JAX side comes from
    tests/goldens/torch_train_step.npz (tests/torch_train_golden.py).
Randomness cannot match JAX's bits; the draws are held to their
distributions (dropout, noise_fn, SpecAugment).
"""

import contextlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from unast_tpu import nn as jnn
from unast_tpu.models import TINY as JTINY
from unast_tpu.models import networks as JN, rnn as JR, unast as JU
from unast_tpu.ops import flash_attention as jax_flash
from unast_tpu.train import losses as JL, optim as JO
from unast_tpu.train.augment import specaugment as j_specaugment
from unast_tpu.train.config import parse_with_config

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.bridge import params_from_jax
from unast_tpu_torch.models import TINY, modules as TM, networks as TN
from unast_tpu_torch.models import rnn as TR, unast as TU
from unast_tpu_torch.ops.attention import (flash_attention,
                                           flash_attention_bwd_plain,
                                           flash_attention_plain)
from unast_tpu_torch.train import losses as TL, optim as TO, steps as TS
from unast_tpu_torch.train.augment import specaugment
from unast_tpu_torch.train.config import train_args

import torch_train_golden as G

ECTX_J = jnn.Ctx.eval()
ECTX_T = tnn.Ctx.eval()
DISC = JTINY.replace(use_discriminator=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers share the host's cores (with a thread pool each, torch's
    small ops run many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol, err_msg=what)


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX state, port params, port state) at TINY with the
    discriminator: the port's init from torch seed 0 (torch_train_golden.
    init_trees), bridged."""
    params, state = G.init_trees()
    tp, ts = params_from_jax(params, state)
    return (jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), tp, ts)


# ---------------------------------------------------------------------------
# The flash-attention backward
# ---------------------------------------------------------------------------


def _attn_case(layout, seed, b, tq, tk, h, d):
    """Fused projections as the port's mha hands them to the kernel: 'qkv'
    one [B, T, 3HD] tensor, 'cross' q [B, Tq, H, D] and one [B, Tk, 2HD]
    k/v tensor; plus ragged kv_lens and an output weight w."""
    rng = np.random.default_rng(seed)
    if layout == "qkv":
        fused = [rng.normal(size=(b, tq, 3 * h * d)).astype(np.float32)]
    else:
        fused = [rng.normal(size=(b, tq, h, d)).astype(np.float32),
                 rng.normal(size=(b, tk, 2 * h * d)).astype(np.float32)]
    lens = np.array([tk, max(1, tk - 9)][:b], np.int32)
    w = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    return fused, lens, w


def _views(layout, xs, h, d):
    def heads(y):
        return [t.unflatten(-1, (h, d)) for t in torch.split(y, h * d, dim=-1)]
    return heads(xs[0]) if layout == "qkv" else [xs[0]] + heads(xs[1])


def _port_grads(layout, fused, lens, w, causal, h, d, dtype):
    """(dq, dk, dv) through the port's flash_attention, taken as the
    gradient of the fused projection(s) the views were cut from."""
    xs = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in fused]
    q, k, v = _views(layout, xs, h, d)
    assert not k.is_contiguous() and not v.is_contiguous()
    before = flash_attention.backward_calls
    out = flash_attention(q, k, v, torch.from_numpy(lens), causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert flash_attention.backward_calls == before + 1
    grads = [x.grad for x in xs]
    if layout == "qkv":
        return torch.split(grads[0], h * d, dim=-1)
    return [grads[0].flatten(-2)] + list(torch.split(grads[1], h * d, dim=-1))


def _jax_grads(layout, fused, lens, w, causal, h, d, dtype):
    """jax.grad through unast_tpu.ops.flash_attention on the same q, k, v
    (contiguous), flattened to [B, T, H*D] like _port_grads."""
    if layout == "qkv":
        q, k, v = np.split(fused[0], 3, axis=-1)
    else:
        q = fused[0].reshape(fused[0].shape[:2] + (h * d,))
        k, v = np.split(fused[1], 2, axis=-1)
    q, k, v = (jnp.asarray(x.reshape(x.shape[:2] + (h, d)), dtype) for x in (q, k, v))

    def loss(q, k, v):
        o = jax_flash(q, k, v, jnp.asarray(lens), causal=causal)
        return jnp.sum(o.astype(jnp.float32) * w)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x.astype(jnp.float32)).reshape(x.shape[:2] + (h * d,))
            for x in g]


@pytest.mark.parametrize("layout,causal,tq,tk,h,d", [
    ("qkv", True, 24, 24, 2, 16),      # decoder self-attention
    ("cross", False, 17, 30, 2, 32),   # cm cross-attention, Tq != Tk
])
def test_flash_backward_matches_jax_f32(layout, causal, tq, tk, h, d):
    fused, lens, w = _attn_case(layout, 0, 2, tq, tk, h, d)
    mine = _port_grads(layout, fused, lens, w, causal, h, d, torch.float32)
    ref = _jax_grads(layout, fused, lens, w, causal, h, d, jnp.float32)
    for name, a, r in zip("qkv", mine, ref):
        _close(a, r, 1e-4, f"d{name}")


def test_flash_backward_matches_jax_bf16():
    h, d = 2, 32
    fused, lens, w = _attn_case("qkv", 1, 2, 20, 20, h, d)
    fused = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
             for a in fused]
    mine = _port_grads("qkv", fused, lens, w, True, h, d, torch.bfloat16)
    ref = _jax_grads("qkv", fused, lens, w, True, h, d, jnp.bfloat16)
    for name, a, r in zip("qkv", mine, ref):
        a = _np(a)
        bound = 2.0 ** -8 * np.abs(r) + 1e-3 * np.abs(r).max()
        assert (np.abs(a - r) <= bound).all(), (name, float(np.abs(a - r).max()))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_matches_autograd_of_plain(causal):
    """The recompute backward gives autograd's gradient of the plain
    forward, on ragged kv_lens."""
    fused, lens, _ = _attn_case("cross", 2, 2, 21, 21, 2, 16)
    q = torch.from_numpy(fused[0]).requires_grad_(True)
    kv = torch.from_numpy(fused[1]).requires_grad_(True)
    k, v = (t.unflatten(-1, (2, 16)) for t in torch.split(kv, 32, dim=-1))
    lens = torch.from_numpy(lens)
    o = flash_attention_plain(q, k, v, lens, causal)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q, k, v, lens, causal, o.detach(), do)
    for a, r in zip(got, want):
        _close(a, r, 1e-5)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _loss_inputs():
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


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    x = _loss_inputs()
    mine = LOSSES[name](TL, x, _t)
    ref = LOSSES[name](JL, x, jnp.asarray)
    np.testing.assert_allclose(_np(mine), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The RNN encoder and the LSTM discriminator
# ---------------------------------------------------------------------------


def test_rnn_encoder_and_discriminator_match_jax(models):
    params, _, tp, _ = models
    jd, td = params["discriminator"], tp["discriminator"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 10, 32)).astype(np.float32)
    lens = np.array([10, 7, 3, 1], np.int32)
    x = x * (np.arange(10) < lens[:, None])[..., None]
    ref_out, (ref_h, ref_c) = jax.jit(
        lambda p, x, l: JR.rnn_encoder(p, ECTX_J, x, l, 0.2))(jd["rnn"], x, lens)
    out, (h, c) = TR.rnn_encoder(td["rnn"], ECTX_T, _t(x), _t(lens), 0.2)
    _close(out, ref_out, 1e-5, "outputs")
    _close(h, ref_h, 1e-5, "h")
    _close(c, ref_c, 1e-5, "c")
    assert not out[3, 1:].any() and not out[2, 3:].any()   # zero at pads
    ref = jax.jit(lambda p, x, l: JU.lstm_discriminator(p, ECTX_J, x, l))(jd, x, lens)
    _close(TU.lstm_discriminator(td, ECTX_T, _t(x), _t(lens)), ref, 1e-5, "logits")


# ---------------------------------------------------------------------------
# The teacher-forced decoders
# ---------------------------------------------------------------------------


def _dec_inputs():
    rng = np.random.default_rng(7)
    text = rng.integers(3, 46, size=(2, 12)).astype(np.int32)
    tlens = np.array([12, 7], np.int32)
    mel = rng.uniform(size=(2, 20, 80)).astype(np.float32)
    mlens = np.array([20, 9], np.int32)
    memory = rng.normal(size=(2, 15, 32)).astype(np.float32)
    mem_pad = np.arange(15)[None, :] >= np.array([15, 6])[:, None]
    return text, tlens, mel, mlens, memory, mem_pad


DECODERS = [(side, impl) for side in ("text", "speech") for impl in ("xla", "flash")]


def _decode(N, cfg, p, s, ctx, side, tgt, tgt_lens, memory, mem_pad):
    """(outputs, cross-attention weights) of N's teacher-forced decoder."""
    ws = []
    out, _ = (N.text_decode_sequence if side == "text" else
              N.speech_decode_sequence)(p, s, ctx, cfg, tgt, tgt_lens, memory,
                                        mem_pad, cross_weights_out=ws)
    return (out if side == "text" else out[:3]), ws


@pytest.fixture(scope="module")
def jax_decoders(models):
    """Every case of DECODERS through the JAX decoders, in one compile."""
    params, state, _, _ = models
    text, tlens, mel, mlens, memory, mem_pad = _dec_inputs()

    def run(params, state):
        return {(side, impl): _decode(
            JN, DISC.replace(attn_impl=impl), params[f"{side}_m"],
            state[f"{side}_m"], ECTX_J, side,
            *((text, tlens) if side == "text" else (mel, mlens)), memory, mem_pad)
            for side, impl in DECODERS}
    return jax.jit(run)(params, state)


@pytest.mark.parametrize("side,impl", DECODERS)
def test_decoder_sequence_matches_jax(models, jax_decoders, side, impl):
    _, _, tp, ts = models
    text, tlens, mel, mlens, memory, mem_pad = _dec_inputs()
    tgt, tgt_lens = (text, tlens) if side == "text" else (mel, mlens)
    out, ws = _decode(TN, TINY.replace(attn_impl=impl), tp[f"{side}_m"],
                      ts[f"{side}_m"], ECTX_T, side, _t(tgt), _t(tgt_lens),
                      _t(memory), _t(mem_pad))
    ref, ref_ws = jax_decoders[(side, impl)]
    for a, r in zip(_leaves(out), _leaves(ref)):
        _close(a, r, 1e-5)
    assert len(ws) == len(ref_ws) == TINY.num_layers
    for a, r in zip(ws, ref_ws):
        _close(a, r, 1e-5, "cross weights")


# ---------------------------------------------------------------------------
# The six task methods in eval mode
# ---------------------------------------------------------------------------


def _task(U, name):
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


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


TASKS = ["text_ae", "speech_ae", "cm_text_in", "cm_speech_in", "tts", "asr"]


@pytest.fixture(scope="module")
def jax_tasks(models):
    """Every task of TASKS through the JAX package in eval mode, in one
    compile: {name: (outputs, new state)}."""
    params, state, _, _ = models
    text, tlens, mel, mlens, _, _ = _dec_inputs()
    return jax.jit(lambda p, s: {
        name: _task(JU, name)(p, s, ECTX_J, DISC, text, tlens, mel, mlens)
        for name in TASKS})(params, state)


@pytest.mark.parametrize("name", TASKS)
def test_task_matches_jax_in_eval_mode(models, jax_tasks, name):
    _, _, tp, ts = models
    text, tlens, mel, mlens, _, _ = _dec_inputs()
    ref, ref_state = jax_tasks[name]
    out, new_state = _task(TU, name)(tp, ts, ECTX_T,
                                     TINY.replace(use_discriminator=True),
                                     *(_t(a) for a in (text, tlens, mel, mlens)))
    refs, outs = _leaves(ref), _leaves(out)
    assert len(refs) == len(outs)
    tol = 1e-4 if name.startswith("cm") else 1e-5
    for i, (a, r) in enumerate(zip(outs, refs)):
        _close(a, r, tol, f"output {i}")
    assert G.flatten(new_state).keys() == G.flatten(jax.device_get(ref_state)).keys()


# ---------------------------------------------------------------------------
# Schedules and the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["multistep", "linear", "transformer", "none"])
def test_schedule_matches_jax(sched):
    argv = ["--sched_type", sched, "--lr", "0.01", "--warmup_steps", "40",
            "--epochs", "3", "--epoch_steps", "50", "--lr_milestones", "[1, 2]"]
    ref = JO.make_schedule(parse_with_config(argv))
    mine = TO.make_schedule(train_args(sched_type=sched, lr=0.01, warmup_steps=40,
                                       epochs=3, epoch_steps=50, lr_milestones=[1, 2]))
    for step in (0, 1, 20, 39, 40, 49, 50, 99, 100, 149, 150, 400):
        np.testing.assert_allclose(mine(step), float(ref(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("optim_type,clip", [("adamw", 1.0), ("adamw", 100.0),
                                             ("adam", 1.0)])
def test_optimizer_update_matches_optax(optim_type, clip):
    """Two updates (bias correction at counts 1 and 2) of one tree, with
    the global-norm clip triggered (1.0) or not (100.0)."""
    rng = np.random.default_rng(8)
    params = {"a": {"w": rng.normal(size=(5, 3))}, "b": [rng.normal(size=(4,))]}
    grads = [jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape) * 2, params)
             for _ in range(2)]
    params, grads = jax.tree_util.tree_map(lambda x: x.astype(np.float32), (params, grads))
    argv = ["--optim_type", optim_type, "--grad_clip", str(clip), "--lr", "0.01",
            "--weight_decay", "0.1", "--sched_type", "multistep"]
    tx = JO.make_optimizer(parse_with_config(argv))
    opt = TO.make_optimizer(train_args(optim_type=optim_type, grad_clip=clip,
                                       lr=0.01, weight_decay=0.1,
                                       sched_type="multistep"))
    jp, jstate = params, tx.init(params)
    tp = TO.tree_map(_t, params)
    tstate = opt.init(tp)
    for g in grads:
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        t_updates, tstate = opt.update(TO.tree_map(_t, g), tstate, tp)
        tp = TO.apply_updates(tp, t_updates)
        for a, r in zip(TO.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(_np(a), np.asarray(r), rtol=1e-6, atol=1e-7)
    assert tstate.count == 2


# ---------------------------------------------------------------------------
# The bridge's discriminator tree
# ---------------------------------------------------------------------------


def test_bridge_carries_the_discriminator():
    """params_from_jax carries a JAX-initialised discriminator tree name for
    name."""
    shapes = jax.eval_shape(
        lambda key: JU.lstm_discriminator_init(key, 32, 16, True, 2),
        jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    jd = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), shapes)
    ref = G.flatten({"discriminator": jd})
    mine = G.flatten(params_from_jax({"discriminator": jd}, {})[0])
    assert mine.keys() == ref.keys()
    assert {"discriminator/rnn/layers/1/bwd/wh", "discriminator/rnn/reduce_h/w",
            "discriminator/rnn/reduce_c/b", "discriminator/fc2/w"} <= mine.keys()
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# Randomness: the distributions of the draws
# ---------------------------------------------------------------------------


def test_dropout_and_noise_statistics():
    gen = torch.Generator().manual_seed(9)
    ctx = tnn.Ctx(generator=gen, train=True)
    x = torch.ones(200_000)
    y = tnn.dropout(ctx, x, 0.3)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 4 * (0.21 / 200_000) ** 0.5
    assert torch.allclose(y[kept], torch.tensor(1 / 0.7))
    z = TM.noise_fn(ctx, torch.ones(400, 500, 3), 0.3)
    rows = z[..., 0]
    assert bool((z == rows[..., None]).all())     # whole time steps zeroed
    assert abs(float((rows == 0).float().mean()) - 0.3) < 4 * (0.21 / 200_000) ** 0.5
    for c, p in ((ECTX_T, 0.3), (ctx, 0.0)):
        assert tnn.dropout(c, x, p) is x and TM.noise_fn(c, z, p) is z
    with pytest.raises(ValueError, match="generator"):
        tnn.dropout(tnn.Ctx(train=True), x, 0.1)


def _span_stats(masked):
    """Masked frames per row, and rows with more than two masked spans."""
    m = masked.astype(np.int8)
    starts = (np.diff(m, axis=1, prepend=0) == 1).sum(1)
    return m.sum(1), int((starts > 2).sum())


def test_specaugment_statistics_match_jax():
    """Over 4000 rows: the masked frames per row have JAX's mean (within
    four standard errors of the difference), no row has more than two
    spans, masked frames hold the row's mean over the padded [T, M]
    tensor and the others are untouched."""
    n, t, m = 4000, 120, 3
    rng = np.random.default_rng(10)
    mel = rng.normal(size=(n, t, m)).astype(np.float32)
    lens = rng.integers(1, t + 1, size=(n,)).astype(np.int32)
    out = specaugment(torch.Generator().manual_seed(11), _t(mel), _t(lens), 20, 100)
    ref = np.asarray(j_specaugment(jax.random.PRNGKey(11), jnp.asarray(mel),
                                   jnp.asarray(lens), 20, 100))
    out = _np(out)
    masked = (out != mel).any(-1)
    ref_masked = (ref != mel).any(-1)
    fill = mel.mean(axis=(1, 2))
    np.testing.assert_allclose(out[masked], np.broadcast_to(
        fill[:, None, None], out.shape)[masked], rtol=1e-6, atol=1e-7)
    counts, many = _span_stats(masked)
    ref_counts, ref_many = _span_stats(ref_masked)
    assert many == ref_many == 0
    se = np.sqrt((counts.var() + ref_counts.var()) / n)
    assert abs(counts.mean() - ref_counts.mean()) < 4 * se, (
        counts.mean(), ref_counts.mean())
    assert not masked[np.arange(t)[None, :] >= lens[:, None]].any()


# ---------------------------------------------------------------------------
# The whole train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden(models):
    z = np.load(G.GOLDEN)
    stale = ("tests/goldens/torch_train_step.npz is stale: {} changed; run "
             "`JAX_PLATFORMS=cpu python tests/torch_train_golden.py`")
    assert str(z["source_hash"]) == G.source_hash(), stale.format(
        "the JAX package, tests/torch_train_golden.py or the config")
    assert str(z["init_hash"]) == G.init_hash(models[2]), stale.format(
        "the port's init")
    return {k: z[k] for k in z.files}


def _golden_tree(golden, mode, name):
    pre = f"{mode}/{name}/"
    return {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}


@pytest.mark.parametrize("mode", G.MODES)
def test_train_step_matches_jax(models, golden, mode):
    """One make_train_step step with the discriminator, guided attention
    and flash on, from the same weights, against the JAX step's golden.
    Tolerances (measured in brackets): metrics 1e-5 relative (2.5e-7);
    new BN state 1e-5 (2.4e-7); Adam's first moment, 0.1 x the clipped
    float32 gradient, 1e-4 relative plus 1e-5 of the largest moment of its
    tree (gradients of ~0, such as the cross-attention key bias's, are
    summation noise; 5e-9 against a largest moment of 1.1e-2). New params:
    the first Adam step moves a param by lr * g / (|g| + 1e-8), +-lr
    wherever |g| >> 1e-8, so they are compared as that normalised update,
    (new - old) / lr, to 1e-3 (1.5e-4, the float32 rounding of the new
    param over lr) where JAX's first moment is above 1e-7 (|g| > 1e-6),
    and to 2 (a sign flip of a tiny gradient) elsewhere."""
    _, _, tp, ts = models
    cfg = TINY.replace(**G.model_overrides(mode))
    args = train_args(G.CONFIG, sp_steps=2, objective_eval_mode=mode == "eval")
    batches = {k: tuple(_t(a).long() if a.dtype == np.int32 else _t(a)
                        for a in v) for k, v in G.batches_np().items()}
    state = TS.train_state(tp, ts, cfg, args)
    before = flash_attention.backward_calls
    step = TS.make_train_step(cfg, args)
    patch = (TS.zero_fixed_dropouts() if mode == "train"
             else contextlib.nullcontext())
    with patch:
        new, metrics = step(state, torch.Generator().manual_seed(0), batches)
    assert (flash_attention.backward_calls - before
            == TS.flash_calls_per_step(cfg, args)[1])
    assert new.step == 1

    ref_metrics = _golden_tree(golden, mode, "metrics")
    assert sorted(metrics) == sorted(ref_metrics)
    for k, r in ref_metrics.items():
        np.testing.assert_allclose(_np(metrics[k]), r, rtol=1e-5, err_msg=k)
    for k, r in _golden_tree(golden, mode, "state").items():
        np.testing.assert_allclose(G.flatten(new.net_state)[k], r, atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    for name, opt in (("gen_mu", new.gen_opt), ("disc_mu", new.disc_opt)):
        mine = G.flatten(opt.mu)
        ref = _golden_tree(golden, mode, name)
        assert mine.keys() == ref.keys()
        top = max(np.abs(r).max() for r in ref.values())
        for k, r in ref.items():
            np.testing.assert_allclose(mine[k], r, rtol=1e-4, atol=1e-5 * top,
                                       err_msg=k)
    old = G.flatten(tp)
    mine = G.flatten(new.params)
    ref = _golden_tree(golden, mode, "params")
    mu = {**{k: v for k, v in _golden_tree(golden, mode, "gen_mu").items()},
          **{"discriminator/" + k: v
             for k, v in _golden_tree(golden, mode, "disc_mu").items()}}
    assert mine.keys() == ref.keys()
    lr = args.lr
    for k, r in ref.items():
        u_mine, u_ref = (mine[k] - old[k]) / lr, (r - old[k]) / lr
        big = np.abs(mu[k]) > 1e-7
        np.testing.assert_allclose(u_mine[big], u_ref[big], atol=1e-3, err_msg=k)
        assert (np.abs(u_mine - u_ref) <= 2 + 1e-3).all(), k
