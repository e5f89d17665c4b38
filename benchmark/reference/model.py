"""Plain PyTorch reference of the transformer TTS/ASR model's supervised
step (the curriculum's warm-up: TTS and ASR teacher-forced, guided
attention, AdamW), written from the model's equations for the benchmark.

It imports nothing of the program. It reads the benchmark's frozen
configuration (a flat dict, benchmark/configs/*.json) and holds its weights
in the program's tree layout (linear `w` [in, out], conv `w` [k, in, out]),
so that one tree, made by `make_weights` from a seed, is handed to both
sides. It computes in float32 with plain attention. Every dropout mask is
drawn from the step's torch.Generator in the order the model's layers run,
with the shapes they have, so that a forward in train mode on the same
generator draws the same masks as the program's.

`prec` rounds what a program computing in that type would hold: the
operands and outputs of every matrix product and convolution and every
layer norm's output. 'f32' leaves them (the reference); 'bf16' and 'fp8'
round them to those types (fp8 e4m3 with one scale a tensor): the
lower-precision control.

Each transformer layer runs under activation checkpointing, its step
generator set back to where the layer began for the recompute and
forward again after it, so the recompute draws the layer's masks again
and the stream goes on as without it: the reference of the widest
configuration's step fits on the card in float32.
"""

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

VOCAB = 46
PAD, SOS, EOS = 0, 1, 2
NEG_INF = -1e9
PE_DROPOUT = 0.1              # the positional encoding's dropout, fixed in code
SPEC_FREQ_MASK, SPEC_TIME_MASK = 20, 100
BN_MOMENTUM, BN_EPS, LN_EPS = 0.1, 1e-5, 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# Rounding of the products' operands
# ---------------------------------------------------------------------------

class _Rounded(torch.autograd.Function):
    """fn(x) forward and grad_fn(grad) backward: a program computing in a
    lower precision rounds both passes (fp8 training: e4m3 forward, e5m2
    gradients, each tensor with its own scale)."""

    @staticmethod
    def forward(ctx, x, fn, grad_fn):
        ctx.grad_fn = grad_fn
        return fn(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.grad_fn(grad), None, None


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _scaled(dtype, top):
    def fn(x):
        s = x.abs().amax().clamp(min=1e-30) / top
        return (x / s).to(dtype).float() * s
    return fn


_E4M3 = _scaled(torch.float8_e4m3fn, FP8_MAX)
_E5M2 = _scaled(torch.float8_e5m2, 57344.0)


def rounder(prec: str):
    """x -> x rounded as `prec` ('f32', 'bf16', 'fp8'), kept in float32,
    with its gradient rounded as that precision's backward would."""
    if prec == "f32":
        return lambda x: x
    fn, grad_fn = {"bf16": (_bf16, _bf16), "fp8": (_E4M3, _E5M2)}[prec]
    return lambda x: _Rounded.apply(x, fn, grad_fn)


@contextlib.contextmanager
def full_float32():
    """Float32 products in float32 (TF32 off) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Ctx(NamedTuple):
    gen: object          # torch.Generator, or None in eval mode
    train: bool
    rnd: object          # rounder


# ---------------------------------------------------------------------------
# Weights: the init of each leaf, made from one seed in a few large draws
# ---------------------------------------------------------------------------

def _u(a, *shape):
    return ("uniform", float(a), tuple(shape))


def _xavier(shape, gain, fan_in, fan_out):
    return _u(gain * math.sqrt(6.0 / (fan_in + fan_out)), *shape)


def _linear(d_in, d_out, gain=1.0, torch_default=False, zero_bias=False):
    w = (_u(1.0 / math.sqrt(d_in), d_in, d_out) if torch_default
         else _xavier((d_in, d_out), gain, d_in, d_out))
    b = ("zeros", (d_out,)) if zero_bias else _u(1.0 / math.sqrt(d_in), d_out)
    return {"w": w, "b": b}


def _conv(c_in, c_out, k, gain=1.0):
    return {"w": _xavier((k, c_in, c_out), gain, c_in * k, c_out * k),
            "b": _u(1.0 / math.sqrt(c_in * k), c_out)}


def _ln(c):
    return {"scale": ("ones", (c,)), "bias": ("zeros", (c,))}


def _mha(d):
    def proj():
        return {"w": _xavier((d, d), 1.0, d, 3 * d), "b": ("zeros", (d,))}
    return {"q": proj(), "k": proj(), "v": proj(),
            "out": _linear(d, d, torch_default=True, zero_bias=True)}


def _ffn(d, ffn):
    return {"lin1": _linear(d, ffn, torch_default=True),
            "lin2": _linear(ffn, d, torch_default=True)}


def _enc_layer(d, ffn):
    return {"attn": _mha(d), "ln1": _ln(d), "ln2": _ln(d), **_ffn(d, ffn)}


def _dec_layer(d, ffn):
    return {"self": _mha(d), "cross": _mha(d), "ln1": _ln(d), "ln2": _ln(d),
            "ln3": _ln(d), **_ffn(d, ffn)}


RELU_GAIN, TANH_GAIN = math.sqrt(2.0), 5.0 / 3.0


def text_prenet_spec(c):
    return {"embed": {"w": ("normal", (VOCAB, c["t_emb_dim"]), PAD)},
            "conv1": _conv(c["t_emb_dim"], c["e_in"], 5, RELU_GAIN),
            "conv2": _conv(c["e_in"], c["e_in"], 5, RELU_GAIN),
            "conv3": _conv(c["e_in"], c["e_in"], 5, RELU_GAIN),
            "bn": {f"bn{i}": _ln(c["e_in"]) for i in (1, 2, 3)}}


def speech_postnet_spec(c, r=1):
    h, m = c["hidden"], c["num_mels"]
    return {"conv1": _conv(m, h, 5, TANH_GAIN),
            "convs": [_conv(h, h, 5, TANH_GAIN) for _ in range(3)],
            "conv2": _conv(h, m, 5),
            "mel_proj": _linear(h, r * m, torch_default=True),
            "stop_proj": _linear(h, r, torch_default=True),
            "bn": {f"bn{i}": _ln(h) for i in range(4)}}


def stack_spec(c, layer):
    return {"layers": [layer(c["e_in"], c["ffn_dim"])
                       for _ in range(c["num_layers"])]}


def unast_spec(c):
    """The TTS/ASR model's weights (no discriminator): the text model and
    the speech model, each an encoder and a decoder."""
    text = {"prenet": text_prenet_spec(c),
            "encoder": stack_spec(c, _enc_layer),
            "decoder": stack_spec(c, _dec_layer),
            "postnet": {"fc": _linear(c["hidden"], VOCAB, torch_default=True)}}
    speech = {"prenet": {"fc1": _linear(c["num_mels"], c["s_pre_hid"]),
                         "fc2": _linear(c["s_pre_hid"], c["e_in"])},
              "encoder": stack_spec(c, _enc_layer),
              "decoder": stack_spec(c, _dec_layer),
              "postnet": speech_postnet_spec(c)}
    return {"text_m": text, "speech_m": speech}


def bn_state(c, names):
    return {"bn": {n: {"mean": torch.zeros(c), "var": torch.ones(c)}
                   for n in names}}


def unast_state(c):
    """The BatchNorm running statistics at the start."""
    return {"text_m": {"prenet": bn_state(c["e_in"], ("bn1", "bn2", "bn3"))},
            "speech_m": {"postnet": bn_state(c["hidden"],
                                             [f"bn{i}" for i in range(4)])}}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _build(spec, fill):
    if isinstance(spec, dict):
        return {k: _build(v, fill) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_build(v, fill) for v in spec]
    return fill(spec)


def make_weights(spec, seed: int, device, overrides=None):
    """The tree of float32 tensors on `device` that `spec` describes, drawn
    from `seed` in two calls on a generator of `device`: one uniform
    buffer for every uniform leaf and one normal buffer for every normal
    leaf, cut in tree order. `overrides` maps a leaf's path ('a/b/0/w') to
    (scale, shift): the leaf becomes leaf * scale + shift."""
    leaves = list(_leaves(spec))
    n_u = sum(math.prod(s[2]) for _, s in leaves if s[0] == "uniform")
    n_n = sum(math.prod(s[1]) for _, s in leaves if s[0] == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    ubuf = torch.rand(n_u, generator=g, device=device) * 2.0 - 1.0
    nbuf = torch.randn(n_n, generator=g, device=device)
    at = {"uniform": 0, "normal": 0}
    overrides = overrides or {}

    def fill(s):
        kind = s[0]
        if kind == "uniform":
            n = math.prod(s[2])
            x = ubuf[at["uniform"]:at["uniform"] + n].view(s[2]) * s[1]
            at["uniform"] += n
            return x
        if kind == "normal":
            n = math.prod(s[1])
            x = nbuf[at["normal"]:at["normal"] + n].view(s[1]).clone()
            at["normal"] += n
            x[s[2]] = 0.0
            return x
        return (torch.ones if kind == "ones" else torch.zeros)(
            s[1], device=device)

    tree = _build(spec, fill)
    for path, (scale, shift) in overrides.items():
        node = tree
        keys = [int(k) if k.isdigit() else k for k in path.split("/")]
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = node[keys[-1]] * scale + shift
    return tree


def leaves(tree):
    """[(path string, tensor)] in tree order."""
    return [("/".join(map(str, p)), x) for p, x in _leaves(tree)]


def tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def dropout(ctx: Ctx, x, p, shape=None):
    """Inverted dropout; the mask drawn as torch.rand(x.shape) < 1 - p."""
    if not ctx.train or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(list(x.shape), generator=ctx.gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def fold_generator(seed: int, index: int, device):
    state = np.random.SeedSequence([seed, index]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def linear(ctx, p, x):
    return ctx.rnd(ctx.rnd(x) @ ctx.rnd(p["w"]) + p["b"])


def conv1d(ctx, p, x, pad):
    xt = F.pad(ctx.rnd(x).transpose(1, 2), pad)
    w = ctx.rnd(p["w"]).permute(2, 1, 0)
    return ctx.rnd(F.conv1d(xt, w).transpose(1, 2) + p["b"])


def layernorm(p, x, rnd=lambda y: y):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return rnd((x - mean) * torch.rsqrt(var + LN_EPS) * p["scale"] + p["bias"])


def checkpointed(ctx, fn, *args):
    """fn(ctx, *args) under activation checkpointing; its recompute draws
    from the generator state the first run began at, and leaves the
    generator where the backward found it."""
    if ctx.gen is None or not torch.is_grad_enabled():
        return fn(ctx, *args)
    start = ctx.gen.get_state()
    runs = [0]

    def run(*a):
        runs[0] += 1
        if runs[0] == 1:
            return fn(ctx, *a)
        now = ctx.gen.get_state()
        ctx.gen.set_state(start)
        try:
            return fn(ctx, *a)
        finally:
            ctx.gen.set_state(now)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def batchnorm(p, s, x, train):
    if train:
        mean = x.mean(dim=(0, 1))
        var = x.var(dim=(0, 1), unbiased=False)
        n = x.shape[0] * x.shape[1]
        new = {"mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean.detach(),
               "var": (1 - BN_MOMENTUM) * s["var"]
               + BN_MOMENTUM * var.detach() * (n / max(1, n - 1))}
    else:
        mean, var, new = s["mean"], s["var"], s
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * p["scale"]) + p["bias"], new


def lens_mask(lens, t):
    return torch.arange(t, device=lens.device)[None, :] < lens[:, None]


def sinusoid(t, d, device):
    pe = np.zeros((5000, d), dtype=np.float32)
    pos = np.arange(5000, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe[:t]).to(device)


def positional_encoding(ctx, x, scale=True):
    d, t = x.shape[-1], x.shape[1]
    if scale:
        x = x * math.sqrt(d)
    return dropout(ctx, x + sinusoid(t, d, x.device)[None], PE_DROPOUT)


def attention(ctx, q, k, v, keep, drop_p=0.0, weights_out=None):
    """q [B, Tq, H, D], k/v [B, Tk, H, D], keep bool broadcast to
    [B, H, Tq, Tk]. Float32 scores and softmax; with weights_out the
    probabilities are kept (before dropout) and dropout applies to them."""
    scores = torch.einsum("bqhd,bkhd->bhqk", ctx.rnd(q), ctx.rnd(k))
    scores = scores / math.sqrt(q.shape[-1])
    scores = torch.where(keep, scores, scores.new_tensor(NEG_INF))
    w = torch.softmax(scores, dim=-1)
    if weights_out is not None:
        weights_out.append(w)
        w = dropout(ctx, w, drop_p)
    return torch.einsum("bhqk,bkhd->bqhd", ctx.rnd(w), ctx.rnd(v))


def mha(ctx, p, q_in, kv_in, nhead, keep, drop_p=0.0, weights_out=None):
    b, tq, d = q_in.shape
    q = linear(ctx, p["q"], q_in)
    k = linear(ctx, p["k"], kv_in)
    v = linear(ctx, p["v"], kv_in)
    heads = lambda x: x.reshape(x.shape[0], x.shape[1], nhead, d // nhead)
    o = attention(ctx, heads(q), heads(k), heads(v), keep, drop_p, weights_out)
    return linear(ctx, p["out"], ctx.rnd(o.reshape(b, tq, d)))


def ffn(ctx, p, x, drop_p):
    h = dropout(ctx, torch.relu(linear(ctx, p["lin1"], x)), drop_p)
    return linear(ctx, p["lin2"], h)


def key_keep(lens, tk):
    """bool [B, 1, 1, Tk]: the valid keys of each row."""
    return lens_mask(lens, tk)[:, None, None, :]


def causal_keep(lens, t):
    m = torch.arange(t, device=lens.device)
    return key_keep(lens, t) & (m[None, :] <= m[:, None])[None, None]


def encoder_layer(ctx, p, x, keep, nhead, drop_p):
    def layer(ctx, x):
        a = mha(ctx, p["attn"], x, x, nhead, keep)
        x = layernorm(p["ln1"], x + dropout(ctx, a, drop_p), ctx.rnd)
        f = ffn(ctx, p, x, drop_p)
        return layernorm(p["ln2"], x + dropout(ctx, f, drop_p), ctx.rnd)
    return checkpointed(ctx, layer, x)


def encoder(ctx, p, x, lens, c, drop_p):
    """The encoder stack; under the configuration's remat each layer draws
    from its own generator, seeded from one draw of the step's (the
    program's rematerialised stack draws so, so that a recompute draws
    the same masks)."""
    keep = key_keep(lens, x.shape[1])
    layers = p["layers"]
    if c.get("remat") and ctx.train:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=ctx.gen,
                                 device=ctx.gen.device).item())
        for li, lp in enumerate(layers):
            inner = ctx._replace(gen=fold_generator(seed, li, x.device))
            x = encoder_layer(inner, lp, x, keep, c["nhead"], drop_p)
        return x
    for lp in layers:
        x = encoder_layer(ctx, lp, x, keep, c["nhead"], drop_p)
    return x


def decoder(ctx, p, x, tgt_lens, memory, mem_lens, c, ws):
    """The teacher-forced decoder: causal self-attention, cross-attention
    whose probabilities go to `ws` (guided attention), FFN; post-LN."""
    drop_p = c["d_drop"]
    self_keep = causal_keep(tgt_lens, x.shape[1])
    cross_keep = key_keep(mem_lens, memory.shape[1])
    def layer(ctx, x, memory, lp):
        a = mha(ctx, lp["self"], x, x, c["nhead"], self_keep)
        x = layernorm(lp["ln1"], x + dropout(ctx, a, drop_p), ctx.rnd)
        a = mha(ctx, lp["cross"], x, memory, c["nhead"], cross_keep, drop_p, ws)
        x = layernorm(lp["ln2"], x + dropout(ctx, a, drop_p), ctx.rnd)
        f = ffn(ctx, lp, x, drop_p)
        return layernorm(lp["ln3"], x + dropout(ctx, f, drop_p), ctx.rnd)

    for lp in p["layers"]:
        x = checkpointed(ctx, layer, x, memory, lp)
    return x


def text_embed(ctx, p, ids, c):
    emb = p["embed"]["w"][ids] * (ids != PAD)[..., None].float()
    return dropout(ctx, emb, c["t_pre_drop"])


def text_prenet_convs(ctx, p, s, x, c):
    new = {}
    for i in (1, 2, 3):
        x = conv1d(ctx, p[f"conv{i}"], x, (2, 2))
        x, new[f"bn{i}"] = batchnorm(p["bn"][f"bn{i}"], s["bn"][f"bn{i}"], x,
                                     ctx.train)
        x = dropout(ctx, torch.relu(x), c["t_pre_drop"])
    return x, {"bn": new}


def speech_prenet(ctx, p, x, c):
    h = dropout(ctx, torch.relu(linear(ctx, p["fc1"], x)), c["s_pre_drop"])
    return torch.relu(linear(ctx, p["fc2"], h))


def speech_postnet(ctx, p, s, x, c):
    new = {}
    h = conv1d(ctx, p["conv1"], x, (4, 0))
    h, new["bn0"] = batchnorm(p["bn"]["bn0"], s["bn"]["bn0"], h, ctx.train)
    h = dropout(ctx, torch.tanh(h), c["s_post_drop"])
    for i, cp in enumerate(p["convs"]):
        h2 = conv1d(ctx, cp, h, (4, 0))
        h2, new[f"bn{i + 1}"] = batchnorm(p["bn"][f"bn{i + 1}"],
                                          s["bn"][f"bn{i + 1}"], h2, ctx.train)
        h = dropout(ctx, torch.tanh(h2), c["s_post_drop"])
    return conv1d(ctx, p["conv2"], h, (4, 0)), {"bn": new}


def text_encode(ctx, p, s, ids, lens, c):
    x = text_embed(ctx, p["prenet"], ids, c)
    x, ps = text_prenet_convs(ctx, p["prenet"], s["prenet"], x, c)
    x = positional_encoding(ctx, x)
    return encoder(ctx, p["encoder"], x, lens, c, c["e_drop"]), {"prenet": ps}


def speech_encode(ctx, p, mel, lens, c):
    x = positional_encoding(ctx, speech_prenet(ctx, p["prenet"], mel, c))
    return encoder(ctx, p["encoder"], x, lens, c, c["e_drop"])


def speech_decode(ctx, p, s, mel, mel_len, memory, mem_lens, c, ws):
    b = mel.shape[0]
    go = torch.zeros((b, 1, mel.shape[2]), device=mel.device)
    x = speech_prenet(ctx, p["prenet"], torch.cat([go, mel[:, :-1]], dim=1), c)
    x = positional_encoding(ctx, x)
    h = decoder(ctx, p["decoder"], x, mel_len, memory, mem_lens, c, ws)
    pre = linear(ctx, p["postnet"]["mel_proj"], h)
    stop = linear(ctx, p["postnet"]["stop_proj"], h)[..., 0]
    resid, ps = speech_postnet(ctx, p["postnet"], s["postnet"], pre, c)
    return pre, pre + resid, stop, {"postnet": ps}


def text_decode(ctx, p, text, text_len, memory, mem_lens, c, ws):
    sos = torch.full((text.shape[0], 1), SOS, dtype=text.dtype,
                     device=text.device)
    x = text_embed(ctx, p["prenet"], torch.cat([sos, text[:, :-1]], dim=1), c)
    x = positional_encoding(ctx, x)
    h = decoder(ctx, p["decoder"], x, text_len, memory, mem_lens, c, ws)
    return linear(ctx, p["postnet"]["fc"], dropout(ctx, h, c["t_post_drop"]))


# ---------------------------------------------------------------------------
# SpecAugment and the losses
# ---------------------------------------------------------------------------

def _randint(gen, high, b, device):
    high = torch.as_tensor(high, device=device)
    u = torch.rand((b,), generator=gen, device=device)
    return (u * high).floor().long().clamp(max=torch.clamp(high - 1, min=0))


def specaugment(gen, mel, mel_len):
    """Two time spans of each row replaced by the row's mean (the model's
    'frequency' mask indexes time too)."""
    b, dev = mel.shape[0], mel.device
    mel_len = mel_len.long()
    f_len = _randint(gen, SPEC_FREQ_MASK, b, dev)
    t_len = _randint(gen, SPEC_TIME_MASK, b, dev)
    bad = (mel_len - t_len) <= 0
    t_alt = _randint(gen, torch.clamp(mel_len // 2, min=1), b, dev)
    t_len = torch.where(bad, t_alt, t_len)
    f_len = torch.minimum(f_len, torch.clamp(mel_len - 1, min=0))

    def start(span):
        hi = torch.clamp(mel_len - span, min=1)
        return (torch.rand((b,), generator=gen, device=dev) * hi).long()

    f0, t0 = start(f_len), start(t_len)
    pos = torch.arange(mel.shape[1], device=dev)[None, :]
    span = (((pos >= t0[:, None]) & (pos < (t0 + t_len)[:, None]))
            | ((pos >= f0[:, None]) & (pos < (f0 + f_len)[:, None])))
    return torch.where(span[:, :, None], mel.mean(dim=(1, 2))[:, None, None], mel)


def masked_mse(gold, pred, mask):
    m = torch.broadcast_to(mask, gold.shape).float()
    return (((gold - pred) ** 2) * m).sum() / m.sum().clamp(min=1.0)


def speech_loss(mel, mel_len, pre, post, stop, eos_weight):
    t = mel.shape[1]
    mask = lens_mask(mel_len, t)[..., None]
    label = (torch.arange(t, device=mel.device)[None, :]
             == (mel_len - 1)[:, None]).float()
    w = torch.where(label == 1, eos_weight, 1.0)
    bce = -(w * label * F.logsigmoid(stop) + (1 - label) * F.logsigmoid(-stop))
    return masked_mse(mel, pre, mask) + masked_mse(mel, post, mask) + bce.mean()


def text_loss(gold, logits, eos_weight):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, gold[..., None])[..., 0]
    w = torch.where(gold == EOS, eos_weight, 1.0)
    w = torch.where(gold == PAD, 0.0, w)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def guided_attention(ws, q_len, k_len, sigma):
    attn = torch.stack(ws)                      # [L, B, H, Tq, Tk]
    tq, tk = attn.shape[-2:]
    dev = attn.device
    qs = torch.arange(tq, dtype=torch.float32, device=dev)[:, None]
    ks = torch.arange(tk, dtype=torch.float32, device=dev)[None, :]
    ql = q_len.float().clamp(min=1.0)[:, None, None]
    kl = k_len.float().clamp(min=1.0)[:, None, None]
    w = 1.0 - torch.exp(-((qs / ql - ks / kl) ** 2) / (2.0 * sigma ** 2))
    valid = ((qs < ql) & (ks < kl)).float()[:, None]
    num = (attn * w[:, None] * valid).sum()
    return num / torch.broadcast_to(valid, attn.shape).sum().clamp(min=1.0)


def sp_loss(params, state, gen, batch, c, prec="f32"):
    """The supervised objective of one micro-batch in train mode: TTS and
    ASR teacher-forced (SpecAugment on the ASR input), their losses and
    the guided-attention term. Returns (loss, {'tts', 'asr', 'ga_sp'},
    new BN state)."""
    text, mel, text_len, mel_len = batch
    ctx = Ctx(gen, True, rounder(prec))
    mel_aug = specaugment(gen, mel, mel_len)
    tp, sp_ = params["text_m"], params["speech_m"]
    tts_ws, asr_ws = [], []
    t_mem, ts = text_encode(ctx, tp, state["text_m"], text, text_len, c)
    pre, post, stop, ss = speech_decode(ctx, sp_, state["speech_m"], mel,
                                        mel_len, t_mem, text_len, c, tts_ws)
    s_mem = speech_encode(ctx, sp_, mel_aug, mel_len, c)
    logits = text_decode(ctx, tp, text, text_len, s_mem, mel_len, c, asr_ws)
    tts = speech_loss(mel, mel_len, pre, post, stop, c["s_eos_weight"])
    asr = text_loss(text, logits, c["t_eos_weight"])
    ga = c["ga_weight"] * (guided_attention(tts_ws, mel_len, text_len, c["ga_sigma"])
                           + guided_attention(asr_ws, text_len, mel_len,
                                              c["ga_sigma"]))
    new_state = {"text_m": ts, "speech_m": ss}
    return tts + asr + ga, {"tts": tts, "asr": asr, "ga_sp": ga}, new_state


# ---------------------------------------------------------------------------
# The step: gradients summed over the micro-batches, clip, AdamW
# ---------------------------------------------------------------------------

def learning_rate(c, count):
    """The schedule's lr at the optimizer's step count before the update."""
    lr = c["lr"]
    if c["sched_type"] == "multistep":
        ms = [m * c["epoch_steps"] for m in c["lr_milestones"]]
        return lr * c["lr_gamma"] ** sum(count >= m for m in ms)
    if c["sched_type"] == "transformer":
        w = c["warmup_steps"]
        if count < w:
            return lr * count / max(1.0, float(w) ** 1.5)
        return lr / math.sqrt(max(1.0, count))
    raise ValueError(f"no reference schedule {c['sched_type']!r}")


class RefState(NamedTuple):
    params: dict
    state: dict
    mu: dict
    nu: dict
    count: int


def init_state(params, state):
    z = lambda t: tree_map(torch.zeros_like, t)
    return RefState(params, state, z(params), z(params), 0)


def ref_step(rs: RefState, gen, micro_batches, c, prec="f32"):
    """One warm-up step: micro_batches is a list of (text, mel, text_len,
    mel_len); each loss is scaled by 1 / len(micro_batches). Returns (new
    RefState, {loss name: mean over the micro-batches}, {leaf path: the
    gradient the optimizer took, before its clip})."""
    names = [p for p, _ in leaves(rs.params)]
    live = tree_map(lambda x: x.detach().requires_grad_(True), rs.params)
    flat = [x for _, x in leaves(live)]
    grads = [torch.zeros_like(x) for x in flat]
    scale = 1.0 / len(micro_batches)
    st = rs.state
    sums = {}
    for mb in micro_batches:
        loss, aux, st = sp_loss(live, st, gen, mb, c, prec)
        for acc, g in zip(grads, torch.autograd.grad(loss * scale, flat,
                                                     allow_unused=True)):
            if g is not None:
                acc += g
        for k, v in aux.items():
            sums[k] = sums.get(k, 0.0) + float(v.detach()) / len(micro_batches)
        del loss, aux
    taken = dict(zip(names, grads))
    with torch.no_grad():
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if not bool(norm < c["grad_clip"]):
            grads = [g / norm * c["grad_clip"] for g in grads]
        count = rs.count + 1
        mu = [ADAM_B1 * m + (1 - ADAM_B1) * g
              for m, g in zip((x for _, x in leaves(rs.mu)), grads)]
        nu = [ADAM_B2 * v + (1 - ADAM_B2) * g * g
              for v, g in zip((x for _, x in leaves(rs.nu)), grads)]
        c1, c2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
        step = -learning_rate(c, count - 1)
        new_p = []
        for p, m, v in zip((x for _, x in leaves(rs.params)), mu, nu):
            u = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS) + c["weight_decay"] * p
            new_p.append(p + u * step)
    unflat = lambda xs: _unflatten(rs.params, xs)
    return (RefState(unflat(new_p), st, unflat(mu), unflat(nu), count), sums,
            taken)


def _unflatten(tree, xs):
    it = iter(xs)
    return tree_map(lambda _: next(it), tree)
