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
    tests/goldens/torch_train_step.npz (tests/torch_train_golden.py); that
    of the flash backward, the losses, the RNN encoder and discriminator,
    the decoders, the tasks and SpecAugment's draws from
    tests/goldens/torch_train_parts.npz (tests/torch_train_parts_golden.py);
    that of the schedules and the optimizer updates from
    tests/goldens/torch_ops.npz (tests/torch_ops_golden.py).
Randomness cannot match JAX's bits; the draws are held to their
distributions (dropout, noise_fn, SpecAugment).
"""

import contextlib
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.bridge import params_from_jax
from unast_tpu_torch.models import TINY, modules as TM, networks as TN
from unast_tpu_torch.models import rnn as TR, unast as TU
from unast_tpu_torch.ops.attention import (flash_attention,
                                           flash_attention_bwd_plain,
                                           flash_attention_fwd_plain,
                                           flash_attention_plain)
from unast_tpu_torch.train import losses as TL, optim as TO, steps as TS
from unast_tpu_torch.train.augment import specaugment
from unast_tpu_torch.train.config import train_args

import chip_smoke as CS
import torch_ops_golden as OG
import torch_serve_golden as SG
import torch_train_golden as G
import torch_train_parts_golden as PG

ECTX_T = tnn.Ctx.eval()


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


@pytest.fixture(scope="module")
def parts(models):
    """The JAX side of the parts' tests, from tests/goldens/torch_train_parts.npz."""
    z = np.load(PG.GOLDEN)
    stale = ("tests/goldens/torch_train_parts.npz is stale: {} changed; run "
             "`JAX_PLATFORMS=cpu python tests/torch_train_parts_golden.py`")
    assert str(z["source_hash"]) == PG.source_hash(), stale.format(
        "the JAX package, a golden module or a library version")
    assert str(z["init_hash"]) == G.init_hash(models[2]), stale.format("the port's init")
    return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# The flash-attention backward
# ---------------------------------------------------------------------------


_attn_case = PG.attn_case


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


@pytest.mark.parametrize("layout,causal,tq,tk,h,d", PG.FLASH_F32)
def test_flash_backward_matches_jax_f32(parts, layout, causal, tq, tk, h, d):
    fused, lens, w = _attn_case(layout, 0, 2, tq, tk, h, d)
    mine = _port_grads(layout, fused, lens, w, causal, h, d, torch.float32)
    for name, a in zip("qkv", mine):
        _close(a, parts[f"flash_f32/{layout}/d{name}"], 1e-4, f"d{name}")


def test_flash_backward_matches_jax_bf16(parts):
    layout, causal, tq, tk, h, d = PG.FLASH_BF16
    fused, lens, w = PG.bf16_case()
    mine = _port_grads(layout, fused, lens, w, causal, h, d, torch.bfloat16)
    for name, a in zip("qkv", mine):
        a, r = _np(a), parts[f"flash_bf16/d{name}"]
        bound = 2.0 ** -8 * np.abs(r) + 1e-3 * np.abs(r).max()
        assert (np.abs(a - r) <= bound).all(), (name, float(np.abs(a - r).max()))


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulated_bf16_backward(q, k, v, kv_lens, causal, o, do, q_start=0, split=True):
    """The bf16 backward kernel's arithmetic (csrc/flash_attn_bwd_wgmma.cu)
    in float32 on bf16 values ([B, T, H, D] in and out): its three passes
    in its tile order (64-row query and key tiles; dK/dV query tiles of 32
    at D 128, from the first that sees the key tile when causal; the
    pre-pass and dQ over the keys their block sees), float32 sums of the
    exact products of bf16 operands, the unscaled scores masked to
    -1e9 sqrt(D), the pre-pass's online max and sum in base 2 giving lse2,
    P = 2^(S c - lse2), and P and dS split into bf16 high and low parts
    for dV, dK and dQ (split=False: rounded to bf16 once)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    c = math.log2(math.e) / math.sqrt(d)
    masked = torch.tensor(-1e9 * math.sqrt(d))
    qh, kh, vh, oh, doh = (x.transpose(1, 2) for x in (q, k, v, o, do))
    lens = kv_lens.view(b, 1, 1, 1)

    def keep(query, key):
        return (key < lens) & ((key <= query + q_start) if causal else True)

    def parts(x):
        hi = _bf(x)
        return (hi, _bf(x - hi)) if split else (hi, torch.zeros_like(x))

    def seen(q0):   # keys a 64-row query block sees
        return min(tk, q_start + min(tq, q0 + 64)) if causal else tk

    def idx(a, n, lim):
        return torch.arange(a, min(a + n, lim))
    delta = (doh * oh).sum(-1)
    lse2 = torch.empty(b, h, tq)
    for q0 in range(0, tq, 64):            # 1. the pre-pass
        rows = idx(q0, 64, tq).view(-1, 1)
        m = torch.full((b, h, len(rows), 1), -math.inf)
        l = torch.zeros_like(m)
        for k0 in range(0, seen(q0), 64):
            s = qh[:, :, q0:q0 + 64] @ kh[:, :, k0:k0 + 64].transpose(-1, -2)
            s = torch.where(keep(rows, idx(k0, 64, tk)), s, masked)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp2((m - m_new) * c) + torch.exp2(s * c - m_new * c).sum(-1, keepdim=True)
            m = m_new
        lse2[:, :, q0:q0 + 64] = (m * c + torch.log2(l))[..., 0]
    bq = 32 if d == 128 else 64
    dk, dv = torch.zeros(b, h, tk, d), torch.zeros(b, h, tk, d)
    for k0 in range(0, tk, 64):            # 2. dK and dV
        keys = idx(k0, 64, tk).view(-1, 1)
        for qb in range((max(0, k0 - q_start) // bq if causal else 0) * bq, tq, bq):
            qt, dot = qh[:, :, qb:qb + bq], doh[:, :, qb:qb + bq]
            st = torch.where(keep(idx(qb, bq, tq), keys),
                             kh[:, :, k0:k0 + 64] @ qt.transpose(-1, -2), masked)
            pt = torch.exp2(st * c - lse2[:, :, None, qb:qb + bq])
            dst = pt * (vh[:, :, k0:k0 + 64] @ dot.transpose(-1, -2)
                        - delta[:, :, None, qb:qb + bq])
            (ph, pl), (dh, dl) = parts(pt), parts(dst)
            dv[:, :, k0:k0 + 64] += pl @ dot + ph @ dot
            dk[:, :, k0:k0 + 64] += dl @ qt + dh @ qt
    dq = torch.zeros(b, h, tq, d)
    for q0 in range(0, tq, 64):            # 3. dQ
        rows = idx(q0, 64, tq).view(-1, 1)
        for k0 in range(0, seen(q0), 64):
            kt, vt = kh[:, :, k0:k0 + 64], vh[:, :, k0:k0 + 64]
            s = torch.where(keep(rows, idx(k0, 64, tk)),
                            qh[:, :, q0:q0 + 64] @ kt.transpose(-1, -2), masked)
            p = torch.exp2(s * c - lse2[:, :, q0:q0 + 64, None])
            dh, dl = parts(p * (doh[:, :, q0:q0 + 64] @ vt.transpose(-1, -2)
                                - delta[:, :, q0:q0 + 64, None]))
            dq[:, :, q0:q0 + 64] += dl @ kt + dh @ kt
    return tuple(_bf(x.transpose(1, 2)) for x in (dq / math.sqrt(d), dk / math.sqrt(d), dv))


def _f64_over_bound(q, k, v, lens, causal, o, do, q_start, grads,
                    dtype=torch.bfloat16):
    """Each gradient's worst element against float64 on chip_smoke.py's
    phase-6 scale for the dtype's gradients (CS.f64_over_bound): bf16
    2**-8 |ref| + 2**-16 A, float32 2**-23 |ref| + 2**-17 A."""
    exact, terms = CS.backward_f64(q, k, v, lens, causal, o, do, q_start)
    return [CS.f64_over_bound(g, r, a, dtype) for g, r, a in zip(grads, exact, terms)]


def test_emulated_bf16_backward_kernel_matches_jax(parts):
    """The backward kernel's arithmetic, emulated, gives JAX's bf16
    gradients within test_flash_backward_matches_jax_bf16's bound, and the
    float64 function within phase 6's; with P and dS rounded to bf16 once
    it misses the latter, which is why the kernel splits them."""
    layout, causal, tq, tk, h, d = PG.FLASH_BF16
    fused, lens, w = PG.bf16_case()
    q, k, v = (_bf(x) for x in _views(layout, [torch.from_numpy(fused[0])], h, d))
    lens = torch.from_numpy(lens)
    o = _bf(flash_attention_plain(*(x.to(torch.bfloat16) for x in (q, k, v)), lens, causal))
    do = _bf(torch.from_numpy(w))
    mine = _emulated_bf16_backward(q, k, v, lens, causal, o, do)
    for name, a in zip("qkv", mine):
        r = parts[f"flash_bf16/d{name}"]
        a = a.flatten(-2).numpy()
        bound = 2.0 ** -8 * np.abs(r) + 1e-3 * np.abs(r).max()
        assert (np.abs(a - r) <= bound).all(), (name, float(np.abs(a - r).max()))
    assert max(_f64_over_bound(q, k, v, lens, causal, o, do, 0, mine)) <= 1
    rounded = _emulated_bf16_backward(q, k, v, lens, causal, o, do, split=False)
    assert max(_f64_over_bound(q, k, v, lens, causal, o, do, 0, rounded)) > 1


@pytest.mark.parametrize("b,tq,tk,h,d,causal,q_start,lens", [
    (2, 150, 150, 2, 32, True, 0, [150, 50]),       # three tiles, ragged
    (2, 100, 300, 2, 128, True, 50, [300, 120]),    # D 128, an sp rank's offset
    (2, 130, 130, 2, 64, False, 0, [1, 65]),        # kv_len 1, off the tile
    (2, 40, 120, 2, 16, True, 80, [120, 100]),      # Tq < the tile
])
def test_emulated_bf16_backward_kernel_within_f64_bound(b, tq, tk, h, d, causal,
                                                        q_start, lens):
    """Over several tiles, causal offsets and ragged kv_lens the emulated
    kernel holds phase 6's float64 bound, as the plain backward does, and
    keys past kv_len get exact zeros; P and dS rounded to bf16 miss it."""
    g = torch.Generator().manual_seed(tq + tk + d)
    q, k, v, do = (_bf(torch.randn(b, t, h, d, generator=g)) for t in (tq, tk, tk, tq))
    lens = torch.tensor(lens, dtype=torch.int32)
    o = _bf(flash_attention_plain(q, k, v, lens, causal, q_start))
    mine = _emulated_bf16_backward(q, k, v, lens, causal, o, do, q_start)
    assert max(_f64_over_bound(q, k, v, lens, causal, o, do, q_start, mine)) <= 1
    plain = flash_attention_bwd_plain(*(x.to(torch.bfloat16) for x in (q, k, v)), lens,
                                      causal, o.to(torch.bfloat16), do.to(torch.bfloat16),
                                      q_start)
    assert max(_f64_over_bound(q, k, v, lens, causal, o, do, q_start, plain)) <= 1
    for i, n in enumerate(lens.tolist()):
        assert not mine[1][i, n:].any() and not mine[2][i, n:].any()
    rounded = _emulated_bf16_backward(q, k, v, lens, causal, o, do, q_start, split=False)
    assert max(_f64_over_bound(q, k, v, lens, causal, o, do, q_start, rounded)) > 1


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits, to
    nearest, ties away from zero; the low 13 bits zero."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return torch.from_numpy(((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000))
                            .view(np.float32))


def _tf32_mm(a, b, split):
    """a @ b as the float32 backward kernel forms a product on the tensor
    cores: each operand split, x = hi + lo with hi = tf32(x) and
    lo = tf32(x - hi), and lo*hi + hi*lo + hi*hi summed in float32, small
    terms first (split=False: one TF32 product, hi*hi)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not split:
        return a_hi @ b_hi
    return _tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi) + a_hi @ b_hi


def _emulated_f32_backward(q, k, v, kv_lens, causal, o, lse, do, q_start=0,
                           split=True):
    """The float32 backward kernel's arithmetic (csrc/flash_attn_bwd_f32.cu)
    in float32 ([B, T, H, D] in and out): the forward's lse in base 2
    (lse2 = lse log2(e)), delta = rowsum(dO o), P = 2^(S c - lse2) on
    the unscaled scores and 0 at masked keys (what the -1e9 score gives),
    and every product as three TF32 products of split operands
    (_tf32_mm), in the kernel's tile order: dK/dV blocks of 64 keys over
    query tiles of 32 (16 at D 128) from the first that sees the block
    when causal, dQ blocks of 64 queries over key tiles of 32 (16 at
    D 128) up to the keys the block sees. In a block one warpgroup forms S
    (and dV), the other dP (and dK); dQ's columns are split between them.
    Each gradient element is summed by one thread over the tiles in
    order, with no partial sums between warpgroups, and a row's sum does
    not depend on the other rows or columns, so the blocks are emulated
    whole. split=False: one TF32 product each."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    tile = 16 if d == 128 else 32
    c = math.log2(math.e) / math.sqrt(d)
    zero = torch.tensor(0.0)
    qh, kh, vh, oh, doh = (x.transpose(1, 2) for x in (q, k, v, o, do))
    lens = kv_lens.view(b, 1, 1, 1)
    lse2 = lse * math.log2(math.e)
    delta = (doh * oh).sum(-1)

    def keep(query, key):
        return (key < lens) & ((key <= query + q_start) if causal else True)

    def idx(a, n, lim):
        return torch.arange(a, min(a + n, lim))

    def mm(a, x):
        return _tf32_mm(a, x, split)
    dk, dv = torch.zeros(b, h, tk, d), torch.zeros(b, h, tk, d)
    for k0 in range(0, tk, 64):            # dK and dV
        keys = idx(k0, 64, tk).view(-1, 1)
        first = (max(0, k0 - q_start) // tile) * tile if causal else 0
        kt, vt = kh[:, :, k0:k0 + 64], vh[:, :, k0:k0 + 64]
        for qb in range(first, tq, tile):
            qt, dot = qh[:, :, qb:qb + tile], doh[:, :, qb:qb + tile]
            pt = torch.where(keep(idx(qb, tile, tq), keys),
                             torch.exp2(mm(kt, qt.transpose(-1, -2)) * c
                                        - lse2[:, :, None, qb:qb + tile]), zero)
            dst = pt * (mm(vt, dot.transpose(-1, -2)) - delta[:, :, None, qb:qb + tile])
            dv[:, :, k0:k0 + 64] += mm(pt, dot)
            dk[:, :, k0:k0 + 64] += mm(dst, qt)
    dq = torch.zeros(b, h, tq, d)
    for q0 in range(0, tq, 64):            # dQ
        rows = idx(q0, 64, tq).view(-1, 1)
        seen = min(tk, q_start + min(tq, q0 + 64)) if causal else tk
        qt, dot = qh[:, :, q0:q0 + 64], doh[:, :, q0:q0 + 64]
        for kb in range(0, seen, tile):
            kt, vt = kh[:, :, kb:kb + tile], vh[:, :, kb:kb + tile]
            p = torch.where(keep(rows, idx(kb, tile, tk)),
                            torch.exp2(mm(qt, kt.transpose(-1, -2)) * c
                                       - lse2[:, :, q0:q0 + 64, None]), zero)
            ds = p * (mm(dot, vt.transpose(-1, -2)) - delta[:, :, q0:q0 + 64, None])
            dq[:, :, q0:q0 + 64] += mm(ds, kt)
    scale = 1 / math.sqrt(d)
    return tuple(x.transpose(1, 2) for x in (dq * scale, dk * scale, dv))


@pytest.mark.parametrize("layout,causal,tq,tk,h,d", PG.FLASH_F32)
def test_emulated_f32_backward_kernel_matches_jax(parts, layout, causal, tq, tk, h, d):
    """The float32 backward kernel's arithmetic, emulated, gives JAX's
    float32 gradients within test_flash_backward_matches_jax_f32's 1e-4,
    and the float64 function within phase 6's float32 bound (2**-23 |ref|
    + 2**-17 A, chip_smoke.F64_BOUND); with one TF32 product (no split)
    it misses the latter, which is why the kernel splits."""
    fused, lens, w = _attn_case(layout, 0, 2, tq, tk, h, d)
    q, k, v = _views(layout, [torch.from_numpy(a) for a in fused], h, d)
    lens, do = torch.from_numpy(lens), torch.from_numpy(w)
    o, lse = flash_attention_fwd_plain(q, k, v, lens, causal)
    mine = _emulated_f32_backward(q, k, v, lens, causal, o, lse, do)
    for name, a in zip("qkv", mine):
        _close(a.flatten(-2), parts[f"flash_f32/{layout}/d{name}"], 1e-4, f"d{name}")
    bound = _f64_over_bound(q, k, v, lens, causal, o, do, 0, mine, torch.float32)
    assert max(bound) <= 1, bound
    one = _emulated_f32_backward(q, k, v, lens, causal, o, lse, do, split=False)
    assert max(_f64_over_bound(q, k, v, lens, causal, o, do, 0, one, torch.float32)) > 1


@pytest.mark.parametrize("b,tq,tk,h,d,causal,q_start,lens", [
    (2, 150, 150, 1, 32, True, 0, [150, 50]),       # several tiles, ragged
    (1, 70, 140, 1, 128, True, 70, [140]),          # D 128, an sp rank's offset
    (2, 100, 100, 1, 16, False, 0, [1, 65]),        # kv_len 1, off the tile
])
def test_emulated_f32_backward_kernel_within_f64_bound(b, tq, tk, h, d, causal,
                                                       q_start, lens):
    """Over several tiles and blocks, a causal offset and ragged
    kv_lens, the emulated float32 kernel holds phase 6's
    float32 bound, as the plain backward does, and keys past kv_len get
    exact zeros; one TF32 product misses it."""
    g = torch.Generator().manual_seed(tq + tk + d)
    q, k, v, do = (torch.randn(b, t, h, d, generator=g) for t in (tq, tk, tk, tq))
    lens = torch.tensor(lens, dtype=torch.int32)
    o, lse = flash_attention_fwd_plain(q, k, v, lens, causal, q_start)
    mine = _emulated_f32_backward(q, k, v, lens, causal, o, lse, do, q_start)
    args = (q, k, v, lens, causal, o, do, q_start)
    assert max(_f64_over_bound(*args, mine, torch.float32)) <= 1
    plain = flash_attention_bwd_plain(q, k, v, lens, causal, o, do, q_start)
    assert max(_f64_over_bound(*args, plain, torch.float32)) <= 1
    for i, n in enumerate(lens.tolist()):
        assert not mine[1][i, n:].any() and not mine[2][i, n:].any()
    one = _emulated_f32_backward(q, k, v, lens, causal, o, lse, do, q_start, split=False)
    assert max(_f64_over_bound(*args, one, torch.float32)) > 1


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


@pytest.mark.parametrize("name", sorted(PG.LOSSES))
def test_loss_matches_jax(parts, name):
    mine = PG.LOSSES[name](TL, PG.loss_inputs(), _t)
    np.testing.assert_allclose(_np(mine), parts[f"loss/{name}"], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The RNN encoder and the LSTM discriminator
# ---------------------------------------------------------------------------


def test_rnn_encoder_and_discriminator_match_jax(models, parts):
    _, _, tp, _ = models
    td = tp["discriminator"]
    x, lens = PG.encoder_inputs()
    out, (h, c) = TR.rnn_encoder(td["rnn"], ECTX_T, _t(x), _t(lens), 0.2)
    _close(out, parts["encoder/out"], 1e-5, "outputs")
    _close(h, parts["encoder/h"], 1e-5, "h")
    _close(c, parts["encoder/c"], 1e-5, "c")
    assert not out[3, 1:].any() and not out[2, 3:].any()   # zero at pads
    _close(TU.lstm_discriminator(td, ECTX_T, _t(x), _t(lens)), parts["discriminator"],
           1e-5, "logits")


# ---------------------------------------------------------------------------
# The teacher-forced decoders
# ---------------------------------------------------------------------------


_dec_inputs = PG.dec_inputs


def _golden_list(parts, prefix):
    n = sum(1 for k in parts if k.startswith(prefix))
    return [parts[f"{prefix}{i}"] for i in range(n)]


@pytest.mark.parametrize("side,impl", PG.DECODERS)
def test_decoder_sequence_matches_jax(models, parts, side, impl):
    _, _, tp, ts = models
    text, tlens, mel, mlens, memory, mem_pad = _dec_inputs()
    tgt, tgt_lens = (text, tlens) if side == "text" else (mel, mlens)
    out, ws = PG.decode(TN, TINY.replace(attn_impl=impl), tp[f"{side}_m"],
                        ts[f"{side}_m"], ECTX_T, side, _t(tgt), _t(tgt_lens),
                        _t(memory), _t(mem_pad))
    ref = _golden_list(parts, f"dec/{side}/{impl}/out/")
    ref_ws = _golden_list(parts, f"dec/{side}/{impl}/ws/")
    assert len(PG.leaves(out)) == len(ref)
    for a, r in zip(PG.leaves(out), ref):
        _close(a, r, 1e-5)
    assert len(ws) == len(ref_ws) == TINY.num_layers
    for a, r in zip(ws, ref_ws):
        _close(a, r, 1e-5, "cross weights")


# ---------------------------------------------------------------------------
# The six task methods in eval mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PG.TASKS)
def test_task_matches_jax_in_eval_mode(models, parts, name):
    _, _, tp, ts = models
    text, tlens, mel, mlens, _, _ = _dec_inputs()
    out, new_state = PG.task(TU, name)(tp, ts, ECTX_T,
                                       TINY.replace(use_discriminator=True),
                                       *(_t(a) for a in (text, tlens, mel, mlens)))
    refs, outs = _golden_list(parts, f"task/{name}/out/"), PG.leaves(out)
    assert len(refs) == len(outs)
    tol = 1e-4 if name.startswith("cm") else 1e-5
    for i, (a, r) in enumerate(zip(outs, refs)):
        _close(a, r, tol, f"output {i}")
    assert sorted(G.flatten(new_state)) == parts[f"task/{name}/state_keys"].tolist()


# ---------------------------------------------------------------------------
# Schedules and the optimizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ops_golden():
    return OG.load()


@pytest.mark.parametrize("sched", ["multistep", "linear", "transformer", "none"])
def test_schedule_matches_jax(ops_golden, sched):
    """make_schedule at OG.SCHEDULE_STEPS against the JAX schedule's values
    (tests/torch_ops_golden.py), 1e-6 relative."""
    mine = TO.make_schedule(train_args(sched_type=sched, **OG.SCHEDULE_KW))
    ref = ops_golden[f"schedule/{sched}"]
    for step, r in zip(OG.SCHEDULE_STEPS, ref):
        np.testing.assert_allclose(mine(step), r, rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("optim_type,clip", [("adamw", 1.0), ("adamw", 100.0),
                                             ("adam", 1.0)])
def test_optimizer_update_matches_optax(ops_golden, optim_type, clip):
    """Two updates (bias correction at counts 1 and 2) of one tree, with
    the global-norm clip triggered (1.0) or not (100.0), against optax's
    (tests/torch_ops_golden.py keeps the params after each), 1e-6."""
    assert (optim_type, clip) in OG.OPT_CASES
    params, grads = OG.opt_case()
    opt = TO.make_optimizer(train_args(optim_type=optim_type, grad_clip=clip,
                                       **OG.OPT_KW))
    tp = TO.tree_map(_t, params)
    tstate = opt.init(tp)
    for step, g in enumerate(grads):
        t_updates, tstate = opt.update(TO.tree_map(_t, g), tstate, tp)
        tp = TO.apply_updates(tp, t_updates)
        for i, a in enumerate(TO.tree_leaves(tp)):
            np.testing.assert_allclose(
                _np(a), ops_golden[f"opt/{optim_type}-{clip}/{step}/params/{i}"],
                rtol=1e-6, atol=1e-7)
    assert tstate.count == 2


# ---------------------------------------------------------------------------
# The bridge's discriminator tree
# ---------------------------------------------------------------------------


def test_bridge_carries_the_discriminator(ops_golden):
    """params_from_jax carries a JAX-initialised discriminator tree name for
    name (its shapes from JAX's lstm_discriminator_init, kept in
    tests/goldens/torch_ops.npz)."""
    shapes = SG.unflatten({k[len("disc_shapes/"):]: np.empty(tuple(v))
                           for k, v in ops_golden.items() if k.startswith("disc_shapes/")})
    rng = np.random.default_rng(4)
    jd = TO.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), shapes)
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


def test_specaugment_statistics_match_jax(parts):
    """Over 4000 rows: the masked frames per row have JAX's mean (within
    four standard errors of the difference), no row has more than two
    spans, masked frames hold the row's mean over the padded [T, M]
    tensor and the others are untouched."""
    mel, lens = PG.spec_inputs()
    n, t = mel.shape[:2]
    out = specaugment(torch.Generator().manual_seed(11), _t(mel), _t(lens), 20, 100)
    ref_masked = np.unpackbits(parts["spec/masked"], axis=-1, count=t).astype(bool)
    out = _np(out)
    masked = (out != mel).any(-1)
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
