"""The port's flash attention (unast_tpu_torch/ops/attention.py) against the
JAX package's: the plain PyTorch version against the Pallas kernel (in
interpret mode on the CPU, as tests/test_ops.py runs it) and against the
plain attention_core, with ragged kv_lens, causal or not, Tq != Tk. Inputs
are made with numpy from a seed. Tolerances: float32 at 2e-5 (that of
tests/test_ops.py); bfloat16 at 2e-2, about two bf16 ulps of outputs of
order 1, since each side rounds its float32 result once.

The kernels themselves run only on a CUDA card; their tests are marked
`gpu` and skip on a host without one. Among them, the gradients through
flash_attention's autograd.Function (kernel forward, plain backward)
against autograd through the plain version; the backward's own parity
with the JAX package is in tests/test_torch_train.py. The layouts the bf16 kernel reads
through TMA (strided views of a fused QKV or KV projection) are pinned on
the CPU through the plain version, and the wrapper's refusal of layouts
TMA cannot take through its check. The float32 kernel's split-TF32
arithmetic is emulated in numpy and held against the JAX kernel.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from unast_tpu import nn as jnn
from unast_tpu.models.transformer import attention_core, causal_bias, padding_bias
from unast_tpu.ops import flash_attention as jax_flash

from unast_tpu_torch.ops import attention
from unast_tpu_torch.ops.attention import flash_attention, flash_attention_plain


@pytest.fixture
def float32_products():
    """Float32 products in the plain version on the card (no TF32), for
    the test only."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _inputs(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, h, d)).astype(np.float32)
    kv_lens = np.array([tk, max(1, tk - 9)][:b], np.int32)
    return q, k, v, kv_lens


def _attention_core(q, k, v, kv_lens, causal):
    pad = jnp.arange(k.shape[1])[None, :] >= jnp.asarray(kv_lens)[:, None]
    bias = padding_bias(pad)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        if tq == tk:
            bias = bias + causal_bias(tq)
        else:  # the kernels' top-left aligned mask: key j <= query i
            keep = jnp.arange(tk)[None, :] <= jnp.arange(tq)[:, None]
            bias = bias + jnp.where(keep, 0.0, -1e9)[None, None]
    return attention_core(q, k, v, bias, jnn.Ctx.eval(), 0.0)


CASES = [  # (causal, tq, tk, d)
    (False, 40, 56, 64),
    (True, 40, 40, 64),
    (False, 24, 33, 32),
    (True, 17, 30, 16),
]


@functools.lru_cache(maxsize=None)
def _jax_flash_f32(causal, tq, tk, d):
    """The JAX kernel (interpret mode) on _inputs(0, 2, tq, tk, 2, d); kept,
    since each call runs the interpreter anew."""
    q, k, v, kv_lens = _inputs(0, 2, tq, tk, 2, d)
    return np.asarray(jax_flash(q, k, v, jnp.asarray(kv_lens), causal=causal))


@pytest.mark.parametrize("causal,tq,tk,d", CASES)
def test_plain_matches_jax_f32(causal, tq, tk, d):
    q, k, v, kv_lens = _inputs(0, 2, tq, tk, 2, d)
    out = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(kv_lens), causal=causal)
    out = out.numpy()
    ref_kernel = _jax_flash_f32(causal, tq, tk, d)
    np.testing.assert_allclose(out, ref_kernel, atol=2e-5, rtol=2e-5)
    ref_core = np.asarray(_attention_core(q, k, v, kv_lens, causal))
    np.testing.assert_allclose(out, ref_core, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_bf16(causal):
    q, k, v, kv_lens = _inputs(1, 2, 32, 32, 2, 64)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(qb, kb, vb, jnp.asarray(kv_lens), causal=causal)
                     .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (qb, kb, vb))
    out = flash_attention_plain(tq, tk, tv, torch.from_numpy(kv_lens),
                                causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits, to
    nearest, ties away from zero; the low 13 bits zero."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, parts):
    """a @ b on the TF32 tensor cores: parts 1 is one TF32 product; parts 3
    splits each operand, x = hi + lo, and sums lo*hi + hi*lo + hi*hi in
    float32, small terms first, as csrc/flash_attn_fwd_f32.cu does."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if parts == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated_f32_kernel(q, k, v, kv_lens, parts):
    """The float32 kernel's arithmetic in numpy: unscaled TF32 scores,
    -1e9 * sqrt(D) on masked keys, p = 2^(s c - m c) with
    c = log2(e) / sqrt(D), P V in TF32, o = acc / l."""
    d = q.shape[-1]
    c = np.float32(np.log2(np.e) / np.sqrt(d))
    qh, kh, vh = (np.swapaxes(x, 1, 2) for x in (q, k, v))   # [B, H, T, D]
    s = _tf32_matmul(qh, np.swapaxes(kh, -1, -2), parts)
    keep = np.arange(k.shape[1])[None, :] < kv_lens[:, None]
    s = np.where(keep[:, None, None, :], s, np.float32(-1e9 * np.sqrt(d)))
    m = s.max(-1, keepdims=True)
    p = np.exp2(s * c - m * c).astype(np.float32)
    o = _tf32_matmul(p, vh, parts) / p.sum(-1, keepdims=True)
    return np.swapaxes(o, 1, 2)


def test_split_tf32_arithmetic_matches_jax_f32():
    """Three TF32 products of split operands hold the float32 kernel's
    2e-5 against the JAX kernel; one TF32 product does not, which is why
    the float32 kernel splits."""
    causal, tq, tk, d = CASES[0]
    q, k, v, kv_lens = _inputs(0, 2, tq, tk, 2, d)
    ref = _jax_flash_f32(causal, tq, tk, d)
    np.testing.assert_allclose(_emulated_f32_kernel(q, k, v, kv_lens, 3), ref,
                               atol=2e-5, rtol=2e-5)
    one = _emulated_f32_kernel(q, k, v, kv_lens, 1)
    assert not np.allclose(one, ref, atol=2e-5, rtol=2e-5)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    q, k, v, kv_lens = (torch.from_numpy(a) for a in _inputs(2, 2, 20, 20, 2, 32))
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_lens)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_plain(q, k, v, kv_lens))


@pytest.mark.gpu
@pytest.mark.usefixtures("float32_products")
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,tq,tk,d", CASES + [(False, 300, 300, 64),
                                                    (False, 815, 815, 64)])
def test_kernel_matches_plain_on_gpu(dtype, tol, causal, tq, tk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, kv_lens = (torch.from_numpy(a).cuda()
                        for a in _inputs(3, 2, tq, tk, 4, d))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_lens, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, kv_lens, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _views(layout, x, tq, tk, h, d):
    """q, k, v as the port's mha gives them: 'qkv' splits one fused
    [B, T, 3*H*D] projection, 'cross' takes q on its own and splits k, v
    from one fused [B, Tk, 2*H*D] projection (x = (q, kv) then)."""
    def heads(y):
        return [t.unflatten(-1, (h, d)) for t in torch.split(y, h * d, dim=-1)]
    if layout == "qkv":
        return heads(x)
    q, kv = x
    return [q] + heads(kv)


def _view_inputs(layout, seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    if layout == "qkv":
        x = torch.from_numpy(rng.normal(size=(b, tq, 3 * h * d)).astype(np.float32))
    else:
        x = (torch.from_numpy(rng.normal(size=(b, tq, h, d)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(b, tk, 2 * h * d)).astype(np.float32)))
    lens = np.array([tk, max(1, tk - 9)][:b], np.int32)
    return _views(layout, x, tq, tk, h, d), lens


@pytest.mark.parametrize("layout", ["qkv", "cross"])
def test_plain_on_fused_views_matches_jax(layout):
    """The strided views the encoders (and later the decoders' cross
    attention) hand to the kernel give JAX's answer on contiguous copies."""
    (q, k, v), lens = _view_inputs(layout, 4, 2, 24, 24, 2, 16)
    assert not k.is_contiguous() and not v.is_contiguous()
    out = flash_attention_plain(q, k, v, torch.from_numpy(lens))
    ref = np.asarray(jax_flash(*(np.ascontiguousarray(x.numpy()) for x in (q, k, v)),
                               jnp.asarray(lens)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def _misaligned(kind, device="cpu"):
    """bf16 [2, 8, 2, 16] layouts the TMA unit cannot take (views, made on
    `device`: a copy to another device would be dense)."""
    base = torch.zeros((2, 8, 2 * 16 + 4), dtype=torch.bfloat16, device=device)
    if kind == "t_stride":   # T stride of 36 elements = 72 bytes
        return base[..., :32].unflatten(-1, (2, 16))
    if kind == "base":       # starts 8 bytes into the allocation
        return base[..., 4:36].unflatten(-1, (2, 16))
    wide = torch.zeros((2, 8, 2, 20), dtype=torch.bfloat16, device=device)
    return wide[..., :16]    # "h_stride": 20 elements = 40 bytes


@pytest.mark.parametrize("kind", ["t_stride", "base", "h_stride"])
def test_check_refuses_bf16_layouts_tma_cannot_take(kind):
    bad = _misaligned(kind)
    good = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16)
    attention._check(good, good, good, None)
    with pytest.raises(ValueError, match="TMA"):
        attention._check(bad, good, good, None)
    with pytest.raises(ValueError, match="TMA"):
        attention._check(good, good, bad, None)
    # the float32 route reads the caller's tensors with plain loads (its
    # pre-pass and the kernel's Q loads) and takes any layout: here a base
    # 4 bytes in and a T stride of 132 bytes
    odd = torch.zeros((2, 8, 2 * 16 + 1))[..., 1:].unflatten(-1, (2, 16))
    attention._check(odd, odd, odd, None)
    attention._check(bad.float(), good.float(), good.float(), None)


def test_strides_of_size_one_dims_are_dense():
    """A dim of size 1 may carry any stride; the kernel gets a dense one,
    which TMA takes."""
    x = torch.zeros((1, 8, 3 * 16), dtype=torch.bfloat16)[..., :16]
    x = x.unflatten(-1, (1, 16)).as_strided((1, 8, 1, 16), (7, 48, 3, 1))
    assert attention._strides(x) == (8 * 48, 48, 16)
    attention._check(x, x, x, None)


GPU_VIEW_CASES = [  # (layout, causal, tq, tk, h, d, lens)
    ("qkv", False, 300, 300, 4, 64, None),
    ("qkv", True, 815, 815, 4, 64, None),
    ("qkv", False, 130, 130, 4, 64, [1, 1]),
    ("cross", False, 300, 815, 4, 64, None),
    ("cross", True, 815, 300, 4, 64, [300, 65]),
    ("qkv", False, 200, 200, 16, 16, None),
    ("qkv", False, 200, 200, 8, 32, None),
    ("qkv", False, 200, 200, 2, 128, None),
    ("cross", True, 100, 257, 2, 128, [257, 1]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("layout,causal,tq,tk,h,d,lens", GPU_VIEW_CASES)
def test_wgmma_kernel_on_fused_views_matches_plain_on_gpu(layout, causal, tq,
                                                          tk, h, d, lens):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (q, k, v), kv_lens = _view_inputs(layout, 5, 2, tq, tk, h, d)
    if lens is not None:
        kv_lens = np.array(lens, np.int32)
    q, k, v = (x.cuda().to(torch.bfloat16) for x in (q, k, v))
    kv_lens = torch.from_numpy(kv_lens).cuda()
    before = (flash_attention.launches, flash_attention.launches_bf16)
    out = flash_attention(q, k, v, kv_lens, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    ref = flash_attention_plain(q, k, v, kv_lens, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,causal,tq,tk,h,d,lens", GPU_VIEW_CASES)
def test_wgmma_kernel_within_one_bf16_rounding_on_gpu(layout, causal, tq, tk,
                                                      h, d, lens):
    """P keeps float32 precision in P.V (split into two bf16 parts), as in
    the TPU kernel, so the kernel and the plain version differ by at most
    one bf16 rounding of the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (q, k, v), kv_lens = _view_inputs(layout, 6, 2, tq, tk, h, d)
    if lens is not None:
        kv_lens = np.array(lens, np.int32)
    q, k, v = (x.cuda().to(torch.bfloat16) for x in (q, k, v))
    kv_lens = torch.from_numpy(kv_lens).cuda()
    out = flash_attention(q, k, v, kv_lens, causal=causal).float()
    ref = flash_attention_plain(q, k, v, kv_lens, causal=causal).float()
    bound = 2.0 ** -7 * ref.abs() + 1e-5
    assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())


@pytest.mark.gpu
@pytest.mark.usefixtures("float32_products")
@pytest.mark.parametrize("layout,causal,tq,tk,h,d,lens", GPU_VIEW_CASES + [
    ("qkv", False, 24, 24, 2, 16, [20, 11]),    # the TINY serve's encoders
    ("qkv", False, 8, 8, 2, 16, [7, 3])])
def test_f32_kernel_on_fused_views_matches_plain_on_gpu(layout, causal, tq,
                                                        tk, h, d, lens):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (q, k, v), kv_lens = _view_inputs(layout, 7, 2, tq, tk, h, d)
    if lens is not None:
        kv_lens = np.array(lens, np.int32)
    q, k, v = (x.cuda() for x in (q, k, v))
    kv_lens = torch.from_numpy(kv_lens).cuda()
    before = (flash_attention.launches, flash_attention.launches_f32)
    out = flash_attention(q, k, v, kv_lens, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_f32) == (
        before[0] + 1, before[1] + 1)
    ref = flash_attention_plain(q, k, v, kv_lens, causal=causal)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.usefixtures("float32_products")
def test_f32_kernel_takes_any_strides_on_gpu():
    """The float32 route reads the caller's tensors with plain loads: views
    of one fused projection whose base is 4 bytes in and whose T stride is
    388 bytes, which TMA would refuse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 40, 3 * 32 + 1)).astype(np.float32))
    q, k, v = (t.unflatten(-1, (2, 16))
               for t in torch.split(x.cuda()[..., 1:], 32, dim=-1))
    kv_lens = torch.tensor([40, 7], dtype=torch.int32, device="cuda")
    out = flash_attention(q, k, v, kv_lens, causal=True)
    ref = flash_attention_plain(q, k, v, kv_lens, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.usefixtures("float32_products")
@pytest.mark.parametrize("tq,tk,h,d", [(300, 300, 4, 64), (100, 257, 2, 128),
                                       (40, 70, 2, 16)])
def test_f32_kernel_key_order_with_one_hot_v_on_gpu(tq, tk, h, d):
    """v of key j is e_(j mod D): each output column sums the weights of its
    own keys, so a key order on which P and V^T disagree moves weight
    between columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, _, kv_lens = (torch.from_numpy(a).cuda()
                        for a in _inputs(8, 2, tq, tk, h, d))
    v = torch.nn.functional.one_hot(torch.arange(tk, device="cuda") % d, d)
    v = v.float()[None, :, None, :].expand(2, tk, h, d)
    out = flash_attention(q, k, v, kv_lens)
    ref = flash_attention_plain(q, k, v, kv_lens)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["t_stride", "base", "h_stride"])
def test_wgmma_kernel_refuses_misaligned_views_on_gpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bad = _misaligned(kind, "cuda")
    good = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16, device="cuda")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(bad, good, good)
    assert flash_attention.launches == before


GPU_GRAD_CASES = [  # (layout, causal, tq, tk, h, d, lens): the train step's
    ("qkv", True, 304, 304, 4, 64, None),      # decoder self-attention
    ("qkv", False, 816, 816, 4, 64, [816, 300]),   # encoder
    ("cross", False, 304, 816, 4, 64, None),   # cm cross-attention
    ("cross", False, 816, 304, 4, 64, [304, 100]),
    ("qkv", True, 24, 24, 2, 16, [20, 11]),    # TINY
]


def _grads_through(attn, layout, x, lens, causal, h, d, w):
    """Gradients of sum(attn(q, k, v) * w) with respect to the fused
    projection(s) x the views q, k, v are cut from."""
    xs = [t.detach().clone().requires_grad_(True) for t in x]
    q, k, v = _views(layout, xs[0] if layout == "qkv" else tuple(xs), None, None,
                     h, d)
    out = attn(q, k, v, lens, causal=causal)
    return torch.autograd.grad((out.float() * w).sum(), xs)


def _check_kernel_gradients(device, dtype, layout, causal, tq, tk, h, d, lens):
    rng = np.random.default_rng(10)
    shapes = ([(2, tq, 3 * h * d)] if layout == "qkv" else
              [(2, tq, h, d), (2, tk, 2 * h * d)])
    x = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
         for s in shapes]
    kv_lens = torch.tensor(lens or [tk, max(1, tk - 9)], dtype=torch.int32,
                           device=device)
    w = torch.from_numpy(rng.normal(size=(2, tq, h, d)).astype(np.float32)).to(device)
    before = (flash_attention.launches, flash_attention.backward_calls)
    got = _grads_through(flash_attention, layout, x, kv_lens, causal, h, d, w)
    if device == "cuda":
        torch.cuda.synchronize()
        assert flash_attention.launches == before[0] + 1
    assert flash_attention.backward_calls == before[1] + 1
    want = _grads_through(flash_attention_plain, layout, x, kv_lens, causal, h, d, w)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for a, r in zip(got, want):
        err = float((a.float() - r.float()).abs().max())
        assert err <= rel * float(r.float().abs().max()), err


@pytest.mark.gpu
@pytest.mark.usefixtures("float32_products")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,causal,tq,tk,h,d,lens", GPU_GRAD_CASES)
def test_gradients_through_kernel_match_plain_autograd_on_gpu(dtype, layout, causal,
                                                              tq, tk, h, d, lens):
    """flash_attention's autograd.Function (the kernel forward, the plain
    recompute backward) against autograd through flash_attention_plain,
    on the card. float32 within 1e-4 of the gradient's largest element;
    bfloat16 within 2**-6 of it: the backward reads the forward output o
    (delta = rowsum(dO o)), which the kernel gives within one bf16
    rounding, 2**-8, of the plain o, and each gradient is rounded once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_kernel_gradients("cuda", dtype, layout, causal, tq, tk, h, d, lens)
