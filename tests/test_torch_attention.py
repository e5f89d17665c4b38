"""The port's flash attention (unast_tpu_torch/ops/attention.py) against the
JAX package's: the plain PyTorch version against the Pallas kernel (in
interpret mode on the CPU, as tests/test_ops.py runs it) and against the
plain attention_core, with ragged kv_lens, causal or not, Tq != Tk. Inputs
are made with numpy from a seed. Tolerances: float32 at 2e-5 (that of
tests/test_ops.py); bfloat16 at 2e-2, about two bf16 ulps of outputs of
order 1, since each side rounds its float32 result once.

The kernels themselves run only on a CUDA card; their tests are marked
`gpu` and skip on a host without one. The layouts the bf16 kernel reads
through TMA (strided views of a fused QKV or KV projection) are pinned on
the CPU through the plain version, and the wrapper's refusal of layouts
TMA cannot take through its check.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from unast_tpu import nn as jnn
from unast_tpu.models.transformer import attention_core, causal_bias, padding_bias
from unast_tpu.ops import flash_attention as jax_flash

from unast_tpu_torch.ops import attention
from unast_tpu_torch.ops.attention import flash_attention, flash_attention_plain


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


@pytest.mark.parametrize("causal,tq,tk,d", CASES)
def test_plain_matches_jax_f32(causal, tq, tk, d):
    q, k, v, kv_lens = _inputs(0, 2, tq, tk, 2, d)
    out = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(kv_lens), causal=causal)
    out = out.numpy()
    ref_kernel = np.asarray(jax_flash(q, k, v, jnp.asarray(kv_lens),
                                      causal=causal))
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


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    q, k, v, kv_lens = (torch.from_numpy(a) for a in _inputs(2, 2, 20, 20, 2, 32))
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_lens)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_plain(q, k, v, kv_lens))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,tq,tk,d", CASES + [(False, 300, 300, 64),
                                                    (False, 815, 815, 64)])
def test_kernel_matches_plain_on_gpu(dtype, tol, causal, tq, tk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    # the float32 kernel reads through plain loads and takes the layout
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
