"""Flash attention of the port: two hand-written Hopper kernels behind
`flash_attention`, and their plain PyTorch version `flash_attention_plain`.

Counterpart of unast_tpu/ops/attention.py (the Pallas TPU kernel). Used by
the transformer encoders when ModelConfig.attn_impl == 'flash'. Both
kernels run on the tensor cores with wgmma fed by TMA: bfloat16 inputs go
to csrc/flash_attn_fwd_wgmma.cu, float32 inputs to csrc/flash_attn_fwd_f32.cu,
which splits every operand into two TF32 parts and sums three TF32
products to keep float32 accuracy (after a pre-pass that splits k and v
into a workspace allocated here). Both read the [B, T, H, D] tensors in
place through their strides, so the [B*H, T, D] transposes of the JAX
wrapper are gone, and load kv_lens per batch row themselves. The backward
pass comes with the training slice.
"""

import ctypes
import functools
import math

import torch

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)
# dtype -> the kernel library (and C entry point) that takes it
_LIBRARY = {torch.float32: "flash_attn_fwd_f32",
            torch.bfloat16: "flash_attn_fwd_wgmma"}
_TMA_REFUSED = -1   # the TMA unit refused a layout


def flash_attention_plain(q, k, v, kv_lens=None, causal: bool = False):
    """Plain PyTorch version of the kernel, the same function
    (unast_tpu/ops/attention.py::_flash_fwd): float32 scores of the
    pre-scaled q against k, -1e9 where key j >= kv_lens[b] or (causal)
    j > i, float32 softmax and float32 P.V, cast to q's dtype.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; kv_lens: [B] or None."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf = q.float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    kpos = torch.arange(tk, device=q.device)
    keep = torch.ones((b, 1, 1, tk), dtype=torch.bool, device=q.device)
    if kv_lens is not None:
        keep = kpos[None, None, None, :] < kv_lens.to(q.device)[:, None, None, None]
    if causal:
        qpos = torch.arange(tq, device=q.device)
        keep = keep & (kpos[None, :] <= qpos[:, None])[None, None]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def bind(lib_path, name: str):
    """launch(q, k, v, kv_lens, causal) -> o through the C entry point
    `name` of the kernel library at `lib_path`, on the current stream.
    Where the library exports `<name>_workspace` (floats of scratch for
    B, H, Tk, D), launch allocates that much and passes it after the
    stream. kv_lens: int32 [B] on q's device, or None. launch checks no
    input (flash_attention's _check does) and raises if the launch
    failed."""
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, name)
    workspace = getattr(lib, name + "_workspace", None)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
                   + [ctypes.c_void_p] * (workspace is not None))
    if workspace is not None:
        workspace.restype = ctypes.c_longlong
        workspace.argtypes = [ctypes.c_int] * 4

    def launch(q, k, v, kv_lens, causal):
        b, tq, h, d = q.shape
        tk = k.shape[1]
        o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if kv_lens is None else kv_lens.data_ptr(),
                b, h, tq, tk, d,
                *_strides(q), *_strides(k), *_strides(v), *_strides(o),
                int(causal), 1.0 / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream]
        if workspace is not None:
            ws = torch.empty(workspace(b, h, tk, d), dtype=torch.float32,
                             device=q.device)
            args.append(ws.data_ptr())
        err = fn(*args)
        if err == _TMA_REFUSED:
            what = ("its workspace" if workspace is not None else
                    f"q, k or v (strides {q.stride()}, {k.stride()}, {v.stride()})")
            raise ValueError(f"{name}: the TMA unit refused the layout of {what}")
        if err != 0:
            raise RuntimeError(f"{name} launch failed: error {err}")
        return o
    return launch


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """launch() of this tree's library `name` (bind), built at first use."""
    from .build import library
    return bind(library(name), name)


def _strides(x):
    """Element strides of the b, t and h dims of a [B, T, H, D] tensor. A
    dim of size 1 is only ever read at index 0, so its stride is free; it
    gets the stride a dense layout would give it, which the TMA unit
    takes whatever the tensor says."""
    b, t, h, d = x.shape
    sh = x.stride(2) if h > 1 else d
    st = x.stride(1) if t > 1 else sh * h
    sb = x.stride(0) if b > 1 else st * t
    return sb, st, sh


def _check(q, k, v, kv_lens):
    if q.dtype not in _LIBRARY:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, Tq, H, D] and k, v [B, Tk, H, D]")
    b, tq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if min(q.shape) == 0 or k.shape[1] == 0:
        raise ValueError("empty attention input")
    if b * h > 65535:
        raise ValueError("B * H exceeds the kernel's grid")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if kv_lens is not None and kv_lens.shape != (b,):
        raise ValueError(f"kv_lens must be [{b}], got {tuple(kv_lens.shape)}")
    if q.dtype == torch.bfloat16:  # the wgmma kernel reads through TMA
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name}'s base address is not 16-byte "
                                 "aligned, which TMA needs")
            for dim, st in zip("bth", _strides(x)):
                if (2 * st) % 16 or not 0 < 2 * st < 2 ** 40:
                    raise ValueError(
                        f"{name}'s {dim} stride is {2 * st} bytes; TMA "
                        "needs a positive multiple of 16 below 2**40")


def flash_attention(q, k, v, kv_lens=None, causal: bool = False):
    """Flash-attention forward (unast_tpu/ops/attention.py::flash_attention).

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D] (float32 or bfloat16, last dim
    contiguous, D in 16/32/64/128); kv_lens: [B] valid key counts (None =
    all Tk valid). Returns [B, Tq, H, D] in q's dtype.

    On a CUDA tensor it launches the kernel for q's dtype (for float32, a
    pre-pass and the kernel), adding one to `flash_attention.launches` and
    to `launches_bf16` or `launches_f32`, or raises (a bfloat16 tensor
    whose base or b/t/h stride is not a multiple of 16 bytes raises
    ValueError; float32 takes any strides). On a CPU tensor it runs
    `flash_attention_plain`, the only case in which the plain version is
    taken. Precondition: every kv_len >= 1; a row with no visible key has
    no defined output."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, kv_lens)
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    o = _kernel(_LIBRARY[q.dtype])(q, k, v, lens, causal)
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.launches_bf16 += 1
    else:
        flash_attention.launches_f32 += 1
    return o


flash_attention.launches = 0        # every launch
flash_attention.launches_bf16 = 0   # of flash_attn_fwd_wgmma
flash_attention.launches_f32 = 0    # of flash_attn_fwd_f32 (pre-pass + kernel)
