"""Flash attention of the port: two hand-written Hopper forward kernels
behind `flash_attention`, their plain PyTorch version
`flash_attention_fwd_plain` (o and lse; `flash_attention_plain`, o), and
the backward pass (two hand-written Hopper kernels behind
`flash_attention_bwd` and their plain version `flash_attention_bwd_plain`).

Counterpart of unast_tpu/ops/attention.py (the Pallas TPU kernel and its
custom_vjp). Used by the transformer encoders and the teacher-forced
decoders when ModelConfig.attn_impl == 'flash'. Both forward kernels run
on the tensor cores with wgmma fed by TMA: bfloat16 inputs go to
csrc/flash_attn_fwd_wgmma.cu, float32 inputs to csrc/flash_attn_fwd_f32.cu,
which splits every operand into two TF32 parts and sums three TF32
products to keep float32 accuracy (after a pre-pass that splits k and v
into a workspace allocated here). Both read the [B, T, H, D] tensors in
place through their strides, so the [B*H, T, D] transposes of the JAX
wrapper are gone, and load kv_lens per batch row themselves.

The forward is the registered operator unast::flash_attention_fwd
(`flash_attention_fwd`, returning o and lse, the float32 [B, H, Tq]
natural-log logsumexp of each row's scaled, masked scores), so that
torch.export keeps it as one node of an exported program, as jax.export
keeps the pallas_call, and loading such a program needs only this module
imported. Its autograd formula is the JAX package's recompute backward
(_flash_vjp_bwd) on the same [B, T, H, D] layout. On the card it is a
hand-written kernel for q's dtype (`flash_attention_bwd`), each a pre-pass
and then one launch on wgmma whose blocks form dQ or dK/dV, reading the
forward's lse instead of recomputing it: bfloat16 inputs go to
csrc/flash_attn_bwd_wgmma.cu (P and dS split into two bf16 parts), float32
inputs to csrc/flash_attn_bwd_f32.cu (split TF32: the grid reads raw
float32 tiles of q, k, v and dO by TMA and splits and transposes them in
shared memory; its pre-pass writes only lse in base 2 and delta). On the
CPU it is
`flash_attention_bwd_plain`, the plain torch version, which recomputes lse
as JAX does.
"""

import ctypes
import functools
import math

import torch
from torch.profiler import record_function

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)
# dtype -> the kernel library (and C entry point) that takes it
_LIBRARY = {torch.float32: "flash_attn_fwd_f32",
            torch.bfloat16: "flash_attn_fwd_wgmma"}
_BACKWARD_LIBRARY = {torch.float32: "flash_attn_bwd_f32",
                     torch.bfloat16: "flash_attn_bwd_wgmma"}
_TMA_REFUSED = -1   # the TMA unit refused a layout


def _keep(q, k, kv_lens, causal: bool, q_start: int = 0):
    """bool [B|1, 1, Tq|1, Tk]: key j is visible to query i of row b when
    j < kv_lens[b] and, if causal, j <= i + q_start (query i sits at
    position q_start + i of the keys' sequence)."""
    b, tq = q.shape[:2]
    tk = k.shape[1]
    kpos = torch.arange(tk, device=q.device)
    keep = torch.ones((b, 1, 1, tk), dtype=torch.bool, device=q.device)
    if kv_lens is not None:
        keep = kpos[None, None, None, :] < kv_lens.to(q.device)[:, None, None, None]
    if causal:
        qpos = torch.arange(tq, device=q.device) + q_start
        keep = keep & (kpos[None, :] <= qpos[:, None])[None, None]
    return keep


def flash_attention_fwd_plain(q, k, v, kv_lens=None, causal: bool = False,
                              q_start: int = 0):
    """(o, lse): the plain PyTorch version of the forward kernels, the same
    function (unast_tpu/ops/attention.py::_flash_fwd): float32 scores of
    the pre-scaled q against k, -1e9 where key j >= kv_lens[b] or (causal)
    j > i + q_start, float32 softmax and float32 P.V, o cast to q's dtype;
    lse, float32 [B, H, Tq], the natural-log logsumexp of each row's
    scores (the lse that _flash_vjp_bwd recomputes, logsumexp of
    _ref_scores): what the kernels write beside o for the backward.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; kv_lens: [B] or None; q_start:
    the keys' position of query 0 (a sequence-parallel rank's first
    frame; 0 when q and k are one sequence)."""
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    s = torch.where(_keep(q, k, kv_lens, causal, q_start), s,
                    torch.full_like(s, NEG_INF))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_plain(q, k, v, kv_lens=None, causal: bool = False,
                          q_start: int = 0):
    """o of flash_attention_fwd_plain: the plain version the forward
    kernels' output is held to."""
    return flash_attention_fwd_plain(q, k, v, kv_lens, causal, q_start)[0]


def flash_attention_bwd_plain(q, k, v, kv_lens, causal: bool, o, do,
                              q_start: int = 0):
    """(dq, dk, dv) of flash attention, step for step the JAX package's
    recompute backward (unast_tpu/ops/attention.py::_flash_vjp_bwd with
    _ref_scores), on the [B, T, H, D] layout: float32 scores of q against k
    times the scale, -1e9 at masked keys, lse = logsumexp, P = exp(s - lse),
    dV = P^T dO, dP = dO V^T, delta = rowsum(dO * o) from the forward output
    o, dS = P (dP - delta) scale, dQ = dS K, dK = dS^T Q, each cast to its
    input's dtype. Every operand is read in float32. Materialises float32
    [B, H, Tq, Tk] scores, probabilities and their gradients. q_start: as
    in flash_attention_plain."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = torch.where(_keep(q, k, kv_lens, causal, q_start), s,
                    torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]   # [B, H, Tq, 1]
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bind(lib_path, name: str):
    """launch(q, k, v, kv_lens, causal, q_start=0) -> (o, lse) through the
    C entry point `name` of the kernel library at `lib_path`, on the
    current stream: o [B, Tq, H, D] of q's dtype, lse float32 [B, H, Tq].
    Where the library exports `<name>_workspace` (floats of scratch for
    B, H, Tk, D), launch allocates that much and passes it after the
    stream. kv_lens: int32 [B] on q's device, or None. launch checks no
    input (flash_attention's _check does) and raises if the launch
    failed."""
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, name)
    workspace = getattr(lib, name + "_workspace", None)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
                   + [ctypes.c_void_p] * (workspace is not None))
    if workspace is not None:
        workspace.restype = ctypes.c_longlong
        workspace.argtypes = [ctypes.c_int] * 4

    def launch(q, k, v, kv_lens, causal, q_start=0):
        b, tq, h, d = q.shape
        tk = k.shape[1]
        o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), None if kv_lens is None else kv_lens.data_ptr(),
                b, h, tq, tk, d,
                *_strides(q), *_strides(k), *_strides(v), *_strides(o),
                int(causal), int(q_start), 1.0 / math.sqrt(d),
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
        return o, lse
    return launch


def bind_backward(lib_path, name: str):
    """launch(q, k, v, kv_lens, causal, o, lse, do, q_start=0) -> (dq, dk,
    dv) through the backward's C entry point `name` of the library at
    `lib_path`, on the current stream: bind's conventions, lse the
    forward's float32 [B, H, Tq], with the workspace
    `<name>_workspace(B, H, Tq, Tk, D)` floats (what the first launch
    writes for the second: lse in base 2 and delta). The gradients are
    new contiguous tensors of q's
    dtype. launch checks no input (flash_attention_bwd
    does) and raises if a launch failed."""
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, name)
    workspace = getattr(lib, name + "_workspace")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 2)
    workspace.restype = ctypes.c_longlong
    workspace.argtypes = [ctypes.c_int] * 5

    def launch(q, k, v, kv_lens, causal, o, lse, do, q_start=0):
        b, tq, h, d = q.shape
        tk = k.shape[1]
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
        dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
        ws = torch.empty(workspace(b, h, tq, tk, d), dtype=torch.float32,
                         device=q.device)
        tensors = (q, k, v, o, do, dq, dk, dv)
        err = fn(*[x.data_ptr() for x in tensors[:5]], lse.data_ptr(),
                 *[x.data_ptr() for x in tensors[5:]],
                 None if kv_lens is None else kv_lens.data_ptr(),
                 b, h, tq, tk, d, *[st for x in tensors for st in _strides(x)],
                 int(causal), int(q_start), 1.0 / math.sqrt(d),
                 torch.cuda.current_stream(q.device).cuda_stream, ws.data_ptr())
        if err == _TMA_REFUSED:
            raise ValueError(
                f"{name}: the TMA unit refused the layout of q, k, v, o, dO or "
                f"its workspace (strides {q.stride()}, {k.stride()}, "
                f"{v.stride()}, {do.stride()})")
        if err != 0:
            raise RuntimeError(f"{name} launch failed: error {err}")
        return dq, dk, dv
    return launch


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """launch() of this tree's library `name` (bind, or bind_backward for
    a backward's), built at first use."""
    from .build import library
    if name in _BACKWARD_LIBRARY.values():
        return bind_backward(library(name), name)
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


def _check(q, k, v, kv_lens, q_start: int = 0):
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
    if q_start < 0:
        raise ValueError(f"q_start must be >= 0, got {q_start}")
    if kv_lens is not None and kv_lens.shape != (b,):
        raise ValueError(f"kv_lens must be [{b}], got {tuple(kv_lens.shape)}")
    if q.dtype == torch.bfloat16:  # the wgmma kernel reads through TMA
        for name, x in (("q", q), ("k", k), ("v", v)):
            refused = _tma_refusal(x)
            if refused:
                raise ValueError(f"{name}'s {refused}")


def _tma_refusal(x):
    """Why the TMA unit cannot read the [B, T, H, D] tensor x (its base
    address or a b/t/h stride), or None if it can."""
    if x.data_ptr() % 16:
        return "base address is not 16-byte aligned, which TMA needs"
    size = x.element_size()
    for dim, st in zip("bth", _strides(x)):
        if (size * st) % 16 or not 0 < size * st < 2 ** 40:
            return (f"{dim} stride is {size * st} bytes; TMA needs a positive "
                    "multiple of 16 below 2**40")
    return None


def _tma_ready(x):
    """x, or a dense copy of it where the TMA unit cannot read x (a float32
    view at an odd offset or stride, an expanded tensor): a layout copy."""
    if x.stride(3) != 1 or _tma_refusal(x):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _forward(q, k, v, kv_lens, causal: bool, q_start: int = 0):
    """(o, lse) on q's device: the kernel for q's dtype on a CUDA tensor
    (counted in flash_attention's launch counts) or a raise, and the plain
    version on a CPU tensor, the only case in which it is taken."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_lens, causal, q_start)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, kv_lens, q_start)
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = _kernel(_LIBRARY[q.dtype])(q, k, v, lens, causal, q_start)
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.launches_bf16 += 1
    else:
        flash_attention.launches_f32 += 1
    return out


def _fake(q, k, v, kv_lens, causal, q_start=0):
    # the kernels write o as a contiguous [B, Tq, H, D] tensor of q's dtype
    # and lse as a contiguous float32 [B, H, Tq]
    b, tq, h, _ = q.shape
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((b, h, tq), dtype=torch.float32, device=q.device))


def _setup_backward(ctx, inputs, output):
    q, k, v, kv_lens, causal, q_start = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, kv_lens, o, lse)
    ctx.mark_non_differentiable(lse)
    ctx.causal, ctx.q_start = causal, q_start


def flash_attention_bwd(q, k, v, kv_lens, causal: bool, o, lse, do,
                        q_start: int = 0):
    """(dq, dk, dv) of flash attention through the backward kernel for q's
    dtype (csrc/flash_attn_bwd_wgmma.cu for bfloat16,
    csrc/flash_attn_bwd_f32.cu for float32; two launches on the current
    stream), adding one to `flash_attention.backward_launches` and to
    `backward_launches_bf16` or `backward_launches_f32`. The same function
    as flash_attention_bwd_plain, which recomputes lse; q, k, v as
    flash_attention takes them (on the card; bfloat16 TMA-readable,
    checked here; float32 through any strides), o and lse the forward's
    outputs (o contiguous, lse float32 [B, H, Tq] contiguous) and do
    [B, Tq, H, D] of q's dtype on q's device. Both kernels read q, k, v
    and dO by TMA: a do whose last dim is not contiguous (an expanded
    gradient with zero strides, as autograd hands over for out.sum()) or
    that TMA cannot read (not 16-byte aligned), and in float32 a q, k, v
    or o that TMA cannot read (a view at an odd offset or stride), is
    first copied to a dense tensor: a layout copy, not a fallback. Raises
    on anything else the kernel does not take."""
    if q.device.type != "cuda" or q.dtype not in _BACKWARD_LIBRARY:
        raise ValueError("flash_attention_bwd takes float32 or bfloat16 tensors "
                         f"on the card, got {q.dtype} on {q.device}")
    _check(q, k, v, kv_lens, q_start)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"match q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or not o.is_contiguous():
        raise ValueError(f"o and do must be {q.dtype} and o contiguous, as "
                         "the forward writes it")
    b, tq, h, _ = q.shape
    if (lse.shape != (b, h, tq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be the forward's contiguous float32 "
                         f"[{b}, {h}, {tq}] on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    do = _tma_ready(do)
    if q.dtype == torch.float32:
        q, k, v, o = (_tma_ready(x) for x in (q, k, v, o))
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    grads = _kernel(_BACKWARD_LIBRARY[q.dtype])(q, k, v, lens, causal, o, lse,
                                                do, q_start)
    flash_attention.backward_launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.backward_launches_bf16 += 1
    else:
        flash_attention.backward_launches_f32 += 1
    return grads


def _backward(ctx, do, _dlse):
    """The JAX package's custom_vjp backward (_flash_vjp_bwd) behind the
    operator: q, k, v, kv_lens and the output o are kept for it, as JAX's
    residuals are, and the lse output (not differentiable), which the
    kernel reads instead of recomputing it. A tensor on the card goes to
    the kernel for its dtype (flash_attention_bwd, which raises on what it
    does not take); a CPU tensor, and only a CPU tensor, to
    flash_attention_bwd_plain."""
    q, k, v, kv_lens, o, lse = ctx.saved_tensors
    flash_attention.backward_calls += 1
    with record_function("unast/flash_attention_bwd"):
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd(q, k, v, kv_lens, ctx.causal, o,
                                             lse, do, ctx.q_start)
        elif q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, kv_lens, ctx.causal,
                                                   o, do, ctx.q_start)
        else:
            raise ValueError(f"no flash backward for {q.dtype} on {q.device}")
    return dq, dk, dv, None, None, None


# The forward as the registered operator unast::flash_attention_fwd (the
# counterpart of the pallas_call in unast_tpu/ops/attention.py::_flash_fwd,
# which jax.export keeps in its StableHLO), returning o and lse. Its one
# implementation, for every device, is `_forward` (looked up at each
# call): the kernel on a CUDA tensor, the plain version on a CPU one.
# torch.export and torch.utils.checkpoint see one opaque op; the fake
# implementation gives the outputs' shapes and layouts, the autograd
# formula is `_backward` (the backward kernel for q's dtype on the card,
# the plain recompute on the CPU). (torch.library's custom_op
# decorator would do the same, but its first call imports torch._dynamo,
# seconds in every process.)
FLASH_SCHEMA = ("flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
                "Tensor? kv_lens, bool causal, int q_start=0) -> (Tensor, Tensor)")
_LIB = torch.library.Library("unast", "DEF")
_LIB.define(FLASH_SCHEMA)
_LIB.impl("flash_attention_fwd", lambda *a: _forward(*a), "CompositeExplicitAutograd")
torch.library.register_fake("unast::flash_attention_fwd", _fake, lib=_LIB)
torch.library.register_autograd("unast::flash_attention_fwd", _backward,
                                setup_context=_setup_backward, lib=_LIB)
flash_attention_fwd = torch.ops.unast.flash_attention_fwd.default


def flash_attention(q, k, v, kv_lens=None, causal: bool = False,
                    q_start: int = 0):
    """Flash attention with its gradient
    (unast_tpu/ops/attention.py::flash_attention).

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D] (float32 or bfloat16, last dim
    contiguous, D in 16/32/64/128); kv_lens: [B] valid key counts (None =
    all Tk valid); q_start: the keys' position of query 0 under the causal
    mask (key j visible to query i when j <= i + q_start): a sequence-
    parallel rank's queries [q_start, q_start + Tq) against the gathered
    keys. Returns o, [B, Tq, H, D] in q's dtype (the operator's lse
    output stays inside autograd, for the backward).

    On a CUDA tensor the forward launches the kernel for q's dtype (for
    float32, a pre-pass and the kernel), adding one to
    `flash_attention.launches` and to `launches_bf16` or `launches_f32`,
    or raises (a bfloat16 tensor whose base or b/t/h stride is not a
    multiple of 16 bytes raises ValueError; float32 takes any strides). On
    a CPU tensor it runs `flash_attention_fwd_plain`. Where q, k or v needs a
    gradient, each backward adds one to `flash_attention.backward_calls`;
    on a CUDA tensor it launches the backward kernel for q's dtype
    (`flash_attention_bwd`, adding one to `backward_launches` and to
    `backward_launches_bf16` or `backward_launches_f32`) or raises, on a
    CPU tensor it runs `flash_attention_bwd_plain`. Precondition: every
    kv_len >= 1; a row with no visible key has no defined output."""
    if q_start:
        return flash_attention_fwd(q, k, v, kv_lens, causal, int(q_start))[0]
    return flash_attention_fwd(q, k, v, kv_lens, causal)[0]


flash_attention.launches = 0        # every launch
flash_attention.launches_bf16 = 0   # of flash_attn_fwd_wgmma
flash_attention.launches_f32 = 0    # of flash_attn_fwd_f32 (pre-pass + kernel)
flash_attention.backward_calls = 0     # every backward through autograd
flash_attention.backward_launches = 0       # every backward launch (2 kernels a call)
flash_attention.backward_launches_bf16 = 0  # of flash_attn_bwd_wgmma
flash_attention.backward_launches_f32 = 0   # of flash_attn_bwd_f32
