#!/usr/bin/env python3
"""GPU smoke run of unast_tpu_torch, the PyTorch/CUDA port: the quickest
proof that the port builds, that its kernels agree with their plain
versions, and that it serves on an NVIDIA card.

    python3 chip_smoke.py

Phases (each that fails exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32
     flags, which this script turns off so float32 products stay float32;
  2. the kernel build (nvcc, from unast_tpu_torch/csrc, one process per
     library, all started together) and its seconds, each library's ptxas
     report, and the count of HGMMA (wgmma) instructions in each library's
     SASS (cuobjdump);
  3. every kernel against its plain PyTorch version, in both dtypes: at
     the serving shapes (text and mel buckets, B 8, on the strided views of
     one fused-QKV projection, as the encoders pass them) and on more
     layouts and masks (separate tensors, cross-attention views, kv_len 1,
     kv_lens off the key tile, causal, Tq != Tk, D 16/32/128); in float32
     also the shapes of phase 5's TINY serve (D 16, B <= 4, T 8-24), the
     route's main case, and a V one-hot in the key, which pins the
     split-TF32 kernel's key order. bf16 within 2e-2 and within one bf16 rounding of the output,
     float32 within 2e-5. Each case with its device time (torch.profiler,
     the route's own kernels, the float32 pre-pass shown apart), its
     per-call time (CUDA events over back-to-back calls, host work
     included), the card's bound and a library call's time;
  4. the main path: a Synthesizer on configs/transformer_d_curriculum_fast.json
     (d 256, 4 layers, 4 heads, bf16) with attn_impl='flash', random weights
     from seed 0 and the stop bias lowered so every request decodes the full
     815 frames: 8 sentences -> tts -> 8 waveforms -> asr -> 8 transcripts,
     with the kernel launch counts set to 0 just before and read just after;
  5. the port on the card against the port on the CPU at TINY width, in
     float32, which is the float32 kernel's path (D 16; counts set to 0 just
     before, read just after; the CPU path is held to the JAX package by
     tests/test_torch_*.py);
  6. one `{"kernels": [...]}` line (both routes), a `{"serve": ...}` line,
     and last `{"ok": true, "device": ...}`.
"""

import json
import os
import subprocess
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "transformer_d_curriculum_fast.json")
SENTENCES = [
    "Printing, in the only sense with which we are at present concerned.",
    "The earliest book printed with movable types.",
    "It is differentiated from most if not from all the arts.",
    "And the book is a marvel of typography.",
    "He was found dead in his cell on the morning of March 4th, 1920.",
    "The committee met for three hours and reached no decision.",
    "A quick brown fox jumps over the lazy dog.",
    "Dr. Smith paid $5 for the ticket.",
]
H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_TF32_FLOPS = 495e12   # dense TF32 tensor-core peak
H100_F32_FLOPS = 67e12     # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
# the route's kernels as the profiler names them (the float32 pre-pass first)
ROUTE_KERNELS = {torch.bfloat16: ("flash_fwd_wgmma_kernel",),
                 torch.float32: ("tf32_split_kernel", "flash_fwd_tf32x3_kernel")}


class Case(NamedTuple):
    """One kernel-vs-plain input set: kv_lens `lens`, or ragged from tk
    down to about a third of it; layout as in attention_inputs; one_hot_v:
    v of key j is the unit vector e_(j mod D), so each output column sums
    the weights of its own keys and a key order on which P and V disagree
    moves weight between columns."""
    name: str
    dtype: torch.dtype
    b: int
    tq: int
    tk: int
    h: int
    d: int
    causal: bool
    seed: int
    layout: str = "separate"
    lens: Optional[List[int]] = None
    one_hot_v: bool = False


bf16, f32 = torch.bfloat16, torch.float32
RAGGED = [1, 63, 65, 100, 129, 300, 511, 815]   # off the 64-key tile
# the serving buckets on the fused-QKV views the encoders pass, in both
# dtypes, and more layouts and masks; the tiny_* cases are the float32
# route's main path (phase 5: TINY, D 16, its exact batches and kv_lens)
FLASH_CASES = [
    Case("asr_encoder_qkv", bf16, 8, 815, 815, 4, 64, False, 16, "qkv"),
    Case("asr_encoder", bf16, 8, 815, 815, 4, 64, False, 1),
    Case("asr_encoder_f32", f32, 8, 815, 815, 4, 64, False, 2),
    Case("asr_encoder_t512", bf16, 8, 512, 512, 4, 64, False, 11, "qkv"),
    Case("asr_encoder_t256", bf16, 8, 256, 256, 4, 64, False, 12, "qkv"),
    Case("tts_encoder", bf16, 8, 300, 300, 4, 64, False, 3, "qkv"),
    Case("tts_encoder_t128", bf16, 8, 128, 128, 4, 64, False, 13, "qkv"),
    Case("tts_encoder_t64", bf16, 8, 64, 64, 4, 64, False, 14, "qkv"),
    Case("tts_encoder_t32", bf16, 8, 32, 32, 4, 64, False, 15, "qkv"),
    Case("tts_encoder_f32", f32, 8, 300, 300, 4, 64, False, 4),
    Case("cross_attention", bf16, 8, 300, 815, 4, 64, False, 17, "cross"),
    Case("kv_len_1", bf16, 8, 300, 300, 4, 64, False, 18, "qkv", lens=[1] * 8),
    Case("kv_lens_off_tile", bf16, 8, 815, 815, 4, 64, False, 19, "qkv",
         lens=RAGGED),
    Case("causal", bf16, 8, 815, 815, 4, 64, True, 5),
    Case("causal_qkv", bf16, 8, 815, 815, 4, 64, True, 20, "qkv", lens=RAGGED),
    Case("causal_f32", f32, 8, 300, 300, 4, 64, True, 6),
    Case("tq_ne_tk", bf16, 8, 300, 815, 4, 64, False, 7),
    Case("tq_gt_tk_causal", bf16, 8, 815, 300, 4, 64, True, 21),
    Case("d16", bf16, 8, 300, 300, 16, 16, False, 22, "qkv"),
    Case("d16_f32", f32, 8, 300, 300, 16, 16, False, 8),
    Case("d32", bf16, 8, 300, 300, 8, 32, False, 9),
    Case("d128", bf16, 8, 300, 300, 2, 128, False, 10),
    Case("d128_cross_causal", bf16, 8, 300, 815, 2, 128, True, 23, "cross",
         lens=RAGGED),
    Case("tiny_asr_encoder_f32", f32, 2, 24, 24, 2, 16, False, 37, "qkv",
         lens=[20, 11]),
    Case("tiny_tts_encoder_f32", f32, 3, 8, 8, 2, 16, False, 38, "qkv",
         lens=[7, 3, 8]),
    Case("tiny_t16_f32", f32, 4, 16, 16, 2, 16, False, 39, "qkv",
         lens=[16, 9, 5, 1]),
    Case("asr_encoder_qkv_f32", f32, 8, 815, 815, 4, 64, False, 24, "qkv"),
    Case("asr_encoder_t512_f32", f32, 8, 512, 512, 4, 64, False, 25, "qkv"),
    Case("tts_encoder_qkv_f32", f32, 8, 300, 300, 4, 64, False, 26, "qkv"),
    Case("tts_encoder_t128_f32", f32, 8, 128, 128, 4, 64, False, 27, "qkv"),
    Case("cross_attention_f32", f32, 8, 300, 815, 4, 64, False, 28, "cross"),
    Case("kv_len_1_f32", f32, 8, 300, 300, 4, 64, False, 29, "qkv",
         lens=[1] * 8),
    Case("kv_lens_off_tile_f32", f32, 8, 815, 815, 4, 64, False, 30, "qkv",
         lens=RAGGED),
    Case("causal_qkv_f32", f32, 8, 815, 815, 4, 64, True, 31, "qkv",
         lens=RAGGED),
    Case("d32_f32", f32, 8, 300, 300, 8, 32, False, 32, "qkv"),
    Case("d128_f32", f32, 8, 300, 300, 2, 128, False, 33, "qkv"),
    Case("d128_cross_causal_f32", f32, 8, 300, 815, 2, 128, True, 34, "cross",
         lens=RAGGED),
    Case("one_hot_v_f32", f32, 8, 300, 300, 4, 64, False, 35, lens=RAGGED,
         one_hot_v=True),
    Case("one_hot_v_d128_f32", f32, 8, 100, 257, 2, 128, True, 36,
         one_hot_v=True),
]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events),
    after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, k, kv_lens, causal):
    """Least time (ms) the card could take for one flash_attention call on
    these inputs, what bounds it, and for float32 the same on the CUDA
    cores: the score and P.V products over the (query, key) pairs this data
    keeps, against the bytes of q, the kept k/v rows, o and kv_lens, each
    moved once. The float32 work at float32 accuracy on the tensor cores is
    three TF32 products (split-TF32), as the float32 kernel does it."""
    b, tq, h, d = q.shape
    lens = kv_lens.cpu().numpy().astype(np.int64)
    rows = np.arange(tq)
    pairs = sum(int(np.minimum(rows + 1, n).sum()) if causal else tq * int(n)
                for n in lens)
    flops = 4 * h * d * pairs
    item = q.element_size()
    nbytes = item * (2 * q.numel() + 2 * h * d * int(lens.sum())) + 4 * b
    t_bytes = nbytes / H100_BYTES_PER_S
    if q.dtype == torch.bfloat16:
        t_ops, cuda_core_ms = flops / H100_BF16_FLOPS, None
    else:
        t_ops = 3 * flops / H100_TF32_FLOPS
        cuda_core_ms = max(flops / H100_F32_FLOPS, t_bytes) * 1e3
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", cuda_core_ms)


def device_ms(fn, symbols, iters: int, tries: int = 3):
    """Mean device time (ms) per call of fn(), from torch.profiler over
    `iters` calls after one warm-up call: {symbol: ms} of the kernels whose
    name holds each of `symbols`, each launched once a call; with no
    symbols, {"": ms} of every kernel the call launches. A profiled window
    now and then records no device activity at all; such a window is
    profiled again, up to `tries` in all, and then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        found = {}
        for symbol in symbols or ("",):
            kernels = [e for e in events if symbol in e.key]
            found[symbol] = (sum(e.count for e in kernels),
                             sum(e.self_device_time_total for e in kernels))
        if all(n == iters if symbols else n >= iters for n, _ in found.values()):
            return {sym: us * 1e-3 / iters for sym, (_, us) in found.items()}
    raise SystemExit(f"profiler saw launches {({s: n for s, (n, _) in found.items()})} "
                     f"in {tries} windows, expected {iters} of each")


def attention_inputs(dtype, b, tq, tk, h, d, layout, seed):
    """q [B, Tq, H, D] and k, v [B, Tk, H, D] on the card. layout 'qkv':
    views of one [B, T, 3*H*D] tensor, as the encoders' fused projection
    gives them (T stride 3*H*D, bases 0, H*D and 2*H*D elements in);
    'cross': q on its own, k and v views of one [B, Tk, 2*H*D] tensor, as
    a cross-attention's fused k/v projection gives them; 'separate':
    three tensors."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def heads(x):
        return [t.unflatten(-1, (h, d)) for t in torch.split(x, h * d, dim=-1)]
    if layout == "qkv":
        assert tq == tk
        return heads(randn(b, tq, 3 * h * d))
    if layout == "cross":
        return [randn(b, tq, h, d)] + heads(randn(b, tk, 2 * h * d))
    return [randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, d)]


def case_inputs(c: Case):
    """q, k, v and kv_lens of case c, on the card."""
    q, k, v = attention_inputs(c.dtype, c.b, c.tq, c.tk, c.h, c.d, c.layout, c.seed)
    if c.one_hot_v:
        eye = torch.nn.functional.one_hot(torch.arange(c.tk, device="cuda") % c.d, c.d)
        v = eye.to(c.dtype)[None, :, None, :].expand(c.b, c.tk, c.h, c.d)
    if c.lens is None:
        kv_lens = torch.linspace(c.tk, max(1, c.tk // 3), c.b,
                                 device="cuda").round().int()
    else:
        kv_lens = torch.tensor(c.lens, dtype=torch.int32, device="cuda")
    return q, k, v, kv_lens


def sdpa_call(q, k, v, kv_lens, causal):
    """fn() computing the same function with one PyTorch call,
    scaled_dot_product_attention under a boolean mask."""
    b, tq, _, _ = q.shape
    tk = k.shape[1]
    keep = torch.arange(tk, device=q.device)[None, :] < kv_lens[:, None]
    mask = keep[:, None, None, :].expand(b, 1, tq, tk)
    if causal:
        mask = mask & torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


def flash_case(c: Case):
    """Kernel vs plain (and SDPA as a yardstick) on case c's inputs."""
    from unast_tpu_torch.ops.attention import flash_attention, flash_attention_plain
    q, k, v, kv_lens = case_inputs(c)
    out = flash_attention(q, k, v, kv_lens, causal=c.causal)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, kv_lens, causal=c.causal)
    tol = 2e-5 if c.dtype == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= tol + tol * ref.float().abs()).all())
    if c.dtype == torch.bfloat16:   # and within one bf16 rounding of the output
        ok = ok and bool((err <= 2.0 ** -7 * ref.float().abs() + 1e-5).all())
    iters = 50 if c.tq * c.tk <= 300 * 815 else 20
    bound_ms, bound_by, bound_cuda_core_ms = attention_bound(q, k, kv_lens, c.causal)
    symbols = ROUTE_KERNELS[c.dtype]

    def kernel():
        return flash_attention(q, k, v, kv_lens, causal=c.causal)
    library = sdpa_call(q, k, v, kv_lens, c.causal)
    per_kernel = device_ms(kernel, symbols, iters)
    case = {
        "case": c.name, "dtype": str(c.dtype).replace("torch.", ""),
        "layout": c.layout, "shape": [c.b, c.tq, c.tk, c.h, c.d],
        "causal": c.causal, "kv_lens": kv_lens.tolist(),
        "one_hot_v": c.one_hot_v,
        "max_abs_err": float(err.max()), "tol": tol, "ok": ok,
        "ms": cuda_ms(kernel, iters),
        "device_ms": sum(per_kernel.values()),
        "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, kv_lens,
                                                          causal=c.causal), iters),
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": device_ms(library, (), iters)[""],
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if c.dtype == torch.float32:
        case["prepass_device_ms"] = per_kernel[symbols[0]]
        case["bound_cuda_core_ms"] = bound_cuda_core_ms
    return case


def hgmma_count(lib):
    """HGMMA (warpgroup MMA) instructions in a built library's SASS: in
    all, and those on TF32 operands."""
    from unast_tpu_torch.ops import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    lines = [line for line in sass.splitlines() if "HGMMA" in line]
    return len(lines), sum("TF32" in line for line in lines)


def reset_launch_counts(fn):
    fn.launches = fn.launches_bf16 = fn.launches_f32 = 0


def host_sync_us(n: int = 200) -> float:
    """Host cost of the decode loops' per-step early-exit test (a device
    reduction read back to the host) on an otherwise idle card."""
    x = torch.zeros(8, dtype=torch.long, device="cuda")
    bool((x == 1).any())
    t = time.perf_counter()
    for _ in range(n):
        bool((x == 1).any())
    return (time.perf_counter() - t) / n * 1e6


def profile_asr(syn, mels):
    """Where the time of one greedy ASR batch goes: its wall time without
    and with torch.profiler, the device's busy time (the sum of its kernel
    times; one stream, so they do not overlap), the idle share of the
    unprofiled wall time, kernels per decode step, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t = time.perf_counter()
    syn.asr_ids(mels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        syn.asr_ids(mels)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t
    steps = sum(syn.last_decode_steps)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_s": wall, "wall_profiled_s": wall_profiled,
        "device_busy_s": busy_us * 1e-6,
        "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
        "decode_steps": steps,
        "kernel_launches": sum(e.count for e in kernels),
        "kernels_per_step": sum(e.count for e in kernels) / max(1, steps),
        "top_kernels": [[e.key[:80], e.self_device_time_total * 1e-3, e.count]
                        for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from unast_tpu_torch.ops import attention, build
    from unast_tpu_torch.audio.params import AudioParams
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import TINY, ModelConfig, unast_init

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}))

    # 2. the kernel build
    t = time.perf_counter()
    libs = build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t,
                      "libs": {k: str(v) for k, v in libs.items()}}))
    for path in libs.values():
        log = path.with_name(path.name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print("ptxas:", line.strip())
    hgmma = {name: hgmma_count(path) for name, path in libs.items()}
    print(json.dumps({"hgmma_instructions": {
        name: {"all": n, "tf32": n_tf32} for name, (n, n_tf32) in hgmma.items()}}))
    assert hgmma["flash_attn_fwd_wgmma"][0] > 0, "the bf16 kernel has no wgmma"
    assert hgmma["flash_attn_fwd_f32"][1] > 0, "the f32 kernel has no TF32 wgmma"

    # 3. every kernel against its plain version
    cases = [flash_case(c) for c in FLASH_CASES]
    bad = [c for c in cases if not c["ok"]]

    # 4. the main path at flagship width
    cfg = ModelConfig.from_json(CONFIG).replace(attn_impl="flash")
    params, state = unast_init(torch.Generator().manual_seed(0), cfg)
    params["speech_m"]["postnet"]["stop_proj"]["b"] -= 100.0
    syn = Synthesizer(params, state, cfg)
    t = time.perf_counter()
    syn.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t
    reset_launch_counts(attention.flash_attention)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wavs = syn.tts(SENTENCES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tts_steps, tts_batches = sum(syn.last_decode_steps), len(syn.last_decode_steps)
    texts = syn.asr(wavs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    asr_steps, asr_batches = sum(syn.last_decode_steps), len(syn.last_decode_steps)
    launches = attention.flash_attention.launches
    launches_bf16 = attention.flash_attention.launches_bf16
    launches_f32 = attention.flash_attention.launches_f32
    peak_mem = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    tts_mels = syn.tts_mels(SENTENCES)
    torch.cuda.synchronize()
    tts_mels_s = time.perf_counter() - t
    asr_profile = profile_asr(syn, tts_mels)

    assert len(wavs) == len(SENTENCES), len(wavs)
    for w in wavs:
        assert w.ndim == 1 and len(w) > 0 and np.isfinite(w).all(), w.shape
    assert len(texts) == len(SENTENCES) and all(isinstance(s, str) for s in texts)
    encoder_calls = tts_batches + asr_batches
    assert launches > 0 and launches == cfg.num_layers * encoder_calls, (
        launches, encoder_calls)
    assert launches_bf16 == launches and launches_f32 == 0, (
        launches_bf16, launches_f32)

    # 5. the card against the CPU at TINY width (float32, flash on): the
    # float32 kernel's path, its launches counted from here
    tiny = TINY.replace(attn_impl="flash")
    tp, ts = unast_init(torch.Generator().manual_seed(0), tiny)
    tp["speech_m"]["postnet"]["stop_proj"]["b"] -= 100.0
    kw = dict(audio_params=AudioParams(n_iter=2), text_buckets=(8, 16),
              mel_buckets=(16, 24), max_batch=4)
    on_gpu = Synthesizer(tp, ts, tiny, device="cuda", **kw)
    on_cpu = Synthesizer(tp, ts, tiny, device="cpu", **kw)
    short = ["hi there", "ok", "go now"]
    rng = np.random.default_rng(1)
    mels = [rng.uniform(0, 1, (n, 80)).astype(np.float32) for n in (20, 11)]
    reset_launch_counts(attention.flash_attention)
    gpu_mels, gpu_ids = on_gpu.tts_mels(short), on_gpu.asr_ids(mels)
    tiny_launches_f32 = attention.flash_attention.launches_f32
    tiny_launches_bf16 = attention.flash_attention.launches_bf16
    mel_err = max(float(np.abs(a - b).max()) for a, b in
                  zip(gpu_mels, on_cpu.tts_mels(short)))
    # on this seed every greedy choice of the CPU run leads its runner-up
    # by more than 1e-2 in logit, far above float32 noise
    ids_equal = all(np.array_equal(a, b) for a, b in
                    zip(gpu_ids, on_cpu.asr_ids(mels)))
    assert mel_err <= 1e-4 and ids_equal, (mel_err, ids_equal)
    assert tiny_launches_f32 > 0 and tiny_launches_bf16 == 0, (
        tiny_launches_f32, tiny_launches_bf16)

    for kernel_case in cases:
        kernel_case.pop("ok")
    routes = [
        ("flash_attn_fwd_wgmma", "bfloat16", "flash_attn_fwd_wgmma.cu",
         "asr_encoder_qkv", launches_bf16,
         "flagship serve: 8 TTS + 8 ASR, bf16"),
        ("flash_attn_fwd_f32", "float32", "flash_attn_fwd_f32.cu",
         "tiny_asr_encoder_f32", tiny_launches_f32,
         "TINY serve on the card, float32 (phase 5)"),
    ]
    kernels = []
    for name, dtype, source, main_name, n, path in routes:
        main_case = next(c for c in cases if c["case"] == main_name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"unast_tpu_torch/csrc/{source}",
            "replaces": "unast_tpu/ops/attention.py:81",
            "dtype": dtype, "launches": n, "launches_counted_on": path,
            **{key: main_case[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms",
                "prepass_device_ms", "bound_cuda_core_ms") if key in main_case},
            "hgmma_instructions": hgmma[name][0],
            "main_case": main_name,
            "cases": [c for c in cases if c["dtype"] == dtype]})
    print(json.dumps({"kernels": kernels}))
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")

    n = len(SENTENCES)
    print(json.dumps({"serve": {
        "config": os.path.relpath(CONFIG, ROOT), "attn_impl": cfg.attn_impl,
        "compute_dtype": cfg.compute_dtype, "d_model": cfg.e_in,
        "layers": cfg.num_layers, "heads": cfg.nhead, "requests": n,
        "warmup_s": warmup_s,
        "tts_batch_s": t1 - t0, "tts_utt_per_s": n / (t1 - t0),
        "tts_mels_s": tts_mels_s, "tts_decode_steps": tts_steps,
        "tts_ms_per_step": 1e3 * tts_mels_s / max(1, tts_steps),
        "asr_batch_s": t2 - t1, "asr_utt_per_s": n / (t2 - t1),
        "asr_decode_steps": asr_steps,
        "wav_samples": [len(w) for w in wavs],
        "flash_launches": launches, "flash_launches_bf16": launches_bf16,
        "encoder_calls": encoder_calls,
        "host_sync_us": host_sync_us(),
        "asr_ids_profile": asr_profile,
        "max_memory_allocated_bytes": peak_mem,
        "tiny_gpu_vs_cpu": {"tts_mels_max_abs_err": mel_err,
                            "asr_ids_equal": ids_equal},
    }}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
