#!/usr/bin/env python3
"""GPU smoke run of unast_tpu_torch, the PyTorch/CUDA port: the quickest
proof that the port builds, that its kernels agree with their plain
versions, and that it serves and trains on an NVIDIA card.

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
  6. the flash-attention gradients (kernel forward, plain recompute
     backward, through flash_attention's autograd.Function) against
     autograd through the plain version, on fused-QKV and cross views: bf16
     at the flagship train step's shapes (B 4, T 304 and 816, causal
     self-attention, cross 304 x 816 and 816 x 304) within 2**-6 of each
     gradient's largest element, float32 at TINY's within 1e-4 of it; each
     with the backward's time and, as its library time, that of SDPA's
     autograd backward under the same mask;
  7. the second main path: 1 step of make_train_step on the same config
     (ae 2, cm 1, sp 4 and d 1 micro-batches of 4, synthetic batches at the
     config's 816 mel frames and 304 tokens with ragged lengths from numpy
     seed 0), random weights from seed 0, counts set to 0 just before each
     step and read just after: losses and every new param finite, bf16
     forward launches and backward calls per step as the code implies,
     float32 launches 0; then a second step under torch.profiler, read by
     the port's record_function ranges (objectives, backward passes,
     greedy decodes, LSTM discriminator, flash backward) for where its
     time goes and the device's idle share (against the profiled wall,
     so an upper bound);
  8. one train step on the card against the same step on the CPU at TINY
     width in float32 with flash on (the float32 kernel and the backward on
     the card), train mode with every dropout and mask at 0, counts set to
     0 just before and read just after;
  9. the third main path, the training loop (train/loop.py::train) on the
     same config with attn_impl='flash', --synthetic --synthetic_size 16
     --epochs 1 --epoch_steps 1 --sp_warmup_steps 1 --save_every 1
     --eval_batch_size 2 and a temporary checkpoint_path, counts set to 0
     just before and read just after: per call (warm-start step, steps,
     evals, saves) its seconds and its bf16 launches and backward calls
     against the counts the code implies, the four checkpoint roles, the
     best checkpoint loaded back equal to the final state bit for bit and
     through Synthesizer.from_checkpoint (2 TTS + 2 ASR, finite), and
     evaluate_main's test-set dumps; then the float32 loop of
     configs/transformer_test.json (flash, objective_eval_mode,
     SpecAugment spans 0): on the card against the CPU (metrics.jsonl
     within 1e-4 relative, PER equal) and resumed from
     model_most_recent.ckpt against the unbroken run;
  10. the RNN backbone served (phases 10-12 each print their seconds as
     they end): a Synthesizer on configs/rnn_d.json (hidden 256, 2 layers,
     bidirectional LSTM encoders, location-sensitive attention, bf16),
     random weights from seed 0, the stop bias lowered by 100: 8 sentences
     -> tts -> asr, counts set to 0 just before and read just after (the
     RNN calls no attention kernel: 0 launches), ms per decode step, the
     asr_ids profile, peak memory; TINY f32 on the card against the CPU
     under 'lsa' and 'luong' (mels 1e-4, ids equal, each greedy choice
     leading by more than 1e-3 on the CPU);
  11. the RNN backbone trained: 2 steps of make_train_step with rnn_d's
     own train args (adam, multistep, B2, ae 1 / cm 2 / sp 1 / d 1) on
     synthetic batches at 816 frames / 304 tokens, counts set to 0 just
     before each step and read just after (0 forwards, 0 backward calls),
     losses and params finite, step seconds, peak memory; one TINY f32 RNN
     step on the card against the CPU (phase 8's tolerances);
  12. the CBHG vocoder: infer/vocoder.py::train_vocoder at
     configs/vocoder.json width (hidden 256, n_fft 2048, l1, adamw), 2
     steps at batch 8 on synthetic items padded to 816 frames; its
     checkpoint saved and loaded back exactly; make_mags on 3 dumps;
     Synthesizer(vocoder_pv=) on phase 4's flagship transformer serving 8
     TTS requests, counts set to 0 just before and read just after (4 bf16
     launches: one encoder call); a TINY f32 vocoder on the card against
     the CPU in eval and train mode (1e-4);
  13. one `{"kernels": [...]}` line (both routes, with their launches on
     the serve, train, loop, vocoder-serve and RNN paths), a
     `{"backward": ...}`, a `{"train": ...}`, a `{"loop": ...}`, an
     `{"rnn_serve": ...}`, an `{"rnn_train": ...}`, a `{"vocoder": ...}`
     and a `{"serve": ...}` line, and last `{"ok": true, "device": ...}`.
"""

import bisect
import itertools
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


# phase 6: the flash-attention backward at the train step's shapes; the
# default kv_lens run from Tk down to about a third of it
BWD_CASES = [
    Case("train_self_t304", bf16, 4, 304, 304, 4, 64, True, 40, "qkv"),
    Case("train_self_t816", bf16, 4, 816, 816, 4, 64, True, 41, "qkv"),
    Case("train_encoder_t816", bf16, 4, 816, 816, 4, 64, False, 42, "qkv"),
    Case("train_cross_304x816", bf16, 4, 304, 816, 4, 64, False, 43, "cross"),
    Case("train_cross_816x304", bf16, 4, 816, 304, 4, 64, False, 44, "cross"),
    Case("tiny_train_self_f32", f32, 2, 12, 12, 2, 16, True, 45, "qkv",
         lens=[12, 5]),
    Case("tiny_train_cross_f32", f32, 2, 12, 20, 2, 16, False, 46, "cross",
         lens=[20, 9]),
]
TRAIN_STEPS = 1
TEST_CONFIG = os.path.join(ROOT, "configs", "transformer_test.json")
RNN_CONFIG = os.path.join(ROOT, "configs", "rnn_d.json")
VOCODER_CONFIG = os.path.join(ROOT, "configs", "vocoder.json")
# phase 9's flagship loop: 1 warm-start step, one epoch of 1 joint step
# (phase 7 takes more at the same width), an eval before and after it (one
# batch of 2), every checkpoint role
LOOP_FLAGS = dict(synthetic_size=16, epochs=1, epoch_steps=1, sp_warmup_steps=1,
                  save_every=1, eval_batch_size=2)
# the train step's record_function ranges (unast_tpu_torch/train/steps.py)
TRAIN_PARTS = ("unast/train/ae", "unast/train/cm", "unast/train/sp",
               "unast/train/gen_update", "unast/train/d", "unast/backward",
               "unast/text_infer", "unast/speech_infer",
               "unast/lstm_discriminator", "unast/flash_attention_bwd")


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


def trace(fn, labels=()):
    """Run fn() once under torch.profiler (CPU and CUDA activity) and read
    its raw events: {"wall_s": the profiled run's wall time, "kernels":
    {name: [launches, device s]} of every device activity, "parts":
    {label: {"count", "host_s", "device_s"}}} for each record_function
    range named in `labels` (the port's 'unast/...' ranges): the ranges'
    wall time on the host, and the device time of the activities that
    start inside them. The device trails its host by little in the
    host-bound loops profiled here, so an activity counts where it
    starts. The device-side copies of the ranges are not activities."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels, device, ranges = {}, [], {label: [] for label in labels}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("unast/") or e.is_user_annotation():
                continue
            n_s = kernels.setdefault(name, [0, 0.0])
            n_s[0] += 1
            n_s[1] += dur * 1e-9
            device.append((start, dur))
        elif name in ranges:
            ranges[name].append((start, start + dur))
    device.sort()
    starts = [start for start, _ in device]
    done = list(itertools.accumulate((dur for _, dur in device), initial=0))

    def busy_ns(a, b):
        return done[bisect.bisect_left(starts, b)] - done[bisect.bisect_left(starts, a)]
    return {"wall_s": wall, "kernels": kernels, "parts": {
        label: {"count": len(spans),
                "host_s": sum(b - a for a, b in spans) * 1e-9,
                "device_s": sum(busy_ns(a, b) for a, b in spans) * 1e-9}
        for label, spans in ranges.items()}}


def device_ms(fn, symbols, iters: int, tries: int = 3):
    """Mean device time (ms) per call of fn(), from a trace of `iters`
    calls after one warm-up call: {symbol: ms} of the kernels whose name
    holds each of `symbols`, each launched once a call; with no symbols,
    {"": ms} of every kernel the call launches. A profiled window now and
    then records no device activity at all; such a window is profiled
    again, up to `tries` in all, and then fails."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        kernels = trace(lambda: [fn() for _ in range(iters)])["kernels"]
        found = {}
        for symbol in symbols or ("",):
            hits = [v for name, v in kernels.items() if symbol in name]
            found[symbol] = (sum(n for n, _ in hits), sum(s_ for _, s_ in hits))
        if all(n == iters if symbols else n >= iters for n, _ in found.values()):
            return {sym: s_ * 1e3 / iters for sym, (_, s_) in found.items()}
    raise SystemExit(f"profiler saw launches {({s: n for s, (n, _) in found.items()})} "
                     f"in {tries} windows, expected {iters} of each")


def device_summary(kernels, top: int = 8):
    """Device busy seconds, launches and the `top` kernels by device time
    ([name, ms, launches]) of a trace's kernels."""
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return (sum(s_ for _, s_ in kernels.values()), sum(n for n, _ in kernels.values()),
            [[name[:80], s_ * 1e3, n] for name, (n, s_) in ranked])


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
    return q, k, v, case_kv_lens(c)


def case_kv_lens(c: Case):
    """kv_lens of case c on the card: c.lens, or from Tk down to a third."""
    if c.lens is None:
        return torch.linspace(c.tk, max(1, c.tk // 3), c.b,
                              device="cuda").round().int()
    return torch.tensor(c.lens, dtype=torch.int32, device="cuda")


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


def sdpa_backward_call(q, k, v, kv_lens, causal, do):
    """fn() computing the flash backward's function with one PyTorch call:
    the autograd backward of scaled_dot_product_attention under the same
    kv_lens (and causal) mask, on inputs whose forward ran once before.
    Each call is one torch.autograd.grad over the retained graph: dq, dk
    and dv of <o, do>, SDPA's own backward kernels and nothing else."""
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    out = sdpa_call(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                    kv_lens, causal)()
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)


def fused_leaves(c: Case):
    """The fused projection(s) case c's q, k and v are views of, on the
    card: 'qkv' one [B, T, 3HD] tensor, 'cross' q [B, Tq, H, D] and one
    [B, Tk, 2HD] k/v tensor; and the case's kv_lens."""
    g = torch.Generator(device="cuda").manual_seed(c.seed)
    hd = c.h * c.d
    shapes = ([(c.b, c.tq, 3 * hd)] if c.layout == "qkv" else
              [(c.b, c.tq, c.h, c.d), (c.b, c.tk, 2 * hd)])
    leaves = [torch.randn(s, generator=g, device="cuda").to(c.dtype) for s in shapes]
    return leaves, case_kv_lens(c)


def qkv_views(c: Case, leaves):
    def heads(x):
        return [t.unflatten(-1, (c.h, c.d)) for t in torch.split(x, c.h * c.d, dim=-1)]
    return heads(leaves[0]) if c.layout == "qkv" else [leaves[0]] + heads(leaves[1])


def qkv_grads(c: Case, attn, leaves, kv_lens, w):
    """(dq, dk, dv) of sum(attn(q, k, v) * w), taken as the gradient of the
    fused leaves the views are cut from, then cut the same way."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    out = attn(*qkv_views(c, xs), kv_lens, causal=c.causal)
    grads = torch.autograd.grad((out.float() * w).sum(), xs)
    return qkv_views(c, grads)


def backward_bound(q, kv_lens, causal):
    """Least time (ms) the card could take for one flash backward on these
    inputs, and what bounds it: five products (S, dV, dP, dQ, dK) over the
    (query, key) pairs this data keeps, at the bf16 tensor-core rate, or
    for float32 as three TF32 products each (split TF32, the forward's
    convention), against the bytes of q, o, dO and dQ and of the kept k, v,
    dK and dV rows, each moved once."""
    b, tq, h, d = q.shape
    lens = kv_lens.cpu().numpy().astype(np.int64)
    rows = np.arange(tq)
    pairs = sum(int(np.minimum(rows + 1, n).sum()) if causal else tq * int(n)
                for n in lens)
    flops = 5 * 2 * h * d * pairs
    t_ops = (flops / H100_BF16_FLOPS if q.dtype == torch.bfloat16
             else 3 * flops / H100_TF32_FLOPS)
    nbytes = q.element_size() * (4 * q.numel() + 4 * h * d * int(lens.sum())) + 4 * b
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def backward_case(c: Case):
    """Gradients through flash_attention (kernel forward, plain backward)
    against autograd through flash_attention_plain on case c, and the time
    of the backward (flash_attention_bwd_plain) alone: per call over
    back-to-back calls (CUDA events) and its kernels' device time."""
    from unast_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_bwd_plain,
                                               flash_attention_plain)
    leaves, kv_lens = fused_leaves(c)
    w = torch.randn((c.b, c.tq, c.h, c.d), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(c.seed + 1))
    got = qkv_grads(c, flash_attention, leaves, kv_lens, w)
    want = qkv_grads(c, flash_attention_plain, leaves, kv_lens, w)
    rel = 1e-4 if c.dtype == torch.float32 else 2.0 ** -6
    errs = {}
    ok = True
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - r.float()).abs().max())
        top = float(r.float().abs().max())
        errs[name] = {"max_abs_err": err, "max_abs_ref": top}
        ok = ok and err <= rel * top
    q, k, v = qkv_views(c, leaves)
    o = flash_attention(q, k, v, kv_lens, causal=c.causal)
    do = w.to(c.dtype)
    iters = 20 if c.tq * c.tk >= 816 * 304 else 50
    bound_ms, bound_by = backward_bound(q, kv_lens, c.causal)

    def bwd():
        return flash_attention_bwd_plain(q, k, v, kv_lens, c.causal, o, do)
    library = sdpa_backward_call(q, k, v, kv_lens, c.causal, do)
    return {
        "case": c.name, "dtype": str(c.dtype).replace("torch.", ""),
        "layout": c.layout, "shape": [c.b, c.tq, c.tk, c.h, c.d],
        "causal": c.causal, "kv_lens": kv_lens.tolist(), "grads": errs,
        "bound_rel_to_max": rel, "ok": ok,
        "bwd_ms": cuda_ms(bwd, iters), "bwd_device_ms": device_ms(bwd, (), iters)[""],
        "bwd_bound_ms": bound_ms, "bwd_bound_by": bound_by,
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": device_ms(library, (), iters)[""],
        "fwd_ms": cuda_ms(lambda: flash_attention(q, k, v, kv_lens,
                                                  causal=c.causal), iters),
    }


def train_batches(rng, args, cfg, b, text_len, mel_len, device):
    """Synthetic stacked micro-batches {objective: (text [n, B, Tt], mel
    [n, B, Tm, M], text_len, mel_len)}: lengths uniform in [Tt/4, Tt] and
    [Tm/4, Tm] with row 0 full, tokens 3..45 with EOS at len - 1 and PAD
    after, mel normal and zero past len."""
    out = {}
    for name in ("ae", "cm", "sp", "d"):
        n = getattr(args, f"{name}_steps")
        tl = rng.integers(text_len // 4, text_len + 1, size=(n, b))
        ml = rng.integers(mel_len // 4, mel_len + 1, size=(n, b))
        tl[:, 0], ml[:, 0] = text_len, mel_len
        text = rng.integers(3, 46, size=(n, b, text_len))
        pos = np.arange(text_len)
        text = np.where(pos == tl[..., None] - 1, 2, text)
        text = np.where(pos >= tl[..., None], 0, text)
        mel = rng.normal(size=(n, b, mel_len, cfg.num_mels)).astype(np.float32)
        mel *= (np.arange(mel_len) < ml[..., None])[..., None]
        out[name] = tuple(torch.from_numpy(x).to(device) for x in (
            text.astype(np.int64), mel, tl.astype(np.int64), ml.astype(np.int64)))
    return out


def compare_train_steps(old, a, b, lr):
    """Largest differences between two results (new TrainState, metrics) of
    one step from the same params `old`: metrics (relative), BN state,
    Adam's first moments (relative to 1e-4 |b| + 1e-5 of the tree's
    largest) and the normalised update (new - old) / lr where b's first
    moment is above 1e-7."""
    from unast_tpu_torch.train.optim import tree_paths as flat
    (ta, ma), (tb, mb) = a, b
    out = {"metrics_rel": max(abs(float(ma[k]) - float(mb[k])) / abs(float(mb[k]))
                              for k in mb),
           "state_abs": max(float((x.cpu() - flat(tb.net_state)[k].cpu()).abs().max())
                            for k, x in flat(ta.net_state).items())}
    mu = {}
    for name, oa, ob in (("gen", ta.gen_opt, tb.gen_opt), ("disc", ta.disc_opt, tb.disc_opt)):
        fa, fb = flat(oa.mu), flat(ob.mu)
        top = max(float(x.abs().max()) for x in fb.values())
        out[f"{name}_mu_scaled"] = max(float(((fa[k].cpu() - x.cpu()).abs()
                                              / (1e-4 * x.cpu().abs() + 1e-5 * top)).max())
                                       for k, x in fb.items())
        prefix = "" if name == "gen" else "discriminator/"
        mu.update({prefix + k: x.cpu() for k, x in fb.items()})
    fo, fa, fb = flat(old), flat(ta.params), flat(tb.params)
    out["update_abs"] = max(
        float(torch.where(mu[k].abs() > 1e-7,
                          (fa[k].cpu() - fb[k].cpu()) / lr, 0.0).abs().max())
        for k in fo)
    return out


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
    t = time.perf_counter()
    syn.asr_ids(mels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    traced = trace(lambda: syn.asr_ids(mels))
    steps = sum(syn.last_decode_steps)
    busy, launches, top = device_summary(traced["kernels"])
    return {
        "wall_s": wall, "wall_profiled_s": traced["wall_s"],
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "decode_steps": steps, "kernel_launches": launches,
        "kernels_per_step": launches / max(1, steps), "top_kernels": top,
    }


def loop_args(config, **flags):
    """The trainer's namespace for `config` with --synthetic and `flags`, as
    `python -m unast_tpu_torch.train.loop` parses them."""
    from unast_tpu_torch.train.config import parse_with_config
    argv = ["--config", config, "--synthetic"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return parse_with_config(argv)


def metrics_records(path):
    """A metrics.jsonl as {"<step>/<key>": value}, without the times."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out.update({f"{rec['step']}/{k}": v for k, v in rec.items()
                        if k not in ("step", "time")})
    return out


def compare_records(a, b, steps=None):
    """Largest relative difference of two metrics.jsonl record sets over
    their non-PER values (of `steps` only, if given), and whether their
    keys and PERs are equal."""
    keep = lambda r: {k: v for k, v in r.items()
                      if steps is None or int(k.split("/")[0]) in steps}
    a, b = keep(a), keep(b)
    pers = [k for k in b if k.endswith("eval/per")]
    return {"keys_equal": a.keys() == b.keys() and len(b) > 0,
            "per_equal": a.keys() == b.keys() and all(a[k] == b[k] for k in pers),
            "max_rel_err": max((abs(a[k] - v) / max(abs(v), 1e-30) for k, v in b.items()
                                if k in a and k not in pers), default=float("inf"))}


class LoopProbe:
    """For one train() call: wraps the loop module's make_train_step (so
    every step call), evaluate and save_ckp, recording per call its kind,
    its seconds (synchronised before and after) and the flash counters'
    deltas, and for an eval its PER and mean losses; restores them on
    exit."""

    def __init__(self, loop, fa):
        self.loop, self.fa, self.calls = loop, fa, []

    def _wrap(self, kind, fn):
        fa = self.fa

        def run(*a, **kw):
            before = (fa.launches_bf16, fa.launches_f32, fa.backward_calls)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec = {"kind": kind, "s": time.perf_counter() - t,
                   "launches_bf16": fa.launches_bf16 - before[0],
                   "launches_f32": fa.launches_f32 - before[1],
                   "backward_calls": fa.backward_calls - before[2]}
            if kind == "eval":
                rec["per"] = out[0]
                rec["losses"] = {k: float(np.mean(v)) for k, v in out[1].items()}
            self.calls.append(rec)
            return out
        return run

    def __enter__(self):
        L = self.loop
        self.saved = (L.make_train_step, L.evaluate, L.save_ckp)
        make = L.make_train_step
        L.make_train_step = lambda cfg, args: self._wrap(
            "step" if args.ae_steps or args.cm_steps else "warm_start_step",
            make(cfg, args))
        L.evaluate = self._wrap("eval", L.evaluate)
        L.save_ckp = self._wrap("save", L.save_ckp)
        return self

    def __exit__(self, *exc):
        self.loop.make_train_step, self.loop.evaluate, self.loop.save_ckp = self.saved

    def of(self, kind, key):
        return [c[key] for c in self.calls if c["kind"] == kind]


def loop_expected(loop, args, cfg, epochs_run, evals):
    """(bf16 or f32 flash forwards, backward calls) each call kind of
    train(args) makes per the code (train/steps.py's counts), and in all."""
    from unast_tpu_torch.train.steps import (flash_calls_per_eval_batch,
                                             flash_calls_per_step)
    wargs, wcfg = loop._warm_start(args, cfg)
    n_val = max(2, args.synthetic_size // 8)
    per_kind = {"warm_start_step": flash_calls_per_step(wcfg, wargs),
                "step": flash_calls_per_step(cfg, args),
                "eval": (flash_calls_per_eval_batch(cfg)
                         * (n_val // loop._fit_eval_bs(n_val, args.eval_batch_size)), 0),
                "save": (0, 0)}
    counts = {"warm_start_step": args.sp_warmup_steps,
              "step": args.epoch_steps * epochs_run, "eval": evals}
    total = [sum(per_kind[k][i] * n for k, n in counts.items()) for i in (0, 1)]
    return per_kind, total


def flagship_loop(fa):
    """Phase 9: train() at the flagship width (bf16, flash) on the synthetic
    corpus, then its checkpoint loaded back, served and test-evaluated."""
    import tempfile
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.nn import cast_weights
    from unast_tpu_torch.train import loop
    from unast_tpu_torch.train.checkpoint import load_ckp
    from unast_tpu_torch.train.optim import tree_paths
    from unast_tpu_torch.train.steps import init_train_state

    def same(a, b):
        pa, pb = tree_paths(a), tree_paths(b)
        return pa.keys() == pb.keys() and all(torch.equal(x, pb[k]) for k, x in pa.items())

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        args = loop_args(CONFIG, attn_impl="flash", checkpoint_path=ck, tb_log_path="",
                         out_test_dir=os.path.join(tmp, "test_out"), **LOOP_FLAGS)
        cfg = loop.model_config_from_args(args)
        per_kind, expected = loop_expected(loop, args, cfg, args.epochs, args.epochs + 1)
        reset_launch_counts(fa)
        bwd0 = fa.backward_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with LoopProbe(loop, fa) as probe:
            t = time.perf_counter()
            ts, _ = loop.train(args)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        seen = [fa.launches_bf16, fa.backward_calls - bwd0]
        assert seen == expected and fa.launches_f32 == 0, (seen, expected, fa.launches_f32)
        for c in probe.calls:
            assert [c["launches_bf16"], c["backward_calls"]] == list(per_kind[c["kind"]]), c
        records = metrics_records(os.path.join(ck, "metrics.jsonl"))
        assert records and all(np.isfinite(v) for v in records.values()), records
        roles = sorted(f for f in os.listdir(ck) if f.endswith(".ckpt"))
        assert roles == ["model_0.ckpt", "model_best.ckpt", "model_most_recent.ckpt",
                         "model_temporary.ckpt"], roles

        best = os.path.join(ck, "model_best.ckpt")
        template = init_train_state(torch.Generator().manual_seed(0), cfg, args,
                                    args.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, loaded, _ = load_ckp(best, template)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        t = time.perf_counter()
        syn = Synthesizer.from_checkpoint(ck, args)
        from_checkpoint_s = time.perf_counter() - t
        equal = (same(loaded.params, ts.params) and same(loaded.net_state, ts.net_state)
                 and loaded.step == ts.step
                 and same(syn.params, cast_weights(ts.params, cfg.dtype))
                 and same(syn.net_state, ts.net_state))
        assert equal, "the checkpoint does not hold the loop's final state"
        t = time.perf_counter()
        wavs = syn.tts(SENTENCES[:2])
        texts = syn.asr(wavs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        assert len(wavs) == len(texts) == 2 and all(
            w.ndim == 1 and len(w) > 0 and np.isfinite(w).all() for w in wavs)

        args.is_eval_test, args.load_path = True, best
        reset_launch_counts(fa)
        t = time.perf_counter()
        test_per, d_score = loop.evaluate_main(args)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t
        with open(os.path.join(args.out_test_dir, "text_preds.json")) as f:
            n_preds = len(json.load(f))
        n_mels = len(os.listdir(os.path.join(args.out_test_dir, "mels")))
        n_test = max(2, args.synthetic_size // 8)
        assert n_preds == n_mels == n_test and np.isfinite(test_per), (n_preds, n_mels)
        assert fa.launches_bf16 == per_kind["eval"][0], (fa.launches_bf16, per_kind)
        return {
            "config": os.path.relpath(CONFIG, ROOT), "flags": LOOP_FLAGS,
            "attn_impl": cfg.attn_impl, "compute_dtype": cfg.compute_dtype,
            "train_s": train_s,
            "sp_warmup_s": sum(probe.of("warm_start_step", "s")),
            "epoch_s": sum(probe.of("step", "s")),
            "steps_per_s": args.epoch_steps / sum(probe.of("step", "s")),
            "step_s": probe.of("step", "s"),
            "eval_s": probe.of("eval", "s"), "per": probe.of("eval", "per"),
            "eval_losses": probe.of("eval", "losses"),
            "save_s": probe.of("save", "s"), "load_s": load_s,
            "from_checkpoint_s": from_checkpoint_s,
            "ckpt_bytes": os.path.getsize(best),
            "max_memory_allocated_bytes": peak,
            "launches": {"per_call_expected": per_kind, "expected": expected,
                         "seen": seen, "calls": probe.calls},
            "metrics_jsonl": records,
            "from_checkpoint_equal": equal,
            "serve_2_tts_2_asr_s": serve_s, "serve_texts": texts,
            "evaluate_main": {"s": test_s, "per": test_per, "d_score": d_score,
                              "utterances": n_preds,
                              "launches_bf16": per_kind["eval"][0]},
        }


def tiny_loop_walk(fa):
    """Phase 9, float32: train() at configs/transformer_test.json (d 64, 1
    layer, flash, so the float32 kernel) on the card against the same run
    on the CPU, 2 epochs, in objective_eval_mode with the SpecAugment
    spans at 0 (no draw then reaches a result, so the two devices' streams
    do not matter); and on the card, 1 epoch then a resume to 2 from
    model_most_recent.ckpt against the unbroken run."""
    import tempfile
    from unast_tpu_torch.train import loop
    make_cfg = loop.model_config_from_args
    loop.model_config_from_args = lambda a: make_cfg(a).replace(
        spec_freq_mask=0, spec_time_mask=0)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def run(name, device, epochs, **kw):
                args = loop_args(TEST_CONFIG, attn_impl="flash", device=device,
                                 epochs=epochs, sp_warmup_steps=1,
                                 checkpoint_path=os.path.join(tmp, name), **kw)
                args.objective_eval_mode = True
                t = time.perf_counter()
                loop.train(args)
                return (metrics_records(os.path.join(tmp, name, "metrics.jsonl")),
                        time.perf_counter() - t, args)
            on_cpu, cpu_s, _ = run("cpu", "cpu", 2)
            reset_launch_counts(fa)
            bwd0 = fa.backward_calls
            on_gpu, gpu_s, args = run("gpu", "cuda", 2)
            seen = [fa.launches_f32, fa.backward_calls - bwd0]
            _, expected = loop_expected(loop, args, loop.model_config_from_args(args),
                                        2, 3)
            run("resumed", "cuda", 1)
            resumed, _, _ = run("resumed", "cuda", 2, auto_resume="true")
    finally:
        loop.model_config_from_args = make_cfg
    out = {"config": os.path.relpath(TEST_CONFIG, ROOT), "cpu_s": cpu_s, "gpu_s": gpu_s,
           "launches_f32": seen[0], "backward_calls": seen[1],
           "expected": expected, "launches_bf16": fa.launches_bf16,
           "card_vs_cpu": compare_records(on_gpu, on_cpu),
           "resume_vs_unbroken": compare_records(resumed, on_gpu, steps={3, 4})}
    # float32 on both; metrics 1e-4 relative (tests/test_torch_loop.py's
    # tolerance against the JAX loop), PER equal
    out["ok"] = all(c["keys_equal"] and c["per_equal"] and c["max_rel_err"] <= 1e-4
                    for c in (out["card_vs_cpu"], out["resume_vs_unbroken"]))
    assert out["ok"], out
    assert seen == expected and out["launches_bf16"] == 0, out
    return out


def rnn_text_margins(p, s, cfg, enc_outputs, pad, ids):
    """Least top-1 minus top-2 logit of each row over the steps of a greedy
    RNN text decode that followed `ids` [B, n] (text_rnn_infer's
    arithmetic, on the device of the weights), up to the row's length in
    `lens`."""
    from unast_tpu_torch import nn
    from unast_tpu_torch.models import modules as M, networks as N, rnn as R
    (hc, enc_out), b = enc_outputs, ids.shape[0]
    ectx = nn.Ctx.eval()
    bufs = M.text_prenet_step_init(p["prenet"], b, cfg, enc_out.dtype, enc_out.device)
    emb = M.text_embed(p["prenet"], ectx, torch.full((b,), 1, device=enc_out.device), cfg)
    attn = N._init_attn_state(p, cfg, enc_out)
    gaps = []
    for i in range(ids.shape[1]):
        x, bufs = M.text_prenet_step(p["prenet"], s["prenet"], ectx, emb, bufs, cfg)
        out, hc, attn = R.rnn_decoder_step(p["decoder"], ectx, x, hc, enc_out, pad,
                                           attn, 0.0, cfg.d_attn)
        top2 = torch.topk(M.text_postnet(p["postnet"], ectx, out, cfg).float(), 2).values
        gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        emb = M.text_embed(p["prenet"], ectx, torch.as_tensor(ids[:, i], device=enc_out.device),
                           cfg)
    return np.stack(gaps, axis=1)


def rnn_serve(fa):
    """Phase 10: a Synthesizer on configs/rnn_d.json (the RNN backbone,
    bf16) with random weights from seed 0 and the stop bias lowered by
    100: 8 sentences -> tts -> 8 waveforms -> asr, counts set to 0 just
    before and read just after (the RNN path calls no attention kernel);
    then TINY f32 on the card against the CPU under 'lsa' and 'luong'."""
    from unast_tpu_torch.audio.params import AudioParams
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import TINY, ModelConfig, networks, unast_init
    t_phase = time.perf_counter()
    cfg = ModelConfig.from_json(RNN_CONFIG)
    params, state = unast_init(torch.Generator().manual_seed(0), cfg)
    params["speech_m"]["postnet"]["stop_proj"]["b"] -= 100.0
    syn = Synthesizer(params, state, cfg)
    t = time.perf_counter()
    syn.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t
    reset_launch_counts(fa)
    bwd0 = fa.backward_calls
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wavs = syn.tts(SENTENCES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tts_steps = sum(syn.last_decode_steps)
    texts = syn.asr(wavs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    asr_steps = sum(syn.last_decode_steps)
    launches = [fa.launches, fa.backward_calls - bwd0]
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    mels = syn.tts_mels(SENTENCES)
    torch.cuda.synchronize()
    tts_mels_s = time.perf_counter() - t
    asr_profile = profile_asr(syn, mels)
    assert len(wavs) == len(texts) == len(SENTENCES)
    for w in wavs:
        assert w.ndim == 1 and len(w) > 0 and np.isfinite(w).all(), w.shape
    assert all(np.isfinite(m).all() for m in mels)
    assert launches == [0, 0], launches

    tiny = {}
    rng = np.random.default_rng(1)
    asr_mels = [rng.uniform(0, 1, (n, 80)).astype(np.float32) for n in (20, 11)]
    short = ["hi there", "ok", "go now"]
    for attn in ("lsa", "luong"):
        tcfg = TINY.replace(model_type="rnn", d_attn=attn, attn_dim=16)
        tp, ts = unast_init(torch.Generator().manual_seed(0), tcfg)
        tp["speech_m"]["postnet"]["stop_proj"]["b"] -= 100.0
        kw = dict(audio_params=AudioParams(n_iter=2), text_buckets=(8, 16),
                  mel_buckets=(16, 24), max_batch=4)
        on_gpu = Synthesizer(tp, ts, tcfg, device="cuda", **kw)
        on_cpu = Synthesizer(tp, ts, tcfg, device="cpu", **kw)
        reset_launch_counts(fa)
        gpu_mels, gpu_ids = on_gpu.tts_mels(short), on_gpu.asr_ids(asr_mels)
        n_launch = fa.launches
        cpu_ids = on_cpu.asr_ids(asr_mels)
        mel_err = max(float(np.abs(a - b).max()) for a, b in
                      zip(gpu_mels, on_cpu.tts_mels(short)))
        padded = np.zeros((2, 24, 80), np.float32)
        for i, m in enumerate(asr_mels):
            padded[i, :len(m)] = m
        from unast_tpu_torch import nn
        with torch.no_grad():
            (enc, mask), _ = networks.speech_encode(
                on_cpu.params["speech_m"], on_cpu.net_state["speech_m"], nn.Ctx.eval(), tcfg,
                torch.from_numpy(padded), torch.tensor([len(m) for m in asr_mels]))
            ids = np.stack([np.pad(i, (0, 16 - len(i))) for i in cpu_ids])
            gaps = rnn_text_margins(on_cpu.params["text_m"], on_cpu.net_state["text_m"],
                                    tcfg, enc, mask, ids)
        least = min(float(g[:len(i)].min()) for g, i in zip(gaps, cpu_ids))
        ids_equal = all(np.array_equal(a, b) for a, b in zip(gpu_ids, cpu_ids))
        tiny[attn] = {"tts_mels_max_abs_err": mel_err, "asr_ids_equal": ids_equal,
                      "least_greedy_margin_cpu": least, "flash_launches": n_launch}
        # float32 on both sides; every greedy choice leads by the margin
        # printed (above 1e-3 for the ids to be held equal)
        assert mel_err <= 1e-4 and ids_equal and n_launch == 0, tiny[attn]
        assert least > 1e-3, tiny[attn]
    n = len(SENTENCES)
    return {
        "config": os.path.relpath(RNN_CONFIG, ROOT), "compute_dtype": cfg.compute_dtype,
        "hidden": cfg.hidden, "layers": cfg.num_layers, "d_attn": cfg.d_attn,
        "attn_dim": cfg.attn_dim, "requests": n, "warmup_s": warmup_s,
        "tts_batch_s": t1 - t0, "tts_utt_per_s": n / (t1 - t0),
        "tts_mels_s": tts_mels_s, "tts_decode_steps": tts_steps,
        "tts_ms_per_step": 1e3 * tts_mels_s / max(1, tts_steps),
        "asr_batch_s": t2 - t1, "asr_decode_steps": asr_steps,
        "asr_ms_per_step": 1e3 * asr_profile["wall_s"] / max(1, asr_profile["decode_steps"]),
        "wav_samples": [len(w) for w in wavs],
        "flash_launches": launches[0], "backward_calls": launches[1],
        "asr_ids_profile": asr_profile, "max_memory_allocated_bytes": peak,
        "tiny_gpu_vs_cpu": tiny, "phase_s": time.perf_counter() - t_phase,
    }


def rnn_train(fa):
    """Phase 11: 2 steps of make_train_step on configs/rnn_d.json with its
    own train args (adam, multistep, B2, ae 1 / cm 2 / sp 1 / d 1) on
    synthetic batches at 816 frames / 304 tokens (numpy seed 0), random
    weights from seed 0, counts set to 0 just before each step and read
    just after; then one TINY f32 RNN step on the card against the CPU."""
    from unast_tpu_torch.models import TINY, ModelConfig, networks, unast_init
    from unast_tpu_torch.nn import tree_to
    from unast_tpu_torch.train import init_train_state, make_train_step, train_state
    from unast_tpu_torch.train.config import train_args
    from unast_tpu_torch.train.optim import tree_paths
    from unast_tpu_torch.train.steps import ZERO_DROPOUTS, zero_fixed_dropouts
    t_phase = time.perf_counter()
    cfg = ModelConfig.from_json(RNN_CONFIG)
    args = train_args(RNN_CONFIG)
    ts = init_train_state(torch.Generator().manual_seed(0), cfg, args)
    batches = train_batches(np.random.default_rng(0), args, cfg, args.train_batch_size,
                            args.data_text_len, args.data_mel_len, "cuda")
    step_fn = make_train_step(cfg, args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    decoders = (networks.text_rnn_infer, networks.speech_rnn_infer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(2):
        reset_launch_counts(fa)
        before = [fa.backward_calls] + [d.steps for d in decoders]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ts, metrics = step_fn(ts, gen, batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        after = [fa.backward_calls] + [d.steps for d in decoders]
        steps.append({"step": i, "s": seconds,
                      "metrics": {k: float(v) for k, v in metrics.items()},
                      "decode_steps": {"text": after[1] - before[1],
                                       "speech": after[2] - before[2]},
                      "flash_launches": fa.launches,
                      "backward_calls": after[0] - before[0]})
    peak = torch.cuda.max_memory_allocated()
    for s_ in steps:
        assert all(np.isfinite(v) for v in s_["metrics"].values()), s_["metrics"]
        assert s_["flash_launches"] == 0 and s_["backward_calls"] == 0, s_
    nonfinite = [k for k, x in tree_paths(ts.params).items()
                 if not bool(torch.isfinite(x).all())]
    assert not nonfinite and ts.step == 2, nonfinite

    tiny_t = TINY.replace(model_type="rnn", e_bi=True, d_attn="lsa", attn_dim=16,
                          use_discriminator=True, disc_num_layers=1, **ZERO_DROPOUTS)
    targs = train_args(os.path.join(ROOT, "configs", "rnn_d_test.json"))
    tp0, ts0 = unast_init(torch.Generator().manual_seed(0), tiny_t)
    tb = train_batches(np.random.default_rng(1), targs, tiny_t, 2, 12, 20, "cpu")
    tiny_step = make_train_step(tiny_t, targs)
    with zero_fixed_dropouts():
        on_cpu = tiny_step(train_state(tp0, ts0, tiny_t, targs),
                           torch.Generator().manual_seed(0), tb)
        reset_launch_counts(fa)
        on_gpu = tiny_step(train_state(tree_to(tp0, "cuda"), tree_to(ts0, "cuda"),
                                       tiny_t, targs),
                           torch.Generator(device="cuda").manual_seed(0),
                           {k: tuple(x.cuda() for x in v) for k, v in tb.items()})
        torch.cuda.synchronize()
    tiny = {"flash_launches": fa.launches,
            **compare_train_steps(tp0, on_gpu, on_cpu, targs.lr)}
    # as phase 8: metrics 1e-4 relative, BN state 1e-5, first moments within
    # 1e-4 relative + 1e-5 of the largest, normalised updates 1e-3
    tiny["ok"] = (tiny["metrics_rel"] <= 1e-4 and tiny["state_abs"] <= 1e-5
                  and tiny["gen_mu_scaled"] <= 1 and tiny["disc_mu_scaled"] <= 1
                  and tiny["update_abs"] <= 1e-3 and tiny["flash_launches"] == 0)
    assert tiny["ok"], tiny
    return {
        "config": os.path.relpath(RNN_CONFIG, ROOT), "compute_dtype": cfg.compute_dtype,
        "optim_type": args.optim_type, "sched_type": args.sched_type,
        "batch": args.train_batch_size, "text_len": args.data_text_len,
        "mel_len": args.data_mel_len,
        "micro_batches": {k: getattr(args, f"{k}_steps") for k in ("ae", "cm", "sp", "d")},
        "first_step_s": steps[0]["s"], "later_step_s": steps[1]["s"],
        "max_memory_allocated_bytes": peak, "steps": steps,
        "tiny_gpu_vs_cpu": tiny, "phase_s": time.perf_counter() - t_phase,
    }


def vocoder_phase(fa, flag_params, flag_state, flag_cfg):
    """Phase 12: infer/vocoder.py::train_vocoder at configs/vocoder.json
    width (hidden 256, n_fft 2048, l1, adamw) for 2 steps of batch 8 on 9
    synthetic items padded to 816 frames (one held out); the checkpoint
    saved and loaded back exactly; make_mags on 3 dumps; then
    Synthesizer(vocoder_pv=) on the flagship transformer of phase 4 (stop
    bias lowered by 100) serving 8 TTS requests, counts set to 0 just
    before and read just after; and a TINY f32 vocoder on the card against
    the CPU."""
    import tempfile
    from unast_tpu_torch import nn
    from unast_tpu_torch.data.dataset import SyntheticSpeechDataset
    from unast_tpu_torch.infer import vocoder as V
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import ModelConfig, unast
    from unast_tpu_torch.nn import tree_to
    from unast_tpu_torch.train.config import parse_with_config
    from unast_tpu_torch.train.optim import tree_paths
    t_phase = time.perf_counter()
    args = parse_with_config(["--config", VOCODER_CONFIG, "--synthetic_size", "9"])
    args.hidden_size, args.n_fft = args.hidden, 2048   # as infer/vocoder.py's main
    ds = SyntheticSpeechDataset(size=args.synthetic_size, seed=args.seed)
    t = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    data_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    step = V.make_vocoder_step
    V.make_vocoder_step = lambda a, tx: _timed(step(a, tx), step_s)
    try:
        params, vstate, losses = V.train_vocoder(args, ds, epochs=2)
    finally:
        V.make_vocoder_step = step
    train_peak = torch.cuda.max_memory_allocated()
    assert len(step_s) == 2 and np.isfinite(losses).all(), (step_s, losses)
    assert all(bool(torch.isfinite(x).all()) for x in tree_paths(params).values())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vocoder.ckpt")
        t = time.perf_counter()
        V.save_vocoder_ckpt(params, vstate, path)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        lp, ls = V.load_vocoder_ckpt(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        ckpt_bytes = os.path.getsize(path)
        equal = all(
            pa.keys() == pb.keys() and all(torch.equal(x, pb[k]) for k, x in pa.items())
            for pa, pb in ((tree_paths(lp), tree_paths(params)),
                           (tree_paths(ls), tree_paths(vstate))))
        assert equal, "the vocoder checkpoint does not hold the trained trees"
        rng = np.random.default_rng(2)
        lens = (300, 500, 815)
        for i, n in enumerate(lens):
            np.save(os.path.join(tmp, f"u{i}.pt"), rng.uniform(size=(n, 80)).astype(np.float32))
        t = time.perf_counter()
        V.make_mags(lp, ls, tmp, [f"u{i}" for i in range(3)], mel_len=args.data_mel_len)
        make_mags_s = time.perf_counter() - t
        for i, n in enumerate(lens):
            m = np.load(os.path.join(tmp, f"u{i}.mag.npy"))
            assert m.shape == (n, 1025) and np.isfinite(m).all(), m.shape

    syn = Synthesizer(flag_params, flag_state, flag_cfg, vocoder_pv=(lp, ls))
    syn.tts(SENTENCES[:1])
    reset_launch_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    wavs = syn.tts(SENTENCES)
    torch.cuda.synchronize()
    tts_s = time.perf_counter() - t
    launches = [fa.launches_bf16, fa.launches_f32]
    encoder_calls = len(syn.last_decode_steps)
    serve_peak = torch.cuda.max_memory_allocated()
    for w in wavs:
        assert w.ndim == 1 and len(w) > 0 and np.isfinite(w).all(), w.shape
    assert launches == [flag_cfg.num_layers * encoder_calls, 0], (launches, encoder_calls)
    with torch.inference_mode():
        mel_b = torch.rand((8, 815, 80), device="cuda").to(flag_cfg.dtype)
        torch.cuda.synchronize()
        t = time.perf_counter()
        unast.vocoder(*syn.vocoder_pv, nn.Ctx.eval(), mel_b)
        torch.cuda.synchronize()
    cbhg_s = time.perf_counter() - t

    vp, vs = unast.vocoder_init(torch.Generator().manual_seed(0), ModelConfig(hidden=16), 2048)
    mel = torch.from_numpy(np.random.default_rng(3).uniform(size=(2, 40, 80)).astype(np.float32))
    tiny = {}
    for mode in ("eval", "train"):
        ctx = nn.Ctx(train=mode == "train")
        cpu, cpu_s = unast.vocoder(vp, vs, ctx, mel)
        gpu, gpu_s = unast.vocoder(tree_to(vp, "cuda"), tree_to(vs, "cuda"), ctx, mel.cuda())
        tiny[mode] = {"max_abs_err": float((gpu.detach().cpu() - cpu.detach()).abs().max()),
                      "state_abs_err": max(float((a.cpu() - tree_paths(cpu_s)[k]).abs().max())
                                           for k, a in tree_paths(gpu_s).items())}
    # float32 on both sides; outputs of order 1
    assert all(v["max_abs_err"] <= 1e-4 and v["state_abs_err"] <= 1e-4
               for v in tiny.values()), tiny
    return {
        "config": os.path.relpath(VOCODER_CONFIG, ROOT), "hidden": args.hidden_size,
        "n_fft": args.n_fft, "loss_type": getattr(args, "loss_type", "l1"),
        "optim_type": args.optim_type, "batch": args.train_batch_size,
        "mel_len": args.data_mel_len, "synthetic_items": len(ds), "data_s": data_s,
        "step_s": step_s, "epoch_losses": losses, "train_max_memory_allocated_bytes": train_peak,
        "ckpt_bytes": ckpt_bytes, "save_s": save_s, "load_s": load_s, "load_equal": equal,
        "make_mags_s": make_mags_s, "make_mags_lens": list(lens),
        "serve_config": os.path.relpath(CONFIG, ROOT), "tts_batch_s": tts_s,
        "tts_utt_per_s": len(SENTENCES) / tts_s, "tts_decode_steps": sum(syn.last_decode_steps),
        "cbhg_b8_t815_s": cbhg_s, "flash_launches_bf16": launches[0],
        "flash_launches_f32": launches[1], "encoder_calls": encoder_calls,
        "serve_max_memory_allocated_bytes": serve_peak,
        "wav_samples": [len(w) for w in wavs], "tiny_gpu_vs_cpu": tiny,
        "phase_s": time.perf_counter() - t_phase,
    }


def _timed(fn, seconds):
    """fn, appending each call's synchronised seconds to `seconds`."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from unast_tpu_torch.ops import attention, build
    from unast_tpu_torch.audio.params import AudioParams
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import TINY, ModelConfig, networks, unast_init
    from unast_tpu_torch.nn import tree_to
    from unast_tpu_torch.train import init_train_state, make_train_step, train_state
    from unast_tpu_torch.train.config import train_args
    from unast_tpu_torch.train.optim import tree_paths
    from unast_tpu_torch.train.steps import (ZERO_DROPOUTS, flash_calls_per_step,
                                             zero_fixed_dropouts)

    phase_ends = [(0, time.perf_counter())]
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

    phase_ends.append((1, time.perf_counter()))
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

    phase_ends.append((2, time.perf_counter()))
    # 3. every kernel against its plain version
    cases = [flash_case(c) for c in FLASH_CASES]
    bad = [c for c in cases if not c["ok"]]

    phase_ends.append((3, time.perf_counter()))
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

    phase_ends.append((4, time.perf_counter()))
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

    phase_ends.append((5, time.perf_counter()))
    # 6. the flash-attention backward against autograd through the plain
    # version, at the train step's shapes
    bwd_cases = [backward_case(c) for c in BWD_CASES]
    bad += [c for c in bwd_cases if not c["ok"]]

    phase_ends.append((6, time.perf_counter()))
    # 7. the second main path: train steps at flagship width. The JSON's
    # fast_prng picks JAX's hardware RBG generator; it means nothing here.
    args = train_args(CONFIG)
    fwd_per_step, bwd_per_step = flash_calls_per_step(cfg, args)
    ts = init_train_state(torch.Generator().manual_seed(0), cfg, args)
    batches = train_batches(np.random.default_rng(0), args, cfg,
                            args.train_batch_size, args.data_text_len,
                            args.data_mel_len, "cuda")
    step_fn = make_train_step(cfg, args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fa = attention.flash_attention
    decoders = (networks.text_tr_infer, networks.speech_tr_infer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def train_step():
        """One step on ts; its record, with the counts set to 0 before."""
        nonlocal ts
        reset_launch_counts(fa)
        before = [fa.backward_calls] + [d.steps for d in decoders]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ts, metrics = step_fn(ts, gen, batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        after = [fa.backward_calls] + [d.steps for d in decoders]
        return {"s": seconds, "metrics": {k: float(v) for k, v in metrics.items()},
                "decode_steps": {"text": after[1] - before[1],
                                 "speech": after[2] - before[2]},
                "flash_launches_bf16": fa.launches_bf16,
                "flash_launches_f32": fa.launches_f32,
                "backward_calls": after[0] - before[0]}
    for i in range(TRAIN_STEPS):
        steps.append({"step": i, **train_step()})
    train_peak = torch.cuda.max_memory_allocated()
    train_launches_bf16 = sum(s_["flash_launches_bf16"] for s_ in steps)
    # a later step under the profiler: where a step's time goes. Its wall
    # includes the profiler's own host work, so the idle share read
    # against it is an upper bound.
    profiled = {}
    traced = trace(lambda: profiled.update(train_step()), TRAIN_PARTS)
    busy, n_kernels, top = device_summary(traced["kernels"])
    later = steps[1:] + [profiled]
    mean_later_s = sum(s_["s"] for s_ in later) / len(later)
    flash_traced = sum(n for name, (n, _) in traced["kernels"].items()
                       if ROUTE_KERNELS[bf16][0] in name)
    breakdown = {
        "step": TRAIN_STEPS, "wall_profiled_s": traced["wall_s"],
        "decode_steps": profiled["decode_steps"],
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / mean_later_s,
        "kernel_launches": n_kernels, "flash_kernels_traced": flash_traced,
        "parts": traced["parts"], "top_kernels": top}
    for s_ in steps + [profiled]:
        assert all(np.isfinite(v) for v in s_["metrics"].values()), s_["metrics"]
        assert s_["flash_launches_bf16"] == fwd_per_step, (s_, fwd_per_step)
        assert s_["flash_launches_f32"] == 0, s_
        assert s_["backward_calls"] == bwd_per_step, (s_, bwd_per_step)
    # the trace holds the whole step: every flash launch, to the d phase's
    assert flash_traced == fwd_per_step, (flash_traced, fwd_per_step)
    nonfinite = [k for k, x in tree_paths(ts.params).items()
                 if not bool(torch.isfinite(x).all())]
    assert not nonfinite and ts.step == TRAIN_STEPS + 1, nonfinite

    phase_ends.append((7, time.perf_counter()))
    # 8. one TINY train step on the card against the CPU, float32, flash on,
    # train mode with every dropout and mask at 0
    tiny_t = TINY.replace(use_discriminator=True, attn_impl="flash", **ZERO_DROPOUTS)
    targs = train_args(CONFIG, sp_steps=2)
    tiny_fwd, tiny_bwd = flash_calls_per_step(tiny_t, targs)
    tp0, ts0 = unast_init(torch.Generator().manual_seed(0), tiny_t)
    tb = train_batches(np.random.default_rng(1), targs, tiny_t, 2, 12, 20, "cpu")
    tiny_step = make_train_step(tiny_t, targs)
    with zero_fixed_dropouts():
        on_cpu_t = tiny_step(train_state(tp0, ts0, tiny_t, targs),
                             torch.Generator().manual_seed(0), tb)
        reset_launch_counts(fa)
        before_bwd = fa.backward_calls
        on_gpu_t = tiny_step(train_state(tree_to(tp0, "cuda"), tree_to(ts0, "cuda"),
                                         tiny_t, targs),
                             torch.Generator(device="cuda").manual_seed(0),
                             {k: tuple(x.cuda() for x in v) for k, v in tb.items()})
        torch.cuda.synchronize()
    tiny_train_launches_f32 = fa.launches_f32
    tiny_train = {"launches_f32": fa.launches_f32, "launches_bf16": fa.launches_bf16,
                  "backward_calls": fa.backward_calls - before_bwd,
                  **compare_train_steps(tp0, on_gpu_t, on_cpu_t, targs.lr)}
    # float32 throughout; tolerances as tests/test_torch_train.py holds the
    # CPU path to the JAX step: metrics 1e-4 relative, BN state 1e-5,
    # first moments within 1e-4 relative + 1e-5 of the largest (scaled <= 1),
    # normalised updates 1e-3 where the moment is above 1e-7
    tiny_train["ok"] = (tiny_train["metrics_rel"] <= 1e-4 and tiny_train["state_abs"] <= 1e-5
                        and tiny_train["gen_mu_scaled"] <= 1 and tiny_train["disc_mu_scaled"] <= 1
                        and tiny_train["update_abs"] <= 1e-3)
    assert tiny_train["ok"], tiny_train
    assert (tiny_train["launches_f32"], tiny_train["launches_bf16"],
            tiny_train["backward_calls"]) == (tiny_fwd, 0, tiny_bwd), (tiny_train, tiny_fwd)

    phase_ends.append((8, time.perf_counter()))
    # 9. the third main path: the training loop at flagship width (bf16),
    # its checkpoint served and test-evaluated, and the float32 loop card
    # against CPU at configs/transformer_test.json width
    loop_run = flagship_loop(fa)
    loop_run["tiny_gpu_vs_cpu"] = tiny_loop_walk(fa)

    phase_ends.append((9, time.perf_counter()))
    # 10.-12. the RNN backbone served and trained at full width, and the
    # CBHG vocoder trained and served through
    rnn_serve_run = rnn_serve(fa)
    print(json.dumps({"phase": 10, "s": rnn_serve_run["phase_s"]}), flush=True)
    rnn_train_run = rnn_train(fa)
    print(json.dumps({"phase": 11, "s": rnn_train_run["phase_s"]}), flush=True)
    vocoder_run = vocoder_phase(fa, params, state, cfg)
    print(json.dumps({"phase": 12, "s": vocoder_run["phase_s"]}), flush=True)
    phase_ends.append((12, time.perf_counter()))
    print(json.dumps({"phase_s": {
        f"{a + 1}" if b - a == 1 else f"{a + 1}-{b}": t1 - t0
        for (a, t0), (b, t1) in zip(phase_ends, phase_ends[1:])}}), flush=True)

    for kernel_case in cases:
        kernel_case.pop("ok")
    routes = [
        ("flash_attn_fwd_wgmma", "bfloat16", "flash_attn_fwd_wgmma.cu",
         "asr_encoder_qkv", launches_bf16,
         "flagship serve: 8 TTS + 8 ASR, bf16", train_launches_bf16,
         f"flagship train: {TRAIN_STEPS} untraced step(s), bf16 (phase 7)",
         loop_run["launches"]["seen"][0],
         "flagship loop: warm-start step, 1 step, 2 evals, bf16 (phase 9)"),
        ("flash_attn_fwd_f32", "float32", "flash_attn_fwd_f32.cu",
         "tiny_asr_encoder_f32", tiny_launches_f32,
         "TINY serve on the card, float32 (phase 5)", tiny_train_launches_f32,
         "TINY train step on the card, float32 (phase 8)",
         loop_run["tiny_gpu_vs_cpu"]["launches_f32"],
         "transformer_test loop on the card, 2 epochs, float32 (phase 9)"),
    ]
    kernels = []
    for (name, dtype, source, main_name, n, path, n_train, train_path,
         n_loop, loop_path) in routes:
        main_case = next(c for c in cases if c["case"] == main_name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"unast_tpu_torch/csrc/{source}",
            "replaces": "unast_tpu/ops/attention.py:81",
            "dtype": dtype, "launches": n, "launches_counted_on": path,
            "launches_train": n_train, "launches_train_counted_on": train_path,
            "launches_loop": n_loop, "launches_loop_counted_on": loop_path,
            "launches_vocoder_serve": vocoder_run[
                "flash_launches_bf16" if dtype == "bfloat16" else "flash_launches_f32"],
            "launches_vocoder_serve_counted_on":
                "flagship serve through the CBHG vocoder: 8 TTS, bf16 (phase 12)",
            "launches_rnn": rnn_serve_run["flash_launches"] + sum(
                s_["flash_launches"] for s_ in rnn_train_run["steps"]),
            "launches_rnn_counted_on": "rnn_d serve (8 TTS + 8 ASR) and 2 train steps "
                                       "(phases 10, 11): the RNN calls no attention kernel",
            **{key: main_case[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms",
                "prepass_device_ms", "bound_cuda_core_ms") if key in main_case},
            "hgmma_instructions": hgmma[name][0],
            "main_case": main_name,
            "cases": [c for c in cases if c["dtype"] == dtype]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"backward": bwd_cases}))
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    print(json.dumps({"train": {
        "config": os.path.relpath(CONFIG, ROOT), "attn_impl": cfg.attn_impl,
        "compute_dtype": cfg.compute_dtype, "batch": args.train_batch_size,
        "text_len": args.data_text_len, "mel_len": args.data_mel_len,
        "micro_batches": {k: getattr(args, f"{k}_steps") for k in ("ae", "cm", "sp", "d")},
        "first_step_s": steps[0]["s"],
        "later_step_s": [s_["s"] for s_ in later],
        "mean_later_step_s": mean_later_s,
        "flash_fwd_per_step_expected": fwd_per_step,
        "flash_bwd_per_step_expected": bwd_per_step,
        "max_memory_allocated_bytes": train_peak,
        "steps": steps,
        "breakdown_step": breakdown,
        "tiny_gpu_vs_cpu": tiny_train,
    }}))

    print(json.dumps({"loop": loop_run}))
    print(json.dumps({"rnn_serve": rnn_serve_run}))
    print(json.dumps({"rnn_train": rnn_train_run}))
    print(json.dumps({"vocoder": vocoder_run}))
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
