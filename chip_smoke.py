#!/usr/bin/env python3
"""GPU smoke run of unast_tpu_torch, the PyTorch/CUDA port: the quickest
proof that the port builds, that its kernels agree with their plain
versions, and that it serves and trains on an NVIDIA card.

    python3 chip_smoke.py

Phases (each that fails exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32
     flags, which this script turns off so float32 products stay float32;
  2. the kernel build (nvcc, from unast_tpu_torch/csrc, one process per
     library, all started together: the two forwards and the two
     backwards) and its seconds, each library's ptxas report, and the
     count of HGMMA (wgmma) instructions in each library's SASS
     (cuobjdump), each above 0 (TF32 ones in the float32 libraries);
  3. every kernel against its plain PyTorch version, in both dtypes: at
     the serving shapes (text and mel buckets, B 8, on the strided views of
     one fused-QKV projection, as the encoders pass them) and on more
     layouts and masks (separate tensors, cross-attention views, kv_len 1,
     kv_lens off the key tile, causal, Tq != Tk, D 16/32/128); in float32
     also the shapes of phase 5's TINY serve (D 16, B <= 4, T 8-24), the
     route's main case, and a V one-hot in the key, which pins the
     split-TF32 kernel's key order. bf16 within 2e-2 and within one bf16 rounding of the output,
     float32 within 2e-5; the lse each kernel writes beside o against
     the plain lse (flash_attention_fwd_plain) within 2**-14 (1 + |lse|).
     Each case with its device time (torch.profiler, the route's own
     kernels, the float32 pre-pass shown apart), its
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
  6. the flash-attention gradients (kernel forward, the dtype's backward
     kernel, through flash_attention's autograd.Function: one launch a
     call, on its route's count) against autograd through the plain
     version, on fused-QKV and cross views: bf16 at the flagship train
     step's shapes (B 4, T 304 and 816, causal self-attention, cross
     304 x 816 and 816 x 304), a tp rank's B4 H2, an sp rank's q 408 at
     q_start 408 over 816 and the wide step's D 128, within 2**-6 of each
     gradient's largest element; float32 at the same B4 H4 D64 shapes,
     the sp rank's, configs/transformer_test.json's D 32 (B2 H2, T32
     causal, cross 24 x 32), the wide D 128 at B8 H8 and TINY's, within
     1e-4 of it. On each case the backward kernel (flash_attention_bwd)
     against flash_attention_bwd_plain on the same q, k, v, o, dO and
     kv_lens, and both against the float64 function: every element within
     r |ref| + a A (A the sum of the absolute terms of its product, dS
     expanded into its own: backward_f64; (r, a) = F64_BOUND, bf16
     (2**-8, 2**-16), float32 (2**-23, 2**-17)), two calls bit for bit,
     keys past kv_len exactly 0; each case with the kernel's device time
     (its two launches apart), its per-call time, the bound, the plain
     version's time and, as its library time, that of SDPA's autograd
     backward under the same mask (float32 with TF32 off); the phase's
     seconds;
  7. the second main path: 1 step of make_train_step on the same config
     (ae 2, cm 1, sp 4 and d 1 micro-batches of 4, synthetic batches at the
     config's 816 mel frames and 304 tokens with ragged lengths from numpy
     seed 0), random weights from seed 0, counts set to 0 just before each
     step and read just after: losses and every new param finite, bf16
     forward launches and backward calls per step as the code implies,
     each backward call one launch of the bf16 backward kernel (so on
     every bf16 path that trains, phases 9, 14, 15, 17, 18 and 20; and
     each float32 one a launch of the float32 kernel, phases 8, 9, 15, 18
     and 20's TINY ranks, phase 14's TINY checks taking no attention
     gradient), float32 launches 0; then a second step under torch.profiler, read by
     the port's record_function ranges (objectives, backward passes,
     greedy decodes, LSTM discriminator, flash backward) for where its
     time goes and the device's idle share (against the profiled wall,
     so an upper bound);
  8. one train step on the card against the same step on the CPU at TINY
     width in float32 with flash on (both float32 kernels on the card),
     train mode with every dropout and mask at 0, counts set to 0 just
     before and read just after; then one joint step of the flagship
     (phase 7's config, batches and objectives) with compute_dtype
     float32: its seconds, peak memory, losses and params finite, forward
     launches on the float32 route as flash_calls_per_step counts them
     and each of its 120 backward calls one launch of the float32
     backward kernel;
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
  11. the RNN backbone trained: 1 step of make_train_step with rnn_d's
     own train args (adam, multistep, B2, ae 1 / cm 2 / sp 1 / d 1) on
     synthetic batches at 816 frames / 304 tokens, counts set to 0 just
     before the step and read just after (0 forwards, 0 backward calls),
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
  13. data on the card: 16 synthetic clips of 1-9.4 s as PCM16 wavs and a
     metadata.csv, `python -m unast_tpu_torch.data.prepare` on the card
     (--batch 8 --bucket_s 11 --f0 --shard_out --wav_shard_out) and again
     with --cpu: caches within 5e-4 (F0 equal), the shards read back
     equal to the caches, the wav shard aligned with the mel frames,
     BatchIterator's shard path equal to its item path, seconds per clip
     of each path, and `python -m unast_tpu_torch.data.shard` on the card;
  14. the CTC family at flagship width: 20 CTC train steps
     (train/ctc.py) on phase 13's shard; Synthesizer(ctc_pv=) serving 8
     ASR requests at the 816-frame bucket one-pass, with ctc_beam 4 and
     spec=True against the AR model, and the AR model's beam 4; one
     hybrid joint step (ctc_weight 0.3, cm_text_decode 'spec'); each with
     its seconds and its launches as the code implies (counts set to 0
     just before, read just after); TINY f32 card against CPU
     (ctc_logits under abs/chunk/rel, the streaming step, ctc_loss and
     its gradient, the CTC draft, speculative, greedy and beam decodes,
     Synthesizer(ctc_pv=) under every option; 1e-4, ids equal, the CPU's
     greedy margins above 1e-3); scripts/ctc_check.py's gate on the port
     (greedy PER < 0.05 after 1200 steps);
  15. FastSpeech at flagship width (phases 15-16 print their seconds as
     they end): a student from seed 0 (duration bias raised by 2)
     distilled from phase 4's AR model on phase 13's shard at B4 x 816 /
     304, one step per duration source (argmax twice, soft, mas, uniform,
     and ctc from a fresh ctc_weight 0.3 teacher), each with its seconds
     and its flash launches and backward calls as the code implies, the
     peak memory; Synthesizer(nar_pv=) serving 8 TTS (one text encoder
     and one frame decoder: 8 launches); TINY f32 card against CPU (the
     forward with the pitch and energy adaptors, every duration source,
     one distill step, the Synthesizer's mels);
  16. the neural vocoders at base 256 (rates 5/5/11, hop 275): 3 STFT-loss
     steps each of MelGAN and HiFi-GAN at B8 x 40-frame crops of phase
     13's shards (crop_batch through MelWavCrops), one adversarial step
     (msd+mpd); Synthesizer(nar_pv=, melgan_params=, pcm16=True) serving
     8 TTS (8 launches); melgan_chunk=256 against the whole vocode (1e-5
     in float32, one PCM16 step); stream_tts's first chunk against the
     whole utterance; TINY card against CPU (both generators, both
     discriminators and mr_stft_loss in f32; a vocoder and an adversarial
     step in f64, and their f32 losses; StreamingCtcAsr equal to the
     one-shot greedy decode);
  17. the wide model, configs/wide_d1024.json at full width (d 1024, 6
     layers, 8 heads of 128, ffn 4096, bf16, flash; phases 17-18 print
     their seconds as they end): one joint step with its remat
     'dots_all' and objective mix (ae 2 / cm 1 / sp 4 / d 1, the LSTM
     discriminator, guided attention) at B8 x 816 / 304 (the config's
     batch 32 cut to 8), its seconds, peak memory, forward launches (the
     checkpoint recompute included) and backward calls as the code
     implies; the sp objective alone under remat off, '', 'dots' and
     'dots_all' (losses bitwise equal, each peak, '' below off); 8 TTS
     (to 815 frames) and 8 ASR served with bf16 weights, then with
     quantize='int8' (latencies, weight bytes, the served mels and the
     teacher-forced TTS forward within 0.1 relative RMS of bf16's; along
     bf16's greedy ASR path the int8 weights' greedy choice equal to
     bf16's wherever bf16's margin is above 0.1); phases 3 and
     6 hold its kernel case (B8 T815 H8 D128 on fused-QKV views) and its
     backward at B8 T816;
  18. the family additions at flagship width: --speech_encoder conformer
     (8 ASR, one ae + sp step), --moe_experts 8 --moe_impl ragged (8 TTS
     to 815 frames through the T == 1 dense decode, 8 ASR, one ae + sp
     step with the aux metric) and the same step with --moe_impl
     dispatch, launches as counted; TINY f32 card against CPU within
     1e-4 (a conformer encoder in train mode, both MoE paths, a MoE stack
     under remat 'dots_all' and under scan_layers with its gradient, the
     quantized TTS forward);
  19. the serving export and the checkpoint migration at flagship width:
     export_synthesizer of phase 15's student, phase 16's MelGAN and phase
     14's CTC model at batch 8, text 304, mel 816, the bundle loaded back
     in this process and each program called on the card (nar_tts 8 bf16
     launches, ctc_asr 4, vocode 0; each exported graph holds those
     unast::flash_attention_fwd nodes) against the eager functions
     (1e-5 of the largest, ids equal), the export's seconds, the bundle's
     bytes, each call's seconds, the registered operator's dispatch cost
     against a direct call; the flagship trees and phase 12's CBHG vocoder
     through export_state_dict / import_state_dict bit-equal, and the two
     compat CLIs round-tripping the flagship checkpoint;
  20. data, tensor, expert, sequence and pipeline parallelism on the one
     card (its worlds
     are started before phase 13 and run beside phases 13-19): a world of two
     processes (this script with --dp-worker) under gloo sharing the H100
     (NCCL refuses two ranks on one device; the device line still says
     count 1), each joined, a failing rank failing the phase: at TINY f32
     one dp step per ZeRO level 0, 1 and 3, the dp = 2 dispatch-MoE step
     whose capacity overflows, a tp = 2, an ep = 2, an sp = 2 and a pp =
     2 step, each against the single-process step (phase 8's
     tolerances), and Synthesizer(mesh=) against the single-process one;
     at flagship width one bf16 joint step with zero=1, one with zero=3,
     one at tp = 2, one at sp = 2 (each rank half of every sequence's
     frames) and one at pp = 2 (each rank 2 of the 4 layers of every
     pipelined stack), each rank's launches and backward calls as
     flash_calls_per_step counts them, its peak memory, param and
     optimizer bytes (a tp rank's as the split rule counts them, an sp
     or pp rank's whole), the step's seconds; in every sharded step the
     kernel against its plain version on each q/k/v layout the rank gave
     it (an sp rank's causal queries at their q_start); the combinations
     JAX builds that the port once refused, at TINY f32 against the
     single-process step: sp = 2 with remat ('' and dots_all), with the
     dispatch MoE overflowing its capacity, the ragged MoE and the RNN
     backbone; then configs/wide_d1024.json at sp = 2 (WIDE_SP_BATCH rows,
     each rank 408 / 152 of the 816 / 304 frames, remat dots_all: the
     bf16 forward at D 128 with q_start, also in the checkpoint
     recompute, and the bf16 backward), each rank's seconds, peak and
     launches as counted, the kernel and the backward kernel against
     their plain versions on every layout the rank gave them; then a world
     of four ranks: TINY dp 2 x tp 2 zero-1, dp 2 x pp 2, tp 2 x pp 2,
     ep 2 x pp 2 and sp 2 x pp 2 steps against the single-process step;
  then one `{"kernels": [...]}` line (both forward routes, with their
     launches on the serve, train, loop, vocoder-serve, RNN, CTC serve,
     speculative, beam, CTC train, hybrid, NAR serve, distill, NAR +
     MelGAN serve, wide step and serve, family step, serve and TINY,
     export, dp, tp, sp, pp and wide sp paths; the bf16 backward, with
     its launches on the train, loop, CTC train, hybrid, distill, wide
     step, family step, dp, tp, sp, pp and wide sp paths; the float32 backward, with its
     launches on the flagship f32 step, the TINY step, the f32 loop, the
     TINY CTC, distill and family checks and the TINY mesh steps; each
     equal to the path's backward calls), a
     `{"backward": ...}`, a `{"train": ...}`, a `{"loop": ...}`, an
     `{"rnn_serve": ...}`, an `{"rnn_train": ...}`, a `{"vocoder": ...}`,
     a `{"data": ...}`, a `{"ctc": ...}`, a `{"nar": ...}`, a `{"melgan":
     ...}`, a `{"wide": ...}`, a `{"families": ...}`, an `{"export":
     ...}`, a `{"dp": ...}` and a `{"serve": ...}` line, and last
     `{"ok": true, "device": ...}`.
"""

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import tempfile
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
# each backward kernel's two launches, in order
BWD_KERNELS = {torch.bfloat16: ("flash_bwd_delta_kernel", "flash_bwd_kernel"),
               torch.float32: ("flash_bwd_f32_delta_kernel", "flash_bwd_f32_kernel")}
# the forward kernels' lse against the plain lse: float32 sums of up to Tk
# terms of 2^-22 relative error each (ex2.approx), and S from another
# order of the same float32 sums
LSE_TOL = 2.0 ** -14


class Case(NamedTuple):
    """One kernel-vs-plain input set: kv_lens `lens`, or ragged from tk
    down to about a third of it; layout as in attention_inputs; one_hot_v:
    v of key j is the unit vector e_(j mod D), so each output column sums
    the weights of its own keys and a key order on which P and V disagree
    moves weight between columns. q_start: the causal mask's offset of
    query 0 (a sequence-parallel rank's queries against the gathered
    keys)."""
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
    q_start: int = 0


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
    # a tp = 2 rank's step (phase 20): 2 of the flagship's 4 heads, q/k/v
    # views of its fused [B, T, 3 * 128] projection, k/v of [B, T, 2 * 128]
    Case("tp_self_t816_h2", bf16, 4, 816, 816, 2, 64, True, 49, "qkv"),
    Case("tp_self_t304_h2", bf16, 4, 304, 304, 2, 64, True, 50, "qkv"),
    Case("tp_encoder_t816_h2", bf16, 4, 816, 816, 2, 64, False, 51, "qkv"),
    Case("tp_cross_304x816_h2", bf16, 4, 304, 816, 2, 64, False, 52, "cross"),
    Case("tp_cross_816x304_h2", bf16, 4, 816, 304, 2, 64, False, 53, "cross"),
    # an sp = 2 rank's causal self-attention (phase 20): its half of the
    # queries at their offset against the gathered keys, k/v views of one
    # gathered [B, T, 2 * 256] tensor, in both dtypes
    Case("sp_self_q408_at408_k816", bf16, 4, 408, 816, 4, 64, True, 54, "cross",
         q_start=408),
    Case("sp_self_q152_at152_k304", bf16, 4, 152, 304, 4, 64, True, 55, "cross",
         q_start=152),
    Case("sp_self_q408_at408_k816_f32", f32, 4, 408, 816, 4, 64, True, 56, "cross",
         q_start=408),
    Case("sp_self_q152_at152_k304_f32", f32, 4, 152, 304, 4, 64, True, 57, "cross",
         q_start=152),
    # phase 17's wide encoder: d 1024 over 8 heads of 128
    Case("wide_encoder_qkv_d128", bf16, 8, 815, 815, 8, 128, False, 47, "qkv"),
    # phase 20's wide sp = 2 rank: its 408 queries of the 816 frames against
    # the gathered keys at D 128, causal at the second rank's q_start and
    # the encoder's
    Case("wide_sp_self_q408_at408_k816_d128", bf16, 8, 408, 816, 8, 128, True, 81,
         "cross", q_start=408),
    Case("wide_sp_encoder_q408_k816_d128", bf16, 8, 408, 816, 8, 128, False, 82,
         "cross"),
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
    Case("wide_encoder_t816_d128", bf16, 8, 816, 816, 8, 128, False, 48, "qkv"),
    # the wide sp = 2 rank's layouts at D 128 (phase 20)
    Case("wide_sp_self_q408_at408_k816_d128", bf16, 8, 408, 816, 8, 128, True, 83,
         "cross", q_start=408),
    Case("wide_sp_encoder_q408_k816_d128", bf16, 8, 408, 816, 8, 128, False, 84,
         "cross"),
    # an sp = 2 rank's causal self-attention and a tp = 2 rank's heads
    # (phase 20's steps)
    Case("sp_self_q408_at408_k816", bf16, 4, 408, 816, 4, 64, True, 58, "cross",
         q_start=408),
    Case("tp_self_t816_h2", bf16, 4, 816, 816, 2, 64, True, 59, "qkv"),
    Case("tiny_train_self_f32", f32, 2, 12, 12, 2, 16, True, 45, "qkv",
         lens=[12, 5]),
    Case("tiny_train_cross_f32", f32, 2, 12, 20, 2, 16, False, 46, "cross",
         lens=[20, 9]),
    # float32 (phase 8's flagship f32 step, phase 20's sp rank, phase 9's
    # configs/transformer_test.json at D 32, the wide encoder's D 128)
    Case("train_self_t816_f32", f32, 4, 816, 816, 4, 64, True, 72, "qkv"),
    Case("train_encoder_t816_f32", f32, 4, 816, 816, 4, 64, False, 73, "qkv"),
    Case("train_self_t304_f32", f32, 4, 304, 304, 4, 64, True, 74, "qkv"),
    Case("train_cross_304x816_f32", f32, 4, 304, 816, 4, 64, False, 75, "cross"),
    Case("train_cross_816x304_f32", f32, 4, 816, 304, 4, 64, False, 76, "cross"),
    Case("sp_self_q408_at408_k816_f32", f32, 4, 408, 816, 4, 64, True, 77, "cross",
         q_start=408),
    Case("test_self_t32_d32_f32", f32, 2, 32, 32, 2, 32, True, 78, "qkv",
         lens=[32, 17]),
    Case("test_cross_24x32_d32_f32", f32, 2, 24, 32, 2, 32, False, 79, "cross",
         lens=[32, 20]),
    Case("wide_encoder_t816_d128_f32", f32, 8, 816, 816, 8, 128, False, 80, "qkv"),
]
TRAIN_STEPS = 1
# phase 11's RNN steps at rnn_d width (host-bound: about a minute and a
# half each; one keeps the script inside its time limit)
RNN_TRAIN_STEPS = 1
TEST_CONFIG = os.path.join(ROOT, "configs", "transformer_test.json")
RNN_CONFIG = os.path.join(ROOT, "configs", "rnn_d.json")
VOCODER_CONFIG = os.path.join(ROOT, "configs", "vocoder.json")
# phase 9's flagship loop: 1 warm-start step, one epoch of 1 joint step
# (phase 7 takes more at the same width), an eval before and after it (one
# batch of 2), every checkpoint role
LOOP_FLAGS = dict(synthetic_size=16, epochs=1, epoch_steps=1, sp_warmup_steps=1,
                  save_every=1, eval_batch_size=2)
# phase 13's corpus: 16 synthetic clips of 1-9.4 s (SyntheticSpeechDataset
# seed 0, 1-20 words), each with 0.05-0.4 s of low noise before and after
DATA_CLIPS = 16
# phase 14: CTC train steps at flagship width, and scripts/ctc_check.py's
# gate (its flags and steps) on the port
CTC_TRAIN_STEPS = 20
CTC_GATE_ARGV = [
    "--hidden", "64", "--e_in", "64", "--t_emb_dim", "64", "--s_pre_hid", "64",
    "--ffn_dim", "128", "--num_layers", "2", "--nhead", "2",
    "--use_discriminator", "false", "--max_mel_len", "112", "--max_text_len", "32",
    "--data_mel_len", "112", "--data_text_len", "32", "--train_batch_size", "4",
    "--sched_type", "multistep", "--lr", "1e-3", "--optim_type", "adamw",
    "--compute_dtype", "bfloat16"]
CTC_GATE_STEPS = 1200
# phases 15-16: the one-pass families on the card. The student's duration
# bias is raised as tests/test_fastspeech.py raises it, so its
# free-running lengths run to hundreds of frames; the distill steps take
# every duration source, two argmax steps first; the vocoders train on
# crops of phase 13's shards.
NAR_DUR_BIAS = 2.0
NAR_SOURCES = ("argmax", "soft", "mas", "uniform", "ctc")
NAR_STEP_SOURCES = ("argmax",) + NAR_SOURCES
VOC_BASE = 256
VOC_STEPS = 3
VOC_BATCH = 8
VOC_FRAMES = 40
MELGAN_CHUNK = 256
STREAM_CHUNK = 32
# phase 17: configs/wide_d1024.json at full width; its batch of 32 cut to 8.
# int8 serving: the served mels and the teacher-forced TTS forward within
# WIDE_INT8_REL_TOL (relative RMS) of bf16's; along bf16's greedy text path
# the int8 weights' greedy choice equal to bf16's at every step whose bf16
# margin is above WIDE_ID_MARGIN
WIDE_CONFIG = os.path.join(ROOT, "configs", "wide_d1024.json")
WIDE_BATCH = 8
# phase 20's wide sp = 2 step: the config's batch of 32 cut to 4, so that
# phase 20, which grows past phase 19's end, keeps the script well inside
# its limit (at 8 the whole script took 1,022 s)
WIDE_SP_BATCH = 4
WIDE_INT8_REL_TOL = 0.1
WIDE_ID_MARGIN = 0.1
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


def attention_bound(q, k, kv_lens, causal, q_start: int = 0):
    """Least time (ms) the card could take for one flash_attention call on
    these inputs, what bounds it, and for float32 the same on the CUDA
    cores: the score and P.V products over the (query, key) pairs this data
    keeps (query i sees keys up to i + q_start when causal), against the
    bytes of q, the kept k/v rows, o and kv_lens, each moved once. The
    float32 work at float32 accuracy on the tensor cores is three TF32
    products (split-TF32), as the float32 kernel does it."""
    b, tq, h, d = q.shape
    lens = kv_lens.cpu().numpy().astype(np.int64)
    rows = np.arange(tq) + q_start
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


def trace(fn, labels=(), record_ops=True):
    """Run fn() once under the profiler (CPU and CUDA activity) and read its
    raw events: {"wall_s": the profiled run's wall time, "stop_s" and
    "read_s": the profiler's stop (its own processing of the events) and
    this function's read of them, "kernels":
    {name: [launches, device s]} of every device activity, "parts":
    {label: {"count", "host_s", "device_s"}}} for each record_function
    range named in `labels` (the port's 'unast/...' ranges): the ranges'
    wall time on the host, and the device time of the activities that
    start inside them. The device trails its host by little in the
    host-bound loops profiled here, so an activity counts where it
    starts. The device-side copies of the ranges are not activities.

    record_ops=False records on the host only the record_function ranges
    (RecordScope.USER_SCOPE), not every aten op, inside one range around
    the whole run: a traced flagship train step then holds its 1.7 million
    device activities and their launch calls, not several million op
    events more, which the profiler post-processes and this loop reads in
    Python. The short windows of the kernel cases record every op (a
    window of back-to-back kernel calls with no range in it lost some of
    its kernels under the scope filter). The events are read in one pass,
    the device's as (start, duration) pairs into numpy."""
    from torch.autograd import DeviceType
    from torch.autograd import profiler as P
    from torch.profiler import ProfilerActivity, profile

    def run():
        with P.record_function("chip_smoke/trace"):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t
    if record_ops:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run()
            t = time.perf_counter()
        results = prof.profiler.kineto_results
        stop_s = time.perf_counter() - t
    else:
        from torch._C._profiler import RecordScope
        config = P.profile(use_device="cuda", use_kineto=True)
        activities = config.kineto_activities
        config = config.config()
        P._prepare_profiler(config, activities)
        P._enable_profiler(config, activities, {RecordScope.USER_SCOPE})
        try:
            wall = run()
        finally:
            t = time.perf_counter()
            results = P._disable_profiler()
            stop_s = time.perf_counter() - t
    t_read = time.perf_counter()
    kernels, starts, durs = {}, [], []
    ranges = {label: [] for label in labels}
    cuda = DeviceType.CUDA
    for e in results.events():
        if e.device_type() == cuda:
            name = e.name()
            if e.is_user_annotation() or name.startswith(("unast/", "chip_smoke/")):
                continue
            start, dur = e.start_ns(), e.duration_ns()
            n_s = kernels.setdefault(name, [0, 0.0])
            n_s[0] += 1
            n_s[1] += dur * 1e-9
            starts.append(start)
            durs.append(dur)
        else:
            name = e.name()
            if name in ranges:
                start = e.start_ns()
                ranges[name].append((start, start + e.duration_ns()))
    starts = np.asarray(starts, np.int64)
    order = np.argsort(starts, kind="stable")
    starts = starts[order]
    done = np.concatenate([[0], np.cumsum(np.asarray(durs, np.int64)[order])])

    def busy_ns(a, b):
        return int(done[np.searchsorted(starts, b)] - done[np.searchsorted(starts, a)])
    parts = {label: {"count": len(spans),
                     "host_s": sum(b - a for a, b in spans) * 1e-9,
                     "device_s": sum(busy_ns(a, b) for a, b in spans) * 1e-9}
             for label, spans in ranges.items()}
    return {"wall_s": wall, "stop_s": stop_s, "read_s": time.perf_counter() - t_read,
            "kernels": kernels, "parts": parts}


def device_ms(fn, symbols, iters: int, tries: int = 3):
    """Mean device time (ms) per call of fn(), from a trace of `iters`
    calls after one warm-up call: {symbol: ms} of the kernels whose name
    holds each of `symbols`, each launched once a call (the mean over the
    launches the window recorded: a window of several short kernels a
    call now and then loses one or two of its events, so at least 90 % of
    them must be there); with no symbols, {"": ms} of every kernel the
    call launches. A profiled window now and then records no device
    activity at all; such a window is profiled again, up to `tries` in
    all, and then fails."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        kernels = trace(lambda: [fn() for _ in range(iters)])["kernels"]
        found = {}
        for symbol in symbols or ("",):
            hits = [v for name, v in kernels.items() if symbol in name]
            found[symbol] = (sum(n for n, _ in hits), sum(s_ for _, s_ in hits))
        if all(iters - iters // 10 <= n <= iters if symbols else n >= iters
               for n, _ in found.values()):
            return {sym: s_ * 1e3 / (n if symbols else iters)
                    for sym, (n, s_) in found.items()}
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


def sdpa_call(q, k, v, kv_lens, causal, q_start: int = 0):
    """fn() computing the same function with one PyTorch call,
    scaled_dot_product_attention under a boolean mask (the causal one
    offset by q_start)."""
    b, tq, _, _ = q.shape
    tk = k.shape[1]
    keep = torch.arange(tk, device=q.device)[None, :] < kv_lens[:, None]
    mask = keep[:, None, None, :].expand(b, 1, tq, tk)
    if causal:
        mask = mask & torch.ones((tq, tk), dtype=torch.bool,
                                 device=q.device).tril(diagonal=q_start)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


def flash_agreement(out, ref, scale=None):
    """(max abs error, tol, ok, worst error over its bound) of a
    flash_attention output against its plain version on the same inputs:
    within tol (2e-5 for float32, 2e-2 for bfloat16) plus tol times
    `scale` (|ref| unless given), and a bfloat16 output also within one
    bf16 rounding of it (2^-7 scale + 1e-5)."""
    tol = 2e-5 if out.dtype == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs() if scale is None else scale
    bound = tol + tol * scale
    if out.dtype == torch.bfloat16:
        bound = torch.minimum(bound, 2.0 ** -7 * scale + 1e-5)
    return float(err.max()), tol, bool((err <= bound).all()), float((err / bound).max())


def attention_f64(q, k, v, kv_lens, causal: bool, q_start: int = 0):
    """(o, P.|V|): the flash function of q, k, v in float64 (the same
    kv_lens and causal mask, offset by q_start), and its weights applied
    to |v|."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / q.shape[-1] ** 0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    keep = torch.ones_like(s, dtype=torch.bool)
    if kv_lens is not None:
        keep = keep & (kpos[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
    if causal:
        keep = keep & (kpos[None, :] <= torch.arange(q.shape[1], device=q.device)[:, None]
                       + q_start)
    p = torch.softmax(s.masked_fill(~keep, -1e9), dim=-1)
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.double()),
            torch.einsum("bhqk,bkhd->bqhd", p, v.double().abs()))


@contextlib.contextmanager
def recorded_flash_inputs(seen: dict):
    """Within the block the transformer's flash_attention calls run as
    before, and the first (q, k, v, kv_lens, causal, q_start) of each
    distinct layout (shapes, strides, dtype, causal, q_start) lands in
    `seen`, detached:
    the very views a step gave the kernel, to hold it against its plain
    version afterwards (check_recorded_flash)."""
    from unast_tpu_torch.models import transformer
    inner = transformer.flash_attention

    def record(q, k, v, kv_lens=None, causal=False, q_start=0):
        key = (tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
               v.stride(), q.dtype, causal, q_start)
        if key not in seen:
            seen[key] = (q.detach(), k.detach(), v.detach(), kv_lens, causal,
                         q_start)
        return inner(q, k, v, kv_lens, causal=causal, q_start=q_start)

    transformer.flash_attention = record
    try:
        yield seen
    finally:
        transformer.flash_attention = inner


def check_recorded_flash(seen: dict) -> list:
    """The kernel against flash_attention_plain on each input set that
    recorded_flash_inputs kept: flash_agreement's tolerances on the scale
    |ref| + P.|V|. A step's activations reach |v| of tens, and where an
    output cancels, two float32 sums of such terms in another order
    differ far beyond |ref|'s rounding; the error of a weighted sum is
    bounded by its weights on |v|. Beside it, both against the float64
    function (attention_f64): a bfloat16 output must lie within one bf16
    unit roundoff (2^-8) of |o| + P.|V| from it. One record a layout
    ('self' when q and k are views of one fused projection)."""
    from unast_tpu_torch.ops.attention import flash_attention, flash_attention_plain
    recs = []
    for q, k, v, kv_lens, causal, q_start in seen.values():
        out = flash_attention(q, k, v, kv_lens, causal=causal, q_start=q_start)
        ref = flash_attention_plain(q, k, v, kv_lens, causal=causal,
                                    q_start=q_start)
        exact, weighted = attention_f64(q, k, v, kv_lens, causal, q_start)
        err, tol, ok, ratio = flash_agreement(out, ref, ref.float().abs() + weighted.float())
        model = (2.0 ** -8 * (exact.abs() + weighted)).clamp(min=1e-30)
        rec = {
            "dtype": str(q.dtype).replace("torch.", ""), "q": list(q.shape),
            "k": list(k.shape), "q_stride": list(q.stride()),
            "k_stride": list(k.stride()), "causal": causal, "q_start": q_start,
            "self": q.untyped_storage().data_ptr() == k.untyped_storage().data_ptr(),
            "max_abs_v": float(v.float().abs().max()),
            "max_abs_err": err, "tol": tol, "err_over_bound": ratio,
            "f64_err_kernel": float((out.double() - exact).abs().max()),
            "f64_err_plain": float((ref.double() - exact).abs().max())}
        if q.dtype == torch.bfloat16:
            rec["f64_err_over_roundoff_kernel"] = float(((out.double() - exact).abs() / model).max())
            rec["f64_err_over_roundoff_plain"] = float(((ref.double() - exact).abs() / model).max())
            ok = ok and rec["f64_err_over_roundoff_kernel"] <= 1
        rec["ok"] = ok
        recs.append(rec)
    return recs


def check_recorded_backward(seen: dict, seed: int = 0) -> list:
    """The backward kernel (flash_attention_bwd, from the forward's o and
    lse) against flash_attention_bwd_plain on each input set that
    recorded_flash_inputs kept, under an output gradient dO of N(0, 1):
    each of dQ, dK, dV within 2^-6 (bf16) or 1e-4 (float32) of the plain
    gradient's largest element, as phase 6 holds autograd's. One record a
    layout."""
    from unast_tpu_torch.ops.attention import (flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd)
    recs = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for q, k, v, kv_lens, causal, q_start in seen.values():
        o, lse = flash_attention_fwd(q, k, v, kv_lens, causal, q_start)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(o.dtype)
        got = flash_attention_bwd(q, k, v, kv_lens, causal, o, lse, do, q_start)
        want = flash_attention_bwd_plain(q, k, v, kv_lens, causal, o, do, q_start)
        rel = 2.0 ** -6 if q.dtype == torch.bfloat16 else 1e-4
        errs = {n: [float((a.float() - b.float()).abs().max()), float(b.float().abs().max())]
                for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        recs.append({"dtype": str(q.dtype).replace("torch.", ""), "q": list(q.shape),
                     "k": list(k.shape), "causal": causal, "q_start": q_start,
                     "max_abs_err_and_ref": errs, "rel": rel,
                     "ok": all(e <= rel * top for e, top in errs.values())})
    return recs


def lse_agreement(lse, ref):
    """(max abs error, worst error over LSE_TOL (1 + |ref|)) of a kernel's
    lse against the plain lse."""
    err = (lse - ref).abs()
    return float(err.max()), float((err / (LSE_TOL * (1 + ref.abs()))).max())


def flash_case(c: Case):
    """Kernel vs plain (and SDPA as a yardstick) on case c's inputs: o and,
    from the operator's second output, lse."""
    from unast_tpu_torch.ops.attention import (flash_attention, flash_attention_fwd,
                                               flash_attention_fwd_plain)
    q, k, v, kv_lens = case_inputs(c)
    out, lse = flash_attention_fwd(q, k, v, kv_lens, c.causal, c.q_start)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, kv_lens, causal=c.causal,
                                             q_start=c.q_start)
    max_err, tol, ok, _ = flash_agreement(out, ref)
    lse_err, lse_ratio = lse_agreement(lse, ref_lse)
    ok = ok and lse_ratio <= 1
    iters = 50 if c.tq * c.tk <= 300 * 815 else 20
    bound_ms, bound_by, bound_cuda_core_ms = attention_bound(q, k, kv_lens, c.causal,
                                                             c.q_start)
    symbols = ROUTE_KERNELS[c.dtype]

    def kernel():
        return flash_attention(q, k, v, kv_lens, causal=c.causal, q_start=c.q_start)
    library = sdpa_call(q, k, v, kv_lens, c.causal, c.q_start)
    per_kernel = device_ms(kernel, symbols, iters)
    case = {
        "case": c.name, "dtype": str(c.dtype).replace("torch.", ""),
        "layout": c.layout, "shape": [c.b, c.tq, c.tk, c.h, c.d],
        "causal": c.causal, "q_start": c.q_start, "kv_lens": kv_lens.tolist(),
        "one_hot_v": c.one_hot_v,
        "max_abs_err": max_err, "tol": tol, "lse_max_abs_err": lse_err,
        "lse_err_over_tol": lse_ratio, "ok": ok,
        "ms": cuda_ms(kernel, iters),
        "device_ms": sum(per_kernel.values()),
        "plain_ms": cuda_ms(lambda: flash_attention_fwd_plain(
            q, k, v, kv_lens, causal=c.causal, q_start=c.q_start), iters),
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": device_ms(library, (), iters)[""],
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if c.dtype == torch.float32:
        case["prepass_device_ms"] = per_kernel[symbols[0]]
        case["bound_cuda_core_ms"] = bound_cuda_core_ms
    return case


def sdpa_backward_call(q, k, v, kv_lens, causal, do, q_start: int = 0):
    """fn() computing the flash backward's function with one PyTorch call:
    the autograd backward of scaled_dot_product_attention under the same
    kv_lens (and causal, offset by q_start) mask, on inputs whose forward
    ran once before. Each call is one torch.autograd.grad over the
    retained graph: dq, dk and dv of <o, do>, SDPA's own backward kernels
    and nothing else."""
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    out = sdpa_call(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                    kv_lens, causal, q_start)()
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
    out = attn(*qkv_views(c, xs), kv_lens, causal=c.causal, q_start=c.q_start)
    grads = torch.autograd.grad((out.float() * w).sum(), xs)
    return qkv_views(c, grads)


def backward_bound(q, kv_lens, causal, q_start: int = 0):
    """Least time (ms) the card could take for one flash backward on these
    inputs, and what bounds it: five products (S, dV, dP, dQ, dK) over the
    (query, key) pairs this data keeps (query i sees keys up to
    i + q_start when causal), at the bf16 tensor-core rate, or
    for float32 as three TF32 products each (split TF32, the forward's
    convention), against the bytes of q, o, dO and dQ and of the kept k, v,
    dK and dV rows, each moved once."""
    b, tq, h, d = q.shape
    lens = kv_lens.cpu().numpy().astype(np.int64)
    rows = np.arange(tq) + q_start
    pairs = sum(int(np.minimum(rows + 1, n).sum()) if causal else tq * int(n)
                for n in lens)
    flops = 5 * 2 * h * d * pairs
    t_ops = (flops / H100_BF16_FLOPS if q.dtype == torch.bfloat16
             else 3 * flops / H100_TF32_FLOPS)
    nbytes = q.element_size() * (4 * q.numel() + 4 * h * d * int(lens.sum())) + 4 * b
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def backward_f64(q, k, v, kv_lens, causal: bool, o, do, q_start: int = 0):
    """((dq, dk, dv), (A_dq, A_dk, A_dv)): the flash backward's function in
    float64 on the same inputs (delta from the o given), and for each
    element A, the sum of the absolute terms of its product: P^T |dO| for
    dv; for dq and dk that of dS K and dS^T Q with dS = P (dP - delta) /
    sqrt(D) expanded into its own terms, |dS| -> P (|dO| |V|^T +
    rowsum(|dO o|)) / sqrt(D). (Where a row sees one key, P is 1 and the
    exact dS is 0: dP and delta are the same sum, which float32 takes in
    two orders, so |dS| alone would leave such an element no room.)"""
    d = q.shape[-1]
    qd, kd, vd, od, dod = (x.double() for x in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / d ** 0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    keep = (kpos[None, :] < kv_lens[:, None])[:, None, None, :]
    if causal:
        keep = keep & (kpos[None, :] <= torch.arange(q.shape[1], device=q.device)[:, None]
                       + q_start)
    p = torch.softmax(s.masked_fill(~keep, -1e9), dim=-1)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    delta = (dod * od).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) / d ** 0.5
    del dp
    grads = (torch.einsum("bhqk,bkhd->bqhd", ds, kd),
             torch.einsum("bhqk,bqhd->bkhd", ds, qd),
             torch.einsum("bhqk,bqhd->bkhd", p, dod))
    del ds
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod.abs(), vd.abs())
              + (dod * od).abs().sum(-1).transpose(1, 2)[..., None]) / d ** 0.5
    terms = (torch.einsum("bhqk,bkhd->bqhd", ds, kd.abs()),
             torch.einsum("bhqk,bqhd->bkhd", ds, qd.abs()),
             torch.einsum("bhqk,bqhd->bkhd", p, dod.abs()))
    return grads, terms


# f64_over_bound's constants (of |ref|, of A) for each dtype's gradients.
# bf16: the one cast to bf16, and float32 sums of terms that carry 16
# bits (a bf16-rounded P or dS does not hold it). float32: one float32
# rounding of the result and of its scale, 2 * 2**-24; and a split-TF32
# operand carries 21 bits (the rounding of lo and the dropped lo*lo, about
# 3 * 2**-22 of each term), P's error enters twice on the way S -> P ->
# dS -> dQ, dK, and the forward's lse adds its own (within 1.4e-6, about
# 2**-19.4, measured), about 2**-18.4 together; doubled for the tensor
# cores' float32 accumulation, 2**-17 (one TF32 product, 10 bits, misses
# it: tests/test_torch_train.py).
F64_BOUND = {torch.bfloat16: (2.0 ** -8, 2.0 ** -16),
             torch.float32: (2.0 ** -23, 2.0 ** -17)}


def f64_over_bound(got, ref, terms, dtype):
    """Largest |got - ref| / (r |ref| + a A) over the elements, (r, a) =
    F64_BOUND[dtype] (the gradients' dtype). An element whose bound is 0 (a
    key past kv_len) must be exactly ref."""
    err = (got.double() - ref).abs()
    r, a = F64_BOUND[dtype]
    bound = r * ref.abs() + a * terms
    ratio = torch.where(bound > 0, err / bound.clamp(min=1e-300),
                        torch.where(err > 0, torch.full_like(err, float("inf")),
                                    torch.zeros_like(err)))
    return float(ratio.max())


def backward_case(c: Case):
    """Gradients through flash_attention (kernel forward and backward)
    against autograd through flash_attention_plain on case c; the backward
    kernel (flash_attention_bwd, for c's dtype) against
    flash_attention_bwd_plain on the same q, k, v, o, dO and kv_lens, both
    against float64 (f64_over_bound, the dtype's constants), two calls bit
    for bit and keys past kv_len exactly 0; and the times: per call over
    back-to-back calls (CUDA events), each of the two launches' device
    time, the plain version's and SDPA's autograd backward's (float32
    with TF32 off, as phase 1 sets it)."""
    from unast_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd,
                                               flash_attention_plain)
    fa = flash_attention
    leaves, kv_lens = fused_leaves(c)
    w = torch.randn((c.b, c.tq, c.h, c.d), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(c.seed + 1))
    route = "backward_launches_bf16" if c.dtype == torch.bfloat16 else "backward_launches_f32"
    before = (fa.backward_launches, getattr(fa, route), fa.backward_calls)
    got = qkv_grads(c, flash_attention, leaves, kv_lens, w)
    torch.cuda.synchronize()
    through = [fa.backward_launches - before[0], getattr(fa, route) - before[1],
               fa.backward_calls - before[2]]
    want = qkv_grads(c, flash_attention_plain, leaves, kv_lens, w)
    rel = 1e-4 if c.dtype == torch.float32 else 2.0 ** -6
    errs = {}
    ok = through == [1, 1, 1]
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - r.float()).abs().max())
        top = float(r.float().abs().max())
        errs[name] = {"max_abs_err": err, "max_abs_ref": top}
        ok = ok and err <= rel * top
    q, k, v = qkv_views(c, leaves)
    o, lse = flash_attention_fwd(q, k, v, kv_lens, c.causal, c.q_start)
    do = w.to(c.dtype)
    # 50 calls a window at every size: the profiler can miss a few launches
    # at the start of a window, and the kernels' are only 2-1500 us long
    iters = 50
    bound_ms, bound_by = backward_bound(q, kv_lens, c.causal, c.q_start)
    args = (q, k, v, kv_lens, c.causal, o, do, c.q_start)

    def plain():
        return flash_attention_bwd_plain(*args)

    def kernel():
        return flash_attention_bwd(q, k, v, kv_lens, c.causal, o, lse, do, c.q_start)
    library = sdpa_backward_call(q, k, v, kv_lens, c.causal, do, c.q_start)
    case = {
        "case": c.name, "dtype": str(c.dtype).replace("torch.", ""),
        "layout": c.layout, "shape": [c.b, c.tq, c.tk, c.h, c.d],
        "causal": c.causal, "q_start": c.q_start, "kv_lens": kv_lens.tolist(),
        "grads": errs, "bound_rel_to_max": rel,
        "autograd_launches_route_launches_and_calls": through,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "plain_ms": cuda_ms(plain, iters),
        "plain_device_ms": device_ms(plain, (), iters)[""],
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": device_ms(library, (), iters)[""],
        "fwd_ms": cuda_ms(lambda: flash_attention(q, k, v, kv_lens, causal=c.causal,
                                                  q_start=c.q_start), iters)}
    mine, again = kernel(), kernel()
    ref_plain = plain()
    exact, terms = backward_f64(*args)
    lens = kv_lens.tolist()
    checks = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        past = [mine[i][b, n:] for b, n in enumerate(lens)] if name != "dq" else []
        checks[name] = {
            "max_abs_err_vs_plain": float((mine[i].float() - ref_plain[i].float())
                                          .abs().max()),
            "f64_over_bound_kernel": f64_over_bound(mine[i], exact[i], terms[i], c.dtype),
            "f64_over_bound_plain": f64_over_bound(ref_plain[i], exact[i], terms[i],
                                                   c.dtype),
            "bitwise_repeat": bool(torch.equal(mine[i], again[i])),
            "zero_past_kv_len": all(not bool(x.any()) for x in past)}
        ok = (ok and checks[name]["f64_over_bound_kernel"] <= 1
              and checks[name]["f64_over_bound_plain"] <= 1
              and checks[name]["bitwise_repeat"] and checks[name]["zero_past_kv_len"])
    del exact, terms
    per_kernel = device_ms(kernel, BWD_KERNELS[c.dtype], iters)
    case.update({
        "kernel": checks, "f64_bound": list(F64_BOUND[c.dtype]),
        "max_abs_err": max(x["max_abs_err_vs_plain"] for x in checks.values()),
        "ms": cuda_ms(kernel, iters), "device_ms": sum(per_kernel.values()),
        "device_ms_per_launch": per_kernel})
    case["ok"] = ok
    return case


def backward_summary(case):
    """Phase 6's line for one case: each launch's device ms, the float64
    ratio of each gradient, two calls bit for bit, zeros past kv_len."""
    checks = case["kernel"]
    return {"bwd_case": case["case"], "ok": case["ok"],
            "device_ms_per_launch": case["device_ms_per_launch"],
            "device_ms": case["device_ms"],
            "library_device_ms": case["library_device_ms"],
            "f64_over_bound": {g: checks[g]["f64_over_bound_kernel"] for g in checks},
            "bitwise_repeat": all(x["bitwise_repeat"] for x in checks.values()),
            "zero_past_kv_len": all(x["zero_past_kv_len"] for x in checks.values())}


# phase 6's case whose shape the flagship step's decoders give the
# backward most often: causal self-attention at B4 T816 H4 D64, per dtype
BWD_MAIN_CASE = {torch.bfloat16: "train_self_t816", torch.float32: "train_self_t816_f32"}


def backward_row(dtype, bwd_cases, hgmma, launches, counted_on, paths):
    """A backward kernel's entry of the kernels line: its launches on the
    main path (`launches`, counted as `counted_on`) and on every other
    path of its dtype that trains (`paths`: {key: (launches, where)}, each
    equal to that path's backward calls), and phase 6's numbers at its
    BWD_MAIN_CASE, with every case of its dtype beside."""
    main = next(c for c in bwd_cases if c["case"] == BWD_MAIN_CASE[dtype])
    name = {torch.bfloat16: "flash_attn_bwd_wgmma", torch.float32: "flash_attn_bwd_f32"}[dtype]
    dtype_name = str(dtype).replace("torch.", "")
    return {
        "name": name, "route": "cuda", "source": f"unast_tpu_torch/csrc/{name}.cu",
        "replaces": "unast_tpu/ops/attention.py:157", "dtype": dtype_name,
        "launches": launches, "launches_counted_on": counted_on,
        **{f"launches_{k}": n for k, (n, _) in paths.items()},
        **{f"launches_{k}_counted_on": where for k, (_, where) in paths.items()},
        **{key: main[key] for key in (
            "max_abs_err", "ms", "device_ms", "device_ms_per_launch", "plain_ms",
            "plain_device_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "f64_bound")},
        "library": "torch.autograd.grad through scaled_dot_product_attention",
        "hgmma_instructions": hgmma[name][0],
        "hgmma_tf32_instructions": hgmma[name][1],
        "main_case": main["case"],
        "cases": [{k: c[k] for k in ("case", "shape", "causal", "q_start", "kernel",
                                     "device_ms", "device_ms_per_launch", "ms",
                                     "plain_device_ms", "library_device_ms", "bound_ms")}
                  for c in bwd_cases if c["dtype"] == dtype_name]}


def bf16_backward_paths(loop_run, ctc_run, nar_run, wide_run, families_run, dp_run):
    """The bf16 backward kernel's launches on every bf16 path that trains
    besides phase 7's: {key: (launches, where)}."""
    per_rank = dp_run["per_rank"]
    return {
        "loop": (loop_run["launches"]["seen"][2],
                 "flagship loop: warm-start step, 1 step, 2 evals (phase 9)"),
        "ctc_train": (ctc_run["train"]["backward_launches"],
                      f"{CTC_TRAIN_STEPS} CTC train steps on the shard (phase 14)"),
        "hybrid": (ctc_run["hybrid_step"]["backward_launches"],
                   "1 hybrid joint step, ctc_weight 0.3 (phase 14)"),
        "distill": (sum(s_["backward_launches"] for s_ in nar_run["distill"]["steps"]),
                    "6 distill steps, B4 at 816 / 304 (phase 15)"),
        "wide_step": (wide_run["step"]["backward_launches"],
                      "configs/wide_d1024.json joint step, B8, D 128 (phase 17)"),
        "family_steps": (sum(families_run[k]["step"]["backward_launches"]
                             for k in ("conformer", "moe_ragged", "moe_dispatch")),
                         "conformer, MoE ragged and dispatch ae + sp steps (phase 18)"),
        "dp_flagship": (sum(r["flagship"][f"zero{z}"]["backward_launches"]
                            for r in per_rank for z in DP_FLAGSHIP_ZEROS),
                        f"dp = 2 joint steps, zero {DP_FLAGSHIP_ZEROS}, both ranks (phase 20)"),
        "tp_flagship": (sum(r["flagship"]["tp2"]["backward_launches"] for r in per_rank),
                        "one tp = 2 joint step, both ranks (phase 20)"),
        "sp_flagship": (sum(r["flagship"]["sp2"]["backward_launches"] for r in per_rank),
                        "one sp = 2 joint step, both ranks (phase 20)"),
        "pp_flagship": (sum(r["flagship"]["pp2"]["backward_launches"] for r in per_rank),
                        "one pp = 2 joint step, both ranks (phase 20)"),
        "wide_sp": (sum(r["wide_sp2"]["backward_launches"] for r in per_rank),
                    f"configs/wide_d1024.json joint step at sp = 2, B{WIDE_SP_BATCH}, D 128, "
                    "both ranks (phase 20)")}


def f32_backward_paths(tiny_train, loop_run, ctc_run, nar_run, families_run, dp_run):
    """The float32 backward kernel's launches on every float32 path that
    trains besides phase 8's flagship step: {key: (launches, where)}."""
    mesh = [c for r in dp_run["per_rank"] for c in r["tiny"].values()
            if "backward_launches_f32" in c]
    mesh4 = [r[k] for r in dp_run["dp2_tp2"]["per_rank"] for k in MESH4_KEYS]
    return {
        "tiny_train": (tiny_train["backward_launches_f32"],
                       "TINY train step on the card against the CPU (phase 8)"),
        "loop": (loop_run["tiny_gpu_vs_cpu"]["backward_launches_f32"],
                 "configs/transformer_test.json loop on the card, 2 epochs, D 32 (phase 9)"),
        "ctc_tiny": (ctc_run["tiny_gpu_vs_cpu"]["backward_launches_f32"],
                     "TINY CTC checks (phase 14): no gradient reaches attention"),
        "nar_tiny": (nar_run["tiny_gpu_vs_cpu"]["step"]["backward_launches_f32"],
                     "TINY distill step on the card (phase 15)"),
        "family_tiny": (families_run["tiny_gpu_vs_cpu"]["backward_launches_f32"],
                        "TINY MoE stacks under remat dots_all and scan, their "
                        "gradients on the card (phase 18)"),
        "mesh_tiny": (sum(c["backward_launches_f32"] for c in mesh + mesh4),
                      "TINY mesh steps (dp zero 0/1/3, MoE dp, tp, ep, sp, pp, sp "
                      "with remat, MoE and RNN; dp 2 x tp 2, dp 2 x pp 2, tp 2 x pp "
                      "2, ep 2 x pp 2, sp 2 x pp 2), every rank (phase 20)")}


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


def compare_train_steps(lr, pairs, metrics, state=None):
    """Largest differences between two results of one step from the same
    params, b the reference. `pairs` maps a name to (new params a, new
    params b, optimizer state a, optimizer state b), each state with Adam's
    first moment `mu` on its params' tree; `metrics` is (metrics a, metrics
    b) and `state` (net state a, net state b). Gives the metrics (relative),
    the net state (absolute), per name the first moments relative to
    1e-4 |b| + 1e-5 of b's largest (<name>_mu_scaled), and over every pair
    the normalised update (a - b) / lr where b's first moment is above
    1e-7 (update_abs) and anywhere (update_abs_all: a first Adam step
    moves an element by about lr, so a sign that rounding decides costs 2
    at most)."""
    from unast_tpu_torch.train.optim import tree_paths as flat
    ma, mb = metrics
    out = {"metrics_rel": max(abs(float(ma[k]) - float(mb[k])) / abs(float(mb[k]))
                              for k in mb)}
    if state is not None:
        fb = flat(state[1])
        out["state_abs"] = max((_max_abs(x, fb[k]) for k, x in flat(state[0]).items()),
                               default=0.0)
    big = loose = 0.0
    for name, (pa, pb, oa, ob) in pairs.items():
        fa, fb, mua, mub = flat(pa), flat(pb), flat(oa.mu), flat(ob.mu)
        mub = {k: x.detach().cpu() for k, x in mub.items()}
        top = max(float(x.abs().max()) for x in mub.values())
        out[f"{name}_mu_scaled"] = max(
            float(((mua[k].detach().cpu() - x).abs() / (1e-4 * x.abs() + 1e-5 * top)).max())
            for k, x in mub.items())
        for k, m in mub.items():
            d = (fa[k].detach().cpu().double() - fb[k].detach().cpu().double()) / lr
            sel = m.abs() > 1e-7
            if bool(sel.any()):
                big = max(big, float(d[sel].abs().max()))
            loose = max(loose, float(d.abs().max()))
    out["update_abs"], out["update_abs_all"] = big, loose
    return out


def joint_step_comparison(a, b):
    """compare_train_steps's pairs, metrics and state for two (TrainState,
    metrics) results of the joint step: the generator's partition and the
    discriminator's, each with its own optimizer."""
    (ta, ma), (tb, mb) = a, b
    gen = lambda p: {k: v for k, v in p.items() if k != "discriminator"}
    return {"pairs": {"gen": (gen(ta.params), gen(tb.params), ta.gen_opt, tb.gen_opt),
                      "disc": (ta.params["discriminator"], tb.params["discriminator"],
                               ta.disc_opt, tb.disc_opt)},
            "metrics": (ma, mb), "state": (ta.net_state, tb.net_state)}


def _max_abs(a, b):
    return float((a.detach().float().cpu() - b.detach().float().cpu()).abs().max())


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
    fn.backward_launches = fn.backward_launches_bf16 = fn.backward_launches_f32 = 0


def bwd_launches(fa):
    """The backward kernels' launch counts by route, for a record."""
    return {"backward_launches_bf16": fa.backward_launches_bf16,
            "backward_launches_f32": fa.backward_launches_f32}


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
            before = (fa.launches_bf16, fa.launches_f32, fa.backward_calls,
                      fa.backward_launches, fa.backward_launches_bf16,
                      fa.backward_launches_f32)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec = {"kind": kind, "s": time.perf_counter() - t,
                   "launches_bf16": fa.launches_bf16 - before[0],
                   "launches_f32": fa.launches_f32 - before[1],
                   "backward_calls": fa.backward_calls - before[2],
                   "backward_launches": fa.backward_launches - before[3],
                   "backward_launches_bf16": fa.backward_launches_bf16 - before[4],
                   "backward_launches_f32": fa.backward_launches_f32 - before[5]}
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
        L.make_train_step = lambda cfg, args, **kw: self._wrap(
            "step" if args.ae_steps or args.cm_steps else "warm_start_step",
            make(cfg, args, **kw))
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
        seen = [fa.launches_bf16, fa.backward_calls - bwd0, fa.backward_launches]
        assert seen == expected + expected[1:] and fa.launches_f32 == 0, (
            seen, expected, fa.launches_f32)
        for c in probe.calls:
            assert [c["launches_bf16"], c["backward_calls"]] == list(per_kind[c["kind"]]), c
            assert (c["backward_launches"] == c["backward_launches_bf16"]
                    == c["backward_calls"] and c["backward_launches_f32"] == 0), c
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
            bwd_routes = bwd_launches(fa)
            _, expected = loop_expected(loop, args, loop.model_config_from_args(args),
                                        2, 3)
            run("resumed", "cuda", 1)
            resumed, _, _ = run("resumed", "cuda", 2, auto_resume="true")
    finally:
        loop.model_config_from_args = make_cfg
    out = {"config": os.path.relpath(TEST_CONFIG, ROOT), "cpu_s": cpu_s, "gpu_s": gpu_s,
           "launches_f32": seen[0], "backward_calls": seen[1],
           "expected": expected, "launches_bf16": fa.launches_bf16,
           **bwd_routes,
           "card_vs_cpu": compare_records(on_gpu, on_cpu),
           "resume_vs_unbroken": compare_records(resumed, on_gpu, steps={3, 4})}
    # float32 on both; metrics 1e-4 relative (tests/test_torch_loop.py's
    # tolerance against the JAX loop), PER equal
    out["ok"] = all(c["keys_equal"] and c["per_equal"] and c["max_rel_err"] <= 1e-4
                    for c in (out["card_vs_cpu"], out["resume_vs_unbroken"]))
    assert out["ok"], out
    # the 2-epoch run on the card: each backward call one launch of the
    # float32 backward kernel, none of the bf16 one
    assert seen == expected and out["launches_bf16"] == 0, out
    assert (out["backward_launches_f32"], out["backward_launches_bf16"]) == (
        seen[1], 0) and seen[1] > 0, out
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
    """Phase 11: RNN_TRAIN_STEPS of make_train_step on configs/rnn_d.json
    with its own train args (adam, multistep, B2, ae 1 / cm 2 / sp 1 / d 1)
    on synthetic batches at 816 frames / 304 tokens (numpy seed 0), random
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
    for i in range(RNN_TRAIN_STEPS):
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
    assert not nonfinite and ts.step == RNN_TRAIN_STEPS, nonfinite

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
            **compare_train_steps(targs.lr, **joint_step_comparison(on_gpu, on_cpu))}
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
        "first_step_s": steps[0]["s"],
        "later_step_s": [s_["s"] for s_ in steps[1:]],
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
    }, (params, vstate)


def _run_cli(module, argv):
    """python -m module *argv from the repo root, as a user runs it: its
    (wall seconds, stdout); a non-zero exit fails the phase."""
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module] + argv, cwd=ROOT,
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"{module} exited {out.returncode}:\n{out.stdout}\n"
                         f"{out.stderr}")
    return time.perf_counter() - t, out.stdout


def data_phase(root):
    """Phase 13: data on the card. A corpus of DATA_CLIPS synthetic clips
    (wavs/<id>.wav PCM16 and metadata.csv) under `root`, prepared by
    `python -m unast_tpu_torch.data.prepare` on the card (--batch 8
    --bucket_s 11 --f0 --shard_out --wav_shard_out) and again with --cpu
    (the numpy DSP): caches within 5e-4 of each other (F0 equal), the
    mel shard equal to the card's caches through float16 and to the
    phonemized transcripts, the wav shard's trimmed clips aligned with the
    mel frames, BatchIterator's shard path equal to its item path, and
    `python -m unast_tpu_torch.data.shard` on the card. Returns its record;
    the card's shard and caches stay under `root` for phase 14."""
    from unast_tpu_torch.data.batching import BatchIterator
    from unast_tpu_torch.data.dataset import SyntheticSpeechDataset, load_manifest
    from unast_tpu_torch.data.shard import PackedShardDataset, WavShardDataset
    from unast_tpu_torch.infer.synthesize import write_wav
    from unast_tpu_torch.text import raw_text_to_phoneme_ids
    t_phase = time.perf_counter()
    ds = SyntheticSpeechDataset(size=DATA_CLIPS, seed=0, n_words=(1, 20))
    rng = np.random.default_rng(8)
    os.makedirs(os.path.join(root, "wavs"))
    rows, clip_s = [], []
    for i in range(DATA_CLIPS):
        fid = f"SYN-{i:04d}"
        wav = np.concatenate([1e-4 * rng.normal(size=int(rng.integers(1000, 9000))),
                              ds[i]["wav"], 1e-4 * rng.normal(size=3000)])
        write_wav(os.path.join(root, "wavs", fid + ".wav"), wav.astype(np.float32))
        rows.append(f"{fid}|{ds._texts[i]}|{ds._texts[i]}")
        clip_s.append(len(wav) / 22050)
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    runs = {}
    for name, extra in (("device", ["--batch", "8", "--bucket_s", "11"]),
                        ("cpu", ["--cpu"])):
        wall, out = _run_cli("unast_tpu_torch.data.prepare", [
            "--data_path", root, "--cache_dir", os.path.join(root, name), "--f0",
            "--shard_out", os.path.join(root, f"{name}.unsh"),
            "--wav_shard_out", os.path.join(root, f"{name}.unwv")] + extra)
        done = next(x for x in out.splitlines() if x.startswith("[prepare] done"))
        prep_s = float(done.split(" in ")[1].split()[0])
        runs[name] = {"wall_s": wall, "prepare_s": prep_s,
                      "s_per_clip": prep_s / DATA_CLIPS}
    names = sorted(os.listdir(os.path.join(root, "cpu")))
    assert names == sorted(os.listdir(os.path.join(root, "device"))), names
    assert len(names) == 3 * DATA_CLIPS, len(names)
    err = {"mel": 0.0, "mag": 0.0}
    frames = 0
    for name in names:
        a = np.load(os.path.join(root, "device", name))
        b = np.load(os.path.join(root, "cpu", name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        kind = name.split(".")[-2]
        if kind == "f0":
            assert np.array_equal(a, b), name
        else:
            err[kind] = max(err[kind], float(np.abs(a - b).max()))
            frames += len(a) if kind == "mel" else 0
    # tests/test_audio.py::test_wav_to_mel_matches_jax's bound
    assert max(err.values()) <= 5e-4, err
    shard = PackedShardDataset(os.path.join(root, "device.unsh"))
    wshard = WavShardDataset(os.path.join(root, "device.unwv"))
    manifest = load_manifest(os.path.join(root, "metadata.csv"))
    assert len(shard) == len(wshard) == DATA_CLIPS
    aligned = 0
    for i, (fid, text) in enumerate(manifest):
        item = shard[i]
        mel = np.load(os.path.join(root, "device", fid + ".mel.npy"))
        assert np.array_equal(item["mel"], mel.astype(np.float16).astype(np.float32)), fid
        assert np.array_equal(item["ids"], np.asarray(raw_text_to_phoneme_ids(text),
                                                      np.int32)), fid
        aligned += int(1 + int(wshard.lens([i])[0]) // 275 == len(mel))
    assert aligned == DATA_CLIPS, aligned

    class Items:
        """The shard's items without its collate_batch: BatchIterator's
        item path."""
        def __len__(self):
            return len(shard)

        def __getitem__(self, i):
            return shard[i]
    batch_ms = {}
    for label, kw in (("fixed", {}), ("buckets", {"text_buckets": [64, 128, 304],
                                                   "mel_buckets": [256, 512, 816]})):
        fast = BatchIterator(shard, 4, 304, 816, seed=3, **kw)
        slow = BatchIterator(Items(), 4, 304, 816, seed=3, **kw)
        ms = [0.0, 0.0]
        for _ in range(6):
            t = time.perf_counter()
            a = fast.next_batch()
            ms[0] += (time.perf_counter() - t) * 1e3 / 6
            t = time.perf_counter()
            b = slow.next_batch()
            ms[1] += (time.perf_counter() - t) * 1e3 / 6
            assert a.keys() == b.keys() and all(
                np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b), label
        for a, b in zip(fast.next_stacked(2), slow.next_stacked(2)):
            assert np.array_equal(a, b), label
        batch_ms[label] = {"shard_path_ms": ms[0], "item_path_ms": ms[1]}
    shard_cli_s, _ = _run_cli("unast_tpu_torch.data.shard", [
        "--out", os.path.join(root, "synthetic.unsh"), "--synthetic",
        "--synthetic_size", "4"])
    assert len(PackedShardDataset(os.path.join(root, "synthetic.unsh"))) == 4
    return {
        "clips": DATA_CLIPS, "clip_s": clip_s, "frames": frames, "prepare": runs,
        "cache_max_abs_err": err, "f0_equal": True, "shard_mel_bytes":
            os.path.getsize(os.path.join(root, "device.unsh")),
        "shard_wav_bytes": os.path.getsize(os.path.join(root, "device.unwv")),
        "wav_shard_aligned": aligned, "batches": batch_ms,
        "shard_cli_s": shard_cli_s, "phase_s": time.perf_counter() - t_phase,
    }


def _tiny_margin(logits, valid):
    """Least lead of a greedy choice over its runner-up (float32 logits)."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1])[valid].min())


def ctc_tiny_checks(fa):
    """Phase 14's TINY float32 checks, card against CPU (flash on, so the
    float32 kernel on the card): ctc_logits under the absolute PE, the
    chunk mask and the relative bias within 1e-4, greedy ids equal with
    the CPU's margins above 1e-3; ctc_stream_step on the card within 1e-4
    of the chunk-masked forward; ctc_loss and its gradient (a batch with
    an unfit row: the rows that fit) within 1e-4 relative; on a joint
    TINY model with ctc_weight 0.3, the CTC draft, the speculative decode,
    the greedy decode and the beam search with ids equal (the CPU's
    teacher-forced margins above 1e-3); and Synthesizer(ctc_pv=)'s
    asr_ids under every option equal."""
    from unast_tpu_torch import nn
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import TINY, ctc as C, networks as N, unast as U
    from unast_tpu_torch.nn import tree_to
    ectx = nn.Ctx.eval()
    rng = np.random.default_rng(5)
    lens = torch.tensor([20, 13])
    mel = torch.from_numpy(rng.uniform(size=(2, 20, 80)).astype(np.float32))
    mel *= (torch.arange(20) < lens[:, None])[..., None]
    field = dict(ctc_chunk=4, ctc_left=1)
    p_rel, s0 = C.ctc_asr_init(torch.Generator().manual_seed(0),
                               TINY.replace(ctc_pos="rel", **field))
    p_abs = {k: v for k, v in p_rel.items() if k != "rel_pos"}
    out = {"logits": {}}
    reset_launch_counts(fa)
    bwd0 = fa.backward_calls
    for name, cfg, p in (("abs_flash", TINY.replace(attn_impl="flash"), p_abs),
                         ("chunk", TINY.replace(**field), p_abs),
                         ("rel", TINY.replace(ctc_pos="rel", **field), p_rel)):
        lc, pc, _ = C.ctc_logits(p, s0, ectx, cfg, mel, lens)
        lg, pg, _ = C.ctc_logits(tree_to(p, "cuda"), tree_to(s0, "cuda"), ectx, cfg,
                                 mel.cuda(), lens.cuda())
        ids_c = C.ctc_greedy_decode(lc, pc, cfg.max_text_len)
        ids_g = C.ctc_greedy_decode(lg, pg, cfg.max_text_len)
        rec = {"max_abs_err": float((lg.cpu() - lc).abs().max()),
               "ids_equal": all(torch.equal(a.cpu(), b) for a, b in zip(ids_g, ids_c)),
               "cpu_min_margin": _tiny_margin(lc, ~pc)}
        if cfg.ctc_chunk:
            carry = C.ctc_stream_init(tree_to(p, "cuda"), cfg, 2, "cuda")
            chunks = []
            for c0 in range(0, 20, cfg.ctc_chunk):
                carry, lgc, _ = C.ctc_stream_step(
                    tree_to(p, "cuda"), ectx, cfg, carry, mel[:, c0:c0 + 4].cuda(),
                    ~pg[:, c0:c0 + 4])
                chunks.append(lgc)
            rec["stream_max_abs_err"] = float(
                (torch.cat(chunks, 1) - lg)[~pg].abs().max())
        out["logits"][name] = rec
        assert (rec["max_abs_err"] <= 1e-4 and rec["ids_equal"]
                and rec["cpu_min_margin"] > 1e-3
                and rec.get("stream_max_abs_err", 0.0) <= 1e-4), (name, rec)
    out["launches_f32"] = fa.launches_f32
    assert fa.launches_f32 == TINY.num_layers and fa.launches_bf16 == 0, out

    lrng = np.random.default_rng(6)
    logits = torch.from_numpy(lrng.normal(size=(3, 10, 47)).astype(np.float32))
    pad = torch.arange(10)[None] >= torch.tensor([10, 7, 4])[:, None]
    labels = torch.tensor([[4, 8, 8, 15, 23, 42], [6, 6, 11, 0, 0, 0],
                           [3, 9, 27, 14, 40, 0]])
    label_lens = torch.tensor([6, 3, 5])
    res = []
    for dev in ("cpu", "cuda"):
        x = logits.to(dev).requires_grad_(True)
        loss = C.ctc_loss(x, pad.to(dev), labels.to(dev), label_lens.to(dev))
        res.append((float(loss.detach()), torch.autograd.grad(loss, x)[0].cpu()))
    (lc, gc), (lg, gg) = res
    out["loss"] = {"value_rel_err": abs(lg - lc) / abs(lc), "value": lc,
                   "grad_rows_fit_max_abs_err": float((gg[:2] - gc[:2]).abs().max()),
                   "grad_max": float(gc.abs().max())}
    assert (out["loss"]["value_rel_err"] <= 1e-4 and out["loss"]["grad_rows_fit_max_abs_err"]
            <= 1e-4 * out["loss"]["grad_max"]), out["loss"]

    jcfg = TINY.replace(attn_impl="flash", ctc_weight=0.3)
    jp, js = U.unast_init(torch.Generator().manual_seed(0), jcfg)
    dec = {}
    for dev in ("cpu", "cuda"):
        p, s = tree_to(jp, dev), tree_to(js, dev)
        with torch.inference_mode():
            (enc, mask), _ = N.speech_encode(p["speech_m"], s["speech_m"], ectx, jcfg,
                                             mel.to(dev), lens.to(dev))
            logits = nn.linear(p["speech_m"]["ctc_head"], enc).float()
            draft, _ = C.ctc_greedy_decode(logits, mask, jcfg.max_text_len)
            spec = N.text_tr_spec_infer(p["text_m"], ectx, jcfg, enc, mask, draft)
            greedy = N.text_tr_infer(p["text_m"], ectx, jcfg, enc, mask)
            beam = N.text_tr_beam_search(p["text_m"], ectx, jcfg, enc, mask, beam=3)
            if dev == "cpu":
                tf = N.text_tr_decode_sequence(
                    p["text_m"], ectx, jcfg, greedy[0],
                    torch.full_like(greedy[1], jcfg.max_text_len), enc, mask)
                valid = torch.arange(jcfg.max_text_len)[None] < greedy[1][:, None]
                out["ar_cpu_min_margin"] = _tiny_margin(tf, valid)
                out["draft_cpu_min_margin"] = _tiny_margin(logits, ~mask)
        dec[dev] = [t.cpu() if torch.is_tensor(t) else t for t in (
            draft, *spec, *greedy, *beam)]
    out["decodes_equal"] = all(
        (torch.equal(a, b) if torch.is_tensor(a) else a == b)
        for a, b in zip(dec["cpu"], dec["cuda"]))
    out["spec_rounds"] = dec["cpu"][3]
    out["spec_equals_greedy"] = bool(torch.equal(dec["cpu"][1], dec["cpu"][4]))
    assert (out["decodes_equal"] and out["spec_equals_greedy"]
            and out["ar_cpu_min_margin"] > 1e-3 and out["draft_cpu_min_margin"] > 1e-3), out
    kw = dict(mel_buckets=(16, 24), max_batch=4)
    mels = [mel[i, :int(lens[i])].numpy() for i in range(2)]
    syns = [Synthesizer(jp, js, jcfg, ctc_pv=(p_abs, s0), device=d, **kw)
            for d in ("cpu", "cuda")]
    out["synthesizer_ids_equal"] = {}
    for name, kw_ in (("ctc", {}), ("ctc_beam", {"ctc_beam": 3}), ("spec", {"spec": True}),
                      ("beam", {"beam": 3})):
        a, b = (s_.asr_ids(mels, **kw_) for s_ in syns)
        out["synthesizer_ids_equal"][name] = all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(out["synthesizer_ids_equal"].values()), out
    # no gradient here reaches attention (ctc_loss's is of the logits):
    # the float32 backward kernel's launches equal the backward calls, 0
    out["backward_calls"] = fa.backward_calls - bwd0
    out.update(bwd_launches(fa))
    assert out["backward_calls"] == out["backward_launches_f32"] == 0, out
    assert out["backward_launches_bf16"] == 0, out
    return out


def ctc_phase(fa, flag_params, flag_state, flag_cfg, root):
    """Phase 14: the CTC family at flagship width (configs/
    transformer_d_curriculum_fast.json, bf16, attn_impl='flash').
    CTC_TRAIN_STEPS steps of train/ctc.py's make_ctc_step on phase 13's
    shard (the config's adamw and batch 4 at 816 frames / 304 tokens),
    counts set to 0 just before and read just after (one encoder a step:
    num_layers forwards and backward calls); Synthesizer(ctc_pv=) on the
    flagship AR model (phase 4's weights) and the trained CTC model
    serving 8 of the corpus's mels at the 816-frame bucket one-pass, with
    ctc_beam 4 and spec=True, and the plain AR model with beam 4 (and
    greedy, which spec equals in float32), each with its batch latency and
    launches; one hybrid joint step (ctc_weight 0.3, cm_text_decode
    'spec') on micro-batches from the shard, its launches and backward
    calls as the code implies for its verify rounds; the TINY float32
    checks of ctc_tiny_checks; scripts/ctc_check.py's gate on the port
    (d 64, 2 layers, the synthetic corpus of 4, CTC_GATE_STEPS steps,
    greedy PER < 0.05)."""
    from unast_tpu_torch.data.batching import BatchIterator
    from unast_tpu_torch.data.dataset import SyntheticSpeechDataset
    from unast_tpu_torch.data.shard import PackedShardDataset
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import networks as N
    from unast_tpu_torch.train import ctc as TC, init_train_state, make_train_step
    from unast_tpu_torch.train.config import (model_config_from_args,
                                              parse_with_config, train_args)
    from unast_tpu_torch.train.optim import tree_paths
    from unast_tpu_torch.train.steps import flash_calls_per_step, seeded_generator
    t_phase = time.perf_counter()
    cfg = flag_cfg
    args = train_args(CONFIG)
    shard = PackedShardDataset(os.path.join(root, "device.unsh"))
    it = BatchIterator(shard, args.train_batch_size, args.data_text_len,
                       args.data_mel_len, seed=args.seed + 1)
    ts = TC.init_ctc_state(torch.Generator().manual_seed(0), cfg, args)
    step = TC.make_ctc_step(cfg, args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fa)
    bwd0 = fa.backward_calls
    step_s, losses = [], []
    for i in range(CTC_TRAIN_STEPS):
        batch = TC.batch_to(it.next_batch(), "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        ts, m = step(ts, seeded_generator(1, i, "cuda"), batch)
        losses.append(float(m["ctc/loss"]))
        step_s.append(time.perf_counter() - t)
    train_counts = [fa.launches_bf16, fa.launches_f32, fa.backward_calls - bwd0,
                    fa.backward_launches, fa.backward_launches_f32]
    train_peak = torch.cuda.max_memory_allocated()
    n_train = cfg.num_layers * CTC_TRAIN_STEPS
    assert np.isfinite(losses).all() and all(
        bool(torch.isfinite(x).all()) for x in tree_paths(ts.params).values()), losses
    assert train_counts == [n_train, 0, n_train, n_train, 0], train_counts

    mels = sorted((np.load(os.path.join(root, "device", f))[:816]
                   for f in os.listdir(os.path.join(root, "device")) if f.endswith(".mel.npy")),
                  key=len)[-8:]
    assert len(mels[-1]) > 512   # the 816-frame bucket
    syn = Synthesizer(flag_params, flag_state, cfg, ctc_pv=(ts.params, ts.net_state))
    syn_ar = Synthesizer(flag_params, flag_state, cfg)
    syn.asr_ids(mels[:1])
    serve = {}
    for name, s_, kw in (("ctc", syn, {}), ("ctc_beam", syn, {"ctc_beam": 4}),
                         ("spec", syn, {"spec": True}), ("beam", syn_ar, {"beam": 4}),
                         ("greedy", syn_ar, {})):
        reset_launch_counts(fa)
        rounds0 = N.text_tr_spec_infer.rounds
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids = s_.asr_ids(mels, **kw)
        torch.cuda.synchronize()
        rounds = N.text_tr_spec_infer.rounds - rounds0
        serve[name] = {"batch_s": time.perf_counter() - t,
                       "launches_bf16": fa.launches_bf16, "launches_f32": fa.launches_f32,
                       "ids_lens": [len(x) for x in ids], "spec_rounds": rounds}
        serve[name]["ids"] = ids
        expected = cfg.num_layers * (2 + 2 * rounds if name == "spec" else 1)
        assert (fa.launches_bf16, fa.launches_f32) == (expected, 0), (name, serve[name])
    serve["spec"]["equals_greedy_rows"] = sum(
        np.array_equal(a, b) for a, b in zip(serve["spec"].pop("ids"),
                                             serve["greedy"]["ids"]))
    for rec in serve.values():
        rec.pop("ids", None)

    hcfg = cfg.replace(ctc_weight=0.3)
    hargs = train_args(CONFIG, cm_text_decode="spec")
    hts = init_train_state(torch.Generator().manual_seed(0), hcfg, hargs)
    hit = BatchIterator(shard, hargs.train_batch_size, hargs.data_text_len,
                        hargs.data_mel_len, seed=hargs.seed + 2)
    hbatches = {k: tuple(torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x)
                         .cuda() for x in hit.next_stacked(getattr(hargs, f"{k}_steps")))
                for k in ("ae", "cm", "sp", "d")}
    hstep = make_train_step(hcfg, hargs)
    reset_launch_counts(fa)
    bwd0, rounds0 = fa.backward_calls, N.text_tr_spec_infer.rounds
    torch.cuda.synchronize()
    t = time.perf_counter()
    hts, hm = hstep(hts, torch.Generator(device="cuda").manual_seed(0), hbatches)
    torch.cuda.synchronize()
    hybrid_s = time.perf_counter() - t
    rounds = N.text_tr_spec_infer.rounds - rounds0
    fwd, bwd = flash_calls_per_step(hcfg, hargs, rounds)
    hybrid = {"s": hybrid_s, "metrics": {k: float(v) for k, v in hm.items()},
              "spec_rounds": rounds, "launches_bf16": fa.launches_bf16,
              "launches_f32": fa.launches_f32, "backward_calls": fa.backward_calls - bwd0,
              "backward_launches": fa.backward_launches, **bwd_launches(fa),
              "expected": [fwd, bwd]}
    assert all(np.isfinite(v) for v in hybrid["metrics"].values()), hybrid
    assert "sp/ctc_sp" in hybrid["metrics"], hybrid["metrics"]
    assert (hybrid["launches_bf16"], hybrid["launches_f32"], hybrid["backward_calls"],
            hybrid["backward_launches"], hybrid["backward_launches_f32"]) == (
                fwd, 0, bwd, bwd, 0), hybrid

    tiny = ctc_tiny_checks(fa)

    gargs = parse_with_config(CTC_GATE_ARGV)
    gcfg = model_config_from_args(gargs)
    gds = SyntheticSpeechDataset(size=4, seed=0, phoneme_dur_s=0.04)
    git = BatchIterator(gds, 4, gargs.data_text_len, gargs.data_mel_len, seed=gargs.seed + 1)
    eval_batch = BatchIterator(gds, 4, gargs.data_text_len, gargs.data_mel_len,
                               seed=9).next_batch()
    gts = TC.init_ctc_state(torch.Generator().manual_seed(0), gcfg, gargs)
    gstep = TC.make_ctc_step(gcfg, gargs)
    per0 = TC.eval_per(gts, gcfg, eval_batch)
    gate_losses = {}
    t = time.perf_counter()
    for i in range(CTC_GATE_STEPS):
        gts, gm = gstep(gts, seeded_generator(1, i, "cuda"),
                        TC.batch_to(git.next_batch(), "cuda"))
        if (i + 1) % 200 == 0:
            gate_losses[i + 1] = float(gm["ctc/loss"])
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t
    per = TC.eval_per(gts, gcfg, eval_batch)
    gate = {"steps": CTC_GATE_STEPS, "s": gate_s, "untrained_per": per0,
            "per": per, "losses": gate_losses, "attn_impl": gcfg.attn_impl}
    assert per < 0.05, gate
    return {
        "config": os.path.relpath(CONFIG, ROOT), "attn_impl": cfg.attn_impl,
        "compute_dtype": cfg.compute_dtype,
        "train": {"steps": CTC_TRAIN_STEPS, "batch": args.train_batch_size,
                  "mel_len": args.data_mel_len, "text_len": args.data_text_len,
                  "step_s": step_s, "losses": losses,
                  "max_memory_allocated_bytes": train_peak,
                  "flash_launches_bf16": train_counts[0],
                  "flash_launches_f32": train_counts[1],
                  "backward_calls": train_counts[2],
                  "backward_launches": train_counts[3]},
        "serve": {"requests": len(mels), "mel_lens": [len(m) for m in mels], **serve},
        "hybrid_step": hybrid, "tiny_gpu_vs_cpu": tiny, "ctc_check_gate": gate,
        "phase_s": time.perf_counter() - t_phase,
    }, (ts.params, ts.net_state)


def nar_tiny_checks(fa):
    """Phase 15's TINY float32 checks, card against CPU (flash on, so the
    float32 kernel on the card): a FastSpeech student with the pitch and
    energy adaptors (duration bias raised by NAR_DUR_BIAS): the forward
    with teacher durations and targets and free-running (speed, pitch
    shift, energy scale) within 1e-4, lengths equal; every duration source
    over a TINY teacher with ctc_weight 0.3 equal; one argmax distill step
    with every dropout at 0 (phase 8's tolerances); Synthesizer(nar_pv=)'s
    mels within 1e-4."""
    from unast_tpu_torch import nn
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import TINY, fastspeech as FS, unast_init
    from unast_tpu_torch.nn import tree_to
    from unast_tpu_torch.train import fastspeech as TF
    from unast_tpu_torch.train.config import train_args
    from unast_tpu_torch.train.steps import ZERO_DROPOUTS, zero_fixed_dropouts
    cfg = TINY.replace(attn_impl="flash", nar_pitch=True, nar_energy=True)
    p, s = FS.fastspeech_init(torch.Generator().manual_seed(0), cfg)
    p["dur"]["fc"]["b"] += NAR_DUR_BIAS
    pg, sg = tree_to(p, "cuda"), tree_to(s, "cuda")
    rng = np.random.default_rng(15)
    tl = torch.tensor([8, 5])
    text = torch.from_numpy(rng.integers(3, 46, size=(2, 8))) * (torch.arange(8) < tl[:, None])
    dur = torch.from_numpy(rng.integers(0, 5, size=(2, 8))) * (torch.arange(8) < tl[:, None])
    f0 = torch.from_numpy(rng.uniform(5.0, 6.0, size=(2, 8)).astype(np.float32))
    en = torch.from_numpy(rng.uniform(0.2, 0.5, size=(2, 8)).astype(np.float32))
    ectx = nn.Ctx.eval()
    reset_launch_counts(fa)
    out = {}
    for name, kw in (("teacher", dict(durations=dur, pitch_target=f0, energy_target=en,
                                      max_len=32)),
                     ("free", dict(max_len=64, speed=1.25, pitch_shift=1.2,
                                   energy_scale=0.9))):
        (a, b_, c_, d_), _ = FS.fastspeech_forward(p, s, ectx, cfg, text, tl, **kw)
        on = {k: v.to("cuda") if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        (ag, bg, cg, dg), _ = FS.fastspeech_forward(pg, sg, ectx, cfg, text.to("cuda"),
                                                     tl.to("cuda"), **on)
        out[name] = {"pre": _max_abs(ag, a), "post": _max_abs(bg, b_),
                     "log_dur": _max_abs(dg, d_),
                     "lens_equal": bool(torch.equal(cg.cpu(), c_))}
    forward_launches = fa.launches_f32

    tcfg = TINY.replace(attn_impl="flash", ctc_weight=0.3)
    tp, ts = unast_init(torch.Generator().manual_seed(0), tcfg)
    ml = torch.tensor([20, 13])
    batch = {"text": text, "text_len": tl, "mel_len": ml,
             "mel": torch.from_numpy(rng.uniform(size=(2, 20, 80)).astype(np.float32))
             * (torch.arange(20) < ml[:, None])[..., None],
             "f0": torch.from_numpy(rng.uniform(80, 300, size=(2, 20)).astype(np.float32))
             * (torch.arange(20) < ml[:, None])}
    gbatch = {k: v.to("cuda") for k, v in batch.items()}
    tpg, tsg = tree_to(tp, "cuda"), tree_to(ts, "cuda")
    sources = {}
    with torch.no_grad():
        for source in NAR_SOURCES:
            args = train_args(CONFIG, nar_dur_source=source)
            a = TF.teacher_durations(source, tp, ts, tcfg, args, batch)
            b_ = TF.teacher_durations(source, tpg, tsg, tcfg, args, gbatch)
            sources[source] = bool(torch.equal(a, b_.cpu()))
    out["durations_equal"] = sources

    scfg = cfg.replace(**ZERO_DROPOUTS)
    args = train_args(CONFIG, nar_dur_source="argmax", sched_type="none", lr=1e-3)
    step = TF.make_distill_step(scfg, tcfg, args)
    tx = TF.make_optimizer(args, TF.make_schedule(args))
    with zero_fixed_dropouts():
        on_cpu, m_cpu = step(TF.FSTrainState(p, s, tx.init(p), 0), tp, ts,
                             torch.Generator().manual_seed(0), batch)
        reset_launch_counts(fa)
        bwd0 = fa.backward_calls
        on_gpu, m_gpu = step(TF.FSTrainState(pg, sg, tx.init(pg), 0), tpg, tsg,
                             torch.Generator(device="cuda").manual_seed(0), gbatch)
        torch.cuda.synchronize()
    out["step"] = {
        "launches_f32": fa.launches_f32, "backward_calls": fa.backward_calls - bwd0,
        "backward_launches": fa.backward_launches, **bwd_launches(fa),
        "expected": list(TF.flash_calls_per_distill_step(scfg, tcfg, args)),
        **compare_train_steps(
            args.lr, {"student": (on_gpu.params, on_cpu.params, on_gpu.opt, on_cpu.opt)},
            (m_gpu, m_cpu), (on_gpu.net_state, on_cpu.net_state))}

    kw = dict(text_buckets=(8, 16), mel_buckets=(24,), max_batch=2)
    syn_cfg = cfg.replace(ctc_weight=0.3)
    mels = [Synthesizer(tp, ts, syn_cfg, nar_pv=(p, s), device=d, **kw).tts_mels(SENTENCES[:3])
            for d in ("cpu", "cuda")]
    out["synth_mels"] = max(float(np.abs(a - b_).max()) for a, b_ in zip(*mels))
    out["synth_lens_equal"] = [len(a) for a in mels[0]] == [len(b_) for b_ in mels[1]]
    out["forward_launches_f32"] = forward_launches
    st = out["step"]
    out["ok"] = (all(max(v["pre"], v["post"], v["log_dur"]) <= 1e-4 and v["lens_equal"]
                     for v in (out["teacher"], out["free"]))
                 and all(sources.values()) and forward_launches > 0
                 and st["metrics_rel"] <= 1e-4 and st["state_abs"] <= 1e-5
                 and st["student_mu_scaled"] <= 1 and st["update_abs"] <= 1e-3
                 and st["update_abs_all"] <= 2 + 1e-3
                 and [st["launches_f32"], st["backward_calls"]] == st["expected"]
                 and st["backward_launches"] == st["backward_launches_f32"]
                 == st["backward_calls"] > 0 and st["backward_launches_bf16"] == 0
                 and out["synth_mels"] <= 1e-4 and out["synth_lens_equal"])
    assert out["ok"], out
    return out


def fastspeech_phase(fa, flag_params, flag_state, flag_cfg, root):
    """Phase 15: FastSpeech at flagship width (configs/
    transformer_d_curriculum_fast.json, bf16, attn_impl='flash'). The
    student from seed 0 with its duration bias raised by NAR_DUR_BIAS (so
    the free-running lengths run to hundreds of frames), the teacher phase
    4's AR weights (for 'ctc' a fresh init with ctc_weight 0.3, whose CTC
    head it needs). Distillation on batches of phase 13's shard (B4 at
    816 frames / 304 tokens, the config's adamw): NAR_STEP_SOURCES, one
    step each, the first two argmax steps timed apart; each with its
    seconds and its flash launches and backward calls against
    train/fastspeech.py::flash_calls_per_distill_step (counts set to 0
    just before, read just after), losses and params finite, the peak
    memory. Then Synthesizer(nar_pv=) on the distilled student serves the
    8 SENTENCES (tts through Griffin-Lim, then tts_mels), with its batch
    latency and launches (one text encoder and one frame decoder); and
    nar_tiny_checks. Returns (record, student (params, state))."""
    from unast_tpu_torch.data.batching import BatchIterator
    from unast_tpu_torch.data.shard import PackedShardDataset
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import fastspeech as FS, unast_init
    from unast_tpu_torch.nn import tree_to
    from unast_tpu_torch.train import fastspeech as TF
    from unast_tpu_torch.train.config import train_args
    from unast_tpu_torch.train.optim import tree_paths
    from unast_tpu_torch.train.steps import seeded_generator
    t_phase = time.perf_counter()
    cfg = flag_cfg
    args = train_args(CONFIG)
    p, s = FS.fastspeech_init(torch.Generator().manual_seed(0), cfg)
    p["dur"]["fc"]["b"] += NAR_DUR_BIAS
    p, s = tree_to(p, "cuda"), tree_to(s, "cuda")
    tx = TF.make_optimizer(args, TF.make_schedule(args))
    fs = TF.FSTrainState(p, s, tx.init(p), 0)
    ctc_cfg = cfg.replace(ctc_weight=0.3)
    ctc_teacher = tree_to(unast_init(torch.Generator().manual_seed(0), ctc_cfg), "cuda")
    teacher = tree_to((flag_params, flag_state), "cuda")
    it = BatchIterator(PackedShardDataset(os.path.join(root, "device.unsh")),
                       args.train_batch_size, args.data_text_len, args.data_mel_len,
                       seed=args.seed + 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, source in enumerate(NAR_STEP_SOURCES):
        sargs = train_args(CONFIG, nar_dur_source=source)
        tcfg, (tp, ts) = ((ctc_cfg, ctc_teacher) if source == "ctc"
                          else (cfg, teacher))
        step = TF.make_distill_step(cfg, tcfg, sargs)
        batch = TF.batch_to(it.next_batch(), "cuda")
        reset_launch_counts(fa)
        bwd0 = fa.backward_calls
        torch.cuda.synchronize()
        t = time.perf_counter()
        fs, m = step(fs, tp, ts, seeded_generator(2, i, "cuda"), batch)
        torch.cuda.synchronize()
        rec = {"source": source, "s": time.perf_counter() - t,
               "metrics": {k: float(v) for k, v in m.items()},
               "launches_bf16": fa.launches_bf16, "launches_f32": fa.launches_f32,
               "backward_calls": fa.backward_calls - bwd0,
               "backward_launches": fa.backward_launches, **bwd_launches(fa),
               "expected": list(TF.flash_calls_per_distill_step(cfg, tcfg, sargs)),
               "mel_lens": batch["mel_len"].tolist(), "text_lens": batch["text_len"].tolist()}
        steps.append(rec)
        assert all(np.isfinite(v) for v in rec["metrics"].values()), rec
        assert [rec["launches_bf16"], rec["backward_calls"]] == rec["expected"], rec
        assert rec["launches_f32"] == rec["backward_launches_f32"] == 0, rec
        assert rec["backward_launches"] == rec["backward_calls"], rec
    train_peak = torch.cuda.max_memory_allocated()
    nonfinite = [k for k, x in tree_paths(fs.params).items()
                 if not bool(torch.isfinite(x).all())]
    assert not nonfinite and fs.step == len(NAR_STEP_SOURCES), nonfinite

    student = (fs.params, fs.net_state)
    syn = Synthesizer(flag_params, flag_state, cfg, nar_pv=student, device="cuda")
    syn.tts(SENTENCES[:1])
    reset_launch_counts(fa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    wavs = syn.tts(SENTENCES)
    torch.cuda.synchronize()
    tts_s = time.perf_counter() - t
    launches = [fa.launches_bf16, fa.launches_f32]
    serve_peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    mels = syn.tts_mels(SENTENCES)
    torch.cuda.synchronize()
    mels_s = time.perf_counter() - t
    for w in wavs:
        assert w.ndim == 1 and len(w) > 0 and np.isfinite(w).all(), w.shape
    assert all(np.isfinite(m).all() for m in mels)
    assert min(len(m) for m in mels) >= 100, [len(m) for m in mels]
    assert launches == [2 * cfg.num_layers, 0], launches
    tiny = nar_tiny_checks(fa)
    return {
        "config": os.path.relpath(CONFIG, ROOT), "attn_impl": cfg.attn_impl,
        "compute_dtype": cfg.compute_dtype, "dur_bias": NAR_DUR_BIAS,
        "distill": {"batch": args.train_batch_size, "mel_len": args.data_mel_len,
                    "text_len": args.data_text_len, "optim_type": args.optim_type,
                    "steps": steps, "max_memory_allocated_bytes": train_peak},
        "serve": {"requests": len(SENTENCES), "tts_batch_s": tts_s,
                  "tts_utt_per_s": len(SENTENCES) / tts_s, "tts_mels_s": mels_s,
                  "mel_frames": [len(m) for m in mels],
                  "flash_launches_bf16": launches[0], "flash_launches_f32": launches[1],
                  "max_memory_allocated_bytes": serve_peak},
        "tiny_gpu_vs_cpu": tiny, "phase_s": time.perf_counter() - t_phase,
    }, student


def melgan_tiny_checks(fa):
    """Phase 16's TINY checks, card against CPU: the MelGAN and HiFi-GAN
    forwards at base 32 and the msd+mpd discriminators within 1e-4 of the
    largest magnitude and mr_stft_loss within 1e-4 relative, in float32;
    one vocoder step and one adversarial step (msd+mpd) from the same
    weights in float64, through compare_train_steps: metrics (grad_norm
    among them) within 1e-4 relative, first moments scaled <= 1, the
    normalised update within 1e-3 where the CPU's first moment is above
    1e-7 and 2 + 1e-3 anywhere; the same steps in float32: losses within
    1e-4 relative. The float32 grad_norm is kept beside its float64 value
    as a witness, not held: the log-magnitude term weighs a bin by 1/|X|,
    so the few near-zero bins of a random generator's output dominate the
    norm, and each float32 FFT's rounding moves it by parts in a thousand
    (on the CPU, too, against float64). StreamingCtcAsr on the card fed one
    chunk a step equal to the one-shot greedy decode of the same
    chunk-masked model."""
    from unast_tpu_torch import nn
    from unast_tpu_torch.infer.streaming import StreamingCtcAsr
    from unast_tpu_torch.models import TINY, ctc as C, melgan as MG
    from unast_tpu_torch.nn import tree_to
    from unast_tpu_torch.train import melgan as TM
    from unast_tpu_torch.train.config import parse_with_config
    rng = np.random.default_rng(16)
    mel = torch.from_numpy(rng.uniform(size=(2, 8, 80)).astype(np.float32))
    n = np.arange(8 * 275)
    wav = torch.from_numpy((0.5 * np.sin(2 * np.pi * np.array([[220.0], [330.0]]) * n / 22050)
                            + 0.05 * rng.normal(size=(2, n.size))).astype(np.float32))
    out = {"forward": {}}
    gens = {}
    for kind in ("melgan", "hifigan"):
        gens[kind] = MG.generator_init(torch.Generator().manual_seed(0), kind, base=32)
        a = MG.generator_forward(gens[kind], mel)
        b = MG.generator_forward(tree_to(gens[kind], "cuda"), mel.to("cuda"))
        out["forward"][kind] = _max_abs(b, a) / max(float(a.abs().max()), 1e-6)
    disc = MG.adv_disc_init(torch.Generator().manual_seed(1), "msd+mpd")
    disc_g = tree_to(disc, "cuda")
    worst = 0.0
    for (fa_, la), (fb, lb) in zip(MG.adv_disc_forward(disc, wav[:1, :1000]),
                                   MG.adv_disc_forward(disc_g, wav[:1, :1000].to("cuda"))):
        for x, y in list(zip(fa_, fb)) + [(la, lb)]:
            worst = max(worst, _max_abs(y, x) / max(float(x.abs().max()), 1e-6))
    out["forward"]["disc"] = worst
    pred = MG.generator_forward(gens["melgan"], mel)
    la, _ = TM.mr_stft_loss(pred, wav)
    lb, _ = TM.mr_stft_loss(pred.to("cuda"), wav.to("cuda"))
    out["mr_stft_rel"] = abs(float(lb) - float(la)) / abs(float(la))
    args = parse_with_config(["--lr", "1e-3", "--melgan_disc", "msd+mpd"])
    tx = TM._voc_tx(args)
    voc, adv = TM.make_vocoder_step(args), TM.make_adversarial_step(args)
    runs = {}
    for device in ("cpu", "cuda"):
        for dtype in (torch.float32, torch.float64):
            g = tree_to(tree_to(gens["melgan"], dtype), device)
            d = tree_to(tree_to(disc, dtype), device)
            m, w = mel.to(device, dtype), wav.to(device, dtype)
            runs[device, dtype] = (voc(TM.VocTrainState(g, tx.init(g), 0), m, w),
                                   adv(TM.AdvTrainState(g, tx.init(g), d, tx.init(d), 0), m, w))
    (nc, mc), (ac, mac) = runs["cpu", torch.float64]
    (ng, mg), (ag, mag) = runs["cuda", torch.float64]
    out["voc_step"] = compare_train_steps(
        args.lr, {"gen": (ng.params, nc.params, ng.opt, nc.opt)}, (mg, mc))
    out["adv_step"] = compare_train_steps(
        args.lr, {"gen": (ag.gen, ac.gen, ag.gen_opt, ac.gen_opt),
                  "disc": (ag.disc, ac.disc, ag.disc_opt, ac.disc_opt)}, (mag, mac))
    rel = lambda a, b, k: abs(float(a[k]) - float(b[k])) / abs(float(b[k]))
    f32 = {dev: (runs[dev, torch.float32][0][1], runs[dev, torch.float32][1][1])
           for dev in ("cpu", "cuda")}
    out["f32_losses_rel"] = max(rel(f32["cuda"][i], f32["cpu"][i], k)
                                for i in (0, 1) for k in f32["cpu"][i] if k != "grad_norm")
    out["f32_grad_norm"] = {"card_vs_cpu_rel": rel(f32["cuda"][0], f32["cpu"][0], "grad_norm"),
                            **{f"{dev}_vs_f64_rel": rel(f32[dev][0], mc, "grad_norm")
                               for dev in ("cpu", "cuda")}}
    ccfg = TINY.replace(ctc_chunk=4, ctc_left=1)
    cp, cs = C.ctc_asr_init(torch.Generator().manual_seed(0), ccfg)
    cmel = torch.from_numpy(rng.uniform(size=(2, 20, 80)).astype(np.float32))
    clen = np.array([20, 13])
    cmel *= torch.from_numpy(np.arange(20) < clen[:, None])[..., None]
    (ids, lens), _ = C.ctc_asr_infer(cp, cs, nn.Ctx.eval(), ccfg, cmel,
                                     torch.from_numpy(clen))
    asr = StreamingCtcAsr(tree_to(cp, "cuda"), ccfg).reset(batch_size=2)
    for t0 in range(0, 20, 4):
        asr.step(cmel[:, t0:t0 + 4].numpy(), n_valid=np.clip(clen - t0, 0, 4))
    out["stream_asr_equal"] = all(asr.emitted[i] == ids[i, :int(lens[i])].tolist()
                                  for i in range(2))
    out["ok"] = (all(x <= 1e-4 for x in out["forward"].values()) and out["mr_stft_rel"] <= 1e-4
                 and out["f32_losses_rel"] <= 1e-4
                 and all(c["metrics_rel"] <= 1e-4 and c["update_abs"] <= 1e-3
                         and c["update_abs_all"] <= 2 + 1e-3
                         and all(v <= 1 for k, v in c.items() if k.endswith("_mu_scaled"))
                         for c in (out["voc_step"], out["adv_step"]))
                 and out["stream_asr_equal"])
    assert out["ok"], out
    return out


def melgan_phase(fa, flag_params, flag_state, flag_cfg, student, root):
    """Phase 16: the neural vocoders at their published width (base 256,
    rates 5/5/11, hop 275). Training: VOC_STEPS STFT-loss steps each of
    MelGAN and HiFi-GAN (train/melgan.py, adamw lr 2e-4 behind the clip)
    at B8 x 40-frame crops drawn by crop_batch through MelWavCrops from
    phase 13's mel and wav shards, then one adversarial step (msd+mpd) on
    the MelGAN generator; each step's seconds and the peak memory.
    Serving: Synthesizer(nar_pv=phase 15's student, melgan_params=,
    pcm16=True) on phase 4's flagship serving the 8 SENTENCES (batch
    latency, launches: one text encoder and one frame decoder); the
    chunked vocode (melgan_chunk=256) against the whole on the same float32
    mels within 1e-5 (cuDNN may pick other algorithms per window shape)
    and PCM16 within one step, each timed also in bf16; stream_tts's time
    to its first chunk (after one untimed stream of the same text) against
    the whole utterance's; melgan_tiny_checks."""
    from unast_tpu_torch.data.shard import MelWavCrops, PackedShardDataset, WavShardDataset
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.infer.streaming import stream_tts
    from unast_tpu_torch.models import melgan as MG
    from unast_tpu_torch.text import raw_text_to_phoneme_ids
    from unast_tpu_torch.train import melgan as TM
    from unast_tpu_torch.train.config import parse_with_config
    from unast_tpu_torch.train.optim import tree_paths
    t_phase = time.perf_counter()
    crops = MelWavCrops(PackedShardDataset(os.path.join(root, "device.unsh")),
                        WavShardDataset(os.path.join(root, "device.unwv")))
    rng = np.random.default_rng(16)

    def batch():
        mel, wav = TM.crop_batch(crops, rng, VOC_BATCH, VOC_FRAMES, 275)
        return torch.from_numpy(mel).to("cuda"), torch.from_numpy(wav).to("cuda")

    train, gens = {}, {}
    for kind in ("melgan", "hifigan"):
        args = parse_with_config(["--melgan_gen", kind, "--melgan_base", str(VOC_BASE),
                                  "--lr", "2e-4", "--melgan_disc", "msd+mpd"])
        vs = TM.init_voc_state(torch.Generator().manual_seed(0), args, device="cuda")
        step = TM.make_vocoder_step(args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"params": MG.num_params(vs.params), "step_s": [], "metrics": []}
        for _ in range(VOC_STEPS):
            mel, wav = batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            vs, m = step(vs, mel, wav)
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t)
            rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        assert all(np.isfinite(list(m.values())).all() for m in rec["metrics"]), rec
        assert all(bool(torch.isfinite(x).all()) for x in tree_paths(vs.params).values())
        train[kind], gens[kind] = rec, vs
    args = parse_with_config(["--melgan_base", str(VOC_BASE), "--lr", "2e-4",
                              "--melgan_disc", "msd+mpd"])
    ats = TM.init_adv_state(torch.Generator().manual_seed(1), gens["melgan"], args)
    mel, wav = batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ats, m = TM.make_adversarial_step(args)(ats, mel, wav)
    torch.cuda.synchronize()
    train["adversarial"] = {"disc": "msd+mpd", "disc_params": MG.num_params(ats.disc),
                            "s": time.perf_counter() - t,
                            "metrics": {k: float(v) for k, v in m.items()},
                            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    assert all(np.isfinite(v) for v in train["adversarial"]["metrics"].values()), train
    gp = gens["melgan"].params

    syn = Synthesizer(flag_params, flag_state, flag_cfg, nar_pv=student,
                      melgan_params=gp, pcm16=True, device="cuda")
    syn.tts(SENTENCES[:1])
    reset_launch_counts(fa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    wavs = syn.tts(SENTENCES)
    torch.cuda.synchronize()
    tts_s = time.perf_counter() - t
    launches = [fa.launches_bf16, fa.launches_f32]
    serve_peak = torch.cuda.max_memory_allocated()
    for w in wavs:
        assert w.dtype == np.int16 and w.ndim == 1 and len(w) > 0, (w.dtype, w.shape)
    assert launches == [2 * flag_cfg.num_layers, 0], launches

    post, lens, _ = syn._tts_chunk_seqs([np.asarray(raw_text_to_phoneme_ids(x), np.int64)
                                         for x in SENTENCES])
    tb = syn._bucket(syn.mel_buckets, int(lens.max()))
    chunking = {"rows": post.shape[0], "frames": tb, "chunk": MELGAN_CHUNK}
    with torch.inference_mode():
        for dtype in (torch.float32, flag_cfg.dtype):
            mel_b = post[:, :tb].to(dtype)
            for pcm16 in (False, True):
                res = {}
                for chunk in (0, MELGAN_CHUNK):
                    syn.melgan_chunk, syn.pcm16 = chunk, pcm16
                    syn._melgan_vocode(mel_b)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    res[chunk] = syn._melgan_vocode(mel_b)
                    torch.cuda.synchronize()
                    chunking[f"{str(dtype)[6:]}_pcm16_{int(pcm16)}_chunk_{chunk}_s"] = (
                        time.perf_counter() - t)
                if dtype == torch.float32:
                    err = _max_abs(res[MELGAN_CHUNK], res[0])
                    chunking[f"max_abs_err_pcm16_{int(pcm16)}"] = err
                    assert err <= (1.0 if pcm16 else 1e-5), chunking
    syn.melgan_chunk, syn.pcm16 = None, True

    text = SENTENCES[0]
    for _ in stream_tts(syn, text, chunk=STREAM_CHUNK):   # cuDNN's window shapes
        pass
    torch.cuda.synchronize()
    t = time.perf_counter()
    chunks = stream_tts(syn, text, chunk=STREAM_CHUNK)
    first = next(chunks)
    first_s = time.perf_counter() - t
    rest = list(chunks)
    all_s = time.perf_counter() - t
    t = time.perf_counter()
    whole = syn.tts([text])
    whole_s = time.perf_counter() - t
    streamed = np.concatenate([first] + rest)
    assert np.isfinite(streamed).all() and len(whole[0]) > 0
    tiny = melgan_tiny_checks(fa)
    return {
        "base": VOC_BASE, "rates": [5, 5, 11], "hop": 275, "crop_frames": VOC_FRAMES,
        "batch": VOC_BATCH, "train": train,
        "serve": {"requests": len(SENTENCES), "pcm16": True, "tts_batch_s": tts_s,
                  "tts_utt_per_s": len(SENTENCES) / tts_s,
                  "wav_samples": [len(w) for w in wavs],
                  "flash_launches_bf16": launches[0], "flash_launches_f32": launches[1],
                  "max_memory_allocated_bytes": serve_peak},
        "chunking": chunking,
        "stream": {"chunk": STREAM_CHUNK, "first_chunk_s": first_s, "all_chunks_s": all_s,
                   "chunks": 1 + len(rest), "samples": len(streamed),
                   "whole_utterance_pcm16_s": whole_s},
        "tiny_gpu_vs_cpu": tiny, "phase_s": time.perf_counter() - t_phase,
    }, gp


def _text_logits(syn, mels, ids):
    """The float32 logits [B, S, V] of each step of a greedy text decode
    that follows `ids` (teacher-forced along them: the KV-cached decode
    step of networks.text_tr_infer) with syn's weights, on the card, the
    mels padded to the Synthesizer's bucket."""
    from unast_tpu_torch.models import modules as M, networks as N, transformer as T
    from unast_tpu_torch import nn
    cfg, ectx = syn.cfg, nn.Ctx.eval()
    n = syn._bucket(syn.mel_buckets, max(len(m) for m in mels))
    mel = torch.zeros((len(mels), n, cfg.num_mels), dtype=cfg.dtype, device="cuda")
    for i, m in enumerate(mels):
        mel[i, :len(m)] = torch.from_numpy(m[:n]).to(cfg.dtype)
    lens = torch.tensor([min(n, len(m)) for m in mels], device="cuda")
    p = syn.params["text_m"]
    with torch.inference_mode():
        (enc, mask), _ = N.speech_tr_encode(syn.params["speech_m"],
                                            syn.net_state["speech_m"], ectx, cfg,
                                            mel, lens)
        cache = T.init_cache(p["decoder"], enc, cfg.max_text_len, cfg.nhead)
        bias = T.padding_bias(mask)
        tok = torch.full((len(mels), 1), 1, dtype=torch.long, device="cuda")
        out = []
        for i in range(max(len(x) for x in ids)):
            x = M.positional_encoding(ectx, M.text_embed(p["prenet"], ectx, tok, cfg),
                                      offset=i)
            h, cache = T.decoder_step(p["decoder"], ectx, x, i, cache, bias,
                                      cfg.nhead, 0.0, moe_opts=cfg.moe_opts)
            out.append(M.text_postnet(p["postnet"], ectx, h, cfg)[:, -1].float().cpu())
            tok = torch.tensor([[int(x[i]) if i < len(x) else 0] for x in ids],
                               device="cuda")
    return torch.stack(out, dim=1).numpy()


def _greedy_agreement(ref_ids, ref_logits, logits, floor):
    """Along ref's greedy path (ref_ids, its logits ref_logits [B, S, V]),
    another model's logits on the same prefixes: the steps whose ref
    margin (top-1 minus top-2) is above `floor`, whether the other's
    greedy choice equals ref's at every one of them, and the largest
    logit difference anywhere on the path."""
    compared, equal = 0, True
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for b, r in enumerate(ref_ids):
        r = np.asarray(r)
        assert np.array_equal(np.argmax(ref_logits[b, :len(r)], -1), r)
        sel = margin[b, :len(r)] > floor
        compared += int(sel.sum())
        equal &= bool(np.array_equal(np.argmax(logits[b, :len(r)], -1)[sel], r[sel]))
    return {"compared": compared, "equal": equal, "margin_floor": floor,
            "logit_max_abs_diff": float(np.abs(logits - ref_logits).max())}


def _asr_mels(n_req, seed):
    """n_req uniform mels of 200-815 frames (numpy seed `seed`)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (int(n), 80)).astype(np.float32)
            for n in rng.integers(200, 816, size=n_req)]


def _serve_batch(syn, fa, texts=None, mels=None):
    """One timed tts_mels (texts) or asr_ids (mels) batch, counts set to 0
    just before and read just after. Returns (outputs, record)."""
    reset_launch_counts(fa)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = syn.tts_mels(texts) if texts is not None else syn.asr_ids(mels)
    torch.cuda.synchronize()
    return out, {"s": time.perf_counter() - t, "launches_bf16": fa.launches_bf16,
                 "launches_f32": fa.launches_f32, "batches": len(syn.last_decode_steps),
                 "decode_steps": sum(syn.last_decode_steps)}


def _objective_step(step_fn, ts, batches, fa, seed):
    """One timed make_train_step call on `batches`, counts set to 0 just
    before and read just after."""
    reset_launch_counts(fa)
    bwd0 = fa.backward_calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ts, m = step_fn(ts, torch.Generator(device="cuda").manual_seed(seed), batches)
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t,
           "metrics": {k: float(v) for k, v in m.items()},
           "launches_bf16": fa.launches_bf16, "launches_f32": fa.launches_f32,
           "backward_calls": fa.backward_calls - bwd0,
           "backward_launches": fa.backward_launches, **bwd_launches(fa),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    assert all(np.isfinite(v) for v in rec["metrics"].values()), rec
    return ts, rec


def wide_phase(fa):
    """Phase 17: configs/wide_d1024.json at full width (d 1024, 6 layers, 8
    heads, ffn 4096, bf16) with attn_impl='flash', random weights from
    seed 0. One joint step with the config's remat 'dots_all' and
    objective mix (ae 2 / cm 1 / sp 4 / d 1, the LSTM discriminator, guided
    attention) at B WIDE_BATCH, 816 / 304, counts set to 0 just before and
    read just after: forward launches (the checkpoint recompute included)
    and backward calls as flash_calls_per_step counts them, the step's
    seconds and peak memory. The sp objective's loss and backward alone on
    that step's first sp micro-batch, four times: remat off, '', 'dots',
    'dots_all', each from the same generator seed and with scan_layers on
    (so remat off draws its per-layer dropout seeds as remat does): the
    losses bitwise equal, each peak, '' below remat off. Guided attention
    asks for the decoders' cross-attention weights, so only the encoders
    are checkpointed (transformer.decoder, as JAX). Then the Synthesizer
    with the stop bias lowered by 100: 8 TTS (to 815 frames) and 8 ASR
    with the bf16 weights, then quantize='int8': latencies, the weights'
    bytes; the int8 mels and the teacher-forced TTS forward within
    WIDE_INT8_REL_TOL (relative RMS) of bf16's; along bf16's greedy ASR
    path, the int8 weights' greedy choice equal to bf16's at every step
    whose bf16 margin is above WIDE_ID_MARGIN (_greedy_agreement), and
    the free-running int8 ids' common prefix with bf16's."""
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import ModelConfig, unast as U
    from unast_tpu_torch.nn import quant as Q
    from unast_tpu_torch.train import init_train_state, make_train_step
    from unast_tpu_torch.train import steps as TS
    from unast_tpu_torch.train.config import train_args
    from unast_tpu_torch.train.optim import tree_leaves, tree_map, split_params
    from unast_tpu_torch.text import raw_text_to_phoneme_ids
    from unast_tpu_torch import nn
    t_phase = time.perf_counter()
    cfg = ModelConfig.from_json(WIDE_CONFIG).replace(attn_impl="flash")
    args = train_args(WIDE_CONFIG, train_batch_size=WIDE_BATCH)
    assert cfg.remat and cfg.remat_policy == "dots_all" and cfg.head_dim == 128
    fwd, bwd = TS.flash_calls_per_step(cfg, args)
    ts = init_train_state(torch.Generator().manual_seed(0), cfg, args)
    n_params = U.num_params(ts.params)
    batches = train_batches(np.random.default_rng(0), args, cfg, WIDE_BATCH,
                            args.data_text_len, args.data_mel_len, "cuda")
    ts, step = _objective_step(make_train_step(cfg, args), ts, batches, fa, 0)
    assert [step["launches_bf16"], step["backward_calls"], step["launches_f32"],
            step["backward_launches"], step["backward_launches_f32"]] == [
                fwd, bwd, 0, bwd, 0], (step, fwd, bwd)
    step.update(expected=[fwd, bwd])

    # the sp objective alone under each policy
    sp_batch = tuple(x[0] for x in batches["sp"])
    gen_p, disc_p = split_params(ts.params)
    policies = {}
    for name, remat, policy in (("off", False, ""), ("''", True, ""),
                                ("dots", True, "dots"), ("dots_all", True, "dots_all")):
        pcfg = cfg.replace(remat=remat, remat_policy=policy, scan_layers=True)
        live = tree_map(lambda x: x.detach().requires_grad_(True), gen_p)
        params = dict(live, discriminator=disc_p)
        reset_launch_counts(fa)
        bwd0 = fa.backward_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        loss, _ = TS.sp_loss_fn(params, ts.net_state,
                                torch.Generator(device="cuda").manual_seed(7),
                                sp_batch, pcfg, args, 1.0)
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
        torch.cuda.synchronize()
        policies[name] = {
            "loss": float(loss.detach()),
            "loss_bits": int(loss.detach().float().view(torch.int32)),
            "s": time.perf_counter() - t,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_start_bytes": torch.cuda.max_memory_allocated() - base,
            "launches_bf16": fa.launches_bf16, "backward_calls": fa.backward_calls - bwd0,
            "backward_launches": fa.backward_launches, **bwd_launches(fa),
            "grad_finite": all(bool(torch.isfinite(g).all()) for g in grads
                               if g is not None)}
        del live, params, loss, grads
    bits = {r["loss_bits"] for r in policies.values()}
    assert len(bits) == 1 and all(r["grad_finite"] for r in policies.values()), policies
    assert all(r["backward_launches"] == r["backward_calls"] > 0
               and r["backward_launches_f32"] == 0 for r in policies.values()), policies
    assert policies["''"]["peak_bytes"] < policies["off"]["peak_bytes"], policies
    del ts, batches, gen_p, disc_p
    torch.cuda.empty_cache()

    # serving, bf16 then int8
    params, state = U.unast_init(torch.Generator().manual_seed(0), cfg)
    params["speech_m"]["postnet"]["stop_proj"]["b"] -= 100.0
    mels_in = _asr_mels(len(SENTENCES), 17)
    seqs = [np.asarray(raw_text_to_phoneme_ids(t_), np.int64)[:64] for t_ in SENTENCES[:4]]
    tf_text = torch.from_numpy(np.stack([np.pad(q, (0, 64 - len(q))) for q in seqs])).cuda()
    tf_tl = torch.tensor([len(q) for q in seqs], device="cuda")
    tf_mel = torch.rand((4, 400, cfg.num_mels), generator=torch.Generator().manual_seed(5))
    tf_mel = tf_mel.to("cuda", cfg.dtype)
    serve, outs = {}, {}
    for name, quantize in (("bf16", None), ("int8", "int8")):
        # no warm-up: the process has served since phase 4
        syn = Synthesizer(params, state, cfg, quantize=quantize)
        tts, rec_t = _serve_batch(syn, fa, texts=SENTENCES)
        ids, rec_a = _serve_batch(syn, fa, mels=mels_in)
        for rec in (rec_t, rec_a):
            assert rec["launches_bf16"] == cfg.num_layers * rec["batches"], rec
            assert rec["launches_f32"] == 0, rec
        assert all(np.isfinite(m).all() and len(m) == cfg.max_mel_len for m in tts)
        with torch.inference_mode():   # the teacher-forced TTS forward
            (_, post, _, _), _ = U.tts(syn.params, syn.net_state, nn.Ctx.eval(), cfg,
                                       tf_text, tf_tl, tf_mel,
                                       torch.full((4,), 400, device="cuda"))
        outs[name] = {"tts": tts, "ids": ids, "forward": post.float().cpu().numpy(),
                      "logits": _text_logits(syn, mels_in, outs.get("bf16", {}).get(
                          "ids", ids))}
        serve[name] = {"tts": rec_t, "asr": rec_a,
                       "param_bytes": Q.quantized_bytes(syn.params)}
        del syn
        torch.cuda.empty_cache()

    def rel_rms(a, b):
        a, b = np.concatenate([x.ravel() for x in a]), np.concatenate([x.ravel() for x in b])
        return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))

    mel_rel = rel_rms(outs["int8"]["tts"], outs["bf16"]["tts"])
    mel_rel_50 = rel_rms([m[:50] for m in outs["int8"]["tts"]],
                         [m[:50] for m in outs["bf16"]["tts"]])
    fwd_rel = rel_rms([outs["int8"]["forward"]], [outs["bf16"]["forward"]])
    agree = _greedy_agreement(outs["bf16"]["ids"], outs["bf16"]["logits"],
                              outs["int8"]["logits"], WIDE_ID_MARGIN)
    prefix = [int(np.argmax(np.append(np.asarray(a)[:min(len(a), len(b))]
                                      != np.asarray(b)[:min(len(a), len(b))], True)))
              for a, b in zip(outs["int8"]["ids"], outs["bf16"]["ids"])]
    int8 = {"tts_mels_rel_rms": mel_rel, "tts_mels_first50_rel_rms": mel_rel_50,
            "tf_forward_rel_rms": fwd_rel, "rel_tol": WIDE_INT8_REL_TOL,
            "greedy_agreement": agree, "free_running_common_prefix": prefix,
            "ids_total": sum(len(x) for x in outs["bf16"]["ids"]),
            "bytes_ratio": serve["int8"]["param_bytes"] / serve["bf16"]["param_bytes"]}
    assert max(fwd_rel, mel_rel) <= WIDE_INT8_REL_TOL, int8
    assert agree["equal"] and agree["compared"] > 0, int8
    assert int8["bytes_ratio"] < 0.6, int8
    return {"config": os.path.relpath(WIDE_CONFIG, ROOT), "attn_impl": cfg.attn_impl,
            "compute_dtype": cfg.compute_dtype, "d_model": cfg.e_in,
            "layers": cfg.num_layers, "heads": cfg.nhead, "ffn": cfg.ffn_dim,
            "params": n_params, "batch": WIDE_BATCH, "config_batch": 32,
            "mel_len": args.data_mel_len, "text_len": args.data_text_len,
            "remat_policy": cfg.remat_policy, "step": step,
            "sp_policies": policies,
            "sp_policies_note": "guided attention on: only the encoders are "
                                "checkpointed; scan_layers on in all four",
            "serve": serve, "int8_vs_bf16": int8,
            "phase_s": time.perf_counter() - t_phase}


def family_tiny_checks(fa):
    """Phase 18's TINY float32 checks, card against CPU within 1e-4 (flash
    on, so the float32 kernel on the card): a conformer encoder in train
    mode (dropout 0) with its BN state; moe_ffn dispatch and ragged (top-2)
    with the aux loss; an encoder + decoder stack with MoE layers under
    remat 'dots_all' and under scan_layers, loss and gradient; the
    quantized TTS forward. Counts set to 0 just before, read just after."""
    from unast_tpu_torch import nn
    from unast_tpu_torch.models import TINY, conformer as C, moe as MoE
    from unast_tpu_torch.models import transformer as T, unast as U
    from unast_tpu_torch.nn import quant as Q, tree_to
    from unast_tpu_torch.train.optim import tree_leaves, tree_unflatten
    d, h, f = TINY.e_in, TINY.nhead, TINY.ffn_dim
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal((2, 12, d)).astype(np.float32))
    pad = torch.arange(12)[None] >= torch.tensor([12, 7])[:, None]
    y = torch.from_numpy(rng.standard_normal((2, 9, d)).astype(np.float32))
    ypad = torch.arange(9)[None] >= torch.tensor([9, 5])[:, None]
    dev = lambda t: tree_to(t, "cuda")
    errs = {}
    reset_launch_counts(fa)

    cp, cs = C.conformer_encoder_init(torch.Generator().manual_seed(0), d, h, f, 2, 15)
    run = lambda p, s, x, pad: C.conformer_encoder(p, s, nn.Ctx(train=True), x, pad, h,
                                                   0.0, 15, impl="flash")
    (a, sa), (b, sb) = run(cp, cs, x, pad), run(dev(cp), dev(cs), dev(x), dev(pad))
    errs["conformer"] = max(_max_abs(a, b), _max_abs(sa["layers"][1]["bn"]["var"],
                                                     sb["layers"][1]["bn"]["var"]))
    mp = MoE.moe_init(torch.Generator().manual_seed(1), d, f, 4)
    for impl in ("dispatch", "ragged"):
        outs = []
        for p, xx, pp in ((mp, x, pad), (dev(mp), dev(x), dev(pad))):
            ctx = nn.Ctx(aux_losses=[])
            outs.append((MoE.moe_ffn(p, ctx, xx, pp, 0.0, (2, 1.25, impl, 8)),
                         ctx.aux_losses[0]))
        errs[f"moe_{impl}"] = max(_max_abs(outs[0][0], outs[1][0]),
                                  _max_abs(outs[0][1], outs[1][1]))
    g = torch.Generator().manual_seed(2)
    stack = {"encoder": T.encoder_init(g, d, h, f, 2, moe=2),
             "decoder": T.decoder_init(g, d, h, f, 2, moe=2)}
    card_bwd = 0   # backward calls on the card
    for form, kw in (("remat_dots_all", dict(remat=True, remat_policy="dots_all")),
                     ("scan", dict(scan_layers=True))):
        res = []
        for p, xx, pp, yy, yp in ((stack, x, pad, y, ypad),
                                  (dev(stack), dev(x), dev(pad), dev(y), dev(ypad))):
            bwd0 = fa.backward_calls
            leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
            live = tree_unflatten(p, leaves)
            ctx = nn.Ctx(aux_losses=[])
            m = T.encoder(live["encoder"], ctx, xx, pp, h, 0.1, impl="flash",
                          moe_opts=(2, 1.25, "ragged"), **kw)
            o = T.decoder(live["decoder"], ctx, yy, m, yp, pp, h, 0.1, impl="flash",
                          moe_opts=(2, 1.25, "dispatch", 8), **kw)
            loss = (o ** 2).mean() + sum(ctx.aux_losses)
            res.append((loss, torch.autograd.grad(loss, leaves)))
            if xx.is_cuda:
                card_bwd += fa.backward_calls - bwd0
        errs[form] = max([_max_abs(res[0][0], res[1][0])]
                         + [_max_abs(a_, b_) for a_, b_ in zip(res[0][1], res[1][1])])
    cfg = TINY.replace(attn_impl="flash")
    qp, qs = U.unast_init(torch.Generator().manual_seed(0), cfg)
    qp = Q.quantize_params(qp)
    tl = torch.tensor([8, 5])
    text = torch.from_numpy(rng.integers(3, 46, (2, 8))) * (torch.arange(8) < tl[:, None])
    mel = torch.rand((2, 12, 80), generator=torch.Generator().manual_seed(3))
    ml = torch.tensor([12, 7])
    with torch.inference_mode():
        (a, _, _, _), _ = U.tts(qp, qs, nn.Ctx.eval(), cfg, text, tl, mel, ml)
        (b, _, _, _), _ = U.tts(dev(qp), dev(qs), nn.Ctx.eval(), cfg, dev(text),
                                dev(tl), dev(mel), dev(ml))
    errs["quantized_tts"] = _max_abs(a, b)
    rec = {"max_abs_err": errs, "launches_f32": fa.launches_f32,
           "launches_bf16": fa.launches_bf16, "backward_calls": card_bwd,
           **bwd_launches(fa), "tol": 1e-4}
    assert max(errs.values()) <= 1e-4 and rec["launches_f32"] > 0, rec
    assert rec["launches_bf16"] == rec["backward_launches_bf16"] == 0, rec
    assert rec["backward_launches_f32"] == card_bwd > 0, rec
    return rec


def families_phase(fa, flag_cfg):
    """Phase 18: the family additions at flagship width (configs/
    transformer_d_curriculum_fast.json: d 256, 4 layers, 4 heads, ffn 1024,
    bf16, attn_impl='flash'), random weights from seed 0, counts set to 0
    just before each call and read just after. --speech_encoder conformer
    (kernel 15): 8 ASR served (its self-attention through the bf16 kernel:
    4 launches an encoder call), one ae + sp step at the config's B4 x 816
    / 304 (one micro-batch each). --moe_experts 8 --moe_impl ragged (the
    README's recipe on this config): 8 TTS (stop bias lowered by 100, to
    815 frames: the T == 1 dense-combine decode) and 8 ASR served, then
    one ae + sp step with its aux metric; the same step with --moe_impl
    dispatch. Each step's launches and backward calls as
    flash_calls_per_step counts them. Then family_tiny_checks."""
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import unast as U
    from unast_tpu_torch.train import init_train_state, make_train_step
    from unast_tpu_torch.train import steps as TS
    from unast_tpu_torch.train.config import train_args
    t_phase = time.perf_counter()
    args = train_args(CONFIG, ae_steps=1, cm_steps=0, sp_steps=1, d_steps=0)
    batches = train_batches(np.random.default_rng(18), args, flag_cfg,
                            args.train_batch_size, args.data_text_len,
                            args.data_mel_len, "cuda")
    batches = {k: batches[k] for k in ("ae", "sp")}
    mels_in = _asr_mels(len(SENTENCES), 18)
    out = {}
    for name, kw in (("conformer", dict(speech_encoder="conformer")),
                     ("moe_ragged", dict(moe_experts=8, moe_impl="ragged")),
                     ("moe_dispatch", dict(moe_experts=8, moe_impl="dispatch"))):
        cfg = flag_cfg.replace(**kw)
        rec = {}
        if name != "moe_dispatch":
            params, state = U.unast_init(torch.Generator().manual_seed(0), cfg)
            params["speech_m"]["postnet"]["stop_proj"]["b"] -= 100.0
            syn = Synthesizer(params, state, cfg)
            syn.asr_ids(mels_in[:1])
            _, rec["asr"] = _serve_batch(syn, fa, mels=mels_in)
            if name == "moe_ragged":
                mels, rec["tts"] = _serve_batch(syn, fa, texts=SENTENCES)
                assert all(np.isfinite(m).all() and len(m) == cfg.max_mel_len
                           for m in mels)
            for r in (rec.get("asr"), rec.get("tts")):
                if r is not None:
                    assert r["launches_bf16"] == cfg.num_layers * r["batches"], r
            del syn, params, state
        fwd, bwd = TS.flash_calls_per_step(cfg, args)
        ts = init_train_state(torch.Generator().manual_seed(0), cfg, args)
        _, rec["step"] = _objective_step(make_train_step(cfg, args), ts, batches, fa, 1)
        assert [rec["step"]["launches_bf16"], rec["step"]["backward_calls"],
                rec["step"]["backward_launches"], rec["step"]["backward_launches_f32"]] == [
                    fwd, bwd, bwd, 0], (rec["step"], fwd, bwd)
        rec["step"]["expected"] = [fwd, bwd]
        if name.startswith("moe"):
            assert {"ae/moe", "sp/moe"} <= set(rec["step"]["metrics"]), rec["step"]
        out[name] = rec
        del ts
        torch.cuda.empty_cache()
    out["tiny_gpu_vs_cpu"] = family_tiny_checks(fa)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def dispatch_cost(fa, iters: int = 400, tries: int = 3):
    """Host microseconds a call of the flash forward takes through the
    registered operator (torch.ops.unast.flash_attention_fwd, what
    flash_attention and the exported programs call) and through
    ops/attention.py::_forward directly, on a bf16 serving shape (B8 T815
    H4 D64, no gradient): each the mean over `iters` back-to-back calls,
    synchronised at the end, the least of `tries` alternating rounds; the
    difference is what the dispatcher adds."""
    from unast_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn((8, 815, 4, 64), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    lens = torch.full((8,), 815, device="cuda")
    calls = {"operator": lambda: A.flash_attention_fwd(q, k, v, lens, False),
             "direct": lambda: A._forward(q, k, v, lens, False)}
    best = {name: float("inf") for name in calls}
    with torch.no_grad():
        for fn in calls.values():
            fn()
        for _ in range(tries):
            for name, fn in calls.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                best[name] = min(best[name], 1e6 * (time.perf_counter() - t) / iters)
    reset_launch_counts(fa)
    return {"shape": "B8 T815 H4 D64 bf16", "iters": iters,
            "operator_us": best["operator"], "direct_us": best["direct"],
            "dispatch_us": best["operator"] - best["direct"]}


def export_phase(fa, flag_params, flag_state, flag_cfg, ctc_pv, student, melgan_params,
                 vocoder_pv):
    """Phase 19: the serving export and the checkpoint migration at flagship
    width. infer/export.py::export_synthesizer of a Synthesizer over phase
    4's AR model, phase 15's FastSpeech student, phase 14's CTC model and
    phase 16's MelGAN generator at batch 8 and the largest buckets (text
    304, mel 816); load_bundle of it in this process; each program called
    on the card on the 8 SENTENCES (nar_tts), on the float32 mels the
    exported nar_tts made for them (ctc_asr, vocode), counts set to 0 just
    before each call and read just after (nar_tts: a text encoder and a
    frame decoder, 2 x num_layers bf16 launches; ctc_asr: one encoder;
    vocode: none), each held to the eager function the Synthesizer runs on
    the same inputs (mels and waveforms within 1e-5 of the largest, ids
    and lengths equal); the export's seconds, the bundle's bytes, each
    call's seconds; the operator's dispatch cost (dispatch_cost); then
    compat: export_state_dict -> import_state_dict of the flagship trees
    and of phase 12's CBHG vocoder bit-equal, and the two CLIs (the main()
    of python -m unast_tpu_torch.compat.torch_import / torch_export, in
    this process) round trip the flagship checkpoint through torch.save
    files bit for bit."""
    from unast_tpu_torch import nn
    from unast_tpu_torch.compat import torch_export as CE, torch_import as CI
    from unast_tpu_torch.infer.export import export_synthesizer, load_bundle
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import melgan as MG
    from unast_tpu_torch.text import raw_text_to_phoneme_ids
    from unast_tpu_torch.train.optim import tree_paths
    t_phase = time.perf_counter()
    cfg = flag_cfg
    syn = Synthesizer(flag_params, flag_state, cfg, nar_pv=student,
                      melgan_params=melgan_params, ctc_pv=ctc_pv)
    out = {"batch": 8, "text_bucket": 304, "mel_bucket": 816}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_bundle.zip")
        t = time.perf_counter()
        export_synthesizer(syn, path, batch=8, mel_bucket=816, text_bucket=304)
        out["export_s"] = time.perf_counter() - t
        out["bundle_bytes"] = os.path.getsize(path)
        t = time.perf_counter()
        b = load_bundle(path)
        out["load_s"] = time.perf_counter() - t
    assert b.names() == ["ctc_asr", "nar_tts", "vocode"], b.names()
    out["graph_flash_nodes"] = {
        name: sum(n.target is torch.ops.unast.flash_attention_fwd.default
                  for n in b.programs[name].graph.nodes) for name in b.names()}
    weights = {k: nn.tree_to(w, "cuda") for k, w in b.weights.items()}
    ids = torch.zeros((8, 304), dtype=torch.long)
    lens = torch.zeros((8,), dtype=torch.long)
    for i, s in enumerate(SENTENCES):
        seq = raw_text_to_phoneme_ids(s)[:304]
        ids[i, :len(seq)] = torch.tensor(seq)
        lens[i] = len(seq)
    ids, lens = ids.cuda(), lens.cuda()
    calls = {}

    def run(name, *args):
        reset_launch_counts(fa)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = b.call(name, weights[{"nar_tts": "nar", "ctc_asr": "ctc",
                                    "vocode": "melgan"}[name]], *args)
        torch.cuda.synchronize()
        calls[name] = {"s": time.perf_counter() - t,
                       "launches_bf16": fa.launches_bf16, "launches_f32": fa.launches_f32}
        return res

    run("nar_tts", ids, lens)                   # the first call loads the module
    post, out_lens = run("nar_tts", ids, lens)
    mel = post.float()[:, :816]
    mel = torch.nn.functional.pad(mel, (0, 0, 0, 816 - mel.shape[1]))
    mel_len = torch.clamp(out_lens, 1, 816)
    run("ctc_asr", mel, mel_len)
    asr_ids, asr_lens = run("ctc_asr", mel, mel_len)
    run("vocode", mel)
    wav = run("vocode", mel)
    with torch.inference_mode():
        e_post, e_lens = syn._nar_tts_impl(ids, lens)
        e_ids, e_lens2 = syn._ctc_asr_impl(mel, mel_len)
        e_wav = MG.generator_forward(syn.melgan_params, mel)
    rel = lambda a, e: float((a.float() - e.float()).abs().max() / e.float().abs().max())
    out["nar_tts"] = {"post_rel_err": rel(post, e_post),
                      "out_lens_equal": bool(torch.equal(out_lens, e_lens)),
                      "frames": out_lens.tolist()}
    out["ctc_asr"] = {"ids_equal": bool(torch.equal(asr_ids, e_ids)),
                      "lens_equal": bool(torch.equal(asr_lens, e_lens2)),
                      "lens": asr_lens.tolist()}
    out["vocode"] = {"wav_rel_err": rel(wav, e_wav), "samples": wav.shape[1]}
    out["calls"] = calls
    n = cfg.num_layers
    assert out["graph_flash_nodes"] == {"nar_tts": 2 * n, "ctc_asr": n, "vocode": 0}, out
    assert [calls[k]["launches_bf16"] for k in ("nar_tts", "ctc_asr", "vocode")] == \
        [2 * n, n, 0], calls
    assert all(calls[k]["launches_f32"] == 0 for k in calls), calls
    assert out["nar_tts"]["post_rel_err"] <= 1e-5 and out["nar_tts"]["out_lens_equal"], out
    assert out["ctc_asr"]["ids_equal"] and out["ctc_asr"]["lens_equal"], out
    assert out["vocode"]["wav_rel_err"] <= 1e-5, out
    assert min(out["nar_tts"]["frames"]) >= 100, out
    out["dispatch"] = dispatch_cost(fa)

    # compat: the reference layout of the flagship trees and the vocoder
    cpu = lambda t: nn.tree_to(t, "cpu")

    def equal(a, b):
        fa_, fb_ = tree_paths(a), tree_paths(b)
        return fa_.keys() == fb_.keys() and all(torch.equal(fa_[k], fb_[k]) for k in fa_)

    t = time.perf_counter()
    fp, fs = cpu(flag_params), cpu(flag_state)
    sd = CE.export_state_dict(fp, fs)
    compat = {"keys": len(sd),
              "flagship_equal": equal(CI.import_state_dict(sd, cfg), (fp, fs))}
    vp, vs = cpu(vocoder_pv[0]), cpu(vocoder_pv[1])
    compat["vocoder_equal"] = equal(
        CI.import_vocoder_state_dict(CE.export_vocoder_state_dict(vp, vs)), (vp, vs))
    with tempfile.TemporaryDirectory() as tmp:
        CE.export_checkpoint(fp, fs, os.path.join(tmp, "ref.ckpt"), epoch=2)
        flags = ["--config", CONFIG, "--device", "cpu"]
        CI.main([os.path.join(tmp, "ref.ckpt"), os.path.join(tmp, "ours"), *flags])
        CE.main([os.path.join(tmp, "ours", "model_most_recent.ckpt"),
                 os.path.join(tmp, "back.ckpt"), *flags])
        ref = torch.load(os.path.join(tmp, "ref.ckpt"), weights_only=False)["state_dict"]
        back = torch.load(os.path.join(tmp, "back.ckpt"), weights_only=False)["state_dict"]
        compat["cli_equal"] = ref.keys() == back.keys() and all(
            torch.equal(ref[k], back[k]) for k in ref)
    compat["s"] = time.perf_counter() - t
    out["compat"] = compat
    assert compat["flagship_equal"] and compat["vocoder_equal"] and compat["cli_equal"], compat
    out["phase_s"] = time.perf_counter() - t_phase
    return out


DP_RANKS = 2      # phase 20's world
DPTP_RANKS = 4    # its dp 2 x tp 2 world
# phase 20's TINY float32 mesh cases: (mesh, config overrides, zero); the
# MoE cases overflow their capacity in groups of 16 tokens that straddle
# the dp ranks' rows, or the sp ranks' frames
MOE_OVERFLOW = dict(moe_experts=4, moe_capacity_factor=0.5, moe_group_size=16)
MESH_TINY_CASES = {
    "moe_dp": ("dp", MOE_OVERFLOW, 1),
    "tp": ("tp", {}, 0),
    "ep": ("ep", dict(moe_experts=4, moe_group_size=16), 0),
    "sp": ("sp", {}, 0),
    "pp": ("pp", dict(pp=2), 0),
    "sp_remat": ("sp", dict(remat=True), 0),
    "sp_remat_dots_all": ("sp", dict(remat=True, remat_policy="dots_all"), 0),
    "sp_moe_dispatch": ("sp", MOE_OVERFLOW, 0),
    "sp_moe_ragged": ("sp", dict(moe_experts=4, moe_impl="ragged"), 0),
    "sp_rnn": ("sp", dict(model_type="rnn"), 0),
}
# the 4-rank world's TINY cases: (make_mesh's dp, tp, sp, ep, pp; config
# overrides, zero)
MESH4_CASES = {
    "tiny_dp2_tp2_zero1": ((2, 2, 1, 1, 1), {}, 1),
    "tiny_dp2_pp2": ((2, 1, 1, 1, 2), dict(pp=2), 0),
    "tiny_tp2_pp2": ((1, 2, 1, 1, 2), dict(pp=2), 0),
    "tiny_ep2_pp2": ((1, 1, 1, 2, 2), dict(pp=2, moe_experts=4, moe_group_size=16), 0),
    "tiny_sp2_pp2": ((1, 1, 2, 1, 2), dict(pp=2), 0),
}
MESH4_KEYS = tuple(MESH4_CASES)


def _tiny_ok(c):
    """Phase 8's tolerances on a compare_train_steps result."""
    return (c["metrics_rel"] <= 1e-4 and c["state_abs"] <= 1e-5
            and c["gen_mu_scaled"] <= 1 and c["disc_mu_scaled"] <= 1
            and c["update_abs"] <= 1e-3)


def dp_worker(rank: int, port: str, out_dir: str, world: int = DP_RANKS) -> int:
    """One rank of phase 20's worlds (`python3 chip_smoke.py --dp-worker
    RANK PORT OUT_DIR WORLD`). NCCL refuses two ranks on one device, so the
    ranks share the one card under gloo, which moves the collectives'
    tensors through the host. The 2-rank world runs the dp, tp and ep
    cases, the 4-rank one the dp 2 x tp 2 step. Writes
    OUT_DIR/rank<RANK>.json; raises (exit 1) on any failed check."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import TINY, ModelConfig, unast_init
    from unast_tpu_torch.nn import tree_to
    from unast_tpu_torch.ops import attention
    from unast_tpu_torch.parallel.mesh import (axis_size, batch_shardings, make_mesh,
                                               shard_train_step, state_bytes)
    from unast_tpu_torch.train import init_train_state, make_train_step, train_state
    from unast_tpu_torch.train.config import train_args
    from unast_tpu_torch.train.steps import (ZERO_DROPOUTS, flash_calls_per_step,
                                             seeded_generator, zero_fixed_dropouts)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    fa = attention.flash_attention
    out = {"rank": rank}
    tiny_t = TINY.replace(use_discriminator=True, attn_impl="flash", **ZERO_DROPOUTS)
    targs = train_args(CONFIG, sp_steps=2)
    tb = train_batches(np.random.default_rng(1), targs, tiny_t, 4, 12, 20, "cuda")

    singles = {}

    def tiny_case(mesh, cfg_t, zero, dp_coord):
        # one sharded step from the same weights on every rank against the
        # single-process step on the whole batch (once a config), both on
        # the card
        p0, s0 = unast_init(torch.Generator().manual_seed(0), cfg_t)
        fresh = lambda: train_state(tree_to(p0, "cuda"), tree_to(s0, "cuda"),
                                    cfg_t, targs)
        with zero_fixed_dropouts():
            if cfg_t not in singles:
                singles[cfg_t] = make_train_step(cfg_t, targs)(
                    fresh(), torch.Generator(device="cuda").manual_seed(0), tb)
            single = singles[cfg_t]
            step, placed = shard_train_step(make_train_step(cfg_t, targs), mesh,
                                            fresh(), zero=zero)
            seen, f32_0 = {}, fa.launches_f32
            bwd0 = (fa.backward_calls, fa.backward_launches_f32, fa.backward_launches_bf16)
            with recorded_flash_inputs(seen):
                new, m = step(placed, seeded_generator(0, dp_coord, "cuda"),
                              batch_shardings(mesh, tb))
            launches = fa.launches_f32 - f32_0
            bwd = [fa.backward_calls - bwd0[0], fa.backward_launches_f32 - bwd0[1],
                   fa.backward_launches_bf16 - bwd0[2]]
            whole = step.plan.whole(new)
        c = compare_train_steps(targs.lr, **joint_step_comparison((whole, m), single))
        # the float32 kernel on this rank's own views (its heads under tp)
        c["flash_launches_f32"] = launches
        # and its backward: each call one launch of the float32 kernel
        c["backward_calls"], c["backward_launches_f32"], c["backward_launches_bf16"] = bwd
        c["flash_vs_plain"] = check_recorded_flash(seen)
        if cfg_t.model_type == "transformer":
            c["ok"] = (_tiny_ok(c) and launches > 0 and bool(c["flash_vs_plain"])
                       and bwd[0] == bwd[1] > 0 and bwd[2] == 0
                       and all(r["ok"] for r in c["flash_vs_plain"]))
        else:   # the RNN backbone calls no attention kernel
            c["ok"] = _tiny_ok(c) and launches == 0 and bwd == [0, 0, 0]
        c["opt_state_bytes"] = state_bytes(new.gen_opt) + state_bytes(new.disc_opt)
        c["opt_state_bytes_whole"] = (state_bytes(single[0].gen_opt)
                                      + state_bytes(single[0].disc_opt))
        return c

    if world == DPTP_RANKS:
        # at TINY the combinations two ranks cannot hold: dp 2 x tp 2 under
        # zero 1 (a dp group's tp peers, ZeRO on top of the tp slices), dp 2
        # x pp 2 (JAX's test_pp_train_step_matches_unsharded layout), and a
        # pp axis beside tp, ep (the MoE stack unstaged) and sp
        for name, ((dp_, tp_, sp_, ep_, pp_), over, zero) in MESH4_CASES.items():
            t = time.perf_counter()
            mesh = make_mesh(dp_, tp_, sp_, ep_, pp_)
            c = tiny_case(mesh, tiny_t.replace(**over), zero,
                          mesh.get_local_rank("dp"))
            c["s"] = time.perf_counter() - t
            out[name] = c
            assert c["ok"], c
        c = out["tiny_dp2_tp2_zero1"]
        assert c["opt_state_bytes"] < 0.5 * c["opt_state_bytes_whole"], c
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
        return 0

    mesh = make_mesh(DP_RANKS)
    meshes = {"dp": mesh, "tp": make_mesh(1, DP_RANKS), "ep": make_mesh(1, 1, ep=DP_RANKS),
              "sp": make_mesh(1, sp=DP_RANKS), "pp": make_mesh(1, pp=DP_RANKS)}
    # (a) TINY, float32, every dropout at 0: one dp step per ZeRO level
    # against the single-process step on the whole batch, on the card
    tiny = {}
    for zero in (0, 1, 3):
        tiny[f"zero{zero}"] = tiny_case(mesh, tiny_t, zero, rank)
    # the MoE capacity under dp, tp = 2 and ep = 2 (the tp and ep ranks
    # share dp coordinate 0's stream)
    for name, (m, over, zero) in MESH_TINY_CASES.items():
        t = time.perf_counter()
        tiny[name] = tiny_case(meshes[m], tiny_t.replace(**over), zero,
                               rank if m == "dp" else 0)
        tiny[name]["s"] = time.perf_counter() - t
    assert all(c["ok"] for c in tiny.values()), tiny
    for k in ("sp", "sp_remat", "sp_remat_dots_all", "sp_moe_dispatch"):
        assert rank == 0 or any(r["q_start"] > 0 for r in tiny[k]["flash_vs_plain"]), \
            tiny[k]
    assert all(r["q"][2] == tiny_t.nhead // DP_RANKS
               for r in tiny["tp"]["flash_vs_plain"]), tiny["tp"]
    # Synthesizer(mesh=) against the single-process one (3 requests, padded
    # to 4), TINY float32 on the card
    tcfg = TINY.replace(attn_impl="flash")
    sp_, ss_ = unast_init(torch.Generator().manual_seed(3), tcfg)
    kw = dict(text_buckets=(16,), mel_buckets=(24,), max_batch=4, device="cuda")
    rng = np.random.default_rng(5)
    mels = [rng.uniform(0, 1, (n, 80)).astype(np.float32) for n in (24, 17, 9)]
    texts = ["hello world", "hi", "ok then"]
    one, dps = Synthesizer(sp_, ss_, tcfg, **kw), Synthesizer(sp_, ss_, tcfg, mesh=mesh, **kw)
    mel_err = max(float(np.abs(a - b).max()) for a, b in
                  zip(dps.tts_mels(texts), one.tts_mels(texts)))
    ids_equal = all(np.array_equal(a, b) for a, b in zip(dps.asr_ids(mels), one.asr_ids(mels)))
    tiny["synthesizer_mesh"] = {"tts_mels_max_abs_err": mel_err, "asr_ids_equal": ids_equal}
    assert mel_err <= 1e-5 and ids_equal, tiny["synthesizer_mesh"]
    out["tiny"] = tiny
    # (b) the flagship joint step, bf16, ZeRO-1 then ZeRO-3, each rank 2 of
    # the 4 rows of the config's batch
    cfg = ModelConfig.from_json(CONFIG).replace(attn_impl="flash")
    args = train_args(CONFIG)
    flag = {}
    whole_batches = train_batches(np.random.default_rng(0), args, cfg,
                                  args.train_batch_size, args.data_text_len,
                                  args.data_mel_len, "cuda")
    # the dp steps under ZeRO 1 and 3 (each rank 2 of the 4 rows), then one
    # tp = 2 step (each rank all 4 rows and 2 of the 4 heads), one sp = 2
    # step (each rank all 4 rows and half of every sequence's frames) and
    # one pp = 2 step (each rank its stage's 2 of the 4 layers of every
    # pipelined stack, 4 micro-batches of 1 row)
    for key, m, zero in [(f"zero{z}", mesh, z) for z in DP_FLAGSHIP_ZEROS] + [
            ("tp2", meshes["tp"], 0), ("sp2", meshes["sp"], 0),
            ("pp2", meshes["pp"], 0)]:
        cfg_k = cfg.replace(pp=axis_size(m, "pp"))
        fwd, bwd = flash_calls_per_step(cfg_k, args, rows=args.train_batch_size,
                                        staged=axis_size(m, "pp") > 1)
        ts = init_train_state(torch.Generator().manual_seed(0), cfg_k, args, "cuda")
        whole_bytes = state_bytes(ts.gen_opt) + state_bytes(ts.disc_opt)
        whole_params = state_bytes(ts.params)
        tp = axis_size(m, "tp")
        split_params = split_bytes(ts.params, tp)
        split_opt = split_bytes(ts.gen_opt, tp) + split_bytes(ts.disc_opt, tp)
        step, placed = shard_train_step(make_train_step(cfg_k, args), m, ts, zero=zero)
        del ts
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(fa)
        bwd0 = fa.backward_calls
        seen = {}
        dist.barrier()
        t = time.perf_counter()
        with recorded_flash_inputs(seen):
            new, met = step(placed, seeded_generator(0, rank if m is mesh else 0, "cuda"),
                            batch_shardings(m, whole_batches))
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t,
               "rows": args.train_batch_size // (DP_RANKS if m is mesh else 1),
               "heads": cfg.nhead // tp,
               "frames_text_mel": [-(-n // axis_size(m, "sp")) for n in
                                   (args.data_text_len, args.data_mel_len)],
               "layers_per_pipelined_stack": cfg.num_layers // axis_size(m, "pp"),
               "flash_counted": [fwd, bwd],
               "flash_launches_bf16": fa.launches_bf16, "flash_launches_f32": fa.launches_f32,
               "backward_calls": fa.backward_calls - bwd0,
               "backward_launches": fa.backward_launches, **bwd_launches(fa),
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "param_bytes": state_bytes(new.params), "param_bytes_whole": whole_params,
               "opt_state_bytes": state_bytes(new.gen_opt) + state_bytes(new.disc_opt),
               "opt_state_bytes_whole": whole_bytes,
               "param_bytes_split_rule": split_params,
               "opt_state_bytes_split_rule": split_opt,
               "metrics": {k: float(v) for k, v in met.items()}}
        # the bf16 kernel against its plain version on every layout the
        # step gave it (the fused q/k/v views of the rank's heads)
        rec["flash_vs_plain"] = check_recorded_flash(seen)
        kinds = {(r["self"], r["causal"]) for r in rec["flash_vs_plain"]}
        assert all(np.isfinite(v) for v in rec["metrics"].values()), rec
        assert (rec["flash_launches_bf16"], rec["flash_launches_f32"],
                rec["backward_calls"], rec["backward_launches"],
                rec["backward_launches_f32"]) == (fwd, 0, bwd, bwd, 0), (rec, fwd, bwd)
        assert all(r["ok"] and r["q"][2] == rec["heads"]
                   for r in rec["flash_vs_plain"]), rec["flash_vs_plain"]
        if key == "sp2":   # the rank's queries against the gathered keys
            assert {r["q"][1] for r in rec["flash_vs_plain"]} <= {
                -(-n // axis_size(m, "sp")) for n in (
                    args.data_text_len, args.data_mel_len, cfg.max_text_len,
                    cfg.max_mel_len)}, rec["flash_vs_plain"]
            assert rank == 0 or any(r["causal"] and r["q_start"] > 0
                                    for r in rec["flash_vs_plain"]), kinds
        else:
            assert {(True, True), (True, False), (False, False)} <= kinds, kinds
        if m is mesh:
            assert rec["opt_state_bytes"] < 0.6 * whole_bytes, rec
        elif key in ("sp2", "pp2"):   # replicated over sp and pp, as in JAX
            assert (rec["param_bytes"], rec["opt_state_bytes"]) == (
                whole_params, whole_bytes), rec
        else:   # each tp-split leaf's half, every other leaf whole
            assert (rec["param_bytes"], rec["opt_state_bytes"]) == (
                split_params, split_opt), rec
        flag[key] = rec
        del new, placed, step
        torch.cuda.empty_cache()
    out["flagship"] = flag
    out["wide_sp2"] = wide_sp_step(meshes["sp"], rank)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


DP_FLAGSHIP_ZEROS = (1, 3)


def wide_sp_step(mesh, rank: int) -> dict:
    """Phase 20's wide step: configs/wide_d1024.json (d 1024, 6 layers, 8
    heads of 128, ffn 4096, remat dots_all, bf16, flash) at sp = 2, one
    joint step of WIDE_SP_BATCH rows (the config's 32 cut) at
    816 / 304, each rank all the rows and its 408 / 152 frames of every
    sequence, random weights from seed 0 as phase 17's. Counts set to 0
    just before the step and read just after: the bf16 forward's launches
    (the checkpoint recompute's included) and the backward's calls and
    launches against flash_calls_per_step, no float32 launch; the step's
    seconds and the rank's peak memory; finite metrics, the same on both
    ranks; the kernel against flash_attention_plain and the backward
    kernel against flash_attention_bwd_plain on every q/k/v layout the
    rank gave the kernel (the causal queries at q_start 408 on the second
    rank)."""
    import torch.distributed as dist
    from unast_tpu_torch.models import ModelConfig
    from unast_tpu_torch.ops import attention
    from unast_tpu_torch.parallel.mesh import batch_shardings, shard_train_step
    from unast_tpu_torch.train import init_train_state, make_train_step
    from unast_tpu_torch.train.config import train_args
    from unast_tpu_torch.train.steps import flash_calls_per_step, seeded_generator
    fa = attention.flash_attention
    cfg = ModelConfig.from_json(WIDE_CONFIG).replace(attn_impl="flash")
    args = train_args(WIDE_CONFIG, train_batch_size=WIDE_SP_BATCH)
    assert cfg.remat and cfg.remat_policy == "dots_all" and cfg.head_dim == 128
    fwd, bwd = flash_calls_per_step(cfg, args, rows=WIDE_SP_BATCH)
    batches = train_batches(np.random.default_rng(0), args, cfg, WIDE_SP_BATCH,
                            args.data_text_len, args.data_mel_len, "cuda")
    ts = init_train_state(torch.Generator().manual_seed(0), cfg, args, "cuda")
    step, placed = shard_train_step(make_train_step(cfg, args), mesh, ts)
    del ts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fa)
    bwd0 = fa.backward_calls
    seen = {}
    dist.barrier()
    t = time.perf_counter()
    with recorded_flash_inputs(seen):
        new, met = step(placed, seeded_generator(0, 0, "cuda"),
                        batch_shardings(mesh, batches))
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t, "rows": WIDE_SP_BATCH, "config_rows": 32,
           "d_model": cfg.e_in, "layers": cfg.num_layers, "heads": cfg.nhead,
           "head_dim": cfg.head_dim, "ffn": cfg.ffn_dim, "remat_policy": cfg.remat_policy,
           "frames_text_mel": [-(-n // 2) for n in (args.data_text_len, args.data_mel_len)],
           "flash_counted": [fwd, bwd],
           "flash_launches_bf16": fa.launches_bf16, "flash_launches_f32": fa.launches_f32,
           "backward_calls": fa.backward_calls - bwd0,
           "backward_launches": fa.backward_launches, **bwd_launches(fa),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "metrics": {k: float(v) for k, v in met.items()}}
    del new, placed, step, batches
    torch.cuda.empty_cache()
    rec["flash_vs_plain"] = check_recorded_flash(seen)
    rec["backward_vs_plain"] = check_recorded_backward(seen, seed=rank)
    del seen
    torch.cuda.empty_cache()
    assert all(np.isfinite(v) for v in rec["metrics"].values()), rec
    assert (rec["flash_launches_bf16"], rec["flash_launches_f32"], rec["backward_calls"],
            rec["backward_launches"], rec["backward_launches_bf16"],
            rec["backward_launches_f32"]) == (fwd, 0, bwd, bwd, bwd, 0), (rec, fwd, bwd)
    local = {-(-n // 2) for n in (args.data_text_len, args.data_mel_len,
                                  cfg.max_text_len, cfg.max_mel_len)}
    assert all(r["ok"] and r["q"][1] in local and r["q"][3] == 128
               for r in rec["flash_vs_plain"]), rec["flash_vs_plain"]
    assert rec["backward_vs_plain"] and all(r["ok"] for r in rec["backward_vs_plain"]), \
        rec["backward_vs_plain"]
    assert rank == 0 or any(r["causal"] and r["q_start"] == 408
                            for r in rec["flash_vs_plain"]), rec["flash_vs_plain"]
    return rec


def split_bytes(tree, tp: int) -> int:
    """Bytes a tp rank holds of a whole tree: each leaf that split_rule
    splits over tp by its path, over tp; every other leaf whole."""
    from unast_tpu_torch.parallel.mesh import split_rule
    from unast_tpu_torch.train.optim import tree_paths
    n = 0
    for path, x in tree_paths(tree).items():
        if torch.is_tensor(x):
            split = x.ndim >= 1 and "tp" in split_rule(path, tuple(x.shape), tp, 1).axes
            n += x.numel() * x.element_size() // (tp if split else 1)
    return n


def _world(n: int) -> list:
    """Run `dp_worker` on n gloo ranks sharing the card, each joined, a
    failing rank failing the phase; their records in rank order."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                                   str(r), port, tmp, str(n)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
               in enumerate(zip(procs, logs)) if p.returncode != 0]
        if bad:
            raise SystemExit(f"phase 20: a rank of the {n}-rank world failed: {bad}")
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def dp_phase():
    """Phase 20: data, tensor, expert, sequence and pipeline parallelism on
    the one card. A
    world of two processes (`dp_worker`) under gloo, both ranks on the one
    H100 (NCCL refuses two ranks on one device): (a) at TINY in float32
    with every dropout at 0, one dp step per ZeRO level 0, 1 and 3, the
    dp = 2 dispatch-MoE step whose capacity overflows in groups straddling
    the ranks (zero 1), a tp = 2 step and an ep = 2 step (E 4), each
    against the single-process step on the whole batch on the card (phase
    8's tolerances), an sp = 2 and a pp = 2 step likewise, and
    Synthesizer(mesh=) TTS mels and ASR ids against the single-process
    Synthesizer; (b) at flagship width in bf16, one dp joint step with
    zero=1 and one with zero=3 (each rank 2 of the config's 4 rows), one
    tp = 2 step (each rank the 4 rows and 2 of the 4 heads), one sp = 2
    step (each rank the 4 rows and 152 / 408 of the 304 / 816 frames) and
    one pp = 2 step (each rank its stage's 2 of the 4 layers of every
    pipelined stack, 4 micro-batches of 1 row): each rank's flash
    launches and backward calls (flash_calls_per_step: the counts depend
    on neither the rows, the heads nor the frames; a pp rank's on its
    stage and the micro-batches), its peak memory, the bytes of its
    params and optimizer state against the whole state's (a tp rank's
    equal to the split rule's count, an sp or pp rank's whole), the
    step's seconds. Every sharded step also holds the kernel against
    flash_attention_plain on each q/k/v layout it gave the kernel on that
    rank (recorded_flash_inputs: the fused views of the rank's heads, an
    sp rank's queries at their q_start). The TINY sp = 2 steps with remat
    ('' and dots_all), the overflowing dispatch MoE, the ragged MoE and
    the RNN backbone; then configs/wide_d1024.json at sp = 2
    (wide_sp_step, WIDE_SP_BATCH rows). Then a world of four ranks: dp 2 x tp 2 zero-1, dp 2
    x pp 2, tp 2 x pp 2, ep 2 x pp 2 and sp 2 x pp 2 steps at TINY
    against the single-process step (MESH4_CASES)."""
    t_phase = time.perf_counter()
    ranks = _world(DP_RANKS)
    t_four = time.perf_counter()
    four = _world(DPTP_RANKS)
    return {"ranks": DP_RANKS, "backend": "gloo", "device": "one card, shared",
            "per_rank": ranks, "dp2_tp2": {"ranks": DPTP_RANKS, "per_rank": four,
                                           "world_s": time.perf_counter() - t_four},
            "phase_s": time.perf_counter() - t_phase}


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
    assert hgmma["flash_attn_bwd_wgmma"][0] > 0, "the bf16 backward has no wgmma"
    assert hgmma["flash_attn_fwd_f32"][1] > 0, "the f32 kernel has no TF32 wgmma"
    assert hgmma["flash_attn_bwd_f32"][1] > 0, "the f32 backward has no TF32 wgmma"

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
    t = time.perf_counter()
    bwd_cases = []
    for c in BWD_CASES:
        bwd_cases.append(backward_case(c))
        print(json.dumps(backward_summary(bwd_cases[-1])), flush=True)
    bad += [c for c in bwd_cases if not c["ok"]]
    print(json.dumps({"phase": 6, "s": time.perf_counter() - t}), flush=True)

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
                "backward_calls": after[0] - before[0],
                "backward_launches": fa.backward_launches, **bwd_launches(fa)}
    for i in range(TRAIN_STEPS):
        steps.append({"step": i, **train_step()})
    train_peak = torch.cuda.max_memory_allocated()
    train_launches_bf16 = sum(s_["flash_launches_bf16"] for s_ in steps)
    # a later step under the profiler: where a step's time goes. Its wall
    # includes the profiler's own host work, so the idle share read
    # against it is an upper bound.
    profiled = {}
    traced = trace(lambda: profiled.update(train_step()), TRAIN_PARTS,
                   record_ops=False)
    busy, n_kernels, top = device_summary(traced["kernels"])
    later = steps[1:] + [profiled]
    mean_later_s = sum(s_["s"] for s_ in later) / len(later)
    flash_traced = sum(n for name, (n, _) in traced["kernels"].items()
                       if ROUTE_KERNELS[bf16][0] in name)
    breakdown = {
        "step": TRAIN_STEPS, "wall_profiled_s": traced["wall_s"],
        "profiler_stop_s": traced["stop_s"], "trace_read_s": traced["read_s"],
        "decode_steps": profiled["decode_steps"],
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / mean_later_s,
        "kernel_launches": n_kernels, "flash_kernels_traced": flash_traced,
        "parts": traced["parts"], "top_kernels": top}
    for s_ in steps + [profiled]:
        assert all(np.isfinite(v) for v in s_["metrics"].values()), s_["metrics"]
        assert s_["flash_launches_bf16"] == fwd_per_step, (s_, fwd_per_step)
        assert s_["flash_launches_f32"] == s_["backward_launches_f32"] == 0, s_
        assert (s_["backward_calls"] == s_["backward_launches"]
                == s_["backward_launches_bf16"] == bwd_per_step), (s_, bwd_per_step)
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
                  "backward_launches": fa.backward_launches, **bwd_launches(fa),
                  **compare_train_steps(targs.lr, **joint_step_comparison(on_gpu_t, on_cpu_t))}
    # float32 throughout; tolerances as tests/test_torch_train.py holds the
    # CPU path to the JAX step: metrics 1e-4 relative, BN state 1e-5,
    # first moments within 1e-4 relative + 1e-5 of the largest (scaled <= 1),
    # normalised updates 1e-3 where the moment is above 1e-7
    tiny_train["ok"] = (tiny_train["metrics_rel"] <= 1e-4 and tiny_train["state_abs"] <= 1e-5
                        and tiny_train["gen_mu_scaled"] <= 1 and tiny_train["disc_mu_scaled"] <= 1
                        and tiny_train["update_abs"] <= 1e-3)
    assert tiny_train["ok"], tiny_train
    assert (tiny_train["launches_f32"], tiny_train["launches_bf16"],
            tiny_train["backward_calls"], tiny_train["backward_launches_f32"],
            tiny_train["backward_launches_bf16"]) == (
                tiny_fwd, 0, tiny_bwd, tiny_bwd, 0), (tiny_train, tiny_fwd)
    # the flagship's joint step in float32 at full width: phase 7's config,
    # batches and objectives with compute_dtype float32, so that every
    # attention forward and backward takes the float32 kernels
    cfg32 = cfg.replace(compute_dtype="float32")
    fwd32, bwd32 = flash_calls_per_step(cfg32, args)
    ts32 = init_train_state(torch.Generator().manual_seed(0), cfg32, args)
    step32 = make_train_step(cfg32, args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(fa)
    bwd0 = fa.backward_calls
    t = time.perf_counter()
    ts32, m32 = step32(ts32, torch.Generator(device="cuda").manual_seed(0), batches)
    torch.cuda.synchronize()
    f32_step = {"config": os.path.relpath(CONFIG, ROOT), "compute_dtype": "float32",
                "batch": args.train_batch_size, "s": time.perf_counter() - t,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "metrics": {k: float(v) for k, v in m32.items()},
                "flash_launches_f32": fa.launches_f32,
                "flash_launches_bf16": fa.launches_bf16,
                "backward_calls": fa.backward_calls - bwd0,
                "backward_launches": fa.backward_launches, **bwd_launches(fa),
                "expected": [fwd32, bwd32]}
    nonfinite = [k for k, x in tree_paths(ts32.params).items()
                 if not bool(torch.isfinite(x).all())]
    assert all(np.isfinite(v) for v in f32_step["metrics"].values()), f32_step
    assert not nonfinite and ts32.step == 1, nonfinite
    assert (f32_step["flash_launches_f32"], f32_step["flash_launches_bf16"],
            f32_step["backward_calls"], f32_step["backward_launches_f32"],
            f32_step["backward_launches_bf16"]) == (fwd32, 0, bwd32, bwd32, 0), f32_step
    print(json.dumps({"phase": 8, "f32_step_s": f32_step["s"]}), flush=True)
    del ts32, step32
    torch.cuda.empty_cache()

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
    vocoder_run, vocoder_pv = vocoder_phase(fa, params, state, cfg)
    print(json.dumps({"phase": 12, "s": vocoder_run["phase_s"]}), flush=True)
    phase_ends.append((12, time.perf_counter()))
    # 20. (started here) data, tensor, expert, sequence and pipeline
    # parallelism: its worlds are processes of their own with their own
    # counts, and run beside phases 13-19, which keep the main process
    dp_pool = concurrent.futures.ThreadPoolExecutor(1)
    dp_future = dp_pool.submit(dp_phase)
    # 13.-14. data prepared on the card into shards, then the CTC family
    # trained on them and served at flagship width
    with tempfile.TemporaryDirectory() as data_root:
        data_run = data_phase(data_root)
        print(json.dumps({"phase": 13, "s": data_run["phase_s"]}), flush=True)
        phase_ends.append((13, time.perf_counter()))
        ctc_run, ctc_pv = ctc_phase(fa, params, state, cfg, data_root)
        print(json.dumps({"phase": 14, "s": ctc_run["phase_s"]}), flush=True)
        phase_ends.append((14, time.perf_counter()))
        # 15.-16. the one-pass families: FastSpeech distilled and served,
        # then the neural vocoders trained on the shards and served behind it
        nar_run, student = fastspeech_phase(fa, params, state, cfg, data_root)
        print(json.dumps({"phase": 15, "s": nar_run["phase_s"]}), flush=True)
        phase_ends.append((15, time.perf_counter()))
        melgan_run, melgan_params = melgan_phase(fa, params, state, cfg, student,
                                                 data_root)
        print(json.dumps({"phase": 16, "s": melgan_run["phase_s"]}), flush=True)
    phase_ends.append((16, time.perf_counter()))
    # 17.-18. the family additions: the wide model (remat, int8 serving),
    # then the conformer and MoE at flagship width (phases 15, 16, 14 and
    # 12's models stay for phase 19)
    torch.cuda.empty_cache()
    wide_run = wide_phase(fa)
    wide_run["kernel_case"] = next(c for c in cases
                                   if c["case"] == "wide_encoder_qkv_d128")
    wide_run["backward_case"] = next(c for c in bwd_cases
                                     if c["case"] == "wide_encoder_t816_d128")
    print(json.dumps({"phase": 17, "s": wide_run["phase_s"]}), flush=True)
    phase_ends.append((17, time.perf_counter()))
    families_run = families_phase(fa, cfg)
    print(json.dumps({"phase": 18, "s": families_run["phase_s"]}), flush=True)
    phase_ends.append((18, time.perf_counter()))
    # 19. the serving export of the one-pass models and the checkpoint
    # migration, at flagship width
    export_run = export_phase(fa, params, state, cfg, ctc_pv, student, melgan_params,
                              vocoder_pv)
    print(json.dumps({"phase": 19, "s": export_run["phase_s"]}), flush=True)
    phase_ends.append((19, time.perf_counter()))
    # 20. its worlds' end
    del student, ctc_pv, melgan_params, vocoder_pv
    torch.cuda.empty_cache()
    dp_run = dp_future.result()
    dp_pool.shutdown()
    print(json.dumps({"phase": 20, "s": dp_run["phase_s"]}), flush=True)
    phase_ends.append((20, time.perf_counter()))
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
    ctc_serve, ctc_train = ctc_run["serve"], ctc_run["train"]
    hybrid = ctc_run["hybrid_step"]
    for (name, dtype, source, main_name, n, path, n_train, train_path,
         n_loop, loop_path) in routes:
        main_case = next(c for c in cases if c["case"] == main_name)
        key = "launches_bf16" if dtype == "bfloat16" else "launches_f32"
        ctc_counts = {
            "launches_ctc_serve": ctc_serve["ctc"][key] + ctc_serve["ctc_beam"][key],
            "launches_ctc_serve_counted_on":
                "Synthesizer(ctc_pv=) one-pass and ctc_beam 4, 8 ASR each, bf16 (phase 14)",
            "launches_spec": ctc_serve["spec"][key],
            "launches_spec_counted_on":
                f"Synthesizer(ctc_pv=) spec=True, 8 ASR, {ctc_serve['spec']['spec_rounds']} "
                "verify rounds, bf16 (phase 14)",
            "launches_ar_beam": ctc_serve["beam"][key],
            "launches_ar_beam_counted_on": "Synthesizer beam=4, 8 ASR, bf16 (phase 14)",
            "launches_ctc_train": ctc_train[
                "flash_launches_bf16" if dtype == "bfloat16" else "flash_launches_f32"],
            "bwd_calls_ctc_train": ctc_train["backward_calls"] if dtype == "bfloat16" else 0,
            "launches_ctc_train_counted_on":
                f"{CTC_TRAIN_STEPS} CTC train steps on the shard, bf16 (phase 14)",
            "launches_hybrid": hybrid[key],
            "bwd_calls_hybrid": hybrid["backward_calls"] if dtype == "bfloat16" else 0,
            "launches_hybrid_counted_on":
                "1 hybrid joint step, ctc_weight 0.3, cm_text_decode spec, "
                f"{hybrid['spec_rounds']} verify rounds, bf16 (phase 14)",
            "launches_ctc_tiny": (ctc_run["tiny_gpu_vs_cpu"]["launches_f32"]
                                  if dtype == "float32" else 0),
            "launches_ctc_tiny_counted_on":
                "TINY ctc_logits on the card, float32, abs/chunk/rel (phase 14)"}
        distill = nar_run["distill"]["steps"]
        nar_tiny = nar_run["tiny_gpu_vs_cpu"]
        one_pass_counts = {
            "launches_nar_serve": nar_run["serve"][f"flash_{key}"],
            "launches_nar_serve_counted_on":
                "Synthesizer(nar_pv=) tts, 8 TTS, bf16 (phase 15)",
            "launches_distill": sum(s_[key] for s_ in distill),
            "bwd_calls_distill": (sum(s_["backward_calls"] for s_ in distill)
                                  if dtype == "bfloat16" else 0),
            "launches_distill_counted_on":
                f"{len(distill)} distill steps ({', '.join(NAR_STEP_SOURCES)}), "
                "B4 at 816 / 304, bf16 (phase 15)",
            "launches_nar_melgan_serve": melgan_run["serve"][f"flash_{key}"],
            "launches_nar_melgan_serve_counted_on":
                "Synthesizer(nar_pv=, melgan_params=, pcm16=True), 8 TTS, bf16 (phase 16)",
            "launches_nar_tiny": (nar_tiny["forward_launches_f32"]
                                  + nar_tiny["step"]["launches_f32"]
                                  if dtype == "float32" else 0),
            "launches_nar_tiny_counted_on":
                "TINY fastspeech_forward (2) and 1 distill step on the card, float32 "
                "(phase 15)"}
        ws = wide_run["serve"]
        fam_steps = [families_run[k]["step"] for k in
                     ("conformer", "moe_ragged", "moe_dispatch")]
        fam_serve = [r for k in ("conformer", "moe_ragged")
                     for r in (families_run[k].get("asr"), families_run[k].get("tts")) if r]
        family_counts = {
            "launches_wide_step": wide_run["step"][key],
            "bwd_calls_wide_step": (wide_run["step"]["backward_calls"]
                                    if dtype == "bfloat16" else 0),
            "launches_wide_step_counted_on":
                "configs/wide_d1024.json joint step, remat dots_all (the "
                "encoders' checkpoint recompute included), B8 at 816 / 304, "
                "bf16 (phase 17)",
            "launches_wide_serve": sum(ws[q][x][key] for q in ("bf16", "int8")
                                       for x in ("tts", "asr")),
            "launches_wide_serve_counted_on":
                "wide Synthesizer, 8 TTS + 8 ASR with bf16 weights and again "
                "with quantize='int8', D 128 (phase 17)",
            "launches_family_steps": sum(s_[key] for s_ in fam_steps),
            "bwd_calls_family_steps": (sum(s_["backward_calls"] for s_ in fam_steps)
                                       if dtype == "bfloat16" else 0),
            "launches_family_steps_counted_on":
                "ae + sp steps at flagship width: conformer, MoE ragged, MoE "
                "dispatch, B4 at 816 / 304, bf16 (phase 18)",
            "launches_family_serve": sum(r[key] for r in fam_serve),
            "launches_family_serve_counted_on":
                "conformer 8 ASR; MoE ragged 8 TTS + 8 ASR, bf16 (phase 18)",
            "launches_family_tiny": families_run["tiny_gpu_vs_cpu"][key],
            "launches_family_tiny_counted_on":
                "TINY conformer, MoE stacks under remat and scan, quantized "
                "TTS forward on the card, float32 (phase 18)"}
        ex_calls = export_run["calls"]
        dp_flag = [r["flagship"][f"zero{z}"] for r in dp_run["per_rank"]
                   for z in DP_FLAGSHIP_ZEROS]
        tp_flag = [r["flagship"]["tp2"] for r in dp_run["per_rank"]]
        sp_flag = [r["flagship"]["sp2"] for r in dp_run["per_rank"]]
        pp_flag = [r["flagship"]["pp2"] for r in dp_run["per_rank"]]
        wide_sp = [r["wide_sp2"] for r in dp_run["per_rank"]]
        slice10_counts = {
            "launches_export": sum(c[key] for c in ex_calls.values()),
            "launches_export_counted_on":
                "the exported nar_tts, ctc_asr and vocode programs of "
                "export_synthesizer, one call each at B8, text 304 / mel 816 "
                "(the last of two calls), bf16 (phase 19)",
            "launches_dp_flagship": sum(r[f"flash_{key}"] for r in dp_flag),
            "bwd_calls_dp_flagship": (sum(r["backward_calls"] for r in dp_flag)
                                      if dtype == "bfloat16" else 0),
            "launches_dp_flagship_counted_on":
                f"dp = 2 joint steps at flagship width, zero {DP_FLAGSHIP_ZEROS}, "
                "each rank 2 of 4 rows, both ranks' counts, bf16 (phase 20; "
                "the TINY float32 dp checks are not counted)",
            "launches_tp_flagship": sum(r[f"flash_{key}"] for r in tp_flag),
            "launches_tp_flagship_per_rank": [r[f"flash_{key}"] for r in tp_flag],
            "bwd_calls_tp_flagship": (sum(r["backward_calls"] for r in tp_flag)
                                      if dtype == "bfloat16" else 0),
            "launches_tp_flagship_counted_on":
                "one tp = 2 joint step at flagship width, each rank the 4 rows "
                "and 2 of the 4 heads, both ranks' counts, bf16 (phase 20; the "
                "TINY float32 tp, ep and dp x tp checks are not counted)",
            "launches_sp_flagship_per_rank": [r[f"flash_{key}"] for r in sp_flag],
            "bwd_calls_sp_flagship_per_rank": [
                r["backward_calls"] if dtype == "bfloat16" else 0 for r in sp_flag],
            "launches_sp_flagship_counted_on":
                "one sp = 2 joint step at flagship width, each rank the 4 rows "
                "and its half of every sequence's frames (q_start at the "
                "second rank's), bf16 (phase 20)",
            "launches_pp_flagship_per_rank": [r[f"flash_{key}"] for r in pp_flag],
            "bwd_calls_pp_flagship_per_rank": [
                r["backward_calls"] if dtype == "bfloat16" else 0 for r in pp_flag],
            "launches_pp_flagship_counted_on":
                "one pp = 2 joint step at flagship width, each rank its stage's "
                "2 of the 4 layers of every pipelined stack on 4 micro-batches "
                "of 1 row, the guided-attention decoders whole, bf16 (phase 20; "
                "the TINY float32 sp, pp and dp x pp checks are not counted)",
            "launches_wide_sp_per_rank": [r[f"flash_{key}"] for r in wide_sp],
            "bwd_calls_wide_sp_per_rank": [
                r["backward_calls"] if dtype == "bfloat16" else 0 for r in wide_sp],
            "launches_wide_sp_counted_on":
                f"one configs/wide_d1024.json joint step at sp = 2, B{WIDE_SP_BATCH} "
                "(the config's 32 cut), each rank 408 / 152 of the 816 / 304 "
                "frames, remat dots_all (the recompute's launches included), "
                "D 128, bf16 (phase 20)"}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"unast_tpu_torch/csrc/{source}",
            "replaces": "unast_tpu/ops/attention.py:81",
            "dtype": dtype, "launches": n, "launches_counted_on": path,
            "launches_train": n_train, "launches_train_counted_on": train_path,
            "launches_flagship_f32_step": f32_step[f"flash_{key}"],
            "launches_flagship_f32_step_counted_on":
                "flagship train: 1 step with compute_dtype float32 (phase 8)",
            "launches_loop": n_loop, "launches_loop_counted_on": loop_path,
            "launches_vocoder_serve": vocoder_run[
                "flash_launches_bf16" if dtype == "bfloat16" else "flash_launches_f32"],
            "launches_vocoder_serve_counted_on":
                "flagship serve through the CBHG vocoder: 8 TTS, bf16 (phase 12)",
            "launches_rnn": rnn_serve_run["flash_launches"] + sum(
                s_["flash_launches"] for s_ in rnn_train_run["steps"]),
            "launches_rnn_counted_on": "rnn_d serve (8 TTS + 8 ASR) and 2 train steps "
                                       "(phases 10, 11): the RNN calls no attention kernel",
            **ctc_counts, **one_pass_counts, **family_counts, **slice10_counts,
            **{key: main_case[key] for key in (
                "max_abs_err", "lse_max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_device_ms",
                "prepass_device_ms", "bound_cuda_core_ms") if key in main_case},
            "lse_worst_err_over_tol": max(c["lse_err_over_tol"] for c in cases
                                          if c["dtype"] == dtype),
            "hgmma_instructions": hgmma[name][0],
            "main_case": main_name,
            "cases": [c for c in cases if c["dtype"] == dtype]})
    kernels.append(backward_row(
        bf16, bwd_cases, hgmma, sum(s_["backward_launches_bf16"] for s_ in steps),
        f"flagship train: {TRAIN_STEPS} untraced step(s), bf16 (phase 7), one "
        "launch = the two kernels of one backward",
        bf16_backward_paths(loop_run, ctc_run, nar_run, wide_run, families_run, dp_run)))
    kernels.append(backward_row(
        f32, bwd_cases, hgmma, f32_step["backward_launches_f32"],
        "flagship train: 1 step with compute_dtype float32 (phase 8), one launch = "
        "the two kernels of one backward",
        f32_backward_paths(tiny_train, loop_run, ctc_run, nar_run, families_run, dp_run)))
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
        "f32_step": f32_step,
    }}))

    print(json.dumps({"loop": loop_run}))
    print(json.dumps({"rnn_serve": rnn_serve_run}))
    print(json.dumps({"rnn_train": rnn_train_run}))
    print(json.dumps({"vocoder": vocoder_run}))
    print(json.dumps({"data": data_run}))
    print(json.dumps({"ctc": ctc_run}))
    print(json.dumps({"nar": nar_run}))
    print(json.dumps({"melgan": melgan_run}))
    print(json.dumps({"wide": wide_run}))
    print(json.dumps({"families": families_run}))
    print(json.dumps({"export": export_run}))
    print(json.dumps({"dp": dp_run}))
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
    print(smi[0])   # the card's name and power limit again, near the end
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                           int(sys.argv[5])))
    sys.exit(main())
