"""Entry: one-pass text-to-speech through the port's Synthesizer
(unast_tpu_torch/infer/serve.py): a FastSpeech student (one pass, the
length regulator) and a MelGAN generator, PCM16 waveforms cut and trimmed
on the host. A closed loop: one caller sends a batch of texts and the
next when it returns.

The weights are made from the seed on the device in the program's
layouts, the duration head's bias and scale set from the traffic file so
that the student speaks at the rate it states (frames a phoneme). The
durations the student serves are recorded where the length regulator
takes them: the check judges them against the reference's own
prediction and is teacher-forced on them, as a served model's tokens.
"""

import math
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import flash_calls, traffic as T
from benchmark.reference import flops as FL
from benchmark.reference import model as RM
from benchmark.reference import serve as RS


def _weight_seeds(seed):
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, 11]).generate_state(2)
    return int(ss[0]), int(ss[1])


def weights(c, t, seed, device):
    s_nar, s_voc = _weight_seeds(seed)
    rate = t["frames_per_phoneme"]
    nar = RM.make_weights(RS.fastspeech_spec(c), s_nar, device, overrides={
        "dur/fc/w": (t["duration_weight_scale"], 0.0),
        "dur/fc/b": (0.0, math.log1p(rate))})
    state = RM.tree_map(lambda x: x.to(device), RS.fastspeech_state(c))
    voc = RM.make_weights(RS.melgan_spec(c["num_mels"], t["melgan_base"]),
                          s_voc, device)
    return nar, state, voc


def _bucket(buckets, need):
    for b in buckets:
        if need <= b:
            return b
    return buckets[-1]


def setup(cell, seed, device):
    from unast_tpu_torch.infer.serve import Synthesizer
    from unast_tpu_torch.models import fastspeech as FS
    from unast_tpu_torch.train.config import model_config_from_args, train_args

    c, t = cell.config, cell.traffic
    args = train_args(os.path.join(cell.root, cell.config_entry["file"]))
    cfg = model_config_from_args(args)
    nar, nar_state, voc = weights(c, t, seed, device)
    syn = Synthesizer({}, {}, cfg, nar_pv=(nar, nar_state), melgan_params=voc,
                      max_batch=t["batch"], pcm16=True,
                      text_buckets=t["text_buckets"],
                      mel_buckets=t["mel_buckets"], device=device)
    lexicon = RS.load_lexicon(cell.root)
    pool = T.texts(t, lexicon, seed, t["pool_batches"])
    state = {"cell": cell, "seed": seed, "device": device, "syn": syn,
             "pool": pool, "lexicon": lexicon, "next": 0, "served": {},
             "durations": None}
    # the student's durations, as the length regulator takes them
    inner = FS.length_regulate

    def regulate(x, durations, max_len):
        if state["durations"] is not None:
            state["durations"].append(durations)
        return inner(x, durations, max_len)

    FS.length_regulate = regulate
    state["restore"] = lambda: setattr(FS, "length_regulate", inner)
    # warm-up: every batch of the pool once (each text and mel bucket the
    # window meets), the last served output of each kept for the check
    for _ in range(len(pool)):
        _one(state)
    return state


def _one(state):
    i = state["next"] % len(state["pool"])
    texts = state["pool"][i]
    state["durations"] = []
    t0 = time.perf_counter()
    with record_function("bench/tts_batch"):
        wavs = state["syn"].tts(texts)
    dt = time.perf_counter() - t0
    state["served"][i] = (wavs, state["durations"])
    state["durations"] = None
    state["next"] += 1
    return dt, len(wavs)


def window(state, seconds):
    lat, done = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        dt, n = _one(state)
        lat.append(dt)
        done += n
    wall = time.perf_counter() - t0
    b = state["cell"].traffic["batch"]
    return {"batches": len(lat), "seconds": wall, "latencies": lat,
            "utterances": done, "attempted": len(lat) * b, "unit_s": lat,
            "failed": len(lat) * b - done,
            "model_flops": _window_flops(state, len(lat))}


def _window_flops(state, n_batches):
    """Model FLOPs of the window's batches: the student and the generator
    at the phonemes and frames each utterance had (the last served
    durations of each pool batch)."""
    c, t = state["cell"].config, state["cell"].traffic
    per_batch = {}
    for i, (_, durs) in state["served"].items():
        d = durs[0].cpu().numpy()
        total = 0
        for text, row in zip(state["pool"][i], d):
            n_tok = len(RS.phonemize(text, state["lexicon"]))
            frames = min(int(row.sum()), c["max_mel_len"])
            total += (FL.fastspeech_forward(c, n_tok, frames)
                      + FL.melgan_forward(frames, c["num_mels"], t["melgan_base"]))
        per_batch[i] = total
    start = state["next"] - n_batches
    return sum(per_batch[(start + k) % len(state["pool"])]
               for k in range(n_batches))


def tail(state):
    n = state["cell"].traffic["trace_batches"]
    with flash_calls.recording() as calls:
        for _ in range(n):
            _one(state)
    state["tail"] = {"batches": n, "flash": calls}


def end_to_end(state, win):
    lat = np.asarray(win["latencies"])
    return {"serve_utt_per_s": win["utterances"] / win["seconds"],
            "serve_batch_p95_s": float(np.percentile(lat, 95))}


def sample(state, n):
    """n served utterances drawn from the seed, the one with the most
    phonemes among them: [(pool batch, row)]."""
    served = sorted(state["served"])
    items = [(i, r) for i in served for r in range(len(state["pool"][i]))]
    lex = state["lexicon"]
    longest = max(items, key=lambda ir: len(
        RS.phonemize(state["pool"][ir[0]][ir[1]], lex)))
    r = T.rng(state["seed"], 3)
    picks = [items[k] for k in r.choice(len(items), size=n - 1, replace=False)]
    return [longest] + [p for p in picks if p != longest][:n - 1]


def judge(state, win, detail=None):
    """The reference over a sample of the served utterances, each
    teacher-forced on the durations the program served (`_readings`)."""
    state["restore"]()
    state.pop("syn")
    if state["device"] == "cuda":
        torch.cuda.empty_cache()
    return _readings(state, lambda i, row, ref: (
        state["served"][i][1][0][row, :len(ref[0])].cpu().numpy(),
        state["served"][i][0][row]), detail)


def control(cell, seed, device, prec, detail=None):
    """The control's readings: the reference in `prec` put in the
    program's place at the same prompts and served durations: the
    durations it would serve and its PCM16 waveform, cut and trimmed."""
    state = setup(cell, seed, device)
    state["restore"]()
    state.pop("syn")
    nar, nar_state, voc = weights(cell.config, cell.traffic, seed, device)

    def got(i, row, ref):
        logd, wav = _reference(state, i, row, nar, nar_state, voc, prec)
        pcm = RS.pcm16(wav)
        start, end = RS.trim_bounds(pcm)
        return np.maximum(np.round(np.expm1(logd)), 0.0), pcm[start:end]
    return _readings(state, got, detail)


def _reference(state, i, row, nar, nar_state, voc, prec):
    """The reference of utterance `row` of pool batch `i` in `prec`,
    teacher-forced on the durations the program served, padded and
    bucketed as the program did: (its log-duration predictions of the
    row's tokens, its waveform cut at the frame count)."""
    c, t = state["cell"].config, state["cell"].traffic
    dev = state["device"]
    text_caps = sorted({min(b, c["max_text_len"]) for b in t["text_buckets"]})
    mel_caps = sorted({min(b, c["max_mel_len"]) for b in t["mel_buckets"]})
    ids_all = [RS.phonemize(x, state["lexicon"]) for x in state["pool"][i]]
    tl = _bucket(text_caps, max(len(x) for x in ids_all))
    served_d = state["served"][i][1][0].cpu().numpy()
    frames_all = np.minimum(served_d.sum(1), c["max_mel_len"])
    tb = _bucket(mel_caps, max(1, int(frames_all.max())))
    n = min(len(ids_all[row]), tl)
    ids = torch.zeros((1, tl), dtype=torch.long, device=dev)
    ids[0, :n] = torch.as_tensor(ids_all[row][:n], device=dev)
    d = torch.as_tensor(served_d[row:row + 1], device=dev)
    post, out_lens, logd = RS.fastspeech(
        nar, nar_state, c, ids, torch.tensor([n], device=dev), d,
        c["max_mel_len"], prec)
    wav = RS.melgan(voc, post[:, :tb], prec)[0].cpu().numpy()
    frames = max(1, int(out_lens[0]))
    return logd[0, :n].double().cpu().numpy(), wav[:RS.HOP * frames]


def _duration_gap(logd, durations):
    """How far, in frames, a duration lies outside the interval of
    predictions that round to it (0 inside)."""
    x = np.expm1(logd)
    d = durations.astype(np.float64)
    lo = np.where(d == 0, -np.inf, d - 0.5)
    return float(np.maximum(np.maximum(lo - x, x - (d + 0.5)), 0.0).max())


def _wave_gap(got, ref):
    """The RMS error, in full-scale units, of the int16 waveform `got`
    against the reference's float waveform trimmed as the reference's
    PCM16 trims; None where the trimmed lengths differ. (Full scale and
    not the waveform's own level: with random weights the generator's
    level varies tenfold from seed to seed, its rounding error far less.)"""
    s, e = RS.trim_bounds(RS.pcm16(ref))
    want = ref[s:e].astype(np.float64)
    got = got.astype(np.float64) / 32767.0
    if len(got) != len(want):
        return None
    return math.sqrt(np.mean((got - want) ** 2))


def _readings(state, got, detail=None):
    """Over the sample, against the float32 reference teacher-forced on
    the served durations: dur_gap, the worst distance (frames) of a side's
    duration outside the interval that rounds to it from the reference's
    prediction; wav_rms_err, the worst RMS error of its waveform (full
    scale); trim_mismatch, the waveforms whose trimmed length differs.
    got(i, row, (log-durations, waveform) of the reference) -> (the
    side's durations, its int16 waveform)."""
    c, t = state["cell"].config, state["cell"].traffic
    nar, nar_state, voc = weights(c, t, state["seed"], state["device"])
    dur_gap, wav_err, mismatch = 0.0, 0.0, 0
    with RM.full_float32(), torch.no_grad():
        for i, row in sample(state, t["check_utterances"]):
            ref = _reference(state, i, row, nar, nar_state, voc, "f32")
            durations, wav = got(i, row, ref)
            d_gap, w_gap = _duration_gap(ref[0], durations), _wave_gap(wav, ref[1])
            if detail is not None:
                detail.setdefault("utterances", []).append([d_gap, w_gap])
            dur_gap = max(dur_gap, d_gap)
            if w_gap is None:
                mismatch += 1
            else:
                wav_err = max(wav_err, w_gap)
    return {"dur_gap": dur_gap, "wav_rms_err": wav_err,
            "trim_mismatch": mismatch}
