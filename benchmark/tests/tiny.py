"""A throwaway benchmark root with tiny cells, made only of new files: a
copy of benchmark/ plus tiny configurations, traffic mixes and limits and
a BENCHMARK.json that names them.

The tiny cells' limits are set as the real cells' are, from readings at
the tiny sizes on the CPU (the port's over seeds 1, 2 and the tests'
seeds; the fp8 control's over seeds 1, 2, 3, 77 and 2**36 + 5): the port
reads loss_rel <= 1.5e-4, grad1_rel <= 1.6e-3, delta_rel <= 1.1e-3,
delta_p90 <= 8.5e-3, delta_worst <= 0.06, wav_rms_err <= 7e-4 there; the
control grad1_rel >= 9.5e-3, delta_rel >= 6e-3, delta_p90 >= 2.2e-2,
wav_rms_err >= 6e-3; a state left unchanged reads delta_worst 1."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")

TINY_WIDTHS = dict(hidden=32, e_in=32, t_emb_dim=32, s_pre_hid=32, ffn_dim=64,
                   num_layers=2, nhead=2, max_mel_len=24, max_text_len=16,
                   data_mel_len=24, data_text_len=16, train_batch_size=4)
TINY_LIMITS = {"sp": {"loss_rel": 6e-4, "grad1_rel": 5e-3, "delta_rel": 3e-3,
                      "delta_p90": 1.5e-2, "delta_worst": 0.3},
               "tts": {"dur_gap": 0.1, "wav_rms_err": 2.5e-3,
                       "trim_mismatch": 0}}


# the serving cell's metrics, as its manifest entries read (the real
# manifest holds no serving cell: its runs spread too widely to bound)
SERVE_METRICS = {
    "end_to_end": [
        {"name": "serve_utt_per_s", "unit": "utt/s", "better": "higher",
         "bound": 0.25, "source": "host_clock"},
        {"name": "serve_batch_p95_s", "unit": "s", "better": "lower",
         "bound": 0.25, "source": "host_clock"}],
    "per_layer": [
        {"name": "batch_mfu.serve", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "synthesizer one pass",
         "moves": "serve_utt_per_s"},
        {"name": "flash_fwd_roofline.serve", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "flash forward",
         "moves": "serve_utt_per_s"},
        {"name": "device_idle_share.serve", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "serve_utt_per_s"}]}


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f)


def make_root(tmp, compute_dtype="bfloat16"):
    """The root at `tmp`, with cells 'tiny.sp' (the flagship's step),
    'tiny_remat.sp' (remat and the transformer schedule, as a wider
    configuration has them) and 'tiny.tts' (one-pass TTS)."""
    shutil.copytree(BENCH, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(tmp, "benchmark")
    c = dict(_load(BENCH, "configs", "flagship_d256.json"), **TINY_WIDTHS,
             compute_dtype=compute_dtype)
    _dump(c, b, "configs", "tiny.json")
    _dump(dict(c, remat=True, remat_policy="dots_all", sched_type="transformer",
               warmup_steps=4), b, "configs", "tiny_remat.json")
    t = dict(_load(BENCH, "traffic", "sp_warmup.json"), batch=4, mel_pad=24,
             text_pad=16, seconds=[0.1, 0.28, 0.2], tokens=[4, 14],
             pool_steps=3, trace_steps=1)
    _dump(t, b, "traffic", "tiny_sp.json")
    s = dict(_load(BENCH, "traffic", "nar_melgan_serve.json"), batch=4,
             chars=[3, 14, 8], pool_batches=3, text_buckets=[8, 16],
             mel_buckets=[16, 24], frames_per_phoneme=1.2, melgan_base=32,
             check_utterances=4, trace_batches=1)
    _dump(s, b, "traffic", "tiny_tts.json")
    real = _load(ROOT, "BENCHMARK.json")
    sp, tts = ["tiny.sp", "tiny_remat.sp"], ["tiny.tts"]
    workloads = {"train_frames_per_s": sp, "serve_utt_per_s": tts,
                 "serve_batch_p95_s": tts}
    per_layer = [dict(m, workloads=sp if m["name"].endswith(".train") else tts)
                 for m in real["per_layer"] + SERVE_METRICS["per_layer"]]
    man = dict(real,
               configs=[{"name": "tiny", "file": "benchmark/configs/tiny.json"},
                        {"name": "tiny_remat",
                         "file": "benchmark/configs/tiny_remat.json"}],
               workloads=[{"name": "tiny.sp", "config": "tiny",
                           "traffic": "tiny_sp", "chips": 1},
                          {"name": "tiny_remat.sp", "config": "tiny_remat",
                           "traffic": "tiny_sp", "chips": 1},
                          {"name": "tiny.tts", "config": "tiny",
                           "traffic": "tiny_tts", "chips": 1}],
               end_to_end=[dict(m, workloads=workloads[m["name"]])
                           if m["name"] in workloads else m
                           for m in real["end_to_end"]
                           + SERVE_METRICS["end_to_end"]],
               per_layer=per_layer)
    _dump(man, tmp, "BENCHMARK.json")
    for name in sp:
        _dump(TINY_LIMITS["sp"], b, "limits", name + ".json")
    _dump(TINY_LIMITS["tts"], b, "limits", "tiny.tts.json")
    return tmp
