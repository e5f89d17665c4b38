"""Observability of the port, mirroring `unast_tpu/train/observe.py`:
metrics to JSONL always and to TensorBoard when `torch.utils.tensorboard`
imports (else a note on stderr, as in JAX), the console epoch summary, the
NaN sentinel, and torch.profiler traces behind a flag (JAX's hook is
jax.profiler). Parity targets: the reference's TensorBoard scalars and
examples (src/train.py:641-764) and check_nan_loss (src/train.py:166-196).
"""

import contextlib
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np


class MetricsWriter:
    """unast_tpu/train/observe.py::MetricsWriter: scalars to JSONL always;
    to TensorBoard when a log dir is given and torch's SummaryWriter is
    importable."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 tb_log_path: Optional[str] = None):
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._tb = None
        if tb_log_path:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=tb_log_path, flush_secs=60)
            except Exception as e:  # pragma: no cover
                print(f"[observe] tensorboard unavailable: {e}", file=sys.stderr)

    def scalars(self, step: int, values: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[prefix + k] = float(v)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(prefix + k, float(v), step)

    def text(self, step: int, tag: str, s: str):
        if self._tb:
            self._tb.add_text(tag, s, step)

    def image(self, step: int, tag: str, img_hw: np.ndarray):
        """2-D array as an HW image (mel/mag spectrograms)."""
        if self._tb:
            self._tb.add_image(tag, img_hw, step, dataformats="HW")

    def figure(self, step: int, tag: str, fig):
        if self._tb:
            self._tb.add_figure(tag, fig, step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


def log_loss_metrics(losses: Dict[str, list], epoch: int, eval_: bool = False):
    """unast_tpu/train/observe.py::log_loss_metrics: the console epoch
    summary (src/train.py:756-764)."""
    kind = "Eval_" if eval_ else "Train"
    parts = [f"{kind} epoch {epoch:-3d}"]
    for k in sorted(losses):
        parts.append(f"{k} loss = {np.mean(losses[k]):0.3f}")
    print(" \t".join(parts))


def check_nan(metrics: Dict[str, float], step: int, dump_dir: str = "."):
    """unast_tpu/train/observe.py::check_nan, the NaN sentinel
    (src/train.py:166-196): on any non-finite metric, dump
    the metric dict and exit."""
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
    if bad:
        path = os.path.join(dump_dir, f"nan_dump_step{step}.json")
        with open(path, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)
        print(f"Discovered NaN loss at step {step}: {sorted(bad)} "
              f"(dump: {path})", file=sys.stderr)
        sys.exit(1)


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]):
    """unast_tpu/train/observe.py::maybe_profile on torch.profiler: trace
    the block's CPU and CUDA activity into a Chrome trace under
    profile_dir; nothing without a profile_dir."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    import torch
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_{int(time.time())}.json"))


def log_example(writer: MetricsWriter, params, net_state, cfg, ex,
                step: int, name: str = "train"):
    """unast_tpu/train/observe.py::log_example: greedy ASR text and TTS mel
    images of one dataset item, on the params' device (log_tb_example,
    src/train.py:699-727)."""
    import torch
    from .. import nn
    from ..models import unast as U
    from ..text import sequence_to_text
    from .optim import tree_leaves

    dev = tree_leaves(params)[0].device
    mel = torch.as_tensor(np.asarray(ex["mel"]), device=dev)[None]
    ids = torch.as_tensor(np.asarray(ex["ids"]), dtype=torch.long, device=dev)[None]
    t_len = torch.tensor([ids.shape[1]], device=dev)
    m_len = torch.tensor([mel.shape[1]], device=dev)
    ectx = nn.Ctx.eval()
    with torch.no_grad():
        (text_pred, text_pred_len), _ = U.asr(params, net_state, ectx, cfg,
                                              mel=mel, mel_len=m_len, infer=True)
        (_, post, _, stop_lens), _ = U.tts(params, net_state, ectx, cfg,
                                           ids, t_len, infer=True)
    tp = text_pred[0][: int(text_pred_len[0])].cpu().numpy()
    writer.text(step, f"{name}/text_gold",
                sequence_to_text(ids[0].cpu().numpy().tolist()))
    writer.text(step, f"{name}/text_pred", sequence_to_text(tp.tolist()))
    writer.image(step, f"{name}/speech_gold",
                 np.flip(mel[0].float().cpu().numpy().T, axis=0))
    writer.image(step, f"{name}/speech_pred",
                 np.flip(post[0][: int(stop_lens[0])].float().cpu().numpy().T,
                         axis=0))


def log_discrim_out(writer: MetricsWriter, d_out, d_target, step: int,
                    name: str = "train"):
    """unast_tpu/train/observe.py::log_discrim_out: the discriminator's
    prediction/target bar chart — parity with
    log_tb_discrim_out (src/train.py:730-754). No-op without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    pred = 1.0 / (1.0 + np.exp(-np.asarray(d_out, np.float64)))
    gold = np.asarray(d_target, np.float64)
    batch = pred.shape[0]
    fig, ax = plt.subplots(figsize=(max(2, batch // 2), 3))
    ind = np.arange(batch)
    ax.bar(ind, pred, 0.2, label="pred")
    ax.bar(ind + 0.2, gold, 0.2, label="gold")
    ax.set_xticks(ind + 0.1)
    ax.legend()
    fig.tight_layout()
    writer.figure(step, f"{name}/discrim_output", fig)
    plt.close(fig)


def set_seed(seed: int):
    """unast_tpu/train/observe.py::set_seed: seed numpy, Python's random and
    torch's default generators (src/utils.py:85-98). The port's own draws
    come from explicit torch.Generators."""
    import random
    import torch
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def compare_outputs(ground_truth, hypothesis, gt_len, hyp_len):
    """unast_tpu/train/observe.py::compare_outputs: console print of decoded
    vs gold text (src/utils.py:36-38)."""
    from ..text import sequence_to_text
    print(f"Model prediction of length {hyp_len} ",
          sequence_to_text(list(np.asarray(hypothesis)[:hyp_len])))
    print(f"Ground Truth of length {gt_len} ",
          sequence_to_text(list(np.asarray(ground_truth)[:gt_len])))


class TeacherRatio:
    """unast_tpu/train/observe.py::TeacherRatio: exponential
    teacher-forcing decay (src/utils.py:116-136). Dormant in the reference
    (teacher.step() commented out, every call passes ratio=1 — SURVEY.md
    #51) but kept for capability parity."""

    def __init__(self, args):
        self.iter = 0
        self.val = args.teacher_init_val
        self.gamma = args.teacher_gamma
        self.start_step = args.teacher_decay_start
        self.stop_step = args.teacher_decay_end

    def step(self):
        self.iter += 1

    def get_val(self) -> float:
        if self.start_step <= self.iter:
            power = min(self.iter, self.stop_step) - self.start_step
            return self.val * (self.gamma ** power)
        return self.val
