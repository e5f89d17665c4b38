"""FastSpeech NAR TTS trainer of the port, mirroring
`unast_tpu/train/fastspeech.py`: duration distillation from an AR
teacher. The student (models/fastspeech.py) regresses the gold mels
(pre + post masked MSE) with the length regulator driven by the teacher's
durations, and log(1 + duration) (with nar_pitch / nar_energy also the
token log-F0 and energy) on its eval-mode branch (predict_variances).

Durations come from precomputed `batch['durs']`, or from
--nar_dur_source: 'uniform' (an even split of the gold frames), 'ctc'
(forced alignment over the teacher's hybrid CTC head), 'mas' (monotonic
alignment search over the teacher's cross-attention), 'soft' or 'argmax'
(FastSpeech 1's counts); --nar_soft_durations is the alias of 'soft'. The
teacher's pass runs without gradients.

CLI (teacher checkpoint -> student checkpoint):
    python -m unast_tpu_torch.train.fastspeech --load_path <ar_ckpt> \
        --checkpoint_path <out_dir> [--nar_steps N] [--device cpu]

Step i draws from a generator seeded from (2, i) (steps.seeded_generator),
the counterpart of JAX's fold_in(PRNGKey(2), i); its bits differ from
JAX's, so parity holds with every dropout at 0.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import nn
from ..device import resolve_device
from ..models import ctc as CT
from ..models import fastspeech as F
from ..models import networks as N
from ..models import unast as U
from ..models.config import ModelConfig
from ..models.modules import lens_to_mask
from ..parallel import collectives as PC
from . import losses as L
from .ctc import batch_to
from .optim import (apply_updates, global_norm, make_optimizer, make_schedule,
                    tree_leaves, tree_map, tree_unflatten)


class FSTrainState(NamedTuple):
    """unast_tpu/train/fastspeech.py::FSTrainState."""
    params: Any
    net_state: Any
    opt: Any
    step: int


def init_fs_state(gen: torch.Generator, cfg: ModelConfig, args,
                  device=None) -> FSTrainState:
    """unast_tpu/train/fastspeech.py::init_fs_state: fastspeech_init's
    weights from `gen` (a CPU generator) on `device` (None = cuda) and the
    optimizer's state."""
    dev = resolve_device(device)
    params, net_state = F.fastspeech_init(gen, cfg)
    params, net_state = nn.tree_to(params, dev), nn.tree_to(net_state, dev)
    tx = make_optimizer(args, make_schedule(args))
    return FSTrainState(params, net_state, tx.init(params), 0)


def dur_source(args) -> str:
    """The duration source make_distill_step uses: --nar_dur_source, else
    'soft' under --nar_soft_durations, else 'argmax'."""
    return getattr(args, "nar_dur_source", None) or (
        "soft" if getattr(args, "nar_soft_durations", False) else "argmax")


def flash_calls_per_distill_step(cfg: ModelConfig, teacher_cfg: ModelConfig,
                                 args):
    """(flash-attention forwards, backwards) of one make_distill_step step
    with attn_impl='flash' on a batch without 'durs': the student's text
    encoder and frame decoder and predict_variances' encoder, all with
    gradients (3 encoder stacks), plus the no-grad teacher: for 'argmax',
    'soft' and 'mas' its text encoder and its decoder's causal
    self-attention (its cross-attention gives its weights, so it runs
    attention_core), for 'ctc' its speech encoder, for 'uniform' nothing."""
    student = 3 * cfg.num_layers if cfg.attn_impl == "flash" else 0
    teacher = 0
    if teacher_cfg.attn_impl == "flash":
        stacks = {"uniform": 0, "ctc": 1}.get(dur_source(args), 2)
        teacher = stacks * teacher_cfg.num_layers
    return student + teacher, student


def teacher_durations(source: str, t_params, t_state, teacher_cfg, args,
                      batch):
    """The step's integer durations [B, Tt] (no gradients) from
    batch['durs'] or `source`, as unast_tpu/train/fastspeech.py's step
    computes them."""
    text, text_len = batch["text"], batch["text_len"]
    mel, mel_len = batch["mel"], batch["mel_len"]
    if "durs" in batch:
        return batch["durs"].long()
    if source == "uniform":
        n_tok = text.shape[1]
        ratio = mel_len.float() / torch.clamp(text_len, min=1).float()
        k = torch.arange(n_tok + 1, dtype=torch.float32, device=text.device)
        bounds = torch.round(k[None, :] * ratio[:, None])
        dur = (bounds[:, 1:] - bounds[:, :-1]).long()
        return dur * lens_to_mask(text_len, n_tok).long()
    ectx = nn.Ctx.eval()
    if source == "ctc":
        (mem, pad), _ = N.speech_encode(
            t_params["speech_m"], t_state["speech_m"], ectx, teacher_cfg,
            mel, mel_len)
        logits = nn.linear(t_params["speech_m"]["ctc_head"], mem).float()
        return CT.ctc_forced_align(
            torch.log_softmax(logits, dim=-1), ~pad, text, text_len,
            blank_split=bool(getattr(args, "nar_ctc_blank_split", 1)))
    ws = []
    U.tts(t_params, t_state, ectx, teacher_cfg, text, text_len, mel, mel_len,
          cross_weights_out=ws)
    attn = torch.stack(ws)
    if teacher_cfg.model_type == "transformer":
        attn = PC.gather(attn, 2)   # every head, under tensor parallelism
    if source == "mas":
        return F.mas_durations(attn, mel_len, text_len)
    return F.durations_from_attention(attn, mel_len, text_len,
                                      soft=(source == "soft"))


def make_distill_step(cfg: ModelConfig, teacher_cfg: ModelConfig, args,
                      plan=None):
    """unast_tpu/train/fastspeech.py::make_distill_step: step(fs,
    teacher_params, teacher_state, gen, batch) -> (new fs, metrics
    {'nar/pre', 'nar/post', 'nar/dur'[, 'nar/pitch', 'nar/energy'],
    'grad_norm'}). batch holds 'text', 'text_len', 'mel', 'mel_len' (and
    'f0' for nar_pitch, optionally 'durs') tensors on the params' device;
    gen is a torch.Generator there (train-mode draws). plan: None, or a
    parallel/mesh.py::MeshPlan (shard_family_step makes it): then batch is
    this rank's dp rows, fs and the teacher's params its tp slices
    (plan.place_tree), and every loss normaliser, the gradient and the
    metrics are the global batch's."""
    tx = make_optimizer(args, make_schedule(args))
    dur_w = float(getattr(args, "nar_dur_weight", 1.0) or 1.0)
    source = dur_source(args)

    def step(fs: FSTrainState, t_params, t_state, gen: torch.Generator, batch):
        if plan is None:
            return run(fs, t_params, t_state, gen, batch)
        with plan.axes():
            return run(fs, t_params, t_state, gen, batch)

    def run(fs: FSTrainState, t_params, t_state, gen: torch.Generator, batch):
        text, text_len = batch["text"], batch["text_len"]
        mel, mel_len = batch["mel"], batch["mel_len"]
        with torch.no_grad():
            dur = teacher_durations(source, t_params, t_state, teacher_cfg,
                                    args, batch)
            tv = lens_to_mask(text_len, text.shape[1]).float()
            pitch_tgt = energy_tgt = None
            if cfg.nar_pitch:
                pitch_tgt = F.token_log_f0_in_graph(batch["f0"], dur, tv)
            if cfg.nar_energy:
                energy_tgt = F.token_energy_in_graph(mel, dur, tv)

        live = tree_map(lambda x: x.detach().requires_grad_(True), fs.params)
        ctx = nn.Ctx(generator=gen, train=True)
        (pre, post, _, _), ns = F.fastspeech_forward(
            live, fs.net_state, ctx, cfg, text, text_len, durations=dur,
            max_len=mel.shape[1], pitch_target=pitch_tgt,
            energy_target=energy_tgt)
        mask = lens_to_mask(mel_len, mel.shape[1])[..., None]
        l_pre = L.masked_mse(mel, pre, mask)
        l_post = L.masked_mse(mel, post, mask)
        logd, logf, ener = F.predict_variances(live, fs.net_state, cfg,
                                               text, text_len)
        d_err = (logd - torch.log1p(dur.float())) ** 2
        n_tok = torch.clamp(PC.total(tv.sum()), min=1.0)
        l_dur = (d_err * tv).sum() / n_tok
        loss = l_pre + l_post + dur_w * l_dur
        metrics = {"nar/pre": l_pre, "nar/post": l_post, "nar/dur": l_dur}
        if cfg.nar_pitch:
            voiced = (pitch_tgt > 0).float() * tv
            l_pitch = (((logf - pitch_tgt) ** 2) * voiced).sum() / torch.clamp(
                PC.total(voiced.sum()), min=1.0)
            loss = loss + dur_w * l_pitch
            metrics["nar/pitch"] = l_pitch
        if cfg.nar_energy:
            l_en = (((ener - energy_tgt) ** 2) * tv).sum() / n_tok
            loss = loss + dur_w * l_en
            metrics["nar/energy"] = l_en
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = tree_unflatten(live, [
                torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, grads)])
            metrics = {k: v.detach() for k, v in metrics.items()}
            if plan is None:
                updates, opt = tx.update(grads, fs.opt, fs.params)
                params = apply_updates(fs.params, updates)
                metrics["grad_norm"] = global_norm(grads)
            else:
                metrics = plan.reduce_metrics(metrics)
                params, opt, metrics["grad_norm"] = plan.apply(
                    tx, "opt", grads, fs.opt, fs.params)
        return FSTrainState(params, ns, opt, fs.step + 1), metrics

    return step


def make_nar_infer(cfg: ModelConfig, max_len: int, speed: float = 1.0):
    """unast_tpu/train/fastspeech.py::make_nar_infer: free-running NAR
    synthesis with the predicted durations, (params, net_state, text,
    text_len) -> (post mel, out_lens)."""

    def infer(params, net_state, text, text_len):
        with torch.inference_mode():
            (_, post, out_lens, _), _ = F.fastspeech_forward(
                params, net_state, nn.Ctx.eval(), cfg, text, text_len,
                max_len=max_len, speed=speed)
        return post, out_lens

    return infer


def eval_nar_mse(fs: FSTrainState, cfg: ModelConfig, batch,
                 speed: float = 1.0):
    """unast_tpu/train/fastspeech.py::eval_nar_mse: free-running synthesis
    of a numpy batch against its gold mels, scored over the overlap of the
    predicted and gold lengths per utterance. Returns (mse, [(pred_len,
    gold_len), ...])."""
    dev = tree_leaves(fs.params)[0].device
    infer = make_nar_infer(cfg, int(batch["mel"].shape[1]), speed)
    post, out_lens = infer(
        fs.params, fs.net_state,
        torch.from_numpy(np.asarray(batch["text"], np.int64)).to(dev),
        torch.from_numpy(np.asarray(batch["text_len"], np.int64)).to(dev))
    post = post.float().cpu().numpy()
    out_lens = out_lens.cpu().numpy()
    gold, gold_len = batch["mel"], batch["mel_len"]
    errs, lens = [], []
    for i in range(len(gold)):
        n = min(int(out_lens[i]), int(gold_len[i]))
        if n > 0:
            errs.append(float(np.mean((post[i, :n] - gold[i, :n]) ** 2)))
        lens.append((int(out_lens[i]), int(gold_len[i])))
    return float(np.mean(errs)), lens


def load_nar_pv(ckpt_path: str, cfg: ModelConfig, args, device=None):
    """(params, net_state) of a student that main() saved (a torch.save
    file, train/checkpoint.py), on `device` (None = cuda): what
    infer/serve.py's Synthesizer(nar_pv=) takes."""
    from .checkpoint import load_ckp
    template = init_fs_state(torch.Generator().manual_seed(1), cfg, args,
                             device)
    _, _, fs, _ = load_ckp(ckpt_path, template)
    return fs.params, fs.net_state


def main(argv=None):
    """unast_tpu/train/fastspeech.py::main: distil nar_steps steps (default
    2000) from the teacher at --load_path (an untrained one without it) on
    the synthetic corpus, or with --data_path on the labeled_train split of
    a prepared corpus (its mel_cache; with --nar_pitch its F0 cache), then
    print the free-running mel MSE of one eval batch and save the student
    to checkpoint_path. Runs on --device (default cuda). Returns (fs, mse)."""
    import os

    from ..data.batching import BatchIterator
    from ..data.dataset import LJSpeechDataset, SyntheticSpeechDataset
    from .checkpoint import load_ckp, save_ckp
    from .config import model_config_from_args, parse_with_config
    from .steps import init_train_state, seeded_generator

    args = parse_with_config(argv)
    cfg = model_config_from_args(args)
    dev = resolve_device(getattr(args, "device", None))
    n_steps = int(getattr(args, "nar_steps", 0) or 2000)

    t_ts = init_train_state(torch.Generator().manual_seed(0), cfg, args, dev)
    if args.load_path:
        _, _, t_ts, _ = load_ckp(args.load_path, t_ts)
    else:
        print("WARNING: no --load_path; distilling from an UNTRAINED "
              "teacher (smoke-test mode)")

    if getattr(args, "synthetic", False) or not os.path.isdir(args.data_path):
        ds = SyntheticSpeechDataset(size=64, seed=0, include_f0=cfg.nar_pitch)
    else:
        from ..data.splits import REFERENCE_SPLITS_DIR
        local = os.path.join(args.data_path, "splits")
        splits = (local if os.path.isdir(local) else REFERENCE_SPLITS_DIR)
        ds = LJSpeechDataset(
            os.path.join(splits, "labeled_train.csv"),
            os.path.join(args.data_path, "mel_cache"),
            include_f0=cfg.nar_pitch)
    it = BatchIterator(ds, args.train_batch_size, args.data_text_len,
                       args.data_mel_len, seed=args.seed + 1)

    fs = init_fs_state(torch.Generator().manual_seed(1), cfg, args, dev)
    step = make_distill_step(cfg, cfg, args)
    keys = ("text", "text_len", "mel", "mel_len") + (
        ("f0",) if cfg.nar_pitch else ())
    for i in range(n_steps):
        fs, m = step(fs, t_ts.params, t_ts.net_state,
                     seeded_generator(2, i, dev),
                     batch_to(it.next_batch(), dev, keys))
        if (i + 1) % 100 == 0:
            print(f"step {i + 1}: " + " ".join(
                f"{k} {float(v):.4f}" for k, v in sorted(m.items())))
    it = BatchIterator(ds, args.eval_batch_size, args.data_text_len,
                       args.data_mel_len, seed=9)
    mse, lens = eval_nar_mse(fs, cfg, it.next_batch())
    print(f"NAR free-running mel MSE {mse:.4f}; (pred, gold) lens: {lens}")
    if args.checkpoint_path:
        save_ckp(0, mse, fs, True, args.checkpoint_path)
    return fs, mse


if __name__ == "__main__":
    main()
