"""CTC ASR trainer of the port (models/ctc.py), mirroring
`unast_tpu/train/ctc.py`: supervised one-pass speech -> text, the speech
encoder and the CTC head trained with ctc_loss on gold transcripts, on the
port's optimizers (train/optim.py).

CLI: python -m unast_tpu_torch.train.ctc [--ctc_steps N] [--synthetic ...]
     [--data_path <prepared corpus>] [--device cpu]
Gate: chip_smoke.py phase 14 runs scripts/ctc_check.py's setting on the
port (greedy PER < 0.05 on the synthetic corpus of 4).

Each step's draws come from a generator seeded from (1, step)
(steps.seeded_generator), the counterpart of JAX's fold_in(PRNGKey(1),
step); its bits differ from JAX's, so parity holds with every dropout at 0.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import nn
from ..device import resolve_device
from ..models import ctc as C
from ..models.config import ModelConfig
from .optim import (apply_updates, global_norm, make_optimizer, make_schedule,
                    tree_leaves, tree_map, tree_unflatten)


class CtcTrainState(NamedTuple):
    """unast_tpu/train/ctc.py::CtcTrainState."""
    params: Any
    net_state: Any
    opt: Any
    step: int


def init_ctc_state(gen: torch.Generator, cfg: ModelConfig, args,
                   device=None) -> CtcTrainState:
    """unast_tpu/train/ctc.py::init_ctc_state: ctc_asr_init's weights from
    `gen` (a CPU generator) on `device` (None = cuda) and the optimizer's
    state."""
    dev = resolve_device(device)
    params, net_state = C.ctc_asr_init(gen, cfg)
    params, net_state = nn.tree_to(params, dev), nn.tree_to(net_state, dev)
    tx = make_optimizer(args, make_schedule(args))
    return CtcTrainState(params, net_state, tx.init(params), 0)


def make_ctc_step(cfg: ModelConfig, args):
    """unast_tpu/train/ctc.py::make_ctc_step: step(ts, gen, batch) -> (new
    ts, metrics {'ctc/loss', 'grad_norm'}); batch holds 'text', 'text_len',
    'mel', 'mel_len' tensors on the params' device, gen a torch.Generator
    there (train-mode draws)."""
    tx = make_optimizer(args, make_schedule(args))

    def step(ts: CtcTrainState, gen: torch.Generator, batch):
        live = tree_map(lambda x: x.detach().requires_grad_(True), ts.params)
        ctx = nn.Ctx(generator=gen, train=True)
        logits, pad, ns = C.ctc_logits(live, ts.net_state, ctx, cfg,
                                       batch["mel"], batch["mel_len"])
        loss = C.ctc_loss(logits, pad, batch["text"], batch["text_len"])
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = tree_unflatten(live, [
                torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, grads)])
            updates, opt = tx.update(grads, ts.opt, ts.params)
            params = apply_updates(ts.params, updates)
            metrics = {"ctc/loss": loss.detach(), "grad_norm": global_norm(grads)}
        return CtcTrainState(params, ns, opt, ts.step + 1), metrics

    return step


def eval_per(ts: CtcTrainState, cfg: ModelConfig, batch) -> float:
    """unast_tpu/train/ctc.py::eval_per: the greedy-CTC phoneme error rate
    of a numpy batch against its gold transcripts."""
    from ..infer.metrics import compute_per
    dev = tree_leaves(ts.params)[0].device
    with torch.inference_mode():
        (ids, lens), _ = C.ctc_asr_infer(
            ts.params, ts.net_state, nn.Ctx.eval(), cfg,
            torch.from_numpy(np.asarray(batch["mel"])).to(dev),
            torch.from_numpy(np.asarray(batch["mel_len"], np.int64)).to(dev))
    return compute_per(batch["text"], ids.cpu().numpy(), batch["text_len"],
                       lens.cpu().numpy())


def batch_to(raw, device, keys=("text", "text_len", "mel", "mel_len")):
    """The step's tensors of a numpy batch (`keys`: mel and f0 float32, the
    rest int64), on `device`."""
    return {k: torch.from_numpy(np.asarray(
        raw[k], np.float32 if k in ("mel", "f0") else np.int64)).to(device)
        for k in keys}


def load_ctc_pv(ckpt_path: str, cfg: ModelConfig, args, device=None):
    """(params, net_state) of a checkpoint that main() saved (a torch.save
    file, train/checkpoint.py), on `device` (None = cuda): what
    infer/serve.py's Synthesizer(ctc_pv=) takes."""
    from .checkpoint import load_ckp
    template = init_ctc_state(torch.Generator().manual_seed(0), cfg, args,
                              device)
    _, _, ts, _ = load_ckp(ckpt_path, template)
    return ts.params, ts.net_state


def main(argv=None):
    """unast_tpu/train/ctc.py::main: train ctc_steps steps (default 2000)
    on the synthetic corpus, or with --data_path on the labeled_train split
    of a prepared corpus (its mel_cache, data/prepare.py), then print the
    greedy PER of one eval batch and save the state to checkpoint_path.
    Runs on --device (default cuda). Returns (ts, per)."""
    import os

    from ..data.batching import BatchIterator
    from ..data.dataset import LJSpeechDataset, SyntheticSpeechDataset
    from .checkpoint import save_ckp
    from .config import model_config_from_args, parse_with_config
    from .steps import seeded_generator

    args = parse_with_config(argv)
    cfg = model_config_from_args(args)
    dev = resolve_device(getattr(args, "device", None))
    n_steps = int(getattr(args, "ctc_steps", 0) or 2000)
    if getattr(args, "synthetic", False) or not os.path.isdir(args.data_path):
        ds = SyntheticSpeechDataset(size=int(args.synthetic_size), seed=0)
    else:
        from ..data.splits import REFERENCE_SPLITS_DIR
        local = os.path.join(args.data_path, "splits")
        splits = (local if os.path.isdir(local) else REFERENCE_SPLITS_DIR)
        ds = LJSpeechDataset(
            os.path.join(splits, "labeled_train.csv"),
            os.path.join(args.data_path, "mel_cache"))
    it = BatchIterator(ds, args.train_batch_size, args.data_text_len,
                       args.data_mel_len, seed=args.seed + 1)
    ts = init_ctc_state(torch.Generator().manual_seed(0), cfg, args, dev)
    step = make_ctc_step(cfg, args)
    for i in range(n_steps):
        ts, m = step(ts, seeded_generator(1, i, dev),
                     batch_to(it.next_batch(), dev))
        if (i + 1) % 100 == 0:
            print(f"step {i + 1}: loss {float(m['ctc/loss']):.4f}")
    eval_it = BatchIterator(ds, args.eval_batch_size, args.data_text_len,
                            args.data_mel_len, seed=9)
    per = eval_per(ts, cfg, eval_it.next_batch())
    print(f"greedy CTC PER: {per:.4f}")
    if args.checkpoint_path:
        save_ckp(0, per, ts, True, args.checkpoint_path)
    return ts, per


if __name__ == "__main__":
    main()
