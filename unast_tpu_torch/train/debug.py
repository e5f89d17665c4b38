"""Debug single-modality trainers of the port, mirroring
`unast_tpu/train/debug.py` (the reference's train_text_auto /
train_speech_auto, src/train.py:767-854, "purely for testing purposes"):
plain denoising-autoencoder training of one modality, to check that it
converges before the joint loop.

    python -m unast_tpu_torch.train.debug --config configs/transformer_test.json \\
        --synthetic --modality text [--device cpu]
"""

import argparse

import numpy as np
import torch

from .. import nn
from ..data.batching import BatchIterator
from ..device import resolve_device
from ..infer.evaluate import batch_to
from ..models import unast as U
from . import losses as L
from .config import model_config_from_args, parse_with_config
from .loop import initialize_datasets
from .optim import (apply_updates, make_optimizer, split_params, tree_leaves,
                    tree_map, tree_unflatten)
from .steps import seeded_generator

DEBUG_SEED = 7   # offset from args.seed of the steps' draws, as in JAX


def make_single_modality_step(cfg, args, modality: str, tx):
    """unast_tpu/train/debug.py::make_single_modality_step: step(params,
    net_state, opt_state, gen, batch) -> (params, net_state, opt_state,
    loss), one train-mode generator update on the text or speech
    autoencoder's loss; the discriminator's params pass through."""
    def loss_fn(params, net_state, gen, batch):
        text, mel, text_len, mel_len = batch
        ctx = nn.Ctx(generator=gen, train=True)
        if modality == "text":
            logits, st = U.text_ae(params, net_state, ctx, cfg, text, text_len)
            return L.text_loss(text, logits, args.t_eos_weight), st
        gold_stop = L.stop_label_from_lens(mel_len, mel.shape[1])
        (pre, post, stop), st = U.speech_ae(params, net_state, ctx, cfg,
                                            mel, mel_len)
        return L.speech_loss(mel, gold_stop, pre, post, mel_len, stop,
                             args.s_eos_weight), st

    def step(params, net_state, opt_state, gen, batch):
        gen_params, disc = split_params(params)
        live = tree_map(lambda x: x.detach().requires_grad_(True), gen_params)
        loss, new_state = loss_fn(dict(live), net_state, gen, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
        grads = tree_unflatten(gen_params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(tree_leaves(gen_params), grads)])
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, gen_params)
            new_params = dict(apply_updates(gen_params, updates))
        if disc is not None:
            new_params["discriminator"] = disc
        return new_params, new_state, opt_state, loss.detach()

    return step


def train_single_modality(args, modality: str, steps: int = None):
    """unast_tpu/train/debug.py::train_single_modality: (params, net_state,
    per-step loss history) of `steps` (default epochs * epoch_steps)
    single-modality steps on the unlabeled set, on args.device."""
    device = resolve_device(args.device)
    cfg = model_config_from_args(args)
    params, net_state = U.unast_init(torch.Generator().manual_seed(args.seed), cfg)
    params, net_state = nn.tree_to(params, device), nn.tree_to(net_state, device)
    tx = make_optimizer(args)
    opt_state = tx.init(split_params(params)[0])
    step = make_single_modality_step(cfg, args, modality, tx)

    it = BatchIterator(initialize_datasets(args)["unlabeled"],
                       args.train_batch_size, text_len=args.data_text_len,
                       mel_len=args.data_mel_len, seed=args.seed,
                       n_mels=args.num_mels)
    history = []
    n = steps or args.epochs * args.epoch_steps
    for i in range(n):
        batch = batch_to(it.next_batch(), device)
        params, net_state, opt_state, loss = step(
            params, net_state, opt_state,
            seeded_generator(args.seed + DEBUG_SEED, i, device), batch)
        history.append(float(loss))
        if (i + 1) % 10 == 0:
            print(f"[{modality}_auto] step {i + 1}/{n} "
                  f"loss {np.mean(history[-10:]):.4f}")
    return params, net_state, history


def main(argv=None):
    """unast_tpu/train/debug.py's entry point: --modality text|speech and
    the trainer's flags."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--modality", default="text", choices=["text", "speech"])
    known, rest = ap.parse_known_args(argv)
    train_single_modality(parse_with_config(rest), known.modality)


if __name__ == "__main__":
    main()
