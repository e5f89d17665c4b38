"""CBHG vocoder training and inference of the port, mirroring
`unast_tpu/infer/vocoder.py`: the sum-reduced L1/L2 regression of
mel -> magnitude, the optimizer of the trainer's flags (train/optim.py), a
seeded train/valid split, checkpoints, and make_mags over predicted-mel
dumps.

As in JAX, batches are padded to a fixed frame count and the loss is the
UNMASKED sum over the padded batch (the reference's sum loss then covers
more zero padding; the relative training signal is unchanged). A
checkpoint is one `torch.save` file of the params and BN state as plain
dicts and lists, loaded with `weights_only=True` onto a template that
vocoder_init builds at the file's widths (JAX pickles the numpy trees).

    python -m unast_tpu_torch.infer.vocoder --config configs/vocoder.json \\
        [--synthetic] [--vocoder_ckpt vocoder.ckpt] [--device cpu]
    python -m unast_tpu_torch.infer.vocoder --infer --vocoder_ckpt v.ckpt \\
        --out_test_dir test_out      # test_out/mels/<f>.pt.npy -> <f>.mag.npy
"""

import os
from typing import Optional

import numpy as np
import torch

from .. import nn
from ..data.batching import BatchIterator
from ..device import resolve_device
from ..models import unast as U
from ..models.config import ModelConfig
from ..train.checkpoint import _plain, _restore
from ..train.optim import apply_updates, make_optimizer, tree_leaves, tree_unflatten
from ..train.steps import seeded_generator


def vocoder_loss(params, vstate, ctx, mel, mag, loss_type: str):
    """unast_tpu/infer/vocoder.py::vocoder_loss: the sum over the whole
    padded batch of |pred - mag| ('l1') or its square, in float32.
    Returns (loss, new_state)."""
    pred, new_state = U.vocoder(params, vstate, ctx, mel)
    diff = pred.float() - mag.float()
    loss = diff.abs().sum() if loss_type == "l1" else (diff * diff).sum()
    return loss, new_state


def make_vocoder_step(args, tx):
    """unast_tpu/infer/vocoder.py::make_vocoder_step: step(params, vstate,
    opt_state, generator, mel, mag) -> (params, new_state, opt_state,
    loss), one update of `tx` (train/optim.py) on the loss's gradient, in
    train mode (batch BN statistics)."""
    loss_type = getattr(args, "loss_type", "l1")

    def step(params, vstate, opt_state, gen, mel, mag):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        loss, new_state = vocoder_loss(live, vstate, nn.Ctx(generator=gen, train=True),
                                       mel, mag, loss_type)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), new_state, opt_state, loss.detach()

    return step


class _Subset:
    def __init__(self, ds, idx):
        self.ds, self.idx = ds, idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[int(self.idx[i])]


def train_vocoder(args, dataset, epochs: Optional[int] = None, device=None):
    """unast_tpu/infer/vocoder.py::train_vocoder: dataset items carry 'mel'
    and 'mag'. The valid split (valid_size, else a tenth) is cut from a
    numpy permutation seeded by args.seed, as in JAX; step i's draws come
    from seeded_generator(seed + 5, i). Weights from a torch generator
    seeded by args.seed. Returns (params, vstate, per-epoch mean
    losses)."""
    dev = resolve_device(device)
    cfg = ModelConfig(hidden=getattr(args, "hidden_size", 256),
                      num_mels=args.num_mels)
    n_fft = getattr(args, "n_fft", 2048)
    params, vstate = nn.tree_to(U.vocoder_init(
        torch.Generator().manual_seed(args.seed), cfg, n_fft), dev)
    tx = make_optimizer(args)
    opt_state = tx.init(params)
    step = make_vocoder_step(args, tx)

    valid_size = min(getattr(args, "valid_size", 0) or max(1, len(dataset) // 10),
                     max(0, len(dataset) - 1))
    indices = np.random.default_rng(args.seed).permutation(len(dataset))
    train_idx = indices[:len(indices) - valid_size]
    assert len(train_idx) > 0, "vocoder training needs at least one item"
    it = BatchIterator(_Subset(dataset, train_idx), args.train_batch_size,
                       text_len=8, mel_len=args.data_mel_len, seed=args.seed,
                       include_mag=True, n_mels=args.num_mels)
    steps_per_epoch = max(1, len(train_idx) // args.train_batch_size)
    epoch_losses = []
    for epoch in range(epochs or args.epochs):
        losses = []
        for s in range(steps_per_epoch):
            b = it.next_batch()
            params, vstate, opt_state, loss = step(
                params, vstate, opt_state,
                seeded_generator(args.seed + 5, epoch * steps_per_epoch + s, dev),
                torch.from_numpy(b["mel"]).to(dev), torch.from_numpy(b["mag"]).to(dev))
            losses.append(float(loss))
        epoch_losses.append(float(np.mean(losses)))
    return params, vstate, epoch_losses


def _vocode_batch(params, vstate, mel):
    """unast_tpu/infer/vocoder.py::_vocode_batch: mel [B, T, M] -> mag in
    eval mode."""
    with torch.inference_mode():
        return U.vocoder(params, vstate, nn.Ctx.eval(), mel)[0]


def save_vocoder_ckpt(params, vstate, path: str):
    """unast_tpu/infer/vocoder.py::save_vocoder_ckpt: one torch.save file of
    the params and BN state, written to a temporary name and renamed."""
    tmp = path + ".tmp"
    torch.save({"params": _plain(params), "vstate": _plain(vstate)}, tmp)
    os.replace(tmp, path)


def load_vocoder_ckpt(path: str, device=None):
    """unast_tpu/infer/vocoder.py::load_vocoder_ckpt: (params, vstate) on
    `device` (None = cuda), rebuilt on the tree of vocoder_init at the
    file's widths (hidden, num_mels and n_fft from its pre and post
    convs); a file whose tree differs from that template is refused."""
    dev = resolve_device(device)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    _, num_mels, hidden = saved["params"]["pre"]["w"].shape
    n_fft = 2 * (saved["params"]["post"]["w"].shape[2] - 1)
    template = nn.tree_to(U.vocoder_init(
        torch.Generator().manual_seed(0),
        ModelConfig(hidden=hidden, num_mels=num_mels), n_fft), dev)
    return _restore(template, [saved["params"], saved["vstate"]], "vocoder")


def make_mags(params, vstate, mels_dir: str, fnames, out_dir: Optional[str] = None,
              batch_size: int = 8, mel_len: int = 816):
    """unast_tpu/infer/vocoder.py::make_mags: predicted-mel dumps
    (<f>.pt.npy, else <f>.pt) -> <f>.mag.npy per utterance, cut to its
    frames, on the params' device."""
    out_dir = out_dir or mels_dir
    os.makedirs(out_dir, exist_ok=True)
    dev = tree_leaves(params)[0].device
    for i in range(0, len(fnames), batch_size):
        chunk = fnames[i:i + batch_size]
        mels, lens = [], []
        for f in chunk:
            src = os.path.join(mels_dir, f + ".pt.npy")
            m = np.load(src if os.path.exists(src) else os.path.join(mels_dir, f + ".pt"))
            lens.append(min(len(m), mel_len))
            pad = np.zeros((mel_len, m.shape[1]), np.float32)
            pad[:lens[-1]] = m[:mel_len]
            mels.append(pad)
        mags = _vocode_batch(params, vstate,
                             torch.from_numpy(np.stack(mels)).to(dev))
        mags = mags.float().cpu().numpy()
        for f, mag, ln in zip(chunk, mags, lens):
            np.save(os.path.join(out_dir, f + ".mag.npy"), mag[:ln])


def main(argv=None):
    """unast_tpu/infer/vocoder.py::main: train the vocoder (default) or
    write .mag.npy files with --infer, on --device (default cuda)."""
    import argparse
    from ..data.dataset import LJSpeechDataset, SyntheticSpeechDataset
    from ..train.config import parse_with_config

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--infer", action="store_true")
    ap.add_argument("--vocoder_ckpt", default="vocoder.ckpt")
    known, rest = ap.parse_known_args(argv)
    args = parse_with_config(rest)
    if not hasattr(args, "hidden_size"):
        args.hidden_size = args.hidden
    if not hasattr(args, "n_fft"):
        args.n_fft = 2048

    if known.infer:
        params, vstate = load_vocoder_ckpt(known.vocoder_ckpt, args.device)
        mels_dir = os.path.join(args.out_test_dir, "mels")
        # eval dumps are np.save(fname + '.pt'), which writes '<f>.pt.npy'
        fnames = sorted(f[:-len(".pt.npy")] for f in os.listdir(mels_dir)
                        if f.endswith(".pt.npy") and not f.endswith(".mag.npy"))
        make_mags(params, vstate, mels_dir, fnames, mel_len=args.data_mel_len)
        print(f"wrote {len(fnames)} .mag.npy files to {mels_dir}")
        return

    if args.synthetic:
        ds = SyntheticSpeechDataset(size=args.synthetic_size, seed=args.seed)
    else:
        splits_dir = args.splits_dir or os.path.join(args.data_path, "splits")
        ds = LJSpeechDataset(os.path.join(splits_dir, "full_train.csv"),
                             os.path.join(args.data_path, "mel_cache"),
                             include_mag=True)
    params, vstate, losses = train_vocoder(args, ds, device=args.device)
    save_vocoder_ckpt(params, vstate, known.vocoder_ckpt)
    print(f"final vocoder loss: {losses[-1]:.2f} -> {known.vocoder_ckpt}")


if __name__ == "__main__":
    main()
