"""The training loop of the port, mirroring `unast_tpu/train/loop.py` (the
reference's train(), src/train.py:567-696): an optional supervised-only
warm start, then per epoch epoch_steps joint steps (the accumulated
ae/cm/sp generator update and the discriminator update), a temporary
checkpoint, evaluation, the best/most-recent checkpoint and the periodic
one.

    python -m unast_tpu_torch.train.loop --config configs/transformer_test.json \\
        --synthetic --epochs 1 --device cpu

Runs on the card unless --device names another device. The mesh:

    torchrun --nproc_per_node N -m unast_tpu_torch.train.loop --dp D \
        [--tp T] [--ep E] [--sp S] [--zero 1|3]   # N = D * T * E * S

runs one rank per device (cuda:LOCAL_RANK under NCCL; gloo with --device
cpu) through parallel/mesh.py's sharded step, laid out over (dp, tp[, ep]
[, sp]) as the JAX loop's mesh (which has no pp axis: --pp runs the GPipe
schedule in each process, beside any of the other axes; --sp takes MoE,
remat and the RNN backbone too). The long-sequence config at sp = 2 on
one node of two cards:

    torchrun --nproc_per_node 2 -m unast_tpu_torch.train.loop \
        --config configs/wide_d1024.json --sp 2

The ranks of one dp coordinate read the same
strided shard of the corpus (1/D of it) with train_batch_size / D rows a
micro-batch; each keeps its tp / ep slices of the state, and an sp rank
runs the model on its 1/S of every sequence's frames. Only rank 0 writes
metrics and checkpoints, and a checkpoint holds the whole state whatever
the splits and the ZeRO level (a resumed run places it again).
Randomness: step `i` draws from a generator seeded from (seed + 17, i),
warm-start step `s` from (seed + 29, s) and eval batch `b` from (0, b), the
counterparts of the JAX loop's fold_in keys; under dp, dp coordinate r of D
seeds from (seed + 17, i * D + r) and (seed + 29, s * D + r) instead, so no
two dp ranks draw the same dropout masks, while the tp, ep and sp ranks of one
dp coordinate share its stream (a replicated activation draws the same
mask on each); the weights come from a CPU generator seeded with `seed`. A
resumed run (load_path or auto_resume) also advances the data streams past
the batches the saved epochs consumed, so it trains on what an unbroken
run would have (the JAX loop restarts its streams).
"""

import copy
import os
import queue
import threading
import time

import numpy as np
import torch

from ..data.batching import BatchGetter, BatchIterator
from ..data.dataset import LJSpeechDataset, SyntheticSpeechDataset
from ..device import resolve_device
from ..infer.evaluate import batch_to, evaluate
from ..parallel import multihost as MH
from .checkpoint import load_ckp, save_ckp, wait_for_saves
from .config import apply_runtime_flags, model_config_from_args, parse_with_config
from .observe import MetricsWriter, check_nan, log_loss_metrics, maybe_profile
from .optim import tree_leaves
from .steps import (ema_params, init_train_state, make_train_step,
                    seeded_generator)

STEP_SEED, WARMUP_SEED = 17, 29   # offsets from args.seed, as in JAX


def initialize_datasets(args):
    """unast_tpu/train/loop.py::initialize_datasets: labeled / unlabeled /
    val / full / test (src/train.py:961-975)."""
    if args.synthetic:
        size = args.synthetic_size
        mk = lambda seed, n: SyntheticSpeechDataset(size=n, seed=seed)
        return {
            "labeled": mk(1, max(2, size // 8)),
            "unlabeled": mk(2, size),
            "val": mk(3, max(2, size // 8)),
            "full": mk(4, size),
            "test": mk(5, max(2, size // 8)),
        }
    # the reference's exact split CSVs unless the user staged their own
    # under <data_path>/splits or passed --splits_dir
    from ..data.splits import REFERENCE_SPLITS_DIR
    local = os.path.join(args.data_path, "splits")
    splits_dir = args.splits_dir or (
        local if os.path.isdir(local) else REFERENCE_SPLITS_DIR)
    cache_dir = os.path.join(args.data_path, "mel_cache")
    ds = lambda name: LJSpeechDataset(
        os.path.join(splits_dir, name + ".csv"), cache_dir)
    return {"labeled": ds("labeled_train"), "unlabeled": ds("unlabeled_train"),
            "val": ds("val"), "full": ds("full_train"), "test": ds("test")}


def _fit_eval_bs(n: int, requested: int) -> int:
    """unast_tpu/train/loop.py::_fit_eval_bs: the largest batch size <=
    requested that divides the set, so evaluation covers every utterance."""
    bs = max(1, min(requested, n))
    while n % bs != 0:
        bs -= 1
    return bs


def _val_batches(args, val_ds):
    """unast_tpu/train/loop.py::_val_batches: fixed-shape eval batches
    covering the whole validation set."""
    bs = _fit_eval_bs(len(val_ds), args.eval_batch_size)
    if bs != args.eval_batch_size:
        print(f"[eval] batch size {args.eval_batch_size} -> {bs} "
              f"(divides {len(val_ds)})")
    it = BatchIterator(val_ds, batch_size=bs,
                       text_len=args.data_text_len, mel_len=args.data_mel_len,
                       seed=args.seed, n_mels=args.num_mels)
    n = len(val_ds) // bs
    it._reshuffle()
    return [it.next_batch() for _ in range(n)]


def _to_device(batches, device):
    """step_batches' numpy micro-batches as tensors on `device` (ids and
    lengths int64)."""
    return {k: batch_to(dict(zip(("text", "mel", "text_len", "mel_len"), v)),
                        device)
            for k, v in batches.items()}


def _warm_start(args, cfg):
    """(args, cfg) of the supervised-only warm-start steps: sp micro-batches
    only, the discriminator off (its params and optimizer state pass
    through the step untouched)."""
    wargs = copy.copy(args)
    wargs.ae_steps = wargs.cm_steps = wargs.d_steps = 0
    wargs.sp_steps = max(1, args.sp_steps)
    return wargs, cfg.replace(use_discriminator=False)


def train(args):
    """unast_tpu/train/loop.py::train. Returns (final TrainState, best
    PER); under dp the TrainState is this rank's (its slices under
    ZeRO)."""
    apply_runtime_flags(args)
    device = resolve_device(MH.maybe_initialize_distributed(args.device))
    cfg = model_config_from_args(args)
    datasets = initialize_datasets(args)
    rank = MH.process_index()
    # the mesh's dp coordinate of this rank (row-major over dp, tp, ep,
    # sp): its tp, ep and sp peers read the same shard and draw the same
    # streams
    n_dp = args.dp
    r_dp = rank // (MH.process_count() // n_dp)
    if n_dp > 1:
        # each dp coordinate reads a strided corpus shard and contributes
        # train_batch_size / dp rows per micro-batch
        assert args.train_batch_size % n_dp == 0, (
            f"global batch {args.train_batch_size} must divide over "
            f"dp={n_dp}")
        args.train_batch_size //= n_dp
        for k in ("labeled", "unlabeled", "full"):
            if len(datasets[k]) < n_dp:   # a rank's shard would be empty
                raise ValueError(f"the {k} set has {len(datasets[k])} items, "
                                 f"fewer than the dp={n_dp} ranks sharding it")
            datasets[k] = MH.HostShardedDataset(datasets[k], r_dp, n_dp)
    batch_getter = BatchGetter(args, datasets["labeled"],
                               datasets["unlabeled"], datasets["full"],
                               n_mels=args.num_mels)
    if not args.cm_infer_mel_len:
        args.cm_infer_mel_len = cfg.max_mel_len
    if not args.cm_infer_text_len:
        args.cm_infer_text_len = cfg.max_text_len

    ts = init_train_state(torch.Generator().manual_seed(args.seed), cfg, args,
                          device)
    s_epoch, best = 0, 300.0
    if not args.load_path and getattr(args, "auto_resume", False):
        cand = os.path.join(args.checkpoint_path, "model_most_recent.ckpt")
        if os.path.exists(cand):
            args.load_path = cand
            print(f"[INFO] auto_resume: {cand}")
    if args.load_path and os.path.exists(args.load_path):
        s_epoch, best, ts, _ = load_ckp(args.load_path, ts)
        print(f"[INFO] Training from epoch {s_epoch}.")

    n_params = sum(x.numel() for x in tree_leaves(ts.params))
    train_step = make_train_step(cfg, args)
    plan = None
    if MH.process_count() > 1:
        from ..parallel.mesh import make_mesh, shard_train_step
        tp, ep, sp = args.tp or 1, args.ep or 1, args.sp or 1
        mesh = make_mesh(args.dp, tp, sp, ep)
        print(f"mesh: dp {args.dp} tp {tp} ep {ep} sp {sp} over "
              f"{MH.process_count()} processes, zero {args.zero}")
        train_step, ts = shard_train_step(train_step, mesh, ts,
                                          zero=args.zero)
        plan = train_step.plan

    def whole():
        # the whole state (a collective under ZeRO or a model split: every
        # rank gathers)
        return (plan.whole(ts) if plan is not None
                and (plan.zero or plan.model_split) else ts)

    def generator(seed, i):
        return seeded_generator(seed, i * n_dp + r_dp, device)

    wargs, wcfg = _warm_start(args, cfg)
    if args.sp_warmup_steps and s_epoch == 0:
        # grounding curriculum: supervised-only steps anchor the
        # cross-modal alignment before the joint mixture
        wstep = make_train_step(wcfg, wargs, plan=plan)
        t0 = time.time()
        for s in range(args.sp_warmup_steps):
            wb = _to_device(batch_getter.step_batches(wargs, False), device)
            ts, wm = wstep(ts, generator(args.seed + WARMUP_SEED, s), wb)
        print(f"[sp_warmup] {args.sp_warmup_steps} supervised-only steps "
              f"in {time.time() - t0:.1f}s "
              f"(final asr {float(wm['sp/asr']):.3f} "
              f"tts {float(wm['sp/tts']):.3f})")
    elif s_epoch > 0:
        if args.sp_warmup_steps:
            batch_getter.skip_steps(wargs, False, args.sp_warmup_steps)
        batch_getter.skip_steps(args, cfg.use_discriminator,
                                s_epoch * args.epoch_steps)

    lead = rank == 0   # the rank that writes metrics and checkpoints
    writer = MetricsWriter(
        jsonl_path=(os.path.join(args.checkpoint_path, "metrics.jsonl")
                    if lead else None),
        tb_log_path=args.tb_log_path if lead else None)
    print(f"Training model with {n_params} parameters on {device}")

    def eval_params(full):
        return (ema_params(full) if getattr(args, "ema_decay", 0.0)
                else None) or full.params

    def save(full, *a, **kw):
        if lead:
            save_ckp(*a[:2], full, *a[2:], **kw)

    val_batches = _val_batches(args, datasets["val"])
    per, eval_losses = evaluate(eval_params(whole()), ts.net_state, cfg, args,
                                val_batches)
    log_loss_metrics(eval_losses, s_epoch - 1, eval_=True)

    # Host-side prefetch: the next step's numpy batches are collated on a
    # worker thread while the device runs the current step; the copies to
    # the device stay on this thread.
    prefetch_q: "queue.Queue" = queue.Queue(maxsize=2)
    stop_prefetch = threading.Event()

    def _producer():
        while not stop_prefetch.is_set():
            try:
                b = batch_getter.step_batches(args, cfg.use_discriminator)
            except Exception as e:  # surfaced in the main thread
                b = e
            while not stop_prefetch.is_set():
                try:
                    prefetch_q.put(b, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(b, Exception):
                return

    producer = threading.Thread(target=_producer, daemon=True)
    producer.start()

    step_count = s_epoch * args.epoch_steps
    step_seed = None
    try:
        for epoch in range(s_epoch, args.epochs):
            epoch_losses = {}
            t0 = time.time()
            with maybe_profile(args.profile_dir if epoch == s_epoch else None):
                for _ in range(args.epoch_steps):
                    batches = prefetch_q.get()
                    if isinstance(batches, Exception):
                        raise batches
                    batches = _to_device(batches, device)
                    step_seed = [args.seed + STEP_SEED, step_count]
                    ts, metrics = train_step(ts, generator(*step_seed), batches)
                    step_count += 1
                    if step_count % max(1, args.log_every) == 0:
                        host = {k: float(v) for k, v in metrics.items()}
                        check_nan(host, step_count, args.checkpoint_path)
                        writer.scalars(step_count, host, prefix="train/")
                        for k, v in host.items():
                            epoch_losses.setdefault(k, []).append(v)
            dt = time.time() - t0
            print(f"Epoch {epoch}: {args.epoch_steps} steps in {dt:.1f}s "
                  f"({args.epoch_steps / dt:.2f} steps/s)")

            # pre-save so a crash in eval loses nothing (src/train.py:666-667)
            full = whole()
            save(full, epoch, 300.0, False, args.checkpoint_path,
                 temporary_save=True, rng=step_seed, async_save=args.async_ckpt)
            per, eval_losses = evaluate(eval_params(full), ts.net_state, cfg,
                                        args, val_batches)
            log_loss_metrics(epoch_losses, epoch)
            log_loss_metrics(eval_losses, epoch, eval_=True)
            writer.scalars(step_count, {k: np.mean(v) for k, v in
                                        eval_losses.items()}, prefix="eval/")
            writer.scalars(step_count, {"per": per}, prefix="eval/")

            save(full, epoch, per, per < best, args.checkpoint_path,
                 rng=step_seed, async_save=args.async_ckpt)
            if args.tb_log_path and lead:
                from .observe import log_example
                try:
                    idx = int(np.random.randint(0, len(datasets["val"])))
                    log_example(writer, full.params, ts.net_state, cfg,
                                datasets["val"][idx], step_count, "eval")
                except Exception as e:  # logging must never kill training
                    print(f"[observe] example logging failed: {e!r}")
            print("Eval_ epoch {:-3d} PER {:0.3f}%".format(epoch, per * 100))
            if per < best:
                print("\t Best score - saving model!")
                best = per
            if args.save_every and (epoch + 1) % args.save_every == 0:
                save(full, epoch, per, per < best, args.checkpoint_path,
                     epoch_save=True, rng=step_seed, async_save=args.async_ckpt)
    finally:
        stop_prefetch.set()
        producer.join(timeout=30)
        wait_for_saves()
        writer.close()
    return ts, best


def evaluate_main(args):
    """unast_tpu/train/loop.py::evaluate_main: the test set, unshuffled,
    with dumps (src/train.py:985-998). Returns (per, d_score)."""
    device = resolve_device(args.device)
    cfg = model_config_from_args(args)
    test_ds = initialize_datasets(args)["test"]
    bs = _fit_eval_bs(len(test_ds), args.eval_batch_size)
    it = BatchIterator(test_ds, batch_size=bs,
                       text_len=args.data_text_len, mel_len=args.data_mel_len,
                       seed=args.seed, n_mels=args.num_mels)
    it._order = np.arange(len(test_ds))  # unshuffled, reference shuffle=False
    batches = [it.next_batch() for _ in range(len(test_ds) // bs)]

    ts = init_train_state(torch.Generator().manual_seed(args.seed), cfg, args,
                          device)
    if args.load_path and os.path.exists(args.load_path):
        _, _, ts, _ = load_ckp(args.load_path, ts)
    per, eval_losses, d_score = evaluate(ts.params, ts.net_state, cfg, args,
                                         batches, is_test=True)
    log_loss_metrics(eval_losses, 0, eval_=True)
    print(f"per : {per}")
    print(f"d_score : {d_score}")
    return per, d_score


def main(argv=None):
    """unast_tpu/train/loop.py::main: evaluate with --is_eval_test, else
    train."""
    args = parse_with_config(argv)
    print(f"device: {resolve_device(args.device)}")
    if args.is_eval_test:
        print("#### DOING EVALUATION ####")
        evaluate_main(args)
    else:
        print("#### TRAINING ####")
        try:
            train(args)
        finally:
            MH.shutdown_distributed()


if __name__ == "__main__":
    main()
