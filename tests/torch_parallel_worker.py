"""One rank of the 2-process gloo world of tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK PORT OUT_DIR

Imports only torch and the port. Both ranks run every case of the port's
data parallelism at TINY and write their records to OUT_DIR/rank<R>.pt:
one dp = 2 joint step under zero 0, 1 and 3; each rank's single-process
step on its own rows (a mean of per-rank steps, which the global batch's
semantics must not be); a ZeRO-3 checkpoint saved whole, loaded and
placed again; the collectives and the speech decode's global stop test;
HostShardedDataset's shards; Synthesizer(mesh=), also with
nar_pv, melgan_params, ctc_pv and quantize='int8', and on rank 0 the
single-process Synthesizer while rank 1 takes the single-process step on
the whole batch. Exit code 0 when every case ran.
"""

import os
import sys

RANK, PORT, OUT = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                        world_size=2, rank=RANK)

import torch_parallel_golden as PG
from unast_tpu_torch.models import TINY, unast_init
from unast_tpu_torch.parallel import multihost as MH
from unast_tpu_torch.parallel.mesh import (batch_shardings, make_mesh,
                                           shard_train_step, state_bytes)
from unast_tpu_torch.train import checkpoint as CK
from unast_tpu_torch.train import steps as TS
from unast_tpu_torch.train.config import train_args
from unast_tpu_torch.train.optim import tree_paths

mesh = make_mesh(2)
out = {}


def flat(tree):
    return {k: torch.as_tensor(v).detach().float().clone()
            for k, v in tree_paths(tree).items()}


def record(key, ts, metrics):
    out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                "params": flat(ts.params), "state": flat(ts.net_state),
                "gen_mu": flat(ts.gen_opt.mu), "disc_mu": flat(ts.disc_opt.mu)}


cfg = TINY.replace(**PG.model_overrides())
args = train_args(PG.CONFIG, **PG.ARGS)
params, state = unast_init(torch.Generator().manual_seed(0), cfg)
batches = {k: tuple(torch.from_numpy(a).long() if a.dtype == np.int32
                    else torch.from_numpy(a) for a in v)
           for k, v in PG.batches_np().items()}
local = batch_shardings(mesh, batches)

with TS.zero_fixed_dropouts():
    # the dp steps, zero 0 / 1 / 3, from the same weights on both ranks
    for zero in PG.ZEROS:
        ts = TS.train_state(params, state, cfg, args)
        step, placed = shard_train_step(TS.make_train_step(cfg, args), mesh,
                                        ts, zero=zero)
        out[f"opt_bytes/{zero}"] = state_bytes(placed.gen_opt)
        new, metrics = step(placed, TS.seeded_generator(0, RANK, "cpu"), local)
        whole = step.dp.whole(new) if zero else new
        record(f"dp/{zero}", whole, metrics)
        if zero == 3:
            # a ZeRO-3 checkpoint: the whole state, saved by rank 0, loaded
            # by both and placed again: each rank's slices as in memory
            ck = os.path.join(OUT, "ck")
            if RANK == 0:
                CK.save_ckp(0, 1.0, whole, False, ck)
            dist.barrier()
            template = TS.train_state(params, state, cfg, args)
            _, _, loaded, _ = CK.load_ckp(os.path.join(ck, "model_most_recent.ckpt"),
                                          template)
            out["resume/placed"] = flat(step.dp.place(loaded)._asdict())
            out["resume/kept"] = flat(new._asdict())
    # a mean of per-rank steps: each rank's single-process step on its rows
    ts = TS.train_state(params, state, cfg, args)
    _, m = TS.make_train_step(cfg, args)(
        ts, TS.seeded_generator(0, RANK, "cpu"),
        {k: tuple(x.clone() for x in v) for k, v in local.items()})
    out["local_metrics"] = {k: float(v) for k, v in m.items()}

# the collectives: sums, the global mean's shares and their gradient, the
# global stop test
from unast_tpu_torch import nn as tnn
from unast_tpu_torch.models import modules as TMo, networks as TN
from unast_tpu_torch.parallel import collectives as C
group = mesh.get_group("dp")
x = torch.tensor(float(RANK + 1), requires_grad=True)
with C.data_parallel(group):
    total = C.total(torch.tensor([RANK + 1.0]))
    share = C.mean(torch.full((3,), RANK + 1.0))
    loss = C.sum_grad(x) ** 2 / C.ranks()    # this rank's share of S**2
    (grad,) = torch.autograd.grad(loss, x)
    stop = C.any_rank(torch.tensor(RANK == 1))
out["collectives"] = {"total": float(total), "mean_share": float(share),
                      "grad": float(grad), "any": stop,
                      "any_alone": C.any_rank(torch.tensor(RANK == 1))}
# the speech decode under dp: rank 1's row stops at its first frame, rank
# 0's never; the loop must run until the global batch stops, as the
# single-process decode of both rows does, since train-mode BatchNorm in
# the postnet reads every frame of the buffer
dcfg = TINY.replace(**PG.model_overrides())
dp_, ds_ = unast_init(torch.Generator().manual_seed(5), dcfg)
mem = torch.randn((2, 5, dcfg.e_in), generator=torch.Generator().manual_seed(6))
stoppers = {"rows": None}
real_stop = TMo.speech_mel_and_stop


def stop_head(p, h):    # a test double: the stop logit by row
    mel, stop = real_stop(p, h)
    fire = stoppers["rows"][:, None, None].to(stop.dtype)
    return mel, torch.where(fire > 0, torch.full_like(stop, 100.0),
                            torch.full_like(stop, -100.0))


TMo.speech_mel_and_stop = stop_head
pad = torch.zeros((2, 5), dtype=torch.bool)
ctx = tnn.Ctx(generator=torch.Generator().manual_seed(0), train=True)
with TS.zero_fixed_dropouts():
    stoppers["rows"] = torch.tensor([0, 1])[RANK:RANK + 1]
    with C.data_parallel(group):
        (pre, post, stops, lens), st = TN.speech_tr_infer(
            dp_["speech_m"], ds_["speech_m"], ctx, dcfg, mem[RANK:RANK + 1],
            pad[RANK:RANK + 1])
    stoppers["rows"] = torch.tensor([0, 1])
    (pre1, post1, _, lens1), st1 = TN.speech_tr_infer(
        dp_["speech_m"], ds_["speech_m"], ctx, dcfg, mem, pad)
TMo.speech_mel_and_stop = real_stop
out["decode"] = {"post": post[0], "post_single": post1[RANK], "lens": lens.tolist(),
                 "lens_single": lens1.tolist(),
                 "bn": flat(st["postnet"]), "bn_single": flat(st1["postnet"])}

# HostShardedDataset: rank r's strided shard of 5 items
out["host_shard"] = [MH.HostShardedDataset(list(range(5)))[i]
                     for i in range(len(MH.HostShardedDataset(list(range(5)))))]

# Synthesizer(mesh=) against the single-process one: 3 requests (padded
# to 4 over the 2 ranks), TTS mels and greedy ASR ids
from unast_tpu_torch.infer.serve import Synthesizer
sp, ss = PG.serve_trees()
scfg = TINY.replace(attn_impl="flash")
mels = PG.asr_mels()
syn = Synthesizer(sp, ss, scfg, device="cpu", mesh=mesh, **PG.SYN_KW)
out["syn/mels"] = [torch.from_numpy(m) for m in syn.tts_mels(PG.SYN_TEXTS)]
out["syn/ids"] = [torch.from_numpy(i) for i in syn.asr_ids(mels)]
if RANK == 0:
    one = Synthesizer(sp, ss, scfg, device="cpu", **PG.SYN_KW)
    out["one/mels"] = [torch.from_numpy(m) for m in one.tts_mels(PG.SYN_TEXTS)]
    out["one/ids"] = [torch.from_numpy(i) for i in one.asr_ids(mels)]
    out["one/margins"] = PG.asr_margins(one, mels, out["one/ids"])
else:   # meanwhile, the single-process step on the whole batch
    with TS.zero_fixed_dropouts():
        new, m = TS.make_train_step(cfg, args)(
            TS.train_state(params, state, cfg, args),
            TS.seeded_generator(0, 0, "cpu"), batches)
    record("single", new, m)
try:
    Synthesizer(sp, ss, scfg, device="cpu", mesh=mesh, max_batch=3)
except ValueError as e:
    out["syn/odd_batch_error"] = str(e)
# the one-pass options and int8 weights under the mesh: NAR TTS through
# MelGAN, one-pass CTC ASR
opts = dict(PG.one_pass_trees(), quantize="int8", device="cpu", **PG.SYN_KW)
wavs = Synthesizer(sp, ss, scfg, mesh=mesh, **opts).tts(PG.SYN_TEXTS)
ids = Synthesizer(sp, ss, scfg, mesh=mesh, **opts).asr_ids(mels)
out["syn_opts/wavs"] = [torch.from_numpy(w) for w in wavs]
out["syn_opts/ids"] = [torch.from_numpy(i) for i in ids]
if RANK == 0:
    one = Synthesizer(sp, ss, scfg, **opts)
    out["one_opts/wavs"] = [torch.from_numpy(w) for w in one.tts(PG.SYN_TEXTS)]
    out["one_opts/ids"] = [torch.from_numpy(i) for i in one.asr_ids(mels)]

torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
dist.barrier()
dist.destroy_process_group()
