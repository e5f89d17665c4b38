"""One rank of the 2-process gloo world of tests/test_torch_parallel.py,
or, with the mode `sp_pp`, of tests/test_torch_sp_pp.py's.

    python tests/torch_parallel_worker.py RANK PORT OUT_DIR [sp_pp|pp4]

Imports only torch and the port. Both ranks run every case of the port's
data parallelism at TINY and write their records to OUT_DIR/rank<R>.pt:
one dp = 2 joint step under zero 0, 1 and 3; each rank's single-process
step on its own rows (a mean of per-rank steps, which the global batch's
semantics must not be); a ZeRO-3 checkpoint saved whole, loaded and
placed again; the collectives and the speech decode's global stop test;
HostShardedDataset's shards; Synthesizer(mesh=), also with
nar_pv, melgan_params, ctc_pv and quantize='int8', and on rank 0 the
single-process Synthesizer while rank 1 takes the single-process step on
the whole batch. The sp_pp mode runs sp_pp_cases instead, and the pp4
mode (a world of 4 ranks) pp4_cases. Exit code 0 when every case ran.
"""

import os
import sys

RANK, PORT, OUT = int(sys.argv[1]), sys.argv[2], sys.argv[3]
MODE = sys.argv[4] if len(sys.argv) > 4 else "dp"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
WORLD = 4 if MODE == "pp4" else 2
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                        world_size=WORLD, rank=RANK)

import torch_parallel_golden as PG
from unast_tpu_torch.models import TINY, unast_init
from unast_tpu_torch.parallel import multihost as MH
from unast_tpu_torch.parallel.mesh import (batch_shardings, make_mesh,
                                           shard_train_step, state_bytes)
from unast_tpu_torch.train import checkpoint as CK
from unast_tpu_torch.train import steps as TS
from unast_tpu_torch.train.config import train_args
from unast_tpu_torch.train.optim import tree_paths

mesh = make_mesh(WORLD)
out = {}


def mesh_cases():
    """The model-parallel cases and the MoE capacity under dp, each a
    sharded step from the same weights on both ranks (the whole state
    recorded) and the single-process step on the whole batch; case i's
    records are written by rank i % 2, which also takes its reference
    once every sharded step has run, while the other rank takes its
    own."""
    import contextlib

    from unast_tpu_torch.audio.params import DEFAULT as AP
    from unast_tpu_torch.parallel.mesh import shard_family_step
    from unast_tpu_torch.train import ctc as TC, fastspeech as TF, melgan as TG
    meshes = {"dp": mesh, "tp": make_mesh(1, 2), "ep": make_mesh(1, 1, ep=2)}
    moe = dict(moe_experts=4, moe_capacity_factor=0.5, moe_group_size=16)
    # name: (mesh, config overrides, every dropout at 0, optimizer); the
    # conformer case updates through Adafactor, whose block-RMS clip needs
    # the whole leaf: at a first step every update is +-1, its RMS 1 and
    # the clip idle, so both sides start from one single-process step
    joint = {
        "moe_dp/dispatch": ("dp", moe, True, "adamw"),
        "moe_dp/ragged": ("dp", dict(moe, moe_impl="ragged"), True, "adamw"),
        "tp/transformer": ("tp", {}, True, "adamw"),
        "tp/conformer": ("tp", dict(speech_encoder="conformer"), True, "adafactor"),
        "tp/train_mode": ("tp", dict(attn_impl="xla", use_discriminator=True), False,
                          "adamw"),
        "ep/dispatch": ("ep", dict(moe_experts=4, moe_group_size=16), True, "adamw"),
        "ep/ragged": ("ep", dict(moe_experts=4, moe_impl="ragged"), True, "adamw"),
    }
    refs = []   # this rank's single-process references, taken last
    for i, (name, (m, over, zero_drop, optim)) in enumerate(joint.items()):
        c = (TINY.replace(**over) if not zero_drop
             else TINY.replace(**PG.model_overrides(), **over))
        args = train_args(PG.CONFIG, **PG.ARGS, optim_type=optim)
        p0, s0 = unast_init(torch.Generator().manual_seed(0), c)
        start = TS.train_state(p0, s0, c, args)
        fixed = TS.zero_fixed_dropouts if zero_drop else contextlib.nullcontext
        with fixed():
            if optim == "adafactor":
                start, _ = TS.make_train_step(c, args)(
                    start, TS.seeded_generator(1, 0, "cpu"), batches)
            step, placed = shard_train_step(
                TS.make_train_step(c, args), meshes[m], start,
                zero=1 if m == "dp" else 0)
            # the tp and ep ranks share their dp coordinate's stream
            gen = TS.seeded_generator(0, RANK if m == "dp" else 0, "cpu")
            new, metrics = step(placed, gen, batch_shardings(meshes[m], batches))
            whole = step.plan.whole(new)
        if RANK == i % 2:
            record(f"{name}/mesh", whole, metrics)
            out[f"{name}/init"] = flat(start.params)
            out[f"{name}/opt_bytes"] = state_bytes(new.gen_opt)
            refs.append((name, None, (c, args, start, fixed)))
        if name == "tp/transformer":
            # a tp checkpoint: the whole state saved by rank 0, loaded by
            # both and placed again: each rank's slices as kept in memory
            ck = os.path.join(OUT, "tp_ck")
            if RANK == 0:
                CK.save_ckp(0, 1.0, whole, False, ck)
            dist.barrier()
            _, _, loaded, _ = CK.load_ckp(os.path.join(ck, "model_most_recent.ckpt"),
                                          TS.train_state(p0, s0, c, args))
            out["tp_resume/placed"] = flat(step.plan.place(loaded)._asdict())
            out["tp_resume/kept"] = flat(new._asdict())

    # the family steps: CTC and distillation at tp = 2, MelGAN at dp = 2
    c = TINY.replace(**PG.model_overrides())
    fargs = train_args(PG.CONFIG, lr=1e-3, melgan_base=32)
    text, mel, tl, ml = (x[0] for x in batches["sp"])
    flat_b = {"text": text, "text_len": tl, "mel": mel, "mel_len": ml}
    t_p, t_s = unast_init(torch.Generator().manual_seed(0), c)
    rng = np.random.default_rng(0)
    vmel = torch.from_numpy(rng.random((4, 16, 80)).astype(np.float32))
    vwav = torch.from_numpy((rng.standard_normal((4, 16 * AP.hop_length))
                             * 0.1).astype(np.float32))
    family = {
        "family/ctc_tp": ("tp", lambda: TC.init_ctc_state(
            torch.Generator().manual_seed(0), c, fargs, "cpu"),
            lambda plan=None: TC.make_ctc_step(c, fargs, plan=plan)),
        "family/distill_tp": ("tp", lambda: TF.init_fs_state(
            torch.Generator().manual_seed(1), c, fargs, "cpu"),
            lambda plan=None: TF.make_distill_step(c, c, fargs, plan=plan)),
        "family/melgan_dp": ("dp", lambda: TG.init_voc_state(
            torch.Generator().manual_seed(0), fargs, device="cpu"),
            lambda plan=None: TG.make_vocoder_step(fargs, plan=plan)),
    }
    def call(kind, st, ts_, b, teacher):
        if kind == "ctc":
            return st(ts_, TS.seeded_generator(1, 0, "cpu"), b)
        if kind == "distill":
            return st(ts_, *teacher, TS.seeded_generator(2, 0, "cpu"), b)
        return st(ts_, b["mel"], b["wav"])

    def family_record(key, st_, mt):
        out[key] = {"metrics": {k: float(v) for k, v in mt.items()},
                    "params": flat(st_.params),
                    "state": flat(getattr(st_, "net_state", {})),
                    "gen_mu": flat(st_.opt.mu), "disc_mu": {}}

    for i, (name, (m, init, make)) in enumerate(family.items(), start=len(joint)):
        ts = init()
        step, placed, plan = shard_family_step(make, meshes[m], ts)
        kind = name.split("/")[1].split("_")[0]
        b = (flat_b if kind != "melgan" else {"mel": vmel, "wav": vwav})
        with TS.zero_fixed_dropouts():
            new, metrics = call(kind, step, placed,
                                batch_shardings(meshes[m], b, dim=0),
                                (plan.place_tree(t_p), t_s))
            whole = plan.whole(new)
        if RANK == i % 2:
            family_record(f"{name}/mesh", whole, metrics)
            out[f"{name}/init"] = flat(ts.params)
            refs.append((name, kind, (ts, make, b)))

    # the references, each rank its own cases, both ranks at once
    for name, kind, case in refs:
        if kind is not None:   # a family step
            ts, make, b = case
            with TS.zero_fixed_dropouts():
                family_record(f"{name}/single",
                              *call(kind, make(None), ts, b, (t_p, t_s)))
            continue
        c, args, start, fixed = case
        with fixed():
            single, sm = TS.make_train_step(c, args)(
                start, TS.seeded_generator(0, 0, "cpu"), batches)
        record(f"{name}/single", single, sm)
        out[f"{name}/opt_bytes"] = (out[f"{name}/opt_bytes"],
                                    state_bytes(single.gen_opt))


def flat(tree):
    return {k: torch.as_tensor(v).detach().float().clone()
            for k, v in tree_paths(tree).items()}


def moment(opt):
    """An optimizer state's per-param moment: Adam's first, or (Adafactor
    at TINY, where no leaf is factored) its full second moment."""
    return flat(opt.mu if hasattr(opt, "mu") else opt.v)


def record(key, ts, metrics):
    out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                "params": flat(ts.params), "state": flat(ts.net_state),
                "gen_mu": moment(ts.gen_opt), "disc_mu": moment(ts.disc_opt)}


def _rebuild_paths(tree, leaves, path=""):
    """tree (of dicts) with each tensor leaf replaced by leaves[its
    tree_paths key]."""
    if isinstance(tree, dict):
        return {k: _rebuild_paths(v, leaves, f"{path}{k}/") for k, v in tree.items()}
    return leaves[path.rstrip("/")]


def run_cases(cases, meshes):
    """Each case (name: (mesh, config overrides, every dropout at 0, args
    overrides, batches)) a sharded step from the same weights on every
    rank (the whole state recorded), and its flash backward calls; case
    i's records are written by rank i % WORLD, which takes its
    single-process reference once every sharded step has run (pp/flash
    also the sequential stack's)."""
    import contextlib

    from unast_tpu_torch.ops import attention as A
    refs = []
    for i, (name, (m, over, zero_drop, aover, b)) in enumerate(cases.items()):
        c = (TINY.replace(**PG.model_overrides(), **over) if zero_drop
             else TINY.replace(use_discriminator=True, **over))
        args = train_args(PG.CONFIG, **{**PG.ARGS, **aover})
        p0, s0 = unast_init(torch.Generator().manual_seed(0), c)
        start = TS.train_state(p0, s0, c, args)
        fixed = TS.zero_fixed_dropouts if zero_drop else contextlib.nullcontext
        with fixed():
            step, placed = shard_train_step(TS.make_train_step(c, args),
                                            meshes[m], start)
            bwd = A.flash_attention.backward_calls
            new, metrics = step(placed, TS.seeded_generator(0, 0, "cpu"),
                                batch_shardings(meshes[m], b))
            bwd = A.flash_attention.backward_calls - bwd
            whole = step.plan.whole(new)
        out[f"{name}/bwd"] = (bwd, TS.flash_calls_per_step(
            c, args, rows=PG.B, staged="pp" in m)[1] if c.attn_impl == "flash" else 0)
        if RANK == i % WORLD:
            record(f"{name}/mesh", whole, metrics)
            out[f"{name}/init"] = flat(start.params)
            refs.append((name, c, args, start, fixed, b))
    for name, c, args, start, fixed, b in refs:
        with fixed():
            single, sm = TS.make_train_step(c, args)(
                start, TS.seeded_generator(0, 0, "cpu"), b)
            record(f"{name}/single", single, sm)
            if name == "pp/flash":   # the sequential stack
                c1 = c.replace(pp=1)
                seq, qm = TS.make_train_step(c1, args)(
                    TS.train_state(*unast_init(torch.Generator().manual_seed(0), c1),
                                   c1, args), TS.seeded_generator(0, 0, "cpu"), b)
                record(f"{name}/sequential", seq, qm)


def base_batches():
    """PG's batches as tensors, and their odd-length cut (11 tokens, 19
    frames: the last sp rank holds a padding frame)."""
    base = {k: tuple(torch.from_numpy(a).long() if a.dtype == np.int32
                     else torch.from_numpy(a) for a in v)
            for k, v in PG.batches_np().items()}
    odd = {k: (t[..., :11], m[..., :19, :], tl.clamp(max=11), ml.clamp(max=19))
           for k, (t, m, tl, ml) in base.items()}
    return base, odd


def pp4_cases():
    """The world of 4 ranks: a pp axis of 2 with tp = 2 (each stage's
    layers split over its tp pair), with ep = 2 (the MoE stack unstaged,
    its experts over ep) and with sp = 2 (each stage on its sp rank's
    frames, odd lengths), each against the single-process step with
    cfg.pp = 2 (every dropout at 0)."""
    base, odd = base_batches()
    meshes = {"tp_pp": make_mesh(1, 2, pp=2), "ep_pp": make_mesh(1, 1, ep=2, pp=2),
              "sp_pp": make_mesh(1, sp=2, pp=2)}
    run_cases({
        "pp4/tp_pp": ("tp_pp", dict(pp=2), True, {}, base),
        "pp4/ep_pp": ("ep_pp", dict(pp=2, moe_experts=4, moe_group_size=16),
                      True, {}, base),
        "pp4/sp_pp": ("sp_pp", dict(pp=2), True,
                      dict(cm_infer_mel_len=23, cm_infer_text_len=15), odd),
    }, meshes)
    out["coords"] = {k: meshes[k].get_coordinate() for k in meshes}


def sp_pp_cases():
    """The sequence- and pipeline-parallel cases at TINY, each a sharded
    step from the same weights on both ranks against the single-process
    step (case i's records written by rank i % 2, which takes its
    reference once every sharded step has ran): sp = 2 with flash, and in
    train mode on the xla route with the conformer on odd lengths (padded
    frames: 11 tokens, 19 frames, cm decoding 15 and 23); pp = 2 with
    flash and in train mode (ae, sp and d without guided attention, so
    that every decoder pipelines), against the one-process schedule (cfg.pp 2)
    and, for flash, the sequential stack too; the flash backward calls of
    each rank. Then the halo convs and BatchNorm on an odd T against the
    unsplit ops, pipeline_encoder on the golden's case, and the meshes'
    coordinates."""
    import torch_sp_pp_golden as SG
    from unast_tpu_torch import nn as tnn
    from unast_tpu_torch.models import conformer as CF
    from unast_tpu_torch.parallel import collectives as C
    from unast_tpu_torch.parallel import pipeline as PL
    from unast_tpu_torch.parallel.mesh import mesh_axis
    meshes = {"sp": make_mesh(1, sp=2), "pp": make_mesh(1, pp=2)}
    base, odd = base_batches()
    cases = {   # name: (mesh, config overrides, every dropout at 0, args, batches)
        "sp/flash": ("sp", {}, True, {}, base),
        "sp/train_mode": ("sp", dict(attn_impl="xla", speech_encoder="conformer"),
                          False, dict(cm_infer_mel_len=23, cm_infer_text_len=15), odd),
        "pp/flash": ("pp", dict(pp=2), True, {}, base),
        "pp/train_mode": ("pp", dict(attn_impl="xla", pp=2), False,
                          dict(cm_steps=0, ga_weight=0.0),
                          {k: v for k, v in base.items() if k != "cm"}),
    }
    # the combinations JAX builds that the port once refused: sp with
    # remat (the recompute inside the region: train mode with the
    # conformer's halos and BatchNorm; flash under dots_all), with MoE
    # (dispatch overflowing its capacity in groups that straddle the
    # ranks, ragged) on odd lengths, and with the RNN backbone
    odd_args = dict(cm_infer_mel_len=23, cm_infer_text_len=15)
    moe = dict(moe_experts=4, moe_capacity_factor=0.5, moe_group_size=16)
    cases.update({
        "sp/remat": ("sp", dict(attn_impl="xla", speech_encoder="conformer",
                                remat=True), False, odd_args, odd),
        "sp/remat_dots_all": ("sp", dict(remat=True, remat_policy="dots_all"),
                              True, {}, base),
        "sp/moe_dispatch": ("sp", moe, True, odd_args, odd),
        "sp/moe_ragged": ("sp", dict(moe, moe_impl="ragged"), True, odd_args, odd),
        "sp/rnn": ("sp", dict(model_type="rnn"), False, odd_args, odd),
    })
    run_cases(cases, meshes)

    # a checkpointed layer inside an sp region against the same layer
    # unchecked: the recompute (in the backward, after the region was
    # left) must gather K and V and draw dropout as the forward did
    from unast_tpu_torch.models import transformer as T
    sp_ax = mesh_axis(meshes["sp"], "sp")
    g = torch.Generator().manual_seed(7)
    lp = T.encoder_layer_init(g, 16, 2, 32)
    xw = torch.randn((2, 7, 16), generator=g)
    pad = torch.tensor([[False] * 7, [False] * 5 + [True] * 2])
    w_y = torch.randn((2, 7, 16), generator=g)

    def layer(lp_, x_):   # its generator made inside, as _run_layers' are
        ctx = tnn.Ctx(generator=torch.Generator().manual_seed(3), train=True)
        return T.encoder_layer(lp_, ctx, x_, T.padding_bias(pad), 2, 0.3)

    def layer_grads(fn):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in tree_paths(lp).items()}
        x = xw.clone().requires_grad_(True)
        with C.mesh_axes(sp=sp_ax, dp_sp=sp_ax.group), C.sequence(7):
            y = C.gather_time(fn(_rebuild_paths(lp, leaves), C.split_time(x)))
        loss = (y * w_y).sum() / 2
        return [C.all_reduce(gr, sp_ax.group) for gr in
                torch.autograd.grad(loss, [x, *leaves.values()])]

    try:
        plain, ckpt = layer_grads(layer), layer_grads(T._ckpt(layer, ""))
        out["remat_in_region"] = {
            "err": max(float((a - b).abs().max()) for a, b in zip(plain, ckpt)),
            "scale": max(float(a.abs().max()) for a in plain)}
    except Exception as e:   # the test reads the failure
        out["remat_in_region"] = {"error": repr(e)}

    # the halo convs, BatchNorm and the depthwise conv on T = 7 (4 frames a
    # rank, one padding) against the unsplit ops; the loss 1/sp a rank,
    # the gradients summed over sp
    g = torch.Generator().manual_seed(11)
    x = torch.randn((3, 7, 4), generator=g, requires_grad=True)
    conv = {"w": torch.randn((5, 4, 4), generator=g, requires_grad=True),
            "b": torch.randn((4,), generator=g, requires_grad=True)}
    dw = {"w": torch.randn((3, 1, 4), generator=g, requires_grad=True),
          "b": torch.randn((4,), generator=g, requires_grad=True)}
    bn_p = {"scale": torch.rand((4,), generator=g) + 0.5, "bias": torch.randn((4,), generator=g)}
    bn_p = {k: v.requires_grad_(True) for k, v in bn_p.items()}
    bn_s = {"mean": torch.zeros(4), "var": torch.ones(4)}
    w_out = torch.randn((4, 3, 7, 4), generator=g)
    leaves = [x, *conv.values(), *dw.values(), *bn_p.values()]

    def ops(x):
        a = tnn.conv1d(conv, x, (2, 2))
        b = tnn.conv1d(conv, x, (4, 0))
        c, st = tnn.batchnorm(bn_p, bn_s, x, True)
        d = CF._depthwise_conv(dw, x, 3)
        return [C.gather_time(y) for y in (a, b, c, d)], st

    sp_ax = mesh_axis(meshes["sp"], "sp")
    with C.mesh_axes(sp=sp_ax, dp_sp=sp_ax.group), C.sequence(7):
        split, st = ops(C.split_time(x))
    loss = sum((y * w).sum() for y, w in zip(split, w_out)) / 2
    grads = [C.all_reduce(gr, sp_ax.group) for gr in torch.autograd.grad(loss, leaves)]
    whole, st1 = ops(x)
    loss1 = sum((y * w).sum() for y, w in zip(whole, w_out))
    grads1 = torch.autograd.grad(loss1, leaves)
    out["halo"] = {"out": [float((a - b).detach().abs().max())
                           for a, b in zip(split, whole)],
                   "grad": [float((a - b).abs().max()) for a, b in zip(grads, grads1)],
                   "state": [float((st[k] - st1[k]).abs().max()) for k in st1],
                   "scale": float(max(y.detach().abs().max() for y in whole))}

    # pipeline_encoder on the golden's case: output and input gradient
    p, xe, pad = SG.encoder_case()
    xe = torch.from_numpy(xe).requires_grad_(True)
    y = PL.pipeline_encoder(PL.stack_for_pipeline(p, SG.ENC["pp"]), tnn.Ctx.eval(),
                            xe, torch.from_numpy(pad), SG.ENC["nhead"], 0.0,
                            meshes["pp"], SG.ENC["n_micro"])
    (gx,) = torch.autograd.grad(y.sum(), xe)
    out["pipeline_encoder"] = {"out": y.detach(), "grad": gx}
    out["coords"] = {k: meshes[k].get_coordinate() for k in meshes}


if MODE in ("sp_pp", "pp4"):
    sp_pp_cases() if MODE == "sp_pp" else pp4_cases()
    torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    sys.exit(0)

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
        whole = step.plan.whole(new) if zero else new
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
            out["resume/placed"] = flat(step.plan.place(loaded)._asdict())
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

mesh_cases()
torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
dist.barrier()
dist.destroy_process_group()
