"""Entry: the curriculum's supervised warm-up step of the port
(unast_tpu_torch/train/loop.py::_warm_start's arguments, the step that
train/steps.py::make_train_step builds from them): sp micro-batches only,
the discriminator off, TTS and ASR teacher-forced through the flash
kernels in both directions, guided attention, AdamW.

Set-up makes the weights and the inputs from the seed on the device,
builds the step and drives it through its first `check_steps` steps
(which also warm up every shape), keeping what the check compares: each
step's loss, the first gradient as the optimizer took it (from Adam's
first moment after one step) and each leaf's change over those steps.
The window then steps on the same object over a pool of step inputs.
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

B1 = 0.9
LOSS_TERMS = ("sp/tts", "sp/asr", "sp/ga_sp")


def _gen(seed, i, device):
    """The generator of step i's draws (dropout, SpecAugment)."""
    s = np.random.SeedSequence([int(seed) % 2 ** 64, 29, i]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def _weight_seed(seed):
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, 7])
               .generate_state(1)[0])


def _norms(tree):
    return {p: float(x.float().norm()) for p, x in RM.leaves(tree)}


def setup(cell, seed, device):
    # the program is imported here, when a run begins (a test may stand a
    # broken step in for make_train_step first)
    from unast_tpu_torch.train.config import model_config_from_args, train_args
    from unast_tpu_torch.train.loop import _warm_start
    from unast_tpu_torch.train.steps import make_train_step, train_state

    c, t = cell.config, cell.traffic
    args = train_args(os.path.join(cell.root, cell.config_entry["file"]))
    wargs, wcfg = _warm_start(args, model_config_from_args(args))
    if wargs.sp_steps != t["micro_batches"] or args.train_batch_size != t["batch"]:
        raise ValueError("the traffic's micro-batches and batch must be the "
                         "configuration's sp_steps and train_batch_size")
    spec = RM.unast_spec(c)
    params = RM.make_weights(spec, _weight_seed(seed), device)
    net_state = RM.tree_map(lambda x: x.to(device), RM.unast_state(c))
    ts = train_state(params, net_state, wcfg, wargs)
    del params
    step = make_train_step(wcfg, wargs)
    pool, frames = T.train_steps(t, seed, t["pool_steps"], device)
    batches = [{"sp": b} for b in pool]
    n_check = t["check_steps"]
    losses = []
    for i in range(n_check):
        ts, m = step(ts, _gen(seed, i, device), batches[i % len(batches)])
        losses.append({k: float(m[k]) for k in LOSS_TERMS})
        if i == 0:
            # Adam's first moment after one step is (1 - b1) times the
            # clipped gradient; the step's grad_norm undoes the clip
            unclip = max(1.0, float(m["grad_norm"]) / wargs.grad_clip)
            grad1 = {p: n / (1.0 - B1) * unclip
                     for p, n in _norms(ts.gen_opt.mu).items()}
    p0 = RM.make_weights(spec, _weight_seed(seed), device)
    delta = {p: float((x - x0).norm()) for (p, x), (_, x0) in
             zip(RM.leaves(ts.params), RM.leaves(p0))}
    del p0
    lens = [(b[2].reshape(-1).tolist(), b[3].reshape(-1).tolist()) for b in pool]
    return {"cell": cell, "seed": seed, "device": device, "ts": ts,
            "step": step, "batches": batches, "next": n_check,
            "frames_per_step": frames,
            "flops_per_step": FL.sp_step(c, *lens[0]),
            "check": {"losses": losses, "grad1": grad1, "delta": delta}}


def _one(state):
    i = state["next"]
    with record_function("bench/step"):
        state["ts"], m = state["step"](
            state["ts"], _gen(state["seed"], i, state["device"]),
            state["batches"][i % len(state["batches"])])
    state["next"] = i + 1
    return m


def window(state, seconds):
    dev = state["device"]
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, last, marks = 0, None, [t0]
    while marks[-1] - t0 < seconds:
        last = _one(state)
        steps += 1
        marks.append(time.perf_counter())
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = last is not None and all(math.isfinite(float(last[k]))
                                      for k in LOSS_TERMS)
    return {"steps": steps, "seconds": wall, "attempted": steps,
            "failed": 0 if finite else steps,
            "frames": steps * state["frames_per_step"],
            "model_flops": steps * state["flops_per_step"],
            "unit_s": list(np.diff(marks))}


def tail(state):
    """The profiled tail: a few more steps, every flash call recorded."""
    n = state["cell"].traffic["trace_steps"]
    with flash_calls.recording() as calls:
        for _ in range(n):
            _one(state)
    state["tail"] = {"steps": n, "flash": calls}


def end_to_end(state, win):
    return {"train_frames_per_s": win["frames"] / win["seconds"]}


def _leaf_gaps(got, ref, keep):
    """Per kept leaf, |got - ref| / max(ref, the median kept leaf's ref)."""
    names = [p for p in ref if keep(p)]
    med = float(np.median([ref[p] for p in names]))
    return np.array([abs(got[p] - ref[p]) / max(ref[p], med) for p in names])


def judge(state, win, detail=None):
    """Free the program's state, then follow the first check_steps steps
    with the plain reference on the same weights, inputs and
    generators, and compare (`compare`)."""
    c, seed, dev = state["cell"].config, state["seed"], state["device"]
    check = state["check"]
    for k in ("ts", "step"):
        state.pop(k, None)
    if dev == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(c, seed, dev, state["batches"],
                             len(check["losses"]), "f32")
    if detail is not None:
        detail.update(program=check, reference=ref)
    return compare(check, ref)


def control(cell, seed, device, prec, detail=None):
    """The control's readings: the reference in `prec` put in the
    program's place on the same weights, inputs and generators, compared
    with the reference as the program is."""
    t = cell.traffic
    pool, _ = T.train_steps(t, seed, t["pool_steps"], device)
    batches = [{"sp": b} for b in pool]
    ref = reference_readings(cell.config, seed, device, batches,
                             t["check_steps"], "f32")
    got = reference_readings(cell.config, seed, device, batches,
                             t["check_steps"], prec)
    got["losses"] = [{"sp/" + k: v for k, v in x.items()}
                     for x in got["losses"]]
    if detail is not None:
        detail.update(program=got, reference=ref)
    return compare(got, ref)


def reference_readings(c, seed, dev, batches, n_steps, prec):
    """The reference's losses, first gradient (before the clip) and
    leaves' changes over n_steps, computed in `prec`."""
    with RM.full_float32():
        params = RM.make_weights(RM.unast_spec(c), _weight_seed(seed), dev)
        p0 = {p: x.clone() for p, x in RM.leaves(params)}
        rs = RM.init_state(params, RM.tree_map(lambda x: x.to(dev),
                                               RM.unast_state(c)))
        losses, grad1 = [], None
        for i in range(n_steps):
            text, mel, tl, ml = batches[i % len(batches)]["sp"]
            mbs = [(text[j], mel[j], tl[j], ml[j]) for j in range(text.shape[0])]
            rs, sums, grads = RM.ref_step(rs, _gen(seed, i, dev), mbs, c, prec)
            losses.append(sums)
            if i == 0:
                grad1 = {p: float(g.norm()) for p, g in grads.items()}
            del grads
        delta = {p: float((x - p0[p]).norm()) for p, x in RM.leaves(rs.params)}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def compare(got, ref):
    """loss_rel: the worst relative gap of a step's loss (the sum of its
    terms). Per leaf, the gap of the first gradient's norm as the
    optimizer took it (before its clip), and of the leaf's change over the
    checked steps, each relative to the larger of the leaf's reference
    norm and the median leaf's: grad1_rel and delta_rel are the median
    leaf's gaps, delta_p90 the 90th percentile's (a fault in a tenth of the
    leaves), delta_worst the worst leaf's (a leaf left unmoved or moved
    twice reads about 1). Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out (they move by round-off
    alone)."""
    total = lambda x, pre: sum(x[pre + k.split("/")[1]] for k in LOSS_TERMS)
    loss = max(abs(total(g, "sp/") - total(r, "")) / abs(total(r, ""))
               for g, r in zip(got["losses"], ref["losses"]))
    med = float(np.median(list(ref["grad1"].values())))
    moved = lambda p: ref["grad1"][p] >= 1e-3 * med
    delta = _leaf_gaps(got["delta"], ref["delta"], moved)
    return {"loss_rel": loss,
            "grad1_rel": float(np.median(_leaf_gaps(got["grad1"], ref["grad1"],
                                                     moved))),
            "delta_rel": float(np.median(delta)),
            "delta_p90": float(np.quantile(delta, 0.9)),
            "delta_worst": float(delta.max())}
