"""The readings that the limits of `correct` are set from, for one cell, in
one process on the card (the benchmark's own runs do not run this):

    python benchmark/control.py --workload flagship_d256.sp_warmup \
        --seeds 1 2 3 --control-seeds 1 2 3 [--faults] --out chiprun_out/x.json

For each of --seeds: the program's set-up and check with no measured
window (the lower readings). For each of --control-seeds: the control,
the plain reference in fp8 (e4m3, one scale a tensor) put in the
program's place and compared as the program is. With --faults (training
cells), the program with half of each micro-batch left out (the mean
over the rest), on the control seeds. Prints and writes one JSON object.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_batch(entry, cell, seed, device):
    """The program's readings with half of each micro-batch's rows left
    out of every step (its losses the means over the rest)."""
    from unast_tpu_torch.train import steps

    inner = steps.make_train_step

    def broken(*a, **kw):
        step = inner(*a, **kw)

        def half(ts, gen, batches):
            return step(ts, gen, {k: tuple(x[:, :x.shape[1] // 2] for x in v)
                                  for k, v in batches.items()})
        return half

    steps.make_train_step = broken
    try:
        detail = {}
        return entry.judge(entry.setup(cell, seed, device), None, detail), detail
    finally:
        steps.make_train_step = inner


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import core

    cell = core.Cell(ROOT, args.workload)
    entry = cell.entry()
    out = {"workload": args.workload, "program": {}, "control": {},
           "half_batch": {}, "detail": {"program": {}, "control": {},
                                        "half_batch": {}}}
    if args.device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    for seed in args.seeds:
        t = time.time()
        state = entry.setup(cell, seed, args.device)
        out["detail"]["program"][seed] = d = {}
        out["program"][seed] = entry.judge(state, None, d)
        print("program", seed, round(time.time() - t, 1), out["program"][seed],
              flush=True)
    for seed in args.control_seeds:
        t = time.time()
        out["detail"]["control"][seed] = d = {}
        out["control"][seed] = entry.control(cell, seed, args.device, "fp8", d)
        print("control", seed, round(time.time() - t, 1), out["control"][seed],
              flush=True)
        if args.faults:
            (out["half_batch"][seed],
             out["detail"]["half_batch"][seed]) = half_batch(entry, cell, seed,
                                                             args.device)
            print("half_batch", seed, out["half_batch"][seed], flush=True)
    text = json.dumps(out)
    print(json.dumps({k: v for k, v in out.items() if k != "detail"}, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
